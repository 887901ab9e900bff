"""BENCHMARK.json against the contract, and the harness finding a cell,
a traffic mix, a configuration and a metric by name, as new files."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from portbench import manifest, training
from portbench.tests.conftest import ROOT


def _doc() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_benchmark_keeps_the_contract_and_every_name_has_its_files():
    bench = manifest.load(ROOT)
    for entry in bench.doc["workloads"]:
        cell = bench.cell(entry["name"])
        assert cell.limits and set(cell.limits) <= set(training.NUMBERS)
        for traced in (False, True):
            assert all(callable(m.read) for m in bench.metrics(cell.name, traced))
    for entry in bench.doc["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        assert set(entry["reduced"]) <= set(config["published"])


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", "-lead", "é", "x" * 65, ""])
def test_a_malformed_name_is_refused(name):
    doc = _doc()
    doc["per_layer"][0]["name"] = name
    with pytest.raises(ValueError):
        manifest.check(doc, ROOT)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "", "x" * 17])
def test_a_malformed_unit_is_refused(unit):
    doc = _doc()
    doc["end_to_end"][1]["unit"] = unit
    with pytest.raises(ValueError):
        manifest.check(doc, ROOT)


@pytest.mark.parametrize("name", ["tokens/s", "%", "ms", "images/s", "GB.s-1"])
def test_a_well_formed_unit_is_taken(name):
    doc = _doc()
    doc["end_to_end"][1]["unit"] = name
    manifest.check(doc, ROOT)


@pytest.mark.parametrize("breakage", [
    lambda d: d["workloads"].append(copy.deepcopy(d["workloads"][0])),
    lambda d: d["per_layer"].append(copy.deepcopy(d["end_to_end"][0])),
    lambda d: d["workloads"][0].update(config="no-such-config"),
    lambda d: d["workloads"][0].update(traffic="no-such-traffic"),
    lambda d: d["workloads"][0].update(name="no-limits-file"),
    lambda d: d["configs"][0].update(file="elsewhere/gpt2.json"),
    lambda d: d["per_layer"][0].update(name="no_reader.lm"),
    lambda d: d["per_layer"][0].update(workloads=["no-such-cell"]),
])
def test_a_name_the_harness_cannot_find_is_refused(breakage):
    doc = _doc()
    breakage(doc)
    with pytest.raises(ValueError):
        manifest.check(doc, ROOT)


def test_metrics_named_alike_share_a_reader_and_a_reader_of_their_own_wins(bench_root: Path):
    metrics = bench_root / "portbench" / "metrics"
    assert manifest.reader_path(bench_root, "mfu.lm") == metrics / "mfu.py"
    assert manifest.reader_path(bench_root, "mfu.resnet") == metrics / "mfu.py"
    assert manifest.reader_path(bench_root, "k2_roofline.lm") == metrics / "k2_roofline.lm.py"
    (metrics / "mfu.vit.py").write_text("def read(run):\n    return 1.0\n")
    assert manifest.reader_path(bench_root, "mfu.vit") == metrics / "mfu.vit.py"


def test_a_cell_and_a_metric_added_as_new_files_are_found_without_edits(bench_root: Path):
    """A later PR adds files and BENCHMARK.json entries only: no file the
    benchmark has changes."""
    before = {p: p.read_bytes() for p in (bench_root / "portbench").rglob("*") if p.is_file()}
    pb = bench_root / "portbench"
    (pb / "traffic" / "lm-b16-s1024.json").write_text(json.dumps(
        {"batch": 16, "seq": 1024, "token_ids": 50257, "feed_batches": 8, "loop": "closed"}))
    (pb / "workloads" / "gpt2s-train-b16.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}}))
    (pb / "metrics" / "steps.lm.py").write_text(
        "def read(run):\n    return float(run.window.steps)\n")
    doc = json.loads((bench_root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "gpt2s-train-b16", "config": "gpt2-small",
                             "traffic": "lm-b16-s1024", "chips": 1, "why": "a smaller batch"})
    doc["end_to_end"][1]["workloads"].append("gpt2s-train-b16")
    doc["per_layer"].append({"name": "steps.lm", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "step: parallel/train.py",
                             "moves": "train_tokens_per_s", "workloads": ["gpt2s-train-b16"]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(doc))

    bench = manifest.load(bench_root)
    cell = bench.cell("gpt2s-train-b16")
    assert cell.traffic["batch"] == 16 and cell.family.__name__ == "portbench.families.lm"
    e2e = [m.name for m in bench.metrics(cell.name, False)]
    assert e2e == ["setup_s", "train_tokens_per_s", "step_ms_p90"]
    (added,) = bench.metrics(cell.name, True)
    assert added.name == "steps.lm" and added.read(type("R", (), {"window": type(
        "W", (), {"steps": 7})})) == 7.0
    after = {p: p.read_bytes() for p in before}
    assert after == before
