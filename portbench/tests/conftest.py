"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary root with tiny cells beside the real ones, so a test can add
files and drive whole runs on the CPU without touching the repo."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY_GPT = {
    "family": "lm", "n_layer": 2, "n_head": 2, "n_embd": 32, "n_positions": 32,
    "vocab_size": 128, "layer_norm_epsilon": 1e-06, "learning_rate": 0.03, "momentum": 0.9,
}
TINY_RESNET = {
    "family": "resnet", "stages": [3, 4, 6, 3], "num_filters": 64, "expansion": 4,
    "num_classes": 10, "bn_epsilon": 1e-05, "learning_rate": 0.1, "momentum": 0.9,
}
TINY_TRAFFIC = {
    "tiny-lm": {"batch": 4, "seq": 16, "token_ids": 120, "feed_batches": 4, "loop": "closed"},
    "tiny-resnet": {"batch": 8, "image_size": 64, "fused_1x1_bwd": True, "feed_batches": 4,
                    "loop": "closed"},
}
# limits for the tiny cells on the CPU, from portbench.calibrate there over
# six seeds: the port's bf16 steps read at most loss 3.6e-4, grad 0.0115,
# change 0.0072 (GPT) and 4.6e-3, 0.029, 0.116 (ResNet); the fp8 control at
# least 3.0e-3, 0.0375, 0.042 and 0.049, 0.034, 0.104; the half-batch fault
# at least 0.014, 0.59, 0.49 and 0.18, 0.53, 0.73. The ResNet's control
# separates on the loss alone at this size.
TINY_LIMITS = {
    "tiny-gpt-train": {"loss_gap": 0.0012, "grad_gap": 0.02, "change_gap": 0.02},
    "tiny-resnet-train": {"loss_gap": 0.015, "grad_gap": 0.1, "change_gap": 0.3},
}


def add_cell(root: Path, name: str, config: str, traffic: str, like: str) -> None:
    """Add a cell to the BENCHMARK.json under `root` that reports the
    metrics the cell `like` reports."""
    path = root / "BENCHMARK.json"
    doc = json.loads(path.read_text())
    doc["workloads"].append({"name": name, "config": config, "traffic": traffic,
                             "chips": 1, "why": f"a cell like {like}"})
    for metric in doc["end_to_end"] + doc["per_layer"]:
        if like in metric.get("workloads", ()):
            metric["workloads"].append(name)
    path.write_text(json.dumps(doc, indent=1))


def make_bench_root(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ with two tiny cells added:
    `tiny-gpt-train` and `tiny-resnet-train`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name, config in (("tiny-gpt", TINY_GPT), ("tiny-resnet", TINY_RESNET)):
        (tmp_path / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(config))
        doc["configs"].append({"name": name, "source": "portbench tests", "reduced": [],
                               "file": f"portbench/configs/{name}.json", "why": "tests"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    for name, traffic in TINY_TRAFFIC.items():
        (tmp_path / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for name, limits in TINY_LIMITS.items():
        (tmp_path / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps({"limits": limits}))
    add_cell(tmp_path, "tiny-gpt-train", "tiny-gpt", "tiny-lm", "gpt2s-train-s1024")
    add_cell(tmp_path, "tiny-resnet-train", "tiny-resnet", "tiny-resnet", "resnet50-train-k4")
    return tmp_path


@pytest.fixture
def bench_root(tmp_path: Path) -> Path:
    return make_bench_root(tmp_path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: tests that need an NVIDIA card; each skips inside its fixture when "
        "torch.cuda.is_available() is false",
    )


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, never
    while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)
