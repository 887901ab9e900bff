"""What the benchmark may load: nothing of JAX or the JAX package anywhere
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing of the port in the references."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "tritonk8ssupervisor_tpu")
PORT = "tritonk8ssupervisor_tpu_torch"
FILES = sorted((ROOT / "portbench").rglob("*.py"))
REFERENCE = sorted((ROOT / "portbench" / "reference").glob("*.py"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _fresh(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    assert len(FILES) >= 30
    for path in FILES:
        for module in _imports(path):
            assert module.split(".")[0] not in FORBIDDEN, f"{path}: {module}"


def test_the_references_import_nothing_of_the_port():
    assert {p.name for p in REFERENCE} >= {"gpt.py", "resnet.py", "common.py"}
    for path in REFERENCE:
        for module in _imports(path):
            top = module.split(".")[0]
            assert top not in FORBIDDEN + (PORT,), f"{path}: {module}"
            assert not module.startswith("portbench.") or module.startswith(
                "portbench.reference"), f"{path}: {module}"
    out = _fresh("import sys, portbench.reference.gpt, portbench.reference.resnet; "
                 f"print([m for m in sys.modules if m.split('.')[0] == {PORT!r}])")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax_in_a_fresh_interpreter(tmp_path):
    code = (
        "import json, sys, time, torch\n"
        "from pathlib import Path\n"
        "from portbench.tests.conftest import make_bench_root\n"
        "from portbench import manifest, run\n"
        f"root = make_bench_root(Path({str(tmp_path)!r}))\n"
        "bench = manifest.load(root)\n"
        "result, _ = run.run_cell(bench, bench.cell('tiny-gpt-train'), 5, 0.1, False,\n"
        "                         torch.device('cpu'), start=time.monotonic())\n"
        "print(json.dumps([result['correct'], run.forbidden_modules(),\n"
        f"                  any(m.split('.')[0] == {PORT!r} for m in sys.modules)]))\n"
    )
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax._src.fake", object())
    monkeypatch.setitem(sys.modules, "tritonk8ssupervisor_tpu.fake", object())
    assert run.forbidden_modules() == ["jax._src.fake", "tritonk8ssupervisor_tpu.fake"]


def _cli(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "gpt2s-train-s1024", "--seed", "4294967311", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(ROOT)
    assert out.returncode == 3 and out.stdout == ""


def test_without_the_port_beside_it_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode == 2 and out.stdout == ""
    assert PORT in out.stderr
