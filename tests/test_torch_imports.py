"""The port stands alone: no module of `tritonk8ssupervisor_tpu_torch`,
and not `chip_smoke.py`, imports JAX or the JAX package, and every entry
point defaults to the card and raises without one."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import tritonk8ssupervisor_tpu_torch
from tritonk8ssupervisor_tpu_torch.benchmarks import decode, lm, resnet50
from tritonk8ssupervisor_tpu_torch.parallel import mesh, train

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tritonk8ssupervisor_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tritonk8ssupervisor_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    assert len(PORT_FILES) >= 90
    for path in PORT_FILES:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {module}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, tritonk8ssupervisor_tpu_torch.benchmarks.resnet50, "
        "tritonk8ssupervisor_tpu_torch.benchmarks.lm, "
        "tritonk8ssupervisor_tpu_torch.ops.flash_attention_cuda, "
        "tritonk8ssupervisor_tpu_torch.benchmarks.decode, "
        "tritonk8ssupervisor_tpu_torch.serving, "
        "tritonk8ssupervisor_tpu_torch.ops.decode_attention_cuda, "
        "tritonk8ssupervisor_tpu_torch.ops.cross_entropy_cuda, "
        "tritonk8ssupervisor_tpu_torch.models.moe, tritonk8ssupervisor_tpu_torch.models.vit, "
        "tritonk8ssupervisor_tpu_torch.parallel.checkpoint, "
        "tritonk8ssupervisor_tpu_torch.parallel.mesh, tritonk8ssupervisor_tpu_torch.parallel.spmd, "
        "tritonk8ssupervisor_tpu_torch.parallel.collectives, "
        "tritonk8ssupervisor_tpu_torch.parallel.distributed, "
        "tritonk8ssupervisor_tpu_torch.parallel.ranks, "
        "tritonk8ssupervisor_tpu_torch.parallel.pipeline, "
        "tritonk8ssupervisor_tpu_torch.ops.ring_attention, "
        "tritonk8ssupervisor_tpu_torch.utils.data, "
        "tritonk8ssupervisor_tpu_torch.utils.convert, "
        "tritonk8ssupervisor_tpu_torch.provision.fleetview, "
        "tritonk8ssupervisor_tpu_torch.provision.retry, "
        "tritonk8ssupervisor_tpu_torch.provision.state, "
        "tritonk8ssupervisor_tpu_torch.parallel.elastic, "
        "tritonk8ssupervisor_tpu_torch.provision.events, "
        "tritonk8ssupervisor_tpu_torch.provision.heal, "
        "tritonk8ssupervisor_tpu_torch.serving.fleet, "
        "tritonk8ssupervisor_tpu_torch.testing.chaos, "
        "tritonk8ssupervisor_tpu_torch.testing.simclock, "
        "tritonk8ssupervisor_tpu_torch.obs, tritonk8ssupervisor_tpu_torch.obs.metrics, "
        "tritonk8ssupervisor_tpu_torch.obs.trace, "
        "tritonk8ssupervisor_tpu_torch.serving.gateway, "
        "tritonk8ssupervisor_tpu_torch.serving.reqlog, "
        "tritonk8ssupervisor_tpu_torch.serving.traffic, "
        "tritonk8ssupervisor_tpu_torch.serving.server, "
        "tritonk8ssupervisor_tpu_torch.obs.analyze, "
        "tritonk8ssupervisor_tpu_torch.provision.runner, "
        "tritonk8ssupervisor_tpu_torch.provision.scheduler, "
        "tritonk8ssupervisor_tpu_torch.provision.journal, "
        "tritonk8ssupervisor_tpu_torch.provision.cache, "
        "tritonk8ssupervisor_tpu_torch.provision.maintenance, "
        "tritonk8ssupervisor_tpu_torch.testing.faults, "
        "tritonk8ssupervisor_tpu_torch.utils.phases, "
        "tritonk8ssupervisor_tpu_torch.utils.topology, "
        "tritonk8ssupervisor_tpu_torch.config, "
        "tritonk8ssupervisor_tpu_torch.config.catalog, "
        "tritonk8ssupervisor_tpu_torch.config.schema, "
        "tritonk8ssupervisor_tpu_torch.config.store, "
        "tritonk8ssupervisor_tpu_torch.packaging, "
        "tritonk8ssupervisor_tpu_torch.config.compile, "
        "tritonk8ssupervisor_tpu_torch.infra, tritonk8ssupervisor_tpu_torch.infra.hcl, "
        "tritonk8ssupervisor_tpu_torch.infra.ansiblecheck, "
        "tritonk8ssupervisor_tpu_torch.provision.terraform, "
        "tritonk8ssupervisor_tpu_torch.provision.ansible, "
        "tritonk8ssupervisor_tpu_torch.provision.readiness, "
        "tritonk8ssupervisor_tpu_torch.provision.autoscale, "
        "tritonk8ssupervisor_tpu_torch.provision.allocator, "
        "tritonk8ssupervisor_tpu_torch.provision.supervisor, "
        "tritonk8ssupervisor_tpu_torch.provision.teardown, "
        "tritonk8ssupervisor_tpu_torch.testing.localcluster, "
        "tritonk8ssupervisor_tpu_torch.cli.io, tritonk8ssupervisor_tpu_torch.cli.discovery, "
        "tritonk8ssupervisor_tpu_torch.cli.main, tritonk8ssupervisor_tpu_torch.cli.wizard, "
        "tritonk8ssupervisor_tpu_torch.utils.roofline, "
        "tritonk8ssupervisor_tpu_torch.utils.corpus, "
        "tritonk8ssupervisor_tpu_torch.utils.benchcompare, "
        "tritonk8ssupervisor_tpu_torch.benchmarks.containerbench; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tritonk8ssupervisor_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet50.run_benchmark(model_name="resnet18", batch_per_chip=2, image_size=32,
                               num_classes=10, steps=1, warmup=1, windows=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet50.run_benchmark(model_name="vit", batch_per_chip=2, image_size=32,
                               num_classes=10, steps=1, warmup=1, windows=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.run_benchmark(vocab_size=64, num_layers=1, num_heads=2, embed_dim=64,
                         seq_len=16, batch_per_data_shard=2, steps=1, warmup=1, windows=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.run_benchmark(vocab_size=64, num_layers=2, num_heads=2, embed_dim=64, seq_len=16,
                         batch_per_data_shard=2, steps=1, warmup=1, windows=1, moe_experts=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.run_benchmark(vocab_size=64, num_layers=2, num_heads=2, embed_dim=64, seq_len=16,
                         batch_per_data_shard=2, steps=1, warmup=1, windows=1,
                         pipeline_parallelism=2, num_microbatches=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.create_train_state(torch.nn.Linear(2, 2), train.default_optimizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.run_benchmark(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32,
                             prompt_len=4, new_tokens=2, batch=1, repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.run_engine_benchmark(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32,
                                    max_len=32, prompt_len=8, shared_prefix_len=4)
    assert tritonk8ssupervisor_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_the_train_drill_defaults_to_the_card_and_raises_without_one(monkeypatch, tmp_path):
    """`cli.main train` runs on the card unless `--device cpu`: without a
    card it raises before it joins, trains or writes anything; without a
    checkpoint directory it refuses to run, as the reference's does."""
    from tritonk8ssupervisor_tpu_torch.cli import main as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TK8S_CHECKPOINT_DIR", raising=False)
    argv = ["train", "--workdir", str(tmp_path), "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--steps", "1", "--yes"]
    assert cli.build_parser().parse_args(argv).device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == []
    assert cli.main(["train", "--workdir", str(tmp_path), "--device", "cpu"]) == 1


def test_the_serve_command_defaults_to_the_card_and_raises_without_one(monkeypatch, tmp_path):
    """`cli.main serve` runs on the card unless `--device cpu`: without a
    card it raises before it builds a model, listens or writes anything,
    in both modes (a drill and the HTTP server)."""
    from tritonk8ssupervisor_tpu_torch.cli import main as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["serve", "--drill", "2"], ["serve", "--port", "0"]):
        argv = argv + ["--workdir", str(tmp_path)]
        assert cli.build_parser().parse_args(argv).device is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == []


def test_chip_smoke_fails_without_the_card_and_alone(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
