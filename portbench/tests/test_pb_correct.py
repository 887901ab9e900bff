"""What decides `correct`, driven through whole runs of the tiny cells on
the CPU (the harness's look for a card is skipped): sound runs pass, the
control (the reference computed with 8-bit products in the port's place)
fails, and so does a run whose timed path is broken underneath, once for
each fault a one-card training cell can have."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import manifest, run, training
from portbench.families import lm, resnet

CPU = torch.device("cpu")
CELLS = ("tiny-gpt-train", "tiny-resnet-train")
SEED = 2**31 + 977


def _run(bench_root, cell):
    bench = manifest.load(bench_root)
    result, _ = run.run_cell(bench, bench.cell(cell), SEED, 0.2, False, CPU,
                             start=time.monotonic())
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_prints_each_number_beside_its_limit(bench_root, cell):
    result = _run(bench_root, cell)
    assert result["correct"] is True
    assert list(result)[-1] == "checked"
    assert set(result["checked"]) == set(manifest.load(bench_root).cell(cell).limits)
    assert all(set(c) == {"value", "limit"} for c in result["checked"].values())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "step_ms_p90"} <= set(result["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(bench_root, cell):
    """The reference in 8-bit products, the step below the configurations'
    bf16, put in the port's place, fails one of the cell's limits."""
    c = manifest.load(bench_root).cell(cell)
    ref = training.reference_steps(c.family, c.config, c.traffic, SEED, CPU)
    control = training.reference_steps(c.family, c.config, c.traffic, SEED, CPU,
                                       precision="fp8")
    numbers = training.compare(control, ref)
    assert any(numbers[n][0] > limit for n, limit in c.limits.items()), numbers


def _tf32_flags() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.mark.parametrize("cell, family", [(CELLS[0], lm), (CELLS[1], resnet)])
def test_the_reference_runs_with_tf32_off_and_sets_the_flags_back(bench_root, monkeypatch,
                                                                  cell, family):
    """PyTorch leaves cuDNN's TF32 on by default: the reference turns it and
    cuBLAS's off for every step it takes, and sets both back after."""
    c = manifest.load(bench_root).cell(cell)
    seen = []
    loss = family.reference_loss

    def recording(*args, **kwargs):
        seen.append(_tf32_flags())
        return loss(*args, **kwargs)

    monkeypatch.setattr(family, "reference_loss", recording)
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        training.reference_steps(c.family, c.config, c.traffic, SEED, CPU)
        assert seen == [(False, False, "highest")] * training.CHECKED_STEPS
        assert _tf32_flags() == (True, True, "high")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _state_unchanged(program):
    program.optimizer.step = lambda *args, **kwargs: None
    return program


def _half_batch(program):
    step = program.step

    def half(batch):
        if isinstance(batch, tuple):
            return step(tuple(t[: t.shape[0] // 2] for t in batch))
        return step(batch[: batch.shape[0] // 2])

    program.step = half
    return program


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
@pytest.mark.parametrize("cell, family", [(CELLS[0], lm), (CELLS[1], resnet)])
def test_a_broken_timed_path_is_not_correct(bench_root, monkeypatch, cell, family, fault):
    build = family.build_program
    monkeypatch.setattr(family, "build_program", lambda *a, **k: fault(build(*a, **k)))
    assert _run(bench_root, cell)["correct"] is False
