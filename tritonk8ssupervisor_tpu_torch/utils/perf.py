"""FLOPs accounting, MFU, timing windows and profiler capture: the port
of `tritonk8ssupervisor_tpu/utils/perf.py`.

FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over one real
train step. It counts only convolutions, matrix products (2 FLOPs per
multiply-add) and the attention kernel K2 (its registered formula,
ops/flash_attention.py), where the reference used XLA's cost analysis of
the whole compiled program, elementwise work included; `flops_source`
says so beside every number. Peak is the card's data-sheet dense bf16 rate, so
MFU = counted FLOPs / (step time x peak).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from pathlib import Path
from typing import Callable, Iterator

import torch
from torch.utils.flop_counter import FlopCounterMode

# Data-sheet dense bf16 tensor-core peak per card (FLOP/s, 2 per MAC,
# without sparsity), keyed by torch.cuda.get_device_name() prefix.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756e12,  # H100 PCIe
    "NVIDIA H200": 989e12,  # H200 SXM
}

FLOPS_SOURCE = (
    "torch.utils.flop_counter over one train step "
    "(convolutions, matrix products and attention only)"
)

# the drain-file contract of tritonk8ssupervisor_tpu/provision/maintenance.py
DRAIN_FILE_VAR = "TK8S_DRAIN_FILE"
DEFAULT_DRAIN_FILE = "/run/tk8s-drain"
ENV_FILE = Path("/etc/tpu-cluster.env")


def peak_flops_per_chip(device_name: str) -> float | None:
    """Dense bf16 peak of the card named `device_name` (exact name, then
    prefix), or None when the card is unknown."""
    if device_name in PEAK_BF16_FLOPS:
        return PEAK_BF16_FLOPS[device_name]
    for name, peak in PEAK_BF16_FLOPS.items():
        if device_name.startswith(name):
            return peak
    return None


def flops_per_step(run_step: Callable[[], object]) -> dict:
    """Run one step under the FLOP counter: {"flops_per_step",
    "flops_source"}; flops_per_step is None when nothing was counted."""
    with FlopCounterMode(display=False) as counter:
        run_step()
    flops = float(counter.get_total_flops())
    return {"flops_per_step": flops or None, "flops_source": FLOPS_SOURCE}


def mfu(flops_per_step: float | None, step_seconds: float, num_chips: int,
        device_name: str) -> float | None:
    """Model FLOPs utilisation against the cards' aggregate peak; None
    when either side is unknown."""
    peak = peak_flops_per_chip(device_name)
    if not flops_per_step or not peak or step_seconds <= 0:
        return None
    return flops_per_step / (step_seconds * peak * num_chips)


def drain_requested() -> str | None:
    """The drain reason when this host is draining, else None: the port's
    own copy of `provision/maintenance.py::drain_requested`. The path is
    TK8S_DRAIN_FILE from the environment, then from the host env file,
    then the watchdog's default."""
    path = os.environ.get(DRAIN_FILE_VAR)
    if not path and ENV_FILE.exists():
        for raw in ENV_FILE.read_text().splitlines():
            key, sep, value = raw.strip().partition("=")
            if sep and not key.startswith("#") and key.strip() == DRAIN_FILE_VAR:
                path = value.strip()
    p = Path(path or DEFAULT_DRAIN_FILE)
    if not p.exists():
        return None
    return p.read_text().strip() or "drain requested"


def timed_windows(
    run_once: Callable[[], dict],
    *,
    steps: int,
    warmup: int,
    windows: int,
    steps_per_call: int = 1,
    profile_dir: str | None = None,
) -> dict:
    """The reference's measurement discipline: warm up, then time
    `windows` windows of `steps` optimizer steps on the host clock, each
    closed by `loss.item()`, which waits for the card. Fenced once per
    window, not per step, so the host keeps the queue full.

    run_once: () -> metrics, one call covering `steps_per_call` steps.
    Between windows the maintenance drain file is polled and the run
    stops early when the host is draining (`drained` carries why).

    Returns final_loss, step_ms (median), step_ms_min, step_ms_windows,
    steps, windows, drained, and first_fence_seconds (monotonic time of
    the first fenced call, for the caller's start-up accounting).
    """
    metrics = run_once()  # first call: kernel builds, cuDNN plans
    metrics["loss"].item()
    first_fence_seconds = time.monotonic()
    for _ in range(max(0, warmup - 1)):
        metrics = run_once()
    metrics["loss"].item()

    calls_per_window = steps // steps_per_call
    window_seconds = []
    drained = None
    for _ in range(max(1, windows)):
        start = time.monotonic()
        for _ in range(calls_per_window):
            metrics = run_once()
        final_loss = metrics["loss"].item()  # the fence
        window_seconds.append(time.monotonic() - start)
        drained = drain_requested()
        if drained is not None:
            print(f"drain requested ({drained}); stopping after "
                  f"{len(window_seconds)} window(s)", flush=True)
            break

    if profile_dir:
        with maybe_trace(profile_dir):
            run_once()["loss"].item()

    step_ms_windows = [s / steps * 1000 for s in window_seconds]
    return {
        "final_loss": final_loss,
        "first_fence_seconds": first_fence_seconds,
        "steps": steps,
        "windows": len(window_seconds),
        "step_ms": statistics.median(step_ms_windows),
        "step_ms_min": min(step_ms_windows),
        "step_ms_windows": [round(w, 3) for w in step_ms_windows],
        "drained": drained,
    }


def timing_summary(result: dict) -> str:
    """'step X ms (min Y over N windows), MFU Z%'."""
    text = (
        f"step {result['step_ms']:.1f} ms "
        f"(min {result['step_ms_min']:.1f} over {result['windows']} windows)"
    )
    if result.get("mfu") is not None:
        text += f", MFU {result['mfu'] * 100:.1f}%"
    return text


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None) -> Iterator[None]:
    """Capture a torch.profiler trace (host and, where there is a card,
    device activity) of the wrapped steps into `profile_dir`: trace.json
    (viewable in Perfetto), ops.txt (operators by device time) and
    summary.json (wall time, device busy time and the device's idle
    share over the wrapped span, which must end synchronised). The
    profiler's own host overhead inflates the wall time, so the idle
    share is an upper bound. No-op without a directory."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        start = time.monotonic()
        yield
        wall_ms = (time.monotonic() - start) * 1e3
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    ops = prof.key_averages()
    Path(profile_dir, "ops.txt").write_text(
        ops.table(sort_by="self_device_time_total", row_limit=40)
    )
    summary = {"wall_ms": wall_ms, "device_busy_ms": None, "device_idle_share": None}
    if torch.profiler.ProfilerActivity.CUDA in activities:
        # kernels only: operator rows repeat their kernels' device time
        busy_ms = sum(
            e.self_device_time_total for e in ops
            if e.device_type == torch.autograd.DeviceType.CUDA
        ) / 1e3
        summary["device_busy_ms"] = busy_ms
        summary["device_idle_share"] = 1.0 - busy_ms / wall_ms
    Path(profile_dir, "summary.json").write_text(json.dumps(summary))
