"""Run one cell of `BENCHMARK.json` once on the card and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the port's training step on weights and batches made on the
card from `--seed`, drives it through its checked steps
(`portbench/training.py`) and a few warm-up steps; the window then runs
the same step for `--seconds` (`portbench/window.py`); with `--trace 1` two
more short stretches of steps run under the profiler (`portbench/trace.py`):
one traced for the card's work alone, which gives its busy and wall time,
and one with the host's ops, which the per-layer readers attribute. Once the
window has closed and the port's state is freed, the plain reference
follows the checked steps and the comparison decides `correct`. The
numbers compared are printed beside their limits as the last lines of
standard error and under `checked`, the last key of the result.

Exit codes: 0 with a result; 2 without the port beside the benchmark; 3
without the card(s) the cell asks for; 4 when JAX or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import time

START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = "tritonk8ssupervisor_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tritonk8ssupervisor_tpu")
# steps after the checked ones and before the window
WARM_STEPS = 2
# the traced stretch: about this many seconds of steps, and at least MIN
TRACE_SECONDS = 1.0
MIN_TRACE_STEPS = 3


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def run_cell(bench, cell, seed: int, seconds: float, traced: bool, device,
             start: float = START) -> tuple[dict, dict]:
    """One run of `cell`: (the result line as a dict, where each number
    compared was read: its step or leaf)."""
    import torch

    from portbench import readers, training, window
    from portbench.trace import capture, capture_card

    fam, config, traffic = cell.family, cell.config, cell.traffic
    on_card = device.type == "cuda"
    phases = {"imports": time.monotonic() - start}
    program = fam.build_program(config, traffic, fam.make_weights(config, traffic, seed, device),
                                device)
    feed = [fam.make_batch(config, traffic, seed, i, device)
            for i in range(traffic["feed_batches"])]
    window.synchronize(device)
    phases["build"] = time.monotonic() - start - sum(phases.values())
    readings = training.program_first_steps(
        program, feed, lambda: fam.make_weights(config, traffic, seed, device))
    phases["checked_steps"] = time.monotonic() - start - sum(phases.values())
    first = training.CHECKED_STEPS
    for i in range(WARM_STEPS):
        program.step(feed[(first + i) % len(feed)])
    window.synchronize(device)
    setup_s = time.monotonic() - start
    phases["warm_steps"] = setup_s - sum(phases.values())
    print("portbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr)

    measured = window.measure(program.step, feed, first + WARM_STEPS, seconds, device)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    trace = card = None
    if traced:
        steps = max(MIN_TRACE_STEPS, round(TRACE_SECONDS * measured.steps / measured.seconds))
        cursor = [0]

        def run_steps(n: int) -> None:
            for _ in range(n):
                program.step(feed[cursor[0] % len(feed)])
                cursor[0] += 1

        card = capture_card(run_steps, steps) if on_card else None
        trace = capture(run_steps, steps)
    last_loss = float(program.step(feed[0])["loss"])

    del program, feed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checked_at = time.monotonic()
    reference = training.reference_steps(fam, config, traffic, seed, device)
    print(f"portbench: reference {time.monotonic() - checked_at:.3f} s", file=sys.stderr)
    numbers = training.compare(readings, reference)
    checked = {name: {"value": numbers[name][0], "limit": limit}
               for name, limit in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checked.values())

    run = readers.Run(cell.name, config, traffic, fam, setup_s, measured, trace, card)
    metrics = {}
    for metric in bench.metrics(cell.name, traced):
        value = metric.read(run)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": measured.steps,
              "failed": 0 if math.isfinite(last_loss) else measured.steps,
              "metrics": metrics, "device": dev}
    if card is not None:
        dev["busy_s"], dev["window_s"] = card.busy_s, card.window_s
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checked"] = checked
    return result, {name: numbers[name][1] for name in checked}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every cache the run writes stays in the checkout, at a fixed path
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")

    from portbench import manifest

    bench = manifest.load(ROOT)
    cell = bench.cell(args.workload)
    if importlib.util.find_spec(PORT) is None:
        print(f"portbench: the port ({PORT}) is not beside the benchmark", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, where = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found[:10]}", file=sys.stderr)
        return 4
    for name, c in result["checked"].items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g} (at {where[name]})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
