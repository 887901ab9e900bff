"""The readings the comparison's limits are set from, for one cell, in
one process on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,... [--out FILE]

- for each of `--seeds`: the port's checked steps against the float32
  reference (the lower readings are the largest over the seeds);
- for each of `--control-seeds`: the control, the reference computed with
  8-bit products in the port's place, and the planted half-batch fault,
  the reference with half of each batch left out and the mean taken over
  the rest, each against the float32 reference (the upper readings are
  the smallest). A step that leaves the state unchanged reads 1 on
  `change_gap` by construction and needs no run.

`--out` also keeps each side's readings leaf by leaf, so another number
can be read from the same runs. Not run by the benchmark's runs;
`PERF.md` keeps what it printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
from pathlib import Path

import torch

from portbench import manifest, training

ROOT = Path(__file__).resolve().parents[1]


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _leaf_readings(readings: training.Readings) -> dict:
    """The readings' norms, without the parameters themselves."""
    return {k: v for k, v in dataclasses.asdict(readings).items() if k != "params"}


def program_readings(cell, seed: int, device) -> training.Readings:
    fam, config, traffic = cell.family, cell.config, cell.traffic
    program = fam.build_program(config, traffic, fam.make_weights(config, traffic, seed, device),
                                device)
    feed = [fam.make_batch(config, traffic, seed, i, device)
            for i in range(training.CHECKED_STEPS)]
    readings = training.program_first_steps(
        program, feed, lambda: fam.make_weights(config, traffic, seed, device))
    del program, feed
    _free(device)
    return readings


def calibrate(cell, seeds: list[int], control_seeds: list[int], device) -> dict:
    fam, config, traffic = cell.family, cell.config, cell.traffic
    rows, readings = [], []

    def reference(seed: int, **kwargs) -> training.Readings:
        readings = training.reference_steps(fam, config, traffic, seed, device, **kwargs)
        _free(device)
        return readings

    for seed in seeds:
        start = time.monotonic()
        side = program_readings(cell, seed, device)
        mid = time.monotonic()
        ref = reference(seed)
        numbers = training.compare(side, ref)
        readings.append({"kind": "program", "seed": seed, "side": _leaf_readings(side),
                         "reference": _leaf_readings(ref)})
        rows.append({"kind": "program", "seed": seed, "program_s": mid - start,
                     "reference_s": time.monotonic() - mid,
                     "losses": side.losses, "reference_losses": ref.losses,
                     **{k: list(v) for k, v in numbers.items()}})
        print(json.dumps(rows[-1]), flush=True)
    for seed in control_seeds:
        ref = reference(seed)
        readings.append({"kind": "reference", "seed": seed, "reference": _leaf_readings(ref)})
        for kind, kwargs in (("control", {"precision": "fp8"}), ("half_batch", {"batch_share": 0.5})):
            side = reference(seed, **kwargs)
            readings.append({"kind": kind, "seed": seed, "side": _leaf_readings(side)})
            numbers = training.compare(side, ref)
            rows.append({"kind": kind, "seed": seed, **{k: list(v) for k, v in numbers.items()}})
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for number in training.NUMBERS:
        by_kind = {}
        for kind in ("program", "control", "half_batch"):
            values = [r[number][0] for r in rows if r["kind"] == kind]
            if values:
                by_kind[kind] = max(values) if kind == "program" else min(values)
        summary[number] = by_kind
    return {"cell": cell.name, "rows": rows, "summary": summary, "readings": readings}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated program seeds")
    parser.add_argument("--control-seeds", default="", help="comma-separated control seeds")
    parser.add_argument("--out", default=None, help="write the readings here as JSON")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = manifest.load(ROOT).cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    result = calibrate(cell, seeds, control, torch.device(args.device))
    print(json.dumps(result["summary"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
