"""TPU VM maintenance-event watchdog: preemption-aware draining.

Cloud TPU VMs receive host maintenance; the guest sees it coming
through the GCE metadata server's `instance/maintenance-event` key
(`NONE` until an event is scheduled, then e.g.
`TERMINATE_ON_HOST_MAINTENANCE`). The reference framework had no
preemption story at all; GKE mode gets one from node auto-repair + the
benchmark Job's gang-restart budget (terraform/gke/main.tf,
config/compile.py). This module is the tpu-vm analogue — SURVEY.md §5
elastic recovery:

- `poll_event()` reads the metadata key (2 s timeout, Metadata-Flavor
  header; injectable fetcher for tests — no real metadata server in
  CI).
- `watch()` loops until an event is pending, then writes the DRAIN
  FILE and exits. The drain file is the one-way signal to the
  workload.
- The training side polls `drain_requested()` between measurement
  windows (benchmarks/resnet50.py, benchmarks/lm.py): on drain it
  saves a final checkpoint and exits cleanly — so the maintenance
  window interrupts a *checkpointed* run, and the converge-on-rerun
  pipeline (or simply re-running the same command after maintenance)
  resumes from the last step instead of step 0.

Deployment: the tpuhost ansible role installs
`tk8s-maintenance-watch.service` (a simple always-restart systemd
unit running this module) on every TPU VM host; the workload inherits
TK8S_DRAIN_FILE from /etc/tpu-cluster.env. One host draining drains
the whole slice-wide run at the next window boundary — gang semantics
match the JAX cluster's (one lost host kills the collective anyway;
draining loses nothing and saves the checkpoint).

CLI:
    python -m tritonk8ssupervisor_tpu_torch.provision.maintenance \
        [--drain-file /run/tk8s-drain] [--interval 10] [--once]

The port's copy of `tritonk8ssupervisor_tpu/provision/maintenance.py`,
whole and under the reference's names: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import os
import time
import urllib.request
from pathlib import Path
from typing import Callable

METADATA_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/maintenance-event"
)
DEFAULT_DRAIN_FILE = "/run/tk8s-drain"
DRAIN_FILE_VAR = "TK8S_DRAIN_FILE"


def _default_fetch(url: str, timeout: float) -> str:
    req = urllib.request.Request(url, headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode("utf-8", errors="replace").strip()


def poll_event(
    fetch: Callable[[str, float], str] | None = None,
    url: str = METADATA_URL,
    timeout: float = 2.0,
    errors: str = "ignore",
) -> str:
    """The current maintenance-event value; "NONE" when nothing is
    scheduled or the metadata server is unreachable (off-GCP dev boxes
    must not self-drain because metadata.google.internal is absent).
    errors="raise" propagates fetch failures instead — what watch() uses
    to tell "no event" apart from "cannot ask" and back off."""
    if fetch is None:
        fetch = _default_fetch  # resolved at call time (testable)
    try:
        value = fetch(url, timeout)
    except Exception:  # noqa: BLE001 - unreachable metadata == no event
        if errors == "raise":
            raise
        return "NONE"
    return value or "NONE"


def request_drain(drain_file: Path, reason: str) -> None:
    """Write the one-way drain signal (idempotent; content = reason).

    Atomic (temp file + os.replace): the training loop polls
    `drain_requested()` between steps, and a reader racing a plain
    write_text could see an empty/partial file — an empty drain file
    still reads as "drain requested" with no reason, so the workload
    would stop without knowing why."""
    from tritonk8ssupervisor_tpu_torch.provision.state import atomic_write_text

    atomic_write_text(Path(drain_file), f"{reason}\n")


def drain_requested(environ: dict | None = None) -> str | None:
    """The drain reason when this host is draining, else None — the
    check the benchmark loops run between measurement windows.

    The drain-file path resolves through the same layered contract as
    the cluster coordinates: process env TK8S_DRAIN_FILE first, then
    the host env file the tpuhost role writes (/etc/tpu-cluster.env —
    an ssh'd `python -m ...benchmarks.resnet50` never sources it into
    its shell, so reading it HERE is what makes the watchdog's signal
    reach the training process), then the watchdog's default path."""
    environ = os.environ if environ is None else environ
    path = environ.get(DRAIN_FILE_VAR)
    if not path:
        from tritonk8ssupervisor_tpu_torch.parallel.distributed import ENV_FILE

        if ENV_FILE.exists():
            from tritonk8ssupervisor_tpu_torch.config.store import parse_flat

            path = parse_flat(ENV_FILE.read_text()).get(DRAIN_FILE_VAR)
        if not path:
            path = DEFAULT_DRAIN_FILE
    p = Path(path)
    if not p.exists():
        return None
    return p.read_text().strip() or "drain requested"


def watch(
    drain_file: Path,
    interval: float = 10.0,
    once: bool = False,
    fetch: Callable[[str, float], str] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    log: Callable[[str], None] = print,
    max_backoff: float = 300.0,
    on_event: Callable[[str], None] | None = None,
) -> bool:
    """Poll the metadata server, owning the drain file's lifecycle:
    write it while an event is pending, REMOVE it once the event clears
    (a live migration completes without a reboot; /run survives until
    reboot — a stale drain file would stop every later run after one
    window). once=True polls a single time and returns whether a drain
    was requested; the continuous mode never returns.

    `on_event` is the observation sink: called with every successfully
    polled value (including "NONE") BEFORE the drain file is touched, so
    a supervisor embedding the watchdog sees scheduled maintenance the
    instant the metadata server announces it — not one poll interval
    later when the drain file lands on disk. A sink that raises is
    logged and never kills the watchdog (the drain file is the
    load-bearing signal; the sink is advisory).

    Repeated fetch failures back off exponentially (doubling from
    `interval` up to `max_backoff`) instead of hammering a struggling
    metadata server at full cadence, and an errored poll leaves the
    drain file untouched — "cannot ask" must not clear a pending drain
    the way a genuine NONE does. The error count feeds the log line so
    a metadata server that has been unreachable for hours reads as "has
    failed N consecutive times", not as a fresh one-off — and the
    doubling is clamped once the cap is reached (an unbounded exponent
    would overflow after ~1000 consecutive failures and crash the
    watchdog exactly when it is needed most)."""
    drain_file = Path(drain_file)
    fired = False
    consecutive_errors = 0
    while True:
        try:
            event = poll_event(fetch=fetch, errors="raise")
        except Exception as e:  # noqa: BLE001 - metadata server flapping
            if once:
                return fired
            consecutive_errors += 1
            # clamp the exponent: past the cap the delay is max_backoff
            # anyway, and 2.0**1024 raises OverflowError
            delay = min(max_backoff,
                        interval * (2.0 ** min(consecutive_errors, 30)))
            if delay >= max_backoff:
                log(f"metadata fetch has failed {consecutive_errors} "
                    f"consecutive time(s) ({e}); backing off "
                    f"{delay:.0f}s (capped)")
            else:
                log(f"metadata fetch failed ({e}); backing off "
                    f"{delay:.0f}s")
            sleep(delay)
            continue
        consecutive_errors = 0
        if on_event is not None:
            try:
                on_event(event)
            except Exception as e:  # noqa: BLE001 - sink is advisory
                log(f"maintenance event sink failed ({e}); continuing")
        if event != "NONE":
            if not fired or not drain_file.exists():
                log(f"maintenance event pending: {event}; requesting drain")
                request_drain(drain_file, f"maintenance-event: {event}")
            fired = True
        else:
            if drain_file.exists():
                log("maintenance event cleared; removing drain file")
                drain_file.unlink()
            fired = False
        if once:
            return fired
        sleep(interval)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--drain-file", type=Path,
                        default=Path(DEFAULT_DRAIN_FILE))
    parser.add_argument("--interval", type=float, default=10.0)
    parser.add_argument("--once", action="store_true",
                        help="poll once and exit (exit code 3 = event "
                        "pending and drain requested)")
    args = parser.parse_args(argv)
    fired = watch(args.drain_file, interval=args.interval, once=args.once)
    return 3 if (fired and args.once) else 0


if __name__ == "__main__":
    raise SystemExit(main())
