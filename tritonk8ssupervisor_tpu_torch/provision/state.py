"""The state files of a workdir that the port reads and writes: the port's
copy of `tritonk8ssupervisor_tpu/provision/state.py::atomic_write_text` and
of the part of `RunPaths` (:116-275) that `serve`, `status` and the gateway fleet
use."""

from __future__ import annotations

import dataclasses
import os
import threading
from pathlib import Path


def atomic_write_text(path: Path | str, text: str) -> None:
    """Write via a same-directory temp file and `os.replace`, so a reader
    sees the old content or the new, never a torn half-write. The temp
    name carries the pid and the thread id: two writers in one process
    (worker threads) or in two processes never replace each other's
    half-written file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


@dataclasses.dataclass(frozen=True)
class RunPaths:
    """The serving plane's files under a workdir, with the reference's
    file names, so the port and the reference read and write one layout."""

    root: Path

    @property
    def events(self) -> Path:
        # the supervisor's durable event ledger (provision/events.py); the
        # gateway fleet records its slice leases on it
        return self.root / "supervisor-events.jsonl"

    @property
    def fleet_status(self) -> Path:
        # the supervisor's atomically rewritten fleet-status document: the
        # gateway routes and sheds by it
        return self.root / "fleet-status.json"

    @property
    def request_log(self) -> Path:
        # the gateway's durable request journal (serving/reqlog.py),
        # replayed by `Gateway.recover` after a restart
        return self.root / "serve-requests.jsonl"

    @property
    def demand_signal(self) -> Path:
        # the gateway's atomically rewritten demand signal (queue depth,
        # completion rate, recent p99 and sheds, per-slice in-flight)
        return self.root / "demand-signal.json"

    @property
    def span_log(self) -> Path:
        # the telemetry plane's span ledger (obs/trace.py)
        return self.root / "telemetry-spans.jsonl"

    @property
    def metrics_snapshot(self) -> Path:
        # the metrics registry's atomic JSON snapshot (obs/metrics.py),
        # written by serve drills at exit
        return self.root / "metrics.json"

    # ---- gateway-fleet artifacts (serving/fleet.py): each replica owns a
    # key-partition, its OWN request journal shard, and its own demand
    # signal; the merged views are folds over the globs below. The glob
    # patterns require the "-<replica>" suffix, so the single-gateway
    # files above are separate artifacts; the plural helpers return base
    # and shards together.

    def request_log_replica(self, replica) -> Path:
        return self.root / f"serve-requests-{replica}.jsonl"

    def demand_signal_replica(self, replica) -> Path:
        return self.root / f"demand-signal-{replica}.json"

    def request_logs(self) -> list:
        """Every request journal on disk: the single-gateway file (when
        present) plus the fleet's per-replica shards, sorted."""
        out = [self.request_log] if self.request_log.exists() else []
        return out + sorted(self.root.glob("serve-requests-*.jsonl"))

    def demand_signals(self) -> list:
        """Every demand signal on disk: single-gateway + per-replica."""
        out = [self.demand_signal] if self.demand_signal.exists() else []
        return out + sorted(self.root.glob("demand-signal-*.json"))
