"""The telemetry plane of the port: the metrics registry (`metrics.py`),
durable spans (`trace.py`) and the `Telemetry` bundle that the gateway, the
engine and the server share. The port's copy of
`tritonk8ssupervisor_tpu/obs/__init__.py` (:44-96); the analyzers
(`obs/analyze.py`) are not ported yet (ROADMAP.md, item 7d-2).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

from tritonk8ssupervisor_tpu_torch.obs.metrics import MetricsRegistry
from tritonk8ssupervisor_tpu_torch.obs.trace import (
    SERVING,
    SUPERVISOR,
    SpanLog,
    Tracer,
)

__all__ = [
    "MetricsRegistry",
    "SpanLog",
    "Tracer",
    "Telemetry",
    "SERVING",
    "SUPERVISOR",
]


@dataclasses.dataclass
class Telemetry:
    """What an instrumented component holds: a metrics registry (always
    real: report()-style surfaces read their counts from it even when
    nothing scrapes) and a tracer (disabled unless a span log is wired).
    `snapshot_path` set means `write_snapshot()` publishes the registry
    as atomic JSON (metrics.json)."""

    metrics: MetricsRegistry
    tracer: Tracer
    snapshot_path: Path | None = None

    @classmethod
    def off(cls, clock=time.monotonic) -> "Telemetry":
        """The un-wired default: live registry, disabled tracer. What the
        gateway constructs when nothing is passed, so the counter-backed
        report paths always work."""
        return cls(MetricsRegistry(clock=clock), Tracer(None, clock=clock))

    @classmethod
    def for_run(
        cls,
        paths,
        clock=time.time,
        plane: str = SERVING,
        fsync: bool = True,
        incarnation: int = 0,
        echo=lambda line: print(line, file=sys.stderr, flush=True),
    ) -> "Telemetry":
        """The wired form over a workdir's `RunPaths`: spans to
        paths.span_log, snapshots to paths.metrics_snapshot. `fsync=False`
        is the virtual-clock harness mode, same as the request journal's."""
        log = SpanLog(paths.span_log, clock=clock, echo=echo, fsync=fsync)
        return cls(
            MetricsRegistry(clock=clock),
            Tracer(log, plane=plane, clock=clock, incarnation=incarnation),
            snapshot_path=paths.metrics_snapshot,
        )

    def bump_incarnation(self) -> int:
        """A restarted writer (gateway crash-resume) announces itself:
        spans after this carry the new incarnation, so a timeline shows
        both lives of the process."""
        self.tracer.incarnation += 1
        return self.tracer.incarnation

    def write_snapshot(self) -> dict | None:
        if self.snapshot_path is None:
            return None
        return self.metrics.write_snapshot(self.snapshot_path)
