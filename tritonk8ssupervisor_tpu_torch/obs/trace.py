"""End-to-end request tracing: durable spans over the EventLedger
discipline. The port's copy of `tritonk8ssupervisor_tpu/obs/trace.py`;
the analyzers that read the log are `obs/analyze.py` and the `trace` and
`analyze` commands of `cli/main.py`.

A request's p99 story spans three planes — admission and queue wait in
the gateway, prefill/decode occupancy in an engine, and (when a heal
wave or breaker hold stole the capacity) the supervisor's reconcile
loop. The request journal (serving/reqlog.py) already records WHAT
happened to a key; spans record WHERE THE TIME WENT, and supervisor
spans (tick, diagnose, heal, breaker transitions) record what the fleet
was doing meanwhile — `trace <key>` joins the two
(obs/analyze.py).

`SpanLog` subclasses `provision/events.EventLedger`, so the durability
surface is inherited, not copied: append + flush + fsync (spans survive
a SIGKILL landing on the next instruction), a torn FINAL line truncated
on replay (the interrupted write), mid-file corruption fatal,
newer-schema records skipped. `fsync=False` is the virtual-clock
harness mode, exactly as for the request journal.

Span schema of record (docs/observability.md):

    {"v": 1, "ts": ..., "kind": "span",
     "span": <name>,             # admission / queue-wait / prefill /
                                 # decode / requeue / expiry / complete /
                                 # replay / tick / diagnose / heal /
                                 # heal-wave / breaker / prefill-chunk
     "plane": "serving" | "supervisor",
     "start": t0, "end": t1,     # on the writer's clock; == for events
     "key": <idempotency key> | None,
     "incarnation": <writer incarnation>,  # distinguishes the gateway
                                 # before and after a crash-resume
     ...attrs}                   # span-specific fields (slice, where,
                                 # cause, reason, chunks, ...)

Emission policy keeps the hot paths clean: the gateway writes spans at
ADMISSION and at TERMINAL settle (complete/expire) — never per claim or
per step — so the reference's <5% overhead gate on the engine-step and
claim paths holds (BENCH_obs.json); dispatch-time detail lives in the
request journal's DISPATCHED records, which the trace reconstruction
joins in.
The REAL engine (serving/engine.py) additionally emits per-chunk
prefill spans: one JSONL line per compiled prefill dispatch is noise
next to real compute, and is exactly the "where did this 4k prompt's
prefill ride along" evidence the timeline wants.

The training step's plane writes no JSONL: a step issues dozens of
sublayer calls in a few hundred milliseconds, so its spans are
`torch.profiler` ranges (`annotate`), which exist only while a profiler
runs and cost one flag test otherwise. Their names:

    train.step       one call of a train step (parallel/train.py)
    train.forward    the model's forward (once per chunk or inner step)
    train.loss       loss and metrics from the logits, router losses
    train.backward   objective.backward()
    train.optimizer  the gradients' reduction and optimizer.step()
    model.embed      token plus position embedding (models/transformer.py)
    model.norm       one LayerNorm
    model.attention  a block's qkv, attention, output projection, residual
    model.mlp        a block's MLP (or MoE MLP) and residual
    model.head       the LM head

The profiler's clock is the Unix clock the serving plane's `Tracer`
writes (`Telemetry.for_run`: `time.time`), so a trace of steps lines up
with the span log.
"""

from __future__ import annotations

import contextlib
import time

from tritonk8ssupervisor_tpu_torch.provision.events import EventLedger

SPAN = "span"

SERVING = "serving"
SUPERVISOR = "supervisor"

_NULL = contextlib.nullcontext()
# torch's profiler flag, bound on the first `annotate`: the planes that do
# not train import this module without torch
_profiling = None


class SpanLog(EventLedger):
    """Durable span ledger: EventLedger's append/replay/scrub with a
    span-filtered read. Buffered in fsync=False mode — spans are the
    highest-volume ledger, nothing reads one mid-run except through
    replay() (which flushes the live writer first), and the in-process
    "kills" that mode exists for drop gateway objects, never this
    log."""

    _buffered = True

    def spans(self) -> list[dict]:
        return [r for r in self.replay() if r.get("kind") == SPAN]


class Tracer:
    """The write handle instrumentation sites hold. A Tracer with no
    log is DISABLED: every emit is a no-op costing one attribute test,
    so un-wired constructions (unit tests, benches without --obs) pay
    nothing. `incarnation` tags every span with which writer produced
    it — a restarted gateway bumps it, so a timeline shows spans from
    both sides of a crash."""

    def __init__(self, log: SpanLog | None, plane: str = SERVING,
                 clock=None, incarnation: int = 0) -> None:
        self.log = log
        self.plane = plane
        self._clock = clock if clock is not None else (
            log._clock if log is not None else time.time
        )
        self.incarnation = int(incarnation)

    @property
    def enabled(self) -> bool:
        return self.log is not None

    def now(self) -> float:
        return self._clock()

    def emit(self, span: str, start: float, end: float,
             key: str | None = None, **attrs) -> None:
        """One closed span [start, end] on the writer's clock."""
        if self.log is None:
            return
        self.log.append(
            SPAN, span=span, plane=self.plane,
            start=round(float(start), 6), end=round(float(end), 6),
            key=key, incarnation=self.incarnation,
            **{k: v for k, v in attrs.items() if v is not None},
        )

    def event(self, span: str, at: float, key: str | None = None,
              **attrs) -> None:
        """A point-in-time span (start == end): admissions, requeues,
        breaker transitions."""
        self.emit(span, at, at, key=key, **attrs)

    def emit_many(self, spans: list) -> None:
        """Batch emit: `spans` is [(name, start, end, key, attrs)].
        One lock/flush/fsync for the whole batch (EventLedger.
        append_many) — how the gateway settles a request's span set
        (queue-wait + prefill + decode + terminal) without paying one
        write per span on the serving loop."""
        if self.log is None or not spans:
            return
        self.log.append_many([
            (SPAN, {
                "span": name, "plane": self.plane,
                "start": round(float(start), 6),
                "end": round(float(end), 6),
                "key": key, "incarnation": self.incarnation,
                **{k: v for k, v in attrs.items() if v is not None},
            })
            for name, start, end, key, attrs in spans
        ])

    @contextlib.contextmanager
    def span(self, name: str, key: str | None = None, **attrs):
        """Context-manager form for code-shaped spans (tick, diagnose):
        times the body on the tracer's clock."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.emit(name, t0, self._clock(), key=key, **attrs)


def annotate(name: str):
    """A `torch.profiler.record_function(name)` range over the body while a
    torch profiler runs; otherwise a shared null context, after one flag
    test. A running profiler is the only switch: the benchmark's traced
    stretches and an operator's `--profile DIR` both turn the spans on."""
    global _profiling
    if _profiling is None:
        from torch._C._autograd import _profiler_enabled as _profiling
    if not _profiling():
        return _NULL
    import torch

    return torch.profiler.record_function(name)
