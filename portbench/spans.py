"""The card work of the traced stretch filed under the program's own spans.

While a profiler runs, the port marks its train steps and its LM with
profiler ranges (`tritonk8ssupervisor_tpu_torch/obs/trace.annotate`):
`train.step`, `train.forward`, `train.loss`, `train.backward` and
`train.optimizer` in `parallel/train.py`; `model.embed`, `model.norm`,
`model.attention`, `model.mlp` and `model.head` in `models/transformer.py`.
A kernel belongs to the host op that launched it, as in
`trace._device_us`: an op's own kernels count, an annotation's device span
and what the profiler files under its own events do not, so each kernel
counts once however the spans nest.

- `launched_ms`: the kernels whose launching op starts inside one of the
  spans, on any thread. The backward runs on autograd's device thread
  while the calling thread waits inside `train.backward`, so its ops count
  by their start time.
- `sublayer_ms`: the kernels of the ops inside the spans, plus those of
  the backward nodes that these ops made. A backward node carries the
  sequence number and the thread of the forward op that made it. Every op
  at the autograd level records the number the next node will take, made
  or not, so a number belongs to the last op of its thread that recorded
  it: the one that made the node.

Both give device ms a traced step, or None where the trace holds no such
span (a program without the spans).
"""

from __future__ import annotations

import bisect

from portbench.trace import _PROFILER_EVENTS


def _spans(trace, name: str) -> list:
    return [e for e in trace.host if e.is_user_annotation and e.name == name]


def _own_kernels(trace) -> list[tuple[object, float]]:
    """(op, µs of the kernels it launched) of every host op with kernels."""
    out = []
    for event in trace.host:
        if event.is_user_annotation or not event.kernels:
            continue
        ancestor = event
        while ancestor is not None and ancestor.name not in _PROFILER_EVENTS:
            ancestor = ancestor.cpu_parent
        if ancestor is None:
            out.append((event, sum(k.duration for k in event.kernels)))
    return out


def _merged(spans: list) -> list[list[float]]:
    intervals: list[list[float]] = []
    for start, end in sorted((s.time_range.start, s.time_range.end) for s in spans):
        if intervals and start <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], end)
        else:
            intervals.append([start, end])
    return intervals


def launched_ms(trace, name: str) -> float | None:
    """Device ms a traced step of the kernels launched by ops that start
    inside a `name` span, on any thread."""
    spans = _spans(trace, name)
    if not spans:
        return None
    intervals = _merged(spans)
    starts = [start for start, _ in intervals]
    total = 0.0
    for op, us in _own_kernels(trace):
        i = bisect.bisect_right(starts, op.time_range.start) - 1
        if i >= 0 and op.time_range.start <= intervals[i][1]:
            total += us
    return total * 1e-3 / trace.steps


def _backward(event) -> bool:
    return event.fwd_thread > 0 and event.sequence_nr >= 0


def _inside(event, spans: set) -> bool:
    while event is not None:
        if id(event) in spans:
            return True
        event = event.cpu_parent
    return False


def _node(event):
    """The innermost backward node at or above `event`, or None."""
    while event is not None and not _backward(event):
        event = event.cpu_parent
    return event


def sublayer_ms(trace, name: str) -> float | None:
    """Device ms a traced step of the ops inside `name` spans and of the
    backward nodes those ops made."""
    spans = {id(s) for s in _spans(trace, name)}
    if not spans:
        return None
    maker: dict = {}  # (thread, sequence number) -> the last forward op that recorded it
    for event in sorted(trace.host, key=lambda e: e.time_range.start):
        if event.sequence_nr >= 0 and not _backward(event):
            maker[(event.thread, event.sequence_nr)] = event
    made = {key for key, op in maker.items() if _inside(op, spans)}
    total = 0.0
    for op, us in _own_kernels(trace):
        node = _node(op)
        if _inside(op, spans) or (node is not None
                                  and (node.fwd_thread, node.sequence_nr) in made):
            total += us
    return total * 1e-3 / trace.steps
