"""The traced stretch of a `--trace 1` run and its reduction: a few steady
steps under `torch.profiler`, read from the profiler's events.

- Work on the card is every CUDA-side event that is not a user
  annotation's device span (`frozen.is_card_work`); its busy time is the
  sum of their durations inside the traced window, the arithmetic of the
  port's `utils/perf.card_work` readers. The window is the
  `portbench.window` range on the profiler's clock: it opens on a
  synchronised card and closes with a synchronise.
- An operator's device time is the summed duration of the kernels launched
  under the outermost host events that match it (a kernel launched inside
  nested matches counts once). `torch.library` custom ops with an autograd formula record under
  their generated Function's name, `GeneratedBackwardFor_tk8s_<op>_default`,
  which reads as `tk8s::<op>`.
- Idle gaps are the stretches of the window in which no card work ran,
  named by the innermost host event running at the gap's middle.

The card's busy and wall time come from a stretch of their own
(`capture_card`), traced for the card's work alone: recording every
host op costs a ResNet step more host time than it has to spare, so a
stretch traced with them idles the card for the profiler's sake.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time
from typing import Callable

import torch

from portbench.frozen import is_card_work

WINDOW = "portbench.window"
_GENERATED = re.compile(r"^GeneratedBackwardFor_(tk8s)_(.+)_default$")
# the profiler's own host events: the kernels it files under them were
# launched by other ops (under "Command Buffer Full", those that ran while
# a launch waited for room in the queue), so they count under those ops
_PROFILER_EVENTS = ("Command Buffer Full", "Activity Buffer Request")
NAME_CHARS = 160


def op_name(name: str) -> str:
    match = _GENERATED.match(name)
    return f"{match.group(1)}::{match.group(2)}" if match else name


def _device_us(event) -> float:
    """The kernels launched under a host event and its children. A user
    annotation's own entry is its device span, first kernel to last with
    the gaps between them, so only its children's kernels count."""
    if event.name in _PROFILER_EVENTS:
        return 0.0
    own = 0.0 if event.is_user_annotation else sum(k.duration for k in event.kernels)
    return own + sum(_device_us(child) for child in event.cpu_children)


@dataclasses.dataclass
class Trace:
    """The reduced stretch: `steps` steps in a window of `window_s` seconds."""

    steps: int
    window_s: float
    busy_s: float
    host: list          # host-side events inside the window
    device: list        # card work inside the window
    start_us: float
    end_us: float

    def op_seconds(self, match: Callable[[str], bool]) -> tuple[float, int]:
        """(device seconds, calls) of the host events whose operator name
        matches, outermost matches only."""
        total, calls = 0.0, 0
        for event in self.host:
            if not match(op_name(event.name)):
                continue
            parent, nested = event.cpu_parent, False
            while parent is not None:
                if match(op_name(parent.name)):
                    nested = True
                    break
                parent = parent.cpu_parent
            if not nested:
                total += _device_us(event)
                calls += 1
        return total * 1e-6, calls

    def breakdown(self, top: int = 10) -> dict:
        """{"device_ops": the kernels that took most time, "idle_gaps": the
        longest stretches without card work, by what the host ran}, in
        seconds over the traced window."""
        by_kernel: dict = collections.defaultdict(float)
        for e in self.device:
            by_kernel[e.name[:NAME_CHARS]] += e.time_range.elapsed_us() * 1e-6
        ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps(top)]}

    def idle_gaps(self, top: int = 10) -> list[tuple[str, float]]:
        """The `top` longest stretches of the window without card work,
        each named by the innermost host event running at its middle."""
        spans = sorted((e.time_range.start, e.time_range.end) for e in self.device)
        gaps, cursor = [], self.start_us
        for start, end in spans:
            if start > cursor:
                gaps.append((cursor, start))
            cursor = max(cursor, end)
        if self.end_us > cursor:
            gaps.append((cursor, self.end_us))
        named = []
        for start, end in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            middle = (start + end) / 2
            running = [e for e in self.host if e.time_range.start <= middle <= e.time_range.end]
            inner = max(running, key=lambda e: e.time_range.start, default=None)
            named.append((op_name(inner.name)[:NAME_CHARS] if inner else "host: none",
                          (end - start) * 1e-6))
        return named


def capture(run_steps: Callable[[int], None], steps: int) -> Trace:
    """Trace `steps` steps after one untraced-in-the-window step that
    takes the profiler's own start-up."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run_steps(1)
        torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            run_steps(steps)
            torch.cuda.synchronize()
    events = list(prof.events())
    ranges = [e for e in events if e.name == WINDOW and e.device_type != torch.autograd.DeviceType.CUDA]
    if len(ranges) != 1:
        raise RuntimeError(f"expected one {WINDOW} range in the trace, found {len(ranges)}")
    lo, hi = ranges[0].time_range.start, ranges[0].time_range.end

    def overlap(e) -> float:
        return max(0.0, min(e.time_range.end, hi) - max(e.time_range.start, lo))

    device = [e for e in events if is_card_work(e) and overlap(e) > 0]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and lo <= e.time_range.start <= hi and e.name != WINDOW]
    busy_s = sum(overlap(e) for e in device) * 1e-6
    return Trace(steps, (hi - lo) * 1e-6, busy_s, host, device, lo, hi)


@dataclasses.dataclass
class CardStretch:
    """`steps` steps traced for the card's work alone: `busy_s` of work on
    the card in `window_s` of wall time, both of this stretch."""

    steps: int
    busy_s: float
    window_s: float


def capture_card(run_steps: Callable[[int], None], steps: int) -> CardStretch:
    """Trace `steps` steps with the profiler's CUDA activity only, after one
    step in its warm-up stage (traced, then dropped) that takes its
    start-up. The stretch opens on a synchronised card and closes with a
    synchronise; its wall time is the host clock's between the two."""
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=schedule) as prof:
        run_steps(1)
        torch.cuda.synchronize()
        prof.step()
        start = time.perf_counter()
        run_steps(steps)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - start
        prof.step()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events() if is_card_work(e))
    return CardStretch(steps, busy_us * 1e-6, window_s)
