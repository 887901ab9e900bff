"""The measured window: the port's step called back to back on the feed
for `seconds` of host time, each step's start marked by a CUDA event on
the stream (no host synchronise inside), the last step closed by one
more event, and the window closed by a synchronise. The window's time
runs from the synchronised start to the final synchronise."""

from __future__ import annotations

import dataclasses
import math
import time

import torch


@dataclasses.dataclass
class Window:
    steps: int
    seconds: float
    step_ms: list[float]

    def percentile_ms(self, share: float) -> float:
        """The step time that `share` of the steps do not exceed (nearest
        rank: 0.9 over 100 steps leaves ten steps above it)."""
        ordered = sorted(self.step_ms)
        return ordered[max(0, math.ceil(share * len(ordered)) - 1)]


class _Marks:
    """Step starts as CUDA events on the card; on the CPU (the harness's
    own tests) as host clock readings."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> list[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(step, feed: list, first: int, seconds: float, device: torch.device) -> Window:
    """Run step(feed[(first + i) % len(feed)]) for i = 0, 1, ... until
    `seconds` of host time have passed since the synchronised start."""
    marks = _Marks(device)
    synchronize(device)
    start = time.perf_counter()
    steps = 0
    while True:
        marks.mark()
        step(feed[(first + steps) % len(feed)])
        steps += 1
        if time.perf_counter() - start >= seconds:
            break
    marks.mark()
    synchronize(device)
    return Window(steps, time.perf_counter() - start, marks.gaps_ms())
