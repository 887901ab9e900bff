"""What the metric readers share: the run they read and the arithmetic
over the traced stretch that several of them take."""

from __future__ import annotations

import dataclasses
from types import ModuleType

from portbench import frozen
from portbench.trace import CardStretch, Trace
from portbench.window import Window

# the products of cuBLAS and cuDNN, as the profiler names their host ops
PRODUCT_OPS = frozenset((
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
    "aten::linear", "aten::_addmm_activation", "aten::einsum", "aten::convolution",
    "aten::convolution_backward",
))


@dataclasses.dataclass
class Run:
    """One run of a cell, as its metric readers see it."""

    cell: str
    config: dict
    traffic: dict
    family: ModuleType
    setup_s: float
    window: Window
    trace: Trace | None = None
    card: CardStretch | None = None

    def rate(self) -> float:
        """Items (tokens or images) trained a second over the window."""
        return self.family.items_per_step(self.traffic) * self.window.steps / self.window.seconds


def mfu_percent(run: Run) -> float:
    """The step's model FLOPs, counted from the shapes, over the window
    time at the H100's dense bf16 rate."""
    flops = run.family.model_flops_per_step(run.config, run.traffic) * run.window.steps
    return 100.0 * flops / (run.window.seconds * frozen.PEAK_BF16_FLOPS)


def is_optimizer(name: str) -> bool:
    return name.startswith("Optimizer.step#")


def is_port_kernel(name: str) -> bool:
    return name.startswith("tk8s::")


def is_product(name: str) -> bool:
    return name in PRODUCT_OPS


def ms_per_step(run: Run, match) -> float | None:
    """Device ms a traced step under the host ops that `match`; None where
    none ran."""
    seconds, calls = run.trace.op_seconds(match)
    return seconds * 1e3 / run.trace.steps if calls else None


def roofline_percent(run: Run, kernel: str, ops: tuple[str, ...]) -> float | None:
    """Σ bound over Σ device time of the port kernel `kernel`'s calls (host
    ops `ops`) in the traced stretch, the bounds from the family's calls
    of a step. None where the kernel did not run or its calls are not the
    family's."""
    calls = run.family.kernel_calls(run.config, run.traffic).get(kernel, [])
    seconds, count = run.trace.op_seconds(lambda name: name in ops)
    if not calls or not count or count != len(calls) * run.trace.steps or seconds <= 0:
        return None
    bound = sum(frozen.bound_s(n_bytes, operations) for n_bytes, operations in calls)
    return 100.0 * bound * run.trace.steps / seconds


def idle_percent(run: Run) -> float | None:
    """The share of the card-only traced stretch in which the card had no
    work: 1 - its busy seconds over its wall seconds, both of that one
    stretch. None where no such stretch was traced (no card)."""
    if run.card is None:
        return None
    return 100.0 * (1.0 - run.card.busy_s / run.card.window_s)
