"""The training cells' set-up steps and the comparison that decides
`correct`.

Set-up builds the port's step once, drives it through its first
`CHECKED_STEPS` steps on distinct batches of the feed, and records what
the comparison reads: each step's loss, each leaf's norm of the first
gradient as the optimizer got it (its momentum buffer after one step,
which SGD starts at the first gradient) and each leaf's norm of the
change of the parameters after the checked steps. The same object then
runs the measured window. Once the window has closed, the reference
follows the same steps from the same weights and batches, and the
numbers that the cell's `limits` name (`portbench/workloads/<cell>.json`)
are compared, each against its limit:

- `loss_gap`: the largest |loss - reference loss| / |reference loss| of
  the checked steps;
- `grad_gap`: over the leaves, the largest gap between the two norms of
  the first gradient, over the larger of the reference's norm of that
  leaf and of the median leaf;
- `change_gap`: the same for the change after the checked steps, over
  the leaves that the reference's gradient moves: a leaf whose gradient
  norm stays under a thousandth of the median leaf's at every step moves
  by round-off alone and is left out;
- `change_diff_median`: over the same leaves, the median (the lower
  middle leaf) of the norm of the difference between the two sides'
  parameters after the checked steps, over the same scale as
  `change_gap`. A gap of norms sees zero-mean rounding in the products
  only at second order, the difference at first; the median leaf is
  steady from seed to seed where the largest is one small leaf's noise.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch

from portbench.reference.common import Precision, exact_float32, leaf_norms, sgd_nesterov_

CHECKED_STEPS = 3
NEGLIGIBLE_GRAD = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_diff_median")


@dataclasses.dataclass
class Readings:
    """What one side of the comparison produced, leaf lists in the order
    of `names`."""

    names: list[str]
    losses: list[float]
    first_grad: list[float]
    change: list[float]
    # the reference's gradient norm of each leaf at each step (the rule
    # that leaves round-off-only leaves out of `change_gap`)
    step_grads: list[list[float]] = dataclasses.field(default_factory=list)
    # each leaf after the checked steps, float32 on the host
    params: dict | None = None


def _momentum_norms(optimizer: torch.optim.Optimizer, params: list[torch.Tensor]) -> list[float]:
    bufs = [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]
    return [0.0 if b is None else leaf_norms([b])[0] for b in bufs]


def _change_norms(params: list[torch.Tensor], initial: dict, names: list[str]) -> list[float]:
    with torch.no_grad():
        return leaf_norms(p.detach() - initial[n] for p, n in zip(params, names))


def program_first_steps(program, feed: list, initial_weights) -> Readings:
    """Drive the port's step through the checked steps on feed[0..] and
    read it. `initial_weights()` makes the weights the program started
    from again."""
    names = [n for n, _ in program.named_params]
    params = [p for _, p in program.named_params]
    losses, first_grad = [], None
    for i in range(CHECKED_STEPS):
        metrics = program.step(feed[i])
        losses.append(metrics["loss"].detach())
        if i == 0:
            first_grad = _momentum_norms(program.optimizer, params)
    change = _change_norms(params, initial_weights(), names)
    final = {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in zip(names, params)}
    return Readings(names, [float(x) for x in losses], first_grad, change, params=final)


def reference_steps(family, config: dict, traffic: dict, seed: int, device,
                    precision: str = "float32", batch_share: float = 1.0,
                    steps: int = CHECKED_STEPS) -> Readings:
    """The reference through the checked steps from the weights and batches
    of `seed`, at `precision`, with every float32 product exact (TF32 off
    for matmuls and cuDNN); `batch_share` < 1 plants the half-batch fault
    in it."""
    with exact_float32():
        return _reference_steps(family, config, traffic, seed, device, Precision(precision),
                                batch_share, steps)


def _reference_steps(family, config: dict, traffic: dict, seed: int, device, prec: Precision,
                     batch_share: float, steps: int) -> Readings:
    weights = family.make_weights(config, traffic, seed, device)
    names = list(weights)
    leaves = {n: t.detach().clone().requires_grad_() for n, t in weights.items()}
    del weights
    lr, momentum = config["learning_rate"], config["momentum"]
    buffers: list = [None] * len(names)
    losses, step_grads = [], []
    for i in range(steps):
        batch = family.make_batch(config, traffic, seed, i, device)
        loss = family.reference_loss(leaves, batch, config, prec, batch_share)
        grads = [leaves[n].grad for n in names]
        step_grads.append(leaf_norms(grads))
        losses.append(float(loss))
        with torch.no_grad():
            sgd_nesterov_([leaves[n] for n in names], grads, buffers, lr, momentum)
        for n in names:
            leaves[n].grad = None
    change = _change_norms([leaves[n] for n in names],
                           family.make_weights(config, traffic, seed, device), names)
    final = {n: leaves[n].detach().to("cpu", torch.float32, copy=True) for n in names}
    return Readings(names, losses, step_grads[0], change, step_grads, final)


def _worst_leaf(side: list[float], ref: list[float], keep: list[bool]) -> tuple[float, int]:
    kept = [r for r, k in zip(ref, keep) if k]
    median = statistics.median(kept) if kept else 0.0
    worst, where = 0.0, -1
    for i, (s, r, k) in enumerate(zip(side, ref, keep)):
        if not k:
            continue
        scale = max(r, median)
        gap = abs(s - r) / scale if scale > 0 else (0.0 if s == r else math.inf)
        if not math.isfinite(s):
            gap = math.inf
        if gap > worst or where < 0:
            worst, where = gap, i
    return worst, where


def compare(side: Readings, ref: Readings) -> dict:
    """{number: (value, what it was read at)} for `NUMBERS`."""
    if side.names != ref.names:
        raise ValueError("the two sides' leaves differ: "
                         f"{sorted(set(side.names) ^ set(ref.names))[:5]}")
    loss_gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                 for a, b in zip(side.losses, ref.losses)]
    loss_gap = max(loss_gaps)
    everywhere = [True] * len(ref.names)
    grad_gap, grad_at = _worst_leaf(side.first_grad, ref.first_grad, everywhere)
    peak = [max(g[i] for g in ref.step_grads) for i in range(len(ref.names))]
    floor = NEGLIGIBLE_GRAD * statistics.median(peak)
    moved = [p >= floor for p in peak]
    change_gap, change_at = _worst_leaf(side.change, ref.change, moved)
    numbers = {
        "loss_gap": (loss_gap, f"step {loss_gaps.index(loss_gap) + 1}"),
        "grad_gap": (grad_gap, ref.names[grad_at]),
        "change_gap": (change_gap, ref.names[change_at]),
    }
    if side.params is not None and ref.params is not None:
        diffs = sorted(_diff_gaps(side, ref, moved))
        middle, middle_at = diffs[(len(diffs) - 1) // 2]
        numbers["change_diff_median"] = (middle, ref.names[middle_at])
    return numbers


def _diff_gaps(side: Readings, ref: Readings, keep: list[bool]) -> list[tuple[float, int]]:
    """(gap, index) of each kept leaf: the norm of the difference of the two
    sides' parameters over the larger of the reference's change of that
    leaf and of the median kept leaf."""
    median = statistics.median(r for r, k in zip(ref.change, keep) if k)
    gaps = []
    for i, (name, k) in enumerate(zip(ref.names, keep)):
        if not k:
            continue
        diff = float(torch.linalg.vector_norm(side.params[name] - ref.params[name],
                                              dtype=torch.float64))
        scale = max(ref.change[i], median)
        gap = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
        gaps.append((gap if math.isfinite(gap) else math.inf, i))
    return gaps


@dataclasses.dataclass
class Program:
    """The port's training step as the window drives it: `step(batch)`
    runs one optimizer step; `named_params` lists the model's leaves in
    the order of the family's weights."""

    state: object
    step: object
    named_params: list
    optimizer: torch.optim.Optimizer


def make_flat_weights(leaves: list[tuple[str, tuple, str, float]], seed: int, device,
                      stream: str = "weights") -> dict:
    """The weights of `leaves` ((name, shape, kind, std) with kind "normal",
    "ones" or "zeros") made on `device` from the seed: every normal leaf a
    view of one float32 draw, scaled by its std."""
    from portbench.seeds import generator

    sizes = [math.prod(shape) for _, shape, kind, _ in leaves if kind == "normal"]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device), device=device)
    out, offset = {}, 0
    for name, shape, kind, std in leaves:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(std)
            offset += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"leaf {name}: unknown kind {kind!r}")
    return out


def load_program(model: torch.nn.Module, weights: dict, state, step) -> Program:
    """Fill the model's leaves (made on the meta device and moved with
    `to_empty`) with `weights`, by name; every leaf must be named there
    with its shape."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("the port's leaves and the family's differ: "
                         f"{sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for name, w in weights.items():
            if params[name].shape != w.shape:
                raise ValueError(f"{name}: port {tuple(params[name].shape)}, family {tuple(w.shape)}")
            params[name].copy_(w)
    return Program(state, step, [(n, params[n]) for n in weights], state.optimizer)
