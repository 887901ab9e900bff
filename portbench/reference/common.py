"""What both references share: the products' precision, SGD with Nesterov
momentum written out, and the per-leaf norms the comparison reads."""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Iterator

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """Float32 products as float32: TF32 off for matmuls and cuDNN, set
    back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to an 8-bit float with one per-tensor scale (its largest
    magnitude maps to the format's largest), returned in x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3. Backward: the gradient passes
    unchanged (the product's own backward already saw rounded operands)."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: unchanged. Backward: the incoming gradient rounded to e5m2,
    so the product's backward products take an 8-bit dY."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """How a reference computes its products (matmuls and convolutions).

    "float32": exact float32 (the reference). "fp8": each product's two
    operands rounded to e4m3 and its output's gradient to e5m2, each with
    a per-tensor scale, the products then summed in float32: the usual
    8-bit training recipe, one step below the configurations' bf16
    compute, and the comparison's control."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: expected 'float32' or 'fp8'")
        self.name = name

    def product(self, fn: Callable, a: torch.Tensor, b: torch.Tensor, *args, **kwargs):
        """fn(a, b, ...) at this precision."""
        if self.name == "float32":
            return fn(a, b, *args, **kwargs)
        return _Fp8Grad.apply(fn(_Fp8Operand.apply(a), _Fp8Operand.apply(b), *args, **kwargs))


def sgd_nesterov_(params: list[torch.Tensor], grads: list[torch.Tensor],
                  buffers: list[torch.Tensor | None], lr: float, momentum: float) -> None:
    """One SGD step with Nesterov momentum and no dampening, in place: the
    buffer starts as the first gradient, then b = m b + g; p -= lr (g + m b)."""
    for i, (p, g) in enumerate(zip(params, grads)):
        if buffers[i] is None:
            buffers[i] = g.clone()
        else:
            buffers[i].mul_(momentum).add_(g)
        p.sub_(lr * (g + momentum * buffers[i]))


def leaf_norms(tensors: Iterable[torch.Tensor]) -> list[float]:
    """The norm of each tensor, summed in float64, on the host; one tensor
    at a time, so a generator of differences holds one at most."""
    return [float(torch.linalg.vector_norm(t, dtype=torch.float64)) for t in tensors]
