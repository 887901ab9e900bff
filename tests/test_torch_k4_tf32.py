"""The arithmetic plan of K4's TF32 instance (`csrc/conv_backward_tf32.cu`),
emulated in plain torch on the CPU and held against float64.

The kernel takes dX = dY W and dW = dY^T X on the tensor cores: in float32
("tf32x3") every product as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) of the
split hi = TF32(x), lo = x - hi (`mm3` of tests/test_torch_tf32x3.py); in
bf16 and fp16 ("tf32x1") one TF32 product, exact for such values. A
contraction shorter than K_MIN = 16 (N for dX, M for dW) is summed with f32
FMAs instead. Here the plan is held to K4's f32 contract, the f32 FMA sum's
elementwise bound 1.01 K 2^-24 (|A||B|)_64 (`_k4_bound_ratio`, the card
tests' bound), and its split of M for dW (`tf32_split`) to its rules. The
JAX package is not involved: the yardstick is float64.
"""

import numpy as np
import pytest
import torch
from test_torch_f32_kernels import _k4_bound_ratio
from test_torch_tf32x3 import _rna, _split, mm3

from tritonk8ssupervisor_tpu_torch.ops import conv_backward_cuda

K_MIN = conv_backward_cuda.K_MIN


def k4_plan(x2, dy2, w2, mm=mm3):
    """(dX, dW) of f32 X (M, C), dY (M, N), W (N, C) as the kernel takes
    them: each product through `mm` where its contraction is K_MIN or
    longer, else an f32 sum of exact products."""
    m, n = dy2.shape
    dx = mm(dy2, w2) if n >= K_MIN else dy2 @ w2
    dw = mm(dy2.t(), x2) if m >= K_MIN else dy2.t() @ x2
    return dx, dw


def _inputs(m, c, n, seed):
    rng = np.random.default_rng(seed)
    x2, dy2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((m, c), (m, n)))
    w2 = torch.from_numpy((rng.normal(size=(n, c)) / c ** 0.5).astype(np.float32))
    return x2, dy2, w2


# the shapes of tests/test_torch_f32_kernels.py's bound test, the card
# tests' narrow and wide ones, and short contractions on either side of
# K_MIN: N in {1, 2, 4, 8, 13} (dX by FMAs), M in {1, 3} (dW by FMAs)
PLAN_SHAPES = [(300, 3, 13), (2000, 100, 36), (4096, 64, 256), (1000, 3, 13), (4099, 100, 36),
               (128, 24, 32), (20000, 64, 64), (1000, 3, 1), (1000, 5, 2), (1000, 5, 4),
               (1000, 24, 8), (1000, 24, 16), (1, 64, 64), (3, 64, 64), (3, 7, 5), (16, 40, 72)]


@pytest.mark.parametrize("m,c,n", PLAN_SHAPES, ids=lambda v: str(v))
def test_k4_tf32_plan_meets_the_f32_bound(m, c, n):
    x2, dy2, w2 = _inputs(m, c, n, seed=m + c + n)
    assert _k4_bound_ratio(*k4_plan(x2, dy2, w2), x2, dy2, w2) <= 1.0


@pytest.mark.parametrize("n", [1, 2])
def test_plain_3xtf32_misses_the_bound_at_short_contractions(n):
    """Without the FMA path a 3xTF32 dX at N = 1 or 2 misses the bound: the
    split's ~2^-21 of |a||b| does not shrink with K, the bound does."""
    x2, dy2, w2 = _inputs(1000, 5, n, seed=n)
    dx = mm3(dy2, w2)
    dw = dy2.t() @ x2
    assert _k4_bound_ratio(dx, dw, x2, dy2, w2) > 1.0


def _truncate(x64: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero."""
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mm3_truncating(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`mm3` as the kernel issues it, with the tensor cores' sums modelled as
    truncating: per k-step of 8, the accumulator plus the step's exact
    products of lo hi, then of hi lo, then of hi hi, each sum cut to f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        step = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _truncate(acc.double() + x[:, step].double() @ y[step].double())
    return acc


def _worst_truncating_ratio(k: int) -> float:
    """The largest bound ratio of a truncating 3xTF32 dX over 5 seeds at
    contraction length k."""
    worst = 0.0
    for seed in range(5):
        x2, dy2, w2 = _inputs(2000, 64, k, seed=seed)
        dx = mm3_truncating(dy2, w2)
        worst = max(worst, _k4_bound_ratio(dx, dy2.t() @ x2, x2, dy2, w2))
    return worst


def test_k_min_keeps_truncating_sums_within_half_the_bound():
    """K_MIN = 16: with truncating sums the plan reads above half the bound
    at K = 8 and within half of it from K = 16 up (0.39 there, 0.24 at 32)."""
    assert K_MIN == 16
    assert _worst_truncating_ratio(8) > 0.5
    for k in (16, 32):
        assert _worst_truncating_ratio(k) <= 0.5, k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_one_tf32_product_of_16_bit_values_is_exact(dtype):
    """bf16 and fp16 values (fp16's subnormals among them) are TF32 values,
    so one TF32 product is their exact product: the f32 product of the
    rounded values equals the float64 product of the values."""
    rng = np.random.default_rng(5)
    scale = 10.0 ** rng.uniform(-7, 4, size=20000)
    a, b = (torch.from_numpy(rng.normal(size=20000) * scale).to(dtype).float() for _ in range(2))
    if dtype == torch.float16:
        assert ((a != 0) & (a.abs() < 2.0 ** -14)).any()  # subnormals, exactly represented
    assert torch.equal(_rna(a), a) and torch.equal(_rna(b), b)
    assert torch.equal((_rna(a) * _rna(b)).double(), a.double() * b.double())


WAVE = conv_backward_cuda.WAVE


def _tiles(c: int, n: int) -> int:
    wide, narrow = max(c, n), min(c, n)
    return -(-wide // 128) * -(-narrow // conv_backward_cuda.tf32_tile(narrow))


# (M, C, N) -> (splits, rows): ResNet-50's stage 1 at one tile, stage 3 at
# 64, the narrow bf16 rows at one (short serial loops: 4 and 12 stages)
SPLITS = [((802816, 64, 64), (132, 6112)), ((12544, 2048, 512), (2, 6272)),
          ((4096, 100, 36), (32, 128)), ((50176, 3, 13), (131, 384)),
          ((200704, 128, 512), (33, 6112)), ((10, 3, 13), (1, 32))]


@pytest.mark.parametrize("shape,expected", SPLITS, ids=lambda v: str(v))
def test_tf32_split_plan(shape, expected):
    """The TF32 dW's split of M: a fixed function of the shape (the same for
    both routes), whole 32-row stages and at least 4 a split unless M is
    shorter, covering M with no empty split, and no more items than one wave
    (132 SMs) unless one split already has more."""
    m, c, n = shape
    splits, rows = conv_backward_cuda.tf32_split(m, c, n)
    assert (splits, rows) == expected == conv_backward_cuda.tf32_split(m, c, n)
    assert conv_backward_cuda.instance(torch.float32, c, n) == "tf32x3"
    assert rows % 32 == 0 and (splits - 1) * rows < m <= splits * rows
    assert rows >= min(128, -(-m // 32) * 32)
    assert splits * _tiles(c, n) <= max(WAVE, _tiles(c, n))
    assert conv_backward_cuda.tf32_split(0, c, n) == (1, 0)


def test_tf32_tile_is_the_narrowest_that_holds_the_width():
    """Q columns take a 64-wide tile where it holds them, else 128-wide ones,
    so a width of 64 (ResNet-50's stage 1) is a 128 x 64 tile."""
    assert [conv_backward_cuda.tf32_tile(q) for q in (1, 13, 64, 65, 100, 128, 129, 256, 512)] \
        == [64, 64, 64, 128, 128, 128, 128, 128, 128]
