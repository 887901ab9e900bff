"""The arithmetic plan of K2's float32 instance (`csrc/flash_attention_tf32.cu`),
emulated in plain torch on the CPU and held against float64.

The kernel splits every f32 operand x into hi = TF32(x) (round to nearest,
ties away: cvt.rna) and lo = x - hi, which the tensor cores read at TF32's
19 bits (truncated), and takes each product as lo(a) hi(b) + hi(a) lo(b) +
hi(a) hi(b) into an f32 accumulator. The softmax, the row sums D =
rowsum(dO * O) and the scaling stay in f32 on the CUDA cores; dS of a row
with a single key is set to 0, its exact value. Here every product goes
through that split (`mm3`) or through one TF32 product (`mm1`), and the
results are held to the f32 bound the card tests use (`K2_F32_REL`, from
tests/test_torch_f32_kernels.py): the 3xTF32 plan meets it at the shapes of
that file's bound test and at head_dim 256, a single TF32 product misses it.
The JAX package is not involved: the yardstick is float64.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_f32_kernels import K2_F32_REL, _tf32

from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa


def _rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 explicit mantissa bits, to nearest with ties
    away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as the tensor cores read them: hi rounded, lo = x - hi (exact
    in f32) cut to TF32."""
    hi = _rna(x)
    return hi, _tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products in f32, the small terms first."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product in f32."""
    return _rna(a) @ _rna(b)


def _bhsd(x, layout):
    return x if layout == "bhsd" else x.transpose(1, 2)


def _mask(s: int, causal: bool) -> torch.Tensor:
    pos = torch.arange(s)
    return pos[:, None] < pos[None, :] if causal else torch.zeros(s, s, dtype=torch.bool)


def attention_split(q, k, v, dout, causal: bool, layout: str, mm, zero_single_key: bool = True):
    """O, dq, dk, dv of exact softmax attention with every product taken by
    `mm`, the rest in f32 as the kernel takes it: O = (P V) / l from the
    running max and sum, P recomputed from the logsumexp in the backward,
    dS = P (dP - D) with D = rowsum(dO * O), dS = 0 in a single-key row."""
    q, k, v, dout = (_bhsd(x, layout) for x in (q, k, v, dout))
    s, d = q.shape[-2], q.shape[-1]
    scale = d ** -0.5
    mask = _mask(s, causal)
    scores = (mm(q, k.transpose(-1, -2)) * scale).masked_fill(mask, float("-inf"))
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, v) / l
    lse = m + torch.log(l)
    p = torch.exp((mm(q, k.transpose(-1, -2)) * scale).masked_fill(mask, float("-inf")) - lse)
    dp = mm(dout, v.transpose(-1, -2))
    rows = (dout * out).sum(-1, keepdim=True)
    ds = p * (dp - rows)
    if zero_single_key:
        single = (~mask).sum(-1) == 1  # a causal row 0, every row of a one-token sequence
        ds = ds.masked_fill(single[:, None], 0.0)
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    dv = mm(p.transpose(-1, -2), dout)
    return {name: _bhsd(x, layout) for name, x in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


def _f64(q, k, v, dout, causal, layout):
    q, k, v = (x.double().requires_grad_(True) for x in (q, k, v))
    out = fa.attention_f64(q, k, v, causal, layout)
    out.backward(dout.double())
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _inputs(b, s, h, d, layout, seed):
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(4)]


# the shapes of tests/test_torch_f32_kernels.py's bound test, and head_dim
# 256 (the widest the kernel takes)
SHAPES = [(2, 65, 3, 40, True, "bshd"), (1, 130, 2, 96, False, "bhsd"),
          (1, 100, 2, 256, True, "bshd")]


def _errors(got, ref):
    """{output: (max |got - f64|, bound)}."""
    return {name: ((got[name].double() - ref[name]).abs().max().item(),
                   rel * ref[name].abs().max().item())
            for name, rel in K2_F32_REL.items()}


@pytest.mark.parametrize("b,s,h,d,causal,layout", SHAPES, ids=lambda v: str(v))
def test_3xtf32_attention_meets_the_f32_bound(b, s, h, d, causal, layout):
    """Every output within K2_F32_REL of float64, with a tenth of it to
    spare: the margin the kernel's own errors show on the card."""
    q, k, v, dout = _inputs(b, s, h, d, layout, seed=s + d)
    errors = _errors(attention_split(q, k, v, dout, causal, layout, mm3),
                     _f64(q, k, v, dout, causal, layout))
    for name, (err, bound) in errors.items():
        assert err <= bound / 10, (name, err, bound)


@pytest.mark.parametrize("b,s,h,d,causal,layout", SHAPES, ids=lambda v: str(v))
def test_single_tf32_attention_misses_the_f32_bound(b, s, h, d, causal, layout):
    """The same plan with one TF32 product each misses the bound at every
    output: the split is what keeps the kernel within it."""
    q, k, v, dout = _inputs(b, s, h, d, layout, seed=s + d)
    errors = _errors(attention_split(q, k, v, dout, causal, layout, mm1),
                     _f64(q, k, v, dout, causal, layout))
    for name, (err, bound) in errors.items():
        assert err > bound, (name, err, bound)


@pytest.mark.parametrize("s,causal", [(1, True), (1, False), (33, True)])
def test_single_key_rows_have_exactly_zero_dq_and_dk(s, causal):
    """A row with one key has dS = 0 in the function; the plan sets it so,
    and where every row has one key (a one-token sequence) dq and dk are
    exactly 0, as float64's are, so a bound of 0 holds. With a longer causal
    sequence row 0's dq is exactly 0."""
    q, k, v, dout = _inputs(2, s, 2, 256, "bshd", seed=s)
    got = attention_split(q, k, v, dout, causal, "bshd", mm3)
    ref = _f64(q, k, v, dout, causal, "bshd")
    assert torch.equal(got["dq"][:, 0], torch.zeros_like(got["dq"][:, 0]))
    assert torch.equal(ref["dq"][:, 0], torch.zeros_like(ref["dq"][:, 0]))
    if s == 1:
        for name in ("dq", "dk"):
            assert torch.equal(got[name], torch.zeros_like(got[name])), name
            assert not ref[name].any(), name
        # D from the CUDA cores and dP from the tensor cores do not cancel
        # bit for bit: without the zero, a bound of 0 would be missed
        unset = attention_split(q, k, v, dout, causal, "bshd", mm3, zero_single_key=False)
        assert unset["dq"].abs().max() > 0
    for name, (err, bound) in _errors(got, ref).items():
        assert err <= bound, (name, err, bound)


def test_the_split_keeps_22_bits():
    """hi + lo reproduces x to 2^-21 of |x| (hi to 2^-11, lo's cut another
    2^-11 of that), where hi alone is off by up to 2^-12."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=100_000).astype(np.float32) * 10.0 ** rng.uniform(
        -20, 20, size=100_000).astype(np.float32))
    hi, lo = _split(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all() and (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21
    rel_hi = ((hi.double() - x.double()).abs() / x.double().abs()).max().item()
    assert 2.0 ** -13 < rel_hi <= 2.0 ** -11


def test_tf32_rounding_is_to_nearest_with_ties_away():
    """cvt.rna: 1 + 2^-11 (a tie) rounds up to 1 + 2^-10, and -(1 + 2^-11)
    down to its negative; 1 + 2^-11 - 2^-23 rounds to 1."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23, 3.0],
                     dtype=torch.float32)
    assert _rna(x).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0]


@pytest.mark.parametrize("m,n,kdim", [(64, 32, 64), (64, 64, 32), (64, 64, 256)])
def test_3xtf32_product_against_float64(m, n, kdim):
    """One split product within 2^-20 K |A||B| of float64 (the f32 sum's own
    error and the dropped lo lo term), where one TF32 product is 100 times
    further off."""
    rng = np.random.default_rng(m + n + kdim)
    a = torch.from_numpy(rng.normal(size=(m, kdim)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(kdim, n)).astype(np.float32))
    ref = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    assert ((mm3(a, b).double() - ref).abs() / mag).max().item() <= 2.0 ** -20 * kdim
    assert ((mm1(a, b).double() - ref).abs() / mag).max().item() > 100 * 2.0 ** -20


def _permuted(s: int) -> int:
    """The kernel's `permuted`: a sequence position's k in a transposed tile."""
    return (s & ~7) | ((s & 6) >> 1) | ((s & 1) << 2)


def test_the_transposed_tiles_permutation_matches_the_accumulator_fragments():
    """A TF32 A fragment holds columns t and t + 4 of each 8 where the f32
    accumulator holds 2t and 2t + 1: with B's sequence positions at
    `permuted`, A's column j is position p with _permuted(p) = j, so a
    product of the accumulator's values as fragments with the permuted B
    is the same sum. Checked as index maps and as one 64 x 32 x 64 product."""
    for s in range(64):
        j = _permuted(s)
        assert j // 8 == s // 8 and (j % 8 == (s % 8) // 2 + 4 * (s % 2))
    assert sorted(_permuted(s) for s in range(64)) == list(range(64))
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    order = [next(s for s in range(32) if _permuted(s) == j) for j in range(32)]
    # fragment column j carries accumulator column order[j]; B's line j is
    # sequence position order[j]
    torch.testing.assert_close(p[:, order] @ v[order], p @ v, rtol=1e-5, atol=1e-5)


def test_the_roofline_rate_is_a_third_of_dense_tf32():
    """The bound of an f32-accurate product: 495 TFLOP/s of dense TF32 on an
    H100 SXM, three TF32 products for each, 165 TFLOP/s; at the LM's (8,
    1024, 12, 64) causal forward 12.9 GFLOP, 0.0782 ms."""
    from tritonk8ssupervisor_tpu_torch.utils import roofline

    rate = roofline.PEAK_F32_PRODUCT_FLOPS["NVIDIA H100 80GB HBM3"]
    assert rate == pytest.approx(495e12 / 3)
    flops = fa.forward_cost(8, 12, 1024, 64, True, 4)[1]
    assert math.isclose(flops / rate * 1e3, 0.0782, abs_tol=1e-4)
