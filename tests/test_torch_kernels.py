"""The port's kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and
skips where there is no card. This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from tritonk8ssupervisor_tpu_torch.models import ResNet18
from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops import flash_attention_cuda
from tritonk8ssupervisor_tpu_torch.parallel import train


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K2, K3 and K4 (CUDA C++) have no CPU mode")


def _inputs(batch, classes, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = (torch.randn(batch, classes, generator=gen, device="cuda") * 4).to(dtype)
    labels = torch.randint(0, classes, (batch,), generator=gen, device="cuda")
    labels[:2] = torch.tensor([-1, classes])[:batch]
    for row in range(2, min(6, batch)):
        top = logits[row].max() + 1
        logits[row, 0] = logits[row, classes - 1] = top
        labels[row] = 0 if row % 2 else classes - 1
    return logits, labels


# K1's regimes and the edges between them: one warp a row up to 16
# 16-byte loads a lane (C * elem <= 8 KB: (32768, 256), (4096, 2048),
# (256, 1000) f32; (4096, 4096) bf16 at the edge, f32 past it), one CTA a
# row beyond ((37, 5000), (8, 32000)); rows that are not whole 16-byte
# loads take one element a load, narrow ((5, 7), (64, 333)) or wide
# ((6, 5001)); an empty batch launches nothing
K1_SHAPES = [(32768, 256), (4096, 2048), (4096, 4096), (256, 1000), (37, 5000), (8, 32000),
             (5, 7), (64, 333), (6, 5001), (0, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("batch,classes", K1_SHAPES)
def test_k1_matches_plain_version(batch, classes, dtype, label_dtype):
    _card()
    logits, labels = _inputs(batch, classes, dtype)
    labels = labels.to(label_dtype)
    before = ce.cross_entropy_forward.launches
    loss, correct, lse = ce.cross_entropy_forward_kernel(logits, labels)
    torch.cuda.synchronize()
    assert ce.cross_entropy_forward.launches == before + (1 if batch else 0)
    ref_loss, ref_correct, ref_lse = ce.cross_entropy_forward_plain(logits, labels)
    # the same f32 arithmetic reduced in another order, exp and log on the
    # card's fast units (--use_fast_math): 1e-5
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(correct, ref_correct)
    assert correct[2:6].all() and not correct[:2].any()
    assert torch.equal(ce.cross_entropy_forward(logits, labels)[0], loss)


def _assert_k1_gradient_close(got, want, g):
    """K1's backward against its plain version. f32: the same arithmetic
    but for `__expf` (--use_fast_math), whose error is a few ulps plus
    |x - lse| * 2^-24 relative: rtol 1e-5, and 1e-6 of the largest |g|
    where exp(x - lse) - 1 cancels. bf16 and fp16: the f32 values differ
    by far less than the output's rounding step, so the stored values
    differ by at most one ulp of the output dtype (floored at fp16's
    subnormal step and at 2^-126, below which the kernel flushes f32 to
    zero)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        atol = 1e-6 * g.abs().max().item() if g.numel() else 0.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
        return
    bits, floor = {torch.bfloat16: (8, 2.0**-126), torch.float16: (11, 2.0**-24)}[got.dtype]
    a, b = got.float(), want.float()
    _, exponent = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exponent - bits).clamp_min(floor)
    worst = ((a - b).abs() / ulp).max().item() if a.numel() else 0.0
    assert worst <= 1.0, f"{worst} ulps"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("batch,classes", K1_SHAPES)
def test_k1_backward_matches_plain_version(batch, classes, dtype, label_dtype):
    _card()
    logits, labels = _inputs(batch, classes, dtype, seed=1)
    labels = labels.to(label_dtype)
    lse = ce.cross_entropy_forward_plain(logits, labels)[2]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = torch.rand(batch, generator=gen, device="cuda") - 0.25
    rows[::3] = 0.0
    # the gradient of a mean (stride 0), and a g that differs by row, 0 on some
    for g in (torch.full((), 1.0 / max(batch, 1), device="cuda").expand(batch), rows):
        before = ce.cross_entropy_backward.launches
        got = ce.cross_entropy_backward(logits, labels, lse, g)
        torch.cuda.synchronize()
        assert ce.cross_entropy_backward.launches == before + (1 if batch else 0)
        _assert_k1_gradient_close(got, ce.cross_entropy_backward_plain(logits, labels, lse, g), g)


@pytest.mark.cuda
def test_k1_wrapper_raises_on_what_it_does_not_take():
    _card()
    logits, labels = _inputs(16, 100, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ce.cross_entropy_forward(logits.t().contiguous().t(), labels)
    with pytest.raises(TypeError):
        ce.cross_entropy_forward(logits.double(), labels)
    with pytest.raises(ValueError, match="CUDA"):
        ce.cross_entropy_forward(logits, labels.cpu())
    lse = ce.cross_entropy_forward_plain(logits, labels)[2]
    g = torch.ones(16, device="cuda")
    with pytest.raises(TypeError):
        ce.cross_entropy_backward(logits, labels, lse, g.half())
    with pytest.raises(ValueError, match="CUDA"):
        ce.cross_entropy_backward(logits, labels, lse.cpu(), g)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        ce.cross_entropy_backward(logits, labels, lse[:8], g)


@pytest.mark.cuda
def test_k1_gradient_matches_reference():
    _card()
    logits, labels = _inputs(64, 1000, torch.float32, seed=3)
    labels = labels.clamp(0, 999)
    x = logits.clone().requires_grad_(True)
    before = ce.cross_entropy_backward.launches
    ce.cross_entropy_loss(x, labels).mean().backward()
    assert ce.cross_entropy_backward.launches == before + 1
    y = logits.clone().requires_grad_(True)
    ce.cross_entropy_loss_reference(y, labels).mean().backward()
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_train_step_on_card_goes_through_k1():
    _card()
    model = ResNet18(num_classes=10, num_filters=8)
    state = train.create_train_state(model, train.default_optimizer())
    step = train.make_train_step(state)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 10, (8,), generator=gen, device="cuda")
    before = ce.cross_entropy_forward.launches, ce.cross_entropy_backward.launches
    metrics = step(images, labels)
    assert torch.isfinite(metrics["loss"])
    assert (ce.cross_entropy_forward.launches,
            ce.cross_entropy_backward.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_k1_bf16_at_the_lm_shape():
    _card()
    logits, labels = _inputs(8192, 32768, torch.bfloat16, seed=4)
    loss, correct, lse = ce.cross_entropy_forward_kernel(logits, labels.int())
    torch.cuda.synchronize()
    ref_loss, ref_correct, ref_lse = ce.cross_entropy_forward_plain(logits, labels.int())
    # the same bf16 values upcast to f32 on both sides, reduced in
    # another order over 32768 columns: 1e-5
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(correct, ref_correct)
    g = torch.full((), 1.0 / 8192, device="cuda").expand(8192)
    got = ce.cross_entropy_backward(logits, labels.int(), lse, g)
    _assert_k1_gradient_close(got, ce.cross_entropy_backward_plain(logits, labels.int(), lse, g), g)


# K2: bf16/fp16 kernel against the plain version. Tolerances are taken
# relative to the reference's largest magnitude (at least 1): the kernel
# keeps the scores in f32 and rounds P and dS to the input dtype for the
# next product (8 mantissa bits in bf16: 2^-9 relative per rounding);
# against the plain version in the same dtype, which also rounds the
# scores, 2e-2; against the plain version on f32 copies of the same
# inputs, 1e-2.
K2_REL_SAME_DTYPE = 2e-2
K2_REL_F32 = 1e-2
# float32 q, k, v (the 3xTF32 instance: each product three TF32 ones): an
# error bound against a float64 evaluation of the same inputs, relative to the f64
# result's largest magnitude: 2e-5 for O, 1e-4 for dq, dk and dv. Each case
# also holds the plain f32 version on the card to it, so the bound is known
# to be attainable; products of TF32's 10-bit inputs miss it
# (tests/test_torch_f32_kernels.py).
K2_F32_REL = {"out": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}

K2_CASES = [
    pytest.param(8, 1024, 12, 64, torch.bfloat16, True, "bshd", id="lm-bshd"),
    pytest.param(8, 1024, 12, 64, torch.bfloat16, True, "bhsd", id="lm-bhsd"),
    pytest.param(2, 1000, 4, 64, torch.bfloat16, True, "bshd", id="ragged-causal"),
    pytest.param(2, 512, 4, 128, torch.bfloat16, False, "bshd", id="d128-full"),
    pytest.param(2, 1024, 4, 128, torch.bfloat16, True, "bshd", id="d128-causal"),
    pytest.param(2, 200, 3, 128, torch.float16, True, "bhsd", id="d128-fp16-ragged"),
    pytest.param(1, 77, 2, 64, torch.float16, False, "bshd", id="fp16-short-full"),
    pytest.param(3, 64, 2, 64, torch.bfloat16, True, "bshd", id="one-tile"),
    pytest.param(2, 1, 2, 64, torch.bfloat16, True, "bshd", id="one-token"),
    pytest.param(1, 130, 3, 64, torch.float16, False, "bhsd", id="fp16-ragged-full"),
    # every other head_dim: d <= 64 on the 64 tile, <= 128 on the 128 tile,
    # <= 256 on the 256 tile (64-row items, each warpgroup half of the
    # output's columns); d not a multiple of 8 through a zero-padded copy
    pytest.param(1, 65, 2, 1, torch.bfloat16, True, "bshd", id="d1-padded"),
    pytest.param(2, 77, 3, 8, torch.bfloat16, True, "bshd", id="d8-causal"),
    pytest.param(2, 130, 2, 8, torch.float16, False, "bhsd", id="d8-fp16-full"),
    pytest.param(4, 1024, 24, 32, torch.bfloat16, True, "bshd", id="d32-lm-24-heads"),
    pytest.param(2, 300, 4, 32, torch.float16, False, "bhsd", id="d32-fp16-full"),
    pytest.param(2, 1000, 4, 36, torch.bfloat16, False, "bshd", id="d36-padded-full"),
    pytest.param(1, 130, 2, 36, torch.float16, True, "bhsd", id="d36-padded-fp16-causal"),
    pytest.param(2, 1000, 4, 40, torch.bfloat16, False, "bshd", id="d40-full"),
    pytest.param(2, 129, 3, 40, torch.float16, True, "bhsd", id="d40-fp16-causal"),
    pytest.param(2, 1024, 32, 80, torch.bfloat16, True, "bshd", id="d80-phi2"),
    pytest.param(1, 200, 2, 80, torch.float16, False, "bhsd", id="d80-fp16-full"),
    pytest.param(8, 1024, 8, 96, torch.bfloat16, True, "bshd", id="d96-lm-8-heads"),
    pytest.param(2, 333, 3, 96, torch.float16, False, "bhsd", id="d96-fp16-full"),
    pytest.param(2, 257, 2, 112, torch.bfloat16, True, "bhsd", id="d112-causal"),
    pytest.param(1, 100, 3, 112, torch.float16, False, "bshd", id="d112-fp16-full"),
    pytest.param(8, 1024, 3, 256, torch.bfloat16, True, "bshd", id="d256-lm-3-heads"),
    pytest.param(2, 512, 2, 256, torch.float16, False, "bhsd", id="d256-fp16-full"),
    pytest.param(2, 200, 2, 256, torch.bfloat16, True, "bhsd", id="d256-ragged-causal"),
    pytest.param(1, 1, 2, 256, torch.float16, True, "bshd", id="d256-one-token"),
    # float32 on the 3xTF32 instance, every head_dim 1-256 at any stride
    pytest.param(8, 1024, 12, 64, torch.float32, True, "bshd", id="f32-lm"),
    pytest.param(8, 1024, 8, 96, torch.float32, True, "bshd", id="f32-d96-lm-8-heads"),
    pytest.param(8, 1024, 3, 256, torch.float32, True, "bshd", id="f32-d256-lm-3-heads"),
    pytest.param(256, 197, 6, 64, torch.float32, False, "bshd", id="f32-vit-s16"),
    pytest.param(2, 1000, 4, 40, torch.float32, False, "bhsd", id="f32-d40-ragged-bhsd"),
    pytest.param(1, 65, 2, 1, torch.float32, True, "bshd", id="f32-d1"),
    pytest.param(2, 77, 3, 8, torch.float32, True, "bshd", id="f32-d8-causal"),
    pytest.param(1, 130, 2, 36, torch.float32, True, "bhsd", id="f32-d36-causal"),
    pytest.param(2, 333, 3, 100, torch.float32, False, "bshd", id="f32-d100-full"),
    pytest.param(2, 200, 2, 256, torch.float32, True, "bhsd", id="f32-d256-ragged-causal"),
    pytest.param(1, 1, 2, 256, torch.float32, True, "bshd", id="f32-d256-one-token"),
    # the widest tile's transposed splits in the head-major layout
    pytest.param(8, 1024, 3, 256, torch.float32, True, "bhsd", id="f32-d256-lm-3-heads-bhsd"),
]


def _k2_inputs(b, s, h, d, dtype, layout, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)]


def _rel_err(actual, expected):
    expected = expected.float()
    scale = expected.abs().max().clamp(min=1.0)
    return ((actual.float() - expected).abs().max() / scale).item()


def _fwd_bwd(fn, q, k, v, dout):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return [out.detach(), q.grad, k.grad, v.grad]


def _k2_lse_matches(q, k, lse, causal, layout):
    """K2's (B, H, S) logsumexp against the f32 scores' own."""
    if layout == "bhsd":
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    s, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    if causal:
        scores = scores.masked_fill(torch.ones(s, s, device="cuda").triu(1).bool(), float("-inf"))
    torch.testing.assert_close(lse, scores.logsumexp(-1), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dtype,causal,layout", K2_CASES)
def test_k2_matches_plain_version(b, s, h, d, dtype, causal, layout):
    _card()
    q, k, v, dout = _k2_inputs(b, s, h, d, dtype, layout)
    fwd, bwd = fa.flash_attention_forward.launches, fa.flash_attention_backward.launches
    copies = fa.flash_attention_forward.copies
    got = _fwd_bwd(lambda *x: fa.flash_attention(*x, causal=causal, layout=layout),
                   q, k, v, dout)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.launches == fwd + 1
    assert fa.flash_attention_backward.launches == bwd + 1
    # dense q, k, v are read in place unless d is not a multiple of 8 (the
    # bf16/fp16 instances' TMA); the 3xTF32 instance reads every head_dim in place
    padded = d % 8 and dtype != torch.float32
    assert fa.flash_attention_forward.copies == copies + (3 if padded else 0)
    _k2_lse_matches(q, k, torch.ops.tk8s.flash_attn_fwd(q, k, v, causal, layout)[1], causal,
                    layout)
    assert all(g.dtype == dtype and g.shape == q.shape for g in got)
    plain = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, causal, layout),
                     q, k, v, dout)
    if dtype == torch.float32:
        f64 = _fwd_bwd(lambda *x: fa.attention_f64(*x, causal, layout),
                       *(x.double() for x in (q, k, v, dout)))
        for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, plain, f64):
            bound = K2_F32_REL[name] * e.abs().max().item()
            assert torch.isfinite(a).all(), name
            assert (a.double() - e).abs().max().item() <= bound, name
            assert (p.double() - e).abs().max().item() <= bound, (name, "plain")
        return
    f32 = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, causal, layout),
                   q.float(), k.float(), v.float(), dout.float())
    for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, plain, f32):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, p) <= K2_REL_SAME_DTYPE, (name, _rel_err(a, p))
        assert _rel_err(a, e) <= K2_REL_F32, (name, _rel_err(a, e))


def _k2_views(b, s, h, d, dtype, layout, seed):
    """q, k, v, dout in `layout`, or q, k, v as views of one (B, S, 3 H D)
    projection ("qkv", read as bshd)."""
    if layout != "qkv":
        return _k2_inputs(b, s, h, d, dtype, layout, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    return [*(x.view(b, s, h, d) for x in qkv.split(h * d, dim=-1)), dout]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bshd", "bhsd", "qkv"])
@pytest.mark.parametrize("s,causal", [(1, True), (17, True), (129, True), (1000, False)])
def test_k2_forward_tiles_at_ragged_lengths_d128_fp16(s, causal, layout):
    """The forward's 128-row q tiles and 64-row k/v tiles at lengths that
    are not multiples of either, head_dim 128 in fp16; the backward runs
    from the forward's O and logsumexp."""
    _card()
    q, k, v, dout = _k2_views(2, s, 3, 128, torch.float16, layout, seed=s)
    kernel_layout = "bhsd" if layout == "bhsd" else "bshd"
    got = _fwd_bwd(lambda *x: fa.flash_attention(*x, causal=causal, layout=kernel_layout),
                   q, k, v, dout)
    torch.cuda.synchronize()
    plain = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, causal, kernel_layout),
                     q, k, v, dout)
    f32 = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, causal, kernel_layout),
                   q.float(), k.float(), v.float(), dout.float())
    for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, plain, f32):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, p) <= K2_REL_SAME_DTYPE, (name, _rel_err(a, p))
        assert _rel_err(a, e) <= K2_REL_F32, (name, _rel_err(a, e))


def _strided(shape, dtype, pad_last=0, offset=0, seed=0):
    """A random (B, S, H, D) view into a larger card buffer that takes
    gradients: rows padded by `pad_last` elements, starting `offset`
    elements in."""
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(b * s * h * (d + pad_last) + offset, generator=gen, device="cuda").to(dtype)
    return buf.requires_grad_(True)[offset:].view(b, s, h, d + pad_last)[..., :d]


@pytest.mark.cuda
@pytest.mark.parametrize("pad_last,offset", [(4, 0), (0, 4)], ids=["odd-stride", "misaligned"])
def test_k2_copies_inputs_that_tma_cannot_address(pad_last, offset):
    """q, k, v with 68-element strides, or starting 8 bytes off a 16-byte
    line, are views the reference takes: the wrapper copies them (and
    counts the copies), forward and backward match the plain version, and
    the launcher itself still refuses them."""
    _card()
    shape = (2, 130, 3, 64)
    q, k, v = (_strided(shape, torch.bfloat16, pad_last, offset, seed=i) for i in range(3))
    assert q.data_ptr() % 16 == (2 * offset) % 16
    dout = _k2_inputs(*shape, torch.bfloat16, "bshd", seed=3)[0]

    def run(fn, *x):  # the views themselves, not dense clones, reach `fn`
        out = fn(*x)
        return [out.detach(), *torch.autograd.grad(out, x, dout)]

    copies = fa.flash_attention_forward.copies
    got = run(lambda *x: fa.flash_attention(*x, causal=True), q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.copies == copies + 3
    plain = run(lambda *x: fa.attention_reference_layout(*x, True, "bshd"), q, k, v)
    f32 = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, True, "bshd"),
                   q.float(), k.float(), v.float(), dout.float())
    for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, plain, f32):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, p) <= K2_REL_SAME_DTYPE, (name, _rel_err(a, p))
        assert _rel_err(a, e) <= K2_REL_F32, (name, _rel_err(a, e))
    out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
    lse = torch.empty(2, 3, shape[1], device="cuda")
    with pytest.raises(ValueError, match="multiples of 8" if pad_last else "aligned"):
        flash_attention_cuda.forward(q.detach(), k.detach(), v.detach(), out, lse, True, "bshd")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k2_backward_is_deterministic(dtype):
    """No atomics: every dQ, dK and dV row is written by one CTA in a fixed
    order, so two backward calls on the same inputs agree bit for bit, on
    the bf16 and the 3xTF32 instance."""
    _card()
    q, k, v, dout = _k2_inputs(4, 1024, 12, 64, dtype, "bshd", seed=11)
    out, lse = torch.ops.tk8s.flash_attn_fwd(q, k, v, True, "bshd")
    first = torch.ops.tk8s.flash_attn_bwd(dout, q, k, v, out, lse, True, "bshd")
    second = torch.ops.tk8s.flash_attn_bwd(dout, q, k, v, out, lse, True, "bshd")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_k2_takes_more_batch_heads_than_a_grid_axis():
    """65,540 (batch, head) pairs, past the 65,535 CTAs of a grid's y axis:
    the persistent CTAs walk them as work items."""
    _card()
    b, s, h, d = 16385, 8, 4, 64
    q, k, v, dout = _k2_inputs(b, s, h, d, torch.bfloat16, "bshd", seed=12)
    got = _fwd_bwd(lambda *x: fa.flash_attention(*x, causal=True), q, k, v, dout)
    torch.cuda.synchronize()
    plain = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, True, "bshd"), q, k, v, dout)
    for name, a, p in zip(("out", "dq", "dk", "dv"), got, plain):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, p) <= K2_REL_SAME_DTYPE, (name, _rel_err(a, p))


@pytest.mark.cuda
def test_k2_reads_qkv_views_in_place_and_its_logsumexp():
    """q, k, v as the seq-major Block makes them: views of one (B, S, 3E)
    projection with seq stride 3E."""
    _card()
    b, s, h, d = 2, 256, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
    q, k, v = (x.view(b, s, h, d) for x in qkv.split(h * d, dim=-1))
    assert q.stride(1) == 3 * h * d
    out, lse = torch.ops.tk8s.flash_attn_fwd(q, k, v, True, "bshd")
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, fa.attention_reference_layout(q, k, v, True, "bshd"), rtol=0, atol=2e-2
    )
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    scores = scores.masked_fill(torch.ones(s, s, device="cuda").triu(1).bool(), float("-inf"))
    torch.testing.assert_close(lse, scores.logsumexp(-1), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k2_wrapper_raises_on_what_it_does_not_take():
    _card()
    x = torch.zeros(1, 128, 2, 264, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim from 1 to 256"):
        fa.flash_attention(x, x, x)
    # head_dim 32, outside the first kernels' 64 and 128, runs
    x = torch.randn(1, 128, 2, 32, device="cuda", dtype=torch.bfloat16)
    got = fa.flash_attention(x, x, x)
    assert _rel_err(got, fa.attention_reference_layout(x, x, x, True, "bshd")) <= K2_REL_SAME_DTYPE
    y = torch.zeros(1, 128, 2, 64, device="cuda")
    # f32 runs (the 3xTF32 instance); float64 is refused in its place
    with pytest.raises(TypeError, match="float32, bf16 or fp16"):
        fa.flash_attention(y.double(), y.double(), y.double())
    wide = torch.zeros(1, 128, 2, 264, device="cuda")
    with pytest.raises(ValueError, match="head_dim from 1 to 256"):
        fa.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(y.bfloat16(), y.bfloat16().cpu(), y.bfloat16())
    with pytest.raises(ValueError, match="layout"):
        fa.flash_attention(y, y, y, layout="sbhd")


@pytest.mark.cuda
def test_k2_flops_reach_the_counter():
    _card()
    from torch.utils.flop_counter import FlopCounterMode

    q, k, v, dout = _k2_inputs(2, 256, 4, 64, torch.bfloat16, "bhsd", seed=7)
    q.requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        fa.flash_attention(q, k, v, layout="bhsd").backward(dout)
    assert counter.get_total_flops() == 12 * 2 * 4 * 64 * (256 * 257 // 2)


@pytest.mark.cuda
def test_lm_train_step_on_card_goes_through_k1_and_k2():
    _card()
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM

    model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                          max_seq_len=128, attention_fn=fa.flash_attention)
    state = train.create_train_state(model, train.default_optimizer(0.03))
    step = train.make_lm_train_step(state)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 512, (4, 128), generator=gen, device="cuda", dtype=torch.int32)
    counters = (ce.cross_entropy_forward, ce.cross_entropy_backward, fa.flash_attention_forward,
                fa.flash_attention_backward)
    counts = [c.launches for c in counters]
    metrics = step(tokens)
    assert torch.isfinite(metrics["loss"])
    assert [c.launches - n for c, n in zip(counters, counts)] == [1, 1, 2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("head_major", [False, True], ids=["seq-major", "head-major"])
def test_lm_through_k2_matches_the_plain_version_on_the_card(head_major):
    """A bf16 LM's loss and gradients through K2 against the same weights
    through the plain attention, both on the card. Head-major feeds K2
    (b, h, s, d) q/k/v and a strided output gradient from the einsum
    projection."""
    _card()
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.models.transformer import dense_attention

    tokens = torch.randint(0, 512, (2, 192), generator=torch.Generator().manual_seed(1))
    grads = {}
    for name, attention in (("k2", fa.flash_attention), ("plain", dense_attention)):
        model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                              max_seq_len=192, attention_fn=attention, head_major=head_major,
                              generator=torch.Generator().manual_seed(0)).cuda()
        logits = model(tokens.cuda())
        loss = torch.nn.functional.cross_entropy(logits.float().flatten(0, 1),
                                                 tokens.cuda().roll(-1, 1).flatten())
        loss.backward()
        grads[name] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()})
    (loss_k2, g_k2), (loss_plain, g_plain) = grads["k2"], grads["plain"]
    # bf16 activations: the kernel rounds P once where the plain version
    # rounds the scores and P; relative to each gradient's largest entry
    torch.testing.assert_close(loss_k2, loss_plain, rtol=0, atol=2e-2)
    for name, g in g_k2.items():
        assert _rel_err(g, g_plain[name]) <= 5e-2, (name, _rel_err(g, g_plain[name]))


# K4: the fused 1x1-conv backward against its plain version on the same
# bf16/fp16 rows. The kernel and the plain version sum the same exact
# products in f32 in other orders; dX is then rounded to the input dtype
# (2^-9 relative in bf16), so dX is held to 1e-2 of its largest magnitude
# and dW (f32 throughout) to 1e-3 of its own.
K4_REL_DX = 1e-2
K4_REL_DW = 1e-3

K4_CASES = [
    pytest.param(128, 24, 32, torch.bfloat16, id="small"),
    pytest.param(10, 8, 16, torch.float16, id="ragged-tiny-fp16"),
    pytest.param(1000, 64, 256, torch.bfloat16, id="ragged"),
    pytest.param(4099, 200, 72, torch.float16, id="ragged-partial-tiles-fp16"),
    pytest.param(802816, 256, 64, torch.bfloat16, id="stage0-full"),
    pytest.param(50176, 256, 1024, torch.bfloat16, id="stage2-full"),
    pytest.param(12544, 2048, 512, torch.float16, id="stage3-full-fp16"),
    # the TF32 instance: float32 at ResNet-50's widths and any width
    # ("tf32x3"), bf16 and fp16 at widths that are not multiples of 8
    # ("tf32x1"); contractions shorter than K_MIN = 16 (N for dX, M for dW)
    # as f32 FMAs, at the threshold on the tensor cores
    pytest.param(128, 24, 32, torch.float32, id="tf32x3-small"),
    pytest.param(1000, 3, 13, torch.float32, id="tf32x3-widths-3-13"),
    pytest.param(4099, 100, 36, torch.float32, id="tf32x3-widths-100-36"),
    pytest.param(802816, 64, 64, torch.float32, id="tf32x3-stage0-full"),
    pytest.param(50176, 256, 1024, torch.float32, id="tf32x3-stage2-full"),
    pytest.param(12544, 2048, 512, torch.float32, id="tf32x3-stage3-full"),
    pytest.param(1000, 3, 1, torch.float32, id="tf32x3-n1-fma-dx"),
    pytest.param(1000, 5, 4, torch.float32, id="tf32x3-n4-fma-dx"),
    pytest.param(3, 64, 64, torch.float32, id="tf32x3-m3-fma-dw"),
    pytest.param(1000, 24, 16, torch.float32, id="tf32x3-n16-at-k-min"),
    pytest.param(16, 40, 72, torch.float32, id="tf32x3-m16-at-k-min"),
    pytest.param(50176, 3, 13, torch.bfloat16, id="tf32x1-bf16-widths-3-13"),
    pytest.param(4096, 100, 36, torch.bfloat16, id="tf32x1-bf16-widths-100-36"),
    pytest.param(1000, 12, 20, torch.float16, id="tf32x1-fp16-widths-12-20"),
    pytest.param(1000, 13, 20, torch.bfloat16, 1, id="tf32x1-bf16-2-byte-offset"),
    pytest.param(777, 36, 100, torch.float32, 1, id="tf32x3-4-byte-offset"),
]

# float32 (the tf32x3 route): elementwise |kernel - f64| <= 1.01 K 2^-24
# (|A| |B|)_64 + 1e-30 against a float64 evaluation, K the contraction
# length (N for dX, M for dW): the forward error bound of an f32 FMA sum in
# any order; the 1e-30 covers results flushed to zero. The plain f32
# version on the card is held to it too; TF32 products miss it.


def _k4_f32_bound_ratio(dx, dw, x2, dy2, w2):
    """max over dX and dW of |got - f64| over the bound above."""
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    ref_dx, ref_dw, mag_dx, mag_dw = cb.conv1x1_backward_f64(x2, dy2, w2)
    m, n = dy2.shape
    return max(((got.double() - ref).abs() / (1.01 * k * 2.0**-24 * mag + 1e-30)).max().item()
               for got, ref, mag, k in ((dx, ref_dx, mag_dx, n), (dw, ref_dw, mag_dw, m)))


def _k4_inputs(m, c, n, dtype, seed=0, offset=0):
    """X, dY, W from a seed; with `offset`, each starts that many elements
    into its storage (rows at any start: the TF32 instance's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def at_offset(t):
        if not offset:
            return t
        storage = torch.empty(t.numel() + offset, dtype=dtype, device="cuda")
        return storage[offset:].view(t.shape).copy_(t)

    x2 = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
    dy2 = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
    w2 = (torch.randn(n, c, generator=gen, device="cuda") / c ** 0.5).to(dtype)
    return at_offset(x2), at_offset(dy2), at_offset(w2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,n,dtype,offset", [
    p if len(p.values) == 5 else pytest.param(*p.values, 0, id=p.id) for p in K4_CASES])
def test_k4_matches_plain_version(m, c, n, dtype, offset):
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x2, dy2, w2 = _k4_inputs(m, c, n, dtype, offset=offset)
    assert offset == 0 or x2.data_ptr() % 16 != 0
    before = cb.conv1x1_backward_kernel.launches
    dx, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    assert cb.conv1x1_backward_kernel.launches == before + 1
    assert dx.dtype == dtype and dx.shape == (m, c) and dw.dtype == torch.float32
    ref_dx, ref_dw = cb.conv1x1_backward_plain(x2, dy2, w2, dtype)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
    if dtype == torch.float32:
        assert _k4_f32_bound_ratio(dx, dw, x2, dy2, w2) <= 1.0
        assert _k4_f32_bound_ratio(ref_dx, ref_dw, x2, dy2, w2) <= 1.0  # the plain version
        return
    assert _rel_err(dx, ref_dx) <= K4_REL_DX, _rel_err(dx, ref_dx)
    scale = ref_dw.abs().max().item()
    assert (dw - ref_dw).abs().max().item() <= K4_REL_DW * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("c,n", [(8, 72), (72, 136), (136, 8)])
@pytest.mark.parametrize("m", [1, 127, 129])
def test_k4_at_widths_and_rows_that_are_not_whole_tiles(m, c, n, dtype):
    """Widths that are multiples of 8 but not of the 64-wide boxes or the
    128-wide tiles, and M around one 128-row tile: TMA zero-fills the
    loads past each edge and clips the store."""
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x2, dy2, w2 = _k4_inputs(m, c, n, dtype, seed=m + c + n)
    dx, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    ref_dx, ref_dw = cb.conv1x1_backward_plain(x2, dy2, w2, dtype)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
    assert _rel_err(dx, ref_dx) <= K4_REL_DX, _rel_err(dx, ref_dx)
    assert (dw - ref_dw).abs().max().item() <= K4_REL_DW * ref_dw.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 128), (torch.float32, 128),
                                     (torch.bfloat16, 100)], ids=["bf16", "f32", "bf16-tf32x1"])
def test_k4_is_deterministic(dtype, c):
    """dW is summed over a fixed split of M in a fixed order: two calls on
    the same inputs agree bit for bit, on the wgmma instance and on both
    routes of the TF32 instance."""
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x2, dy2, w2 = _k4_inputs(200704, c, 512, dtype, seed=1)
    first = cb.conv1x1_backward_kernel(x2, dy2, w2)
    second = cb.conv1x1_backward_kernel(x2, dy2, w2)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k4_takes_an_empty_batch(dtype):
    """M = 0 rows: an empty dX in the compute dtype and a zero f32 dW, as
    the reference returns, without a launch."""
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x2, dy2, w2 = _k4_inputs(0, 64, 256, dtype)
    before = cb.conv1x1_backward_kernel.launches
    dx2, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    assert cb.conv1x1_backward_kernel.launches == before
    assert dx2.shape == (0, 64) and dx2.dtype == dtype
    assert dw.shape == (256, 64) and dw.dtype == torch.float32 and not dw.any()


@pytest.mark.cuda
def test_k4_takes_more_rows_than_the_first_design_s_grid():
    """M past 65535 x 128 rows, the cap of K4's first dgrad grid (one CTA
    a 128-row tile on the grid's y axis): the persistent grid walks every
    tile. C = N = 64 in bf16, ~1.1 GB an operand; against the plain
    version with the tolerances above."""
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    m = 65535 * 128 + 128 * 3 + 5
    x2, dy2, w2 = _k4_inputs(m, 64, 64, torch.bfloat16, seed=7)
    dx, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    ref_dx, ref_dw = cb.conv1x1_backward_plain(x2, dy2, w2, torch.bfloat16)
    assert dx.shape == (m, 64) and torch.isfinite(dx).all() and torch.isfinite(dw).all()
    assert _rel_err(dx, ref_dx) <= K4_REL_DX, _rel_err(dx, ref_dx)
    # the last rows, past every multiple of the old cap, hold their values
    assert _rel_err(dx[-133:], ref_dx[-133:]) <= K4_REL_DX
    assert (dw - ref_dw).abs().max().item() <= K4_REL_DW * ref_dw.abs().max().item()


@pytest.mark.cuda
def test_k4_raises_on_what_it_does_not_take():
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x = torch.zeros(2, 16, 4, 4, device="cuda").to(memory_format=torch.channels_last)
    w = torch.zeros(8, 16, 1, 1, device="cuda")
    dy = torch.zeros(2, 8, 4, 4, device="cuda").to(memory_format=torch.channels_last)
    # f32 and width 12 run on the TF32 instance; float64 is refused in their place
    with pytest.raises(TypeError, match="float32, bf16 or fp16"):
        cb.conv1x1_backward(x, w, dy, torch.float64)
    with pytest.raises(TypeError, match="float32, bf16 or fp16"):
        cb.conv1x1_backward(x[:, :12], w[:, :12], dy, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv1x1_backward(x, w.cpu(), dy, torch.bfloat16)
    # the wrapper itself, on rows that are not K4's
    x2, dy2, w2 = _k4_inputs(64, 16, 8, torch.bfloat16)
    with pytest.raises(TypeError, match="float32, bf16 or fp16"):
        cb.conv1x1_backward_kernel(x2.double(), dy2.double(), w2.double())
    with pytest.raises(ValueError, match="contiguous"):
        cb.conv1x1_backward_kernel(x2.t().contiguous().t(), dy2, w2)
    with pytest.raises(ValueError, match="aligned"):
        misaligned = torch.empty(64 * 16 + 1, device="cuda", dtype=torch.bfloat16)
        cb.conv1x1_backward_kernel(misaligned[1:].view(64, 16), dy2, w2)
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv1x1_backward_kernel(x2, dy2.cpu(), w2)


@pytest.mark.cuda
def test_k4_flops_reach_the_counter():
    _card()
    from torch.utils.flop_counter import FlopCounterMode

    from tritonk8ssupervisor_tpu_torch.ops.conv_backward import conv1x1

    b, c, h, w, n = 4, 64, 14, 14, 128
    x = torch.randn(b, c, h, w, device="cuda").bfloat16().to(memory_format=torch.channels_last)
    weight = torch.randn(n, c, 1, 1, device="cuda").to(memory_format=torch.channels_last)
    x.requires_grad_(True)
    weight.requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        conv1x1(x, weight).float().sum().backward()
    m = b * h * w
    # the forward convolution (2 M C N) and K4's two products (4 M C N)
    assert counter.get_total_flops() == 6 * m * c * n


@pytest.mark.cuda
def test_resnet_step_on_card_launches_k4_per_stride1_1x1_conv():
    _card()
    from tritonk8ssupervisor_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    model = ResNet(stage_sizes=(1, 1), block_cls=BottleneckBlock, num_classes=10,
                   num_filters=8, fused_1x1_bwd=True, fast_pool_bwd=True)
    state = train.create_train_state(model, train.default_optimizer())
    step = train.make_train_step(state)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 10, (8,), generator=gen, device="cuda")
    before = (cb.conv1x1_backward_kernel.launches, ce.cross_entropy_forward.launches,
              ce.cross_entropy_backward.launches)
    metrics = step(images, labels)
    assert torch.isfinite(metrics["loss"])
    # Conv_0 and Conv_2 of both blocks and stage 0's stride-1 shortcut
    assert cb.conv1x1_backward_kernel.launches == before[0] + 5
    assert ce.cross_entropy_forward.launches == before[1] + 1
    assert ce.cross_entropy_backward.launches == before[2] + 1


# K3: the int8-KV decode attention against its plain version on the same
# inputs, relative to the reference's own largest magnitude. Both keep the
# scores and probabilities in f32 (the kernel sums in another order and
# exponentiates on the fast unit, __expf: 2e-5) and round the output once
# to q's dtype, so a bf16 or fp16 output differs by at most one ulp at the
# largest magnitude: 2^-7 and 2^-10. Every case also runs on f32 copies of
# q, which holds its masks and positions to the f32 limit.
K3_REL = {torch.float32: 2e-5, torch.float16: 2**-10, torch.bfloat16: 2**-7}


def _k3_check(q, k8, ks, v8, vs, pos, layout, tables=None):
    """K3 against its plain version with q in its dtype and in f32."""
    from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da

    for q_check in (q, q.float()):
        out = da.decode_attention_int8(q_check, k8, ks, v8, vs, pos, layout=layout,
                                       tables=tables)
        ref = da.decode_attention_int8_plain(q_check, k8, ks, v8, vs, pos, layout=layout,
                                             tables=tables).float()
        assert torch.isfinite(out).all()
        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= K3_REL[q_check.dtype], (q_check.dtype, rel)

K3_CASES = [
    # (B, W, H, L, D, q dtype, layout, pos: int, a list (per row, or per row
    # and query), "rows" (B,) or "window" (B, W)); "paged" is a pool of
    # 16-position pages read through shuffled page tables
    pytest.param(8, 1, 12, 640, 64, torch.bfloat16, "blhd", 639, id="lm-blhd-last"),
    pytest.param(8, 1, 12, 640, 64, torch.bfloat16, "blhd", 127, id="lm-blhd-prompt"),
    pytest.param(2, 1, 3, 1000, 64, torch.float32, "bhld", 0, id="ragged-pos0"),
    pytest.param(2, 1, 3, 1000, 64, torch.float32, "bhld", 999, id="ragged-last"),
    pytest.param(2, 1, 3, 1000, 64, torch.float32, "blhd", 1200, id="ragged-past-end"),
    pytest.param(2, 1, 3, 1000, 64, torch.float32, "blhd", -1, id="ragged-negative"),
    pytest.param(4, 1, 2, 512, 16, torch.float16, "blhd", "rows", id="d16-rows-fp16"),
    pytest.param(4, 5, 12, 512, 64, torch.bfloat16, "blhd", "window", id="window5"),
    pytest.param(3, 5, 2, 300, 16, torch.float32, "bhld", "window", id="window5-d16-bhld"),
    pytest.param(2, 1, 4, 256, 128, torch.bfloat16, "bhld", 200, id="d128"),
    pytest.param(2, 3, 4, 100, 128, torch.float16, "blhd", "window", id="d128-window3-fp16"),
    pytest.param(2, 9, 2, 64, 32, torch.float32, "blhd", "window", id="window9-d32"),
    pytest.param(1, 1, 1, 1, 16, torch.float32, "bhld", 0, id="one-position"),
    # the engine's shapes on its pool: decode with per-slot positions (an
    # inactive slot at -1), the 5-query verify window, the drafter
    pytest.param(4, 1, 12, 512, 64, torch.bfloat16, "paged", [300, 511, 17, -1],
                 id="paged-engine-decode"),
    pytest.param(4, 5, 12, 512, 64, torch.bfloat16, "paged",
                 [[p + i for i in range(5)] for p in (300, 507, 17, 0)], id="paged-verify5"),
    pytest.param(4, 1, 2, 512, 16, torch.bfloat16, "paged", [300, 511, 17, 200],
                 id="paged-drafter-d16"),
    pytest.param(3, 5, 4, 256, 128, torch.float32, "paged", "window", id="paged-window5-d128"),
    # past the old limit of 227 KB of scores (one query over 65,536)
    pytest.param(1, 1, 2, 65536, 64, torch.float32, "blhd", 65535, id="long-65536"),
    pytest.param(1, 1, 2, 65536, 64, torch.bfloat16, "paged", [40000], id="long-65536-paged"),
    # positions at the chunk edges, one row each and as a window
    pytest.param(5, 1, 3, 256, 64, torch.bfloat16, "blhd", [63, 64, 65, 127, 128],
                 id="chunk-edges"),
    pytest.param(2, 5, 3, 256, 64, torch.float32, "paged",
                 [[61 + i for i in range(5)], [124 + i for i in range(5)]],
                 id="chunk-edges-window-paged"),
    pytest.param(2, 12, 2, 300, 256, torch.float16, "blhd", "window", id="window12-d256"),
    # head_dims that are not multiples of 16: rows copied in 8-byte (40,
    # 72), 4-byte (36), 2-byte (2) or 1-byte (33, 1) units
    pytest.param(4, 1, 12, 512, 40, torch.bfloat16, "blhd", "rows", id="d40-rows"),
    pytest.param(4, 1, 4, 512, 40, torch.bfloat16, "paged", [300, 511, 17, -1],
                 id="d40-paged-engine-decode"),
    pytest.param(4, 5, 4, 512, 40, torch.bfloat16, "paged",
                 [[p + i for i in range(5)] for p in (300, 507, 17, 0)], id="d40-paged-verify5"),
    pytest.param(3, 5, 4, 300, 72, torch.float16, "bhld", "window", id="d72-window5-bhld"),
    pytest.param(2, 1, 6, 640, 72, torch.float32, "blhd", 639, id="d72-blhd-last"),
    pytest.param(2, 1, 2, 256, 36, torch.bfloat16, "paged", [100, 255], id="d36-paged"),
    pytest.param(2, 3, 2, 200, 33, torch.float32, "blhd", "window", id="d33-window3"),
    pytest.param(2, 1, 3, 130, 2, torch.float32, "bhld", 129, id="d2"),
    pytest.param(2, 1, 2, 130, 1, torch.bfloat16, "blhd", "rows", id="d1-rows"),
    pytest.param(2, 1, 3, 640, 256, torch.bfloat16, "bhld", 639, id="d256-bhld-last"),
]
PAGE_SIZE = 16


def _k3_inputs(b, w, h, length, d, dtype, layout, pos, seed=0):
    """q, the cache (dense, or a pool of PAGE_SIZE-position pages with B *
    L / PAGE_SIZE + 1 pages: shuffled tables, one page shared by two rows,
    the last table column on the last page), pos and the tables (None when
    dense)."""
    from tritonk8ssupervisor_tpu_torch.models.decode import _quant_kv

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, w, h, d, generator=gen, device="cuda").to(dtype)
    tables = None
    if layout == "paged":
        n_pages = length // PAGE_SIZE
        pages = b * n_pages + 1
        cache_shape = (pages, PAGE_SIZE, h, d)
        tables = torch.randperm(pages - 1, generator=gen, device="cuda")[: b * n_pages]
        tables = tables.view(b, n_pages).to(torch.int32)
        if b > 1 and n_pages > 1:
            tables[1, 0] = tables[0, 1]
        tables[:, -1] = pages - 1
    else:
        cache_shape = (b, h, length, d) if layout == "bhld" else (b, length, h, d)
    k8, ks = _quant_kv(torch.randn(cache_shape, generator=gen, device="cuda"))
    v8, vs = _quant_kv(torch.randn(cache_shape, generator=gen, device="cuda"))
    if pos == "rows":
        pos = torch.randint(-1, length + 2, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    elif pos == "window":
        start = torch.randint(0, length - w, (b, 1), generator=gen, device="cuda")
        pos = (start + torch.arange(w, device="cuda")).to(torch.int32)
    elif isinstance(pos, list):
        pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return (q if w > 1 else q[:, 0]), k8, ks, v8, vs, pos, tables


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,h,length,d,dtype,layout,pos", K3_CASES)
def test_k3_matches_plain_version(b, w, h, length, d, dtype, layout, pos):
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da

    q, k8, ks, v8, vs, pos, tables = _k3_inputs(b, w, h, length, d, dtype, layout, pos)
    before = da.decode_attention_kernel.launches
    out = da.decode_attention_int8(q, k8, ks, v8, vs, pos, layout=layout, tables=tables)
    torch.cuda.synchronize()
    assert da.decode_attention_kernel.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _k3_check(q, k8, ks, v8, vs, pos, layout, tables)


@pytest.mark.cuda
def test_k3_reads_the_gathered_pages_and_strided_queries():
    """The engine's shapes: q a view of the (S, W, 3E) projection, the cache
    gathered from pages through a page table into (S, L, H, D), per-query
    positions; then the same pool read through the table in place."""
    _card()
    from tritonk8ssupervisor_tpu_torch.models.decode import _quant_kv

    s, w, h, d, ps, pages = 4, 5, 12, 64, 16, 130
    gen = torch.Generator(device="cuda").manual_seed(3)
    pool_k, pool_ks = _quant_kv(torch.randn(pages, ps, h, d, generator=gen, device="cuda"))
    pool_v, pool_vs = _quant_kv(torch.randn(pages, ps, h, d, generator=gen, device="cuda"))
    tables = torch.randint(0, pages, (s, 32), generator=gen, device="cuda")
    logical = torch.arange(32 * ps, device="cuda")
    page, off = tables[:, logical // ps], logical % ps
    k8, ks, v8, vs = (t[page, off] for t in (pool_k, pool_ks, pool_v, pool_vs))
    qkv = torch.randn(s, w, 3 * h * d, generator=gen, device="cuda").bfloat16()
    q = qkv[..., : h * d].view(s, w, h, d)
    assert not q.is_contiguous()
    pos = (torch.tensor([[3], [100], [255], [500]], device="cuda")
           + torch.arange(w, device="cuda")).to(torch.int32)
    _k3_check(q, k8, ks, v8, vs, pos, "blhd")
    _k3_check(q, pool_k, pool_ks, pool_v, pool_vs, pos, "paged", tables.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 40, 64, 128])
def test_k3_query_is_bit_equal_alone_in_a_window_and_paged(d):
    """A query's output depends only on its own pos and the cache: bit-equal
    alone (W = 1) and inside a 5-query window, and bit-equal on the paged
    pool and on its gathered view (the engine's spec = spec_base token
    identity leans on it)."""
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da

    window = [[p + i for i in range(5)] for p in (60, 507, 0, 126)]
    q, k8, ks, v8, vs, pos, tables = _k3_inputs(4, 5, 6, 512, d, torch.bfloat16, "paged",
                                                window, seed=d)
    paged = da.decode_attention_int8(q, k8, ks, v8, vs, pos, layout="paged", tables=tables)
    view = [da.gather_pages(t, tables) for t in (k8, ks, v8, vs)]
    assert torch.equal(paged, da.decode_attention_int8(q, *view, pos, layout="blhd"))
    for i in range(5):
        alone = da.decode_attention_int8(q[:, i], k8, ks, v8, vs, pos[:, i].contiguous(),
                                         layout="paged", tables=tables)
        assert torch.equal(alone, paged[:, i]), i
    # a Python-int pos (generate's) gives the bits of the same pos as a tensor
    row = da.decode_attention_int8(q[:1, 0], *(t[:1] for t in view), 130, layout="blhd")
    same = da.decode_attention_int8(q[:1, 0], *(t[:1] for t in view),
                                    torch.tensor([130], dtype=torch.int32, device="cuda"),
                                    layout="blhd")
    assert torch.equal(row, same)


@pytest.mark.cuda
def test_k3_is_deterministic():
    """Every sum runs in a fixed order: two calls are bit-equal, here over
    64 chunks of positions a row."""
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da

    window = [[4000 + 7 * r + i for i in range(5)] for r in range(8)]
    q, k8, ks, v8, vs, pos, _ = _k3_inputs(8, 5, 12, 4096, 64, torch.float32, "blhd", window,
                                           seed=4)
    first = da.decode_attention_int8(q, k8, ks, v8, vs, pos, layout="blhd")
    second = da.decode_attention_int8(q, k8, ks, v8, vs, pos, layout="blhd")
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_k3_raises_on_what_it_does_not_take():
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da

    q, k8, ks, v8, vs, pos, _ = _k3_inputs(2, 1, 2, 64, 64, torch.bfloat16, "blhd", "rows")
    call = da.decode_attention_int8
    with pytest.raises(TypeError, match="int8"):
        call(q, k8.float(), ks, v8, vs, pos, layout="blhd")
    with pytest.raises(TypeError, match="f32 scales"):
        call(q, k8, ks.bfloat16(), v8, vs, pos, layout="blhd")
    with pytest.raises(TypeError):
        call(q.double(), k8, ks, v8, vs, pos, layout="blhd")
    with pytest.raises(TypeError, match="int32"):
        call(q, k8, ks, v8, vs, pos.long(), layout="blhd")
    with pytest.raises(ValueError, match="CUDA"):
        call(q, k8, ks, v8, vs, pos.cpu(), layout="blhd")
    with pytest.raises(ValueError, match="CUDA"):
        call(q.cpu(), k8, ks, v8, vs, 3, layout="blhd")
    with pytest.raises(ValueError, match="from 1 to 256"):
        q2, k2, ks2, v2, vs2, _, _ = _k3_inputs(2, 1, 2, 64, 264, torch.bfloat16, "blhd", 3)
        call(q2, k2, ks2, v2, vs2, 3, layout="blhd")
    # rows that start off a 16-byte line are read, one byte a copy
    buf = torch.zeros(k8.numel() + 1, dtype=torch.int8, device="cuda")
    odd = buf[1:].view(k8.shape)
    odd.copy_(k8)
    _k3_check(q, odd, ks, v8, vs, 3, "blhd")
    with pytest.raises(ValueError, match="unit stride"):
        call(q, k8.transpose(-1, -2).contiguous().transpose(-1, -2), ks, v8, vs, 3,
             layout="blhd")
    with pytest.raises(ValueError, match="layout"):
        call(q, k8, ks, v8, vs, 3, layout="hbld")
    with pytest.raises(ValueError, match="pos of shape"):
        call(q, k8, ks, v8, vs, pos[:1], layout="blhd")
    # the paged layout: int32 tables on the card, 16-byte aligned pool rows
    qp, pk, pks, pv, pvs, ppos, tables = _k3_inputs(2, 1, 2, 64, 64, torch.bfloat16, "paged",
                                                    [5, 63])
    with pytest.raises(TypeError, match="int32"):
        call(qp, pk, pks, pv, pvs, ppos, layout="paged", tables=tables.long())
    with pytest.raises(ValueError, match="CUDA"):
        call(qp, pk, pks, pv, pvs, ppos, layout="paged", tables=tables.cpu())
    # a pool that starts 8 bytes off a 16-byte line is read 8 bytes a copy
    buf = torch.zeros(pk.numel() + 8, dtype=torch.int8, device="cuda")
    odd = buf[8:].view(pk.shape)
    odd.copy_(pk)
    _k3_check(qp, odd, pks, pv, pvs, ppos, "paged", tables)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_int8", [False, True], ids=["bf16-cache", "int8-cache"])
def test_generate_on_card_launches_k3_per_layer_per_decode_forward(cache_int8):
    _card()
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.models import decode as dec
    from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da

    model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                          max_seq_len=64, generator=torch.Generator().manual_seed(0))
    params = dec.lm_params(model, "cuda")
    prompt = torch.randint(0, 512, (3, 10), generator=torch.Generator().manual_seed(1)).cuda()
    before = da.decode_attention_kernel.launches
    tokens = dec.generate(model, params, prompt, max_new_tokens=7, cache_int8=cache_int8)
    assert tokens.shape == (3, 7) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512
    assert da.decode_attention_kernel.launches - before == (2 * 6 if cache_int8 else 0)


# ViT-S/16 on K2: non-causal, the ragged 197 tokens (a second 128-row item
# of 69 real rows, the masked edge path of the forward and of all three
# backward kernels), head_dim 64, q/k/v read in place as views of the one
# qkv projection (sequence stride 3 * H * D, k 2 * H * D bytes into a row).
@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(256, 6), (2, 2)], ids=["vit-s16", "small"])
def test_k2_at_the_vit_shape_reads_the_qkv_views_in_place(b, h):
    _card()
    s, d = 197, 64
    gen = torch.Generator(device="cuda").manual_seed(b)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
    dout = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()

    def run(fn):
        x = qkv.detach().requires_grad_(True)
        q, k, v = (t.view(b, s, h, d) for t in x.split(h * d, dim=-1))
        out = fn(q, k, v)
        return [out.detach(), *torch.autograd.grad(out, (q, k, v), dout)]

    copies, fwd = fa.flash_attention_forward.copies, fa.flash_attention_forward.launches
    got = run(lambda *x: fa.flash_attention(*x, causal=False))
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.copies == copies  # 0 copies of the views
    assert fa.flash_attention_forward.launches == fwd + 1
    plain = run(lambda *x: fa.attention_reference_layout(*x, False, "bshd"))
    q, k, v = (t.view(b, s, h, d).float() for t in qkv.split(h * d, dim=-1))
    f32 = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, False, "bshd"),
                   q, k, v, dout.float())
    for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, plain, f32):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, p) <= K2_REL_SAME_DTYPE, (name, _rel_err(a, p))
        assert _rel_err(a, e) <= K2_REL_F32, (name, _rel_err(a, e))


def _paired_steps(make_model, batch, steps=2):
    """`steps` train steps of one model through K1 and K2 and of its twin
    (same seed) through their plain versions, both on the card: the
    losses, and K1's (forward, backward), K2's and K2's copies' counts of
    the kernel run."""
    from tritonk8ssupervisor_tpu_torch.models.transformer import dense_attention

    counters = (ce.cross_entropy_forward, ce.cross_entropy_backward, fa.flash_attention_forward,
                fa.flash_attention_backward)
    out = {}
    for name, attention, metrics_fn in (
            ("kernels", fa.flash_attention, ce.cross_entropy_loss_and_correct),
            ("plain", dense_attention, ce.cross_entropy_loss_and_correct_reference)):
        state = train.create_train_state(make_model(attention), train.default_optimizer(0.03))
        if isinstance(batch, tuple):
            step = train.make_train_step(state, metrics_fn=metrics_fn)
        else:
            step = train.make_lm_train_step(state, metrics_fn=metrics_fn)
        before = [c.launches for c in counters] + [fa.flash_attention_forward.copies]
        metrics = [step(*batch) if isinstance(batch, tuple) else step(batch)
                   for _ in range(steps)]
        after = [c.launches for c in counters] + [fa.flash_attention_forward.copies]
        out[name] = ([m["loss"].item() for m in metrics], metrics[-1],
                     [a - b for a, b in zip(after, before)])
    return out


@pytest.mark.cuda
def test_moe_lm_step_through_k1_and_k2_matches_the_plain_versions():
    """Two bf16 steps of a 2-layer LM whose second block is a mixture of 4
    experts (k = 2, capacity factor 0.5, so choices drop), through K1 and
    K2 against the same steps through their plain versions on the card."""
    _card()
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM

    def make(attention):
        return TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                             max_seq_len=128, attention_fn=attention, moe_experts=4,
                             moe_capacity_factor=0.5,
                             generator=torch.Generator().manual_seed(0))

    tokens = torch.randint(0, 512, (4, 128), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).cuda()
    runs = _paired_steps(make, tokens)
    (k_loss, k_metrics, k_counts), (p_loss, p_metrics, p_counts) = runs["kernels"], runs["plain"]
    assert k_counts == [2, 2, 4, 4, 0] and p_counts == [0, 0, 0, 0, 0]
    torch.testing.assert_close(torch.tensor(k_loss), torch.tensor(p_loss), rtol=0, atol=2e-2)
    assert k_metrics["router_loss"].item() > 0 and p_metrics["router_loss"].item() > 0


@pytest.mark.cuda
def test_vit_step_through_k1_and_k2_matches_the_plain_versions():
    """Two bf16 steps of a 2-layer ViT (heads of 64, 17 tokens) with
    `flash_attention`, non-causal, against dense attention and K1's plain
    version, on the card."""
    _card()
    from tritonk8ssupervisor_tpu_torch.models import ViT

    def make(attention):
        return ViT(num_classes=10, patch_size=8, num_layers=2, num_heads=2, embed_dim=128,
                   image_size=32, attention_fn=attention,
                   generator=torch.Generator().manual_seed(0))

    gen = torch.Generator().manual_seed(2)
    batch = (torch.randn(8, 32, 32, 3, generator=gen).cuda(),
             torch.randint(0, 10, (8,), generator=gen, dtype=torch.int32).cuda())
    runs = _paired_steps(make, batch)
    (k_loss, _, k_counts), (p_loss, _, p_counts) = runs["kernels"], runs["plain"]
    assert k_counts == [2, 2, 4, 4, 0] and p_counts == [0, 0, 0, 0, 0]
    torch.testing.assert_close(torch.tensor(k_loss), torch.tensor(p_loss), rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_a_checkpointed_run_resumes_bit_equal_on_the_card(tmp_path):
    """Four LM steps through K1 and K2 straight, against two, a save, a
    restore into a fresh state and two more: K2's backward has no atomics
    and the products run at the same shapes, so every parameter and
    momentum buffer is bit-equal."""
    _card()
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.parallel.checkpoint import TrainCheckpointer

    def fresh(seed):
        model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                              max_seq_len=128, attention_fn=fa.flash_attention,
                              moe_experts=4, generator=torch.Generator().manual_seed(seed))
        return train.create_train_state(model, train.default_optimizer(0.03))

    tokens = torch.randint(0, 512, (4, 128), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32).cuda()
    straight = fresh(0)
    step = train.make_lm_train_step(straight)
    for _ in range(4):
        step(tokens)
    first = fresh(0)
    step = train.make_lm_train_step(first)
    for _ in range(2):
        step(tokens)
    TrainCheckpointer(tmp_path / "ckpt").save(first.step, first)
    resumed = TrainCheckpointer(tmp_path / "ckpt").restore(fresh(1))
    step = train.make_lm_train_step(resumed)
    for _ in range(2):
        step(tokens)
    assert resumed.step == straight.step == 4
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p_a, p_b in zip(resumed.model.parameters(), straight.model.parameters()):
        assert torch.equal(resumed.optimizer.state[p_a]["momentum_buffer"],
                           straight.optimizer.state[p_b]["momentum_buffer"])


# The GPU cluster plane's acceptance tests (config/compile.py), as a host
# runs them: in their own process, the port importable from this checkout.

def _host_env() -> dict:
    import os
    from pathlib import Path

    env = {k: v for k, v in os.environ.items() if not k.startswith("PET_")}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent.parent)
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_gpu_smoke_command_passes_on_the_card():
    import subprocess

    from tritonk8ssupervisor_tpu_torch.config import compile as cc

    _card()
    n = torch.cuda.device_count()
    out = subprocess.run(["bash", "-c", cc.gpu_smoke_command(n)], capture_output=True,
                         text=True, env=_host_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith(f"GPU OK: {n} devices, capability 9.0, nvcc ")


@pytest.mark.cuda
def test_gpu_cluster_smoke_forms_an_nccl_group_of_one():
    import subprocess

    from tritonk8ssupervisor_tpu_torch.config import compile as cc

    _card()
    command = cc.gpu_cluster_smoke_command(1, 0, nnodes=1, gpus_per_node=1,
                                           master_addr="127.0.0.1", master_port=_free_port())
    out = subprocess.run(["bash", "-c", command], capture_output=True, text=True,
                         env=_host_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == ["CLUSTER OK: 1 processes, 1 GPUs"]
