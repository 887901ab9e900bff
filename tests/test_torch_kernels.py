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
        pytest.skip("needs a CUDA card: K1 (Triton), K2, K3 and K4 (CUDA C++) have no CPU mode")


def _inputs(batch, classes, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = (torch.randn(batch, classes, generator=gen, device="cuda") * 4).to(dtype)
    labels = torch.randint(0, classes, (batch,), generator=gen, device="cuda")
    labels[:2] = torch.tensor([-1, classes])
    for row in range(2, min(6, batch)):
        top = logits[row].max() + 1
        logits[row, 0] = logits[row, classes - 1] = top
        labels[row] = 0 if row % 2 else classes - 1
    return logits, labels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("batch,classes", [(256, 1000), (37, 5000), (8, 32000), (5, 7)])
def test_k1_matches_plain_version(batch, classes, dtype, label_dtype):
    _card()
    logits, labels = _inputs(batch, classes, dtype)
    labels = labels.to(label_dtype)
    before = ce.cross_entropy_forward.launches
    loss, correct = ce.cross_entropy_forward(logits, labels)
    torch.cuda.synchronize()
    assert ce.cross_entropy_forward.launches == before + 1
    ref_loss, ref_correct = ce.cross_entropy_forward_plain(logits, labels)
    # the same f32 arithmetic reduced in another order: 1e-5
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
    assert torch.equal(correct, ref_correct)
    assert correct[2:6].all() and not correct[:2].any()


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


@pytest.mark.cuda
def test_k1_gradient_matches_reference():
    _card()
    logits, labels = _inputs(64, 1000, torch.float32, seed=3)
    labels = labels.clamp(0, 999)
    x = logits.clone().requires_grad_(True)
    ce.cross_entropy_loss(x, labels).mean().backward()
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
    before = ce.cross_entropy_forward.launches
    metrics = step(images, labels)
    assert torch.isfinite(metrics["loss"])
    assert ce.cross_entropy_forward.launches == before + 1


@pytest.mark.cuda
def test_k1_bf16_at_the_lm_shape():
    _card()
    logits, labels = _inputs(8192, 32768, torch.bfloat16, seed=4)
    loss, correct = ce.cross_entropy_forward(logits, labels.int())
    torch.cuda.synchronize()
    ref_loss, ref_correct = ce.cross_entropy_forward_plain(logits, labels.int())
    # the same bf16 values upcast to f32 on both sides, reduced in
    # another order over 32768 columns: 1e-5
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
    assert torch.equal(correct, ref_correct)


# K2: bf16/fp16 kernel against the plain version. Tolerances are taken
# relative to the reference's largest magnitude (at least 1): the kernel
# keeps the scores in f32 and rounds P and dS to the input dtype for the
# next product (8 mantissa bits in bf16: 2^-9 relative per rounding);
# against the plain version in the same dtype, which also rounds the
# scores, 2e-2; against the plain version on f32 copies of the same
# inputs, 1e-2.
K2_REL_SAME_DTYPE = 2e-2
K2_REL_F32 = 1e-2

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


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dtype,causal,layout", K2_CASES)
def test_k2_matches_plain_version(b, s, h, d, dtype, causal, layout):
    _card()
    q, k, v, dout = _k2_inputs(b, s, h, d, dtype, layout)
    fwd, bwd = fa.flash_attention_forward.launches, fa.flash_attention_backward.launches
    got = _fwd_bwd(lambda *x: fa.flash_attention(*x, causal=causal, layout=layout),
                   q, k, v, dout)
    torch.cuda.synchronize()
    assert fa.flash_attention_forward.launches == fwd + 1
    assert fa.flash_attention_backward.launches == bwd + 1
    assert all(g.dtype == dtype and g.shape == q.shape for g in got)
    plain = _fwd_bwd(lambda *x: fa.attention_reference_layout(*x, causal, layout),
                     q, k, v, dout)
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
def test_k2_backward_is_deterministic():
    """No atomics: every dQ, dK and dV row is written by one CTA in a fixed
    order, so two backward calls on the same inputs agree bit for bit."""
    _card()
    q, k, v, dout = _k2_inputs(4, 1024, 12, 64, torch.bfloat16, "bshd", seed=11)
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
    x = torch.zeros(1, 128, 2, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 128, 2, 64, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(y, y, y)
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
    counts = (ce.cross_entropy_forward.launches, fa.flash_attention_forward.launches,
              fa.flash_attention_backward.launches)
    metrics = step(tokens)
    assert torch.isfinite(metrics["loss"])
    assert (ce.cross_entropy_forward.launches, fa.flash_attention_forward.launches,
            fa.flash_attention_backward.launches) == (counts[0] + 1, counts[1] + 2, counts[2] + 2)


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
]


def _k4_inputs(m, c, n, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x2 = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
    dy2 = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
    w2 = (torch.randn(n, c, generator=gen, device="cuda") / c ** 0.5).to(dtype)
    return x2, dy2, w2


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,n,dtype", K4_CASES)
def test_k4_matches_plain_version(m, c, n, dtype):
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x2, dy2, w2 = _k4_inputs(m, c, n, dtype)
    before = cb.conv1x1_backward_kernel.launches
    dx, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    assert cb.conv1x1_backward_kernel.launches == before + 1
    assert dx.dtype == dtype and dx.shape == (m, c) and dw.dtype == torch.float32
    ref_dx, ref_dw = cb.conv1x1_backward_plain(x2, dy2, w2, dtype)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
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
def test_k4_is_deterministic():
    """dW is summed over a fixed split of M in a fixed order: two calls on
    the same inputs agree bit for bit."""
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x2, dy2, w2 = _k4_inputs(200704, 128, 512, torch.bfloat16, seed=1)
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
def test_k4_raises_on_what_it_does_not_take():
    _card()
    from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb

    x = torch.zeros(2, 16, 4, 4, device="cuda").to(memory_format=torch.channels_last)
    w = torch.zeros(8, 16, 1, 1, device="cuda")
    dy = torch.zeros(2, 8, 4, 4, device="cuda").to(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="bf16"):
        cb.conv1x1_backward(x, w, dy, torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        cb.conv1x1_backward(x[:, :12], w[:, :12], dy, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv1x1_backward(x, w.cpu(), dy, torch.bfloat16)
    # the wrapper itself, on rows that are not K4's
    x2, dy2, w2 = _k4_inputs(64, 16, 8, torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        cb.conv1x1_backward_kernel(x2.float(), dy2.float(), w2.float())
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
    before = cb.conv1x1_backward_kernel.launches, ce.cross_entropy_forward.launches
    metrics = step(images, labels)
    assert torch.isfinite(metrics["loss"])
    # Conv_0 and Conv_2 of both blocks and stage 0's stride-1 shortcut
    assert cb.conv1x1_backward_kernel.launches == before[0] + 5
    assert ce.cross_entropy_forward.launches == before[1] + 1


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
@pytest.mark.parametrize("d", [16, 64, 128])
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
    with pytest.raises(ValueError, match="multiple of 16"):
        q24, k24, ks24, v24, vs24, _, _ = _k3_inputs(2, 1, 2, 64, 24, torch.bfloat16, "blhd", 3)
        call(q24, k24, ks24, v24, vs24, 3, layout="blhd")
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(2 * 64 * 2 * 64 + 1, dtype=torch.int8, device="cuda")
        call(q, buf[1:].view(2, 64, 2, 64), ks, v8, vs, 3, layout="blhd")
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
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(pk.numel() + 8, dtype=torch.int8, device="cuda")
        call(qp, buf[8:].view(pk.shape), pks, pv, pvs, ppos, layout="paged", tables=tables)


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
