"""K2's plain version in the PyTorch port against the JAX `flash_attention`.

Off the TPU the JAX `flash_attention` is its dense reference path
(`attention_reference_layout`), as its own tests run it
(tests/test_ops.py); the port's `flash_attention` on CPU tensors is the
port's plain version. Inputs and cotangents are made with numpy from a
seed and handed to both; gradients come from `jax.vjp` and
`torch.autograd`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu.ops.flash_attention import flash_attention as jax_flash
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops import flash_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import attention_reference

# f32: the same arithmetic in another op order; bf16: both sides round the
# scores, the probabilities and the output to bf16 (inputs and cotangent
# drawn at half scale, so values stay below 4 where a bf16 step is 2^-6)
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(2, 128, 2, 64), (2, 80, 2, 32)]


def _arrays(shape, layout, dtype, seed):
    b, s, h, d = shape
    dims = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    rng = np.random.default_rng(seed)
    arrays = [(rng.normal(size=dims) * 0.5).astype(np.float32) for _ in range(4)]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        arrays = [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                  for a in arrays]
    return arrays


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("shape", SHAPES, ids=["s128-d64", "s80-d32"])
def test_plain_flash_attention_matches_jax(shape, layout, causal, dtype):
    q, k, v, g = _arrays(shape, layout, dtype, seed=sum(shape) + causal)
    jq, jk, jv, jg = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v, g))
    ref, vjp = jax.vjp(lambda *x: jax_flash(*x, causal=causal, layout=layout), jq, jk, jv)
    ref_grads = vjp(jg)

    tq, tk, tv = (_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    before = fa.flash_attention_forward.launches
    out = fa.flash_attention(tq, tk, tv, causal=causal, layout=layout)
    out.backward(_torch(g, dtype))
    assert fa.flash_attention_forward.launches == before  # CPU: no kernel
    assert out.dtype == getattr(torch, dtype) and out.shape == tq.shape

    tol = TOLERANCE[dtype]
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out.detach(), tq.grad, tk.grad, tv.grad),
                               (ref, *ref_grads)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            rtol=0, atol=tol, err_msg=name,
        )


def test_causal_rows_see_only_earlier_keys():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    v2 = v.clone()
    v2[:, 9:] += 1.0  # change only the later keys' values
    out2 = fa.flash_attention(q, k, v2, causal=True)
    torch.testing.assert_close(out[:, :9], out2[:, :9], rtol=0, atol=0)
    assert not torch.allclose(out[:, 9:], out2[:, 9:])
    # the first row attends to itself alone
    torch.testing.assert_close(out[:, 0], v[:, 0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_causal_mask_in_half_precision_matches_jax(dtype):
    """-1e30 overflows fp16 to -inf, as in the reference; the masked
    softmax stays finite either way."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(1, 16, 2, 32)).astype(np.float32) for _ in range(3))
    jdtype = jnp.float16 if dtype == torch.float16 else jnp.bfloat16
    ref = jax_flash(*(jnp.asarray(a).astype(jdtype) for a in (q, k, v)), causal=True)
    out = fa.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=True)
    assert out.dtype == dtype and torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def test_layouts_compute_the_same_function():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 24, 3, 16)).astype(np.float32))
               for _ in range(3))
    seq_major = fa.flash_attention(q, k, v, layout="bshd")
    head_major = fa.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)), layout="bhsd")
    torch.testing.assert_close(head_major.transpose(1, 2), seq_major, rtol=0, atol=1e-6)
    torch.testing.assert_close(seq_major, attention_reference(q, k, v, causal=True))


def test_wrapper_rejects_a_bad_layout_and_a_device_it_has_no_path_for():
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="layout"):
        fa.flash_attention(x, x, x, layout="sbhd")
    meta = torch.empty(1, 8, 2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(x, x, meta)


def test_the_ops_shapes_and_flops_without_a_card():
    """The custom ops' fake implementations and FLOP formulas, traced on
    fake tensors: 4*B*H*D per (query, key) pair forward, 8 backward, over
    S(S+1)/2 pairs when causal."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, h, s, d = 2, 3, 40, 64
    for layout, shape in (("bshd", (b, s, h, d)), ("bhsd", (b, h, s, d))):
        for causal, pairs in ((True, s * (s + 1) // 2), (False, s * s)):
            with FakeTensorMode():
                q, k, v = (torch.empty(shape, dtype=torch.bfloat16, requires_grad=True)
                           for _ in range(3))
                with FlopCounterMode(display=False) as counter:
                    out, lse = torch.ops.tk8s.flash_attn_fwd(q, k, v, causal, layout)
                    out.sum().backward()
                assert out.shape == shape and out.dtype == torch.bfloat16
                assert lse.shape == (b, h, s) and lse.dtype == torch.float32
                assert q.grad.shape == shape
            assert counter.get_total_flops() == 12 * b * h * d * pairs


def _strided(shape, pad_last=0, offset=0):
    """A bf16 (B, S, H, D) view into a larger buffer: rows padded by
    `pad_last` elements, starting `offset` elements in."""
    b, s, h, d = shape
    buf = torch.zeros(b * s * h * (d + pad_last) + offset, dtype=torch.bfloat16)
    return buf[offset:].view(b, s, h, d + pad_last)[..., :d]


@pytest.mark.parametrize("pad_last,offset,message", [
    (4, 0, "multiples of 8"),        # strides of 68 elements
    (0, 4, "aligned"),               # a start 8 bytes past a 16-byte line
    (0, 0, None),                    # dense: read in place
    (8, 8, None),                    # strides of 72 elements, a 16-byte start
], ids=["odd-stride", "misaligned", "dense", "padded"])
def test_k2_forward_raises_on_what_tma_refuses(pad_last, offset, message):
    """The forward reads q, k, v and writes O through TMA tensor maps: the
    launcher refuses strides that are not whole 16-byte multiples and
    starts that are not 16-byte aligned before it builds or launches
    anything."""
    x = _strided((1, 16, 2, 64), pad_last, offset)
    assert x.data_ptr() % 16 == (2 * offset) % 16
    if message is None:
        flash_attention_cuda.check_tma_operand("q", x)
        return
    out, lse = torch.empty(1, 16, 2, 64, dtype=torch.bfloat16), torch.empty(1, 2, 16)
    with pytest.raises(ValueError, match=message):
        flash_attention_cuda.forward(x, x, x, out, lse, True, "bshd")
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_cuda.check_tma_operand("k", x.transpose(-1, -2))


@pytest.mark.parametrize("pad_last,offset,in_place", [
    (0, 0, True),     # dense
    (8, 8, True),     # strides of 72 elements, a 16-byte start
    (4, 0, False),    # strides of 68 elements
    (0, 4, False),    # a start 8 bytes past a 16-byte line
], ids=["dense", "padded", "odd-stride", "misaligned"])
def test_kernel_view_reads_in_place_or_copies(pad_last, offset, in_place):
    """What TMA can address goes to K2 as it is; anything else becomes a
    dense copy with the same values in fresh, 16-byte aligned memory."""
    x = _strided((2, 16, 3, 64), pad_last, offset)
    x.copy_(torch.arange(x.numel(), dtype=torch.float32).view(x.shape))
    y = fa._kernel_view(x)
    assert (y is x) == in_place
    assert y.is_contiguous() or in_place
    assert y.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in y.stride()[:-1])
    assert torch.equal(y, x)
    flash_attention_cuda.check_tma_operand("q", y)


@pytest.mark.parametrize("seq,padded", [(1, 128), (128, 128), (129, 256), (1000, 1024)])
def test_backward_rows_scratch_covers_whole_items(seq, padded):
    """The backward's scratch holds a logsumexp and a rowsum(dO * O) for
    every q row of every (batch, head), over the sequence padded to whole
    128-row items: the kernel's tiles never read past it."""
    assert flash_attention_cuda.rows_numel(2, 3, seq) == 2 * 3 * 2 * padded
