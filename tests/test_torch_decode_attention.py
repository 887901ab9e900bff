"""K3's contract on the CPU: the port's plain version of the int8-KV decode
attention against the JAX kernel `decode_attention_int8(interpret=True)`,
in both cache layouts, with per-row and per-query positions, and the
port's int8-cache decode block against the JAX einsum decode branch on the
same weights and cache.

Inputs are drawn with numpy from a seed and handed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_transformer import lm_variables

from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
from tritonk8ssupervisor_tpu.models import decode as jax_dec
from tritonk8ssupervisor_tpu.ops.decode_attention import decode_attention_int8 as jax_k3
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.ops.decode_attention import (
    decode_attention_int8,
    decode_attention_int8_plain,
)
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

# the same f32 arithmetic as the TPU kernel, summed in another order
TOLERANCE = 1e-5


def head_major_inputs(b, h, length, d, seed, w=None):
    """q (B, H, D) or (B, W, H, D) f32 and a (B, H, L, D) int8 cache with its
    (B, H, L) scales, quantised as the reference's test does."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d) if w is None else (b, w, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h, length, d)).astype(np.float32)
    v = rng.standard_normal((b, h, length, d)).astype(np.float32)
    ks = (np.abs(k).max(-1) / 127.0 + 1e-8).astype(np.float32)
    vs = (np.abs(v).max(-1) / 127.0 + 1e-8).astype(np.float32)
    k8 = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    return q, k8, ks, v8, vs


def jax_reference(q, k8, ks, v8, vs, pos):
    """The JAX kernel in interpret mode: q (B, H, D), one scalar pos."""
    return np.asarray(jax_k3(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks),
                             jnp.asarray(v8), jnp.asarray(vs), pos, interpret=True))


def torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("pos", [0, 9, 15, 20, -1], ids=["0", "9", "L-1", "past-L", "negative"])
def test_plain_version_matches_jax_kernel(d, pos):
    q, k8, ks, v8, vs = head_major_inputs(2, 3, 16, d, seed=d)
    want = jax_reference(q, k8, ks, v8, vs, pos)
    got = decode_attention_int8_plain(*torch_args(q, k8, ks, v8, vs), pos, layout="bhld")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOLERANCE, atol=TOLERANCE)
    # the entry point takes the plain version on CPU tensors
    routed = decode_attention_int8(*torch_args(q, k8, ks, v8, vs), pos)
    assert torch.equal(routed, got)


def test_negative_pos_is_uniform_over_all_positions():
    """pos < 0 masks every score to -1e30: the softmax is uniform, so the
    output is the mean of vs * v8 over all L (the reference's semantics)."""
    q, k8, ks, v8, vs = head_major_inputs(2, 3, 16, 16, seed=3)
    got = decode_attention_int8_plain(*torch_args(q, k8, ks, v8, vs), -5)
    want = (vs[..., None] * v8.astype(np.float32)).mean(axis=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOLERANCE, atol=TOLERANCE)


def test_cache_layout_blhd_is_the_same_function():
    """The cache as it lies, (B, L, H, D) with (B, L, H) scales, against the
    JAX kernel on the head-major transpose."""
    q, k8, ks, v8, vs = head_major_inputs(2, 3, 16, 16, seed=4)
    want = jax_reference(q, k8, ks, v8, vs, 11)
    got = decode_attention_int8_plain(
        *torch_args(q, k8.transpose(0, 2, 1, 3), ks.transpose(0, 2, 1),
                    v8.transpose(0, 2, 1, 3), vs.transpose(0, 2, 1)), 11, layout="blhd")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOLERANCE, atol=TOLERANCE)


def test_per_row_and_per_query_positions_match_a_loop_of_the_jax_kernel():
    """pos (B,) for single queries and (B, W) for a window: each (row,
    query) equals the JAX kernel at that scalar position."""
    b, h, length, d, w = 3, 2, 16, 16, 4
    q, k8, ks, v8, vs = head_major_inputs(b, h, length, d, seed=5)
    rows = np.array([4, -1, 20], np.int32)
    got = decode_attention_int8_plain(*torch_args(q, k8, ks, v8, vs),
                                      torch.from_numpy(rows)).numpy()
    for i, p in enumerate(rows):
        np.testing.assert_allclose(got[i], jax_reference(q, k8, ks, v8, vs, int(p))[i],
                                   rtol=TOLERANCE, atol=TOLERANCE)

    qw, k8, ks, v8, vs = head_major_inputs(b, h, length, d, seed=6, w=w)
    window = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [13, 14, 15, 16]], np.int32)
    got = decode_attention_int8_plain(
        *torch_args(qw, k8.transpose(0, 2, 1, 3), ks.transpose(0, 2, 1),
                    v8.transpose(0, 2, 1, 3), vs.transpose(0, 2, 1)),
        torch.from_numpy(window), layout="blhd").numpy()
    assert got.shape == (b, w, h, d)
    for j in range(w):
        for i in range(b):
            want = jax_reference(qw[:, j], k8, ks, v8, vs, int(window[i, j]))[i]
            np.testing.assert_allclose(got[i, j], want, rtol=TOLERANCE, atol=TOLERANCE)


def test_shapes_that_do_not_fit_raise():
    q, k8, ks, v8, vs = torch_args(*head_major_inputs(2, 3, 16, 16, seed=7))
    with pytest.raises(ValueError, match="layout"):
        decode_attention_int8(q, k8, ks, v8, vs, 3, layout="lbhd")
    with pytest.raises(ValueError, match="pos of shape"):
        decode_attention_int8(q, k8, ks, v8, vs, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="cache"):
        decode_attention_int8(q, k8, ks, v8, vs, 3, layout="blhd")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_op_gives_the_output_shape_on_fake_tensors(dtype):
    """K3's op `tk8s::decode_attn_int8` traced without a card: its fake
    implementation returns q's shape and dtype, with a tensor pos or a
    scalar one, on a dense cache and on a paged pool with page tables."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(2, 3, 4, 64, dtype=dtype)
        k8 = torch.empty(2, 100, 4, 64, dtype=torch.int8)
        scale = torch.empty(2, 100, 4)
        pool = torch.empty(9, 16, 4, 64, dtype=torch.int8)
        pool_scale = torch.empty(9, 16, 4)
        tables = torch.empty(2, 4, dtype=torch.int32)
        pos = torch.empty(2, 3, dtype=torch.int32)
        for args in ((pos, 0), (None, 7)):
            out = torch.ops.tk8s.decode_attn_int8(q, k8, scale, k8, scale, *args, "blhd")
            assert out.shape == q.shape and out.dtype == dtype
            out = torch.ops.tk8s.decode_attn_int8(q, pool, pool_scale, pool, pool_scale, *args,
                                                  "paged", tables)
            assert out.shape == q.shape and out.dtype == dtype


# the port's int8-cache decode block against the JAX einsum decode branch:
# f32 model, head_dim 16 (1/4 is exact either way), so only the order of
# summation differs; bf16 model: the reference rounds the scores, the key
# scales and the probabilities to bf16 where K3 keeps f32 (2^-8 relative
# each), and the residual stream is bf16: two of its steps near 4 (2^-6
# each). The K/V written at pos: scales to 1e-5 in f32, and in bf16 to one
# step of the bf16 keys they are the maximum of (2^-8 relative).
BLOCK_TOLERANCE = {"float32": 1e-5, "bfloat16": 3.2e-2}
SCALE_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_block_matches_jax_einsum_branch(dtype):
    cfg = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32, max_seq_len=16)
    jmodel = JaxLM(**cfg, dtype=getattr(jnp, dtype), logits_dtype=getattr(jnp, dtype))
    variables = lm_variables(jmodel, seed=8, seq=16)
    model = TransformerLM(**cfg, dtype=getattr(torch, dtype), logits_dtype=getattr(torch, dtype))
    model.load_state_dict(state_dict_from_flax(variables, model))
    params = dec.lm_params(model)

    rng = np.random.default_rng(9)
    b, length, h, d, pos = 2, 16, 2, 16, 10
    cache = {}
    for name in ("k", "v"):
        raw = rng.standard_normal((b, length, h, d)).astype(np.float32)
        codes, scale = dec._quant_kv(torch.from_numpy(raw))
        cache[name], cache[f"{name}_scale"] = codes.numpy(), scale.numpy()
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)

    want, want_cache = jax_dec._block_with_cache(
        variables["params"]["Block_0"], jnp.asarray(x).astype(getattr(jnp, dtype)),
        {k: jnp.asarray(v) for k, v in cache.items()}, pos, 2, 4, getattr(jnp, dtype),
        prefill=False)
    port_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = dec._block_with_cache(params["Block_0"], torch.from_numpy(x).to(getattr(torch, dtype)),
                                port_cache, pos, 2, 4, getattr(torch, dtype), prefill=False)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BLOCK_TOLERANCE[dtype])
    # the write at pos: K/V equal up to the products' order, so a code may
    # sit one step over at a rounding edge
    for name, value in port_cache.items():
        ref = np.asarray(want_cache[name])
        if name.endswith("scale"):
            np.testing.assert_allclose(value.numpy(), ref, rtol=SCALE_RTOL[dtype])
        else:
            assert np.abs(value.numpy().astype(int) - ref).max() <= 1
