"""The port's TransformerLM against the JAX TransformerLM on the same
weights and tokens, seq-major and head-major, in f32 and bf16.

The weights are drawn with numpy from a seed into the flax variable tree
and carried to the port by `utils/convert.py`. Both sides use dense
attention here (the JAX `flash_attention` is dense off the TPU; the
port's plain version is the same arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
from tritonk8ssupervisor_tpu.ops.flash_attention import flash_attention as jax_flash
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models import transformer
from tritonk8ssupervisor_tpu_torch.ops.flash_attention import flash_attention
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

CONFIG = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=128, max_seq_len=64)
# f32: the same math in other op orders over two layers; bf16: both sides
# round activations to bf16 at the same points, and a logit near 4 has a
# bf16 step of 2^-5, so a one-step disagreement is 3.1e-2
TOLERANCE = {"float32": 1e-4, "bfloat16": 5e-2}


def lm_variables(jax_model, seed, seq=64):
    """flax variables of `jax_model` with every leaf drawn from numpy."""
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.key(0), jnp.zeros((1, seq), jnp.int32))
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=s.shape).astype(np.float32)
        if name == "pos_embed":
            return (rng.normal(size=s.shape) * 0.02).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tokens(seed, batch=2, seq=64, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)


def _pair(dtype, head_major, seed=0):
    jmodel = JaxLM(**CONFIG, attention_fn=jax_flash, dtype=getattr(jnp, dtype),
                   logits_dtype=getattr(jnp, dtype), head_major=head_major)
    variables = lm_variables(jmodel, seed)
    model = TransformerLM(**CONFIG, attention_fn=flash_attention,
                          dtype=getattr(torch, dtype), logits_dtype=getattr(torch, dtype),
                          head_major=head_major)
    model.load_state_dict(state_dict_from_flax(variables, model))
    return jmodel, variables, model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_major", [False, True], ids=["seq-major", "head-major"])
def test_logits_match_jax(head_major, dtype):
    jmodel, variables, model = _pair(dtype, head_major, seed=1)
    tokens = _tokens(2)
    ref = jmodel.apply(variables, jnp.asarray(tokens), train=False)
    logits = model(torch.from_numpy(tokens), train=False)
    assert logits.dtype == getattr(torch, dtype) and logits.shape == (2, 64, 256)
    np.testing.assert_allclose(
        logits.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)),
        rtol=0, atol=TOLERANCE[dtype],
    )


def test_head_major_is_the_same_function_on_the_same_weights():
    _, variables, seq_major = _pair("float32", False, seed=3)
    head_major = TransformerLM(**CONFIG, dtype=torch.float32,
                               logits_dtype=torch.float32, head_major=True)
    head_major.load_state_dict(state_dict_from_flax(variables, head_major))
    tokens = torch.from_numpy(_tokens(4))
    torch.testing.assert_close(head_major(tokens), seq_major(tokens), rtol=1e-5, atol=1e-5)


def test_changing_a_later_token_leaves_earlier_logits_alone():
    _, _, model = _pair("float32", False, seed=5)
    tokens = torch.from_numpy(_tokens(6, batch=1))
    changed = tokens.clone()
    changed[0, 10] = (changed[0, 10] + 1) % 256
    a, b = model(tokens), model(changed)
    torch.testing.assert_close(a[0, :10], b[0, :10], rtol=0, atol=0)
    assert not torch.allclose(a[0, 10:], b[0, 10:])


def test_remat_blocks_give_the_same_gradients():
    torch.manual_seed(0)
    tokens = torch.from_numpy(_tokens(7))
    grads = []
    for remat in (False, True):
        model = TransformerLM(**CONFIG, dtype=torch.float32, logits_dtype=torch.float32,
                              remat_blocks=remat, generator=torch.Generator().manual_seed(9))
        model(tokens).float().square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_default_dtypes_and_seeded_init():
    a = TransformerLM(**CONFIG, generator=torch.Generator().manual_seed(1))
    b = TransformerLM(**CONFIG, generator=torch.Generator().manual_seed(1))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.dtype == torch.float32, name  # f32 parameters
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    logits = a(torch.zeros(2, 16, dtype=torch.int32))
    assert logits.dtype == torch.bfloat16  # bf16 head by default, as the reference
    assert a.Block_0.attention_fn is transformer.dense_attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lm_logits_match_jax(dtype):
    """Every second block a mixture of 4 experts (capacity factor 1, so
    some choices drop): the MoE block adds its output to the residual,
    as the reference's does."""
    from test_torch_moe import draw

    moe = dict(moe_experts=4, moe_every=2, moe_capacity_factor=1.0)
    jmodel = JaxLM(**CONFIG, **moe, attention_fn=jax_flash, dtype=getattr(jnp, dtype),
                   logits_dtype=getattr(jnp, dtype))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64), jnp.int32)))
    variables = draw(shapes, seed=12)
    model = TransformerLM(**CONFIG, **moe, attention_fn=flash_attention,
                          dtype=getattr(torch, dtype), logits_dtype=getattr(torch, dtype))
    model.load_state_dict(state_dict_from_flax(variables, model))
    assert hasattr(model.Block_1, "moe_mlp") and not hasattr(model.Block_0, "moe_mlp")
    tokens = _tokens(13)
    # op by op, as the other logit tests here: under jit XLA keeps some
    # bf16 intermediates in f32, and a router input one bf16 step away can
    # move which choices the capacity drops
    ref = jmodel.apply(variables, jnp.asarray(tokens), train=False)
    logits = model(torch.from_numpy(tokens), train=False)
    np.testing.assert_allclose(
        logits.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)),
        rtol=0, atol=TOLERANCE[dtype],
    )


def test_moe_block_with_a_mesh_raises_naming_item_4b():
    """A MoE block takes a mesh, and a MoE LM takes a sequence shard
    (pos_offset > 0; the shards' slot offsets are the MoE layers' own,
    tests/test_torch_moe_seq.py): the offset reads `pos_embed` at the
    shard's positions, so it computes what the model whose first
    positions hold those embeddings computes at offset 0."""
    mesh = object()
    block = transformer.Block(64, 2, transformer.dense_attention, 4, torch.float32,
                              moe_experts=2, moe_mesh=mesh)
    assert block.moe_mlp.mesh is mesh
    cfg = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16, max_seq_len=8,
               moe_experts=2, dtype=torch.float32, logits_dtype=torch.float32)
    model = TransformerLM(**cfg)
    shifted = TransformerLM(**cfg)
    shifted.load_state_dict(model.state_dict())
    with torch.no_grad():
        shifted.pos_embed[:4] = model.pos_embed[4:]
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 32, (1, 4)))
    torch.testing.assert_close(model(tokens, pos_offset=4), shifted(tokens), rtol=0, atol=0)


def test_layer_norm_and_dense_follow_flax():
    """flax LayerNorm (epsilon 1e-6, fast variance, f32 statistics, output
    in the model dtype) and Dense (f32 kernel cast per call)."""
    import flax.linen as fnn

    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3 + 1
    scale, bias = rng.uniform(0.5, 1.5, 32).astype(np.float32), rng.normal(size=32).astype(np.float32)
    ln = fnn.LayerNorm(dtype=jnp.bfloat16, param_dtype=jnp.float32)
    ref = ln.apply({"params": {"scale": scale, "bias": bias}},
                   jnp.asarray(x).astype(jnp.bfloat16))
    port = transformer.LayerNorm(32, torch.bfloat16)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    out = port(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0, atol=2e-2)

    kernel = rng.normal(size=(32, 16)).astype(np.float32)
    dense = fnn.Dense(16, dtype=jnp.float32, param_dtype=jnp.float32)
    ref = dense.apply({"params": {"kernel": kernel, "bias": bias[:16]}}, jnp.asarray(x))
    port = transformer.Dense(32, 16, torch.float32)
    port.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                          "bias": torch.from_numpy(bias[:16].copy())})
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
