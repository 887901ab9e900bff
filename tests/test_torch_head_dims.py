"""K2 and K3 at every head_dim they take, on the CPU.

The port's LM train step with `attention_fn=flash_attention` against the
JAX `make_lm_train_step` with its own `flash_attention`, at head_dims
from 8 to 256 (both sides take the plain attention off their
accelerators); K3's plain version against the JAX kernel
`decode_attention_int8(interpret=True)` at head_dims that are not
multiples of 16; and the host-side pieces of K2 that need no card: the
tile width a head_dim runs on, the padded copy of a head_dim that is not a
multiple of 8, and the cost functions and FLOP formula at the real
head_dim. Inputs and weights are drawn with numpy from a seed and handed
to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode_attention import TOLERANCE, head_major_inputs, jax_reference, torch_args
from test_torch_moe import draw
from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
from tritonk8ssupervisor_tpu.ops.cross_entropy import cross_entropy_loss_and_correct_interpret
from tritonk8ssupervisor_tpu.ops.flash_attention import flash_attention as jax_flash
from tritonk8ssupervisor_tpu.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu.parallel import train as jax_train
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.ops import decode_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops import flash_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import cross_entropy_loss_and_correct
from tritonk8ssupervisor_tpu_torch.ops.decode_attention import decode_attention_int8_plain
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

VOCAB, BATCH = 128, 2

# (head_dim, heads, layers, seq): embed = heads * head_dim
LM_HEAD_DIMS = [
    pytest.param(8, 4, 2, 32, id="d8"),
    pytest.param(32, 2, 2, 32, id="d32"),
    pytest.param(36, 2, 1, 24, id="d36"),
    pytest.param(40, 2, 1, 16, id="d40"),
    pytest.param(80, 1, 2, 16, id="d80"),
    pytest.param(96, 2, 1, 16, id="d96"),
    pytest.param(256, 1, 1, 16, id="d256"),
]


@pytest.mark.parametrize("d,heads,layers,seq", LM_HEAD_DIMS)
def test_lm_step_with_flash_attention_matches_jax(d, heads, layers, seq):
    """One SGD step of an f32 LM whose heads are d wide, with flash
    attention on both sides: the loss to 1e-5 and every updated parameter
    to 1e-4, the tolerances of tests/test_torch_lm_train.py (f32
    gradients summed in other orders)."""
    config = dict(vocab_size=VOCAB, num_layers=layers, num_heads=heads, embed_dim=heads * d,
                  max_seq_len=seq)
    jmodel = JaxLM(**config, attention_fn=jax_flash, dtype=jnp.float32,
                   logits_dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, seq), jnp.int32)))
    variables = draw(shapes, seed=d)
    tx = jax_train.default_optimizer(learning_rate=0.1)
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                  opt_state=tx.init(params))
    jstep = jax_train.make_lm_train_step(jmodel, tx, mesh, mesh_lib.param_shardings(jstate, mesh),
                                         metrics_fn=cross_entropy_loss_and_correct_interpret)

    model = TransformerLM(**config, attention_fn=fa.flash_attention, dtype=torch.float32,
                          logits_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables, model))
    state = train.create_train_state(model, train.default_optimizer(0.1), device="cpu")
    step = train.make_lm_train_step(state, metrics_fn=cross_entropy_loss_and_correct)

    tokens = np.random.default_rng(d + 1).integers(0, VOCAB, (BATCH, seq)).astype(np.int32)
    launches = fa.flash_attention_forward.launches
    jstate, jmetrics = jstep(jstate, jnp.asarray(tokens))
    metrics = step(torch.from_numpy(tokens))
    assert fa.flash_attention_forward.launches == launches  # the CPU: the plain version
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5, atol=1e-5)
    expected = state_dict_from_flax({"params": jax.device_get(jstate.params)}, state.model)
    for key, value in state.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("d", [40, 72, 256])
@pytest.mark.parametrize("pos", [0, 17, 31, -1], ids=["0", "17", "L-1", "negative"])
def test_k3_plain_version_matches_jax_kernel_at_head_dim(d, pos):
    """One position for every row: head_dims that are not multiples of 16
    (40, 72) and the widest K3 takes (256)."""
    q, k8, ks, v8, vs = head_major_inputs(2, 3, 32, d, seed=d)
    want = jax_reference(q, k8, ks, v8, vs, pos)
    got = decode_attention_int8_plain(*torch_args(q, k8, ks, v8, vs), pos, layout="bhld")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOLERANCE, atol=TOLERANCE)


@pytest.mark.parametrize("d", [40, 72, 256])
def test_k3_plain_version_per_row_positions_match_jax_kernel(d):
    """A (B,) position per row, in the cache's (B, L, H, D) layout: each row
    equals the JAX kernel at that row's scalar position."""
    q, k8, ks, v8, vs = head_major_inputs(3, 2, 32, d, seed=d + 1)
    rows = np.array([5, -1, 40], np.int32)
    got = decode_attention_int8_plain(
        *torch_args(q, k8.transpose(0, 2, 1, 3), ks.transpose(0, 2, 1),
                    v8.transpose(0, 2, 1, 3), vs.transpose(0, 2, 1)),
        torch.from_numpy(rows), layout="blhd").numpy()
    for i, p in enumerate(rows):
        np.testing.assert_allclose(got[i], jax_reference(q, k8, ks, v8, vs, int(p))[i],
                                   rtol=TOLERANCE, atol=TOLERANCE)


@pytest.mark.parametrize("d,tile", [(1, 64), (8, 64), (36, 64), (64, 64), (65, 128), (96, 128),
                                    (128, 128), (129, 256), (200, 256), (256, 256)])
def test_k2_runs_a_head_dim_on_the_narrowest_tile_that_holds_it(d, tile):
    assert flash_attention_cuda.tile_width(d) == tile


@pytest.mark.parametrize("d", [0, 257, 264, 512])
def test_k2_refuses_a_head_dim_outside_1_to_256(d):
    with pytest.raises(ValueError, match="from 1 to 256"):
        flash_attention_cuda.tile_width(d)


def test_k2_launcher_refuses_a_head_dim_past_256_before_it_builds():
    """A contiguous (B, S, H, 264) tensor passes the TMA checks; the tile
    pick refuses it before the library is built or anything launched."""
    x = torch.zeros(1, 16, 2, 264, dtype=torch.bfloat16)
    out, lse = torch.empty_like(x), torch.empty(1, 2, 16)
    with pytest.raises(ValueError, match="from 1 to 256"):
        flash_attention_cuda.forward(x, x, x, out, lse, True, "bshd")


@pytest.mark.parametrize("d,width", [(1, 8), (7, 8), (8, 8), (36, 40), (40, 40), (81, 88),
                                     (255, 256)])
def test_k2_pads_a_head_dim_to_the_next_multiple_of_8(d, width):
    assert flash_attention_cuda.padded_width(d) == width


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_k2_reads_a_head_dim_not_a_multiple_of_8_from_a_zero_padded_copy(layout):
    """d = 36 has 72-byte rows, which TMA cannot address: the wrapper's
    view is a copy 40 wide, the values in front and zeros behind, in fresh
    memory that TMA can read."""
    x = torch.randn(2, 5, 3, 36, generator=torch.Generator().manual_seed(0)).bfloat16()
    if layout == "bhsd":
        x = x.transpose(1, 2)
    y = fa._kernel_view(x)
    assert y.shape == (*x.shape[:-1], 40) and y.dtype == x.dtype
    assert torch.equal(y[..., :36], x) and not y[..., 36:].any()
    flash_attention_cuda.check_tma_operand("q", y)
    same = torch.zeros(2, 5, 3, 40, dtype=torch.bfloat16)
    assert fa._kernel_view(same) is same  # a multiple of 8 is read in place


@pytest.mark.parametrize("d", [8, 36, 96, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_k2_costs_count_the_real_head_dim(d, causal):
    """Bytes and tensor-core operations of both directions, and the FLOP
    formula the counter reads, at the caller's d: the tile's zero columns
    and a padded copy's are not model work."""
    b, h, s = 2, 3, 100
    pairs = s * (s + 1) // 2 if causal else s * s
    n = b * s * h * d
    assert fa.forward_cost(b, h, s, d, causal, 2) == (4 * n * 2 + b * h * s * 4,
                                                      4 * b * h * d * pairs)
    assert fa.backward_cost(b, h, s, d, causal, 2) == (8 * n * 2 + b * h * s * 4,
                                                       10 * b * h * d * pairs)
    for layout, shape in (("bshd", (b, s, h, d)), ("bhsd", (b, h, s, d))):
        assert fa._fwd_flops(shape, shape, shape, causal, layout) == 4 * b * h * d * pairs
        assert fa._bwd_flops(shape, shape, shape, shape, shape, (b, h, s), causal,
                             layout) == 8 * b * h * d * pairs


@pytest.mark.parametrize("d,width", [(1, 16), (16, 16), (33, 48), (40, 48), (72, 80), (256, 256)])
def test_k3_computes_at_the_head_dim_rounded_up_to_16(d, width):
    assert decode_attention_cuda.padded_dim(d) == width
