"""The port's mixture-of-experts layer (`models/moe.py`) against the JAX
package's, on the same router probabilities, weights and inputs.

Every single-device case of tests/test_moe.py, held against the JAX
functions: the capacity formula, dispatch and combine (compared for
equality, with overflow drops, second choices ranked after first
choices, and tied probabilities), the load-balance loss, `MoEMLP`'s
forward, router loss and gradients (1e-4 in f32, 5e-2 in bf16, the
tolerances of tests/test_torch_transformer.py), `moe_mlp_reference`, and
sparse upcycling of an LM and of a ViT. Weights are drawn with numpy
from a seed into the flax tree and carried by `utils/convert.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
from tritonk8ssupervisor_tpu.models import ViT as JaxViT
from tritonk8ssupervisor_tpu.models import moe as jax_moe
from tritonk8ssupervisor_tpu_torch.models import TransformerLM, ViT, moe
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

TOLERANCE = {"float32": 1e-4, "bfloat16": 5e-2}


def draw(shapes, seed):
    """numpy values for the parameters of a flax variable tree of
    ShapeDtypeStructs (an init's sown router losses are dropped)."""
    rng = np.random.default_rng(seed)
    shapes = {"params": shapes["params"]}

    def leaf(path, s):
        name = path[-1].key
        if name.endswith("kernel"):
            fan_in = s.shape[-2] if len(s.shape) == 3 else int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        if name in ("embedding", "cls_token"):
            return rng.normal(size=s.shape).astype(np.float32)
        if name == "pos_embed":
            return (rng.normal(size=s.shape) * 0.02).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _probs(seed, b=2, s=16, e=4):
    logits = np.random.default_rng(seed).normal(size=(b, s, e)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _dispatch_both(probs, k, capacity):
    want = jax_moe.top_k_dispatch(jnp.asarray(probs), k=k, capacity=capacity)
    got = moe.top_k_dispatch(torch.from_numpy(np.array(probs)), k, capacity)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_capacity_formula():
    for args in [(128, 8, 2, 1.0), (4, 64, 1, 1.0), (1024, 8, 2, 1.25), (197, 4, 2, 0.5)]:
        assert moe.compute_capacity(*args) == jax_moe.compute_capacity(*args)
    assert moe.compute_capacity(seq_len=128, num_experts=8, k=2, capacity_factor=1.0) == 32
    assert moe.compute_capacity(seq_len=4, num_experts=64, k=1, capacity_factor=1.0) == 1


@pytest.mark.parametrize("k,capacity_factor", [(1, 1.0), (2, 1.25), (2, 0.5), (3, 0.75)])
def test_dispatch_and_combine_equal_jax(k, capacity_factor):
    probs = _probs(seed=k * 10 + int(capacity_factor * 4), s=16, e=4)
    capacity = moe.compute_capacity(16, 4, k, capacity_factor)
    want, got = _dispatch_both(probs, k, capacity)
    for name, w, g in zip(("dispatch", "combine", "top1"), want, got):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    dispatch, combine, _ = got
    assert dispatch.sum(axis=1).max() <= 1.0  # a slot holds at most one token
    assert combine.sum(axis=(2, 3)).max() <= 1.0 + 1e-6
    if capacity_factor < 1.0:  # some choices were dropped
        assert dispatch.sum() < probs.shape[0] * probs.shape[1] * k


def test_overflow_drops_keep_the_earliest_tokens():
    probs = np.zeros((1, 8, 4), np.float32)
    probs[..., 0] = 1.0
    want, (dispatch, combine, _) = _dispatch_both(probs, 1, 3)
    np.testing.assert_array_equal(dispatch, want[0])
    np.testing.assert_array_equal(combine, want[1])
    np.testing.assert_array_equal(dispatch[0, :, 0, :].sum(-1), [1, 1, 1, 0, 0, 0, 0, 0])
    assert combine[0, 3:].sum() == 0.0


def test_second_choices_rank_after_first_choices():
    probs = np.asarray([[[0.4, 0.6, 0.0, 0.0],
                         [0.9, 0.1, 0.0, 0.0],
                         [0.9, 0.1, 0.0, 0.0],
                         [0.9, 0.1, 0.0, 0.0]]], np.float32)
    want, got = _dispatch_both(probs, 2, 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][0, :, 0, :].sum(-1), [0, 1, 1, 1])


@pytest.mark.parametrize("k", [1, 2])
def test_a_uniform_router_picks_the_first_experts_and_balances_to_one(k):
    """Tied probabilities: jax.lax.top_k takes the lower index first, and
    so must the port (torch.topk promises no order)."""
    e = 8
    probs = np.full((2, 16, e), 1.0 / e, np.float32)
    want, (dispatch, combine, top1) = _dispatch_both(probs, k, capacity=32)
    for w, g in zip(want, (dispatch, combine, top1)):
        np.testing.assert_array_equal(g, w)
    chosen = dispatch.sum(axis=-1)  # (b, s, E)
    assert (chosen[..., :k] == 1).all() and (chosen[..., k:] == 0).all()
    lb = moe.load_balance_loss(torch.from_numpy(probs), torch.from_numpy(top1))
    assert float(lb) == pytest.approx(1.0, rel=1e-6)

    spread = np.eye(e, dtype=np.float32)[np.arange(4 * 16) % e].reshape(4, 16, e)
    uniform = np.full((4, 16, e), 1.0 / e, np.float32)
    lb = moe.load_balance_loss(torch.from_numpy(uniform), torch.from_numpy(spread))
    want_lb = jax_moe.load_balance_loss(jnp.asarray(uniform), jnp.asarray(spread))
    assert float(lb) == pytest.approx(float(want_lb), rel=1e-6)
    assert float(lb) == pytest.approx(1.0, rel=1e-6)


def _layer_pair(dtype, capacity_factor, seed, b=2, s=16, d=32, e=4):
    jlayer = jax_moe.MoEMLP(num_experts=e, mlp_ratio=2, k=2, capacity_factor=capacity_factor,
                            dtype=getattr(jnp, dtype))
    shapes = jax.eval_shape(lambda: jlayer.init(jax.random.key(0), jnp.zeros((b, s, d))))
    variables = draw(shapes, seed)
    layer = moe.MoEMLP(d, e, mlp_ratio=2, k=2, capacity_factor=capacity_factor,
                       dtype=getattr(torch, dtype))
    layer.load_state_dict(state_dict_from_flax(variables, layer))
    x = np.random.default_rng(seed + 1).normal(size=(b, s, d)).astype(np.float32)
    return jlayer, variables, layer, x


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["no-drops", "drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_forward_router_loss_and_gradients_match_jax(dtype, capacity_factor):
    jlayer, variables, layer, x = _layer_pair(dtype, capacity_factor, seed=5)
    w = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jax_objective(params, xx):
        y, sown = jlayer.apply({"params": params}, xx, mutable=["moe_losses"])
        aux = sum(jax.tree_util.tree_leaves(sown))
        return jnp.sum(y.astype(jnp.float32) * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jax_objective, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    aux = layer.router_loss
    assert aux.shape == () and y.dtype == getattr(torch, dtype)
    (torch.sum(y.float() * torch.from_numpy(w)) + aux).backward()

    tol = TOLERANCE[dtype]
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # the router runs in f32 on both sides
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=tol, atol=tol)
    for name, value in jgrads.items():
        grad = getattr(layer, name).grad.numpy()
        scale = max(1.0, float(np.abs(value).max()))
        np.testing.assert_allclose(grad, np.asarray(value), rtol=tol, atol=tol * scale,
                                   err_msg=name)
    if capacity_factor < 1:  # drops: dropped tokens leave the layer at 0
        capacity = moe.compute_capacity(16, 4, 2, capacity_factor)
        probs = torch.softmax(torch.from_numpy(x) @ layer.router_kernel.detach(), dim=-1)
        dispatch, _, _ = moe.top_k_dispatch(probs, 2, capacity)
        assert dispatch.sum() < 2 * 16 * 2


def test_moe_mlp_matches_the_reference_when_nothing_drops():
    jlayer, variables, layer, x = _layer_pair("float32", 8.0, seed=9)
    with torch.no_grad():
        y = layer(torch.from_numpy(x))
        ref = moe.moe_mlp_reference(layer.state_dict(), torch.from_numpy(x), k=2)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-5)
    jref = jax.jit(lambda v, xx: jax_moe.moe_mlp_reference(v, xx, k=2))(
        {"params": variables["params"]}, jnp.asarray(x))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=1e-4, atol=1e-5)


def test_router_loss_is_kept_from_the_last_forward():
    layer = moe.MoEMLP(16, 4, mlp_ratio=2, dtype=torch.float32)
    assert layer.router_loss is None
    gen = torch.Generator().manual_seed(0)
    x1, x2 = torch.randn(2, 8, 16, generator=gen), torch.randn(2, 8, 16, generator=gen)
    layer(x1)
    first = layer.router_loss.detach()
    assert first.shape == () and float(first) > 0.0  # the load-balance term is >= 1
    layer(x2)
    assert not torch.equal(layer.router_loss.detach(), first)  # replaced, not summed
    layer(x1)
    torch.testing.assert_close(layer.router_loss.detach(), first, rtol=0, atol=0)


def test_a_mesh_raises_naming_item_4b(tmp_path):
    """A MoE layer takes a mesh (expert parallelism,
    tests/test_torch_mesh_train.py), and a MoE LM steps with its sequence
    over "model" (tests/test_torch_moe_seq.py on 2 and 4 ranks): the step
    points the MoE layers at the axis. On a gloo group of one rank (one
    shard, zero offsets) the step with the sequence axis equals the step
    without it to the bit."""
    import torch.distributed as dist

    from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
    from tritonk8ssupervisor_tpu_torch.parallel import train

    marker = object()
    assert moe.MoEMLP(16, 4, mesh=marker).mesh is marker
    cfg = dict(vocab_size=32, num_layers=2, num_heads=2, embed_dim=16, max_seq_len=8,
               moe_experts=4, moe_capacity_factor=0.5, dtype=torch.float32,
               logits_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 32, (2, 8)))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_mesh(device_type="cpu")
        out = {}
        for seq_axis in (None, "model"):
            model = TransformerLM(**cfg, moe_mesh=mesh)
            assert model.Block_1.moe_mlp.mesh is mesh
            state = train.create_train_state(model, train.default_optimizer(0.1), mesh=mesh)
            step = train.make_lm_train_step(state, seq_axis=seq_axis)
            assert model.Block_1.moe_mlp.seq_axis == seq_axis
            out[seq_axis] = (step(tokens), model.state_dict())
    finally:
        dist.destroy_process_group()
    (plain, plain_sd), (seq, seq_sd) = out[None], out["model"]
    assert {k: float(v) for k, v in plain.items()} == {k: float(v) for k, v in seq.items()}
    for key, value in plain_sd.items():
        assert torch.equal(seq_sd[key], value), key


UPCYCLE = {
    "lm": (JaxLM, TransformerLM, dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
                                      max_seq_len=16),
           {}, np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)),
    "vit": (JaxViT, ViT, dict(num_classes=10, patch_size=8, num_layers=2, num_heads=2,
                              embed_dim=32),
            {"image_size": 32},
            np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)),
}


@pytest.mark.parametrize("family", ["lm", "vit"])
def test_upcycled_model_equals_the_dense_one_at_step_0(family):
    """Identical experts, renormalised top-k gates and capacity that drops
    nothing: the upcycled MoE model computes the dense model's function
    (held against the JAX dense model), every non-MLP entry carries over
    as it is, and the result fits the MoE model's own state dict."""
    jax_cls, torch_cls, config, extra, inputs = UPCYCLE[family]
    jdense = jax_cls(**config, dtype=jnp.float32,
                     **({"logits_dtype": jnp.float32} if family == "lm" else {}))
    dtypes = {"dtype": torch.float32, **({"logits_dtype": torch.float32}
                                         if family == "lm" else {})}
    shapes = jax.eval_shape(lambda: jdense.init(jax.random.key(0), jnp.asarray(inputs),
                                                train=False))
    variables = draw(shapes, seed=11)
    dense = torch_cls(**config, **extra, **dtypes)
    dense.load_state_dict(state_dict_from_flax(variables, dense))
    moe_model = torch_cls(**config, **extra, **dtypes, moe_experts=4, moe_every=2,
                          moe_capacity_factor=8.0)
    upcycled = moe.upcycle_dense_to_moe(dense.state_dict(), moe_model,
                                        torch.Generator().manual_seed(2))
    target = moe_model.state_dict()
    assert {k: v.shape for k, v in upcycled.items()} == {k: v.shape for k, v in target.items()}
    moe_model.load_state_dict(upcycled)
    for key, value in dense.state_dict().items():
        if key in target:
            torch.testing.assert_close(upcycled[key], value, rtol=0, atol=0, msg=key)

    want = jax.jit(lambda v, i: jdense.apply(v, i, train=False))(variables, jnp.asarray(inputs))
    with torch.no_grad():
        got = moe_model(torch.from_numpy(inputs), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="moe_experts"):
        moe.upcycle_dense_to_moe(dense.state_dict(), dense)
