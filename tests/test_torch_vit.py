"""The port's ViT (`models/vit.py`) against the JAX ViT on the same
weights and images: logits in f32 and bf16, one SGD step through the
train steps of both packages (dense and with MoE blocks, whose router
losses must join the objective), the patch refusal, remat against plain,
and `flash_attention` (K2's plain version on the CPU) against dense.

Weights are drawn with numpy from a seed into the flax tree and carried
by `utils/convert.py`; the JAX loss runs its Pallas kernel in interpret
mode, as tests/test_torch_train.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import TOLERANCE, draw
from tritonk8ssupervisor_tpu.models import ViT as JaxViT
from tritonk8ssupervisor_tpu.ops.cross_entropy import (
    cross_entropy_loss_and_correct_interpret,
)
from tritonk8ssupervisor_tpu.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu.parallel import train as jax_train
from tritonk8ssupervisor_tpu_torch.models import ViT
from tritonk8ssupervisor_tpu_torch.models import moe
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import cross_entropy_loss_and_correct
from tritonk8ssupervisor_tpu_torch.ops.flash_attention import flash_attention
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

CONFIG = dict(num_classes=10, patch_size=8, num_layers=2, num_heads=2, embed_dim=32)


def _images(seed, batch=4):
    return np.random.default_rng(seed).normal(size=(batch, 32, 32, 3)).astype(np.float32)


def _pair(dtype="float32", seed=0, **kw):
    jmodel = JaxViT(**CONFIG, dtype=getattr(jnp, dtype), **kw)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    variables = draw(shapes, seed)
    model = ViT(**CONFIG, dtype=getattr(torch, dtype), image_size=32, **kw)
    model.load_state_dict(state_dict_from_flax(variables, model))
    return jmodel, variables, model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(dtype):
    jmodel, variables, model = _pair(dtype, seed=1)
    x = _images(2)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)  # op by op: bf16 rounded per op
    logits = model(torch.from_numpy(x), train=False)
    assert logits.dtype == torch.float32 and logits.shape == (4, 10)  # f32 head
    assert model.pos_embed.shape == (17, 32)  # 4 x 4 patches and [CLS]
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=TOLERANCE[dtype])


@pytest.mark.parametrize("moe_experts", [0, 4], ids=["dense", "moe"])
def test_one_sgd_step_matches_jax(moe_experts):
    """One step of the image train step on both sides; with MoE blocks the
    router losses join the objective, so the router kernel moves as the
    reference's does, while the reported loss is the data loss alone."""
    kw = {"moe_experts": moe_experts, "moe_capacity_factor": 1.0} if moe_experts else {}
    jmodel, variables, model = _pair(seed=3, **kw)
    x = _images(4)
    labels = np.random.default_rng(5).integers(0, 10, 4).astype(np.int32)

    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    tx = jax_train.default_optimizer(learning_rate=0.1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats={}, opt_state=tx.init(params))
    jstep = jax_train.make_train_step(jmodel, tx, mesh, mesh_lib.param_shardings(jstate, mesh),
                                      metrics_fn=cross_entropy_loss_and_correct_interpret)
    jstate, jmetrics = jstep(jstate, jnp.asarray(x), jnp.asarray(labels))

    state = train.create_train_state(model, train.default_optimizer(0.1), device="cpu")
    metrics = train.make_train_step(state, metrics_fn=cross_entropy_loss_and_correct)(
        torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5, atol=1e-5)
    assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    assert ("router_loss" in metrics) == bool(moe_experts)
    expected = state_dict_from_flax({"params": jax.device_get(jstate.params)}, state.model)
    for key, value in state.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    if moe_experts:
        router = "Block_1.moe_mlp.router_kernel"
        before = state_dict_from_flax(variables, state.model)[router]
        assert not torch.equal(state.model.state_dict()[router], before)


def test_a_patch_that_does_not_divide_the_image_raises():
    model = ViT(**CONFIG, image_size=32)
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.ones(1, 30, 30, 3))
    with pytest.raises(ValueError, match="not divisible"):
        ViT(**CONFIG, image_size=30)


def test_remat_gives_the_same_gradients_with_moe_blocks():
    """torch.utils.checkpoint recomputes each block in the backward; the
    recompute must not change the router loss nor a gradient."""
    x = torch.from_numpy(_images(7))
    labels = torch.from_numpy(np.arange(4, dtype=np.int64) % 10)
    grads, aux = [], []
    for remat in (False, True):
        model = ViT(**CONFIG, image_size=32, dtype=torch.float32, moe_experts=4,
                    moe_every=1, moe_capacity_factor=1.0, remat_blocks=remat,
                    generator=torch.Generator().manual_seed(9))
        logits = model(x)
        router_loss = train._moe_aux_total(model)
        loss = torch.nn.functional.cross_entropy(logits, labels) + router_loss
        loss.backward()
        # what a recompute left behind is the same loss
        torch.testing.assert_close(train._moe_aux_total(model), router_loss, rtol=0, atol=0)
        grads.append([p.grad for p in model.parameters()])
        aux.append(router_loss.detach())
    torch.testing.assert_close(aux[0], aux[1], rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_attention_plugs_in_non_causal():
    """K2's plain version on CPU tensors, non-causal at the ragged 17
    tokens, is the dense function."""
    _, variables, dense = _pair(seed=11)
    flash = ViT(**CONFIG, image_size=32, dtype=torch.float32, attention_fn=flash_attention)
    flash.load_state_dict(state_dict_from_flax(variables, flash))
    x = torch.from_numpy(_images(12))
    torch.testing.assert_close(flash(x), dense(x), rtol=1e-5, atol=1e-5)
