"""The port's `max_pool_3x3_s2` and the ResNet with `fast_pool_bwd`
against the JAX package, on the CPU. Inputs come from numpy seeds; the
reference takes NHWC, the port NCHW views of the same memory."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_resnet import random_flax_variables

from tritonk8ssupervisor_tpu.models import resnet as jax_resnet
from tritonk8ssupervisor_tpu.ops import pool_backward as jax_pool
from tritonk8ssupervisor_tpu_torch.models import resnet
from tritonk8ssupervisor_tpu_torch.ops.pool_backward import max_pool_3x3_s2
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax


def _nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _both(x, dy, dtype):
    """(forward, dx) of the reference and of the port on the same values."""
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ref_y, vjp = jax.vjp(jax_pool.max_pool_3x3_s2, jnp.asarray(x, jdtype))
    (ref_dx,) = vjp(jnp.asarray(dy, jdtype))
    xt = _nchw(x, dtype).requires_grad_(True)
    y = max_pool_3x3_s2(xt)
    y.backward(_nchw(dy, dtype))
    assert y.dtype == xt.grad.dtype == dtype
    return (np.asarray(ref_y, np.float32), np.asarray(ref_dx, np.float32),
            _nhwc(y), _nhwc(xt.grad), xt)


def test_forward_is_bit_equal_to_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 8))
    dy = rng.normal(size=(2, 8, 8, 8))
    ref_y, _, y, _, _ = _both(x, dy, torch.bfloat16)
    np.testing.assert_array_equal(y, ref_y)
    want = fnn.max_pool(jnp.asarray(x, jnp.bfloat16), (3, 3), strides=(2, 2),
                        padding=((1, 1), (1, 1)))
    np.testing.assert_array_equal(y, np.asarray(want, np.float32))


def test_backward_on_unique_maxima_matches_the_reference_and_autodiff():
    """Distinct values everywhere: the mask backward is the ordinary max
    pool gradient, on both sides (tests/test_ops.py:391-411)."""
    x = (np.arange(2 * 8 * 8 * 4, dtype=np.float32).reshape(2, 8, 8, 4) * np.pi) % 7.1
    dy = np.random.default_rng(1).normal(size=(2, 4, 4, 4))
    _, ref_dx, _, dx, xt = _both(x, dy, torch.float32)
    # the same f32 masks, quotients and sums in the reference's order
    np.testing.assert_array_equal(dx, ref_dx)
    xa = xt.detach().clone().requires_grad_(True)
    F.max_pool2d(xa, 3, 2, padding=1).backward(_nchw(dy, torch.float32))
    np.testing.assert_allclose(dx, _nhwc(xa.grad), rtol=1e-6, atol=1e-6)


def test_an_all_equal_window_splits_uniformly_not_as_max_pool2d_routes():
    x = np.zeros((1, 4, 4, 1), np.float32)
    dy = np.ones((1, 2, 2, 1), np.float32)
    _, ref_dx, _, dx, xt = _both(x, dy, torch.float32)
    np.testing.assert_array_equal(dx, ref_dx)
    assert dx.sum() == pytest.approx(4.0) and (dx > 0).sum() > 4
    xa = xt.detach().clone().requires_grad_(True)
    F.max_pool2d(xa, 3, 2, padding=1).backward(_nchw(dy, torch.float32))
    assert (_nhwc(xa.grad) > 0).sum() == 4  # one element per window
    assert np.abs(dx - _nhwc(xa.grad)).max() > 0.1


def test_post_relu_bf16_activations_with_zero_windows_match_the_reference():
    """Stem-like bf16 activations after a ReLU with a negative shift, so
    many windows are all zero and tie across up to nine elements."""
    rng = np.random.default_rng(2)
    x = np.maximum(rng.normal(size=(2, 16, 16, 8)) - 1.0, 0.0)
    dy = rng.normal(size=(2, 8, 8, 8))
    ref_y, ref_dx, y, dx, _ = _both(x, dy, torch.bfloat16)
    zero_windows = (ref_y == 0).mean()
    assert zero_windows > 0.05, zero_windows
    np.testing.assert_array_equal(y, ref_y)
    # the same f32 arithmetic in the same order, rounded once to bf16
    np.testing.assert_array_equal(dx, ref_dx)


def test_resnet18_fast_pool_bwd_step_matches_jax():
    """ResNet-18 with `fast_pool_bwd` on both sides: logits, every
    parameter's gradient and the moved BatchNorm statistics after one
    train-mode forward and backward."""
    jmodel = jax_resnet.ResNet18(num_classes=10, num_filters=8, dtype=jnp.float32,
                                 fast_pool_bwd=True)
    # negative stem biases: many all-zero pool windows after the ReLU
    variables = random_flax_variables(jmodel, seed=4, stem_bias_shift=-1.0)
    tmodel = resnet.ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                             fast_pool_bwd=True)
    tmodel.load_state_dict(state_dict_from_flax(variables, tmodel))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16)

    def loss(params):
        logits, updates = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(16), labels]), (logits, updates)

    (_, (ref_logits, updates)), ref_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    tmodel.train()
    logits = tmodel(torch.from_numpy(x))
    F.cross_entropy(logits, torch.from_numpy(labels)).backward()

    ref_logits = np.asarray(ref_logits)
    # f32 through 18 layers with train-mode BatchNorm over 16 images
    # (tests/test_torch_resnet.py): 1e-3 of the logit scale and of each
    # gradient's largest entry
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0,
                               atol=1e-3 * np.abs(ref_logits).max())
    params = dict(tmodel.named_parameters())
    grads = state_dict_from_flax(
        {"params": jax.device_get(ref_grads), "batch_stats": variables["batch_stats"]}, tmodel)
    for name, p in params.items():
        want = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-3 * max(np.abs(want).max(), 1e-6), err_msg=name)
    stats = state_dict_from_flax(
        {"params": variables["params"], "batch_stats": jax.device_get(updates["batch_stats"])},
        tmodel)
    for key, value in tmodel.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(value.numpy(), stats[key].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=key)

