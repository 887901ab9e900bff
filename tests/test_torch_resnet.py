"""The port's ResNet against the flax reference on the same weights.

Weights are made with numpy from a seed in the flax layout (every
BatchNorm scale, bias and statistic random too, so no residual branch
is silenced by the zero-init scale), handed to the flax model as they
are and to the port through utils/convert.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tritonk8ssupervisor_tpu.models import resnet as jax_resnet
from tritonk8ssupervisor_tpu_torch.models import resnet
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

FAMILIES = {
    "resnet18": (jax_resnet.ResNet18, resnet.ResNet18),
    "resnet50": (jax_resnet.ResNet50, resnet.ResNet50),
}


def random_flax_variables(model, seed, image=32, stem_bias_shift=0.0):
    """flax variables of `model` with every leaf drawn from numpy; the
    stem BatchNorm's bias is moved by `stem_bias_shift` (negative: many
    all-zero windows after the stem's ReLU)."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, image, image, 3)), train=False)
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        shift = stem_bias_shift if path[0].key == "stem_norm" and name == "bias" else 0.0
        return (rng.normal(size=s.shape) * 0.1 + shift).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(family, dtype, seed=0):
    jax_cls, torch_cls = FAMILIES[family]
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jmodel = jax_cls(num_classes=10, num_filters=8, dtype=jdtype)
    variables = random_flax_variables(jmodel, seed)
    tmodel = torch_cls(num_classes=10, num_filters=8, dtype=dtype)
    tmodel.load_state_dict(state_dict_from_flax(variables, tmodel))
    return jmodel, variables, tmodel


def _images(seed, n=4, image=32):
    return np.random.default_rng(seed).normal(size=(n, image, image, 3)).astype(np.float32)


def _stats_state_dict(tmodel):
    return {k: v.numpy() for k, v in tmodel.state_dict().items() if "running_" in k}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_eval_and_train_match_flax(family):
    jmodel, variables, tmodel = _pair(family, torch.float32)
    # 16 images: ResNet-50's last stage is 1x1 at 32x32, so train mode
    # normalises each channel there over the batch alone
    x = _images(1, n=16)

    ref_eval = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    tmodel.eval()
    with torch.no_grad():
        got_eval = tmodel(torch.from_numpy(x))
    # f32 convolutions on the CPU by two libraries, summed in other
    # orders through 18-50 layers: 1e-4
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(ref_eval), rtol=1e-4, atol=1e-4)

    ref_train, updates = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"])
    )(variables, x)
    tmodel.train()
    with torch.no_grad():
        got_train = tmodel(torch.from_numpy(x))
    # Train mode normalises by batch statistics, 16 values a channel in
    # the last stage, which amplifies f32 rounding: the two sides differ
    # by 2e-4 of the logit scale (measured; at 4 images, where each
    # sits ~2e-3 from a float64 evaluation, 6e-4). Hence 1e-3 of it.
    scale = np.abs(np.asarray(ref_train)).max()
    np.testing.assert_allclose(
        got_train.numpy(), np.asarray(ref_train), rtol=0, atol=1e-3 * scale
    )
    # the running statistics moved as flax moves them: 0.9 / 0.1 with the
    # biased batch variance (torch's own BatchNorm2d would use the unbiased)
    expected = state_dict_from_flax(
        {"params": variables["params"], "batch_stats": jax.device_get(updates["batch_stats"])},
        tmodel,
    )
    got = _stats_state_dict(tmodel)
    assert got
    # flax takes the variance as E[x^2] - E[x]^2, torch by Welford's
    # method, over activations that already carry f32 rounding from the
    # layers above: 1e-4
    for key, value in got.items():
        np.testing.assert_allclose(value, expected[key].numpy(), rtol=1e-4, atol=1e-4, err_msg=key)


def test_bf16_forward_matches_flax():
    jmodel, variables, tmodel = _pair("resnet18", torch.bfloat16, seed=3)
    x = _images(2)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the classifier runs in f32
    # bf16 activations (8 mantissa bits) rounded at other points by XLA
    # and by torch through 18 layers: a few bf16 ulps of the logit scale
    # (measured: 1e-2 of it)
    scale = np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=3e-2 * scale)


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding_matches_flax(size):
    """flax SAME on an even size pads (0, 1); torch's padding=1 would pad
    (1, 1). An odd size pads (1, 1) in both."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    conv = fnn.Conv(4, (3, 3), (2, 2), padding="SAME", use_bias=False)
    ref = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))
    port = resnet.Conv(3, 4, (3, 3), (2, 2), dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        symmetric = F.conv2d(xt, port.weight, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if size % 2 == 0:
        assert np.abs(symmetric - ref).max() > 0.1
    else:
        np.testing.assert_allclose(symmetric, ref, rtol=1e-5, atol=1e-5)


def test_s2d_stem_is_the_plain_7x7_conv():
    """The reference's space-to-depth stem (s2d_stem=True, its default)
    computes the same function as the plain 7x7/2 pad-3 conv the port runs."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    kernel = (rng.normal(size=(7, 7, 3, 8)) / np.sqrt(147)).astype(np.float32)
    stem = jax_resnet.StemConvS2D(8, dtype=jnp.float32)
    ref = np.asarray(stem.apply({"params": {"kernel": kernel}}, x))
    port = resnet.Conv(3, 8, (7, 7), (2, 2), padding=((3, 3), (3, 3)), dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_remat_blocks_same_step_and_stats_move_once():
    """torch.utils.checkpoint recomputes each block in the backward; the
    gradients are the plain model's and the running statistics move once."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_images(6))
    labels = torch.from_numpy(rng.integers(0, 10, size=4))
    results = []
    for remat in (False, True):
        model = resnet.ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                                remat_blocks=remat, generator=torch.Generator().manual_seed(7))
        model.train()
        F.cross_entropy(model(x), labels).backward()
        results.append(
            ({n: p.grad.clone() for n, p in model.named_parameters()},
             {k: v.clone() for k, v in model.state_dict().items() if "running_" in k})
        )
    (grads, stats), (remat_grads, remat_stats) = results
    for name in grads:
        torch.testing.assert_close(remat_grads[name], grads[name], rtol=1e-5, atol=1e-6)
    for key in stats:
        torch.testing.assert_close(remat_stats[key], stats[key], rtol=0, atol=0)


def test_every_resnet_lever_builds_and_runs_with_33_fused_convs():
    """Every lever of the reference's ResNet is accepted and none raises:
    the same-function ones run the plain convolution, and `fused_1x1_bwd`
    and `fast_pool_bwd` build and run a train-mode forward and backward on
    the CPU, ResNet-50 with 33 fused 1x1 convolutions."""
    for flags in ({"matmul_1x1": True}, {"s2d_stem": False}):
        resnet.ResNet18(num_classes=10, num_filters=8, **flags)
    x = torch.from_numpy(_images(9, n=2))
    for flags in ({"fused_1x1_bwd": True}, {"fast_pool_bwd": True},
                  {"fused_1x1_bwd": True, "fast_pool_bwd": True}):
        model = resnet.ResNet50(num_classes=10, num_filters=8, **flags)
        model.train()
        model(x).float().sum().backward()
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    fused = [m for m in model.modules() if isinstance(m, resnet.FusedBwdConv1x1)]
    assert len(fused) == 33  # Conv_0 and Conv_2 of 16 blocks, stage 0's shortcut
