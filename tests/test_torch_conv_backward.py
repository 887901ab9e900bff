"""The port's `conv1x1` (K4's function) and the ResNet with
`fused_1x1_bwd` against the JAX package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode
(`conv1x1(..., interpret=True)`; the reference's `FusedBwdConv1x1` picks
interpret itself off the TPU). The port's CPU tensors take K4's plain
version. Inputs come from numpy seeds and go to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import random_flax_variables

from tritonk8ssupervisor_tpu.models import resnet as jax_resnet
from tritonk8ssupervisor_tpu.ops import conv_backward as jax_cb
from tritonk8ssupervisor_tpu.ops.cross_entropy import (
    cross_entropy_loss_and_correct_interpret,
)
from tritonk8ssupervisor_tpu.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu.parallel import train as jax_train
from tritonk8ssupervisor_tpu_torch.models import resnet
from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb
from tritonk8ssupervisor_tpu_torch.ops import conv_backward_cuda
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import cross_entropy_loss_and_correct
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax


def _bf16_ulp(x):
    """One bf16 unit in the last place at each |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _nchw(a, dtype=torch.float32):
    """numpy NHWC -> the port's NCHW view of channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _weight(kernel):
    """flax (1, 1, C, N) -> the port's (N, C, 1, 1) f32, channels_last."""
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    return w.contiguous(memory_format=torch.channels_last).requires_grad_(True)


# (batch, height, width, C, N): M = 128 runs the reference's Pallas kernel
# (interpret); M = 10 and 6 are ragged, where the reference falls back to
# XLA dots
SHAPES = [(2, 8, 8, 24, 32), (1, 2, 5, 16, 8), (3, 1, 2, 32, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_forward_and_gradients_match_jax(shape):
    b, h, w, c, n = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    kernel = rng.normal(size=(1, 1, c, n)).astype(np.float32)

    def loss(x, k):
        return jnp.sum(jnp.sin(jax_cb.conv1x1(x, k, jnp.float32, True)))

    ref_y = jax_cb.conv1x1(x, kernel, jnp.float32, True)
    ref_dx, ref_dk = jax.grad(loss, argnums=(0, 1))(x, kernel)

    xt = _nchw(x).requires_grad_(True)
    wt = _weight(kernel)
    y = cb.conv1x1(xt, wt, torch.float32)
    torch.sin(y).sum().backward()
    # f32 on both sides, summed in other orders (tests/test_ops.py:119-145)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref_y), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(ref_dx), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(ref_dk),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_compute_with_f32_params_matches_jax(shape):
    """The model's configuration: bf16 activations and compute, f32
    weight. dX comes back bf16 within one bf16 ulp of the reference, dW
    f32 within 1e-5 relative (the same f32 sums of the same bf16
    products, in another order)."""
    b, h, w, c, n = shape
    rng = np.random.default_rng(10 + sum(shape))
    x = jnp.asarray(rng.normal(size=(b, h, w, c)), jnp.bfloat16)
    kernel = rng.normal(size=(1, 1, c, n)).astype(np.float32)
    dy = jnp.asarray(rng.normal(size=(b, h, w, n)), jnp.bfloat16)

    ref_y, vjp = jax.vjp(lambda x, k: jax_cb.conv1x1(x, k, jnp.bfloat16, True), x, kernel)
    ref_dx, ref_dk = vjp(dy)

    xt = _nchw(np.asarray(x, np.float32), torch.bfloat16).requires_grad_(True)
    wt = _weight(kernel)
    y = cb.conv1x1(xt, wt, torch.bfloat16)
    y.backward(_nchw(np.asarray(dy, np.float32), torch.bfloat16))
    assert y.dtype == xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32

    ref_y, ref_dx = np.asarray(ref_y, np.float32), np.asarray(ref_dx, np.float32)
    assert np.all(np.abs(_nhwc(y) - ref_y) <= _bf16_ulp(ref_y))
    assert np.all(np.abs(_nhwc(xt.grad) - ref_dx) <= _bf16_ulp(ref_dx))
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(ref_dk),
                               rtol=1e-5, atol=1e-5 * np.abs(ref_dk).max())


@pytest.mark.parametrize("m", [128, 10, 48])
def test_plain_version_matches_the_reference_kernel(m):
    """`conv1x1_backward_plain` against `_fused_backward_2d` (the function
    that calls the Pallas kernel, interpreted, or its XLA-dot fallback)
    on the same bf16 rows: the port's W is the reference's transposed."""
    c, n = 24, 16
    rng = np.random.default_rng(m)
    x2, dy2, w2 = (jnp.asarray(rng.normal(size=s), jnp.bfloat16)
                   for s in ((m, c), (m, n), (c, n)))
    ref_dx, ref_dw = jax_cb._fused_backward_2d(x2, dy2, w2, True)
    to_torch = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    dx, dw = cb.conv1x1_backward_plain(to_torch(x2), to_torch(dy2), to_torch(w2).t(),
                                       torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32 and dw.shape == (n, c)
    ref_dx = np.asarray(ref_dx, np.float32)
    assert np.all(np.abs(dx.float().numpy() - ref_dx) <= _bf16_ulp(ref_dx))
    np.testing.assert_allclose(dw.numpy().T, np.asarray(ref_dw), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref_dw)).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_plain_version_takes_an_empty_batch_as_the_reference_does(dtype):
    """M = 0 rows: the reference returns an empty dX in the compute dtype
    and a zero f32 dW, and so does the port's plain version."""
    c, n = 24, 16
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_dx, ref_dw = jax_cb._fused_backward_2d(jnp.zeros((0, c), jdt), jnp.zeros((0, n), jdt),
                                               jnp.zeros((c, n), jdt), True)
    dx, dw = cb.conv1x1_backward_plain(torch.zeros(0, c, dtype=tdt), torch.zeros(0, n, dtype=tdt),
                                       torch.zeros(n, c, dtype=tdt), tdt)
    assert dx.shape == ref_dx.shape == (0, c) and dx.dtype == tdt
    assert dw.shape == (n, c) and dw.dtype == torch.float32
    np.testing.assert_array_equal(dw.numpy().T, np.asarray(ref_dw))


def test_rows_are_read_in_place_or_copied_and_counted():
    """X and dY are viewed as rows without a copy when their memory is
    channels_last-dense; an NCHW-contiguous tensor is copied, once, and
    the copy is counted. dX comes back channels_last-dense either way."""
    rng = np.random.default_rng(3)
    x = _nchw(rng.normal(size=(2, 4, 4, 8)).astype(np.float32))
    w = _weight(rng.normal(size=(1, 1, 8, 16)).astype(np.float32))
    dy = _nchw(rng.normal(size=(2, 4, 4, 16)).astype(np.float32))
    before = cb.conv1x1_backward.copies
    dx, dw = cb.conv1x1_backward(x, w, dy, torch.float32)
    assert cb.conv1x1_backward.copies == before
    assert dx.is_contiguous(memory_format=torch.channels_last) and dw.shape == (16, 8, 1, 1)
    dx2, dw2 = cb.conv1x1_backward(x, w, dy.contiguous(), torch.float32)
    assert cb.conv1x1_backward.copies == before + 1
    torch.testing.assert_close(dx2, dx, rtol=0, atol=0)
    torch.testing.assert_close(dw2, dw, rtol=0, atol=0)
    assert cb.conv1x1_backward_kernel.launches == 0  # CPU tensors: the plain version


def test_kernel_inputs_that_k4_does_not_take_raise():
    """K4's wrapper checks dtype, shapes, widths and layout, then the
    device, before any launch: CPU tensors are refused, never launched.
    f32 and widths that are not multiples of 8 are K4's too (its FMA
    instance): float64 is refused in their place, at width 12 as at 24."""
    bf16 = torch.bfloat16
    x2 = torch.zeros(16, 24, dtype=bf16)
    dy2 = torch.zeros(16, 8, dtype=bf16)
    w2 = torch.zeros(8, 24, dtype=bf16)
    f64 = torch.float64
    bad = [
        (TypeError, "float32, bf16 or fp16", (x2.to(f64), dy2.to(f64), w2.to(f64))),
        (TypeError, "one dtype", (x2, dy2.half(), w2)),
        (ValueError, "W \\(N, C\\)", (x2, dy2, w2.t().contiguous())),
        (TypeError, "float32, bf16 or fp16", (x2[:, :12].to(f64), dy2.to(f64),
                                              w2[:, :12].to(f64))),
        (ValueError, "contiguous", (torch.zeros(24, 16, dtype=bf16).t(), dy2, w2)),
        (ValueError, "aligned", (torch.zeros(16 * 24 + 1, dtype=bf16)[1:].view(16, 24),
                                 dy2, w2)),
        (ValueError, "CUDA", (x2, dy2, w2)),
    ]
    for error, message, args in bad:
        with pytest.raises(error, match=message):
            cb.conv1x1_backward_kernel(*args)
    x, w, dy = torch.zeros(1, 12, 2, 2), torch.zeros(8, 12, 1, 1), torch.zeros(1, 8, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv1x1_backward(x, w.to("meta"), dy, torch.bfloat16)
    assert cb.conv1x1_backward_kernel.launches == 0


def test_k4_wrapper_takes_more_rows_than_the_old_grid_cap(monkeypatch):
    """More than 65535 x 128 = 8,388,480 rows (the cap of K4's first,
    non-persistent dgrad grid): the wrapper hands them to the launcher,
    as the reference computes any batch. Meta tensors stand in for the
    card's (no memory); the launcher is recorded, not run."""
    m, c, n = 65535 * 128 + 128 * 3 + 5, 64, 64
    launched = []
    monkeypatch.setattr(cb, "_on_one_cuda_device", lambda *tensors: True)
    monkeypatch.setattr(conv_backward_cuda, "backward",
                        lambda x2, dy2, w2, dx2, dw: launched.append(
                            (tuple(x2.shape), tuple(dy2.shape), tuple(dx2.shape), dw.dtype)))
    monkeypatch.setattr(cb.conv1x1_backward_kernel, "launches", 0)
    x2, dy2 = (torch.empty(m, width, dtype=torch.bfloat16, device="meta") for width in (c, n))
    w2 = torch.empty(n, c, dtype=torch.bfloat16, device="meta")
    dx2, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    assert launched == [((m, c), (m, n), (m, c), torch.float32)]
    assert dx2.shape == (m, c) and dw.shape == (n, c)
    assert cb.conv1x1_backward_kernel.launches == 1
    assert not hasattr(conv_backward_cuda, "MAX_ROWS")


@pytest.mark.parametrize("c,n", [(8, 8), (64, 256), (2048, 512)])
def test_k4_split_plan_of_an_empty_batch(c, n):
    """M = 0 is one split of no rows, not a division by zero; K4's wrapper
    then launches nothing."""
    assert conv_backward_cuda.split(0, c, n) == (1, 0)


# ResNet-50's stride-1 1x1 convolutions at batch 256 as K4's (M, C, N)
# (chip_smoke.K4_SHAPES)
RESNET50_K4_SHAPES = [
    (256 * size * size, c, n) for size, c, n in (
        (56, 64, 64), (56, 64, 256), (56, 256, 64), (56, 256, 128),
        (28, 128, 512), (28, 512, 128), (28, 512, 256),
        (14, 256, 1024), (14, 1024, 256), (14, 1024, 512),
        (7, 512, 2048), (7, 2048, 512))
]


@pytest.mark.parametrize("m,c,n", RESNET50_K4_SHAPES + [(1, 8, 8), (129, 136, 72)])
def test_k4_split_plan(m, c, n):
    """dW's split of M is a fixed function of the shape, covers M in whole
    64-row steps with no empty split, fills at most one wave of the
    H100's 132 SMs, and keeps the f32 workspace under 13 MB (the cap of
    the kernel's first design)."""
    splits, rows = conv_backward_cuda.split(m, c, n)
    assert conv_backward_cuda.split(m, c, n) == (splits, rows)
    assert rows % 64 == 0 and (splits - 1) * rows < m <= splits * rows
    tiles = -(-c // 128) * -(-n // 128)
    assert splits * tiles <= max(132, tiles)
    workspace = splits * n * c * 4 if splits > 1 else 0
    assert workspace <= 13 * 2**20


# ----------------------------------------------------------- the model


def _bottleneck_pair(stage_sizes, seed, image=32, **flags):
    cfg = dict(stage_sizes=stage_sizes, num_classes=10, num_filters=8)
    jmodel = jax_resnet.ResNet(block_cls=jax_resnet.BottleneckBlock, dtype=jnp.float32,
                               **cfg, **flags)
    variables = random_flax_variables(jmodel, seed, image)
    tmodel = resnet.ResNet(block_cls=resnet.BottleneckBlock, dtype=torch.float32, **cfg, **flags)
    tmodel.load_state_dict(state_dict_from_flax(variables, tmodel))
    return jmodel, variables, tmodel


def _grads_of_loss(jmodel, variables, tmodel, x, labels):
    """(logits, gradients by port name) of the mean cross-entropy in train
    mode, on both sides."""
    def loss(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, train=True, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(labels, 10)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1)), logits

    (_, ref_logits), ref_grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    # the statistics fill the state dict's other entries
    expected = state_dict_from_flax(
        {"params": jax.device_get(ref_grads), "batch_stats": variables["batch_stats"]}, tmodel)
    tmodel.train()
    logits = tmodel(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    return np.asarray(ref_logits), expected, logits.detach().numpy()


@pytest.mark.parametrize("stage_sizes,image", [((1,), 16), ((1, 1), 32)])
def test_fused_bottleneck_resnet_logits_and_gradients_match_jax(stage_sizes, image):
    jmodel, variables, tmodel = _bottleneck_pair(stage_sizes, seed=len(stage_sizes),
                                                 image=image, fused_1x1_bwd=True)
    fused = [n for n, m in tmodel.named_modules() if isinstance(m, resnet.FusedBwdConv1x1)]
    # Conv_0 and Conv_2 of each block and stage 0's stride-1 shortcut; a
    # stride-2 shortcut stays the plain Conv
    assert len(fused) == 2 * len(stage_sizes) + 1
    if len(stage_sizes) > 1:
        assert type(getattr(tmodel, tmodel.block_names[-1]).shortcut) is resnet.Conv
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, image, image, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    ref_logits, expected, logits = _grads_of_loss(jmodel, variables, tmodel, x, labels)
    # f32 through a few layers with train-mode BatchNorm over a small
    # batch, summed in other orders (tests/test_torch_resnet.py): 1e-3 of
    # the logit scale, and of each gradient's largest entry
    np.testing.assert_allclose(logits, ref_logits, rtol=0,
                               atol=1e-3 * np.abs(ref_logits).max())
    for name, p in tmodel.named_parameters():
        want = expected[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-3 * max(np.abs(want).max(), 1e-6), err_msg=name)


def test_fused_train_step_matches_jax_make_train_step():
    """One SGD step of the fused bottleneck ResNet through each package's
    `make_train_step`: parameters and moved BatchNorm statistics."""
    jmodel, variables, tmodel = _bottleneck_pair((1, 1), seed=5, fused_1x1_bwd=True)
    rng = np.random.default_rng(6)
    images = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)

    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    tx = jax_train.default_optimizer(learning_rate=0.1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params),
    )
    jstep = jax_train.make_train_step(jmodel, tx, mesh, mesh_lib.param_shardings(jstate, mesh),
                                      metrics_fn=cross_entropy_loss_and_correct_interpret)
    jstate, jmetrics = jstep(jstate, images, labels)

    state = train.create_train_state(tmodel, train.default_optimizer(0.1), device="cpu")
    metrics = train.make_train_step(state, metrics_fn=cross_entropy_loss_and_correct)(
        torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-4, atol=1e-4)
    expected = state_dict_from_flax(
        jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}), tmodel)
    # f32 gradients through a few layers at lr 0.1, and statistics that
    # flax takes as E[x^2] - E[x]^2: as tests/test_torch_train.py
    for key, value in tmodel.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(), rtol=1e-4, atol=5e-5,
                                   err_msg=key)


def test_levers_keep_the_state_dict_and_remat_keeps_the_gradients():
    """`fused_1x1_bwd` and `fast_pool_bwd` change neither the parameters'
    names, shapes and dtypes nor (from one generator seed) their values;
    with both levers on, `remat_blocks` gives the same gradients and
    moves the statistics once."""
    def build(**flags):
        return resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BottleneckBlock,
                             num_classes=10, num_filters=8, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(3), **flags)

    plain = build().state_dict()
    for flags in ({"fused_1x1_bwd": True}, {"fast_pool_bwd": True},
                  {"fused_1x1_bwd": True, "fast_pool_bwd": True}):
        other = build(**flags).state_dict()
        assert list(other) == list(plain)
        for key, value in other.items():
            assert value.shape == plain[key].shape and value.dtype == plain[key].dtype, key
            torch.testing.assert_close(value, plain[key], rtol=0, atol=0)

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, size=4))
    results = []
    for remat in (False, True):
        model = build(fused_1x1_bwd=True, fast_pool_bwd=True, remat_blocks=remat)
        model.train()
        torch.nn.functional.cross_entropy(model(x), labels).backward()
        results.append(({n: p.grad.clone() for n, p in model.named_parameters()},
                        {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}))
    (grads, stats), (remat_grads, remat_stats) = results
    for name in grads:
        torch.testing.assert_close(remat_grads[name], grads[name], rtol=1e-5, atol=1e-6)
    for key in stats:
        torch.testing.assert_close(remat_stats[key], stats[key], rtol=0, atol=0)

