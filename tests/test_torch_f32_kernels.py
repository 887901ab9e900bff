"""K2 and K4 at every dtype and width the reference takes, on the CPU.

K2's 3xTF32 instance (`csrc/flash_attention_tf32.cu`) and K4's TF32
instance (`csrc/conv_backward_tf32.cu`) run only on the card
(tests/test_torch_kernels.py holds them to their bound there). Here,
without a card:

- the route: the instance an input runs on is a function of its dtype
  and head_dim (K2) or widths (K4) alone, and a failed build raises
  instead of picking another instance;
- the wrappers hand f32 inputs to K2's 3xTF32 launchers, and K4's f32
  and narrow widths to its TF32 launcher (recorded, not run), without
  copies;
- K4's plain version in f32 and at widths 3, 13, 100 and 36 against the
  reference's `_fused_backward_2d` (its Pallas kernel interpreted, or its
  XLA-dot fallback) and `conv1x1(compute_dtype=float32, interpret=True)`;
- one SGD step of a small f32 bottleneck ResNet with `fused_1x1_bwd`, at
  widths that are not multiples of 8, against the JAX one;
- the f32 bound the card tests use: the plain f32 versions meet it
  against a float64 evaluation, products of TF32's 10-bit inputs miss it
  (by more than 10x for K4);
- the f32 cost and bound helpers and the roofline's f32 FLOPs, at the
  rate of f32-accurate products (3xTF32, a third of dense TF32).

Inputs are drawn with numpy from a seed and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conv_backward import _bf16_ulp, _nchw, _nhwc, _weight
from test_torch_resnet import random_flax_variables
from test_torch_roofline import F32, torch_trace

from tritonk8ssupervisor_tpu.models import resnet as jax_resnet
from tritonk8ssupervisor_tpu.ops import conv_backward as jax_cb
from tritonk8ssupervisor_tpu.ops.cross_entropy import cross_entropy_loss_and_correct_interpret
from tritonk8ssupervisor_tpu.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu.parallel import train as jax_train
from tritonk8ssupervisor_tpu_torch.models import resnet
from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb
from tritonk8ssupervisor_tpu_torch.ops import conv_backward_cuda
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops import flash_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import cross_entropy_loss_and_correct
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.utils import roofline
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

H100 = "NVIDIA H100 80GB HBM3"

# ----------------------------------------------------------------- the route

K2_ROUTES = [
    (torch.float32, 1, "tf32x3-64"), (torch.float32, 40, "tf32x3-64"),
    (torch.float32, 64, "tf32x3-64"), (torch.float32, 96, "tf32x3-128"),
    (torch.float32, 256, "tf32x3-256"),
    (torch.bfloat16, 1, "wgmma-64"), (torch.bfloat16, 64, "wgmma-64"),
    (torch.bfloat16, 65, "wgmma-128"), (torch.bfloat16, 128, "wgmma-128"),
    (torch.bfloat16, 129, "wgmma-256"), (torch.bfloat16, 256, "wgmma-256"),
    (torch.float16, 36, "wgmma-64"), (torch.float16, 96, "wgmma-128"),
    (torch.float16, 200, "wgmma-256"),
]


@pytest.mark.parametrize("dtype,head_dim,route", K2_ROUTES,
                         ids=lambda v: str(v).removeprefix("torch."))
def test_k2_route_is_a_function_of_dtype_and_head_dim(dtype, head_dim, route):
    assert flash_attention_cuda.instance(dtype, head_dim) == route


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.int64, torch.uint8])
def test_k2_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32, bf16 or fp16"):
        flash_attention_cuda.instance(dtype, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_route_refuses_a_head_dim_past_256(dtype):
    """Above 256 f32 raises as bf16 does: the limit stays the kernels'."""
    for head_dim in (0, 257, 512):
        with pytest.raises(ValueError, match="head_dim from 1 to 256"):
            flash_attention_cuda.instance(dtype, head_dim)


K4_ROUTES = [
    (torch.float32, 64, 64, "tf32x3"), (torch.float32, 3, 13, "tf32x3"),
    (torch.float32, 2048, 512, "tf32x3"),
    (torch.bfloat16, 64, 256, "wgmma-64"), (torch.bfloat16, 128, 512, "wgmma-128"),
    (torch.bfloat16, 2048, 512, "wgmma-256"), (torch.float16, 200, 72, "wgmma-256"),
    (torch.bfloat16, 3, 13, "tf32x1"), (torch.bfloat16, 100, 36, "tf32x1"),
    (torch.bfloat16, 12, 8, "tf32x1"), (torch.float16, 8, 12, "tf32x1"),
    (torch.float16, 1, 1, "tf32x1"),
]


@pytest.mark.parametrize("dtype,c,n,route", K4_ROUTES,
                         ids=lambda v: str(v).removeprefix("torch."))
def test_k4_route_is_a_function_of_dtype_and_widths(dtype, c, n, route):
    """Every input the wgmma instances took keeps its route; f32 goes to
    the TF32 instance's 3xTF32 route and the bf16/fp16 widths TMA cannot
    address to its one-product route."""
    assert conv_backward_cuda.instance(dtype, c, n) == route


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.int8])
def test_k4_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32, bf16 or fp16"):
        conv_backward_cuda.instance(dtype, 64, 64)


def _unbuilt(name):
    def fail():
        raise RuntimeError(f"nvcc failed building {name}")
    return fail


def test_a_failed_build_raises_and_never_switches_the_instance(monkeypatch):
    """The f32 inputs' 3xTF32 libraries (K2's and K4's) fail to build:
    both wrappers raise the build's error, and neither reaches for the
    bf16/fp16 library."""
    monkeypatch.setattr(flash_attention_cuda, "_tf32_lib", _unbuilt("flash_attention_tf32.cu"))
    monkeypatch.setattr(flash_attention_cuda, "_lib", _unbuilt("the wgmma library"))
    monkeypatch.setattr(conv_backward_cuda, "_tf32_lib", _unbuilt("conv_backward_tf32.cu"))
    monkeypatch.setattr(conv_backward_cuda, "_lib", _unbuilt("the wgmma library"))
    monkeypatch.setattr(cb, "_on_one_cuda_device", lambda *tensors: True)
    q = torch.empty(2, 16, 3, 40, device="meta")
    with pytest.raises(RuntimeError, match="flash_attention_tf32.cu"):
        fa.flash_attention_forward(q, q, q, True, "bshd")
    with pytest.raises(RuntimeError, match="conv_backward_tf32.cu"):
        cb.conv1x1_backward_kernel(torch.empty(32, 24, device="meta"),
                                   torch.empty(32, 16, device="meta"),
                                   torch.empty(16, 24, device="meta"))
    half = {"device": "meta", "dtype": torch.float16}
    with pytest.raises(RuntimeError, match="conv_backward_tf32.cu"):
        cb.conv1x1_backward_kernel(torch.empty(32, 12, **half), torch.empty(32, 8, **half),
                                   torch.empty(8, 12, **half))


# ---------------------------------------------------------- the wrappers


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("d", [8, 36, 64, 100, 256])
def test_k2_wrappers_hand_f32_views_to_the_fma_launchers_without_a_copy(monkeypatch, layout, d):
    """f32 q, k, v as strided views of one projection (and any head_dim,
    not padded) reach the 3xTF32 launchers as they are: no copy, outputs
    of q's shape, one launch counted each way, on that instance."""
    calls = []
    monkeypatch.setattr(flash_attention_cuda, "forward",
                        lambda q, k, v, out, lse, causal, lay, scale: calls.append(
                            ("fwd", q, k, v, out.shape, lse.shape, scale)))
    monkeypatch.setattr(flash_attention_cuda, "backward",
                        lambda dout, q, k, v, out, lse, rows, dq, dk, dv, causal, lay, scale:
                        calls.append(("bwd", dout, q, dq.shape, rows.numel())))
    for counter in (fa.flash_attention_forward, fa.flash_attention_backward):
        monkeypatch.setattr(counter, "launches", 0)
        monkeypatch.setattr(counter, "tf32_launches", 0)
    monkeypatch.setattr(fa.flash_attention_forward, "copies", 0)
    b, s, h = 2, 24, 3
    qkv = torch.empty(b, s, 3 * h * d + 1, device="meta")[..., 1:]  # an odd start and stride
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    if layout == "bhsd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = fa.flash_attention_forward(q, k, v, True, layout)
    grads = fa.flash_attention_backward(out, q, k, v, out, lse, True, layout)
    assert fa.flash_attention_forward.copies == 0
    assert (fa.flash_attention_forward.launches, fa.flash_attention_backward.launches) == (1, 1)
    assert fa.flash_attention_forward.tf32_launches == fa.flash_attention_backward.tf32_launches == 1
    (_, fq, fk, fv, out_shape, lse_shape, scale), (_, dout, bq, dq_shape, rows) = calls
    assert fq is q and fk is k and fv is v and bq is q and dout is out
    assert out_shape == q.shape and lse_shape == (b, h, s) and scale == d ** -0.5
    assert all(g.shape == q.shape for g in grads) and dq_shape == q.shape
    assert rows >= b * h * s


@pytest.mark.parametrize("dtype,c,n,misaligned", [
    (torch.float32, 64, 256, False), (torch.float32, 3, 13, True),
    (torch.bfloat16, 3, 13, False), (torch.float16, 100, 36, True),
    (torch.bfloat16, 12, 24, True),
])
def test_k4_wrapper_hands_f32_and_narrow_widths_to_the_tf32_launcher(monkeypatch, dtype, c, n,
                                                                      misaligned):
    """Rows at any start (a 2-byte offset here) and any width pass the
    wrapper's checks when they route to the TF32 instance; the launcher is
    recorded, not run, and dW comes back f32."""
    launched = []
    monkeypatch.setattr(cb, "_on_one_cuda_device", lambda *tensors: True)
    monkeypatch.setattr(conv_backward_cuda, "backward",
                        lambda x2, dy2, w2, dx2, dw: launched.append(
                            (conv_backward_cuda.instance(x2.dtype, c, n), dx2.dtype, dw.dtype)))
    monkeypatch.setattr(cb.conv1x1_backward_kernel, "launches", 0)
    monkeypatch.setattr(cb.conv1x1_backward_kernel, "tf32_launches", 0)
    m = 50
    x2 = torch.zeros(m * c + 1, dtype=dtype)[1:].view(m, c) if misaligned else torch.zeros(
        m, c, dtype=dtype)
    dy2, w2 = torch.zeros(m, n, dtype=dtype), torch.zeros(n, c, dtype=dtype)
    dx2, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    route = "tf32x3" if dtype == torch.float32 else "tf32x1"
    assert launched == [(route, dtype, torch.float32)]
    assert dx2.shape == (m, c) and dw.shape == (n, c)
    assert cb.conv1x1_backward_kernel.launches == cb.conv1x1_backward_kernel.tf32_launches == 1


def test_k4_wgmma_route_still_needs_aligned_rows(monkeypatch):
    monkeypatch.setattr(cb, "_on_one_cuda_device", lambda *tensors: True)
    x2 = torch.zeros(16 * 24 + 1, dtype=torch.bfloat16)[1:].view(16, 24)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cb.conv1x1_backward_kernel(x2, torch.zeros(16, 8, dtype=torch.bfloat16),
                                   torch.zeros(8, 24, dtype=torch.bfloat16))


@pytest.mark.parametrize("m,c,n", [(1, 3, 13), (10, 100, 36), (802816, 64, 64),
                                   (12544, 2048, 512), (50176, 3, 13)])
def test_k4_tf32_split_plan(m, c, n):
    """The TF32 dW's split of M: a fixed function of the shape, whole
    32-row stages, no empty split, at most one CTA an SM in one wave."""
    splits, rows = conv_backward_cuda.tf32_split(m, c, n)
    assert conv_backward_cuda.tf32_split(m, c, n) == (splits, rows)
    assert rows % 32 == 0 and (splits - 1) * rows < m <= splits * rows
    tiles = -(-max(c, n) // 128) * -(-min(c, n) // conv_backward_cuda.tf32_tile(min(c, n)))
    assert splits * tiles <= max(132, tiles)
    assert conv_backward_cuda.tf32_split(0, c, n) == (1, 0)


# ----------------------------------------- K4's plain version vs the reference

# (M, C, N): M = 128 runs the reference's Pallas kernel (interpreted); M = 10
# takes its XLA-dot fallback
WIDTHS = [(128, 3, 13), (128, 100, 36), (10, 13, 3), (10, 36, 100)]


@pytest.mark.parametrize("m,c,n", WIDTHS, ids=lambda v: str(v))
def test_plain_version_in_f32_matches_the_reference_at_any_width(m, c, n):
    """f32 compute on both sides: the same f32 sums in other orders, to
    1e-5 of each output's largest magnitude."""
    rng = np.random.default_rng(m + c + n)
    x2, dy2, w2 = (rng.normal(size=s).astype(np.float32) for s in ((m, c), (m, n), (c, n)))
    ref_dx, ref_dw = jax_cb._fused_backward_2d(jnp.asarray(x2), jnp.asarray(dy2),
                                               jnp.asarray(w2), True)
    dx, dw = cb.conv1x1_backward_plain(torch.from_numpy(x2), torch.from_numpy(dy2),
                                       torch.from_numpy(w2).t(), torch.float32)
    assert dx.dtype == dw.dtype == torch.float32 and dw.shape == (n, c)
    ref_dx, ref_dw = np.asarray(ref_dx), np.asarray(ref_dw)
    np.testing.assert_allclose(dx.numpy(), ref_dx, rtol=0, atol=1e-5 * np.abs(ref_dx).max())
    np.testing.assert_allclose(dw.numpy().T, ref_dw, rtol=0, atol=1e-5 * np.abs(ref_dw).max())


@pytest.mark.parametrize("m,c,n", WIDTHS, ids=lambda v: str(v))
def test_plain_version_in_bf16_matches_the_reference_at_any_width(m, c, n):
    """bf16 rows at widths that are not multiples of 8 (the TF32 instance's
    bf16 inputs): dX within one bf16 ulp, dW to 1e-5 of its largest."""
    rng = np.random.default_rng(7 + m + c + n)
    x2, dy2, w2 = (jnp.asarray(rng.normal(size=s), jnp.bfloat16)
                   for s in ((m, c), (m, n), (c, n)))
    ref_dx, ref_dw = jax_cb._fused_backward_2d(x2, dy2, w2, True)
    to_torch = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    dx, dw = cb.conv1x1_backward_plain(to_torch(x2), to_torch(dy2), to_torch(w2).t(),
                                       torch.bfloat16)
    ref_dx = np.asarray(ref_dx, np.float32)
    assert np.all(np.abs(dx.float().numpy() - ref_dx) <= _bf16_ulp(ref_dx))
    np.testing.assert_allclose(dw.numpy().T, np.asarray(ref_dw), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref_dw)).max())


@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 13), (1, 4, 5, 100, 36), (3, 2, 2, 13, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv1x1_in_f32_matches_the_reference_s_at_any_width(shape):
    """`conv1x1(compute_dtype=float32)` forward and gradients against the
    reference's with `interpret=True`: f32 on both sides, 2e-5
    (tests/test_ops.py:119-145)."""
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
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref_y), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(ref_dx), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(ref_dk),
                               rtol=2e-5, atol=2e-5)


def test_f32_fused_resnet_step_at_narrow_widths_matches_jax():
    """One SGD step of `ResNet(dtype=float32, fused_1x1_bwd=True)` with 3
    filters (1x1 convolutions of widths 3 and 12, the TF32 instance's on
    the card) through each package's `make_train_step`: the loss to 1e-4
    and every parameter and statistic to rtol 1e-4, atol 5e-5, as
    tests/test_torch_conv_backward.py holds the 8-filter model."""
    cfg = dict(stage_sizes=(1, 1), num_classes=10, num_filters=3)
    jmodel = jax_resnet.ResNet(block_cls=jax_resnet.BottleneckBlock, dtype=jnp.float32,
                               fused_1x1_bwd=True, **cfg)
    variables = random_flax_variables(jmodel, 11, 32)
    tmodel = resnet.ResNet(block_cls=resnet.BottleneckBlock, dtype=torch.float32,
                           fused_1x1_bwd=True, **cfg)
    tmodel.load_state_dict(state_dict_from_flax(variables, tmodel))
    fused = [m for m in tmodel.modules() if isinstance(m, resnet.FusedBwdConv1x1)]
    assert fused and any(m.weight.shape[0] % 8 or m.weight.shape[1] % 8 for m in fused)
    rng = np.random.default_rng(12)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=8).astype(np.int32)

    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    tx = jax_train.default_optimizer(learning_rate=0.1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params))
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
    for key, value in tmodel.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(), rtol=1e-4, atol=5e-5,
                                   err_msg=key)


# ------------------------------------------------------------ the f32 bound


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with TF32's 10 explicit mantissa bits (the rest cut)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _k4_bound_ratio(dx, dw, x2, dy2, w2):
    """max over dX and dW of |got - f64| over the f32 FMA sum's bound,
    1.01 K 2^-24 (|A||B|)_64 + 1e-30 with K = N for dX and M for dW."""
    ref_dx, ref_dw, mag_dx, mag_dw = cb.conv1x1_backward_f64(x2, dy2, w2)
    m, n = dy2.shape
    return max(((got.double() - ref).abs() / (1.01 * k * 2.0**-24 * mag + 1e-30)).max().item()
               for got, ref, mag, k in ((dx, ref_dx, mag_dx, n), (dw, ref_dw, mag_dw, m)))


@pytest.mark.parametrize("m,c,n", [(300, 3, 13), (2000, 100, 36), (4096, 64, 256)])
def test_k4_bound_holds_for_f32_products_and_not_for_tf32(m, c, n):
    rng = np.random.default_rng(m)
    x2, dy2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((m, c), (m, n)))
    w2 = torch.from_numpy((rng.normal(size=(n, c)) / c ** 0.5).astype(np.float32))
    plain = cb.conv1x1_backward_plain(x2, dy2, w2, torch.float32)
    assert _k4_bound_ratio(*plain, x2, dy2, w2) <= 1.0
    tf32 = cb.conv1x1_backward_plain(_tf32(x2), _tf32(dy2), _tf32(w2), torch.float32)
    assert _k4_bound_ratio(*tf32, x2, dy2, w2) > 10.0


# K2's f32 bound against float64, relative to the f64 output's largest
# magnitude: O 2e-5, dq, dk and dv 1e-4 (as tests/test_torch_kernels.py)
K2_F32_REL = {"out": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}


def _attention_and_grads(fn, q, k, v, dout):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout.to(out.dtype))
    return dict(zip(("out", "dq", "dk", "dv"), (out.detach(), q.grad, k.grad, v.grad)))


@pytest.mark.parametrize("b,s,h,d,causal,layout", [(2, 65, 3, 40, True, "bshd"),
                                                    (1, 130, 2, 96, False, "bhsd")])
def test_k2_bound_holds_for_the_plain_f32_version_and_not_for_tf32(b, s, h, d, causal, layout):
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    rng = np.random.default_rng(s + d)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                     for _ in range(4))
    ref = _attention_and_grads(lambda *x: fa.attention_f64(*x, causal, layout), q, k, v, dout)
    plain = _attention_and_grads(lambda *x: fa.attention_reference_layout(*x, causal, layout),
                                 q, k, v, dout)
    tf32 = _attention_and_grads(lambda *x: fa.attention_reference_layout(*x, causal, layout),
                                *(_tf32(x) for x in (q, k, v)), _tf32(dout))
    for name, rel in K2_F32_REL.items():
        scale = ref[name].abs().max().item()
        assert (plain[name].double() - ref[name]).abs().max().item() <= rel * scale, name
        assert (tf32[name].double() - ref[name]).abs().max().item() > rel * scale, name


# ------------------------------------------------------ costs and bounds


def test_f32_kernels_count_4_byte_elements_against_the_f32_peak():
    """An f32 row's bound: 4-byte elements and the rate of f32-accurate
    products, 495 / 3 = 165 TFLOP/s (3xTF32). At the LM's (8, 1024, 12,
    64) causal the forward is 12.9 GFLOP, so its f32 bound is 0.0782 ms and
    the backward's (32.2 GFLOP) 0.1954 ms, both set by the operations."""
    assert roofline.kernel_peak_flops(4, H100) == pytest.approx(165e12)
    assert roofline.PEAK_F32_FLOPS[H100] == 67e12  # K1's and K3's f32 arithmetic
    assert roofline.kernel_peak_flops(2, H100) == 989e12
    assert roofline.kernel_peak_flops(4, "cpu") is None
    b, h, s, d = 8, 12, 1024, 64
    n_bytes, flops = fa.forward_cost(b, h, s, d, True, 4)
    assert n_bytes == 4 * b * s * h * d * 4 + b * h * s * 4
    assert n_bytes - fa.forward_cost(b, h, s, d, True, 2)[0] == 4 * b * s * h * d * 2
    assert flops == 4 * b * h * d * s * (s + 1) // 2
    ms, by = roofline.bound_ms(n_bytes, flops, 3.35e12, roofline.kernel_peak_flops(4, H100))
    assert by == "operations" and ms == pytest.approx(0.0782, abs=1e-4)
    ms, by = roofline.bound_ms(*fa.backward_cost(b, h, s, d, True, 4), 3.35e12,
                               roofline.kernel_peak_flops(4, H100))
    assert by == "operations" and ms == pytest.approx(0.1954, abs=1e-4)
    m, c, n = 256 * 56 * 56, 64, 256
    assert cb.backward_cost(m, c, n, 4) == (4 * (m * c + m * n + n * c) + 4 * m * c + 4 * n * c,
                                            4 * m * c * n)


def test_roofline_counts_f32_k2_and_k4_calls_against_the_f32_peak(tmp_path):
    """In a trace with f32 calls of K2 and K4 beside a bf16 product, the
    compute bound takes the f32 calls' FLOPs at the 3xTF32 rate (165
    TFLOP/s, what `analyze` reads by default for an H100) and the rest at
    989; the FLOPs themselves are the cost functions' as for bf16."""
    b, s, h, d, m, c, n = 2, 256, 4, 64, 4096, 24, 13
    ops = [
        {"name": "tk8s::flash_attn_fwd", "concrete": ["", "", "", "True", ""],
         "inputs": [([b, s, h, d], F32)] * 3 + [([], "Scalar"), ([], "")],
         "kernels": [("attn_tf32_fwd", 300)]},
        {"name": "tk8s::flash_attn_bwd", "concrete": ["", "", "", "", "", "", "True", ""],
         "inputs": [([b, s, h, d], F32)] * 5 + [([b, h, s], F32), ([], "Scalar"), ([], "")],
         "kernels": [("attn_tf32_rows", 10), ("attn_tf32_dkdv", 500), ("attn_tf32_dq", 400)]},
        {"name": "tk8s::conv1x1_bwd", "inputs": [([m, c], F32), ([m, n], F32), ([n, c], F32)],
         "kernels": [("gemm", 50), ("gemm", 60), ("reduce", 5)]},
        {"name": "aten::mm", "inputs": [([512, 256], "c10::BFloat16"),
                                        ([256, 128], "c10::BFloat16")],
         "kernels": [("sm90_xmma_gemm", 40)]},
    ]
    (tmp_path / "trace.json").write_text(__import__("json").dumps(torch_trace(ops, "inner")))
    f32_peak = roofline.kernel_peak_flops(4, H100)
    assert f32_peak == pytest.approx(165e12)
    report = roofline.analyze(str(tmp_path), 1, 3.35e12, 989e12, f32_peak)
    f32 = (fa.forward_cost(b, h, s, d, True, 4)[1] + fa.backward_cost(b, h, s, d, True, 4)[1]
           + cb.backward_cost(m, c, n, 4)[1])
    tensor = 2.0 * 512 * 128 * 256
    assert report.total_flops == pytest.approx(f32 + tensor)
    assert report.f32_flops == pytest.approx(f32)
    assert report.mxu_bound_ms == pytest.approx((tensor / 989e12 + f32 / 165e12) * 1e3)
    f32_ops = {op.name for op in report.ops if op.f32_products}
    assert f32_ops == {"attn_tf32_fwd", "attn_tf32_rows", "attn_tf32_dkdv", "attn_tf32_dq",
                       "gemm", "reduce"}
    # bf16 calls of the same ops stay on the tensor cores' peak
    assert not roofline.f32_products({"name": "tk8s::conv1x1_bwd", "args": {
        "Input Dims": [[m, c]], "Input type": ["c10::BFloat16"]}})
