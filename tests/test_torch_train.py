"""The port's train step against the JAX `make_train_step` on the same
weights and batch, and the port's benchmark entry on the CPU.

The JAX side runs on a 1-device mesh with the Pallas loss kernel in
interpret mode (as tests/test_parallel.py does); the port runs on CPU
tensors, whose loss takes K1's plain torch version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu.models import resnet as jax_resnet
from tritonk8ssupervisor_tpu.ops.cross_entropy import (
    cross_entropy_loss_and_correct_interpret,
)
from tritonk8ssupervisor_tpu.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu.parallel import train as jax_train
from tritonk8ssupervisor_tpu_torch.benchmarks.resnet50 import run_benchmark
from tritonk8ssupervisor_tpu_torch.models import ResNet18
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import (
    cross_entropy_loss,
    cross_entropy_loss_and_correct,
    cross_entropy_loss_and_correct_reference,
)
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

BATCH = 16  # ResNet-18's last stage is 1x1 at 32x32: BatchNorm over the batch


def _random_variables(model, seed):
    """flax variables of `model` with every leaf drawn from numpy."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=BATCH).astype(np.int32)
    return images, labels


def _port_state(variables, lr=0.1):
    model = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables, model))
    return train.create_train_state(model, train.default_optimizer(lr), device="cpu")


def test_two_steps_match_jax_make_train_step():
    jmodel = jax_resnet.ResNet18(num_classes=10, num_filters=8, dtype=jnp.float32)
    variables = _random_variables(jmodel, seed=11)
    images, labels = _batch(12)

    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    tx = jax_train.default_optimizer(learning_rate=0.1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params),
    )
    shardings = mesh_lib.param_shardings(jstate, mesh)
    jstep = jax_train.make_train_step(
        jmodel, tx, mesh, shardings, metrics_fn=cross_entropy_loss_and_correct_interpret
    )

    state = _port_state(variables)
    step = train.make_train_step(state, metrics_fn=cross_entropy_loss_and_correct)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, images, labels)
        metrics = step(x, y)
        # f32 on both sides; train-mode BatchNorm over 16 values a channel
        # in the last stage amplifies rounding (tests/test_torch_resnet.py)
        np.testing.assert_allclose(
            float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4, atol=1e-4
        )
        assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    assert state.step == int(jstate.step) == 2

    expected = state_dict_from_flax(
        jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}),
        state.model,
    )
    # parameters after two SGD-Nesterov steps at lr 0.1 and the moved
    # statistics: f32 gradients through 18 layers, summed in other orders
    # (measured: at most 7e-6 apart)
    for key, value in state.model.state_dict().items():
        np.testing.assert_allclose(
            value.numpy(), expected[key].numpy(), rtol=1e-4, atol=5e-5, err_msg=key
        )


def test_steps_per_call_and_loss_fn_paths():
    jmodel = jax_resnet.ResNet18(num_classes=10, num_filters=8)
    variables = _random_variables(jmodel, seed=21)
    x, y = (torch.from_numpy(a) for a in _batch(22))

    chained = _port_state(variables)
    metrics = train.make_train_step(chained, steps_per_call=2)(x, y)
    single = _port_state(variables)
    step = train.make_train_step(single)
    step(x, y)
    last = step(x, y)
    assert chained.step == single.step == 2
    torch.testing.assert_close(metrics["loss"], last["loss"], rtol=0, atol=0)
    for (name, a), b in zip(chained.model.state_dict().items(),
                            single.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)

    custom = _port_state(variables)
    out = train.make_train_step(custom, loss_fn=cross_entropy_loss)(x, y)
    torch.testing.assert_close(out["loss"], _first_loss(variables, x, y), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        train.make_train_step(custom, loss_fn=cross_entropy_loss,
                              metrics_fn=cross_entropy_loss_and_correct)


def _first_loss(variables, x, y):
    state = _port_state(variables)
    return train.make_train_step(state)(x, y)["loss"]


def test_default_metrics_fn_is_the_kernel_only_on_the_card():
    assert train._default_metrics_fn(torch.device("cpu")) is (
        cross_entropy_loss_and_correct_reference
    )
    assert train._default_metrics_fn(torch.device("cuda")) is cross_entropy_loss_and_correct


def test_run_benchmark_on_cpu_reports_the_reference_fields():
    result = run_benchmark(
        model_name="resnet18", batch_per_chip=4, image_size=32, num_classes=10,
        steps=2, warmup=1, windows=1, device="cpu",
    )
    # one counted step, one warm-up step, one window of two steps
    assert result["final_step"] == 4
    assert result["platform"] == "cpu" and result["device_kind"] == "cpu"
    assert result["mfu"] is None  # no device number from a CPU run
    assert result["flops_per_step"] > 0 and "flop_counter" in result["flops_source"]
    assert np.isfinite(result["final_loss"])
    for key in ("images_per_sec_per_chip", "step_ms", "step_ms_min",
                "step_ms_windows", "flops_per_image", "compile_seconds",
                "global_batch", "num_chips", "data_parallelism"):
        assert key in result, key


@pytest.mark.parametrize("kwargs", [
    {"model_name": "vit"},
    {"model_parallelism": 2},
    {"checkpoint_dir": "ckpt"},
])
def test_run_benchmark_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_benchmark(device="cpu", **kwargs)


def test_run_benchmark_resnet50_fused_1x1_bwd_runs_on_cpu():
    """`fused_1x1_bwd` is ported (kernel K4; its plain version on CPU
    tensors): the ResNet-50 benchmark runs with it at a tiny size and
    counts the default path's FLOPs (the plain version's two products are
    the two that cuDNN's backward is counted for). ResNet-18 has no
    stride-1 1x1 convolution, so it would not reach the lever."""
    kwargs = dict(model_name="resnet50", batch_per_chip=2, image_size=32, num_classes=10,
                  steps=1, warmup=1, windows=1, device="cpu")
    result = run_benchmark(fused_1x1_bwd=True, **kwargs)
    assert result["final_step"] == 3 and np.isfinite(result["final_loss"])
    assert result["mfu"] is None and result["platform"] == "cpu"
    default = run_benchmark(**kwargs)
    assert result["flops_per_step"] == pytest.approx(default["flops_per_step"], rel=1e-3)


def test_run_benchmark_stops_at_a_window_boundary_when_draining(tmp_path, monkeypatch):
    drain = tmp_path / "drain"
    drain.write_text("host maintenance\n")
    monkeypatch.setenv("TK8S_DRAIN_FILE", str(drain))
    result = run_benchmark(
        model_name="resnet18", batch_per_chip=2, image_size=32, num_classes=10,
        steps=1, warmup=1, windows=3, device="cpu",
    )
    assert result["drained"] == "host maintenance"
    assert result["windows"] == 1 and result["final_step"] == 3


def test_peak_table_and_mfu_arithmetic():
    from tritonk8ssupervisor_tpu_torch.utils import perf

    assert perf.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert perf.peak_flops_per_chip("NVIDIA H100 PCIe 80GB") == 756e12  # prefix
    assert perf.peak_flops_per_chip("cpu") is None
    assert perf.mfu(989e12 * 0.05, 0.1, 1, "NVIDIA H100 80GB HBM3") == pytest.approx(0.5)
    assert perf.mfu(None, 0.1, 1, "NVIDIA H100 80GB HBM3") is None
    assert perf.mfu(1e12, 0.1, 1, "cpu") is None
