"""The port's LM train and eval steps and `lm_optimizer` against the JAX
`make_lm_train_step`, `make_lm_eval_step` and optax, on the same weights
and tokens, and the port's LM benchmark entry on the CPU.

The JAX side runs on a 1-device mesh with the Pallas loss kernel in
interpret mode (as tests/test_parallel.py does); the port runs on CPU
tensors, whose loss takes K1's plain version and whose attention takes
K2's plain version. Models are f32 so that the comparison is of the
algorithm, not of bf16 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import draw
from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
from tritonk8ssupervisor_tpu.ops.cross_entropy import (
    cross_entropy_loss_and_correct_interpret,
)
from tritonk8ssupervisor_tpu.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu.parallel import train as jax_train
from tritonk8ssupervisor_tpu_torch.benchmarks import lm
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import cross_entropy_loss_and_correct
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

CONFIG = dict(vocab_size=128, num_layers=2, num_heads=2, embed_dim=64, max_seq_len=32)
BATCH, SEQ = 4, 32


def _variables(jax_model, seed):
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 128, (BATCH, SEQ)).astype(np.int32)


def _jax_setup(tx, seed):
    jmodel = JaxLM(**CONFIG, dtype=jnp.float32, logits_dtype=jnp.float32)
    variables = _variables(jmodel, seed)
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats={}, opt_state=tx.init(params))
    shardings = mesh_lib.param_shardings(state, mesh)
    return jmodel, variables, mesh, state, shardings


def _port_state(variables, tx):
    model = TransformerLM(**CONFIG, dtype=torch.float32, logits_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables, model))
    return train.create_train_state(model, tx, device="cpu")


def _assert_params_match(state, jparams, rtol, atol):
    expected = state_dict_from_flax({"params": jax.device_get(jparams)}, state.model)
    for key, value in state.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


def test_two_sgd_steps_match_jax():
    jmodel, variables, mesh, jstate, shardings = _jax_setup(
        jax_train.default_optimizer(learning_rate=0.1), seed=1)
    jstep = jax_train.make_lm_train_step(
        jmodel, jax_train.default_optimizer(learning_rate=0.1), mesh, shardings,
        metrics_fn=cross_entropy_loss_and_correct_interpret,
    )
    state = _port_state(variables, train.default_optimizer(0.1))
    step = train.make_lm_train_step(state, metrics_fn=cross_entropy_loss_and_correct)
    tokens = _tokens(2)
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, jnp.asarray(tokens))
        metrics = step(torch.from_numpy(tokens))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(metrics["accuracy"]),
                                   float(jmetrics["accuracy"]), rtol=0, atol=1e-7)
    assert state.step == int(jstate.step) == 2
    # f32 gradients through two layers, summed in other orders: 1e-4
    _assert_params_match(state, jstate.params, rtol=1e-4, atol=1e-4)


MOE = dict(moe_experts=4, moe_every=2, moe_capacity_factor=1.0)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_moe_lm_sgd_steps_match_jax(grad_accum):
    """Two SGD steps of an LM whose second block is a mixture of 4
    experts (capacity factor 1: some choices drop), against JAX: the
    router losses join the objective on both sides, the reported loss is
    the data loss, and with grad_accum=2 each half-batch adds its own
    router losses (the reference's per-chunk average)."""
    jmodel = JaxLM(**CONFIG, **MOE, dtype=jnp.float32, logits_dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32)))
    variables = draw(shapes, seed=20 + grad_accum)
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    tx = jax_train.default_optimizer(learning_rate=0.1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats={}, opt_state=tx.init(params))
    jstep = jax_train.make_lm_train_step(
        jmodel, tx, mesh, mesh_lib.param_shardings(jstate, mesh),
        metrics_fn=cross_entropy_loss_and_correct_interpret, grad_accum=grad_accum)

    model = TransformerLM(**CONFIG, **MOE, dtype=torch.float32, logits_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables, model))
    state = train.create_train_state(model, train.default_optimizer(0.1), device="cpu")
    step = train.make_lm_train_step(state, metrics_fn=cross_entropy_loss_and_correct,
                                    grad_accum=grad_accum)
    tokens = _tokens(22)
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, jnp.asarray(tokens))
        metrics = step(torch.from_numpy(tokens))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-5, atol=1e-5)
        assert float(metrics["router_loss"]) > 0.0
    _assert_params_match(state, jstate.params, rtol=1e-4, atol=1e-4)


def test_lm_optimizer_matches_optax_over_three_steps():
    """Warmup (lr 0 at the first update), global-norm clipping and AdamW's
    decoupled decay, step for step against optax."""
    kwargs = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10, weight_decay=0.1,
                  grad_clip_norm=0.5)
    jtx = jax_train.lm_optimizer(**kwargs)
    jmodel, variables, mesh, jstate, shardings = _jax_setup(jtx, seed=3)
    jstep = jax_train.make_lm_train_step(
        jmodel, jtx, mesh, shardings, metrics_fn=cross_entropy_loss_and_correct_interpret)
    state = _port_state(variables, train.lm_optimizer(**kwargs))
    step = train.make_lm_train_step(state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for i in range(3):
        tokens = _tokens(10 + i)
        jstate, jmetrics = jstep(jstate, jnp.asarray(tokens))
        metrics = step(torch.from_numpy(tokens))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-5, atol=1e-5)
        if i == 0:  # the schedule gives lr 0 at count 0: nothing moves
            for key, value in state.model.state_dict().items():
                torch.testing.assert_close(value, before[key], rtol=0, atol=0)
    # The key third of each qkv bias adds q.b_k to a whole row of scores,
    # which the softmax cancels: its gradient is 0 up to f32 rounding, and
    # Adam's g / sqrt(v) turns that rounding noise into steps of +-lr on
    # either side. Those entries are held to the bound of three steps
    # (lr 0, 5e-3, 1e-2); every other parameter to 1e-4.
    e = CONFIG["embed_dim"]
    expected = state_dict_from_flax({"params": jax.device_get(jstate.params)}, state.model)
    for key, value in state.model.state_dict().items():
        got, want = value.numpy().copy(), expected[key].numpy().copy()
        if key.endswith("qkv.bias"):
            for side in (got, want):
                assert np.abs(side[e:2 * e] - before[key].numpy()[e:2 * e]).max() <= 1.6e-2
                side[e:2 * e] = 0.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=key)


def test_warmup_cosine_schedule_matches_optax():
    import optax

    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 20, 3e-5)
    ours = train.warmup_cosine_decay(3e-4, 5, 20, 3e-5)
    for count in (0, 1, 4, 5, 6, 12, 19, 20, 25):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)


def test_grad_accum_two_equals_the_full_batch_step():
    jmodel = JaxLM(**CONFIG, dtype=jnp.float32, logits_dtype=jnp.float32)
    variables = _variables(jmodel, seed=4)
    tokens = torch.from_numpy(_tokens(5))
    results = []
    for accum in (1, 2):
        state = _port_state(variables, train.default_optimizer(0.1))
        metrics = train.make_lm_train_step(state, grad_accum=accum)(tokens)
        results.append((metrics, state.model.state_dict()))
    (m1, p1), (m2, p2) = results
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m2["accuracy"], m1["accuracy"], rtol=0, atol=1e-7)
    for key in p1:
        torch.testing.assert_close(p2[key], p1[key], rtol=1e-5, atol=1e-6, msg=key)
    state = _port_state(variables, train.default_optimizer(0.1))
    with pytest.raises(ValueError, match="grad_accum"):
        train.make_lm_train_step(state, grad_accum=3)(tokens)


def test_eval_step_equals_the_train_metrics_before_the_update_and_jax():
    jmodel, variables, mesh, jstate, shardings = _jax_setup(
        jax_train.default_optimizer(0.1), seed=6)
    tokens = _tokens(7)
    jeval = jax_train.make_lm_eval_step(
        jmodel, mesh, shardings, metrics_fn=cross_entropy_loss_and_correct_interpret)
    jmetrics = jeval(jstate, jnp.asarray(tokens))

    state = _port_state(variables, train.default_optimizer(0.1))
    evaluated = train.make_lm_eval_step(state)(torch.from_numpy(tokens))
    assert state.step == 0 and not evaluated["loss"].requires_grad
    trained = train.make_lm_train_step(state)(torch.from_numpy(tokens))
    torch.testing.assert_close(evaluated["loss"], trained["loss"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(evaluated["accuracy"], trained["accuracy"], rtol=0, atol=0)
    np.testing.assert_allclose(float(evaluated["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(evaluated["accuracy"]), float(jmetrics["accuracy"]),
                               rtol=0, atol=1e-7)


def test_next_token_metrics_mask_the_wrapped_position():
    """Targets are the tokens rolled left; the last position (whose
    target wrapped around) counts in neither metric."""
    tokens = torch.tensor([[1, 2, 3, 0]])
    logits = torch.full((1, 4, 4), -10.0)
    logits[0, 0, 2] = logits[0, 1, 3] = 10.0   # right at positions 0 and 1
    logits[0, 2, 1] = logits[0, 3, 1] = 10.0   # wrong at 2; 3 is masked
    calls = []

    def pair_fn(flat, targets):
        calls.append(flat.shape[0])
        return cross_entropy_loss_and_correct(flat, targets)

    loss, accuracy = train._next_token_metrics(pair_fn, logits, tokens)
    assert calls == [4]  # the kernel sees every row, the wrapped one included
    assert float(accuracy) == pytest.approx(2 / 3)
    losses = cross_entropy_loss_and_correct(logits[0], torch.tensor([2, 3, 0, 1]))[0]
    assert float(loss) == pytest.approx(float(losses[:3].sum() / 3))


@pytest.mark.parametrize("kwargs", [
    {"seq_axis": "model"}, {"forward_fn": lambda p, t: None}, {"mesh": object()},
])
def test_unported_step_options_raise(kwargs):
    """A sequence axis needs a state made on a mesh, and the step runs on
    the state's mesh only (tests/test_torch_mesh_train.py drives the
    mesh). The pipeline's hook `forward_fn` ((model, tokens) -> logits,
    tests/test_torch_pipeline.py) runs: a hook that calls the model gives
    the default step's metrics and update to the bit."""
    variables = _variables(JaxLM(**CONFIG), seed=8)
    state = _port_state(variables, train.default_optimizer())
    if "forward_fn" not in kwargs:
        with pytest.raises(ValueError, match="mesh"):
            train.make_lm_train_step(state, **kwargs)
        return
    calls = []

    def forward_fn(model, tokens):
        calls.append(tokens.shape)
        return model(tokens)

    tokens = torch.from_numpy(_tokens(2))
    hooked = train.make_lm_train_step(state, forward_fn=forward_fn)(tokens)
    plain_state = _port_state(variables, train.default_optimizer())
    plain = train.make_lm_train_step(plain_state)(tokens)
    assert calls == [tokens.shape]
    assert {k: float(v) for k, v in hooked.items()} == {k: float(v) for k, v in plain.items()}
    for key, value in plain_state.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[key], value), key


def test_run_benchmark_on_cpu_reports_the_reference_fields():
    result = lm.run_benchmark(
        vocab_size=128, num_layers=1, num_heads=2, embed_dim=64, seq_len=32,
        batch_per_data_shard=2, steps=2, warmup=1, windows=1, device="cpu",
    )
    # one counted step, one warm-up step, one window of two steps
    assert result["final_step"] == 4
    assert result["platform"] == "cpu" and result["device"] == "cpu"
    assert result["attention"] == "dense"  # "auto" off the card
    assert result["mfu"] is None  # no device number from a CPU run
    assert result["flops_per_step"] > 0 and "flop_counter" in result["flops_source"]
    assert np.isfinite(result["final_loss"])
    for key in ("start_step", "model", "num_chips", "sequence_parallelism",
                "expert_parallelism", "moe_experts", "pipeline_parallelism",
                "global_batch", "seq_len", "num_layers", "embed_dim", "step_ms",
                "step_ms_min", "step_ms_windows", "steps", "windows", "tokens_per_sec",
                "tokens_per_sec_per_chip", "flops_per_token", "compile_seconds"):
        assert key in result, key
    flash = lm.run_benchmark(
        vocab_size=128, num_layers=1, num_heads=2, embed_dim=64, seq_len=32,
        batch_per_data_shard=2, steps=1, warmup=1, windows=1, attention="flash",
        head_major=True, grad_accum=2, device="cpu",
    )
    assert flash["attention"] == "flash" and np.isfinite(flash["final_loss"])


@pytest.mark.parametrize("kwargs", [
    {"sequence_parallelism": 2}, {"expert_parallelism": 2},
    {"pipeline_parallelism": 2}, {"checkpoint_dir": "memory://tk8s-lm-bench-test/ckpt"},
])
def test_run_benchmark_unported_options_raise(kwargs):
    """A sequence, expert or pipeline degree of 2 does not divide one
    process's single rank, which the mesh refuses as the reference's
    make_mesh does (tests/test_torch_mesh_train.py and
    tests/test_torch_pipeline.py run them on gloo ranks). A URL checkpoint
    directory, once refused, is now taken: the run commits its last step
    there (an fsspec `memory://` URL; no bucket is reachable from the test
    machines)."""
    run = functools.partial(
        lm.run_benchmark, vocab_size=64, num_layers=1, num_heads=2, embed_dim=32, seq_len=16,
        batch_per_data_shard=2, steps=1, warmup=1, windows=1, device="cpu", **kwargs)
    if "checkpoint_dir" not in kwargs:
        with pytest.raises(ValueError, match="do not divide device count 1"):
            run()
        return
    import fsspec

    from tritonk8ssupervisor_tpu_torch.parallel.checkpoint import TrainCheckpointer

    try:
        result = run()
        assert TrainCheckpointer(kwargs["checkpoint_dir"]).latest_step() == result["final_step"]
    finally:
        fsspec.filesystem("memory").rm("/tk8s-lm-bench-test", recursive=True)


def test_run_benchmark_trains_a_moe_lm_on_cpu():
    result = lm.run_benchmark(
        vocab_size=128, num_layers=2, num_heads=2, embed_dim=64, seq_len=32,
        batch_per_data_shard=2, steps=2, warmup=1, windows=1, moe_experts=4, moe_every=2,
        device="cpu",
    )
    assert result["moe_experts"] == 4 and result["final_step"] == 4
    assert np.isfinite(result["final_loss"]) and result["router_loss"] > 0.0
    # the expert products are counted: more FLOPs than the dense model's
    dense = lm.run_benchmark(
        vocab_size=128, num_layers=2, num_heads=2, embed_dim=64, seq_len=32,
        batch_per_data_shard=2, steps=1, warmup=1, windows=1, device="cpu",
    )
    assert result["flops_per_step"] > dense["flops_per_step"] and "router_loss" not in dense


def test_run_benchmark_rejects_bad_arguments():
    with pytest.raises(ValueError, match="attention"):
        lm.run_benchmark(device="cpu", attention="ring")
    with pytest.raises(ValueError, match="grad-accum"):
        lm.run_benchmark(device="cpu", grad_accum=0)
