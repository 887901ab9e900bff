"""The port's train steps on a mesh of gloo ranks against the JAX
package's on a mesh of the conftest's virtual devices of the same
degrees, from the same weights and batch (parallel/train.py,
parallel/spmd.py, models/resnet.BatchNorm over the global batch,
models/moe.py's expert parallelism, the benchmarks' mesh paths).

Each case runs the reference's step on its global arrays, then the port's
on 4 CPU processes (`parallel/ranks.run_ranks`), each rank on its shard
of the batch (and of the sequence), and holds every rank's metrics and
parameter shards against the reference's (each shard against its block
of the reference's parameter, cut by the rank's spec). Models are f32,
so the comparison is of the algorithm: the ranks sum the same products
in other orders than XLA does.
"""

import functools

import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu_torch.benchmarks import lm as lm_bench
from tritonk8ssupervisor_tpu_torch.benchmarks import resnet50 as resnet_bench
from tritonk8ssupervisor_tpu_torch.models import ResNet18, TransformerLM
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import ring_attention
from tritonk8ssupervisor_tpu_torch.parallel import mesh, train
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

RANKS = 4
TIMEOUT = 240.0
# f32 parameters after one SGD-Nesterov step and the metrics: the same
# arithmetic as the reference, summed in other orders across ranks
# (measured below 2e-6 on these cases)
RTOL, ATOL = 1e-4, 2e-5

LM = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=16)
SGD = ("sgd", {"learning_rate": 0.1})

# ------------------------------------------------------------------ rank bodies


def _rank_view(state) -> dict:
    """What a rank hands back: its parameters (shards), specs, coordinates."""
    return {"params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "specs": state.specs,
            "coords": [state.mesh.get_local_rank(a) for a in mesh.AXES]}


def resnet_ranks(sd, images, labels, model_parallelism):
    """One step of the ResNet-18 of state dict `sd` on a mesh with
    `model_parallelism`; also whether a custom loss is refused there."""
    m = mesh.make_mesh(model_parallelism=model_parallelism, device_type="cpu")
    model = ResNet18(num_classes=sd["classifier.bias"].shape[0],
                     num_filters=sd["stem_conv.weight"].shape[0], dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = train.create_train_state(model, _port_optimizer(SGD), mesh=m)
    metrics = train.make_train_step(state)(batch_shard(m, torch.from_numpy(images)),
                                           batch_shard(m, torch.from_numpy(labels)))
    refused = None
    if model_parallelism > 1:
        try:
            train.make_train_step(state, loss_fn=lambda logits, y: logits.sum(-1))
        except ValueError as e:
            refused = str(e)
    return {"metrics": metrics, **_rank_view(state)}, refused


def _port_optimizer(tx):
    name, kwargs = tx
    return train.lm_optimizer(**kwargs) if name == "adamw" else train.default_optimizer(**kwargs)


def lm_ranks(sd, batches, seq_parallelism, expert_parallelism, moe_experts, tx):
    """LM steps on a mesh, one per global batch of `batches`: the
    sequence over "model" (ring attention) when `seq_parallelism` > 1,
    the experts over "expert"; with a sequence axis also the eval step's
    metrics after the updates. `tx` names the optimizer ("sgd" or
    "adamw") and its arguments."""
    m = mesh.make_mesh(model_parallelism=seq_parallelism,
                       expert_parallelism=expert_parallelism, device_type="cpu")
    seq_axis = "model" if seq_parallelism > 1 else None
    kwargs = {}
    if seq_axis:
        kwargs["attention_fn"] = functools.partial(ring_attention, mesh=m, axis_name="model")
    model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32,
                          moe_experts=moe_experts, moe_mesh=m if moe_experts else None,
                          **kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = train.create_train_state(model, _port_optimizer(tx), mesh=m)
    step = train.make_lm_train_step(state, seq_axis=seq_axis)
    for tokens in batches:
        local = batch_shard(m, torch.from_numpy(tokens))
        if seq_axis:
            local = mesh.local_shard(local, m, (None, seq_axis))
        metrics = step(local)
    if seq_axis:
        metrics["eval"] = train.make_lm_eval_step(state, seq_axis=seq_axis)(local)
    return {"metrics": metrics, **_rank_view(state)}


def clipped_grads_ranks():
    """ClippedAdamW on expert 2 x data 2 with an expert-sharded (2, 3)
    parameter (this rank holds one row) and a replicated (3,) one, their
    gradients set by hand: the gradients after the step, which the
    clipping scales in place by max_norm / global norm."""
    m = mesh.make_mesh(expert_parallelism=2, device_type="cpu")
    model = torch.nn.Module()
    model.expert_w = torch.nn.Parameter(torch.zeros(2, 3))
    model.b = torch.nn.Parameter(torch.zeros(3))
    state = train.create_train_state(model, train.lm_optimizer(grad_clip_norm=0.5), mesh=m)
    row = m.get_local_rank("expert")
    model.expert_w.grad = torch.tensor([[1.0, 2.0, 2.0], [4.0, 4.0, 7.0]])[row:row + 1]
    model.b.grad = torch.tensor([2.0, 4.0, 4.0])
    state.optimizer.step()
    return state.specs, model.expert_w.grad, model.b.grad


def benchmark_ranks():
    """The benchmarks' mesh paths at a tiny size on 4 ranks, and what they
    refuse."""
    tiny_lm = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, seq_len=16,
                   batch_per_data_shard=2, steps=1, warmup=1, windows=1, device="cpu")
    results = {
        "resnet_mp2": resnet_bench.run_benchmark(
            model_name="resnet18", batch_per_chip=2, image_size=32, num_classes=10, steps=1,
            warmup=1, windows=1, model_parallelism=2, device="cpu"),
        "lm_sp2": lm_bench.run_benchmark(sequence_parallelism=2, **tiny_lm),
        "lm_ep2": lm_bench.run_benchmark(expert_parallelism=2, moe_experts=4, **tiny_lm),
        "pp2": lm_bench.run_benchmark(pipeline_parallelism=2, num_microbatches=2, **tiny_lm),
        "sp_moe": lm_bench.run_benchmark(sequence_parallelism=2, moe_experts=4, **tiny_lm),
    }
    for name, call in (
        ("mp3", lambda: resnet_bench.run_benchmark(
            model_name="resnet18", batch_per_chip=2, image_size=32, num_classes=10,
            steps=1, warmup=1, windows=1, model_parallelism=3, device="cpu")),
        ("pp_moe", lambda: lm_bench.run_benchmark(pipeline_parallelism=2, moe_experts=4,
                                                  **tiny_lm)),
        ("pp_sp", lambda: lm_bench.run_benchmark(pipeline_parallelism=2,
                                                 sequence_parallelism=2, **tiny_lm)),
    ):
        try:
            call()
            results[name] = None
        except (ValueError, NotImplementedError) as e:
            results[name] = (type(e).__name__, str(e))
    return results


# ------------------------------------------------------------------ reference side


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _random_variables(jmodel, sample, seed):
    """flax variables of `jmodel`, every leaf drawn from numpy."""
    jax, _ = _jax()
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), sample, train=False))
    shapes = {k: v for k, v in shapes.items() if k in ("params", "batch_stats")}
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel" or "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" else s.shape[-2]
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _reference_step(jmodel, variables, ref_mesh, batches, tx, lm=False, seq_axis=None):
    """The reference's train step on `ref_mesh`, once per batch of
    `batches`: (new state, the last metrics, and with a sequence axis the
    eval metrics after the updates). `tx` as `lm_ranks` takes it."""
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.parallel import mesh as jax_mesh
    from tritonk8ssupervisor_tpu.parallel import train as jax_train

    name, kwargs = tx
    tx = jax_train.lm_optimizer(**kwargs) if name == "adamw" else \
        jax_train.default_optimizer(**kwargs)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=stats, opt_state=tx.init(params))
    shardings = jax_mesh.param_shardings(state, ref_mesh)
    if lm:
        step = jax_train.make_lm_train_step(jmodel, tx, ref_mesh, shardings, seq_axis=seq_axis)
    else:
        step = jax_train.make_train_step(jmodel, tx, ref_mesh, shardings)
    for batch in batches:
        state, metrics = step(state, *batch)
    evaluated = None
    if seq_axis:
        evaluated = jax_train.make_lm_eval_step(jmodel, ref_mesh, shardings,
                                                seq_axis=seq_axis)(state, *batches[-1])
    return state, metrics, evaluated


def _block(x, spec, coords, sizes):
    """The block of global `x` that a rank at `coords` holds under `spec`."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            i = mesh.AXES.index(axis)
            x = np.split(x, sizes[i], axis=dim)[coords[i]]
    return x


def _assert_rank_matches(rank, result, expected, jmetrics, sizes, keys=("loss", "accuracy")):
    for key in keys:
        np.testing.assert_allclose(float(result["metrics"][key]), float(jmetrics[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {rank} {key}")
    assert result["params"].keys() == expected.keys()
    for key, value in result["params"].items():
        want = _block(expected[key].numpy(), result["specs"].get(key, ()), result["coords"],
                      sizes)
        np.testing.assert_allclose(value.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {rank} {key}")


def _torch_state(variables, model):
    from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

    return {k: v.numpy() for k, v in state_dict_from_flax(variables, model).items()}


def _expected(new_state, model):
    jax, _ = _jax()
    from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

    variables = {"params": jax.device_get(new_state.params)}
    if new_state.batch_stats:
        variables["batch_stats"] = jax.device_get(new_state.batch_stats)
    return state_dict_from_flax(variables, model)


def test_dp_resnet_step_matches_the_reference_with_global_batch_norm():
    """Data parallel on 4 ranks (4 images each) against the reference's
    4-device step: BatchNorm normalises over all 16 images and moves its
    running statistics by the global batch's, as flax's does under jit;
    the gradient is summed over the ranks. A BatchNorm over each rank's
    own 4 images is a different model, which these tolerances refuse."""
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.models import ResNet18 as JaxResNet18
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    jmodel = JaxResNet18(num_classes=10, num_filters=8, dtype=jnp.float32)
    variables = _random_variables(jmodel, jnp.zeros((1, 32, 32, 3)), seed=31)
    rng = np.random.default_rng(32)
    images = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    ref_mesh = make_mesh(devices=jax.devices()[:RANKS])
    new, jmetrics, _ = _reference_step(jmodel, variables, ref_mesh, [(images, labels)], SGD)

    port_model = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32)
    expected = _expected(new, port_model)
    sd = _torch_state(variables, port_model)
    results = run_ranks(resnet_ranks, RANKS, args=(sd, images, labels, 1),
                        timeout=TIMEOUT, threads=1)
    sizes = [dict(ref_mesh.shape)[a] for a in mesh.AXES]
    for rank, (result, _) in enumerate(results):
        _assert_rank_matches(rank, result, expected, jmetrics, sizes)


def test_tp_resnet_step_matches_the_reference():
    """data 2 x model 2: the classifier (512 classes) class-sharded over
    "model" with the vocab-parallel loss, the wide convolutions held as
    "model" shards and gathered for their forward, against the
    reference's step on the same mesh; 511 classes (not divisible) take
    the data-parallel K1 path, as the reference's do; a custom loss is
    refused on the tensor-parallel mesh."""
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.models import ResNet18 as JaxResNet18
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(41)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    ref_mesh = make_mesh(devices=jax.devices()[:RANKS], model_parallelism=2)
    sizes = [dict(ref_mesh.shape)[a] for a in mesh.AXES]
    cases = []
    for classes in (512, 511):
        jmodel = JaxResNet18(num_classes=classes, num_filters=16, dtype=jnp.float32)
        variables = _random_variables(jmodel, jnp.zeros((1, 32, 32, 3)), seed=classes)
        labels = rng.integers(0, classes, size=8).astype(np.int32)
        new, jmetrics, _ = _reference_step(jmodel, variables, ref_mesh, [(images, labels)], SGD)
        port_model = ResNet18(num_classes=classes, num_filters=16, dtype=torch.float32)
        cases.append((labels, _torch_state(variables, port_model), _expected(new, port_model),
                      jmetrics))
    results = {}
    for classes, (labels, sd, expected, jmetrics) in zip((512, 511), cases):
        results[classes] = run_ranks(resnet_ranks, RANKS, args=(sd, images, labels, 2),
                                     timeout=TIMEOUT, threads=1)
        for rank, (result, refused) in enumerate(results[classes]):
            _assert_rank_matches(rank, result, expected, jmetrics, sizes)
            assert "incompatible with model_parallelism > 1" in refused
    specs = results[512][0][0]["specs"]
    assert specs["classifier.weight"] == ("model", None)
    assert specs["BasicBlock_6.Conv_1.weight"] == ("model", None, None, None)
    assert results[511][0][0]["specs"]["classifier.weight"] == (None, None)


def _lm_case(seq_parallelism, expert_parallelism, moe_experts, batch, seed, tx=None, steps=1):
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
    from tritonk8ssupervisor_tpu.ops.ring_attention import ring_attention as jax_ring
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    ref_mesh = make_mesh(devices=jax.devices()[:RANKS], model_parallelism=seq_parallelism,
                         expert_parallelism=expert_parallelism)
    seq_axis = "model" if seq_parallelism > 1 else None
    kwargs = {}
    if seq_axis:
        def attention_fn(q, k, v, causal=True):
            return jax_ring(q, k, v, mesh=ref_mesh, axis_name="model", causal=causal)

        kwargs["attention_fn"] = attention_fn
    jmodel = JaxLM(**LM, dtype=jnp.float32, logits_dtype=jnp.float32, moe_experts=moe_experts,
                   moe_mesh=ref_mesh if moe_experts else None, **kwargs)
    variables = _random_variables(jmodel, jnp.zeros((1, 16), jnp.int32), seed)
    rng = np.random.default_rng(seed + 1)
    batches = [rng.integers(0, 64, (batch, 16)).astype(np.int32) for _ in range(steps)]
    tx = tx or SGD
    new, jmetrics, jeval = _reference_step(jmodel, variables, ref_mesh,
                                           [(t,) for t in batches], tx, lm=True,
                                           seq_axis=seq_axis)
    port_model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32,
                               moe_experts=moe_experts)
    sd = _torch_state(variables, port_model)
    results = run_ranks(lm_ranks, RANKS,
                        args=(sd, batches, seq_parallelism, expert_parallelism, moe_experts, tx),
                        timeout=TIMEOUT, threads=1)
    sizes = [dict(ref_mesh.shape)[a] for a in mesh.AXES]
    return results, _expected(new, port_model), jmetrics, jeval, sizes, sd


def test_sequence_parallel_lm_step_matches_the_reference():
    """data 2 x model 2 with the sequence over "model": ring attention,
    `pos_embed` at each shard's global positions, the next-token halo
    from the next shard, the last global position masked and global
    denominators, against the reference's `make_lm_train_step(seq_axis=
    "model")` and its eval step after the update."""
    results, expected, jmetrics, jeval, sizes, _ = _lm_case(2, 1, 0, batch=4, seed=51)
    for rank, result in enumerate(results):
        _assert_rank_matches(rank, result, expected, jmetrics, sizes)
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(float(result["metrics"]["eval"][key]), float(jeval[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"rank {rank} eval {key}")


def test_expert_parallel_moe_lm_step_matches_the_reference():
    """data 2 x expert 2, 4 experts in the second block: each rank holds 2
    experts, the dispatched slots travel by all_to_all there and back,
    the router loss is the global batch's; metrics, router loss and every
    parameter shard against the reference's step on the same mesh."""
    results, expected, jmetrics, _, sizes, _ = _lm_case(1, 2, 4, batch=8, seed=61)
    for rank, result in enumerate(results):
        _assert_rank_matches(rank, result, expected, jmetrics, sizes)
        assert result["specs"]["Block_1.moe_mlp.expert_up_kernel"] == ("expert", None, None)
        assert result["params"]["Block_1.moe_mlp.expert_up_kernel"].shape[0] == 2
        assert float(result["metrics"]["router_loss"]) > 0


def test_benchmarks_run_their_mesh_paths_on_four_ranks():
    """`run_benchmark(model_parallelism=2)`, the LM's
    `sequence_parallelism=2`, `expert_parallelism=2, moe_experts=4`,
    `pipeline_parallelism=2` (data 2 x pipe 2, 2 microbatches) and
    `sequence_parallelism=2, moe_experts=4` run to their metrics on 4 gloo
    ranks; a degree that does not divide the ranks raises ValueError, and
    so do the pipeline with MoE blocks and with sequence parallelism, as
    the reference's benchmark refuses them."""
    results = run_ranks(benchmark_ranks, RANKS, timeout=TIMEOUT, threads=1)
    for r in results:
        for name, ranks, batch in (("resnet_mp2", 4, 4), ("lm_sp2", 4, 4), ("lm_ep2", 4, 8),
                                   ("pp2", 4, 4), ("sp_moe", 4, 4)):
            result = r[name]
            assert np.isfinite(result["final_loss"]), name
            assert result["num_chips"] == ranks and result["global_batch"] == batch, name
        assert r["resnet_mp2"]["model_parallelism"] == 2
        assert r["resnet_mp2"]["data_parallelism"] == 2
        assert r["lm_sp2"]["attention"] == "ring"
        assert r["lm_ep2"]["expert_parallelism"] == 2 and r["lm_ep2"]["router_loss"] > 0
        assert r["mp3"][0] == "ValueError" and "do not divide device count 4" in r["mp3"][1]
        assert (r["pp2"]["pipeline_parallelism"], r["pp2"]["num_microbatches"]) == (2, 2)
        assert r["sp_moe"]["attention"] == "ring" and r["sp_moe"]["router_loss"] > 0
        assert r["pp_moe"][0] == "ValueError" and "--moe-experts" in r["pp_moe"][1]
        assert r["pp_sp"][0] == "ValueError" and "separate strategies" in r["pp_sp"][1]


def test_lm_optimizer_clips_by_the_norm_of_the_whole_parameters_on_a_mesh():
    """AdamW with global-norm clipping (`lm_optimizer`) on data 2 x expert
    2: the norm a rank clips by is that of the reference's global arrays,
    each expert shard's squared norm summed over the expert axis; two
    steps (lr 0, then 1e-2 after the one-step warmup) against optax on the
    reference's mesh, the clip norm small enough to clip. The key third of
    each qkv bias is held to a bound, not to the reference
    (tests/test_torch_lm_train.py says why)."""
    kwargs = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10, weight_decay=0.1,
                  grad_clip_norm=0.05)
    results, expected, jmetrics, _, sizes, sd = _lm_case(1, 2, 4, batch=8, seed=71,
                                                         tx=("adamw", kwargs), steps=2)
    e = LM["embed_dim"]
    biases = [k for k in expected if k.endswith("qkv.bias")]
    for side in [expected] + [r["params"] for r in results]:
        for key in biases:
            keys = side[key].numpy()[e:2 * e]
            assert np.abs(keys - sd[key][e:2 * e]).max() <= 1.1e-2  # two steps, lr 0 and 1e-2
            keys[:] = 0.0
    for rank, result in enumerate(results):
        _assert_rank_matches(rank, result, expected, jmetrics, sizes)


def test_clipping_norm_counts_every_shard_once():
    """The global norm of the gradients above is sqrt(9 + 81 + 36) = sqrt(126):
    each rank scales its expert row and the replicated bias by 0.5 / sqrt(126),
    not by its local norm (sqrt(45) or sqrt(117))."""
    scale = 0.5 / np.sqrt(126.0)
    for rank, (specs, w, b) in enumerate(run_ranks(clipped_grads_ranks, RANKS,
                                                   timeout=TIMEOUT, threads=1)):
        assert specs["expert_w"] == ("expert", None)
        row = [[1.0, 2.0, 2.0], [4.0, 4.0, 7.0]][rank % 2]  # the expert coordinate
        np.testing.assert_allclose(w.numpy(), np.array([row]) * scale, rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.array([2.0, 4.0, 4.0]) * scale, rtol=1e-6)
