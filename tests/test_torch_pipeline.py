"""The port's pipeline (parallel/pipeline.py) against the JAX package's:
the GPipe schedule with its gradients, the pipelined LM's forward and
first train step, its parameter layout, refusals and weight carrier, and
the LM benchmark's pipeline path with a checkpointed resume.

The reference runs on the conftest's virtual CPU devices; the port on gloo
ranks (`parallel/ranks.run_ranks`), one stage each, from the same numpy
weights and tokens. Models are f32, so the comparison is of the
algorithm: the ranks sum the same products in other orders than XLA.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_mesh_train import _block, _random_variables, _torch_state
from torch.testing._internal.distributed.fake_pg import FakeStore

from tritonk8ssupervisor_tpu_torch.benchmarks import lm as lm_bench
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.parallel import mesh, train
from tritonk8ssupervisor_tpu_torch.parallel import pipeline as pp
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

TIMEOUT = 240.0
# f32 against the reference, as tests/test_torch_mesh_train.py
RTOL, ATOL = 1e-4, 2e-5
LM = dict(vocab_size=64, num_layers=4, num_heads=2, embed_dim=16, max_seq_len=16)
LR = 0.1
# (P, M, microbatch, d, with a loss): M > P, M < P (the pipeline never
# fills), and gradients through the schedule
AFFINE_CASES = {"m6_forward": (4, 6, 4, 8, False), "m2_fewer_than_p": (4, 2, 2, 4, False),
                "m4_gradients": (4, 4, 4, 8, True)}


@contextlib.contextmanager
def fake_world(world: int = 8):
    """This process as rank 0 of a fake process group (no collective runs)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _affine_stage(params, x):
    # one "layer" per stage: x -> tanh(x * w + b), params (d,)
    return torch.tanh(x * params["w"] + params["b"])


def _affine_inputs(name):
    p, m, mb, d, _ = AFFINE_CASES[name]
    rng = np.random.default_rng(sorted(AFFINE_CASES).index(name))
    params = {"w": rng.normal(size=(p, d)).astype(np.float32),
              "b": (0.1 * rng.normal(size=(p, d))).astype(np.float32)}
    return params, rng.normal(size=(m, mb, d)).astype(np.float32), \
        rng.normal(size=(m, mb, d)).astype(np.float32)


# ------------------------------------------------------------------ rank bodies


def affine_ranks():
    """Every case of AFFINE_CASES on pipe 4: this rank's output, and with a
    loss its stage's gradients and the microbatches'."""
    m = mesh.make_mesh(pipeline_parallelism=4, device_type="cpu")
    out = {}
    for name, (*_, with_loss) in AFFINE_CASES.items():
        params, mb, tgt = _affine_inputs(name)
        local = {k: mesh.local_shard(torch.from_numpy(v), m, ("pipe", None)).clone()
                 .requires_grad_() for k, v in params.items()}
        x = torch.from_numpy(mb).requires_grad_()
        y = pp.pipeline_apply(_affine_stage, local, x, m)
        result = {"y": y.detach()}
        if with_loss:
            torch.mean((y - torch.from_numpy(tgt)) ** 2).backward()
            result.update({f"d{k}": v.grad[0] for k, v in local.items()}, dx=x.grad)
        out[name] = result
    return out


def pp_lm_ranks(sd, tokens, pipe, remat, microbatches):
    """The pipelined LM made from the dense state dict `sd` on a mesh with
    `pipe` stages: its logits on this rank's batch shard, then one SGD
    step; the parameters after it."""
    m = mesh.make_mesh(pipeline_parallelism=pipe, device_type="cpu")
    model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32,
                          remat_blocks=remat)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = pp.create_pp_lm_state(model, train.default_optimizer(LR), m)
    local = batch_shard(m, torch.from_numpy(tokens))
    with torch.no_grad():
        logits = pp.make_pp_lm_forward(state.model, m, microbatches)(
            dict(state.model.outer.named_parameters()),
            dict(state.model.stages.named_parameters()), local)
    metrics = pp.make_pp_lm_train_step(state, microbatches)(local)
    return {"logits": logits, "metrics": metrics, "specs": state.specs,
            "params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "coords": [m.get_local_rank(a) for a in mesh.AXES]}


BENCH = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, seq_len=16,
             batch_per_data_shard=4, pipeline_parallelism=2, num_microbatches=2, warmup=1,
             device="cpu")


def bench_ranks(runs):
    """`lm.run_benchmark` with the pipeline, once per (checkpoint_dir,
    steps, windows) of `runs`."""
    return [lm_bench.run_benchmark(checkpoint_dir=d, steps=steps, windows=windows, **BENCH)
            for d, steps, windows in runs]


# ------------------------------------------------------------------ reference side


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


@pytest.fixture(scope="module")
def affine():
    """The port's cases on 4 gloo ranks and the reference's on a pipe-4 mesh."""
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.parallel import pipeline as jax_pp
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    ref_mesh = make_mesh(devices=jax.devices()[:4], pipeline_parallelism=4)

    def stage(params, x):
        return jnp.tanh(x * params["w"] + params["b"])

    want = {}
    for name, (*_, with_loss) in AFFINE_CASES.items():
        params, mb, tgt = _affine_inputs(name)

        def loss(p, x):
            return jnp.mean((jax_pp.pipeline_apply(stage, p, x, ref_mesh) - tgt) ** 2)

        want[name] = {"y": np.asarray(jax_pp.pipeline_apply(stage, params, mb, ref_mesh))}
        if with_loss:
            grads, dx = jax.grad(loss, argnums=(0, 1))(params, mb)
            want[name].update({f"d{k}": np.asarray(v) for k, v in grads.items()},
                              dx=np.asarray(dx))
    return run_ranks(affine_ranks, 4, timeout=TIMEOUT, threads=1), want


@pytest.mark.parametrize("name", sorted(AFFINE_CASES))
def test_pipeline_apply_matches_the_reference(affine, name):
    """Every rank returns the last stage's outputs, equal to the
    reference's `pipeline_apply`; through a loss, each rank's stage
    gradients equal the reference's slice of them, and only stage 0 (which
    feeds the microbatches) holds the microbatches' gradient."""
    results, want = affine
    for rank, result in enumerate(results):
        got = result[name]
        np.testing.assert_allclose(got["y"].numpy(), want[name]["y"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {rank}")
        if "dw" in got:
            for key in ("dw", "db"):
                np.testing.assert_allclose(got[key].numpy(), want[name][key][rank], rtol=RTOL,
                                           atol=ATOL, err_msg=f"rank {rank} {key}")
            dx = want[name]["dx"] if rank == 0 else np.zeros_like(want[name]["dx"])
            np.testing.assert_allclose(got["dx"].numpy(), dx, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {rank} dx")


def _jax_lm(**kw):
    _, jnp = _jax()
    from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM

    return JaxLM(**LM, dtype=jnp.float32, logits_dtype=jnp.float32, **kw)


def _port_pp_model(num_stages):
    return pp.PipelinedLM(TransformerLM(**LM, dtype=torch.float32,
                                        logits_dtype=torch.float32), num_stages)


@pytest.mark.parametrize("ranks,remat", [(2, True), (4, False)], ids=["pipe2_remat", "data2_pipe2"])
def test_pp_lm_forward_and_step_match_the_reference(ranks, remat):
    """The pipelined LM on pipe 2 (2 ranks, each layer recomputed in the
    backward) and on data 2 x pipe 2 (4 ranks), 2 microbatches, from one
    dense LM's weights: the logits of the reference's `make_pp_lm_forward`
    on each rank's rows; after one step of its `make_pp_lm_train_step`
    the loss, the accuracy and every parameter (each rank's stage against
    its slice of the reference's stack)."""
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.parallel import pipeline as jax_pp
    from tritonk8ssupervisor_tpu.parallel import train as jax_train
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    ref_mesh = make_mesh(devices=jax.devices()[:ranks], pipeline_parallelism=2)
    jmodel = _jax_lm()
    variables = _random_variables(jmodel, jnp.zeros((1, 16), jnp.int32), seed=80 + ranks)
    tokens = np.random.default_rng(90 + ranks).integers(0, 64, (2 * ranks, 16)).astype(np.int32)
    tx = jax_train.default_optimizer(learning_rate=LR)
    outer, stages, _ = jax_pp.pipelined_lm_params(jmodel, variables["params"], ref_mesh)
    params = {"outer": outer, "stages": stages}
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats={}, opt_state=tx.init(params))
    shardings = jax_pp.pp_state_shardings(state, ref_mesh)
    logits = jax.jit(jax_pp.make_pp_lm_forward(jmodel, ref_mesh, 2))(outer, stages, tokens)
    step = jax_pp.make_pp_lm_train_step(jmodel, tx, ref_mesh, shardings, num_microbatches=2)
    new, jmetrics = step(jax.device_put(state, shardings), tokens)

    port_model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32)
    sd = _torch_state(variables, port_model)
    results = run_ranks(pp_lm_ranks, ranks, args=(sd, tokens, 2, remat, 2), timeout=TIMEOUT,
                        threads=1)
    expected = state_dict_from_flax({"params": jax.device_get(new.params)}, _port_pp_model(2))
    sizes = [dict(ref_mesh.shape)[a] for a in mesh.AXES]
    rows = len(tokens) // sizes[0]
    for rank, result in enumerate(results):
        data = result["coords"][0]
        np.testing.assert_allclose(result["logits"].numpy(),
                                   np.asarray(logits)[data * rows:(data + 1) * rows],
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {rank} logits")
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(float(result["metrics"][key]), float(jmetrics[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"rank {rank} {key}")
        assert result["params"].keys() == expected.keys()
        assert result["specs"]["stages.qkv.weight"] == ("pipe", None, None, None)
        assert result["params"]["stages.qkv.weight"].shape[:2] == (1, 2)
        for key, value in result["params"].items():
            want = _block(expected[key].numpy(), result["specs"][key], result["coords"], sizes)
            np.testing.assert_allclose(value.numpy(), want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {rank} {key}")


def test_stack_unstack_roundtrip_and_the_reference_stack():
    """`stack_block_params` stacks each Block_i entry into one (L, ...)
    tensor, as the reference's does for its tree (the carried reference
    stack equals the port's), and `unstack_block_params` inverts it."""
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.parallel import pipeline as jax_pp

    jmodel = _jax_lm()
    variables = _random_variables(jmodel, jnp.zeros((1, 16), jnp.int32), seed=3)
    model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables, model))
    params = model.state_dict()
    stacked = pp.stack_block_params(params, 4)
    assert stacked["qkv.weight"].shape == (4, 48, 16)
    back = pp.unstack_block_params(stacked, 4)
    assert back.keys() == {k for k in params if k.startswith("Block_")}
    for key, value in back.items():
        assert torch.equal(value, params[key]), key
    ref = jax_pp.stack_block_params(variables["params"], 4)
    np.testing.assert_array_equal(stacked["qkv.weight"].numpy(),
                                  np.swapaxes(np.asarray(ref["qkv"]["kernel"]), -1, -2))


def test_pipelined_lm_params_validates_divisibility():
    model = TransformerLM(**LM)
    bad = TransformerLM(**{**LM, "num_layers": 3})
    with fake_world():
        m = mesh.make_mesh(pipeline_parallelism=4, device_type="cpu")
        with pytest.raises(ValueError, match="not divisible"):
            pp.pipelined_lm_params(bad, bad.state_dict(), m)
        outer, stages, specs = pp.pipelined_lm_params(model, model.state_dict(), m)
    assert set(outer) == {"tok_embed.weight", "pos_embed", "LayerNorm_0.weight",
                          "LayerNorm_0.bias", "lm_head.weight", "lm_head.bias"}
    assert stages["qkv.weight"].shape == (4, 1, 48, 16)
    assert specs["stages.qkv.weight"] == ("pipe", None, None, None)
    assert specs["outer.lm_head.weight"] == (None, None)
    with pytest.raises(ValueError, match="not divisible"):
        pp.PipelinedLM(bad, 4)


def test_pp_rejects_moe_and_head_major_models():
    """A MoE LM (its blocks' parameters differ) and a head-major LM (the
    stage Block is seq-major) are refused with the reference's ValueErrors
    at every entry point."""
    moe = TransformerLM(**LM, moe_experts=4)
    head_major = TransformerLM(**LM, head_major=True)
    with fake_world():
        m = mesh.make_mesh(pipeline_parallelism=4, device_type="cpu")
        for call in (lambda: pp.pipelined_lm_params(moe, {}, m),
                     lambda: pp.make_pp_lm_forward(moe, m, num_microbatches=2),
                     lambda: pp.PipelinedLM(moe, 4)):
            with pytest.raises(ValueError, match="dense TransformerLM only"):
                call()
        with pytest.raises(ValueError, match="head_major"):
            pp.make_pp_lm_forward(head_major, m, num_microbatches=2)


def test_convert_carries_the_reference_pp_parameters():
    """The reference's {"outer", "stages"} tree from `pipelined_lm_params`
    carries onto a `PipelinedLM` by `utils/convert.py` (stacked kernels
    keep their stack dims in front) equal to the port's own split of the
    same dense weights."""
    jax, jnp = _jax()
    from tritonk8ssupervisor_tpu.parallel import pipeline as jax_pp
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    jmodel = _jax_lm()
    variables = _random_variables(jmodel, jnp.zeros((1, 16), jnp.int32), seed=5)
    outer, stages, _ = jax_pp.pipelined_lm_params(
        jmodel, variables["params"], make_mesh(pipeline_parallelism=2))
    carried = state_dict_from_flax(
        {"params": jax.device_get({"outer": outer, "stages": stages})}, _port_pp_model(2))
    model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables, model))
    ours = pp.PipelinedLM(model, 2).state_dict()
    assert carried.keys() == ours.keys()
    assert ours["stages.mlp_up.weight"].shape == (2, 2, 64, 16)
    for key, value in ours.items():
        assert torch.equal(carried[key], value), key


def test_lm_benchmark_pipeline_resumes_bit_equal(tmp_path):
    """`run_benchmark(pipeline_parallelism=2)` on 2 gloo ranks: 6 steps
    straight, and 3 steps with a checkpoint directory then 3 more in fresh
    ranks that restore them, end on the same loss and the same saved
    parameters and momentum, to the bit."""
    straight, first = tmp_path / "straight", tmp_path / "resumed"
    results = run_ranks(bench_ranks, 2, args=([(str(straight), 2, 2), (str(first), 1, 1)],),
                        timeout=TIMEOUT, threads=1)
    resumed = run_ranks(bench_ranks, 2, args=([(str(first), 1, 1)],), timeout=TIMEOUT,
                        threads=1)
    want, half = results[0]
    got = resumed[0][0]
    assert (want["final_step"], half["final_step"], got["start_step"], got["final_step"]) == (
        6, 3, 3, 6)
    assert want["pipeline_parallelism"] == 2 and want["num_microbatches"] == 2
    assert want["num_chips"] == 2 and want["global_batch"] == 4
    assert want["flops_per_step"] > 0 and np.isfinite(want["final_loss"])
    assert got["final_loss"] == want["final_loss"]
    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

    saved = {}
    for name, directory in (("straight", straight), ("resumed", first)):
        dcp_to_torch_save(directory / "6", tmp_path / f"{name}.pt")
        saved[name] = torch.load(tmp_path / f"{name}.pt")
    assert saved["straight"].keys() == saved["resumed"].keys()
    assert saved["straight"]["model.stages.qkv.weight"].shape == (2, 1, 96, 32)
    assert any(k.startswith("optimizer.stages.") for k in saved["straight"])
    for key, value in saved["straight"].items():
        assert torch.equal(saved["resumed"][key], value), key


@pytest.mark.parametrize("kwargs,message", [
    ({"sequence_parallelism": 2}, "separate strategies"),
    ({"moe_experts": 4}, "--moe-experts is not wired"),
    ({"head_major": True}, "--head-major with --pipeline-parallelism"),
    ({"grad_accum": 2}, "--grad-accum with --pipeline-parallelism"),
], ids=["sp", "moe", "head_major", "grad_accum"])
def test_lm_benchmark_refuses_what_the_reference_refuses(kwargs, message):
    """The reference's benchmark refuses the pipeline with sequence
    parallelism, MoE blocks, the head-major layout and gradient
    accumulation with ValueError; so does the port's, before any mesh."""
    with pytest.raises(ValueError, match=message):
        lm_bench.run_benchmark(**{**BENCH, "steps": 1, "windows": 1, **kwargs})
