"""Sequence parallelism over mixture-of-experts blocks (models/moe.py)
against the JAX package, which ranks the slots with one cumsum over the
whole sequence: `top_k_dispatch` on contiguous sequence shards over gloo
ranks equal to the reference's on the whole sequence, and the MoE LM's
train step with the sequence over "model" against the reference's on its
virtual CPU devices (ring attention, the router losses over every token).
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_mesh_train import (
    ATOL,
    LM,
    RTOL,
    SGD,
    _assert_rank_matches,
    _expected,
    _port_optimizer,
    _random_variables,
    _rank_view,
    _reference_step,
    _torch_state,
)

from tritonk8ssupervisor_tpu_torch.models import TransformerLM, moe
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import ring_attention
from tritonk8ssupervisor_tpu_torch.parallel import mesh, train
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

TIMEOUT = 240.0
SHARDS = 4
# (k, capacity factor) over a (2, 16, 4) router: at 0.5 and 1.0 the
# capacity drops choices, so a shard's second-choice slots start after
# every shard's first choices
DISPATCH_CASES = [(1, 0.5), (1, 1.0), (2, 0.5), (2, 1.0), (2, 2.0)]
# combine against the reference's: the same f32 gate arithmetic
COMBINE_ATOL = 1e-6
# the MoE LM's second block: 4 experts, k 2, a capacity that drops
MOE = dict(moe_experts=4, moe_capacity_factor=0.5)


def _router_probs(k, cf):
    logits = np.random.default_rng(int(10 * cf) + k).normal(size=(2, 16, 4)) * 2.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def dispatch_ranks():
    """Every case of DISPATCH_CASES on this rank's shard of the sequence
    (model 4): its dispatch, combine and first-choice mask."""
    m = mesh.make_mesh(model_parallelism=SHARDS, device_type="cpu")
    group = mesh.mesh_group(m, "model")
    out = []
    for k, cf in DISPATCH_CASES:
        probs = _router_probs(k, cf)
        capacity = moe.compute_capacity(probs.shape[1], 4, k, cf)
        local = mesh.local_shard(torch.from_numpy(probs), m, (None, "model", None))
        out.append(moe.top_k_dispatch(local, k, capacity, seq_group=group))
    return out


def seq_moe_ranks(sd, tokens):
    """One step of the MoE LM of state dict `sd` with the sequence over
    "model" (2 shards, ring attention), then the eval step."""
    m = mesh.make_mesh(model_parallelism=2, device_type="cpu")
    model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32, moe_mesh=m,
                          attention_fn=functools.partial(ring_attention, mesh=m,
                                                         axis_name="model"), **MOE)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = train.create_train_state(model, _port_optimizer(SGD), mesh=m)
    local = mesh.local_shard(batch_shard(m, torch.from_numpy(tokens)), m, (None, "model"))
    metrics = train.make_lm_train_step(state, seq_axis="model")(local)
    metrics["eval"] = train.make_lm_eval_step(state, seq_axis="model")(local)
    return {"metrics": metrics, **_rank_view(state)}


@pytest.fixture(scope="module")
def dispatched():
    return run_ranks(dispatch_ranks, SHARDS, timeout=TIMEOUT, threads=1)


@pytest.mark.parametrize("case", range(len(DISPATCH_CASES)),
                         ids=[f"k{k}_cf{cf}" for k, cf in DISPATCH_CASES])
def test_sharded_dispatch_equals_the_reference_on_the_whole_sequence(dispatched, case):
    """The shards' dispatch, laid end to end, is the reference's on the
    whole sequence to the bit (every slot and drop), the combine within
    1e-6, with the capacity of the whole length."""
    from tritonk8ssupervisor_tpu.models import moe as jax_moe

    k, cf = DISPATCH_CASES[case]
    probs = _router_probs(k, cf)
    capacity = jax_moe.compute_capacity(16, 4, k, cf)
    want = [np.asarray(a) for a in jax_moe.top_k_dispatch(probs, k, capacity)]
    got = [torch.cat([r[case][i] for r in dispatched], dim=1).numpy() for i in range(3)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=COMBINE_ATOL)
    np.testing.assert_array_equal(got[2], want[2])
    if cf < 2.0:
        assert want[0].sum() < probs.shape[0] * probs.shape[1] * k  # the capacity dropped


def _seq_moe_case(ranks, batch, seed):
    """The MoE LM (its second block 4 experts, k 2, capacity factor 0.5)
    with the sequence over "model" (2 shards): the reference's step and
    eval on `ranks` virtual devices, the port's on as many gloo ranks."""
    import jax
    import jax.numpy as jnp

    from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
    from tritonk8ssupervisor_tpu.ops.ring_attention import ring_attention as jax_ring
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    ref_mesh = make_mesh(devices=jax.devices()[:ranks], model_parallelism=2)

    def attention_fn(q, k, v, causal=True):
        return jax_ring(q, k, v, mesh=ref_mesh, axis_name="model", causal=causal)

    jmodel = JaxLM(**LM, dtype=jnp.float32, logits_dtype=jnp.float32, moe_mesh=ref_mesh,
                   attention_fn=attention_fn, **MOE)
    variables = _random_variables(jmodel, jnp.zeros((1, 16), jnp.int32), seed)
    tokens = np.random.default_rng(seed + 1).integers(0, 64, (batch, 16)).astype(np.int32)
    new, jmetrics, jeval = _reference_step(jmodel, variables, ref_mesh, [(tokens,)], SGD,
                                           lm=True, seq_axis="model")
    # the router losses of the first forward, over every token
    dense = JaxLM(**LM, dtype=jnp.float32, logits_dtype=jnp.float32, **MOE)
    _, sown = dense.apply(variables, tokens, train=True, mutable=["moe_losses"])
    router = sum(float(x) for x in jax.tree_util.tree_leaves(sown))
    port_model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32, **MOE)
    sd = _torch_state(variables, port_model)
    results = run_ranks(seq_moe_ranks, ranks, args=(sd, tokens), timeout=TIMEOUT, threads=1)
    sizes = [dict(ref_mesh.shape)[a] for a in mesh.AXES]
    return results, _expected(new, port_model), jmetrics, jeval, router, sizes


@pytest.mark.parametrize("ranks,batch", [(2, 2), (4, 4)], ids=["model2", "data2_model2"])
def test_sequence_parallel_moe_lm_step_matches_the_reference(ranks, batch):
    """model 2 (2 ranks) and data 2 x model 2 (4 ranks): each shard's
    slots offset by the other shards' counts, the capacity of the whole
    sequence, the router losses reduced over the batch axes and "model";
    the loss, the accuracy, the router loss, every parameter after the
    step and the eval step after it against the reference's."""
    results, expected, jmetrics, jeval, router, sizes = _seq_moe_case(ranks, batch, 100 + ranks)
    for rank, result in enumerate(results):
        _assert_rank_matches(rank, result, expected, jmetrics, sizes)
        np.testing.assert_allclose(float(result["metrics"]["router_loss"]), router,
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {rank} router loss")
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(float(result["metrics"]["eval"][key]), float(jeval[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"rank {rank} eval {key}")
