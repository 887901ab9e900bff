"""The port's multi-rank ops against the JAX package's, on gloo ranks:
`vocab_parallel_cross_entropy` (ops/cross_entropy.py) and
`ring_attention` (ops/ring_attention.py).

The reference runs on a mesh of the conftest's virtual CPU devices with
global arrays; the port runs on 2 or 4 CPU processes of a gloo group
(`parallel/ranks.run_ranks`), each rank on its block of the same numpy
inputs, and each rank's results are held against its block of the
reference's. The rank bodies below are module-level so that the
spawned processes import them from this file; they import no JAX.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce
from tritonk8ssupervisor_tpu_torch.ops import ring_attention as ra
from tritonk8ssupervisor_tpu_torch.parallel import mesh
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks

TIMEOUT = 120.0

# ------------------------------------------------------------------ rank bodies


def vocab_parallel_ranks(logits, labels, cotangent):
    """(losses, correct, d(losses . cotangent)/d(this rank's logits)) on a
    mesh whose model axis is every rank, each holding a class block."""
    m = mesh.make_mesh(model_parallelism=torch.distributed.get_world_size(), device_type="cpu")
    block = mesh.local_shard(torch.from_numpy(logits), m, (None, "model")).requires_grad_()
    losses, correct = ce.vocab_parallel_cross_entropy(
        block, torch.from_numpy(labels), mesh.mesh_group(m, "model"))
    (losses * torch.from_numpy(cotangent)).sum().backward()
    return losses.detach(), correct, block.grad


def ring_ranks(cases):
    """For each (q, k, v, cotangent, causal, model_parallelism): this
    rank's output block and gradients of (out . cotangent) in its q, k, v
    blocks, with the spec that cut them and the count of folds."""
    out = []
    for q, k, v, ct, causal, model_parallelism, dtype in cases:
        m = mesh.make_mesh(model_parallelism=model_parallelism, device_type="cpu")
        spec = ra.sequence_sharding(m, "model", batch=q.shape[0])
        blocks = [mesh.local_shard(torch.from_numpy(x), m, spec).to(getattr(torch, dtype))
                  .requires_grad_() for x in (q, k, v)]
        folds = []
        fold = ra._fold
        ra._fold = lambda *a, **kw: folds.append(1) or fold(*a, **kw)
        try:
            o = ra.ring_attention(*blocks, mesh=m, axis_name="model", causal=causal)
        finally:
            ra._fold = fold
        ct_block = mesh.local_shard(torch.from_numpy(np.asarray(ct)), m, spec).to(o.dtype)
        (o.float() * ct_block.float()).sum().backward()
        coords = [m.get_local_rank(a) for a in mesh.AXES]
        out.append({"out": o.detach(), "grads": [b.grad for b in blocks], "spec": spec,
                    "coords": coords, "folds": len(folds)})
    return out


# ------------------------------------------------------------------ reference side


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _ref_block(x, spec, coords, sizes):
    """The block of global `x` at mesh coordinates `coords` under `spec`."""
    names = list(mesh.AXES)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        index, count = 0, 1
        for a in axes:
            index = index * sizes[names.index(a)] + coords[names.index(a)]
            count *= sizes[names.index(a)]
        x = np.split(x, count, axis=dim)[index]
    return x


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_cross_entropy_matches_the_reference(n):
    """Losses, correct flags and the gradient in each rank's logit block,
    against the reference's function under shard_map on n devices. Row 0
    ties its label's logit with a class of another shard (correct), row 1
    has the label C that no shard owns and row 2 the label -1 (both
    incorrect; their losses are the partition terms). f32 on both sides:
    1e-5 relative."""
    jax, jnp = _jax()
    from jax.sharding import PartitionSpec as P

    from tritonk8ssupervisor_tpu.ops.cross_entropy import vocab_parallel_cross_entropy
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh
    from tritonk8ssupervisor_tpu.parallel.train import shard_map

    rng = np.random.default_rng(n)
    b, c = 6, 8 * n
    logits = rng.normal(size=(b, c)).astype(np.float32)
    labels = rng.integers(0, c, size=b).astype(np.int32)
    logits[0, c - 1] = logits[0, labels[0] % (c // n)] = logits[0].max() + 1.0
    labels[0] = labels[0] % (c // n)  # in shard 0, tied with class c - 1 in the last
    labels[1], labels[2] = c, -1
    cotangent = rng.normal(size=b).astype(np.float32)

    ref_mesh = make_mesh(devices=jax.devices()[:n], model_parallelism=n)
    vp = shard_map(functools.partial(vocab_parallel_cross_entropy, axis_name="model"),
                   mesh=ref_mesh, in_specs=(P(None, "model"), P(None)),
                   out_specs=(P(None), P(None)))
    ref_losses, ref_correct = jax.jit(vp)(logits, labels)
    ref_grad = jax.jit(jax.grad(lambda x: jnp.sum(vp(x, labels)[0] * cotangent)))(logits)
    assert bool(ref_correct[0]) and not bool(ref_correct[1]) and not bool(ref_correct[2])

    results = run_ranks(vocab_parallel_ranks, n, args=(logits, labels, cotangent),
                        timeout=TIMEOUT, threads=1)
    for rank, (losses, correct, grad) in enumerate(results):
        np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(correct.numpy(), np.asarray(ref_correct))
        np.testing.assert_allclose(grad.numpy(), np.split(np.asarray(ref_grad), n, axis=1)[rank],
                                   rtol=1e-5, atol=1e-6)


def _ring_case(seed, b, s, h, d, causal, model_parallelism, dtype="float32"):
    """f32 numpy q, k, v (rounded to bf16 values for a bf16 case), an f32
    cotangent, and the case's options."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4)]
    if dtype == "bfloat16":
        arrays[:3] = [a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in arrays[:3]]
    return (*arrays, causal, model_parallelism, dtype)


RING_CASES = {
    # name: (seed, b, s, h, d, causal, model_parallelism, dtype)
    "causal zigzag": (0, 2, 16, 2, 8, True, None, "float32"),
    "causal dense fallback": (1, 2, None, 2, 8, True, None, "float32"),  # odd blocks
    "non-causal": (2, 2, 16, 2, 8, False, None, "float32"),
    "data 2 x model 2": (3, 4, 16, 2, 8, True, 2, "float32"),
    "bf16": (4, 2, 16, 2, 8, True, None, "bfloat16"),
}


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_the_reference(n):
    """Each rank's output block and its q/k/v gradient blocks against the
    reference's `ring_attention` on n devices (its mesh of the same
    degrees), for the causal zigzag schedule, the causal contiguous
    fallback (a block of odd length), the non-causal ring, data 2 x model
    2 (4 ranks only) and bf16 inputs; and the folds each rank made
    against `causal_fold_units` / `dense_fold_units`. f32: 2e-5 absolute
    on outputs and gradients (the same folds, other summation orders);
    bf16: 2e-2 (both round the output and the inputs' products to bf16)."""
    jax, jnp = _jax()
    jax_ra = importlib.import_module("tritonk8ssupervisor_tpu.ops.ring_attention")
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    names, cases = [], []
    for name, (seed, b, s, h, d, causal, mp, dtype) in RING_CASES.items():
        if mp is not None and n != 4:
            continue
        names.append(name)
        cases.append(_ring_case(seed, b, s if s is not None else 3 * n, h, d, causal,
                                mp or n, dtype))
    results = run_ranks(ring_ranks, n, args=(cases,), timeout=TIMEOUT, threads=1)

    for i, (name, (q, k, v, ct, causal, mp, dtype)) in enumerate(zip(names, cases)):
        ref_mesh = make_mesh(devices=jax.devices()[:n], model_parallelism=mp)
        q, k, v = (jnp.asarray(x, dtype=dtype) for x in (q, k, v))

        def objective(q, k, v):
            out = jax_ra.ring_attention(q, k, v, mesh=ref_mesh, axis_name="model",
                                        causal=causal)
            return jnp.sum(out.astype(jnp.float32) * ct), out

        (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        sizes = [dict(ref_mesh.shape)[a] for a in mesh.AXES]
        blk = q.shape[1] // mp
        zigzag = causal and blk % 2 == 0
        for rank, rank_results in enumerate(results):
            r = rank_results[i]
            want = [np.asarray(x.astype(jnp.float32)) for x in (ref_out, *ref_grads)]
            got = [r["out"]] + r["grads"]
            for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
                np.testing.assert_allclose(
                    g.float().numpy(), _ref_block(w, r["spec"], r["coords"], sizes),
                    rtol=tol, atol=tol, err_msg=f"{name}, rank {rank}, {label}")
            if zigzag:
                assert r["folds"] == ra.causal_fold_units(mp) == jax_ra.causal_fold_units(mp)
            else:
                assert 4 * r["folds"] == ra.dense_fold_units(mp) == jax_ra.dense_fold_units(mp)
    assert ra.causal_fold_units(8) / ra.dense_fold_units(8) == pytest.approx(17 / 32)


def test_sequence_sharding_and_batch_axis_resolution():
    """`sequence_sharding`'s spec and `_resolve_batch_axis` against the
    reference's on the same mesh shapes (a batch the joint axes do not
    divide falls back to data, then to none)."""
    jax, _ = _jax()
    jax_ra = importlib.import_module("tritonk8ssupervisor_tpu.ops.ring_attention")
    from tritonk8ssupervisor_tpu.parallel.mesh import make_mesh

    class Shape:  # the mesh's axis names and sizes are all the resolver reads
        def __init__(self, ref):
            self.mesh_dim_names = tuple(ref.axis_names)
            self.shape = tuple(ref.shape[a] for a in ref.axis_names)

    for kwargs in ({"model_parallelism": 2}, {"model_parallelism": 2, "expert_parallelism": 2},
                   {"model_parallelism": 8}):
        ref = make_mesh(**kwargs)
        for batch in (None, 8, 4, 2, 1):
            want = jax_ra._resolve_batch_axis(ref, "model", "auto", batch)
            assert ra._resolve_batch_axis(Shape(ref), "model", "auto", batch) == want
            assert ra.sequence_sharding(Shape(ref), "model", batch=batch) == \
                tuple(jax_ra.sequence_sharding(ref, "model", batch=batch).spec)
