"""The port's mesh (`parallel/mesh.py`), cluster coordinates
(`parallel/distributed.py`) and input sharding (`utils/data.py`) against
the JAX package's, on layouts only.

The port's meshes here are `DeviceMesh`es of 8 ranks built in this one
process on torch's fake process group (no collective runs), one rank at
a time; the reference's are meshes of the conftest's 8 virtual CPU
devices. Everything is compared exactly: ranks, shapes, specs, rows.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from torch.testing._internal.distributed.fake_pg import FakeStore

from tritonk8ssupervisor_tpu.models import ResNet18 as JaxResNet18
from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
from tritonk8ssupervisor_tpu.parallel import distributed as jax_distributed
from tritonk8ssupervisor_tpu.parallel import mesh as jax_mesh
from tritonk8ssupervisor_tpu_torch.models import ResNet18, TransformerLM
from tritonk8ssupervisor_tpu_torch.parallel import distributed, mesh
from tritonk8ssupervisor_tpu_torch.utils import data

WORLD = 8


@contextlib.contextmanager
def fake_world(rank: int, world: int = WORLD):
    """This process as rank `rank` of a fake process group of `world`."""
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shape(m):
    return dict(zip(m.mesh_dim_names, m.shape))


def test_make_mesh_shapes_and_errors_match_the_reference():
    cases = [{}, {"model_parallelism": 2}, {"model_parallelism": 2, "expert_parallelism": 2},
             {"pipeline_parallelism": 4}]
    with fake_world(3):
        for kwargs in cases:
            ours = mesh.make_mesh(device_type="cpu", **kwargs)
            ref = jax_mesh.make_mesh(**kwargs)
            assert _shape(ours) == dict(ref.shape), kwargs
            # rank r sits where the reference's device r sits
            np.testing.assert_array_equal(
                ours.mesh.numpy(), np.vectorize(lambda d: d.id)(ref.devices))
        for bad in ({"model_parallelism": 3}, {"model_parallelism": 0},
                    {"model_parallelism": 2, "expert_parallelism": 2,
                     "pipeline_parallelism": 4}):
            with pytest.raises(ValueError, match="do not divide device count 8"):
                mesh.make_mesh(device_type="cpu", **bad)
            with pytest.raises(ValueError, match="do not divide"):
                jax_mesh.make_mesh(**bad)
    # without a process group the world is one rank: a degree of 2 is refused
    with pytest.raises(ValueError, match="do not divide device count 1"):
        mesh.make_mesh(model_parallelism=2, device_type="cpu")


def test_batch_axes_degree_and_this_ranks_coordinates():
    with fake_world(5):
        m = mesh.make_mesh(model_parallelism=2, expert_parallelism=2, device_type="cpu")
        ref = jax_mesh.make_mesh(model_parallelism=2, expert_parallelism=2)
        assert mesh.batch_axes(m) == jax_mesh.batch_axes(ref) == ("data", "expert")
        assert mesh.batch_degree(m) == jax_mesh.batch_degree(ref) == 4
        # rank 5 = (data 1, expert 0, pipe 0, model 1): batch shard 2 of 4
        assert [m.get_local_rank(a) for a in mesh.AXES] == [1, 0, 0, 1]
        assert mesh.axis_index(m, ("data", "expert")) == 2
        assert sorted(dist.get_process_group_ranks(mesh.mesh_group(m, ("data", "expert")))) \
            == [1, 3, 5, 7]


def test_cross_slice_mesh_layout_matches_the_reference():
    with fake_world(0):
        ours = mesh.make_cross_slice_mesh(num_slices=2, model_parallelism=2, device_type="cpu")
        ref = jax_mesh.make_cross_slice_mesh(num_slices=2, model_parallelism=2)
        assert _shape(ours) == dict(ref.shape)
        np.testing.assert_array_equal(ours.mesh.numpy(),
                                      np.vectorize(lambda d: d.id)(ref.devices))
        assert mesh.slice_groups(num_slices=4) == [[0, 1], [2, 3], [4, 5], [6, 7]]
        with pytest.raises(ValueError, match="straddle"):
            mesh.make_cross_slice_mesh(num_slices=2, model_parallelism=8, device_type="cpu")
        with pytest.raises(ValueError, match="equal slices"):
            mesh.make_cross_slice_mesh(num_slices=3, device_type="cpu")
        with pytest.raises(ValueError, match="pass num_slices"):
            mesh.make_cross_slice_mesh(device_type="cpu")


class _Tagged:
    def __init__(self, slice_index):
        self.slice_index = slice_index


def test_slice_groups_follow_slice_tags():
    devices = [_Tagged(s) for s in (1, 0, 1, 0)]
    groups = mesh.slice_groups(devices)
    assert [[d.slice_index for d in g] for g in groups] == [[0, 0], [1, 1]]
    assert not mesh._hardware_multislice([_Tagged(0), _Tagged(0)])
    assert not mesh._hardware_multislice([0, 1])  # ranks carry no tags
    with pytest.raises(ValueError, match="caller asked for 3"):
        mesh.slice_groups(devices, num_slices=3)


def _cross_slice_env(monkeypatch, slices: int):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", str(slices))
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    monkeypatch.setenv("TK8S_NUM_SLICES", str(slices))
    monkeypatch.setenv("TK8S_SLICE_ID", "0")
    monkeypatch.setenv("TK8S_PROCS_PER_SLICE", "1")


def test_workload_mesh_reads_the_cluster_environment(monkeypatch):
    with fake_world(0):
        plain = mesh.make_workload_mesh(model_parallelism=2, device_type="cpu")
        assert _shape(plain) == {"data": 4, "expert": 1, "pipe": 1, "model": 2}
        _cross_slice_env(monkeypatch, 2)
        crossed = mesh.make_workload_mesh(model_parallelism=4, device_type="cpu")
        ref = jax_mesh.make_workload_mesh(model_parallelism=4)
        np.testing.assert_array_equal(crossed.mesh.numpy(),
                                      np.vectorize(lambda d: d.id)(ref.devices))
        _cross_slice_env(monkeypatch, 3)  # 8 ranks do not split into 3 slices
        with pytest.raises(ValueError, match="equal slices"):
            mesh.make_workload_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="equal slices"):
            jax_mesh.make_workload_mesh()


ENVIRONS = [
    {},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "2"},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "1", "TK8S_NUM_SLICES": "2", "TK8S_SLICE_ID": "1",
     "TK8S_PROCS_PER_SLICE": "2"},
    {"JAX_COORDINATOR_ADDRESS": "x:1"},  # incomplete
    {"JAX_COORDINATOR_ADDRESS": "x:1", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "0",
     "TK8S_NUM_SLICES": "2", "TK8S_SLICE_ID": "2", "TK8S_PROCS_PER_SLICE": "2"},
    {"JAX_COORDINATOR_ADDRESS": "x:1", "JAX_NUM_PROCESSES": "3", "JAX_PROCESS_ID": "0",
     "TK8S_NUM_SLICES": "2", "TK8S_SLICE_ID": "0", "TK8S_PROCS_PER_SLICE": "2"},
]


def _resolve(fn, environ, env_file):
    try:
        return fn(environ, env_file=env_file)
    except RuntimeError as e:
        return type(e), str(e).split(":")[0]


@pytest.mark.parametrize("environ", ENVIRONS)
def test_cluster_env_matches_the_reference(environ, tmp_path):
    absent = tmp_path / "absent"
    ours = _resolve(distributed.cluster_env, environ, absent)
    ref = _resolve(jax_distributed.cluster_env, environ, absent)
    if ref is None or isinstance(ref, tuple):
        assert ours == ref
    else:
        assert ours.__dict__ == ref.__dict__
        assert (ours.global_process_id, ours.is_multi_slice, ours.is_multi_host) == \
            (ref.global_process_id, ref.is_multi_slice, ref.is_multi_host)


def test_init_from_launcher_joins_only_a_launched_group():
    """A single process (no WORLD_SIZE, or 1) joins nothing; neither does a
    process already in a group."""
    assert not distributed.init_from_launcher({})
    assert not distributed.init_from_launcher({"WORLD_SIZE": "1"})
    with fake_world(0):
        assert not distributed.init_from_launcher({"WORLD_SIZE": "8"})


def test_cluster_env_file_is_overlaid_by_the_process_environment(tmp_path):
    env_file = tmp_path / "tpu-cluster.env"
    env_file.write_text("# generated\nJAX_COORDINATOR_ADDRESS=10.0.0.9:8476\n"
                        "JAX_NUM_PROCESSES=2\nJAX_PROCESS_ID=1\n")
    for environ in ({}, {"JAX_COORDINATOR_ADDRESS": "10.9.9.9:9999"}):
        assert distributed.cluster_env(environ, env_file=env_file).__dict__ == \
            jax_distributed.cluster_env(environ, env_file=env_file).__dict__


# ---------------------------------------------------------------- sharding rules


def _flax_path_to_torch(path) -> str:
    """The port's parameter name for a flax params path (utils/convert.py)."""
    *modules, leaf = path
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)
    return ".".join(modules + [leaf])


def _spec_in_torch_order(spec, shape, leaf):
    """A reference PartitionSpec over a flax param, in the torch layout
    of the same parameter (HWIO -> OIHW, (in, out) -> (out, in))."""
    full = list(spec) + [None] * (len(shape) - len(spec))
    if leaf == "kernel" and len(shape) == 4:
        full = [full[3], full[2], full[0], full[1]]
    elif leaf == "kernel" and len(shape) == 2:
        full = [full[1], full[0]]
    return tuple(full)


def _reference_specs(jmodel, sample, ref_mesh):
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), sample, train=False))
    shardings = jax_mesh.param_shardings(shapes["params"], ref_mesh)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]:
        keys = [p.key for p in path]
        leaf_shape = shapes["params"]
        for k in keys:
            leaf_shape = leaf_shape[k]
        out[_flax_path_to_torch(keys)] = _spec_in_torch_order(sh.spec, leaf_shape.shape, keys[-1])
    return out


LM = dict(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128, max_seq_len=32)


@pytest.mark.parametrize("family", ["resnet", "lm", "moe_lm"])
def test_param_shardings_name_the_reference_axes(family):
    """Every parameter's spec, model 2 x expert 2 on 8 ranks, against the
    reference's PartitionSpec for the same parameter: the classifier,
    wide convolutions, embeddings, projections and expert tensors are
    sharded at these widths (at least 2^16 elements), the rest not."""
    if family == "resnet":
        jmodel, model = JaxResNet18(num_classes=512, num_filters=16), \
            ResNet18(num_classes=512, num_filters=16)
        sample = jnp.zeros((1, 32, 32, 3))
    else:
        moe = {"moe_experts": 4} if family == "moe_lm" else {}
        jmodel, model = JaxLM(**LM, **moe), TransformerLM(**LM, **moe)
        sample = jnp.zeros((1, 8), jnp.int32)
    ref_mesh = jax_mesh.make_mesh(model_parallelism=2, expert_parallelism=2)
    expected = _reference_specs(jmodel, sample, ref_mesh)
    with fake_world(0):
        ours = mesh.param_shardings(
            model, mesh.make_mesh(model_parallelism=2, expert_parallelism=2,
                                  device_type="cpu"))
    assert ours == expected
    sharded = {k for k, v in ours.items() if any(v)}
    assert sharded, "nothing sharded: the widths are below the rule's size"
    if family == "moe_lm":
        assert ours["Block_1.moe_mlp.expert_up_kernel"] == ("expert", None, "model")
        assert ours["Block_1.moe_mlp.expert_up_bias"] == ("expert", None)
    if family == "resnet":
        assert ours["classifier.weight"] == ("model", None)


# ---------------------------------------------------------------- input sharding


def test_batch_shards_follow_the_reference_batch_sharding():
    """Rank r's rows of a global batch are the rows the reference's
    `batch_sharding` puts on device r, for every rank of data 2 x expert 2
    x model 2; `prefetch_to_mesh` yields them, `global_batch_from_local`
    places a rank's own rows."""
    ref_mesh = jax_mesh.make_mesh(model_parallelism=2, expert_parallelism=2)
    images = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    placed = jax.device_put(images, jax_mesh.batch_sharding(ref_mesh, ndim=2))
    ref_rows = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    for rank in range(WORLD):
        with fake_world(rank):
            m = mesh.make_mesh(model_parallelism=2, expert_parallelism=2, device_type="cpu")
            np.testing.assert_array_equal(data.batch_shard(m, images), ref_rows[rank])
            batches = [{"x": images, "y": np.arange(8)}, {"x": images + 1, "y": np.arange(8)}]
            got = list(data.prefetch_to_mesh(iter(batches), m, size=1))
            assert len(got) == 2
            np.testing.assert_array_equal(got[1]["x"].numpy(), ref_rows[rank] + 1)
            assert got[0]["y"].shape == (2,) and got[0]["x"].device.type == "cpu"
            local = data.global_batch_from_local(m, (ref_rows[rank],))
            assert isinstance(local, tuple) and torch.equal(local[0],
                                                            torch.tensor(ref_rows[rank]))
            with pytest.raises(ValueError, match="prefetch size"):
                next(data.prefetch_to_mesh(iter(batches), m, size=0))
