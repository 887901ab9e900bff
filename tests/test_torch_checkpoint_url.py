"""`TrainCheckpointer` at a URL (`parallel/checkpoint.py`): DCP's fsspec
writer and reader under the reference's URL rule, no sidecar markers and a
step committed by its DCP `.metadata`. On fsspec's in-process `memory://`
file system: save, restore, pruning to `max_to_keep`, the fall-back past a
torn step (and past one in a local directory), and `latest_step` ignoring
a step without its metadata; on a
`file://` URL, a save by 2 gloo ranks restored by 2 ranks. No bucket is
reachable from the test machines, so a real `gs://` save is not run here."""

import uuid

import fsspec
import pytest
import torch

from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.parallel.checkpoint import TrainCheckpointer

LM = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32, max_seq_len=16)


def _state(seed: int = 0, mesh=None):
    model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(seed))
    return train.create_train_state(model, train.default_optimizer(0.05), "cpu", mesh=mesh)


def _tokens(i: int) -> torch.Tensor:
    return torch.randint(0, 64, (8, 16), generator=torch.Generator().manual_seed(i))


def _values(state) -> dict:
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        out[f"momentum.{name}"] = state.optimizer.state[p]["momentum_buffer"].clone()
    return out


def _assert_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.fixture
def memory_url():
    root = f"/tk8s-ckpt-{uuid.uuid4().hex}"
    yield f"memory://{root}/run"
    fs = fsspec.filesystem("memory")
    if fs.exists(root):
        fs.rm(root, recursive=True)


def test_save_restore_and_prune_on_a_memory_url(memory_url):
    """Four saves keep the newest two, no marker directory is written, and a
    fresh state restores the latest step's values bit for bit, or an older
    kept step's when asked."""
    fs = fsspec.filesystem("memory")
    state = _state()
    ckpt = TrainCheckpointer(memory_url, max_to_keep=2)
    assert ckpt.latest_step() is None
    saved = {}
    step = train.make_lm_train_step(state)
    for i in range(4):
        step(_tokens(i))
        ckpt.save(state.step, state)
        saved[state.step] = _values(state)
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    root = memory_url.removeprefix("memory://")
    assert sorted(p.rsplit("/", 1)[-1] for p in fs.ls(root, detail=False)) == ["3", "4"]  # no markers
    assert fs.exists(f"{root}/4/.metadata")
    fresh = TrainCheckpointer(memory_url).restore(_state(seed=9))
    assert fresh.step == 4
    _assert_equal(_values(fresh), saved[4])
    older = TrainCheckpointer(memory_url).restore(_state(seed=9), step=3)
    assert older.step == 3
    _assert_equal(_values(older), saved[3])
    # training continues from the restored state as from the saved one
    train.make_lm_train_step(fresh)(_tokens(4))
    step(_tokens(4))
    _assert_equal(_values(fresh), _values(state))


@pytest.mark.parametrize("where", ["memory_url", "local_dir"])
def test_a_torn_step_falls_back_to_the_previous_one(where, memory_url, tmp_path):
    """The latest step's metadata (and, in a local directory, its marker) is
    there but its data is torn: the restore reads the step before it. DCP
    raises a failed read inside its load as a CheckpointException, which is
    not an Exception; the checkpointer raises it as a RuntimeError, which
    the fall-back catches."""
    location = memory_url if where == "memory_url" else str(tmp_path / "ckpt")
    fs, root = fsspec.core.url_to_fs(location)
    state = _state()
    ckpt = TrainCheckpointer(location)
    step = train.make_lm_train_step(state)
    step(_tokens(0))
    ckpt.save(state.step, state)
    want = _values(state)
    step(_tokens(1))
    ckpt.save(state.step, state)
    for path in fs.find(f"{root}/2"):
        if not path.endswith(".metadata"):
            with fs.open(path, "wb") as f:
                f.write(b"x")
    assert ckpt.latest_step() == 2
    restored = TrainCheckpointer(location).restore(_state(seed=9))
    assert restored.step == 1
    _assert_equal(_values(restored), want)


def test_latest_step_ignores_a_step_without_metadata(memory_url):
    """DCP writes `.metadata` last: a step directory without it is a save
    that never finished, not the latest step."""
    fs = fsspec.filesystem("memory")
    state = _state()
    ckpt = TrainCheckpointer(memory_url)
    train.make_lm_train_step(state)(_tokens(0))
    ckpt.save(state.step, state)
    root = memory_url.removeprefix("memory://")
    fs.makedirs(f"{root}/7", exist_ok=True)
    fs.pipe(f"{root}/7/__0_0.distcp", b"partial")
    assert ckpt.all_steps() == [1, 7]
    assert ckpt.latest_step() == 1
    assert TrainCheckpointer(memory_url).restore(_state(seed=9)).step == 1


def save_and_restore_on_two(url: str) -> dict:
    """One rank of 2 on a data-parallel mesh: two steps, a save at each, then
    a fresh state restored from the URL."""
    from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
    from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

    mesh = mesh_lib.make_mesh(device_type="cpu")
    state = _state(mesh=mesh)
    ckpt = TrainCheckpointer(url)
    step = train.make_lm_train_step(state)
    for i in range(2):
        step(batch_shard(mesh, _tokens(i)))
        ckpt.save(state.step, state)
    restored = TrainCheckpointer(url).restore(_state(seed=9, mesh=mesh))
    return {"saved": _values(state), "restored": _values(restored), "step": restored.step,
            "latest": ckpt.latest_step()}


def test_two_ranks_save_and_restore_on_a_file_url(tmp_path):
    from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks

    url = f"file://{tmp_path}/ckpt"
    ranks = run_ranks(save_and_restore_on_two, 2, args=(url,), timeout=240.0, threads=1)
    for rank in ranks:
        assert (rank["step"], rank["latest"]) == (2, 2)
        _assert_equal(rank["restored"], rank["saved"])
    _assert_equal(ranks[0]["saved"], ranks[1]["saved"])
    assert sorted(p.name for p in (tmp_path / "ckpt" / "2").iterdir()) == [
        ".metadata", "__0_0.distcp", "__1_0.distcp"]
    assert not (tmp_path / "ckpt" / ".tk8s-complete").exists()
