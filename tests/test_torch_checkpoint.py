"""The port's checkpointing (`parallel/checkpoint.py`, on
torch.distributed.checkpoint): every case of tests/test_checkpoint.py
but the resized-mesh restore (tests/test_torch_mesh_checkpoint.py), and a
resumed run bit-equal to one that never stopped.

The round trip, an unmarked torn step skipped, a marked but torn step
falling back, a directory without markers, a restore with nothing to
restore, pruning by `max_to_keep`, `gs://` kept as it is (and a URL
opened through fsspec: tests/test_torch_checkpoint_url.py), and both
benchmarks resuming from their `checkpoint_dir`. All on the CPU, in one process.
"""

import shutil

import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu_torch.benchmarks import lm
from tritonk8ssupervisor_tpu_torch.benchmarks.resnet50 import run_benchmark
from tritonk8ssupervisor_tpu_torch.models import ResNet18, TransformerLM
from tritonk8ssupervisor_tpu_torch.parallel import checkpoint as ckpt_lib
from tritonk8ssupervisor_tpu_torch.parallel import train
from tritonk8ssupervisor_tpu_torch.parallel.checkpoint import (
    COMMIT_DIR,
    TrainCheckpointer,
    resolve_checkpoint_dir,
)

LM_CONFIG = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=16,
                 dtype=torch.float32, logits_dtype=torch.float32)


def _resnet_state():
    model = ResNet18(num_classes=16, num_filters=8, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0))
    return train.create_train_state(model, train.default_optimizer(0.1), device="cpu")


def _resnet_batch():
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(8, 32, 32, 3, generator=gen),
            torch.randint(0, 16, (8,), generator=gen))


def _toy_state(step, fill):
    """A one-parameter state: the crash-safety contract does not depend
    on the model."""
    model = torch.nn.Linear(4, 4, bias=False)
    torch.nn.init.constant_(model.weight, fill)
    state = train.create_train_state(model, train.default_optimizer(), device="cpu")
    state.step = step
    return state


def _tear(step_dir):
    """A save a crash tore mid-write: every file of the step cut to junk."""
    for f in step_dir.rglob("*"):
        if f.is_file() and f.stat().st_size > 0:
            f.write_bytes(b"x")


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for index in sa:
        for key in sa[index]:
            torch.testing.assert_close(sa[index][key], sb[index][key], rtol=0, atol=0)


def test_save_restore_round_trip(tmp_path):
    state = _resnet_state()
    step = train.make_train_step(state)
    x, y = _resnet_batch()
    step(x, y)
    step(x, y)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(state.step, state)
    assert ckpt.latest_step() == 2
    assert (tmp_path / "ckpt" / COMMIT_DIR / "2").read_text() == "2\n"

    restored = _resnet_state()  # fresh weights, no momentum, step 0
    assert ckpt.restore(restored) is restored
    ckpt.close()
    _assert_states_equal(restored, state)  # BatchNorm statistics and momentum too
    train.make_train_step(restored)(x, y)  # training continues from the step
    assert restored.step == 3


def test_unmarked_torn_step_is_skipped_on_restore(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, _toy_state(1, 1.0))
    ckpt.save(2, _toy_state(2, 7.0))
    assert ckpt.latest_step() == 2
    ckpt.close()
    (tmp_path / "ckpt" / COMMIT_DIR / "2").unlink()  # killed mid-save: no marker
    _tear(tmp_path / "ckpt" / "2")

    reopened = TrainCheckpointer(tmp_path / "ckpt")
    assert reopened.latest_step() == 1
    restored = reopened.restore(_toy_state(0, 0.0))
    assert restored.step == 1
    torch.testing.assert_close(restored.model.weight, torch.full((4, 4), 1.0))


def test_marked_but_torn_step_falls_back_on_restore(tmp_path, capsys):
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, _toy_state(1, 1.0))
    ckpt.save(2, _toy_state(2, 7.0))
    _tear(tmp_path / "ckpt" / "2")  # marker intact

    restored = TrainCheckpointer(tmp_path / "ckpt").restore(_toy_state(0, 0.0))
    assert restored.step == 1
    torch.testing.assert_close(restored.model.weight, torch.full((4, 4), 1.0))
    assert "checkpoint step 2 unreadable" in capsys.readouterr().out


def test_legacy_checkpoints_without_markers_stay_restorable(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, _toy_state(1, 3.0))
    ckpt.close()
    shutil.rmtree(tmp_path / "ckpt" / COMMIT_DIR)

    reopened = TrainCheckpointer(tmp_path / "ckpt")
    assert reopened.latest_step() == 1
    assert reopened.restore(_toy_state(0, 0.0)).step == 1


def test_restore_without_a_checkpoint_raises(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "empty")
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_toy_state(0, 0.0))


def test_max_to_keep_prunes_old_steps(tmp_path):
    state = _resnet_state()
    step = train.make_train_step(state)
    x, y = _resnet_batch()
    ckpt = TrainCheckpointer(tmp_path / "ckpt", max_to_keep=2)
    for _ in range(4):
        step(x, y)
        ckpt.save(state.step, state)
    assert ckpt.latest_step() == 4
    assert ckpt.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "ckpt" / COMMIT_DIR).iterdir()) == ["3", "4"]


def test_resolve_checkpoint_dir_keeps_gcs_urls_and_the_checkpointer_refuses_them():
    assert resolve_checkpoint_dir("gs://bucket/ckpt") == "gs://bucket/ckpt"
    local = resolve_checkpoint_dir("relative/ckpt")
    assert local.is_absolute()
    # a URL is no longer refused: the checkpointer opens it through fsspec
    # (memory:// here; tests/test_torch_checkpoint_url.py saves and restores)
    import fsspec

    url = "memory://tk8s-resolve-test/ckpt"
    try:
        ckpt = TrainCheckpointer(url)
        assert ckpt.all_steps() == [] and ckpt.latest_step() is None
    finally:
        fsspec.filesystem("memory").rm("/tk8s-resolve-test", recursive=True)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_a_resumed_run_is_bit_equal_to_one_that_never_stopped(tmp_path, optimizer):
    """N steps straight against k steps, a save, a restore into a fresh
    state (new model, new optimizer), and N - k more: bit for bit, the
    optimizer's moments and AdamW's schedule count included."""
    tx = (train.default_optimizer(0.1) if optimizer == "sgd" else
          train.lm_optimizer(learning_rate=1e-2, warmup_steps=2, decay_steps=10))
    tokens = [torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(i))
              for i in range(4)]

    def fresh(seed):
        model = TransformerLM(**LM_CONFIG, moe_experts=4,
                              generator=torch.Generator().manual_seed(seed))
        return train.create_train_state(model, tx, device="cpu")

    straight = fresh(0)
    step = train.make_lm_train_step(straight)
    for t in tokens:
        step(t)

    first = fresh(0)
    step = train.make_lm_train_step(first)
    for t in tokens[:2]:
        step(t)
    TrainCheckpointer(tmp_path / "ckpt").save(first.step, first)
    resumed = TrainCheckpointer(tmp_path / "ckpt").restore(fresh(1))
    assert resumed.step == 2
    if optimizer == "adamw":
        assert resumed.optimizer.count == 2
    step = train.make_lm_train_step(resumed)
    for t in tokens[2:]:
        step(t)
    _assert_states_equal(resumed, straight)


def test_lm_benchmark_resume_round_trip(tmp_path):
    kwargs = dict(vocab_size=128, num_layers=1, num_heads=2, embed_dim=64, seq_len=32,
                  batch_per_data_shard=2, steps=2, warmup=1, windows=1, device="cpu",
                  checkpoint_dir=str(tmp_path / "lm-ckpt"))
    first = lm.run_benchmark(**kwargs)
    assert first["start_step"] == 0
    assert first["final_step"] == 4  # a counted step, a warm-up step, a window of two
    second = lm.run_benchmark(**kwargs)
    assert second["start_step"] == first["final_step"]
    assert second["final_step"] == first["final_step"] + 4
    assert second["restore_seconds"] > 0 and np.isfinite(second["final_loss"])
    assert TrainCheckpointer(tmp_path / "lm-ckpt").all_steps() == [4, 8]


def test_image_benchmark_saves_at_every_window_and_resumes(tmp_path):
    kwargs = dict(model_name="resnet18", batch_per_chip=2, image_size=32, num_classes=10,
                  steps=1, warmup=1, windows=2, device="cpu",
                  checkpoint_dir=str(tmp_path / "ckpt"))
    first = run_benchmark(**kwargs)
    assert (first["start_step"], first["final_step"]) == (0, 4)
    assert TrainCheckpointer(tmp_path / "ckpt").all_steps() == [3, 4]  # one a window
    second = run_benchmark(**kwargs)
    assert (second["start_step"], second["final_step"]) == (4, 8)


def test_drain_stops_after_the_window_save(tmp_path, monkeypatch, capsys):
    drain = tmp_path / "drain"
    drain.write_text("host maintenance\n")
    monkeypatch.setenv("TK8S_DRAIN_FILE", str(drain))
    result = run_benchmark(model_name="resnet18", batch_per_chip=2, image_size=32,
                           num_classes=10, steps=1, warmup=1, windows=3, device="cpu",
                           checkpoint_dir=str(tmp_path / "ckpt"))
    assert result["drained"] == "host maintenance" and result["final_step"] == 3
    assert TrainCheckpointer(tmp_path / "ckpt").latest_step() == 3
    assert "checkpoint saved" in capsys.readouterr().out


def test_maybe_restore_without_a_directory_is_a_no_op():
    state = _toy_state(5, 1.0)
    assert ckpt_lib.maybe_restore(None, state) == (None, state, 0, 0.0)
    assert ckpt_lib.window_save_hook(None, state) is None
    ckpt_lib.save_and_close(None, state)
