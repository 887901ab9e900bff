"""Elastic training in the port (`parallel/elastic.py`, `cli/main.py train`)
against the reference's (`tritonk8ssupervisor_tpu/parallel/elastic.py`).

- Both trainers, driven by the same scripted fleet views on one fake clock
  with the same fake checkpoint and `rng=lambda: 0.0`, give the same
  report, the same saves, the same job-ack documents and the same log
  lines in every scenario of tests/test_elastic.py.
- The port's fleet-status reader keeps the torn-read contract and reads a
  concurrent atomic rewrite whole; `Cooldown` draws the reference's delays.
- A tiny LM's state checkpointed on 4 gloo ranks restores on 2 with its
  values intact and trains on.
- A planned 2 -> 1 shrink through `cli.main train --device cpu` in two
  processes: each process reads its fleet status from its own FIFO, so
  the test decides which document each poll gets and both processes see
  the generation bump at the same step; process 1 is removed after the
  bump's flush, and process 0 resumes alone from the state both saved.
- The SIGKILL drill (chaos-marked, as the reference's): process 1 killed
  mid-training, its fleet status published through the reference's
  event ledger.
"""

import copy
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu.parallel import elastic as ref_elastic
from tritonk8ssupervisor_tpu.provision import events as ev
from tritonk8ssupervisor_tpu.provision import retry as ref_retry
from tritonk8ssupervisor_tpu_torch.parallel import elastic
from tritonk8ssupervisor_tpu_torch.provision import retry

ROOT = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------- the seams


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(0.0, float(seconds))


class FakeCkpt:
    """latest/save/restore over deep-copied states. Takes the reference's
    `save(step, state, wait=...)` and the port's `save(step, state)`, and
    records the steps saved."""

    def __init__(self):
        self.store = {}
        self.saves = []

    def latest_step(self):
        return max(self.store) if self.store else None

    def save(self, step, state, wait=False):
        self.store[step] = copy.deepcopy(state)
        self.saves.append(step)

    def restore(self, state, shardings, step=None):
        chosen = max(self.store) if step is None else step
        return copy.deepcopy(self.store[chosen])


def _view(mod, gen=1, healing=False, verdict="healthy", draining=(), degraded=(),
          updated=None):
    return mod.FleetView(generation=gen, heal_in_progress=healing, verdict=verdict,
                         draining=tuple(draining), degraded=tuple(degraded), updated=updated)


def _scripted(mod, views):
    return mod.ScriptedHealthSource([_view(mod, **v) for v in views])


class _LiveHealth:
    """Healthy documents with a fresh `updated` stamp at every poll: what a
    live supervisor's once-per-tick rewrite looks like."""

    def __init__(self, mod, clock):
        self._mod, self._clock = mod, clock

    def poll(self):
        return _view(self._mod, updated=self._clock())


def _fail_once_at(n_fail):
    failed = {"done": False}

    def step_fn(state, *batch):
        if state["n"] == n_fail and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("collective peer lost")
        return {"n": state["n"] + 1}, {}

    return step_fn


def _always_fail(state, *batch):
    raise RuntimeError("wedged")


def _drain_from_step(three):
    """(drain_fn, batch hook): the drain probe answers from step `three` on."""
    seen = {"drain": False}

    def drain_fn():
        return "maintenance-event: TERMINATE" if seen["drain"] else None

    def batch(session, step):
        if step >= three:
            seen["drain"] = True
        return ()

    return drain_fn, batch


# The scenarios of tests/test_elastic.py: (health, policy kwargs, steps,
# step_fn factory or None, drain: "probe" or None)
SCENARIOS = {
    "generation_bump": (lambda mod, clock: _scripted(mod, [{}] * 6 + [{"gen": 2}]),
                        {"checkpoint_every": 100}, 8, None, None),
    "drain_from_probe": (lambda mod, clock: _scripted(mod, [{}]),
                         {"checkpoint_every": 100}, 10, None, "probe"),
    "drain_from_status_list": (
        lambda mod, clock: _scripted(mod, [{}] * 4 + [{"draining": (1,)}]),
        {"checkpoint_every": 100}, 6, None, None),
    "bounded_wait_gives_up_degraded": (
        lambda mod, clock: _scripted(mod, [{}, {}, {"gen": 2, "healing": True,
                                                    "verdict": "degraded", "degraded": (1,)}]),
        {"checkpoint_every": 100, "wait_base_s": 10.0, "wait_cap_s": 20.0,
         "max_wait_s": 100.0, "max_degraded": 1}, 4, None, None),
    "degraded_within_budget": (
        lambda mod, clock: _scripted(mod, [{}, {}, {"gen": 2, "verdict": "degraded",
                                                    "degraded": (2,)}]),
        {"checkpoint_every": 100, "max_wait_s": 500.0, "max_degraded": 1}, 4, None, None),
    "step_failure": (lambda mod, clock: _LiveHealth(mod, clock), {"checkpoint_every": 5},
                     10, lambda: _fail_once_at(7), None),
    "stale_healthy_after_failure": (
        lambda mod, clock: _scripted(mod, [{"updated": 270.0}]),
        {"checkpoint_every": 2, "wait_base_s": 10.0, "wait_cap_s": 10.0, "max_wait_s": 50.0},
        6, lambda: _fail_once_at(3), None),
    "repeated_failure_raises": (lambda mod, clock: _scripted(mod, [{}]),
                                {"checkpoint_every": 5, "max_consecutive_failures": 2}, 4,
                                lambda: _always_fail, None),
    "drain_during_emergency_checkpoint": (
        lambda mod, clock: _scripted(mod, [{"updated": 1.0}] * 5
                                     + [{"gen": 2, "draining": (3,), "updated": 2.0},
                                        {"gen": 2, "updated": 3.0}]),
        {"checkpoint_every": 100}, 8, None, None),
    "drain_then_bump": (
        lambda mod, clock: _scripted(mod, [{"updated": 1.0}] * 4
                                     + [{"draining": (3,), "updated": 2.0}]
                                     + [{"gen": 2, "updated": 3.0}]),
        {"checkpoint_every": 100}, 8, None, None),
}


def drive(mod, scenario: str, tmp_path: Path) -> dict:
    """Run `scenario` on `mod`'s ElasticTrainer; everything it produced."""
    make_health, policy, steps, make_step, drain = SCENARIOS[scenario]
    clock = FakeClock()
    ckpt = FakeCkpt()
    calls = {"setup": 0, "init": 0, "rejoin": 0, "shutdown": 0}
    acks, lines = [], []
    step_fn = make_step() if make_step else (lambda state, *batch: ({"n": state["n"] + 1}, {}))

    class RecordingAck(mod.JobAck):
        def write(self, *args, **kwargs):
            super().write(*args, **kwargs)
            acks.append(json.loads(self.path.read_text()))

    def setup():
        calls["setup"] += 1
        return mod.TrainSession({"n": 0}, None, step_fn)

    def count(name):
        def fn():
            calls[name] += 1
        return fn

    drain_fn, batch_fn = None, (lambda session, step: ())
    if drain == "probe":
        drain_fn, batch_fn = _drain_from_step(3)
    trainer = mod.ElasticTrainer(
        setup, batch_fn, checkpoint=ckpt, health=make_health(mod, clock),
        policy=mod.ElasticPolicy(**policy),
        ack=RecordingAck(tmp_path / f"{mod.__name__}-job-ack.json", clock=clock),
        init_fn=count("init"), rejoin_fn=count("rejoin"), shutdown_fn=count("shutdown"),
        drain_fn=drain_fn, clock=clock, sleep=clock.sleep, rng=lambda: 0.0,
        echo=lines.append,
    )
    try:
        report, error = trainer.run(steps), None
    except mod.ElasticError as e:
        report, error = None, str(e)
    return {"report": report, "error": error, "saves": ckpt.saves, "acks": acks,
            "lines": lines, "calls": calls, "clock": clock.t,
            "state": trainer.session.state if trainer.session else None}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_the_port_trainer_equals_the_reference(scenario, tmp_path):
    """The same report (every field, the fake clock's stamps included),
    saves, job-ack documents, log lines and cluster transitions."""
    ours, ref = drive(elastic, scenario, tmp_path), drive(ref_elastic, scenario, tmp_path)
    assert ours == ref
    # each scenario does what the reference's own test pins
    if scenario == "repeated_failure_raises":
        assert ref["error"] is not None
    else:
        assert ref["report"]["final_step"] == SCENARIOS[scenario][2]
    if scenario in ("generation_bump", "step_failure", "bounded_wait_gives_up_degraded"):
        assert len(ref["report"]["resumes"]) == 1 and ref["calls"]["rejoin"] == 1


# ---------------------------------------------------- the health source


def test_file_health_source_reads_absent_and_torn_as_unknown(tmp_path):
    """A missing, torn or wrongly shaped fleet-status.json is unknown (None),
    never healthy; a whole document parses as the reference parses it."""
    path = tmp_path / "fleet-status.json"
    src, ref = elastic.FileHealthSource(path), ref_elastic.FileHealthSource(path)
    assert src.poll() is None and ref.poll() is None  # absent
    for torn in ('{"membership": {"gen', "[1, 2, 3]", ""):
        path.write_text(torn)
        assert src.poll() is None and ref.poll() is None
    for doc in ({"verdict": "healthy", "membership": {"generation": 4, "heal_in_progress": True},
                 "degraded": [2]},
                {"verdict": "degraded", "slices": {"0": {"state": "healthy"},
                                                   "1": {"state": "draining"}},
                 "degraded": [1], "serving": {"eligible": [0], "shed": True},
                 "slices_total": 2, "updated": 12.5}):
        path.write_text(json.dumps(doc))
        got = src.poll()
        assert got is not None and got.__dict__ == ref.poll().__dict__
    assert src.poll() == elastic.FleetView(generation=1, heal_in_progress=False,
                                           verdict="degraded", draining=(1,), degraded=(1,),
                                           updated=12.5, serving=(0,), shed=True,
                                           slices_total=2)


def test_file_health_source_reads_a_concurrent_rewrite_whole(tmp_path):
    """Polls racing the supervisor's atomic rewrite (the reference's
    `events.write_fleet_status`) see the old or the new document, never a
    torn one: every successful poll is complete, generations never go back."""
    path = tmp_path / "fleet-status.json"
    src = elastic.FileHealthSource(path)
    stop = threading.Event()

    def writer():
        gen = 0
        while not stop.is_set():
            gen += 1
            ev.write_fleet_status(path, {
                "verdict": "healthy",
                "membership": {"generation": gen, "heal_in_progress": False},
                "degraded": [],
            })

    thread = threading.Thread(target=writer)
    thread.start()
    try:
        seen = []
        deadline = time.monotonic() + 10.0
        while len(seen) < 200 and time.monotonic() < deadline:
            got = src.poll()
            if got is not None:
                seen.append(got)
    finally:
        stop.set()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert seen, "no successful read before the 10 s deadline"
    gens = [v.generation for v in seen]
    assert all(v.verdict == "healthy" for v in seen)
    assert gens == sorted(gens), "generation went backwards (torn read?)"


@pytest.mark.parametrize("base,cap", [(5.0, 60.0), (10.0, 20.0), (2.0, 2.0)])
def test_cooldown_draws_the_reference_sequence(base, cap):
    """The same delays as the reference's Cooldown for the same draws,
    through a reset as well."""
    ours = retry.Cooldown(base, cap, rng=random.Random(7).random)
    ref = ref_retry.Cooldown(base, cap, rng=random.Random(7).random)
    got = [ours.next() for _ in range(12)]
    want = [ref.next() for _ in range(12)]
    ours.reset()
    ref.reset()
    got += [ours.next() for _ in range(4)]
    want += [ref.next() for _ in range(4)]
    assert got == want
    assert all(base <= d <= cap for d in got)


def test_job_ack_is_atomic_sorted_and_bounded(tmp_path):
    """The port's ack document equals the reference's, byte for byte."""
    for mod, name in ((elastic, "ours.json"), (ref_elastic, "ref.json")):
        mod.JobAck(tmp_path / name, clock=lambda: 42.0).write(
            "degraded", 3, 17, world=2, slices=(2, 0), reason="x" * 500)
        mod.JobAck(None).write("resumed", 1, 1)  # disabled: a no-op
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
    doc = json.loads((tmp_path / "ours.json").read_text())
    assert doc["slices"] == [0, 2] and len(doc["reason"]) == 200
    assert not list(tmp_path.glob(".*.tmp"))


# -------------------------------------------- real state across a resize


LM = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=128, max_seq_len=16)


def _lm_state(mesh):
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.parallel import train

    model = TransformerLM(**LM, dtype=torch.float32, logits_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    return train.create_train_state(model, train.default_optimizer(0.05), "cpu", mesh=mesh)


def _tokens():
    return torch.from_numpy(np.random.default_rng(5).integers(0, 64, (8, 16)).astype(np.int32))


def _full_values(state) -> dict:
    """Every parameter and momentum buffer as the whole array (a sharded
    one gathered over its mesh axes)."""
    from tritonk8ssupervisor_tpu_torch.parallel import checkpoint as ckpt_lib

    out = {}
    for name, p in state.model.named_parameters():
        for key, local in (("param", p.detach()),
                           ("momentum", state.optimizer.state[p]["momentum_buffer"])):
            value = ckpt_lib._global(state, name, local)
            out[f"{key}.{name}"] = getattr(value, "full_tensor", lambda: value)().clone()
    return out


def save_on_four(directory: str) -> dict:
    """One rank of 4 on a (data 2, model 2) mesh: one step, a save at step 1."""
    from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
    from tritonk8ssupervisor_tpu_torch.parallel import train
    from tritonk8ssupervisor_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

    mesh = mesh_lib.make_mesh(model_parallelism=2, device_type="cpu")
    state = _lm_state(mesh)
    train.make_lm_train_step(state)(batch_shard(mesh, _tokens()))
    elastic.ElasticCheckpoint(TrainCheckpointer(directory)).save(state.step, state)
    sharded = sorted(n for n, spec in state.specs.items() if any(spec))
    return {"values": _full_values(state), "sharded": sharded}


def restore_on_two(directory: str) -> dict:
    """One rank of 2 on a (data 2) mesh: restore, compare, one more step."""
    from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
    from tritonk8ssupervisor_tpu_torch.parallel import train
    from tritonk8ssupervisor_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

    mesh = mesh_lib.make_mesh(device_type="cpu")
    state = _lm_state(mesh)
    train.make_lm_train_step(state)(batch_shard(mesh, _tokens()))  # away from the saved values
    ckpt = elastic.ElasticCheckpoint(lambda: TrainCheckpointer(directory))
    restored = ckpt.restore(state, None)
    restored_step, values = restored.step, _full_values(restored)
    loss = train.make_lm_train_step(restored)(batch_shard(mesh, _tokens()))["loss"]
    return {"restored_step": restored_step, "values": values, "after_step": restored.step,
            "loss": float(loss)}


def test_state_saved_on_four_ranks_restores_on_two(tmp_path):
    """The shrink direction of the resize-resume pin (the reference's
    test_restore_into_smaller_mesh_value_equality): a state checkpointed on
    4 ranks, its MLP weights sharded over "model", restores into a 2-rank
    data-parallel world with every value intact, and training continues."""
    from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks

    directory = str(tmp_path / "ckpt")
    saved = run_ranks(save_on_four, 4, args=(directory,), timeout=240.0, threads=1)
    assert saved[0]["sharded"], "nothing sharded: the resize would reshard nothing"
    restored = run_ranks(restore_on_two, 2, args=(directory,), timeout=240.0, threads=1)
    want = saved[0]["values"]
    for rank in restored:
        assert rank["restored_step"] == 1 and rank["after_step"] == 2
        assert set(rank["values"]) == set(want)
        for key, value in want.items():
            assert torch.equal(rank["values"][key], value), key
        assert np.isfinite(rank["loss"])


# ------------------------------------- the train drill in two processes


HEALTHY = {"verdict": "healthy", "membership": {"generation": 1, "heal_in_progress": False,
                                                "draining": []}, "degraded": []}
# the supervisor's view once slice 1 is gone and will not be healed
SHRUNK = {"verdict": "degraded", "membership": {"generation": 2, "heal_in_progress": False,
                                               "draining": []}, "degraded": [1]}


def _drill_argv(tmp_path: Path, pid: int, steps: int, every: int, status: Path) -> list[str]:
    return [
        sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.cli.main", "train",
        "--device", "cpu", "--workdir", str(tmp_path),
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--steps", str(steps), "--checkpoint-every", str(every),
        "--status-file", str(status), "--ack-file", str(tmp_path / f"ack-{pid}.json"),
        "--env-file", str(tmp_path / "cluster.env"), "--max-wait", "10",
        "--max-degraded", "1", "--train-report", str(tmp_path / f"report-{pid}.json"), "--yes",
    ]


def _drill_env(pid: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "TK8S_"))}
    env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
               JAX_PROCESS_ID=str(pid), OMP_NUM_THREADS="1")
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class StatusFifo:
    """One process's fleet status, served through a FIFO poll by poll: the
    n-th open of the FIFO (a poll of its FileHealthSource) gets `doc(n)`,
    and once `hold_from` is reached the reader is held (the FIFO stays open
    and unwritten) and `held` is set. `acks` is the process's ack file as
    each poll found it. Each poll gets a FIFO of its own, renamed over the
    path as soon as the previous one is opened and before it is written,
    so the next open for writing waits for the next poll, not for a reader
    still draining the last, and no poll can open a FIFO that is spent."""

    def __init__(self, path: Path, ack: Path, doc, hold_from: int | None = None):
        os.mkfifo(path)
        self.path, self.ack, self.doc, self.hold_from = path, ack, doc, hold_from
        self.polls = 0
        self.acks: list = []
        self.held = threading.Event()
        self._held_fd = None
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            fd = os.open(self.path, os.O_WRONLY)  # blocks until the next poll opens it
            if self._stop:
                os.close(fd)
                return
            self.polls += 1
            self.acks.append(json.loads(self.ack.read_text())["phase"]
                             if self.ack.exists() else None)
            if self.hold_from is not None and self.polls >= self.hold_from:
                self._held_fd = fd
                self.held.set()
                return
            # the next FIFO takes the path BEFORE this poll's reader can see
            # EOF: a poll that came after the close but before the rename
            # would open this spent FIFO and wait for a writer forever
            fresh = self.path.with_name(self.path.name + ".next")
            os.mkfifo(fresh)
            os.replace(fresh, self.path)
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(self.doc(self.polls)))

    def close(self):
        self._stop = True
        if self._held_fd is not None:
            os.close(self._held_fd)
        if self.thread.is_alive():  # unblock its open: a reader that reads nothing
            fd = os.open(self.path, os.O_RDONLY | os.O_NONBLOCK)
            self.thread.join(timeout=10)
            os.close(fd)


def test_planned_shrink_through_the_train_drill(tmp_path):
    """Two processes of `cli.main train --device cpu` over gloo; the fleet
    status bumps the generation (slice 1 gone, no heal coming) at the step-6
    boundary for both. Both flush step 6; process 1 is then removed while it
    waits for the heal, and process 0 rejoins at world size 1 from the
    rewritten env file, restores the state the two saved and finishes with
    no step lost, acknowledging notified, then degraded."""
    steps, every, bump_poll = 12, 4, 8  # poll 1 at start, poll s + 2 at step s
    (tmp_path / "cluster.env").write_text("JAX_NUM_PROCESSES=1\nJAX_PROCESS_ID=0\n")

    def doc(n):
        return HEALTHY if n < bump_poll else SHRUNK

    fifos = [StatusFifo(tmp_path / f"status-{pid}.fifo", tmp_path / f"ack-{pid}.json", doc,
                        hold_from=None if pid == 0 else bump_poll + 1) for pid in (0, 1)]
    port = _free_port()
    procs = [subprocess.Popen(_drill_argv(tmp_path, pid, steps, every, fifos[pid].path),
                              env=_drill_env(pid, port), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for pid in (0, 1)]
    try:
        # process 1 polls for the heal only after its flush of step 6
        assert fifos[1].held.wait(timeout=180), "process 1 never reached the heal wait"
        os.killpg(procs[1].pid, signal.SIGKILL)
        out = procs[0].communicate(timeout=180)[0]
        assert procs[0].returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=30)
        for f in fifos:
            f.close()
    report = json.loads((tmp_path / "report-0.json").read_text())
    assert (report["final_step"], report["world"], report["generation"]) == (steps, 1, 2), out
    (resume,) = report["resumes"]
    assert resume["reason"] == "generation 1 -> 2" and resume["at_step"] == 6
    assert resume["resumed_step"] == 6 and resume["steps_lost"] == 0 <= every
    assert resume["degraded"] and resume["degraded_slices"] == [1] and resume["world"] == 1
    # acknowledgements: none before the bump, notified at the heal wait, then degraded
    assert fifos[0].acks[:bump_poll] == [None] * bump_poll
    assert fifos[0].acks[bump_poll] == "notified" and fifos[0].acks[-1] == "degraded"
    assert json.loads((tmp_path / "ack-0.json").read_text())["phase"] == "degraded"
    assert json.loads((tmp_path / "ack-1.json").read_text())["phase"] == "notified"
    # step 6 was written by both processes, the steps after it by one
    ckpt = tmp_path / "ckpt"
    assert len(list((ckpt / "6").glob("*.distcp"))) == 2
    assert len(list((ckpt / str(steps)).glob("*.distcp"))) == 1
    assert "[elastic] membership change at step 6: generation 1 -> 2" in out


@pytest.mark.chaos
def test_two_process_sigkill_drill(tmp_path):
    """The reference's acceptance drill through the port's CLI: two CPU
    processes train one data-parallel LM; process 1 is process-group
    SIGKILLed after the first committed checkpoint; the survivor sees the
    failed collective, acknowledges the change, rejoins at world size 1
    from the shared checkpoint losing at most one checkpoint interval, and
    the port's event ledger, fed by the port's JobAckWatcher, carries
    job-notified -> job-resumed with MTTR and the degraded ack. The drill
    runs on the port alone: its launcher, supervisor side and ledger."""
    from tritonk8ssupervisor_tpu_torch.provision import events as ev
    from tritonk8ssupervisor_tpu_torch.provision import supervisor as sup_mod
    from tritonk8ssupervisor_tpu_torch.testing import localcluster

    ckpt_dir = tmp_path / "ckpt"
    status = tmp_path / "fleet-status.json"
    env_file = tmp_path / "cluster.env"
    acks = [tmp_path / f"ack-{i}.json" for i in (0, 1)]
    reports = [tmp_path / f"report-{i}.json" for i in (0, 1)]
    ledger = ev.EventLedger(tmp_path / "events.jsonl", echo=lambda line: None)
    folded = ev.LedgerView()

    def rec(kind, **fields):
        record = ledger.append(kind, **fields)
        ev.apply(folded, record)
        return record

    def publish():
        ev.write_fleet_status(status, ev.fleet_status(folded, time.time()))

    rec(ev.TICK, tick=1, states={"0": "healthy", "1": "healthy"})
    publish()
    steps, every = 40, 5

    def argv(pid):
        return [
            sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.cli.main", "train",
            "--device", "cpu", "--workdir", str(tmp_path), "--checkpoint-dir", str(ckpt_dir),
            "--steps", str(steps), "--checkpoint-every", str(every),
            "--status-file", str(status), "--ack-file", str(acks[pid]),
            "--env-file", str(env_file), "--max-wait", "10", "--max-degraded", "1",
            "--train-report", str(reports[pid]), "--yes",
        ]

    procs = localcluster.launch_cluster(argv, num_processes=2, extra_env={"OMP_NUM_THREADS": 1})
    try:
        marker_dir = ckpt_dir / ".tk8s-complete"
        deadline = time.time() + 300
        done = []
        while time.time() < deadline and procs[0].poll() is None:
            if marker_dir.is_dir():
                done = sorted(int(p.name) for p in marker_dir.iterdir())
                if done and done[-1] >= every:
                    break
            time.sleep(0.05)
        assert done and done[-1] >= every, "no committed checkpoint before the kill"
        os.killpg(procs[1].pid, signal.SIGKILL)
        env_file.write_text("JAX_NUM_PROCESSES=1\nJAX_PROCESS_ID=0\n")
        # the supervisor's side, at its tick after the survivor acknowledged
        # the failed step: slice 1 is gone (generation bump), no heal is
        # coming (the degraded path), the env file is the new process set.
        # Until then the survivor waits on the stale healthy status. (The
        # port's survivor sees the failed collective within milliseconds, so
        # a verdict published at once would let it resume before a 0.2 s
        # tick could observe the notified acknowledgement.)
        watcher = sup_mod.JobAckWatcher(acks[0])
        published = False
        while time.time() < deadline and procs[0].poll() is None:
            if watcher.observe(folded, rec, time.time()):
                publish()
            if not published and any(r["kind"] == ev.JOB_NOTIFIED for r in ledger.replay()):
                rec(ev.VERDICT, slice=1, state="missing", detail="SIGKILL drill")
                publish()
                published = True
            time.sleep(0.2)
        out = procs[0].communicate(timeout=60)[0]
        assert procs[0].returncode == 0, out
        report = json.loads(reports[0].read_text())
        assert report["final_step"] == steps, out
        assert report["world"] == 1, out
        assert report["resumes"], out
        assert report["steps_lost"] <= every, out
        watcher.observe(folded, rec, time.time())
        recorded = [r["kind"] for r in ledger.replay()]
        assert ev.JOB_NOTIFIED in recorded, recorded
        assert ev.JOB_RESUMED in recorded, recorded
        resumed = next(r for r in ledger.replay() if r["kind"] == ev.JOB_RESUMED)
        assert resumed.get("mttr_s") is not None
        assert ev.DEGRADED_ACK in recorded, recorded
    finally:
        localcluster.kill_cluster(procs)
