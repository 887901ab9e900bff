"""The port's resident supervisor (`provision/supervisor.py`) against the
reference's: the scenarios of tests/test_supervisor.py (the rate limiter,
the circuit breaker, the flap filter, the job-ack watcher, preemption,
drain, degraded acks, heal storms, kills and restarts from the ledger,
the dirty set and the sweep, parallel heal waves, failure domains, quota
deferral, compaction, the GKE and second-instance refusals,
`stop_running`, `SupervisePolicy.from_env`), and the supervisor cases of
tests/test_autoscale.py, tests/test_allocator.py and tests/test_obs.py,
run through both packages on each one's `SimClock` over one scripted
world (`FleetSim`, a twin of the reference test's and of
`bench_provision.SuperviseSim`; `testing/chaos.ChaosFleet` for the
autoscale, allocator and telemetry cases) that takes the package as a
parameter. Each side runs in its own temporary root, replaced by one name
before the comparison; the event ledgers replay equal record by record,
the `fleet-status.json` documents and the printed lines are equal, and
every number the reference test asserts is asserted on both sides.

Heals of one parallel wave run on worker threads that append their
records in arrival order, in the reference as in the port: where a
scenario runs such a wave, records of one virtual instant are compared as
a multiset, with the heal ids named by slice and printed lines compared
sorted. No tolerance.

Every scenario that drives a supervisor also runs as the mirrored pair of
tests/test_torch_heal.py: the reference on a tpu-vm fleet, the port on a
gpu-vm `h100` `2x8` fleet of as many slices (two host VMs a slice, in
both worlds), through `GpuMirror`; the port's ledger, status document,
printed lines and the world's commands, its words mapped by `as_tpu`,
equal the reference's."""

import dataclasses
import json
import os
import signal
import types

import pytest

from tritonk8ssupervisor_tpu import obs as ref_obs
from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.obs import metrics as ref_metrics
from tritonk8ssupervisor_tpu.provision import allocator as ref_allocator
from tritonk8ssupervisor_tpu.provision import autoscale as ref_autoscale
from tritonk8ssupervisor_tpu.provision import events as ref_events
from tritonk8ssupervisor_tpu.provision import heal as ref_heal
from tritonk8ssupervisor_tpu.provision import retry as ref_retry
from tritonk8ssupervisor_tpu.provision import runner as ref_runner
from tritonk8ssupervisor_tpu.provision import state as ref_state
from tritonk8ssupervisor_tpu.provision import supervisor as ref_supervisor
from tritonk8ssupervisor_tpu.testing import chaos as ref_chaos
from tritonk8ssupervisor_tpu.testing import faults as ref_faults
from tritonk8ssupervisor_tpu.testing import simclock as ref_simclock
from tritonk8ssupervisor_tpu_torch import obs
from tritonk8ssupervisor_tpu_torch.config import schema
from tritonk8ssupervisor_tpu_torch.obs import metrics
from tritonk8ssupervisor_tpu_torch.provision import (
    allocator,
    autoscale,
    events,
    heal,
    retry,
    runner,
    state,
    supervisor,
)
from tritonk8ssupervisor_tpu_torch.testing import chaos, faults, simclock

from test_torch_heal import GPU_VM, MIRROR_PROBLEMS, MIRROR_ZONE, GpuMirror, as_tpu  # noqa: E402

SIDES = {
    "port": types.SimpleNamespace(
        sup=supervisor, ev=events, heal=heal, state=state, runner=runner, schema=schema,
        retry=retry, faults=faults, simclock=simclock, chaos=chaos, obs=obs, metrics=metrics,
        autoscale=autoscale, allocator=allocator),
    "reference": types.SimpleNamespace(
        sup=ref_supervisor, ev=ref_events, heal=ref_heal, state=ref_state, runner=ref_runner,
        schema=ref_schema, retry=ref_retry, faults=ref_faults, simclock=ref_simclock,
        chaos=ref_chaos, obs=ref_obs, metrics=ref_metrics, autoscale=ref_autoscale,
        allocator=ref_allocator),
}


def sides(mode: str) -> dict:
    """The two packages for one mode: `tpu-vm` compares like for like;
    `gpu-vm` is the mirrored pair (the port's side has `gpu`)."""
    return {side: types.SimpleNamespace(**vars(m), mirror=mode == "gpu-vm",
                                        gpu=mode == "gpu-vm" and side == "port")
            for side, m in SIDES.items()}


def cfg(m, num_slices=3, **overrides):
    """A tpu-vm config, in the mirror's zone on a mirrored pair."""
    base = dict(project="my-proj", zone="us-west4-a", generation="v5e",
                topology="4x4", mode="tpu-vm", num_slices=num_slices)
    if getattr(m, "mirror", False):
        base["zone"] = MIRROR_ZONE
    base.update(overrides)
    return m.schema.ClusterConfig(**base)


def gpu_view(m, world, config):
    """The config and the RunFn pair the side's supervisor runs on: the
    world's own, or on the port's side of a mirrored pair the gpu-vm
    config of as many slices and the world seen through `GpuMirror`."""
    if not getattr(m, "gpu", False):
        return config, world
    gpu_config = m.schema.ClusterConfig(**{**dataclasses.asdict(config), **GPU_VM})
    return gpu_config, GpuMirror(world, gpu_config)


class Say:
    def __init__(self):
        self.lines = []

    def say(self, text=""):
        self.lines.append(text)

    def text(self):
        return "\n".join(self.lines)


class FleetSim:
    """A scripted fleet whose health is a function of virtual time, for
    either package `m`: slices can be preempted (vanish from the Cloud TPU
    listing) or drain for maintenance on schedule; `terraform apply
    -replace` costs `heal_seconds` on the clock and (unless
    `heal_works=False`) brings the slice back."""

    def __init__(self, m, root, clock, num_slices=3, heal_seconds=120.0,
                 heal_works=True, failure_domains=0):
        self.m = m
        self.paths = m.state.RunPaths(root)
        self.config = cfg(m, num_slices, failure_domains=failure_domains)
        self.sup_config, self.view = gpu_view(m, self, self.config)
        self.paths.terraform_module(self.sup_config.mode).mkdir(parents=True)
        self.hosts = 2 if getattr(m, "mirror", False) else 1
        self.clock = clock
        self.heal_seconds = heal_seconds
        self.heal_works = heal_works
        self.num_slices = num_slices
        self.down: set = set()
        self.down_at: list = []
        self.drain_windows: dict = {}
        self.applies: list = []
        self.plays: list = []
        self.ips = {i: f"10.0.{i}" for i in range(num_slices)}  # host h is .h+1
        m.state.ClusterHosts(
            host_ips=[self.slice_ips(i) for i in range(num_slices)],
            internal_ips=[self.slice_ips(i, f"10.1.{i}") for i in range(num_slices)],
            coordinator_ip="10.1.0.1",
        ).save(self.paths.hosts_file)
        self.paths.tfstate(self.sup_config.mode).write_text(json.dumps(
            {"resources": [{"index": i} for i in range(num_slices)]}))

    def slice_ips(self, i, net=None):
        return [f"{net or self.ips[i]}.{h + 1}" for h in range(self.hosts)]

    def preempt(self, slice_index, at):
        self.down_at.append((at, slice_index))

    def drain(self, slice_index, start, until):
        self.drain_windows[slice_index] = (start, until)

    def _sync(self):
        now = self.clock.time()
        for at, i in list(self.down_at):
            if now >= at:
                self.down.add(i)
                self.down_at.remove((at, i))

    def _draining(self, slice_index):
        window = self.drain_windows.get(slice_index)
        if window is None or slice_index in self.down:
            return False
        return window[0] <= self.clock.time() < window[1]

    def run(self, args, cwd=None, **kwargs):
        self._sync()
        line = " ".join(str(a) for a in args)
        if line.startswith("terraform apply"):
            replaced = [int(str(a).split("[")[1].rstrip("]"))
                        for a in args if str(a).startswith("-replace=")]
            self.applies.append(replaced)
            self.clock.sleep(self.heal_seconds)
            if self.heal_works:
                for i in replaced:
                    self.down.discard(i)
                    self.ips[i] = f"10.9.{i}"
        elif line.startswith("ansible-playbook"):
            self.plays.append(line)
        return ""

    def run_quiet(self, args, cwd=None, **kwargs):
        self._sync()
        if args[:3] == ["terraform", "output", "-json"]:
            return json.dumps({
                "host_ips": {"value": [self.slice_ips(i) for i in range(self.num_slices)]},
                "internal_ips": {"value": [self.slice_ips(i, f"10.1.{i}")
                                           for i in range(self.num_slices)]},
            })
        if args and args[0] == "gcloud":
            return "\n".join(f"{self.config.node_prefix}-{i}\tREADY"
                             for i in range(self.num_slices) if i not in self.down)
        if args and args[0] == "ssh":
            net = args[-2].rsplit(".", 1)[0]
            index = next((i for i, x in self.ips.items() if x == net), None)
            if "cat" in args[-1]:
                if index is not None and self._draining(index):
                    return "maintenance-event: TERMINATE_ON_HOST_MAINTENANCE"
                return ""
            if index in self.down:
                raise self.m.runner.CommandError(args, 255)
            return ""
        return ""


def build(m, world, clock, prompter=None, policy=None, readiness_timeout=60.0, hooks=None):
    return m.sup.Supervisor(
        world.sup_config, world.paths, prompter or Say(),
        run=world.view.run, run_quiet=world.view.run_quiet,
        policy=policy or m.sup.SupervisePolicy(),
        ledger=m.ev.EventLedger(world.paths.events, clock=clock.time, echo=lambda line: None),
        clock=clock.time, sleep=clock.sleep, rng=lambda: 0.0,
        readiness_timeout=readiness_timeout, hooks=hooks,
    )


def run_sim(supervisor, clock, ticks):
    clock.begin()
    try:
        return supervisor.run(ticks=ticks)
    finally:
        clock.release()


def run_killed(m, supervisor, clock, ticks):
    """Run until the fault plan's SIGKILL stand-in ends the loop."""
    clock.begin()
    try:
        with pytest.raises(m.faults.SupervisorKilled):
            supervisor.run(ticks=ticks)
    finally:
        clock.release()


def replay(m, world):
    return m.ev.EventLedger(world.paths.events).replay()


def kinds(m, world):
    return [r["kind"] for r in replay(m, world)]


def status(world):
    return json.loads(world.paths.fleet_status.read_text())


def observed(m, world, *says, **extra) -> dict:
    """What a scenario leaves behind: the ledger, the status document, the
    printed lines, the world's commands."""
    out = {"ledger": replay(m, world),
           "status": status(world) if world.paths.fleet_status.exists() else None,
           "lines": [list(s.lines) for s in says],
           "applies": list(world.applies), "plays": list(getattr(world, "plays", []))}
    out.update(extra)
    return out


def normalized(value, root, side):
    text = json.dumps(value, sort_keys=True, default=str).replace(str(root), "ROOT")
    if side == "reference":
        text = text.replace("tritonk8ssupervisor_tpu", "tritonk8ssupervisor_tpu_torch")
    return json.loads(text)


HEAL_KINDS = ("heal-start", "heal-done", "heal-failed")


def unordered_waves(obs_doc: dict) -> dict:
    """The same observation with each virtual instant's records as a
    sorted multiset, heal ids and attempt numbers named by the heal's
    slices, and the printed lines and the world's commands sorted."""
    names: dict = {}
    seen: dict = {}
    records = []
    for r in obs_doc["ledger"]:
        r = dict(r)
        if r.get("kind") in HEAL_KINDS and "id" in r:
            key = tuple(r.get("slices") or ())
            if r["kind"] == "heal-start":
                seen[key] = seen.get(key, 0) + 1
                names[r["id"]] = f"heal{list(key)}#{seen[key]}"
                r.pop("attempt", None)
            r["id"] = names.get(r["id"], r["id"])
        records.append(r)
    runs, out = [], []
    for r in records:
        if runs and runs[-1][0]["ts"] == r["ts"]:
            runs[-1].append(r)
        else:
            runs.append([r])
    for run in runs:
        out.extend(sorted(run, key=lambda r: json.dumps(r, sort_keys=True)))
    return dict(obs_doc, ledger=out, lines=[sorted(lines) for lines in obs_doc["lines"]],
                applies=sorted(obs_doc["applies"]), plays=sorted(obs_doc["plays"]))


def both(tmp_path, scenario, parallel=False, mode="tpu-vm") -> dict:
    out = {}
    MIRROR_PROBLEMS.clear()
    for side, m in sides(mode).items():
        root = tmp_path / side
        root.mkdir()
        doc = normalized(scenario(m, root), root, side)
        if m.gpu:
            doc = as_tpu(doc)
        out[side] = unordered_waves(doc) if parallel else doc
    assert MIRROR_PROBLEMS == []
    assert out["port"] == out["reference"]
    return out["port"]


MODES = pytest.mark.parametrize("mode", ["tpu-vm", "gpu-vm"])


# ------------------------------------------------------ rate limiter, breaker, flaps


def units(m) -> list:
    out = []
    bucket = m.sup.TokenBucket(capacity=2, refill_seconds=600.0)
    out += [bucket.try_take(0.0), bucket.try_take(0.0), bucket.try_take(0.0),
            bucket.retry_at(0.0), bucket.try_take(599.0), bucket.try_take(600.0),
            bucket.try_take(600.0)]
    assert out == [True, True, False, 600.0, False, True, False]
    bucket = m.sup.TokenBucket(capacity=1, refill_seconds=600.0)
    bucket.consume_at(100.0)
    bucket.consume_at(100.0)
    out += [bucket.tokens, bucket.try_take(100.0), bucket.try_take(700.0)]
    assert out[-3:] == [0.0, False, True]

    breaker = m.sup.CircuitBreaker(threshold=3, window_s=1000.0,
                                   cooldown=m.retry.Cooldown(300.0, 3600.0, rng=lambda: 0.0))
    trace = [breaker.allow(0.0), breaker.record_failure(10.0), breaker.record_failure(20.0),
             breaker.record_failure(30.0), breaker.state, breaker.reopen_at,
             breaker.allow(100.0), breaker.allow(330.0), breaker.state,
             breaker.record_failure(340.0), breaker.state, breaker.trips, breaker.reopen_at,
             breaker.allow(640.0), breaker.record_success(650.0), breaker.state,
             list(breaker.failures)]
    assert trace == [True, False, False, True, m.sup.OPEN, 330.0, False, True,
                     m.sup.HALF_OPEN, True, m.sup.OPEN, 2, 640.0, True, True, m.sup.CLOSED, []]
    out.append(trace)
    breaker = m.sup.CircuitBreaker(threshold=3, window_s=100.0,
                                   cooldown=m.retry.Cooldown(300.0, 3600.0, rng=lambda: 0.0))
    trace = [breaker.record_failure(0.0), breaker.record_failure(50.0),
             breaker.record_failure(140.0), breaker.state]
    assert trace == [False, False, False, m.sup.CLOSED]
    out.append(trace)

    def health(states):
        return m.heal.FleetHealth([m.heal.SliceHealth(i, s) for i, s in enumerate(states)])

    H, M, U, D = m.heal.HEALTHY, m.heal.MISSING, m.heal.UNREADY, m.heal.DRAINING
    flaps = m.sup.FlapFilter(threshold=2)
    trace = [flaps.observe(health(s)) for s in ([H, M], [H, M], [H, H], [H, U])]
    assert trace == [[], [1], [], []]
    flaps = m.sup.FlapFilter(threshold=2)
    trace += [flaps.observe(health(s)) for s in ([U], [D], [U])]
    assert trace[-3:] == [[], [], [0]]
    out.append(trace)
    return out


def test_rate_limiter_breaker_and_flap_filter_match_the_reference():
    ours, ref = units(SIDES["port"]), units(SIDES["reference"])
    assert ours == ref


def test_job_ack_watcher_tolerates_missing_and_torn_as_the_reference(tmp_path):
    out = {}
    for side, m in SIDES.items():
        path = tmp_path / side / "job-ack.json"
        path.parent.mkdir()
        watcher = m.sup.JobAckWatcher(path)
        seen = [watcher.read()]
        path.write_text('{"phase": "resu')
        seen += [watcher.read(), watcher.observe(m.ev.LedgerView(), lambda *a, **k: None, 0.0)]
        assert seen == [None, None, None]
        out[side] = seen
    assert out["port"] == out["reference"]


# ------------------------------------------------------------- reconcile drills


def sc_single_bad_probe(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.preempt(1, at=50.0)
    orig_quiet = world.run_quiet

    def flappy_quiet(args, cwd=None, **kwargs):
        if clock.time() >= 70.0:
            world.down.discard(1)
        return orig_quiet(args, cwd=cwd, **kwargs)

    world.run_quiet = flappy_quiet
    say = Say()
    run_sim(build(m, world, clock, prompter=say), clock, ticks=5)
    assert world.applies == []
    recorded = kinds(m, world)
    assert m.ev.HEAL_START not in recorded
    assert recorded.count(m.ev.VERDICT) >= 2
    return observed(m, world, say)


def sc_preemption_drain_then_healed_once(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.drain(1, start=240.0, until=300.0)
    world.preempt(1, at=300.0)
    say = Say()
    run_sim(build(m, world, clock, prompter=say), clock, ticks=16)
    assert world.applies == [[1]]
    assert len(world.plays) == 1 and "--limit 10.9.1.1" in world.plays[0]
    recorded = kinds(m, world)
    assert recorded.count(m.ev.HEAL_START) == 1 and recorded.count(m.ev.HEAL_DONE) == 1
    assert recorded.index(m.ev.MAINTENANCE) < recorded.index(m.ev.HEAL_START)
    assert "draining for maintenance" in say.text()
    done = next(r for r in replay(m, world) if r["kind"] == m.ev.HEAL_DONE)
    assert done["slices"] == [1] and done["mttr_s"] == [210.0]
    doc = status(world)
    assert doc["verdict"] == "healthy"
    assert doc["heals"] == {"attempted": 1, "succeeded": 1, "failed": 0, "rate_limited": 0,
                            "held_ticks": 0, "suppressed": 0, "deferred": 0, "in_flight": 0}
    assert doc["mttr_s"]["last"] == 210.0
    assert doc["membership"]["generation"] >= 3
    assert doc["membership"]["heal_in_progress"] is False
    return observed(m, world, say)


def write_ack(m, world, phase, generation=2, step=100, slices=(), world_size=2):
    m.state.atomic_write_text(world.paths.job_ack, json.dumps({
        "v": 1, "ts": world.clock.time(), "phase": phase, "generation": generation,
        "step": step, "world": world_size, "slices": sorted(slices), "reason": "drill",
    }) + "\n")


def sc_degraded_ack_suppresses_heal(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.preempt(2, at=0.0)
    say = Say()
    supervisor = build(m, world, clock, prompter=say)
    write_ack(m, world, "notified", step=40)
    run_sim(supervisor, clock, ticks=1)
    write_ack(m, world, "degraded", step=40, slices=(2,), world_size=1)
    run_sim(supervisor, clock, ticks=6)
    assert world.applies == []
    recorded = kinds(m, world)
    assert {m.ev.JOB_NOTIFIED, m.ev.DEGRADED_ACK, m.ev.JOB_RESUMED} <= set(recorded)
    assert recorded.count(m.ev.HEAL_SUPPRESSED) == 1
    resumed = next(r for r in replay(m, world) if r["kind"] == m.ev.JOB_RESUMED)
    assert resumed["degraded"] is True and resumed["mttr_s"] is not None
    doc = status(world)
    assert doc["job"]["phase"] == "degraded" and doc["job"]["acked_degraded"] == [2]
    assert doc["heals"]["suppressed"] == 1
    assert "suppressed" in say.text()
    return observed(m, world, say)


def sc_healthy_again_clears_suppression(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.preempt(1, at=0.0)
    say = Say()
    supervisor = build(m, world, clock, prompter=say)
    write_ack(m, world, "degraded", step=10, slices=(1,), world_size=2)
    run_sim(supervisor, clock, ticks=3)
    assert world.applies == []
    world.down.discard(1)
    run_sim(supervisor, clock, ticks=2)
    assert status(world)["job"]["acked_degraded"] == []
    world.preempt(1, at=world.clock.time())
    run_sim(supervisor, clock, ticks=4)
    assert world.applies == [[1]]
    return observed(m, world, say)


def sc_job_ack_restart_does_not_rerecord(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    first, second = Say(), Say()
    write_ack(m, world, "resumed", generation=3, step=70)
    run_sim(build(m, world, clock, prompter=first), clock, ticks=2)
    assert kinds(m, world).count(m.ev.JOB_RESUMED) == 1
    run_sim(build(m, world, clock, prompter=second), clock, ticks=2)
    assert kinds(m, world).count(m.ev.JOB_RESUMED) == 1
    return observed(m, world, first, second)


def sc_heal_storm_trips_breaker(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, heal_works=False)
    world.preempt(2, at=0.0)
    policy = m.sup.SupervisePolicy(
        interval=30.0, flap_threshold=2, heal_burst=2, heal_refill_s=600.0,
        breaker_threshold=3, breaker_window_s=3600.0, breaker_cooldown_s=600.0,
        max_degraded=1)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy), clock, ticks=30)
    recorded = kinds(m, world)
    doc = status(world)
    attempts = recorded.count(m.ev.HEAL_START)
    assert attempts == len(world.applies) and doc["heals"]["failed"] == attempts
    assert recorded.count(m.ev.RATE_LIMITED) >= 1
    assert m.ev.BREAKER_OPEN in recorded and doc["breaker"]["trips"] >= 1
    assert recorded.count(m.ev.DEGRADED_HOLD) >= 1
    assert doc["verdict"] == "degraded-hold" and doc["degraded"] == [2]
    opens = [i for i, k in enumerate(recorded) if k == m.ev.BREAKER_OPEN]
    half_opens = [i for i, k in enumerate(recorded) if k == m.ev.BREAKER_HALF_OPEN]
    for idx in [i for i, k in enumerate(recorded) if k == m.ev.HEAL_START]:
        if idx > opens[0]:
            assert any(h < idx for h in half_opens)
    return observed(m, world, say)


def sc_kill_restart_without_double_heal(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.preempt(1, at=60.0)
    policy = m.sup.SupervisePolicy(interval=30.0, flap_threshold=2, heal_burst=1,
                                   heal_refill_s=600.0)
    plan = m.faults.FaultPlan([m.faults.FaultRule(match="tpu-vm list", after=4, kill=True)],
                              echo=lambda line: None)
    world_quiet = world.run_quiet
    world.run_quiet = plan.wrap(world_quiet)
    first = Say()
    run_killed(m, build(m, world, clock, prompter=first, policy=policy), clock, 20)
    assert world.applies == [[1]]
    recorded = kinds(m, world)
    assert recorded.count(m.ev.HEAL_DONE) == 1 and m.ev.SUPERVISOR_STOP not in recorded
    world.run_quiet = world_quiet
    second = Say()
    run_sim(build(m, world, clock, prompter=second, policy=policy), clock, ticks=4)
    assert world.applies == [[1]]
    doc = status(world)
    assert doc["heals"]["attempted"] == 1 and doc["verdict"] == "healthy"
    world.preempt(1, at=clock.time())
    third = Say()
    run_sim(build(m, world, clock, prompter=third, policy=policy), clock, ticks=14)
    assert kinds(m, world).count(m.ev.RATE_LIMITED) >= 1
    assert len(world.applies) == 2
    starts = [r for r in replay(m, world) if r["kind"] == m.ev.HEAL_START]
    assert starts[1]["ts"] - starts[0]["ts"] >= 600.0
    return observed(m, world, first, second, third)


def sc_kill_mid_heal_crash_signature(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.preempt(1, at=60.0)
    plan = m.faults.FaultPlan([m.faults.FaultRule(match="terraform apply", kill=True)],
                              echo=lambda line: None)
    world_run = world.run
    world.run = plan.wrap(world_run)
    policy = m.sup.SupervisePolicy(interval=30.0, heal_burst=2, heal_refill_s=600.0)
    first = Say()
    run_killed(m, build(m, world, clock, prompter=first, policy=policy), clock, 20)
    assert world.applies == []
    assert len(m.ev.fold(replay(m, world)).open_heals) == 1
    world.run = world_run
    second = Say()
    run_sim(build(m, world, clock, prompter=second, policy=policy), clock, ticks=5)
    assert "resuming after a crash mid-heal" in second.text()
    assert world.applies == [[1]]
    doc = status(world)
    assert doc["verdict"] == "healthy"
    assert doc["heals"]["attempted"] == 2 and doc["heals"]["succeeded"] == 1
    return observed(m, world, first, second)


def counting_quiet(world):
    counts = {"list": 0, "ssh": 0}
    orig = world.run_quiet

    def quiet(args, cwd=None, **kwargs):
        if args and args[0] == "gcloud":
            counts["list"] += 1
        elif args and args[0] == "ssh":
            counts["ssh"] += 1
        return orig(args, cwd=cwd, **kwargs)

    world.run_quiet = quiet
    return counts


def sc_dirty_set_probes_changed_not_fleet(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, num_slices=12)
    counts = counting_quiet(world)
    policy = m.sup.SupervisePolicy(interval=30.0, page_size=4, sweep_slices=2)
    say = Say()
    supervisor = build(m, world, clock, prompter=say, policy=policy)
    seen = []
    run_sim(supervisor, clock, ticks=1)
    seen.append(dict(counts))
    assert counts == {"list": 3, "ssh": 24 * world.hosts}
    counts["list"] = counts["ssh"] = 0
    run_sim(supervisor, clock, ticks=1)
    seen.append(dict(counts))
    assert counts == {"list": 3, "ssh": 4 * world.hosts}
    world.preempt(7, at=clock.time())
    run_sim(supervisor, clock, ticks=4)
    assert world.applies == [[7]]
    doc = status(world)
    assert doc["verdict"] == "healthy" and doc["slice_states"] == {"healthy": 12}
    return observed(m, world, say, counts=seen)


def sc_sweep_catches_listing_invisible_drift(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, num_slices=8)
    world.drain(6, start=40.0, until=10_000.0)
    policy = m.sup.SupervisePolicy(interval=30.0, page_size=4, sweep_slices=2)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy), clock, ticks=6)
    assert m.ev.MAINTENANCE in kinds(m, world)
    assert "draining for maintenance" in say.text()
    assert world.applies == []
    return observed(m, world, say)


def sc_parallel_heals_in_wave_time(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, num_slices=6)
    for i in range(4):
        world.preempt(i, at=60.0)
    policy = m.sup.SupervisePolicy(interval=30.0, flap_threshold=2, heal_burst=2,
                                   heal_refill_s=3600.0, heal_workers=2)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy, hooks=clock), clock, ticks=10)
    assert sorted(i for order in world.applies for i in order) == [0, 1, 2, 3]
    assert all(len(order) == 1 for order in world.applies)
    records = replay(m, world)
    starts = [r for r in records if r["kind"] == m.ev.HEAL_START]
    dones = [r for r in records if r["kind"] == m.ev.HEAL_DONE]
    assert len(starts) == 4 and len(dones) == 4
    assert max(r["ts"] for r in dones) - min(r["ts"] for r in starts) == 240.0
    doc = status(world)
    assert doc["verdict"] == "healthy"
    assert doc["heals"]["attempted"] == 4 and doc["heals"]["succeeded"] == 4
    return observed(m, world, say)


def sc_parallel_failures_stop_next_wave(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, num_slices=6, heal_works=False)
    for i in range(5):
        world.preempt(i, at=0.0)
    policy = m.sup.SupervisePolicy(
        interval=30.0, flap_threshold=2, heal_burst=1, heal_refill_s=36_000.0,
        heal_workers=2, breaker_threshold=3, breaker_window_s=36_000.0,
        breaker_cooldown_s=6_000.0, max_degraded=5)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy, hooks=clock,
                  readiness_timeout=60.0), clock, ticks=6)
    recorded = kinds(m, world)
    assert recorded.count(m.ev.HEAL_START) == 4
    assert m.ev.BREAKER_OPEN in recorded and m.ev.DEGRADED_HOLD in recorded
    doc = status(world)
    assert doc["verdict"] == "degraded-hold"
    assert doc["heals"]["attempted"] == 4 and doc["heals"]["failed"] == 4
    return observed(m, world, say)


def sc_domain_outage_isolates_blast_radius(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, num_slices=6, failure_domains=3)
    lost_domain = world.config.domain_of(1)
    for i in (1, 4, 0):
        world.preempt(i, at=60.0)
    policy = m.sup.SupervisePolicy(
        interval=30.0, flap_threshold=2, heal_burst=2, heal_refill_s=3600.0,
        domain_threshold=2, domain_window_s=300.0, domain_cooldown_s=300.0, heal_workers=2)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy, hooks=clock), clock, ticks=20)
    records = replay(m, world)
    outages = [r for r in records if r["kind"] == m.ev.DOMAIN_OUTAGE]
    assert [r["domain"] for r in outages] == [lost_domain]
    assert sorted(outages[0]["slices"]) == [1, 4]
    opens = [r for r in records if r["kind"] == m.ev.DOMAIN_BREAKER_OPEN]
    assert {r["domain"] for r in opens} == {lost_domain}
    close = next(r for r in records if r["kind"] == m.ev.DOMAIN_BREAKER_CLOSE
                 and r["domain"] == lost_domain)
    done_healthy = next(r for r in records
                        if r["kind"] == m.ev.HEAL_DONE and r["slices"] == [0])
    assert done_healthy["ts"] < close["ts"]
    canaries = [r for r in records if r["kind"] == m.ev.HEAL_START and r.get("canary")]
    assert len(canaries) == 1 and canaries[0]["domain"] == lost_domain
    first_into = next(r for r in records
                      if r["kind"] == m.ev.HEAL_START and set(r["slices"]) & {1, 4})
    assert first_into.get("canary") is True
    assert m.ev.DOMAIN_RECOVERED in [r["kind"] for r in records]
    doc = status(world)
    assert doc["verdict"] == "healthy" and doc["slice_states"] == {"healthy": 6}
    assert doc["domain_outages"] == 1
    assert doc["domains"][lost_domain]["breaker"] == "closed"
    assert doc["domains"][lost_domain]["outages"] == 1
    assert doc["domains"][lost_domain]["outage_active"] is False
    assert "DOMAIN OUTAGE" in say.text()
    violations = m.chaos.InvariantChecker(world.config, policy).check(records)
    assert violations == []
    return observed(m, world, say, violations=violations)


def sc_domain_failures_trip_domain_breaker_first(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, num_slices=6, failure_domains=3, heal_works=False)
    world.preempt(2, at=0.0)
    policy = m.sup.SupervisePolicy(
        interval=30.0, flap_threshold=2, heal_burst=3, heal_refill_s=600.0,
        breaker_threshold=3, breaker_window_s=36_000.0, breaker_cooldown_s=6_000.0,
        domain_threshold=3, domain_cooldown_s=6_000.0, max_degraded=1)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy, readiness_timeout=60.0),
            clock, ticks=24)
    records = replay(m, world)
    domain = world.config.domain_of(2)
    opens = [r for r in records if r["kind"] == m.ev.DOMAIN_BREAKER_OPEN]
    assert opens and all(r["domain"] == domain for r in opens)
    recorded = [r["kind"] for r in records]
    assert m.ev.DOMAIN_OUTAGE not in recorded and m.ev.BREAKER_OPEN not in recorded
    doc = status(world)
    assert doc["breaker"]["state"] == "closed"
    assert doc["domains"][domain]["breaker"] in ("open", "half-open")
    return observed(m, world, say)


def sc_kill_mid_half_open_canary(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock, heal_works=False)
    world.preempt(2, at=0.0)
    policy = m.sup.SupervisePolicy(
        interval=30.0, flap_threshold=2, heal_burst=3, heal_refill_s=600.0,
        breaker_threshold=2, breaker_window_s=36_000.0, breaker_cooldown_s=300.0)
    plan = m.faults.FaultPlan([m.faults.FaultRule(match="terraform apply", after=2, kill=True)],
                              echo=lambda line: None)
    world_run = world.run
    world.run = plan.wrap(world_run)
    first = Say()
    run_killed(m, build(m, world, clock, prompter=first, policy=policy,
                        readiness_timeout=60.0), clock, 40)
    recorded = kinds(m, world)
    assert m.ev.BREAKER_OPEN in recorded and m.ev.BREAKER_HALF_OPEN in recorded
    view = m.ev.fold(replay(m, world))
    assert view.breaker_state == "half-open" and len(view.open_heals) == 1
    world.run = world_run
    world.heal_works = True
    second = build(m, world, clock, policy=policy, readiness_timeout=60.0)
    restored = second.restore()
    assert second.breaker.state == m.sup.OPEN
    assert second.breaker.reopen_at == restored.breaker_reopen_at
    third = Say()
    run_sim(build(m, world, clock, prompter=third, policy=policy, readiness_timeout=60.0),
            clock, ticks=10)
    doc = status(world)
    assert doc["verdict"] == "healthy" and doc["breaker"]["state"] == "closed"
    violations = m.chaos.InvariantChecker(world.config, policy).check(replay(m, world))
    assert violations == []
    return observed(m, world, first, third, reopen_at=second.breaker.reopen_at,
                    violations=violations)


def sc_quota_parked_page_defers_heal(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.preempt(1, at=0.0)
    orig_quiet = world.run_quiet

    def stormy_quiet(args, cwd=None, **kwargs):
        if args and args[0] == "gcloud" and 10.0 <= clock.time() < 200.0:
            raise m.runner.CommandError(
                list(args), 1, tail="Error 429: Too Many Requests (RESOURCE_EXHAUSTED)")
        return orig_quiet(args, cwd=cwd, **kwargs)

    world.run_quiet = stormy_quiet
    policy = m.sup.SupervisePolicy(interval=30.0, flap_threshold=2, quota_defer_cap_s=600.0)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy), clock, ticks=12)
    records = replay(m, world)
    deferrals = [r for r in records if r["kind"] == m.ev.HEAL_DEFERRED]
    assert len(deferrals) == 1 and deferrals[0]["slice"] == 1
    starts = [r for r in records if r["kind"] == m.ev.HEAL_START]
    assert starts and starts[0]["ts"] >= 200.0
    assert world.applies == [[1]]
    assert "quota-parked" in say.text()
    doc = status(world)
    assert doc["verdict"] == "healthy" and doc["heals"]["deferred"] == 1
    return observed(m, world, say)


def sc_kill_compact_restart(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    world.preempt(1, at=60.0)
    policy = m.sup.SupervisePolicy(interval=30.0, flap_threshold=2, heal_burst=1,
                                   heal_refill_s=600.0)
    plan = m.faults.FaultPlan([m.faults.FaultRule(match="tpu-vm list", after=4, kill=True)],
                              echo=lambda line: None)
    world_quiet = world.run_quiet
    world.run_quiet = plan.wrap(world_quiet)
    first = Say()
    run_killed(m, build(m, world, clock, prompter=first, policy=policy), clock, 20)
    assert world.applies == [[1]]
    led = m.ev.EventLedger(world.paths.events, clock=clock.time, echo=lambda line: None)
    before = m.ev.fold(led.replay())
    assert before.heals_attempted == 1
    dropped = led.compact()
    assert dropped > 0
    snapshot = [json.loads(line) for line in world.paths.events.read_text().splitlines()
                if line.strip()]
    assert len(snapshot) == 1
    world.run_quiet = world_quiet
    second = Say()
    run_sim(build(m, world, clock, prompter=second, policy=policy), clock, ticks=4)
    assert world.applies == [[1]]
    doc = status(world)
    assert doc["verdict"] == "healthy" and doc["heals"]["attempted"] == 1
    assert doc["membership"]["generation"] >= before.membership_generation
    world.preempt(1, at=clock.time())
    third = Say()
    run_sim(build(m, world, clock, prompter=third, policy=policy), clock, ticks=14)
    assert kinds(m, world).count(m.ev.RATE_LIMITED) >= 1
    assert len(world.applies) == 2
    return observed(m, world, first, second, third, dropped=dropped, snapshot=snapshot)


def sc_auto_compacts_past_threshold(m, root):
    clock = m.simclock.SimClock()
    world = FleetSim(m, root, clock)
    policy = m.sup.SupervisePolicy(interval=30.0, compact_records=8)
    say = Say()
    run_sim(build(m, world, clock, prompter=say, policy=policy), clock, ticks=20)
    lines = [json.loads(line) for line in world.paths.events.read_text().splitlines()
             if line.strip()]
    assert len(lines) <= 10
    assert any(r["kind"] == m.ev.SNAPSHOT for r in lines)
    assert "event ledger compacted" in say.text()
    assert m.ev.fold(replay(m, world)).ticks == 20
    assert status(world)["verdict"] == "healthy"
    return observed(m, world, say, raw=lines)


SCENARIOS = {
    "single bad probe": (sc_single_bad_probe, False),
    "preemption: drain, then healed once": (sc_preemption_drain_then_healed_once, False),
    "degraded ack suppresses heal": (sc_degraded_ack_suppresses_heal, False),
    "healthy again clears suppression": (sc_healthy_again_clears_suppression, False),
    "job ack: restart does not re-record": (sc_job_ack_restart_does_not_rerecord, False),
    "heal storm trips the breaker": (sc_heal_storm_trips_breaker, False),
    "kill, restart, no double heal": (sc_kill_restart_without_double_heal, False),
    "kill mid-heal: crash signature": (sc_kill_mid_heal_crash_signature, False),
    "dirty set": (sc_dirty_set_probes_changed_not_fleet, False),
    "sweep rotation": (sc_sweep_catches_listing_invisible_drift, False),
    "parallel heals in wave time": (sc_parallel_heals_in_wave_time, True),
    "parallel failures stop the next wave": (sc_parallel_failures_stop_next_wave, True),
    "domain outage": (sc_domain_outage_isolates_blast_radius, True),
    "domain breaker before global": (sc_domain_failures_trip_domain_breaker_first, False),
    "kill mid half-open canary": (sc_kill_mid_half_open_canary, False),
    "quota-parked page defers heal": (sc_quota_parked_page_defers_heal, False),
    "kill, compact, restart": (sc_kill_compact_restart, False),
    "auto-compaction": (sc_auto_compacts_past_threshold, False),
}


@MODES
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_scenario_matches_the_reference(tmp_path, name, mode):
    scenario, parallel = SCENARIOS[name]
    both(tmp_path, scenario, parallel=parallel, mode=mode)


# ---------------------------------------------------------------- housekeeping


@pytest.mark.parametrize("mode", ["tpu-vm", "gpu-vm"])
def test_supervisor_refuses_gke_and_a_second_instance_as_the_reference(tmp_path, mode):
    """gke-gpu, on the port's side of the mirrored pair, is refused with
    the reference's gke message, word for word."""
    out = {}
    for side, m in sides(mode).items():
        root = tmp_path / side
        clock = m.simclock.SimClock()
        world = FleetSim(m, root, clock)
        gke_config = (cfg(m, **{**GPU_VM, "mode": "gke-gpu", "topology": "1x8"}) if m.gpu
                      else cfg(m, mode="gke", topology="2x2"))
        with pytest.raises(m.schema.ConfigError, match="self-repair") as gke:
            m.sup.Supervisor(gke_config, world.paths, Say())
        world.paths.supervisor_pid.write_text(f"{os.getpid()}\n")
        with pytest.raises(m.sup.SupervisorError, match="already running") as second:
            build(m, world, clock).run(ticks=1)
        out[side] = normalized([str(gke.value), str(second.value)], root, side)
    assert out["port"] == out["reference"]


def test_stop_running_matches_the_reference(tmp_path, monkeypatch):
    out = {}
    for side, m in SIDES.items():
        paths = m.state.RunPaths(tmp_path / side)
        (tmp_path / side).mkdir()
        lines = []
        seen = [m.sup.stop_running(paths, echo=lines.append)]
        paths.supervisor_pid.write_text("99999999\n")
        seen += [m.sup.stop_running(paths, echo=lines.append), paths.supervisor_pid.exists()]
        paths.supervisor_pid.write_text(f"{os.getpid()}\n")
        sent = []
        holders = iter([os.getpid(), None])
        monkeypatch.setattr(m.sup.PidLock, "holder", lambda self: next(holders))
        seen.append(m.sup.stop_running(paths, echo=lines.append,
                                       kill=lambda pid, sig: sent.append((pid, sig)),
                                       sleep=lambda s: None))
        monkeypatch.undo()
        seen += [sent == [(os.getpid(), signal.SIGTERM)], paths.supervisor_pid.exists()]
        assert seen == [False, False, False, True, True, False]
        out[side] = [seen, lines]
    assert out["port"] == out["reference"]


def test_supervise_policy_from_env_matches_the_reference(monkeypatch):
    environ = {"TK8S_SUPERVISE_INTERVAL": "7.5", "TK8S_SUPERVISE_FLAP_THRESHOLD": "4",
               "TK8S_SUPERVISE_BREAKER_THRESHOLD": "9", "TK8S_SUPERVISE_SWEEP": "3",
               "TK8S_SUPERVISE_DOMAIN_WINDOW": "120", "TK8S_SUPERVISE_COMPACT": ""}
    for name, value in environ.items():
        monkeypatch.setenv(name, value)
    out = {}
    for side, m in SIDES.items():
        policy = m.sup.SupervisePolicy.from_env()
        assert policy.interval == 7.5 and policy.flap_threshold == 4
        assert policy.breaker_threshold == 9 and policy.heal_burst == 2
        assert policy == m.sup.SupervisePolicy.from_env(environ)
        out[side] = [vars(policy), dict(m.sup.SupervisePolicy._ENV)]
    out = {side: json.loads(json.dumps(v, default=lambda t: t.__name__))
           for side, v in out.items()}
    assert out["port"] == out["reference"]


# ------------------------------------------- autoscale, allocator, telemetry


def demand_doc(now, queue_depth=0, inflight=None, sheds=0, p99=None, rate=None):
    return {"v": 1, "updated": now, "queue_depth": queue_depth, "service_rate": rate,
            "p99_s": p99, "recent_sheds": sheds, "deadline_headroom_s": None,
            "inflight": {str(k): v for k, v in (inflight or {}).items()},
            "active_workers": []}


def write_demand(m, path, now, **kwargs):
    m.state.atomic_write_text(path, json.dumps(demand_doc(now, **kwargs)))


def tick_n(m, supervisor, clock, world, n, interval=30.0, demand=None):
    for _ in range(n):
        if demand is not None:
            write_demand(m, world.paths.demand_signal, clock.time(), **demand)
        supervisor.tick()
        clock.sleep(interval)


class TwoHosts:
    """A `ChaosFleet` seen with two host IPs a slice, for both sides of a
    mirrored pair: host 1 of the slice at `10.a.b.c` is `11.a.b.c`, and
    answers SSH as host 0 does."""

    def __init__(self, world):
        self.world = world
        hosts = json.loads(world.paths.hosts_file.read_text())
        for key in ("host_ips", "internal_ips"):
            hosts[key] = [self.both(ips) for ips in hosts[key]]
        world.paths.hosts_file.write_text(json.dumps(hosts))

    @staticmethod
    def both(ips):
        return [ip for first in ips for ip in (first, "11." + first.split(".", 1)[1])]

    def run(self, args, cwd=None, **kwargs):
        return self.world.run(args, cwd=cwd, **kwargs)

    def run_quiet(self, args, cwd=None, **kwargs):
        args = list(args)
        if args[:1] == ["ssh"] and args[-2].startswith("11."):
            args[-2] = "10." + args[-2].split(".", 1)[1]
        out = self.world.run_quiet(args, cwd=cwd, **kwargs)
        if args[:3] == ["terraform", "output", "-json"]:
            doc = json.loads(out)
            out = json.dumps({k: {"value": [self.both(ips) for ips in v["value"]]}
                              for k, v in doc.items()})
        return out


def chaos_world(m, root, clock, num_slices, **kwargs):
    """The chaos fleet, its config and the RunFn pair the side's supervisor
    runs on (two hosts a slice, and the gpu-vm view, on a mirrored pair)."""
    config = m.chaos.sim_config(num_slices)
    if m.mirror:
        config = dataclasses.replace(config, zone=MIRROR_ZONE)
    world = m.chaos.ChaosFleet(root, clock, config, **kwargs)
    sup_config, view = gpu_view(m, TwoHosts(world) if m.mirror else world, config)
    if m.gpu:
        world.paths.terraform_module(sup_config.mode).mkdir(parents=True)
    return world, sup_config, view


def chaos_supervisor(m, root, clock, num_slices=4, heal_seconds=30.0, **controllers):
    world, config, view = chaos_world(m, root, clock, num_slices, heal_seconds=heal_seconds,
                                      teardown_seconds=10.0)
    quiet = m.chaos._Quiet()
    sup = m.sup.Supervisor(
        config, world.paths, quiet, run=view.run, run_quiet=view.run_quiet,
        policy=m.chaos.default_policy(),
        ledger=m.ev.EventLedger(world.paths.events, clock=clock.time, echo=lambda line: None),
        clock=clock.time, sleep=clock.sleep, rng=lambda: 0.0, readiness_timeout=60.0,
        hooks=clock, **controllers)
    return world, sup, quiet


def make_autoscaler(m, envelope=4):
    policy = m.autoscale.AutoscalePolicy(
        min_slices=1, max_slices=envelope, up_queue_per_slice=8.0, down_queue_per_slice=2.0,
        slo_p99_s=30.0, confirm_up=2, confirm_down=3, cooldown_s=30.0, cooldown_cap_s=300.0,
        drain_timeout_s=120.0, signal_max_age_s=90.0)
    return m.autoscale.Autoscaler(
        policy, envelope,
        cooldown=m.retry.Cooldown(policy.cooldown_s, policy.cooldown_cap_s, rng=lambda: 0.0))


def sc_autoscale_up_on_confirmed_demand(m, root):
    clock = m.simclock.SimClock()
    world, sup, quiet = chaos_supervisor(m, root, clock, autoscaler=make_autoscaler(m))
    sup._active = {0, 1}
    world.removed |= {2, 3}
    clock.begin()
    try:
        sup.restore()
        tick_n(m, sup, clock, world, 3, demand=dict(queue_depth=60))
    finally:
        clock.release()
    records = sup.ledger.replay()
    assert m.ev.SCALE_DECISION in [r["kind"] for r in records]
    starts = [r for r in records if r["kind"] == m.ev.SCALE_START]
    dones = [r for r in records if r["kind"] == m.ev.SCALE_DONE]
    assert starts and starts[0]["direction"] == "up"
    assert dones and dones[0]["id"] == starts[0]["id"]
    assert sup._active == {0, 1, 2, 3} and world.removed == set()
    assert any(2 in replaced or 3 in replaced for replaced in world.applies)
    doc = sup.status_doc(clock.time())
    assert doc["autoscale"]["actual"] == 4
    return observed(m, world, quiet, doc=doc, destroys=world.destroys)


def sc_autoscale_drains_then_tears_down(m, root):
    clock = m.simclock.SimClock()
    world, sup, quiet = chaos_supervisor(m, root, clock, autoscaler=make_autoscaler(m))
    clock.begin()
    try:
        sup.restore()
        tick_n(m, sup, clock, world, 4, demand=dict(queue_depth=0, inflight={3: 2}))
        mid = sup.status_doc(clock.time())
        assert mid["autoscale"]["in_progress"]["direction"] == "down"
        assert mid["membership"]["draining"] == [3]
        assert 3 not in mid["serving"]["eligible"]
        assert world.destroys == []
        tick_n(m, sup, clock, world, 1, demand=dict(queue_depth=0, inflight={3: 0}))
    finally:
        clock.release()
    assert world.destroys == [[3]] and world.removed == {3} and sup._active == {0, 1, 2}
    done = [r for r in sup.ledger.replay() if r["kind"] == m.ev.SCALE_DONE]
    assert done and done[0]["direction"] == "down" and done[0]["stragglers"] == 0
    doc = sup.status_doc(clock.time())
    assert doc["autoscale"]["actual"] == 3 and doc["slices_total"] == 3
    return observed(m, world, quiet, mid=mid, doc=doc, destroys=world.destroys)


def make_allocator(m, envelope=4, **overrides):
    policy = m.allocator.AllocatorPolicy(
        min_serving=1, min_training=0, train_slices=2, up_queue_per_slice=6.0,
        slo_p99_s=60.0, idle_queue_per_slice=2.0, idle_p99_margin=0.5, confirm_to_serving=2,
        confirm_to_training=3, cooldown_s=30.0, cooldown_cap_s=600.0, ack_timeout_s=60.0,
        drain_timeout_s=120.0, idle_inflight_per_slice=3.0, signal_max_age_s=90.0)
    for key, value in overrides.items():
        setattr(policy, key, value)
    return m.allocator.Allocator(
        policy, envelope,
        cooldown=m.retry.Cooldown(policy.cooldown_s, policy.cooldown_cap_s, rng=lambda: 0.0))


def sc_allocator_lends_idle_slices(m, root):
    clock = m.simclock.SimClock()
    world, sup, quiet = chaos_supervisor(m, root, clock,
                                         allocator=make_allocator(m, train_slices=0))
    clock.begin()
    try:
        sup.restore()
        tick_n(m, sup, clock, world, 4, demand=dict(queue_depth=0, rate=2.0))
    finally:
        clock.release()
    records = sup.ledger.replay()
    notices = [r for r in records if r["kind"] == m.ev.PREEMPT_NOTICE]
    changed = [r for r in records if r["kind"] == m.ev.ROLE_CHANGED]
    assert notices and notices[0]["direction"] == "to-training"
    assert changed and changed[-1]["role"] == "training"
    doc = sup.status_doc(clock.time())
    assert doc["allocation"]["training"] == changed[-1]["slices"]
    assert not set(changed[-1]["slices"]) & set(doc["serving"]["eligible"])
    return observed(m, world, quiet, doc=doc)


def sc_supervisor_telemetry(m, root):
    clock = m.simclock.SimClock()
    world, config, view = chaos_world(m, root, clock, 2)
    telemetry = m.obs.Telemetry.for_run(world.paths, clock=clock.time, plane="supervisor",
                                        fsync=False, echo=lambda line: None)
    quiet = m.chaos._Quiet()
    sup = m.sup.Supervisor(
        config, world.paths, quiet, run=view.run, run_quiet=view.run_quiet,
        policy=m.chaos.default_policy(), clock=clock.time, sleep=clock.sleep,
        rng=lambda: 0.0, readiness_timeout=60.0, hooks=clock, telemetry=telemetry)
    clock.begin()
    try:
        sup.tick()
        clock.sleep(30.0)
        sup.tick()
    finally:
        clock.release()
    snap = json.loads(world.paths.metrics_snapshot.read_text())
    assert m.metrics.counter_total(snap, "supervisor_ticks_total") == 2
    assert m.metrics.gauge_value(snap, "supervisor_last_tick_seconds") is not None
    spans = telemetry.tracer.log.spans()
    assert {"tick", "diagnose"} <= {s["span"] for s in spans}
    doc = sup.status_doc(clock.time())
    assert doc["telemetry"]["metrics_snapshot"] == str(world.paths.metrics_snapshot)
    assert doc["telemetry"]["last_tick_s"] is not None
    assert doc["telemetry"]["span_log_bytes"] is not None
    # the registry's metric names are the reference's (the scrape surface)
    names = sorted({k for k in snap.get("metrics", snap)})
    return observed(m, world, quiet, snapshot=snap, names=names, spans=spans, doc=doc)


CONTROLLER_SCENARIOS = {
    "autoscale: up on confirmed demand": sc_autoscale_up_on_confirmed_demand,
    "autoscale: drain, then tear down": sc_autoscale_drains_then_tears_down,
    "allocator: lends idle slices": sc_allocator_lends_idle_slices,
    "telemetry: metrics snapshot and spans": sc_supervisor_telemetry,
}


@MODES
@pytest.mark.parametrize("name", sorted(CONTROLLER_SCENARIOS))
def test_supervisor_controllers_match_the_reference(tmp_path, name, mode):
    both(tmp_path, CONTROLLER_SCENARIOS[name], mode=mode)


# ------------------------------------------------- the supervised elastic co-drive


class DictCheckpoint:
    """A checkpoint store over plain dict states (the trainer's
    latest_step / save / restore surface)."""

    def __init__(self):
        self.store = {}

    def latest_step(self):
        return max(self.store) if self.store else None

    def save(self, step, state, wait=False):
        self.store[step] = dict(state)

    def restore(self, state, shardings=None, step=None):
        return dict(self.store[max(self.store) if step is None else step])


def test_the_supervised_elastic_drill_equals_the_reference_drill(tmp_path):
    """`chip_smoke.supervised_elastic_drill`, the co-drive of the port's
    supervisor and trainer that phase 33 runs on the card, here with the
    reference drill's modeled step (the virtual step time only) at its
    defaults (4 slices, a tick every 30 s, slice 3 preempted at 300 s,
    1.5 s steps, a checkpoint every 30 of 400), reports what
    `bench_provision.run_elastic_drill()` reports, field by field."""
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import bench_provision
    import chip_smoke
    from tritonk8ssupervisor_tpu_torch.parallel import elastic

    def setup():
        return elastic.TrainSession({"n": 0}, None, lambda state: ({"n": state["n"] + 1}, {}))

    ours = chip_smoke.supervised_elastic_drill(tmp_path, setup, lambda session, i: (),
                                               DictCheckpoint())
    ref = bench_provision.run_elastic_drill()
    fields = ("final_step", "steps_lost", "resumes", "resume_degraded", "waited_s",
              "time_to_training_resumed_s", "budget_s", "heal_applies", "ledger",
              "num_slices", "interval_s", "preempt_at_s", "lost_slice", "step_s",
              "checkpoint_every_steps", "checkpoint_interval_s", "total_steps")
    assert {k: ours[k] for k in fields} == {k: ref[k] for k in fields}
    assert ours["heal_applies"] == [[3]] and ours["final_step"] == 400
    assert 0 < ours["steps_lost"] <= 30 and ours["ledger"]["job_mttr_s"] is not None
    assert ours["steps_run"] == 400 + ours["steps_lost"] + ours["resumes"]
    kinds = [r["kind"] for r in ours["records"]]
    assert kinds.index(events.JOB_NOTIFIED) < kinds.index(events.JOB_RESUMED)
