"""The port's co-scheduling drive and campaigns (`testing/chaos.py`:
`KillOnKindLedger`, `VirtualTrainer`, `default_alloc_policy`,
`_alloc_summary`, `_training_slice_seconds`, `run_coschedule_drive`,
`generate_coschedule_scenario` and `run_coschedule_campaign`) against the
JAX package's: equal scenarios per seed; seeded campaigns and the three
named drills of `bench_provision.run_allocator_benchmark` (a supervisor
SIGKILL mid-handover, a trainer that never acks, a tenant flood against
the WFQ admission queue) that give the same ledgers, request journals,
span logs, published documents (the job ack among them) and result dicts
through both packages, with zero violations and the reference's own
asserts (tests/test_allocator.py, bench_provision.py); and
tests/test_allocator.py's kill mid-handover through both packages.

The drives run on tests/test_torch_serve_chaos.py's `TurnClock`, one
actor at a time (the trainer and the gateway in the calling thread, the
supervisor in its own). The drills run the benchmark's trace cut to
1500 s, as `run_coschedule_cost_drives` allows; the 25-seed sweep stays
behind the `chaos` marker.
"""

import dataclasses
import json
import types

import pytest

from bench_provision import (
    COSCHEDULE_CHECKPOINT_EVERY,
    COSCHEDULE_TRAFFIC,
    COSCHEDULE_TRAINER_RATE,
)
from test_torch_serve_chaos import drive_both, one_actor_at_a_time
from test_torch_supervisor import normalized
from tritonk8ssupervisor_tpu.provision import allocator as ref_allocator
from tritonk8ssupervisor_tpu.provision import events as ref_events
from tritonk8ssupervisor_tpu.provision import retry as ref_retry
from tritonk8ssupervisor_tpu.provision import supervisor as ref_sup
from tritonk8ssupervisor_tpu.provision.state import atomic_write_text as ref_atomic_write
from tritonk8ssupervisor_tpu.serving import gateway as ref_gateway
from tritonk8ssupervisor_tpu.testing import chaos as ref_chaos
from tritonk8ssupervisor_tpu.testing import faults as ref_faults
from tritonk8ssupervisor_tpu.testing import simclock as ref_simclock
from tritonk8ssupervisor_tpu_torch.provision import allocator, events, retry
from tritonk8ssupervisor_tpu_torch.provision import supervisor as sup_mod
from tritonk8ssupervisor_tpu_torch.provision.state import atomic_write_text
from tritonk8ssupervisor_tpu_torch.serving import gateway
from tritonk8ssupervisor_tpu_torch.testing import chaos, faults, simclock

PACKAGES = {
    "reference": types.SimpleNamespace(
        chaos=ref_chaos, events=ref_events, allocator=ref_allocator, retry=ref_retry,
        sup=ref_sup, gateway=ref_gateway, faults=ref_faults, simclock=ref_simclock,
        atomic_write_text=ref_atomic_write),
    "port": types.SimpleNamespace(
        chaos=chaos, events=events, allocator=allocator, retry=retry, sup=sup_mod,
        gateway=gateway, faults=faults, simclock=simclock, atomic_write_text=atomic_write_text),
}
DRILL_TRAFFIC = dict(COSCHEDULE_TRAFFIC, duration_s=1500.0)
TRAINER = dict(trainer_rate=COSCHEDULE_TRAINER_RATE, checkpoint_every=COSCHEDULE_CHECKPOINT_EVERY)


def test_generate_coschedule_scenario_equals_the_reference_per_seed():
    kinds = set()
    for seed in range(40):
        ours = chaos.generate_coschedule_scenario(seed)
        ref = ref_chaos.generate_coschedule_scenario(seed)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        kinds |= {e["kind"] for e in ours.events}
    assert chaos.generate_coschedule_scenario(42) == chaos.generate_coschedule_scenario(42)
    assert chaos.generate_coschedule_scenario(42) != chaos.generate_coschedule_scenario(43)
    assert set(chaos.COSCHEDULE_PRIMITIVES) <= kinds
    assert chaos.COSCHEDULE_PRIMITIVES == ref_chaos.COSCHEDULE_PRIMITIVES
    for n in (2, 4):
        assert vars(chaos.default_alloc_policy(n)) == vars(ref_chaos.default_alloc_policy(n))


@pytest.mark.parametrize("seed", (1, 4))  # surge preemption; a supervisor kill mid-handover
def test_coschedule_campaign_equals_the_reference_with_zero_violations(
        tmp_path, monkeypatch, seed):
    """tests/test_allocator.py's tier-1 smoke, through both packages."""
    one_actor_at_a_time(monkeypatch)
    doc = drive_both(tmp_path, lambda mod, root: mod.run_coschedule_campaign(
        mod.generate_coschedule_scenario(seed), root), seed=seed)
    out = doc["result"]
    assert out["violations"] == []
    assert out["converged"] is True
    assert out["handovers"]["notices"] > 0
    assert out["training"]["steps"] > 0
    assert doc["files"]["job-ack.json"] is not None


def _killed_mid_handover(out):
    assert out["supervisor_restarts"] >= 1


def _never_acked(out):
    assert out["handovers"]["forced"] >= 1


def _flooded(out):
    assert out["offered"] > out["accepted"]  # the flood was shed, not served
    assert out["training"]["steps"] > 0


# bench_provision.run_allocator_benchmark's three named drills and its pass
# conditions for each (the flood's fairness check is among the violations)
DRILLS = {
    "supervisor-kill-mid-handover": (dict(kill_on_notice=1), _killed_mid_handover),
    "never-acking-trainer": (dict(trainer_ack=False), _never_acked),
    "tenant-flood": (dict(tenants={"base": 3.0, "flood": 1.0},
                          flood={"tenant": "flood", "at": 500.0, "duration": 180.0,
                                 "rps": 6.0}), _flooded),
}


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_named_drill_equals_the_reference_with_zero_violations(tmp_path, monkeypatch, name):
    options, holds = DRILLS[name]
    one_actor_at_a_time(monkeypatch)
    doc = drive_both(tmp_path, lambda mod, root: mod.run_coschedule_drive(
        root, num_slices=4, alloc_policy=mod.default_alloc_policy(4), **options, **TRAINER,
        **DRILL_TRAFFIC))
    out = doc["result"]
    assert out["violations"] == [], (name, out["violations"])
    assert out["converged"] is True
    assert out["coscheduled"] is True and out["handovers"]["notices"] > 0
    holds(out)


# ------------------------------------------------- the kill mid-handover


def _make_allocator(m, envelope=4, **overrides):
    policy = m.allocator.AllocatorPolicy(
        min_serving=1, min_training=0, train_slices=0,
        up_queue_per_slice=6.0, slo_p99_s=60.0,
        idle_queue_per_slice=2.0, idle_p99_margin=0.5,
        confirm_to_serving=2, confirm_to_training=3,
        cooldown_s=60.0, cooldown_cap_s=600.0,
        ack_timeout_s=60.0, drain_timeout_s=120.0,
        idle_inflight_per_slice=3.0, signal_max_age_s=90.0,
    )
    for key, value in overrides.items():
        setattr(policy, key, value)
    return m.allocator.Allocator(policy, envelope, cooldown=m.retry.Cooldown(
        policy.cooldown_s, policy.cooldown_cap_s, rng=lambda: 0.0))


def _write_demand(m, path, now, queue_depth):
    m.atomic_write_text(path, json.dumps({
        "v": 1, "updated": now, "queue_depth": queue_depth, "service_rate": 2.0,
        "p99_s": None, "recent_sheds": 0, "deadline_headroom_s": None, "inflight": {},
        "active_workers": []}))


def _tick_n(m, supervisor, clock, world, n):
    for _ in range(n):
        _write_demand(m, world.paths.demand_signal, clock.time(), 60)
        supervisor.tick()
        clock.sleep(30.0)


def kill_mid_handover(m, root) -> dict:
    """tests/test_allocator.py::test_sigkill_mid_handover_resumes_same_id
    with package `m`: a `KillOnKindLedger` kills the supervisor on the
    first PREEMPT_NOTICE; the restarted one resumes the open handover."""
    clock = m.simclock.SimClock()
    config = m.chaos.sim_config(4)
    world = m.chaos.ChaosFleet(root, clock, config, heal_seconds=30.0)
    ledger = m.chaos.KillOnKindLedger(world.paths.events, clock=clock.time,
                                      echo=lambda line: None,
                                      kill_kind=m.events.PREEMPT_NOTICE, kill_after=1)

    def make_supervisor():
        return m.sup.Supervisor(
            config, world.paths, m.chaos._Quiet(), run=world.run, run_quiet=world.run_quiet,
            policy=m.chaos.default_policy(), ledger=ledger, clock=clock.time,
            sleep=clock.sleep, rng=lambda: 0.0, readiness_timeout=60.0, hooks=clock,
            allocator=_make_allocator(m, envelope=4, train_slices=2, ack_timeout_s=60.0,
                                      cooldown_s=30.0))

    supervisor = make_supervisor()
    killed_at = None
    clock.begin()
    try:
        supervisor.restore()
        for _ in range(3):
            _write_demand(m, world.paths.demand_signal, clock.time(), 60)
            try:
                supervisor.tick()
            except m.faults.SupervisorKilled:
                killed_at = clock.time()
                break
            clock.sleep(30.0)
        first_lines = list(supervisor.prompter.lines)
        supervisor = make_supervisor()
        view = supervisor.restore()
        open_handover = dict(view.open_handover) if view.open_handover else None
        resumed_text = supervisor.prompter.text()
        m.atomic_write_text(world.paths.job_ack, json.dumps({
            "v": 1, "ts": clock.time(), "phase": "notified",
            "generation": view.membership_generation, "step": 100, "world": 2,
            "slices": [], "reason": "drain notice"}))
        _tick_n(m, supervisor, clock, world, 2)
    finally:
        clock.release()
    records = supervisor.ledger.replay()
    checker = m.chaos.ServeInvariantChecker(m.gateway.GatewayPolicy(),
                                            alloc_policy=supervisor.allocator.policy)
    return {"records": records, "killed_at": killed_at, "open_handover": open_handover,
            "resumed_text": resumed_text, "lines": [first_lines, supervisor.prompter.lines],
            "handover_violations": checker.check_handover_protocol(records),
            "exclusivity_violations": checker.check_role_exclusivity(records)}


def test_kill_mid_handover_resumes_the_same_id_as_the_reference(tmp_path):
    out = {}
    for side, m in PACKAGES.items():
        root = tmp_path / side
        out[side] = normalized(kill_mid_handover(m, root), root, side)
    assert out["port"] == out["reference"]
    port = out["port"]
    assert port["killed_at"] is not None, "the scripted kill on PREEMPT_NOTICE never fired"
    assert port["open_handover"] is not None
    assert "resuming after a crash mid-handover" in port["resumed_text"]
    notices = [r for r in port["records"] if r["kind"] == events.PREEMPT_NOTICE]
    changed = [r for r in port["records"]
               if r["kind"] == events.ROLE_CHANGED and not r.get("initial")]
    assert len(notices) == 1, "restart minted a sibling handover"
    assert changed and changed[0]["id"] == notices[0]["id"] == port["open_handover"]["id"]
    assert port["handover_violations"] == [] and port["exclusivity_violations"] == []


def test_kill_on_kind_ledger_raises_after_the_nth_record_of_its_kind(tmp_path):
    """The n-th record of the kind is on the ledger when the kill lands,
    and records of other kinds never count, in both packages."""
    seen = {}
    for side, m in PACKAGES.items():
        ledger = m.chaos.KillOnKindLedger(tmp_path / f"{side}.jsonl", clock=lambda: 5.0,
                                          echo=lambda line: None,
                                          kill_kind=m.events.SCALE_START, kill_after=2)
        ledger.append(m.events.SCALE_START, id="s1", slices=[1])
        ledger.append(m.events.TICK, states={})
        with pytest.raises(m.faults.SupervisorKilled):
            ledger.append(m.events.SCALE_START, id="s2", slices=[2])
        ledger.append(m.events.SCALE_START, id="s3", slices=[3])  # past the kill: plain
        seen[side] = ledger.replay()
    assert seen["port"] == seen["reference"]
    assert [r.get("id") for r in seen["port"]] == ["s1", None, "s2", "s3"]


@pytest.mark.chaos
def test_coschedule_twentyfive_seed_campaign(tmp_path):
    """The full co-scheduling sweep through the port: 25 seeded campaigns,
    zero violations, all converged."""
    failures = []
    for seed in range(1, 26):
        out = chaos.run_coschedule_campaign(chaos.generate_coschedule_scenario(seed),
                                            tmp_path / f"seed-{seed}")
        if out["violations"] or not out["converged"]:
            failures.append((seed, out["events"], out["violations"]))
    assert failures == []
