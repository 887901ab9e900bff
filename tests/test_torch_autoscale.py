"""The port's autoscaler and allocator (`provision/autoscale.py`,
`provision/allocator.py`) against the reference's: the scripted scenarios
of tests/test_autoscale.py and tests/test_allocator.py and seeded walks of
demand signals (fresh, stale, torn, shedding, slow, idle, cold) give equal
decisions, streaks and cooldown expiries step by step, under one clock and
one cooldown jitter; demand documents parse and read alike (absent, torn,
wrong shape); shards merge alike; and `read_fleet_demand` over the shards
the port's `GatewayFleet` writes equals the reference's over the same
files. No tolerance."""

import dataclasses
import json
import random
import types
from pathlib import Path

import numpy as np
import pytest

from tritonk8ssupervisor_tpu.provision import allocator as ref_allocator
from tritonk8ssupervisor_tpu.provision import autoscale as ref_autoscale
from tritonk8ssupervisor_tpu.provision import retry as ref_retry
from tritonk8ssupervisor_tpu_torch.provision import allocator, autoscale, retry
from tritonk8ssupervisor_tpu_torch.testing import chaos

SIDES = {
    "port": types.SimpleNamespace(autoscale=autoscale, allocator=allocator, retry=retry),
    "reference": types.SimpleNamespace(autoscale=ref_autoscale, allocator=ref_allocator,
                                       retry=ref_retry),
}


def demand_doc(now, queue_depth=0, inflight=None, sheds=0, p99=None, rate=None,
               kv_free=None, workers=()):
    return {"v": 1, "updated": now, "queue_depth": queue_depth, "service_rate": rate,
            "p99_s": p99, "recent_sheds": sheds, "deadline_headroom_s": None,
            "inflight": {str(k): v for k, v in (inflight or {}).items()},
            "active_workers": list(workers), "kv_pages_free": kv_free}


def as_data(value):
    if dataclasses.is_dataclass(value):
        return [type(value).__name__, dataclasses.asdict(value)]
    return value


def make_autoscaler(m, seed=0, envelope=4, **overrides):
    policy = m.autoscale.AutoscalePolicy(
        min_slices=1, max_slices=envelope, up_queue_per_slice=8.0, down_queue_per_slice=2.0,
        slo_p99_s=30.0, confirm_up=2, confirm_down=3, cooldown_s=60.0, cooldown_cap_s=600.0,
        drain_timeout_s=120.0, signal_max_age_s=90.0)
    for key, value in overrides.items():
        setattr(policy, key, value)
    cooldown = m.retry.Cooldown(policy.cooldown_s, policy.cooldown_cap_s,
                                rng=random.Random(seed).random)
    return m.autoscale.Autoscaler(policy, envelope, cooldown=cooldown)


def make_allocator(m, seed=0, envelope=4, **overrides):
    policy = m.allocator.AllocatorPolicy(
        min_serving=1, min_training=0, train_slices=0, up_queue_per_slice=6.0, slo_p99_s=60.0,
        idle_queue_per_slice=2.0, idle_p99_margin=0.5, confirm_to_serving=2,
        confirm_to_training=3, cooldown_s=60.0, cooldown_cap_s=600.0, ack_timeout_s=60.0,
        drain_timeout_s=120.0, idle_inflight_per_slice=3.0, signal_max_age_s=90.0)
    for key, value in overrides.items():
        setattr(policy, key, value)
    cooldown = m.retry.Cooldown(policy.cooldown_s, policy.cooldown_cap_s,
                                rng=random.Random(seed).random)
    return m.allocator.Allocator(policy, envelope, cooldown=cooldown)


def walk(seed: int, steps: int = 60) -> list:
    """(now, document or None) pairs: a seeded walk through busy, idle,
    shedding, slow, cold, stale and torn windows."""
    rng = np.random.default_rng(seed)
    out, now = [], 0.0
    for _ in range(steps):
        now += float(rng.choice([10.0, 30.0, 45.0]))
        kind = rng.choice(["busy", "busy", "idle", "idle", "calm", "shed", "slow", "cold",
                           "stale", "torn"])
        inflight = {int(i): int(rng.integers(0, 5)) for i in range(int(rng.integers(0, 4)))}
        rate = None if kind == "cold" else float(rng.uniform(0.5, 4.0))
        depth = {"busy": int(rng.integers(20, 120)), "idle": 0, "calm": int(rng.integers(3, 12)),
                 "shed": int(rng.integers(0, 5)), "slow": 0, "cold": 0, "stale": 80,
                 "torn": 0}[kind]
        doc = demand_doc(now - (200.0 if kind == "stale" else float(rng.uniform(0, 5))),
                         queue_depth=depth, inflight=inflight,
                         sheds=int(rng.integers(1, 4)) if kind == "shed" else 0,
                         p99=float(rng.uniform(40, 90)) if kind == "slow" else None,
                         rate=rate, kv_free=int(rng.integers(0, 64)))
        out.append((now, None if kind == "torn" else doc))
    return out


def drive_autoscaler(m, seed: int, overrides: dict) -> list:
    scaler = make_autoscaler(m, seed=seed, **overrides)
    active, record = 2, []
    for step, (now, doc) in enumerate(walk(seed)):
        signal = None if doc is None else m.autoscale.parse_demand_signal(doc)
        fresh = scaler.fresh(signal, now)
        reasons = ([scaler.up_reason(signal, active), scaler.down_reason(signal, active)]
                   if signal is not None else None)
        decision = scaler.observe(signal, active, now)
        entry = [step, fresh, reasons, as_data(decision), scaler.up_streak, scaler.down_streak,
                 scaler.cooldown_until]
        if decision is not None:
            entry.append(scaler.note_action(now))
            active = decision.to_count
            if step % 3 == 0:
                scaler.note_done()
        record.append(entry)
    return record


def drive_allocator(m, seed: int, overrides: dict) -> list:
    alloc = make_allocator(m, seed=seed, **overrides)
    serving, training, record = 2, 2, []
    record.append(alloc.initial_training([0, 1, 2, 3]))
    for step, (now, doc) in enumerate(walk(seed)):
        signal = None if doc is None else m.autoscale.parse_demand_signal(doc)
        reasons = ([alloc.preempt_reason(signal, serving), alloc.lend_reason(signal, serving)]
                   if signal is not None else None)
        decision = alloc.observe(signal, serving, training, now=now)
        entry = [step, alloc.fresh(signal, now), reasons, as_data(decision), alloc.serve_streak,
                 alloc.train_streak, alloc.cooldown_until]
        if decision is not None:
            entry.append(alloc.note_action(now))
            moved = decision.count
            if decision.direction == m.allocator.TO_SERVING:
                serving, training = serving + moved, training - moved
            else:
                serving, training = serving - moved, training + moved
            if step % 2 == 0:
                alloc.note_done()
        record.append(entry)
    return record


POLICIES = [{}, {"confirm_up": 1, "confirm_down": 1}, {"max_slices": 2},
            {"min_slices": 3, "slo_p99_s": 50.0}]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_the_autoscaler_decides_as_the_reference_step_by_step(seed, policy):
    ours = drive_autoscaler(SIDES["port"], seed, POLICIES[policy])
    ref = drive_autoscaler(SIDES["reference"], seed, POLICIES[policy])
    assert ours == ref
    if policy == 0:
        assert any(entry[3] is not None for entry in ours)


ALLOC_POLICIES = [{}, {"confirm_to_training": 1}, {"min_training": 1, "train_slices": 2},
                  {"min_serving": 2, "train_slices": 4}]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", range(len(ALLOC_POLICIES)))
def test_the_allocator_decides_as_the_reference_step_by_step(seed, policy):
    ours = drive_allocator(SIDES["port"], seed, ALLOC_POLICIES[policy])
    ref = drive_allocator(SIDES["reference"], seed, ALLOC_POLICIES[policy])
    assert ours == ref
    if policy == 1:
        assert any(entry[3] is not None for entry in ours[1:])


def _scripted(m) -> list:
    """The scripted scenarios of tests/test_autoscale.py and
    tests/test_allocator.py, each as the list of what it observes."""
    def sig(now, **kwargs):
        return m.autoscale.parse_demand_signal(demand_doc(now, **kwargs))

    out = []
    scaler = make_autoscaler(m)
    busy = sig(100.0, queue_depth=100)
    out += [as_data(scaler.observe(busy, 2, now=100.0)), scaler.up_streak,
            as_data(scaler.observe(busy, 2, now=300.0)), scaler.up_streak,
            as_data(scaler.observe(sig(310.0, queue_depth=100), 2, now=310.0)),
            as_data(scaler.observe(None, 2, now=340.0)), scaler.up_streak]
    scaler = make_autoscaler(m)
    out += [as_data(scaler.observe(sig(t, queue_depth=q), 2, t))
            for t, q in ((0.0, 100), (30.0, 5), (60.0, 100), (90.0, 100))]
    scaler = make_autoscaler(m)
    out += [as_data(scaler.observe(sig(30.0 * k, queue_depth=0), 3, 30.0 * k)) for k in range(4)]
    scaler = make_autoscaler(m, envelope=4, max_slices=2)
    out += [as_data(scaler.observe(sig(30.0 * k, queue_depth=500), 2, 30.0 * k))
            for k in range(5)]
    scaler = make_autoscaler(m)
    out += [scaler.up_reason(sig(0.0, sheds=3), 2), scaler.up_reason(sig(0.0, p99=45.0), 2),
            scaler.down_reason(sig(0.0, sheds=3), 3)]
    scaler = make_autoscaler(m)
    out += [as_data(scaler.observe(sig(t, queue_depth=40), 1, t)) for t in (0.0, 30.0)]
    scaler = make_autoscaler(m)
    scaler.observe(sig(0.0, queue_depth=100), 2, 0.0)
    out.append(as_data(scaler.observe(sig(30.0, queue_depth=100), 2, 30.0)))
    until = scaler.note_action(30.0)
    out += [until, as_data(scaler.observe(sig(60.0, queue_depth=100), 3, 60.0)),
            as_data(scaler.observe(sig(until - 1.0, queue_depth=100), 3, until - 1.0)),
            as_data(scaler.observe(sig(until + 1.0, queue_depth=100), 3, until + 1.0))]
    alloc = make_allocator(m, confirm_to_training=1)
    out.append(as_data(alloc.observe(sig(0.0, inflight={0: 3, 1: 3, 2: 3}, rate=2.0), 4, 0,
                                     now=0.0)))
    alloc = make_allocator(m, confirm_to_training=1)
    out.append(as_data(alloc.observe(sig(0.0, rate=2.0), 4, 0, now=0.0)))
    alloc = make_allocator(m)
    out += [as_data(alloc.observe(sig(t, rate=None), 3, 1, now=t)) for t in (0.0, 30.0, 60.0)]
    out += [make_allocator(m, train_slices=2).initial_training([0, 1, 2, 3]),
            make_allocator(m, train_slices=4, min_serving=2).initial_training([0, 1, 2, 3])]
    env = {"TK8S_AUTOSCALE_MIN_SLICES": "2", "TK8S_AUTOSCALE_CONFIRM_DOWN": "6",
           "TK8S_AUTOSCALE_DRAIN_TIMEOUT": "450", "TK8S_ALLOC_TRAIN_SLICES": "3",
           "TK8S_ALLOC_ACK_TIMEOUT": "45"}
    out += [as_data(m.autoscale.AutoscalePolicy.from_env(env)),
            as_data(m.allocator.AllocatorPolicy.from_env(env)),
            as_data(m.autoscale.AutoscalePolicy.from_env({}))]
    return out


def test_the_scripted_scenarios_give_the_reference_s_answers():
    assert _scripted(SIDES["port"]) == _scripted(SIDES["reference"])


def test_demand_documents_read_and_merge_as_the_reference(tmp_path):
    bodies = ["", '{"updated": 10.0, "queue_de', "[1, 2, 3]", '{"queue_depth": 4}',
              json.dumps(demand_doc(10.0, queue_depth=7, inflight={2: 3}, sheds=1)),
              json.dumps({"updated": "x"}), json.dumps({"updated": 1.0, "inflight": [1]}),
              json.dumps(demand_doc(5.0, p99=3.0, rate=1.5, kv_free=9, workers=(3, 1)))]
    out = {}
    for side, m in SIDES.items():
        results = []
        for i, body in enumerate(bodies):
            path = tmp_path / side / f"d{i}.json"
            path.parent.mkdir(exist_ok=True)
            if body:
                path.write_text(body)
            signal = m.autoscale.read_demand_signal(path)
            results.append([as_data(signal),
                            None if signal is None else signal.inflight_on([2, 3])])
        parsed = {f"g{i}": m.autoscale.parse_demand_signal(doc) for i, doc in enumerate([
            demand_doc(100.0, queue_depth=3, inflight={0: 1}, p99=2.0, rate=1.0, kv_free=4,
                       workers=(0,)),
            demand_doc(60.0, queue_depth=5, inflight={0: 2, 1: 1}, p99=7.0, sheds=2,
                       workers=(1, 2)),
            demand_doc(-500.0, queue_depth=99), None])}
        results += [as_data(m.autoscale.merge_demand_signals(parsed)),
                    as_data(m.autoscale.merge_demand_signals(parsed, now=130.0, max_age=90.0)),
                    as_data(m.autoscale.merge_demand_signals(parsed, now=1000.0, max_age=1.0)),
                    as_data(m.autoscale.merge_demand_signals({}))]
        out[side] = results
    assert out["port"] == out["reference"]


def test_read_fleet_demand_over_the_port_s_fleet_shards(tmp_path):
    """The shards a drill of the port's gateway fleet writes, read by
    both packages' `read_fleet_demand`: one merged signal, equal to the
    merge of each shard read alone, with the replicas' queue depths and
    rates summed."""
    report = chaos.run_fleet_kill_drill(tmp_path, duration_s=60.0)
    assert report["requests_lost"] == 0
    legacy = tmp_path / "demand-signal.json"
    shards = autoscale.fleet_signal_paths(legacy)
    assert len(shards) >= 2 and shards == ref_autoscale.fleet_signal_paths(legacy)
    singles = {r: autoscale.read_demand_signal(p) for r, p in shards.items()}
    newest = max(s.updated for s in singles.values())
    for now in (None, newest, newest + 1e6):
        ours = autoscale.read_fleet_demand(legacy, now=now)
        ref = ref_autoscale.read_fleet_demand(legacy, now=now)
        assert as_data(ours) == as_data(ref)
    merged = autoscale.read_fleet_demand(legacy)
    assert merged == autoscale.merge_demand_signals(
        singles, max_age=autoscale.FLEET_SIGNAL_MAX_AGE_S)
    assert merged.queue_depth == sum(s.queue_depth for s in singles.values())
    assert autoscale.read_fleet_demand(legacy, now=newest + 1e6) is None
    # no shards beside the path: exactly read_demand_signal
    lone = Path(tmp_path / "alone" / "demand-signal.json")
    lone.parent.mkdir()
    lone.write_text(json.dumps(demand_doc(3.0, queue_depth=2)))
    assert as_data(autoscale.read_fleet_demand(lone)) == as_data(
        ref_autoscale.read_fleet_demand(lone)) == as_data(autoscale.read_demand_signal(lone))
