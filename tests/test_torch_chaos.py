"""The port's chaos harness (`testing/chaos.py`) against the JAX
package's. The request plane: crafted record streams that break (or keep)
each of `ServeInvariantChecker`'s invariants, the reference's own
(tests/test_serve_chaos.py's checker cases) and the fleet's partition,
lease and epoch-fence cases, make both checkers name the same violations;
and `run_gateway_kill_drill` gives the same dict through both packages,
with work in flight at the kill and nothing lost. The supervisor campaign
core: `generate_scenario` gives equal scenarios per seed, both
`InvariantChecker`s name the same violations on the crafted histories of
tests/test_chaos.py, and the few-seed and kill-restart campaigns give
equal results and event ledgers with zero violations (the 100-seed sweep
stays behind the `chaos` marker, as the reference's). No tolerance: the
checks compare strings and counts."""

import dataclasses
import gc
import json

import pytest

from test_torch_supervisor import normalized, unordered_waves
from tritonk8ssupervisor_tpu.serving import gateway as ref_gw
from tritonk8ssupervisor_tpu.serving import reqlog as ref_reqlog
from tritonk8ssupervisor_tpu.testing import chaos as ref_chaos
from tritonk8ssupervisor_tpu_torch import obs
from tritonk8ssupervisor_tpu_torch.provision import events as ev
from tritonk8ssupervisor_tpu_torch.serving import gateway as gw
from tritonk8ssupervisor_tpu_torch.serving import reqlog as rl
from tritonk8ssupervisor_tpu_torch.testing import chaos


def checkers() -> dict:
    """One checker a side, with the reference's campaign autoscale and
    allocation policies (the checker reads only their thresholds)."""
    out = {}
    for side, (mod, gw_mod) in {"reference": (ref_chaos, ref_gw), "port": (chaos, gw)}.items():
        out[side] = mod.ServeInvariantChecker(
            gw_mod.GatewayPolicy(queue_budget=8), interval_s=30.0,
            autoscale_policy=ref_chaos.default_autoscale_policy(),
            alloc_policy=ref_chaos.default_alloc_policy())
    return out


def metrics_snapshot(accepted: int, completed: int, busy: float) -> dict:
    registry = obs.MetricsRegistry(clock=lambda: 0.0)
    registry.counter("serving_requests_accepted_total").inc(accepted)
    registry.counter("serving_requests_completed_total").inc(completed)
    registry.gauge("serving_slots_busy_peak").set(busy)
    registry.gauge("serving_slots_total").set(4)
    return registry.snapshot()


ACCEPT = {"ts": 0.0, "kind": rl.ACCEPTED, "key": "k", "deadline_s": 10.0}
SERVED = [{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k", "rid": 1},
          {"ts": 2.0, "kind": rl.DISPATCHED, "key": "k", "slice": 0},
          {"ts": 3.0, "kind": rl.COMPLETED, "key": "k"}]
LEDGER = [{"ts": 0.0, "kind": ev.TICK, "states": {"0": "healthy"}}]


def grant(ts, index, replica, epoch, expires_at):
    return {"ts": ts, "kind": ev.LEASE_GRANT, "slice": index, "replica": replica,
            "epoch": epoch, "expires_at": expires_at}


def dispatch(ts, index, replica, epoch, key="k"):
    return {"ts": ts, "kind": rl.DISPATCHED, "key": key, "slice": index, "replica": replica,
            "lease_epoch": epoch}


# name -> (method, arguments, whether it must find a violation)
CASES = {
    "lost": ("check_conservation", ([{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k"}],), True),
    "phantom-terminal": ("check_conservation",
                         ([{"ts": 1.0, "kind": rl.COMPLETED, "key": "ghost"}],), True),
    "conserved": ("check_conservation", ([{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k"},
                                          {"ts": 2.0, "kind": rl.EXPIRED, "key": "k",
                                           "where": "queue"}],), False),
    "completed-twice": ("check_no_double_service",
                        (SERVED + [{"ts": 4.0, "kind": rl.COMPLETED, "key": "k"}],), True),
    "zombie-dispatch": ("check_no_double_service",
                        ([{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k"},
                          {"ts": 2.0, "kind": rl.EXPIRED, "key": "k", "where": "queue"},
                          {"ts": 3.0, "kind": rl.DISPATCHED, "key": "k", "slice": 0}],), True),
    "fresh-acceptance": ("check_no_double_service",
                         ([{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k"},
                           {"ts": 2.0, "kind": rl.EXPIRED, "key": "k", "where": "queue"}]
                          + [dict(r, ts=r["ts"] + 2.0) for r in SERVED],), False),
    "late-dispatch": ("check_deadline_honesty",
                      ([ACCEPT, {"ts": 10.0, "kind": rl.DISPATCHED, "key": "k",
                                 "slice": 0}],), True),
    "late-serve": ("check_deadline_honesty",
                   ([ACCEPT, {"ts": 11.0, "kind": rl.COMPLETED, "key": "k"}],), True),
    "early-expiry": ("check_deadline_honesty",
                     ([ACCEPT, {"ts": 4.0, "kind": rl.EXPIRED, "key": "k",
                                "where": "queue"}],), True),
    "honest-deadline": ("check_deadline_honesty",
                        ([ACCEPT, {"ts": 3.0, "kind": rl.DISPATCHED, "key": "k", "slice": 0},
                          {"ts": 9.0, "kind": rl.COMPLETED, "key": "k"},
                          {"ts": 9.5, "kind": rl.EXPIRED, "key": "j", "where": "timeout"}],),
                        False),
    "dishonest-retry-after": ("check_retry_after_honesty", ([
        {"ts": 1.0, "kind": rl.SHED, "reason": "breaker-open", "retry_after_s": None},
        {"ts": 2.0, "kind": rl.SHED, "reason": "overload", "retry_after_s": 5.0, "depth": 2},
        {"ts": 3.0, "kind": rl.SHED, "reason": "unservable", "retry_after_s": 4.0}],), True),
    "honest-retry-after": ("check_retry_after_honesty", ([
        {"ts": 1.0, "kind": rl.SHED, "reason": "overload", "retry_after_s": 5.8, "depth": 8},
        {"ts": 2.0, "kind": rl.SHED, "reason": "unservable", "retry_after_s": None}],), False),
    "stale-view": ("check_view_staleness",
                   ([{"ts": 1.0, "kind": rl.DISPATCHED, "key": "k", "view_age_s": 9999.0}],),
                   True),
    "phantom-generation": ("check_cross_ledger",
                           ([{"ts": 1.0, "kind": rl.DISPATCHED, "key": "k",
                              "generation": 7}], LEDGER), True),
    "phantom-breaker-shed": ("check_cross_ledger",
                             ([{"ts": 1.0, "kind": rl.SHED, "reason": "breaker-open",
                                "retry_after_s": 5.0}], LEDGER), True),
    "breaker-shed-on-record": ("check_cross_ledger",
                               ([{"ts": 1.0, "kind": rl.SHED, "reason": "breaker-open",
                                  "retry_after_s": 5.0}],
                                [{"ts": 0.5, "kind": ev.BREAKER_OPEN}] + LEDGER), False),
    "metrics-drift": ("check_metrics_consistency",
                      (SERVED, metrics_snapshot(accepted=2, completed=1, busy=5.0)), True),
    "metrics-agree": ("check_metrics_consistency",
                      (SERVED, metrics_snapshot(accepted=1, completed=1, busy=3.0)), False),
    "unconfirmed-scale": ("check_scale_confirmation", ([
        {"ts": 1.0, "kind": ev.SCALE_DECISION, "direction": "up", "windows": 1,
         "signal_age_s": 5.0},
        {"ts": 2.0, "kind": ev.SCALE_DECISION, "direction": "down", "windows": 3,
         "signal_age_s": None}],), True),
    "scale-through-the-breaker": ("check_scale_breaker_gate", ([
        {"ts": 1.0, "kind": ev.SCALE_BREAKER_OPEN, "reopen_at": 100.0},
        {"ts": 50.0, "kind": ev.SCALE_START, "id": "s1"}],), True),
    "overlapping-scales": ("check_scale_serialised", ([
        {"ts": 1.0, "kind": ev.SCALE_START, "id": "s1", "cooldown_until": 61.0},
        {"ts": 30.0, "kind": ev.SCALE_START, "id": "s2"},
        {"ts": 40.0, "kind": ev.SCALE_DONE, "id": "s1"},
        {"ts": 41.0, "kind": ev.SCALE_DONE, "id": "s2"}],), True),
    "dispatch-to-draining": ("check_no_dispatch_to_draining", (
        [{"ts": 50.0, "kind": rl.DISPATCHED, "key": "k", "slice": 2}],
        [{"ts": 1.0, "kind": ev.SCALE_START, "id": "s1", "direction": "down",
          "slices": [2]}]), True),
    "unconfirmed-handover": ("check_alloc_confirmation", ([
        {"ts": 1.0, "kind": ev.ALLOC_DECISION, "direction": "to-training", "windows": 0,
         "signal_age_s": 500.0}],), True),
    "handover-protocol": ("check_handover_protocol", ([
        {"ts": 1.0, "kind": ev.PREEMPT_NOTICE, "id": "a1", "slices": [1],
         "ack_deadline": 90.0},
        {"ts": 5.0, "kind": ev.PREEMPT_NOTICE, "id": "a2", "slices": [2]},
        {"ts": 10.0, "kind": ev.PREEMPT_ACK, "id": "a1", "forced": True},
        {"ts": 20.0, "kind": ev.ROLE_CHANGED, "id": "a1", "role": "training", "slices": [1]},
        {"ts": 21.0, "kind": ev.ROLE_CHANGED, "id": "a2", "role": "serving",
         "slices": [2]}],), True),
    "role-exclusivity": ("check_role_exclusivity", ([
        {"ts": 1.0, "kind": ev.ROLE_CHANGED, "id": "a1", "role": "training", "slices": [3]},
        {"ts": 2.0, "kind": ev.PREEMPT_NOTICE, "id": "a2", "slices": [4]},
        {"ts": 3.0, "kind": ev.PREEMPT_NOTICE, "id": "a3", "slices": [4]}],), True),
    "dispatch-to-training": ("check_no_dispatch_to_training", (
        [{"ts": 50.0, "kind": rl.DISPATCHED, "key": "k", "slice": 1}],
        [{"ts": 1.0, "kind": ev.PREEMPT_NOTICE, "id": "a1", "slices": [1]},
         {"ts": 20.0, "kind": ev.ROLE_CHANGED, "id": "a1", "role": "training",
          "slices": [1]}]), True),
    "tenant-flood": ("check_tenant_fairness", (
        [{"ts": 0.0, "kind": rl.ACCEPTED, "key": f"f{i}", "tenant": "flood"}
         for i in range(12)]
        + [{"ts": 1.0, "kind": rl.COMPLETED, "key": f"f{i}"} for i in range(12)],
        {"flood": 1.0, "interactive": 3.0}, "flood", (0.0, 10.0)), True),
    "partition-exclusivity": ("check_partition_exclusivity", (
        [[{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k"}],
         [{"ts": 2.0, "kind": rl.ACCEPTED, "key": "k"}]],), True),
    "adopted-across-shards": ("check_partition_exclusivity", (
        [[{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k"},
          {"ts": 2.0, "kind": rl.DISPATCHED, "key": "k"}],
         [{"ts": 5.0, "kind": rl.REQUEUED, "key": "k"},
          {"ts": 7.0, "kind": rl.COMPLETED, "key": "k"},
          {"ts": 8.0, "kind": rl.ACCEPTED, "key": "k"}]],), False),
    "double-lease": ("check_lease_exclusivity", (
        [grant(0.0, 0, "g0", 1, 30.0), grant(10.0, 0, "g1", 2, 40.0),
         grant(11.0, 1, "g1", 2, 41.0)],), True),
    "regrant-at-expiry": ("check_lease_exclusivity", (
        [grant(0.0, 0, "g0", 1, 30.0),
         {"ts": 20.0, "kind": ev.LEASE_RENEW, "slice": 0, "replica": "g0", "epoch": 1,
          "expires_at": 50.0},
         grant(50.0, 0, "g1", 2, 80.0),
         {"ts": 60.0, "kind": ev.LEASE_REVOKE, "slice": 0, "replica": "g1", "epoch": 2,
          "at": 60.0},
         grant(60.0, 0, "g0", 3, 90.0)],), False),
    "dispatch-outside-the-lease": ("check_cross_lease_dispatch", (
        [dispatch(5.0, 0, "g0", None), dispatch(6.0, 0, "g1", 1), dispatch(35.0, 0, "g0", 1),
         dispatch(12.0, 0, "g0", 1)],
        [grant(0.0, 0, "g0", 1, 30.0),
         {"ts": 20.0, "kind": ev.LEASE_REVOKE, "slice": 0, "replica": "g0", "epoch": 1,
          "at": 20.0}]), True),
    "fleet-check-of-a-clean-adoption": ("check_fleet", (
        [[{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k", "rid": 1},
          dispatch(2.0, 0, "g1", 1)],
         [{"ts": 5.0, "kind": rl.REQUEUED, "key": "k"}, dispatch(6.0, 0, "g0", 2),
          {"ts": 7.0, "kind": rl.COMPLETED, "key": "k"}]],
        [grant(0.0, 0, "g1", 1, 30.0),
         {"ts": 4.0, "kind": ev.LEASE_REVOKE, "slice": 0, "replica": "g1", "epoch": 1,
          "at": 4.0},
         grant(4.0, 0, "g0", 2, 34.0)]), False),
    "fleet-check-of-a-lost-key": ("check_fleet", (
        [[{"ts": 1.0, "kind": rl.ACCEPTED, "key": "k", "rid": 1}, dispatch(2.0, 0, "g1", 1)],
         [dispatch(6.0, 0, "g1", 1)]],
        [grant(0.0, 0, "g1", 1, 30.0),
         {"ts": 4.0, "kind": ev.LEASE_REVOKE, "slice": 0, "replica": "g1", "epoch": 1,
          "at": 4.0}]), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_both_checkers_name_the_same_violations(name):
    method, args, violating = CASES[name]
    found = {side: getattr(checker, method)(*args) for side, checker in checkers().items()}
    assert found["port"] == found["reference"]
    assert bool(found["port"]) is violating, found["port"]


def test_the_fleet_cases_name_each_broken_invariant():
    checker = checkers()["port"]
    assert "two replicas owned one key" in checker.check_partition_exclusivity(
        *CASES["partition-exclusivity"][1])[0]
    lease = checker.check_lease_exclusivity(*CASES["double-lease"][1])
    assert any("while epoch 1 (g0) was live" in v for v in lease)
    assert any("reuses epoch 2" in v for v in lease)
    fence = checker.check_cross_lease_dispatch(*CASES["dispatch-outside-the-lease"][1])
    assert [v.split(":")[0] for v in fence] == ["cross-lease-dispatch"] * 3
    assert "with no lease epoch" in fence[0] and "never granted" in fence[1]
    assert "outside its epoch-1 lease [0.000, 20.000]" in fence[2]
    lost = checker.check_fleet(*CASES["fleet-check-of-a-lost-key"][1])
    assert any(v.startswith("request-conservation: key k") for v in lost)
    assert any(v.startswith("cross-lease-dispatch") for v in lost)


def test_check_runs_every_family_the_policies_ask_for():
    """`check()` with a ledger and a snapshot runs the request checks, the
    cross-ledger and metrics checks and the scale and allocation checks,
    in one list, equal on both sides."""
    records = CASES["completed-twice"][1][0] + CASES["dispatch-to-draining"][1][0]
    ledger = CASES["dispatch-to-draining"][1][1] + CASES["role-exclusivity"][1][0]
    found = {side: checker.check(records, ledger, metrics=metrics_snapshot(9, 9, 1.0))
             for side, checker in checkers().items()}
    assert found["port"] == found["reference"]
    families = {v.split(":")[0] for v in found["port"]}
    assert families >= {"double-service", "metrics-vs-ledger", "dispatch-to-draining",
                        "role-exclusivity"}


def test_the_gateway_kill_drill_gives_the_same_dict_and_loses_nothing(tmp_path):
    """A gateway over modeled engines on a `SimClock`, dropped mid-dispatch
    at 100 s and resumed from its journal: the same dict through both
    packages, the spans and journals equal when parsed."""
    drills = {}
    for side, mod in {"reference": ref_chaos, "port": chaos}.items():
        drills[side] = mod.run_gateway_kill_drill(tmp_path / side)
    ref, port = drills["reference"], drills["port"]
    assert port == ref
    assert port["inflight_at_kill"] > 0 and port["requests_redone"] > 0
    assert port["requests_lost"] == 0 and port["violations"] == []
    assert port["duplicates_replayed_from_journal"] == port["duplicates_resubmitted"] > 0
    assert port["completed"] + port["expired"] == port["accepted"] == port["offered"]
    journals = {side: ref_reqlog.RequestLog(tmp_path / side / "serve-requests.jsonl",
                                            echo=lambda line: None).replay()
                for side in drills}
    assert journals["port"] == journals["reference"]
    # the drill leaves its buffered span log to be closed with it: collect
    # the cycle it sits in, so its writer flushes, before reading the file
    gc.collect()
    spans = {side: [json.loads(line) for line in (tmp_path / side / "telemetry-spans.jsonl")
                    .read_text().splitlines()] for side in drills}
    assert spans["port"] == spans["reference"]
    assert len(spans["port"]) > 0


# ------------------------------------------------ the supervisor campaign core


def test_generate_scenario_equals_the_reference_per_seed():
    kinds = set()
    for seed in range(60):
        ours, ref = chaos.generate_scenario(seed), ref_chaos.generate_scenario(seed)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.fault_times == ref.fault_times
        kinds |= {e["kind"] for e in ours.events}
    assert chaos.generate_scenario(42) == chaos.generate_scenario(42)
    assert chaos.generate_scenario(42) != chaos.generate_scenario(43)
    assert set(chaos.PRIMITIVES) <= kinds
    assert vars(chaos.default_policy()) == vars(ref_chaos.default_policy())


def supervisor_checkers(num_slices=8, failure_domains=4, **overrides) -> dict:
    out = {}
    for side, mod in {"reference": ref_chaos, "port": chaos}.items():
        policy = mod.default_policy()
        for key, value in overrides.items():
            setattr(policy, key, value)
        out[side] = mod.InvariantChecker(mod.sim_config(num_slices, failure_domains), policy)
    return out


DOMAIN_1 = ref_chaos.sim_config(8, 4).domain_of(1)  # slices 1 and 5
DOMAIN_0 = ref_chaos.sim_config(8, 4).domain_of(0)  # slices 0 and 4
SUPERVISOR_CASES = {
    # name: (check, records, policy overrides, substring of a violation or None)
    "concurrent double heal": ("check_no_double_heal", [
        {"ts": 10.0, "kind": ev.HEAL_START, "id": "h1", "slices": [2]},
        {"ts": 20.0, "kind": ev.HEAL_START, "id": "h2", "slices": [2]},
        {"ts": 30.0, "kind": ev.HEAL_DONE, "id": "h1", "slices": [2]},
        {"ts": 40.0, "kind": ev.HEAL_DONE, "id": "h2", "slices": [2]}], {}, "h2"),
    "re-heal without fresh evidence": ("check_no_double_heal", [
        {"ts": 5.0, "kind": ev.VERDICT, "slice": 2, "state": "missing"},
        {"ts": 10.0, "kind": ev.HEAL_START, "id": "h1", "slices": [2]},
        {"ts": 30.0, "kind": ev.HEAL_DONE, "id": "h1", "slices": [2]},
        {"ts": 40.0, "kind": ev.HEAL_START, "id": "h2", "slices": [2]}], {},
        "without a fresh unhealthy verdict"),
    "re-heal after fresh evidence": ("check_no_double_heal", [
        {"ts": 5.0, "kind": ev.VERDICT, "slice": 2, "state": "missing"},
        {"ts": 10.0, "kind": ev.HEAL_START, "id": "h1", "slices": [2]},
        {"ts": 30.0, "kind": ev.HEAL_DONE, "id": "h1", "slices": [2]},
        {"ts": 35.0, "kind": ev.VERDICT, "slice": 2, "state": "unready"},
        {"ts": 40.0, "kind": ev.HEAL_START, "id": "h2", "slices": [2]}], {}, None),
    "orphaned start, then the recovery heal": ("check_no_double_heal", [
        {"ts": 5.0, "kind": ev.VERDICT, "slice": 1, "state": "missing"},
        {"ts": 10.0, "kind": ev.HEAL_START, "id": "h1", "slices": [1]},
        {"ts": 700.0, "kind": ev.VERDICT, "slice": 1, "state": "missing"},
        {"ts": 710.0, "kind": ev.HEAL_START, "id": "h2", "slices": [1]},
        {"ts": 830.0, "kind": ev.HEAL_DONE, "id": "h2", "slices": [1]}], {}, None),
    "token overspend": ("check_token_conservation", [
        {"ts": float(t), "kind": ev.HEAL_START, "id": f"h{t}", "slices": [0]}
        for t in (0, 1, 2)], {"heal_burst": 2}, "token-conservation"),
    "closing a never-opened breaker": ("check_breaker_transitions", [
        {"ts": 1.0, "kind": ev.BREAKER_CLOSE}], {}, "closed -> closed"),
    "half-opening a closed domain breaker": ("check_breaker_transitions", [
        {"ts": 1.0, "kind": ev.DOMAIN_BREAKER_HALF_OPEN, "domain": "z-fd0"}], {},
        "closed -> half-open"),
    "the legal breaker cycle": ("check_breaker_transitions", [
        {"ts": 1.0, "kind": ev.DOMAIN_BREAKER_OPEN, "domain": "z-fd0"},
        {"ts": 2.0, "kind": ev.DOMAIN_BREAKER_HALF_OPEN, "domain": "z-fd0"},
        {"ts": 3.0, "kind": ev.DOMAIN_BREAKER_HALF_OPEN, "domain": "z-fd0"},
        {"ts": 4.0, "kind": ev.DOMAIN_BREAKER_CLOSE, "domain": "z-fd0"}], {}, None),
    "heal into a gated domain": ("check_domain_canary_gate", [
        {"ts": 10.0, "kind": ev.DOMAIN_OUTAGE, "domain": DOMAIN_1, "slices": [1, 5]},
        {"ts": 20.0, "kind": ev.HEAL_START, "id": "h1", "slices": [5]}], {}, "non-canary"),
    "the canary, then heals after the close": ("check_domain_canary_gate", [
        {"ts": 10.0, "kind": ev.DOMAIN_OUTAGE, "domain": DOMAIN_1, "slices": [1, 5]},
        {"ts": 300.0, "kind": ev.HEAL_START, "id": "h1", "slices": [1], "canary": True,
         "domain": DOMAIN_1},
        {"ts": 420.0, "kind": ev.HEAL_DONE, "id": "h1", "slices": [1], "canary": True,
         "domain": DOMAIN_1},
        {"ts": 420.0, "kind": ev.DOMAIN_BREAKER_CLOSE, "domain": DOMAIN_1},
        {"ts": 450.0, "kind": ev.HEAL_START, "id": "h2", "slices": [5]}], {}, None),
    "two concurrent canaries": ("check_domain_canary_gate", [
        {"ts": 10.0, "kind": ev.DOMAIN_OUTAGE, "domain": DOMAIN_0, "slices": [0, 4]},
        {"ts": 300.0, "kind": ev.HEAL_START, "id": "c1", "slices": [0], "canary": True,
         "domain": DOMAIN_0},
        {"ts": 310.0, "kind": ev.HEAL_START, "id": "c2", "slices": [4], "canary": True,
         "domain": DOMAIN_0},
        {"ts": 400.0, "kind": ev.HEAL_DONE, "id": "c1", "slices": [0]},
        {"ts": 410.0, "kind": ev.HEAL_DONE, "id": "c2", "slices": [4]}], {}, "second canary"),
}


@pytest.mark.parametrize("name", sorted(SUPERVISOR_CASES))
def test_both_invariant_checkers_name_the_same_violations(name):
    method, records, overrides, expected = SUPERVISOR_CASES[name]
    found = {side: getattr(checker, method)(records)
             for side, checker in supervisor_checkers(**overrides).items()}
    assert found["port"] == found["reference"]
    whole = {side: checker.check(records)
             for side, checker in supervisor_checkers(**overrides).items()}
    assert whole["port"] == whole["reference"]
    if expected is None:
        assert found["port"] == []
    else:
        assert any(expected in v for v in found["port"]), found["port"]


def campaigns(tmp_path, seed: int) -> dict:
    """One seeded campaign through each package: its result and its event
    ledger, in each side's own workdir."""
    out = {}
    for side, mod in {"reference": ref_chaos, "port": chaos}.items():
        root = tmp_path / side / f"seed-{seed}"
        result = mod.run_campaign(mod.generate_scenario(seed), root)
        ledger = [json.loads(line) for line in (root / "supervisor-events.jsonl")
                  .read_text().splitlines() if line.strip()]
        doc = {"ledger": ledger, "lines": [], "applies": [], "plays": [], "result": result}
        out[side] = unordered_waves(normalized(doc, root, side))
    assert out["port"] == out["reference"]
    return out["port"]["result"]


@pytest.mark.parametrize("seed", (1, 3, 7))  # outage, kill-restart, quota storm
def test_campaign_few_seeds_equal_the_reference_with_zero_violations(tmp_path, seed):
    scenario = chaos.generate_scenario(seed)
    out = campaigns(tmp_path, seed)
    assert out["violations"] == [], (seed, out)
    assert out["converged"] is True
    assert out["mttr_s"] <= scenario.mttr_bound_s
    assert out["status_parses"] is True


def test_campaign_kill_restart_resumes_from_the_ledger_as_the_reference(tmp_path):
    assert "sigkill-mid-heal" in [e["kind"] for e in chaos.generate_scenario(3).events]
    out = campaigns(tmp_path, 3)
    assert out["restarts"] >= 1
    assert out["converged"] is True
    assert out["violations"] == []


@pytest.mark.chaos
def test_chaos_hundred_seed_campaign(tmp_path):
    """The full sweep through the port: 100 seeded campaigns, zero
    violations, all converged."""
    failures = []
    for seed in range(1, 101):
        out = chaos.run_campaign(chaos.generate_scenario(seed), tmp_path / f"seed-{seed}")
        if out["violations"] or not out["converged"]:
            failures.append((seed, out["events"], out["violations"]))
    assert failures == []
