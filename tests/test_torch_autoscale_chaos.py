"""The port's autoscale drive and campaigns (`testing/chaos.py`:
`default_autoscale_policy`, `_active_slice_seconds`, `_scale_summary`,
`run_autoscale_drive`, `generate_autoscale_scenario` and
`run_autoscale_campaign`) against the JAX package's: equal scenarios per
seed; seeded campaigns and the three named drills of
`bench_provision.run_autoscale_benchmark` (a gateway SIGKILL mid-drain, a
failed apply mid-scale-up, a supervisor SIGKILL mid-scale) that give the
same ledgers, request journals, span logs, published documents and result
dicts through both packages, with zero violations and the reference's own
asserts (tests/test_chaos.py, bench_provision.py).

The drives run on tests/test_torch_serve_chaos.py's `TurnClock`, one
actor at a time, with the global `random` seeded alike before each side:
the drive's autoscaler draws its cooldown jitter from it, in the
reference as in the port. The campaigns run one diurnal period (900 s) and
the drills the benchmark's trace cut to 1500 s, as
`run_autoscale_cost_drives` allows; the 25-seed sweep stays behind the
`chaos` marker.
"""

import dataclasses

import pytest

from bench_provision import AUTOSCALE_TRAFFIC
from test_torch_serve_chaos import drive_both, one_actor_at_a_time
from tritonk8ssupervisor_tpu.testing import chaos as ref_chaos
from tritonk8ssupervisor_tpu_torch.provision import events as ev
from tritonk8ssupervisor_tpu_torch.testing import chaos

DRILL_TRAFFIC = dict(AUTOSCALE_TRAFFIC, duration_s=1500.0)


def test_generate_autoscale_scenario_equals_the_reference_per_seed():
    kinds = set()
    for seed in range(40):
        ours = chaos.generate_autoscale_scenario(seed)
        ref = ref_chaos.generate_autoscale_scenario(seed)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        kinds |= {e["kind"] for e in ours.events}
    assert chaos.generate_autoscale_scenario(42) == chaos.generate_autoscale_scenario(42)
    assert chaos.generate_autoscale_scenario(42) != chaos.generate_autoscale_scenario(43)
    assert {"burst", "gateway-kill-mid-drain", "slice-loss-mid-scale-up", "torn-demand",
            "supervisor-kill-mid-scale"} <= kinds
    assert chaos.AUTOSCALE_PRIMITIVES == ref_chaos.AUTOSCALE_PRIMITIVES
    for n in (2, 4):
        assert vars(chaos.default_autoscale_policy(n)) == vars(
            ref_chaos.default_autoscale_policy(n))


# a scale-up, an aborted scale-up, a scale-down, a scale-down still draining
# at the end, a record past the end, and records that move nothing
SCALE_RECORDS = [
    {"ts": 10.0, "kind": ev.SCALE_DECISION, "direction": "up", "windows": 2},
    {"ts": 12.0, "kind": ev.SCALE_START, "direction": "up", "slices": [2, 3]},
    {"ts": 40.0, "kind": ev.SCALE_DONE, "direction": "up", "slices": [2, 3]},
    {"ts": 100.0, "kind": ev.SCALE_START, "direction": "up", "slices": [1]},
    {"ts": 130.0, "kind": ev.SCALE_ABORT, "direction": "up", "slices": [1]},
    {"ts": 200.0, "kind": ev.SCALE_START, "direction": "down", "slices": [3]},
    {"ts": 320.0, "kind": ev.SCALE_DONE, "direction": "down", "slices": [3]},
    {"ts": 400.0, "kind": ev.SCALE_HELD, "direction": "down"},
    {"ts": 450.0, "kind": ev.SCALE_START, "direction": "down", "slices": [2]},
    {"ts": 900.0, "kind": ev.SCALE_DONE, "direction": "down", "slices": [2]},
    {"ts": 500.0, "kind": ev.SCALE_BREAKER_OPEN, "reopen_at": 800.0},
]


@pytest.mark.parametrize("initial,end_s", [(1, 600.0), (2, 1000.0), (0, 50.0)])
def test_cost_and_scale_summary_equal_the_reference(initial, end_s):
    records = sorted(SCALE_RECORDS, key=lambda r: r["ts"])
    ours = chaos._active_slice_seconds(records, initial, end_s)
    assert ours == ref_chaos._active_slice_seconds(records, initial, end_s)
    assert ours > 0.0
    assert chaos._scale_summary(records) == ref_chaos._scale_summary(records)


@pytest.mark.parametrize("seed", (1, 2))  # gateway kill mid-drain; slice loss mid-scale-up
def test_autoscale_campaign_equals_the_reference_with_zero_violations(
        tmp_path, monkeypatch, seed):
    """tests/test_chaos.py's tier-1 smoke, through both packages: one
    diurnal period per seed."""
    one_actor_at_a_time(monkeypatch)
    doc = drive_both(tmp_path, lambda mod, root: mod.run_autoscale_campaign(
        dataclasses.replace(mod.generate_autoscale_scenario(seed), duration_s=900.0), root),
        seed=seed)
    out = doc["result"]
    assert out["violations"] == [], (seed, out["events"], out["violations"])
    assert out["converged"] is True
    assert out["expired"] == 0 or out["completed"] > 0
    assert out["scales"]["started"] > 0  # the loop actually closed
    assert doc["files"]["demand-signal.json"] is not None


def _gateway_kill(out):
    assert out["gateway_kills"] == 1
    assert out["redone_after_kill"] > 0


def _failed_apply(out):
    assert out["scales"]["aborted"] >= 1
    assert out["scales"]["done_up"] >= 1


def _supervisor_kill(out):
    assert out["supervisor_restarts"] >= 1


# bench_provision.run_autoscale_benchmark's three named drills and its
# pass conditions for each
DRILLS = {
    "gateway-kill-mid-drain": (dict(kill_gateway_on_drain=True), _gateway_kill),
    "failed-apply-mid-scale-up": (dict(fail_applies=1), _failed_apply),
    "supervisor-kill-mid-scale": (dict(supervisor_kill_on="destroy"), _supervisor_kill),
}


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_named_drill_equals_the_reference_with_zero_violations(tmp_path, monkeypatch, name):
    options, holds = DRILLS[name]
    one_actor_at_a_time(monkeypatch)
    doc = drive_both(tmp_path, lambda mod, root: mod.run_autoscale_drive(
        root, autoscale_policy=mod.default_autoscale_policy(4), **options, **DRILL_TRAFFIC))
    out = doc["result"]
    assert out["violations"] == [], (name, out["violations"])
    assert out["converged"] is True
    assert out["autoscale"] is True and out["scales"]["started"] > 0
    holds(out)


@pytest.mark.chaos
def test_autoscale_twentyfive_seed_campaign(tmp_path):
    """The full elasticity sweep through the port: 25 seeded campaigns at
    their full length, zero violations, all converged."""
    failures = []
    for seed in range(1, 26):
        out = chaos.run_autoscale_campaign(chaos.generate_autoscale_scenario(seed),
                                           tmp_path / f"seed-{seed}")
        if out["violations"] or not out["converged"]:
            failures.append((seed, out["events"], out["violations"]))
    assert failures == []
