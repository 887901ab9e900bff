"""The port's gateway fleet (`serving/fleet.py`) against the JAX package's
on the CPU: the key-partition map; the slice-lease state machine at its
edges; the control loop (grant, kill, 429, reassignment, adoption,
revival); the seeded fleet campaigns and the fleet kill drill
(`testing/chaos.py`), whose journal shards, lease records and reports are
equal through both packages with zero violations; two replicas over two
tiny real `SlotEngine`s each side, with a replica killed mid-dispatch,
equal token for token and record for record; and `cli.main status --json
--all` over a fleet drill's workdir, equal to the reference's status.

Journals are compared parsed, not as bytes. Real engines take no virtual
time (their steps return dt=0.0), so both sides wrap them in one adapter
that reports a fixed step time on the `SimClock`. Models are f32 with
head_dim 16 (tests/test_torch_decode.py says why): token for token equal.
"""

import dataclasses
import io
import json
import time
import zlib

import numpy as np
import pytest
from test_torch_decode import lm_pair

from tritonk8ssupervisor_tpu.cli import main as ref_cli
from tritonk8ssupervisor_tpu.cli.io import Prompter
from tritonk8ssupervisor_tpu.provision import events as ref_events
from tritonk8ssupervisor_tpu.provision import state as ref_state
from tritonk8ssupervisor_tpu.serving import fleet as ref_fleet
from tritonk8ssupervisor_tpu.serving import gateway as ref_gw
from tritonk8ssupervisor_tpu.serving import reqlog as ref_reqlog
from tritonk8ssupervisor_tpu.serving import traffic as ref_traffic
from tritonk8ssupervisor_tpu.serving.engine import SlotEngine as RefSlotEngine
from tritonk8ssupervisor_tpu.testing import chaos as ref_chaos
from tritonk8ssupervisor_tpu.testing.simclock import SimClock as RefSimClock
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.provision import events, state
from tritonk8ssupervisor_tpu_torch.serving import fleet, reqlog, traffic
from tritonk8ssupervisor_tpu_torch.serving import gateway as gw
from tritonk8ssupervisor_tpu_torch.serving.engine import SlotEngine
from tritonk8ssupervisor_tpu_torch.testing import chaos
from tritonk8ssupervisor_tpu_torch.testing.simclock import SimClock

SIDES = {
    "reference": {"fleet": ref_fleet, "events": ref_events, "gw": ref_gw, "state": ref_state,
                  "reqlog": ref_reqlog, "traffic": ref_traffic, "chaos": ref_chaos,
                  "clock": RefSimClock, "engine": RefSlotEngine},
    "port": {"fleet": fleet, "events": events, "gw": gw, "state": state, "reqlog": reqlog,
             "traffic": traffic, "chaos": chaos, "clock": SimClock, "engine": SlotEngine},
}


def quiet(_line):
    pass


def both(run, tmp_path):
    """`run(mods, dir)` through each side, each in its own directory."""
    out = {}
    for side, mods in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        out[side] = run(mods, root)
    return out["reference"], out["port"]


def shards(paths, replicas) -> list:
    """Each replica's journal shard, parsed (a replica that journaled
    nothing has no shard)."""
    return [[json.loads(line) for line in path.read_text().splitlines()] if path.exists()
            else None for path in map(paths.request_log_replica, replicas)]


# ------------------------------------------------------- partition routing


def test_partition_of_pins_the_references_crc32_mapping():
    assert fleet.partition_of("sess:conv-1", 32) == 26
    assert fleet.partition_of("key:fkill-17", 32) == 5
    assert fleet.partition_of("rid:42", 32) == 16
    keys = [f"key:k{n}" for n in range(500)] + ["a", "bb", "sess:x", "", "rid:0"]
    for partitions in (1, 2, 7, 32):
        for key in keys:
            assert fleet.partition_of(key, partitions) == ref_fleet.partition_of(
                key, partitions) == zlib.crc32(key.encode()) % partitions
    assert fleet.partition_of("x", 0) == 0  # clamped, no division by zero


def test_route_key_prefers_session_then_key_then_rid():
    for mods in SIDES.values():
        both_ids = mods["gw"].Request(rid=7, prompt_len=8, max_new_tokens=4, key="k1",
                                      session_id="c9")
        keyed = mods["gw"].Request(rid=7, prompt_len=8, max_new_tokens=4, key="k1")
        bare = mods["gw"].Request(rid=7, prompt_len=8, max_new_tokens=4)
        assert [mods["fleet"].route_key(r) for r in (both_ids, keyed, bare)] == [
            "sess:c9", "key:k1", "rid:7"]
    assert dataclasses.asdict(fleet.FleetPolicy()) == dataclasses.asdict(ref_fleet.FleetPolicy())


def test_runpaths_replica_helpers_and_globs(tmp_path):
    paths = state.RunPaths(tmp_path)
    ref_paths = ref_state.RunPaths(tmp_path)
    for name in ("events", "fleet_status", "request_log", "demand_signal", "span_log",
                 "metrics_snapshot"):
        assert getattr(paths, name) == getattr(ref_paths, name), name
    assert paths.request_log_replica("g1") == ref_paths.request_log_replica("g1")
    assert paths.demand_signal_replica("g1") == ref_paths.demand_signal_replica("g1")
    assert paths.request_logs() == []
    paths.request_log_replica("g1").write_text("")
    paths.request_log_replica("g0").write_text("")
    assert paths.request_logs() == [paths.request_log_replica("g0"),
                                    paths.request_log_replica("g1")]
    paths.request_log.write_text("")
    paths.demand_signal_replica("g0").write_text("{}")
    paths.demand_signal.write_text("{}")
    assert paths.request_logs() == ref_paths.request_logs()
    assert paths.request_logs()[0] == paths.request_log
    assert paths.demand_signals() == ref_paths.demand_signals() == [
        paths.demand_signal, paths.demand_signal_replica("g0")]


# ------------------------------------------------- slice leases (the edges)


def lease_table(mods, root, name="events.jsonl"):
    led = mods["events"].EventLedger(root / name, clock=lambda: 0.0, echo=quiet, fsync=False)
    return mods["fleet"].SliceLeases(led)


def expiry_boundary(mods, root):
    leases = lease_table(mods, root)
    leases.grant(3, "g0", now=100.0, ttl_s=30.0)
    seen = [leases.live(3, 129.999) is not None, leases.check(3, "g0", 129.999),
            leases.live(3, 130.0), leases.check(3, "g0", 130.0),
            [i for i, _ in leases.sweep(130.0)]]
    return seen, leases.ledger.replay()


def revoke_races_dispatch(mods, root):
    leases = lease_table(mods, root)
    leases.grant(0, "g1", now=0.0, ttl_s=30.0)
    seen = [leases.check(0, "g1", 10.0), leases.revoke(0, 10.0, reason="rebalance"),
            leases.check(0, "g1", 10.1)]
    return seen, leases.ledger.replay()


def grant_refuses_a_live_lease(mods, root):
    leases = lease_table(mods, root)
    leases.grant(1, "g0", now=0.0, ttl_s=30.0)
    with pytest.raises(mods["fleet"].LeaseHeld, match="slice 1") as refused:
        leases.grant(1, "g1", now=10.0, ttl_s=30.0)
    seen = [str(refused.value), leases.grant(1, "g1", now=30.0, ttl_s=30.0)]
    return seen, leases.ledger.replay()


def renew_only_the_live_holder(mods, root):
    leases = lease_table(mods, root)
    leases.grant(2, "g0", now=0.0, ttl_s=30.0)
    seen = [leases.renew(2, "g1", 5.0, 30.0), dict(leases.renew(2, "g0", 25.0, 30.0)),
            leases.renew(2, "g0", 55.0, 30.0), leases.held_by("g0"), leases.held_by("g1")]
    return seen, leases.ledger.replay()


def restore_after_a_crash_mid_renew(mods, root):
    seen = []
    records = []
    for name, renewed in (("a.jsonl", True), ("b.jsonl", False)):
        leases = lease_table(mods, root, name)
        leases.grant(0, "g0", now=0.0, ttl_s=30.0)
        if renewed:
            leases.renew(0, "g0", 25.0, 30.0)
        resumed = mods["fleet"].SliceLeases(leases.ledger)
        resumed.restore(mods["events"].fold(leases.ledger.replay()))
        seen += [resumed.epoch, dict(resumed.table), resumed.check(0, "g0", 40.0)]
        records += leases.ledger.replay()
    return seen, records


def restore_never_reuses_a_dead_fence(mods, root):
    leases = lease_table(mods, root)
    leases.grant(0, "g0", now=0.0, ttl_s=30.0)
    leases.revoke(0, 10.0, reason="replica-dead")
    leases.grant(0, "g1", now=10.0, ttl_s=30.0)
    resumed = mods["fleet"].SliceLeases(leases.ledger)
    resumed.restore(mods["events"].fold(leases.ledger.replay()))
    seen = [resumed.epoch, resumed.grant(1, "g0", now=50.0, ttl_s=30.0)]
    return seen, leases.ledger.replay()


LEASE_CASES = [expiry_boundary, revoke_races_dispatch, grant_refuses_a_live_lease,
               renew_only_the_live_holder, restore_after_a_crash_mid_renew,
               restore_never_reuses_a_dead_fence]


@pytest.mark.parametrize("case", LEASE_CASES, ids=lambda case: case.__name__)
def test_a_lease_case_gives_the_same_answers_and_records(case, tmp_path):
    (ref_seen, ref_records), (seen, records) = both(case, tmp_path)
    assert seen == ref_seen
    assert records == ref_records
    assert records  # every case writes the ledger


def test_the_lease_edges_hold_in_the_port(tmp_path):
    """Expiry is inclusive at the boundary; a re-grant mints a fresh
    epoch; a restored table's epoch is the highest ever granted."""
    seen, records = expiry_boundary(SIDES["port"], tmp_path)
    assert seen == [True, 1, None, None, [3]]
    assert [r["kind"] for r in records] == [events.LEASE_GRANT, events.LEASE_EXPIRE]
    (tmp_path / "regrant").mkdir()
    seen, _ = grant_refuses_a_live_lease(SIDES["port"], tmp_path / "regrant")
    assert seen[1]["epoch"] == 2
    (tmp_path / "restore").mkdir()
    seen, _ = restore_never_reuses_a_dead_fence(SIDES["port"], tmp_path / "restore")
    assert seen[0] == 2 and seen[1]["epoch"] == 3


# --------------------------------------------------- the fleet control loop


def fleet_under_test(mods, root, replicas=2, num_slices=2):
    gw_policy = mods["gw"].GatewayPolicy(
        max_seq_len=512, slots_per_slice=2, prefill_chunk=64, queue_budget=16,
        bucket_bounds=(64, 128), poll_every_s=2.0, default_deadline_s=120.0)
    engines = {i: mods["gw"].ModeledEngine(slots=2, prefill_chunk=64,
                                           cost=mods["gw"].DecodeCostModel())
               for i in range(num_slices)}
    paths = mods["state"].RunPaths(root)
    led = mods["events"].EventLedger(paths.events, clock=lambda: 0.0, echo=quiet, fsync=False)
    return mods["fleet"].GatewayFleet(engines, paths, led,
                                      policy=mods["fleet"].FleetPolicy(replicas=replicas),
                                      gateway_policy=gw_policy, clock=lambda: 0.0, fsync=False)


def control_loop(mods, root):
    """Grant every slice; kill g1, whose key is then refused 429-style;
    reap it (revoke, re-grant, reassignment, adoption); serve the key at
    the successor; revive g1 as a standby."""
    f = fleet_under_test(mods, root)
    first = f.tick(0.0)
    held = {rid: f.leases.held_by(rid) for rid in f.replica_ids}
    req = next(mods["gw"].Request(rid=n, prompt_len=8, max_new_tokens=4, key=f"k{n}",
                                  arrival=10.0)
               for n in range(64) if f.owner_of(mods["gw"].Request(
                   rid=n, prompt_len=8, max_new_tokens=4, key=f"k{n}")) == "g1")
    f.kill("g1", 10.0)
    refused = f.submit(req, 10.5)
    moved = f.tick(12.0)
    accepted = f.submit(req, 12.5)
    f.revive("g1", 20.0)
    f.tick(22.0)
    return {
        "first": first, "held": held, "key": req.key,
        "refused": (refused.ok, refused.reason, refused.retry_after_s),
        "moved": moved, "accepted": (accepted.ok, accepted.reason),
        "owners": dict(f.partition_owner), "standby": f.leases.held_by("g1"),
        "report": f.report(30.0), "ledger": f.ledger.replay(),
        "shards": shards(f._paths, f.replica_ids),
    }


def test_the_control_loop_grants_reaps_adopts_and_revives_as_the_reference(tmp_path):
    ref, port = both(control_loop, tmp_path)
    assert port == ref
    assert port["refused"] == (False, gw.REJECT_NO_CAPACITY, 2.0)
    assert (port["moved"]["revoked"], port["moved"]["granted"]) == (1, 1)
    assert port["moved"]["adopted"][0]["from"] == "g1"
    assert set(port["owners"].values()) == {"g0"} and port["standby"] == []
    assert port["accepted"] == (True, gw.ACCEPTED)


# ----------------------------------------- seeded campaigns and the drill


@pytest.mark.parametrize("seed", [1, 5])
def test_a_fleet_campaign_gives_the_same_shards_leases_and_report(seed, tmp_path):
    """`generate_fleet_scenario(seed)` through both packages'
    `run_fleet_campaign` over `ModeledEngine`s on `SimClock`s."""
    scenario = chaos.generate_fleet_scenario(seed)
    assert dataclasses.asdict(scenario) == dataclasses.asdict(
        ref_chaos.generate_fleet_scenario(seed))

    def run(mods, root):
        report = mods["chaos"].run_fleet_campaign(
            mods["chaos"].generate_fleet_scenario(seed), root)
        paths = mods["state"].RunPaths(root)
        ledger = [json.loads(line) for line in paths.events.read_text().splitlines()]
        return report, shards(paths, [f"g{i}" for i in range(scenario.replicas)]), ledger

    (ref_report, ref_shards, ref_ledger), (report, port_shards, ledger) = both(run, tmp_path)
    assert report == ref_report
    assert port_shards == ref_shards
    assert ledger == ref_ledger
    assert report["violations"] == [] and report["converged"] is True
    assert report["replica_kills"] >= 1 and report["reassignments"] >= 1
    assert report["completed"] + report["expired"] == report["accepted"] > 0
    assert {r["kind"] for r in ledger} >= {events.LEASE_GRANT, events.LEASE_REVOKE}


def test_the_fleet_kill_drill_gives_the_same_dict_and_loses_nothing(tmp_path):
    def run(mods, root):
        drill = mods["chaos"].run_fleet_kill_drill(root, duration_s=120.0)
        return drill, shards(mods["state"].RunPaths(root), [f"g{i}" for i in range(4)])

    (ref_drill, ref_shards), (drill, port_shards) = both(run, tmp_path)
    assert drill == ref_drill
    assert port_shards == ref_shards
    assert drill["violations"] == [] and drill["converged"] is True
    assert drill["requests_lost"] == 0 and drill["requests_redone"] > 0
    assert drill["partitions_reassigned"] > 0 and drill["successor"] != drill["victim"]
    assert drill["duplicates_replayed_from_journal"] == drill["duplicates_resubmitted"] > 0
    assert drill["kill_to_reassign_s"] <= 2 * 2.0


# ---------------------------------------- two replicas over real engines


MAX_LEN = 48
STEP_S = 0.01


class FixedStep:
    """A real engine that reports a fixed step time, so a `SimClock` drive
    moves while it decodes (a real engine's step returns dt=0.0)."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def step(self):
        result = self.engine.step()
        return None if result is None else dataclasses.replace(result, dt=STEP_S)


@pytest.fixture(scope="module")
def tiny_lm():
    """A 1-layer f32 LM on both sides from one set of weights."""
    jmodel, jparams, model, params = lm_pair(seed=0, num_layers=1, max_seq_len=MAX_LEN)
    return {"reference": (jmodel, jparams), "port": (model, params)}


def real_fleet_drive(mods, root, lm):
    """2 replicas, 2 slices of 2 slots; 8 keyed requests at t=0 (unshared
    prompts), g1 killed at 25 ms, mid-dispatch, reaped at the 2 s tick,
    and revived at 3 s as a standby."""
    model, params = lm
    engines = {i: FixedStep(mods["engine"](model, params, slots=2, max_len=MAX_LEN,
                                           prefill_chunk=4, page_size=4))
               for i in range(2)}
    clock = mods["clock"]()
    paths = mods["state"].RunPaths(root)
    ledger = mods["events"].EventLedger(paths.events, clock=clock.time, echo=quiet,
                                        fsync=False)
    policy = mods["gw"].GatewayPolicy(max_seq_len=MAX_LEN, slots_per_slice=2, prefill_chunk=4,
                                      page_size=4, bucket_bounds=(16, 32))
    f = mods["fleet"].GatewayFleet(engines, paths, ledger,
                                   policy=mods["fleet"].FleetPolicy(replicas=2),
                                   gateway_policy=policy, clock=clock.time, fsync=False)
    rng = np.random.default_rng(13)
    arrivals = [mods["gw"].Request(rid=i, prompt_len=int(n), max_new_tokens=6, arrival=0.0,
                                   key=f"real-{i}",
                                   tokens=rng.integers(0, 64, n).astype(np.int32))
                for i, n in enumerate(rng.integers(4, 13, 8))]
    at_kill = {}

    def kill(f):
        gateway = f.gateways["g1"]
        at_kill.update(inflight=sum(len(w.inflight) for w in gateway.workers.values()),
                       queued=gateway.queue_depth())
        f.kill("g1")

    events_ = (mods["traffic"].WorldEvent(0.025, kill),
               mods["traffic"].WorldEvent(3.0, lambda f: f.revive("g1")))
    clock.launch()
    clock.begin()
    try:
        report = mods["fleet"].drive_fleet(f, arrivals, clock, horizon_s=1.0, events=events_)
    finally:
        clock.release()
    journals = [f.reqlogs[r].replay() for r in f.replica_ids]
    violations = mods["chaos"].ServeInvariantChecker(policy).check_fleet(
        journals, ledger.replay())
    return {"report": {k: v for k, v in report.items() if k != "per_replica"},
            "at_kill": at_kill, "journals": journals, "ledger": ledger.replay(),
            "violations": violations}


def test_two_replicas_over_real_engines_with_a_kill_match_the_reference(tiny_lm, tmp_path):
    ref, port = both(lambda mods, root: real_fleet_drive(
        mods, root, tiny_lm["reference" if mods["fleet"] is ref_fleet else "port"]), tmp_path)
    assert port["at_kill"] == ref["at_kill"]
    assert port["at_kill"]["inflight"] > 0 and port["at_kill"]["queued"] > 0
    assert port["violations"] == ref["violations"] == []
    assert port["report"]["reassignments"][0]["redone"] > 0
    assert port["report"]["quiescent"] is True
    assert port["report"] == ref["report"]
    assert port["ledger"] == ref["ledger"]
    assert port["journals"] == ref["journals"]

    def settled(journals):
        out = {}
        for r in reqlog.merge_records(*journals):
            if r["kind"] in (reqlog.COMPLETED, reqlog.EXPIRED):
                out.setdefault(r["key"], []).append((r["kind"], r.get("result")))
        return out

    tokens = settled(port["journals"])
    assert tokens == settled(ref["journals"])
    assert sorted(tokens) == sorted(f"real-{i}" for i in range(8))
    assert all(len(v) == 1 and v[0][0] == reqlog.COMPLETED and len(v[0][1]["tokens"]) == 6
               for v in tokens.values())


# ------------------------------------------------------------------ status


def test_status_json_all_over_a_fleet_drill_is_the_references(tmp_path, monkeypatch,
                                                               capsys):
    """`cli.main status --json --all` over the workdir the fleet kill drill
    wrote: the port prints the reference's `fleet_status` of the same
    ledger, and the same document as the reference's `status`, with `now`
    pinned; the gateway fleet's lease counts are the ledger's."""
    chaos.run_fleet_kill_drill(tmp_path, duration_s=120.0)
    monkeypatch.setattr(time, "time", lambda: 1_000.0)
    argv = ["status", "--json", "--all", "--workdir", str(tmp_path)]
    assert cli.main(argv) == 0
    doc = json.loads(capsys.readouterr().out)
    buffer = io.StringIO()
    assert ref_cli.main(argv, prompter=Prompter(io.StringIO(), buffer)) == 0
    assert doc == json.loads(buffer.getvalue())
    ledger = ref_events.EventLedger(ref_state.RunPaths(tmp_path).events, echo=quiet).replay()
    expected = ref_events.fleet_status(ref_events.fold(ledger), 1_000.0, all_slices=True)
    assert {k: v for k, v in doc.items() if k != "telemetry"} == {
        **expected, "gateway_fleet": {**expected["gateway_fleet"],
                                      "stalest_demand_age_s":
                                          doc["gateway_fleet"]["stalest_demand_age_s"]}}
    kinds = [r["kind"] for r in ledger]
    assert doc["gateway_fleet"]["grants"] == kinds.count(events.LEASE_GRANT) > 0
    assert doc["gateway_fleet"]["revokes"] == kinds.count(events.LEASE_REVOKE) > 0
    # the human summary reads the same block; a workdir with neither file fails
    assert cli.main(["status", "--all", "--workdir", str(tmp_path)]) == 0
    assert "gateway fleet: 4 replica(s)" in capsys.readouterr().out
    assert cli.main(["status", "--workdir", str(tmp_path / "empty")]) == 1
