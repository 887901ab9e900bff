"""The port's event ledger (`provision/events.py`) against the JAX
package's: the same record streams fold to the same `LedgerView` through
both packages (the reference's own streams from tests/test_events.py and
seeded random streams over every record kind, leases included), give the
same status documents, bounded and `all_slices`, and compact to the same
snapshot, whose fold equals the original's, pre-domain ledgers included;
and `write_fleet_status` is atomic. No tolerance: the folds are exact."""

import dataclasses
import json
import os
import random

import pytest
from test_events import (
    PRE_DOMAIN_FIXTURE,
    PRE_DOMAIN_SNAPSHOT,
    domain_records,
    seeded_records,
)

from tritonk8ssupervisor_tpu.provision import events as ref_events
from tritonk8ssupervisor_tpu.provision import heal as ref_heal
from tritonk8ssupervisor_tpu_torch.provision import events, heal

SIDES = {"reference": ref_events, "port": events}


def kinds(mod) -> dict:
    """The record vocabulary: every public upper-case string constant."""
    return {name: value for name, value in vars(mod).items()
            if name.isupper() and not name.startswith("_") and isinstance(value, str)}


def test_the_vocabulary_and_the_slice_states_are_the_references():
    assert kinds(events) == kinds(ref_events)
    assert len(kinds(events)) == 40
    assert events.SCHEMA_VERSION == ref_events.SCHEMA_VERSION
    for name in ("_ROLE_SERVING", "_ROLE_TRAINING", "_ROLE_TRANSITIONING", "_HEALTHY",
                 "_DRAINING", "_LOST"):
        assert getattr(events, name) == getattr(ref_events, name), name
    for name in ("HEALTHY", "MISSING", "UNREADY", "DRAINING", "DEGRADED"):
        assert getattr(heal, name) == getattr(ref_heal, name), name
    assert events._HEALTHY == heal.HEALTHY and events._DRAINING == heal.DRAINING
    assert events._LOST == (heal.MISSING, heal.UNREADY)


def random_records(seed: int, n: int = 160) -> list:
    """A seeded stream over every record kind but the snapshot, with the
    fields each kind's fold reads: slices, states, heal ids (some never
    closed), domains, job acks, scales and handovers (some aborted), and
    leases whose epochs are mostly fresh and sometimes stale."""
    rng = random.Random(seed)
    vocab = sorted(v for k, v in kinds(ref_events).items() if v != ref_events.SNAPSHOT)
    states = ["healthy", "missing", "unready", "draining", "degraded", "unknown"]
    slices = lambda: sorted(rng.sample(range(6), rng.randint(1, 3)))  # noqa: E731
    records: list = []
    ts = 0.0
    epoch = 0
    for _ in range(n):
        ts += rng.choice([0.0, 1.0, 7.5, 30.0])
        kind = rng.choice(vocab)
        r = {"ts": ts, "kind": kind}
        k = kind
        if k == ref_events.SUPERVISOR_START:
            r.update(pid=7, autoscale=rng.random() < 0.5,
                     active=slices() if rng.random() < 0.5 else None)
        elif k == ref_events.TICK:
            r.update(tick=len(records), states={str(i): rng.choice(states) for i in slices()})
        elif k in (ref_events.VERDICT, ref_events.MAINTENANCE):
            r.update(slice=rng.randrange(6), state=rng.choice(states), detail=f"d{rng.random()}",
                     streak=rng.randrange(4), domain=rng.choice(["", "z-fd0", "z-fd1"]))
        elif k in (ref_events.HEAL_START, ref_events.HEAL_DONE, ref_events.HEAL_FAILED):
            r.update(id=f"h{rng.randrange(4)}", slices=slices(), mttr_s=[rng.random() * 100],
                     domains=rng.sample(["z-fd0", "z-fd1"], rng.randint(0, 2)),
                     canary=rng.random() < 0.2)
        elif k.startswith("domain-") or k == ref_events.HEAL_DEFERRED:
            r.update(domain=rng.choice(["z-fd0", "z-fd1"]), slices=slices(),
                     reopen_at=ts + 300.0, slice=rng.randrange(6))
        elif k in (ref_events.BREAKER_OPEN, ref_events.SCALE_BREAKER_OPEN):
            r.update(reopen_at=ts + 600.0, failures=3, trip=1)
        elif k in (ref_events.JOB_NOTIFIED, ref_events.JOB_RESUMED, ref_events.DEGRADED_ACK):
            r.update(generation=rng.randrange(1, 5), step=rng.randrange(100), slices=slices(),
                     degraded=rng.random() < 0.5,
                     mttr_s=rng.random() * 10 if rng.random() < 0.5 else None)
        elif k.startswith("scale-"):
            r.update(direction=rng.choice(["up", "down"]), from_count=rng.randrange(1, 6),
                     to_count=rng.randrange(1, 6), reason="demand", windows=rng.randrange(4),
                     slices=slices(), active=slices() if rng.random() < 0.5 else None,
                     cooldown_until=ts + 120.0 if rng.random() < 0.5 else None,
                     id=f"s{rng.randrange(3)}", drain_deadline=ts + 60.0)
        elif k in (ref_events.ALLOC_DECISION, ref_events.PREEMPT_NOTICE,
                   ref_events.PREEMPT_ACK, ref_events.ROLE_CHANGED):
            r.update(direction=rng.choice(["to-serving", "to-training"]), count=1,
                     reason="demand", windows=2, slices=slices(), id=f"a{rng.randrange(3)}",
                     role=rng.choice(["serving", "training"]), forced=rng.random() < 0.3,
                     aborted=rng.random() < 0.2,
                     cooldown_until=ts + 90.0 if rng.random() < 0.5 else None,
                     ack_deadline=ts + 30.0, drain_deadline=ts + 60.0)
        elif k == ref_events.LEASE_GRANT:
            epoch += 1
            r.update(slice=rng.randrange(4), replica=f"g{rng.randrange(3)}", epoch=epoch,
                     expires_at=ts + 30.0)
        elif k in (ref_events.LEASE_RENEW, ref_events.LEASE_EXPIRE, ref_events.LEASE_REVOKE):
            r.update(slice=rng.randrange(4), replica=f"g{rng.randrange(3)}",
                     epoch=max(0, epoch - rng.randrange(2)), expires_at=ts + 30.0, at=ts,
                     reason="replica-dead")
        else:
            r.update(slice=rng.randrange(6), retry_at=ts + 200.0, slices=slices())
        records.append(r)
    return records


STREAMS = {
    "seeded": seeded_records,
    "domain": domain_records,
    "pre-domain": lambda: [json.loads(line) for line in PRE_DOMAIN_FIXTURE.splitlines()],
    "pre-domain-snapshot": lambda: [json.loads(PRE_DOMAIN_SNAPSHOT)],
    **{f"random-{seed}": (lambda seed=seed: random_records(seed)) for seed in (0, 1, 2)},
}


def view_fields(view) -> dict:
    return dataclasses.asdict(view)


def restored_fields(view) -> dict:
    """The view's fields with its open heals in id order: a snapshot keeps
    the pending heals keyed by id and written with sorted keys, so a
    compacted ledger restores them in that order, in both packages."""
    fields = view_fields(view)
    fields["open_heals"] = sorted(fields["open_heals"], key=lambda r: str(r.get("id")))
    return fields


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_a_stream_folds_to_the_same_view_and_status(name):
    records = STREAMS[name]()
    ref_view, view = ref_events.fold(records), events.fold(records)
    assert view_fields(view) == view_fields(ref_view)
    now = (records[-1]["ts"] if records else 0.0) + 50.0
    for all_slices in (False, True):
        for fleet in (None, {"stalest_demand_age_s": 4.0}):
            assert events.fleet_status(view, now, pid=7, all_slices=all_slices,
                                       gateway_fleet=fleet) == ref_events.fleet_status(
                ref_view, now, pid=7, all_slices=all_slices, gateway_fleet=fleet)
    assert events.snapshot_fields(view) == ref_events.snapshot_fields(ref_view)


def test_the_random_streams_use_every_kind_and_reach_the_lease_block():
    seen = {r["kind"] for seed in (0, 1, 2) for r in random_records(seed)}
    assert seen == set(kinds(events).values()) - {events.SNAPSHOT}
    view = events.fold(random_records(0))
    assert view.lease_grants and view.lease_renews and view.lease_revokes
    doc = events.fleet_status(view, 1e4)
    assert doc["gateway_fleet"]["grants"] == view.lease_grants


def write_records(led, records):
    for r in records:
        fields = {k: v for k, v in r.items() if k not in ("kind", "ts")}
        led._clock = lambda ts=r["ts"]: ts
        led.append(r["kind"], **fields)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_compact_round_trips_to_the_same_view_on_both_sides(name, tmp_path):
    """Each side writes the stream, compacts it to one snapshot (the same
    record on both sides, parsed), and folds it back to the original's
    view; a record appended after the compaction folds on top equally."""
    records = STREAMS[name]()
    later = {"ts": 1e4, "kind": events.LEASE_GRANT, "slice": 9, "replica": "g0",
             "epoch": 10_000, "expires_at": 1e4 + 30.0}
    out = {}
    for side, mod in SIDES.items():
        led = mod.EventLedger(tmp_path / f"{side}.jsonl", echo=lambda line: None, fsync=False)
        write_records(led, records)
        written = led.replay()
        led._clock = lambda: 9e3
        dropped = led.compact()
        after = led.replay()
        assert dropped == max(0, len(records) - 1)
        assert restored_fields(mod.fold(after)) == restored_fields(mod.fold(written))
        write_records(led, [later])
        final = led.replay()
        assert restored_fields(mod.fold(final)) == restored_fields(
            mod.fold(written + final[-1:]))
        assert [p.name for p in tmp_path.iterdir() if p.name.startswith(".")] == []
        out[side] = after
    assert out["port"] == out["reference"]


def test_compact_of_nothing_or_one_record_is_a_no_op(tmp_path):
    led = events.EventLedger(tmp_path / "e.jsonl", echo=lambda line: None)
    assert led.compact() == 0
    led.append(events.SUPERVISOR_START, pid=1)
    assert led.compact() == 0
    assert [r["kind"] for r in led.replay()] == [events.SUPERVISOR_START]


def test_the_subclasses_keep_their_own_compaction(tmp_path):
    """The request journal overrides `compact` (its key snapshots): adding
    the base one changes nothing there."""
    from tritonk8ssupervisor_tpu_torch.serving import reqlog

    assert reqlog.RequestLog.compact is not events.EventLedger.compact
    log = reqlog.RequestLog(tmp_path / "r.jsonl", clock=lambda: 1.0, echo=lambda line: None,
                            fsync=False)
    log.append(reqlog.ACCEPTED, key="k", rid=1, prompt_len=4, max_new_tokens=2)
    log.append(reqlog.COMPLETED, key="k", result={"tokens": [1, 2]})
    log.compact()
    assert [r["kind"] for r in log.replay()] == [reqlog.STATE]


def test_write_fleet_status_is_atomic(tmp_path, monkeypatch):
    """The document lands whole through a temp file and `os.replace`, on
    both sides byte for byte; a failed write leaves the old document."""
    doc = events.fleet_status(events.fold(seeded_records()), now=800.0, pid=7)
    paths = {side: tmp_path / side / "fleet-status.json" for side in SIDES}
    for side, mod in SIDES.items():
        mod.write_fleet_status(paths[side], doc)
    assert paths["port"].read_bytes() == paths["reference"].read_bytes()
    assert json.loads(paths["port"].read_text()) == doc
    assert sorted(p.name for p in paths["port"].parent.iterdir()) == ["fleet-status.json"]

    def torn(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", torn)
    with pytest.raises(OSError, match="disk full"):
        events.write_fleet_status(paths["port"], {"verdict": "degraded"})
    assert json.loads(paths["port"].read_text()) == doc
