"""The port's gateway, request journal and open-loop traffic against the
JAX package's on the CPU: one request stream through the reference's
`Gateway` over the JAX `SlotEngine` and through the port's over the port's
`SlotEngine` (admissions, terminal states, tokens, journal records and the
metrics snapshot identical); the modeled engines under one seeded
open-loop stream with tenants, a drain and a generation bump (`report()`
equal dict for dict); and the journal's fold, compaction, torn final line
and crash recovery.

Both sides run on one virtual clock each, stepped by hand (real engines
return dt=0.0), so every timestamp, latency and journal record is a pure
function of the stream. Models are f32 with head_dim 16
(tests/test_torch_decode.py says why): token for token equal.
"""

import dataclasses
import json

import numpy as np
import pytest
from test_torch_decode import lm_pair

from tritonk8ssupervisor_tpu import obs as ref_obs
from tritonk8ssupervisor_tpu.provision import events as ref_events
from tritonk8ssupervisor_tpu.provision import fleetview as ref_fleetview
from tritonk8ssupervisor_tpu.serving import gateway as ref_gw
from tritonk8ssupervisor_tpu.serving import reqlog as ref_reqlog
from tritonk8ssupervisor_tpu.serving import traffic as ref_traffic
from tritonk8ssupervisor_tpu.serving.engine import SlotEngine as RefSlotEngine
from tritonk8ssupervisor_tpu.testing.simclock import SimClock
from tritonk8ssupervisor_tpu_torch import obs
from tritonk8ssupervisor_tpu_torch.provision import events, fleetview
from tritonk8ssupervisor_tpu_torch.serving import gateway as gw
from tritonk8ssupervisor_tpu_torch.serving import reqlog
from tritonk8ssupervisor_tpu_torch.serving import traffic
from tritonk8ssupervisor_tpu_torch.serving.engine import SlotEngine

MAX_LEN = 48
# (reference modules, port modules): each side of a comparison runs only
# on its own package
SIDES = {
    "reference": {"gw": ref_gw, "reqlog": ref_reqlog, "obs": ref_obs,
                  "traffic": ref_traffic, "fleetview": ref_fleetview},
    "port": {"gw": gw, "reqlog": reqlog, "obs": obs, "traffic": traffic,
             "fleetview": fleetview},
}


def quiet(_line):
    pass


class StepClock:
    """A virtual clock that only the test moves."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def lm():
    """A 1-layer f32 LM on both sides from one set of weights."""
    jmodel, jparams, model, params = lm_pair(seed=0, num_layers=1, max_seq_len=MAX_LEN)
    return {"reference": (jmodel, jparams), "port": (model, params)}


def make_engine(side: str, lm, **kwargs):
    model, params = lm[side]
    cls = RefSlotEngine if side == "reference" else SlotEngine
    return cls(model, params, slots=2, max_len=MAX_LEN, prefill_chunk=4, page_size=4,
               **kwargs)


def stream():
    """(rid, step, tokens, max_new_tokens, deadline_s, key): staggered
    arrivals, three prompts sharing an 8-token prefix (the third waits for
    a slot and joins the warm prefix store), an over-long prompt, a
    request already past its zero deadline, and a duplicate of a served
    key."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 64, 8)

    def prompt(n):
        return np.concatenate([prefix, rng.integers(0, 64, n)]).astype(np.int32)

    return [
        (0, 0, prompt(4), 6, None, "a"),
        (1, 0, prompt(3), 5, None, "b"),
        (2, 1, rng.integers(0, 64, 40).astype(np.int32), 2, None, "too-long"),
        (3, 2, prompt(2), 4, 0.0, "dead"),
        (4, 3, prompt(6), 4, None, "c"),
        (5, 40, None, 6, None, "a"),  # the key of rid 0 again, once served
    ]


def serve_stream(side: str, engine, tmp_path):
    """The stream through one side's gateway, a step boundary every 10 ms
    of virtual time. Returns (gateway, admissions, requests)."""
    mods = SIDES[side]
    clock = StepClock()
    policy = mods["gw"].GatewayPolicy(max_seq_len=MAX_LEN, slots_per_slice=2,
                                      prefill_chunk=4, page_size=4, bucket_bounds=(16, 32))
    log = mods["reqlog"].RequestLog(tmp_path / f"{side}.jsonl", clock=clock, echo=quiet,
                                    fsync=False)
    gateway = mods["gw"].Gateway({0: engine}, None, policy=policy, clock=clock, reqlog=log,
                                 telemetry=mods["obs"].Telemetry.off(clock))
    arrivals = stream()
    first_tokens = {rid: tokens for rid, _, tokens, *_ in arrivals if tokens is not None}
    admissions: dict = {}
    requests: dict = {}
    for step in range(400):
        clock.t = step * 0.01
        for rid, at, tokens, new, deadline, key in arrivals:
            if at != step:
                continue
            tokens = first_tokens[0] if tokens is None else tokens
            req = mods["gw"].Request(rid=rid, prompt_len=int(tokens.size),
                                     max_new_tokens=new, tokens=tokens, deadline_s=deadline,
                                     key=key)
            requests[rid] = req
            admissions[rid] = gateway.submit(req, clock.t)
        gateway.workers[0].step(clock.t)
        if step > max(a[1] for a in arrivals) and gateway.workers[0].idle():
            break
    gateway.update_gauges()
    return gateway, admissions, requests


def terminal(req):
    if req.done_at is not None:
        return ("completed", req.done_at)
    if req.expired_at is not None:
        return ("expired", req.expired_where, req.expired_at)
    return ("open",)


def test_one_stream_through_both_gateways_is_identical(lm, tmp_path):
    runs = {side: serve_stream(side, make_engine(side, lm), tmp_path) for side in SIDES}
    (ref, ref_adm, ref_reqs), (port, adm, reqs) = runs["reference"], runs["port"]
    assert sorted(adm) == sorted(ref_adm) == list(range(6))
    for rid in adm:
        assert (adm[rid].ok, adm[rid].reason, adm[rid].retry_after_s, adm[rid].result) == (
            ref_adm[rid].ok, ref_adm[rid].reason, ref_adm[rid].retry_after_s,
            ref_adm[rid].result), rid
        assert terminal(reqs[rid]) == terminal(ref_reqs[rid]), rid
        assert reqs[rid].out_tokens == ref_reqs[rid].out_tokens, rid
        assert reqs[rid].generated == ref_reqs[rid].generated, rid
    # the stream exercises every outcome it was built for
    assert [adm[r].reason for r in range(6)] == [
        gw.ACCEPTED, gw.ACCEPTED, gw.REJECT_UNSERVABLE, gw.ACCEPTED, gw.ACCEPTED, gw.REPLAYED]
    assert terminal(reqs[3])[:2] == ("expired", "queue")
    assert all(len(reqs[r].out_tokens) == reqs[r].max_new_tokens for r in (0, 1, 4))
    assert reqs[4].dispatched_at > reqs[4].arrival  # it waited for a slot
    assert adm[5].result["tokens"] == reqs[0].out_tokens
    # the journal, record for record (kinds per key included), and the
    # whole metrics snapshot
    ref_records, records = ref.reqlog.replay(), port.reqlog.replay()
    assert records == ref_records

    def kinds(recs):
        out: dict = {}
        for r in recs:
            out.setdefault(r.get("key"), []).append(r["kind"])
        return out

    assert kinds(records) == kinds(ref_records)
    assert kinds(records)["a"] == [reqlog.ACCEPTED, reqlog.DISPATCHED, reqlog.COMPLETED,
                                   reqlog.REPLAYED]
    assert port.telemetry.metrics.snapshot() == ref.telemetry.metrics.snapshot()
    assert port.telemetry.metrics.render() == ref.telemetry.metrics.render()
    assert port.report() == ref.report()
    assert port.engine_report().keys() == ref.engine_report().keys()


def test_engine_report_keys_match_the_reference_with_a_drafter(lm, tmp_path):
    """`engine_report()` and `report()` merge `stats()` and the spec block
    by key: with a drafter the port's keys and values are the
    reference's."""
    draft = lm_pair(seed=1, num_layers=1, max_seq_len=MAX_LEN)
    drafts = {"reference": draft[:2], "port": draft[2:]}
    runs = {}
    for side in SIDES:
        model, params = drafts[side]
        engine = make_engine(side, lm, draft_model=model, draft_params=params, spec_k=2)
        runs[side] = serve_stream(side, engine, tmp_path)[0]
    ref, port = runs["reference"], runs["port"]
    assert port.engine_report()["spec"]["drafted"] > 0
    assert port.engine_report() == ref.engine_report()
    assert port.report() == ref.report()
    for a, b in zip(port.metrics.completed, ref.metrics.completed):
        assert (a.rid, a.out_tokens) == (b.rid, b.out_tokens)


def write_status(path, generation, draining=(), down=()):
    degraded = sorted(set(down) | set(draining))
    ref_events.write_fleet_status(path, {
        "verdict": "degraded" if degraded else "healthy",
        "updated": 0.0,
        "slices_total": 2,
        "membership": {"generation": generation, "heal_in_progress": bool(down),
                       "draining": sorted(draining)},
        "degraded": degraded,
        "serving": {"eligible": [i for i in range(2) if i not in degraded],
                    "avoid": {str(i): "missing" for i in down}, "shed": False},
    })


def modeled_drive(side: str, tmp_path):
    """Two modeled slices with speculative decoding under two tenants'
    seeded open-loop streams (shared prefixes, keys, deadlines): slice 0
    drains from 20 s to 30 s, slice 1 leaves the serving set on a
    generation bump at 40 s, in a burst (its in-flight work requeued), and
    returns at 60 s."""
    mods = SIDES[side]
    root = tmp_path / side
    root.mkdir()
    status = root / "fleet-status.json"
    write_status(status, 1)
    clock = SimClock()
    policy = mods["gw"].GatewayPolicy(
        max_seq_len=512, slots_per_slice=2, prefill_chunk=64, bucket_bounds=(64, 128, 256),
        tenant_weights={"interactive": 3.0, "batch": 1.0}, queue_budget=24, spec_k=2,
        demand_signal_every_s=5.0)
    engines = {i: mods["gw"].ModeledEngine(slots=2, prefill_chunk=64, num_pages=96,
                                           spec_k=2) for i in range(2)}
    log = mods["reqlog"].RequestLog(root / "r.jsonl", clock=clock.time, echo=quiet,
                                    fsync=False)
    gateway = mods["gw"].Gateway(
        engines, mods["fleetview"].FileHealthSource(status), policy=policy,
        clock=clock.time, reqlog=log, telemetry=mods["obs"].Telemetry.off(clock.time),
        demand_path=root / "demand-signal.json")
    model = mods["traffic"].TrafficModel
    arrivals = sorted(
        mods["traffic"].generate_arrivals(
            model(base_rps=1.5, seed=11, tenant="interactive", priority=1,
                  shared_prefix_len=96, shared_prefix_share=0.5, key_prefix="i",
                  deadline_s=30.0, bursts=((30.0, 10.0, 3.0),)), 80.0)
        + mods["traffic"].generate_arrivals(
            model(base_rps=1.0, seed=12, tenant="batch", key_prefix="b"), 80.0, rid0=10_000),
        key=lambda r: r.arrival)
    events = (
        mods["traffic"].WorldEvent(20.0, lambda g: write_status(status, 1, draining=(0,))),
        mods["traffic"].WorldEvent(30.0, lambda g: write_status(status, 1)),
        mods["traffic"].WorldEvent(40.0, lambda g: write_status(status, 2, down=(1,))),
        mods["traffic"].WorldEvent(60.0, lambda g: write_status(status, 3)),
    )
    clock.begin()
    try:
        report = mods["traffic"].drive_open_loop(gateway, arrivals, clock, horizon_s=80.0,
                                                  events=events)
    finally:
        clock.release()
    return gateway, report, arrivals, root


def test_modeled_engines_under_one_open_loop_stream_report_the_same(tmp_path):
    ref, ref_report, ref_arrivals, ref_root = modeled_drive("reference", tmp_path)
    port, report, arrivals, root = modeled_drive("port", tmp_path)
    fields = ("rid", "prompt_len", "max_new_tokens", "arrival", "prefix_len", "prefix_id",
              "key", "deadline_s", "tenant", "priority")
    assert [[getattr(r, f) for f in fields] for r in arrivals] == [
        [getattr(r, f) for f in fields] for r in ref_arrivals]
    assert report == ref_report
    # the drive exercised what it scripted
    assert report["completed"] > 20 and report["quiescent"]
    assert report["requeued_after_slice_loss"] > 0
    assert report["engine"]["spec"]["drafted"] > 0
    assert report["engine"]["prefix"]["hits"] > 0
    assert port.reqlog.replay() == ref.reqlog.replay()
    assert port.telemetry.metrics.snapshot() == ref.telemetry.metrics.snapshot()
    assert (root / "demand-signal.json").read_text() == (
        ref_root / "demand-signal.json").read_text()


def keyed_records(tmp_path):
    """A journal written by the reference's gateway: served, expired, shed,
    replayed and still-open keys."""
    clock = StepClock()
    log = ref_reqlog.RequestLog(tmp_path / "src.jsonl", clock=clock, echo=quiet, fsync=False)
    gateway = ref_gw.Gateway(
        {0: ref_gw.ModeledEngine(slots=1, prefill_chunk=64)}, None,
        policy=ref_gw.GatewayPolicy(max_seq_len=512, slots_per_slice=1,
                                    bucket_bounds=(64, 128)),
        clock=clock, reqlog=log)
    for rid, (plen, new, deadline) in enumerate([(10, 2, None), (20, 3, 0.0), (300, 2, None),
                                                 (30, 4, None), (40, 4, 100.0)]):
        gateway.submit(ref_gw.Request(rid=rid, prompt_len=plen, max_new_tokens=new,
                                      deadline_s=deadline, key=f"k{rid}",
                                      tokens=np.arange(plen, dtype=np.int32) % 50), clock.t)
    for step in range(3):
        clock.t = 0.5 * step
        gateway.workers[0].step(clock.t)
    gateway.submit(ref_gw.Request(rid=9, prompt_len=10, max_new_tokens=2, key="k0"), clock.t)
    return log.replay()


def test_journal_fold_compact_and_torn_line_match_the_reference(tmp_path):
    records = keyed_records(tmp_path)
    assert {r["kind"] for r in records} >= {
        reqlog.ACCEPTED, reqlog.DISPATCHED, reqlog.COMPLETED, reqlog.EXPIRED, reqlog.SHED,
        reqlog.REPLAYED}
    body = "".join(json.dumps(r, sort_keys=True) + "\n" for r in records)
    torn = body + '{"v": 1, "kind": "acc'
    views = {}
    for side, mod in (("reference", ref_reqlog), ("port", reqlog)):
        path = tmp_path / f"{side}.jsonl"
        path.write_text(torn)
        lines: list = []
        log = mod.RequestLog(path, clock=lambda: 123.0, echo=lines.append, fsync=False)
        assert log.replay() == records
        assert path.read_text() == body  # the torn line truncated away
        assert len(lines) == 1 and "torn final line" in lines[0]
        view = mod.fold(records)
        views[side] = {
            "keys": {k: dataclasses.asdict(v) for k, v in view.keys.items()},
            "incomplete": [kv.key for kv in view.incomplete()],
            "state": {k: mod.state_fields(v) for k, v in view.keys.items()},
            "merged": mod.merge_records(records[:5], records[5:]),
            "dropped": log.compact(),
            "compacted": path.read_text(),
        }
        # fold(compacted) == fold(original), the compaction's contract
        assert {k: dataclasses.asdict(v) for k, v in mod.fold(log.replay()).keys.items()} == (
            views[side]["keys"])
    assert views["port"] == views["reference"]
    assert views["port"]["incomplete"] == ["k3", "k4"]
    # a corrupt line with valid records after it is fatal on both sides
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json}\n" + body)
    for error, mod in ((ref_events.EventLedgerError, ref_reqlog),
                       (events.EventLedgerError, reqlog)):
        with pytest.raises(error, match="corrupt at line 1"):
            mod.RequestLog(bad, echo=quiet).replay()


def crash_and_recover(side: str, tmp_path):
    """A gateway serves one key, holds one in a slot and one in the queue,
    and is dropped (the crash); a new gateway on the same journal
    recovers. Returns (recover counts, queue order after recovery, the
    replayed admission, the resumed requests' outputs, the journal)."""
    mods = SIDES[side]
    clock = StepClock()
    path = tmp_path / f"{side}-crash.jsonl"
    policy = mods["gw"].GatewayPolicy(max_seq_len=512, slots_per_slice=1,
                                      bucket_bounds=(64, 128))

    def gateway():
        log = mods["reqlog"].RequestLog(path, clock=clock, echo=quiet, fsync=False)
        return mods["gw"].Gateway({0: mods["gw"].ModeledEngine(slots=1, prefill_chunk=64)},
                                  None, policy=policy, clock=clock, reqlog=log)

    first = gateway()
    for rid, plen in enumerate((10, 20, 30)):
        first.submit(mods["gw"].Request(rid=rid, prompt_len=plen, max_new_tokens=3,
                                        key=f"k{rid}"), clock.t)
    while not first.metrics.completed:
        clock.t += 0.1
        first.workers[0].step(clock.t)
    first.workers[0].step(clock.t)  # k1 joins the slot; k2 stays queued
    assert first.workers[0].inflight and first.queue_depth() == 1
    del first  # the crash: nothing settles the open keys
    clock.t += 1.0
    second = gateway()
    counts = second.recover(clock.t)
    order = [r.key for q in second.queues.values() for r in q]
    replay = second.submit(mods["gw"].Request(rid=7, prompt_len=10, max_new_tokens=3,
                                              key="k0"), clock.t)
    while second.queue_depth() or not second.workers[0].idle():
        clock.t += 0.1
        second.workers[0].step(clock.t)
    done = sorted((r.key, r.retries, r.generated) for r in second.metrics.completed)
    return counts, order, (replay.ok, replay.reason, replay.result), done, \
        second.reqlog.replay()


def test_recover_after_a_crash_matches_the_reference(tmp_path):
    ref = crash_and_recover("reference", tmp_path)
    port = crash_and_recover("port", tmp_path)
    assert port == ref
    counts, order, replay, done, _ = port
    assert counts == {"redone": 2, "completed_cached": 1, "expired_on_recover": 0,
                      "unrecoverable": 0}
    assert order == ["k1", "k2"]  # re-admitted front-of-queue, oldest first
    assert replay[:2] == (True, gw.REPLAYED) and replay[2]["generated"] == 3
    assert [d[0] for d in done] == ["k1", "k2"]
