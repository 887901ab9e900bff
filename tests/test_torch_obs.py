"""The port's telemetry plane (`obs/`) against the JAX package's on the
CPU: one sequence of counter, gauge and histogram operations renders the
same Prometheus text, snapshot and query answers; spans written by both
tracers on a fixed clock and incarnation replay equal, through the same
durable ledger (torn final line included); `Telemetry` wires the same
files; and the engine's `"prefill-chunk"` spans equal the reference
engine's field for field, apart from the times.
"""

import threading

import numpy as np
import pytest
from test_torch_decode import lm_pair

from tritonk8ssupervisor_tpu import obs as ref_obs
from tritonk8ssupervisor_tpu.obs import metrics as ref_metrics
from tritonk8ssupervisor_tpu.obs import trace as ref_trace
from tritonk8ssupervisor_tpu.provision.state import RunPaths as RefRunPaths
from tritonk8ssupervisor_tpu.serving import gateway as ref_gw
from tritonk8ssupervisor_tpu.serving.engine import SlotEngine as RefSlotEngine
from tritonk8ssupervisor_tpu_torch import obs
from tritonk8ssupervisor_tpu_torch.obs import metrics, trace
from tritonk8ssupervisor_tpu_torch.provision.state import RunPaths
from tritonk8ssupervisor_tpu_torch.serving import gateway as gw
from tritonk8ssupervisor_tpu_torch.serving.engine import SlotEngine

SIDES = {"reference": (ref_metrics, ref_trace, ref_obs), "port": (metrics, trace, obs)}


def quiet(_line):
    pass


def exercise(registry):
    """One fixed sequence of operations, labels with characters that need
    escaping included."""
    c = registry.counter("requests_total", "requests by outcome")
    c.inc()
    c.inc(2, outcome="ok")
    c.inc(outcome='quote"d\nline\\')
    c.inc(0.5, outcome="ok", replica="g1")
    g = registry.gauge("queue_depth", "queued requests")
    g.set(7)
    g.add(-2)
    g.set(1.25, replica="g1")
    h = registry.histogram("latency_seconds", "latency")
    for v in (0.0004, 0.001, 0.0015, 0.3, 2.0, 1e6):
        h.observe(v)
    h.observe(0.02, replica="g1")
    hb = registry.histogram("small", "custom buckets", buckets=metrics.log_buckets(0.5, 3.0, 4))
    hb.observe(1.0)
    registry.counter("never_fired_total", "registered, never incremented")
    assert registry.counter("requests_total") is c  # get-or-create
    return {
        "value": c.value(outcome="ok"), "total": c.total(),
        "per_label": c.per_label("outcome"), "per_label_match": c.per_label(
            "outcome", replica="g1"),
        "gauge": (g.value(), g.value(replica="g1"), g.value(replica="none")),
        "hist": (h.count(), h.sum(), h.snapshot_value(), h.count(replica="g1")),
    }


def test_the_same_operations_render_the_same_text_and_snapshot(tmp_path):
    out = {}
    for side, (m, _, _) in SIDES.items():
        registry = m.MetricsRegistry(clock=lambda: 1234.5)
        answers = exercise(registry)
        snap = registry.snapshot()
        written = registry.write_snapshot(tmp_path / side / "metrics.json")
        out[side] = {
            "answers": answers, "render": registry.render(), "snapshot": snap,
            "written": written, "file": (tmp_path / side / "metrics.json").read_text(),
            "queries": (m.counter_total(snap, "requests_total"),
                        m.counter_by_label(snap, "requests_total", "outcome"),
                        m.gauge_value(snap, "queue_depth"),
                        m.gauge_value(snap, "queue_depth", {"replica": "g1"}),
                        m.counter_total(snap, "absent_total")),
            "buckets": m.log_buckets(), "escape": m.escape_label_value('a"b\\c\nd'),
        }
    assert out["port"] == out["reference"]
    assert "# TYPE latency_seconds histogram" in out["port"]["render"]
    assert 'outcome="quote\\"d\\nline\\\\"' in out["port"]["render"]
    with pytest.raises(ValueError):
        metrics.log_buckets(0.0)


def test_a_name_registered_as_another_type_raises_on_both_sides():
    for m, _, _ in SIDES.values():
        registry = m.MetricsRegistry()
        registry.counter("x_total")
        with pytest.raises(ValueError):
            registry.gauge("x_total")


def test_counters_are_thread_safe():
    registry = metrics.MetricsRegistry()
    c = registry.counter("hits_total")

    def bump():
        for _ in range(2000):
            c.inc(worker="w")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert c.value(worker="w") == 16000


def write_spans(m_trace, path, fsync=False):
    ticks = iter(np.arange(100.0, 200.0, 0.25))
    log = m_trace.SpanLog(path, clock=lambda: 50.0, echo=quiet, fsync=fsync)
    tracer = m_trace.Tracer(log, plane=m_trace.SERVING, clock=lambda: float(next(ticks)),
                            incarnation=41)
    assert tracer.enabled
    tracer.emit("prefill", 1.0, 2.1234567, key="k1", rid=1, slice=None, where="slot")
    tracer.event("admission", 3.0, key="k2", rid=2)
    tracer.emit_many([("queue-wait", 0.0, 1.0, "k1", {"rid": 1}),
                      ("complete", 2.5, 2.5, "k1", {"rid": 1, "generated": 4})])
    tracer.emit_many([])
    with tracer.span("tick", key=None, reason="poll"):
        pass
    tracer.incarnation += 1
    tracer.event("requeue", 4.0, key="k2", cause="engine-failure")
    return log


@pytest.mark.parametrize("fsync", [False, True], ids=["buffered", "fsync"])
def test_spans_replay_equal(tmp_path, fsync):
    replays = {}
    for side, (_, t, _) in SIDES.items():
        log = write_spans(t, tmp_path / f"{side}.jsonl", fsync=fsync)
        replays[side] = (log.replay(), log.spans(), (tmp_path / f"{side}.jsonl").read_text())
    assert replays["port"] == replays["reference"]
    spans = replays["port"][1]
    assert [s["span"] for s in spans] == ["prefill", "admission", "queue-wait", "complete",
                                          "tick", "requeue"]
    assert spans[0]["end"] == 2.123457 and "slice" not in spans[0]
    assert [s["incarnation"] for s in spans] == [41] * 5 + [42]
    # a disabled tracer writes nothing and costs one attribute test
    off = trace.Tracer(None)
    assert not off.enabled
    off.emit("x", 0.0, 1.0)
    off.emit_many([("x", 0.0, 1.0, None, {})])


def test_a_torn_span_line_is_truncated_on_both_sides(tmp_path):
    for side, (_, t, _) in SIDES.items():
        path = tmp_path / f"{side}.jsonl"
        write_spans(t, path).replay()
        good = path.read_text()
        path.write_text(good + '{"v": 1, "kind": "sp')
        lines: list = []
        assert len(t.SpanLog(path, echo=lines.append).spans()) == 6
        assert path.read_text() == good and "torn final line" in lines[0]


def test_telemetry_bundles_wire_the_same_files(tmp_path):
    out = {}
    for side, (_, _, o) in SIDES.items():
        root = tmp_path / side
        paths = (RefRunPaths if side == "reference" else RunPaths)(root)
        off = o.Telemetry.off(clock=lambda: 5.0)
        assert not off.tracer.enabled and off.write_snapshot() is None
        tel = o.Telemetry.for_run(paths, clock=lambda: 9.0, incarnation=3, fsync=False,
                                  echo=quiet)
        tel.tracer.event("admission", 1.0, key="k")
        assert tel.bump_incarnation() == 4
        tel.tracer.event("recover", 2.0)
        tel.metrics.counter("c_total").inc()
        doc = tel.write_snapshot()
        out[side] = {"spans": tel.tracer.log.spans(), "snapshot": doc,
                     "files": sorted(p.name for p in root.iterdir()),
                     "paths": {name: getattr(paths, name).name for name in (
                         "fleet_status", "request_log", "demand_signal", "span_log",
                         "metrics_snapshot")}}
    assert out["port"] == out["reference"]
    assert out["port"]["files"] == ["metrics.json", "telemetry-spans.jsonl"]


def chunk_spans(side, tmp_path):
    """Two requests (one joining the other's warm prefix) through one
    side's engine with a wired tracer, a drafter shadowing every chunk."""
    jmodel, jparams, model, params = lm_pair(seed=0, num_layers=1, max_seq_len=48)
    jdraft, jdparams, draft, dparams = lm_pair(seed=1, num_layers=1, max_seq_len=48)
    ticks = iter(range(10_000))
    clock = lambda: float(next(ticks))  # noqa: E731 - a counter as a clock
    m_trace = SIDES[side][1]
    tracer = m_trace.Tracer(m_trace.SpanLog(tmp_path / f"{side}.jsonl", echo=quiet,
                                            fsync=False), clock=clock, incarnation=7)
    if side == "reference":
        engine = RefSlotEngine(jmodel, jparams, slots=2, max_len=48, prefill_chunk=4,
                               page_size=4, tracer=tracer, slice_index=3, draft_model=jdraft,
                               draft_params=jdparams, spec_k=2)
        make = ref_gw.Request
    else:
        engine = SlotEngine(model, params, slots=2, max_len=48, prefill_chunk=4, page_size=4,
                            tracer=tracer, slice_index=3, draft_model=draft,
                            draft_params=dparams, spec_k=2)
        make = gw.Request
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 64, 8)
    a = np.concatenate([prefix, rng.integers(0, 64, 5)]).astype(np.int32)
    b = np.concatenate([prefix, rng.integers(0, 64, 2)]).astype(np.int32)
    engine.join(0, make(rid=10, prompt_len=a.size, max_new_tokens=3, tokens=a, key="ka"))
    out = {}
    for step in range(40):
        res = engine.step()
        if step == 5:
            engine.join(1, make(rid=11, prompt_len=b.size, max_new_tokens=3, tokens=b,
                                key="kb"))
        if res is not None:
            for slot, ids in res.finished.items():
                out[slot] = ids
                engine.release(slot)
        if len(out) == 2:
            break
    return tracer.log.spans(), out


def test_engine_prefill_chunk_spans_match_the_reference(tmp_path):
    ref_spans, ref_out = chunk_spans("reference", tmp_path)
    spans, out = chunk_spans("port", tmp_path)
    assert out == ref_out

    def fields(records):
        return [{k: v for k, v in r.items() if k not in ("start", "end", "ts")}
                for r in records]

    assert fields(spans) == fields(ref_spans)
    assert [(s["key"], s["start_token"], s["tokens"]) for s in spans] == [
        ("ka", 0, 4), ("ka", 4, 4), ("ka", 8, 4), ("ka", 12, 1), ("kb", 8, 2)]
    assert all(s["span"] == "prefill-chunk" and s["slice"] == 3 and s["incarnation"] == 7
               and s["end"] > s["start"] for s in spans)
    # without a tracer the engine emits nothing and reads no clock
    engine = SlotEngine(*lm_pair(seed=0, num_layers=1, max_seq_len=48)[2:], slots=1,
                        max_len=48, prefill_chunk=4, page_size=4)
    assert not engine._tracer.enabled
