"""The port's analyzers (`obs/analyze.py`) and its `cli.main trace` and
`analyze` against the reference's: the crafted cases of tests/test_obs.py,
one seeded random stream of journal, span and ledger records, and both
packages' gateway-kill drill workdirs give equal timelines, renderings,
fleet intervals and correlations; the commands exit as the reference's
do and print equal documents apart from the path fields. No tolerance:
the documents are compared with `==`."""

import gc
import json

import numpy as np
import pytest

from tritonk8ssupervisor_tpu.cli import main as ref_cli
from tritonk8ssupervisor_tpu.obs import analyze as ref_analyze
from tritonk8ssupervisor_tpu.testing import chaos as ref_chaos
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.obs import analyze
from tritonk8ssupervisor_tpu_torch.obs.trace import SpanLog
from tritonk8ssupervisor_tpu_torch.provision.state import RunPaths
from tritonk8ssupervisor_tpu_torch.serving import reqlog
from tritonk8ssupervisor_tpu_torch.testing import chaos


def _span(name, start, end, key=None, plane="serving", inc=1, **attrs):
    return {"kind": "span", "ts": end, "span": name, "plane": plane,
            "start": start, "end": end, "key": key, "incarnation": inc, **attrs}


def _both(fn_name, *args, **kwargs):
    """The function of that name in both packages on the same inputs:
    (port's, reference's)."""
    return (getattr(analyze, fn_name)(*args, **kwargs),
            getattr(ref_analyze, fn_name)(*args, **kwargs))


def _equal(fn_name, *args, **kwargs):
    ours, ref = _both(fn_name, *args, **kwargs)
    assert ours == ref
    return ours


CRAFTED_JOURNAL = [
    {"kind": "accepted", "ts": 1.0, "key": "k", "prompt_len": 8, "max_new_tokens": 4,
     "deadline_s": 60.0},
    {"kind": "dispatched", "ts": 2.0, "key": "k", "slice": 1, "queued_s": 1.0},
    {"kind": "requeued", "ts": 5.0, "key": "k", "cause": "gateway-restart", "retries": 1},
    {"kind": "dispatched", "ts": 6.0, "key": "k", "slice": 0, "queued_s": 5.0},
    {"kind": "completed", "ts": 9.0, "key": "k", "latency_s": 8.0},
    {"kind": "accepted", "ts": 1.5, "key": "other"},
    {"kind": "state", "ts": 20.0, "key": "compacted", "accepts": 2, "completions": 1,
     "expiries": 1, "state": "expired", "accepted_ts": 3.0},
]
CRAFTED_SPANS = [
    _span("admission", 1.0, 1.0, key="k", inc=1),
    _span("queue-wait", 1.0, 6.0, key="k", inc=2),
    _span("prefill-chunk", 6.0, 6.5, key="k", inc=2, tokens=32, start_token=0),
    _span("prefill", 6.0, 7.0, key="k", inc=2),
    _span("decode", 7.0, 9.0, key="k", inc=2),
    _span("complete", 9.0, 9.0, key="k", inc=2, latency_s=8.0),
    _span("tick", 0.0, 1.0, plane="supervisor"),
]
# heals (one orphaned by a kill mid-heal), global and per-domain breaker
# holds (one left open), a domain outage, and supervisor heal spans
CRAFTED_LEDGER = [
    {"kind": "heal-start", "ts": 100.0, "id": "h1", "slices": [2, 0]},
    {"kind": "heal-done", "ts": 220.0, "id": "h1", "slices": [2, 0]},
    {"kind": "heal-start", "ts": 230.0, "id": "h3", "slices": [1]},
    {"kind": "heal-failed", "ts": 260.0, "id": "h3"},
    {"kind": "heal-done", "ts": 270.0, "id": "never-started"},
    {"kind": "breaker-open", "ts": 300.0},
    {"kind": "breaker-close", "ts": 400.0},
    {"kind": "domain-breaker-open", "ts": 310.0, "domain": "rack-a"},
    {"kind": "domain-breaker-close", "ts": 350.0, "domain": "rack-a"},
    {"kind": "domain-breaker-open", "ts": 450.0, "domain": "rack-b"},
    {"kind": "domain-outage", "ts": 320.0, "domain": "zone-1"},
    {"kind": "domain-recovered", "ts": 380.0, "domain": "zone-1"},
    {"kind": "domain-outage", "ts": 480.0, "domain": "zone-2"},
    {"kind": "heal-start", "ts": 500.0, "id": "h2", "slices": [3], "canary": True},
]
CRAFTED_SUPERVISOR_SPANS = [
    _span("heal-wave", 290.0, 330.0, plane="supervisor", slices=[2]),
    _span("heal", 295.0, 300.0, plane="supervisor"),
    _span("tick", 0.0, 1.0, plane="supervisor"),
]


def test_crafted_timelines_and_renderings_equal_the_reference():
    for key in ("k", "other", "compacted", "nope"):
        timeline = _equal("request_timeline", key, CRAFTED_SPANS, CRAFTED_JOURNAL)
        _equal("render_timeline", timeline)
    timeline = analyze.request_timeline("k", CRAFTED_SPANS, CRAFTED_JOURNAL)
    assert timeline["complete"] and timeline["incarnations"] == [1, 2]
    assert timeline["phases"] == {"queue-wait": 5.0, "prefill": 1.0, "decode": 2.0}
    gap = analyze.request_timeline("other", [], CRAFTED_JOURNAL)
    assert gap["accepts"] == 1 and not gap["complete"]


def test_crafted_fleet_intervals_equal_the_reference():
    intervals = _equal("fleet_intervals", CRAFTED_LEDGER, CRAFTED_SUPERVISOR_SPANS)
    kinds = sorted(iv["kind"] for iv in intervals)
    assert kinds == ["breaker-hold"] * 3 + ["domain-outage"] * 2 + ["heal"] * 4 + ["heal-wave"]
    orphan = [iv for iv in intervals if iv.get("orphaned")]
    assert len(orphan) == 1 and orphan[0]["end"] == float("inf") and orphan[0]["canary"]
    for iv in intervals:
        assert analyze._interval_label(iv) == ref_analyze._interval_label(iv)


def test_crafted_correlation_equals_the_reference():
    spans = [_span("complete", 2.5 * i, 2.5 * i, key=f"b{i}", latency_s=1.0)
             for i in range(120)]
    spans += [_span("complete", 305.0 + 5 * i, 305.0 + 5 * i, key=f"s{i}", latency_s=20.0)
              for i in range(10)]
    spans += CRAFTED_SUPERVISOR_SPANS
    out = _equal("correlate", spans, CRAFTED_LEDGER, window_s=60.0)
    assert out["spikes"] and any("heal-wave span for slice(s) 2" in line
                                 for line in out["attributions"])
    assert any("breaker hold (rack-a)" in line for line in out["attributions"])
    assert _equal("correlate", spans[:120], [], window_s=60.0)["attributions"] == []
    assert _equal("correlate", [], [], req_records=[])["overall_p50_s"] is None
    journal = [{"kind": "completed", "ts": 10.0 + i, "key": f"k{i}", "latency_s": 1.0 + i % 3}
               for i in range(20)]
    assert _equal("correlate", [], CRAFTED_LEDGER, req_records=journal,
                  window_s=4.0)["completions"] == 20
    for q in (0.0, 0.5, 0.99, 1.0):
        values = [3.0, 1.0, 2.0, 7.0, 5.0]
        assert analyze._percentile(values, q) == ref_analyze._percentile(values, q)


def _random_stream(seed: int, keys: int = 24) -> tuple[list, list, list]:
    """A seeded stream of request-journal records, serving and supervisor
    spans and ledger records over shared times, with requeues, expiries,
    sheds, two incarnations and unclosed fleet intervals."""
    rng = np.random.default_rng(seed)
    journal, spans, ledger = [], [], []
    for k in range(keys):
        key = f"key-{k}"
        t = float(rng.uniform(0.0, 600.0))
        journal.append({"kind": "accepted", "ts": round(t, 6), "key": key,
                        "prompt_len": int(rng.integers(4, 256)), "max_new_tokens": 16})
        spans.append(_span("admission", t, t, key=key))
        inc = 1
        for _ in range(int(rng.integers(1, 3))):
            queued = float(rng.exponential(2.0))
            slice_index = int(rng.integers(0, 4))
            journal.append({"kind": "dispatched", "ts": round(t + queued, 6), "key": key,
                            "slice": slice_index, "queued_s": round(queued, 6),
                            "view_age_s": round(float(rng.uniform(0, 3)), 6)})
            if rng.random() < 0.3:
                inc += 1
                journal.append({"kind": "requeued", "ts": round(t + queued + 1, 6),
                                "key": key, "cause": "gateway-restart", "retries": inc - 1})
        prefill = float(rng.exponential(0.5))
        decode = float(rng.exponential(4.0))
        start = t + queued
        spans.append(_span("queue-wait", t, start, key=key, inc=inc))
        spans.append(_span("prefill-chunk", start, start + prefill / 2, key=key, inc=inc,
                           tokens=int(rng.integers(1, 64)), start_token=0))
        spans.append(_span("prefill", start, start + prefill, key=key, inc=inc))
        spans.append(_span("decode", start + prefill, start + prefill + decode, key=key,
                           inc=inc))
        done = start + prefill + decode
        fate = rng.random()
        if fate < 0.75:
            journal.append({"kind": "completed", "ts": round(done, 6), "key": key,
                            "latency_s": round(done - t, 6)})
            spans.append(_span("complete", done, done, key=key, inc=inc,
                               latency_s=round(done - t, 6)))
        elif fate < 0.9:
            journal.append({"kind": "expired", "ts": round(done, 6), "key": key,
                            "reason": "deadline"})
        else:
            journal.append({"kind": "shed", "ts": round(t, 6), "key": key,
                            "reason": "overload", "retry_after_s": 2.0})
    for h in range(6):
        t = float(rng.uniform(0.0, 600.0))
        ledger.append({"kind": "heal-start", "ts": t, "id": f"h{h}",
                       "slices": sorted(rng.choice(4, 2, replace=False).tolist()),
                       "canary": bool(rng.random() < 0.3)})
        if h % 3:
            ledger.append({"kind": "heal-done" if h % 2 else "heal-failed",
                           "ts": t + float(rng.uniform(10, 90)), "id": f"h{h}"})
    for name, (opened, closed) in {"": ("breaker-open", "breaker-close"),
                                   "rack-a": ("domain-breaker-open", "domain-breaker-close"),
                                   "zone-1": ("domain-outage", "domain-recovered")}.items():
        t = float(rng.uniform(0.0, 500.0))
        ledger.append({"kind": opened, "ts": t, **({"domain": name} if name else {})})
        if rng.random() < 0.6:
            ledger.append({"kind": closed, "ts": t + float(rng.uniform(5, 100)),
                           **({"domain": name} if name else {})})
    ledger.sort(key=lambda r: r["ts"])
    spans.append(_span("heal-wave", 200.0, 260.0, plane="supervisor", slices=[1, 3]))
    return journal, spans, ledger


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_stream_equals_the_reference(seed):
    journal, spans, ledger = _random_stream(seed)
    for key in sorted({r["key"] for r in journal}) + ["missing"]:
        timeline = _equal("request_timeline", key, spans, journal)
        _equal("render_timeline", timeline)
    _equal("fleet_intervals", ledger, spans)
    for window_s in (5.0, 30.0, 60.0):
        for spike_factor in (1.5, 2.0):
            _equal("correlate", spans, ledger, req_records=journal, window_s=window_s,
                   spike_factor=spike_factor)
    _equal("correlate", [], ledger, req_records=journal, window_s=30.0)


@pytest.fixture(scope="module")
def kill_drills(tmp_path_factory):
    """Both packages' gateway-kill drills, one workdir each; the drill's
    buffered span log is flushed by collecting the cycle it sits in."""
    out = {}
    for side, mod in {"reference": ref_chaos, "port": chaos}.items():
        root = tmp_path_factory.mktemp(f"kill-drill-{side}")
        out[side] = (root, mod.run_gateway_kill_drill(root))
    gc.collect()
    return out


def test_kill_drill_timelines_equal_the_reference(kill_drills):
    (root, result), (ref_root, ref_result) = kill_drills["port"], kill_drills["reference"]
    assert result["redone_keys"] == ref_result["redone_keys"] and result["redone_keys"]
    timelines = {}
    for side, (workdir, _) in kill_drills.items():
        paths = RunPaths(workdir)
        spans = SpanLog(paths.span_log, echo=lambda line: None).spans()
        records = reqlog.RequestLog(paths.request_log, echo=lambda line: None).replay()
        module = analyze if side == "port" else ref_analyze
        timelines[side] = [module.request_timeline(key, spans, records)
                           for key in result["redone_keys"]]
    assert timelines["port"] == timelines["reference"]
    for timeline in timelines["port"]:
        assert timeline["complete"] and timeline["incarnations"] == [1, 2]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_trace_and_analyze_commands_equal_the_reference(kill_drills, capsys):
    (root, result), (ref_root, _) = kill_drills["port"], kill_drills["reference"]
    for key in result["redone_keys"] + ["no-such-key"]:
        rc, out = _run(cli.main, ["trace", key, "--json", "--workdir", str(root)], capsys)
        ref_rc, ref_out = _run(ref_cli.main, ["trace", key, "--json", "--workdir",
                                              str(ref_root)], capsys)
        assert (rc, json.loads(out)) == (ref_rc, json.loads(ref_out))
        assert rc == (2 if key == "no-such-key" else 0)
        rc, out = _run(cli.main, ["trace", key, "--workdir", str(root)], capsys)
        ref_rc, ref_out = _run(ref_cli.main, ["trace", key, "--workdir", str(ref_root)], capsys)
        assert (rc, out) == (ref_rc, ref_out)
    for flags in (["--correlate", "--json"], ["--json"], ["--correlate", "--window", "5"]):
        rc, out = _run(cli.main, ["analyze", *flags, "--workdir", str(root)], capsys)
        ref_rc, ref_out = _run(ref_cli.main, ["analyze", *flags, "--workdir", str(ref_root)],
                               capsys)
        assert rc == ref_rc == 0
        if "--json" in flags:
            doc, ref_doc = json.loads(out), json.loads(ref_out)
            assert doc.pop("span_log") == str(RunPaths(root).span_log)
            ref_doc.pop("span_log")
            assert doc == ref_doc and doc["spans"] > 0
        else:
            assert out.replace(str(root), "W") == ref_out.replace(str(ref_root), "W")


def test_commands_without_telemetry_exit_1(tmp_path, capsys):
    for argv in (["trace", "some-key"], ["trace"], ["analyze", "--correlate"]):
        argv = argv + ["--workdir", str(tmp_path)]
        assert cli.main(argv) == 1
        assert ref_cli.main(argv) == 1
    err = capsys.readouterr().err
    assert "no span log at" in err and "no telemetry on record" in err
