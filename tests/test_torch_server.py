"""The port's HTTP front door and drill (`serving/server.py`) and the
`serve` command on the CPU, mirroring tests/test_serving.py's HTTP tests
and tests/test_serve_chaos.py's engine-loop crash test: GET /healthz, a
plain and a streamed POST /generate over the port's `SlotEngine` (their
tokens equal to the engine's alone), a 400 for a prompt that cannot fit,
a 504 with the journal trail for an expired deadline, a duplicate key
answered from the journal, GET /metrics, an engine raising mid-step
contained (its work requeued, /healthz 503), `run_drill`, and
`cli.main serve --drill`.

Every client has a timeout and every test stops its server and engine
loop in `finally`, so no test can hang the suite.
"""

import http.client
import json
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from test_torch_decode import lm_pair

from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.serving import gateway as gw
from tritonk8ssupervisor_tpu_torch.serving import reqlog
from tritonk8ssupervisor_tpu_torch.serving import server
from tritonk8ssupervisor_tpu_torch.serving.engine import SlotEngine

MAX_LEN = 32
TIMEOUT_S = 60


def quiet(_line):
    pass


class Serving:
    """A gateway behind `make_handler` on a ThreadingHTTPServer on port 0,
    with its engine loop; a context manager that stops both."""

    def __init__(self, gateway):
        self.gateway = gateway
        self.lock = threading.Lock()
        self.loop = server.EngineLoop(gateway, self.lock)
        self.http = ThreadingHTTPServer(
            ("127.0.0.1", 0), server.make_handler(gateway, self.lock, loop=self.loop))
        self.thread = threading.Thread(target=self.http.serve_forever,
                                       kwargs={"poll_interval": 0.05}, daemon=True)

    def __enter__(self):
        self.loop.start()
        self.thread.start()
        self.conn = http.client.HTTPConnection("127.0.0.1", self.http.server_address[1],
                                               timeout=TIMEOUT_S)
        return self

    def __exit__(self, *exc):
        self.conn.close()
        self.http.shutdown()
        self.http.server_close()
        self.loop.stop()

    def post(self, doc):
        self.conn.request("POST", "/generate", body=json.dumps(doc),
                          headers={"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        return resp, resp.read()

    def get(self, path):
        self.conn.request("GET", path)
        resp = self.conn.getresponse()
        return resp, resp.read()


@pytest.fixture(scope="module")
def lm():
    _, _, model, params = lm_pair(seed=0, num_layers=1, max_seq_len=MAX_LEN)
    return model, params


def engine_gateway(lm, **gateway_kwargs):
    model, params = lm
    engine = SlotEngine(model, params, slots=2, max_len=MAX_LEN, prefill_chunk=8)
    policy = gw.GatewayPolicy(max_seq_len=MAX_LEN, slots_per_slice=2, prefill_chunk=8,
                              bucket_bounds=(16,))
    return gw.Gateway({0: engine}, None, policy=policy, **gateway_kwargs)


def engine_alone(lm, prompt, new):
    model, params = lm
    engine = SlotEngine(model, params, slots=2, max_len=MAX_LEN, prefill_chunk=8)
    engine.join(0, gw.Request(rid=0, prompt_len=len(prompt), max_new_tokens=new,
                              tokens=np.asarray(prompt, np.int32)))
    while True:
        res = engine.step()
        if 0 in res.finished:
            return res.finished[0]


def test_http_plain_and_streamed_generate_equal_the_engine_alone(lm):
    prompt = [1, 2, 3, 4, 5, 6]
    want = engine_alone(lm, prompt, 5)
    with Serving(engine_gateway(lm)) as s:
        resp, body = s.get("/healthz")
        assert resp.status == 200, body
        health = json.loads(body)
        assert health["engine_crashed"] is None and health["shedding"] is None
        assert "per_slice" not in health["engine"]
        resp, body = s.post({"tokens": prompt, "max_new_tokens": 5})
        assert resp.status == 200, body
        plain = json.loads(body)
        assert plain["tokens"] == want and plain["generated"] == 5
        s.conn.request("POST", "/generate", body=json.dumps(
            {"tokens": prompt, "max_new_tokens": 5, "stream": True}),
            headers={"Content-Type": "application/json"})
        resp = s.conn.getresponse()
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(line) for line in resp.read().decode().splitlines()]
        s.conn.close()  # the streamed reply closes its connection
        chunks, tail = lines[:-1], lines[-1]
        assert tail["done"] is True and tail["tokens"] == want
        assert [t for c in chunks for t in c["tokens"]] == want
        assert sum(c["n"] for c in chunks) == 5
        # a prompt that can never fit is a 400, not a hang
        resp, body = s.post({"tokens": list(range(40)), "max_new_tokens": 2})
        assert resp.status == 400 and json.loads(body)["error"] == gw.REJECT_UNSERVABLE
        resp, body = s.post({"max_new_tokens": 2})
        assert resp.status == 400 and "bad request" in json.loads(body)["error"]
        resp, _ = s.get("/nowhere")
        assert resp.status == 404
        resp, body = s.get("/metrics")
        text = body.decode()
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert "serving_requests_completed_total 2" in text
        assert "serving_engine_step_seconds_count" in text
        assert "serving_slots_total 2" in text
        assert "serving_ttft_seconds_count 2" in text
    assert s.loop.crashed is None


def modeled_gateway(tmp_path):
    policy = gw.GatewayPolicy(max_seq_len=512, bucket_bounds=(64, 128, 256), slots_per_slice=2)
    return gw.Gateway({0: gw.ModeledEngine(slots=2, prefill_chunk=64)}, None, policy=policy,
                      reqlog=reqlog.RequestLog(tmp_path / "r.jsonl", echo=quiet))


def test_http_deadline_504_carries_the_journal_trail_and_duplicates_replay(tmp_path):
    gateway = modeled_gateway(tmp_path)
    with Serving(gateway) as s:
        resp, body = s.post({"tokens": [1, 2, 3], "max_new_tokens": 4, "deadline_s": 0.0,
                             "idempotency_key": "dead"})
        doc = json.loads(body)
        assert resp.status == 504
        assert doc["error"] == "deadline-expired" and doc["where"] == "queue"
        assert [e["kind"] for e in doc["trail"]] == [reqlog.ACCEPTED, reqlog.EXPIRED]
        body = {"tokens": [1, 2, 3], "max_new_tokens": 3, "idempotency_key": "once"}
        first, first_body = s.post(body)
        dup, dup_body = s.post(body)
        assert first.status == dup.status == 200
        assert json.loads(dup_body)["replayed"] is True
        assert json.loads(dup_body)["generated"] == json.loads(first_body)["generated"]
        # a streamed request past its deadline ends with the expiry line
        s.conn.request("POST", "/generate", body=json.dumps(
            {"tokens": [1, 2], "max_new_tokens": 2, "deadline_s": 0.0, "stream": True}),
            headers={"Content-Type": "application/json"})
        lines = s.conn.getresponse().read().decode().splitlines()
        assert json.loads(lines[-1])["error"] == "deadline-expired"
    kinds = [r["kind"] for r in gateway.reqlog.replay() if r.get("key") == "once"]
    assert kinds.count(reqlog.COMPLETED) == 1 and reqlog.REPLAYED in kinds


class BoomEngine:
    """An engine that dies mid-step."""

    slots = 1

    def __init__(self):
        self._joined = {}

    def busy_slots(self):
        return len(self._joined)

    def join(self, slot, request):
        self._joined[slot] = request

    def release(self, slot):
        self._joined.pop(slot, None)

    def reset(self):
        self._joined.clear()

    def step(self):
        raise RuntimeError("device lost")


def test_an_engine_crash_is_contained_requeued_and_reported(tmp_path):
    log = reqlog.RequestLog(tmp_path / "r.jsonl", echo=quiet)
    policy = gw.GatewayPolicy(max_seq_len=512, bucket_bounds=(64, 128, 256), slots_per_slice=2)
    gateway = gw.Gateway({0: BoomEngine(), 1: gw.ModeledEngine(slots=2, prefill_chunk=64)},
                         None, policy=policy, reqlog=log)
    done = [threading.Event(), threading.Event()]
    requests = [gw.Request(rid=i, prompt_len=8, max_new_tokens=2, key=f"boom-{i}",
                           notify=lambda _r, e=done[i]: e.set()) for i in range(2)]
    with Serving(gateway) as s:
        with s.lock:
            for request in requests:
                assert gateway.submit(request, time.monotonic()).ok
        for event in done:
            assert event.wait(30.0), "a waiter was stranded"
        assert all(r.done_at is not None and r.slice_index == 1 for r in requests)
        resp, body = s.get("/healthz")
        doc = json.loads(body)
        assert resp.status == 503 and "device lost" in doc["engine_crashed"]
        assert doc["serving"]["engine_failures"] == 1
        _, metrics_text = s.get("/metrics")
    assert isinstance(s.loop.crashed, RuntimeError)
    assert "serving_engine_crashed 1" in metrics_text.decode()
    causes = [r.get("cause") for r in log.replay() if r["kind"] == reqlog.REQUEUED]
    assert "engine-failure" in causes


def test_run_drill_serves_every_request_and_expires_one(lm, tmp_path):
    gateway = engine_gateway(lm, reqlog=reqlog.RequestLog(tmp_path / "r.jsonl", echo=quiet))
    report = server.run_drill(gateway, 3, vocab_size=64, max_new_tokens=4, expire_one=True)
    assert report["submitted"] == 4 and report["completed"] == 3
    assert [r["rid"] for r in report["results"]] == [0, 1, 2]
    assert all(len(r["tokens"]) == 4 for r in report["results"])
    assert [e["where"] for e in report["expiries"]] == ["queue"]
    # given prompts are sent as they are, and served as the engine alone
    prompts = [np.arange(5, dtype=np.int32), np.arange(3, 10, dtype=np.int32)]
    report = server.run_drill(engine_gateway(lm), 2, vocab_size=64, max_new_tokens=4,
                              prompts=prompts)
    assert [r["tokens"] for r in report["results"]] == [
        engine_alone(lm, p.tolist(), 4) for p in prompts]


def test_the_serve_drill_completes_on_the_cpu(tmp_path, capsys):
    report_path = tmp_path / "report.json"
    argv = ["serve", "--drill", "3", "--slots", "2", "--device", "cpu",
            "--workdir", str(tmp_path), "--serve-report", str(report_path)]
    assert cli.main(argv) == 0
    report = json.loads(report_path.read_text())
    assert report["completed"] == report["submitted"] == 3
    assert report["tokens_generated"] == 24 and len(report["results"]) == 3
    assert report["engine"]["spec"]["drafted"] > 0
    assert "serve drill done: 3/3 completed" in capsys.readouterr().out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert {"serve-requests.jsonl", "telemetry-spans.jsonl", "metrics.json",
            "demand-signal.json"} <= set(names)
    spans = [json.loads(line) for line in (tmp_path / "telemetry-spans.jsonl").open()]
    assert {"prefill-chunk", "complete"} <= {s["span"] for s in spans}
    # a second drill on the same workdir recovers the journal first: every
    # key settled, nothing re-admitted
    assert cli.main(argv[:-2]) == 0


def test_the_serve_command_listens_on_its_port(tmp_path, monkeypatch):
    """Without --drill, `serve` hands its gateway to `serve_http` on
    127.0.0.1:--port; the HTTP tests above run that server's handler."""
    got = {}

    def fake_serve_http(gateway, host, port, echo):
        got.update(host=host, port=port, workers=sorted(gateway.workers),
                   view=gateway.policy.allow_no_view)
        return 0

    monkeypatch.setattr(server, "serve_http", fake_serve_http)
    assert cli.main(["serve", "--port", "9123", "--device", "cpu", "--no-spec",
                     "--workdir", str(tmp_path)]) == 0
    assert got == {"host": "127.0.0.1", "port": 9123, "workers": [0], "view": False}


def test_tenant_weights_parse_as_the_reference(monkeypatch):
    from tritonk8ssupervisor_tpu.cli.main import _parse_tenant_weights as ref_parse

    for raw in ("", "  ", "interactive=3,batch=1", "a=0.5"):
        assert cli._parse_tenant_weights(raw) == ref_parse(raw)
    for bad in ("a", "=2", "a=x", "a=0"):
        with pytest.raises(SystemExit):
            cli._parse_tenant_weights(bad)


def test_the_serve_drill_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["serve", "--drill", "1", "--workdir", str(tmp_path)]
    assert cli.build_parser().parse_args(argv).device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert list(tmp_path.iterdir()) == []
