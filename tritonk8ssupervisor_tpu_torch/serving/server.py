"""The gateway's front door: `cli.main serve`, HTTP and drill modes. The
port's copy of `tritonk8ssupervisor_tpu/serving/server.py`; the engine
loop steps the port's `SlotEngine` from its own thread.

A deliberately thin layer: the stdlib `ThreadingHTTPServer` accepts
POST /generate requests, the gateway decides admission (429 with a
Retry-After header when shedding, 400 for unservable prompts), and a
single engine-loop thread advances every slice worker's step
boundaries — handler threads only enqueue and wait, so the serving
schedule stays the gateway's, not the socket layer's.

`{"stream": true}` turns the response into NDJSON token chunks written
as decode steps land (the engine loop's `on_token` emission feeds a
per-request queue the handler thread drains), so the client's first
byte arrives at first-token time instead of full-response time — the
TTFT the fleet bench measures (`serving_ttft_seconds`,
docs/observability.md). The final line carries the terminal verdict
(`"done": true` with the result, or the deadline-expiry trail).

`run_drill` is the no-network variant the CLI smoke and operators use:
N seeded requests through the same gateway/engine path, one JSON
report. Both modes watch the workdir's fleet-status.json through the
shared reader, so a supervisor writing degraded-hold sheds HTTP
traffic exactly like it sheds bench traffic.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tritonk8ssupervisor_tpu_torch.serving.gateway import (
    ACCEPTED,
    Gateway,
    REJECT_UNSERVABLE,
    Request,
)


class EngineLoop(threading.Thread):
    """The single stepping thread: advances every worker at its step
    boundaries; parks briefly when the whole gateway is idle. All
    gateway mutation happens under one lock shared with submit().

    An engine raising mid-step must not strand its waiters until their
    timeout: the crash is caught HERE, the worker's in-flight slots are
    marked failed-requeueable through the request journal
    (`Gateway.fail_worker` — surviving workers pick the work up), and
    the error surfaces on `self.crashed` so `/healthz` reports 503
    instead of pretending the engine is fine."""

    def __init__(self, gateway: Gateway, lock: threading.Lock,
                 clock=time.monotonic, idle_s: float = 0.002) -> None:
        super().__init__(daemon=True)
        self.gateway = gateway
        self.lock = lock
        self.clock = clock
        self.idle_s = idle_s
        self.stop_event = threading.Event()
        self.crashed: BaseException | None = None  # last engine crash
        # step-boundary wall time onto the gateway's registry: the
        # engines return dt=0.0 (real compute measures itself here),
        # and /metrics wants the distribution
        reg = gateway.telemetry.metrics
        self._h_step = reg.histogram(
            "serving_engine_step_seconds",
            "wall time of one slice worker's step boundary")
        self._g_crashed = reg.gauge(
            "serving_engine_crashed",
            "1 after an engine crashed mid-step (healthz is 503)")

    def run(self) -> None:
        # the current CUDA device is per thread and starts at card 0 here:
        # make it the engines' card, so nothing the step allocates without
        # a device lands on another card
        for worker in self.gateway.workers.values():
            device = getattr(worker.engine, "device", None)
            if getattr(device, "type", None) == "cuda" and device.index is not None:
                import torch

                torch.cuda.set_device(device)
                break
        while not self.stop_event.is_set():
            advanced = False
            with self.lock:
                for index in sorted(self.gateway.workers):
                    worker = self.gateway.workers[index]
                    if not worker.alive:
                        continue
                    try:
                        t0 = self.clock()
                        if worker.step(t0) is not None:
                            advanced = True
                            self._h_step.observe(
                                max(0.0, self.clock() - t0))
                    except Exception as e:  # noqa: BLE001 - contained
                        self.crashed = e
                        self._g_crashed.set(1)
                        try:
                            self.gateway.fail_worker(index, self.clock(),
                                                     error=repr(e))
                        except Exception:  # noqa: BLE001 - still contained
                            # even the containment failed (a wrecked
                            # engine raising from reset() too): the
                            # worker stays dead, the loop keeps the
                            # OTHER workers' requests moving, and the
                            # original crash stays on self.crashed
                            worker.fail()
            if not advanced:
                self.stop_event.wait(self.idle_s)

    def stop(self) -> None:
        self.stop_event.set()
        self.join(timeout=10)


def _result_doc(req: Request) -> dict:
    return {
        "rid": req.rid,
        "tokens": [int(t) for t in req.out_tokens],
        "generated": req.generated,
        "slice": req.slice_index,
        "latency_s": (round(req.done_at - req.arrival, 6)
                      if req.done_at is not None else None),
        "retries": req.retries,
    }


def _expiry_doc(gateway: Gateway, req: Request) -> dict:
    """The 504 body: terminal verdict plus the journal trail summary —
    where the time went, not a bare timeout string."""
    return {
        "error": "deadline-expired",
        "rid": req.rid,
        "where": req.expired_where,
        "deadline_s": req.deadline_s,
        "retries": req.retries,
        "trail": gateway.trail(req.key),
    }


def make_handler(gateway: Gateway, lock: threading.Lock,
                 timeout_s: float = 300.0, loop: EngineLoop | None = None):
    """A request handler bound to one gateway. POST /generate with
    {"tokens": [...], "max_new_tokens": N} and optionally
    {"deadline_s": S, "idempotency_key": K, "stream": true}
    (streaming: NDJSON token chunks as they decode, terminal line
    last); GET /healthz reports the
    routed view (503 while shedding or after an engine crash — load
    balancers read this); GET /metrics is the Prometheus text
    exposition of the gateway's registry (obs/metrics.py — scrape
    example in docs/observability.md)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
            pass  # the gateway's metrics are the log of record

        def _reply(self, code: int, doc: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(doc, sort_keys=True).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib name
            if self.path == "/metrics":
                with lock:
                    # pull-derived gauges refresh at scrape time — the
                    # claim/step hot paths never pay for occupancy
                    gateway.update_gauges()
                    body = gateway.telemetry.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/healthz":
                self._reply(404, {"error": "unknown path"})
                return
            with lock:
                gateway.poll(time.monotonic(), force=True)
                shedding = gateway.shed_reason()
                crashed = loop.crashed if loop is not None else None
                engine = gateway.engine_report()
                if engine is not None:
                    # the bounded aggregate (pages, KV utilization,
                    # prefix hit/miss/eviction) — per-slice detail
                    # stays in report()/the drill JSON
                    engine = {k: v for k, v in engine.items()
                              if k != "per_slice"}
                doc = {
                    "shedding": shedding,
                    "eligible_slices": gateway.eligible_slices(),
                    "queue_depth": gateway.queue_depth(),
                    "engine_crashed": (repr(crashed)
                                       if crashed is not None else None),
                    "serving": gateway.report()["serving"],
                    "engine": engine,
                }
            self._reply(503 if shedding or crashed else 200, doc)

        def do_POST(self):  # noqa: N802 - stdlib name
            if self.path != "/generate":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                doc = json.loads(self.rfile.read(length) or b"{}")
                tokens = np.asarray(doc["tokens"], np.int32)
                new = int(doc.get("max_new_tokens", 16))
                deadline = doc.get("deadline_s")
                deadline = None if deadline is None else float(deadline)
                key = doc.get("idempotency_key")
                key = None if key is None else str(key)
                tenant = doc.get("tenant")
                tenant = None if tenant is None else str(tenant)
                priority = int(doc.get("priority", 0))
                stream = bool(doc.get("stream", False))
            except (KeyError, TypeError, ValueError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            done = threading.Event()
            chunks: queue.Queue = queue.Queue()
            req = Request(rid=id(done) & 0x7FFFFFFF,
                          prompt_len=int(tokens.size),
                          max_new_tokens=new, tokens=tokens,
                          deadline_s=deadline, key=key,
                          tenant=tenant, priority=priority,
                          stream=stream,
                          # settle (complete OR expire) unparks the
                          # waiter; the sentinel closes the chunk drain
                          notify=lambda _r: (done.set(),
                                             chunks.put(None)))
            if stream:
                # called from the engine loop at each step boundary;
                # queue.put is lock-free enough to sit under its lock
                req.on_token = (
                    lambda _r, n, ids, _now: chunks.put(
                        (int(n), None if ids is None
                         else [int(t) for t in ids])))
            with lock:
                admission = gateway.submit(req, time.monotonic())
            if admission.ok and admission.result is not None:
                # a COMPLETED idempotency key answered from the journal
                self._reply(200, {**admission.result, "replayed": True})
                return
            if not admission.ok:
                if admission.reason == REJECT_UNSERVABLE:
                    self._reply(400, {"error": admission.reason})
                    return
                self._reply(
                    429, {"error": admission.reason,
                          "retry_after_s": admission.retry_after_s},
                    headers={"Retry-After":
                             f"{admission.retry_after_s:.0f}"},
                )
                return
            # the handler waits for the gateway's settle (completion OR
            # deadline expiry), with its own timeout as the last-resort
            # guard for deadline-free requests
            wait_s = timeout_s if req.deadline_s is None else min(
                timeout_s, float(req.deadline_s) + 5.0
            )
            if stream:
                self._stream_reply(req, chunks, wait_s)
                return
            if not done.wait(wait_s):
                with lock:
                    cancelled = gateway.cancel(req, time.monotonic())
                if cancelled:
                    # a clean terminal state + the journal trail, not a
                    # TimeoutError into the handler thread
                    self._reply(504, _expiry_doc(gateway, req))
                    return
            if req.done_at is not None:
                self._reply(200, _result_doc(req))
                return
            self._reply(504, _expiry_doc(gateway, req))

        def _stream_reply(self, req: Request, chunks: queue.Queue,
                          wait_s: float) -> None:
            """Drain the request's token-chunk queue onto the wire as
            NDJSON. HTTP/1.0 read-until-close framing (no
            Content-Length): the status must be sent before the first
            token exists, so the terminal verdict travels in the LAST
            line, not the status code."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            hard_stop = time.monotonic() + wait_s
            settled = False
            while True:
                remaining = hard_stop - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = chunks.get(timeout=min(1.0, remaining))
                except queue.Empty:
                    continue
                if item is None:
                    settled = True
                    break
                n_new, ids = item
                line = json.dumps({"rid": req.rid, "n": n_new,
                                   "tokens": ids}, sort_keys=True)
                try:
                    self.wfile.write(line.encode() + b"\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    # the client hung up mid-stream: stop generating
                    # for nobody — cancel records a clean terminal
                    with lock:
                        gateway.cancel(req, time.monotonic())
                    return
            if not settled and req.done_at is None:
                with lock:
                    gateway.cancel(req, time.monotonic())
            if req.done_at is not None:
                tail = {**_result_doc(req), "done": True}
            else:
                tail = {**_expiry_doc(gateway, req), "done": True}
            try:
                self.wfile.write(
                    json.dumps(tail, sort_keys=True).encode() + b"\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

    return Handler


def serve_http(gateway: Gateway, host: str, port: int,
               echo=lambda line: None) -> int:
    """Run until KeyboardInterrupt. Returns 0."""
    lock = threading.Lock()
    loop = EngineLoop(gateway, lock)
    server = ThreadingHTTPServer((host, port),
                                 make_handler(gateway, lock, loop=loop))
    loop.start()
    engine = gateway.engine_report()
    spec = (engine or {}).get("spec")
    echo(f"[serve] listening on http://{host}:{server.server_address[1]} "
         f"({len(gateway.workers)} slice worker(s), "
         f"{gateway.policy.slots_per_slice} slots each"
         + (f", speculative k={spec['spec_k']}" if spec else "")
         + "); POST /generate, GET /healthz; Ctrl-C to stop")
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        echo(f"[serve] done: {json.dumps(gateway.report(), sort_keys=True)}")
    return 0


def run_drill(gateway: Gateway, requests: int, vocab_size: int,
              seed: int = 0, max_new_tokens: int = 8,
              prompt_lens=(4, 8, 12), timeout_s: float = 300.0,
              deadline_s: float | None = None,
              expire_one: bool = False, prompts=None) -> dict:
    """N seeded requests through the real gateway+engine path, no
    network: the CLI smoke (`cli.main serve --drill N`) and the
    quickest way to see continuous batching produce tokens.

    `prompts` (int32 arrays, one request each, `requests` of them) sends
    given prompts in place of the seeded random ones: a shared-prefix
    stream, or prompts whose tokens another run is held to.
    `deadline_s` gives every drill request a deadline; `expire_one`
    appends one extra request with a zero deadline — already expired
    at arrival, so the dispatcher MUST skip-and-expire it (the
    deadline-expiry case: a clean 504-class terminal, never a
    TimeoutError into the caller)."""
    import random

    rng = random.Random(seed)
    lock = threading.Lock()
    loop = EngineLoop(gateway, lock)
    loop.start()
    pending = []
    replayed = 0
    nonce = time.monotonic_ns()  # fresh keys per drill invocation
    try:
        total = requests + (1 if expire_one else 0)
        for rid in range(total):
            if prompts is not None and rid < requests:
                tokens = np.asarray(prompts[rid], np.int32)
                plen = int(tokens.size)
            else:
                plen = rng.choice(list(prompt_lens))
                tokens = np.asarray(
                    [rng.randrange(vocab_size) for _ in range(plen)], np.int32
                )
            done = threading.Event()
            req = Request(rid=rid, prompt_len=plen,
                          max_new_tokens=max_new_tokens, tokens=tokens,
                          deadline_s=(0.0 if expire_one
                                      and rid == total - 1
                                      else deadline_s),
                          key=f"drill-{seed}-{nonce}-{rid}",
                          notify=lambda _r, ev=done: ev.set())
            with lock:
                admission = gateway.submit(req, time.monotonic())
            if admission.ok and admission.result is not None:
                replayed += 1  # answered from the journal: no waiter
            elif admission.ok:
                pending.append((req, done))
        deadline = time.monotonic() + timeout_s
        for req, done in pending:
            if not done.wait(max(0.1, deadline - time.monotonic())):
                raise TimeoutError(
                    f"drill request {req.rid} did not settle in "
                    f"{timeout_s:.0f}s"
                )
    finally:
        loop.stop()
    # publish the drill's telemetry: gauges refreshed, atomic snapshot
    # written when the gateway's Telemetry carries a snapshot path
    gateway.update_gauges()
    gateway.telemetry.write_snapshot()
    report = gateway.report()
    report["results"] = [_result_doc(r) for r, _ in pending
                         if r.done_at is not None]
    report["expiries"] = [_expiry_doc(gateway, r) for r, _ in pending
                          if r.expired_at is not None]
    report["replayed"] = replayed
    report["admission"] = ACCEPTED
    return report
