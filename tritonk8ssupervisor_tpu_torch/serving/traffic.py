"""Open-loop traffic for the serving bench: arrival models and the event
loop. The port's copy of `tritonk8ssupervisor_tpu/serving/traffic.py`,
whole; the clock is the caller's (the tests drive it on a virtual one).

"Millions of users" means the benchmark must model an ARRIVAL RATE,
not a single request: an open-loop source keeps offering work at its
own pace whether or not the system keeps up, which is what exposes
queue growth, tail latency, and shedding — a closed loop (send the next
request when the last returns) self-throttles and hides all three.

`TrafficModel` is a seeded inhomogeneous Poisson process: a diurnal
rate curve (sinusoidal around `base_rps`) times scripted burst storms,
realized by thinning against the peak rate — fully deterministic for a
given seed, so the perf gate compares like with like.

`drive_open_loop` is the deterministic discrete-event loop the bench
uses: ONE actor on a SimClock interleaving arrivals, scripted world
events (status rewrites, slice kills), and per-slice step boundaries
in time order. Ties resolve arrivals-first-then-workers-by-index, so
"a request arriving exactly at a batch step boundary" joins THAT
boundary, deterministically (pinned in tests/test_serving.py). Workers
are event-driven, not polled: an idle worker parks until an arrival,
a requeue, or a world event wakes it — virtual time never burns on an
empty fleet.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable

from tritonk8ssupervisor_tpu_torch.serving.gateway import SERVE, Gateway, Request


@dataclasses.dataclass
class TrafficModel:
    """Seeded open-loop arrival process with request-size mix."""

    base_rps: float = 2.0  # mean arrivals/sec at the diurnal midline
    diurnal_amplitude: float = 0.25  # peak/trough swing around base
    diurnal_period_s: float = 900.0
    diurnal_phase: float = 0.0  # fraction of a period t=0 starts at
    # (0.75 starts in the trough — the co-scheduling benches use it so
    # the run opens where training holds the fleet; 0.0 = legacy)
    bursts: tuple = ()  # (start_s, duration_s, rate_multiplier)
    prompt_lens: tuple = (32, 64, 128, 256)
    prompt_weights: tuple | None = None
    new_tokens_choices: tuple = (16, 32, 64, 96)
    new_tokens_weights: tuple | None = None
    seed: int = 0
    # request-plane resilience knobs: every arrival carries a deadline
    # and an idempotency key (serving/reqlog.py) when these are set
    deadline_s: float | None = None
    key_prefix: str | None = None
    # shared-system-prompt shape — the realistic millions-of-users
    # traffic the prefix cache targets: a `shared_prefix_share`
    # fraction of arrivals open with the SAME `shared_prefix_len`-token
    # system prompt (identified by prefix_id = "sys-<seed>"; distinct
    # seeds are distinct prompts) followed by a unique suffix. The
    # engines' prefix stores should re-prefill ~0 of the shared prefix
    # after the first request warms it.
    shared_prefix_len: int = 0
    shared_prefix_share: float = 0.0
    # multi-tenant shape (the gateway's WFQ lever): every arrival of
    # this model bills `tenant` at `priority`; mixed-tenant streams
    # are built by merging several models' arrival lists (open-loop:
    # each stream is a pure function of its own model, so merging
    # keeps every stream bit-identical to running it alone). None/0 =
    # the homogeneous pre-tenant stream, byte-identical.
    tenant: str | None = None
    priority: int = 0
    # multi-turn sessions (serving/fleet.py): a `session_share`
    # fraction of arrivals OPEN a conversation of `session_turns`
    # total turns. Follow-up turns arrive after seeded think-time gaps
    # (exponential around `session_think_s`) carrying the SAME
    # `session_id` — the fleet pins the whole conversation to one
    # replica — and a prompt that GROWS by the previous turn's
    # generation plus a fresh user utterance (capped at
    # `session_prompt_cap` so late turns stay servable). Every session
    # turn is tagged prefix_id="sess-<id>" with prefix_len covering its
    # whole prompt: turn k+1's prefill chain-matches the KV blocks turn
    # k registered in the PrefixStore, so the conversation re-prefills
    # only the new tail. 0.0 share = no sessions, streams byte-
    # identical to the pre-session model (the draws below are gated).
    session_share: float = 0.0
    session_turns: int = 3
    session_think_s: float = 10.0
    session_prompt_cap: int = 256

    def rate(self, t: float) -> float:
        rate = self.base_rps * (
            1.0 + self.diurnal_amplitude
            * math.sin(2.0 * math.pi * (t / self.diurnal_period_s
                                        + self.diurnal_phase))
        )
        for start, duration, mult in self.bursts:
            if start <= t < start + duration:
                rate *= mult
        return max(0.0, rate)

    def peak_rate(self) -> float:
        peak = self.base_rps * (1.0 + abs(self.diurnal_amplitude))
        worst = max((m for _, _, m in self.bursts), default=1.0)
        return peak * max(1.0, worst)


def generate_arrivals(model: TrafficModel, duration_s: float,
                      rid0: int = 0) -> list[Request]:
    """The arrival stream, pregenerated: open-loop means arrivals do
    not depend on service, so the whole stream is a pure function of
    (model, duration). Thinning: draw candidates at the peak rate,
    keep each with probability rate(t)/peak."""
    rng = random.Random(model.seed)
    peak = model.peak_rate()
    if peak <= 0:
        return []
    out: list[Request] = []
    t = 0.0
    rid = rid0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            break
        if rng.random() > model.rate(t) / peak:
            continue  # thinned: the instantaneous rate is below peak
        prompt = rng.choices(model.prompt_lens,
                             weights=model.prompt_weights)[0]
        new = rng.choices(model.new_tokens_choices,
                          weights=model.new_tokens_weights)[0]
        # the share draw only happens when the shape is ON, so legacy
        # scenarios keep their exact seeded streams; prefix-cache A/B
        # drives hold the TRAFFIC fixed (same share > 0) and flip the
        # ENGINE's prefix_cache instead — same arrivals, same tags,
        # only the cache differs
        shared = (model.shared_prefix_share > 0
                  and model.shared_prefix_len > 0
                  and rng.random() < model.shared_prefix_share)
        prefix_len = (min(int(model.shared_prefix_len), int(prompt) - 1)
                      if shared else 0)
        # session draw gated like the prefix draw above: legacy models
        # (share 0) consume not one extra random number
        session = (model.session_share > 0 and model.session_turns > 1
                   and rng.random() < model.session_share)
        if session:
            sid = f"{model.seed}-{rid}"
            turn_t = t
            turn_prompt = int(prompt)
            for turn in range(int(model.session_turns)):
                turn_new = int(rng.choices(
                    model.new_tokens_choices,
                    weights=model.new_tokens_weights)[0])
                out.append(Request(
                    rid=rid, prompt_len=turn_prompt,
                    max_new_tokens=turn_new,
                    arrival=turn_t, deadline_s=model.deadline_s,
                    key=(f"{model.key_prefix}-{rid}"
                         if model.key_prefix is not None else None),
                    # the whole conversation-so-far IS the reusable
                    # prefix: turn k+1 chain-matches the blocks turn
                    # k's prefill registered under the session id
                    prefix_len=turn_prompt,
                    prefix_id=f"sess-{sid}",
                    tenant=model.tenant,
                    priority=int(model.priority),
                    session_id=sid, turn=turn,
                ))
                rid += 1
                turn_t += rng.expovariate(
                    1.0 / max(0.001, model.session_think_s))
                # next prompt = conversation so far + a fresh utterance
                turn_prompt = min(
                    int(model.session_prompt_cap),
                    turn_prompt + turn_new + int(rng.choices(
                        model.prompt_lens,
                        weights=model.prompt_weights)[0]),
                )
            continue
        out.append(Request(
            rid=rid, prompt_len=int(prompt), max_new_tokens=int(new),
            arrival=t, deadline_s=model.deadline_s,
            key=(f"{model.key_prefix}-{rid}"
                 if model.key_prefix is not None else None),
            prefix_len=prefix_len,
            prefix_id=(f"sys-{model.seed}" if prefix_len > 0 else None),
            tenant=model.tenant, priority=int(model.priority),
        ))
        rid += 1
    # session follow-ups land out of arrival order; the loops sort,
    # but the pregenerated stream's own contract stays time-ordered
    if model.session_share > 0:
        out.sort(key=lambda r: r.arrival)
    return out


@dataclasses.dataclass
class WorldEvent:
    """A scripted world change at virtual time `at`: `fn(gateway)` —
    typically an atomic fleet-status rewrite, or a worker kill/revive
    standing in for the preemption the status will soon report."""

    at: float
    fn: Callable


def drive_open_loop(
    gateway: Gateway,
    arrivals: list[Request],
    clock,
    horizon_s: float,
    events: tuple = (),
    drain_grace_s: float = 600.0,
) -> dict:
    """Run the gateway under the pregenerated arrival stream on the
    virtual clock (any object with `time()` and `sleep(s)`; the tests
    use the reference's `testing/simclock.SimClock`). Returns the gateway
    report plus drive bookkeeping. The drive ends when every arrival
    has been offered AND the system is quiescent (queues empty, all
    workers idle), or at horizon+grace — a backlog that never drains
    is reported, not hidden, via `quiescent: False`."""
    arrivals = sorted(arrivals, key=lambda r: r.arrival)
    events = sorted(events, key=lambda e: e.at)
    i_arr = 0
    i_ev = 0
    # worker index -> next step-boundary time; None = parked idle
    next_step: dict = {i: None for i in gateway.workers}
    hard_stop = horizon_s + drain_grace_s

    def wake_idle(now: float) -> None:
        # park/unpark is pure scheduling: a worker with work in flight
        # (after a revive), or queued work it is ELIGIBLE to claim,
        # gets a boundary NOW. The eligibility check matters: waking a
        # draining/lost worker for queue depth it may not touch would
        # spin the loop at one virtual instant forever.
        for i, worker in gateway.workers.items():
            if next_step[i] is not None or not worker.alive:
                continue
            if worker.inflight or (
                gateway.queue_depth()
                and gateway.slice_mode(i) == SERVE
            ):
                next_step[i] = now

    while True:
        now = clock.time()
        candidates = []
        if i_arr < len(arrivals):
            candidates.append(arrivals[i_arr].arrival)
        if i_ev < len(events):
            candidates.append(events[i_ev].at)
        candidates.extend(t for t in next_step.values() if t is not None)
        if not candidates:
            break  # no arrivals left, no events, every worker parked
        t_next = min(candidates)
        if t_next >= hard_stop:
            break
        if t_next > now:
            clock.sleep(t_next - now)
            now = t_next
        # ---- tie order: arrivals, then world events, then workers by
        # index — an arrival AT a boundary joins that boundary
        while i_arr < len(arrivals) and arrivals[i_arr].arrival <= now:
            gateway.submit(arrivals[i_arr], now)
            i_arr += 1
            wake_idle(now)
        while i_ev < len(events) and events[i_ev].at <= now:
            events[i_ev].fn(gateway)
            i_ev += 1
            gateway.poll(now, force=True)
            wake_idle(now)
        for i in sorted(gateway.workers):
            if next_step[i] is not None and next_step[i] <= now:
                dt = gateway.workers[i].step(now)
                next_step[i] = None if dt is None else now + dt
        wake_idle(now)

    quiescent = (
        i_arr >= len(arrivals)
        and gateway.queue_depth() == 0
        and all(w.idle() for w in gateway.workers.values())
    )
    report = gateway.report()
    report.update({
        "offered": len(arrivals),
        "drive_end_s": clock.time(),
        "quiescent": quiescent,
        "final_queue_depth": gateway.queue_depth(),
    })
    return report
