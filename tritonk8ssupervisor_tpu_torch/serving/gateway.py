"""Continuous-batching serving gateway, routed by fleet status: the port's
copy of `tritonk8ssupervisor_tpu/serving/gateway.py`, whole, in front of
the port's `SlotEngine` (serving/engine.py). The same request stream gives
the same admissions, terminal states, tokens, journal records and counters
as the reference's gateway over the reference's engine
(tests/test_torch_gateway.py).

The supervisor keeps a fleet healthy; this module is the traffic plane in
front of the decode stack that fleet protects, its "front door". The
shape is the Gemma-on-TPU serving comparison's (PAPERS.md): the metrics
that matter are tokens/sec/chip and tail latency under an *arrival
process*, not a single request, and the mechanism that wins them is
continuous batching:

- **Admission queue + sequence-length bucketing**: requests land in
  per-bucket FIFO queues (`SequenceBuckets`: the bucket quantizes the
  prompt's padded prefill shape so the compiled-step count stays
  bounded). A prompt that cannot fit the model — longer than the
  largest bucket, or prompt+new_tokens past the cache — is rejected
  CLEANLY at admission (400-class `unservable`), never crashes an
  engine.
- **Slot-based continuous batching**: each slice runs an engine with a
  fixed number of decode *slots*. New requests join the running batch
  at step boundaries (the engine pulls from the queue whenever a slot
  frees), instead of waiting for the whole batch to drain — the idle
  bubble request-at-a-time serving pays on every length-mismatched
  batch simply does not exist. Prefill is *chunked*: one bounded chunk
  rides along each decode step, so a 4k-token prompt never stalls the
  seven streams already decoding next to it.
- **Fleet-status routing**: the gateway consumes the supervisor's
  fleet-status.json through the same torn-read-tolerant reader the
  elastic trainer uses (provision/fleetview.py — absent/torn = unknown
  retry, keep the last good view). DRAINING slices stop taking new
  work but finish what they have; slices that LEFT the serving set
  (membership generation bump) have their in-flight work requeued to
  healthy peers; a slice returning resumes pulling automatically.
- **Load shedding**: a 429-style `Admission` with `retry_after_s` when
  the supervisor's breaker is open (the status `serving.shed` flag /
  degraded-hold verdict — repairs aren't sticking, so admitting more
  work converts one incident into queue collapse) or when queue depth
  exceeds the SLO budget (`queue_budget`: past it, every admitted
  request would already miss its latency target — honest refusal beats
  a doomed promise). A gateway that has a health source configured but
  has NEVER read a fleet view (cold start before the supervisor's
  first publish) sheds with the distinct `no-fleet-view` reason
  instead of guessing a route — logged once per poll interval, lifted
  the moment the first status lands.
- **Deadlines**: every request may carry `deadline_s` (or inherit
  `GatewayPolicy.default_deadline_s`). Admission refuses a deadline it
  cannot plausibly meet — estimated queue wait (depth over the
  observed completion rate) already past the budget — with an honest
  Retry-After sized to when the queue will have drained enough. The
  dispatcher skips-and-expires dead requests at claim time instead of
  burning slot capacity on work whose caller gave up; expiry anywhere
  (queue, slot, requeue, recover, server timeout) produces ONE clean
  504-class terminal state audited with where the time went
  (queued_s/served_s in the metrics and the request journal).
- **Exactly-once from the client's view**: with a `RequestLog`
  (serving/reqlog.py) attached, every lifecycle transition is
  journaled under the request's client-supplied idempotency key. A
  restarted gateway (`recover()`) re-admits incomplete work
  front-of-queue — the same semantics as the generation-bump requeue —
  and answers duplicate submissions of a COMPLETED key from the
  recorded result instead of regenerating; a duplicate racing its own
  completion is refused 429-style rather than served twice.

Dispatch is **pull-based**: engines claim work at their own step
boundaries, so a dead engine simply stops pulling — the only work a
slice loss exposes is its in-flight slots, which the membership bump
recovers. The same `Gateway`/`SliceWorker` logic runs both the real
engines (serving/engine.py, `cli.main serve`) and the modeled engines
that serving/traffic.py drives on a virtual clock.

Knobs: docs/performance.md, "Serving". Status-schema contract:
docs/failure-modes.md.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from tritonk8ssupervisor_tpu_torch import obs as obs_mod
from tritonk8ssupervisor_tpu_torch.provision.fleetview import (
    FleetView,
    HealthSource,
)
from tritonk8ssupervisor_tpu_torch.serving import kvpool
from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod

# Admission verdicts. `unservable` is 400-class (retrying cannot help);
# `replayed` is 200-class (a COMPLETED idempotency key answered from
# the journal); the rest are 429-class with a retry_after hint.
ACCEPTED = "accepted"
REPLAYED = "replayed"  # duplicate of a completed key: result attached
REJECT_UNSERVABLE = "unservable"  # prompt cannot fit the model, ever
REJECT_OVERLOAD = "overload"  # queue past the SLO budget
REJECT_BREAKER = "breaker-open"  # supervisor holding: shed requested
REJECT_NO_CAPACITY = "no-slices"  # nothing route-eligible right now
REJECT_NO_FLEET_VIEW = "no-fleet-view"  # cold start: no routed view yet
REJECT_DEADLINE = "deadline-unmeetable"  # queue wait already past it
REJECT_DUPLICATE = "duplicate-in-flight"  # key racing its own completion
REJECT_TENANT = "tenant-overload"  # ONE tenant over its WFQ queue share

# Worker modes derived from the routed view.
SERVE = "serve"  # eligible: pull new work
DRAIN = "drain"  # draining: finish in-flight, pull nothing
LOST = "lost"  # left the serving set: in-flight is requeued

_UNSET = object()  # "caller did not pass retry_after" sentinel


@dataclasses.dataclass
class Request:
    """One inference request through the gateway. The sim benches fill
    only the sizes; the real path carries prompt token ids in `tokens`
    and collects the generation in `out_tokens`."""

    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    tokens: Any = None  # np.ndarray[int] on the real path
    bucket: int = 0
    # shared-system-prompt shape (serving/traffic.py): the first
    # `prefix_len` prompt tokens are the content identified by
    # `prefix_id`, shared with every other request carrying it. The
    # REAL engine ignores these (it hashes token content); the modeled
    # engine's prefix cache keys on them because sim requests carry
    # sizes, not tokens.
    prefix_len: int = 0
    prefix_id: Any = None
    # the request-plane resilience contract (docs/failure-modes.md,
    # "Request lifecycle & exactly-once semantics")
    key: str | None = None  # client-supplied idempotency key
    deadline_s: float | None = None  # relative budget from arrival
    # multi-tenant fairness (docs/failure-modes.md "Fleet allocation &
    # preemption", WFQ semantics): which tenant's weight this request
    # bills against (None = the default tenant), and its priority
    # class — higher classes claim first; the oldest-head aging bound
    # keeps a starved class from waiting forever
    tenant: str | None = None
    priority: int = 0
    wfq_tag: float | None = None  # virtual finish time, set at admission
    # progress/attribution
    slice_index: int | None = None
    dispatched_at: float | None = None
    first_token_at: float | None = None
    done_at: float | None = None
    expired_at: float | None = None
    expired_where: str | None = None  # queue / slot / requeue / ...
    generated: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    retries: int = 0  # times requeued (slice loss / engine / restart)
    notify: Callable | None = None  # settle callback (HTTP path)
    # multi-turn sessions (serving/fleet.py): requests of one
    # conversation share `session_id` — the fleet routes them to the
    # SAME key-partition (KV affinity: turn k+1's prompt chain-matches
    # turn k's registered prefix blocks in the PrefixStore), `turn`
    # counts from 0
    session_id: str | None = None
    turn: int = 0
    # streaming token delivery: with `stream` set, `on_token(request,
    # n_new, ids_or_None, now)` fires at every step boundary that
    # emitted tokens for this request — tokens flow to the client as
    # decoded instead of arriving as one settled response, and TTFT
    # (arrival -> first emission) becomes the user-visible latency
    stream: bool = False
    on_token: Callable | None = None


@dataclasses.dataclass(frozen=True)
class Admission:
    """The gateway's answer to submit(): accepted, or a 400/429-style
    refusal. `retry_after_s` is None exactly when retrying cannot help
    (unservable). `result` is set exactly when `reason == REPLAYED` —
    a duplicate of a COMPLETED idempotency key, answered from the
    request journal instead of regenerated."""

    ok: bool
    reason: str = ACCEPTED
    retry_after_s: float | None = None
    result: dict | None = None


class SequenceBuckets:
    """Prompt-length buckets. A request is queued under the smallest
    bucket bound >= its prompt length; prompts longer than the largest
    bound are unservable. The bounds quantize the padded prefill shapes
    the engines compile for, so distinct compiled programs stay
    O(len(bounds)), not O(distinct prompt lengths)."""

    def __init__(self, bounds=(64, 128, 256, 512)) -> None:
        if not bounds:
            raise ValueError("need at least one bucket bound")
        self.bounds = tuple(sorted(int(b) for b in bounds))

    @property
    def max_prompt_len(self) -> int:
        return self.bounds[-1]

    def bucket_for(self, prompt_len: int) -> int | None:
        """The bucket bound for a prompt, or None when no bucket can
        hold it (the clean-reject path, not an engine crash)."""
        if prompt_len < 0:
            return None
        for bound in self.bounds:
            if prompt_len <= bound:
                return bound
        return None


@dataclasses.dataclass
class GatewayPolicy:
    """Gateway knobs (docs/performance.md "Serving" lists them)."""

    max_seq_len: int = 1024  # engine cache length: prompt + new tokens
    slots_per_slice: int = 8  # continuous-batching slots per engine
    prefill_chunk: int = 64  # prompt tokens advanced per step boundary
    queue_budget: int = 64  # queued requests before overload shedding
    retry_after_s: float = 5.0  # base 429 hint
    poll_every_s: float = 1.0  # fleet-status poll cadence
    bucket_bounds: tuple = (64, 128, 256, 512)
    # requests without their own deadline_s inherit this (None = no
    # deadline: requests wait forever)
    default_deadline_s: float | None = None
    # settled (completed/expired) idempotency keys kept answerable in
    # memory: past this many, the oldest-settled are evicted from the
    # key index and trail map — a duplicate arriving later regenerates,
    # so the retention window must exceed the client retry horizon
    # (0 = unbounded, the bench/sim default semantics)
    terminal_key_retention: int = 4096
    # rewrite the request journal down to per-key snapshots (dropping
    # evicted terminal keys) once it holds this many records, so a
    # long-running server's journal stays O(retained keys), not
    # O(requests ever served) (0 = never auto-compact)
    journal_compact_records: int = 20000
    # serve with NO fleet view ever read, even though a health source
    # is configured (standalone drills set this; a gateway fronting a
    # supervised fleet keeps False and sheds `no-fleet-view` instead of
    # routing blind on cold start)
    allow_no_view: bool = False
    # paged-KV sizing (docs/performance.md "Engine hot path"): tokens
    # per KV page, and the per-slice page budget. None = memory-equal
    # to the pre-paging dense cache (slots * ceil(max_seq_len /
    # page_size)) — paging then raises effective concurrency instead
    # of spending more HBM
    page_size: int = 16
    pages_per_slice: int | None = None
    # cross-request prefix/KV reuse (the shared-system-prompt lever)
    prefix_cache: bool = True
    # speculative decoding (docs/performance.md "Engine hot path"):
    # drafter proposals verified per round — 0 disables (the plain
    # one-token-per-step decode, byte-identical to pre-spec). The real
    # engine takes the draft model from the CLI (`cli.main serve
    # --draft-model`); the MODELED engine mirrors the token accounting
    # with seeded per-request acceptance draws at `spec_acceptance`,
    # so SimClock drills and the autoscale/allocator cost models see
    # speculative throughput without running a drafter
    spec_k: int = 0
    spec_acceptance: float = 0.85
    # long-running-server bound on the in-memory audit trails
    # (GatewayMetrics.depth_samples and the shed/expiry/admission audit
    # lists): past this many entries the oldest are evicted in
    # insertion order — the registry's counters stay exact forever, the
    # trails keep a bounded recent window (0 = unbounded)
    audit_retention: int = 65536
    # demand-signal publish cadence (provision/autoscale.py): with a
    # demand_path wired, the gateway atomically rewrites
    # demand-signal.json at most this often, piggybacked on poll()
    demand_signal_every_s: float = 5.0
    # ---- multi-tenant fairness (per-tenant WFQ over the bucketed
    # admission queue; docs/failure-modes.md "WFQ weight semantics").
    # None = single homogeneous stream, claim order byte-identical to
    # the pre-WFQ gateway. A dict of tenant -> weight enables
    # virtual-time claim order: each accepted request is tagged
    # finish = max(vtime, tenant_finish) + cost/weight, and claim()
    # serves the smallest tag among per-(bucket, tenant, priority)
    # queue heads — a flooding tenant's backlog cannot starve the rest.
    tenant_weights: dict | None = None
    # per-tenant SLO budget: one tenant may hold at most
    # slack * weight-share of queue_budget queued requests; past it
    # ONLY that tenant sheds (429 tenant-overload) while the others
    # keep admitting (0 disables the per-tenant cap)
    tenant_budget_slack: float = 1.5
    # starvation bound on the claim order: a queued request older than
    # this claims NEXT regardless of priority class or WFQ tag —
    # priorities reorder the queue, they must never starve it
    # (0 disables aging; the regression pin lives in test_serving.py)
    claim_age_bound_s: float = 60.0


@dataclasses.dataclass
class StepResult:
    """One engine step boundary's outcome: how long the step took
    (modeled engines return the cost model's dt; real engines measure
    themselves), tokens emitted per slot, and the slots whose requests
    finished this step (mapping to their generated ids, or None when
    the engine only tracks counts)."""

    dt: float
    emitted: dict = dataclasses.field(default_factory=dict)  # slot -> n
    finished: dict = dataclasses.field(default_factory=dict)  # slot -> ids
    # the step's NEW token ids per slot (real engines fill it; modeled
    # engines leave it empty — they track counts) — what a streaming
    # request's on_token callback delivers as the step settles
    tokens: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DecodeCostModel:
    """The modeled engine's step costs — the decode roofline in four
    numbers. A decode step re-reads the weights once regardless of how
    many slots are active (`decode_fixed_s`, the bandwidth floor that
    makes batching pay) plus a small per-slot cache read; a prefill
    chunk is compute-shaped: a fixed dispatch plus per-token work over
    the PADDED chunk (padding waste is the cost bucketing bounds)."""

    decode_fixed_s: float = 0.040
    decode_per_slot_s: float = 0.001
    prefill_fixed_s: float = 0.004
    prefill_per_token_s: float = 0.0001
    chips_per_slice: int = 4
    # speculative decoding: one drafter decode dispatch (the drafter
    # re-reads ITS weights — a fraction of the target's fixed cost
    # because the model is a fraction of the size) plus a per-slot
    # cache read; the verify dispatch is costed as one target decode
    # step (same weight read, same cache gather — the window adds
    # queries, not bandwidth, which is what makes speculation pay)
    draft_fixed_s: float = 0.008
    draft_per_slot_s: float = 0.0002


class ModeledEngine:
    """The virtual-clock twin of serving/engine.SlotEngine: identical
    join/step/release/reset surface and scheduling (one prefill chunk
    rides along each decode step), with the cost model supplying dt
    instead of real compute, and the SAME paged-KV/prefix bookkeeping
    (serving/kvpool.py) driving capacity and prefill skipping. What
    the open-loop bench drives.

    Sim requests carry sizes, not tokens, so prefix blocks key on the
    traffic model's `(prefix_id, block_index)` identity instead of a
    content hash — same chain semantics, same match-cap-at-len-1 rule.
    `num_pages=None` keeps capacity unbounded (pages are accounted but
    never bind) — the pre-paging sims' exact behavior."""

    def __init__(self, slots: int, prefill_chunk: int,
                 cost: DecodeCostModel | None = None,
                 page_size: int = 16,
                 num_pages: int | None = None,
                 prefix_cache: bool = True,
                 spec_k: int = 0,
                 spec_acceptance: float = 0.85) -> None:
        self.slots = int(slots)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.cost = cost or DecodeCostModel()
        self.page_size = max(1, int(page_size))
        self.num_pages = None if num_pages is None else int(num_pages)
        self.pages = kvpool.PagePool(self.num_pages, self.page_size)
        self.prefix = (kvpool.PrefixStore(self.pages)
                       if prefix_cache else None)
        # speculative-decoding twin: the cost model charges k drafter
        # dispatches + one verify-shaped target dispatch per round, and
        # each request draws its acceptance lengths from its OWN seeded
        # stream (rid-keyed) — deterministic per scenario, independent
        # of slot placement, so A/B drives compare like with like
        self.spec_k = max(0, int(spec_k))
        self.spec = self.spec_k >= 1
        self.spec_acceptance = min(1.0, max(0.0, float(spec_acceptance)))
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rolled_back = 0
        self._slots: dict = {}  # slot -> {prefill_left, budget, generated}
        self._prefill_rr = 0  # round-robin pointer over prefilling slots
        self.joins = 0
        self.steps = 0  # step boundaries that did work
        self.prefill_tokens = 0  # prompt tokens actually prefilled
        self.peak_slots_busy = 0

    def busy_slots(self) -> int:
        return len(self._slots)

    def _block_keys(self, request: Request) -> list:
        """Identity keys for the request's full prompt pages: blocks
        inside the shared prefix key on (prefix_id, j) — matchable
        across requests — the rest on (rid, j), unique by
        construction."""
        ps = self.page_size
        shared_len = (int(request.prefix_len or 0)
                      if request.prefix_id is not None else 0)
        return [
            ("p", request.prefix_id, j)
            if (j + 1) * ps <= shared_len else ("u", request.rid, j)
            for j in range(kvpool.full_blocks(request.prompt_len, ps))
        ]

    def _span_pages(self, prompt_len: int, max_new: int,
                    shared_blocks: int) -> int:
        start0 = shared_blocks * self.page_size
        suffix = max(1, prompt_len - start0)
        prefill_end = start0 + -(-suffix // self.prefill_chunk) \
            * self.prefill_chunk
        # the speculative page window mirrors the real engine: a verify
        # dispatch may write spec_k positions past the last accepted
        # token, and admission accounts the pages they land on
        reach = prompt_len + max_new + (self.spec_k if self.spec else 0)
        span = max(prefill_end, reach)
        return -(-span // self.page_size)

    def _alloc(self, need: int) -> list | None:
        got = self.pages.alloc(need)
        if got is None and self.prefix is not None:
            self.prefix.evict_for(need - self.pages.pages_free)
            got = self.pages.alloc(need)
        return got

    def can_join(self, request: Request) -> bool:
        shared = (self.prefix.peek(self._block_keys(request)[
            :kvpool.match_cap_blocks(request.prompt_len, self.page_size)])
            if self.prefix is not None else 0)
        need = self._span_pages(int(request.prompt_len),
                                int(request.max_new_tokens),
                                shared) - shared
        budget = self.pages.pages_free
        if need <= budget:
            return True  # free list suffices: skip the store walk
        if self.prefix is not None:
            # only under real page pressure is the store's evictable
            # count worth its O(entries) refcount walk
            budget += self.prefix.evictable_pages()
        return need <= budget

    def join(self, slot: int, request: Request) -> None:
        if slot in self._slots:
            raise ValueError(f"slot {slot} already occupied")
        keys = self._block_keys(request)
        shared_n, shared_pages = 0, []
        if self.prefix is not None:
            cap = kvpool.match_cap_blocks(request.prompt_len,
                                          self.page_size)
            shared_n, shared_pages = self.prefix.match(keys[:cap])
        total = self._span_pages(int(request.prompt_len),
                                 int(request.max_new_tokens), shared_n)
        self.pages.ref(shared_pages)
        private = self._alloc(total - shared_n)
        if private is None:
            self.pages.unref(shared_pages)
            raise RuntimeError(
                f"page pool exhausted: need {total - shared_n} pages, "
                f"{self.pages.pages_free} free (claim should have "
                f"checked can_join)"
            )
        self._slots[slot] = {
            "prefill_left": int(request.prompt_len)
            - shared_n * self.page_size,
            "prompt_len": int(request.prompt_len),
            "budget": int(request.max_new_tokens),
            "generated": 0,
            "keys": keys,
            "pages": list(shared_pages) + list(private),
            "registered": shared_n >= len(keys),
            # seeded per-request acceptance draws: the request's rid is
            # the seed, so the SAME request accepts the same lengths no
            # matter which slot or slice serves it
            "spec_rng": (random.Random(0x5BD1E995 ^ int(request.rid))
                         if self.spec else None),
        }
        self.joins += 1
        self.peak_slots_busy = max(self.peak_slots_busy, len(self._slots))

    def release(self, slot: int) -> None:
        st = self._slots.pop(slot, None)
        if st is not None:
            self.pages.unref(st["pages"])

    def reset(self) -> None:
        for slot in list(self._slots):
            self.release(slot)
        if self.prefix is not None:
            self.prefix.flush()

    def stats(self) -> dict:
        in_use = self.pages.pages_in_use
        pages_free = (self.pages.pages_free
                      if self.num_pages is not None else None)
        return {
            "page_size": self.page_size,
            "pages_total": self.num_pages,
            "pages_in_use": in_use,
            "pages_free": pages_free,
            "kv_pages_free": pages_free,
            "kv_utilization": (round(in_use / self.num_pages, 4)
                               if self.num_pages else None),
            "peak_pages_in_use": self.pages.peak_in_use,
            "peak_slots_busy": self.peak_slots_busy,
            "joins": self.joins,
            "steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "cache_int8": False,
            "prefix": (self.prefix.stats() if self.prefix is not None
                       else None),
            "spec": ({
                "spec_k": self.spec_k,
                "rounds": self.spec_rounds,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "rolled_back": self.spec_rolled_back,
                "acceptance_rate": (round(self.spec_accepted
                                          / self.spec_drafted, 4)
                                    if self.spec_drafted else None),
            } if self.spec else None),
        }

    def step(self) -> StepResult | None:
        if not self._slots:
            return None
        emitted: dict = {}
        finished: dict = {}
        dt = 0.0
        decoding = sorted(s for s, st in self._slots.items()
                          if st["prefill_left"] == 0)
        prefilling = sorted(s for s, st in self._slots.items()
                            if st["prefill_left"] > 0)
        if prefilling:
            # exactly ONE chunk per boundary, round-robin across
            # prefilling slots: a long prompt advances chunk by chunk
            # while its decoding peers keep streaming
            slot = prefilling[self._prefill_rr % len(prefilling)]
            self._prefill_rr += 1
            st = self._slots[slot]
            self.prefill_tokens += min(self.prefill_chunk,
                                       st["prefill_left"])
            st["prefill_left"] = max(0, st["prefill_left"]
                                     - self.prefill_chunk)
            # the compiled chunk is the PADDED shape: full chunk cost
            dt += (self.cost.prefill_fixed_s
                   + self.prefill_chunk * self.cost.prefill_per_token_s)
            if st["prefill_left"] == 0:
                if not st["registered"] and self.prefix is not None:
                    self.prefix.register(
                        st["keys"], st["pages"][:len(st["keys"])]
                    )
                    st["registered"] = True
                # the prefill's final logits ARE the first token
                st["generated"] = 1
                emitted[slot] = 1
                if st["generated"] >= st["budget"]:
                    finished[slot] = None
        if decoding and self.spec:
            # one speculative round: k drafter dispatches over the
            # batch + one verify-shaped target dispatch; every decoding
            # slot emits its accepted run + one target token (clamped
            # to budget), drawn from the request's seeded stream —
            # exactly the real engine's accounting, minus the drafter
            dt += (self.cost.decode_fixed_s
                   + len(decoding) * self.cost.decode_per_slot_s
                   + self.spec_k * (self.cost.draft_fixed_s
                                    + len(decoding)
                                    * self.cost.draft_per_slot_s))
            self.spec_rounds += 1
            for slot in decoding:
                st = self._slots[slot]
                accepted = 0
                while (accepted < self.spec_k
                       and st["spec_rng"].random()
                       < self.spec_acceptance):
                    accepted += 1
                self.spec_drafted += self.spec_k
                self.spec_accepted += accepted
                self.spec_rolled_back += self.spec_k - accepted
                take = min(accepted + 1,
                           st["budget"] - st["generated"])
                st["generated"] += take
                emitted[slot] = emitted.get(slot, 0) + take
                if st["generated"] >= st["budget"]:
                    # the speculative page-window overhang frees the
                    # moment the budget fills (kvpool.release_span:
                    # decrements exactly the truncated tail)
                    need = -(-(st["prompt_len"] + st["budget"])
                             // self.page_size)
                    if len(st["pages"]) > need:
                        self.pages.release_span(st["pages"], need)
                    finished[slot] = None
        elif decoding:
            dt += (self.cost.decode_fixed_s
                   + len(decoding) * self.cost.decode_per_slot_s)
            for slot in decoding:
                st = self._slots[slot]
                st["generated"] += 1
                emitted[slot] = emitted.get(slot, 0) + 1
                if st["generated"] >= st["budget"]:
                    finished[slot] = None
        self.steps += 1
        return StepResult(dt=dt, emitted=emitted, finished=finished)


class GatewayMetrics:
    """What the benches and `status` read back: completions, refusals
    (with the queue depth that justified each — the "sheds only while
    the budget demands it" audit trail), depth samples, and reroutes.

    The audit trails are BOUNDED (`retention`, insertion-ordered deque
    eviction): on a long-running server every admission and every shed
    used to append forever, so memory grew with requests-ever-served.
    The exact lifetime counts live in the metrics registry (the single
    source of truth report() reads); these lists are the recent-window
    evidence — depth that justified a shed, where an expiry's time
    went. The 10k-request flatness pin lives in tests/test_serving.py.
    `retention=0` keeps the unbounded pre-cap semantics (virtual-clock
    benches that scan the whole run's audit trail)."""

    def __init__(self, retention: int = 0) -> None:
        maxlen = int(retention) if retention and int(retention) > 0 \
            else None
        self.completed: list[Request] = []
        self.rejected: deque = deque(maxlen=maxlen)
        self.accepted: deque = deque(maxlen=maxlen)  # (ts, rid)
        self.depth_samples: deque = deque(maxlen=maxlen)  # (ts, depth)
        self.expired: deque = deque(maxlen=maxlen)  # terminal audits
        self.engine_failures: deque = deque(maxlen=maxlen)
        self.requeued = 0
        self.submitted = 0
        self.replayed = 0  # duplicates answered from the journal

    def latencies(self) -> list[float]:
        return sorted(r.done_at - r.arrival for r in self.completed
                      if r.done_at is not None)

    def percentile(self, q: float) -> float | None:
        lat = self.latencies()
        if not lat:
            return None
        idx = min(len(lat) - 1, max(0, int(round(q * (len(lat) - 1)))))
        return lat[idx]

    def tokens_generated(self) -> int:
        return sum(r.generated for r in self.completed)


class SliceWorker:
    """One slice's serving loop body: at each step boundary it claims
    new work for free slots (IF the routed view says this slice may
    take it), advances the engine one boundary, and settles emissions
    at the boundary's end. Pull-based: the gateway never pushes into a
    worker, so a dead worker exposes only its in-flight slots."""

    def __init__(self, index: int, engine, gateway: "Gateway") -> None:
        self.index = index
        self.engine = engine
        self.gateway = gateway
        self.inflight: dict = {}  # slot -> Request
        self.alive = True

    def idle(self) -> bool:
        return not self.inflight

    def fail(self) -> None:
        """The slice died under us (bench fault injection / a real
        engine raising): stop stepping. In-flight requests stay frozen
        until the membership bump reaps them — exactly the exposure a
        real preemption has."""
        self.alive = False

    def revive(self) -> None:
        self.alive = True

    def reap(self) -> list[Request]:
        """Pull every in-flight request out (the slice left the serving
        set); the engine is reset so a healed slice starts clean. A
        reset that raises too (a genuinely wrecked engine) must not
        void the reap — the requests are already rescued; the worker
        just stays dead until revived."""
        lost = [self.inflight[s] for s in sorted(self.inflight)]
        self.inflight.clear()
        try:
            self.engine.reset()
        except Exception as e:  # noqa: BLE001 - containment of containment
            self.alive = False
            self.gateway._echo(
                f"[gateway] slice {self.index} engine reset failed "
                f"({e!r}): worker stays dead"
            )
        return lost

    def step(self, now: float) -> float | None:
        """One step boundary at `now`. Returns the step's duration, or
        None when there was nothing to do (idle — the drive loop parks the
        worker until new work arrives)."""
        if not self.alive:
            return None
        self.gateway.poll(now)
        mode = self.gateway.slice_mode(self.index)
        if mode == SERVE:
            # admission to a slot is accounted in PAGES, not slots: a
            # paged engine with free slots but no free pages must not
            # claim work it cannot cache (the queue's head waits —
            # head-of-line beats starving it behind smaller requests)
            fits = getattr(self.engine, "can_join", None)
            for slot in range(self.engine.slots):
                if slot in self.inflight:
                    continue
                claimed = self.gateway.claim(self.index, now, fits=fits)
                if claimed is None:
                    break
                claimed.slice_index = self.index
                self.engine.join(slot, claimed)
                self.inflight[slot] = claimed
        if not self.inflight:
            return None
        result = self.engine.step()
        if result is None:
            return None
        end = now + result.dt
        for slot, n in result.emitted.items():
            req = self.inflight.get(slot)
            if req is None:
                continue
            req.generated += n
            if req.first_token_at is None and n > 0:
                req.first_token_at = end
                self.gateway.note_first_token(req, end)
            if n > 0 and req.on_token is not None:
                # streaming delivery: tokens leave at the boundary they
                # were decoded, not when the request settles (ids are
                # None on modeled engines — they track counts)
                req.on_token(req, n, result.tokens.get(slot), end)
        for slot, ids in result.finished.items():
            req = self.inflight.pop(slot, None)
            if req is None:
                continue
            deadline = self.gateway.deadline_at(req)
            if deadline is not None and end > deadline:
                # finished, but past the budget: the caller is gone —
                # deadline honesty says 504, never a late 200
                self.engine.release(slot)
                self.gateway.expire(req, "slot", end)
                continue
            req.done_at = end
            if ids is not None:
                req.out_tokens = list(ids)
            self.engine.release(slot)
            self.gateway.complete(req)
        # deadline sweep AFTER completions settle: a request finishing
        # exactly AT its deadline is served (completion wins the tie);
        # one still UNFINISHED at a boundary on/past its deadline has
        # its slot reclaimed for work that can still make it
        for slot in sorted(self.inflight):
            req = self.inflight[slot]
            deadline = self.gateway.deadline_at(req)
            if deadline is not None and end >= deadline:
                self.inflight.pop(slot)
                self.engine.release(slot)
                self.gateway.expire(req, "slot", end)
        return result.dt


@dataclasses.dataclass
class WfqClock:
    """The WFQ virtual clock: system virtual time plus each tenant's
    last assigned finish tag. A standalone gateway owns its own; the
    gateway FLEET (serving/fleet.py) hands ONE instance to every
    replica, so tenant weights bind globally — a tenant's request
    admitted on replica g0 advances the same virtual time a g3
    admission tags against, and a flooding tenant cannot escape its
    weight by spraying replicas."""

    vtime: float = 0.0
    finish: dict = dataclasses.field(default_factory=dict)  # tenant -> tag


class Gateway:
    """Admission + bucketed queue + fleet-status routing over a set of
    per-slice workers. See the module docstring for the contract."""

    def __init__(
        self,
        engines: dict,
        health: HealthSource | None,
        policy: GatewayPolicy | None = None,
        clock: Callable[[], float] = time.monotonic,
        echo: Callable[[str], None] = lambda line: None,
        reqlog: reqlog_mod.RequestLog | None = None,
        telemetry: "obs_mod.Telemetry | None" = None,
        demand_path=None,
        replica: str | None = None,
        lease_guard: Callable | None = None,
        wfq: WfqClock | None = None,
    ) -> None:
        self.policy = policy or GatewayPolicy()
        self.buckets = SequenceBuckets(self.policy.bucket_bounds)
        self._health = health
        self._clock = clock
        self._echo = echo
        self.reqlog = reqlog
        # gateway-fleet identity (serving/fleet.py): `replica` stamps a
        # `replica` label on every counter/gauge/histogram write (None
        # = the single-gateway unlabeled series, byte-identical) and
        # rides on DISPATCHED journal records; `lease_guard(slice, now)
        # -> epoch | None` is the slice-lease epoch fence consulted at
        # every claim — None means this replica does NOT hold a live
        # lease on the slice and the pull is refused.
        self.replica = None if replica is None else str(replica)
        self._lease_guard = lease_guard
        self._labels = ({"replica": self.replica}
                        if self.replica is not None else {})
        # The telemetry plane (obs/): the registry is ALWAYS real —
        # report()/healthz counts read from it as the single source of
        # truth — while spans flow only when a SpanLog is wired
        # (`cli.main serve`, the chaos campaigns). Handles are resolved
        # once here; the hot paths (claim, step) pay one counter inc.
        self.telemetry = telemetry or obs_mod.Telemetry.off(clock=clock)
        reg = self.telemetry.metrics
        self._tracer = self.telemetry.tracer
        self._c_submitted = reg.counter(
            "serving_requests_submitted_total",
            "requests offered to admission (accepted or not)")
        self._c_accepted = reg.counter(
            "serving_requests_accepted_total",
            "admissions that opened a conservation obligation "
            "(must equal the journal's ACCEPTED records)")
        self._c_rejected = reg.counter(
            "serving_requests_rejected_total",
            "admission refusals by reason (400/429-class)")
        self._c_completed = reg.counter(
            "serving_requests_completed_total",
            "requests served to completion")
        self._c_expired = reg.counter(
            "serving_requests_expired_total",
            "504-class terminal expiries by where the time went")
        self._c_requeued = reg.counter(
            "serving_requests_requeued_total",
            "in-flight work re-admitted front-of-queue by cause")
        self._c_replayed = reg.counter(
            "serving_requests_replayed_total",
            "duplicate submissions answered from the request journal")
        self._c_dispatched = reg.counter(
            "serving_requests_dispatched_total",
            "queue claims handed to slice workers")
        self._c_tokens = reg.counter(
            "serving_tokens_generated_total",
            "tokens emitted by completed requests")
        self._c_engine_failures = reg.counter(
            "serving_engine_failures_total",
            "engines that crashed mid-step (EngineLoop containment)")
        self._c_lease_fenced = reg.counter(
            "serving_lease_fenced_total",
            "dispatch pulls refused by the slice-lease epoch fence "
            "(a stale holder tried to claim from a slot pool it no "
            "longer owns)")
        self._h_latency = reg.histogram(
            "serving_request_latency_seconds",
            "arrival-to-completion latency (seconds, log buckets)")
        self._h_queue_wait = reg.histogram(
            "serving_queue_wait_seconds",
            "arrival-to-dispatch queue wait of completed requests")
        self._h_ttft = reg.histogram(
            "serving_ttft_seconds",
            "arrival to first emitted token (TTFT) — the user-visible "
            "latency under streaming delivery")
        self._g_depth = reg.gauge(
            "serving_queue_depth", "queued requests across all buckets")
        self._g_slots_busy = reg.gauge(
            "serving_slots_busy", "in-flight slots across all workers")
        self._g_slots_total = reg.gauge(
            "serving_slots_total", "decode slots across all workers")
        self._g_slots_peak = reg.gauge(
            "serving_slots_busy_peak",
            "sum of per-engine peak busy slots (must stay <= total)")
        self._g_pages_in_use = reg.gauge(
            "serving_kv_pages_in_use", "KV pages referenced right now")
        self._g_pages_total = reg.gauge(
            "serving_kv_pages_total", "KV page pool capacity (bounded pools)")
        self._g_pages_peak = reg.gauge(
            "serving_kv_pages_in_use_peak",
            "sum of per-engine peak pages in use")
        self._g_pages_free = reg.gauge(
            "serving_kv_pages_free",
            "KV page-pool headroom across bounded pools (the demand "
            "signal distinct from slot headroom)")
        # speculative decoding (engines report cumulative counts; the
        # gauges mirror them at scrape/snapshot time like occupancy)
        self._g_spec_drafted = reg.gauge(
            "serving_spec_drafted_tokens",
            "drafter proposals offered to target verify")
        self._g_spec_accepted = reg.gauge(
            "serving_spec_accepted_tokens",
            "drafter proposals that survived exact rejection sampling")
        self._g_spec_rolled_back = reg.gauge(
            "serving_spec_rolled_back_tokens",
            "drafter proposals truncated by a reject (paged-KV "
            "rollback)")
        self._g_spec_acceptance = reg.gauge(
            "serving_spec_acceptance_rate",
            "accepted / drafted over the engines' lifetime")
        self.workers = {
            int(i): SliceWorker(int(i), engine, self)
            for i, engine in engines.items()
        }
        self.queues: dict = {b: deque() for b in self.buckets.bounds}
        self.metrics = GatewayMetrics(
            retention=self.policy.audit_retention
        )
        self.view: FleetView | None = None
        self._last_poll: float | None = None
        self._last_membership: tuple | None = None
        # demand-signal publishing (provision/autoscale.py): with a
        # path wired, poll() piggybacks an atomic demand-signal.json
        # rewrite at the policy cadence — queue depth, observed
        # completion rate, recent p99/sheds, per-slice in-flight — the
        # supervisor's autoscaler input. None = not publishing (the
        # pre-autoscale behavior, and every standalone drill's).
        self._demand_path = (Path(demand_path)
                             if demand_path is not None else None)
        self._last_demand_pub: float | None = None
        self._sheds_at_last_pub = 0
        self._recent_latencies: deque = deque(maxlen=128)
        # idempotency-key index: key -> ("inflight", None) |
        # ("completed", result) | ("expired", None). Seeded by recover()
        # from the journal, kept live by submit/complete/expire.
        self._key_state: dict = {}
        self._trails: dict = {}  # key -> bounded lifecycle trail
        # settled keys in settlement order (insertion-ordered dict used
        # as an LRU): the eviction queue terminal_key_retention bounds
        self._terminal_order: dict = {}
        self._journal_appends = 0  # records since the last compact
        # recent completion timestamps: the observed service rate the
        # deadline-feasibility check models queue wait with
        self._completion_times: deque = deque(maxlen=64)
        self._noview_logged_at: float | None = None
        # ---- per-tenant WFQ state (policy.tenant_weights) ----
        # `_vtime` is the system virtual time (advanced to the claimed
        # request's tag at dispatch); `_wfq_finish` is each tenant's
        # last assigned finish tag — both live on a WfqClock that a
        # fleet SHARES across replicas (fleet-wide weights) and a
        # standalone gateway owns alone. `_priority_seen` keeps the
        # legacy head-only claim scan until a prioritized request
        # actually arrives — homogeneous streams pay nothing.
        self._wfq_enabled = bool(self.policy.tenant_weights)
        self._wfq = wfq if wfq is not None else WfqClock()
        self._priority_seen = False

    # The WFQ virtual clock's two faces, kept as attribute-shaped
    # properties so every admission/claim site (and the tests pinning
    # them) read/write the SHARED clock transparently.
    @property
    def _vtime(self) -> float:
        return self._wfq.vtime

    @_vtime.setter
    def _vtime(self, value: float) -> None:
        self._wfq.vtime = value

    @property
    def _wfq_finish(self) -> dict:
        return self._wfq.finish

    # -------------------------------------------------------------- routing

    def poll(self, now: float, force: bool = False) -> FleetView | None:
        """Refresh the routed view at the policy cadence. An unknown
        read (absent/torn) KEEPS the last good view — the reader
        contract says retry, and the previous document is the best
        evidence held; a gateway that flipped to 'everything healthy'
        on a torn read would route into the hole the supervisor just
        told it about."""
        if (not force and self._last_poll is not None
                and now - self._last_poll < self.policy.poll_every_s):
            return self.view
        self._last_poll = now
        self.publish_demand(now)
        if self._health is None:
            return None
        got = self._health.poll()
        if got is not None:
            self.view = got
            self._reconcile_membership(now)
        return self.view

    def recent_p99(self) -> float | None:
        """p99 latency over the RECENT completion window (the demand
        signal's SLO evidence) — the lifetime percentile the report
        carries would never recover after one bad hour."""
        window = sorted(self._recent_latencies)
        if not window:
            return None
        idx = min(len(window) - 1,
                  max(0, int(round(0.99 * (len(window) - 1)))))
        return window[idx]

    def _total(self, counter) -> int:
        """One counter's lifetime count FOR THIS GATEWAY: the exact
        replica-labeled series in a fleet (the registry is shared, so
        .total() would fold every replica together), the whole counter
        standalone — byte-identical to the pre-fleet reports."""
        if self._labels:
            return int(counter.value(**self._labels))
        return int(counter.total())

    def _pressure_sheds(self) -> int:
        """Lifetime count of load-pressure refusals (overload, breaker,
        no capacity, deadline-unmeetable) from the registry — 400-class
        unservables and duplicate refusals are not demand evidence."""
        per_reason = self._c_rejected.per_label("reason", **self._labels)
        return int(sum(
            count for reason, count in per_reason.items()
            if reason in (REJECT_OVERLOAD, REJECT_BREAKER,
                          REJECT_NO_CAPACITY, REJECT_DEADLINE)
        ))

    def publish_demand(self, now: float, force: bool = False) -> bool:
        """Atomically rewrite demand-signal.json (provision/autoscale
        schema-of-record, docs/failure-modes.md "Elastic capacity"):
        what the supervisor's autoscaler folds into a desired slice
        count, and what its drain-then-teardown path watches to learn a
        DRAINING slice's in-flight work has settled. Torn-read
        tolerance is the READER's discipline; this side only promises
        old-or-new, never a blend (temp + os.replace)."""
        if self._demand_path is None:
            return False
        if (not force and self._last_demand_pub is not None
                and now - self._last_demand_pub
                < self.policy.demand_signal_every_s):
            return False
        self._last_demand_pub = now
        sheds_total = self._pressure_sheds()
        recent_sheds = max(0, sheds_total - self._sheds_at_last_pub)
        self._sheds_at_last_pub = sheds_total
        wait = self.estimated_queue_wait()
        headroom = None
        if self.policy.default_deadline_s is not None and wait is not None:
            headroom = round(float(self.policy.default_deadline_s)
                             - wait, 3)
        engine = self.engine_report()
        doc = {
            "v": 1,
            "updated": now,
            "queue_depth": self.queue_depth(),
            "service_rate": self.service_rate(),
            "p99_s": self.recent_p99(),
            "recent_sheds": recent_sheds,
            "deadline_headroom_s": headroom,
            # page-pool headroom as demand evidence: a fleet can have
            # free SLOTS and no free PAGES (long prompts, fat budgets)
            # — slot-only signals would under-report that pressure
            "kv_pages_free": (engine.get("kv_pages_free")
                              if engine is not None else None),
            "inflight": {
                str(i): len(w.inflight)
                for i, w in sorted(self.workers.items())
            },
            "active_workers": sorted(
                i for i, w in self.workers.items() if w.alive
            ),
        }
        from tritonk8ssupervisor_tpu_torch.provision.state import (
            atomic_write_text,
        )

        atomic_write_text(self._demand_path,
                          json.dumps(doc, sort_keys=True) + "\n")
        return True

    def eligible_slices(self) -> list[int]:
        """Route-eligible slices among the workers this gateway runs.
        No view ever seen = no supervisor advice: serve on everything
        (a standalone `cli.main serve --drill` has no fleet)."""
        view = self.view
        if view is None:
            return sorted(self.workers)
        if view.serving is not None:
            eligible = set(view.serving)
        else:
            # pre-serving-block documents: derive from degraded/draining
            avoid = set(view.degraded) | set(view.draining)
            eligible = {i for i in self.workers if i not in avoid}
        return sorted(i for i in self.workers if i in eligible)

    def slice_mode(self, index: int) -> str:
        view = self.view
        if view is None:
            return SERVE
        if index in self.eligible_slices():
            return SERVE
        if index in view.draining:
            return DRAIN
        return LOST

    def shed_reason(self) -> str | None:
        """Why admission must refuse right now, or None. Cold start
        first (a health source is configured but NO view has ever been
        read — routing blind would defeat the supervisor's advice),
        then the breaker (the supervisor's explicit hold), then the SLO
        queue budget."""
        view = self.view
        if (view is None and self._health is not None
                and not self.policy.allow_no_view):
            return REJECT_NO_FLEET_VIEW
        if view is not None and (view.shed
                                 or view.verdict == "degraded-hold"):
            return REJECT_BREAKER
        if self.queue_depth() >= self.policy.queue_budget:
            return REJECT_OVERLOAD
        return None

    def _reconcile_membership(self, now: float) -> None:
        """React to a changed view: requeue the in-flight work of every
        worker that LEFT the serving set (generation bump — replaced
        hosts mean those streams are gone), front-of-queue so the
        retried requests don't pay the whole queue again."""
        view = self.view
        signature = (view.generation, tuple(self.eligible_slices()),
                     tuple(view.draining))
        if signature == self._last_membership:
            return
        self._last_membership = signature
        for index, worker in sorted(self.workers.items()):
            if self.slice_mode(index) == LOST and worker.inflight:
                lost = worker.reap()
                requeued = self._requeue_lost(lost, now, "slice-loss")
                self._echo(
                    f"[gateway] slice {index} left the serving set "
                    f"(generation {view.generation}): requeued "
                    f"{requeued} in-flight request(s)"
                )

    def _requeue_lost(self, lost: list, now: float, cause: str) -> int:
        """Push reaped in-flight requests back to the FRONT of their
        buckets (they already paid the queue once), expiring the ones
        whose deadline lapsed while they were stranded — a dead request
        must not take a slot from one that can still make it."""
        requeued = 0
        for req in reversed(lost):
            deadline = self.deadline_at(req)
            if deadline is not None and now >= deadline:
                self.expire(req, "requeue", now)
                continue
            req.retries += 1
            req.slice_index = None
            req.dispatched_at = None
            self.queues[req.bucket].appendleft(req)
            self._journal(reqlog_mod.REQUEUED, key=req.key, rid=req.rid,
                          cause=cause, retries=req.retries)
            self._c_requeued.inc(cause=cause, **self._labels)
            self._tracer.event("requeue", now, key=req.key, rid=req.rid,
                               cause=cause, retries=req.retries)
            requeued += 1
        self.metrics.requeued += requeued
        return requeued

    def fail_worker(self, index: int, now: float | None = None,
                    error: str = "") -> int:
        """An engine crashed mid-step (EngineLoop caught it): stop the
        worker, mark its in-flight slots failed-requeueable through the
        journal, and hand the work to the surviving workers. Returns
        the number requeued."""
        now = self._clock() if now is None else now
        worker = self.workers[int(index)]
        worker.fail()
        lost = worker.reap()
        requeued = self._requeue_lost(lost, now, "engine-failure")
        self.metrics.engine_failures.append(
            {"ts": now, "slice": int(index), "error": str(error)[:200]}
        )
        self._c_engine_failures.inc(**self._labels)
        self._tracer.event("engine-failure", now, slice=int(index))
        self._echo(
            f"[gateway] slice {index} engine failed ({error}): "
            f"requeued {requeued} in-flight request(s)"
        )
        return requeued

    def attach_worker(self, index: int, engine) -> None:
        """Start serving a slice this gateway did not construct with —
        the fleet grants a slice LEASE and hands the replica the
        slice's engine. Idempotent for the same index (a renew changes
        nothing); a dead prior worker on the index is replaced."""
        index = int(index)
        worker = self.workers.get(index)
        if worker is not None and worker.engine is engine:
            worker.revive()
            return
        self.workers[index] = SliceWorker(index, engine, self)

    def detach_worker(self, index: int, now: float | None = None,
                      cause: str = "lease-revoked") -> int:
        """Stop serving a slice (lease expired or revoked while this
        replica is still alive): reap its in-flight work back to the
        front of the queue and drop the worker — the next lease holder
        gets a clean engine. Returns the number requeued."""
        now = self._clock() if now is None else now
        worker = self.workers.pop(int(index), None)
        if worker is None:
            return 0
        lost = worker.reap()
        requeued = self._requeue_lost(lost, now, cause)
        if requeued:
            self._echo(
                f"[gateway] slice {index} lease lost ({cause}): "
                f"requeued {requeued} in-flight request(s)"
            )
        return requeued

    # ------------------------------------------------------------ admission

    def queue_depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def deadline_at(self, request: Request) -> float | None:
        """The absolute expiry instant, or None for deadline-free
        requests. Anchored at arrival: requeues and restarts never
        reset a client's budget."""
        if request.deadline_s is None:
            return None
        return request.arrival + float(request.deadline_s)

    def service_rate(self) -> float | None:
        """Observed request completions/sec over the recent window, or
        None before there is enough evidence to model with."""
        times = self._completion_times
        if len(times) < 8:
            return None
        span = times[-1] - times[0]
        if span <= 0:
            return None
        return (len(times) - 1) / span

    def estimated_queue_wait(self) -> float | None:
        """Modeled wait for a request admitted NOW: everything queued
        ahead of it draining at the observed completion rate."""
        rate = self.service_rate()
        if rate is None:
            return None
        return self.queue_depth() / rate

    def submit(self, request: Request, now: float | None = None) -> Admission:
        now = self._clock() if now is None else now
        self.poll(now)
        self.metrics.submitted += 1
        self._c_submitted.inc(**self._labels)
        request.arrival = now
        if request.deadline_s is None:
            request.deadline_s = self.policy.default_deadline_s
        if request.key is not None:
            known = self._key_state.get(request.key)
            if known is not None:
                phase, result = known
                if phase == "completed":
                    # exactly-once from the client's view: the recorded
                    # result answers the duplicate, nothing regenerates
                    self.metrics.replayed += 1
                    self._c_replayed.inc(**self._labels)
                    self._tracer.event("replay", now, key=request.key,
                                       rid=request.rid)
                    self._journal(reqlog_mod.REPLAYED, key=request.key,
                                  rid=request.rid)
                    return Admission(True, REPLAYED, None, result=result)
                if phase == "inflight":
                    # a duplicate racing its own completion: refusing
                    # beats serving the same key twice
                    return self._refuse(request, REJECT_DUPLICATE, now)
                # phase == "expired": the 504 was delivered; a retry
                # with the same key opens a fresh acceptance epoch
        bound = self.buckets.bucket_for(request.prompt_len)
        if (bound is None or request.prompt_len < 1
                or request.max_new_tokens < 1
                or request.prompt_len + request.max_new_tokens
                > self.policy.max_seq_len):
            # 400-class: no amount of retrying makes this prompt fit
            return self._refuse(request, REJECT_UNSERVABLE, now,
                                retry_after=None)
        reason = self.shed_reason()
        if reason is None and not self.eligible_slices():
            reason = REJECT_NO_CAPACITY
        if reason is None and self._wfq_enabled:
            # per-tenant SLO budget: ONE tenant past its weight share
            # of the queue sheds alone — a flood from one stream must
            # not consume the whole queue_budget and starve the rest
            cap = self._tenant_budget(request.tenant)
            if cap is not None and self._tenant_depth(
                    request.tenant) >= cap:
                reason = REJECT_TENANT
        if reason is not None:
            return self._refuse(request, reason, now)
        if request.deadline_s is not None:
            wait = self.estimated_queue_wait()
            if wait is not None and wait > float(request.deadline_s):
                # the queue ahead already outlasts the budget: an
                # honest refusal now, with a Retry-After sized to when
                # the backlog will have drained enough to make it
                return self._refuse(
                    request, REJECT_DEADLINE, now,
                    retry_after=max(1.0,
                                    wait - float(request.deadline_s)),
                )
        request.bucket = bound
        if request.priority:
            self._priority_seen = True
        if self._wfq_enabled:
            # start-time fair queueing: the tag is assigned ONCE at
            # admission — start at max(system vtime, the tenant's last
            # finish), advance by normalized cost. Within a tenant,
            # tags are monotone (FIFO holds); across tenants, a light
            # tenant's fresh request tags BELOW a flooding tenant's
            # backlog and claims first.
            tenant = request.tenant or "default"
            weight = float(
                (self.policy.tenant_weights or {}).get(tenant, 1.0)
            ) or 1.0
            start = max(self._vtime, self._wfq_finish.get(tenant, 0.0))
            cost = (max(1, request.prompt_len)
                    + max(1, request.max_new_tokens)) / weight
            request.wfq_tag = start + cost
            self._wfq_finish[tenant] = request.wfq_tag
        self.queues[bound].append(request)
        if request.key is not None:
            self._key_state[request.key] = ("inflight", None)
            self._terminal_order.pop(request.key, None)  # live again
        # the ACCEPTED record carries the prompt tokens on the real
        # path: they ARE the request's content, and recover() must
        # never re-serve a key it would have to fabricate a prompt for
        self._journal(reqlog_mod.ACCEPTED, key=request.key,
                      rid=request.rid, prompt_len=request.prompt_len,
                      max_new_tokens=request.max_new_tokens,
                      deadline_s=request.deadline_s,
                      **({"tenant": request.tenant}
                         if request.tenant is not None else {}),
                      **({"priority": request.priority}
                         if request.priority else {}),
                      **({"tokens": [int(t) for t in request.tokens]}
                         if request.tokens is not None else {}))
        self.metrics.accepted.append((now, request.rid))
        self._c_accepted.inc(**self._labels)
        self.metrics.depth_samples.append((now, self.queue_depth()))
        self._tracer.event("admission", now, key=request.key,
                           rid=request.rid, prompt_len=request.prompt_len,
                           max_new_tokens=request.max_new_tokens,
                           deadline_s=request.deadline_s)
        return Admission(True)

    def _refuse(self, request: Request, reason: str, now: float,
                retry_after=_UNSET) -> Admission:
        if retry_after is _UNSET:
            retry_after = self._retry_after(reason)
        depth = self.queue_depth()
        self.metrics.rejected.append({
            "ts": now, "reason": reason, "depth": depth,
            "rid": request.rid,
        })
        self._c_rejected.inc(reason=reason, **self._labels)
        self._tracer.event("shed", now, key=request.key,
                           rid=request.rid, reason=reason, depth=depth)
        self._journal(reqlog_mod.SHED, key=request.key, rid=request.rid,
                      reason=reason, depth=depth,
                      retry_after_s=retry_after)
        if reason == REJECT_NO_FLEET_VIEW:
            if (self._noview_logged_at is None
                    or now - self._noview_logged_at
                    >= self.policy.poll_every_s):
                self._noview_logged_at = now
                self._echo(
                    "[gateway] no fleet view yet (fleet-status.json "
                    "never read): shedding no-fleet-view 429s until the "
                    "supervisor publishes one"
                )
        return Admission(False, reason, retry_after)

    def _retry_after(self, reason: str) -> float:
        base = self.policy.retry_after_s
        if reason == REJECT_OVERLOAD:
            # a full queue drains at roughly the serving rate; hint
            # proportionally so retries spread instead of thundering
            return base + 0.1 * self.queue_depth()
        return base

    # ------------------------------------------------------------- dispatch

    def _tenant_budget(self, tenant: str | None) -> int | None:
        """One tenant's queued-request cap: slack * its weight share of
        the queue budget (at least 1), or None when the per-tenant cap
        is disabled. Unknown tenants weigh 1.0 like the default."""
        weights = self.policy.tenant_weights or {}
        slack = float(self.policy.tenant_budget_slack)
        if not weights or slack <= 0:
            return None
        w = float(weights.get(tenant or "default", 1.0)) or 1.0
        total = sum(float(x) or 1.0 for x in weights.values())
        if (tenant or "default") not in weights:
            total += w
        share = w / max(w, total)
        return max(1, int(share * self.policy.queue_budget * slack))

    def _tenant_depth(self, tenant: str | None) -> int:
        return sum(
            1 for q in self.queues.values() for r in q
            if (r.tenant or "default") == (tenant or "default")
        )

    def _pick_queued(self, now: float) -> tuple | None:
        """The next request to claim: (queue, index, request). The
        candidates are, per bucket, the FIRST queued request of each
        (tenant, priority) class — FIFO holds within a class, while
        across classes the order is priority first, then the WFQ
        virtual-finish tag (arrival when WFQ is off). The STARVATION
        BOUND overrides both: a candidate older than
        `claim_age_bound_s` claims next no matter its class or tag —
        priorities and weights reorder the queue, they may never
        starve it (the aging regression pin lives in
        tests/test_serving.py). Homogeneous streams (no tenants, no
        priorities ever submitted) keep the original head-only
        oldest-first scan, byte-identical."""
        scan_classes = self._wfq_enabled or self._priority_seen
        best = None  # (key, q, i, req)
        oldest = None  # (arrival, q, i, req)
        for q in self.queues.values():
            if not q:
                continue
            seen: set = set()
            for i, req in enumerate(q):
                cls = (req.tenant, req.priority)
                if cls in seen:
                    continue
                seen.add(cls)
                if oldest is None or req.arrival < oldest[0]:
                    oldest = (req.arrival, q, i, req)
                tag = (req.wfq_tag if req.wfq_tag is not None
                       else req.arrival)
                key = (-int(req.priority), tag, req.arrival)
                if best is None or key < best[0]:
                    best = (key, q, i, req)
                if not scan_classes:
                    break  # heads only: the legacy oldest-first scan
        if best is None:
            return None
        bound = float(self.policy.claim_age_bound_s)
        if (scan_classes and bound > 0 and oldest is not None
                and now - oldest[0] > bound
                and oldest[3] is not best[3]):
            return oldest[1], oldest[2], oldest[3]
        return best[1], best[2], best[3]

    def claim(self, slice_index: int, now: float,
              fits: Callable | None = None) -> Request | None:
        """One request for a free slot on `slice_index` — oldest-first
        across buckets for a homogeneous stream (bucketing batches
        compiled shapes, it must not starve a sparse bucket), and
        priority-then-WFQ order when tenants/priority classes are in
        play (`_pick_queued`) — or None when every bucket is empty or
        the slice may not take new work. Requests whose deadline has
        already passed are skipped-and-expired here instead of burning
        slot capacity on callers that gave up. `fits` is the engine's
        page-capacity probe (can_join): when the chosen request cannot
        be cached right now, claim returns None and the request keeps
        its place — head-of-line blocking is the honest policy
        (skipping ahead would starve big prompts behind an endless
        stream of small ones)."""
        if self.slice_mode(slice_index) != SERVE:
            return None
        # slice-lease epoch fence (serving/fleet.py): a replica may pull
        # from a slice's slot pool only while it HOLDS a live lease on
        # it. A stale holder — lease expired or revoked between its last
        # renew and this claim — gets None, not work: the fence is what
        # makes "two replicas never pull from the same pool" a checked
        # invariant instead of a scheduling accident.
        lease_epoch = None
        if self._lease_guard is not None:
            lease_epoch = self._lease_guard(int(slice_index), now)
            if lease_epoch is None:
                self._c_lease_fenced.inc(**self._labels)
                return None
        while True:
            picked = self._pick_queued(now)
            if picked is None:
                return None
            best, index, req = picked
            deadline = self.deadline_at(req)
            if deadline is not None and now >= deadline:
                del best[index]
                self.expire(req, "queue", now)
                continue
            if fits is not None and not fits(req):
                return None
            del best[index]
            if req.wfq_tag is not None:
                # the system virtual time advances to the claimed tag:
                # an idle tenant's NEXT request starts from here, not
                # from zero (no banked credit for sitting out)
                self._vtime = max(self._vtime, req.wfq_tag)
            req.dispatched_at = now
            view = self.view
            self._journal(
                reqlog_mod.DISPATCHED, key=req.key, rid=req.rid,
                slice=int(slice_index),
                queued_s=round(now - req.arrival, 6),
                generation=(view.generation if view is not None
                            else None),
                view_age_s=(round(max(0.0, now - view.updated), 3)
                            if view is not None
                            and view.updated is not None else None),
                **({"replica": self.replica}
                   if self.replica is not None else {}),
                **({"lease_epoch": lease_epoch}
                   if lease_epoch is not None else {}),
            )
            # hot path: ONE counter inc — span detail for the dispatch
            # lives in the journal record above, and the queue-wait
            # histogram is observed at terminal settle, so the claim
            # path stays inside the <5% overhead gate
            self._c_dispatched.inc(**self._labels)
            self.metrics.depth_samples.append((now, self.queue_depth()))
            return req

    def expire(self, request: Request, where: str, now: float) -> None:
        """One request's 504-class terminal state, with the audit of
        where the time went — the ONLY way a request dies. `where` is
        queue (skipped at claim), slot (reclaimed at a boundary),
        requeue (deadline lapsed while stranded), recover (lapsed
        across a gateway restart), recover-unroutable (the restarted
        gateway's bucket config can no longer hold the prompt),
        recover-unrecoverable (the journal holds no prompt tokens and
        the engines need real ones — re-serving would fabricate the
        prompt), or timeout (the HTTP handler gave up on a
        deadline-free request)."""
        request.expired_at = now
        request.expired_where = where
        served = (round(now - request.dispatched_at, 6)
                  if request.dispatched_at is not None else 0.0)
        audit = {
            "ts": now, "rid": request.rid, "key": request.key,
            "where": where, "deadline_s": request.deadline_s,
            "age_s": round(now - request.arrival, 6),
            "queued_s": round((request.dispatched_at
                               if request.dispatched_at is not None
                               else now) - request.arrival, 6),
            "served_s": served, "retries": request.retries,
        }
        self.metrics.expired.append(audit)
        self._c_expired.inc(where=where, **self._labels)
        if request.dispatched_at is not None:
            self._h_queue_wait.observe(audit["queued_s"], **self._labels)
        self._tracer.event("expiry", now, key=request.key,
                           rid=request.rid, where=where,
                           queued_s=audit["queued_s"], served_s=served,
                           retries=request.retries)
        if request.key is not None:
            self._settle_key(request.key, "expired", None)
        self._journal(reqlog_mod.EXPIRED, key=request.key,
                      rid=request.rid, where=where,
                      deadline_s=request.deadline_s,
                      age_s=audit["age_s"], queued_s=audit["queued_s"],
                      served_s=audit["served_s"])
        if request.notify is not None:
            request.notify(request)

    def expire_queued(self, now: float | None = None) -> int:
        """Eagerly sweep queued requests whose deadline has passed —
        what claim() does lazily, for idle fleets where no claim will
        come (e.g. every worker dead while the supervisor heals)."""
        now = self._clock() if now is None else now
        swept = 0
        for bound, q in self.queues.items():
            keep: deque = deque()
            while q:
                req = q.popleft()
                deadline = self.deadline_at(req)
                if deadline is not None and now >= deadline:
                    self.expire(req, "queue", now)
                    swept += 1
                else:
                    keep.append(req)
            self.queues[bound] = keep
        return swept

    def cancel(self, request: Request, now: float | None = None,
               where: str = "timeout") -> bool:
        """The HTTP handler stopped waiting: pull the request out of
        wherever it is (queue or slot) and settle it terminal-expired.
        False when it already settled (completion raced the cancel and
        won — the result stands)."""
        now = self._clock() if now is None else now
        if request.done_at is not None or request.expired_at is not None:
            return False
        dequeued = False
        for q in self.queues.values():
            for i, queued in enumerate(q):  # identity, not __eq__:
                if queued is request:       # tokens may be an ndarray
                    del q[i]
                    dequeued = True
                    break
            if dequeued:
                break
        if not dequeued:
            for worker in self.workers.values():
                slots = [s for s, r in worker.inflight.items()
                         if r is request]
                for slot in slots:
                    worker.inflight.pop(slot)
                    worker.engine.release(slot)
        self.expire(request, where, now)
        return True

    def note_first_token(self, request: Request, now: float) -> None:
        """The request's first decoded token just left the engine:
        observe TTFT (arrival -> first emission), the user-visible
        latency under streaming delivery. Called once per request by
        the worker that emitted it."""
        self._h_ttft.observe(max(0.0, now - request.arrival),
                             **self._labels)

    def complete(self, request: Request) -> None:
        self.metrics.completed.append(request)
        done = (request.done_at if request.done_at is not None
                else self._clock())
        self._completion_times.append(done)
        self._c_completed.inc(**self._labels)
        self._c_tokens.inc(max(0, request.generated), **self._labels)
        latency = max(0.0, done - request.arrival)
        self._h_latency.observe(latency, **self._labels)
        self._recent_latencies.append(latency)
        # the request's span set, emitted at terminal settle as ONE
        # batched write (never on the claim/step hot paths): queue
        # wait, prefill occupancy (dispatch -> first token), decode
        # occupancy (first token -> done), and the terminal event the
        # analyzers key on
        if self._tracer.enabled:
            spans = []
            if request.dispatched_at is not None:
                spans.append(("queue-wait", request.arrival,
                              request.dispatched_at, request.key,
                              {"rid": request.rid}))
                first = request.first_token_at
                if first is not None and first >= request.dispatched_at:
                    spans.append(("prefill", request.dispatched_at,
                                  first, request.key,
                                  {"rid": request.rid,
                                   "slice": request.slice_index}))
                    spans.append(("decode", first, done, request.key,
                                  {"rid": request.rid,
                                   "slice": request.slice_index,
                                   "generated": request.generated}))
            spans.append(("complete", done, done, request.key,
                          {"rid": request.rid,
                           "slice": request.slice_index,
                           "latency_s": round(latency, 6),
                           "generated": request.generated,
                           "retries": request.retries}))
            self._tracer.emit_many(spans)
        if request.dispatched_at is not None:
            self._h_queue_wait.observe(
                max(0.0, request.dispatched_at - request.arrival),
                **self._labels)
        if request.key is not None:
            result = {
                "rid": request.rid,
                "tokens": [int(t) for t in request.out_tokens],
                "generated": request.generated,
                "slice": request.slice_index,
                "latency_s": (round(request.done_at - request.arrival, 6)
                              if request.done_at is not None else None),
                "retries": request.retries,
            }
            self._settle_key(request.key, "completed", result)
            self._journal(reqlog_mod.COMPLETED, key=request.key,
                          rid=request.rid, slice=request.slice_index,
                          result=result, latency_s=result["latency_s"])
        if request.notify is not None:
            request.notify(request)

    # ------------------------------------------------------------- journal

    def _journal(self, kind: str, **fields) -> None:
        if self.reqlog is None:
            return
        record = self.reqlog.append(kind, **fields)
        self._journal_appends += 1
        key = fields.get("key")
        if key:
            entry = {"ts": record["ts"], "kind": kind}
            for name in ("slice", "where", "reason", "cause",
                         "generation", "view_age_s", "depth",
                         "retry_after_s"):
                if fields.get(name) is not None:
                    entry[name] = fields[name]
            trail = self._trails.setdefault(key, [])
            trail.append(entry)
            if len(trail) > 24:
                del trail[0]
        cap = self.policy.journal_compact_records
        if cap and self._journal_appends >= int(cap):
            self._compact_reqlog()

    def _settle_key(self, key: str, state: str, result) -> None:
        """Index a key's terminal state and enforce the retention cap:
        past `terminal_key_retention` settled keys, the oldest-settled
        fall out of the index and trail map (a later duplicate of an
        evicted key regenerates — retention IS the replay window)."""
        self._key_state[key] = (state, result)
        self._terminal_order.pop(key, None)  # re-settle refreshes age
        self._terminal_order[key] = True
        cap = self.policy.terminal_key_retention
        if cap and int(cap) > 0:
            while len(self._terminal_order) > int(cap):
                oldest = next(iter(self._terminal_order))
                del self._terminal_order[oldest]
                self._key_state.pop(oldest, None)
                self._trails.pop(oldest, None)

    def _compact_reqlog(self) -> int:
        """Rewrite the journal to per-key snapshots, dropping terminal
        keys the retention cap already evicted from memory — the
        serving path's bound on journal growth (the sim campaigns never
        reach the cap, so their raw record streams stay intact for the
        invariant checkers)."""
        if self.reqlog is None:
            return 0
        view = reqlog_mod.fold(self.reqlog.replay())
        evicted = [key for key, kv in view.keys.items()
                   if kv.terminal and key not in self._key_state]
        for key in evicted:
            del view.keys[key]
        dropped = self.reqlog.compact(view)
        self._journal_appends = 0
        return dropped

    def trail(self, key: str | None) -> list:
        """The journaled lifecycle of one idempotency key (bounded) —
        the 504 body's 'where the time went' summary."""
        if key is None:
            return []
        return list(self._trails.get(key, []))

    def recover(self, now: float | None = None) -> dict:
        """Fold the request journal after a gateway restart: COMPLETED
        keys become answerable duplicates, incomplete keys (accepted or
        dispatched when the process died) are re-admitted at the FRONT
        of the queue — same semantics as the generation-bump requeue —
        and keys whose deadline lapsed during the outage settle
        terminal-expired instead of being served to nobody. A key the
        restarted gateway cannot re-serve faithfully (prompt tokens
        missing from the journal on a real engine, or a prompt no
        current bucket holds) also settles terminal — never served
        from a fabricated prompt, never silently dropped."""
        if self.reqlog is None:
            return {"redone": 0, "completed_cached": 0,
                    "expired_on_recover": 0, "unrecoverable": 0}
        now = self._clock() if now is None else now
        records = self.reqlog.replay()
        view = reqlog_mod.fold(records)
        cached = self._seed_settled(view)
        # an inherited journal past the compaction cap is folded down
        # NOW, before the restart's own appends grow it further
        self._journal_appends = len(records)
        # journal timestamps live on the journal's clock; translate a
        # key's age onto ours so deadlines keep their anchor even when
        # the gateway clock is monotonic and the journal's is wall
        journal_now = self.reqlog._clock()
        redone, expired, unrecoverable = self._readmit(
            view, now, journal_now, "gateway-restart")
        self.metrics.requeued += redone
        if redone or expired or cached or unrecoverable:
            self._echo(
                f"[gateway] journal recovered: {redone} request(s) "
                f"re-admitted front-of-queue, {expired} expired during "
                f"the outage, {unrecoverable} settled unrecoverable, "
                f"{cached} completed key(s) answerable"
            )
        return {"redone": redone, "completed_cached": cached,
                "expired_on_recover": expired,
                "unrecoverable": unrecoverable}

    def _seed_settled(self, view: "reqlog_mod.RequestLogView") -> int:
        """Index a folded journal view's terminal keys (COMPLETED keys
        become answerable duplicates, EXPIRED keys refuse re-service
        until re-accepted). Returns the completed count."""
        cached = 0
        for kv in view.keys.values():
            if kv.state == "completed":
                self._trails[kv.key] = list(kv.trail)
                self._settle_key(kv.key, "completed", kv.result)
                cached += 1
            elif kv.state == "expired":
                self._settle_key(kv.key, "expired", None)
        return cached

    def _readmit(self, view: "reqlog_mod.RequestLogView", now: float,
                 journal_now: float, cause: str) -> tuple:
        """Re-admit a folded view's incomplete keys at the FRONT of the
        queue (they already paid it once), settling the ones that
        cannot be served faithfully. Shared by recover() (this
        replica's own journal after a restart) and adopt() (a dead
        peer's journal after a partition reassignment). Returns
        (redone, expired, unrecoverable)."""
        redone = expired = unrecoverable = 0
        # the engines decide what a re-admitted request must carry: a
        # real decode engine (SlotEngine) needs the prompt token ids; a
        # modeled one serves from the sizes alone
        needs_tokens = any(getattr(w.engine, "requires_tokens", False)
                           for w in self.workers.values())
        for kv in reversed(view.incomplete()):  # appendleft: oldest in front
            age = max(0.0, journal_now - (kv.accepted_ts
                                          if kv.accepted_ts is not None
                                          else journal_now))
            req = Request(
                rid=kv.rid if kv.rid is not None else 0,
                prompt_len=kv.prompt_len,
                max_new_tokens=kv.max_new_tokens,
                arrival=now - age, key=kv.key,
                tokens=(list(kv.tokens)
                        if kv.tokens is not None else None),
                deadline_s=kv.deadline_s,
                retries=kv.requeues + 1,
            )
            self._trails[kv.key] = list(kv.trail)
            self._key_state[kv.key] = ("inflight", None)
            deadline = self.deadline_at(req)
            if deadline is not None and now >= deadline:
                self.expire(req, "recover", now)
                expired += 1
                continue
            bound = self.buckets.bucket_for(kv.prompt_len)
            if bound is None:
                # journal from an older bucket config: the key cannot
                # be routed any more. Still OWED a terminal state —
                # settle it so conservation holds and a retry with the
                # same key opens a fresh epoch under the new config.
                self.expire(req, "recover-unroutable", now)
                unrecoverable += 1
                continue
            if needs_tokens and req.tokens is None:
                # the ACCEPTED record holds no prompt tokens (an older
                # journal schema): re-serving would substitute a
                # fabricated prompt and journal its output as this
                # key's real result. Settle terminal instead — the
                # retrying client regenerates with its real prompt.
                self.expire(req, "recover-unrecoverable", now)
                unrecoverable += 1
                continue
            req.bucket = bound
            self.queues[bound].appendleft(req)
            self._journal(reqlog_mod.REQUEUED, key=kv.key, rid=kv.rid,
                          cause=cause, retries=req.retries)
            self._c_requeued.inc(cause=cause, **self._labels)
            self._tracer.event("requeue", now, key=kv.key, rid=kv.rid,
                               cause=cause, retries=req.retries)
            redone += 1
        return redone, expired, unrecoverable

    def adopt(self, records: list, now: float | None = None,
              cause: str = "partition-adopt") -> dict:
        """Take over a DEAD replica's key-partition (serving/fleet.py
        reassignment): fold ITS journal records, make its COMPLETED
        keys answerable duplicates here, and re-admit its incomplete
        keys front-of-THIS-replica's queue. The REQUEUED/terminal
        records land in this replica's journal, so the fleet checker's
        merged N-journal fold still sees every adopted ACCEPTED key
        reach exactly one terminal state — the "kill one replica, lose
        zero requests" guarantee."""
        now = self._clock() if now is None else now
        view = reqlog_mod.fold(list(records))
        cached = self._seed_settled(view)
        journal_now = (self.reqlog._clock()
                       if self.reqlog is not None else now)
        redone, expired, unrecoverable = self._readmit(
            view, now, journal_now, cause)
        self.metrics.requeued += redone
        if redone or expired or cached or unrecoverable:
            self._echo(
                f"[gateway] partition adopted ({cause}): {redone} "
                f"request(s) re-admitted, {expired} expired in the "
                f"hand-off, {unrecoverable} settled unrecoverable, "
                f"{cached} completed key(s) answerable"
            )
        return {"redone": redone, "completed_cached": cached,
                "expired_on_recover": expired,
                "unrecoverable": unrecoverable}

    # -------------------------------------------------------------- reports

    def engine_report(self) -> dict | None:
        """Aggregate the workers' paged-KV/prefix stats — why
        throughput moved, for `report()` and `/healthz`: pages in use
        vs total, KV-memory utilization, prefix hit/miss/eviction
        counters and the prefill tokens the cache skipped."""
        per_slice = {
            index: worker.engine.stats()
            for index, worker in sorted(self.workers.items())
            if hasattr(worker.engine, "stats")
        }
        if not per_slice:
            return None
        stats = list(per_slice.values())
        bounded = [s["pages_total"] for s in stats
                   if s["pages_total"] is not None]
        pages_total = sum(bounded) if len(bounded) == len(stats) else None
        pages_in_use = sum(s["pages_in_use"] for s in stats)
        # page-pool headroom (bounded pools only): the demand-signal /
        # autoscaler evidence that is DISTINCT from slot headroom
        kv_pages_free = (pages_total - pages_in_use
                         if pages_total is not None else None)
        prefix_stats = [s["prefix"] for s in stats
                        if s["prefix"] is not None]
        prefix = None
        if prefix_stats:
            prefix = {
                key: sum(p[key] for p in prefix_stats)
                for key in ("entries", "hits", "misses", "block_hits",
                            "hit_tokens", "evictions")
            }
            asked = prefix["hits"] + prefix["misses"]
            prefix["hit_rate"] = (round(prefix["hits"] / asked, 4)
                                  if asked else None)
        spec_stats = [s.get("spec") for s in stats
                      if s.get("spec") is not None]
        spec = None
        if spec_stats:
            spec = {
                key: sum(p[key] for p in spec_stats)
                for key in ("rounds", "drafted", "accepted",
                            "rolled_back")
            }
            spec["spec_k"] = max(p["spec_k"] for p in spec_stats)
            spec["acceptance_rate"] = (
                round(spec["accepted"] / spec["drafted"], 4)
                if spec["drafted"] else None
            )
        return {
            "pages_in_use": pages_in_use,
            "pages_total": pages_total,
            "kv_pages_free": kv_pages_free,
            "kv_utilization": (round(pages_in_use / pages_total, 4)
                               if pages_total else None),
            "peak_pages_in_use": sum(s["peak_pages_in_use"]
                                     for s in stats),
            "peak_slots_busy": max(s["peak_slots_busy"] for s in stats),
            "prefill_tokens": sum(s["prefill_tokens"] for s in stats),
            "prefix": prefix,
            "spec": spec,
            "per_slice": per_slice,
        }

    def update_gauges(self) -> None:
        """Refresh the pull-derived gauges (queue depth, slot and page
        occupancy) from the live structures. Called at scrape time
        (GET /metrics), at snapshot writes, and by the chaos checker —
        never on the claim/step hot paths, which is why occupancy is a
        gauge and not per-step bookkeeping."""
        labels = self._labels
        self._g_depth.set(self.queue_depth(), **labels)
        slots_total = busy = peak = 0
        for worker in self.workers.values():
            slots_total += int(getattr(worker.engine, "slots", 0))
            busy += len(worker.inflight)
            peak += int(getattr(worker.engine, "peak_slots_busy", 0))
        self._g_slots_total.set(slots_total, **labels)
        self._g_slots_busy.set(busy, **labels)
        self._g_slots_peak.set(peak, **labels)
        engine = self.engine_report()
        if engine is not None:
            self._g_pages_in_use.set(engine["pages_in_use"], **labels)
            self._g_pages_peak.set(engine["peak_pages_in_use"], **labels)
            if engine["pages_total"] is not None:
                self._g_pages_total.set(engine["pages_total"], **labels)
            if engine["kv_pages_free"] is not None:
                self._g_pages_free.set(engine["kv_pages_free"], **labels)
            spec = engine.get("spec")
            if spec is not None:
                self._g_spec_drafted.set(spec["drafted"], **labels)
                self._g_spec_accepted.set(spec["accepted"], **labels)
                self._g_spec_rolled_back.set(spec["rolled_back"],
                                             **labels)
                if spec["acceptance_rate"] is not None:
                    self._g_spec_acceptance.set(spec["acceptance_rate"],
                                                **labels)

    def report(self) -> dict:
        """The machine-readable serving summary (the drill/bench
        document's core). Counts come FROM the metrics registry — the
        single source of truth the /metrics exposition scrapes — while
        the exact-sample latency percentiles and audit lists stay on
        GatewayMetrics (a log-bucketed histogram would round the p99
        the benches pin). Keys and value semantics are the pre-registry
        schema byte-for-byte (pinned in tests/test_serving.py)."""
        m = self.metrics
        rejects = {reason: int(count) for reason, count
                   in sorted(self._c_rejected.per_label(
                       "reason", **self._labels).items())}
        expired_where = {where: int(count) for where, count
                         in sorted(self._c_expired.per_label(
                             "where", **self._labels).items())}
        return {
            "submitted": self._total(self._c_submitted),
            "completed": self._total(self._c_completed),
            "rejected": rejects,
            "requeued_after_slice_loss": self._total(self._c_requeued),
            "tokens_generated": self._total(self._c_tokens),
            "p50_latency_s": m.percentile(0.50),
            "p99_latency_s": m.percentile(0.99),
            "max_queue_depth": max(
                (d for _, d in m.depth_samples), default=0
            ),
            "expired": self._total(self._c_expired),
            "expired_where": expired_where,
            "replayed_from_journal": self._total(self._c_replayed),
            # the routing-advice audit (the no_fleet_view cold-start
            # counter lives here and in rejected["no-fleet-view"])
            "serving": {
                "view": "ok" if self.view is not None else "none",
                "no_fleet_view_sheds": rejects.get(
                    REJECT_NO_FLEET_VIEW, 0),
                "engine_failures": self._total(self._c_engine_failures),
            },
            # the paged-KV/prefix observability block (why did
            # throughput move): docs/performance.md "Engine hot path"
            "engine": self.engine_report(),
        }
