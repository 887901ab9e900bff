"""Crash-safe request journal: the gateway's flight recorder. The port's
copy of `tritonk8ssupervisor_tpu/serving/reqlog.py`, whole; the same
records fold to the same views (tests/test_torch_gateway.py).

A gateway that kept every queued and in-flight request only in memory
would lose all of it in a crash, and a client retrying a request it never
heard back about could be served twice. This module gives the request
plane the same durability discipline the provisioning plane got from
`provision/journal.py` and `provision/events.py`:

- **One JSONL record per lifecycle transition**, append + flush +
  fsync (`RequestLog` subclasses `provision/events.EventLedger`, so the
  torn-final-line truncation, mid-file-corruption detection, and
  forward-compat schema skipping are the SAME code, not a copy):

      ACCEPTED    admission succeeded: the gateway now OWES a terminal
                  state for this idempotency key. On the real serve
                  path the record carries the PROMPT TOKENS — they are
                  the request's content, and recover() cannot re-serve
                  what it cannot reconstruct (a fabricated prompt would
                  be journaled as the key's real result)
      DISPATCHED  a slice worker claimed it (carries the routed view's
                  generation and age — the staleness audit trail)
      REQUEUED    pulled back to the front of the queue (slice loss,
                  engine crash, or gateway restart) — not terminal
      COMPLETED   served; the record carries the RESULT, so a duplicate
                  submission of this key is answered from the journal
      EXPIRED     deadline ran out (carries WHERE: queue / slot /
                  requeue / recover / timeout) — terminal
      SHED        refused at admission (never accepted: 400/429-class,
                  with the reason and the Retry-After hint) — audit
                  only, outside the conservation ledger

- **Keyed by client-supplied idempotency keys**: `fold()` rebuilds a
  per-key state machine (`KeyView`), which is everything a restarted
  gateway needs — incomplete keys are re-admitted front-of-queue
  (`Gateway.recover`), COMPLETED keys answer duplicates from the
  recorded result, and the per-key `trail` is the 504 body's "where the
  time went" summary.

- **`compact()`** rewrites the journal to one `state` record per key
  (atomic temp + fsync + replace, same as the event ledger):
  fold(compacted + later records) == fold(original + later records),
  pinned in tests/test_serve_chaos.py.

The request-conservation invariants the chaos campaigns assert over
this journal (every ACCEPTED key ends in exactly one terminal state,
no key COMPLETED twice, no dispatch after expiry) live in
`testing/chaos.ServeInvariantChecker`; the contract documentation is
docs/failure-modes.md, "Request lifecycle & exactly-once semantics".
"""

from __future__ import annotations

import dataclasses
import json
import os

from tritonk8ssupervisor_tpu_torch.provision.events import (
    SCHEMA_VERSION,
    EventLedger,
)

# Record kinds. ACCEPTED opens a key's conservation obligation;
# COMPLETED/EXPIRED close it; the rest are audit.
ACCEPTED = "accepted"
DISPATCHED = "dispatched"
REQUEUED = "requeued"
COMPLETED = "completed"
EXPIRED = "expired"
SHED = "shed"
REPLAYED = "replayed"  # a duplicate of a COMPLETED key answered from here
STATE = "state"  # one compacted key snapshot (compact() output)

TERMINAL = (COMPLETED, EXPIRED)

# Fields worth keeping in the bounded per-key trail (the 504 body).
_TRAIL_FIELDS = ("slice", "where", "reason", "cause", "generation",
                 "view_age_s", "depth", "retry_after_s")
_TRAIL_CAP = 24


class RequestLog(EventLedger):
    """The gateway's append-only journal. Same durability surface as
    the supervisor's event ledger (append/replay/scrub inherited);
    `compact()` folds to per-key snapshots instead of one global one."""

    def compact(self, view: "RequestLogView | None" = None) -> int:
        """Rewrite the journal down to one `state` record per key.
        Returns the number of records dropped. Terminal keys keep their
        result (duplicate submissions stay answerable); incomplete keys
        keep everything `Gateway.recover` re-admits from."""
        records = self.replay()
        if len(records) <= 1:
            return 0
        if view is None:
            view = fold(records)
        lines = []
        for kv in sorted(view.keys.values(), key=lambda k: (
                k.accepted_ts if k.accepted_ts is not None else 0.0,
                k.key)):
            record = {"v": SCHEMA_VERSION, "ts": self._clock(),
                      "kind": STATE, **state_fields(kv)}
            lines.append(json.dumps(record, sort_keys=True) + "\n")
        tmp = self.path.with_name(f".{self.path.name}.compact.tmp")
        with self._mutex:
            with tmp.open("w") as f:
                f.writelines(lines)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._drop_writer()  # the cached handle names the old inode
        dropped = len(records) - len(lines)
        self._echo(
            f"request journal compacted: {len(records)} records -> "
            f"{len(lines)} key snapshot(s)"
        )
        return dropped


# ------------------------------------------------------------- replay fold


@dataclasses.dataclass
class KeyView:
    """One idempotency key's folded lifecycle."""

    key: str
    state: str = ""  # "" / accepted / dispatched / completed / expired
    rid: int | None = None
    prompt_len: int = 0
    max_new_tokens: int = 0
    deadline_s: float | None = None
    tokens: list | None = None  # prompt token ids (real path only);
    accepted_ts: float | None = None  # latest ACCEPTED (re-accept legal
    accepts: int = 0                  # only after a terminal EXPIRED)
    dispatches: int = 0
    requeues: int = 0
    replays: int = 0
    completions: int = 0
    expiries: int = 0
    result: dict | None = None  # the COMPLETED record's result payload
    expired: dict | None = None  # {"where": ..., "ts": ...}
    trail: list = dataclasses.field(default_factory=list)

    @property
    def terminal(self) -> bool:
        return self.state in ("completed", "expired")

    @property
    def deadline_at(self) -> float | None:
        if self.deadline_s is None or self.accepted_ts is None:
            return None
        return self.accepted_ts + self.deadline_s

    def note(self, record: dict) -> None:
        entry = {"ts": record.get("ts"), "kind": record.get("kind")}
        for field in _TRAIL_FIELDS:
            if record.get(field) is not None:
                entry[field] = record[field]
        self.trail.append(entry)
        if len(self.trail) > _TRAIL_CAP:
            del self.trail[0]


@dataclasses.dataclass
class RequestLogView:
    """The whole journal folded: per-key views plus the shed audit."""

    keys: dict = dataclasses.field(default_factory=dict)  # str -> KeyView
    sheds: int = 0
    shed_reasons: dict = dataclasses.field(default_factory=dict)

    def key_view(self, key: str) -> KeyView:
        return self.keys.setdefault(str(key), KeyView(str(key)))

    def incomplete(self) -> list:
        """Accepted-but-not-terminal keys, oldest acceptance first —
        exactly what a restarted gateway owes the clients that are
        still waiting."""
        open_keys = [kv for kv in self.keys.values()
                     if kv.accepts > 0 and not kv.terminal]
        return sorted(open_keys, key=lambda kv: (
            kv.accepted_ts if kv.accepted_ts is not None else 0.0,
            kv.key))


def state_fields(kv: KeyView) -> dict:
    """Serialise one KeyView into a compacted `state` record — the
    exact inverse of `_apply_state`."""
    return {
        "key": kv.key,
        "state": kv.state,
        "rid": kv.rid,
        "prompt_len": kv.prompt_len,
        "max_new_tokens": kv.max_new_tokens,
        "deadline_s": kv.deadline_s,
        "tokens": kv.tokens,
        "accepted_ts": kv.accepted_ts,
        "accepts": kv.accepts,
        "dispatches": kv.dispatches,
        "requeues": kv.requeues,
        "replays": kv.replays,
        "completions": kv.completions,
        "expiries": kv.expiries,
        "result": kv.result,
        "expired": kv.expired,
        "trail": list(kv.trail),
    }


def _apply_state(view: RequestLogView, record: dict) -> None:
    kv = view.key_view(record.get("key", ""))
    kv.state = record.get("state", "")
    kv.rid = record.get("rid")
    kv.prompt_len = record.get("prompt_len", 0)
    kv.max_new_tokens = record.get("max_new_tokens", 0)
    kv.deadline_s = record.get("deadline_s")
    kv.tokens = record.get("tokens")
    kv.accepted_ts = record.get("accepted_ts")
    kv.accepts = record.get("accepts", 0)
    kv.dispatches = record.get("dispatches", 0)
    kv.requeues = record.get("requeues", 0)
    kv.replays = record.get("replays", 0)
    kv.completions = record.get("completions", 0)
    kv.expiries = record.get("expiries", 0)
    kv.result = record.get("result")
    kv.expired = record.get("expired")
    kv.trail = list(record.get("trail") or [])


def apply(view: RequestLogView, record: dict) -> RequestLogView:
    """Fold ONE record into the view (the gateway applies as it
    appends; `fold()` loops this over a replay)."""
    kind = record.get("kind", "")
    if kind == STATE:
        _apply_state(view, record)
        return view
    if kind == SHED:
        view.sheds += 1
        reason = record.get("reason", "")
        view.shed_reasons[reason] = view.shed_reasons.get(reason, 0) + 1
        key = record.get("key")
        if key:
            view.key_view(key).note(record)
        return view
    key = record.get("key")
    if not key:
        return view
    kv = view.key_view(key)
    kv.note(record)
    if kind == ACCEPTED:
        kv.state = "accepted"
        kv.accepts += 1
        kv.accepted_ts = record.get("ts")
        kv.rid = record.get("rid")
        kv.prompt_len = record.get("prompt_len", 0)
        kv.max_new_tokens = record.get("max_new_tokens", 0)
        kv.deadline_s = record.get("deadline_s")
        kv.tokens = record.get("tokens")
        kv.expired = None  # a re-accept supersedes the expired epoch
    elif kind == DISPATCHED:
        kv.state = "dispatched"
        kv.dispatches += 1
    elif kind == REQUEUED:
        kv.state = "accepted"  # back in the queue, still owed
        kv.requeues += 1
    elif kind == COMPLETED:
        kv.state = "completed"
        kv.completions += 1
        kv.result = record.get("result")
        kv.tokens = None  # settled: the prompt is no longer owed
    elif kind == EXPIRED:
        kv.state = "expired"
        kv.expiries += 1
        kv.expired = {"where": record.get("where"), "ts": record.get("ts")}
        kv.tokens = None
    elif kind == REPLAYED:
        kv.replays += 1
    return view


def fold(records: list[dict]) -> RequestLogView:
    view = RequestLogView()
    for record in records:
        apply(view, record)
    return view


def merge_records(*record_lists) -> list:
    """Chronologically merge N replica journals' replays into ONE
    record stream `fold()` can consume — the gateway-fleet invariant
    checker's view (serving/fleet.py: each replica journals only its
    own key-partition, so the per-key state machines never interleave
    across journals; merging just restores global time order). Stable:
    ties on `ts` keep journal order then record order, so the merged
    fold is deterministic for a given journal tuple."""
    tagged = []
    for j, records in enumerate(record_lists):
        for i, record in enumerate(records):
            ts = record.get("ts")
            tagged.append((ts if ts is not None else 0.0, j, i, record))
    tagged.sort(key=lambda t: (t[0], t[1], t[2]))
    return [t[3] for t in tagged]
