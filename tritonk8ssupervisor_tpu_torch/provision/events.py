"""Durable event ledger and machine-readable fleet status: the port's copy
of `tritonk8ssupervisor_tpu/provision/events.py`, whole. The request journal
(`serving/reqlog.py`) and the span log (`obs/trace.py`) inherit
`EventLedger`; the gateway fleet (`serving/fleet.py`) records its slice
leases on it and restores them from `fold()`; `cli.main status` renders
`fleet_status()`. The same records fold to the same views, snapshots and
status documents as in the reference (tests/test_torch_events.py).

The discipline, as in the reference:

- append + flush + fsync, so every record survives a SIGKILL landing on
  the next instruction;
- a torn FINAL line (the one write a kill interrupted) is detected and
  physically truncated on replay, never fatal; mid-file corruption with
  valid records after it raises;
- records from a newer schema version are skipped, not misread;
- `compact()` rewrites the ledger to one snapshot of the fold (temp file,
  fsync, `os.replace`), and fold(compacted + later) == fold(original +
  later).

The record vocabulary is the reference's whole, so the port folds a
ledger the reference's supervisor wrote; the port itself writes only the
lease records so far (the supervisor that writes the rest is not ported:
ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from pathlib import Path

from tritonk8ssupervisor_tpu_torch.provision import heal as heal_mod
from tritonk8ssupervisor_tpu_torch.provision.state import atomic_write_text

SCHEMA_VERSION = 1

# Event kinds. One vocabulary shared by the writer (supervisor), the
# replay fold, and the docs (docs/failure-modes.md "running unattended").
SUPERVISOR_START = "supervisor-start"
SUPERVISOR_STOP = "supervisor-stop"
TICK = "tick"  # one reconcile observation: CHANGED per-slice states
SNAPSHOT = "snapshot"  # a compacted ledger prefix: the folded view, whole
VERDICT = "verdict"  # a slice's state CHANGED (healthy -> missing, ...)
MAINTENANCE = "maintenance"  # a slice began draining for maintenance
HEAL_START = "heal-start"
HEAL_DONE = "heal-done"
HEAL_FAILED = "heal-failed"
RATE_LIMITED = "rate-limited"  # heal wanted, token bucket said no
BREAKER_OPEN = "breaker-open"
BREAKER_HALF_OPEN = "breaker-half-open"
BREAKER_CLOSE = "breaker-close"
DEGRADED_HOLD = "degraded-hold"  # breaker open: observing, not healing
# The job-facing contract (parallel/elastic.py): the training job
# acknowledges membership changes through job-ack.json and the
# supervisor folds those acknowledgements into the ledger, so MTTR for
# a *training job* (notice -> training resumed at the new world size)
# is attributable from the same flight record as the fleet's own MTTR.
JOB_NOTIFIED = "job-notified"  # trainer saw the membership change
JOB_RESUMED = "job-resumed"  # trainer is stepping again (new world)
DEGRADED_ACK = "degraded-ack"  # trainer continues WITHOUT these slices
HEAL_SUPPRESSED = "heal-suppressed"  # heal skipped: the job owns the loss
# Failure-domain vocabulary (blast-radius isolation): the correlated-
# failure classifier's verdict and the per-domain breaker's transitions.
# A DOMAIN_OUTAGE means K-of-domain slices went unhealthy inside one
# window — one correlated incident, not K independent faults — and the
# domain's breaker holds heals into that domain until a single CANARY
# heal (a HEAL_START carrying canary=true) proves the domain takes
# repairs again. Ledgers written before these kinds existed fold
# unchanged: the fields default empty (tests/test_events.py pins it).
DOMAIN_OUTAGE = "domain-outage"  # K-of-domain unhealthy in a window
DOMAIN_BREAKER_OPEN = "domain-breaker-open"
DOMAIN_BREAKER_HALF_OPEN = "domain-breaker-half-open"  # canary gate
DOMAIN_BREAKER_CLOSE = "domain-breaker-close"  # canary landed: gate lifts
DOMAIN_RECOVERED = "domain-recovered"  # every slice healthy: episode over
HEAL_DEFERRED = "heal-deferred"  # quota-parked listing page: postponed
# Autoscale vocabulary (provision/autoscale.py): the demand-driven
# second controller's flight record. A SCALE_START without a matching
# SCALE_DONE/SCALE_ABORT is the mid-scale crash signature — a restarted
# supervisor RESUMES that scale (re-runs the idempotent warm provision,
# or continues the drain with its original deadline) instead of
# starting a new one, so a kill can never double-provision a slice or
# orphan a half-drained one.
SCALE_DECISION = "scale-decision"  # confirmed desired-count change
SCALE_START = "scale-start"  # execution began (up: provision; down: drain)
SCALE_DONE = "scale-done"  # capacity changed; `active` is the new set
SCALE_ABORT = "scale-abort"  # execution failed / drain aborted
SCALE_HELD = "scale-held"  # decision confirmed but the breaker holds
SCALE_BREAKER_OPEN = "scale-breaker-open"  # thrash breaker tripped
SCALE_BREAKER_HALF_OPEN = "scale-breaker-half-open"  # one probe action
SCALE_BREAKER_CLOSE = "scale-breaker-close"  # clean scale: gate lifts
# Allocation vocabulary (provision/allocator.py): the train/serve
# co-scheduling third controller's flight record. A PREEMPT_NOTICE
# without a matching ROLE_CHANGED is the mid-handover crash signature —
# a restarted supervisor RESUMES that handover under its original id,
# so a kill can never double-assign a slice to both roles or orphan a
# half-preempted trainer. PREEMPT_ACK closes the bounded wait for the
# trainer's job-ack (forced=true past the ack deadline); ROLE_CHANGED
# flips the named slices' role and bumps the membership generation
# exactly once (the gateway requeues stragglers on it, the elastic
# trainer re-forms at the new world size).
ALLOC_DECISION = "alloc-decision"  # confirmed role reassignment
PREEMPT_NOTICE = "preempt-notice"  # handover open: slices TRANSITIONING
PREEMPT_ACK = "preempt-ack"  # trainer acked (or forced past deadline)
ROLE_CHANGED = "role-changed"  # handover closed: roles flipped
# Gateway-fleet lease vocabulary (serving/fleet.py): the sharded
# request plane's slice-ownership protocol. Every GRANT carries a
# fleet-monotonic `epoch` — the fence a replica must present with each
# dispatch, so a holder whose lease was revoked/expired behind its back
# is REFUSED instead of double-pulling from a slot pool a peer now
# owns. RENEW keeps the epoch and extends `expires_at`; EXPIRE/REVOKE
# close the lease (a re-grant always mints a fresh epoch, which is why
# a supervisor/fleet restart folding this ledger can never hand out a
# stale fence). Ledgers from before the fleet existed fold unchanged —
# the fields default empty.
LEASE_GRANT = "lease-grant"  # slice -> replica ownership opened (epoch)
LEASE_RENEW = "lease-renew"  # same epoch, expiry pushed out
LEASE_EXPIRE = "lease-expire"  # TTL lapsed (swept at a fleet tick)
LEASE_REVOKE = "lease-revoke"  # administratively closed (carries reason)

# Role vocabulary shared with provision/allocator.py (string literals
# here to avoid the module cycle; tests pin the two stay in sync).
_ROLE_SERVING = "serving"
_ROLE_TRAINING = "training"
_ROLE_TRANSITIONING = "transitioning"

# Slice states the membership fold reasons about — mirrors
# provision/heal.py's vocabulary (tests pin the two stay in sync).
_HEALTHY = "healthy"
_DRAINING = "draining"
_LOST = ("missing", "unready")



class EventLedgerError(RuntimeError):
    """The ledger itself is unusable (mid-file corruption, bad schema)."""


class EventLedger:
    """Append-only fsync'd JSONL event log. `replay()` is read-only and
    lock-free.

    `fsync=False` drops the per-record fsync (flush only): for the
    virtual-clock harnesses whose "crashes" are in-process object drops,
    which OS-buffered writes survive by construction. Anything guarding
    against a real SIGKILL keeps the default.

    Subclasses may set `_buffered = True` to ALSO drop the per-record
    flush in fsync=False mode (the span log does: nothing reads one
    mid-run except through replay(), which flushes the live writer
    first). fsync=True always flushes and fsyncs."""

    _buffered = False

    def __init__(
        self,
        path: Path,
        clock=time.time,
        echo=lambda line: print(line, file=sys.stderr, flush=True),
        fsync: bool = True,
    ) -> None:
        self.path = Path(path)
        self._clock = clock
        self._echo = echo
        self._fsync = bool(fsync)
        self._mutex = threading.Lock()
        self._handle = None  # cached O_APPEND writer (lazy)

    def _writer(self):
        """The cached append handle: one long-lived O_APPEND handle keeps
        every durability property (flush + fsync per record) at a
        fraction of the syscalls of an open per record. Invalidated by
        compact()/scrub(): after an os.replace the old inode is no longer
        the ledger."""
        f = self._handle
        if f is None or f.closed:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            f = self._handle = self.path.open("a")
        return f

    def _drop_writer(self) -> None:
        if self._handle is not None:
            try:
                self._handle.close()
            except OSError:
                pass
            self._handle = None

    def append(self, kind: str, **fields) -> dict:
        record = {"v": SCHEMA_VERSION, "ts": self._clock(), "kind": kind,
                  **fields}
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._mutex:
            f = self._writer()
            f.write(line)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
            elif not self._buffered:
                f.flush()
        return record

    def append_many(self, kinds_fields: list) -> list[dict]:
        """Append several records under ONE lock/flush/fsync: the span
        log's terminal-settle batch (a request's queue-wait + prefill +
        decode + terminal land together). Durability is per BATCH."""
        records = []
        lines = []
        for kind, fields in kinds_fields:
            record = {"v": SCHEMA_VERSION, "ts": self._clock(),
                      "kind": kind, **fields}
            records.append(record)
            lines.append(json.dumps(record, sort_keys=True) + "\n")
        if not lines:
            return records
        with self._mutex:
            f = self._writer()
            f.write("".join(lines))
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
            elif not self._buffered:
                f.flush()
        return records

    def replay(self) -> list[dict]:
        """All records in append order: torn final line truncated away
        (the interrupted write), mid-file corruption fatal, newer-schema
        records skipped (forward compat). A live buffered writer (this
        instance's own cached handle) is flushed first, so a replay
        always sees everything this process appended."""
        with self._mutex:
            if self._handle is not None and not self._handle.closed:
                self._handle.flush()
        if not self.path.exists():
            return []
        raw = self.path.read_text()
        records: list[dict] = []
        lines = raw.splitlines(keepends=True)
        good_bytes = 0
        for i, line in enumerate(lines):
            stripped = line.strip()
            if not stripped:
                good_bytes += len(line)
                continue
            try:
                record = json.loads(stripped)
                if not isinstance(record, dict) or "kind" not in record:
                    raise ValueError("record is not an event")
            except (json.JSONDecodeError, ValueError) as e:
                if i == len(lines) - 1:
                    self._echo(
                        f"event ledger {self.path}: torn final line "
                        f"(interrupted write) truncated: {stripped[:60]!r}"
                    )
                    with self.path.open("r+") as f:
                        f.truncate(good_bytes)
                    break
                raise EventLedgerError(
                    f"event ledger {self.path} corrupt at line {i + 1} "
                    f"with valid records after it: {e}"
                ) from e
            good_bytes += len(line)
            if record.get("v", 0) > SCHEMA_VERSION:
                continue  # a newer writer's record: opaque, skip
            records.append(record)
        return records

    def compact(self, view: "LedgerView | None" = None) -> int:
        """Rewrite the ledger down to ONE snapshot record carrying the
        folded view — the event-ledger sibling of `Journal.compact()`.

        A week-long supervise loop appends a tick record every interval
        plus a verdict per state change, forever; restart-replay cost (and
        the file itself) grows without bound. Everything resume needs is
        the FOLD, not the history: per-slice heal-start timestamps (token
        buckets), the breaker's windowed failures and open/cooldown state,
        the monotonic membership generation, the job-ack phase, counters,
        and any orphaned heal-start (the crash signature). The snapshot
        record serialises exactly that; `apply()` restores it wholesale,
        so fold(compacted ledger + later records) == fold(original ledger
        + later records). The rewrite is a same-directory temp file +
        fsync + os.replace — readers and a crash mid-compaction see the
        old ledger or the new one, never a truncation. Returns the number
        of records dropped.

        `view` (the supervisor's live fold) skips the re-replay; without
        it the ledger is replayed and folded here (the offline path).
        """
        records = self.replay()
        if len(records) <= 1:
            return 0
        if view is None:
            view = fold(records)
        snap = {"v": SCHEMA_VERSION, "ts": self._clock(), "kind": SNAPSHOT,
                **snapshot_fields(view)}
        line = json.dumps(snap, sort_keys=True) + "\n"
        tmp = self.path.with_name(f".{self.path.name}.compact.tmp")
        with self._mutex:
            with tmp.open("w") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._drop_writer()  # the cached handle names the old inode
        dropped = len(records) - 1
        self._echo(
            f"event ledger compacted: {len(records)} records -> 1 snapshot"
        )
        return dropped

    def scrub(self) -> None:
        """Delete the ledger (teardown)."""
        with self._mutex:
            self._drop_writer()
            self.path.unlink(missing_ok=True)


# ------------------------------------------------------------ replay fold


@dataclasses.dataclass
class SliceView:
    """One slice's folded history: last verdict + heal bookkeeping."""

    index: int
    state: str = "unknown"
    detail: str = ""
    since: float | None = None  # ts of the last state CHANGE
    streak: int = 0  # consecutive unhealthy observations (last run's)
    heal_starts: list = dataclasses.field(default_factory=list)  # ts list
    heals_succeeded: int = 0
    heals_failed: int = 0
    domain: str = ""  # failure domain ("" on pre-domain ledgers)


@dataclasses.dataclass
class DomainView:
    """One failure domain's folded history: its breaker state (the
    per-domain sibling of the global breaker block) and the outage
    record. `outage_active` is the classifier's episode flag — set by
    DOMAIN_OUTAGE, cleared by DOMAIN_BREAKER_CLOSE — so a restarted
    supervisor knows the domain is still under the canary gate."""

    name: str
    breaker_state: str = "closed"
    breaker_since: float | None = None
    breaker_reopen_at: float | None = None
    breaker_trips: int = 0
    breaker_failures: list = dataclasses.field(default_factory=list)  # ts
    outages: int = 0
    last_outage_ts: float | None = None
    outage_active: bool = False


@dataclasses.dataclass
class LedgerView:
    """The replayed ledger folded into what a restart (and the status
    command) needs. `open_heals` are heal-starts without a matching
    done/failed — the crash signature: the supervisor died mid-heal, and
    those attempts are SPENT against the rate limit on resume."""

    started: float | None = None
    stopped: float | None = None
    ticks: int = 0
    slices: dict = dataclasses.field(default_factory=dict)  # int -> SliceView
    heals_attempted: int = 0
    heals_succeeded: int = 0
    heals_failed: int = 0
    rate_limited: int = 0
    held_ticks: int = 0  # degraded-hold observations
    heals_suppressed: int = 0  # skipped: trainer acked the loss
    heals_deferred: int = 0  # postponed: listing page quota-parked
    domain_outages: int = 0  # correlated-failure classifications
    domains: dict = dataclasses.field(default_factory=dict)  # str -> DomainView
    # Monotonic membership generation: bumped whenever a slice LEAVES
    # the serving set (healthy/draining -> missing/unready) or RETURNS
    # to it (missing/unready -> healthy, i.e. a heal landed — replaced
    # hosts, so the job must re-form even though the verdict is green).
    # healthy -> draining is a notice, not yet a loss, so it does not
    # bump; the trainer reads the draining list for its checkpoint
    # window instead. This is what parallel/elastic.py keys resume on.
    membership_generation: int = 1
    # the training job's last acknowledged phase (job-ack.json fold)
    job_phase: str = ""  # "" / "notified" / "resumed" / "degraded"
    job_generation: int | None = None
    job_step: int | None = None
    job_notified_ts: float | None = None
    job_resumed_ts: float | None = None
    job_mttr_samples: list = dataclasses.field(default_factory=list)
    acked_degraded: set = dataclasses.field(default_factory=set)
    breaker_state: str = "closed"
    breaker_since: float | None = None
    breaker_reopen_at: float | None = None
    breaker_trips: int = 0
    breaker_failures: list = dataclasses.field(default_factory=list)  # ts
    # ---- autoscale fold (provision/autoscale.py) ----
    # `autoscale_active` is None on pre-autoscale ledgers (every
    # configured slice is active); once any scale record lands it is
    # the authoritative active-slice list. `open_scale` is a
    # SCALE_START without a DONE/ABORT — the mid-scale crash signature.
    autoscale_enabled: bool = False
    autoscale_desired: int | None = None
    autoscale_active: list | None = None
    last_scale_decision: dict | None = None
    open_scale: dict | None = None
    scale_decisions: int = 0
    scales_started: int = 0
    scales_done: int = 0
    scales_aborted: int = 0
    scales_held: int = 0
    scale_cooldown_until: float | None = None
    scale_breaker_state: str = "closed"
    scale_breaker_since: float | None = None
    scale_breaker_reopen_at: float | None = None
    scale_breaker_trips: int = 0
    scale_breaker_failures: list = dataclasses.field(default_factory=list)
    # ---- allocation fold (provision/allocator.py) ----
    # `roles` is the per-slice role map (absent slices are SERVING —
    # pre-allocation ledgers fold to an empty map and byte-identical
    # behavior). `open_handover` is a PREEMPT_NOTICE without a
    # ROLE_CHANGED — the mid-handover crash signature.
    alloc_enabled: bool = False
    roles: dict = dataclasses.field(default_factory=dict)  # int -> role
    open_handover: dict | None = None
    last_alloc_decision: dict | None = None
    alloc_decisions: int = 0
    preempt_notices: int = 0
    preempt_acks: int = 0
    forced_preemptions: int = 0
    role_changes: int = 0
    alloc_cooldown_until: float | None = None
    # ---- gateway-fleet lease fold (serving/fleet.py) ----
    # `leases` is the LIVE lease table (slice -> {replica, epoch,
    # expires_at, since}); `lease_epoch` is the highest epoch ever
    # granted — the monotonic fence a restarted fleet resumes from so
    # a re-grant after a crash can never reuse a dead holder's epoch.
    leases: dict = dataclasses.field(default_factory=dict)
    lease_epoch: int = 0
    lease_grants: int = 0
    lease_renews: int = 0
    lease_expiries: int = 0
    lease_revokes: int = 0
    fleet_replicas: set = dataclasses.field(default_factory=set)
    open_heals: list = dataclasses.field(default_factory=list)  # records
    # heal-start id -> record, until a done/failed closes it (the list
    # above is kept in sync — it is the public face, this is the index)
    pending_heals: dict = dataclasses.field(default_factory=dict)
    mttr_samples: list = dataclasses.field(default_factory=list)  # seconds
    last_ts: float | None = None

    def slice_view(self, index: int) -> SliceView:
        return self.slices.setdefault(int(index), SliceView(int(index)))

    def domain_view(self, name: str) -> DomainView:
        return self.domains.setdefault(str(name), DomainView(str(name)))


def snapshot_fields(view: LedgerView) -> dict:
    """Serialise a LedgerView into the snapshot record's fields — the
    exact inverse of `_apply_snapshot`. Every field a restart consumes is
    here: drop one and a compacted ledger silently forgets it (the
    compact round-trip tests in tests/test_events.py pin the set)."""
    return {
        "started": view.started,
        "stopped": view.stopped,
        "ticks": view.ticks,
        "heals_attempted": view.heals_attempted,
        "heals_succeeded": view.heals_succeeded,
        "heals_failed": view.heals_failed,
        "rate_limited": view.rate_limited,
        "held_ticks": view.held_ticks,
        "heals_suppressed": view.heals_suppressed,
        "heals_deferred": view.heals_deferred,
        "domain_outages": view.domain_outages,
        "domains": {
            dv.name: {
                "breaker_state": dv.breaker_state,
                "breaker_since": dv.breaker_since,
                "breaker_reopen_at": dv.breaker_reopen_at,
                "breaker_trips": dv.breaker_trips,
                "breaker_failures": list(dv.breaker_failures),
                "outages": dv.outages,
                "last_outage_ts": dv.last_outage_ts,
                "outage_active": dv.outage_active,
            }
            for dv in view.domains.values()
        },
        "membership_generation": view.membership_generation,
        "job_phase": view.job_phase,
        "job_generation": view.job_generation,
        "job_step": view.job_step,
        "job_notified_ts": view.job_notified_ts,
        "job_resumed_ts": view.job_resumed_ts,
        "job_mttr_samples": list(view.job_mttr_samples),
        "acked_degraded": sorted(view.acked_degraded),
        "breaker_state": view.breaker_state,
        "breaker_since": view.breaker_since,
        "breaker_reopen_at": view.breaker_reopen_at,
        "breaker_trips": view.breaker_trips,
        "breaker_failures": list(view.breaker_failures),
        # the autoscale fold: desired/active capacity, the open scale
        # (mid-scale crash signature — it must survive compaction the
        # same way orphaned heal-starts do), thrash-breaker state
        "autoscale_enabled": view.autoscale_enabled,
        "autoscale_desired": view.autoscale_desired,
        "autoscale_active": (list(view.autoscale_active)
                             if view.autoscale_active is not None
                             else None),
        "last_scale_decision": view.last_scale_decision,
        "open_scale": view.open_scale,
        "scale_decisions": view.scale_decisions,
        "scales_started": view.scales_started,
        "scales_done": view.scales_done,
        "scales_aborted": view.scales_aborted,
        "scales_held": view.scales_held,
        "scale_cooldown_until": view.scale_cooldown_until,
        "scale_breaker_state": view.scale_breaker_state,
        "scale_breaker_since": view.scale_breaker_since,
        "scale_breaker_reopen_at": view.scale_breaker_reopen_at,
        "scale_breaker_trips": view.scale_breaker_trips,
        "scale_breaker_failures": list(view.scale_breaker_failures),
        # the allocation fold: per-slice roles and the open handover
        # (the mid-handover crash signature — it must survive
        # compaction the same way orphaned heal-starts do)
        "alloc_enabled": view.alloc_enabled,
        "roles": {str(k): v for k, v in view.roles.items()},
        "open_handover": view.open_handover,
        "last_alloc_decision": view.last_alloc_decision,
        "alloc_decisions": view.alloc_decisions,
        "preempt_notices": view.preempt_notices,
        "preempt_acks": view.preempt_acks,
        "forced_preemptions": view.forced_preemptions,
        "role_changes": view.role_changes,
        "alloc_cooldown_until": view.alloc_cooldown_until,
        # the gateway-fleet lease fold: the live lease table AND the
        # monotonic epoch high-water mark must survive compaction — a
        # fleet restarting over a compacted ledger that forgot either
        # could double-grant a slice or mint a reused (unfenceable)
        # epoch
        "leases": {str(k): dict(v) for k, v in view.leases.items()},
        "lease_epoch": view.lease_epoch,
        "lease_grants": view.lease_grants,
        "lease_renews": view.lease_renews,
        "lease_expiries": view.lease_expiries,
        "lease_revokes": view.lease_revokes,
        "fleet_replicas": sorted(view.fleet_replicas),
        # orphaned heal-starts (the crash signature) survive the compact
        "pending_heals": {str(k): v for k, v in view.pending_heals.items()},
        "mttr_samples": list(view.mttr_samples),
        "last_ts": view.last_ts,
        "slices": {
            str(sv.index): {
                "state": sv.state,
                "detail": sv.detail,
                "since": sv.since,
                "streak": sv.streak,
                "heal_starts": list(sv.heal_starts),
                "heals_succeeded": sv.heals_succeeded,
                "heals_failed": sv.heals_failed,
                "domain": sv.domain,
            }
            for sv in view.slices.values()
        },
    }


def _apply_snapshot(view: LedgerView, record: dict) -> None:
    """Restore a compacted snapshot into `view` wholesale — the first
    record of a compacted ledger; later records fold on top normally."""
    view.started = record.get("started")
    view.stopped = record.get("stopped")
    view.ticks = record.get("ticks", 0)
    view.heals_attempted = record.get("heals_attempted", 0)
    view.heals_succeeded = record.get("heals_succeeded", 0)
    view.heals_failed = record.get("heals_failed", 0)
    view.rate_limited = record.get("rate_limited", 0)
    view.held_ticks = record.get("held_ticks", 0)
    view.heals_suppressed = record.get("heals_suppressed", 0)
    view.heals_deferred = record.get("heals_deferred", 0)
    view.domain_outages = record.get("domain_outages", 0)
    view.domains = {}
    # snapshots from before the failure-domain model simply have no
    # "domains" entry — they restore to the flat (global-only) view
    for name, entry in (record.get("domains") or {}).items():
        dv = DomainView(str(name))
        dv.breaker_state = entry.get("breaker_state", "closed")
        dv.breaker_since = entry.get("breaker_since")
        dv.breaker_reopen_at = entry.get("breaker_reopen_at")
        dv.breaker_trips = entry.get("breaker_trips", 0)
        dv.breaker_failures = list(entry.get("breaker_failures") or [])
        dv.outages = entry.get("outages", 0)
        dv.last_outage_ts = entry.get("last_outage_ts")
        dv.outage_active = bool(entry.get("outage_active", False))
        view.domains[dv.name] = dv
    view.membership_generation = record.get("membership_generation", 1)
    view.job_phase = record.get("job_phase", "")
    view.job_generation = record.get("job_generation")
    view.job_step = record.get("job_step")
    view.job_notified_ts = record.get("job_notified_ts")
    view.job_resumed_ts = record.get("job_resumed_ts")
    view.job_mttr_samples = list(record.get("job_mttr_samples") or [])
    view.acked_degraded = {int(i) for i in record.get("acked_degraded") or []}
    view.breaker_state = record.get("breaker_state", "closed")
    view.breaker_since = record.get("breaker_since")
    view.breaker_reopen_at = record.get("breaker_reopen_at")
    view.breaker_trips = record.get("breaker_trips", 0)
    view.breaker_failures = list(record.get("breaker_failures") or [])
    view.autoscale_enabled = bool(record.get("autoscale_enabled", False))
    view.autoscale_desired = record.get("autoscale_desired")
    active = record.get("autoscale_active")
    view.autoscale_active = (
        sorted(int(i) for i in active) if active is not None else None
    )
    view.last_scale_decision = record.get("last_scale_decision")
    view.open_scale = record.get("open_scale")
    view.scale_decisions = record.get("scale_decisions", 0)
    view.scales_started = record.get("scales_started", 0)
    view.scales_done = record.get("scales_done", 0)
    view.scales_aborted = record.get("scales_aborted", 0)
    view.scales_held = record.get("scales_held", 0)
    view.scale_cooldown_until = record.get("scale_cooldown_until")
    view.scale_breaker_state = record.get("scale_breaker_state", "closed")
    view.scale_breaker_since = record.get("scale_breaker_since")
    view.scale_breaker_reopen_at = record.get("scale_breaker_reopen_at")
    view.scale_breaker_trips = record.get("scale_breaker_trips", 0)
    view.scale_breaker_failures = list(
        record.get("scale_breaker_failures") or []
    )
    view.alloc_enabled = bool(record.get("alloc_enabled", False))
    view.roles = {int(k): str(v)
                  for k, v in (record.get("roles") or {}).items()}
    view.open_handover = record.get("open_handover")
    view.last_alloc_decision = record.get("last_alloc_decision")
    view.alloc_decisions = record.get("alloc_decisions", 0)
    view.preempt_notices = record.get("preempt_notices", 0)
    view.preempt_acks = record.get("preempt_acks", 0)
    view.forced_preemptions = record.get("forced_preemptions", 0)
    view.role_changes = record.get("role_changes", 0)
    view.alloc_cooldown_until = record.get("alloc_cooldown_until")
    view.leases = {int(k): dict(v)
                   for k, v in (record.get("leases") or {}).items()}
    view.lease_epoch = record.get("lease_epoch", 0)
    view.lease_grants = record.get("lease_grants", 0)
    view.lease_renews = record.get("lease_renews", 0)
    view.lease_expiries = record.get("lease_expiries", 0)
    view.lease_revokes = record.get("lease_revokes", 0)
    view.fleet_replicas = {str(r)
                           for r in record.get("fleet_replicas") or []}
    view.pending_heals = dict(record.get("pending_heals") or {})
    view.open_heals = list(view.pending_heals.values())
    view.mttr_samples = list(record.get("mttr_samples") or [])
    view.slices = {}
    for index, entry in (record.get("slices") or {}).items():
        sv = SliceView(int(index))
        sv.state = entry.get("state", "unknown")
        sv.detail = entry.get("detail", "")
        sv.since = entry.get("since")
        sv.streak = entry.get("streak", 0)
        sv.heal_starts = list(entry.get("heal_starts") or [])
        sv.heals_succeeded = entry.get("heals_succeeded", 0)
        sv.heals_failed = entry.get("heals_failed", 0)
        sv.domain = entry.get("domain", "")
        view.slices[sv.index] = sv
    view.last_ts = record.get("last_ts")


def _note_state(view: LedgerView, sv: SliceView, new_state: str) -> None:
    """Assign one slice observation, bumping the membership generation on
    serving-set transitions. ONE helper shared by the TICK and VERDICT
    folds — TICK lands first in the ledger, so if the two disagreed the
    generation could skip or double-count a transition."""
    prev = sv.state
    if prev != new_state:
        left = prev in (_HEALTHY, _DRAINING) and new_state in _LOST
        returned = prev in _LOST and new_state == _HEALTHY
        if left or returned:
            view.membership_generation += 1
        if new_state == _HEALTHY:
            # a slice back in service clears any degraded-continuation
            # acknowledgement: the trainer should fold it back in on its
            # next generation-bump resume, and heal is fair game again
            view.acked_degraded.discard(sv.index)
    sv.state = new_state


def apply(view: LedgerView, record: dict) -> LedgerView:
    """Fold ONE event into the view. The supervisor applies each record
    as it appends it, so a week-long reconcile loop keeps an O(1)-per-
    tick live view instead of re-reading its whole ledger every status
    publish; `fold()` is the same function looped over a replay."""
    kind = record.get("kind", "")
    ts = record.get("ts")
    if kind == SNAPSHOT:
        _apply_snapshot(view, record)
        return view
    view.last_ts = ts
    if kind == SUPERVISOR_START:
        view.started = ts
        view.stopped = None
        if record.get("autoscale"):
            view.autoscale_enabled = True
            if record.get("active") is not None:
                view.autoscale_active = sorted(
                    int(i) for i in record["active"]
                )
    elif kind == SUPERVISOR_STOP:
        view.stopped = ts
    elif kind == TICK:
        view.ticks += 1
        for index, state in (record.get("states") or {}).items():
            _note_state(view, view.slice_view(int(index)), state)
    elif kind == VERDICT:
        sv = view.slice_view(record.get("slice", -1))
        _note_state(view, sv, record.get("state", "unknown"))
        sv.detail = record.get("detail", "")
        sv.since = ts
        sv.streak = record.get("streak", 0)
        if record.get("domain"):
            sv.domain = record["domain"]
    elif kind == HEAL_START:
        view.heals_attempted += 1
        view.pending_heals[record.get("id",
                                      len(view.pending_heals))] = record
        view.open_heals = list(view.pending_heals.values())
        for index in record.get("slices", []):
            view.slice_view(index).heal_starts.append(ts)
    elif kind in (HEAL_DONE, HEAL_FAILED):
        view.pending_heals.pop(record.get("id", -1), None)
        view.open_heals = list(view.pending_heals.values())
        if kind == HEAL_DONE:
            view.heals_succeeded += 1
            for index in record.get("slices", []):
                view.slice_view(index).heals_succeeded += 1
            for sample in record.get("mttr_s", []):
                view.mttr_samples.append(sample)
        else:
            view.heals_failed += 1
            view.breaker_failures.append(ts)
            for index in record.get("slices", []):
                view.slice_view(index).heals_failed += 1
            for name in record.get("domains") or []:
                view.domain_view(name).breaker_failures.append(ts)
    elif kind == RATE_LIMITED:
        view.rate_limited += 1
    elif kind == DEGRADED_HOLD:
        view.held_ticks += 1
    elif kind == HEAL_DEFERRED:
        view.heals_deferred += 1
    elif kind == DOMAIN_OUTAGE:
        dv = view.domain_view(record.get("domain", ""))
        dv.outages += 1
        dv.last_outage_ts = ts
        dv.outage_active = True
        view.domain_outages += 1
    elif kind == DOMAIN_BREAKER_OPEN:
        dv = view.domain_view(record.get("domain", ""))
        dv.breaker_state = "open"
        dv.breaker_since = ts
        dv.breaker_reopen_at = record.get("reopen_at")
        dv.breaker_trips += 1
    elif kind == DOMAIN_BREAKER_HALF_OPEN:
        dv = view.domain_view(record.get("domain", ""))
        dv.breaker_state = "half-open"
        dv.breaker_since = ts
    elif kind == DOMAIN_BREAKER_CLOSE:
        # the canary-gate lifts, but the outage EPISODE runs until the
        # domain reads fully healthy (DOMAIN_RECOVERED) — otherwise the
        # still-unhealthy remainder would re-classify as a fresh outage
        dv = view.domain_view(record.get("domain", ""))
        dv.breaker_state = "closed"
        dv.breaker_since = ts
        dv.breaker_reopen_at = None
        dv.breaker_failures = []
    elif kind == DOMAIN_RECOVERED:
        view.domain_view(record.get("domain", "")).outage_active = False
    elif kind == JOB_NOTIFIED:
        view.job_phase = "notified"
        view.job_generation = record.get("generation")
        view.job_step = record.get("step")
        view.job_notified_ts = ts
    elif kind == JOB_RESUMED:
        view.job_phase = "degraded" if record.get("degraded") else "resumed"
        view.job_generation = record.get("generation")
        view.job_step = record.get("step")
        view.job_resumed_ts = ts
        if record.get("mttr_s") is not None:
            view.job_mttr_samples.append(record["mttr_s"])
    elif kind == DEGRADED_ACK:
        view.job_phase = "degraded"
        view.job_generation = record.get("generation")
        view.job_step = record.get("step")
        for index in record.get("slices", []):
            view.acked_degraded.add(int(index))
    elif kind == HEAL_SUPPRESSED:
        view.heals_suppressed += 1
    elif kind == BREAKER_OPEN:
        view.breaker_state = "open"
        view.breaker_since = ts
        view.breaker_reopen_at = record.get("reopen_at")
        view.breaker_trips += 1
    elif kind == BREAKER_HALF_OPEN:
        view.breaker_state = "half-open"
        view.breaker_since = ts
    elif kind == BREAKER_CLOSE:
        view.breaker_state = "closed"
        view.breaker_since = ts
        view.breaker_reopen_at = None
        view.breaker_failures = []
    elif kind == SCALE_DECISION:
        view.autoscale_enabled = True
        view.scale_decisions += 1
        view.autoscale_desired = record.get("to_count")
        view.last_scale_decision = {
            "ts": ts,
            "direction": record.get("direction"),
            "from_count": record.get("from_count"),
            "to_count": record.get("to_count"),
            "reason": str(record.get("reason", ""))[:200],
            "windows": record.get("windows"),
        }
    elif kind == SCALE_START:
        view.autoscale_enabled = True
        view.scales_started += 1
        view.open_scale = record
        if record.get("cooldown_until") is not None:
            view.scale_cooldown_until = record["cooldown_until"]
        if record.get("direction") == "down":
            # draining-for-scale-down: the Router stops pulling (the
            # membership.draining list carries these), but the slices
            # stay ACTIVE (and billed) until SCALE_DONE removes them
            for index in record.get("slices", []):
                sv = view.slice_view(int(index))
                _note_state(view, sv, _DRAINING)
                sv.detail = "scale-down drain"
                sv.since = ts
    elif kind == SCALE_DONE:
        view.autoscale_enabled = True
        view.scales_done += 1
        view.open_scale = None
        if record.get("active") is not None:
            view.autoscale_active = sorted(
                int(i) for i in record["active"]
            )
        if record.get("direction") == "down":
            for index in record.get("slices", []):
                view.slices.pop(int(index), None)
                view.roles.pop(int(index), None)  # torn down: no role
        else:
            for index in record.get("slices", []):
                sv = view.slice_view(int(index))
                sv.state = _HEALTHY
                sv.detail = "scaled up"
                sv.since = ts
        # capacity changed hands: the serving set is different, so the
        # membership generation bumps exactly once per executed scale —
        # the gateway requeues a removed slice's stragglers on it, and
        # the elastic trainer re-forms over the new world
        view.membership_generation += 1
    elif kind == SCALE_ABORT:
        view.autoscale_enabled = True
        view.scales_aborted += 1
        view.open_scale = None
        # aborts are the thrash breaker's failure evidence (windowed,
        # restored into the breaker on resume like heal failures)
        view.scale_breaker_failures.append(ts)
        if record.get("direction") == "down":
            # the drain is called off: the slices never left service
            for index in record.get("slices", []):
                sv = view.slice_view(int(index))
                _note_state(view, sv, _HEALTHY)
                sv.detail = "scale-down aborted"
                sv.since = ts
    elif kind == SCALE_HELD:
        view.autoscale_enabled = True
        view.scales_held += 1
    elif kind == SCALE_BREAKER_OPEN:
        view.scale_breaker_state = "open"
        view.scale_breaker_since = ts
        view.scale_breaker_reopen_at = record.get("reopen_at")
        view.scale_breaker_trips += 1
    elif kind == SCALE_BREAKER_HALF_OPEN:
        view.scale_breaker_state = "half-open"
        view.scale_breaker_since = ts
    elif kind == SCALE_BREAKER_CLOSE:
        view.scale_breaker_state = "closed"
        view.scale_breaker_since = ts
        view.scale_breaker_reopen_at = None
        view.scale_breaker_failures = []
    elif kind == ALLOC_DECISION:
        view.alloc_enabled = True
        view.alloc_decisions += 1
        view.last_alloc_decision = {
            "ts": ts,
            "direction": record.get("direction"),
            "count": record.get("count"),
            "reason": str(record.get("reason", ""))[:200],
            "windows": record.get("windows"),
        }
    elif kind == PREEMPT_NOTICE:
        view.alloc_enabled = True
        view.preempt_notices += 1
        view.open_handover = record
        if record.get("cooldown_until") is not None:
            view.alloc_cooldown_until = record["cooldown_until"]
        # both directions park the slices TRANSITIONING: the published
        # status carries them in membership.draining, so the side that
        # must let go drains — the trainer's checkpoint window
        # (to-serving) or the Router's finish-in-flight (to-training)
        for index in record.get("slices", []):
            view.roles[int(index)] = _ROLE_TRANSITIONING
    elif kind == PREEMPT_ACK:
        view.preempt_acks += 1
        if record.get("forced"):
            view.forced_preemptions += 1
        if (view.open_handover is not None
                and view.open_handover.get("id") == record.get("id")):
            view.open_handover = dict(view.open_handover,
                                      acked=True,
                                      forced=bool(record.get("forced")))
    elif kind == ROLE_CHANGED:
        view.alloc_enabled = True
        view.role_changes += 1
        role = record.get("role", _ROLE_SERVING)
        for index in record.get("slices", []):
            view.roles[int(index)] = role
        if (view.open_handover is not None
                and view.open_handover.get("id") == record.get("id")):
            view.open_handover = None
        # the serving set changed hands: one generation bump per
        # executed role change — the gateway requeues a reclaimed
        # slice's stragglers on it, and the elastic trainer re-forms
        # at the new world size. The initial role assignment bumps too
        # (the trainer must form at the post-assignment world). An
        # ABORTED hand-back deliberately does NOT bump: the slices
        # never left the serving set (nothing to reap) and the
        # trainer's world never changed (nothing to re-form) — bumping
        # would charge the trainer a full teardown/rejoin for a
        # handover that never happened.
        if not record.get("aborted"):
            view.membership_generation += 1
    elif kind == LEASE_GRANT:
        view.lease_grants += 1
        epoch = int(record.get("epoch", 0))
        # the epoch high-water mark is monotone over the ledger's whole
        # lifetime — grants land in epoch order, but a compacted prefix
        # plus a replayed suffix must still fold to the max ever seen
        view.lease_epoch = max(view.lease_epoch, epoch)
        replica = record.get("replica")
        view.leases[int(record.get("slice", -1))] = {
            "replica": replica,
            "epoch": epoch,
            "expires_at": record.get("expires_at"),
            "since": ts,
        }
        if replica is not None:
            view.fleet_replicas.add(str(replica))
    elif kind == LEASE_RENEW:
        view.lease_renews += 1
        lease = view.leases.get(int(record.get("slice", -1)))
        # a renew for a superseded epoch is a no-op on the fold: the
        # live lease (newer epoch) is the truth, the stale renew is the
        # race the fence exists for
        if lease is not None and lease.get("epoch") == record.get("epoch"):
            lease["expires_at"] = record.get("expires_at")
    elif kind in (LEASE_EXPIRE, LEASE_REVOKE):
        if kind == LEASE_EXPIRE:
            view.lease_expiries += 1
        else:
            view.lease_revokes += 1
        index = int(record.get("slice", -1))
        lease = view.leases.get(index)
        if lease is not None and lease.get("epoch") == record.get("epoch"):
            view.leases.pop(index, None)
    return view


def fold(records: list[dict]) -> LedgerView:
    """One pass over the replayed ledger. Counters span the ledger's whole
    lifetime (restarts included); breaker/open-heal state is last-wins."""
    view = LedgerView()
    for record in records:
        apply(view, record)
    return view


# ------------------------------------------------------------ fleet status


def fleet_status(
    view: LedgerView,
    now: float,
    pid: int | None = None,
    all_slices: bool = False,
    telemetry: dict | None = None,
    gateway_fleet: dict | None = None,
) -> dict:
    """The machine-readable status document. Written atomically to
    fleet-status.json every reconcile tick and rendered by
    `./setup.sh status [--json]`; schema documented in
    docs/failure-modes.md (running unattended).

    The document stays BOUNDED at fleet scale: `slice_states` carries
    per-state counts for the whole fleet, while the per-slice `slices`
    detail names only the not-healthy slices — at 256 healthy slices the
    status a FileHealthSource (parallel/elastic.py) parses every step
    boundary is a few hundred bytes, not a megabyte. `all_slices=True`
    (what `./setup.sh status --json --all` folds from the ledger) emits
    the full per-slice dump.

    `telemetry` (the supervisor's `telemetry_block()`) records which
    metrics snapshot this status was built alongside, the span log and
    its size, and the last tick's duration — absent on documents built
    by an un-wired fold (the status command synthesizes one from disk
    then)."""
    degraded = sorted(
        sv.index for sv in view.slices.values()
        if sv.state not in (heal_mod.HEALTHY, "unknown")
    )
    counts: dict = {}
    for sv in view.slices.values():
        counts[sv.state] = counts.get(sv.state, 0) + 1
    healing = bool(view.open_heals)
    if view.breaker_state != "closed":
        verdict = "degraded-hold"
    elif degraded:
        verdict = "recovering" if healing else "degraded"
    else:
        verdict = "healthy"
    mttr = view.mttr_samples
    job_mttr = view.job_mttr_samples
    # Allocation (provision/allocator.py): TRAINING slices are healthy
    # but belong to the elastic trainer — never route-eligible;
    # TRANSITIONING slices are mid-handover and read as DRAINING to
    # both consumers (the Router finishes in-flight and pulls nothing,
    # the trainer opens its drain-notice checkpoint window). Empty role
    # map (pre-allocation ledgers) = every slice SERVING, byte-identical.
    training_slices = sorted(
        i for i, role in view.roles.items() if role == _ROLE_TRAINING
    )
    transitioning = sorted(
        i for i, role in view.roles.items()
        if role == _ROLE_TRANSITIONING
    )
    not_serving_roles = set(training_slices) | set(transitioning)
    draining = sorted(
        {sv.index for sv in view.slices.values()
         if sv.state == heal_mod.DRAINING} | set(transitioning)
    )
    doc = {
        "v": SCHEMA_VERSION,
        "updated": now,
        "supervisor": {
            "pid": pid,
            "running": view.started is not None and view.stopped is None,
            "started": view.started,
            "uptime_s": (
                round(now - view.started, 3)
                if view.started is not None and view.stopped is None
                else None
            ),
            "ticks": view.ticks,
        },
        "verdict": verdict,
        "slices_total": len(view.slices),
        "slice_states": counts,
        "slices": {
            str(sv.index): {
                "state": sv.state,
                "detail": sv.detail,
                "since": sv.since,
                "heals_attempted": len(sv.heal_starts),
                "heals_succeeded": sv.heals_succeeded,
                "heals_failed": sv.heals_failed,
            }
            for sv in sorted(view.slices.values(), key=lambda s: s.index)
            if all_slices or sv.state != heal_mod.HEALTHY
        },
        "degraded": degraded,
        # The traffic-facing routing contract (serving/gateway.py,
        # through the same provision/fleetview.py reader the trainer
        # uses): which slices may take new inference work, which to
        # route around (with the state as the reason), and whether the
        # gateway should shed outright — the breaker holding means the
        # supervisor has stopped trusting repairs, and a gateway that
        # kept admitting into a collapsing fleet would turn one incident
        # into queue collapse. Bounded like the rest of the document:
        # `eligible` is a list of ints, `avoid` only names not-healthy
        # slices.
        "serving": {
            "eligible": [
                sv.index
                for sv in sorted(view.slices.values(), key=lambda s: s.index)
                if sv.state == heal_mod.HEALTHY
                and sv.index not in not_serving_roles
            ],
            "avoid": {
                str(sv.index): sv.state
                for sv in sorted(view.slices.values(), key=lambda s: s.index)
                if sv.state not in (heal_mod.HEALTHY, "unknown")
            },
            "shed": view.breaker_state != "closed",
        },
        # The job-facing membership contract (parallel/elastic.py
        # FileHealthSource): a monotonic generation the trainer keys
        # resume on, and heal_in_progress so it WAITS for the supervisor
        # instead of thrash-restarting into a half-healed fleet.
        "membership": {
            "generation": view.membership_generation,
            "heal_in_progress": bool(view.open_heals),
            "draining": draining,
        },
        "job": {
            "phase": view.job_phase or None,
            "generation": view.job_generation,
            "step": view.job_step,
            "notified": view.job_notified_ts,
            "resumed": view.job_resumed_ts,
            "acked_degraded": sorted(view.acked_degraded),
            "mttr_s": {
                "count": len(job_mttr),
                "mean": (round(sum(job_mttr) / len(job_mttr), 3)
                         if job_mttr else None),
                "last": job_mttr[-1] if job_mttr else None,
            },
        },
        "heals": {
            "attempted": view.heals_attempted,
            "succeeded": view.heals_succeeded,
            "failed": view.heals_failed,
            "rate_limited": view.rate_limited,
            "held_ticks": view.held_ticks,
            "suppressed": view.heals_suppressed,
            "deferred": view.heals_deferred,
            "in_flight": len(view.open_heals),
        },
        # Blast-radius block: one entry per failure domain the ledger
        # has seen (bounded — domains are counted in single digits, not
        # slices). DOMAIN_OUTAGE counts surface here and in
        # `./setup.sh status`.
        "domain_outages": view.domain_outages,
        "domains": {
            dv.name: {
                "breaker": dv.breaker_state,
                "reopen_at": dv.breaker_reopen_at,
                "trips": dv.breaker_trips,
                "outages": dv.outages,
                "outage_active": dv.outage_active,
            }
            for dv in sorted(view.domains.values(), key=lambda d: d.name)
        },
        # Elastic-capacity block (provision/autoscale.py): desired vs
        # actual slice count, the last confirmed decision with its
        # reason, the scale in flight (mid-scale crash signature), the
        # thrash-breaker state, and the cooldown remaining — what
        # `./setup.sh status` renders and the runbook
        # (docs/failure-modes.md "Elastic capacity") reads back.
        "autoscale": {
            "enabled": view.autoscale_enabled,
            "desired": view.autoscale_desired,
            "actual": (len(view.autoscale_active)
                       if view.autoscale_active is not None
                       else len(view.slices) or None),
            "active": view.autoscale_active,
            "last_decision": view.last_scale_decision,
            "in_progress": (
                {
                    "id": view.open_scale.get("id"),
                    "direction": view.open_scale.get("direction"),
                    "slices": view.open_scale.get("slices"),
                    "drain_deadline": view.open_scale.get(
                        "drain_deadline"),
                }
                if view.open_scale is not None else None
            ),
            "cooldown_until": view.scale_cooldown_until,
            "cooldown_remaining_s": (
                round(max(0.0, view.scale_cooldown_until - now), 3)
                if view.scale_cooldown_until is not None else None
            ),
            "breaker": {
                "state": view.scale_breaker_state,
                "reopen_at": view.scale_breaker_reopen_at,
                "trips": view.scale_breaker_trips,
            },
            "scales": {
                "decisions": view.scale_decisions,
                "started": view.scales_started,
                "done": view.scales_done,
                "aborted": view.scales_aborted,
                "held": view.scales_held,
            },
        },
        # Co-scheduling block (provision/allocator.py): the per-slice
        # role split, the handover in flight (the mid-handover crash
        # signature), the last confirmed decision, and the protocol
        # counters — what `./setup.sh status` renders and the runbook
        # (docs/failure-modes.md "Fleet allocation & preemption")
        # reads back. Bounded: role COUNTS for the fleet, explicit
        # lists only for the non-serving roles.
        "allocation": {
            "enabled": view.alloc_enabled,
            "roles": {
                _ROLE_SERVING: max(
                    0, len(view.slices) - len(not_serving_roles)
                ) if view.slices else 0,
                _ROLE_TRAINING: len(training_slices),
                _ROLE_TRANSITIONING: len(transitioning),
            },
            "training": training_slices,
            "transitioning": transitioning,
            "last_decision": view.last_alloc_decision,
            "in_progress": (
                {
                    "id": view.open_handover.get("id"),
                    "direction": view.open_handover.get("direction"),
                    "slices": view.open_handover.get("slices"),
                    "ack_deadline": view.open_handover.get("ack_deadline"),
                    "drain_deadline": view.open_handover.get(
                        "drain_deadline"),
                    "acked": bool(view.open_handover.get("acked")),
                }
                if view.open_handover is not None else None
            ),
            "cooldown_until": view.alloc_cooldown_until,
            "cooldown_remaining_s": (
                round(max(0.0, view.alloc_cooldown_until - now), 3)
                if view.alloc_cooldown_until is not None else None
            ),
            "handovers": {
                "decisions": view.alloc_decisions,
                "notices": view.preempt_notices,
                "acks": view.preempt_acks,
                "forced": view.forced_preemptions,
                "role_changes": view.role_changes,
            },
        },
        "mttr_s": {
            "count": len(mttr),
            "mean": round(sum(mttr) / len(mttr), 3) if mttr else None,
            "last": mttr[-1] if mttr else None,
        },
        "breaker": {
            "state": view.breaker_state,
            "since": view.breaker_since,
            "reopen_at": view.breaker_reopen_at,
            "trips": view.breaker_trips,
            "failures_on_record": len(view.breaker_failures),
        },
    }
    # Gateway-fleet block (serving/fleet.py): present only when the
    # ledger has ever seen a lease (or the caller passed live fleet
    # evidence) so pre-fleet status documents keep their pinned schema.
    # Bounded: replicas and lease COUNTS always, the per-slice lease
    # map capped — at 256 slices the detail lives in the ledger, not
    # in a document a gateway parses every poll.
    if view.lease_grants or view.leases or gateway_fleet is not None:
        lease_items = sorted(view.leases.items())
        doc["gateway_fleet"] = {
            "replicas": sorted(view.fleet_replicas),
            "leases_total": len(view.leases),
            "leases": {
                str(i): {
                    "replica": entry.get("replica"),
                    "epoch": entry.get("epoch"),
                    "expires_at": entry.get("expires_at"),
                }
                for i, entry in lease_items[:32]
            },
            "lease_epoch": view.lease_epoch,
            "grants": view.lease_grants,
            "renews": view.lease_renews,
            "expiries": view.lease_expiries,
            "revokes": view.lease_revokes,
            # filled from the live demand fold when the supervisor (or
            # status command) has one: how old the stalest replica's
            # demand-signal-<replica>.json is
            "stalest_demand_age_s": None,
        }
        if gateway_fleet:
            doc["gateway_fleet"].update(gateway_fleet)
    if telemetry is not None:
        doc["telemetry"] = telemetry
    return doc


def write_fleet_status(path: Path, status: dict) -> None:
    atomic_write_text(
        Path(path), json.dumps(status, indent=2, sort_keys=True) + "\n"
    )
