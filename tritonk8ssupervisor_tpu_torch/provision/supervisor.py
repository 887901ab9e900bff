"""Continuous supervisor: the resident reconcile loop.

Everything built so far — retry engine, DAG scheduler, journal/resume,
slice heal, warm cache — runs when a human types `./setup.sh provision`
or `./setup.sh heal`; a slice lost at 3am stayed lost until morning.
Podracer-style TPU orchestration (PAPERS.md, 2104.06272) assumes a
resident control loop that detects drift and repairs it autonomously.
This module is that loop, surfaced as `./setup.sh supervise`:

each tick it takes one shared `FleetSnapshot`, runs `heal.diagnose`
(TPU listing + per-slice SSH + drain files), and drives the fleet back
to spec through the existing slice-scoped heal path — governed by:

- a **flap filter**: a slice must be unhealthy for N consecutive
  snapshots (default 2) before it is heal-eligible, so one stale
  snapshot TTL window or transient SSH blip can never trigger a
  `terraform apply -replace`;
- **drain awareness**: a DRAINING slice (the maintenance watchdog's
  file is present — provision/maintenance.py) is *expected* downtime,
  never heal-eligible; it becomes eligible only when maintenance ends
  in a missing/unready slice;
- a per-slice **token-bucket rate limiter**: at most `heal_burst` heals
  per slice, refilling one token per `heal_refill_s` — a flapping slice
  cannot be terraform-replaced in a tight loop;
- a global **circuit breaker**: after `breaker_threshold` failed heals
  inside `breaker_window_s` it trips OPEN and the loop holds in
  degraded-hold (observing and reporting, not healing — the fleet runs
  on the healthy slices per `--max-degraded` semantics) for a cooldown
  that grows between consecutive trips with the retry engine's
  decorrelated-jitter formula (retry.Cooldown), then HALF-OPENs for one
  probe heal;
- **failure-domain isolation** (blast radius): slices are striped into
  failure domains (ClusterConfig.failure_domains); K-of-domain slices
  lost inside one window is classified a DOMAIN_OUTAGE — one correlated
  incident, not K independent faults — and heals into that domain are
  held behind a PER-DOMAIN breaker whose re-entry is gated by a single
  canary heal, while heal-eligible slices in healthy domains keep
  draining in waves. The global breaker survives as last resort above
  the domain breakers (it accrues domain trips and canary failures).
  Quota-parked listing pages (429 floor) defer non-urgent heals so the
  supervisor never deepens an API quota storm;
- a durable **event ledger** (provision/events.py): every observation,
  verdict change, heal attempt, rate-limit refusal, and breaker
  transition is fsync'd, and a restarted supervisor REPLAYS it — heal
  tokens already spent stay spent, the breaker stays tripped, and a
  kill mid-heal can never buy the fleet extra heals (no double-heal).

Every tick atomically rewrites `fleet-status.json` for external
scrapers; `./setup.sh status [--json]` renders the same document.
Deterministic under testing/simclock.py + testing/faults.py.

The port's copy of `tritonk8ssupervisor_tpu/provision/supervisor.py`,
whole and under the reference's names: the port imports nothing of the
JAX package. The same scripted world gives the same event ledger,
`fleet-status.json` and printed lines as the reference
(tests/test_torch_supervisor.py). It supervises gpu-vm deployments
too: the listing fold (`readiness.fold_listing`) signs a GPU slice by its
host VMs' statuses, and the slice-scoped heal and scale-down address its
host instances (`terraform.slice_addresses`); gke-gpu is refused as the
reference refuses gke.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import random
import signal
import threading
import time
from pathlib import Path
from typing import Callable

from tritonk8ssupervisor_tpu_torch import obs as obs_mod
from tritonk8ssupervisor_tpu_torch.config.schema import (
    VM_MODES,
    ClusterConfig,
    ConfigError,
)
from tritonk8ssupervisor_tpu_torch.provision import allocator as allocator_mod
from tritonk8ssupervisor_tpu_torch.provision import autoscale as autoscale_mod
from tritonk8ssupervisor_tpu_torch.provision import events as events_mod
from tritonk8ssupervisor_tpu_torch.provision import heal as heal_mod
from tritonk8ssupervisor_tpu_torch.provision import readiness
from tritonk8ssupervisor_tpu_torch.provision import retry
from tritonk8ssupervisor_tpu_torch.provision import runner as run_mod
from tritonk8ssupervisor_tpu_torch.provision.scheduler import Task, run_dag
from tritonk8ssupervisor_tpu_torch.provision.state import (
    LockHeldError,
    PidLock,
    RunPaths,
)


class SupervisorError(RuntimeError):
    """The supervisor cannot run (already running, bad mode, ...)."""


# ------------------------------------------------------------ rate limiter


class TokenBucket:
    """Per-slice heal budget: `capacity` tokens, one minted every
    `refill_seconds`. Clock-free — callers pass `now` — so the same
    arithmetic runs on wall time and on the virtual clock, and the
    ledger restore can replay consumption at recorded timestamps."""

    def __init__(self, capacity: int, refill_seconds: float) -> None:
        self.capacity = max(1, int(capacity))
        self.refill_seconds = max(0.0, float(refill_seconds))
        self.tokens = float(self.capacity)
        self.updated: float | None = None

    def _refill(self, now: float) -> None:
        if self.updated is None:
            self.updated = now
            return
        if self.refill_seconds <= 0:
            self.tokens = float(self.capacity)
        elif now > self.updated:
            self.tokens = min(
                float(self.capacity),
                self.tokens + (now - self.updated) / self.refill_seconds,
            )
        self.updated = max(self.updated, now)

    def try_take(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_at(self, now: float) -> float:
        """When the next token lands (== now when one is available)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return now
        return now + (1.0 - self.tokens) * self.refill_seconds

    def consume_at(self, ts: float) -> None:
        """Restore path: account a heal the LEDGER says happened at `ts`
        — refill up to then, then spend (floor 0, never negative)."""
        self._refill(ts)
        self.tokens = max(0.0, self.tokens - 1.0)


# ---------------------------------------------------------- circuit breaker

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Global heal circuit breaker: `threshold` failed heals inside
    `window_s` trip it OPEN; after a cooldown (retry.Cooldown — grows
    between consecutive trips, resets on recovery) it HALF-OPENs for one
    probe heal whose outcome closes or re-opens it.

    The failure window is a deque pruned from the left: `_prune` runs
    every recorded failure, and a list rebuild there made its cost grow
    with total history — at fleet scale (hundreds of heals on record)
    per-tick bookkeeping must stay O(events in window), never O(events
    ever). The perf pin lives in tests/test_supervisor.py."""

    def __init__(
        self,
        threshold: int,
        window_s: float,
        cooldown: retry.Cooldown,
    ) -> None:
        self.threshold = max(1, int(threshold))
        self.window_s = float(window_s)
        self.cooldown = cooldown
        self.state = CLOSED
        # failure timestamps inside the window, oldest first
        self.failures: collections.deque = collections.deque()
        self.reopen_at: float | None = None
        self.trips = 0

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self.failures and self.failures[0] <= cutoff:
            self.failures.popleft()

    def allow(self, now: float) -> bool:
        """May a heal run now? OPEN past its cooldown transitions to
        HALF-OPEN (one probe heal allowed); OPEN inside it refuses."""
        if self.state == OPEN:
            if self.reopen_at is not None and now >= self.reopen_at:
                self.state = HALF_OPEN
                return True
            return False
        return True

    def trip(self, now: float) -> float:
        """Force the breaker OPEN without a heal failure — the
        correlated-failure classifier's move: a DOMAIN_OUTAGE verdict
        opens the domain's breaker BEFORE any heal is stormed into the
        dead compartment. Returns the reopen (canary) time."""
        self.state = OPEN
        self.trips += 1
        self.reopen_at = now + self.cooldown.next()
        return self.reopen_at

    def record_failure(self, now: float) -> bool:
        """Returns True when this failure TRIPS the breaker (closed ->
        open on the Kth windowed failure, or half-open probe failed)."""
        self.failures.append(now)
        self._prune(now)
        if self.state == HALF_OPEN or (
            self.state == CLOSED and len(self.failures) >= self.threshold
        ):
            self.state = OPEN
            self.trips += 1
            self.reopen_at = now + self.cooldown.next()
            return True
        return False

    def record_success(self, now: float) -> bool:
        """Returns True when this success CLOSES a tripped breaker."""
        closed_it = self.state != CLOSED
        self.state = CLOSED
        self.failures.clear()
        self.reopen_at = None
        self.cooldown.reset()
        return closed_it


# ---------------------------------------------------------- job-ack watcher


class JobAckWatcher:
    """The supervisor's read side of the job<->supervisor contract.

    An elastic training job (parallel/elastic.py) acknowledges membership
    events by atomically rewriting job-ack.json: phase `notified` when it
    saw a generation bump or drain notice, `resumed` when it is stepping
    again, `degraded` when it gave up waiting and continues WITHOUT some
    slices. `observe()` folds phase transitions into the event ledger
    (job-notified / job-resumed / degraded-ack) exactly once — dedup is
    against the folded LedgerView, so a restarted supervisor does not
    re-record an acknowledgement it already ledgered. A missing or torn
    ack file is "no news", never an error: the job may simply not be an
    elastic one."""

    def __init__(self, path) -> None:
        self.path = Path(path)

    def read(self) -> dict | None:
        try:
            doc = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return None  # absent or torn: unknown, retry next tick
        return doc if isinstance(doc, dict) else None

    def observe(
        self,
        view: "events_mod.LedgerView",
        record: Callable[..., dict],
        now: float,
        say: Callable[[str], None] = lambda line: None,
    ) -> str | None:
        """Fold the current ack (if new) into the ledger via `record`
        (kind, **fields) and return the phase recorded, else None."""
        doc = self.read()
        if doc is None:
            return None
        phase = doc.get("phase")
        if phase not in ("notified", "resumed", "degraded"):
            return None  # heartbeat/unknown phases are not ledger events
        gen = doc.get("generation")
        step = doc.get("step")
        folded = "degraded" if view.job_phase == "degraded" else view.job_phase
        if (phase == folded and gen == view.job_generation
                and step == view.job_step):
            return None  # already on the ledger
        if phase == "notified":
            record(events_mod.JOB_NOTIFIED, generation=gen, step=step,
                   reason=str(doc.get("reason", ""))[:200])
            say(f"  job acknowledged membership change "
                f"(generation {gen}, step {step})")
            return phase
        mttr = (round(now - view.job_notified_ts, 3)
                if view.job_notified_ts is not None else None)
        slices = sorted(int(i) for i in doc.get("slices") or [])
        if phase == "degraded" and slices:
            record(events_mod.DEGRADED_ACK, slices=slices,
                   generation=gen, step=step)
            say(f"  job continues DEGRADED without slice(s) "
                f"{', '.join(str(i) for i in slices)}; suppressing heal "
                "for them until they read healthy again")
        record(events_mod.JOB_RESUMED, generation=gen, step=step,
               world=doc.get("world"), degraded=phase == "degraded",
               mttr_s=mttr)
        say(f"  job resumed training (generation {gen}, step {step}"
            + (f", job MTTR {mttr:.0f}s" if mttr is not None else "") + ")")
        return phase


# -------------------------------------------------------------- flap filter


class FlapFilter:
    """A slice is heal-eligible only after `threshold` CONSECUTIVE
    unhealthy snapshots (default 2): one stale FleetSnapshot TTL window
    or a transient SSH blip must never cost a `terraform apply
    -replace`. DRAINING is expected downtime (maintenance), so it
    neither builds a streak nor resets one: only missing/unready
    observations grow it, only a healthy observation clears it."""

    def __init__(self, threshold: int = 2) -> None:
        self.threshold = max(1, int(threshold))
        self.streaks: dict[int, int] = {}

    def observe(self, health: "heal_mod.FleetHealth") -> list[int]:
        """Update streaks from one diagnosis; return the heal-eligible
        slice indices (unhealthy, not draining, streak >= threshold).

        Cost is O(slices IN THIS DIAGNOSIS), and the streak dict only
        holds slices with a live streak (healthy observations remove the
        entry instead of zeroing it) — with the dirty-set reconcile
        passing a handful of changed slices per tick, a 256-slice fleet
        pays for its incidents, not its size."""
        eligible: list[int] = []
        for s in health.slices:
            if s.state == heal_mod.HEALTHY:
                self.streaks.pop(s.index, None)
            elif s.state == heal_mod.DRAINING:
                pass  # expected downtime: hold the streak, don't grow it
            else:
                streak = self.streaks.get(s.index, 0) + 1
                self.streaks[s.index] = streak
                if streak >= self.threshold:
                    eligible.append(s.index)
        return eligible


# ------------------------------------------------------------------ policy


@dataclasses.dataclass
class SupervisePolicy:
    """Knobs for the reconcile loop. Every field has a TK8S_SUPERVISE_*
    env override so a live drill can tune a running deployment's next
    start without a code change (same convention as TK8S_RETRY_*)."""

    interval: float = 30.0  # seconds between reconcile ticks
    flap_threshold: int = 2  # consecutive bad snapshots before heal
    heal_burst: int = 2  # token-bucket capacity per slice
    heal_refill_s: float = 600.0  # seconds to mint one heal token
    breaker_threshold: int = 3  # failed heals in window -> OPEN
    breaker_window_s: float = 1800.0
    breaker_cooldown_s: float = 300.0  # base cooldown (grows per trip)
    breaker_cooldown_cap_s: float = 3600.0
    max_degraded: int = 0  # N-of-M budget the hold verdict respects
    # ---- fleet-scale knobs (sharded reconcile, parallel heals) ----
    page_size: int = 64  # slices per FleetSnapshot listing page
    sweep_slices: int = 4  # slices re-diagnosed per tick beyond the
    # dirty set — silent drift (e.g. a drain file on a listing-READY
    # host) is caught within ceil(num_slices / sweep_slices) ticks
    heal_workers: int = 8  # parallel slice-scoped heals per wave
    compact_records: int = 20000  # ledger records before auto-compact
    # ---- blast-radius knobs (failure domains, quota deferral) ----
    domain_threshold: int = 3  # K-of-domain unhealthy in the window
    # => DOMAIN_OUTAGE: one correlated incident, not K independent
    # faults. 0 disables the classifier (per-domain breakers then trip
    # only on their own heal failures).
    domain_window_s: float = 300.0  # incident-start span that counts
    # as "correlated" — K losses spread over hours are K faults
    domain_cooldown_s: float = 300.0  # base hold before the canary
    # heal re-enters an outaged domain (grows per re-trip, capped by
    # breaker_cooldown_cap_s)
    quota_defer_cap_s: float = 900.0  # a quota-parked slice's heal is
    # deferred at most this long — past it the incident is old enough
    # that repair outweighs API pressure

    _ENV = {
        "interval": ("TK8S_SUPERVISE_INTERVAL", float),
        "flap_threshold": ("TK8S_SUPERVISE_FLAP_THRESHOLD", int),
        "heal_burst": ("TK8S_SUPERVISE_HEAL_BURST", int),
        "heal_refill_s": ("TK8S_SUPERVISE_HEAL_REFILL", float),
        "breaker_threshold": ("TK8S_SUPERVISE_BREAKER_THRESHOLD", int),
        "breaker_window_s": ("TK8S_SUPERVISE_BREAKER_WINDOW", float),
        "breaker_cooldown_s": ("TK8S_SUPERVISE_BREAKER_COOLDOWN", float),
        "breaker_cooldown_cap_s": ("TK8S_SUPERVISE_BREAKER_COOLDOWN_CAP",
                                   float),
        "page_size": ("TK8S_SUPERVISE_PAGE_SIZE", int),
        "sweep_slices": ("TK8S_SUPERVISE_SWEEP", int),
        "heal_workers": ("TK8S_SUPERVISE_HEAL_WORKERS", int),
        "compact_records": ("TK8S_SUPERVISE_COMPACT", int),
        "domain_threshold": ("TK8S_SUPERVISE_DOMAIN_THRESHOLD", int),
        "domain_window_s": ("TK8S_SUPERVISE_DOMAIN_WINDOW", float),
        "domain_cooldown_s": ("TK8S_SUPERVISE_DOMAIN_COOLDOWN", float),
        "quota_defer_cap_s": ("TK8S_SUPERVISE_QUOTA_DEFER_CAP", float),
    }

    @classmethod
    def from_env(cls, environ: dict | None = None) -> "SupervisePolicy":
        env = os.environ if environ is None else environ
        kwargs = {}
        for field, (name, cast) in cls._ENV.items():
            raw = env.get(name, "")
            if raw != "":
                kwargs[field] = cast(raw)
        return cls(**kwargs)


# ----------------------------------------------------------- actor hooks


class _NoHooks:
    """Default actor-lifecycle hooks: no-ops. The parallel heal dispatch
    brackets its worker threads with launch/begin/release so a virtual
    clock (testing/simclock.py — whose SimClock satisfies this protocol
    directly) can account for them; on the real wall clock nothing needs
    accounting."""

    def launch(self, *a, **k) -> None:
        pass

    def begin(self, *a, **k) -> None:
        pass

    def release(self, *a, **k) -> None:
        pass


_NO_HOOKS = _NoHooks()


# -------------------------------------------------------------- supervisor


class Supervisor:
    """The reconcile loop. One instance per run; `run()` holds the
    workdir's supervisor pid lock and loops `tick()` until the tick
    budget or a stop request. Injectable clock/sleep/rng make the loop a
    pure function of the scripted world under testing/simclock.py.

    Fleet-scale shape (Maple-style: many local reconcilers, one global
    policy): the tick cost scales with the number of CHANGED slices, not
    fleet size —

    - the fleet listing arrives in bounded pages
      (readiness.FleetSnapshot(page_size=), per-page TTL + 429 quota
      floor), and per-slice listing signatures from it drive a DIRTY
      SET: only slices whose listing changed, slices already known
      unhealthy, and a slow `sweep_slices`-per-tick rotation (bounding
      how long silent drift — a drain file on a listing-READY host —
      can hide) get the expensive SSH/drain diagnosis;
    - heal throughput scales with the heal budget, not 1: eligible
      slices are dispatched as INDEPENDENT slice-scoped heals in waves
      of `heal_workers` (scheduler.run_dag under the hood), each heal
      charged to its own token bucket and the shared breaker — a zone
      outage killing 32 slices converges in ceil(32/workers) heal
      times, not 32 serial ones;
    - the event ledger auto-compacts past `compact_records`
      (events.EventLedger.compact — fold-to-snapshot, resume invariants
      preserved), so a week-long run replays one record per slice, not
      millions.
    """

    def __init__(
        self,
        config: ClusterConfig,
        paths: RunPaths,
        prompter,
        run: run_mod.RunFn = run_mod.run_streaming,
        run_quiet: run_mod.RunFn = run_mod.run_capture,
        policy: SupervisePolicy | None = None,
        ssh_user: str = "",
        ssh_key: str = "",
        ledger: events_mod.EventLedger | None = None,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[], float] = random.random,
        timer=None,
        readiness_timeout: float = 900.0,
        heal_fn=heal_mod.heal,
        hooks=None,
        telemetry: "obs_mod.Telemetry | None" = None,
        autoscaler: "autoscale_mod.Autoscaler | None" = None,
        demand_path=None,
        scale_up_fn=None,
        scale_down_fn=None,
        allocator: "allocator_mod.Allocator | None" = None,
    ) -> None:
        if config.mode not in VM_MODES:
            raise ConfigError(
                "supervise drives the tpu-vm heal path; GKE node pools "
                "self-repair (auto_repair) — see docs/failure-modes.md"
            )
        self.config = config
        self.paths = paths
        self.prompter = prompter
        self._run = run
        self._run_quiet = run_quiet
        self.policy = policy or SupervisePolicy()
        self._ssh_user = ssh_user
        self._ssh_key = ssh_key
        self.ledger = ledger or events_mod.EventLedger(
            paths.events, clock=clock
        )
        self._clock = clock
        self._sleep = sleep
        self._timer = timer
        self._readiness_timeout = readiness_timeout
        self._heal_fn = heal_fn
        self._stop = False
        # the shared batched listing: ttl under the tick interval so every
        # tick observes fresh state, while the probes INSIDE one tick
        # (diagnose + any heal readiness) share a single fetch; paged so
        # a 256-slice fleet is bounded list calls per tick, never one
        # giant ask raced against API rate limits
        self.snapshot = readiness.FleetSnapshot(
            config, run_quiet=run_quiet,
            ttl=min(10.0, max(0.0, self.policy.interval / 2.0)),
            page_size=self.policy.page_size,
            clock=clock,  # quota parking must age on the LOOP's clock
        )
        self.flaps = FlapFilter(self.policy.flap_threshold)
        self.buckets: dict[int, TokenBucket] = {}
        self.breaker = CircuitBreaker(
            self.policy.breaker_threshold,
            self.policy.breaker_window_s,
            retry.Cooldown(self.policy.breaker_cooldown_s,
                           self.policy.breaker_cooldown_cap_s, rng=rng),
        )
        # ---- failure domains (blast-radius isolation) ----
        # slice -> domain from the config's striping; with a single
        # domain every per-domain mechanism is bypassed and the loop is
        # byte-for-byte the flat single-domain behavior.
        self._domains: dict[int, str] = config.domain_map()
        self._multi_domain = len(set(self._domains.values())) > 1
        self._rng = rng
        self.domain_breakers: dict[str, CircuitBreaker] = {}
        self._outage_active: dict[str, bool] = {}
        self._defer_logged: set = set()  # slices with a ledgered deferral
        self.ticks = 0
        self._heal_seq = 0
        self._last_states: dict[int, str] = {}
        self._incidents: dict[int, float] = {}  # slice -> first-bad ts
        self._view = events_mod.LedgerView()  # folded history (restored)
        self.job_ack = JobAckWatcher(paths.job_ack)
        self._suppress_logged: set = set()  # slices with a ledgered skip
        # ---- dirty-set reconcile state ----
        self._health_cache: dict[int, "heal_mod.SliceHealth"] = {}
        self._listing_sig: dict[int, str] = {}  # slice -> listing state
        self._sweep_cursor = 0  # round-robin full-sweep rotation
        self._hooks = hooks if hooks is not None else _NO_HOOKS
        # parallel heals run on worker threads: ledger folds, breaker,
        # flap/incident bookkeeping share one re-entrant lock
        self._mutex = threading.RLock()
        self._ledger_records = 0  # appended + replayed, for auto-compact
        # ---- demand-driven autoscaling (provision/autoscale.py) ----
        # The second controller in the reconcile loop. `_active` is the
        # slice set the fleet currently RUNS (diagnosis, heal, and
        # status all scope to it); with no autoscaler it is every
        # configured slice forever — byte-identical pre-autoscale
        # behavior. `_scale_open` mirrors the ledger's open SCALE_START
        # (the mid-scale crash signature restore() resumes from).
        self.autoscaler = autoscaler
        self._demand_path = (Path(demand_path) if demand_path is not None
                             else paths.demand_signal)
        self._scale_up_fn = scale_up_fn or self._default_scale_up
        self._scale_down_fn = scale_down_fn or self._default_scale_down
        self._active: set = set(range(config.num_slices))
        self._scale_drain: set = set()  # slices draining for scale-down
        self._scale_open: dict | None = None
        self._scale_seq = 0
        self._drain_wait_logged = False
        self.scale_breaker: CircuitBreaker | None = None
        if autoscaler is not None:
            ap = autoscaler.policy
            self.scale_breaker = CircuitBreaker(
                ap.breaker_threshold, ap.breaker_window_s,
                retry.Cooldown(ap.cooldown_s, ap.cooldown_cap_s, rng=rng),
            )
        # ---- train/serve co-scheduling (provision/allocator.py) ----
        # The third controller. Per-slice roles live in the folded
        # LedgerView (self._view.roles — _record keeps it live, restore
        # rebuilds it), so a restarted supervisor resumes the exact
        # role split its ledger recorded; `_handover_open` mirrors the
        # ledger's open PREEMPT_NOTICE (the mid-handover crash
        # signature restore() resumes under the SAME id).
        self.allocator = allocator
        self._handover_seq = 0
        self._ack_wait_logged = False
        self._alloc_drain_logged = False
        self._roles_seeded = False
        # ---- telemetry plane (obs/) ----
        # The registry is always real (the status telemetry block reads
        # it); spans and metrics.json snapshots flow when supervise_cmd
        # wires Telemetry.for_run. _record() mirrors heal/breaker
        # events into it, so the scrape surface can never disagree with
        # the ledger it was derived from.
        self.telemetry = telemetry or obs_mod.Telemetry.off(clock=clock)
        reg = self.telemetry.metrics
        self._tracer = self.telemetry.tracer
        self._c_ticks = reg.counter(
            "supervisor_ticks_total", "reconcile ticks run")
        self._h_tick = reg.histogram(
            "supervisor_tick_seconds", "wall time of one reconcile tick")
        self._g_last_tick = reg.gauge(
            "supervisor_last_tick_seconds",
            "duration of the most recent tick")
        self._g_dirty = reg.gauge(
            "supervisor_dirty_set_size",
            "slices given the expensive diagnosis this tick")
        self._c_heals = reg.counter(
            "supervisor_heals_total",
            "heal lifecycle events by result (start/done/failed/"
            "rate-limited/deferred/suppressed)")
        self._h_mttr = reg.histogram(
            "supervisor_heal_mttr_seconds",
            "per-slice incident-open to heal-done (the ledger's "
            "mttr_s samples)")
        self._g_breaker = reg.gauge(
            "supervisor_breaker_state",
            "0 closed / 1 half-open / 2 open, per domain "
            "(domain=global is the last-resort breaker)")
        self._c_outages = reg.counter(
            "supervisor_domain_outages_total",
            "correlated-failure classifications")
        self._c_scale = reg.counter(
            "supervisor_autoscale_decisions_total",
            "autoscale decision lifecycle by direction and result "
            "(decision/start/done/abort/held)")
        self._g_desired = reg.gauge(
            "supervisor_slices_desired",
            "the autoscaler's confirmed desired slice count")
        self._g_active = reg.gauge(
            "supervisor_slices_active",
            "slices currently active (serving + draining-for-scale)")
        self._g_scale_breaker = reg.gauge(
            "supervisor_scale_breaker_state",
            "scale-thrash breaker: 0 closed / 1 half-open / 2 open")
        self._c_alloc = reg.counter(
            "supervisor_alloc_events_total",
            "co-scheduling protocol lifecycle by direction and result "
            "(decision/notice/ack/forced/role-change)")
        self._g_training = reg.gauge(
            "supervisor_slices_training",
            "slices currently assigned the TRAINING role")
        self._g_transitioning = reg.gauge(
            "supervisor_slices_transitioning",
            "slices mid-handover between roles")
        self._last_tick_s: float | None = None

    # ----------------------------------------------------------- plumbing

    def _bucket(self, index: int) -> TokenBucket:
        if index not in self.buckets:
            self.buckets[index] = TokenBucket(
                self.policy.heal_burst, self.policy.heal_refill_s
            )
        return self.buckets[index]

    def _domain_breaker(self, name: str) -> CircuitBreaker:
        """The per-domain breaker (lazily created): same windowed-failure
        arithmetic as the global one, but its cooldown is the domain
        re-entry hold (domain_cooldown_s) and tripping it is what the
        DOMAIN_OUTAGE classifier does. The GLOBAL breaker stays the last
        resort above these: it accrues a failure only when a domain
        breaker trips (or a canary fails) — domains failing one by one
        across the fleet still freeze everything."""
        if name not in self.domain_breakers:
            self.domain_breakers[name] = CircuitBreaker(
                self.policy.breaker_threshold,
                self.policy.breaker_window_s,
                retry.Cooldown(self.policy.domain_cooldown_s,
                               self.policy.breaker_cooldown_cap_s,
                               rng=self._rng),
            )
        return self.domain_breakers[name]

    def _slice_domains(self, slices) -> list:
        """Sorted distinct failure domains of `slices` (multi-domain
        mode only — flat fleets tag nothing)."""
        if not self._multi_domain:
            return []
        return sorted({self._domains.get(int(i), "") for i in slices})

    def request_stop(self) -> None:
        self._stop = True

    _BREAKER_LEVEL = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

    def _record(self, kind: str, **fields) -> dict:
        """Append to the durable ledger AND fold into the live view —
        the status publish then costs O(view), not O(ledger): a
        week-long loop never re-reads its own history per tick.
        Serialised under the supervisor mutex: parallel heal workers
        record concurrently, and the fold is a mutation. Selected kinds
        mirror into the telemetry plane here, so the registry is
        derived from exactly the records the ledger holds."""
        with self._mutex:
            record = self.ledger.append(kind, **fields)
            events_mod.apply(self._view, record)
            self._ledger_records += 1
            self._mirror_telemetry(kind, record)
        return record

    def _mirror_telemetry(self, kind: str, record: dict) -> None:
        """Heal counters, MTTR samples, breaker-state gauges, and
        breaker-transition span events, keyed off the ledger record
        being appended (one mirror point — instrumentation can never
        drift from the flight recorder)."""
        ts = record.get("ts", 0.0)
        if kind == events_mod.HEAL_START:
            self._c_heals.inc(result="start")
        elif kind == events_mod.HEAL_DONE:
            self._c_heals.inc(result="done")
            for sample in record.get("mttr_s") or []:
                self._h_mttr.observe(float(sample))
        elif kind == events_mod.HEAL_FAILED:
            self._c_heals.inc(result="failed")
        elif kind == events_mod.RATE_LIMITED:
            self._c_heals.inc(result="rate-limited")
        elif kind == events_mod.HEAL_DEFERRED:
            self._c_heals.inc(result="deferred")
        elif kind == events_mod.HEAL_SUPPRESSED:
            self._c_heals.inc(result="suppressed")
        elif kind == events_mod.DOMAIN_OUTAGE:
            self._c_outages.inc()
            self._tracer.event("domain-outage", ts,
                               domain=record.get("domain", ""),
                               slices=record.get("slices"))
        elif kind == events_mod.SCALE_DECISION:
            self._c_scale.inc(direction=record.get("direction", ""),
                              result="decision")
            self._g_desired.set(float(record.get("to_count") or 0))
            self._tracer.event("scale-decision", ts,
                               direction=record.get("direction"),
                               from_count=record.get("from_count"),
                               to_count=record.get("to_count"),
                               reason=record.get("reason"))
        elif kind == events_mod.SCALE_START:
            self._c_scale.inc(direction=record.get("direction", ""),
                              result="start")
        elif kind == events_mod.SCALE_DONE:
            self._c_scale.inc(direction=record.get("direction", ""),
                              result="done")
            self._g_active.set(float(len(record.get("active") or [])))
        elif kind == events_mod.SCALE_ABORT:
            self._c_scale.inc(direction=record.get("direction", ""),
                              result="abort")
        elif kind == events_mod.SCALE_HELD:
            self._c_scale.inc(direction=record.get("direction", ""),
                              result="held")
        elif kind == events_mod.ALLOC_DECISION:
            self._c_alloc.inc(direction=record.get("direction", ""),
                              result="decision")
            self._tracer.event("alloc-decision", ts,
                               direction=record.get("direction"),
                               count=record.get("count"),
                               reason=record.get("reason"))
        elif kind == events_mod.PREEMPT_NOTICE:
            self._c_alloc.inc(direction=record.get("direction", ""),
                              result="notice")
            self._tracer.event("preempt-notice", ts,
                               id=record.get("id"),
                               direction=record.get("direction"),
                               slices=record.get("slices"))
        elif kind == events_mod.PREEMPT_ACK:
            self._c_alloc.inc(
                direction=record.get("direction", ""),
                result="forced" if record.get("forced") else "ack")
        elif kind == events_mod.ROLE_CHANGED:
            self._c_alloc.inc(direction=record.get("direction", ""),
                              result="role-change")
            self._tracer.event("role-changed", ts, id=record.get("id"),
                               role=record.get("role"),
                               slices=record.get("slices"))
            roles = self._view.roles
            self._g_training.set(float(sum(
                1 for r in roles.values()
                if r == allocator_mod.TRAINING)))
            self._g_transitioning.set(float(sum(
                1 for r in roles.values()
                if r == allocator_mod.TRANSITIONING)))
        elif kind in (events_mod.SCALE_BREAKER_OPEN,
                      events_mod.SCALE_BREAKER_HALF_OPEN,
                      events_mod.SCALE_BREAKER_CLOSE):
            state = {"open": OPEN, "half-open": HALF_OPEN,
                     "close": CLOSED}[kind.rsplit("-", 1)[-1]]
            self._g_scale_breaker.set(self._BREAKER_LEVEL[state])
            self._tracer.event("scale-breaker", ts, state=state)
        elif kind in (events_mod.BREAKER_OPEN,
                      events_mod.BREAKER_HALF_OPEN,
                      events_mod.BREAKER_CLOSE,
                      events_mod.DOMAIN_BREAKER_OPEN,
                      events_mod.DOMAIN_BREAKER_HALF_OPEN,
                      events_mod.DOMAIN_BREAKER_CLOSE):
            state = {"open": OPEN, "half-open": HALF_OPEN,
                     "close": CLOSED}[kind.rsplit("-", 1)[-1]]
            domain = record.get("domain") or "global"
            self._g_breaker.set(self._BREAKER_LEVEL[state],
                                domain=domain)
            self._tracer.event("breaker", ts, state=state,
                               domain=domain)

    def say(self, text: str) -> None:
        self.prompter.say(text)

    # ------------------------------------------------------------ restore

    def restore(self) -> events_mod.LedgerView:
        """Resume from the event ledger: heal tokens spent before the
        restart stay spent (heal-start timestamps replayed into the
        buckets — including ORPHANED starts, the kill-mid-heal crash
        signature, so a crash can never mint extra heals), the breaker's
        windowed failures and open/cooldown state survive, and counters
        continue instead of resetting. Slice streaks deliberately do NOT
        survive: a restarted supervisor must re-confirm unhealth with
        fresh snapshots before it replaces anything."""
        records = self.ledger.replay()
        self._ledger_records = len(records)
        view = events_mod.fold(records)
        for sv in view.slices.values():
            bucket = self._bucket(sv.index)
            for ts in sv.heal_starts:
                bucket.consume_at(ts)
        self.breaker.failures = collections.deque(view.breaker_failures)
        if view.breaker_state == OPEN:
            self.breaker.state = OPEN
            self.breaker.reopen_at = view.breaker_reopen_at
            self.breaker.trips = view.breaker_trips
        elif view.breaker_state == HALF_OPEN:
            # THE crash pin: killed while the half-open probe heal was in
            # flight (an orphaned heal-start on the ledger) must resume
            # OPEN — never CLOSED, and not HALF_OPEN either: HALF_OPEN
            # would hand the restart a SECOND probe while the first one's
            # outcome is unknown. The preserved reopen_at re-arms the
            # canary gate; a clean half-open (no orphan) resumes as-is.
            self.breaker.trips = view.breaker_trips
            if view.open_heals:
                self.breaker.state = OPEN
                self.breaker.reopen_at = (view.breaker_reopen_at
                                          if view.breaker_reopen_at
                                          is not None else view.last_ts)
            else:
                self.breaker.state = HALF_OPEN
        for name, dv in view.domains.items():
            br = self._domain_breaker(name)
            br.failures = collections.deque(dv.breaker_failures)
            br.trips = dv.breaker_trips
            orphaned_canary = any(
                r.get("canary") and r.get("domain") == name
                for r in view.open_heals
            )
            if dv.breaker_state == OPEN or (
                dv.breaker_state == HALF_OPEN and orphaned_canary
            ):
                br.state = OPEN  # same kill-mid-canary pin, per domain
                br.reopen_at = (dv.breaker_reopen_at
                                if dv.breaker_reopen_at is not None
                                else view.last_ts)
            elif dv.breaker_state == HALF_OPEN:
                br.state = HALF_OPEN
            if dv.outage_active:
                self._outage_active[name] = True
        # ---- autoscale resume: active set, open scale, breaker,
        # cooldown. An open SCALE_START is the mid-scale crash
        # signature: the restart RESUMES that scale (idempotent warm
        # re-provision, or the drain with its original deadline)
        # instead of deciding a new one — no double-provision, no
        # orphaned half-drained slice.
        if view.autoscale_active is not None:
            self._active = set(view.autoscale_active)
        if view.open_scale is not None and self.autoscaler is None:
            self.say(
                "WARNING: the ledger holds an unfinished scale "
                f"({view.open_scale.get('direction')} of slice(s) "
                f"{view.open_scale.get('slices')}) but this supervisor "
                "runs without --autoscale; restart with --autoscale to "
                "finish it, or repair by hand (./setup.sh heal / "
                "teardown)"
            )
        if view.open_scale is not None and self.autoscaler is not None:
            self._scale_open = dict(view.open_scale)
            if self._scale_open.get("direction") == autoscale_mod.DOWN:
                self._scale_drain = {
                    int(i) for i in self._scale_open.get("slices", [])
                }
            self.say(
                "resuming after a crash mid-scale "
                f"({self._scale_open.get('direction')} of slice(s) "
                f"{', '.join(str(i) for i in self._scale_open.get('slices', []))}): "
                "finishing that scale before any new decision"
            )
        if self.autoscaler is not None:
            if view.scale_cooldown_until is not None:
                self.autoscaler.cooldown_until = view.scale_cooldown_until
            br = self.scale_breaker
            br.failures = collections.deque(view.scale_breaker_failures)
            br.trips = view.scale_breaker_trips
            if view.scale_breaker_state == OPEN:
                br.state = OPEN
                br.reopen_at = (view.scale_breaker_reopen_at
                                if view.scale_breaker_reopen_at is not None
                                else view.last_ts)
            elif view.scale_breaker_state == HALF_OPEN:
                # killed mid-probe-action: resume OPEN, never a second
                # probe while the first one's outcome is unknown (the
                # global-breaker crash pin, applied to scaling)
                if view.open_scale is not None:
                    br.state = OPEN
                    br.reopen_at = (view.scale_breaker_reopen_at
                                    if view.scale_breaker_reopen_at
                                    is not None else view.last_ts)
                else:
                    br.state = HALF_OPEN
        # ---- allocation resume: roles live in the view itself; the
        # open PREEMPT_NOTICE is the mid-handover crash signature — the
        # restart RESUMES that handover under its original id (the
        # notice was already delivered; re-issuing a sibling would
        # double-open the trainer's checkpoint window and double-bump
        # the generation at close).
        if view.roles:
            self._roles_seeded = True
        if view.open_handover is not None and self.allocator is None:
            self.say(
                "WARNING: the ledger holds an unfinished role handover "
                f"({view.open_handover.get('direction')} of slice(s) "
                f"{view.open_handover.get('slices')}) but this "
                "supervisor runs without --allocate; restart with "
                "--allocate to finish it"
            )
        if view.open_handover is not None and self.allocator is not None:
            self.say(
                "resuming after a crash mid-handover "
                f"({view.open_handover.get('direction')} of slice(s) "
                f"{', '.join(str(i) for i in view.open_handover.get('slices', []))}): "
                "finishing that handover before any new decision"
            )
        if self.allocator is not None \
                and view.alloc_cooldown_until is not None:
            self.allocator.cooldown_until = view.alloc_cooldown_until
        self._view = view
        if view.open_heals:
            slices = sorted(
                {i for r in view.open_heals for i in r.get("slices", [])}
            )
            self.say(
                f"resuming after a crash mid-heal of slice(s) "
                f"{', '.join(str(i) for i in slices)}: those attempts "
                "stay charged against the rate limit; re-confirming "
                "fleet state before any new heal"
            )
        return view

    # --------------------------------------------------------------- tick

    def _dirty_set(self) -> list[int]:
        """The slices worth an expensive (SSH + drain) diagnosis this
        tick: slices whose LISTING signature changed since the last tick
        (the paged `tpu-vm list` is the cheap fleet-wide change
        detector), slices already known not-healthy (streaks must grow
        or clear on fresh evidence), never-diagnosed slices, plus the
        `sweep_slices`-per-tick round-robin rotation that bounds how
        long a listing-invisible drift (a drain file on a READY node)
        can stay unseen. At `num_slices <= sweep_slices` every slice is
        swept every tick — small fleets keep the full-sweep behavior exactly.

        Scoped to the ACTIVE slice set: a slice the autoscaler tore
        down is not missing, it is gone on purpose — diagnosing it
        would heal it straight back; a slice draining for scale-down is
        the supervisor's own doing and equally exempt. With no
        autoscaler every configured slice is active forever."""
        candidates = sorted(self._active - self._scale_drain)
        if not candidates:
            return []
        n = len(candidates)
        listing_sig: dict[int, str] | None = None
        try:
            folded = readiness.fold_listing(
                self.config, self.snapshot.states(), candidates)
            listing_sig = {i: v.signature for i, v in folded.items()}
        except Exception:  # noqa: BLE001 - listing down: SSH still decides
            pass  # keep the previous signatures; the sweep still rotates
        dirty: set[int] = set()
        for i in candidates:
            cached = self._health_cache.get(i)
            if cached is None or cached.state != heal_mod.HEALTHY:
                dirty.add(i)
            elif (listing_sig is not None
                  and listing_sig[i] != self._listing_sig.get(i, "")):
                dirty.add(i)
        for _ in range(min(max(1, self.policy.sweep_slices), n)):
            dirty.add(candidates[self._sweep_cursor % n])
            self._sweep_cursor = (self._sweep_cursor + 1) % n
        if listing_sig is not None:
            self._listing_sig = listing_sig
        return sorted(dirty)

    def tick(self) -> dict:
        """One reconcile pass: observe -> judge -> (maybe) heal ->
        publish status. Returns the observation summary.

        Incremental: only the dirty set (changed/unhealthy/swept slices)
        is diagnosed, the flap filter and incident bookkeeping fold just
        those observations, and the TICK record carries only the CHANGED
        states — per-tick cost and ledger growth track incidents, not
        fleet size."""
        now = self._clock()
        self.ticks += 1
        self.snapshot.invalidate()  # every tick sees fresh fleet state
        dirty = self._dirty_set()
        t_diag = self._clock()
        observed = heal_mod.diagnose(
            self.config, self.paths, run_quiet=self._run_quiet,
            ssh_user=self._ssh_user, ssh_key=self._ssh_key,
            snapshot=self.snapshot, only_slices=dirty,
        )
        self._tracer.emit("diagnose", t_diag, self._clock(),
                          tick=self.ticks, observed=len(dirty))
        for s in observed.slices:
            self._health_cache[s.index] = s
        health = heal_mod.FleetHealth(
            [self._health_cache[i] for i in sorted(self._health_cache)]
        )
        changed = {
            str(s.index): s.state for s in observed.slices
            if self._last_states.get(s.index) != s.state
        }
        self._record(events_mod.TICK, tick=self.ticks, states=changed,
                     observed=len(dirty))
        for s in observed.slices:
            if self._last_states.get(s.index) != s.state:
                self._record(
                    events_mod.VERDICT, slice=s.index, state=s.state,
                    detail=s.detail, domain=s.domain,
                    streak=self.flaps.streaks.get(s.index, 0),
                )
                if s.state == heal_mod.DRAINING:
                    # seen BEFORE the node disappears: expected downtime,
                    # logged, never healed
                    self._record(events_mod.MAINTENANCE,
                                       slice=s.index, detail=s.detail)
                    self.say(f"  slice {s.index} draining for maintenance "
                             f"({s.detail}); holding, not healing")
                self._last_states[s.index] = s.state
            # incident bookkeeping for MTTR: opened at the FIRST bad
            # observation, closed by a heal-done or a healthy observation
            if s.state == heal_mod.HEALTHY:
                self._incidents.pop(s.index, None)
                self._suppress_logged.discard(s.index)
                self._defer_logged.discard(s.index)
            else:
                self._incidents.setdefault(s.index, now)
        if self._multi_domain:
            self._settle_recovered_domains(now)

        # the training job's acknowledgement file, folded into the ledger
        # BEFORE the heal decision so a fresh degraded-continuation ack
        # suppresses this very tick's heal
        self.job_ack.observe(self._view, self._record, now, say=self.say)

        eligible = self.flaps.observe(observed)
        if self._view.acked_degraded:
            # the trainer already absorbed these losses as degraded
            # continuation (past its wait budget): healing them now would
            # fight the running job — a replaced slice bumps the
            # membership generation and forces ANOTHER resume. Leave them
            # quarantined until an operator heals by hand or the trainer
            # folds them back in.
            suppressed = [i for i in eligible
                          if i in self._view.acked_degraded]
            for i in suppressed:
                if i not in self._suppress_logged:
                    self._record(events_mod.HEAL_SUPPRESSED, slice=i)
                    self.say(
                        f"  slice {i}: heal suppressed — the job continues "
                        "degraded without it (degraded-ack on the ledger); "
                        "run `./setup.sh heal` to repair it by hand"
                    )
                    self._suppress_logged.add(i)
            eligible = [i for i in eligible
                        if i not in self._view.acked_degraded]
        summary = {
            "tick": self.ticks, "ts": now,
            "states": {str(s.index): s.state for s in health.slices},
            "observed": list(dirty),
            "eligible": list(eligible), "healed": [], "held": False,
        }
        if eligible:
            summary.update(self._reconcile(eligible, health, now))
        elif health.degraded:
            pending = [
                s.index for s in observed.slices
                if s.state not in (heal_mod.HEALTHY, heal_mod.DRAINING)
            ]
            if pending:
                self.say(
                    f"  slice(s) {', '.join(str(i) for i in pending)} "
                    "unhealthy; awaiting confirmation "
                    f"(flap threshold {self.policy.flap_threshold})"
                )
        # ONE demand-signal read per tick, shared by the second and
        # third controllers: two independent reads could land either
        # side of an atomic rewrite (a torn-read race) and the
        # autoscaler and allocator would act on DIFFERENT snapshots of
        # the same window — the single-read-per-tick pin lives in
        # tests/test_allocator.py.
        signal = None
        if self.autoscaler is not None or self.allocator is not None:
            # the fleet-aware read: with per-replica demand shards on
            # disk (serving/fleet.py) the N signals fold into ONE
            # merged view — per-replica staleness-guarded, so a dead
            # replica's last document neither freezes nor dilutes the
            # controllers; with no shards this is the single-gateway
            # read, byte-identical
            signal = autoscale_mod.read_fleet_demand(
                self._demand_path, now=now,
                max_age=(self.autoscaler.policy.signal_max_age_s
                         if self.autoscaler is not None
                         else autoscale_mod.FLEET_SIGNAL_MAX_AGE_S))
        # the second controller: demand signal -> desired slice count
        # -> scale execution, AFTER heal reconcile (repairs first —
        # scaling a broken fleet is how thrash starts) and BEFORE the
        # publish, so this tick's status already carries the verdict
        if self.autoscaler is not None:
            summary["autoscale"] = self._autoscale(now, signal)
        # the third controller: demand signal + training-job state ->
        # per-slice role assignment, after heal (repairs first) and
        # autoscale (capacity first, then who gets it)
        if self.allocator is not None:
            summary["allocation"] = self._allocate(now, signal)
        # tick telemetry BEFORE the publish, so the metrics snapshot
        # written next to fleet-status.json already includes this tick
        done = self._clock()
        self._last_tick_s = round(max(0.0, done - now), 6)
        self._c_ticks.inc()
        self._h_tick.observe(self._last_tick_s)
        self._g_last_tick.set(self._last_tick_s)
        self._g_dirty.set(len(dirty))
        self._tracer.emit("tick", now, done, tick=self.ticks,
                          observed=len(dirty),
                          eligible=len(summary["eligible"]),
                          healed=len(summary["healed"]))
        self._publish(now)
        return summary

    def _settle_recovered_domains(self, now: float) -> None:
        """End an outage EPISODE once its domain reads fully healthy
        again: the canary-gate lifted at breaker-close, but the episode
        flag lives until recovery — otherwise the still-unhealthy
        remainder of the domain would re-classify as a fresh outage
        every tick. A domain that recovered WITHOUT a canary (listing
        glitch cleared, operator healed by hand) also closes its
        breaker here instead of holding it armed forever."""
        for name in list(self._outage_active):
            bad = [
                i for i, s in self._health_cache.items()
                if self._domains.get(i) == name
                and s.state not in (heal_mod.HEALTHY, heal_mod.DRAINING)
            ]
            if bad:
                continue
            self._outage_active.pop(name, None)
            br = self.domain_breakers.get(name)
            if br is not None and br.record_success(now):
                self._record(events_mod.DOMAIN_BREAKER_CLOSE, domain=name,
                             recovered=True)
                self.say(f"  domain {name}: recovered without a canary; "
                         "breaker closed")
            self._record(events_mod.DOMAIN_RECOVERED, domain=name)
            self.say(f"  domain {name}: fully healthy — outage episode "
                     "over")

    def _defer_quota_parked(self, eligible: list, now: float,
                            out: dict) -> list:
        """Heals for slices whose listing page is quota-parked (429
        floor, stale-served) are DEFERRED: a heal is its own burst of
        API calls, and the evidence behind it is stale — dispatching it
        deepens the quota storm that parked the page. The deferral is
        bounded: past quota_defer_cap_s of incident age the repair
        outweighs the API pressure and the heal goes through."""
        parked = self.snapshot.parked_slices(now)
        if not parked:
            return eligible
        kept: list = []
        for index in eligible:
            age = now - self._incidents.get(index, now)
            if index in parked and age < self.policy.quota_defer_cap_s:
                if index not in self._defer_logged:
                    self._record(events_mod.HEAL_DEFERRED, slice=index,
                                 domain=self._domains.get(index, ""),
                                 incident_age_s=round(age, 3))
                    self.say(
                        f"  slice {index}: heal deferred — its listing "
                        "page is quota-parked (429 backoff); not adding "
                        "API load to a throttled API"
                    )
                    self._defer_logged.add(index)
                out["deferred"].append(index)
            else:
                kept.append(index)
        return kept

    def _classify_domains(self, now: float) -> None:
        """The correlated-failure classifier: K-of-domain slices whose
        incidents OPENED within domain_window_s of each other is one
        DOMAIN_OUTAGE, not K independent faults — policy switches from
        'heal each' to 'hold the domain behind its breaker, re-enter via
        one canary'. Runs on the raw health cache (not flap-confirmed):
        classification is a policy input and must beat the heal wave."""
        threshold = int(self.policy.domain_threshold)
        if threshold <= 0:
            return
        by_domain: dict[str, list[int]] = {}
        for i, s in self._health_cache.items():
            if s.state in (heal_mod.MISSING, heal_mod.UNREADY):
                by_domain.setdefault(
                    self._domains.get(i, ""), []
                ).append(i)
        for name, bad in by_domain.items():
            if self._outage_active.get(name) or len(bad) < threshold:
                continue
            opened = sorted(self._incidents.get(i, now) for i in bad)
            window = self.policy.domain_window_s
            correlated = any(
                opened[j + threshold - 1] - opened[j] <= window
                for j in range(len(opened) - threshold + 1)
            )
            if not correlated:
                continue
            self._outage_active[name] = True
            self._record(
                events_mod.DOMAIN_OUTAGE, domain=name, slices=sorted(bad),
                unhealthy=len(bad), threshold=threshold, window_s=window,
            )
            self.say(
                f"  DOMAIN OUTAGE: {len(bad)} slice(s) of domain {name} "
                f"lost within {window:.0f}s — correlated failure, "
                "holding heals into that domain behind its breaker"
            )
            br = self._domain_breaker(name)
            if br.state == CLOSED:
                br.trip(now)
                self._record(
                    events_mod.DOMAIN_BREAKER_OPEN, domain=name,
                    reopen_at=br.reopen_at, trip=br.trips,
                    classified=True,
                )
                self.say(
                    f"  domain {name} breaker OPEN (classified outage); "
                    f"canary heal at t={br.reopen_at:.0f}"
                )

    def _gate_domains(
        self, eligible: list, now: float, out: dict
    ) -> tuple[list, dict]:
        """Consult each eligible slice's DOMAIN breaker. Returns the
        slices allowed through plus {slice: domain} for the canaries —
        a domain past its hold gets EXACTLY one canary heal; its other
        slices stay held until the canary proves the domain takes
        repairs again. Healthy domains pass through untouched, so one
        dead compartment never starves the rest of the fleet."""
        allowed: list = []
        canaries: dict = {}
        grouped: dict[str, list] = {}
        for index in sorted(eligible):
            grouped.setdefault(self._domains.get(index, ""),
                               []).append(index)
        for name, slices in sorted(grouped.items()):
            br = self.domain_breakers.get(name)
            if br is None or br.state == CLOSED:
                allowed.extend(slices)
                continue
            if not br.allow(now):
                self._record(
                    events_mod.DEGRADED_HOLD, slices=slices, domain=name,
                    reopen_at=br.reopen_at,
                    max_degraded=self.policy.max_degraded,
                )
                self.say(
                    f"  domain {name} breaker OPEN: holding slice(s) "
                    f"{', '.join(str(i) for i in slices)} "
                    f"(canary at t={br.reopen_at:.0f})"
                )
                out["held"] = True
                continue
            # allow() flipped (or found) the breaker HALF_OPEN: one
            # canary re-enters; the rest keep their tokens and wait
            canary = slices[0]
            self._record(events_mod.DOMAIN_BREAKER_HALF_OPEN,
                         domain=name, slice=canary)
            self.say(f"  domain {name} breaker half-open: one canary "
                     f"heal (slice {canary})")
            allowed.append(canary)
            canaries[canary] = name
            rest = slices[1:]
            if rest:
                self._record(
                    events_mod.DEGRADED_HOLD, slices=rest, domain=name,
                    reopen_at=br.reopen_at,
                    max_degraded=self.policy.max_degraded,
                )
                out["held"] = True
        return allowed, canaries

    def _reconcile(self, eligible: list[int], health, now: float) -> dict:
        out: dict = {"healed": [], "held": False, "rate_limited": [],
                     "deferred": [], "canary": []}
        eligible = self._defer_quota_parked(sorted(eligible), now, out)
        canaries: dict = {}
        if self._multi_domain:
            self._classify_domains(now)
            eligible, canaries = self._gate_domains(eligible, now, out)
            out["canary"] = sorted(canaries)
        if not eligible:
            return out
        if not self.breaker.allow(now):
            self._record(
                events_mod.DEGRADED_HOLD, slices=sorted(eligible),
                reopen_at=self.breaker.reopen_at,
                max_degraded=self.policy.max_degraded,
            )
            over = len(eligible) > self.policy.max_degraded
            self.say(
                f"  breaker OPEN: holding degraded on slice(s) "
                f"{', '.join(str(i) for i in eligible)} "
                f"(retry at t={self.breaker.reopen_at:.0f}"
                f"{'; OVER --max-degraded budget' if over else ''})"
            )
            out["held"] = True
            return out
        if self.breaker.state == HALF_OPEN:
            self._record(events_mod.BREAKER_HALF_OPEN,
                               slices=sorted(eligible))
            self.say("  breaker half-open: one probe heal")
            # one probe decides the breaker; the rest of the eligible
            # set keeps its tokens for the post-probe tick
            eligible = sorted(eligible)[:1]
        to_heal: list[int] = []
        for index in sorted(eligible):
            if self._bucket(index).try_take(now):
                to_heal.append(index)
            else:
                retry_at = self._bucket(index).retry_at(now)
                self._record(events_mod.RATE_LIMITED, slice=index,
                                   retry_at=retry_at)
                self.say(
                    f"  slice {index}: heal rate-limited "
                    f"(burst {self.policy.heal_burst} per "
                    f"{self.policy.heal_refill_s:.0f}s; next token at "
                    f"t={retry_at:.0f})"
                )
                out["rate_limited"].append(index)
        if to_heal:
            canaries = {i: d for i, d in canaries.items() if i in to_heal}
            out["healed"] = self._dispatch_heals(to_heal, health, now,
                                                 canaries=canaries)
        return out

    def _dispatch_heals(
        self, slices: list[int], health, now: float,
        canaries: dict | None = None,
    ) -> list[int]:
        """Order the heals: one slice-scoped heal per slice, dispatched
        in waves of `heal_workers` concurrent workers (scheduler.run_dag
        under the actor hooks, so the simclock drills stay
        deterministic) — a zone outage killing K slices converges in
        ceil(K / heal_workers) heal times, not K serial ones. Each heal
        was already charged to its own token bucket; the shared breaker
        is consulted between waves, so a storm of failures stops the
        NEXT wave (in-flight heals finish — they are real repairs, not
        retries). `heal_workers <= 1` keeps the serial single combined
        heal order (one terraform apply covering every slice). A
        HALF-OPEN breaker dispatches exactly one probe heal."""
        canaries = canaries or {}
        order = sorted(slices)
        if self.breaker.state == HALF_OPEN:
            order = order[:1]  # one probe heal decides the breaker
        if len(order) == 1 or self.policy.heal_workers <= 1:
            ok = self._heal(order, health, now,
                            canary_domain=canaries.get(order[0])
                            if len(order) == 1 else None)
            return order if ok else []
        healed: list[int] = []
        width = max(1, int(self.policy.heal_workers))
        for start in range(0, len(order), width):
            wave = order[start:start + width]
            wave_now = self._clock()
            if start > 0 and not self.breaker.allow(wave_now):
                remaining = order[start:]
                self._record(
                    events_mod.DEGRADED_HOLD, slices=remaining,
                    reopen_at=self.breaker.reopen_at,
                    max_degraded=self.policy.max_degraded,
                )
                self.say(
                    f"  breaker OPEN mid-dispatch: holding degraded on "
                    f"slice(s) {', '.join(str(i) for i in remaining)}"
                )
                break

            def make(index: int):
                def fn(_results: dict):
                    self._hooks.begin()
                    return (index,
                            self._heal([index], health, self._clock(),
                                       canary_domain=canaries.get(index)))
                return fn

            tasks = [Task(f"heal-slice-{i}", make(i)) for i in wave]
            # the supervisor's own actor slot is released while it waits
            # on the wave — on the virtual clock, time may only advance
            # once every in-flight heal is asleep
            self._hooks.release()
            try:
                results = run_dag(
                    tasks, max_workers=len(wave),
                    on_submit=self._hooks.launch,
                    on_settled=self._hooks.release,
                    echo=lambda line: None,
                )
            finally:
                self._hooks.begin()
            self._tracer.emit("heal-wave", wave_now, self._clock(),
                              wave=start // width, slices=list(wave))
            healed.extend(i for i, ok in results.values() if ok)
        return sorted(healed)

    def _heal(self, slices: list[int], health, now: float,
              canary_domain: str | None = None) -> bool:
        """One heal order through the existing slice-scoped path. The
        heal-start record is fsync'd BEFORE any repair runs: a kill
        anywhere inside leaves the attempt on the ledger (spent token on
        resume — no double-heal; an orphaned CANARY start resumes the
        domain breaker OPEN). Safe to run from parallel heal workers:
        bookkeeping (ledger folds, breakers, streaks, incidents) is
        serialised under the supervisor mutex while the repair itself
        runs unlocked."""
        domains = self._slice_domains(slices)
        extra = {"domains": domains} if domains else {}
        if canary_domain:
            extra.update(canary=True, domain=canary_domain)
        with self._mutex:
            self._heal_seq += 1
            heal_id = f"heal-{int(now)}-{self._heal_seq}"
            self._record(events_mod.HEAL_START, id=heal_id,
                         slices=sorted(slices), attempt=self._heal_seq,
                         **extra)
        started = self._clock()
        phase = (self._timer.phase("supervise-heal")
                 if self._timer is not None else contextlib.nullcontext())
        try:
            with phase:
                self._heal_fn(
                    self.config, self.paths, self.prompter,
                    run=self._run, run_quiet=self._run_quiet,
                    ssh_key=self._ssh_key, ssh_user=self._ssh_user,
                    max_degraded=0,
                    readiness_timeout=self._readiness_timeout,
                    sleep=self._sleep, clock=self._clock,
                    health=health, only_slices=slices,
                )
        except Exception as e:  # noqa: BLE001 - a BaseException (SIGKILL
            # stand-in, KeyboardInterrupt) must sail through UNrecorded:
            # the orphaned heal-start IS the crash signature resume reads.
            done = self._clock()
            self._tracer.emit("heal", started, done, id=heal_id,
                              slices=sorted(slices), ok=False,
                              canary=bool(canary_domain))
            with self._mutex:
                self._record(
                    events_mod.HEAL_FAILED, id=heal_id,
                    slices=sorted(slices),
                    seconds=round(done - started, 3), error=str(e)[:500],
                    **extra,
                )
                self.say(f"  heal of slice(s) "
                         f"{', '.join(str(i) for i in slices)} FAILED: {e}")
                # Breaker hierarchy: multi-domain fleets charge the
                # failure to the slice's DOMAIN breaker first; the
                # GLOBAL breaker (last resort) accrues one failure only
                # when a domain breaker trips or a canary fails — so one
                # struggling domain stops ITS heals, while domains
                # failing across the fleet still freeze everything.
                # Flat fleets feed the global breaker directly (the
                # pre-domain behavior, exactly).
                feed_global = not domains
                for name in domains:
                    br = self._domain_breaker(name)
                    if br.record_failure(done):
                        feed_global = True
                        self._record(
                            events_mod.DOMAIN_BREAKER_OPEN, domain=name,
                            failures=len(br.failures),
                            reopen_at=br.reopen_at, trip=br.trips,
                        )
                        self.say(
                            f"  domain {name} breaker OPEN (trip "
                            f"{br.trips}); canary at t={br.reopen_at:.0f}"
                        )
                if feed_global and self.breaker.record_failure(done):
                    self._record(
                        events_mod.BREAKER_OPEN,
                        failures=len(self.breaker.failures),
                        window_s=self.policy.breaker_window_s,
                        reopen_at=self.breaker.reopen_at,
                        trip=self.breaker.trips,
                    )
                    self.say(
                        f"  circuit breaker OPEN (trip "
                        f"{self.breaker.trips}: "
                        f"{len(self.breaker.failures)} failed heal(s) in "
                        f"{self.policy.breaker_window_s:.0f}s); "
                        "degraded-hold "
                        f"until t={self.breaker.reopen_at:.0f}"
                    )
            return False
        done = self._clock()
        self._tracer.emit("heal", started, done, id=heal_id,
                          slices=sorted(slices), ok=True,
                          canary=bool(canary_domain))
        with self._mutex:
            mttr = [round(done - self._incidents.get(i, now), 3)
                    for i in sorted(slices)]
            for i in slices:
                self._incidents.pop(i, None)
                # healed: demand fresh evidence before any further heal
                self.flaps.streaks.pop(i, None)
            self._record(
                events_mod.HEAL_DONE, id=heal_id, slices=sorted(slices),
                seconds=round(done - started, 3), mttr_s=mttr,
                **extra,
            )
            for name in domains:
                br = self.domain_breakers.get(name)
                if br is not None and br.record_success(done):
                    # the EPISODE flag (_outage_active) deliberately
                    # stays set until the whole domain reads healthy
                    # (_settle_recovered_domains) — only the gate lifts
                    self._record(events_mod.DOMAIN_BREAKER_CLOSE,
                                 domain=name,
                                 canary=bool(canary_domain == name))
                    self.say(
                        f"  domain {name} breaker closed "
                        + ("(canary heal succeeded — re-entering the "
                           "domain)" if canary_domain == name
                           else "(heal succeeded)")
                    )
            if self.breaker.record_success(done):
                self._record(events_mod.BREAKER_CLOSE)
                self.say("  circuit breaker closed (heal succeeded)")
        return True

    def _maybe_compact(self) -> None:
        """Fold the event ledger to one snapshot record once it crosses
        `compact_records` (between ticks — no heal in flight). A tick
        appends O(changed slices) records, so a quiet week stays under
        the threshold; an eventful one compacts instead of growing a
        restart's replay without bound. The live view IS the fold, so
        compaction costs one replay-free rewrite."""
        limit = int(self.policy.compact_records)
        if limit <= 0 or self._ledger_records < limit:
            return
        with self._mutex:
            dropped = self.ledger.compact(view=self._view)
            self._ledger_records = 1
        if dropped:
            self.say(
                f"  event ledger compacted: {dropped + 1} records -> "
                "1 snapshot (restart-resume state preserved)"
            )

    # ---------------------------------------------------------- autoscale

    def _default_scale_up(self, slices: list[int]) -> None:
        """Scale-up executor: the existing warm incremental-provision
        path. A scaled-down slice reads `missing` to the heal
        machinery, and a slice-scoped heal IS its re-provision —
        terraform `-replace=` scoped to exactly these slices, ansible
        `--limit`, scoped readiness — which the content-addressed
        converge cache makes a ~30 s warm no-op for unchanged roles."""
        self._heal_fn(
            self.config, self.paths, self.prompter,
            run=self._run, run_quiet=self._run_quiet,
            ssh_key=self._ssh_key, ssh_user=self._ssh_user,
            max_degraded=0,
            readiness_timeout=self._readiness_timeout,
            sleep=self._sleep, clock=self._clock,
            only_slices=sorted(slices),
        )

    def _default_scale_down(self, slices: list[int]) -> None:
        """Scale-down executor: teardown scoped to exactly the drained
        slices (terraform destroy -target=...), never the deployment."""
        from tritonk8ssupervisor_tpu_torch.provision import terraform as tf_mod

        tf_mod.destroy_slices(self.config, self.paths, sorted(slices),
                              run=self._run)

    def _scale_breaker_allow(self, now: float) -> bool:
        br = self.scale_breaker
        was_open = br.state == OPEN
        allowed = br.allow(now)
        if allowed and was_open and br.state == HALF_OPEN:
            self._record(events_mod.SCALE_BREAKER_HALF_OPEN)
            self.say("  scale breaker half-open: one probe scale action")
        return allowed

    def _scale_failure(self, now: float) -> None:
        br = self.scale_breaker
        if br.record_failure(now):
            self._record(events_mod.SCALE_BREAKER_OPEN,
                         failures=len(br.failures),
                         reopen_at=br.reopen_at, trip=br.trips)
            self.say(
                f"  scale-thrash breaker OPEN (trip {br.trips}: "
                f"{len(br.failures)} failed/aborted scale action(s)); "
                f"no scaling until t={br.reopen_at:.0f}"
            )

    def _scale_success(self, now: float) -> None:
        if self.scale_breaker.record_success(now):
            self._record(events_mod.SCALE_BREAKER_CLOSE)
            self.say("  scale-thrash breaker closed (scale landed)")

    def _autoscale(self, now: float,
                   signal: "autoscale_mod.DemandSignal | None") -> dict:
        """One autoscale window: finish any scale already in flight
        (an open SCALE_START — possibly inherited from a crash — is
        ALWAYS resumed before any new decision, so capacity changes are
        strictly serialised), else fold the demand signal through the
        hysteresis and execute a confirmed decision behind the
        thrash breaker. `signal` is the tick's ONE shared demand read."""
        out: dict = {"decision": None, "action": None}
        if self._scale_open is not None:
            self._progress_open_scale(now, out, signal)
            self._g_active.set(float(len(self._active)))
            return out
        decision = self.autoscaler.observe(signal, len(self._active), now)
        self._g_active.set(float(len(self._active)))
        if decision is None:
            return out
        out["decision"] = dataclasses.asdict(decision)
        self._record(
            events_mod.SCALE_DECISION,
            direction=decision.direction,
            from_count=decision.from_count,
            to_count=decision.to_count,
            reason=decision.reason[:200],
            windows=decision.windows,
            signal_age_s=decision.signal_age_s,
            queue_depth=signal.queue_depth,
            recent_sheds=signal.recent_sheds,
            p99_s=signal.p99_s,
        )
        self.say(
            f"  autoscale: scale {decision.direction} "
            f"{decision.from_count} -> {decision.to_count} "
            f"({decision.reason}; confirmed {decision.windows} window(s))"
        )
        if not self._scale_breaker_allow(now):
            self._record(events_mod.SCALE_HELD,
                         direction=decision.direction,
                         reopen_at=self.scale_breaker.reopen_at)
            self.say(
                f"  scale-thrash breaker OPEN: decision held "
                f"(retry at t={self.scale_breaker.reopen_at:.0f})"
            )
            out["action"] = "held"
            return out
        if decision.direction == autoscale_mod.UP:
            out["action"] = self._begin_scale_up(decision, now)
        else:
            out["action"] = self._begin_scale_down(decision, now)
        return out

    def _begin_scale_up(self, decision, now: float) -> str | None:
        want = decision.to_count - decision.from_count
        slices = sorted(
            set(range(self.config.num_slices)) - self._active
        )[:want]
        if not slices:
            return None  # envelope exhausted: nothing left to provision
        cooldown_until = self.autoscaler.note_action(now)
        self._scale_seq += 1
        scale_id = f"scale-{int(now)}-{self._scale_seq}"
        # the SCALE_START is fsync'd BEFORE any provisioning runs: a
        # kill anywhere inside leaves the open scale on the ledger, and
        # the restart resumes THIS scale instead of minting another
        self._scale_open = self._record(
            events_mod.SCALE_START, id=scale_id,
            direction=autoscale_mod.UP, slices=slices,
            cooldown_until=cooldown_until,
        )
        self.say(
            f"  scale-up: provisioning slice(s) "
            f"{', '.join(str(i) for i in slices)} via the warm "
            "incremental path"
        )
        return self._execute_scale_up(now)

    def _execute_scale_up(self, now: float) -> str:
        """Run (or, after a crash, RE-run — the warm path is
        idempotent) the open scale-up's provisioning."""
        record = self._scale_open
        slices = sorted(int(i) for i in record.get("slices", []))
        started = self._clock()
        try:
            self._scale_up_fn(slices)
        except Exception as e:  # noqa: BLE001 - BaseException (SIGKILL
            # stand-in) must sail through UNrecorded: the open
            # SCALE_START is the crash signature resume reads.
            done = self._clock()
            self._tracer.emit("scale-wave", started, done,
                              id=record.get("id"), direction="up",
                              slices=slices, ok=False)
            self._record(events_mod.SCALE_ABORT, id=record.get("id"),
                         direction=autoscale_mod.UP, slices=slices,
                         seconds=round(done - started, 3),
                         error=str(e)[:500])
            self.say(
                f"  scale-up of slice(s) "
                f"{', '.join(str(i) for i in slices)} FAILED: {e}"
            )
            self._scale_open = None
            self._scale_failure(done)
            return "aborted"
        done = self._clock()
        self._tracer.emit("scale-wave", started, done,
                          id=record.get("id"), direction="up",
                          slices=slices, ok=True)
        self._active.update(slices)
        for i in slices:
            # fresh capacity must earn fresh verdicts: no stale
            # bookkeeping from the slice's previous life
            self._health_cache.pop(i, None)
            self._last_states.pop(i, None)
            self._incidents.pop(i, None)
            self.flaps.streaks.pop(i, None)
        self._record(events_mod.SCALE_DONE, id=record.get("id"),
                     direction=autoscale_mod.UP, slices=slices,
                     seconds=round(done - started, 3),
                     active=sorted(self._active))
        self._scale_open = None
        self._scale_success(done)
        self.autoscaler.note_done()
        self.say(
            f"  scale-up complete: slice(s) "
            f"{', '.join(str(i) for i in slices)} serving "
            f"({len(self._active)} active)"
        )
        return "scaled-up"

    def _begin_scale_down(self, decision, now: float) -> str:
        count = max(1, decision.from_count - decision.to_count)
        # drain the highest-index active slices: deterministic, and the
        # low indices hold the coordinator/anchor roles
        slices = sorted(sorted(self._active, reverse=True)[:count])
        cooldown_until = self.autoscaler.note_action(now)
        self._scale_seq += 1
        scale_id = f"scale-{int(now)}-{self._scale_seq}"
        deadline = now + self.autoscaler.policy.drain_timeout_s
        self._scale_open = self._record(
            events_mod.SCALE_START, id=scale_id,
            direction=autoscale_mod.DOWN, slices=slices,
            drain_deadline=deadline, cooldown_until=cooldown_until,
        )
        self._scale_drain = set(slices)
        self._drain_wait_logged = False
        self.say(
            f"  scale-down: draining slice(s) "
            f"{', '.join(str(i) for i in slices)} — the Router stops "
            f"pulling; teardown when in-flight settles "
            f"(deadline t={deadline:.0f})"
        )
        return "draining"

    def _progress_open_scale(self, now: float, out: dict,
                             signal=None) -> None:
        record = self._scale_open
        if record.get("direction") == autoscale_mod.UP:
            out["action"] = self._execute_scale_up(now)
            return
        slices = sorted(int(i) for i in record.get("slices", []))
        fresh = self.autoscaler.fresh(signal, now)
        serving = max(1, len(self._active) - len(slices))
        surge = (self.autoscaler.up_reason(signal, serving)
                 if fresh else None)
        if surge is not None:
            # a burst landed DURING the scale-down: aborting the drain
            # is cheap (the slices never left service) and honest —
            # finishing the teardown just to re-provision next window
            # is the thrash the breaker exists to stop, so the abort
            # also counts as its failure evidence.
            self._record(events_mod.SCALE_ABORT, id=record.get("id"),
                         direction=autoscale_mod.DOWN, slices=slices,
                         reason=f"demand rose mid-drain: {surge}"[:200])
            self.say(
                f"  scale-down ABORTED: demand rose mid-drain ({surge});"
                f" slice(s) {', '.join(str(i) for i in slices)} return "
                "to service"
            )
            self._scale_open = None
            self._scale_drain.clear()
            self._drain_wait_logged = False
            self._scale_failure(now)
            out["action"] = "drain-aborted"
            return
        settled = fresh and signal.inflight_on(slices) == 0
        deadline = record.get("drain_deadline")
        if not settled and (deadline is None or now < deadline):
            if not self._drain_wait_logged:
                inflight = (signal.inflight_on(slices)
                            if fresh else "unknown")
                self.say(
                    f"  scale-down: waiting for slice(s) "
                    f"{', '.join(str(i) for i in slices)} to drain "
                    f"({inflight} in flight)"
                )
                self._drain_wait_logged = True
            out["action"] = "draining"
            return
        stragglers = signal.inflight_on(slices) if fresh else None
        out["action"] = self._finalize_scale_down(record, slices,
                                                  stragglers, now)

    def _finalize_scale_down(self, record: dict, slices: list[int],
                             stragglers, now: float) -> str:
        started = self._clock()
        try:
            self._scale_down_fn(slices)
        except Exception as e:  # noqa: BLE001 - same crash discipline
            done = self._clock()
            self._tracer.emit("scale-wave", started, done,
                              id=record.get("id"), direction="down",
                              slices=slices, ok=False)
            self._record(events_mod.SCALE_ABORT, id=record.get("id"),
                         direction=autoscale_mod.DOWN, slices=slices,
                         seconds=round(done - started, 3),
                         error=str(e)[:500])
            self.say(
                f"  scale-down teardown of slice(s) "
                f"{', '.join(str(i) for i in slices)} FAILED: {e}"
            )
            self._scale_open = None
            self._scale_drain.clear()
            self._drain_wait_logged = False
            self._scale_failure(done)
            return "aborted"
        done = self._clock()
        self._tracer.emit("scale-wave", started, done,
                          id=record.get("id"), direction="down",
                          slices=slices, ok=True)
        self._active.difference_update(slices)
        for i in slices:
            self._health_cache.pop(i, None)
            self._last_states.pop(i, None)
            self._incidents.pop(i, None)
            self.flaps.streaks.pop(i, None)
            self._suppress_logged.discard(i)
            self._defer_logged.discard(i)
        self._record(events_mod.SCALE_DONE, id=record.get("id"),
                     direction=autoscale_mod.DOWN, slices=slices,
                     seconds=round(done - started, 3),
                     stragglers=stragglers,
                     active=sorted(self._active))
        self._scale_open = None
        self._scale_drain.clear()
        self._drain_wait_logged = False
        self._scale_success(done)
        self.autoscaler.note_done()
        extra = (f"; {stragglers} straggler(s) requeue via the "
                 "membership bump" if stragglers else "")
        self.say(
            f"  scale-down complete: slice(s) "
            f"{', '.join(str(i) for i in slices)} torn down "
            f"({len(self._active)} active{extra})"
        )
        return "scaled-down"

    # ----------------------------------------------------- co-scheduling

    def _role_lists(self) -> tuple[list[int], list[int]]:
        """(serving, training) slice lists from the folded role map,
        scoped to the active set. Slices without a role entry are
        SERVING (the pre-allocation default); slices draining for
        scale-down are neither."""
        roles = self._view.roles
        candidates = sorted(self._active - self._scale_drain)
        serving = [i for i in candidates
                   if roles.get(i, allocator_mod.SERVING)
                   == allocator_mod.SERVING]
        training = [i for i in candidates
                    if roles.get(i) == allocator_mod.TRAINING]
        return serving, training

    def _allocate(self, now: float,
                  signal: "autoscale_mod.DemandSignal | None") -> dict:
        """One co-scheduling window: seed the initial role split on the
        first tick, finish any handover already in flight (an open
        PREEMPT_NOTICE — possibly inherited from a crash — is ALWAYS
        resumed before any new decision, under its original id), else
        fold the demand signal into a confirmed role reassignment and
        open the preemption protocol."""
        out: dict = {"decision": None, "action": None}
        if not self._roles_seeded:
            self._roles_seeded = True
            initial = self.allocator.initial_training(
                sorted(self._active))
            if initial:
                self._record(
                    events_mod.ROLE_CHANGED, id="alloc-initial",
                    slices=initial, role=allocator_mod.TRAINING,
                    initial=True,
                )
                self.say(
                    f"  allocation: slice(s) "
                    f"{', '.join(str(i) for i in initial)} start as the "
                    "training world"
                )
        if self._view.open_handover is not None:
            out["action"] = self._progress_handover(now, signal)
            return out
        serving, training = self._role_lists()
        decision = self.allocator.observe(
            signal, len(serving), len(training), now
        )
        if decision is None:
            return out
        out["decision"] = dataclasses.asdict(decision)
        self._record(
            events_mod.ALLOC_DECISION,
            direction=decision.direction,
            count=decision.count,
            reason=decision.reason[:200],
            windows=decision.windows,
            signal_age_s=decision.signal_age_s,
            queue_depth=signal.queue_depth,
            recent_sheds=signal.recent_sheds,
            p99_s=signal.p99_s,
            serving=len(serving), training=len(training),
        )
        self.say(
            f"  allocation: {decision.direction} x{decision.count} "
            f"({decision.reason}; confirmed {decision.windows} window(s))"
        )
        cooldown_until = self.allocator.note_action(now)
        self._handover_seq += 1
        handover_id = f"handover-{int(now)}-{self._handover_seq}"
        self._ack_wait_logged = False
        self._alloc_drain_logged = False
        if decision.direction == allocator_mod.TO_SERVING:
            # reclaim the highest-index training slices; the PREEMPT
            # NOTICE is fsync'd BEFORE anything else moves — a kill
            # anywhere after leaves the open handover on the ledger
            # and the restart resumes THIS one, never a sibling
            slices = sorted(training)[len(training) - decision.count:]
            deadline = now + self.allocator.policy.ack_timeout_s
            self._record(
                events_mod.PREEMPT_NOTICE, id=handover_id,
                direction=decision.direction, slices=slices,
                ack_deadline=deadline, cooldown_until=cooldown_until,
            )
            self.say(
                f"  preempting training slice(s) "
                f"{', '.join(str(i) for i in slices)}: drain-notice "
                f"checkpoint window open (job-ack deadline "
                f"t={deadline:.0f})"
            )
            out["action"] = "notified"
        else:
            # lend the highest-index serving slices (the low indices
            # hold the coordinator/anchor roles); the Router drains
            # them first — finish in-flight, pull nothing new
            slices = sorted(sorted(serving, reverse=True)
                            [:decision.count])
            deadline = now + self.allocator.policy.drain_timeout_s
            self._record(
                events_mod.PREEMPT_NOTICE, id=handover_id,
                direction=decision.direction, slices=slices,
                drain_deadline=deadline, cooldown_until=cooldown_until,
            )
            self.say(
                f"  lending slice(s) {', '.join(str(i) for i in slices)} "
                f"to training: the Router drains first (deadline "
                f"t={deadline:.0f})"
            )
            out["action"] = "draining"
        return out

    def _progress_handover(
        self, now: float,
        signal: "autoscale_mod.DemandSignal | None",
    ) -> str:
        """Advance the open handover one window. to-serving: wait for
        the trainer's job-ack (bounded — past ack_deadline the
        preemption is FORCED), then flip the roles; to-training: wait
        for the Router's drain to settle (bounded — stragglers requeue
        via the membership bump), abort if demand rose under it."""
        rec = self._view.open_handover
        slices = sorted(int(i) for i in rec.get("slices", []))
        if rec.get("direction") == allocator_mod.TO_SERVING:
            if not rec.get("acked"):
                notice_ts = rec.get("ts", now)
                job_ts = self._view.job_notified_ts
                deadline = rec.get("ack_deadline")
                # the ack is consulted BEFORE the deadline: an ack
                # landing exactly AT the bounded-wait deadline is an
                # acknowledged preemption, never a forced one
                if job_ts is not None and job_ts >= notice_ts:
                    self._record(
                        events_mod.PREEMPT_ACK, id=rec.get("id"),
                        direction=rec.get("direction"), slices=slices,
                        forced=False,
                        waited_s=round(now - notice_ts, 3),
                    )
                    self.say(
                        "  trainer acknowledged the preemption "
                        "(checkpoint window used)"
                    )
                elif deadline is not None and now >= deadline:
                    self._record(
                        events_mod.PREEMPT_ACK, id=rec.get("id"),
                        direction=rec.get("direction"), slices=slices,
                        forced=True,
                        waited_s=round(now - notice_ts, 3),
                    )
                    self.say(
                        f"  trainer did not ack within "
                        f"{self.allocator.policy.ack_timeout_s:.0f}s: "
                        "FORCED preemption (the last periodic "
                        "checkpoint bounds the loss)"
                    )
                else:
                    if not self._ack_wait_logged:
                        self.say(
                            f"  handover {rec.get('id')}: waiting for "
                            f"the trainer's job-ack "
                            f"(deadline t={deadline:.0f})"
                        )
                        self._ack_wait_logged = True
                    return "awaiting-ack"
            self._record(
                events_mod.ROLE_CHANGED, id=rec.get("id"),
                direction=rec.get("direction"), slices=slices,
                role=allocator_mod.SERVING,
            )
            self.say(
                f"  slice(s) {', '.join(str(i) for i in slices)} join "
                "the serving set (membership generation bumped; the "
                "trainer re-forms at the smaller world)"
            )
            self.allocator.note_done()
            self._ack_wait_logged = False
            return "to-serving"
        # ---- to-training: the Router lets go first
        serving, _training = self._role_lists()
        fresh = self.allocator.fresh(signal, now)
        surge = (self.allocator.preempt_reason(signal,
                                               max(1, len(serving)))
                 if fresh else None)
        if surge is not None:
            # demand rose under the hand-back: aborting is cheap (the
            # slices never stopped serving in-flight work) and honest —
            # finishing the handover just to preempt it next window is
            # the thrash the cooldown exists to stop, so the abort
            # skips note_done and the cooldown keeps its growth
            self._record(
                events_mod.ROLE_CHANGED, id=rec.get("id"),
                direction=rec.get("direction"), slices=slices,
                role=allocator_mod.SERVING, aborted=True,
                reason=f"demand rose mid-drain: {surge}"[:200],
            )
            self.say(
                f"  hand-back ABORTED: demand rose mid-drain ({surge}); "
                f"slice(s) {', '.join(str(i) for i in slices)} return "
                "to serving"
            )
            self._alloc_drain_logged = False
            return "drain-aborted"
        settled = fresh and signal.inflight_on(slices) == 0
        deadline = rec.get("drain_deadline")
        if not settled and (deadline is None or now < deadline):
            if not self._alloc_drain_logged:
                inflight = (signal.inflight_on(slices)
                            if fresh else "unknown")
                self.say(
                    f"  hand-back: waiting for slice(s) "
                    f"{', '.join(str(i) for i in slices)} to drain "
                    f"({inflight} in flight)"
                )
                self._alloc_drain_logged = True
            return "draining"
        stragglers = signal.inflight_on(slices) if fresh else None
        self._record(
            events_mod.ROLE_CHANGED, id=rec.get("id"),
            direction=rec.get("direction"), slices=slices,
            role=allocator_mod.TRAINING, stragglers=stragglers,
        )
        extra = (f"; {stragglers} straggler(s) requeue via the "
                 "membership bump" if stragglers else "")
        self.say(
            f"  slice(s) {', '.join(str(i) for i in slices)} handed to "
            f"training (the elastic world grows{extra})"
        )
        self.allocator.note_done()
        self._alloc_drain_logged = False
        return "to-training"

    # ------------------------------------------------------------- status

    def _publish(self, now: float) -> None:
        # metrics.json lands FIRST, so the fleet-status document's
        # telemetry block always names a snapshot at least as fresh as
        # the status that points at it
        self.telemetry.write_snapshot()
        events_mod.write_fleet_status(
            self.paths.fleet_status, self.status_doc(now)
        )

    def telemetry_block(self) -> dict:
        """The status document's telemetry block: where the metrics
        snapshot and span log live, how big the span log has grown, and
        the last tick's duration — what `./setup.sh status --json`
        surfaces (docs/observability.md)."""
        tel = self.telemetry
        span_path = tel.tracer.log.path if tel.tracer.enabled else None
        span_bytes = None
        if span_path is not None:
            try:
                span_bytes = span_path.stat().st_size
            except OSError:
                span_bytes = 0
        return {
            "metrics_snapshot": (str(tel.snapshot_path)
                                 if tel.snapshot_path is not None
                                 else None),
            "span_log": str(span_path) if span_path is not None else None,
            "span_log_bytes": span_bytes,
            "last_tick_s": self._last_tick_s,
            "ticks_observed": int(self._c_ticks.total()),
        }

    def status_doc(self, now: float) -> dict:
        """The live view = restored history + every record this run
        appended (folded incrementally by `_record`) — identical to
        re-folding the ledger, which is what the status command does
        out-of-process, without re-reading the file every tick. The
        telemetry block records the metrics snapshot the document was
        built alongside."""
        return events_mod.fleet_status(
            self._view, now, pid=os.getpid(),
            telemetry=self.telemetry_block(),
        )

    # ---------------------------------------------------------------- run

    def run(self, ticks: int = 0) -> int:
        """Hold the pid lock and reconcile every `interval` seconds.
        `ticks=0` runs until `request_stop()` (SIGTERM/SIGINT in the
        CLI); a positive budget runs exactly that many ticks — what the
        drills and the tier-1 smoke use."""
        lock = PidLock(self.paths.supervisor_pid, echo=self.say)
        try:
            lock.acquire()
        except LockHeldError as e:
            raise SupervisorError(
                f"a supervisor is already running (pid {e.pid}, "
                f"{self.paths.supervisor_pid}); one reconcile loop per "
                "deployment — stop it first (teardown does this "
                "automatically)"
            ) from e
        try:
            self.restore()
            autoscale_fields = {}
            if self.autoscaler is not None:
                autoscale_fields = {
                    "autoscale": True,
                    "active": sorted(self._active),
                    "min_slices": self.autoscaler.min_slices,
                    "max_slices": self.autoscaler.max_slices,
                }
            if self.allocator is not None:
                autoscale_fields.update(
                    allocate=True,
                    min_serving=self.allocator.min_serving,
                    train_slices=self.allocator.policy.train_slices,
                )
            self._record(
                events_mod.SUPERVISOR_START, pid=os.getpid(),
                interval=self.policy.interval,
                flap_threshold=self.policy.flap_threshold,
                heal_burst=self.policy.heal_burst,
                heal_refill_s=self.policy.heal_refill_s,
                breaker_threshold=self.policy.breaker_threshold,
                max_degraded=self.policy.max_degraded,
                failure_domains=len(set(self._domains.values())),
                **autoscale_fields,
            )
            self.say(
                f"supervising {self.config.num_slices} slice(s) every "
                f"{self.policy.interval:.0f}s (flap threshold "
                f"{self.policy.flap_threshold}, heal burst "
                f"{self.policy.heal_burst}/{self.policy.heal_refill_s:.0f}s"
                f", breaker {self.policy.breaker_threshold} fails/"
                f"{self.policy.breaker_window_s:.0f}s); status in "
                f"{self.paths.fleet_status}"
            )
            done = 0
            while not self._stop:
                self.tick()
                done += 1
                self._maybe_compact()
                if ticks and done >= ticks:
                    break
                self._sleep(self.policy.interval)
            self._record(events_mod.SUPERVISOR_STOP,
                               pid=os.getpid(), ticks=done)
            self._publish(self._clock())
            return 0
        finally:
            lock.release()


# ----------------------------------------------------- teardown's stop hook


def stop_running(
    paths: RunPaths,
    echo: Callable[[str], None] = lambda line: None,
    kill: Callable[[int, int], None] = os.kill,
    sleep: Callable[[float], None] = time.sleep,
    grace_s: float = 5.0,
) -> bool:
    """Stop a running supervisor via its pid lockfile — teardown's FIRST
    act: a live reconcile loop would watch teardown delete slices and
    dutifully heal them back. SIGTERM first (the loop exits cleanly and
    records supervisor-stop), SIGKILL after the grace period; a stale
    lockfile (dead pid) is just removed. Returns True when a live
    supervisor was signalled."""
    lock = PidLock(paths.supervisor_pid)
    pid = lock.holder()
    if pid is None:
        paths.supervisor_pid.unlink(missing_ok=True)
        return False
    echo(f"stopping running supervisor (pid {pid})")
    try:
        kill(pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        paths.supervisor_pid.unlink(missing_ok=True)
        return False
    waited = 0.0
    while waited < grace_s:
        sleep(0.2)
        waited += 0.2
        if lock.holder() is None:
            paths.supervisor_pid.unlink(missing_ok=True)
            return True
    echo(f"supervisor pid {pid} ignored SIGTERM for {grace_s:.0f}s; "
         "sending SIGKILL")
    try:
        kill(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    paths.supervisor_pid.unlink(missing_ok=True)
    return True
