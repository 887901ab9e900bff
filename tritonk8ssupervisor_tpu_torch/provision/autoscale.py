"""Demand-driven autoscaling policy: the gateway→supervisor feedback loop.

Every earlier plane is one-directional: the supervisor publishes
`fleet-status.json` and the serving gateway routes on it, but nothing
flows BACK — a queue collapsing under a burst never changed capacity,
and a fleet idling through the diurnal trough kept paying for every
slice. This module closes the loop (ROADMAP item 1, Podracer's
time-shared-pods resource model, PAPERS.md):

- the **gateway** atomically publishes `demand-signal.json` (queue
  depth, observed completion rate, recent p99, recent shed count,
  deadline headroom, per-slice in-flight counts) on its poll cadence —
  torn-read tolerant exactly like `fleet-status.json`;
- `read_demand_signal` is the supervisor's reader: an absent, torn, or
  wrong-shaped document is **unknown — retry**, never evidence (the
  same contract as provision/fleetview.py), and the `Autoscaler`
  additionally refuses STALE documents — a pre-incident "queue is
  empty" snapshot must never justify a scale-down (the elastic
  trainer's staleness guard, applied to capacity);
- the `Autoscaler` folds fresh signals into a desired slice count with
  **hysteresis**: scale-up and scale-down have separate thresholds and
  separate N-consecutive-window confirmation streaks (the FlapFilter
  discipline — one noisy window never moves capacity), a **cooldown**
  between actions (retry.Cooldown: decorrelated growth while actions
  keep aborting, reset on a clean scale), and the supervisor guards the
  whole loop with a **scale-thrash CircuitBreaker**
  so an oscillating policy freezes itself instead of the fleet.

The supervisor (provision/supervisor.py) EXECUTES decisions: scale-up
re-provisions inactive slices through the existing warm incremental
path (fast when the converge cache is warm); scale-down marks
slices DRAINING (the Router stops pulling — docs/failure-modes.md
"Elastic capacity"), waits for in-flight work to settle via the demand
signal, requeues stragglers through the gateway's membership bump, and
tears down ONLY the drained slices. Every decision / execution / abort
is a ledger event (SCALE_DECISION / SCALE_START / SCALE_DONE /
SCALE_ABORT), so a SIGKILL'd supervisor resumes mid-scale without
double-provisioning or orphaning a half-drained slice.

Benched by `bench_provision.py --autoscale` (BENCH_autoscale.json):
unattended scale-up MTTR under a burst, and cost-per-served-token
(slice-hours / completed tokens) under the diurnal+burst trace vs a
static fleet.

The port's copy of `tritonk8ssupervisor_tpu/provision/autoscale.py`, whole
and under the reference's names: `read_fleet_demand` reads the shards the
port's gateway fleet (`serving/fleet.py`) writes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path

from tritonk8ssupervisor_tpu_torch.provision import retry

SCHEMA_VERSION = 1

UP = "up"
DOWN = "down"


@dataclasses.dataclass(frozen=True)
class DemandSignal:
    """One parsed demand-signal.json observation. `updated` is the
    WRITER's clock — the reader judges staleness against its own clock
    before trusting any field (a stale document is not evidence)."""

    updated: float
    queue_depth: int
    service_rate: float | None = None
    p99_s: float | None = None
    recent_sheds: int = 0
    deadline_headroom_s: float | None = None
    inflight: dict = dataclasses.field(default_factory=dict)  # slice -> n
    active_workers: tuple = ()
    # KV page-pool headroom across the gateway's bounded pools (None on
    # pre-paged or unbounded-sim documents): pressure evidence DISTINCT
    # from queue depth — a fleet can show free slots and a short queue
    # while its page pools are pinned by long prompts / fat budgets
    kv_pages_free: int | None = None

    def inflight_on(self, slices) -> int:
        return sum(int(self.inflight.get(int(i), 0)) for i in slices)


def parse_demand_signal(raw) -> DemandSignal | None:
    """A DemandSignal from a parsed document, or None when it is not
    one (wrong type, mangled fields) — the same "unknown, retry"
    verdict as a torn read (provision/fleetview.py discipline)."""
    try:
        if not isinstance(raw, dict) or raw.get("updated") is None:
            return None
        inflight_raw = raw.get("inflight")
        inflight = (
            {int(k): int(v) for k, v in inflight_raw.items()}
            if isinstance(inflight_raw, dict) else {}
        )
        rate = raw.get("service_rate")
        p99 = raw.get("p99_s")
        headroom = raw.get("deadline_headroom_s")
        kv_free = raw.get("kv_pages_free")
        return DemandSignal(
            kv_pages_free=int(kv_free) if kv_free is not None else None,
            updated=float(raw["updated"]),
            queue_depth=int(raw.get("queue_depth", 0)),
            service_rate=float(rate) if rate is not None else None,
            p99_s=float(p99) if p99 is not None else None,
            recent_sheds=int(raw.get("recent_sheds", 0)),
            deadline_headroom_s=(float(headroom)
                                 if headroom is not None else None),
            inflight=inflight,
            active_workers=tuple(
                sorted(int(i) for i in raw.get("active_workers") or [])
            ),
        )
    except (TypeError, ValueError):
        return None


def read_demand_signal(path: Path | str) -> DemandSignal | None:
    """Read the gateway's demand-signal.json. Absent or torn (the
    gateway writes atomically, but a half-copied scrape snapshot is
    still possible) reads are unknown — retry next tick. Staleness is
    judged by the CALLER (`Autoscaler.observe`), which knows its own
    clock; this function only answers "is there a whole document"."""
    try:
        raw = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None  # absent or torn: unknown, retry
    return parse_demand_signal(raw)


# ------------------------------------------------------- fleet demand fold

# default per-replica staleness bound for the fleet fold, matching
# AutoscalePolicy.signal_max_age_s — callers with a policy pass theirs
FLEET_SIGNAL_MAX_AGE_S = 90.0


def merge_demand_signals(
    signals: dict,
    now: float | None = None,
    max_age: float | None = None,
) -> DemandSignal | None:
    """Fold N replicas' demand signals (serving/fleet.py: each replica
    publishes demand-signal-<replica>.json for ITS key-partition and
    leased slices) into the ONE DemandSignal the autoscaler and
    allocator consume. The per-replica staleness guard runs HERE, not
    just on the merged document: one dead replica's week-old "queue is
    empty" must neither drag the merged view stale (freezing the
    controllers) nor dilute live replicas' pressure — stale members are
    dropped, fresh ones merge.

    Merge semantics: demand sums (queue_depth, service_rate,
    recent_sheds, kv_pages_free — slice leases are disjoint, so
    per-replica engine reports never double-count a pool), pain takes
    the worst case (p99 = max, deadline_headroom = min), per-slice
    inflight sums, active_workers unions, and `updated` is the OLDEST
    included signal — the merged view is only as fresh as its stalest
    member, so the autoscaler's own staleness guard stays honest."""
    fresh = {}
    for replica, signal in signals.items():
        if signal is None:
            continue
        if (now is not None and max_age is not None
                and now - signal.updated > max_age):
            continue  # this replica's signal is not evidence
        fresh[replica] = signal
    if not fresh:
        return None
    members = list(fresh.values())
    rates = [s.service_rate for s in members if s.service_rate is not None]
    p99s = [s.p99_s for s in members if s.p99_s is not None]
    headrooms = [s.deadline_headroom_s for s in members
                 if s.deadline_headroom_s is not None]
    kv_frees = [s.kv_pages_free for s in members
                if s.kv_pages_free is not None]
    inflight: dict = {}
    workers: set = set()
    for s in members:
        for index, n in s.inflight.items():
            inflight[int(index)] = inflight.get(int(index), 0) + int(n)
        workers.update(int(i) for i in s.active_workers)
    return DemandSignal(
        updated=min(s.updated for s in members),
        queue_depth=sum(s.queue_depth for s in members),
        service_rate=sum(rates) if rates else None,
        p99_s=max(p99s) if p99s else None,
        recent_sheds=sum(s.recent_sheds for s in members),
        deadline_headroom_s=min(headrooms) if headrooms else None,
        inflight=inflight,
        active_workers=tuple(sorted(workers)),
        kv_pages_free=sum(kv_frees) if kv_frees else None,
    )


def fleet_signal_paths(path: Path | str) -> dict:
    """The per-replica demand-signal shards next to the legacy path:
    demand-signal-<replica>.json siblings (state.RunPaths naming).
    Empty dict = no fleet is publishing here."""
    path = Path(path)
    stem, suffix = path.stem, path.suffix
    out = {}
    for shard in sorted(path.parent.glob(f"{stem}-*{suffix}")):
        replica = shard.stem[len(stem) + 1:]
        if replica:
            out[replica] = shard
    return out


def read_fleet_demand(
    path: Path | str,
    now: float | None = None,
    max_age: float | None = None,
) -> DemandSignal | None:
    """The supervisor's ONE demand read: when per-replica shards exist
    next to `path`, fold them (per-replica staleness-guarded) into a
    merged signal; when none do, this is exactly `read_demand_signal`
    — a single-gateway deployment's behavior, byte-identical."""
    shards = fleet_signal_paths(path)
    if not shards:
        return read_demand_signal(path)
    return merge_demand_signals(
        {replica: read_demand_signal(p) for replica, p in shards.items()},
        now=now,
        max_age=max_age if max_age is not None else FLEET_SIGNAL_MAX_AGE_S,
    )


# ------------------------------------------------------------------ policy


@dataclasses.dataclass
class AutoscalePolicy:
    """Knobs for the demand→capacity fold. Every field has a
    TK8S_AUTOSCALE_* env override (the TK8S_SUPERVISE_* convention);
    docs/failure-modes.md "Elastic capacity" tabulates them."""

    min_slices: int = 1  # never drain below this
    max_slices: int = 0  # 0 = the fleet's provisioned envelope
    # scale-up pressure: queue deeper than this per ACTIVE slice, any
    # recent shed, or p99 over the SLO
    up_queue_per_slice: float = 8.0
    slo_p99_s: float = 30.0
    # scale-down pressure: the queue must fit comfortably on ONE FEWER
    # slice, with no sheds and p99 well inside the SLO
    down_queue_per_slice: float = 2.0
    down_p99_margin: float = 0.5  # p99 must be under margin * slo
    # hysteresis: consecutive confirming windows before a decision
    # (scale-down demands more evidence — capacity is cheap to keep for
    # one more window and expensive to be missing in the next burst)
    confirm_up: int = 2
    confirm_down: int = 4
    # cooldown between scale actions (retry.Cooldown: decorrelated
    # growth while actions keep aborting/failing, reset on a clean one)
    cooldown_s: float = 120.0
    cooldown_cap_s: float = 900.0
    # scale-down drain: how long a DRAINING slice may finish in-flight
    # work before teardown proceeds and stragglers are requeued
    drain_timeout_s: float = 300.0
    # a signal older than this is STALE — not evidence, no decision
    signal_max_age_s: float = 90.0
    # the scale-thrash breaker (failed/aborted scale actions in a
    # window trip it OPEN; no scale action runs while it holds)
    breaker_threshold: int = 3
    breaker_window_s: float = 3600.0

    _ENV = {
        "min_slices": ("TK8S_AUTOSCALE_MIN_SLICES", int),
        "max_slices": ("TK8S_AUTOSCALE_MAX_SLICES", int),
        "up_queue_per_slice": ("TK8S_AUTOSCALE_UP_QUEUE", float),
        "slo_p99_s": ("TK8S_AUTOSCALE_SLO_P99", float),
        "down_queue_per_slice": ("TK8S_AUTOSCALE_DOWN_QUEUE", float),
        "down_p99_margin": ("TK8S_AUTOSCALE_DOWN_P99_MARGIN", float),
        "confirm_up": ("TK8S_AUTOSCALE_CONFIRM_UP", int),
        "confirm_down": ("TK8S_AUTOSCALE_CONFIRM_DOWN", int),
        "cooldown_s": ("TK8S_AUTOSCALE_COOLDOWN", float),
        "cooldown_cap_s": ("TK8S_AUTOSCALE_COOLDOWN_CAP", float),
        "drain_timeout_s": ("TK8S_AUTOSCALE_DRAIN_TIMEOUT", float),
        "signal_max_age_s": ("TK8S_AUTOSCALE_SIGNAL_MAX_AGE", float),
        "breaker_threshold": ("TK8S_AUTOSCALE_BREAKER_THRESHOLD", int),
        "breaker_window_s": ("TK8S_AUTOSCALE_BREAKER_WINDOW", float),
    }

    @classmethod
    def from_env(cls, environ: dict | None = None) -> "AutoscalePolicy":
        env = os.environ if environ is None else environ
        kwargs = {}
        for field, (name, cast) in cls._ENV.items():
            raw = env.get(name, "")
            if raw != "":
                kwargs[field] = cast(raw)
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One confirmed desired-count change. `windows` is the length of
    the confirming streak — the ledger records it so the chaos checker
    can prove no decision ever fired on fewer than the policy demands;
    `signal_age_s` proves it fired on fresh evidence."""

    direction: str  # UP / DOWN
    from_count: int
    to_count: int
    reason: str
    windows: int
    signal_age_s: float


class Autoscaler:
    """The hysteresis fold: fresh demand signals in, confirmed
    Decisions out. Clock-free (callers pass `now`) so the same
    arithmetic runs on wall time and the virtual clock.

    The streak discipline mirrors the supervisor's FlapFilter: an
    up-pressure window grows the up streak and clears the down streak
    (and vice versa), a neutral window clears both, and an UNKNOWN
    window (absent/torn/stale signal) clears both too — a decision must
    be confirmed by `confirm_up`/`confirm_down` CONSECUTIVE fresh
    windows, so a gateway outage or a half-copied file can never leave
    a stale streak armed. Cooldown holds a confirmed decision without
    destroying its streak: the moment the cooldown lapses, the still-
    confirmed pressure fires."""

    def __init__(
        self,
        policy: AutoscalePolicy,
        envelope: int,
        cooldown: retry.Cooldown | None = None,
    ) -> None:
        self.policy = policy
        self.envelope = max(1, int(envelope))
        cap = int(policy.max_slices) if policy.max_slices else self.envelope
        self.max_slices = max(1, min(cap, self.envelope))
        self.min_slices = max(1, min(int(policy.min_slices),
                                     self.max_slices))
        self.cooldown = cooldown or retry.Cooldown(
            policy.cooldown_s, policy.cooldown_cap_s
        )
        self.cooldown_until = 0.0
        self.up_streak = 0
        self.down_streak = 0
        self.last_signal: DemandSignal | None = None

    # ------------------------------------------------------- pressure

    def up_reason(self, signal: DemandSignal, active: int) -> str | None:
        """Why capacity must GROW right now, or None. Also the drain
        abort probe: a scale-down in flight consults this against the
        post-drain count to decide whether demand rose under it."""
        p = self.policy
        active = max(1, int(active))
        if signal.recent_sheds > 0:
            return f"shedding ({signal.recent_sheds} recent)"
        if signal.queue_depth > p.up_queue_per_slice * active:
            return (f"queue {signal.queue_depth} > "
                    f"{p.up_queue_per_slice:.0f}/slice x {active}")
        if signal.p99_s is not None and signal.p99_s > p.slo_p99_s:
            return f"p99 {signal.p99_s:.1f}s > SLO {p.slo_p99_s:.0f}s"
        if (signal.deadline_headroom_s is not None
                and signal.deadline_headroom_s <= 0):
            return "deadline headroom exhausted"
        return None

    def down_reason(self, signal: DemandSignal, active: int) -> str | None:
        """Why capacity may SHRINK: the whole load must fit comfortably
        on one fewer slice, with zero sheds and p99 well inside SLO."""
        p = self.policy
        if active <= self.min_slices:
            return None
        if signal.recent_sheds > 0:
            return None
        if signal.queue_depth > p.down_queue_per_slice * (active - 1):
            return None
        if (signal.p99_s is not None
                and signal.p99_s > p.down_p99_margin * p.slo_p99_s):
            return None
        return (f"queue {signal.queue_depth} <= "
                f"{p.down_queue_per_slice:.0f}/slice x {active - 1}"
                + (f", p99 {signal.p99_s:.1f}s" if signal.p99_s is not None
                   else ""))

    def _up_step(self, signal: DemandSignal, active: int) -> int:
        """How many slices one scale-up adds: sized to the backlog
        (excess queue over the per-slice budget), at least one."""
        p = self.policy
        excess = signal.queue_depth - p.up_queue_per_slice * active
        step = max(1, math.ceil(excess / max(1.0, p.up_queue_per_slice)))
        return min(step, self.max_slices - active)

    # -------------------------------------------------------- observe

    def fresh(self, signal: DemandSignal | None, now: float) -> bool:
        return (signal is not None
                and now - signal.updated <= self.policy.signal_max_age_s)

    def observe(
        self, signal: DemandSignal | None, active: int, now: float
    ) -> Decision | None:
        """Fold one window. Returns a confirmed Decision, or None
        (unknown/stale signal, unconfirmed streak, at bounds, or inside
        the cooldown)."""
        if not self.fresh(signal, now):
            # absent, torn, or stale: NOT evidence. The streaks reset —
            # confirmation means consecutive FRESH windows.
            self.up_streak = 0
            self.down_streak = 0
            return None
        self.last_signal = signal
        age = max(0.0, now - signal.updated)
        up = self.up_reason(signal, active)
        down = self.down_reason(signal, active) if up is None else None
        if up is not None:
            self.up_streak += 1
            self.down_streak = 0
        elif down is not None:
            self.down_streak += 1
            self.up_streak = 0
        else:
            self.up_streak = 0
            self.down_streak = 0
            return None
        if up is not None:
            if active >= self.max_slices:
                return None  # pinned at --max-slices: pressure noted
            if self.up_streak < max(1, int(self.policy.confirm_up)):
                return None
            if now < self.cooldown_until:
                return None  # held; the streak survives the hold
            return Decision(UP, active,
                            active + self._up_step(signal, active),
                            up, self.up_streak, round(age, 3))
        if self.down_streak < max(1, int(self.policy.confirm_down)):
            return None
        if now < self.cooldown_until:
            return None
        return Decision(DOWN, active, active - 1, down,
                        self.down_streak, round(age, 3))

    # ------------------------------------------------------ lifecycle

    def note_action(self, now: float) -> float:
        """A decision is being EXECUTED: arm the cooldown and clear the
        streaks (the next decision needs fresh confirmation against the
        new capacity). Returns the cooldown expiry for the ledger."""
        self.cooldown_until = now + self.cooldown.next()
        self.up_streak = 0
        self.down_streak = 0
        return self.cooldown_until

    def note_done(self) -> None:
        """A scale action LANDED cleanly: reset the cooldown growth, so
        a healthy diurnal rhythm pays the base cooldown, not a grown
        one. (Aborts/failures deliberately skip this — consecutive
        trouble grows the hold, the retry-engine discipline.)"""
        self.cooldown.reset()
