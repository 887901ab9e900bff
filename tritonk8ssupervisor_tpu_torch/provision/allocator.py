"""Train/serve co-scheduling policy: one fleet, two workloads.

The autoscaler (provision/autoscale.py) sizes the SERVING fleet against
demand by provisioning and tearing down slices — capacity that is not
serving is simply gone. This module is the third controller (ROADMAP
item 4, Podracer's priority-time-shared TPU-pod model, PAPERS.md): a
slice that serving does not need right now is not torn down, it is
HANDED TO ELASTIC TRAINING, and reclaimed — through a full preemption
protocol, never a kill — when the queue surges. Every slice carries a
role:

- ``SERVING``: the gateway routes to it (fleet-status ``serving.eligible``);
- ``TRAINING``: part of the elastic trainer's world; the gateway never
  dispatches to it;
- ``TRANSITIONING``: mid-handover in either direction — it appears in
  ``membership.draining`` so the side that must let go drains first
  (the trainer flushes its drain-notice checkpoint, or the Router
  finishes in-flight work and pulls nothing new).

The `Allocator` is the decision fold, shaped exactly like the
`Autoscaler` it sits beside: fresh demand signals in, confirmed
`AllocDecision`s out, with separate confirmation streaks per direction
(preempting a training job demands less evidence than taking capacity
away from serving is cheap — but both are hysteresis-gated so one noisy
window never moves a role), a cooldown between handovers, and a
staleness guard (a stale "queue is empty" snapshot must never lend a
slice away right before the burst it failed to see).

The supervisor (provision/supervisor.py `_allocate`) EXECUTES decisions
as a ledger-recorded protocol built from this repo's existing
preemption assets:

- ``ALLOC_DECISION``  — the confirmed fold (direction, windows, reason);
- ``PREEMPT_NOTICE``  — the handover opens: the named slices turn
  TRANSITIONING and land in ``membership.draining``. For ``to-serving``
  this IS the drain-notice checkpoint window (parallel/elastic.py
  flushes at ~0 step cost and job-acks); for ``to-training`` it is the
  Router's drain (finish in-flight, pull nothing);
- ``PREEMPT_ACK``     — the trainer acknowledged (job-ack.json folded by
  JobAckWatcher), or the bounded wait lapsed and the preemption is
  FORCED (``forced=true``; the last periodic checkpoint bounds the loss);
- ``ROLE_CHANGED``    — the handover closes: roles flip, the membership
  generation bumps (the gateway requeues stragglers, the elastic
  trainer re-forms at the new world size).

A ``PREEMPT_NOTICE`` without a matching ``ROLE_CHANGED`` is the
mid-handover crash signature: a restarted supervisor RESUMES that
handover under its original id — no slice is ever double-assigned, no
half-preempted trainer is orphaned. Benched by
``bench_provision.py --allocator`` (BENCH_allocator.json): goodput +
training steps on ONE co-scheduled fleet vs two static half-fleets
under the diurnal+burst trace, with the co-scheduling chaos campaigns
(testing/chaos.py) proving the allocation invariants.

The port's copy of `tritonk8ssupervisor_tpu/provision/allocator.py`, whole
and under the reference's names: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
import os

from tritonk8ssupervisor_tpu_torch.provision import retry
from tritonk8ssupervisor_tpu_torch.provision.autoscale import DemandSignal

# Roles (the events fold and fleet-status allocation block share these).
SERVING = "serving"
TRAINING = "training"
TRANSITIONING = "transitioning"

# Handover directions. `to-serving` preempts training (notice -> ack ->
# role change); `to-training` lends an idle serving slice (Router drain
# -> role change).
TO_SERVING = "to-serving"
TO_TRAINING = "to-training"


@dataclasses.dataclass
class AllocatorPolicy:
    """Knobs for the role fold. Every field has a TK8S_ALLOC_* env
    override (the TK8S_AUTOSCALE_* convention); docs/failure-modes.md
    "Fleet allocation & preemption" tabulates them."""

    min_serving: int = 1  # never hand the last serving slices away
    min_training: int = 0  # training floor the preemptor respects
    # slices that START as the training world (highest indices; the
    # low indices hold the serving anchors) — 0 means training only
    # ever gets what idle troughs lend it
    train_slices: int = 0
    # preemption pressure (reclaim training capacity for serving):
    # same semantics as the autoscaler's up pressure
    up_queue_per_slice: float = 8.0
    slo_p99_s: float = 30.0
    # lend pressure: the serving load must fit comfortably on one
    # fewer slice, with no sheds and p99 well inside the SLO
    idle_queue_per_slice: float = 2.0
    idle_p99_margin: float = 0.5
    # hysteresis: consecutive confirming FRESH windows per direction
    # (lending demands more evidence — a preempted trainer pays a
    # resume, and capacity missing in the next burst pays more)
    confirm_to_serving: int = 2
    confirm_to_training: int = 4
    # cooldown between handovers (retry.Cooldown: grows while
    # handovers keep aborting, resets on a clean one)
    cooldown_s: float = 120.0
    cooldown_cap_s: float = 900.0
    # bounded wait for the trainer's job-ack after a PREEMPT_NOTICE:
    # past it the preemption is FORCED (the trainer may be wedged;
    # its last periodic checkpoint bounds the loss)
    ack_timeout_s: float = 90.0
    # how long the Router may drain a to-training slice before the
    # role flips anyway and stragglers requeue via the membership bump
    drain_timeout_s: float = 120.0
    # hand-back sizing: lend k slices only while total in-flight work
    # still fits `idle_inflight_per_slice` streams per REMAINING slice
    # — queue depth alone reads "keeping up" as "idle" and over-lends
    # straight into a preempt-back oscillation
    idle_inflight_per_slice: float = 3.0
    # a demand signal older than this is STALE — not evidence
    signal_max_age_s: float = 90.0

    _ENV = {
        "min_serving": ("TK8S_ALLOC_MIN_SERVING", int),
        "min_training": ("TK8S_ALLOC_MIN_TRAINING", int),
        "train_slices": ("TK8S_ALLOC_TRAIN_SLICES", int),
        "up_queue_per_slice": ("TK8S_ALLOC_UP_QUEUE", float),
        "slo_p99_s": ("TK8S_ALLOC_SLO_P99", float),
        "idle_queue_per_slice": ("TK8S_ALLOC_IDLE_QUEUE", float),
        "idle_p99_margin": ("TK8S_ALLOC_IDLE_P99_MARGIN", float),
        "confirm_to_serving": ("TK8S_ALLOC_CONFIRM_SERVING", int),
        "confirm_to_training": ("TK8S_ALLOC_CONFIRM_TRAINING", int),
        "cooldown_s": ("TK8S_ALLOC_COOLDOWN", float),
        "cooldown_cap_s": ("TK8S_ALLOC_COOLDOWN_CAP", float),
        "ack_timeout_s": ("TK8S_ALLOC_ACK_TIMEOUT", float),
        "drain_timeout_s": ("TK8S_ALLOC_DRAIN_TIMEOUT", float),
        "idle_inflight_per_slice": ("TK8S_ALLOC_IDLE_INFLIGHT", float),
        "signal_max_age_s": ("TK8S_ALLOC_SIGNAL_MAX_AGE", float),
    }

    @classmethod
    def from_env(cls, environ: dict | None = None) -> "AllocatorPolicy":
        env = os.environ if environ is None else environ
        kwargs = {}
        for field, (name, cast) in cls._ENV.items():
            raw = env.get(name, "")
            if raw != "":
                kwargs[field] = cast(raw)
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class AllocDecision:
    """One confirmed role reassignment. `windows` and `signal_age_s`
    land on the ALLOC_DECISION ledger record so the chaos checker can
    prove no handover ever fired on fewer confirming windows than the
    policy demands, or on stale evidence."""

    direction: str  # TO_SERVING / TO_TRAINING
    count: int  # slices changing role
    reason: str
    windows: int
    signal_age_s: float


class Allocator:
    """The role-fold: fresh demand signals in, confirmed AllocDecisions
    out. Clock-free (callers pass `now`) — the same arithmetic runs on
    wall time and the virtual clock. The streak discipline mirrors the
    Autoscaler's: pressure in one direction grows its streak and clears
    the other, a neutral window clears both, an UNKNOWN window
    (absent/torn/stale signal) clears both too."""

    def __init__(
        self,
        policy: AllocatorPolicy,
        envelope: int,
        cooldown: retry.Cooldown | None = None,
    ) -> None:
        self.policy = policy
        self.envelope = max(1, int(envelope))
        self.min_serving = max(1, min(int(policy.min_serving),
                                      self.envelope))
        self.min_training = max(0, int(policy.min_training))
        self.cooldown = cooldown or retry.Cooldown(
            policy.cooldown_s, policy.cooldown_cap_s
        )
        self.cooldown_until = 0.0
        self.serve_streak = 0
        self.train_streak = 0
        self.last_signal: DemandSignal | None = None

    def initial_training(self, slices: list) -> list:
        """The slices that start as the training world: the highest
        `train_slices` indices of the active set, capped so serving
        keeps its floor."""
        want = max(0, int(self.policy.train_slices))
        cap = max(0, len(slices) - self.min_serving)
        return sorted(sorted(slices)[len(slices) - min(want, cap):]) \
            if min(want, cap) > 0 else []

    # ------------------------------------------------------- pressure

    def preempt_reason(self, signal: DemandSignal,
                       serving: int) -> str | None:
        """Why serving must RECLAIM capacity right now, or None. Also
        the abort probe a to-training drain consults against its
        post-handover serving count."""
        p = self.policy
        serving = max(1, int(serving))
        if signal.recent_sheds > 0:
            return f"shedding ({signal.recent_sheds} recent)"
        if signal.queue_depth > p.up_queue_per_slice * serving:
            return (f"queue {signal.queue_depth} > "
                    f"{p.up_queue_per_slice:.0f}/slice x {serving}")
        if signal.p99_s is not None and signal.p99_s > p.slo_p99_s:
            return f"p99 {signal.p99_s:.1f}s > SLO {p.slo_p99_s:.0f}s"
        if (signal.deadline_headroom_s is not None
                and signal.deadline_headroom_s <= 0):
            return "deadline headroom exhausted"
        return None

    def lend_reason(self, signal: DemandSignal,
                    serving: int) -> str | None:
        """Why a serving slice may be LENT to training: the whole load
        must fit comfortably on one fewer slice, zero sheds, p99 well
        inside the SLO."""
        p = self.policy
        if serving <= self.min_serving:
            return None
        if signal.service_rate is None:
            # an empty queue with NO observed completions is a cold
            # start, not idleness — lending on it hands slices away
            # right as the first ramp arrives
            return None
        if signal.recent_sheds > 0:
            return None
        if signal.queue_depth > p.idle_queue_per_slice * (serving - 1):
            return None
        if (signal.p99_s is not None
                and signal.p99_s > p.idle_p99_margin * p.slo_p99_s):
            return None
        return (f"queue {signal.queue_depth} <= "
                f"{p.idle_queue_per_slice:.0f}/slice x {serving - 1}"
                + (f", p99 {signal.p99_s:.1f}s"
                   if signal.p99_s is not None else ""))

    def _preempt_count(self, signal: DemandSignal, serving: int,
                       training: int) -> int:
        """How many training slices one preemption reclaims: sized to
        the backlog (like the autoscaler's up-step), bounded by what
        training can give up past its floor."""
        p = self.policy
        excess = signal.queue_depth - p.up_queue_per_slice * max(1, serving)
        step = max(1, math.ceil(excess / max(1.0, p.up_queue_per_slice)))
        return max(0, min(step, training - self.min_training))

    def _lend_count(self, signal: DemandSignal, serving: int) -> int:
        """How many slices one hand-back lends: the largest k the load
        still fits comfortably without (lend_reason already proved
        k >= 1). Sized hand-backs matter for the TRAINER: returning
        three slices one at a time costs three membership resumes;
        returning them together costs one."""
        p = self.policy
        inflight = sum(int(v) for v in signal.inflight.values())
        k = 1
        while (serving - (k + 1) >= self.min_serving
               and signal.queue_depth
               <= p.idle_queue_per_slice * (serving - (k + 1))
               and inflight
               <= p.idle_inflight_per_slice * (serving - (k + 1))):
            k += 1
        return k

    # -------------------------------------------------------- observe

    def fresh(self, signal: DemandSignal | None, now: float) -> bool:
        return (signal is not None
                and now - signal.updated <= self.policy.signal_max_age_s)

    def observe(
        self,
        signal: DemandSignal | None,
        serving: int,
        training: int,
        now: float,
    ) -> AllocDecision | None:
        """Fold one window against the current role split. Returns a
        confirmed AllocDecision, or None (unknown/stale signal,
        unconfirmed streak, nothing to move, or inside the cooldown)."""
        if not self.fresh(signal, now):
            self.serve_streak = 0
            self.train_streak = 0
            return None
        self.last_signal = signal
        age = max(0.0, now - signal.updated)
        preempt = self.preempt_reason(signal, serving)
        lend = (self.lend_reason(signal, serving)
                if preempt is None else None)
        if preempt is not None:
            self.serve_streak += 1
            self.train_streak = 0
        elif lend is not None:
            self.train_streak += 1
            self.serve_streak = 0
        else:
            self.serve_streak = 0
            self.train_streak = 0
            return None
        if preempt is not None:
            count = self._preempt_count(signal, serving, training)
            if count <= 0:
                return None  # training has nothing to give past its floor
            if self.serve_streak < max(1, int(
                    self.policy.confirm_to_serving)):
                return None
            if now < self.cooldown_until:
                return None  # held; the streak survives the hold
            return AllocDecision(TO_SERVING, count, preempt,
                                 self.serve_streak, round(age, 3))
        if self.train_streak < max(1, int(self.policy.confirm_to_training)):
            return None
        if now < self.cooldown_until:
            return None
        return AllocDecision(TO_TRAINING,
                             self._lend_count(signal, serving), lend,
                             self.train_streak, round(age, 3))

    # ------------------------------------------------------ lifecycle

    def note_action(self, now: float) -> float:
        """A handover is being EXECUTED: arm the cooldown, clear the
        streaks (the next decision needs fresh confirmation against the
        new role split). Returns the cooldown expiry for the ledger."""
        self.cooldown_until = now + self.cooldown.next()
        self.serve_streak = 0
        self.train_streak = 0
        return self.cooldown_until

    def note_done(self) -> None:
        """A handover LANDED cleanly: reset the cooldown growth so a
        healthy diurnal rhythm pays the base cooldown. (Aborted
        hand-backs deliberately skip this — the retry discipline.)"""
        self.cooldown.reset()
