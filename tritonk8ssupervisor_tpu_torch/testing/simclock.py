"""Deterministic virtual time for concurrent simulations: the port's copy
of `tritonk8ssupervisor_tpu/testing/simclock.py`, whole. The fleet drills
(`testing/chaos.py`) drive `serving/fleet.drive_fleet` on it.

The scheduler benchmark (bench_provision.py) and the perf smoke tests
need to measure DAG wall-clock against a sequential baseline WITHOUT
real sleeps — tier-1 must stay fast — and deterministically, across
real threads. `SimClock` is a tiny discrete-event clock:

- task bodies call `clock.sleep(seconds)` instead of time.sleep;
- the clock advances to the earliest pending wake-up only when EVERY
  in-flight actor is blocked in `sleep` — so virtual time never runs
  ahead of work that hasn't started (or whose completion hasn't been
  fully processed), and the measured makespan is a pure function of the
  task graph, not of OS thread scheduling.

An actor's in-flight window is accounted in three stages, matching
run_dag's hooks exactly:

1. `launch()`  — the task was submitted (run_dag's `on_submit`, fired in
   the scheduling thread BEFORE a worker exists for it);
2. `begin()`   — the task body entered its worker thread (call first
   thing inside the fn; converts the launch slot into an active actor);
3. `release()` — the scheduler recorded the result and submitted any
   newly-ready dependents (run_dag's `on_settled`).

Holding the slot from submit to settle closes both hand-off races: time
cannot jump while a submitted task is still on its way into a worker,
nor between a task finishing and its dependents being enqueued.

The pool must be at least as wide as the graph's widest antichain: a
task queued behind a busy worker is "launched but never begins", which
the clock correctly refuses to advance past — surfaced as SimClockStalled
rather than a silent wrong number. Sequential baselines therefore model
seriality with a chain of `after=` edges, not max_workers=1.
"""

from __future__ import annotations

import contextlib
import threading


class SimClockStalled(RuntimeError):
    """No actor can make progress: typically the thread pool is narrower
    than the task graph (a queued task holds its `launch` slot forever),
    or an actor blocked on something other than the clock."""


class SimClock:
    def __init__(self, start: float = 0.0, stall_timeout: float = 30.0):
        self._now = float(start)
        self._cv = threading.Condition()
        self._launched = 0  # submitted, body not yet entered
        self._active = 0  # begun, not yet settled
        self._sleepers: list[float] = []  # wake times of blocked actors
        self._stall_timeout = stall_timeout

    def time(self) -> float:
        with self._cv:
            return self._now

    # ------------------------------------------------------ actor lifecycle

    def launch(self, *_args, **_kwargs) -> None:
        """Account one submitted-but-not-begun actor. Signature absorbs
        arguments so it plugs straight into run_dag(on_submit=clock.launch)."""
        with self._cv:
            self._launched += 1

    def begin(self, *_args, **_kwargs) -> None:
        """The actor's body is now running: convert its launch slot."""
        with self._cv:
            if self._launched > 0:
                self._launched -= 1
            self._active += 1

    def release(self, *_args, **_kwargs) -> None:
        """The actor is fully settled (result recorded, dependents
        submitted): drop its slot and let time move if everyone else is
        asleep. Plugs into run_dag(on_settled=clock.release)."""
        with self._cv:
            self._active -= 1
            self._maybe_advance()
            self._cv.notify_all()

    @contextlib.contextmanager
    def actor(self):
        """begin()/release() as a context manager — for simple harnesses
        (thread pools without a settle phase) where the body's exit IS
        the settle point."""
        self.begin()
        try:
            yield self
        finally:
            self.release()

    # -------------------------------------------------------------- sleeping

    def sleep(self, seconds: float) -> None:
        """Block until virtual time reaches now+seconds. The LAST actor to
        block is the one that advances the clock — by then every piece of
        in-flight work is waiting on time, so jumping to the earliest
        wake-up is exactly what a real cluster's wall clock would do."""
        with self._cv:
            wake = self._now + max(0.0, float(seconds))
            self._sleepers.append(wake)
            self._maybe_advance()
            while self._now < wake:
                if not self._cv.wait(timeout=self._stall_timeout):
                    self._sleepers.remove(wake)
                    raise SimClockStalled(
                        f"virtual clock stalled at t={self._now:g} "
                        f"({self._active} active, {self._launched} launched, "
                        f"{len(self._sleepers)} sleeping) — is the worker "
                        "pool narrower than the task graph?"
                    )
                self._maybe_advance()
            self._sleepers.remove(wake)
            self._cv.notify_all()

    def charge(self, seconds: float) -> None:
        """Advance virtual time by `seconds` from the DRIVER thread while
        no actors are in flight — for costs that happen outside the task
        graph proper, e.g. the per-task digest verification a warm resume
        pays before the scheduler ever submits anything
        (bench_provision.py --warm). Charging while actors are active
        would corrupt their sleep accounting, so it raises instead."""
        with self._cv:
            if self._active or self._launched or self._sleepers:
                raise SimClockStalled(
                    "charge() while actors are in flight: "
                    f"{self._active} active, {self._launched} launched, "
                    f"{len(self._sleepers)} sleeping"
                )
            self._now += max(0.0, float(seconds))
            self._cv.notify_all()

    def _maybe_advance(self) -> None:
        # caller holds self._cv
        if (
            self._sleepers
            and self._launched == 0
            and len(self._sleepers) >= self._active
        ):
            nxt = min(self._sleepers)
            if nxt > self._now:
                self._now = nxt
                self._cv.notify_all()
