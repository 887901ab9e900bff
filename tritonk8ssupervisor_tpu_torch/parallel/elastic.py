"""Elastic training: supervisor-aware resume at the new world size. The
port of `tritonk8ssupervisor_tpu/parallel/elastic.py`, with the same names
and the same protocol.

The supervisor can detect, heal and ledger a slice loss; `ElasticTrainer`
makes the training job survive it: membership change is a recoverable
event, not a crash. The contract with the supervisor has two halves:

- **Down**: `fleet-status.json` carries a monotonic membership
  `generation` (bumped when a slice leaves or returns to the serving
  set) and a `heal_in_progress` flag (so the trainer WAITS for the heal
  instead of thrash-restarting into a half-healed fleet), plus the
  `draining` list: scheduled maintenance the trainer answers with a
  pre-preemption checkpoint while continuing to step.
  `FileHealthSource` reads it; absence or a torn read is *unknown,
  retry*, never healthy.
- **Up**: the trainer acknowledges through `job-ack.json` (atomic
  rewrite): `notified` when it saw the change, `resumed` when it is
  stepping again, `degraded` when the bounded wait ran out and it
  continues WITHOUT the lost slices.

At every step boundary the trainer polls the health source; on a
generation bump (or a mid-step collective failure, the unplanned form of
the same event) it:

1. flushes an emergency checkpoint (best-effort: a peer may already be
   gone, and then the last periodic checkpoint bounds the loss to one
   interval);
2. leaves the process group (`distributed.shutdown`);
3. waits bounded-with-backoff (`provision/retry.Cooldown`, decorrelated
   jitter) for the supervisor to finish healing, or, past `max_wait_s`,
   declares degraded continuation within its `max_degraded` budget;
4. re-runs `initialize_from_env` at the new process set, rebuilds the
   session (the injected `setup`) at the new world size, and restores
   the checkpoint into it.

Two places differ from the reference, because the port's training state
differs:

- **The step's shape.** The port's `make_lm_train_step` and
  `make_train_step` return `step(*batch) -> metrics` and update the
  `TrainState` in place. `TrainSession.step_fn` keeps the reference's
  `(state, *batch) -> (state, metrics)`, and `state_step_fn` wraps a port
  step in it for the `setup()` that builds a session.
- **`ElasticCheckpoint`** adapts the port's `TrainCheckpointer`. Its
  saves are synchronous, so `save(step, state)` has no `wait`. Its
  restore copies into the live state in place, so `restore` accepts the
  reference's `shardings` and does not use them, and needs no
  `abstract_like`.

Every seam (health source, checkpoint, cluster join/leave, clock/sleep,
drain probe) is injectable, so the reconfigure logic is held against the
reference's on a virtual clock (tests/test_torch_elastic.py), and the
real drill (two processes, one SIGKILLed mid-training, through
`cli/main.py train`) runs the exact same loop.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time
from pathlib import Path
from typing import Any, Callable

from tritonk8ssupervisor_tpu_torch.parallel import distributed
from tritonk8ssupervisor_tpu_torch.provision import retry

# the fleet-status reader, re-exported under the trainer-facing names the
# reference's module re-exports
from tritonk8ssupervisor_tpu_torch.provision.fleetview import (  # noqa: F401
    FileHealthSource,
    FleetView,
    HealthSource,
    ScriptedHealthSource,
    parse_fleet_status,
)
from tritonk8ssupervisor_tpu_torch.provision.state import atomic_write_text
from tritonk8ssupervisor_tpu_torch.utils.perf import drain_requested


class ElasticError(RuntimeError):
    """The trainer cannot make progress (repeated failed resumes)."""


# ----------------------------------------------------------------- job ack


class JobAck:
    """The trainer's half of the contract: job-ack.json, atomically
    rewritten (`provision/state.atomic_write_text`) so the supervisor's
    tick never reads a torn acknowledgement. `path=None` disables (a run
    without a supervisor, e.g. plain benchmarks)."""

    def __init__(self, path: Path | str | None, clock=time.time) -> None:
        self.path = Path(path) if path else None
        self._clock = clock

    def write(
        self,
        phase: str,
        generation: int | None,
        step: int,
        world: int | None = None,
        slices=(),
        reason: str = "",
    ) -> None:
        if self.path is None:
            return
        doc = {
            "v": 1,
            "ts": self._clock(),
            "phase": phase,
            "generation": generation,
            "step": int(step),
            "world": world,
            "slices": sorted(int(i) for i in slices),
            "reason": reason[:200],
        }
        atomic_write_text(self.path, json.dumps(doc, sort_keys=True) + "\n")


# ------------------------------------------------------- cluster transitions


def default_initialize(env_file: Path | str | None = None, environ: dict | None = None,
                       device=None, backend: str | None = None):
    """(Re)join the cluster from the env contract: the production
    init_fn/rejoin_fn (`distributed.initialize_from_env`; `device` and
    `backend` as there). With `env_file`, the FILE is authoritative on
    rejoin: after a heal, the provisioning layer rewrites the host's env
    file with the new process set, while this process's inherited env
    vars still describe the old world."""
    if env_file is not None:
        env_file = Path(env_file)
        if env_file.exists():
            environ = distributed.parse_flat(env_file.read_text())
        elif environ is None:
            environ = {}
        return distributed.initialize_from_env(environ=environ, env_file=env_file,
                                               device=device, backend=backend)
    return distributed.initialize_from_env(environ, device=device, backend=backend)


def default_shutdown() -> None:
    """Leave the current process group (`distributed.shutdown`,
    best-effort: the coordinator may be the host that died). The
    reference also clears JAX's backends so the next `jax.devices()` sees
    the new world; torch caches no device set to clear."""
    distributed.shutdown()


# ------------------------------------------------------------------ trainer


@dataclasses.dataclass
class ElasticPolicy:
    """Knobs for the elastic loop (docs/failure-modes.md lists them)."""

    checkpoint_every: int = 50  # steps between durable checkpoints
    poll_every: int = 1  # steps between health polls
    wait_base_s: float = 5.0  # first heal-wait probe delay
    wait_cap_s: float = 60.0  # decorrelated-jitter cap (retry.Cooldown)
    max_wait_s: float = 600.0  # give up waiting -> degraded continuation
    max_degraded: int = 0  # slices the job will continue without
    max_consecutive_failures: int = 3  # resumes with zero progress


@dataclasses.dataclass
class TrainSession:
    """One world's training surface, built by the caller's `setup()`:
    state + its shardings (None for the port's `TrainState`, which keeps
    its own specs), the step, and the mesh it runs on (None without a
    process group). `setup` is re-run after every membership change: it
    must rebuild the mesh from the CURRENT process group."""

    state: Any
    shardings: Any
    step_fn: Callable  # (state, *batch) -> (state, metrics)
    mesh: Any = None


def state_step_fn(step: Callable[..., dict]) -> Callable:
    """A port train step (`step(*batch) -> metrics`, updating its
    `TrainState` in place) as the reference's `(state, *batch) -> (state,
    metrics)`, for `TrainSession.step_fn`."""
    def step_fn(state, *batch):
        return state, step(*batch)

    return step_fn


def _state_step(state: Any, fallback: int) -> int:
    """The step counter carried by TrainState pytrees; `fallback` for
    toy/fake states without one."""
    step = getattr(state, "step", None)
    if step is None:
        return fallback
    try:
        return int(step)
    except (TypeError, ValueError):
        return fallback


class ElasticCheckpoint:
    """`parallel/checkpoint.TrainCheckpointer` adapted to the trainer's
    duck-typed needs (latest_step, save, restore), so fakes in tests only
    implement three methods. The port's saves are synchronous, so `save`
    has no `wait`; `restore` copies into the live state in place, so it
    takes the reference's `shardings` and does not use them.

    Pass a zero-arg factory instead of an instance to defer construction
    until first use, and `reset()` drops it between worlds: the
    checkpointer's barriers belong to the process group it was used in,
    and the next world builds a fresh one."""

    def __init__(self, checkpointer) -> None:
        if callable(checkpointer):
            self._ckpt, self._factory = None, checkpointer
        else:
            self._ckpt, self._factory = checkpointer, None

    def _resolve(self):
        if self._ckpt is None:
            self._ckpt = self._factory()
        return self._ckpt

    def latest_step(self) -> int | None:
        return self._resolve().latest_step()

    def save(self, step: int, state: Any) -> None:
        self._resolve().save(step, state)

    def restore(self, state: Any, shardings: Any = None, step: int | None = None) -> Any:
        del shardings  # the restore copies into `state`, on its own mesh
        return self._resolve().restore(state, step=step)

    def reset(self) -> None:
        """Drop the cached checkpointer so the next use rebuilds it in the
        CURRENT world (no-op without a factory). Called by the trainer
        between leaving the old world and restoring in the new one."""
        if self._factory is None or self._ckpt is None:
            return
        try:
            self._ckpt.close()
        except Exception:  # noqa: BLE001 - the old world may be gone
            pass
        self._ckpt = None

    def close(self) -> None:
        if self._ckpt is not None:
            self._ckpt.close()


class ElasticTrainer:
    """The elastic loop around the make_train_step/make_lm_train_step
    machinery. See the module docstring for the protocol; every
    collaborator is injectable:

    - setup:      () -> TrainSession, re-run per world
    - batch_fn:   (session, step) -> step args tuple
    - checkpoint: latest_step()/save(step, state)/restore(state, shardings)
                  (ElasticCheckpoint wraps TrainCheckpointer)
    - health:     HealthSource
    - ack:        JobAck (or None)
    - init_fn / rejoin_fn / shutdown_fn: cluster transitions
    - drain_fn:   () -> reason|None (utils/perf.drain_requested)
    """

    def __init__(
        self,
        setup: Callable[[], TrainSession],
        batch_fn: Callable[[TrainSession, int], tuple],
        checkpoint,
        health: HealthSource,
        policy: ElasticPolicy | None = None,
        ack: JobAck | None = None,
        init_fn: Callable[[], Any] | None = None,
        rejoin_fn: Callable[[], Any] | None = None,
        shutdown_fn: Callable[[], None] = default_shutdown,
        drain_fn: Callable[[], str | None] | None = drain_requested,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[], float] = random.random,
        echo: Callable[[str], None] = lambda line: print(line, flush=True),
    ) -> None:
        self._setup = setup
        self._batch_fn = batch_fn
        self._ckpt = checkpoint
        self._health = health
        self.policy = policy or ElasticPolicy()
        self._ack = ack or JobAck(None)
        self._init_fn = init_fn or default_initialize
        self._rejoin_fn = rejoin_fn or self._init_fn
        self._shutdown_fn = shutdown_fn
        self._drain_fn = drain_fn
        self._clock = clock
        self._sleep = sleep
        self._rng = rng
        self._echo = echo
        self.session: TrainSession | None = None
        self.generation: int | None = None
        self.world: Any = None  # the last ClusterEnv (or None)

    # ------------------------------------------------------------- helpers

    def _say(self, text: str) -> None:
        self._echo(f"[elastic] {text}")

    def _world_size(self) -> int | None:
        env = self.world
        return getattr(env, "num_processes", None) if env is not None else 1

    def _save(self, step: int) -> bool:
        """Persist the current state; best-effort (an emergency flush
        after the coordinator died may fail: the last periodic
        checkpoint then bounds the loss). Synchronous, so the reference's
        `wait` for its emergency and final saves has no counterpart."""
        try:
            self._ckpt.save(step, self.session.state)
            return True
        except Exception as e:  # noqa: BLE001 - durability is best-effort
            self._say(f"checkpoint save at step {step} failed "
                      f"({type(e).__name__}: {e}); continuing on the "
                      "previous checkpoint")
            return False

    def _restore(self, fallback_step: int) -> int:
        """Restore the latest complete checkpoint into the CURRENT
        session's shardings; returns the step training resumes at."""
        latest = self._ckpt.latest_step()
        if latest is None:
            return fallback_step
        self.session.state = self._ckpt.restore(
            self.session.state, self.session.shardings
        )
        return _state_step(self.session.state, latest)

    # -------------------------------------------------------- reconfigure

    def _wait_for_heal(self) -> tuple[FleetView | None, bool, float]:
        """Bounded wait for the supervisor: returns (last view, degraded,
        seconds waited). Exits early on a settled fleet — healthy, or
        degraded within the trainer's own budget once no heal is in
        flight; a fleet still healing (heal_in_progress) is always worth
        waiting for inside the budget.

        Staleness guard: after an UNPLANNED event (our collective died),
        a status document the supervisor wrote BEFORE the incident still
        says "healthy" — trusting it would resume straight into the
        broken fleet and fail again. A view is only evidence once it is
        *fresh*: its generation moved past ours, or its `updated` stamp
        changed from the first view this wait observed. (Stamps are
        compared for inequality, never across clock domains.)"""
        policy = self.policy
        cooldown = retry.Cooldown(policy.wait_base_s, policy.wait_cap_s,
                                  rng=self._rng)
        start = self._clock()
        deadline = start + policy.max_wait_s
        baseline = self._health.poll()
        view = baseline

        def fresh(v: FleetView) -> bool:
            if self.generation is None or v.generation != self.generation:
                return True
            if baseline is None:
                return True
            return v.updated != baseline.updated

        while True:
            if view is not None and not view.heal_in_progress \
                    and fresh(view):
                if view.verdict == "healthy":
                    return view, False, self._clock() - start
                if (len(view.degraded) <= policy.max_degraded
                        and view.verdict in ("degraded", "degraded-hold")):
                    # the supervisor has stopped (or been stopped from)
                    # healing and the loss fits the budget: continue
                    # degraded now rather than burn the whole wait
                    return view, True, self._clock() - start
            remaining = deadline - self._clock()
            if remaining <= 0:
                return view, True, self._clock() - start
            self._sleep(min(cooldown.next(), remaining))
            view = self._health.poll()

    def _reconfigure(self, step: int, last_saved: int, reason: str,
                     state_intact: bool, report: dict) -> int:
        """The membership-change path: flush, leave, wait, rejoin,
        rebuild, restore. Returns the step training resumes at."""
        policy = self.policy
        now = self._clock()
        self._say(f"membership change at step {step}: {reason}")
        if state_intact:
            if self._save(step):
                last_saved = step
        self._ack.write("notified", self.generation, step,
                        world=self._world_size(), reason=reason)
        self._shutdown_fn()
        reset = getattr(self._ckpt, "reset", None)
        if reset is not None:
            reset()  # the old world's checkpoint manager dies with it
        view, degraded, waited = self._wait_for_heal()
        self.world = self._rejoin_fn()
        self.session = self._setup()
        resumed_at = self._restore(last_saved)
        lost = max(0, step - resumed_at)
        self.generation = view.generation if view is not None \
            else self.generation
        slices = tuple(view.degraded) if (degraded and view) else ()
        phase = "degraded" if degraded else "resumed"
        self._ack.write(phase, self.generation, resumed_at,
                        world=self._world_size(), slices=slices,
                        reason=reason)
        self._say(
            f"resumed at step {resumed_at} "
            f"(world size {self._world_size()}, "
            f"{'DEGRADED without slice(s) %s' % (list(slices),) if degraded else 'fleet healthy'}, "
            f"waited {waited:.0f}s, lost {lost} step(s))"
        )
        report["resumes"].append({
            "ts": self._clock(),
            "reason": reason,
            "at_step": step,
            "resumed_step": resumed_at,
            "steps_lost": lost,
            "degraded": degraded,
            "degraded_slices": list(slices),
            "generation": self.generation,
            "world": self._world_size(),
            "waited_s": round(waited, 3),
            "notice_ts": now,
        })
        report["steps_lost"] += lost
        return resumed_at

    # ---------------------------------------------------------------- run

    def run(self, total_steps: int) -> dict:
        """Train to `total_steps`, surviving membership changes. Returns
        the report: start/final step, resumes (with per-resume steps
        lost and wait), and drain flushes."""
        policy = self.policy
        view = self._health.poll()
        self.generation = view.generation if view is not None else None
        self.world = self._init_fn()
        self.session = self._setup()
        step = self._restore(0)
        start_step = step
        report = {
            "start_step": start_step,
            "final_step": step,
            "steps_lost": 0,
            "resumes": [],
            "drain_flushes": 0,
        }
        if step > 0:
            self._say(f"resuming from checkpoint at step {step}")
        last_saved = step
        last_polled = None
        drain_flushed = False
        failures_at: int | None = None
        failures = 0
        while step < total_steps:
            # ---- step-boundary health consultation
            reason = None
            if last_polled is None or step - last_polled >= policy.poll_every:
                last_polled = step
                view = self._health.poll()
                if view is not None:
                    if self.generation is None:
                        self.generation = view.generation
                    elif view.generation != self.generation:
                        reason = (f"generation "
                                  f"{self.generation} -> {view.generation}")
                drain = self._drain_fn() if self._drain_fn else None
                if drain is None and view is not None and view.draining:
                    drain = (f"slice(s) {list(view.draining)} draining "
                             "per fleet status")
                if reason is None and drain and not drain_flushed:
                    # the pre-preemption checkpoint window: scheduled
                    # maintenance was announced but the world has not
                    # changed yet — flush NOW, keep stepping, and the
                    # coming generation bump (or kill) costs ~0 steps
                    self._say(f"drain notice ({drain}); flushing "
                              f"checkpoint at step {step}")
                    if self._save(step):
                        last_saved = step
                        drain_flushed = True
                        report["drain_flushes"] += 1
                    self._ack.write("notified", self.generation, step,
                                    world=self._world_size(),
                                    reason=f"drain: {drain}"[:200])
            if reason is not None:
                step = self._reconfigure(step, last_saved, reason,
                                         state_intact=True, report=report)
                last_saved = step
                last_polled = None
                drain_flushed = False
                continue
            # ---- one optimizer step
            try:
                self.session.state, _metrics = self.session.step_fn(
                    self.session.state, *self._batch_fn(self.session, step)
                )
                step += 1
                failures = 0
                failures_at = None
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 - a collective dying
                # under us IS the unplanned membership signal: the
                # in-flight state is suspect, so resume from the last
                # durable checkpoint (<= one interval of loss)
                if failures_at == step:
                    failures += 1
                else:
                    failures, failures_at = 1, step
                if failures >= policy.max_consecutive_failures:
                    raise ElasticError(
                        f"step {step} failed {failures} times with no "
                        f"progress between resumes; giving up: {e}"
                    ) from e
                step = self._reconfigure(
                    step, last_saved,
                    f"step failure: {type(e).__name__}: {e}"[:200],
                    state_intact=False, report=report,
                )
                last_saved = step
                last_polled = None
                drain_flushed = False
                continue
            # ---- periodic durability
            if step - last_saved >= policy.checkpoint_every \
                    or step >= total_steps:
                if self._save(step):
                    last_saved = step
                    drain_flushed = False
        report["final_step"] = step
        report["world"] = self._world_size()
        report["generation"] = self.generation
        return report
