"""Dependency-graph executor for the provisioning pipeline.

The reference's `main` was a straight line (setup.sh:8-92) and the rebuilt
pipeline kept that shape: terraform → readiness → ansible → manifests, one
after another, even where nothing orders them (compiling manifests needs
only the config, not a live cluster). Wall-clock-to-ready is the north-star
metric (BASELINE.md), so the line becomes a DAG: named tasks with explicit
`after=` edges, executed by a bounded thread pool that starts every task
the moment its dependencies finish — the overlap-independent-work
discipline of pipelined-parallel systems (GPipe in PAPERS.md: keep
independent stages busy instead of barriering).

Failure semantics preserve the errexit-with-retries contract:

- Transient faults retry INSIDE a task (the runners each task calls are
  already wrapped by provision/retry.py's classifier+backoff); the
  scheduler never second-guesses that layer.
- A task that raises — i.e. a FATAL fault, or a transient one that
  exhausted its budget — fails the DAG fast: no new tasks are submitted,
  not-yet-started tasks are marked skipped, and the ORIGINAL exception
  re-raises unchanged once in-flight tasks drain (cli/main.py's friendly
  ERROR path keys on exception type).
- In-flight tasks are never abandoned mid-run: threads can't be killed,
  so the scheduler waits for them — no orphaned threads holding half-open
  subprocesses past the run's end.

Crash-safety layers a durable ledger on top (provision/journal.py):
with `journal=`, every task transition is fsync'd to an append-only JSONL
file, and a re-run skips the verified prefix — tasks whose recorded
inputs-hash and artifact digests still match, reached only through other
skipped tasks — executing just the dirty suffix. A SIGKILL'd supervisor
resumes mid-DAG instead of from zero.

The port's copy of `tritonk8ssupervisor_tpu/provision/scheduler.py`, whole
and under the reference's names: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import sys
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from pathlib import Path
from typing import Callable


class SchedulerError(ValueError):
    """The task graph itself is malformed (duplicate name, unknown or
    cyclic dependency) — always a programming error, never a runtime
    fault, so it raises before any task starts."""


@dataclasses.dataclass(frozen=True)
class Task:
    """One named unit of pipeline work.

    `fn` receives the results-so-far mapping {task name: return value};
    every dependency named in `after` is guaranteed present when it runs.

    The journal fields are optional and only consulted when run_dag gets a
    `journal=`:

    - `inputs_hash` fingerprints everything that, when changed, must make
      a recorded completion stale (journal.inputs_hash of tfvars, config,
      CLI knobs). Empty means "never resume-skip this task".
    - `artifacts` are the on-disk outputs whose digests are recorded at
      done-time and re-verified before a skip (tfstate, hosts.json,
      inventory, manifest dir).
    - `restore` recomputes the task's return value from those artifacts
      when the task is skipped (e.g. load hosts.json instead of re-running
      terraform), so dependents see the same results mapping either way.
    """

    name: str
    fn: Callable[[dict], object]
    after: tuple[str, ...] = ()
    inputs_hash: str = ""
    artifacts: tuple[Path, ...] = ()
    restore: Callable[[dict], object] | None = None


def validate(tasks: list[Task]) -> list[Task]:
    """Check names/edges and return a topological order (stable: ties keep
    input order, which also makes max_workers=1 runs deterministic)."""
    names = [t.name for t in tasks]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise SchedulerError(f"duplicate task name(s): {sorted(dupes)}")
    known = set(names)
    for t in tasks:
        missing = [d for d in t.after if d not in known]
        if missing:
            raise SchedulerError(
                f"task {t.name!r} depends on unknown task(s) {missing}"
            )
    order: list[Task] = []
    done: set[str] = set()
    remaining = list(tasks)
    while remaining:
        ready = [t for t in remaining if all(d in done for d in t.after)]
        if not ready:
            raise SchedulerError(
                "dependency cycle among: "
                f"{sorted(t.name for t in remaining)}"
            )
        order.extend(ready)
        done.update(t.name for t in ready)
        remaining = [t for t in remaining if t.name not in done]
    return order


def run_dag(
    tasks: list[Task],
    *,
    max_workers: int = 4,
    timer=None,
    journal=None,
    on_submit: Callable[[Task], None] | None = None,
    on_settled: Callable[[Task], None] | None = None,
    echo: Callable[[str], None] = lambda line: print(
        line, file=sys.stderr, flush=True
    ),
) -> dict[str, object]:
    """Execute the graph; return {task name: fn's return value}.

    `timer` (a utils.phases.PhaseTimer) wraps each task in
    `timer.phase(name, after=...)` inside its worker thread, so the runlog
    records overlapping spans and the dependency edges the critical-path
    analysis needs. `on_submit` fires in the submitting thread right
    before a task is handed to the pool; `on_settled` fires in the
    scheduling thread once a finished task's result has been recorded AND
    its newly-ready dependents submitted (success or failure). Together
    they bracket a task's in-flight window with no gap — which is what
    lets the simulation harness (testing/simclock.py) keep virtual time
    deterministic across real threads.

    On the first task failure the scheduler stops submitting, drains the
    in-flight tasks, reports any tasks it skipped, and re-raises the
    first error unchanged. Later failures from already-running tasks are
    echoed, not raised — one run, one verdict.

    `journal` (a provision.journal.Journal, already holding its writer
    lock) turns the run crash-safe: each task's running/done/failed
    transition is fsync'd before/after execution, and at submit time a
    task is SKIPPED — `restore`d instead of executed — when the replayed
    ledger verifies it (recorded inputs-hash matches, artifact digests
    match, and every dependency was itself skipped, so an upstream re-run
    dirties the whole suffix). Failed/killed tasks re-run with attempt
    numbers continuing the recorded history. A BaseException that is not
    an Exception (KeyboardInterrupt, a simulated SIGKILL) writes nothing:
    the lingering `running` record IS the crash signature resume keys on.
    """
    order = validate(tasks)
    if not order:
        return {}
    by_name = {t.name: t for t in order}
    results: dict[str, object] = {}
    done: set[str] = set()
    pending = list(order)  # not yet submitted, in stable topo order
    failure: BaseException | None = None
    failed_or_skipped: list[str] = []
    replayed = journal.replay() if journal is not None else {}
    restored: set[str] = set()  # journal-verified skips this run

    def run_task(task: Task):
        if journal is not None:
            prior = replayed.get(task.name)
            attempt = (prior.attempts if prior is not None else 0) + 1
            journal.note_running(task.name, task.inputs_hash, attempt)
        try:
            if timer is not None:
                with timer.phase(task.name, after=task.after):
                    result = task.fn(results)
            else:
                result = task.fn(results)
        except BaseException as e:
            # Only genuine task failures are journaled; a non-Exception
            # BaseException models the supervisor dying mid-task, which
            # writes nothing — the open `running` record marks the task
            # dirty for the resume run, exactly like a real SIGKILL.
            if journal is not None and isinstance(e, Exception):
                journal.note_failed(task.name, task.inputs_hash, str(e))
            raise
        if journal is not None:
            journal.note_done(task.name, task.inputs_hash, task.artifacts)
        return result

    with ThreadPoolExecutor(
        max_workers=max(1, max_workers), thread_name_prefix="tk8s-dag"
    ) as pool:
        futures: dict = {}

        def submit_ready() -> None:
            nonlocal pending
            # Loop because a journal-verified skip completes a task
            # instantly, which can make its dependents ready within the
            # same scheduling round (a fully-verified prefix collapses
            # without ever touching the pool).
            while True:
                ready = [t for t in pending
                         if all(d in done for d in t.after)]
                ready_names = {t.name for t in ready}
                pending = [t for t in pending if t.name not in ready_names]
                to_submit = []
                skipped_any = False
                for task in ready:
                    if (
                        journal is not None
                        and all(d in restored for d in task.after)
                        and journal.verified_done(
                            replayed, task.name, task.inputs_hash,
                            task.artifacts,
                        )
                    ):
                        results[task.name] = (
                            task.restore(results)
                            if task.restore is not None else None
                        )
                        done.add(task.name)
                        restored.add(task.name)
                        skipped_any = True
                        echo(f"  {task.name}: journal-verified; skipping")
                        if timer is not None and hasattr(timer, "note_skip"):
                            timer.note_skip(task.name, after=task.after)
                    else:
                        to_submit.append(task)
                # announce the WHOLE batch before submitting any of it: a
                # task handed to the pool can start (and block on a virtual
                # clock) instantly, and on_submit accounting must already
                # cover its still-unsubmitted siblings (testing/simclock.py)
                if on_submit is not None:
                    for task in to_submit:
                        on_submit(task)
                for task in to_submit:
                    futures[pool.submit(run_task, task)] = task
                if not skipped_any:
                    break

        submit_ready()
        while futures:
            finished, _ = wait(futures, return_when=FIRST_COMPLETED)
            settled = []
            for fut in finished:
                task = futures.pop(fut)
                settled.append(task)
                try:
                    results[task.name] = fut.result()
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    failed_or_skipped.append(task.name)
                    if failure is None:
                        failure = e
                        if futures:
                            echo(
                                f"  task {task.name!r} failed; waiting for "
                                f"{len(futures)} in-flight task(s), "
                                "cancelling the rest"
                            )
                    else:
                        echo(f"  task {task.name!r} also failed: {e}")
                else:
                    done.add(task.name)
            if failure is None:
                submit_ready()
            if on_settled is not None:
                for task in settled:
                    on_settled(task)
    if failure is not None:
        skipped = [t.name for t in pending]
        failed_or_skipped.extend(skipped)
        if skipped:
            echo(f"  skipped (dependencies failed): {', '.join(skipped)}")
        raise failure
    return results


def critical_path(tasks: list[Task], durations: dict[str, float]) -> list[str]:
    """Longest dependency chain by summed duration — the floor on DAG
    wall-clock no concurrency can beat. Tasks missing from `durations`
    count as 0."""
    order = validate(tasks)
    best: dict[str, float] = {}
    prev: dict[str, str | None] = {}
    for t in order:
        via = max(t.after, key=lambda d: best[d], default=None)
        best[t.name] = durations.get(t.name, 0.0) + (best[via] if via else 0.0)
        prev[t.name] = via
    if not best:
        return []
    tail: str | None = max(best, key=lambda n: best[n])
    path: list[str] = []
    while tail is not None:
        path.append(tail)
        tail = prev[tail]
    return list(reversed(path))
