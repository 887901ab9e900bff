"""Durable provisioning ledger: crash-safe resume for the DAG pipeline.

The reference's only resume property was files-as-phase-contract (state.py,
skip-if-present, reference setup.sh:139-143): a re-run skipped a phase iff
its output file happened to exist — no record of WHICH inputs produced it,
no notion of a phase that died halfway. The DAG scheduler made the pipeline
concurrent but kept that amnesia: SIGKILL the supervisor and the next run
starts from zero. Podracer-style TPU orchestration (PAPERS.md, 2104.06272)
treats a killable controller as table stakes — the fleet's state must
outlive the process supervising it.

This module is that outliving state: an append-only, fsync'd, JSONL
ledger recording one line per DAG-task transition::

    {"v": 1, "ts": ..., "task": "terraform-apply", "status": "running",
     "inputs_hash": "9f2c...", "attempt": 1}
    {"v": 1, "ts": ..., "task": "terraform-apply", "status": "done",
     "inputs_hash": "9f2c...", "attempt": 1,
     "artifacts": {"terraform/tpu-vm/terraform.tfstate": "ab41...",
                   "terraform/hosts.json": "77d0..."}}

Append-only + fsync means every transition survives a SIGKILL landing the
next instruction; JSONL means a torn final line (the one write the kill
interrupted) is detectable and truncatable, never fatal. On re-run,
`run_dag(journal=...)` replays the ledger and skips a task iff

- its last record says ``done``,
- the recorded ``inputs_hash`` equals the task's current inputs-hash
  (config changed => dirty), and
- every recorded artifact (tfstate, hosts.json, inventory, manifests)
  still hashes to what the ledger saw at done-time (disk changed =>
  dirty), and
- every one of its dependencies was itself skipped (an upstream re-run
  dirties the whole suffix).

Everything else — the dirty suffix — re-executes, with attempt numbers
continuing the recorded history. A lockfile (pid-stamped, O_EXCL —
state.PidLock, shared with the event ledger) rejects a second concurrent
supervisor: two writers interleaving an append-only log would corrupt
the one artifact whose integrity resume depends on.

The port's copy of `tritonk8ssupervisor_tpu/provision/journal.py`, whole
and under the reference's names: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Iterable

from tritonk8ssupervisor_tpu_torch.provision.state import LockHeldError, PidLock

SCHEMA_VERSION = 1

RUNNING = "running"
DONE = "done"
FAILED = "failed"


class JournalError(RuntimeError):
    """The ledger itself is unusable (mid-file corruption, bad schema)."""


class JournalLockedError(JournalError):
    """Another live supervisor holds the journal lock."""


def inputs_hash(*parts) -> str:
    """Stable digest of a task's inputs — whatever, when changed, must
    dirty the task (tfvars, config fields, CLI knobs). Parts are JSON-
    serialised with sorted keys so dict ordering can't fake a change."""
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def digest_path(path: Path) -> str | None:
    """Content digest of an artifact: a file hashes its bytes, a directory
    hashes the sorted (relative name, file digest) pairs under it, and a
    missing path is None — so "the artifact vanished" and "the artifact
    never existed" compare equal only to each other."""
    path = Path(path)
    if path.is_dir():
        h = hashlib.sha256()
        for sub in sorted(p for p in path.rglob("*") if p.is_file()):
            h.update(str(sub.relative_to(path)).encode())
            h.update(hashlib.sha256(sub.read_bytes()).digest())
        return h.hexdigest()
    if path.is_file():
        return hashlib.sha256(path.read_bytes()).hexdigest()
    return None


@dataclasses.dataclass
class TaskLedger:
    """Replayed view of one task: its last transition plus attempt count."""

    task: str
    status: str = ""
    inputs_hash: str = ""
    attempts: int = 0  # total `running` records across all runs
    artifacts: dict = dataclasses.field(default_factory=dict)
    errors: list = dataclasses.field(default_factory=list)


class Journal:
    """The ledger handle. Open it (context manager) around a run to hold
    the writer lock; `replay()` works without the lock (read-only)."""

    def __init__(
        self,
        path: Path,
        clock=time.time,
        echo=lambda line: print(line, file=sys.stderr, flush=True),
    ) -> None:
        self.path = Path(path)
        self.lock_path = self.path.with_name(self.path.name + ".lock")
        self._clock = clock
        self._echo = echo
        self._mutex = threading.Lock()  # scheduler workers append concurrently
        self._lock = PidLock(
            self.lock_path,
            echo=lambda line: self._echo(
                f"stale journal lock {self.lock_path} (holder dead); "
                "taking over"
            ),
        )

    # ------------------------------------------------------------- locking

    def acquire(self) -> "Journal":
        """Take the single-writer lock (state.PidLock). A live pid in the
        lockfile means a second supervisor is running — reject; a dead pid
        is the residue of a crash (exactly the case resume exists for)
        and is stolen."""
        try:
            self._lock.acquire()
        except LockHeldError as e:
            raise JournalLockedError(
                f"journal {self.path} is locked by live supervisor "
                f"pid {e.pid} ({self.lock_path}); two concurrent "
                "provision runs over one workdir would corrupt the "
                "ledger — wait for it or kill it first"
            ) from e
        return self

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "Journal":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # ------------------------------------------------------------- writing

    def _append(self, record: dict) -> None:
        record = {"v": SCHEMA_VERSION, "ts": self._clock(), **record}
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._mutex:
            with self.path.open("a") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

    def note_running(self, task: str, inputs_hash: str, attempt: int) -> None:
        self._append({"task": task, "status": RUNNING,
                      "inputs_hash": inputs_hash, "attempt": attempt})

    def note_done(
        self, task: str, inputs_hash: str, artifacts: Iterable[Path] = ()
    ) -> None:
        digests = {str(p): digest_path(p) for p in artifacts}
        self._append({"task": task, "status": DONE,
                      "inputs_hash": inputs_hash, "artifacts": digests})

    def note_failed(self, task: str, inputs_hash: str, error: str) -> None:
        self._append({"task": task, "status": FAILED,
                      "inputs_hash": inputs_hash, "error": str(error)[:500]})

    # ------------------------------------------------------------- replay

    def replay(self) -> dict[str, TaskLedger]:
        """Last-transition-wins view of the ledger, attempt history summed.

        A corrupt FINAL line is a torn write — the one append a SIGKILL
        interrupted — so it is physically truncated away and replay
        proceeds; a corrupt line with valid records AFTER it is real
        corruption and raises JournalError. Records from a NEWER schema
        version are skipped (forward compat: an old supervisor must not
        misread fields it doesn't know), never fatal.
        """
        if not self.path.exists():
            return {}
        raw = self.path.read_text()
        ledgers: dict[str, TaskLedger] = {}
        lines = raw.splitlines(keepends=True)
        good_bytes = 0
        for i, line in enumerate(lines):
            stripped = line.strip()
            if not stripped:
                good_bytes += len(line)
                continue
            try:
                record = json.loads(stripped)
                if not isinstance(record, dict) or "task" not in record:
                    raise ValueError("record is not a task transition")
            except (json.JSONDecodeError, ValueError) as e:
                if i == len(lines) - 1:
                    self._echo(
                        f"journal {self.path}: torn final line "
                        f"(interrupted write) truncated: {stripped[:60]!r}"
                    )
                    with self.path.open("r+") as f:
                        f.truncate(good_bytes)
                    break
                raise JournalError(
                    f"journal {self.path} corrupt at line {i + 1} with "
                    f"valid records after it: {e}"
                ) from e
            good_bytes += len(line)
            if record.get("v", 0) > SCHEMA_VERSION:
                continue  # a newer supervisor's record: opaque, skip
            ledger = ledgers.setdefault(
                record["task"], TaskLedger(task=record["task"])
            )
            ledger.status = record.get("status", "")
            ledger.inputs_hash = record.get("inputs_hash", "")
            if ledger.status == RUNNING:
                ledger.attempts += 1
            elif ledger.status == DONE:
                ledger.artifacts = record.get("artifacts", {})
            elif ledger.status == FAILED:
                ledger.errors.append(record.get("error", ""))
        return ledgers

    def verified_done(
        self,
        ledgers: dict[str, TaskLedger],
        task: str,
        current_inputs_hash: str,
        artifact_paths: Iterable[Path] = (),
    ) -> bool:
        """True iff the replayed ledger proves `task` finished with THESE
        inputs and its on-disk artifacts are untouched. A task without an
        inputs-hash opted out of resume (e.g. the probe Job: a health
        check is only meaningful re-run) and never skips."""
        if not current_inputs_hash:
            return False
        ledger = ledgers.get(task)
        if ledger is None or ledger.status != DONE:
            return False
        if ledger.inputs_hash != current_inputs_hash:
            return False
        recorded = ledger.artifacts
        for p in artifact_paths:
            if str(p) not in recorded:
                return False  # done under an older artifact contract
        for p_str, digest in recorded.items():
            if digest_path(Path(p_str)) != digest:
                return False
        return True

    def compact(self) -> int:
        """Rewrite the ledger down to the last verified snapshot: one
        record per task, carrying its final transition (done records keep
        their artifact digests; failed keeps the last error; a lingering
        `running` — the crash signature — is preserved verbatim in
        effect). Returns the number of records dropped.

        The append-only ledger grows by a handful of lines per task per
        run, forever — across heal cycles and daily converges that is
        unbounded. After a fully-green run the history adds nothing the
        snapshot doesn't already prove (resume only consults the LAST
        transition plus digests), so cli/main.py compacts here. The
        rewrite is a same-directory temp file + fsync + os.replace:
        readers and a crash mid-compaction see the old ledger or the new
        one, never a truncation. Attempt history resets (compaction
        happens on green runs, where the history is spent anyway).
        """
        ledgers = self.replay()
        if not self.path.exists():
            return 0
        before = sum(
            1 for line in self.path.read_text().splitlines() if line.strip()
        )
        records = []
        for task, ledger in ledgers.items():
            record: dict = {
                "v": SCHEMA_VERSION, "ts": self._clock(), "task": task,
                "status": ledger.status, "inputs_hash": ledger.inputs_hash,
            }
            if ledger.status == DONE:
                record["artifacts"] = ledger.artifacts
            elif ledger.status == FAILED:
                record["error"] = ledger.errors[-1] if ledger.errors else ""
            elif ledger.status == RUNNING:
                record["attempt"] = ledger.attempts
            records.append(json.dumps(record, sort_keys=True) + "\n")
        tmp = self.path.with_name(f".{self.path.name}.compact.tmp")
        with self._mutex:
            with tmp.open("w") as f:
                f.writelines(records)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        dropped = before - len(records)
        if dropped > 0:
            self._echo(
                f"journal compacted: {before} records -> {len(records)}"
            )
        return dropped

    def scrub(self) -> None:
        """Delete the ledger and its lock — teardown's LAST act, so a
        clean that crashes halfway leaves the ledger (and with it the
        evidence of what ran) for the re-run."""
        self.path.unlink(missing_ok=True)
        self.lock_path.unlink(missing_ok=True)
