"""The durable JSONL ledger that the request journal (`serving/reqlog.py`)
and the span log (`obs/trace.py`) inherit: the port's copy of
`SCHEMA_VERSION`, `EventLedgerError` and `EventLedger` from
`tritonk8ssupervisor_tpu/provision/events.py` (:40, :139-331).

The discipline, as in the reference:

- append + flush + fsync, so every record survives a SIGKILL landing on
  the next instruction;
- a torn FINAL line (the one write a kill interrupted) is detected and
  physically truncated on replay, never fatal; mid-file corruption with
  valid records after it raises;
- records from a newer schema version are skipped, not misread.

The reference's base `compact()` folds the supervisor's `LedgerView`; the
port has no supervisor ledger yet (ROADMAP.md, item 7c-2), and neither
subclass calls it (`RequestLog` overrides it, `SpanLog` never compacts),
so it is left out.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

SCHEMA_VERSION = 1


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

    def scrub(self) -> None:
        """Delete the ledger (teardown)."""
        with self._mutex:
            self._drop_writer()
            self.path.unlink(missing_ok=True)
