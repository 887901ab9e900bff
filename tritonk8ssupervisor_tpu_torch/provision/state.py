"""Atomic rewrite of a polled state file: the port's copy of
`tritonk8ssupervisor_tpu/provision/state.py::atomic_write_text`."""

from __future__ import annotations

import os
import threading
from pathlib import Path


def atomic_write_text(path: Path | str, text: str) -> None:
    """Write via a same-directory temp file and `os.replace`, so a reader
    sees the old content or the new, never a torn half-write. The temp
    name carries the pid and the thread id: two writers in one process
    (worker threads) or in two processes never replace each other's
    half-written file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)
