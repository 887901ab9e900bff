"""Streaming subprocess execution shared by the terraform/ansible/kubectl
wrappers.

The reference ran child tools inline in the shell with `set -o errexit`
(setup.sh:3-4) so a non-zero exit aborted the run. `run_streaming` keeps
that contract (raise on failure) while letting tests substitute a recording
fake. Both runners take an optional `timeout=`: a wedged child blocks
inside code no signal handler can unwind (the bench.py subprocess-probe
lesson — a hard PJRT wedge survives SIGALRM; only killing the process
does), so terraform/ansible/kubectl children get the same treatment —
kill the whole process group, raise rc 124 (the `timeout(1)` convention),
and let the retry layer classify the hang as transient.

The port's copy of `tritonk8ssupervisor_tpu/provision/runner.py`, whole
and under the reference's names: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence


class CommandError(RuntimeError):
    def __init__(self, args: Sequence[str], returncode: int, tail: str = ""):
        self.args_run = list(args)
        self.returncode = returncode
        self.tail = tail  # captured output — what the retry classifier reads
        super().__init__(
            f"command failed ({returncode}): {' '.join(args)}"
            + (f"\n{tail}" if tail else "")
        )


# Signature shared by the real runner and test fakes: returns captured
# stdout (streamed live too, like the reference's inline terraform output).
RunFn = Callable[..., str]


def run_streaming(
    args: Sequence[str],
    cwd: Path | None = None,
    env: dict | None = None,
    echo: Callable[[str], None] = lambda line: print(line, flush=True),
    timeout: float | None = None,
) -> str:
    try:
        proc = subprocess.Popen(
            list(args),
            cwd=str(cwd) if cwd else None,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            # own process group, so a timeout kill reaps terraform's
            # provider plugins / ansible's forks too, not just the leader
            start_new_session=timeout is not None,
        )
    except OSError as e:
        # missing binary / missing cwd -> same friendly path as a failure
        raise CommandError(args, 127, tail=str(e)) from e
    timed_out = threading.Event()
    watchdog = None
    if timeout is not None:
        def _kill() -> None:
            timed_out.set()
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass  # already gone

        watchdog = threading.Timer(timeout, _kill)
        watchdog.daemon = True
        watchdog.start()
    captured: list[str] = []
    assert proc.stdout is not None
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            captured.append(line)
            echo(line)
        proc.wait()
    finally:
        if watchdog is not None:
            watchdog.cancel()
    if timed_out.is_set():
        raise CommandError(
            args, 124,
            tail="\n".join(captured[-20:] + [f"killed after {timeout:g}s timeout"]),
        )
    output = "\n".join(captured)
    if proc.returncode != 0:
        raise CommandError(args, proc.returncode, tail="\n".join(captured[-20:]))
    return output


def run_capture(
    args: Sequence[str],
    cwd: Path | None = None,
    env: dict | None = None,
    timeout: float | None = None,
) -> str:
    """Quiet variant for machine-read output (terraform output -json etc.)."""
    try:
        proc = subprocess.run(
            list(args),
            cwd=str(cwd) if cwd else None,
            env=env,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired as e:
        tail = (e.stdout or b"")
        if isinstance(tail, bytes):
            tail = tail.decode("utf-8", errors="replace")
        raise CommandError(
            args, 124, tail=tail[-2000:] + f"\nkilled after {timeout:g}s timeout"
        ) from e
    except OSError as e:
        raise CommandError(args, 127, tail=str(e)) from e
    if proc.returncode != 0:
        raise CommandError(args, proc.returncode, tail=proc.stderr[-2000:])
    return proc.stdout
