"""Local multi-process cluster harness for drills and tests: the port's
copy of `tritonk8ssupervisor_tpu/testing/localcluster.py`, whole and under
the reference's names.

Launch N rendezvousing worker processes carrying the exact env contract
the tpuhost ansible role / GKE Job manifests emit (JAX_* coordinates,
TK8S_* cross-slice arithmetic), which the port's
`parallel/distributed.py` reads as its process group's address, size and
rank; collect their outputs; and clean up by **process-group SIGKILL**:
each worker is launched in its own session, so a timed-out or
assertion-failed drill reaps the worker AND anything it spawned, instead
of orphaning rendezvous'd processes that sit in a collective holding the
coordinator port.

The reference also pins JAX's CPU devices in each worker's environment
(`JAX_PLATFORMS`, `XLA_FLAGS`); those mean nothing to the port. A port
worker takes its device from its command line (`cli.main train --device
cpu|cuda`), so `devices_per_process` is kept for the reference's
signature and sets nothing.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(
    pid: int,
    num_processes: int,
    port: int,
    devices_per_process: int = 1,
    num_slices: int = 1,
    extra: dict | None = None,
) -> dict:
    """The per-worker environment: single-slice workers get plain JAX_*
    coordinates; with num_slices > 1 each worker gets the CROSS-SLICE
    contract (within-slice JAX_PROCESS_ID + TK8S_* slice arithmetic) —
    exactly what a pod on slice s, completion index p sees."""
    assert num_processes % num_slices == 0
    per_slice = num_processes // num_slices
    env = dict(os.environ)
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = str(num_processes)
    if num_slices > 1:
        env["JAX_PROCESS_ID"] = str(pid % per_slice)
        env["TK8S_NUM_SLICES"] = str(num_slices)
        env["TK8S_SLICE_ID"] = str(pid // per_slice)
        env["TK8S_PROCS_PER_SLICE"] = str(per_slice)
    else:
        env["JAX_PROCESS_ID"] = str(pid)
    if extra:
        env.update({k: str(v) for k, v in extra.items()})
    return env


def launch_cluster(
    argv_for,
    num_processes: int = 2,
    devices_per_process: int = 1,
    num_slices: int = 1,
    extra_env: dict | None = None,
    port: int | None = None,
    cwd: Path | None = None,
) -> list[subprocess.Popen]:
    """Start the workers without waiting. `argv_for(pid)` returns each
    worker's command line (or pass a plain list for identical workers).
    Every worker runs in its OWN session/process group so kill_cluster
    can reap it and its children with one killpg."""
    port = free_port() if port is None else port
    procs: list[subprocess.Popen] = []
    for pid in range(num_processes):
        argv = argv_for(pid) if callable(argv_for) else list(argv_for)
        procs.append(subprocess.Popen(
            argv,
            env=worker_env(pid, num_processes, port,
                           devices_per_process=devices_per_process,
                           num_slices=num_slices, extra=extra_env),
            cwd=str(cwd or REPO),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            start_new_session=True,
        ))
    return procs


def kill_cluster(procs) -> None:
    """Process-group SIGKILL every still-running worker, then reap. With
    start_new_session each leader's pid IS its pgid, so the group kill
    takes the worker's own children (compiler helpers, nested drills) down with it — a failed drill must not leave rendezvous'd
    processes camped on the coordinator port."""
    for proc in procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except (subprocess.TimeoutExpired, OSError):  # pragma: no cover
            pass


def run_cluster(
    worker: str,
    num_processes: int = 2,
    devices_per_process: int = 1,
    timeout: int = 600,
    num_slices: int = 1,
    extra_env: dict | None = None,
) -> list[str]:
    """Launch `worker` (python -c source) in `num_processes`
    rendezvousing subprocesses and return their outputs; on any failure
    or timeout, process-group-kill every sibling (a crashed rank leaves
    the others blocked in the collective) and fail with all outputs."""
    procs = launch_cluster(
        [sys.executable, "-c", worker],
        num_processes=num_processes,
        devices_per_process=devices_per_process,
        num_slices=num_slices,
        extra_env=extra_env,
    )
    outputs = [""] * num_processes
    try:
        for pid, proc in enumerate(procs):
            try:
                outputs[pid], _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                outputs[pid] = f"<timeout after {timeout}s>"
                raise
        for pid, proc in enumerate(procs):
            assert proc.returncode == 0, (
                f"process {pid} failed:\n" + "\n---\n".join(outputs)
            )
    finally:
        kill_cluster(procs)
    return outputs
