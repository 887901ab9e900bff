"""Start N ranks of one function on this machine: a local stand-in for
`torchrun --nproc-per-node N`.

    results = run_ranks(body, 4, args=(x,), backend="gloo")

Each rank is a fresh process (multiprocessing's "spawn" method) that
joins a process group of `world_size` ranks through a `FileStore` in a
temporary directory (no port to choose, so several launches can run at
once), calls `body(*args)`, and hands back what it returned. `body`
must be a module-level function (it is sent by import path) and its
result picklable; tensors are moved to the CPU first. A rank that
raises fails the launch with the rank's traceback; a launch that does
not finish within `timeout` seconds is killed, every process of it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist


def _to_cpu(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


def _rank_main(body: Callable, args: tuple, rank: int, world_size: int, backend: str,
               workdir: str, threads: int, timeout: float) -> None:
    out = Path(workdir, f"rank{rank}.pkl")
    try:
        torch.set_num_threads(threads)
        store = dist.FileStore(os.path.join(workdir, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = ("ok", _to_cpu(body(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the launcher, which raises
        result = ("error", traceback.format_exc())
    tmp = out.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(result))
    tmp.replace(out)


def run_ranks(body: Callable, world_size: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 300.0, threads: int | None = None) -> list:
    """Run `body(*args)` on `world_size` ranks of one process group and
    return their results in rank order. `threads` is each rank's torch
    thread count (default: the machine's cores shared out)."""
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world_size)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tk8s-ranks-") as workdir:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(body, args, rank, world_size, backend, workdir,
                                   threads, timeout))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        paths = [Path(workdir, f"rank{rank}.pkl") for rank in range(world_size)]
        results: list = [None] * world_size
        try:
            # poll, so that one rank's failure ends the launch at once
            # instead of leaving the others waiting in a collective
            while any(r is None for r in results):
                for rank, (p, path) in enumerate(zip(procs, paths)):
                    if results[rank] is not None:
                        continue
                    if path.exists():
                        status, value = pickle.loads(path.read_bytes())
                        if status != "ok":
                            raise RuntimeError(f"rank {rank} of {body.__name__} failed:\n{value}")
                        results[rank] = (value,)
                    elif not p.is_alive():
                        p.join()
                        if not path.exists():
                            raise RuntimeError(f"rank {rank} of {body.__name__} exited with "
                                               f"code {p.exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {body.__name__} did not "
                                       f"finish within {timeout:.0f} s")
                time.sleep(0.02)
        finally:
            # ranks that handed back a result are exiting; any other is killed
            for p, r in zip(procs, results):
                p.join(5.0 if r is not None else 0.0)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [r[0] for r in results]
