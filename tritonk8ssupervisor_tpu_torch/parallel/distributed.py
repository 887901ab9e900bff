"""Cluster coordinates: the port's copy of `cluster_env` from
`tritonk8ssupervisor_tpu/parallel/distributed.py` (:91-138).

A pure parser. The coordinates come from `/etc/tpu-cluster.env` (written
per host by the provisioning layer) overlaid per key by the process
environment (a Job's `JAX_*`/`TK8S_*` variables), so overriding only the
coordinator address keeps the process counts of the file. None means a
single process. In cross-slice mode the process count spans every slice
and a process's global id is `slice_id * procs_per_slice + process_id`
(slice-major).

The port forms no process group from them yet (`initialize_from_env` is
ROADMAP.md queue 1, item 5b): it runs on the group the caller started
(`parallel/ranks.run_ranks`, a test's gloo group, or the one
`init_from_launcher` joins under torchrun), and
`parallel/mesh.make_workload_mesh` reads the slice count from here.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import torch
import torch.distributed as dist

ENV_FILE = Path("/etc/tpu-cluster.env")

COORDINATOR_VAR = "JAX_COORDINATOR_ADDRESS"
NUM_PROCESSES_VAR = "JAX_NUM_PROCESSES"
PROCESS_ID_VAR = "JAX_PROCESS_ID"
# cross-slice coordinates (absent: one slice)
NUM_SLICES_VAR = "TK8S_NUM_SLICES"
SLICE_ID_VAR = "TK8S_SLICE_ID"
PROCS_PER_SLICE_VAR = "TK8S_PROCS_PER_SLICE"


def parse_flat(text: str) -> dict[str, str]:
    """KEY=value lines, blank lines and `#` comments skipped (the
    reference's `config/store.parse_flat`)."""
    flat: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        flat[key.strip()] = value.strip()
    return flat


@dataclasses.dataclass(frozen=True)
class ClusterEnv:
    coordinator_address: str
    num_processes: int  # across every slice in cross-slice mode
    process_id: int  # within the slice
    num_slices: int = 1
    slice_id: int = 0
    procs_per_slice: int | None = None

    @property
    def is_multi_host(self) -> bool:
        return self.num_processes > 1

    @property
    def is_multi_slice(self) -> bool:
        return self.num_slices > 1

    @property
    def global_process_id(self) -> int:
        """Slice-major id over every host: slice 0's are [0, P), slice 1's
        [P, 2P), ...; `process_id` in single-slice mode."""
        if not self.is_multi_slice:
            return self.process_id
        return self.slice_id * self.procs_per_slice + self.process_id


def cluster_env(environ: dict | None = None, env_file: Path = ENV_FILE) -> ClusterEnv | None:
    """The cluster's coordinates, or None for a single process. Raises
    RuntimeError on an incomplete or inconsistent environment."""
    environ = dict(os.environ) if environ is None else dict(environ)
    if env_file.exists():
        environ = {**parse_flat(env_file.read_text()), **environ}
    if COORDINATOR_VAR not in environ:
        return None
    try:
        num_slices = int(environ.get(NUM_SLICES_VAR, "1"))
        if num_slices > 1:
            slice_id = int(environ[SLICE_ID_VAR])
            procs_per_slice = int(environ[PROCS_PER_SLICE_VAR])
        else:
            slice_id, procs_per_slice = 0, None
        env = ClusterEnv(
            coordinator_address=environ[COORDINATOR_VAR],
            num_processes=int(environ[NUM_PROCESSES_VAR]),
            process_id=int(environ[PROCESS_ID_VAR]),
            num_slices=num_slices,
            slice_id=slice_id,
            procs_per_slice=procs_per_slice,
        )
    except KeyError as e:
        raise RuntimeError(
            f"incomplete cluster environment: {e.args[0]} is unset but "
            f"{COORDINATOR_VAR} is present"
        ) from None
    if env.is_multi_slice:
        if not 0 <= env.slice_id < env.num_slices:
            raise RuntimeError(
                f"{SLICE_ID_VAR}={env.slice_id} out of range for "
                f"{NUM_SLICES_VAR}={env.num_slices}"
            )
        if env.num_slices * env.procs_per_slice != env.num_processes:
            raise RuntimeError(
                f"{NUM_PROCESSES_VAR}={env.num_processes} must equal "
                f"{NUM_SLICES_VAR} x {PROCS_PER_SLICE_VAR} "
                f"({env.num_slices} x {env.procs_per_slice}) — in cross-slice "
                "mode the process count spans every slice"
            )
    return env


def init_from_launcher(environ: dict | None = None) -> bool:
    """Join the process group a launcher describes in the environment
    (torchrun's WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    NCCL on this process's card (LOCAL_RANK), gloo without a card. True
    when it joined one; False for a single process or when a group exists."""
    environ = os.environ if environ is None else environ
    if int(environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    backend = "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    dist.init_process_group(backend)
    return True
