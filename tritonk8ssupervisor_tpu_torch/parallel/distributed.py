"""Cluster formation: the port of
`tritonk8ssupervisor_tpu/parallel/distributed.py`.

The coordinates come from `/etc/tpu-cluster.env` (written per host by the
provisioning layer) overlaid per key by the process environment (a Job's
`JAX_*`/`TK8S_*` variables), so overriding only the coordinator address
keeps the process counts of the file. `cluster_env` parses them (None
means a single process). In cross-slice mode the process count spans
every slice and a process's global id is `slice_id * procs_per_slice +
process_id` (slice-major).

`initialize_from_env` forms one `torch.distributed` process group from
them, every slice's processes in one group, as the reference forms one
`jax.distributed` cluster; `shutdown` leaves it (the elastic trainer,
`parallel/elastic.py`, leaves and re-forms it at every membership
change). Under torchrun, `init_from_launcher` joins the launcher's group
instead, and `join` picks between the two for the benchmarks.
`parallel/mesh.make_workload_mesh` reads the slice count from here.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from pathlib import Path

import torch
import torch.distributed as dist

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.config.store import parse_flat

ENV_FILE = Path("/etc/tpu-cluster.env")

COORDINATOR_VAR = "JAX_COORDINATOR_ADDRESS"
NUM_PROCESSES_VAR = "JAX_NUM_PROCESSES"
PROCESS_ID_VAR = "JAX_PROCESS_ID"
# cross-slice coordinates (absent: one slice)
NUM_SLICES_VAR = "TK8S_NUM_SLICES"
SLICE_ID_VAR = "TK8S_SLICE_ID"
PROCS_PER_SLICE_VAR = "TK8S_PROCS_PER_SLICE"
# how long a collective (and the rendezvous) waits for a peer before it
# raises: what turns a dead peer into a step failure the trainer sees
GROUP_TIMEOUT_S = 60.0


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


def _backend(device: str | torch.device | None, backend: str | None) -> str:
    """NCCL on the card, gloo when the caller asks for the CPU; `backend`
    overrides (gloo on the card: two processes sharing one card, which
    NCCL refuses). Raises without a card unless the CPU was asked for."""
    device = resolve_device(device)
    if backend is not None:
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_from_env(environ: dict | None = None, env_file: Path = ENV_FILE,
                        device: str | torch.device | None = None,
                        backend: str | None = None) -> ClusterEnv | None:
    """Form the process group from the discovered coordinates and return
    them: the counterpart of the reference's `jax.distributed.initialize`
    from the env contract.

    A single process, or no coordinates, is a no-op that returns the env
    (None without coordinates), as in the reference. Otherwise every
    process rendezvouses at `tcp://<coordinator_address>` with rank =
    `global_process_id` and world size = `num_processes`, so in
    cross-slice mode the group spans every slice. The backend is NCCL on
    the card (this process's current device) and gloo only for
    `device="cpu"`; without a card and without `device="cpu"` it raises.
    `backend="gloo"` on the card lets two processes share one card, which
    NCCL refuses.

    The group's timeout is GROUP_TIMEOUT_S (60 s), not torch's 30
    minutes: the reference relies on JAX's coordination heartbeat to fail
    a step whose peer died, and here the timeout is what turns a peer that
    hangs into a failed collective the elastic trainer catches (a peer
    that exits closes its sockets, which gloo reports at once). For NCCL,
    TORCH_NCCL_ASYNC_ERROR_HANDLING defaults to 2 here (abort the
    communicators and raise in the caller), where torch's default ends
    the process; a dead NCCL peer is unverified (one card: rule (e) of
    ROADMAP.md).

    The reference also exports libtpu's `MEGASCALE_*` variables, its
    cross-slice DCN transport. The port has no counterpart: NCCL or gloo
    carries the cross-slice traffic of the one group."""
    env = cluster_env(environ, env_file)
    if env is None or not env.is_multi_host:
        return env
    backend = _backend(device, backend)
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
    dist.init_process_group(backend, init_method=f"tcp://{env.coordinator_address}",
                            rank=env.global_process_id, world_size=env.num_processes,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return env


def shutdown() -> None:
    """Leave the process group, best-effort: the peer may be dead. On NCCL
    the communicators are aborted rather than waited on (a destroy would
    wait for work a dead peer never finishes); gloo's group is destroyed.
    A no-op without a group."""
    if not dist.is_initialized():
        return
    from torch.distributed import distributed_c10d

    try:
        if dist.get_backend() == "nccl" and hasattr(distributed_c10d, "_abort_process_group"):
            distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - leaving a broken world is best-effort
        pass


def init_from_launcher(environ: dict | None = None,
                       device: str | torch.device | None = None) -> bool:
    """Join the process group a launcher describes in the environment
    (torchrun's WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    NCCL on this process's card (LOCAL_RANK), gloo only for
    `device="cpu"`; without a card and without `device="cpu"` it raises.
    True when it joined one; False for a single process or when a group
    exists."""
    environ = os.environ if environ is None else environ
    if int(environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    backend = _backend(device, None)
    if backend == "nccl":
        torch.cuda.set_device(int(environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend)
    return True


def join(device: str | torch.device | None = None) -> bool:
    """The benchmarks' rendezvous: `initialize_from_env` where the cluster
    environment names coordinates (the reference's benchmarks join so),
    else the launcher's group (`init_from_launcher`). True when this
    process joined a group, which the caller destroys when it is done."""
    if cluster_env() is not None:
        env = initialize_from_env(device=device)
        return env.is_multi_host
    return init_from_launcher(device=device)
