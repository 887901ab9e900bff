"""Checkpoint and resume of the training state on
`torch.distributed.checkpoint` (DCP): the port of
`tritonk8ssupervisor_tpu/parallel/checkpoint.py`, in one process or on a
mesh of ranks.

A step is saved as `<dir>/<step>/`, one DCP checkpoint, and committed by
the marker `<dir>/.tk8s-complete/<step>`, written (temp file, then
`os.replace`) only after the step's save finished. `latest_step` counts
committed steps only, unless no step has a marker at all (a directory
written before markers existed, trusted as a whole); `restore` falls back
past a step that fails to read to the previous one.

The directory may also be a URL (`gs://bucket/run`, or any scheme
`fsspec` knows, such as `file://` and `memory://`): DCP's `FsspecWriter`
and `FsspecReader` write and read it. As in the reference, which leaves
a URL's commit to orbax, no marker is written there: a step counts as
committed when its DCP `.metadata` exists, which DCP writes last.
Listing, pruning and the fall-back past a torn step go through `fsspec`
the same way.

A state without a mesh is saved by DCP in one process, without
`init_process_group` (`no_dist=True`); a state on a mesh is saved by
every rank of the process group, each sharded parameter (and the optimizer state that
follows it) as a DTensor of its placements, so a restore onto another
mesh (another rank count, other degrees) reshards it. Saves are
synchronous: rank 0 writes the marker after DCP's commit, and the ranks
meet at a barrier before the save and after the marker.

What is saved is what a resumed run needs to equal one that never
stopped, as one flat dict of tensors:

- `model.<name>`: every entry of the model's `state_dict` (parameters
  and the BatchNorm running statistics);
- `optimizer.<parameter name>.<key>`: the optimizer's per-parameter state
  (SGD's momentum buffer, AdamW's moments and step), keyed by the
  parameter's name in the model where torch keys it by its index;
- `optimizer.count`: `ClippedAdamW`'s update count (its schedule's
  input), for optimizers that have one;
- `step`: `TrainState.step`.

A restore copies into the live state in place: the model's tensors
directly, the optimizer's state through `load_state_dict`, which puts
each tensor where torch keeps it. So the port needs no counterpart of
the reference's `abstract_like`.
"""

from __future__ import annotations

import contextlib
import posixpath
import shutil
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from tritonk8ssupervisor_tpu_torch.parallel.mesh import dtensor_placements
from tritonk8ssupervisor_tpu_torch.parallel.train import TrainState
from tritonk8ssupervisor_tpu_torch.provision.state import atomic_write_text

# `<ckpt-dir>/.tk8s-complete/<step>`: the commit marker of a whole save
COMMIT_DIR = ".tk8s-complete"
# the file DCP writes last, which commits a step at a URL
METADATA_FILE = ".metadata"


def resolve_checkpoint_dir(directory: Path | str) -> Path | str:
    """Local paths become absolute; URL-style paths (gs://...) pass
    through untouched (Path would fold 'gs://bucket' into 'gs:/bucket')."""
    raw = str(directory)
    if "://" in raw:
        return raw
    return Path(directory).absolute()


def _writer(location: Path | str):
    """DCP's writer for a step: the file-system one for a local path,
    fsspec's for a URL."""
    if isinstance(location, Path):
        return dcp.FileSystemWriter(location)
    from torch.distributed.checkpoint._fsspec_filesystem import FsspecWriter

    return FsspecWriter(location)


def _reader(location: Path | str):
    if isinstance(location, Path):
        return dcp.FileSystemReader(location)
    from torch.distributed.checkpoint._fsspec_filesystem import FsspecReader

    return FsspecReader(location)


@contextlib.contextmanager
def _dcp_call():
    """Around every DCP save and load. DCP without a process group warns on
    every call that it assumes one process, which is this module's design.
    A failure inside DCP (a torn file, a peer lost mid-save) is a
    `CheckpointException`, which is not an `Exception`: it is raised as a
    RuntimeError, which the fall-back past a torn step and the elastic
    trainer's best-effort saves catch."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        try:
            yield
        except dcp.CheckpointException as e:
            raise RuntimeError(f"checkpoint {e}") from e


def _on_mesh(state: TrainState) -> bool:
    return state.mesh is not None and dist.is_initialized()


def _is_rank0(state: TrainState) -> bool:
    return not _on_mesh(state) or dist.get_rank() == 0


def _sharded(state: TrainState, name: str) -> bool:
    spec = state.specs.get(name)
    return _on_mesh(state) and bool(spec) and any(spec)


def _global(state: TrainState, name: str, local: torch.Tensor) -> torch.Tensor:
    """`local` (a shard of parameter `name`, or of state shaped like it)
    as a DTensor of the parameter's placements; as it is when the
    parameter is replicated or there is no mesh."""
    if not _sharded(state, name):
        return local
    spec = state.specs[name]
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, state.mesh, dtensor_placements(state.mesh, spec),
                              run_check=False)


def _state_dict(state: TrainState) -> dict[str, torch.Tensor]:
    out = {f"model.{k}": _global(state, k, v) for k, v in state.model.state_dict().items()}
    names = {p: n for n, p in state.model.named_parameters()}
    for param, values in state.optimizer.state.items():
        for key, value in values.items():
            if value.shape == param.shape:  # a per-element state: the parameter's shards
                value = _global(state, names[param], value)
            out[f"optimizer.{names[param]}.{key}"] = value
    if hasattr(state.optimizer, "count"):
        out["optimizer.count"] = torch.tensor(state.optimizer.count)
    out["step"] = torch.tensor(state.step)
    return out


def _restore_into(path: Path | str, state: TrainState) -> None:
    """Load the DCP checkpoint at `path` (a directory or a URL) into
    `state` in place."""
    stored = _reader(path).read_metadata().state_dict_metadata
    model = {f"model.{k}": _global(state, k, v) for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    target: dict[str, torch.Tensor] = dict(model)
    for key, meta in stored.items():
        if key in model:
            continue
        name = key.removeprefix("optimizer.").rpartition(".")[0]
        if name in params and _sharded(state, name) \
                and tuple(meta.size) == tuple(model[f"model.{name}"].shape):
            # a sharded parameter's per-element state: read as its shards
            target[key] = _global(state, name, torch.zeros_like(params[name]))
        else:  # replicated optimizer state and counters, read on the host
            target[key] = torch.empty(meta.size, dtype=meta.properties.dtype)
    if set(model) - set(stored):
        raise ValueError(f"{path}: no entry for {sorted(set(model) - set(stored))[:4]}")
    with _dcp_call():
        dcp.load(target, storage_reader=_reader(path), no_dist=not _on_mesh(state))

    index = {n: i for i, n in enumerate(params)}
    per_param: dict[int, dict[str, torch.Tensor]] = {}
    for key, value in target.items():
        if key.startswith("optimizer.") and key != "optimizer.count":
            name, _, leaf = key.removeprefix("optimizer.").rpartition(".")
            per_param.setdefault(index[name], {})[leaf] = getattr(value, "_local_tensor", value)
    groups = state.optimizer.state_dict()["param_groups"]
    state.optimizer.load_state_dict({"state": per_param, "param_groups": groups})
    if "optimizer.count" in target:
        state.optimizer.count = int(target["optimizer.count"])
    state.step = int(target["step"])


class TrainCheckpointer:
    """Saves and restores a `TrainState` under `directory` (a local path or
    a URL), keeping the newest `max_to_keep` committed steps."""

    def __init__(self, directory: Path | str, max_to_keep: int = 3):
        self._dir = resolve_checkpoint_dir(directory)
        if isinstance(self._dir, Path):
            self._fs = None
            self._dir.mkdir(parents=True, exist_ok=True)
        else:
            from fsspec.core import url_to_fs

            self._dir = self._dir.rstrip("/")
            self._fs, self._root = url_to_fs(self._dir)
            self._fs.makedirs(self._root, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _location(self, step: int) -> Path | str:
        """Where `step` is saved: a directory, or a URL."""
        if self._fs is None:
            return self._dir / str(step)
        return f"{self._dir}/{step}"

    def _marker(self, step: int) -> Path:
        return self._dir / COMMIT_DIR / str(step)

    def _committed(self, step: int) -> bool:
        if self._fs is None:
            return self._marker(step).exists()
        return self._fs.exists(f"{self._root}/{step}/{METADATA_FILE}")

    def _remove(self, step: int) -> None:
        """Drop `step`: its marker first (a local step), then its files."""
        if self._fs is None:
            self._marker(step).unlink(missing_ok=True)
            shutil.rmtree(self._dir / str(step), ignore_errors=True)
        elif self._fs.exists(f"{self._root}/{step}"):
            self._fs.rm(f"{self._root}/{step}", recursive=True)

    def all_steps(self) -> list[int]:
        """Every step with a directory, committed or not, ascending."""
        if self._fs is None:
            return sorted(int(p.name) for p in self._dir.iterdir()
                          if p.is_dir() and p.name.isdigit())
        try:
            entries = self._fs.ls(self._root, detail=True)
        except FileNotFoundError:
            return []
        names = [posixpath.basename(e["name"].rstrip("/")) for e in entries
                 if e["type"] == "directory"]
        return sorted(int(n) for n in names if n.isdigit())

    def _committed_steps(self) -> list[int]:
        """Steps safe to restore, ascending: those with a marker, or every
        step when none has one (a directory from before the markers); at
        a URL, those whose DCP metadata exists."""
        steps = self.all_steps()
        committed = [s for s in steps if self._committed(s)]
        return committed if committed or self._fs is not None else steps

    def latest_step(self) -> int | None:
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Save `state` as `step` and commit it; then drop the steps beyond
        the newest `max_to_keep`. The save is synchronous: the reference's
        `wait` for its asynchronous saves has no counterpart."""
        on_mesh, rank0 = _on_mesh(state), _is_rank0(state)
        if rank0:
            self._remove(step)
        if on_mesh:
            dist.barrier()
        with _dcp_call():
            dcp.save(_state_dict(state), storage_writer=_writer(self._location(step)),
                     no_dist=not on_mesh)
        if rank0:
            if self._fs is None:
                atomic_write_text(self._marker(step), f"{step}\n")
            for old in self.all_steps()[:-self.max_to_keep]:
                self._remove(old)
        if on_mesh:
            dist.barrier()

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Restore into `state` in place and return it. With no explicit
        step, tries the latest committed step and falls back past any that
        fails to read (a torn save) to the previous complete one."""
        if step is not None:
            _restore_into(self._location(step), state)
            return state
        candidates = self._committed_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint to restore in {self._dir}")
        last_error: Exception | None = None
        for candidate in reversed(candidates):
            try:
                _restore_into(self._location(candidate), state)
                return state
            except Exception as e:  # noqa: BLE001 - a torn step may fail anywhere in DCP's read
                last_error = e
                print(f"checkpoint step {candidate} unreadable ({type(e).__name__}: {e}); "
                      "falling back to the previous complete step", flush=True)
        raise FileNotFoundError(
            f"no readable checkpoint (latest torn?): {last_error}"
        ) from last_error

    def close(self) -> None:
        """Nothing is left in flight: every save committed when it returned."""


def maybe_restore(checkpoint_dir: Path | str | None, state: TrainState
                  ) -> tuple[TrainCheckpointer | None, TrainState, int, float]:
    """The benchmarks' resume preamble: open `checkpoint_dir` (when given)
    and restore its latest step into `state` if it has one. Returns
    (checkpointer or None, state, start_step, restore_seconds)."""
    if not checkpoint_dir:
        return None, state, 0, 0.0
    start = time.monotonic()
    ckpt = TrainCheckpointer(checkpoint_dir)
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
    return ckpt, state, state.step, time.monotonic() - start


def window_save_hook(ckpt: TrainCheckpointer | None, state: TrainState):
    """`perf.timed_windows(on_window=...)`: with a checkpointer, every
    window boundary saves the state, so a run killed mid-way resumes at
    the last window; None without one."""
    if ckpt is None:
        return None
    return lambda: ckpt.save(state.step, state)


def save_and_close(ckpt: TrainCheckpointer | None, state: TrainState) -> None:
    """The postamble: save the final step unless the last window's hook
    already did, then close."""
    if ckpt is not None:
        if ckpt.latest_step() != state.step:
            ckpt.save(state.step, state)
        ckpt.close()
