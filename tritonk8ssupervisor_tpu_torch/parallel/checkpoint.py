"""Checkpoint and resume of the training state on
`torch.distributed.checkpoint` (DCP): the port of
`tritonk8ssupervisor_tpu/parallel/checkpoint.py`, in one process or on a
mesh of ranks.

A step is saved as `<dir>/<step>/`, one DCP checkpoint, and committed by
the marker `<dir>/.tk8s-complete/<step>`, written (temp file, then
`os.replace`) only after the step's save finished. `latest_step` counts
committed steps only, unless no step has a marker at all (a directory
written before markers existed, trusted as a whole); `restore` falls back
past a step that fails to read to the previous one. A state without a
mesh is saved by DCP in one process, without `init_process_group`
(`no_dist=True`); a state on a mesh is saved by every rank of the
process group, each sharded parameter (and the optimizer state that
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

`resolve_checkpoint_dir` keeps a URL (`gs://...`) as it is, as the
reference does; a `TrainCheckpointer` on a URL raises: object-store
checkpoints are ROADMAP.md queue 1, item 7.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from tritonk8ssupervisor_tpu_torch.parallel.mesh import dtensor_placements
from tritonk8ssupervisor_tpu_torch.parallel.train import TrainState

# `<ckpt-dir>/.tk8s-complete/<step>`: the commit marker of a whole save
COMMIT_DIR = ".tk8s-complete"


def resolve_checkpoint_dir(directory: Path | str) -> Path | str:
    """Local paths become absolute; URL-style paths (gs://...) pass
    through untouched (Path would fold 'gs://bucket' into 'gs:/bucket')."""
    raw = str(directory)
    if "://" in raw:
        return raw
    return Path(directory).absolute()


def _atomic_write_text(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


@contextlib.contextmanager
def _one_process():
    """DCP without a process group warns on every call that it assumes one
    process, which is this module's design."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


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


def _restore_into(path: Path, state: TrainState) -> None:
    """Load the DCP checkpoint at `path` into `state` in place."""
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
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
    with _one_process():
        dcp.load(target, checkpoint_id=path, no_dist=not _on_mesh(state))

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
    """Saves and restores a `TrainState` under `directory`, keeping the
    newest `max_to_keep` committed steps."""

    def __init__(self, directory: Path | str, max_to_keep: int = 3):
        self._dir = resolve_checkpoint_dir(directory)
        if not isinstance(self._dir, Path):
            raise NotImplementedError(
                f"checkpoints at {self._dir}: object-store checkpoints are not "
                "ported yet: ROADMAP.md queue 1, item 7"
            )
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _marker(self, step: int) -> Path:
        return self._dir / COMMIT_DIR / str(step)

    def all_steps(self) -> list[int]:
        """Every step with a directory, committed or not, ascending."""
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def _committed_steps(self) -> list[int]:
        """Steps safe to restore, ascending: those with a marker, or every
        step when none has one (a directory from before the markers)."""
        steps = self.all_steps()
        committed = [s for s in steps if self._marker(s).exists()]
        return committed if committed else steps

    def latest_step(self) -> int | None:
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Save `state` as `step` and commit it; then drop the steps beyond
        the newest `max_to_keep`. The save is synchronous: the reference's
        `wait` for its asynchronous saves has no counterpart."""
        step_dir = self._dir / str(step)
        on_mesh, rank0 = _on_mesh(state), _is_rank0(state)
        if rank0:
            self._marker(step).unlink(missing_ok=True)
            shutil.rmtree(step_dir, ignore_errors=True)
        if on_mesh:
            dist.barrier()
        with _one_process():
            dcp.save(_state_dict(state), checkpoint_id=step_dir, no_dist=not on_mesh)
        if rank0:
            _atomic_write_text(self._marker(step), f"{step}\n")
            for old in self.all_steps()[:-self.max_to_keep]:
                self._marker(old).unlink(missing_ok=True)
                shutil.rmtree(self._dir / str(old), ignore_errors=True)
        if on_mesh:
            dist.barrier()

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Restore into `state` in place and return it. With no explicit
        step, tries the latest committed step and falls back past any that
        fails to read (a torn save) to the previous complete one."""
        if step is not None:
            _restore_into(self._dir / str(step), state)
            return state
        candidates = self._committed_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint to restore in {self._dir}")
        last_error: Exception | None = None
        for candidate in reversed(candidates):
            try:
                _restore_into(self._dir / str(candidate), state)
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
