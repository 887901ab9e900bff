"""Cluster formation in the port (`parallel/distributed.py`): the process
group `initialize_from_env` forms from the env contract the provisioning
layer writes (the reference's `JAX_*` coordinates and its `TK8S_*` slice
arithmetic), held to the coordinates the reference's `cluster_env`
resolves from the same environment; the no-op for a single process; the
refusal to fall back to gloo without a card; `shutdown` and `join`."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from tritonk8ssupervisor_tpu.parallel import distributed as jax_distributed
from tritonk8ssupervisor_tpu_torch.parallel import distributed

ROOT = Path(__file__).resolve().parents[1]

# one process of a group: forms it from its environment, sums rank + 1
# over it, leaves, and prints what it saw
MEMBER = """
import json, sys, torch, torch.distributed as dist
from tritonk8ssupervisor_tpu_torch.parallel import distributed
env = getattr(distributed, sys.argv[1])(device="cpu")
total = torch.tensor([dist.get_rank() + 1.0])
dist.all_reduce(total)
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "backend": dist.get_backend(), "sum": total.item(),
                  "global_id": getattr(env, "global_process_id", None)}))
distributed.shutdown()
print(json.dumps({"left": not dist.is_initialized()}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_slices(pid: int, port: int) -> dict:
    return {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": "0", "TK8S_NUM_SLICES": "2", "TK8S_SLICE_ID": str(pid),
            "TK8S_PROCS_PER_SLICE": "1"}


def _one_slice(pid: int, port: int) -> dict:
    return {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid)}


@pytest.mark.parametrize("entry", ["initialize_from_env", "join"])
@pytest.mark.parametrize("coordinates", [_one_slice, _two_slices], ids=["1_slice", "2_slices"])
def test_two_processes_form_one_group_from_the_env_contract(coordinates, entry, tmp_path):
    """Two processes with the env contract's coordinates form one gloo group
    (`device="cpu"`): each rank is the `global_process_id` the reference's
    `cluster_env` gives for its environment, across two slices of one
    process too; `shutdown` leaves it."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "TK8S_"))}
    procs = [subprocess.Popen([sys.executable, "-c", MEMBER, entry], cwd=ROOT,
                              env={**base, **coordinates(pid, port), "OMP_NUM_THREADS": "1"},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append([json.loads(line) for line in out.splitlines()])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (seen, left) in enumerate(outs):
        want = jax_distributed.cluster_env(coordinates(pid, port),
                                           env_file=tmp_path / "absent").global_process_id
        assert seen["rank"] == want
        assert (seen["world"], seen["backend"], seen["sum"]) == (2, "gloo", 3.0)
        assert left == {"left": True}
        if entry == "initialize_from_env":
            assert seen["global_id"] == want
    assert sorted(seen["rank"] for seen, _ in outs) == [0, 1]


def test_a_single_process_or_no_coordinates_forms_no_group(tmp_path, monkeypatch):
    """The reference's no-op: no coordinates give None, one process gives
    its env, and neither forms a group, with or without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    absent = tmp_path / "absent"
    assert distributed.initialize_from_env({}, env_file=absent) is None
    single = {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "1",
              "JAX_PROCESS_ID": "0"}
    env = distributed.initialize_from_env(single, env_file=absent)
    assert env.__dict__ == jax_distributed.cluster_env(single, env_file=absent).__dict__
    assert not env.is_multi_host and not dist.is_initialized()
    # the env file alone (a host with no process variables)
    env_file = tmp_path / "tpu-cluster.env"
    env_file.write_text("JAX_COORDINATOR_ADDRESS=10.0.0.9:8476\nJAX_NUM_PROCESSES=1\n"
                        "JAX_PROCESS_ID=0\n")
    assert distributed.initialize_from_env({}, env_file=env_file).num_processes == 1
    assert not dist.is_initialized()
    distributed.shutdown()  # no group: a no-op


def test_without_a_card_it_raises_rather_than_choosing_gloo(tmp_path, monkeypatch):
    """Several processes and no `device="cpu"`: the port runs on the card,
    and without one it raises before any rendezvous; so does the launcher's
    join."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    environ = {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2",
               "JAX_PROCESS_ID": "1"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_from_env(environ, env_file=tmp_path / "absent")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_from_launcher({"WORLD_SIZE": "2", "RANK": "1"})
    assert not dist.is_initialized()
