"""Ansible wrapper: generate runtime configs, run the playbook.

Rebuild of `createAnsibleConfigs` + `runAnsible` (reference
setup.sh:116-137, 111-115): fail fast when terraform left no endpoints
(setup.sh:117-120), generate the inventory and role vars, point
ansible.cfg at the discovered SSH key (the sed at setup.sh:133), then
`ansible-playbook -i hosts clusterUp.yml`.

The port's copy of `tritonk8ssupervisor_tpu/provision/ansible.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
A GPU deployment runs the GPU playbook (`playbook_for`).
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

from tritonk8ssupervisor_tpu_torch.config import compile as compiler
from tritonk8ssupervisor_tpu_torch.config.schema import ClusterConfig
from tritonk8ssupervisor_tpu_torch.provision import cache as cache_mod
from tritonk8ssupervisor_tpu_torch.provision import runner as run_mod
from tritonk8ssupervisor_tpu_torch.provision.state import ClusterHosts, RunPaths

_KEY_LINE = re.compile(r"^private_key_file\s*=.*$", re.MULTILINE)


def patch_private_key(ansible_cfg: Path, key_path: Path | str) -> None:
    """Point ansible.cfg at the SSH key — the runtime sed (setup.sh:133).
    Reversed by teardown (setup.sh:511)."""
    text = ansible_cfg.read_text()
    new = f"private_key_file = {key_path}"
    if _KEY_LINE.search(text):
        text = _KEY_LINE.sub(new, text)
    else:
        text = text.rstrip("\n") + "\n" + new + "\n"
    ansible_cfg.write_text(text)


def reset_private_key(ansible_cfg: Path) -> None:
    if ansible_cfg.exists():
        patch_private_key(ansible_cfg, "")


def write_runtime_configs(
    config: ClusterConfig,
    hosts: ClusterHosts,
    paths: RunPaths,
    ssh_key: Path | str = "",
    ansible_user: str = "",
) -> None:
    compiler.write_ansible_configs(
        config,
        hosts.host_ips,
        paths.ansible_dir,
        coordinator_ip=hosts.coordinator_ip,
        internal_ips=hosts.internal_ips,
        ansible_user=ansible_user,
    )
    if ssh_key and paths.ansible_cfg.exists():
        patch_private_key(paths.ansible_cfg, ssh_key)


def playbook_for(config: ClusterConfig) -> str:
    """The playbook of the deployment's accelerator kind: `clusterUp.yml`
    (tpuhost, gkejoin) or `clusterUpGpu.yml` (gpuhost, gkegpujoin)."""
    return "clusterUpGpu.yml" if config.is_gpu else "clusterUp.yml"


def run_playbook(
    paths: RunPaths,
    run: run_mod.RunFn = run_mod.run_streaming,
    extra_args: list[str] | None = None,
    playbook: str = "clusterUp.yml",
) -> None:
    """`cd ansible && ansible-playbook -i hosts clusterUp.yml`
    (setup.sh:111-115), or the GPU playbook."""
    run(
        ["ansible-playbook", "-i", "hosts", playbook] + (extra_args or []),
        cwd=paths.ansible_dir,
    )


def converge_slice(
    config: ClusterConfig,
    paths: RunPaths,
    hosts: ClusterHosts,
    slice_index: int,
    run: run_mod.RunFn = run_mod.run_streaming,
    cache: "cache_mod.WarmCache | None" = None,
    ssh_key: Path | str = "",
    ssh_user: str = "",
    echo=lambda line: print(line, file=sys.stderr, flush=True),
) -> bool:
    """Converge ONE slice's hosts: `ansible-playbook --limit <slice ips>`.

    This is the per-slice unit both the provision DAG (configure-slice-N
    tasks, cli/main.py) and `heal` (provision/heal.py) execute, so the
    warm-path skip logic lives here once: with a `cache`, the converge is
    a no-op when the slice's content key (role tree + its inventory view
    + endpoints + SSH identity, provision/cache.py) already converged —
    ansible would discover the same no-op itself, but only after minutes
    of SSH round-trips per host. Returns True when ansible actually ran.
    Call AFTER write_runtime_configs: the generated inventory and role
    files are inputs of the key. An empty slice (degraded, emptied from
    hosts.json) converges nothing and returns False.
    """
    slice_ips = (
        list(hosts.host_ips[slice_index])
        if slice_index < len(hosts.host_ips) else []
    )
    task = f"configure-slice-{slice_index}"
    if not slice_ips:
        echo(f"  {task}: no hosts recorded; nothing to converge")
        return False
    key = cache_mod.converge_key(
        paths, slice_index, slice_ips,
        ssh_key=str(ssh_key), ansible_user=ssh_user,
    )
    if cache is not None and cache.fresh(task, key):
        echo(f"  {task}: converge inputs unchanged (warm cache); "
             "skipping ansible")
        return False
    run_playbook(paths, run=run,
                 extra_args=["--limit", ",".join(slice_ips)],
                 playbook=playbook_for(config))
    if cache is not None:
        cache.record(task, key)
    return True
