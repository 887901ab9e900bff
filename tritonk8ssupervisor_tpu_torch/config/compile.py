"""Compile the validated ClusterConfig into tool-specific artifacts.

The reference did this with string concatenation: generated HCL
(updateTerraformConfig, setup.sh:162-198), an Ansible inventory + vars.yml
(createAnsibleConfigs, setup.sh:116-137), and a sed-patched ansible.cfg
(setup.sh:133). We generate *data* instead of code: a terraform.tfvars.json
consumed by static, reviewable Terraform modules (no HCL codegen), a YAML
inventory, and Kubernetes Job manifests with `google.com/tpu` resource
requests (the benchmark-workload analogue of docs/benchmarks.md).

The port's copy of `tritonk8ssupervisor_tpu/config/compile.py`, whole and
under the reference's names. Its documents equal the reference's once
`tritonk8ssupervisor_tpu` reads `tritonk8ssupervisor_tpu_torch` (the modules
the Jobs run and the smoke test imports) and the archive is the port's
(`packaging.py`). The strings that describe the TPU host's runtime
(`jax_smoke_command`, `PROBE_JAX_PIN`, the libtpu index, the `JAX_*`,
`TK8S_*` and `TPU_*` env names, `google.com/tpu` and the GKE TPU node
selectors) are the TPU catalog's data and stay as they are: the shared
ansible roles consume them. One TPU string differs on purpose:
`cluster_smoke_command` forms the JAX cluster itself, where the
reference's calls its own `initialize_from_env` (the port's forms a torch
group on the card, which a TPU host cannot).

The GPU modes (`gke-gpu`, `gpu-vm`) get the H100 counterparts of every
TPU document: tfvars for `terraform/gke-gpu` and `terraform/gpu-vm`, a
`[GPUHOST]` inventory, the `gpuhost` role's vars with `gpu_smoke_command`
and `gpu_cluster_smoke_command`, and Indexed Jobs that request
`nvidia.com/gpu` and launch the port under `python -m
torch.distributed.run`. No GPU document names JAX, libtpu or a TPU.
"""

from __future__ import annotations

import base64
import json
import shlex
from pathlib import Path

import yaml

from tritonk8ssupervisor_tpu_torch import packaging
from tritonk8ssupervisor_tpu_torch.config.schema import ClusterConfig

BENCH_IMAGE_DEFAULT = "python:3.11-slim"
# ConfigMap carrying the framework source archive (packaging.py); mounted
# into the benchmark Job so the default plain-python image can self-install
# the package — no registry required (the probe Job's pattern, extended).
PACKAGE_CONFIGMAP_NAME = "tk8s-pkg"
# the archive's mount point inside the Job's container
PACKAGE_MOUNT_PATH = "/".join(("", "opt", "tk8s-pkg"))


# ---------------------------------------------------------------- terraform


def to_tfvars(config: ClusterConfig) -> dict:
    """Variables for terraform/tpu-vm or terraform/gke root modules.

    Replaces the reference's per-VM `module` block codegen loop
    (setup.sh:145-152) — fan-out lives in HCL `count` now, driven by
    `num_slices` / node counts here.
    """
    common = {
        "project": config.project,
        "zone": config.zone,
        "network": config.network,
        "subnetwork": config.subnetwork,
        "name_prefix": config.node_prefix,
        "num_slices": config.num_slices,
    }
    if config.mode == "tpu-vm":
        return common | {
            "accelerator_type": config.accelerator_type,
            "runtime_version": config.effective_runtime_version,
        }
    if config.mode == "gpu-vm":
        return common | {
            "machine_type": config.gke_machine_type,
            "hosts_per_slice": config.hosts_per_slice,
            "boot_image": config.effective_runtime_version,
        }
    if config.mode == "gke-gpu":
        return common | {
            "cluster_name": config.cluster_name,
            "machine_type": config.gke_machine_type,
            "accelerator_type": config.accelerator_type,
            "gpus_per_node": _per_host(config),
            "nodes_per_slice": config.hosts_per_slice,
            "broad_node_scopes": config.broad_node_scopes,
        }
    return common | {
        "cluster_name": config.cluster_name,
        "machine_type": config.gke_machine_type,
        "tpu_topology": str(config.parsed_topology),
        "nodes_per_slice": config.hosts_per_slice,
        "broad_node_scopes": config.broad_node_scopes,
    }


def write_tfvars(config: ClusterConfig, terraform_dir: Path) -> Path:
    out = terraform_dir / config.mode / "terraform.tfvars.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(to_tfvars(config), indent=2, sort_keys=True) + "\n")
    return out


# ------------------------------------------------------------------ ansible


def _check_slice_shape(name: str, slice_ips) -> None:
    """slice_ips must be per-slice lists (terraform output shape); a flat
    list of strings would silently iterate characters and emit garbage
    host lines."""
    if not isinstance(slice_ips, (list, tuple)) or not all(
        isinstance(s, (list, tuple)) and all(isinstance(ip, str) for ip in s)
        for s in slice_ips
    ):
        raise TypeError(
            f"{name} must be a list of per-slice IP lists "
            f"(e.g. [['10.0.0.1', '10.0.0.2']]), got {slice_ips!r}"
        )


def to_inventory(
    config: ClusterConfig,
    slice_ips: list[list[str]],
    internal_ips: list[list[str]] | None = None,
    ansible_user: str = "",
) -> str:
    """INI inventory, the analogue of the [MASTER]/[HOST] groups the
    reference built from masters.ip/hosts.ip (setup.sh:123-126).

    `slice_ips` (external IPs, SSH addressing) is per-slice (terraform
    output shape): each host line carries its slice index, its position in
    the slice, its slice's coordinator AND the global (slice 0) coordinator
    as inventory hostvars. The tpuhost role writes whichever coordination
    block matches the deployment: multi-slice deployments get the
    cross-slice contract (one jax.distributed cluster spanning all
    slices, global ids computed by parallel/distributed.py — the
    reference joined every node into one compute surface,
    rancherhost/tasks/main.yml:26-34); single-slice multi-host
    deployments get the per-slice contract. Coordinators are first-host
    VPC-internal IPs when `internal_ips` is provided: worker dials to
    an external NAT IP are blocked by default firewall rules, and JAX
    coordinator traffic belongs on the VPC anyway.

    `ansible_user` is the SSH login for TPU VMs (the discovered gcloud
    username — GCP maps metadata/OS-Login keys to user accounts and
    disables direct root SSH; the play escalates with become). Empty means
    omit, letting ansible default to the control machine's user, which is
    what `gcloud compute ssh` would use.

    The [LOCAL] group hosts the gkejoin play, which drives gcloud/kubectl
    from the control machine (the ranchermaster local_action analogue,
    ranchermaster/tasks/main.yml:51-52)."""
    _check_slice_shape("slice_ips", slice_ips)
    if internal_ips:
        _check_slice_shape("internal_ips", internal_ips)
        if [len(s) for s in internal_ips] != [len(s) for s in slice_ips]:
            raise ValueError(
                "internal_ips shape does not match slice_ips: "
                f"{internal_ips!r} vs {slice_ips!r}"
            )
    if (
        config.num_slices > 1
        and slice_ips
        and not slice_ips[0]
        and any(slice_ips[1:])
    ):
        # The cross-slice contract pins the coordinator (global process
        # id 0) to slice 0's first host; without slice 0 no process
        # would run the coordinator service and every other host would
        # hang in jax.distributed.initialize — fail loudly instead.
        raise ValueError(
            "slice 0 has no endpoints but later slices do: the "
            "cross-slice cluster's coordinator lives on slice 0's first "
            "host (re-run provisioning, or drop the empty slice from "
            "the terraform output)"
        )
    group = "GPUHOST" if config.is_gpu else "TPUHOST"
    lines = [f"[{group}]"]
    global_coordinator = ""
    for slice_index, ips in enumerate(slice_ips):
        if not ips:  # slice endpoints not populated (yet) — emit nothing
            continue
        coordinator = (
            internal_ips[slice_index][0] if internal_ips else ips[0]
        )
        if not global_coordinator:
            global_coordinator = coordinator  # slice 0 (guarded above)
        for process_id, ip in enumerate(ips):
            # a GPU host's launcher node rank over the whole deployment
            rank = (f" node_rank={slice_index * config.hosts_per_slice + process_id}"
                    if config.is_gpu else "")
            lines.append(
                f"{ip} slice_index={slice_index} process_id={process_id}{rank} "
                f"slice_coordinator={coordinator} "
                f"global_coordinator={global_coordinator}"
            )
    lines += ["", f"[{group}:vars]"]
    if ansible_user:
        lines.append(f"ansible_user={ansible_user}")
    lines += [
        "ansible_python_interpreter=/usr/bin/python3",
        "",
        "[LOCAL]",
        "localhost ansible_connection=local",
        "",
    ]
    return "\n".join(lines)


def to_ansible_vars(config: ClusterConfig, coordinator_ip: str = "") -> dict:
    """vars.yml analogue (reference setup.sh:128-131 wrote master IP + env
    name/description for the ranchermaster role)."""
    if config.is_gpu:
        return _gpu_ansible_vars(config, coordinator_ip)
    expected_per_host = config.spec.chips_on_host(config.parsed_topology)
    return {
        "coordinator": coordinator_ip,
        "kubernetes_name": config.env_name,
        "kubernetes_description": config.env_description,
        "tpu_generation": config.generation,
        "accelerator_type": config.accelerator_type,
        "runtime_version": config.effective_runtime_version,
        "expected_devices_per_host": expected_per_host,
        "hosts_per_slice": config.hosts_per_slice,
        "num_slices": config.num_slices,
        "expected_total_chips": config.num_slices * config.chips_per_slice,
        # one definition of the acceptance test for both the ansible role
        # and the SSH readiness path (provision/readiness.py)
        "jax_smoke_cmd": jax_smoke_command(expected_per_host),
        # the cluster-wide rendezvous acceptance:
        # single-slice deployments must form the slice's JAX cluster,
        # cross-slice deployments the whole surface
        "cluster_smoke_cmd": cluster_smoke_command(
            config.num_slices * config.chips_per_slice
            if config.num_slices > 1 else config.chips_per_slice
        ),
        "project": config.project,
        "zone": config.zone,
        "cluster_name": config.cluster_name,
        "mode": config.mode,
    }


def jax_smoke_command(expected_devices: int) -> str:
    """The per-host acceptance test: JAX must actually see the chips —
    "TPU chips usable" != "VM booted" (SURVEY.md §7 readiness semantics).
    Shared by the tpuhost ansible role (via to_ansible_vars) and the
    tpu-vm SSH readiness path (provision/readiness.py)."""
    return (
        "python3 -c \"import jax; n = jax.local_device_count(); "
        f"assert n == {expected_devices}, "
        f"f'expected {expected_devices} TPU devices, saw {{n}}'; "
        "print(f'JAX OK: {n} devices')\""
    )


# libtpu's DCN transport port (the reference's parallel/distributed.py)
MEGASCALE_PORT = "8081"


def cluster_smoke_command(expected_chips: int, timeout_s: int = 240) -> str:
    """The cluster-wide rendezvous acceptance: every
    host runs this CONCURRENTLY after the tpuhost play writes
    /etc/tpu-cluster.env; jax.distributed.initialize must form the
    cluster and the global device count must equal the deployment's chip
    total — the per-host smoke proves "this host's chips are usable",
    this one proves "the hosts form ONE cluster" (the GKE probe Job's
    equivalent for tpu-vm mode). `timeout` bounds a wedged rendezvous
    (e.g. a firewalled coordinator port) so the play fails with the
    assertion context instead of hanging the whole provision.

    The command does what the reference's `initialize_from_env` does
    (its parallel/distributed.py:143-167): it reads the coordinates
    through the port's `parallel.distributed.cluster_env`, exports
    libtpu's MEGASCALE_* variables in cross-slice mode, and calls
    `jax.distributed.initialize` where there is more than one host. It
    cannot call the port's `initialize_from_env`, which forms a torch
    group on the CUDA card and raises on a TPU host. The string runs on
    the TPU host, which has JAX; the port imports none."""
    return (
        f"timeout {timeout_s} python3 -c \"import os, jax; "
        "from tritonk8ssupervisor_tpu_torch.parallel.distributed import cluster_env; "
        "env = cluster_env(); "
        "multi = env is not None and env.is_multi_host; "
        "[os.environ.setdefault(k, v) for k, v in ("
        "('MEGASCALE_COORDINATOR_ADDRESS', env.coordinator_address.rsplit(':', 1)[0]), "
        "('MEGASCALE_NUM_SLICES', str(env.num_slices)), "
        "('MEGASCALE_SLICE_ID', str(env.slice_id)), "
        f"('MEGASCALE_PORT', '{MEGASCALE_PORT}'))] if multi and env.is_multi_slice else None; "
        "jax.distributed.initialize(coordinator_address=env.coordinator_address, "
        "num_processes=env.num_processes, process_id=env.global_process_id) "
        "if multi else None; "
        "n = jax.device_count(); "
        f"assert n == {expected_chips}, "
        f"f'expected {expected_chips} cluster chips, saw {{n}}'; "
        "print(f'CLUSTER OK: {jax.process_count()} processes, "
        "{n} chips')\""
    )


def write_ansible_configs(
    config: ClusterConfig,
    slice_ips: list[list[str]],
    ansible_dir: Path,
    coordinator_ip: str = "",
    internal_ips: list[list[str]] | None = None,
    ansible_user: str = "",
) -> None:
    """Generated vars go to group_vars/all.yml so every play sees them (the
    reference funnelled one vars.yml into each play via vars_files,
    clusterUp.yml:12,22)."""
    ansible_dir.mkdir(parents=True, exist_ok=True)
    (ansible_dir / "hosts").write_text(
        to_inventory(
            config, slice_ips, internal_ips=internal_ips, ansible_user=ansible_user
        )
    )
    vars_dir = ansible_dir / "group_vars"
    vars_dir.mkdir(parents=True, exist_ok=True)
    (vars_dir / "all.yml").write_text(
        yaml.safe_dump(to_ansible_vars(config, coordinator_ip), sort_keys=True)
    )
    # Stage the framework source archive for the tpuhost role (files/ is
    # ansible's copy-module search path): every TPU host gets the package
    # installed, so the success banner's advertised benchmark command runs
    # on a fresh VM. Deterministic bytes -> ansible reports changed=false
    # on converge re-runs. A GPU deployment stages it for the gpuhost role
    # only: a role its playbook does not name gets nothing.
    role = "gpuhost" if config.is_gpu else "tpuhost"
    packaging.build_source_archive(
        ansible_dir / "roles" / role / "files" / packaging.ARCHIVE_NAME
    )


# -------------------------------------------------------------- k8s manifests

# benchmark families deployable as the cluster Job (--bench-workload):
# name -> (module, flags the name implies). "vit" rides the image-
# training harness with its model selector; "decode" is the serving-
# side KV-cache generation benchmark.
BENCH_WORKLOADS = {
    "resnet50": ("tritonk8ssupervisor_tpu_torch.benchmarks.resnet50", ()),
    "vit": ("tritonk8ssupervisor_tpu_torch.benchmarks.resnet50",
            ("--model", "vit")),
    "lm": ("tritonk8ssupervisor_tpu_torch.benchmarks.lm", ()),
    "decode": ("tritonk8ssupervisor_tpu_torch.benchmarks.decode", ()),
}
# workloads whose module accepts --checkpoint-dir (training runs that
# save/resume state; decode generates, nothing to checkpoint)
CHECKPOINTABLE_WORKLOADS = {"resnet50", "vit", "lm"}


def bench_command(module: str = "tritonk8ssupervisor_tpu_torch.benchmarks.resnet50",
                  extra_args: tuple[str, ...] = ("--json",),
                  extra_packages: tuple[str, ...] = ()) -> str:
    """Self-installing benchmark command for the default (plain python)
    image: install the ConfigMap-mounted source archive + the pinned
    jax[tpu], then run the module. This is what makes the generated Job
    runnable as published — the reference's workloads ran straight from
    public images (docs/benchmarks.md:1-4); ours ships its own source.

    extra_args carry user input (e.g. --checkpoint-dir) into a bash -c
    string, so each is shell-quoted; extra_packages join the pip install
    (e.g. gcsfs for gs:// checkpoints)."""
    args = " ".join(shlex.quote(a) for a in extra_args)
    packages = "".join(f" {shlex.quote(p)}" for p in extra_packages)
    return (
        f"pip install --quiet {PACKAGE_MOUNT_PATH}/{packaging.ARCHIVE_NAME} "
        f"'{PROBE_JAX_PIN}'{packages} -f {PROBE_LIBTPU_INDEX} && "
        f"python -m {module} {args}".rstrip()
    )


def to_package_configmap(root: Path | None = None) -> dict:
    """The framework source archive as a ConfigMap (binaryData), mounted by
    the benchmark Job. The archive is deterministic (packaging.py) so this
    manifest is stable across re-runs."""
    blob = packaging.build_archive_bytes(root)
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": PACKAGE_CONFIGMAP_NAME},
        "binaryData": {packaging.ARCHIVE_NAME: base64.b64encode(blob).decode()},
    }


def _slice_job_name(config: ClusterConfig, name: str, slice_index: int) -> str:
    """Indexed-Job pod hostnames are {job_name}-{index}; with num_slices
    > 1 jobs are named {name}-{slice}, so the coordinator address must
    derive from the per-slice job name — each slice forms its own JAX
    cluster (the reference joined each node through its own registration
    URL, rancherhost/tasks/main.yml:19-24)."""
    return f"{name}-{slice_index}" if config.num_slices > 1 else name


def tpu_job_env(
    config: ClusterConfig,
    job_name: str,
    svc: str,
    *,
    name: str | None = None,
    slice_index: int = 0,
    cross_slice: bool | None = None,
) -> list[dict]:
    """The coordinator/topology env wiring every multi-host TPU Job needs
    (the registrationUrl handoff analogue, rancherhost/tasks/main.yml:19-24):
    jax.distributed.initialize reads JAX_*; libtpu's multi-host topology
    discovery reads TPU_WORKER_HOSTNAMES (the full per-pod list — a bare
    service name would not resolve per pod) and TPU_WORKER_ID. Shared by the
    benchmark Job and user-supplied (BYO) workload Jobs so both wire the
    same way.

    cross_slice (default: on whenever num_slices > 1) joins every slice's Job into ONE jax.distributed cluster — the
    reference joined every provisioned node into one compute surface
    (rancherhost/tasks/main.yml:26-34), and so does this: the coordinator
    is slice 0's pod 0, JAX_NUM_PROCESSES spans all slices, and the
    TK8S_* slice coordinates let parallel/distributed.py compute the
    global process id (a manifest fieldRef cannot do the arithmetic) and
    export libtpu's MEGASCALE_* DCN transport vars at runtime.
    TPU_WORKER_HOSTNAMES stays per-slice either way: it feeds libtpu's
    WITHIN-slice ICI topology discovery; the cross-slice hop is DCN.
    Pass cross_slice=False (CLI --independent-slices) for
    N independent clusters."""
    hosts = config.hosts_per_slice
    topo = config.parsed_topology
    if cross_slice is None:
        cross_slice = config.num_slices > 1
    index_ref = {
        "valueFrom": {
            "fieldRef": {
                "fieldPath": "metadata.annotations['batch.kubernetes.io/job-completion-index']"
            }
        }
    }
    if cross_slice and config.num_slices > 1:
        base = name if name is not None else job_name.rsplit("-", 1)[0]
        slice0_job = _slice_job_name(config, base, 0)
        env = [
            {"name": "JAX_COORDINATOR_ADDRESS",
             "value": f"{slice0_job}-0.{svc}:8476"},
            {"name": "JAX_NUM_PROCESSES",
             "value": str(config.num_slices * hosts)},
            {"name": "JAX_PROCESS_ID", **index_ref},
            {"name": "TK8S_NUM_SLICES", "value": str(config.num_slices)},
            {"name": "TK8S_SLICE_ID", "value": str(slice_index)},
            {"name": "TK8S_PROCS_PER_SLICE", "value": str(hosts)},
        ]
    else:
        env = [
            {"name": "JAX_COORDINATOR_ADDRESS",
             "value": f"{job_name}-0.{svc}:8476"},
            {"name": "JAX_NUM_PROCESSES", "value": str(hosts)},
            {"name": "JAX_PROCESS_ID", **index_ref},
        ]
    return env + [
        {"name": "TPU_TOPOLOGY", "value": str(topo)},
        {
            "name": "TPU_WORKER_HOSTNAMES",
            "value": ",".join(f"{job_name}-{i}.{svc}" for i in range(hosts)),
        },
        {"name": "TPU_WORKER_ID", **index_ref},
    ]


def _indexed_tpu_job(
    config: ClusterConfig,
    *,
    name: str,
    job_name: str,
    slice_index: int,
    container: dict,
    backoff_limit: int,
    pod_spec_extra: dict | None = None,
) -> dict:
    """One Indexed Job spanning every host of a slice: one pod per TPU
    host (SPMD — no master/worker asymmetry), nodeSelector pinning to
    the accelerator+topology, google.com/tpu chip accounting via GKE's
    device plugin."""
    topo = config.parsed_topology
    hosts = config.hosts_per_slice
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": job_name,
            "labels": {"app": name, "slice": str(slice_index)},
        },
        "spec": {
            "completions": hosts,
            "parallelism": hosts,
            "completionMode": "Indexed",
            "backoffLimit": backoff_limit,
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "subdomain": f"{name}-svc",
                    "restartPolicy": "Never",
                    "nodeSelector": {
                        "cloud.google.com/gke-tpu-accelerator": _gke_accelerator_label(
                            config.generation
                        ),
                        "cloud.google.com/gke-tpu-topology": str(topo),
                    },
                    "containers": [container],
                    **(pod_spec_extra or {}),
                },
            },
        },
    }


def to_user_workload_job(
    config: ClusterConfig,
    *,
    name: str,
    image: str,
    command: list[str],
    slice_index: int = 0,
    env: dict[str, str] | None = None,
    backoff_limit: int = 0,
    cross_slice: bool | None = None,
) -> dict:
    """A user-supplied (bring-your-own) training/serving container on the
    provisioned TPU pool — the reference's third-party-app walkthrough
    (its docs/detailed.md:255-371 deployed Ghost and Guestbook onto the
    cluster) re-expressed for TPU workloads: your image + command, the
    framework's slice wiring. The container gets the same coordinator/
    topology env and chip requests as the benchmark Job, so any JAX
    program that calls jax.distributed.initialize() (or this package's
    parallel.initialize_from_env) forms the slice's mesh unchanged.

    `env` adds/overrides plain-value variables (e.g. your HF_TOKEN or
    config knobs). manifests/byo-workload.example.yaml shows a rendered
    example; docs/detailed.md §2b is the walkthrough.
    """
    if config.is_gpu:
        return to_gpu_user_workload_job(
            config, name=name, image=image, command=command,
            slice_index=slice_index, env=env, backoff_limit=backoff_limit,
            cross_slice=cross_slice)
    spec = config.spec
    topo = config.parsed_topology
    job_name = _slice_job_name(config, name, slice_index)
    svc = f"{name}-svc"
    env_block = tpu_job_env(config, job_name, svc, name=name,
                            slice_index=slice_index, cross_slice=cross_slice)
    for key, value in (env or {}).items():
        env_block = [e for e in env_block if e["name"] != key]
        env_block.append({"name": key, "value": value})
    chips_on_host = spec.chips_on_host(topo)
    container = {
        "name": "workload",
        "image": image,
        "command": list(command),
        "resources": {
            "requests": {"google.com/tpu": str(chips_on_host)},
            "limits": {"google.com/tpu": str(chips_on_host)},
        },
        "env": env_block,
        "ports": [{"containerPort": 8476}],
    }
    return _indexed_tpu_job(
        config,
        name=name,
        job_name=job_name,
        slice_index=slice_index,
        container=container,
        backoff_limit=backoff_limit,
    )


def _bench_workload(
    config: ClusterConfig,
    *,
    workload: str,
    bench_flags: tuple[str, ...],
    checkpoint_dir: str,
    command: list[str] | None,
    slice_index: int,
    cross_slice: bool | None,
) -> tuple[str, tuple[str, ...], tuple[str, ...], bool]:
    """The benchmark Job's module, its arguments, the packages its
    install adds, and the resolved cross-slice setting: shared by the TPU
    and the GPU Jobs, so both validate a workload the same way."""
    if workload not in BENCH_WORKLOADS:
        raise ValueError(
            f"workload={workload!r}: expected one of "
            f"{sorted(BENCH_WORKLOADS)}"
        )
    module, implied_flags = BENCH_WORKLOADS[workload]
    bench_flags = (*implied_flags, *bench_flags)
    if checkpoint_dir and workload not in CHECKPOINTABLE_WORKLOADS:
        # caught here, at manifest compile time, because the module's
        # argparse would otherwise reject --checkpoint-dir on every pod
        # and the Job would burn its whole restart budget on a
        # guaranteed-failing command
        raise ValueError(
            f"--checkpoint-dir is not supported by the {workload!r} "
            f"workload (training workloads only: "
            f"{sorted(CHECKPOINTABLE_WORKLOADS)})"
        )
    # resolve the mode ONCE: the checkpoint layout and the cluster
    # topology env must agree (independent clusters sharing one orbax
    # dir would clobber each other's steps)
    cross_slice = (cross_slice if cross_slice is not None
                   else config.num_slices > 1)
    # Checkpoints need a home that outlives the pod; a gs:// bucket is the
    # durable choice (orbax writes it natively — the node pool's service
    # account needs storage read/write scope, see docs/benchmarks.md).
    if checkpoint_dir and command is not None:
        raise ValueError(
            "checkpoint_dir only applies to the generated benchmark "
            "command; bake the flag into the explicit `command` instead"
        )
    bench_args: tuple[str, ...] = ("--json", *bench_flags)
    extra_packages: tuple[str, ...] = ()
    if checkpoint_dir:
        # Independent slices each train their own state -> per-slice
        # subdirectories so they don't clobber one another. Cross-slice
        # mode trains ONE state across all slices -> one shared dir
        # (orbax's multihost protocol has only process 0 finalize).
        if config.num_slices > 1 and not cross_slice:
            ckpt = checkpoint_dir.rstrip("/") + f"/slice-{slice_index}"
        else:
            ckpt = checkpoint_dir.rstrip("/")
        bench_args += ("--checkpoint-dir", ckpt)
        if checkpoint_dir.startswith("gs://"):
            # orbax's epath needs a GCS backend; plain python pods have
            # none and would crash-loop on the first mkdir (pyproject
            # optional-dependency `gcs`)
            extra_packages = ("gcsfs",)
    return module, bench_args, extra_packages, cross_slice


def to_benchmark_job(
    config: ClusterConfig,
    *,
    name: str = "resnet50-bench",
    image: str = BENCH_IMAGE_DEFAULT,
    command: list[str] | None = None,
    slice_index: int = 0,
    checkpoint_dir: str = "",
    workload: str = "resnet50",
    bench_flags: tuple[str, ...] = (),
    cross_slice: bool | None = None,
) -> dict:
    """Training benchmark as an Indexed Job spanning every host of a slice.

    This is the TPU-native re-expression of the reference's benchmark
    container workload (docs/benchmarks.md:1-4) and its node-join logic
    (rancherhost/tasks/main.yml:26-34): instead of a rancher/agent phoning
    home, K8s schedules one pod per TPU host; the completion index + a
    headless service give jax.distributed.initialize its coordinator.

    `workload` picks the benchmark family ("resnet50" — the flagship —
    or "lm", the long-context Transformer); `bench_flags` append raw
    module flags, which is how the parallelism knobs reach the cluster
    (e.g. ("--sequence-parallelism", "4") or ("--moe-experts", "8",
    "--expert-parallelism", "4") — benchmarks/lm.py validates the
    combinations at startup, so a bad set fails the Job loudly on the
    first pod log line rather than silently running something else).
    """
    module, bench_args, extra_packages, cross_slice = _bench_workload(
        config, workload=workload, bench_flags=bench_flags,
        checkpoint_dir=checkpoint_dir, command=command,
        slice_index=slice_index, cross_slice=cross_slice)
    if config.is_gpu:
        return to_gpu_benchmark_job(
            config, name=name, image=None if image == BENCH_IMAGE_DEFAULT else image,
            command=command, slice_index=slice_index, module=module,
            bench_args=bench_args, extra_packages=extra_packages,
            cross_slice=cross_slice, checkpointed=bool(checkpoint_dir))
    spec = config.spec
    topo = config.parsed_topology
    chips_on_host = spec.chips_on_host(topo)
    svc = f"{name}-svc"
    job_name = _slice_job_name(config, name, slice_index)
    # Default path: plain python image + self-install from the package
    # ConfigMap (bench_command). A custom image is assumed to carry the
    # framework already (Dockerfile at the repo root builds one).
    self_install = command is None and image == BENCH_IMAGE_DEFAULT
    if command is None:
        command = (
            ["bash", "-c", bench_command(module=module,
                                         extra_args=bench_args,
                                         extra_packages=extra_packages)]
            if self_install
            else ["python", "-m", module, *bench_args]
        )
    container = {
        "name": "bench",
        "image": image,
        "command": command,
        "resources": {
            "requests": {"google.com/tpu": str(chips_on_host)},
            "limits": {"google.com/tpu": str(chips_on_host)},
        },
        "env": tpu_job_env(config, job_name, svc, name=name,
                           slice_index=slice_index, cross_slice=cross_slice),
        "ports": [{"containerPort": 8476}],
    }
    pod_spec_extra = {}
    if self_install:
        container["volumeMounts"] = [
            {"name": "tk8s-pkg", "mountPath": PACKAGE_MOUNT_PATH, "readOnly": True}
        ]
        pod_spec_extra["volumes"] = [
            {
                "name": "tk8s-pkg",
                "configMap": {"name": PACKAGE_CONFIGMAP_NAME},
            }
        ]
    # Failure recovery (SURVEY.md §5; the reference's node-join converged
    # on re-run, rancherhost/tasks/main.yml:2-9): one lost pod kills the
    # slice's whole JAX cluster — every sibling crashes on the broken
    # collective — so a single recovery costs ~`hosts` pod failures.
    # With a checkpoint dir, budget 3 gang restarts (each retry
    # self-resumes from the latest per-window save); without one a retry
    # would replay the whole run from step 0, so keep fail-fast.
    hosts = config.hosts_per_slice
    return _indexed_tpu_job(
        config,
        name=name,
        job_name=job_name,
        slice_index=slice_index,
        container=container,
        backoff_limit=3 * hosts if checkpoint_dir else 0,
        pod_spec_extra=pod_spec_extra,
    )


# THE host jax pin. The tpuhost role defaults
# (ansible/roles/tpuhost/defaults/main.yml jax_version) must match;
# tests/test_infra.py enforces the equality since YAML can't import this.
JAX_VERSION_PIN = "0.4.38"
PROBE_JAX_PIN = f"jax[tpu]=={JAX_VERSION_PIN}"
PROBE_LIBTPU_INDEX = "https://storage.googleapis.com/jax-releases/libtpu_releases.html"


def to_probe_job(
    config: ClusterConfig,
    *,
    name: str = "tpu-probe",
    image: str = BENCH_IMAGE_DEFAULT,
) -> dict:
    """A short acceptance-test Job: one pod per TPU host — across ALL
    slices — running the JAX device-count smoke test (jax_smoke_command).
    "Chips allocatable" at the node level still doesn't prove a workload
    can enumerate them; this is the deterministic replacement for the
    reference's dashboard-probe workaround (reference setup.sh:59-85) at
    the workload level. Driven by provision/readiness.py run_probe_job.

    Coverage: each pod requests every chip of one host, so with
    completions == total hosts, resource accounting forces exactly one pod
    onto every TPU host — no per-slice pinning needed. The default image
    is a plain python base; the probe self-installs the pinned jax[tpu]
    (same pin as the tpuhost role) so it works without a custom image.
    A GPU deployment's probe is `to_gpu_probe_job`.
    """
    if config.is_gpu:
        return to_gpu_probe_job(
            config, image=None if image == BENCH_IMAGE_DEFAULT else image,
            **({} if name == "tpu-probe" else {"name": name}))
    spec = config.spec
    topo = config.parsed_topology
    total_hosts = config.num_slices * config.hosts_per_slice
    chips_on_host = spec.chips_on_host(topo)
    probe_cmd = (
        f"pip install --quiet '{PROBE_JAX_PIN}' -f {PROBE_LIBTPU_INDEX} && "
        + jax_smoke_command(chips_on_host)
    )
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {
            "completions": total_hosts,
            "parallelism": total_hosts,
            "completionMode": "Indexed",
            "backoffLimit": 2,
            "ttlSecondsAfterFinished": 600,
            "template": {
                "spec": {
                    "restartPolicy": "Never",
                    "nodeSelector": {
                        "cloud.google.com/gke-tpu-accelerator": _gke_accelerator_label(
                            config.generation
                        ),
                        "cloud.google.com/gke-tpu-topology": str(topo),
                    },
                    "containers": [
                        {
                            "name": "probe",
                            "image": image,
                            "command": ["bash", "-c", probe_cmd],
                            "resources": {
                                "requests": {"google.com/tpu": str(chips_on_host)},
                                "limits": {"google.com/tpu": str(chips_on_host)},
                            },
                        }
                    ],
                }
            },
        },
    }


def to_headless_service(name: str = "resnet50-bench", port: int = 8476,
                        port_name: str = "jax-coordinator") -> dict:
    """Headless Service for pod-to-pod coordinator discovery (SURVEY.md §7
    'hard parts': coordinator discovery inside K8s). A GPU Job set names
    the launcher's rendezvous port instead (`_service_port`)."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": f"{name}-svc"},
        "spec": {
            "clusterIP": "None",  # the k8s API literal, not YAML null
            "selector": {"app": name},
            "ports": [{"port": port, "name": port_name}],
        },
    }


def _service_port(config: ClusterConfig) -> dict:
    """The headless Service's port for the deployment's Jobs."""
    return ({"port": GPU_MASTER_PORT, "port_name": "torch-rendezvous"}
            if config.is_gpu else {})


def _gke_accelerator_label(generation: str) -> str:
    return {
        "v4": "tpu-v4-podslice",
        "v5e": "tpu-v5-lite-podslice",
        "v5p": "tpu-v5p-slice",
        "v6e": "tpu-v6e-slice",
    }[generation]


def write_manifests(
    config: ClusterConfig,
    manifests_dir: Path,
    workload_image: str = "",
    workload_command: list[str] | None = None,
    workload_name: str = "workload",
    **job_kwargs,
) -> list[Path]:
    """Compile the benchmark Job set — and, when `workload_image` is
    given, a user-supplied (BYO) workload Job set next to it, one Job per
    slice with the same coordinator/topology wiring (the CLI's
    --workload-image/--workload-command; docs/detailed.md §2b)."""
    manifests_dir.mkdir(parents=True, exist_ok=True)
    # the generated dir is owned by this compiler: stale files from a
    # previous (larger) topology must not survive a resize — a leftover
    # bench-job-2.yaml would `kubectl apply` a Job for a slice that no
    # longer exists
    for stale in manifests_dir.glob("*.yaml"):
        stale.unlink()
    paths = []
    # package ConfigMap first: the Job's self-install mount depends on it
    pkg = manifests_dir / "package-configmap.yaml"
    pkg.write_text(yaml.safe_dump(to_package_configmap(), sort_keys=False))
    paths.append(pkg)
    svc = manifests_dir / "bench-service.yaml"
    svc.write_text(yaml.safe_dump(to_headless_service(**_service_port(config)),
                                  sort_keys=False))
    paths.append(svc)
    for i in range(config.num_slices):
        job = manifests_dir / f"bench-job-{i}.yaml"
        job.write_text(
            yaml.safe_dump(to_benchmark_job(config, slice_index=i, **job_kwargs), sort_keys=False)
        )
        paths.append(job)
    if workload_image:
        wsvc = manifests_dir / "workload-service.yaml"
        wsvc.write_text(
            yaml.safe_dump(to_headless_service(workload_name, **_service_port(config)),
                           sort_keys=False)
        )
        paths.append(wsvc)
        for i in range(config.num_slices):
            wjob = manifests_dir / f"workload-job-{i}.yaml"
            wjob.write_text(
                yaml.safe_dump(
                    to_user_workload_job(
                        config,
                        name=workload_name,
                        image=workload_image,
                        command=list(workload_command or []),
                        slice_index=i,
                        cross_slice=job_kwargs.get("cross_slice"),
                    ),
                    sort_keys=False,
                )
            )
            paths.append(wjob)
    return paths


# ---------------------------------------------------------------- GPU plane
#
# The H100 counterparts of the TPU documents above. One launcher process
# per host (`python -m torch.distributed.run`) starts one worker per GPU;
# its arguments carry the coordinates, so no GPU document sets a JAX_*
# variable or writes /etc/tpu-cluster.env: eight workers of one host
# reading that per-host contract would all take the host's rank
# (parallel/distributed.join prefers it), where the launcher's group gives
# each its own.

# the launcher's rendezvous port (torch.distributed.run's default)
GPU_MASTER_PORT = 29500


def _per_host(config: ClusterConfig) -> int:
    """GPUs (chips) on each host of the deployment's slices."""
    return config.spec.chips_on_host(config.parsed_topology)


def gpu_smoke_command(expected_devices: int) -> str:
    """The per-host acceptance test of a GPU host, the counterpart of
    `jax_smoke_command`: torch sees exactly `expected_devices` CUDA
    devices, each of compute capability (9, 0) (the kernels are built for
    sm_90a only), and the port's own nvcc lookup
    (`ops/cuda_build.nvcc_path`) finds a compiler, which the kernels'
    first launch needs; nothing is built. Shared by the gpuhost ansible
    role (via to_ansible_vars) and the GKE probe Job."""
    return (
        "python3 -c \"import torch; "
        "from tritonk8ssupervisor_tpu_torch.ops import cuda_build; "
        "n = torch.cuda.device_count(); "
        f"assert n == {expected_devices}, "
        f"f'expected {expected_devices} CUDA devices, saw {{n}}'; "
        "caps = sorted(set(torch.cuda.get_device_capability(i) for i in range(n))); "
        "assert caps == [(9, 0)], "
        "f'expected compute capability (9, 0) on every device, saw {caps}'; "
        "nvcc = cuda_build.nvcc_path(); "
        "print(f'GPU OK: {n} devices, capability 9.0, nvcc {nvcc}')\""
    )


def gpu_launcher_args(nnodes: int, gpus_per_node: int, node_rank, master_addr: str,
                      master_port: int = GPU_MASTER_PORT) -> str:
    """`python -m torch.distributed.run`'s arguments for one host of a
    deployment: `node_rank` may be a shell or template expression the
    host resolves ($JOB_COMPLETION_INDEX, an inventory variable)."""
    return (f"--nnodes {nnodes} --nproc-per-node {gpus_per_node} "
            f"--node-rank {node_rank} --master-addr {master_addr} "
            f"--master-port {master_port}")


def gpu_cluster_smoke_command(
    expected_gpus: int,
    node_rank,
    *,
    nnodes: int,
    gpus_per_node: int,
    master_addr: str,
    master_port: int = GPU_MASTER_PORT,
    timeout_s: int = 240,
) -> str:
    """The cluster-wide rendezvous acceptance of a GPU deployment, the
    counterpart of `cluster_smoke_command`: every host runs it at once
    under the launcher (one worker per GPU); each worker forms an NCCL
    group itself, even at a world of one (the port's
    `init_from_launcher` leaves a world of one without a group), and
    all-reduces a one: the sum must equal the deployment's GPU total.
    Each host's first worker prints the verdict. `timeout` bounds a
    wedged rendezvous."""
    launcher = gpu_launcher_args(nnodes, gpus_per_node, node_rank, master_addr, master_port)
    return (
        f"timeout {timeout_s} python3 -m torch.distributed.run {launcher} "
        "--no-python python3 -c \"import datetime, os, torch; "
        "import torch.distributed as dist; "
        "local = int(os.environ['LOCAL_RANK']); torch.cuda.set_device(local); "
        "dist.init_process_group('nccl', "
        f"timeout=datetime.timedelta(seconds={timeout_s})); "
        "ones = torch.ones(1, device='cuda'); dist.all_reduce(ones); "
        "n = int(ones.item()); w = dist.get_world_size(); dist.destroy_process_group(); "
        f"assert n == {expected_gpus}, "
        f"f'expected {expected_gpus} cluster GPUs, saw {{n}}'; "
        "print(f'CLUSTER OK: {w} processes, {n} GPUs') if local == 0 else None\""
    )


def _gpu_ansible_vars(config: ClusterConfig, coordinator_ip: str) -> dict:
    """The gpuhost and gkegpujoin roles' vars. The cluster smoke spans
    every slice at once, as the TPU one does for cross-slice
    deployments; the host's launcher node rank and the coordinator come
    from the inventory's hostvars when ansible renders the command."""
    per_host = _per_host(config)
    total = config.num_slices * config.chips_per_slice
    return {
        "coordinator": coordinator_ip,
        "kubernetes_name": config.env_name,
        "kubernetes_description": config.env_description,
        "gpu_generation": config.generation,
        "accelerator_type": config.accelerator_type,
        "machine_type": config.gke_machine_type,
        "boot_image": config.effective_runtime_version,
        "expected_devices_per_host": per_host,
        "hosts_per_slice": config.hosts_per_slice,
        "num_slices": config.num_slices,
        "expected_total_gpus": total,
        "gpu_smoke_cmd": gpu_smoke_command(per_host),
        "cluster_smoke_cmd": gpu_cluster_smoke_command(
            total, "{{ node_rank }}",
            nnodes=config.num_slices * config.hosts_per_slice,
            gpus_per_node=per_host, master_addr="{{ global_coordinator }}"),
        "project": config.project,
        "zone": config.zone,
        "cluster_name": config.cluster_name,
        "mode": config.mode,
    }


def gpu_job_world(config: ClusterConfig, name: str, svc: str, slice_index: int,
                  cross_slice: bool | None) -> tuple[int, str, str]:
    """(nodes, this pod's node-rank shell expression, master address) of
    a GPU Job's launcher. Cross-slice (the default with several slices)
    spans every slice: the master is slice 0's pod 0 and the rank is
    slice x hosts + the pod's completion index."""
    hosts = config.hosts_per_slice
    if cross_slice is None:
        cross_slice = config.num_slices > 1
    if cross_slice and config.num_slices > 1:
        offset = slice_index * hosts
        rank = ("$JOB_COMPLETION_INDEX" if offset == 0
                else f"$((JOB_COMPLETION_INDEX+{offset}))")
        master = f"{_slice_job_name(config, name, 0)}-0.{svc}"
        return config.num_slices * hosts, rank, master
    job_name = _slice_job_name(config, name, slice_index)
    return hosts, "$JOB_COMPLETION_INDEX", f"{job_name}-0.{svc}"


def gpu_job_env(nnodes: int, gpus_per_node: int, master: str) -> list[dict]:
    """The launcher's coordinates as the PET_* variables
    `torch.distributed.run` reads for any argument it is not given: the
    user-workload Job's command runs the launcher with none."""
    return [
        {"name": "PET_NNODES", "value": str(nnodes)},
        {"name": "PET_NPROC_PER_NODE", "value": str(gpus_per_node)},
        {"name": "PET_MASTER_ADDR", "value": master},
        {"name": "PET_MASTER_PORT", "value": str(GPU_MASTER_PORT)},
    ]


def _gpu_container(config: ClusterConfig, name: str, image: str, command: list[str],
                   env: list[dict]) -> dict:
    per_host = str(_per_host(config))
    container = {
        "name": name,
        "image": image,
        "command": command,
        "resources": {
            "requests": {"nvidia.com/gpu": per_host},
            "limits": {"nvidia.com/gpu": per_host},
        },
    }
    if env:
        container["env"] = env
        container["ports"] = [{"containerPort": GPU_MASTER_PORT}]
    container["volumeMounts"] = [{"name": "dshm", "mountPath": "/dev/shm"}]
    return container


def _package_mount(container: dict, pod_spec: dict) -> None:
    """Mount the package ConfigMap at PACKAGE_MOUNT_PATH."""
    container["volumeMounts"].append(
        {"name": "tk8s-pkg", "mountPath": PACKAGE_MOUNT_PATH, "readOnly": True})
    pod_spec["volumes"].append(
        {"name": "tk8s-pkg", "configMap": {"name": PACKAGE_CONFIGMAP_NAME}})


def _indexed_gpu_job(config: ClusterConfig, *, name: str, job_name: str, slice_index: int,
                     container: dict, backoff_limit: int, package: bool) -> dict:
    """One Indexed Job spanning every host of a slice, one pod a host
    holding all its GPUs (nvidia.com/gpu through GKE's device plugin),
    pinned to the A3 node pool by the accelerator label. NCCL's
    shared-memory transport needs more /dev/shm than a container's
    default 64 MB: a memory-backed volume is mounted there."""
    hosts = config.hosts_per_slice
    pod_spec = {
        "subdomain": f"{name}-svc",
        "restartPolicy": "Never",
        "nodeSelector": {"cloud.google.com/gke-accelerator": config.accelerator_type},
        "containers": [container],
        "volumes": [{"name": "dshm", "emptyDir": {"medium": "Memory"}}],
    }
    if package:
        _package_mount(container, pod_spec)
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": job_name, "labels": {"app": name, "slice": str(slice_index)}},
        "spec": {
            "completions": hosts,
            "parallelism": hosts,
            "completionMode": "Indexed",
            "backoffLimit": backoff_limit,
            "template": {"metadata": {"labels": {"app": name}}, "spec": pod_spec},
        },
    }


def gpu_bench_command(launcher: str, module: str, extra_args: tuple[str, ...] = ("--json",),
                      extra_packages: tuple[str, ...] = (), install: bool = True) -> str:
    """The GPU Job's command: install the ConfigMap-mounted archive into
    the image's torch (a CUDA devel image: the kernels are built with
    nvcc at first launch), then start the module under the launcher.
    extra_args are shell-quoted, as in `bench_command`."""
    args = " ".join(shlex.quote(a) for a in extra_args)
    packages = "".join(f" {shlex.quote(p)}" for p in extra_packages)
    run = f"python -m torch.distributed.run {launcher} -m {module} {args}".rstrip()
    if not install:
        return run
    return (f"pip install --quiet {PACKAGE_MOUNT_PATH}/{packaging.ARCHIVE_NAME}"
            f"{packages} && {run}")


def to_gpu_benchmark_job(
    config: ClusterConfig,
    *,
    name: str = "resnet50-bench",
    image: str | None = None,
    command: list[str] | None = None,
    slice_index: int = 0,
    module: str = BENCH_WORKLOADS["resnet50"][0],
    bench_args: tuple[str, ...] = ("--json",),
    extra_packages: tuple[str, ...] = (),
    cross_slice: bool | None = None,
    checkpointed: bool = False,
) -> dict:
    """The benchmark Job of a gke-gpu slice (to_benchmark_job validates
    the workload and calls this): one pod a host running the launcher
    with one worker a GPU. The default image is the catalog's CUDA devel
    image with torch, into which the command installs the port's archive
    from the ConfigMap; another image is taken to carry the port already.
    A lost pod fails the whole launcher group, so the restart budget is
    the TPU Job's: 3 gang restarts with a checkpoint, none without."""
    svc = f"{name}-svc"
    job_name = _slice_job_name(config, name, slice_index)
    nnodes, rank, master = gpu_job_world(config, name, svc, slice_index, cross_slice)
    per_host = _per_host(config)
    self_install = command is None and image is None
    if command is None:
        launcher = gpu_launcher_args(nnodes, per_host, rank, master)
        command = ["bash", "-c", gpu_bench_command(
            launcher, module, bench_args, extra_packages, install=self_install)]
    container = _gpu_container(config, "bench", image or config.spec.job_image, command,
                               gpu_job_env(nnodes, per_host, master))
    return _indexed_gpu_job(
        config, name=name, job_name=job_name, slice_index=slice_index,
        container=container,
        backoff_limit=3 * config.hosts_per_slice if checkpointed else 0,
        package=self_install)


def to_gpu_user_workload_job(
    config: ClusterConfig,
    *,
    name: str,
    image: str,
    command: list[str],
    slice_index: int = 0,
    env: dict[str, str] | None = None,
    backoff_limit: int = 0,
    cross_slice: bool | None = None,
) -> dict:
    """A bring-your-own container on a gke-gpu pool: the image and command
    are the user's, the launcher's coordinates arrive as the PET_*
    variables (so `python -m torch.distributed.run -m your.module` needs
    no arguments) and the command runs with this host's PET_NODE_RANK
    exported, computed from the completion index in the shell."""
    svc = f"{name}-svc"
    job_name = _slice_job_name(config, name, slice_index)
    nnodes, rank, master = gpu_job_world(config, name, svc, slice_index, cross_slice)
    env_block = gpu_job_env(nnodes, _per_host(config), master)
    for key, value in (env or {}).items():
        env_block = [e for e in env_block if e["name"] != key]
        env_block.append({"name": key, "value": value})
    wrapped = ["bash", "-c", f'export PET_NODE_RANK={rank}; exec "$@"', "--", *command]
    container = _gpu_container(config, "workload", image, wrapped, env_block)
    return _indexed_gpu_job(
        config, name=name, job_name=job_name, slice_index=slice_index,
        container=container, backoff_limit=backoff_limit, package=False)


def to_gpu_probe_job(config: ClusterConfig, *, name: str = "gpu-probe",
                     image: str | None = None) -> dict:
    """The GPU probe Job: one pod on every A3 host of every slice (each
    requests all of a host's GPUs, so completions == hosts places one a
    host), installing the port's archive from the ConfigMap into the
    image and running `gpu_smoke_command`. Driven by
    provision/readiness.py run_probe_job, which applies the ConfigMap
    first."""
    total_hosts = config.num_slices * config.hosts_per_slice
    per_host = _per_host(config)
    probe_cmd = (f"pip install --quiet {PACKAGE_MOUNT_PATH}/{packaging.ARCHIVE_NAME} && "
                 + gpu_smoke_command(per_host))
    container = _gpu_container(config, "probe", image or config.spec.job_image,
                               ["bash", "-c", probe_cmd], [])
    pod_spec = {
        "restartPolicy": "Never",
        "nodeSelector": {"cloud.google.com/gke-accelerator": config.accelerator_type},
        "containers": [container],
        "volumes": [{"name": "dshm", "emptyDir": {"medium": "Memory"}}],
    }
    _package_mount(container, pod_spec)
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {
            "completions": total_hosts,
            "parallelism": total_hosts,
            "completionMode": "Indexed",
            "backoffLimit": 2,
            "ttlSecondsAfterFinished": 600,
            "template": {"spec": pod_spec},
        },
    }
