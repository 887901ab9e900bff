"""Terraform wrapper.

Rebuild of `runTerraformTasks` (reference setup.sh:138-161) minus its HCL
code generation: the reference string-concatenated a root module per run
(`updateTerraformConfig`, setup.sh:162-198); here the modules under
terraform/{tpu-vm,gke}/ are static HCL with `count` fan-out and all
per-run data flows through terraform.tfvars.json (config/compile.py).

Phase contract: on success the provisioned endpoints are persisted to
terraform/hosts.json — the masters.ip/hosts.ip analogue
(terraform/master/main.tf:29-31) that the ansible layer requires
(setup.sh:117-120).

The port's copy of `tritonk8ssupervisor_tpu/provision/terraform.py`, whole
and under the reference's names: the port imports nothing of the JAX
package. The GPU modes have modules of their own, terraform/gke-gpu and
terraform/gpu-vm (one module per mode, as before); gpu-vm's outputs have
tpu-vm's shape.
"""

from __future__ import annotations

import json
import os
import sys

from tritonk8ssupervisor_tpu_torch.config import compile as compiler
from tritonk8ssupervisor_tpu_torch.config.schema import (
    ALL_MODES,
    VM_MODES,
    ClusterConfig,
    ConfigError,
)
from tritonk8ssupervisor_tpu_torch.provision import runner as run_mod
from tritonk8ssupervisor_tpu_torch.provision.state import ClusterHosts, RunPaths


def already_applied(config: ClusterConfig, paths: RunPaths) -> bool:
    """Skip-if-provisioned idempotency (setup.sh:139-143): a non-empty
    tfstate means apply already ran; re-running converges via terraform."""
    state_file = paths.tfstate(config.mode)
    if not state_file.exists():
        return False
    try:
        state = json.loads(state_file.read_text())
    except json.JSONDecodeError:
        return False
    return bool(state.get("resources"))


def precheck(config: ClusterConfig, paths: RunPaths) -> None:
    """Static HCL validation before any cloud call: parsed-AST variable and
    reference checks plus tfvars coverage (infra/hcl.py) — what `terraform
    validate`+`plan` would catch, without needing the binary. Skipped
    silently when lark is unavailable (pip-installed minimal envs)."""
    try:
        from tritonk8ssupervisor_tpu_torch.infra import hcl
    except ImportError:  # pragma: no cover - lark not installed
        return
    module_dir = paths.terraform_module(config.mode)
    if not list(module_dir.glob("*.tf")):
        return  # test sandboxes run against stub module dirs
    try:
        module = hcl.parse_module_dir(module_dir)
    except Exception as e:  # noqa: BLE001 - grammar gaps must not block apply
        # The in-repo grammar covers the constructs these modules use, not
        # all of HCL (heredocs, splats, ...). Valid-but-unparseable HCL is
        # terraform's to judge — warn and let apply proceed.
        print(
            f"WARNING: HCL precheck skipped ({module_dir}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return
    problems = hcl.validate_module(module)
    problems += hcl.check_tfvars(module, compiler.to_tfvars(config))
    if problems:
        raise ConfigError(
            "terraform module precheck failed:\n  " + "\n  ".join(problems)
        )


def terraform_env(paths: RunPaths, environ: dict | None = None) -> dict:
    """Child environment for terraform commands: TF_PLUGIN_CACHE_DIR
    pinned to a shared cache under terraform/ so the google provider
    (~100 MB) downloads ONCE per checkout instead of once per module per
    re-run — a full network round-trip shaved off every converge. An
    operator's own TF_PLUGIN_CACHE_DIR wins."""
    env = dict(os.environ if environ is None else environ)
    if not env.get("TF_PLUGIN_CACHE_DIR"):
        cache = paths.terraform_dir / ".plugin-cache"
        try:
            cache.mkdir(parents=True, exist_ok=True)
        except OSError:
            return env  # unwritable checkout: terraform caches per-module
        env["TF_PLUGIN_CACHE_DIR"] = str(cache)
    return env


def init_needed(config: ClusterConfig, paths: RunPaths) -> bool:
    """`terraform init` is only needed until the module's .terraform/
    (providers + lock) exists; after that, re-running init is a network
    round-trip that adds nothing to a converge. Provider upgrades are an
    explicit operator action (`terraform init -upgrade`), not something
    every provision run should re-negotiate."""
    module_dir = paths.terraform_module(config.mode)
    return not (module_dir / ".terraform").is_dir()


def apply(
    config: ClusterConfig,
    paths: RunPaths,
    run: run_mod.RunFn = run_mod.run_streaming,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
) -> ClusterHosts:
    """terraform init (first run only) + apply, then persist endpoints.

    `terraform get && terraform apply` analogue (setup.sh:154-158); output
    collection replaces the reference's local-exec IP appending.
    """
    module_dir = paths.terraform_module(config.mode)
    precheck(config, paths)
    compiler.write_tfvars(config, paths.terraform_dir)
    env = terraform_env(paths)
    if init_needed(config, paths):
        run(["terraform", "init", "-input=false", "-no-color"],
            cwd=module_dir, env=env)
    else:
        print(f"terraform module {config.mode} already initialized; "
              "skipping init", flush=True)
    run(
        ["terraform", "apply", "-auto-approve", "-input=false", "-no-color"],
        cwd=module_dir,
        env=env,
    )
    hosts = collect_outputs(config, paths, run_quiet)
    hosts.save(paths.hosts_file)
    return hosts


def slice_addresses(
    slice_indices: list[int], mode: str = "tpu-vm", hosts_per_slice: int = 1,
) -> list[str]:
    """The module resources of the named slices, sorted and without
    duplicates: tpu-vm's count fan-out has one `google_tpu_v2_vm.slice[i]`
    per slice; gpu-vm's has one `google_compute_instance.host[k]` per host,
    slice s owning hosts s * hosts_per_slice ... (s + 1) * hosts_per_slice - 1
    (terraform/gpu-vm/main.tf), in `readiness.gpu_vm_names` order."""
    slices = sorted(set(slice_indices))
    if mode == "gpu-vm":
        return [f"google_compute_instance.host[{s * hosts_per_slice + h}]"
                for s in slices for h in range(hosts_per_slice)]
    return [f"google_tpu_v2_vm.slice[{i}]" for i in slices]


def slice_replace_addresses(
    slice_indices: list[int], mode: str = "tpu-vm", hosts_per_slice: int = 1,
) -> list[str]:
    """Terraform `-replace=` addresses for the named slices' instances."""
    return [f"-replace={a}"
            for a in slice_addresses(slice_indices, mode, hosts_per_slice)]


def apply_slices(
    config: ClusterConfig,
    paths: RunPaths,
    slice_indices: list[int],
    run: run_mod.RunFn = run_mod.run_streaming,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
) -> ClusterHosts:
    """Heal-scoped converge: re-create ONLY the named slices.

    Terraform's plan is already a no-op for healthy resources, but a
    slice that is unreachable yet still in the state file would no-op
    too — `-replace=` (the taint successor) forces destroy+create for
    exactly the quarantined slice addresses while every healthy slice's
    state entry is left untouched. A gpu-vm slice is its hosts' instances,
    every one replaced. The VM modes only: GKE slice repair is the node
    pool's auto-repair job (terraform/gke*/main.tf), not ours.
    """
    if config.mode not in VM_MODES:
        raise ConfigError(
            "slice-scoped apply is a tpu-vm operation; gke node pools "
            "self-repair (management.auto_repair)"
        )
    if not slice_indices:
        raise ValueError("apply_slices needs at least one slice index")
    module_dir = paths.terraform_module(config.mode)
    precheck(config, paths)
    compiler.write_tfvars(config, paths.terraform_dir)
    env = terraform_env(paths)
    if init_needed(config, paths):
        run(["terraform", "init", "-input=false", "-no-color"],
            cwd=module_dir, env=env)
    run(
        # -lock-timeout: the supervisor dispatches independent slice-
        # scoped heals concurrently; a second apply QUEUES on the state
        # lock instead of aborting with "state locked" (terraform
        # serialises the applies; the slow parts — VM boot, readiness,
        # converge — overlap across heal workers regardless)
        ["terraform", "apply", "-auto-approve", "-input=false", "-no-color",
         "-lock-timeout=600s"]
        + slice_replace_addresses(slice_indices, config.mode,
                                  config.hosts_per_slice),
        cwd=module_dir,
        env=env,
    )
    hosts = collect_outputs(config, paths, run_quiet)
    hosts.save(paths.hosts_file)  # atomic rewrite (state.atomic_write_text)
    return hosts


def collect_outputs(
    config: ClusterConfig,
    paths: RunPaths,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
) -> ClusterHosts:
    """Read `terraform output -json` into ClusterHosts.

    Expected outputs (declared in terraform/<mode>/outputs.tf):
    - tpu-vm, gpu-vm: `host_ips` = per-slice lists of external IPs (SSH
      addressing), `internal_ips` = per-slice lists of VPC IPs
      (coordinator addresses — worker->coordinator rendezvous rides the
      VPC, never external NAT)
    - gke, gke-gpu: `endpoint` = control-plane endpoint, `node_pool` = name
    """
    module_dir = paths.terraform_module(config.mode)
    raw = run_quiet(["terraform", "output", "-json"], cwd=module_dir)
    outputs = {k: v.get("value") for k, v in json.loads(raw or "{}").items()}
    if config.mode in VM_MODES:
        host_ips = outputs.get("host_ips") or []
        internal_ips = outputs.get("internal_ips") or []
        coord_source = internal_ips or host_ips
        if host_ips and not internal_ips:
            # A stale tfstate (pre-internal_ips) leaves only the external
            # NAT form, which default firewall rules block for
            # worker->coordinator dials — make that diagnosable up front.
            print(
                "WARNING: terraform output has no internal_ips; falling "
                "back to external IPs for the JAX coordinator. Multi-host "
                "rendezvous over external NAT usually fails — re-apply to "
                "refresh outputs.",
                file=sys.stderr,
                flush=True,
            )
        coordinator = coord_source[0][0] if coord_source and coord_source[0] else ""
        return ClusterHosts(
            host_ips=host_ips,
            internal_ips=internal_ips,
            coordinator_ip=coordinator,
        )
    return ClusterHosts(
        host_ips=[],
        gke_endpoint=outputs.get("endpoint") or "",
    )


def slice_target_addresses(
    slice_indices: list[int], mode: str = "tpu-vm", hosts_per_slice: int = 1,
) -> list[str]:
    """Terraform `-target=` addresses for the named slices' instances —
    the scale-down sibling of `slice_replace_addresses`: destroy ONLY
    these slices, leaving every other slice's state entry untouched."""
    return [f"-target={a}"
            for a in slice_addresses(slice_indices, mode, hosts_per_slice)]


def destroy_slices(
    config: ClusterConfig,
    paths: RunPaths,
    slice_indices: list[int],
    run: run_mod.RunFn = run_mod.run_streaming,
) -> None:
    """Scale-down-scoped teardown: destroy ONLY the named (drained)
    slices of the VM module's count fan-out. The autoscaler's
    drain-then-teardown path (provision/supervisor.py) calls this after
    the request journal shows the slice's in-flight work settled —
    never the whole-deployment `destroy`, which is teardown's job."""
    if config.mode not in VM_MODES:
        raise ConfigError(
            "slice-scoped destroy is a tpu-vm operation; gke capacity "
            "is the node pool autoscaler's job"
        )
    if not slice_indices:
        raise ValueError("destroy_slices needs at least one slice index")
    run(
        ["terraform", "destroy", "-auto-approve", "-input=false",
         "-no-color", "-lock-timeout=600s"]
        + slice_target_addresses(slice_indices, config.mode,
                                 config.hosts_per_slice),
        cwd=paths.terraform_module(config.mode),
        env=terraform_env(paths),
    )


def destroy(
    config: ClusterConfig,
    paths: RunPaths,
    run: run_mod.RunFn = run_mod.run_streaming,
) -> None:
    """`terraform destroy -force` analogue (setup.sh:498-503)."""
    destroy_mode(config.mode, paths, run)


def destroy_mode(
    mode: str,
    paths: RunPaths,
    run: run_mod.RunFn = run_mod.run_streaming,
) -> None:
    """Destroy one module's resources from its tfstate. Keyed off the mode
    string (not a ClusterConfig) so teardown can work from orphaned
    terraform state alone — the reference's cleanRunner only needed the
    state files, never the config (reference setup.sh:484-521)."""
    if not paths.tfstate(mode).exists():
        return
    run(
        ["terraform", "destroy", "-auto-approve", "-input=false", "-no-color"],
        cwd=paths.terraform_module(mode),
    )


def modes_with_state(paths: RunPaths) -> list[str]:
    """Modes whose module dir holds a tfstate with resources: every mode's,
    the GPU modules' too, so `-c` leaves no H100s running."""
    found = []
    for mode in ALL_MODES:
        state_file = paths.tfstate(mode)
        if not state_file.exists():
            continue
        try:
            state = json.loads(state_file.read_text())
        except (OSError, json.JSONDecodeError):
            found.append(mode)  # unreadable state still warrants a destroy run
            continue
        if state.get("resources"):
            found.append(mode)
    return found
