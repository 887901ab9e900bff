"""Teardown: destroy infrastructure and scrub all generated state.

Rebuild of `cleanRunner` (reference setup.sh:484-521): list the doomed
resources and confirm (487-497), `terraform destroy` (498-503), scrub SSH
known_hosts per IP (504-508), then delete every generated artifact so the
next run starts clean (509-513) and reset the ansible.cfg key path (511).

The port's copy of `tritonk8ssupervisor_tpu/provision/teardown.py`, whole
and under the reference's names: it stops a running supervisor first
(`provision/supervisor.stop_running`) and scrubs the gateway fleet's
journal and demand-signal shards with the ledgers. The GPU modes'
terraform state and staged archive are destroyed and scrubbed as the TPU
modes' are.
"""

from __future__ import annotations

import shutil

from tritonk8ssupervisor_tpu_torch.cli.io import Prompter
from tritonk8ssupervisor_tpu_torch.config.schema import ALL_MODES, ClusterConfig
from tritonk8ssupervisor_tpu_torch.provision import ansible as ansible_mod
from tritonk8ssupervisor_tpu_torch.provision import events as events_mod
from tritonk8ssupervisor_tpu_torch.provision import journal as journal_mod
from tritonk8ssupervisor_tpu_torch.provision import runner as run_mod
from tritonk8ssupervisor_tpu_torch.provision import supervisor as supervisor_mod
from tritonk8ssupervisor_tpu_torch.provision import terraform as terraform_mod
from tritonk8ssupervisor_tpu_torch.provision.state import (
    ClusterHosts,
    MissingStateError,
    RunPaths,
)


def _recorded_hosts(paths: RunPaths) -> ClusterHosts | None:
    """hosts.json when present AND readable. Teardown must stay runnable
    over any partial-clean residue: a truncated hosts record means no IPs
    to list/scrub, never an abort that strands the remaining state."""
    if not paths.hosts_file.exists():
        return None
    try:
        return ClusterHosts.load(paths.hosts_file)
    except MissingStateError:
        return None


def clean(
    config: ClusterConfig | None,
    paths: RunPaths,
    prompter: Prompter,
    run: run_mod.RunFn = run_mod.run_streaming,
    assume_yes: bool = False,
) -> bool:
    """Returns True when teardown ran, False when the user aborted.

    `config=None` means the config file is gone but terraform state
    remains (e.g. a partial manual cleanup): every mode with state is
    destroyed — the reference keyed teardown off terraform state, never
    the config (reference setup.sh:484-521), so orphaned resources must
    stay reachable by `./setup.sh -c`.
    """
    doomed = _describe_doomed(config, paths)
    prompter.say("The following resources will be DESTROYED:")
    for line in doomed:
        prompter.say(f"  - {line}")
    if not assume_yes and not prompter.confirm("Destroy and remove all state?"):
        prompter.say("Aborted; nothing was changed.")
        return False

    # Stop any resident supervisor FIRST: a live reconcile loop would
    # watch the destroy delete slices and dutifully heal them back
    # (provision/supervisor.py stop_running: SIGTERM, grace, SIGKILL;
    # a stale pid lockfile from a crashed supervisor is just removed).
    supervisor_mod.stop_running(paths, echo=prompter.say)

    # Destroy EVERY mode holding terraform state, not just config.mode: a
    # mode switch via --config leaves the previous mode's tfstate behind,
    # and the state scrub below would otherwise orphan those resources.
    doomed_modes = set(terraform_mod.modes_with_state(paths))
    if config is not None:
        doomed_modes.add(config.mode)
    for mode in sorted(doomed_modes):
        terraform_mod.destroy_mode(mode, paths, run)
    if not doomed_modes:
        hosts = _recorded_hosts(paths)
        if hosts is not None and hosts.flat_ips:
            # No tfstate anywhere but host IPs are on record: nothing was
            # actually destroyed — say so loudly before the scrub deletes
            # the last record of possibly-live resources.
            prompter.say(
                "WARNING: no terraform state found — nothing was destroyed. "
                "Hosts recorded at: " + ", ".join(hosts.flat_ips) + ". "
                "If they still exist, delete them manually, e.g. "
                "`gcloud compute tpus tpu-vm delete <name> --zone <zone>`."
            )
    _scrub_known_hosts(paths, run)
    _remove_generated_state(config, paths)
    # The ledgers go LAST: every earlier step is individually idempotent
    # (unlink missing_ok, destroy keyed off tfstate existence), so a clean
    # that crashes anywhere above leaves them behind and the re-run simply
    # does the remaining work — a crashed clean is itself resumable. The
    # supervisor's EVENT ledger goes after even the journal: it is the
    # flight record of what the fleet was and what ran, the last evidence
    # an interrupted clean would want preserved.
    journal_mod.Journal(paths.journal).scrub()
    # fleet-status carries the allocation block (per-slice train/serve
    # roles) and job-ack the trainer's preemption handshake — both are
    # allocator state a fresh deployment must never inherit: a stale
    # role map would route traffic around slices that no longer exist
    paths.fleet_status.unlink(missing_ok=True)
    paths.job_ack.unlink(missing_ok=True)
    # the gateway's demand signals are derived state like fleet-status:
    # scrubbed with the contract files so a fresh run's autoscaler can
    # never read a previous deployment's queue as evidence. The plural
    # helper globs the fleet's per-replica demand-signal-<replica>.json
    # shards along with the single-gateway file — a fleet of N replicas
    # leaves N signals behind, not one
    for signal in paths.demand_signals():
        signal.unlink(missing_ok=True)
    # telemetry artifacts scrub with the ledgers: the metrics snapshot
    # is derived state, and the span log is the telemetry plane's
    # flight record (obs/trace.py) — kept until the very end with the
    # request journal so an interrupted clean leaves the evidence
    paths.metrics_snapshot.unlink(missing_ok=True)
    # the gateway's request journals hold client-owed work; like the
    # event ledger they outlive every resumable step above. Globbed:
    # the fleet's per-replica serve-requests-<replica>.jsonl shards
    # scrub with the single-gateway journal
    for request_log in paths.request_logs():
        request_log.unlink(missing_ok=True)
    paths.span_log.unlink(missing_ok=True)
    events_mod.EventLedger(paths.events).scrub()
    prompter.say("Clean. Re-run ./setup.sh to provision again.")
    return True


def _describe_doomed(config: ClusterConfig | None, paths: RunPaths) -> list[str]:
    """The doomed-VM listing (setup.sh:487-491), from recorded state. Must
    name EVERY mode clean() will destroy — a mode switch leaves the old
    mode's tfstate behind, and the user confirms what they see here."""
    stateful_modes = terraform_mod.modes_with_state(paths)
    if config is not None:
        modes = sorted(set(stateful_modes) | {config.mode})
        lines = [
            f"{', '.join(modes)} deployment(s) in project {config.project} "
            f"(zone {config.zone})"
        ]
    else:
        modes = stateful_modes or ["(unknown mode)"]
        lines = [
            f"orphaned terraform state: {', '.join(modes)} "
            "(config file missing; destroying from state)"
        ]
    hosts = _recorded_hosts(paths)
    if hosts is not None:
        kind = "GPU" if config is not None and config.is_gpu else "TPU"
        for ip in hosts.flat_ips:
            lines.append(f"{kind} host {ip}")
        if hosts.gke_endpoint:
            lines.append(f"GKE cluster endpoint {hosts.gke_endpoint}")
    else:
        lines.append("(no recorded hosts — terraform state only)")
    return lines


def _scrub_known_hosts(paths: RunPaths, run: run_mod.RunFn) -> None:
    """ssh-keygen -R per host IP (setup.sh:504-508) so re-provisioned VMs
    with recycled IPs don't trip host-key verification."""
    hosts = _recorded_hosts(paths)
    if hosts is None:
        return
    for ip in hosts.flat_ips:
        try:
            run(["ssh-keygen", "-R", ip])
        except run_mod.CommandError:
            pass  # absent entries are fine, same as the reference's `|| true`


def _remove_generated_state(config: ClusterConfig | None, paths: RunPaths) -> None:
    """Delete everything a run generated (setup.sh:509-513), the GPU
    modules' state and the gpuhost role's staged archive too."""
    for mode in ALL_MODES:
        for name in (
            "terraform.tfvars.json",
            "terraform.tfstate",
            "terraform.tfstate.backup",
        ):
            (paths.terraform_module(mode) / name).unlink(missing_ok=True)
        shutil.rmtree(
            paths.terraform_module(mode) / ".terraform", ignore_errors=True
        )
    paths.hosts_file.unlink(missing_ok=True)
    paths.quarantine_file.unlink(missing_ok=True)
    paths.inventory.unlink(missing_ok=True)
    (paths.ansible_dir / "group_vars" / "all.yml").unlink(missing_ok=True)
    for role in ("tpuhost", "gpuhost"):
        shutil.rmtree(paths.ansible_dir / "roles" / role / "files", ignore_errors=True)
    shutil.rmtree(paths.manifests_dir, ignore_errors=True)
    shutil.rmtree(paths.probe_dir, ignore_errors=True)
    paths.config_file.unlink(missing_ok=True)
    paths.runlog.unlink(missing_ok=True)
    # the warm converge cache keys off content that no longer exists
    # after the scrub above — a stale entry surviving teardown could
    # never verify, but scrubbing it keeps "clean" meaning clean
    paths.warm_cache.unlink(missing_ok=True)
    ansible_mod.reset_private_key(paths.ansible_cfg)
