"""GCP environment discovery.

The reference bootstrapped credentials by ``eval $(triton env)`` and then
scanned ``~/.ssh`` for the private key whose fingerprint matched
``$SDC_KEY_ID``, hard-failing (with cleanup) when absent
(setConfigFromTritonENV, reference setup.sh:209-239). The TPU/GCP analogue
discovers project/account/zone from ``gcloud config``, verifies credentials
exist, and locates the SSH private key Ansible will use for TPU VMs.

All subprocess execution goes through an injectable runner so tests use a
fake gcloud (SURVEY.md §4: testability designed in, not bolted on).

The port's copy of `tritonk8ssupervisor_tpu/cli/discovery.py`, whole and
under the reference's names, with `list_gpu_zones` beside `list_tpu_zones`.
"""

from __future__ import annotations

import dataclasses
import subprocess
from pathlib import Path
from typing import Callable


class DiscoveryError(RuntimeError):
    """Environment is not usable; message says how to fix it."""


@dataclasses.dataclass
class GcloudEnv:
    """What `gcloud config` knows — the SDC_URL/SDC_ACCOUNT/SDC_KEY_ID
    analogue (reference setup.sh:211-213)."""

    project: str = ""
    account: str = ""
    zone: str = ""


Runner = Callable[..., "subprocess.CompletedProcess[str]"]


def _default_runner(args, **kwargs):
    return subprocess.run(
        args, capture_output=True, text=True, timeout=30, **kwargs
    )


def _gcloud_get(key: str, run: Runner) -> str:
    try:
        proc = run(["gcloud", "config", "get-value", key])
    except (OSError, subprocess.SubprocessError):
        return ""
    if proc.returncode != 0:
        return ""
    value = proc.stdout.strip()
    return "" if value in ("", "(unset)") else value


def discover(run: Runner = _default_runner) -> GcloudEnv:
    """Pull project/account/zone from gcloud config; empty fields mean
    "unknown" and the wizard prompts for them instead.

    The three lookups are independent gcloud invocations (~1 s of CLI
    startup each), so they fan out concurrently — discovery costs one
    gcloud round-trip, not three (the DAG-pipeline discipline applied to
    the pre-wizard phase; docs/performance.md)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(
        max_workers=3, thread_name_prefix="gcloud-discover"
    ) as pool:
        project, account, zone = pool.map(
            lambda key: _gcloud_get(key, run),
            ("project", "account", "compute/zone"),
        )
    return GcloudEnv(project=project, account=account, zone=zone)


def require_credentials(env: GcloudEnv, run: Runner = _default_runner) -> None:
    """Hard-fail with guidance when no usable identity exists — the analogue
    of the reference aborting (and cleaning up) when the Triton SSH key was
    missing (setup.sh:231-237)."""
    if env.account:
        return
    try:
        proc = run(["gcloud", "auth", "list", "--format=value(account)"])
        if proc.returncode == 0 and proc.stdout.strip():
            env.account = proc.stdout.strip().splitlines()[0]
            return
    except (OSError, subprocess.SubprocessError):
        pass
    raise DiscoveryError(
        "no GCP credentials found: run `gcloud auth login` and "
        "`gcloud auth application-default login`, then re-run setup.sh"
    )


# Candidate private keys, most specific first. The reference matched keys by
# MD5 fingerprint against $SDC_KEY_ID (setup.sh:215-230); GCP instead
# installs gcloud's own key (or any key in project metadata), so we take the
# first existing candidate and let the operator override.
_SSH_KEY_CANDIDATES = ("google_compute_engine", "id_ed25519", "id_rsa")


def find_ssh_key(ssh_dir: Path | None = None) -> Path:
    """Locate the private key Ansible should use for TPU VM SSH.

    Raises DiscoveryError when none exists, mirroring the reference's
    missing-key abort (setup.sh:231-237).
    """
    ssh_dir = ssh_dir if ssh_dir is not None else Path.home() / ".ssh"
    for name in _SSH_KEY_CANDIDATES:
        candidate = ssh_dir / name
        if candidate.is_file():
            return candidate
    raise DiscoveryError(
        f"no SSH private key found in {ssh_dir} "
        f"(looked for {', '.join(_SSH_KEY_CANDIDATES)}); "
        "run `gcloud compute config-ssh` to create one"
    )


def ssh_username() -> str:
    """The SSH login for TPU VMs. GCP maps metadata/OS-Login SSH keys to
    user accounts and disables direct root login, so the inventory must
    not say root (the reference's VMs accepted root after the key copy,
    reference terraform/master/main.tf:13-27 — GCP works differently).
    `gcloud compute ssh` / `gcloud compute tpus tpu-vm ssh` default to the
    local OS username; TK8S_SSH_USER overrides for OS-Login setups whose
    derived username differs."""
    import getpass
    import os
    import sys

    override = os.environ.get("TK8S_SSH_USER")
    user = override or getpass.getuser()
    if user == "root" and not override:
        # getuser() says root when the CLI itself runs as root (containers,
        # CI) — exactly the login GCP blocks. Don't fail (the play may be
        # targeting a custom image), but make the fix obvious.
        print(
            "warning: derived SSH username is 'root', which GCP TPU VMs "
            "reject by default; set TK8S_SSH_USER to the OS-Login/metadata "
            "username the VMs expect",
            file=sys.stderr,
        )
    return user


def list_networks(project: str = "", run: Runner = _default_runner) -> list[str]:
    """Live VPC network names for the wizard menu — the `triton networks`
    menu analogue (reference setup.sh:257,309-400, default
    Joyent-SDC-Public). Any gcloud failure falls back to ["default"],
    the network every fresh GCP project carries."""
    cmd = ["gcloud", "compute", "networks", "list", "--format=value(name)"]
    if project:
        cmd.append(f"--project={project}")
    try:
        proc = run(cmd)
    except (OSError, subprocess.SubprocessError):
        return ["default"]
    if proc.returncode != 0:
        return ["default"]
    names = [line.strip() for line in proc.stdout.splitlines() if line.strip()]
    return names or ["default"]


def list_subnetworks(
    project: str,
    region: str,
    network: str,
    run: Runner = _default_runner,
) -> list[str]:
    """Subnet names of `network` in `region` (auto-mode VPCs have one per
    region named like the network). Fallback mirrors list_networks."""
    cmd = [
        "gcloud",
        "compute",
        "networks",
        "subnets",
        "list",
        f"--network={network}",
        f"--regions={region}",
        "--format=value(name)",
    ]
    if project:
        cmd.append(f"--project={project}")
    try:
        proc = run(cmd)
    except (OSError, subprocess.SubprocessError):
        return [network or "default"]
    if proc.returncode != 0:
        return [network or "default"]
    names = [line.strip() for line in proc.stdout.splitlines() if line.strip()]
    return names or [network or "default"]


def list_tpu_zones(generation: str, run: Runner = _default_runner) -> list[str]:
    """Zones offering `generation`, live when credentials allow, otherwise
    the static catalog — the same live-with-fallback pattern as the
    reference's `triton networks`/`triton packages` menus (setup.sh:257-259).

    `gcloud compute tpus accelerator-types list` is zone-scoped, so each
    catalog zone is probed individually — but CONCURRENTLY: the probes
    are independent read-only calls, and the wizard's zone menu should
    cost one gcloud round-trip, not len(zones) of them. Any gcloud
    failure falls back to the static catalog.
    """
    from concurrent.futures import ThreadPoolExecutor

    from tritonk8ssupervisor_tpu_torch.config import catalog

    spec = catalog.get_spec(generation)

    def probe_zone(zone: str) -> bool | None:
        """True/False: zone offers the generation; None: gcloud failed."""
        try:
            proc = run(
                [
                    "gcloud",
                    "compute",
                    "tpus",
                    "accelerator-types",
                    "list",
                    f"--zone={zone}",
                    "--format=value(name)",
                ]
            )
        except (OSError, subprocess.SubprocessError):
            return None
        if proc.returncode != 0:
            return None
        # name format: projects/P/locations/ZONE/acceleratorTypes/TYPE
        return any(
            line.split("/")[-1].startswith(spec.type_prefix + "-")
            for line in proc.stdout.strip().splitlines()
        )

    if not spec.zones:
        return []
    with ThreadPoolExecutor(
        max_workers=min(8, len(spec.zones)), thread_name_prefix="gcloud-zones"
    ) as pool:
        verdicts = list(pool.map(probe_zone, spec.zones))
    if any(v is None for v in verdicts):
        return list(spec.zones)
    live = [zone for zone, ok in zip(spec.zones, verdicts) if ok]
    return live or list(spec.zones)


def list_gpu_zones(generation: str, run: Runner = _default_runner) -> list[str]:
    """Zones offering the GPU family's accelerator, live when credentials
    allow, otherwise the static catalog: one `gcloud compute
    accelerator-types list` names every zone with the type (the listing
    is project-wide, unlike the TPU one), narrowed to the catalog's zones.
    Any gcloud failure, or no catalog zone in the listing, falls back to
    the catalog."""
    from tritonk8ssupervisor_tpu_torch.config import catalog

    spec = catalog.get_spec(generation)
    try:
        proc = run([
            "gcloud", "compute", "accelerator-types", "list",
            f"--filter=name={spec.type_prefix}", "--format=value(zone)",
        ])
    except (OSError, subprocess.SubprocessError):
        return list(spec.zones)
    if proc.returncode != 0:
        return list(spec.zones)
    listed = {line.strip().rsplit("/", 1)[-1] for line in proc.stdout.splitlines()}
    return [zone for zone in spec.zones if zone in listed] or list(spec.zones)
