"""The interactive configuration wizard.

TPU rebuild of `getConfigFromUser` (reference setup.sh:255-451) and
`verifyConfig` (setup.sh:452-483). The reference prompted for environment
name/description, master hostname, node prefix, node count (1-9), then live
network and KVM-package menus; here the accelerator questions replace the
VM-shape questions — generation, slice topology, slice count, zone — with
menus driven by the accelerator catalog (live-refreshed zones when gcloud
has credentials). Validation is delegated to ClusterConfig.validate()'s
rules so the wizard, file-loaded configs, and tests enforce identical
constraints (unlike the reference, whose regexes lived inline in prompts).

The port's copy of `tritonk8ssupervisor_tpu/cli/wizard.py`, whole and under
the reference's names: the menus are the TPU catalog's (`config/catalog.py`).
With `accelerator="gpu"` (`cli.main --accelerator gpu`) it asks the GPU
menus instead, in the same order: mode (`gke-gpu`, `gpu-vm`), family,
topology, slices, zone, network, subnetwork; the TPU transcript is the
reference's, unchanged.
"""

from __future__ import annotations

from tritonk8ssupervisor_tpu_torch.cli import discovery
from tritonk8ssupervisor_tpu_torch.cli.io import Prompter
from tritonk8ssupervisor_tpu_torch.config import catalog
from tritonk8ssupervisor_tpu_torch.config.schema import (
    _NAME_RE,
    GPU_MODES,
    MAX_SLICES,
    MODES,
    ClusterConfig,
)

# a GPU deployment's names and descriptions until the user gives others
GPU_DEFAULTS = dict(cluster_name="gpu-dev", node_prefix="gpunode", env_name="gpu dev",
                    env_description="H100 Kubernetes environment",
                    generation=catalog.DEFAULT_GPU_GENERATION,
                    topology=catalog.DEFAULT_GPU_TOPOLOGY, mode="gke-gpu")


def _name_validator(field: str):
    def check(value: str) -> str:
        if _NAME_RE.match(value):
            return ""
        return (
            f"{field} must be lowercase letters/digits/hyphens, "
            "starting with a letter (RFC1035)"
        )

    return check


def _int_range_validator(lo: int, hi: int, reason: str = ""):
    def check(value: str) -> str:
        try:
            n = int(value)
        except ValueError:
            return f"enter a number {lo}-{hi}"
        if lo <= n <= hi:
            return ""
        return f"must be {lo}-{hi}" + (f" ({reason})" if reason else "")

    return check


def _choose_named(
    prompter: Prompter, title: str, options: list[str], default: str
) -> str:
    """Menu over live-discovered names with an escape hatch for names the
    listing can't see (shared VPCs, cross-project networks) — the
    reference's network menus offered only the listed choices
    (setup.sh:309-400); GCP needs the extra door."""
    other = "other (enter a name)"
    # A configured name the live listing can't see (shared VPC,
    # cross-project) must not silently fall to the first listed option:
    # it joins the menu as its own default-selected entry, so plain
    # Enter preserves the existing config value. The literal "default"
    # is the tool's own schema guess (GCP's auto-network name), not a
    # user choice — unlisted it means "no such network here", so it
    # falls to the first live option as before.
    entries = list(options)
    configured = None
    if default in options:
        default_index = options.index(default)
    elif default and default != "default":
        configured = len(entries)
        entries.append(f"{default} (configured; not in live listing)")
        default_index = configured
    else:
        default_index = 0
    choice = prompter.menu(title, entries + [other], default_index)
    if configured is not None and choice == configured:
        return default
    if choice == len(entries):
        return prompter.ask_validated(
            "Name", default, lambda v: "" if v else "a name is required"
        )
    return options[choice]


def run_wizard(
    prompter: Prompter,
    env: discovery.GcloudEnv | None = None,
    zone_lister=None,
    network_lister=discovery.list_networks,
    subnet_lister=discovery.list_subnetworks,
    accelerator: str = "tpu",
) -> ClusterConfig:
    """Collect a full ClusterConfig interactively.

    Question order mirrors the reference wizard (setup.sh:255-451):
    identity -> naming -> sizing -> placement. `accelerator` "gpu" asks
    the GPU catalog's menus; `zone_lister` defaults to the kind's.
    """
    gpu = accelerator == "gpu"
    if zone_lister is None:
        zone_lister = discovery.list_gpu_zones if gpu else discovery.list_tpu_zones
    env = env or discovery.GcloudEnv()
    config = ClusterConfig(**GPU_DEFAULTS) if gpu else ClusterConfig()

    prompter.say("---------------------------------------------------------")
    prompter.say(" H100 GPU Kubernetes cluster setup" if gpu else " TPU Kubernetes cluster setup")
    prompter.say("---------------------------------------------------------")

    # Identity (the reference read these from `triton env`, setup.sh:209-213)
    config.project = prompter.ask_validated(
        "GCP project",
        env.project,
        lambda v: "" if v else "project is required",
    )

    # Environment metadata (setup.sh:265-271 analogue)
    config.env_name = prompter.ask("Environment name", config.env_name)
    config.env_description = prompter.ask(
        "Environment description", config.env_description
    )

    # Naming (master hostname / node prefix analogues, setup.sh:274-295)
    config.cluster_name = prompter.ask_validated(
        "Cluster name", config.cluster_name, _name_validator("cluster name")
    )
    config.node_prefix = prompter.ask_validated(
        "GPU node name prefix" if gpu else "TPU node name prefix",
        config.node_prefix, _name_validator("node prefix")
    )

    if gpu:
        _gpu_menus(prompter, config)
    else:
        _tpu_menus(prompter, config)

    # Slice count keeps the reference's 1-9 guard-rail (setup.sh:297-307).
    # Multiple slices form ONE cross-slice training surface by default
    # (data parallel over DCN, docs/parallelism.md; --independent-slices
    # restores per-slice clusters).
    config.num_slices = int(
        prompter.ask_validated(
            "Number of slices (several = one cross-slice training surface)",
            str(config.num_slices),
            _int_range_validator(1, MAX_SLICES, "no HA support"),
        )
    )

    # Placement (zones with capacity; live list when credentials exist —
    # the `triton networks` live-menu analogue, setup.sh:257)
    zones = zone_lister(config.generation)
    default_zone_idx = zones.index(env.zone) if env.zone in zones else 0
    config.zone = zones[prompter.menu("Zone:", zones, default_zone_idx)]

    # Networking: live menus with defaults, like the reference's `triton
    # networks` menu defaulting to Joyent-SDC-Public (setup.sh:309-400)
    config.network = _choose_named(
        prompter,
        "VPC network:",
        network_lister(config.project),
        config.network,
    )
    config.subnetwork = _choose_named(
        prompter,
        f"VPC subnetwork ({config.region}):",
        subnet_lister(config.project, config.region, config.network),
        config.subnetwork,
    )

    config.validate()
    return config


def _tpu_menus(prompter: Prompter, config: ClusterConfig) -> None:
    """The reference's mode, generation and topology menus."""
    # Deployment mode: GKE cluster vs standalone TPU VM slice.
    modes = (
        ("gke", "gke     - GKE cluster with a TPU node pool (full Kubernetes)"),
        ("tpu-vm", "tpu-vm  - standalone Cloud TPU VM slice (no Kubernetes)"),
    )
    assert {m for m, _ in modes} == set(MODES)
    config.mode = modes[prompter.menu("Deployment mode:", [l for _, l in modes], 0)][0]

    # Accelerator menus (replace network/package menus, setup.sh:309-450)
    generations = sorted(catalog.ACCELERATORS)
    gen_idx = prompter.menu(
        "TPU generation:",
        [
            f"{g:<4} - up to {catalog.ACCELERATORS[g].max_chips} chips, "
            f"{catalog.ACCELERATORS[g].chips_per_host}/host"
            for g in generations
        ],
        generations.index(catalog.DEFAULT_GENERATION),
    )
    config.generation = generations[gen_idx]
    spec = catalog.ACCELERATORS[config.generation]

    topo_default = (
        spec.topologies.index(catalog.DEFAULT_TOPOLOGY)
        if catalog.DEFAULT_TOPOLOGY in spec.topologies
        else 0
    )
    topo_idx = prompter.menu(
        f"Slice topology ({config.generation}):",
        [
            f"{t:<9} = {spec.topology(t).chips} chips, "
            f"{spec.hosts(spec.topology(t))} host(s)  "
            f"[{catalog.accelerator_type_name(config.generation, t)}]"
            for t in spec.topologies
        ],
        topo_default,
    )
    config.topology = spec.topologies[topo_idx]


def _gpu_menus(prompter: Prompter, config: ClusterConfig) -> None:
    """The GPU catalog's mode, family and topology menus."""
    modes = (
        ("gke-gpu", "gke-gpu - GKE cluster with H100 (A3) node pools (full Kubernetes)"),
        ("gpu-vm", "gpu-vm  - standalone H100 (A3) VMs configured by ansible"),
    )
    assert {m for m, _ in modes} == set(GPU_MODES)
    config.mode = modes[prompter.menu("Deployment mode:", [l for _, l in modes], 0)][0]

    families = sorted(catalog.GPU_ACCELERATORS)
    family_idx = prompter.menu(
        "GPU family:",
        [
            f"{g:<9} - {catalog.GPU_ACCELERATORS[g].type_prefix}, up to "
            f"{catalog.GPU_ACCELERATORS[g].max_chips} GPUs, "
            f"{catalog.GPU_ACCELERATORS[g].chips_per_host}/host"
            for g in families
        ],
        families.index(catalog.DEFAULT_GPU_GENERATION),
    )
    config.generation = families[family_idx]
    spec = catalog.GPU_ACCELERATORS[config.generation]

    topo_default = (
        spec.topologies.index(catalog.DEFAULT_GPU_TOPOLOGY)
        if catalog.DEFAULT_GPU_TOPOLOGY in spec.topologies
        else 0
    )
    topo_idx = prompter.menu(
        f"Slice topology ({config.generation}, hosts x GPUs a host):",
        [
            f"{t:<5} = {spec.topology(t).chips} GPUs, "
            f"{spec.hosts(spec.topology(t))} host(s)  "
            f"[{spec.gke_machine_type[spec.chips_on_host(spec.topology(t))]}]"
            for t in spec.topologies
        ],
        topo_default,
    )
    config.topology = spec.topologies[topo_idx]


def config_rows(config: ClusterConfig) -> list[tuple[str, str]]:
    """The summary rows shared by the verify gate and --show-config (the
    debugVars dump analogue, setup.sh:522-531)."""
    if config.is_gpu:
        return _gpu_config_rows(config)
    rows = [
        ("GCP project", config.project),
        ("Zone", config.zone),
        ("Mode", config.mode),
        ("Cluster name", config.cluster_name),
        ("Environment", f"{config.env_name} - {config.env_description}"),
        ("TPU generation", config.generation),
        ("Slice topology", f"{config.topology} ({config.accelerator_type})"),
        (
            "Slices x hosts x chips",
            f"{config.num_slices} x {config.hosts_per_slice} x "
            f"{config.spec.chips_on_host(config.parsed_topology)}",
        ),
        ("Total chips", str(config.num_slices * config.chips_per_slice)),
        ("Network", f"{config.network} / {config.subnetwork}"),
        ("Runtime version", config.effective_runtime_version),
    ]
    if config.failure_domains > 1:
        rows.append((
            "Failure domains",
            f"{config.failure_domains} (slice i -> "
            f"{config.zone or 'zone'}-fd(i % {config.failure_domains}))",
        ))
    if config.mode == "gke":
        rows.append(("GKE machine type", config.gke_machine_type))
    return rows


def _gpu_config_rows(config: ClusterConfig) -> list[tuple[str, str]]:
    per_host = config.spec.chips_on_host(config.parsed_topology)
    rows = [
        ("GCP project", config.project),
        ("Zone", config.zone),
        ("Mode", config.mode),
        ("Cluster name", config.cluster_name),
        ("Environment", f"{config.env_name} - {config.env_description}"),
        ("GPU family", f"{config.generation} ({config.accelerator_type})"),
        ("Slice topology", f"{config.topology} (hosts x GPUs a host)"),
        ("Slices x hosts x GPUs",
         f"{config.num_slices} x {config.hosts_per_slice} x {per_host}"),
        ("Total GPUs", str(config.num_slices * config.chips_per_slice)),
        ("Network", f"{config.network} / {config.subnetwork}"),
        ("Machine type", config.gke_machine_type),
    ]
    if config.mode == "gpu-vm":
        rows.append(("Boot image", config.effective_runtime_version))
    else:
        rows.append(("Job image", config.spec.job_image))
    return rows


def verify_config(config: ClusterConfig, prompter: Prompter) -> bool:
    """Print the full summary and gate on confirmation — verifyConfig
    (setup.sh:452-483), including its reachability warning (setup.sh:468)."""
    prompter.say("")
    prompter.say("Verify the configuration:")
    prompter.say("---------------------------------------------------------")
    for label, value in config_rows(config):
        prompter.say(f"  {label:<24} {value}")
    prompter.say("---------------------------------------------------------")
    prompter.say(
        "NOTE: worker hosts must reach the coordinator over the VPC; "
        "default-network firewall rules usually allow this."
    )
    return prompter.confirm("Proceed with this configuration?")
