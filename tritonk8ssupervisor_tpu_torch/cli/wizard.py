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
"""

from __future__ import annotations

from tritonk8ssupervisor_tpu_torch.cli import discovery
from tritonk8ssupervisor_tpu_torch.cli.io import Prompter
from tritonk8ssupervisor_tpu_torch.config import catalog
from tritonk8ssupervisor_tpu_torch.config.schema import MAX_SLICES, MODES, ClusterConfig, _NAME_RE


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
    zone_lister=discovery.list_tpu_zones,
    network_lister=discovery.list_networks,
    subnet_lister=discovery.list_subnetworks,
) -> ClusterConfig:
    """Collect a full ClusterConfig interactively.

    Question order mirrors the reference wizard (setup.sh:255-451):
    identity -> naming -> sizing -> placement.
    """
    env = env or discovery.GcloudEnv()
    config = ClusterConfig()

    prompter.say("---------------------------------------------------------")
    prompter.say(" TPU Kubernetes cluster setup")
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
        "TPU node name prefix", config.node_prefix, _name_validator("node prefix")
    )

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


def config_rows(config: ClusterConfig) -> list[tuple[str, str]]:
    """The summary rows shared by the verify gate and --show-config (the
    debugVars dump analogue, setup.sh:522-531)."""
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
