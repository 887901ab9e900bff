"""Cluster configuration schema + validation.

The reference collected eight settings through an interactive wizard and
validated them inline (reference setup.sh:255-451): environment
name/description, master hostname (regex ^[a-zA-Z][0-9a-zA-Z]+$ at
setup.sh:276), node prefix, node count (1-9, setup.sh:301), network menu,
package menu. This module is the same contract as data: a typed config
object with pure validation, so the wizard, the file store, and tests all
share one source of truth.

The port's copy of `tritonk8ssupervisor_tpu/config/schema.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
It adds the GPU modes: a GPU family of the catalog (`h100`, `h100-mega`)
deploys as `gke-gpu` (a GKE cluster with A3 node pools) or `gpu-vm`
(standalone A3 VMs configured by ansible), and a TPU generation as the
reference's `tpu-vm` or `gke`; validation refuses a mixed pair.
"""

from __future__ import annotations

import dataclasses
import re

from tritonk8ssupervisor_tpu_torch.config import catalog
from tritonk8ssupervisor_tpu_torch.utils.topology import Topology

# GCP resource names: lowercase RFC1035, same spirit as the reference's
# hostname regex (setup.sh:276) but matching what the google provider accepts.
_NAME_RE = re.compile(r"^[a-z][a-z0-9-]{0,61}[a-z0-9]$")

MODES = ("tpu-vm", "gke")  # the TPU modes, the reference's
GPU_MODES = ("gke-gpu", "gpu-vm")
ALL_MODES = MODES + GPU_MODES
# the modes whose hosts are standalone VMs configured over SSH by ansible
VM_MODES = ("tpu-vm", "gpu-vm")

# The reference capped clusters at 9 nodes with a "no HA support" comment
# (setup.sh:297-307). We keep the same guard-rail for slice count.
MAX_SLICES = 9


class ConfigError(ValueError):
    """Invalid cluster configuration; message lists every problem found."""


@dataclasses.dataclass
class ClusterConfig:
    """Everything `setup.sh` needs to stand up (and tear down) a cluster.

    Persisted as flat KEY=value via config/store.py, the analogue of the
    reference `config` file (setup.sh:199-208).
    """

    # Identity / placement (replaces Triton SDC_URL/ACCOUNT, setup.sh:209-239)
    project: str = ""
    zone: str = ""
    # Deployment mode: a standalone TPU VM slice, or a GKE cluster with a
    # TPU node pool (reference had one mode: Triton KVMs joined to Rancher).
    mode: str = "gke"
    # Naming (master hostname / node prefix analogues, setup.sh:274-295)
    cluster_name: str = "tpu-dev"
    node_prefix: str = "tpunode"
    # Environment metadata (kubernetes_name/description, setup.sh:265-271)
    env_name: str = "tpu dev"
    env_description: str = "TPU Kubernetes environment"
    # Accelerator selection (replaces network/package menus, setup.sh:309-450)
    generation: str = catalog.DEFAULT_GENERATION
    topology: str = catalog.DEFAULT_TOPOLOGY
    num_slices: int = 1
    # Networking (reference defaulted to Joyent-SDC-Public, setup.sh:309-400)
    network: str = "default"
    subnetwork: str = "default"
    # Host software (reference pinned docker-engine 1.12.6; we pin the TPU VM
    # runtime image instead — dockersetup/tasks/main.yml:42-46 analogue)
    runtime_version: str = ""  # "" -> generation default from the catalog
    # GKE node identity: default is Workload Identity + minimal node
    # scopes (logging/monitoring/image-pull). True restores the broad
    # cloud-platform node scope — the 2017-era everything-identity the
    # reference's VMs effectively ran with — as an explicit opt-in for
    # clusters that can't use WI bindings yet.
    broad_node_scopes: bool = False
    # Failure domains: how many blast-radius compartments the slices are
    # striped across. 0 (default) = one domain per zone — every slice
    # shares fate (the pre-domain model, exactly). N > 1 stripes slice i
    # into domain `<zone>-fd<i % N>`: machines that share a power feed /
    # ToR / maintenance window share a domain, and the supervisor reacts
    # to a CORRELATED loss (K-of-domain inside a window) with a
    # per-domain circuit breaker + canary re-entry instead of storming
    # heals into the dead compartment (docs/failure-modes.md, "blast
    # radius & correlated failures").
    failure_domains: int = 0

    @property
    def is_gpu(self) -> bool:
        """A GPU deployment (`gke-gpu` or `gpu-vm`)."""
        return self.mode in GPU_MODES

    @property
    def region(self) -> str:
        return self.zone.rsplit("-", 1)[0] if self.zone else ""

    @property
    def spec(self) -> catalog.AcceleratorSpec:
        return catalog.get_spec(self.generation)

    @property
    def parsed_topology(self) -> Topology:
        return self.spec.topology(self.topology)

    @property
    def chips_per_slice(self) -> int:
        return self.parsed_topology.chips

    @property
    def hosts_per_slice(self) -> int:
        return self.spec.hosts(self.parsed_topology)

    @property
    def accelerator_type(self) -> str:
        return catalog.accelerator_type_name(self.generation, self.topology)

    @property
    def effective_runtime_version(self) -> str:
        return self.runtime_version or self.spec.default_runtime

    @property
    def gke_machine_type(self) -> str:
        chips_on_host = self.spec.chips_on_host(self.parsed_topology)
        try:
            return self.spec.gke_machine_type[chips_on_host]
        except KeyError:
            raise ConfigError(
                f"no GKE machine type packs {chips_on_host} {self.generation} "
                f"chips on one host"
            ) from None

    # ---- failure domains ----

    def domain_of(self, slice_index: int) -> str:
        """The failure domain slice `slice_index` belongs to. One domain
        per zone by default; `failure_domains` N stripes slices modulo N
        so every domain holds an equal share of the fleet."""
        n = int(self.failure_domains)
        zone = self.zone or "default"
        if n <= 1:
            return zone
        return f"{zone}-fd{int(slice_index) % n}"

    def domain_map(self) -> dict[int, str]:
        """{slice index: domain name} for the whole fleet."""
        return {i: self.domain_of(i) for i in range(self.num_slices)}

    def domain_slices(self) -> dict[str, list[int]]:
        """{domain name: sorted slice indices} — the classifier's view."""
        grouped: dict[str, list[int]] = {}
        for i in range(self.num_slices):
            grouped.setdefault(self.domain_of(i), []).append(i)
        return grouped

    def validate(self) -> None:
        """Raise ConfigError listing *all* problems (the reference re-prompted
        per field; batch validation serves both wizard and file-loaded configs)."""
        errors: list[str] = []
        if not self.project:
            errors.append("project is required (run `gcloud config set project ...`)")
        gpu_family = self.generation in catalog.GPU_ACCELERATORS
        modes, other = (GPU_MODES, MODES) if gpu_family else (MODES, GPU_MODES)
        if self.mode in other:
            errors.append(
                f"mode {self.mode!r} does not deploy the "
                f"{'GPU family' if gpu_family else 'TPU generation'} "
                f"{self.generation!r}; choose one of {modes}"
            )
        elif self.mode not in modes:
            errors.append(f"mode must be one of {modes}, got {self.mode!r}")
        for field in ("cluster_name", "node_prefix"):
            value = getattr(self, field)
            if not _NAME_RE.match(value):
                errors.append(
                    f"{field} {value!r} must match {_NAME_RE.pattern} "
                    "(lowercase letters, digits, hyphens)"
                )
        if not (1 <= self.num_slices <= MAX_SLICES):
            errors.append(
                f"num_slices must be 1-{MAX_SLICES} (no HA support yet), "
                f"got {self.num_slices}"
            )
        if self.failure_domains < 0:
            errors.append(
                f"failure_domains must be >= 0 (0 = one domain per "
                f"zone), got {self.failure_domains}"
            )
        elif self.failure_domains > self.num_slices:
            errors.append(
                f"failure_domains {self.failure_domains} exceeds "
                f"num_slices {self.num_slices} — a domain with no slices "
                "cannot isolate anything"
            )
        try:
            spec = catalog.get_spec(self.generation)
        except ValueError as e:
            errors.append(str(e))
            spec = None
        if spec is not None:
            try:
                spec.topology(self.topology)
            except ValueError as e:
                errors.append(str(e))
            if self.zone and self.zone not in spec.zones:
                errors.append(
                    f"zone {self.zone!r} has no {self.generation} capacity; "
                    f"known zones: {', '.join(spec.zones)}"
                )
            if not self.zone:
                errors.append(
                    f"zone is required; {self.generation} zones: "
                    f"{', '.join(spec.zones)}"
                )
        if errors:
            raise ConfigError("; ".join(errors))

    # ---- flat KEY=value round-trip (store.py uses these) ----

    _INT_FIELDS = ("num_slices", "failure_domains")
    _BOOL_FIELDS = ("broad_node_scopes",)

    def to_flat(self) -> dict[str, str]:
        return {
            f.name.upper(): str(getattr(self, f.name))
            for f in dataclasses.fields(self)
        }

    @classmethod
    def from_flat(cls, flat: dict[str, str]) -> "ClusterConfig":
        known = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in flat.items():
            name = key.lower()
            if name in known:
                if name in cls._INT_FIELDS:
                    kwargs[name] = int(value)
                elif name in cls._BOOL_FIELDS:
                    kwargs[name] = value.strip().lower() in ("true", "1", "yes")
                else:
                    kwargs[name] = value
        return cls(**kwargs)
