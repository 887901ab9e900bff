"""Accelerator catalog: which TPU generations and NVIDIA GPU families
exist, which topologies each supports, how chips pack onto hosts, and
where capacity lives.

This is the TPU analogue of the reference's live Triton menus — the
reference pulled `triton networks` / `triton packages` and let the user pick
by ordinal (reference setup.sh:257-259, 309-450, getNetworkIDs at 532-539,
getPackageID at 540-542). TPU offerings are a small static product matrix,
so we ship it as data and validate offline; `gcloud compute tpus
accelerator-types list` can refresh it when credentials exist (see
cli/discovery.py).

The port's copy of `tritonk8ssupervisor_tpu/config/catalog.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
Beside the TPU catalog it holds the H100 families the port runs on
(`GPU_ACCELERATORS`), in the same shape: a "chip" is one GPU, a host one
VM of up to 8 GPUs, and a topology `<hosts>x<gpus per host>`. They stay
out of `ACCELERATORS`, whose sorted keys are the TPU wizard's menu.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

from tritonk8ssupervisor_tpu_torch.utils.topology import Topology, hosts_for, parse_topology


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """One TPU generation's provisioning facts."""

    generation: str  # user-facing: "v4" | "v5e" | "v5p" | "v6e"
    type_prefix: str  # Cloud TPU API accelerator-type prefix
    cores_per_chip_in_name: int  # v4/v5p types count TensorCores, v5e/v6e count chips
    topology_ndim: int  # 2 for v5e/v6e, 3 for v4/v5p
    chips_per_host: int  # densest host packing for multi-host slices
    max_chips: int
    topologies: tuple[str, ...]  # valid slice topologies, ascending by chips
    zones: tuple[str, ...]  # zones with capacity (refreshable via gcloud)
    gke_machine_type: dict  # chips-on-host -> GKE machine type
    default_runtime: str  # TPU VM software version; a GPU VM's boot image
    kind: ClassVar[str] = "tpu"

    def topology(self, text: str) -> Topology:
        topo = parse_topology(text)
        if str(topo) not in self.topologies:
            raise ValueError(
                f"topology {topo} is not a valid {self.generation} slice; "
                f"choose one of: {', '.join(self.topologies)}"
            )
        return topo

    def hosts(self, topo: Topology) -> int:
        return hosts_for(topo.chips, self.chips_per_host)

    def chips_on_host(self, topo: Topology) -> int:
        """Chips attached to each host of this slice (uniform for valid slices)."""
        return min(topo.chips, self.chips_per_host)


ACCELERATORS: dict[str, AcceleratorSpec] = {
    "v4": AcceleratorSpec(
        generation="v4",
        type_prefix="v4",
        cores_per_chip_in_name=2,
        topology_ndim=3,
        chips_per_host=4,
        max_chips=4096,
        topologies=(
            "2x2x1", "2x2x2", "2x2x4", "2x4x4", "4x4x4", "4x4x8",
            "4x8x8", "8x8x8", "8x8x12", "8x8x16", "8x16x16",
        ),
        zones=("us-central2-b",),
        gke_machine_type={4: "ct4p-hightpu-4t"},
        default_runtime="tpu-ubuntu2204-base",
    ),
    "v5e": AcceleratorSpec(
        generation="v5e",
        type_prefix="v5litepod",
        cores_per_chip_in_name=1,
        topology_ndim=2,
        chips_per_host=8,
        max_chips=256,
        topologies=(
            "1x1", "2x2", "2x4", "4x4", "4x8", "8x8", "8x16", "16x16",
        ),
        zones=("us-west4-a", "us-east1-c", "us-east5-b", "europe-west4-b"),
        gke_machine_type={1: "ct5lp-hightpu-1t", 4: "ct5lp-hightpu-4t", 8: "ct5lp-hightpu-8t"},
        default_runtime="v2-alpha-tpuv5-lite",
    ),
    "v5p": AcceleratorSpec(
        generation="v5p",
        type_prefix="v5p",
        cores_per_chip_in_name=2,
        topology_ndim=3,
        chips_per_host=4,
        max_chips=8960,
        topologies=(
            "2x2x1", "2x2x2", "2x2x4", "2x4x4", "4x4x4", "4x4x8",
            "4x8x8", "8x8x8", "8x8x16", "8x16x16", "16x16x16",
        ),
        zones=("us-east5-a", "us-central1-a", "europe-west4-b"),
        gke_machine_type={4: "ct5p-hightpu-4t"},
        default_runtime="v2-alpha-tpuv5",
    ),
    "v6e": AcceleratorSpec(
        generation="v6e",
        type_prefix="v6e",
        cores_per_chip_in_name=1,
        topology_ndim=2,
        chips_per_host=8,
        max_chips=256,
        topologies=(
            "1x1", "2x2", "2x4", "4x4", "4x8", "8x8", "8x16", "16x16",
        ),
        zones=("us-east5-b", "us-east1-d", "europe-west4-a", "asia-northeast1-b"),
        gke_machine_type={1: "ct6e-standard-1t", 4: "ct6e-standard-4t", 8: "ct6e-standard-8t"},
        default_runtime="v2-alpha-tpuv6e",
    ),
}

# Wizard default, the analogue of the reference defaulting the package menu
# to k4-highcpu-kvm-7.75G (setup.sh:402-450).
DEFAULT_GENERATION = "v5e"
DEFAULT_TOPOLOGY = "2x2"


@dataclasses.dataclass(frozen=True)
class GpuAcceleratorSpec(AcceleratorSpec):
    """One NVIDIA GPU family's provisioning facts in the TPU spec's shape:
    `type_prefix` is the Compute Engine / GKE accelerator type,
    `gke_machine_type` maps GPUs on a host to the A3 machine type (for GKE
    node pools and standalone VMs alike), `default_runtime` is the
    CUDA-ready boot image of a standalone VM and `job_image` the default
    image of a GKE Job: a CUDA 12 devel image with torch, since the port
    builds its kernels with nvcc at first launch."""

    job_image: str = ""
    kind: ClassVar[str] = "gpu"


# The A3 families. Machine types and GPU counts: Google Cloud's "GPU
# machine types" page (accelerator-optimized A3: a3-highgpu-{1,2,4,8}g
# with 1-8 H100 80GB, a3-megagpu-8g with 8 H100 Mega 80GB); zones: its
# "GPU regions and zones" page, a snapshot that
# `gcloud compute accelerator-types list` refreshes (cli/discovery.py).
# The boot image is a Deep Learning VM family carrying CUDA 12, nvcc and
# torch; the Job image the public pytorch/pytorch CUDA 12.4 devel tag.
GPU_ACCELERATORS: dict[str, GpuAcceleratorSpec] = {
    "h100": GpuAcceleratorSpec(
        generation="h100",
        type_prefix="nvidia-h100-80gb",
        cores_per_chip_in_name=1,
        topology_ndim=2,
        chips_per_host=8,
        max_chips=64,
        topologies=("1x1", "1x2", "1x4", "1x8", "2x8", "4x8", "8x8"),
        zones=("us-central1-a", "us-central1-c", "us-east4-a", "us-east5-a",
               "us-west1-b", "europe-west4-b", "asia-northeast1-b"),
        gke_machine_type={1: "a3-highgpu-1g", 2: "a3-highgpu-2g",
                          4: "a3-highgpu-4g", 8: "a3-highgpu-8g"},
        default_runtime="projects/deeplearning-platform-release/global/images/"
                        "family/pytorch-latest-gpu-debian-11-py310",
        job_image="pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel",
    ),
    "h100-mega": GpuAcceleratorSpec(
        generation="h100-mega",
        type_prefix="nvidia-h100-mega-80gb",
        cores_per_chip_in_name=1,
        topology_ndim=2,
        chips_per_host=8,
        max_chips=64,
        topologies=("1x8", "2x8", "4x8", "8x8"),
        zones=("us-central1-a", "us-east4-a", "us-east5-a", "europe-west4-b"),
        gke_machine_type={8: "a3-megagpu-8g"},
        default_runtime="projects/deeplearning-platform-release/global/images/"
                        "family/pytorch-latest-gpu-debian-11-py310",
        job_image="pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel",
    ),
}

DEFAULT_GPU_GENERATION = "h100"
DEFAULT_GPU_TOPOLOGY = "1x8"


def get_spec(generation: str) -> AcceleratorSpec:
    """The TPU generation's or the GPU family's spec."""
    spec = ACCELERATORS.get(generation) or GPU_ACCELERATORS.get(generation)
    if spec is None:
        raise ValueError(
            f"unknown TPU generation {generation!r}; "
            f"choose one of: {', '.join(sorted(ACCELERATORS))}"
        )
    return spec


def accelerator_type_name(generation: str, topology_text: str) -> str:
    """Cloud TPU accelerator-type string, e.g. ("v5e", "4x4") -> "v5litepod-16".

    v4/v5p types count TensorCores (2/chip): ("v4", "2x2x1") -> "v4-8".
    A GPU family's is its accelerator type, whatever the topology:
    ("h100", "2x8") -> "nvidia-h100-80gb".
    """
    spec = get_spec(generation)
    topo = spec.topology(topology_text)
    if spec.kind == "gpu":
        return spec.type_prefix
    return f"{spec.type_prefix}-{topo.chips * spec.cores_per_chip_in_name}"
