"""Deterministic source archive — the workload delivery mechanism.

The reference's workloads were public container images that ran as
published (reference docs/benchmarks.md:1-4 pulled
misterbisson/simple-container-benchmarks; docs/detailed.md:289-331
`kubectl create -f` a public guestbook manifest). This framework's
benchmark workload is the framework itself, which no registry carries —
so provisioning ships the source:

- GKE mode: the archive rides a ConfigMap (binaryData) mounted into the
  benchmark Job; the Job command pip-installs it plus pinned jax[tpu]
  before running (config/compile.py to_package_configmap / bench_command —
  the probe Job's self-install pattern, generalized).
- tpu-vm mode: the archive is staged into the tpuhost ansible role's
  files/ dir and pip-installed on every host (the dockersetup payload
  analogue, reference ansible/roles/dockersetup/tasks/main.yml:42-46),
  so the success banner's advertised command works on a fresh VM.

The archive is byte-deterministic (sorted members, zeroed timestamps and
ownership) so re-runs generate identical manifests and ansible sees
`changed=false` — the converge-on-rerun property the reference got from
terraform state + docker probes (SURVEY.md §5 failure detection).

The port's copy of `tritonk8ssupervisor_tpu/packaging.py`, with three
differences, each for the port's sake:

- the archive carries the port's CUDA sources (`csrc/*.cu`, `csrc/*.cuh`)
  beside its modules: `ops/cuda_build.py` builds the kernels from them at
  first use, beside the installed sources, so an archive without them
  would fail at the first kernel launch on a fresh host. What a build
  leaves there (`csrc/build/`: libraries and their logs) never rides
  along: a library built for another host is not deterministic bytes;
- its `pyproject.toml` is always synthesized, in a checkout too: the
  repo's own manifest describes the JAX distribution, whose version
  attribute names a package this archive does not hold. The synthesized
  one names the port, its version and dependencies, and lists the CUDA
  sources as package data, without which setuptools would leave them
  out of the wheel pip installs;
- so no README rides along either: nothing references it.
"""

from __future__ import annotations

import gzip
import io
import tarfile
from pathlib import Path

ARCHIVE_NAME = "tritonk8ssupervisor-tpu-torch-src.tar.gz"
PACKAGE = "tritonk8ssupervisor_tpu_torch"

# repo root = the directory holding pyproject.toml, one level above the package
REPO_ROOT = Path(__file__).resolve().parent.parent

# The CUDA sources the kernels are built from at first use, relative to
# the package: package data for setuptools, members of the archive.
CUDA_SOURCES = ("csrc/*.cu", "csrc/*.cuh")

# The build manifest of every archive. The tpu extra of the reference's
# is unnecessary because the Job command and the tpuhost role install the
# jax[tpu] pin explicitly alongside the archive.
_SYNTHESIZED_PYPROJECT = """\
[build-system]
requires = ["setuptools>=68"]
build-backend = "setuptools.build_meta"

[project]
name = "tritonk8ssupervisor-tpu-torch"
version = "{version}"
requires-python = ">=3.10"
dependencies = [
    "torch",
    "numpy>=1.24",
    "PyYAML>=6.0",
]

[tool.setuptools.packages.find]
include = ["tritonk8ssupervisor_tpu_torch*"]

[tool.setuptools.package-data]
tritonk8ssupervisor_tpu_torch = [{package_data}]
"""


def archive_entries(root: Path | None = None) -> list[tuple[str, bytes]]:
    """(arcname, content) pairs for everything pip needs to build the
    package: the synthesized manifest, the package's modules and its CUDA
    sources. Checkout mode (a pyproject.toml in `root`) reads the package
    from `root`; installed mode reads the installed package tree, so the
    archive builds from a pip install, not only from a git checkout."""
    from tritonk8ssupervisor_tpu_torch import __version__

    root = root if root is not None else REPO_ROOT
    pkg_dir = Path(__file__).resolve().parent
    if (root / "pyproject.toml").is_file():
        pkg_dir = root / PACKAGE
    package_data = ", ".join(f'"{pattern}"' for pattern in CUDA_SOURCES)
    entries = [
        (
            "pyproject.toml",
            _SYNTHESIZED_PYPROJECT.format(
                version=__version__, package_data=package_data
            ).encode(),
        )
    ]
    built = pkg_dir / "csrc" / "build"  # what nvcc leaves there (ops/cuda_build.py)
    members = {p for p in pkg_dir.rglob("*.py")
               if "__pycache__" not in p.parts and built not in p.parents}
    for pattern in CUDA_SOURCES:
        members.update(pkg_dir.glob(pattern))
    for path in sorted(members):
        if not path.is_file():
            continue
        arcname = f"{PACKAGE}/" + path.relative_to(pkg_dir).as_posix()
        entries.append((arcname, path.read_bytes()))
    return entries


def build_archive_bytes(root: Path | None = None) -> bytes:
    """A pip-installable source archive as bytes, built without network or
    a `build` frontend: pip unpacks the tarball and drives the setuptools
    backend itself (PEP 517), so a plain tar of the source tree suffices."""
    tar_buf = io.BytesIO()
    with tarfile.open(fileobj=tar_buf, mode="w") as tar:
        for arcname, data in archive_entries(root):
            info = tarfile.TarInfo(arcname)
            info.size = len(data)
            info.mtime = 0
            info.uid = info.gid = 0
            info.uname = info.gname = ""
            info.mode = 0o644
            tar.addfile(info, io.BytesIO(data))
    # gzip with fixed mtime; tarfile's own "w:gz" stamps wall-clock time
    return gzip.compress(tar_buf.getvalue(), mtime=0)


def build_source_archive(out_path: Path, root: Path | None = None) -> Path:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_bytes(build_archive_bytes(root))
    return out_path
