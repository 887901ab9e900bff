"""Build the port's CUDA sources at first use and load them with ctypes.

Each source under `csrc/` has a plain C interface and no PyTorch headers,
so `nvcc` builds it in seconds: for Hopper (`sm_90a`), into
`csrc/build/` beside the sources (listed in .gitignore). The library's
name carries a hash of its source, the shared headers (`csrc/*.cuh`) and
the flags, so an edited source or header builds anew and an unchanged
one loads what an earlier process built; the compiler's report
(`-Xptxas -v`: registers, shared memory, spills) is kept beside it as
`<name>.log`.

A missing `nvcc` or a failed build raises with the compiler's output:
nothing falls back to a plain version on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--use_fast_math", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """`nvcc` on PATH, else under the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from csrc/ at "
        "first use and need the CUDA toolkit (nvcc on PATH or CUDA_HOME)"
    )


def library_path(source_name: str) -> Path:
    """Where `source_name`'s library lives once built: named by a hash of
    the source, every header under `csrc/` and the flags."""
    source = CSRC / source_name
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source_name: str) -> Path:
    """Compile `csrc/<source_name>` unless its library exists; returns
    the library's path. Builds into a temporary name and renames, so
    processes building at once never load a half-written file."""
    target = library_path(source_name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.stem, suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source_name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source_name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, target)
    return target


def load(source_name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source_name>`, built first if need be;
    one load per process."""
    with _lock:
        if source_name not in _loaded:
            _loaded[source_name] = ctypes.CDLL(str(build(source_name)))
        return _loaded[source_name]
