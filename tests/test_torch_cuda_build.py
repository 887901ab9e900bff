"""ops/cuda_build.py without a CUDA toolkit: a stand-in `nvcc` script on
PATH shows that a library is built once per source and flags, rebuilt
when the source changes, and that a failed build or a missing compiler
raises with the reason."""

import os
import stat

import pytest

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: logs its call, writes the file after -o
echo "$@" >> "$(dirname "$0")/calls.log"
[ -n "$FAIL" ] && { echo "error: $FAIL" >&2; exit 2; }
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
echo "ptxas info    : Used 1 registers" >&2
"""


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel v1\n")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("FAIL", raising=False)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", csrc / "build")
    return bin_dir / "calls.log", csrc


def test_a_library_is_built_once_per_source_and_flags(toolkit):
    calls, csrc = toolkit
    first = cuda_build.build("k.cu")
    assert first.read_text() == "built\n" and first.parent == csrc / "build"
    assert "sm_90a" in calls.read_text()
    assert "Used 1 registers" in first.with_suffix(".log").read_text()
    assert cuda_build.build("k.cu") == first
    assert len(calls.read_text().splitlines()) == 1  # the second call loaded it
    (csrc / "k.cu").write_text("// kernel v2\n")
    second = cuda_build.build("k.cu")
    assert second != first and len(calls.read_text().splitlines()) == 2
    assert sorted(p.suffix for p in (csrc / "build").iterdir()) == [".log", ".log", ".so", ".so"]


def test_editing_a_header_changes_the_library_name(toolkit):
    """A source that includes a shared header (csrc/*.cuh) builds anew when
    the header changes, though the source itself did not."""
    calls, csrc = toolkit
    (csrc / "shared.cuh").write_text("// helpers v1\n")
    first = cuda_build.build("k.cu")
    assert cuda_build.library_path("k.cu") == first
    (csrc / "shared.cuh").write_text("// helpers v2\n")
    assert cuda_build.library_path("k.cu") != first
    second = cuda_build.build("k.cu")
    assert second != first and len(calls.read_text().splitlines()) == 2


def test_a_failed_build_raises_with_the_compiler_output(toolkit, monkeypatch):
    _, csrc = toolkit
    monkeypatch.setenv("FAIL", "identifier undefined")
    with pytest.raises(RuntimeError, match="identifier undefined"):
        cuda_build.build("k.cu")
    assert not list((csrc / "build").glob("*.so"))  # nothing half-built is left


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()
