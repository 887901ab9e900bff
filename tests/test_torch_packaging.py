"""The port's source archive (`packaging.py`): deterministic bytes, the
port's modules with its CUDA sources and a synthesized manifest, no built
library and no byte code, in a checkout and from an installed tree alike.
Installed with pip as the compiled Job installs it (`--no-build-isolation
--no-deps --target`, offline), it holds the CUDA sources, and the Jobs'
benchmark modules run from the installed copy. `write_ansible_configs`
stages it, and its ConfigMap stays under the API server's object limit."""

import base64
import io
import os
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest
import yaml

try:
    import tomllib  # Python >= 3.11
except ModuleNotFoundError:  # pragma: no cover - version-dependent
    tomllib = None

import tritonk8ssupervisor_tpu_torch
from tritonk8ssupervisor_tpu_torch import packaging
from tritonk8ssupervisor_tpu_torch.config import compile as cc
from tritonk8ssupervisor_tpu_torch.config.schema import ClusterConfig

PACKAGE_DIR = Path(tritonk8ssupervisor_tpu_torch.__file__).resolve().parent
CUDA_SOURCES = ["conv_backward.cu", "conv_backward_tf32.cu", "cross_entropy.cu",
                "decode_attention.cu", "flash_attention.cu", "flash_attention_tf32.cu",
                "hopper.cuh"]
CONFIGMAP_LIMIT = 1_048_576  # bytes the API server accepts in one object


def members(blob: bytes) -> list[tarfile.TarInfo]:
    with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
        return tar.getmembers()


def expected_names() -> list[str]:
    modules = [p for p in PACKAGE_DIR.rglob("*.py") if "__pycache__" not in p.parts]
    sources = [PACKAGE_DIR / "csrc" / name for name in CUDA_SOURCES]
    return ["pyproject.toml"] + sorted(
        "tritonk8ssupervisor_tpu_torch/" + p.relative_to(PACKAGE_DIR).as_posix()
        for p in modules + sources)


def test_archive_is_deterministic_and_holds_the_modules_and_the_cuda_sources():
    blob = packaging.build_archive_bytes()
    assert blob == packaging.build_archive_bytes()
    infos = members(blob)
    assert [m.name for m in infos] == expected_names()
    assert {(m.mtime, m.uid, m.gid, m.uname, m.gname, m.mode) for m in infos} == {
        (0, 0, 0, "", "", 0o644)}
    names = [m.name for m in infos]
    assert {"tritonk8ssupervisor_tpu_torch/cli/wizard.py",
            "tritonk8ssupervisor_tpu_torch/utils/roofline.py"} <= set(names)
    assert not [n for n in names if "/csrc/build" in n or "__pycache__" in n
                or n.endswith((".pyc", ".so", ".log"))]
    assert "README.md" not in names
    assert packaging.ARCHIVE_NAME == "tritonk8ssupervisor-tpu-torch-src.tar.gz"


def test_the_manifest_is_synthesized_for_the_port():
    with tarfile.open(fileobj=io.BytesIO(packaging.build_archive_bytes())) as tar:
        manifest = tar.extractfile("pyproject.toml").read().decode()
    if tomllib is None:
        pytest.skip("needs tomllib (py311+)")
    data = tomllib.loads(manifest)
    assert data["project"]["name"] == "tritonk8ssupervisor-tpu-torch"
    assert data["project"]["version"] == tritonk8ssupervisor_tpu_torch.__version__
    assert data["project"]["dependencies"] == ["torch", "numpy>=1.24", "PyYAML>=6.0"]
    assert data["tool"]["setuptools"]["packages"]["find"]["include"] == [
        "tritonk8ssupervisor_tpu_torch*"]
    assert data["tool"]["setuptools"]["package-data"] == {
        "tritonk8ssupervisor_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]}


def _copy_tree(dest: Path) -> Path:
    """A checkout of the port alone: its package (no byte code) and a
    pyproject.toml of the repo's, which the archive does not read."""
    shutil.copytree(PACKAGE_DIR, dest / "tritonk8ssupervisor_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    (dest / "pyproject.toml").write_text("[project]\nname = 'the-jax-distribution'\n")
    return dest


def test_a_built_library_beside_the_sources_stays_out(tmp_path):
    root = _copy_tree(tmp_path / "checkout")
    build = root / "tritonk8ssupervisor_tpu_torch" / "csrc" / "build"
    build.mkdir()
    (build / "flash_attention-0123abcd.so").write_bytes(b"\x7fELF built elsewhere")
    (build / "flash_attention-0123abcd.log").write_text("ptxas info\n")
    (build / "stray.py").write_text("x = 1\n")
    assert packaging.build_archive_bytes(root) == packaging.build_archive_bytes()


def test_installed_mode_builds_the_same_archive(tmp_path):
    """No pyproject.toml beside the package (a pip install): the archive
    is read from the installed tree, with the same synthesized manifest."""
    assert packaging.build_archive_bytes(root=tmp_path) == packaging.build_archive_bytes()


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """The archive installed the Job's way, once for the module."""
    root = tmp_path_factory.mktemp("installed")
    archive = packaging.build_source_archive(root / packaging.ARCHIVE_NAME)
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "--quiet", "--no-index",
         "--disable-pip-version-check", "--no-build-isolation",
         "--no-deps", "--target", str(root / "site"), str(archive)],
        check=True, timeout=300,
    )
    return root


def test_pip_installs_the_cuda_sources(installed):
    csrc = installed / "site" / "tritonk8ssupervisor_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.iterdir()) == CUDA_SOURCES
    for name in CUDA_SOURCES:
        assert (csrc / name).read_bytes() == (PACKAGE_DIR / "csrc" / name).read_bytes()
    installed_modules = sorted(
        p.relative_to(installed / "site").as_posix()
        for p in (installed / "site" / "tritonk8ssupervisor_tpu_torch").rglob("*.py"))
    assert installed_modules == [n for n in expected_names() if n.endswith(".py")]


@pytest.mark.parametrize("module", ["lm", "resnet50"])
def test_the_jobs_modules_run_from_the_installed_copy(installed, module):
    code = (
        "import runpy, sys, tritonk8ssupervisor_tpu_torch as t; "
        f"assert t.__file__.startswith({str(installed / 'site')!r}), t.__file__; "
        f"sys.argv = ['{module}', '--help']; "
        f"runpy.run_module('tritonk8ssupervisor_tpu_torch.benchmarks.{module}', "
        "run_name='__main__')"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(installed / "site"), HOME=str(installed))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=installed, env=env)
    assert out.returncode == 0, out.stderr
    assert "--json" in out.stdout and "--checkpoint-dir" in out.stdout


def test_write_ansible_configs_stages_the_archive(tmp_path):
    config = ClusterConfig(project="p", zone="us-west4-a", generation="v5e", topology="4x4")
    cc.write_ansible_configs(config, [["10.0.0.1"]], tmp_path)
    staged = tmp_path / "roles" / "tpuhost" / "files" / packaging.ARCHIVE_NAME
    assert staged.read_bytes() == packaging.build_archive_bytes()


def test_the_configmap_is_under_the_object_limit():
    cm = cc.to_package_configmap()
    document = yaml.safe_dump(cm, sort_keys=False)
    assert len(document.encode()) < CONFIGMAP_LIMIT
    blob = base64.b64decode(yaml.safe_load(document)["binaryData"][packaging.ARCHIVE_NAME])
    assert blob == packaging.build_archive_bytes()


def test_the_repo_manifest_ships_the_cuda_sources_too():
    """A `pip install .` of the repo carries the port's CUDA sources."""
    if tomllib is None:
        pytest.skip("needs tomllib (py311+)")
    data = tomllib.loads((packaging.REPO_ROOT / "pyproject.toml").read_text())
    assert data["tool"]["setuptools"]["package-data"] == {
        "tritonk8ssupervisor_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]}
