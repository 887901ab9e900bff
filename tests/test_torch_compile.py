"""The port's manifest compiler (`config/compile.py`) against the reference's:
for every configuration of tests/test_compile.py and test_packaging.py,
and a sweep of the catalog's generations, tfvars, inventories (with their
per-slice coordinators, internal IPs, ansible user and the errors on bad
slice shapes), ansible vars, the benchmark, probe and user-workload Jobs
across every workload, checkpoint mode, image and cross-slice setting,
the headless services and the files `write_manifests` writes are equal
once the reference's `tritonk8ssupervisor_tpu` reads
`tritonk8ssupervisor_tpu_torch` (and `tritonk8ssupervisor-tpu`,
`tritonk8ssupervisor-tpu-torch`). The ConfigMap's archive is compared
apart: the port's decodes to the port's archive. One string differs by
design: the TPU cluster smoke (`cluster_smoke_command`), which forms the
JAX cluster itself where the reference's calls its own
`initialize_from_env` (the port's forms a torch group on the card, F9).
The parity tests compile the reference with the port's command in its
place, and the command is held to the reference's behaviour instead: both
form a two-process JAX cluster on the CPU and print the same line. No
tolerance."""

import base64
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from tritonk8ssupervisor_tpu.config import compile as ref_cc
from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu_torch import packaging
from tritonk8ssupervisor_tpu_torch.config import compile as cc
from tritonk8ssupervisor_tpu_torch.config import schema

SIDES = {"port": (cc, schema), "reference": (ref_cc, ref_schema)}
REPO = Path(__file__).resolve().parent.parent
REF_CLUSTER_SMOKE = ref_cc.cluster_smoke_command


@pytest.fixture(autouse=True)
def port_cluster_smoke(monkeypatch):
    """The reference compiles the port's TPU cluster smoke, spelled with
    the reference's names (which `port_names` renames back): the one
    deliberate difference between the compilers (F9)."""
    monkeypatch.setattr(ref_cc, "cluster_smoke_command", lambda *a, **k: cc.cluster_smoke_command(
        *a, **k).replace("tritonk8ssupervisor_tpu_torch", "tritonk8ssupervisor_tpu"))


def port_names(value):
    """The reference's document with the package renamed as the port
    names it: the one substitution between the two compilers."""
    text = json.dumps(value, sort_keys=True)
    text = text.replace("tritonk8ssupervisor_tpu", "tritonk8ssupervisor_tpu_torch")
    text = text.replace("tritonk8ssupervisor-tpu", "tritonk8ssupervisor-tpu-torch")
    return json.loads(text)


def outcome(fn):
    """fn()'s value, or the class name and message of what it raised."""
    try:
        return ["ok", fn()]
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return [type(e).__name__, str(e)]


BASE = dict(project="my-proj", zone="us-west4-a", generation="v5e", topology="4x4")
CONFIGS = [
    {},
    {"mode": "tpu-vm"},
    {"mode": "gke"},
    {"mode": "gke", "num_slices": 2},
    {"num_slices": 2},
    {"mode": "gke", "num_slices": 3},
    {"num_slices": 3},
    {"topology": "2x2"},
    {"mode": "gke", "topology": "2x2"},
    {"project": "p", "cluster_name": "c"},
    {"project": "p", "cluster_name": "c", "num_slices": 2},
    {"project": "my-project", "cluster_name": "tpu-dev"},
    {"project": "golden-proj", "num_slices": 2, "mode": "gke", "broad_node_scopes": True},
    {"generation": "v4", "topology": "2x2x2", "zone": "us-central2-b"},
    {"generation": "v5p", "topology": "2x2x2", "zone": "us-east5-a", "mode": "gke"},
    {"generation": "v6e", "topology": "4x4", "zone": "us-east5-b", "mode": "gke",
     "num_slices": 2},
]

IP_SETS = [
    ([["10.0.0.1", "10.0.0.2"], ["10.0.1.1"]], None, ""),
    ([["34.1.1.1", "34.1.1.2"], ["34.2.2.1"]], [["10.0.0.1", "10.0.0.2"], ["10.0.1.1"]], ""),
    ([["10.0.0.1"]], None, "alice"),
    ([["10.0.0.1"], []], None, ""),
    ([[]], None, ""),
    ([[], ["2.2.2.1", "2.2.2.2"]], None, ""),
    ([["1.1.1.1", "1.1.1.2"], ["2.2.2.1", "2.2.2.2"]],
     [["10.0.0.1", "10.0.0.2"], ["10.0.1.1", "10.0.1.2"]], "bob"),
    (["10.0.0.1"], None, ""),
    ([["10.0.0.1"]], ["10.0.0.1"], ""),
    ([["10.0.0.1"]], [["10.0.0.1", "10.0.0.2"]], ""),
    ("10.0.0.1", None, ""),
]

CHECKPOINTS = ["", "gs://bkt/ckpt", "gs://bkt/ckpt/", "/mnt/ckpt", "dir with 'quotes'"]
IMAGES = [None, "gcr.io/p/bench:1"]
CROSS = [None, False, True]
FLAG_SETS = [(), ("--sequence-parallelism", "4"),
             ("--moe-experts", "8", "--expert-parallelism", "4")]


def _config(mods, kwargs):
    return mods[1].ClusterConfig(**{**BASE, **kwargs})


def describe(side: str, kwargs: dict) -> dict:
    """Every document the compiler makes of one configuration, and the
    errors it raises, as plain data."""
    mod = SIDES[side][0]
    config = _config(SIDES[side], kwargs)
    out = {"validate": outcome(config.validate), "tfvars": outcome(lambda: mod.to_tfvars(config))}
    out["inventory"] = [
        outcome(lambda: mod.to_inventory(config, ips, internal_ips=internal, ansible_user=user))
        for ips, internal, user in IP_SETS
    ]
    out["ansible_vars"] = [outcome(lambda: mod.to_ansible_vars(config, coordinator_ip=ip))
                           for ip in ("", "10.0.0.1")]
    jobs = []
    slices = range(config.num_slices)
    for workload in sorted(mod.BENCH_WORKLOADS) + ["bert"]:
        for ckpt in CHECKPOINTS:
            for image in IMAGES:
                for cross in CROSS:
                    for i in slices:
                        extra = {} if image is None else {"image": image}
                        jobs.append(outcome(lambda: mod.to_benchmark_job(
                            config, slice_index=i, checkpoint_dir=ckpt, workload=workload,
                            cross_slice=cross, **extra)))
    for flags in FLAG_SETS:
        for image in IMAGES:
            extra = {} if image is None else {"image": image}
            jobs.append(outcome(lambda: mod.to_benchmark_job(
                config, workload="lm", bench_flags=flags, **extra)))
    jobs.append(outcome(lambda: mod.to_benchmark_job(
        config, command=["python", "x.py"], checkpoint_dir="gs://b/p")))
    jobs.append(outcome(lambda: mod.to_benchmark_job(
        config, name="other-bench", command=["python", "x.py"])))
    out["benchmark_jobs"] = jobs
    out["probe_jobs"] = [outcome(lambda: mod.to_probe_job(config)),
                         outcome(lambda: mod.to_probe_job(config, name="p2", image="img"))]
    out["user_jobs"] = [
        outcome(lambda: mod.to_user_workload_job(
            config, name="my-trainer", image="gcr.io/p/trainer:1",
            command=["python", "train.py"], slice_index=i, cross_slice=cross,
            env={"MY_FLAG": "on", "JAX_NUM_PROCESSES": "override"}, backoff_limit=backoff))
        for i in slices for cross in CROSS for backoff in (0, 3)
    ]
    out["services"] = [mod.to_headless_service(), mod.to_headless_service("my-trainer")]
    out["commands"] = [
        mod.jax_smoke_command(8), mod.cluster_smoke_command(16),
        mod.cluster_smoke_command(48, timeout_s=30), mod.bench_command(),
        mod.bench_command(module="m", extra_args=("--a", "b c"), extra_packages=("gcsfs",)),
    ]
    out["constants"] = [mod.BENCH_IMAGE_DEFAULT, mod.PACKAGE_CONFIGMAP_NAME,
                        mod.PACKAGE_MOUNT_PATH, mod.JAX_VERSION_PIN, mod.PROBE_JAX_PIN,
                        mod.PROBE_LIBTPU_INDEX,
                        {k: list(v) for k, v in mod.BENCH_WORKLOADS.items()},
                        sorted(mod.CHECKPOINTABLE_WORKLOADS)]
    return out


@pytest.mark.parametrize("index", range(len(CONFIGS)))
def test_documents_equal_the_reference_after_the_rename(index):
    ours = json.loads(json.dumps(describe("port", CONFIGS[index]), sort_keys=True))
    ref = port_names(describe("reference", CONFIGS[index]))
    assert ours == ref
    # the module the default Job runs is the port's
    job = cc.to_benchmark_job(_config(SIDES["port"], CONFIGS[index]))
    assert "python -m tritonk8ssupervisor_tpu_torch.benchmarks.resnet50 --json" in \
        job["spec"]["template"]["spec"]["containers"][0]["command"][-1]


def test_the_tpu_runtime_strings_are_the_reference_s_byte_for_byte():
    """What the TPU host's runtime reads stays the reference's: the smoke
    command, the pins, the libtpu index and the env names."""
    assert cc.jax_smoke_command(8) == ref_cc.jax_smoke_command(8)
    assert (cc.JAX_VERSION_PIN, cc.PROBE_JAX_PIN, cc.PROBE_LIBTPU_INDEX) == (
        ref_cc.JAX_VERSION_PIN, ref_cc.PROBE_JAX_PIN, ref_cc.PROBE_LIBTPU_INDEX)
    ours = cc.to_benchmark_job(schema.ClusterConfig(**BASE, num_slices=2))
    ref = ref_cc.to_benchmark_job(ref_schema.ClusterConfig(**BASE, num_slices=2))
    names = [[e["name"] for e in job["spec"]["template"]["spec"]["containers"][0]["env"]]
             for job in (ours, ref)]
    assert names[0] == names[1]
    # the cluster smoke differs on purpose: it forms the JAX cluster
    # itself instead of calling the port's torch rendezvous (F9)
    ours, renamed = cc.cluster_smoke_command(16), REF_CLUSTER_SMOKE(16).replace(
        "tritonk8ssupervisor_tpu.", "tritonk8ssupervisor_tpu_torch.")
    assert ours != renamed and "initialize_from_env" in renamed
    assert "initialize_from_env" not in ours and "jax.distributed.initialize(" in ours
    assert "tritonk8ssupervisor_tpu_torch.parallel.distributed import cluster_env" in ours
    assert all(f"'{name}'" in ours for name in (
        "MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID",
        "MEGASCALE_PORT"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_host_smoke(command: str, cross_slice: bool) -> list:
    """`command` on two hosts at once, here two CPU processes with the
    coordinates a two-host slice (or two one-host slices) gets: each
    one's exit code and printed lines."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith(
            ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "TK8S_", "MEGASCALE_",
             "XLA_FLAGS"))}
        env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID="0" if cross_slice else str(pid))
        if cross_slice:
            env.update(TK8S_NUM_SLICES="2", TK8S_SLICE_ID=str(pid), TK8S_PROCS_PER_SLICE="1")
        procs.append(subprocess.Popen(["bash", "-c", command], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    out = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=120)
        out.append([proc.returncode, stdout.splitlines(), stderr[-2000:] if proc.returncode else ""])
    return out


@pytest.mark.parametrize("cross_slice", [False, True])
def test_the_tpu_cluster_smoke_forms_the_reference_s_jax_cluster(cross_slice):
    """F9: the TPU cluster smoke on two hosts (two CPU processes) forms
    one JAX cluster of two devices, as the reference's command does; the
    old rename called the port's `initialize_from_env`, whose torch
    rendezvous raises on a host without a CUDA card."""
    ours = _two_host_smoke(cc.cluster_smoke_command(2, timeout_s=90), cross_slice)
    ref = _two_host_smoke(REF_CLUSTER_SMOKE(2, timeout_s=90), cross_slice)
    assert ref == [[0, ["CLUSTER OK: 2 processes, 2 chips"], ""]] * 2
    assert ours == ref


def _written(side: str, root, kwargs: dict, **job_kwargs) -> dict:
    """{file name: parsed documents} of what write_manifests writes, the
    ConfigMap's archive taken out and returned beside it."""
    mod = SIDES[side][0]
    config = _config(SIDES[side], kwargs)
    root.mkdir(parents=True)
    (root / "bench-job-7.yaml").write_text("stale: true\n")  # a larger topology's leftover
    (root / "notes.txt").write_text("kept\n")
    paths = mod.write_manifests(config, root, **job_kwargs)
    docs = {p.name: yaml.safe_load(p.read_text()) for p in paths}
    blob = docs["package-configmap.yaml"]["binaryData"].pop(mod.packaging.ARCHIVE_NAME)
    return {"order": [p.name for p in paths], "on_disk": sorted(p.name for p in root.iterdir()),
            "docs": docs, "archive_name": mod.packaging.ARCHIVE_NAME}, blob


WRITE_CASES = [
    ({"num_slices": 2}, {}),
    ({"mode": "gke"}, {"image": "gcr.io/p/bench:2"}),
    ({"mode": "gke", "topology": "2x2"},
     {"workload": "lm", "bench_flags": ("--steps", "10"), "checkpoint_dir": "/tmp-ckpt"}),
    ({"project": "p", "cluster_name": "c", "num_slices": 2},
     {"workload_image": "gcr.io/p/t:1", "workload_command": ["python", "train.py"],
      "workload_name": "my-trainer"}),
    ({"num_slices": 3}, {"workload_image": "i", "cross_slice": False,
                         "checkpoint_dir": "gs://b/c"}),
]


@pytest.mark.parametrize("index", range(len(WRITE_CASES)))
def test_write_manifests_writes_the_reference_s_files(tmp_path, index):
    kwargs, job_kwargs = WRITE_CASES[index]
    ours, blob = _written("port", tmp_path / "port", kwargs, **job_kwargs)
    ref, _ = _written("reference", tmp_path / "reference", kwargs, **job_kwargs)
    assert ours == port_names(ref)
    assert "bench-job-7.yaml" not in ours["on_disk"] and "notes.txt" in ours["on_disk"]
    assert base64.b64decode(blob) == packaging.build_archive_bytes()


def test_the_configmap_carries_the_port_s_archive():
    cm = cc.to_package_configmap()
    ref = ref_cc.to_package_configmap()
    assert list(cm["binaryData"]) == [packaging.ARCHIVE_NAME]
    assert packaging.ARCHIVE_NAME == "tritonk8ssupervisor-tpu-torch-src.tar.gz"
    assert base64.b64decode(cm["binaryData"][packaging.ARCHIVE_NAME]) == \
        packaging.build_archive_bytes()
    for doc in (cm, ref):
        doc.pop("binaryData")
    assert cm == port_names(ref)


def test_write_tfvars_and_ansible_configs_write_the_reference_s_files(tmp_path):
    for side in SIDES:
        mod = SIDES[side][0]
        root = tmp_path / side
        for kwargs in ({"mode": "gke", "num_slices": 2}, {"mode": "tpu-vm"}):
            mod.write_tfvars(_config(SIDES[side], kwargs), root / "terraform")
        mod.write_ansible_configs(_config(SIDES[side], {"num_slices": 2}),
                                  [["34.1.1.1"], ["34.2.2.1"]], root / "ansible",
                                  coordinator_ip="10.0.0.1",
                                  internal_ips=[["10.0.0.1"], ["10.0.1.1"]],
                                  ansible_user="alice")
    files = {}
    for side in SIDES:
        root = tmp_path / side
        files[side] = {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                       if p.is_file() and "files" not in p.parts}
    assert {k: v.decode() for k, v in files["port"].items()} == port_names(
        {k: v.decode() for k, v in files["reference"].items()})
    staged = tmp_path / "port" / "ansible" / "roles" / "tpuhost" / "files"
    assert [p.name for p in staged.iterdir()] == [packaging.ARCHIVE_NAME]
    assert (staged / packaging.ARCHIVE_NAME).read_bytes() == packaging.build_archive_bytes()
