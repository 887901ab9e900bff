"""The GPU cluster plane (ROADMAP 7f) on the CPU, at small sizes: the
gke-gpu Job set (resources, node selector, the launcher's arguments for 1
and 2 slices x 1 and 2 hosts, cross-slice or not; the probe Job; the
user-workload Job) with no TPU or JAX string in any GPU document; the
smoke commands run here (the per-host one fails loudly without a card;
the cluster one, pointed at gloo and the CPU, forms a two-process group
under the launcher and counts it); the gpu-vm and gke-gpu readiness
parsers over canned gcloud and kubectl outputs; `join()` taking the
launcher's group under a GPU Job's env; `modes_with_state` and `-c` over
GPU state; and `cli.main --accelerator gpu` provisioning both modes
through the wizard in a stub world (sh stubs of terraform,
ansible-playbook, gcloud, ssh, ssh-keygen and kubectl on PATH), resuming
without the flag, healing a gpu-vm host VM that a maintenance event
stopped and supervising (with the autoscaler and the allocator) a gpu-vm
deployment, refusing both for gke-gpu as the reference refuses gke, and
tearing down. The slice-scoped terraform addresses, the per-slice listing
fold and the supervisor's listing signature are held on their own here;
tests/test_torch_heal.py and tests/test_torch_supervisor.py hold gpu-vm's
heal and supervisor against the reference's on a mirrored tpu-vm world."""

import io
import json
import os
import re
import shlex
import socket
import subprocess
import types
from pathlib import Path

import pytest
import yaml

from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.provision import heal as ref_heal
from tritonk8ssupervisor_tpu.provision import supervisor as ref_supervisor
from tritonk8ssupervisor_tpu.provision import terraform as ref_terraform
from tritonk8ssupervisor_tpu_torch import packaging
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.cli.io import Prompter
from tritonk8ssupervisor_tpu_torch.config import compile as cc
from tritonk8ssupervisor_tpu_torch.config import schema, store
from tritonk8ssupervisor_tpu_torch.parallel import distributed
from tritonk8ssupervisor_tpu_torch.provision import heal as heal_mod
from tritonk8ssupervisor_tpu_torch.provision import readiness, state, teardown
from tritonk8ssupervisor_tpu_torch.provision import supervisor as supervisor_mod
from tritonk8ssupervisor_tpu_torch.provision import terraform as terraform_mod

REPO = Path(__file__).resolve().parent.parent
# what no GPU document may name (the ConfigMap's base64 archive aside)
TPU_STRINGS = re.compile(r"jax|libtpu|JAX_|TPU_|google\.com/tpu|gke-tpu")


def gpu(**overrides) -> schema.ClusterConfig:
    base = dict(project="gpu-proj", zone="us-central1-a", generation="h100", topology="1x8",
                mode="gke-gpu")
    return schema.ClusterConfig(**{**base, **overrides})


def without_archive(doc):
    """A document with the ConfigMap's archive (random base64) left out."""
    if isinstance(doc, dict):
        return {k: without_archive(v) for k, v in doc.items() if k != "binaryData"}
    if isinstance(doc, list):
        return [without_archive(v) for v in doc]
    return doc


def container(job: dict) -> dict:
    return job["spec"]["template"]["spec"]["containers"][0]


# ----------------------------------------------------------------- the Jobs


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("cross", [None, False])
def test_the_gke_gpu_job_launches_the_port_under_the_launcher(slices, hosts, cross):
    config = gpu(topology=f"{hosts}x8", num_slices=slices)
    for i in range(slices):
        job = cc.to_benchmark_job(config, slice_index=i, workload="lm", cross_slice=cross,
                                  bench_flags=("--steps", "3"))
        c = container(job)
        spec = job["spec"]["template"]["spec"]
        assert (job["spec"]["completions"], job["spec"]["parallelism"]) == (hosts, hosts)
        assert job["spec"]["completionMode"] == "Indexed" and job["spec"]["backoffLimit"] == 0
        assert c["resources"] == {"requests": {"nvidia.com/gpu": "8"},
                                  "limits": {"nvidia.com/gpu": "8"}}
        assert spec["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert c["image"] == config.spec.job_image and "devel" in c["image"]
        assert spec["subdomain"] == "resnet50-bench-svc"
        assert {"name": "dshm", "emptyDir": {"medium": "Memory"}} in spec["volumes"]
        shell, flag, script = c["command"]
        install, run = script.split(" && ")
        assert (shell, flag) == ("bash", "-c")
        assert install == f"pip install --quiet /opt/tk8s-pkg/{packaging.ARCHIVE_NAME}"
        argv = shlex.split(run)
        one_world = cross is None and slices > 1
        nnodes = slices * hosts if one_world else hosts
        offset = i * hosts if one_world else 0
        job0 = "resnet50-bench-0" if slices > 1 and one_world else job["metadata"]["name"]
        assert argv == [
            "python", "-m", "torch.distributed.run", "--nnodes", str(nnodes),
            "--nproc-per-node", "8", "--node-rank",
            "$JOB_COMPLETION_INDEX" if offset == 0 else f"$((JOB_COMPLETION_INDEX+{offset}))",
            "--master-addr", f"{job0}-0.resnet50-bench-svc", "--master-port", "29500",
            "-m", "tritonk8ssupervisor_tpu_torch.benchmarks.lm", "--json", "--steps", "3"]
        env = {e["name"]: e["value"] for e in c["env"]}
        assert env == {"PET_NNODES": str(nnodes), "PET_NPROC_PER_NODE": "8",
                       "PET_MASTER_ADDR": f"{job0}-0.resnet50-bench-svc",
                       "PET_MASTER_PORT": "29500"}
        assert not TPU_STRINGS.search(json.dumps(job))


def test_the_gpu_job_options_follow_the_tpu_job_s():
    config = gpu(topology="2x8", num_slices=2)
    ckpt = cc.to_benchmark_job(config, slice_index=1, checkpoint_dir="gs://b/c/",
                               cross_slice=False)
    assert ckpt["spec"]["backoffLimit"] == 6
    assert container(ckpt)["command"][-1].endswith("--json --checkpoint-dir gs://b/c/slice-1")
    assert " gcsfs && " in container(ckpt)["command"][-1]
    custom = cc.to_benchmark_job(config, image="gcr.io/p/port:1")
    assert container(custom)["command"][-1].startswith("python -m torch.distributed.run ")
    assert "tk8s-pkg" not in json.dumps(custom)
    explicit = cc.to_benchmark_job(config, command=["python", "x.py"])
    assert container(explicit)["command"] == ["python", "x.py"]
    with pytest.raises(ValueError, match="not supported by the 'decode'"):
        cc.to_benchmark_job(config, workload="decode", checkpoint_dir="/c")
    vit = cc.to_benchmark_job(gpu(), workload="vit")
    assert "benchmarks.resnet50 --json --model vit" in container(vit)["command"][-1]


def test_the_gpu_probe_and_user_workload_jobs():
    config = gpu(topology="2x8", num_slices=3)
    probe = cc.to_probe_job(config)
    assert probe == cc.to_gpu_probe_job(config)
    assert probe["metadata"]["name"] == "gpu-probe"
    assert (probe["spec"]["completions"], probe["spec"]["parallelism"]) == (6, 6)
    c = container(probe)
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "8"}
    assert c["command"][-1] == (f"pip install --quiet /opt/tk8s-pkg/{packaging.ARCHIVE_NAME} && "
                                + cc.gpu_smoke_command(8))
    assert cc.to_probe_job(config, name="p2", image="img")["metadata"]["name"] == "p2"
    user = cc.to_user_workload_job(config, name="trainer", image="img", slice_index=2,
                                   command=["python", "-m", "torch.distributed.run", "-m", "t"],
                                   env={"HF_TOKEN": "x", "PET_NNODES": "1"})
    c = container(user)
    assert c["command"] == ["bash", "-c", 'export PET_NODE_RANK=$((JOB_COMPLETION_INDEX+4)); '
                            'exec "$@"', "--", "python", "-m", "torch.distributed.run", "-m", "t"]
    assert {e["name"]: e["value"] for e in c["env"]} == {
        "PET_NPROC_PER_NODE": "8", "PET_MASTER_ADDR": "trainer-0-0.trainer-svc",
        "PET_MASTER_PORT": "29500", "HF_TOKEN": "x", "PET_NNODES": "1"}
    for doc in (probe, user):
        assert not TPU_STRINGS.search(json.dumps(doc))


def test_write_manifests_writes_the_gpu_job_set(tmp_path):
    config = gpu(topology="2x8", num_slices=2)
    paths = cc.write_manifests(config, tmp_path, workload="lm", workload_image="img",
                               workload_command=["python", "t.py"], workload_name="trainer")
    assert [p.name for p in paths] == [
        "package-configmap.yaml", "bench-service.yaml", "bench-job-0.yaml", "bench-job-1.yaml",
        "workload-service.yaml", "workload-job-0.yaml", "workload-job-1.yaml"]
    docs = {p.name: yaml.safe_load(p.read_text()) for p in paths}
    assert docs["bench-service.yaml"]["spec"] == {
        "clusterIP": "None", "selector": {"app": "resnet50-bench"},
        "ports": [{"port": 29500, "name": "torch-rendezvous"}]}
    assert docs["workload-service.yaml"]["metadata"]["name"] == "trainer-svc"
    assert not TPU_STRINGS.search(json.dumps(without_archive(docs)))
    import base64
    blob = docs["package-configmap.yaml"]["binaryData"][packaging.ARCHIVE_NAME]
    assert base64.b64decode(blob) == packaging.build_archive_bytes()


@pytest.mark.parametrize("mode", schema.GPU_MODES)
def test_no_gpu_document_names_a_tpu_or_jax(tmp_path, mode):
    config = gpu(mode=mode, topology="2x8", num_slices=2)
    cc.write_tfvars(config, tmp_path / "terraform")
    cc.write_ansible_configs(config, [["34.0.0.1", "34.0.0.2"], ["34.0.1.1", "34.0.1.2"]],
                             tmp_path / "ansible", coordinator_ip="10.0.0.1",
                             internal_ips=[["10.0.0.1", "10.0.0.2"], ["10.0.1.1", "10.0.1.2"]])
    written = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*")
                     if p.is_file())
    assert written == ["ansible/group_vars/all.yml", "ansible/hosts",
                       f"ansible/roles/gpuhost/files/{packaging.ARCHIVE_NAME}",
                       f"terraform/{mode}/terraform.tfvars.json"]
    for rel in written[:2] + written[3:]:
        assert not TPU_STRINGS.search((tmp_path / rel).read_text()), rel
    vars_ = yaml.safe_load((tmp_path / "ansible/group_vars/all.yml").read_text())
    assert vars_["expected_total_gpus"] == 32 and vars_["gpu_smoke_cmd"] == cc.gpu_smoke_command(8)
    assert vars_["cluster_smoke_cmd"] == cc.gpu_cluster_smoke_command(
        32, "{{ node_rank }}", nnodes=4, gpus_per_node=8, master_addr="{{ global_coordinator }}")


# ---------------------------------------------------- the smoke commands run


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("PET_", "JAX_COORD"))}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return env


def test_the_gpu_smoke_fails_loudly_without_a_card():
    out = subprocess.run(["bash", "-c", cc.gpu_smoke_command(1)], capture_output=True, text=True,
                         env=_port_env(), timeout=120)
    assert out.returncode != 0 and "GPU OK" not in out.stdout
    assert "AssertionError: expected 1 CUDA devices, saw 0" in out.stderr


def _cluster_smoke_on_cpu(expected: int) -> subprocess.CompletedProcess:
    """The cluster smoke of a one-host deployment of two GPUs, pointed at
    gloo and the CPU (NCCL and the card are the only substitutions)."""
    command = cc.gpu_cluster_smoke_command(expected, 0, nnodes=1, gpus_per_node=2,
                                           master_addr="127.0.0.1", master_port=_free_port(),
                                           timeout_s=100)
    on_cpu = (command.replace("torch.cuda.set_device(local); ", "")
              .replace("'nccl'", "'gloo'").replace("device='cuda'", "device='cpu'"))
    assert on_cpu.count("gloo") == 1 and "cuda" not in on_cpu.split("-c", 1)[1]
    return subprocess.run(["bash", "-c", on_cpu], capture_output=True, text=True,
                          env=_port_env(), timeout=150)


def test_the_cluster_smoke_counts_its_launcher_group():
    """The launcher starts both workers, the all-reduce counts them, one
    line a host; a deployment of 16 that forms a group of 2 fails."""
    out = _cluster_smoke_on_cpu(2)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == ["CLUSTER OK: 2 processes, 2 GPUs"]
    bad = _cluster_smoke_on_cpu(16)
    assert bad.returncode != 0 and "expected 16 cluster GPUs, saw 2" in bad.stderr


# ------------------------------------------------------------ the launcher


def test_join_takes_the_launcher_s_group_under_a_gpu_job_s_env(monkeypatch, tmp_path):
    job = cc.to_benchmark_job(gpu(topology="2x8", num_slices=2), slice_index=1)
    job_env = {e["name"]: e["value"] for e in container(job)["env"]}
    # what the launcher adds for each worker
    launcher = {"WORLD_SIZE": "32", "RANK": "17", "LOCAL_RANK": "1", "MASTER_ADDR": "m",
                "MASTER_PORT": "29500"}
    assert distributed.cluster_env(environ={**job_env, **launcher},
                                   env_file=tmp_path / "absent.env") is None
    calls = []
    monkeypatch.setattr(distributed, "ENV_FILE", tmp_path / "absent.env")
    monkeypatch.setattr(distributed, "initialize_from_env", lambda **k: calls.append("env"))
    monkeypatch.setattr(distributed, "init_from_launcher",
                        lambda device=None: calls.append(("launcher", device)) or True)
    for name in list(os.environ):
        if name.startswith(("JAX_", "TK8S_")):
            monkeypatch.delenv(name)
    for name, value in {**job_env, **launcher}.items():
        monkeypatch.setenv(name, value)
    assert distributed.join(device="cpu") is True
    assert calls == [("launcher", "cpu")]


# ---------------------------------------------------------------- readiness


def canned(text: str):
    return lambda args, **kwargs: text


def test_the_gpu_vm_readiness_parsers():
    config = gpu(mode="gpu-vm", topology="2x8", num_slices=2, node_prefix="g")
    calls = []

    def listing(args, **kwargs):
        calls.append(args)
        return "g-0-0\tRUNNING\ng-0-1\tSTAGING\nprojects/p/zones/z/instances/g-1-0\tRUNNING\ng-9\n"

    states = readiness.gpu_vm_states(config, listing)
    assert states == {"g-0-0": "RUNNING", "g-0-1": "STAGING", "g-1-0": "RUNNING",
                      "g-9": "UNKNOWN"}
    assert calls[0] == ["gcloud", "compute", "instances", "list", "--zones=us-central1-a",
                        "--format=value(name,status)", "--filter=name~^g-"]
    readiness.gpu_vm_states(config, listing, names=["g-1-0", "g-1-1"])
    assert calls[1][-2:] == ["--filter=name:(g-1-0 g-1-1)", "--page-size=2"]
    assert readiness.gpu_vm_probe(config, readiness.gpu_vm_names(config, [0]), listing) == (
        "host VM(s) not running: g-0-1 is STAGING")
    assert readiness.gpu_vm_probe(config, readiness.gpu_vm_names(config, [1]), listing) == (
        "host VM(s) not running: g-1-1 is CREATING")
    assert readiness.gpu_vm_probe(config, ["g-0-0", "g-1-0"], listing) == ""
    # the batched snapshot pages by slices, each page naming its hosts
    snap = readiness.FleetSnapshot(config, run_quiet=listing, page_size=1, clock=lambda: 0.0)
    assert snap.page_count == 2
    assert snap.states() == {"g-0-0": "RUNNING", "g-0-1": "STAGING", "g-1-0": "RUNNING"}
    assert calls[-1][-2:] == ["--filter=name:(g-1-0 g-1-1)", "--page-size=2"]
    assert snap.parked_slices(now=0.0) == set()


def _nodes(*allocatable, ready=True) -> str:
    return json.dumps({"items": [
        {"metadata": {"name": f"n{i}"},
         "status": {"allocatable": ({"nvidia.com/gpu": a} if a is not None else {"cpu": "8"}),
                    "conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}
        for i, a in enumerate(allocatable)]})


def test_the_gke_gpu_readiness_parser():
    config = gpu(topology="2x8", num_slices=1)
    assert readiness.gke_gpu_probe(config, canned(_nodes("8", None))) == (
        "1/2 GPU nodes registered")
    assert readiness.gke_gpu_probe(config, canned(_nodes("8", "0"))) == "8/16 GPUs allocatable"
    assert readiness.gke_gpu_probe(config, canned(_nodes("8", "8", ready=False))) == (
        "nodes not Ready: n0, n1")
    assert readiness.gke_gpu_probe(config, canned(_nodes("8", "8", None))) == ""
    assert readiness.gke_tpu_probe(config, canned(_nodes("8", "8"))).startswith("0/")


def test_run_probe_job_applies_the_package_then_the_gpu_probe(tmp_path):
    calls = []
    done = json.dumps({"metadata": {"name": "gpu-probe"}, "spec": {"completions": 2},
                       "status": {"conditions": [{"type": "Complete", "status": "True"}]}})
    readiness.run_probe_job(gpu(topology="2x8"), tmp_path, run=lambda a, **k: calls.append(a),
                            run_quiet=lambda a, **k: calls.append(a) or done, sleep=lambda s: 0)
    assert calls == [["kubectl", "apply", "-f", str(tmp_path / "package-configmap.yaml")],
                     ["kubectl", "apply", "-f", str(tmp_path / "gpu-probe.yaml")],
                     ["kubectl", "get", "job", "gpu-probe", "-o", "json"],
                     ["kubectl", "delete", "-f", str(tmp_path / "gpu-probe.yaml"),
                      "--ignore-not-found"]]
    failed = json.dumps({"metadata": {"name": "gpu-probe"}, "status": {"conditions": [
        {"type": "Failed", "status": "True"}]}})
    with pytest.raises(readiness.ProbeFailed, match="see kubectl logs job/gpu-probe"):
        readiness.run_probe_job(gpu(), tmp_path, run=lambda a, **k: None,
                                run_quiet=lambda a, **k: failed, sleep=lambda s: 0)


# ------------------------------------------------------- state and teardown


def test_teardown_destroys_every_gpu_module_with_state(tmp_path):
    paths = state.RunPaths(tmp_path)
    for mode in schema.ALL_MODES:
        paths.terraform_module(mode).mkdir(parents=True)
    for mode in ("gke-gpu", "gpu-vm"):
        paths.tfstate(mode).write_text(json.dumps({"resources": [{"type": "x"}]}))
        paths.tfvars(mode).write_text("{}")
    (paths.ansible_dir / "roles" / "gpuhost" / "files").mkdir(parents=True)
    (paths.ansible_dir / "roles" / "gpuhost" / "files" / "a.tar.gz").write_text("x")
    assert terraform_mod.modes_with_state(paths) == ["gke-gpu", "gpu-vm"]
    config = gpu(mode="gpu-vm")
    store.save_config_file(config, paths.config_file)
    calls, said = [], []
    prompter = types.SimpleNamespace(say=said.append, confirm=lambda q: True)
    assert teardown.clean(config, paths, prompter, run=lambda a, **k: calls.append(
        (a[:2], Path(k["cwd"]).name) if "cwd" in k else (a[:2], None)), assume_yes=True)
    assert calls == [(["terraform", "destroy"], "gke-gpu"), (["terraform", "destroy"], "gpu-vm")]
    assert terraform_mod.modes_with_state(paths) == []
    assert not [p for m in schema.ALL_MODES for p in paths.terraform_module(m).glob("terraform.*")]
    assert not (paths.ansible_dir / "roles" / "gpuhost" / "files").exists()
    assert not paths.config_file.exists()


def ref_gke_refusals(tmp_path) -> list:
    """The reference's heal and supervisor refusals of a gke config."""
    config = ref_schema.ClusterConfig(project="p", zone="us-west4-a", generation="v5e",
                                      topology="2x2", mode="gke")
    paths = state.RunPaths(tmp_path / "reference")
    out = []
    for refuse in (lambda: ref_heal.heal(config, paths, types.SimpleNamespace(say=print)),
                   lambda: ref_supervisor.Supervisor(config, paths,
                                                     types.SimpleNamespace(say=print))):
        with pytest.raises(ref_schema.ConfigError) as e:
            refuse()
        out.append(str(e.value))
    return out


class GpuFleet:
    """A gpu-vm fleet of healthy host VMs for `run_quiet`: the listing
    from `status` ({host name: status}), every SSH probe answered."""

    def __init__(self, config):
        self.status = {n: "RUNNING" for n in readiness.gpu_vm_names(config)}
        self.calls = []

    def run_quiet(self, args, cwd=None, **kwargs):
        self.calls.append(" ".join(map(str, args)))
        if args[:4] == ["gcloud", "compute", "instances", "list"]:
            return "\n".join(f"{n}\t{s}" for n, s in self.status.items())
        return ""


@pytest.mark.parametrize("mode", schema.GPU_MODES)
def test_heal_and_supervise_refuse_a_gpu_config(tmp_path, mode):
    """gke-gpu's node pools self-repair: heal and the supervisor refuse it
    with the reference's gke messages, word for word. gpu-vm is served:
    a healthy fleet heals to a no-op and a supervisor tick finds it
    healthy."""
    paths = state.RunPaths(tmp_path / "port")
    config = gpu(mode=mode, topology="2x8", num_slices=2, node_prefix="gpunode")
    if mode == "gke-gpu":
        got = []
        for refuse in (lambda: heal_mod.heal(config, paths, types.SimpleNamespace(say=print)),
                       lambda: supervisor_mod.Supervisor(config, paths,
                                                         types.SimpleNamespace(say=print))):
            with pytest.raises(schema.ConfigError) as e:
                refuse()
            got.append(str(e.value))
        assert got == ref_gke_refusals(tmp_path)
        # phase 36 of chip_smoke.py holds the CLI's gke-gpu heal to this message
        import sys

        if str(REPO) not in sys.path:
            sys.path.insert(0, str(REPO))
        import chip_smoke

        assert got[0] == chip_smoke.GKE_HEAL_REFUSAL
        return
    state.ClusterHosts(host_ips=[["34.0.0.1", "34.0.0.2"], ["34.0.1.1", "34.0.1.2"]],
                       internal_ips=[["10.0.0.1", "10.0.0.2"], ["10.0.1.1", "10.0.1.2"]],
                       coordinator_ip="10.0.0.1").save(paths.hosts_file)
    fleet, said = GpuFleet(config), []
    prompter = types.SimpleNamespace(say=said.append)
    assert heal_mod.heal(config, paths, prompter, run_quiet=fleet.run_quiet)
    assert said[-1] == "Fleet healthy; nothing to heal."
    sup = supervisor_mod.Supervisor(config, paths, prompter, run_quiet=fleet.run_quiet)
    assert sup.tick()["states"] == {"0": "healthy", "1": "healthy"}
    assert fleet.calls[0] == ("gcloud compute instances list --zones=us-central1-a "
                              "--format=value(name,status) --filter=name~^gpunode-")
    assert not TPU_STRINGS.search("\n".join(said + fleet.calls))


@pytest.mark.parametrize("indices", [[], [0], [1], [2, 0, 2], [5, 1, 3, 1], [8, 7]])
def test_tpu_vm_slice_addresses_equal_the_reference_s(indices):
    ours = [terraform_mod.slice_replace_addresses(indices),
            terraform_mod.slice_target_addresses(indices),
            terraform_mod.slice_replace_addresses(indices, "tpu-vm", 4),
            terraform_mod.slice_target_addresses(indices, "tpu-vm", 4)]
    ref = [ref_terraform.slice_replace_addresses(indices),
           ref_terraform.slice_target_addresses(indices)] * 2
    assert ours == ref


@pytest.mark.parametrize("topology", ["1x8", "2x8", "4x8"])
@pytest.mark.parametrize("indices", [[0], [1], [2, 0, 2], [3, 1, 3, 0]])
def test_gpu_vm_slice_addresses_are_every_host_of_each_slice(topology, indices):
    config = gpu(mode="gpu-vm", topology=topology, num_slices=4)
    hosts = config.hosts_per_slice
    slices = sorted(set(indices))
    want = [s * hosts + h for s in slices for h in range(hosts)]
    for kind, fn in (("replace", terraform_mod.slice_replace_addresses),
                     ("target", terraform_mod.slice_target_addresses)):
        got = fn(indices, "gpu-vm", hosts)
        assert got == [f"-{kind}=google_compute_instance.host[{k}]" for k in want]
        assert len(set(got)) == len(got) == hosts * len(slices)
    # host k of the module's fan-out is the VM gpu_vm_names lists k-th
    names = readiness.gpu_vm_names(config)
    assert [names[k] for k in want] == readiness.gpu_vm_names(config, slices)
    assert [f"{config.node_prefix}-{k // hosts}-{k % hosts}" for k in want] == \
        readiness.gpu_vm_names(config, slices)


# a tpu-vm slice's listed state, and its gpu-vm mirror: {host: status}, a
# host left out being absent from the listing
MIRRORED_LISTINGS = {
    "ready": ("READY", {0: "RUNNING", 1: "RUNNING"}, readiness.LISTED),
    "absent": (None, {0: "RUNNING"}, readiness.ABSENT),
    "every host absent": (None, {}, readiness.ABSENT),
    "preempted": ("PREEMPTED", {0: "RUNNING", 1: "TERMINATED"}, readiness.NOT_READY),
    "creating": ("CREATING", {0: "STAGING", 1: "RUNNING"}, readiness.NOT_READY),
    "absent and stopped": (None, {0: "TERMINATED"}, readiness.ABSENT),
}


@pytest.mark.parametrize("case", sorted(MIRRORED_LISTINGS))
def test_the_listing_fold_gives_mirrored_states_one_verdict(case):
    tpu_state, hosts, verdict = MIRRORED_LISTINGS[case]
    tpu_config = schema.ClusterConfig(project="p", zone="us-west4-a", generation="v5e",
                                      topology="4x4", mode="tpu-vm", num_slices=2)
    gpu_config = gpu(mode="gpu-vm", topology="2x8", num_slices=2, node_prefix="gpunode")
    tpu_listing = {"tpunode-0": "READY"}
    gpu_listing = {"gpunode-0-0": "RUNNING", "gpunode-0-1": "RUNNING"}
    if tpu_state is not None:
        tpu_listing["tpunode-1"] = tpu_state
    gpu_listing.update({f"gpunode-1-{h}": s for h, s in hosts.items()})
    tpu = readiness.fold_listing(tpu_config, tpu_listing, [0, 1])
    ours = readiness.fold_listing(gpu_config, gpu_listing, [0, 1])
    assert tpu[0].state == ours[0].state == readiness.LISTED
    assert tpu[1].state == ours[1].state == verdict
    detail = ours[1].detail
    assert not TPU_STRINGS.search(detail) and "TPU" not in detail
    if verdict == readiness.ABSENT:
        absent = [f"gpunode-1-{h}" for h in range(2) if h not in hosts]
        assert detail == "absent from the Compute Engine listing: " + ", ".join(absent)
    elif verdict == readiness.NOT_READY:
        stopped = ", ".join(f"gpunode-1-{h} {s}" for h, s in hosts.items() if s != "RUNNING")
        assert detail == f"host VM status {stopped} (want RUNNING)"
    # the reference's diagnosis of the tpu-vm listing: the same slice state
    assert tpu[1].detail == {readiness.LISTED: "", readiness.ABSENT:
                             "absent from the Cloud TPU listing",
                             readiness.NOT_READY: f"TPU state {tpu_state}"}[verdict]


def test_one_gpu_vm_host_s_status_dirties_only_its_slice(tmp_path):
    config = gpu(mode="gpu-vm", topology="2x8", num_slices=4, node_prefix="gpunode")
    paths = state.RunPaths(tmp_path)
    state.ClusterHosts(host_ips=[[f"34.0.{i}.1", f"34.0.{i}.2"] for i in range(4)],
                       internal_ips=[[f"10.0.{i}.1", f"10.0.{i}.2"] for i in range(4)],
                       coordinator_ip="10.0.0.1").save(paths.hosts_file)
    fleet = GpuFleet(config)
    sup = supervisor_mod.Supervisor(
        config, paths, types.SimpleNamespace(say=lambda line: None), run_quiet=fleet.run_quiet,
        policy=supervisor_mod.SupervisePolicy(interval=0.0, sweep_slices=1))
    sup.tick()  # every slice diagnosed healthy, every signature recorded

    def dirty():
        sup.snapshot.invalidate()
        sweep = sorted(sup._active)[sup._sweep_cursor % 4]
        return sup._dirty_set(), sweep

    got, sweep = dirty()
    assert got == [sweep]  # an unchanged listing: the sweep's one slice
    fleet.status["gpunode-2-1"] = "TERMINATED"
    got, sweep = dirty()
    assert got == sorted({2, sweep})
    assert sup._listing_sig[2] == "RUNNING TERMINATED"
    assert {i: v for i, v in sup._listing_sig.items() if i != 2} == {
        i: "RUNNING RUNNING" for i in (0, 1, 3)}
    got, sweep = dirty()  # the same listing again: nothing changed since
    assert got == [sweep]


# ------------------------------------------------- the CLI in a stub world

STUBS = {
    "terraform": """#!/bin/sh
echo "terraform $*" >> "$CALLS_LOG"
case "$1" in
  apply) echo '{"resources": [{"type": "gpu"}]}' > terraform.tfstate ;;
  output) echo '{"host_ips": {"value": [["34.0.0.1", "34.0.0.2"]]}, "internal_ips": {"value": [["10.0.0.1", "10.0.0.2"]]}}' ;;
  destroy) rm -f terraform.tfstate ;;
esac
""",
    "gcloud": """#!/bin/sh
echo "gcloud $*" >> "$CALLS_LOG"
case "$*" in
  "config get-value project") echo stub-proj ;;
  "config get-value account") echo me@stub.test ;;
  *"accelerator-types list"*) printf 'us-east5-a\\nus-central1-c\\n' ;;
  *"instances list"*) printf "${GPU_LISTING:-gpunode-0-0\\tRUNNING\\ngpunode-0-1\\tRUNNING\\n}" ;;
esac
""",
    "kubectl": """#!/bin/sh
echo "kubectl $*" >> "$CALLS_LOG"
case "$*" in
  "get job gpu-probe -o json")
    echo '{"spec": {"completions": 2}, "status": {"conditions": [{"type": "Complete", "status": "True"}]}}' ;;
  *)
    echo '{"items": [{"metadata": {"name": "n1"}, "status": {"allocatable": {"nvidia.com/gpu": "8"}, "conditions": [{"type": "Ready", "status": "True"}]}}, {"metadata": {"name": "n2"}, "status": {"allocatable": {"nvidia.com/gpu": "8"}, "conditions": [{"type": "Ready", "status": "True"}]}}]}' ;;
esac
""",
    **{name: f'#!/bin/sh\necho "{name} $*" >> "$CALLS_LOG"\n'
       for name in ("ansible-playbook", "ssh", "ssh-keygen")},
}
# project, env name, env description, cluster name, node prefix, mode, family,
# topology (5: 2x8), slices, zone (the live listing's second: us-east5-a), network,
# subnetwork; then yes at the gate
ANSWERS = {"gke-gpu": ["", "", "", "", "", "1", "", "5", "", "2", "", "", "yes"],
           "gpu-vm": ["", "", "", "", "", "2", "", "5", "", "2", "", "", "yes"]}


@pytest.fixture
def world(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in STUBS.items():
        (bin_dir / name).write_text(body)
        (bin_dir / name).chmod(0o755)
    (tmp_path / "home" / ".ssh").mkdir(parents=True)
    (tmp_path / "home" / ".ssh" / "id_rsa").write_text("fake-key\n")
    work = tmp_path / "repo"
    (work / "ansible").mkdir(parents=True)
    (work / "ansible" / "ansible.cfg").write_text("[defaults]\nprivate_key_file =\n")
    for name in list(os.environ):
        if name.startswith(("TK8S_", "BENCH_IMAGE", "TF_PLUGIN_CACHE_DIR")):
            monkeypatch.delenv(name)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("CALLS_LOG", str(tmp_path / "calls.log"))
    monkeypatch.setenv("TK8S_SSH_USER", "tester")
    monkeypatch.setenv("TK8S_RETRY_BASE_DELAY", "0.01")
    monkeypatch.setenv("TK8S_RETRY_MAX_DELAY", "0.02")
    monkeypatch.setenv("TK8S_SCHED_WORKERS", "1")
    calls_log = tmp_path / "calls.log"

    def run(argv, answers=()):
        calls_log.write_text("")
        out = io.StringIO()
        prompter = Prompter(io.StringIO("".join(f"{a}\n" for a in answers)), out)
        rc = cli.main([*argv, "--workdir", str(work)], prompter)
        calls = [c for c in calls_log.read_text().splitlines()
                 if not c.startswith("gcloud config") and "auth list" not in c]
        return rc, out.getvalue(), calls

    return types.SimpleNamespace(run=run, work=work, paths=state.RunPaths(work))


def heal_and_supervise_gpu_vm(world, monkeypatch, capsys):
    """The provisioned gpu-vm deployment: a heal of a healthy fleet is a
    no-op; host 0 of slice 0 stopped by a maintenance event (TERMINATED)
    is healed by replacing the slice's two host VMs and reconverging
    them; supervise ticks over the restored fleet, alone and with the
    autoscaler or the allocator."""
    capsys.readouterr()
    rc, out, calls = world.run(["heal"])
    assert rc == 0 and "Fleet healthy; nothing to heal." in out, out
    assert not [c for c in calls if c.startswith(("terraform", "ansible"))]
    monkeypatch.setenv("GPU_LISTING", "gpunode-0-0\\tTERMINATED\\ngpunode-0-1\\tRUNNING\\n")
    rc, out, calls = world.run(["heal"])
    err = capsys.readouterr().err
    assert rc == 0, out + err
    assert ("slice 0: unready (host VM status gpunode-0-0 TERMINATED (want RUNNING))" in out
            and "Healed slice(s) 0; fleet fully healthy." in out)
    assert [c for c in calls if c.startswith(("terraform", "ansible"))] == [
        "terraform init -input=false -no-color",  # the stub leaves no .terraform/
        "terraform apply -auto-approve -input=false -no-color -lock-timeout=600s "
        "-replace=google_compute_instance.host[0] -replace=google_compute_instance.host[1]",
        "terraform output -json",
        "ansible-playbook -i hosts clusterUpGpu.yml --limit 34.0.0.1,34.0.0.2"]
    assert not TPU_STRINGS.search(out + err) and "TPU" not in out + err
    vars_ = yaml.safe_load((world.paths.ansible_dir / "group_vars" / "all.yml").read_text())
    config = store.load_config_file(world.paths.config_file)
    assert vars_ == cc.to_ansible_vars(config, coordinator_ip="10.0.0.1")
    monkeypatch.delenv("GPU_LISTING")
    for flags in ([], ["--autoscale"], ["--allocate"]):
        rc, out, _ = world.run(["supervise", "--ticks", "1", "--interval", "0", *flags])
        err = capsys.readouterr().err
        assert rc == 0, out + err
        doc = json.loads(world.paths.fleet_status.read_text())
        assert doc["verdict"] == "healthy" and doc["slice_states"] == {"healthy": 1}, doc
        assert not TPU_STRINGS.search(out + err) and "TPU" not in out + err


@pytest.mark.parametrize("mode", schema.GPU_MODES)
def test_accelerator_gpu_provisions_resumes_refuses_heal_and_cleans(world, mode, capsys,
                                                                    monkeypatch):
    flags = ["--accelerator", "gpu", "--bench-workload", "lm"]
    if mode == "gke-gpu":
        flags.append("--probe")
    rc, out, calls = world.run(flags, ANSWERS[mode])
    assert rc == 0, out + capsys.readouterr().err
    config = store.load_config_file(world.paths.config_file)
    assert (config.mode, config.generation, config.topology, config.zone, config.node_prefix,
            config.cluster_name) == (mode, "h100", "2x8", "us-east5-a", "gpunode", "gpu-dev")
    assert " H100 GPU Kubernetes cluster setup" in out and "Cluster is ready." in out
    assert "  Total GPUs               16" in out
    tfvars = json.loads(world.paths.tfvars(mode).read_text())
    assert tfvars == cc.to_tfvars(config)
    assert [c for c in calls if c.startswith("terraform")] == [
        "terraform init -input=false -no-color", "terraform apply -auto-approve -input=false "
        "-no-color", "terraform output -json"]
    vars_ = yaml.safe_load((world.paths.ansible_dir / "group_vars" / "all.yml").read_text())
    assert vars_ == cc.to_ansible_vars(config, coordinator_ip="10.0.0.1" if mode == "gpu-vm"
                                       else "")
    job = yaml.safe_load((world.paths.manifests_dir / "bench-job-0.yaml").read_text())
    assert "--nnodes 2 --nproc-per-node 8" in container(job)["command"][-1]
    if mode == "gke-gpu":
        assert "ansible-playbook -i hosts clusterUpGpu.yml" in calls
        assert "kubectl get nodes -o json" in calls
        assert f"kubectl apply -f {world.paths.probe_dir / 'gpu-probe.yaml'}" in calls
        assert "  Job runs:   python -m torch.distributed.run --nnodes 2" in out
    else:
        assert "ansible-playbook -i hosts clusterUpGpu.yml --limit 34.0.0.1,34.0.0.2" in calls
        assert any(c.startswith("gcloud compute instances list") for c in calls)
        assert sum(c.startswith("ssh ") for c in calls) == 2
        assert "[GPUHOST]" in world.paths.inventory.read_text()
        assert "  Benchmark: python3 -m torch.distributed.run --nnodes 2" in out
    staged = world.paths.ansible_dir / "roles"
    assert [p.relative_to(staged).as_posix() for p in staged.rglob("*.tar.gz")] == [
        f"gpuhost/files/{packaging.ARCHIVE_NAME}"]

    # the saved GPU config resumes without the flag, every task journal-verified
    rc, out, calls = world.run([], ["yes"])
    assert rc == 0 and "Previous run detected" in out
    assert not [c for c in calls if not c.startswith(("gcloud", "kubectl"))]

    if mode == "gke-gpu":  # its node pools self-repair: refused as the reference refuses gke
        for command, message in zip(("heal", "supervise"), ref_gke_refusals(world.work.parent)):
            rc, _, _ = world.run([command, "--ticks", "1"] if command == "supervise"
                                 else [command])
            assert rc == 1 and capsys.readouterr().err.endswith(f"ERROR: {message}\n")
    else:
        heal_and_supervise_gpu_vm(world, monkeypatch, capsys)

    rc, out, calls = world.run(["-c", "--yes"])
    assert rc == 0 and "GPU host" in out if mode == "gpu-vm" else rc == 0
    assert calls[0] == "terraform destroy -auto-approve -input=false -no-color"
    assert terraform_mod.modes_with_state(world.paths) == []
    assert not world.paths.config_file.exists() and not world.paths.manifests_dir.exists()
    assert not list(staged.rglob("*.tar.gz"))
