"""`cli.main`'s default path (provision) and `--show-config` of the port
against the reference's, in twin stub worlds (the recipe of
tests/test_main_e2e.py's `fake_world`): `terraform`, `ansible-playbook`,
`gcloud`, `ssh`, `ssh-keygen` and `kubectl` as `sh` scripts on a PATH of
each side's own, logging their calls; one fake HOME with an SSH key; a
workdir with the terraform and ansible layout. Both packages run the same
argv and the same scripted answers, and give equal exit codes, printed
lines, stub calls and state: the config, `terraform/hosts.json`, the
ansible inventory and vars, the compiled manifests and the parsed journal
and runlog records.

The cases of tests/test_main_e2e.py that provision: tpu-vm then clean,
gke, resume, a warm rerun without the journal, a config change, the
kill/resume drill, `--show-config`, `--probe`, an explicit `--config` over
a saved one, a missing terraform, the checkpoint dir, the bench workload
and flags, `--resize` up and down, and a resize without a run; also a
provision through the wizard, an interrupt (130 and the resume hint) and
an input that runs out (1). The DAG runs one task at a time
(`TK8S_SCHED_WORKERS=1`), so transcripts and calls compare in order;
discovery's `gcloud` calls and readiness's `ssh` probes of a slice's
hosts run concurrently and compare as a multiset.
One case runs the DAG 8 wide and compares only the state it leaves.

Differences by design, set aside: wall-clock stamps and durations; each
side's root; the package's name where it is written (the reference's
`tritonk8ssupervisor_tpu` reads `tritonk8ssupervisor_tpu_torch`, as in
tests/test_torch_compile.py); the ConfigMap's archive (the port's decodes
to the port's archive) and the archive staged into the ansible role; the
warm cache's keys and the journal's artifact digests, which hash those
files. No tolerance."""

import base64
import io
import json
import os
import re
import sys
import types

import pytest
import yaml

from tritonk8ssupervisor_tpu.cli import io as ref_io
from tritonk8ssupervisor_tpu.cli import main as ref_cli
from tritonk8ssupervisor_tpu.config import store as ref_store
from tritonk8ssupervisor_tpu.provision import state as ref_state
from tritonk8ssupervisor_tpu.testing import faults as ref_faults
from tritonk8ssupervisor_tpu_torch import packaging
from tritonk8ssupervisor_tpu_torch.cli import io as cli_io
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.config import store
from tritonk8ssupervisor_tpu_torch.provision import state
from tritonk8ssupervisor_tpu_torch.testing import faults

# autouse: the reference compiles the port's TPU cluster smoke, the one
# string the compilers differ in by design (F9, tests/test_torch_compile.py)
from test_torch_compile import port_cluster_smoke  # noqa: E402,F401

SIDES = {
    "port": types.SimpleNamespace(cli=cli, io=cli_io, store=store, state=state,
                                  faults=faults),
    "reference": types.SimpleNamespace(cli=ref_cli, io=ref_io, store=ref_store,
                                       state=ref_state, faults=ref_faults),
}

STUBS = {
    "terraform": """#!/bin/sh
echo "terraform $*" >> "$CALLS_LOG"
case "$1" in
  init) ;;
  apply) echo '{"resources": [{"type": "google_tpu_v2_vm"}]}' > terraform.tfstate ;;
  output) echo '{"host_ips": {"value": [["10.0.0.1", "10.0.0.2"]]}}' ;;
  destroy) rm -f terraform.tfstate ;;
esac
""",
    "ansible-playbook": '#!/bin/sh\necho "ansible-playbook $*" >> "$CALLS_LOG"\n',
    "gcloud": """#!/bin/sh
echo "gcloud $*" >> "$CALLS_LOG"
case "$*" in
  "config get-value project") echo stub-proj ;;
  "config get-value account") echo me@stub.test ;;
  "config get-value compute/zone") echo "" ;;
  *"tpu-vm list"*) for i in 0 1 2 3; do printf 'tpunode-%s\\tREADY\\n' "$i"; done ;;
  *describe*) echo READY ;;
esac
""",
    "ssh-keygen": '#!/bin/sh\necho "ssh-keygen $*" >> "$CALLS_LOG"\n',
    "ssh": '#!/bin/sh\necho "ssh $*" >> "$CALLS_LOG"\n',
    "kubectl": """#!/bin/sh
echo "kubectl $*" >> "$CALLS_LOG"
case "$*" in
  "get job tpu-probe -o json")
    echo '{"spec": {"completions": 1}, "status": {"conditions": [{"type": "Complete", "status": "True"}]}}' ;;
  *)
    echo '{"items": [{"metadata": {"name": "n1"}, "status": {"allocatable": {"google.com/tpu": "4"}, "conditions": [{"type": "Ready", "status": "True"}]}}]}' ;;
esac
""",
}


@pytest.fixture
def world(tmp_path, monkeypatch):
    """Both sides' stub worlds under tmp_path/<side>, one HOME, and the
    environment of a deterministic run."""
    home = tmp_path / "home"
    (home / ".ssh").mkdir(parents=True)
    (home / ".ssh" / "id_rsa").write_text("fake-key\n")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("TK8S_SSH_USER", "tester")
    monkeypatch.setenv("TK8S_SCHED_WORKERS", "1")
    monkeypatch.setenv("TK8S_RETRY_BASE_DELAY", "0.01")
    monkeypatch.setenv("TK8S_RETRY_MAX_DELAY", "0.02")
    for name in list(os.environ):
        if name.startswith(("TK8S_FAULT_PLAN", "TK8S_BENCH_", "TK8S_CHECKPOINT_DIR",
                            "BENCH_IMAGE", "TF_PLUGIN_CACHE_DIR")):
            monkeypatch.delenv(name)
    for side in SIDES:
        root = tmp_path / side
        work = root / "repo"
        for sub in ("terraform/tpu-vm", "terraform/gke", "ansible"):
            (work / sub).mkdir(parents=True)
        (work / "ansible" / "ansible.cfg").write_text(
            "[defaults]\nhost_key_checking = False\nprivate_key_file =\n")
        (work / "ansible" / "clusterUp.yml").write_text("[]\n")
        bin_dir = root / "bin"
        bin_dir.mkdir()
        for name, body in STUBS.items():
            (bin_dir / name).write_text(body)
            (bin_dir / name).chmod(0o755)
    return types.SimpleNamespace(tmp=tmp_path, monkeypatch=monkeypatch,
                                 path=os.environ["PATH"])


def saved_config(work, **overrides):
    lines = {"PROJECT": "file-proj", "ZONE": "us-west4-a", "MODE": "tpu-vm",
             "GENERATION": "v5e", "TOPOLOGY": "4x4", "NUM_SLICES": "1"}
    lines.update(overrides)
    path = work / "given.config"
    path.write_text("\n".join(f"{k}={v}" for k, v in lines.items()) + "\n")
    return path


def text(value: str) -> str:
    """A transcript with its durations and the overlap line set aside."""
    value = "\n".join(line for line in value.splitlines()
                      if not line.startswith("  WALL"))
    return re.sub(r"\d+\.\d+s\b", "Ns", value)


class Interrupting:
    """An input stream whose first read is a ^C."""

    def readline(self):
        raise KeyboardInterrupt


class Side:
    """One package's world: drives `main` and collects what it did."""

    def __init__(self, name, w, capsys):
        self.name, self.m, self.capsys = name, SIDES[name], capsys
        self.root = w.tmp / name
        self.work = self.root / "repo"
        self.calls_log = self.root / "calls.log"
        self.w = w

    def activate(self):
        self.w.monkeypatch.setenv("CALLS_LOG", str(self.calls_log))
        self.w.monkeypatch.setenv("PATH", f"{self.root / 'bin'}:{self.w.path}")

    def run(self, argv, answers=None, stream=None):
        """main(argv) with `answers` on the prompter's input: [exit code or
        the class of what it raised, stdout, stderr, the calls]."""
        self.activate()
        self.calls_log.write_text("")
        lines = "".join(f"{a}\n" for a in answers or [])
        prompter = self.m.io.Prompter(stream or io.StringIO(lines), sys.stdout)
        try:
            rc = self.m.cli.main(argv, prompter)
        except self.m.faults.SupervisorKilled as e:
            rc = ["SupervisorKilled", str(e)]
        out = self.capsys.readouterr()
        calls = self.calls_log.read_text().splitlines()
        # discovery's gcloud calls and readiness's ssh probes of a slice's
        # hosts run concurrently: a multiset; the others in the order the
        # DAG ran them
        probes = [c for c in calls if c.split()[0] in ("gcloud", "ssh")]
        ordered = [c for c in calls if c.split()[0] not in ("gcloud", "ssh")]
        return [rc, text(out.out), text(out.err), ordered, sorted(probes)]

    def state(self) -> dict:
        """The state provision left: config, hosts.json, inventory, vars,
        manifests (the ConfigMap's archive taken out) and the parsed
        journal and runlog."""
        out = {}
        for path in sorted(self.work.rglob("*")):
            rel = path.relative_to(self.work).as_posix()
            if not path.is_file() or "/files/" in f"/{rel}" or rel.endswith(
                    ("provision-cache.json", "given.config", "clusterUp.yml")):
                continue
            raw = path.read_text()
            if rel.endswith(".yaml"):
                docs = list(yaml.load_all(raw, Loader=getattr(yaml, "CSafeLoader",
                                                              yaml.SafeLoader)))
                for doc in docs:
                    blob = (doc.get("binaryData") or {}).pop(
                        self.m.cli.compiler.packaging.ARCHIVE_NAME, None)
                    if blob is not None and self.name == "port":
                        assert base64.b64decode(blob) == packaging.build_archive_bytes()
                out[rel] = docs
            elif rel.endswith(".jsonl"):
                out[rel] = [_stable(json.loads(line)) for line in raw.splitlines()
                            if line.strip()]
            elif rel.endswith(".json"):
                out[rel] = _stable(json.loads(raw))
            else:
                out[rel] = raw
        return out


VOLATILE = {"ts", "t_start", "t_end", "seconds", "pid", "started"}


def _stable(value):
    if isinstance(value, dict):
        return {k: "-" if k in VOLATILE else
                {a: "-" for a in v} if k == "artifacts" and isinstance(v, dict) else
                _stable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_stable(v) for v in value]
    return value


def both(w, capsys, scenario) -> dict:
    """Run `scenario(side)` on each package; assert equal outcomes once
    each side's root and the reference's package name read the port's."""
    out = {}
    for name in SIDES:
        side = Side(name, w, capsys)
        doc = json.dumps(scenario(side), sort_keys=True, default=str)
        doc = doc.replace(str(side.root), "ROOT")
        if name == "reference":
            doc = doc.replace("tritonk8ssupervisor_tpu", "tritonk8ssupervisor_tpu_torch")
            doc = doc.replace("tritonk8ssupervisor-tpu", "tritonk8ssupervisor-tpu-torch")
        out[name] = json.loads(doc)
    assert out["port"] == out["reference"]
    return out["port"]


# ---------------------------------------------------------------- scenarios


def sc_tpu_vm_then_clean(s):
    runs = [s.run(["--yes", "--config", str(saved_config(s.work)), "--workdir", str(s.work)])]
    assert runs[0][0] == 0 and "Cluster is ready" in runs[0][1] and "TOTAL" in runs[0][1]
    assert any(c.startswith("ssh -o BatchMode") for c in runs[0][4])
    assert any(c.startswith("ansible-playbook -i hosts clusterUp.yml") and
               "--limit 10.0.0.1,10.0.0.2" in c for c in runs[0][3])
    after = s.state()
    assert json.loads(json.dumps(after["terraform/hosts.json"]))["coordinator_ip"] == "10.0.0.1"
    runs.append(s.run(["-c", "--yes", "--workdir", str(s.work)]))
    assert runs[1][0] == 0 and "ssh-keygen -R 10.0.0.1" in runs[1][3]
    return {"runs": runs, "provisioned": after, "cleaned": s.state()}


def sc_gke(s):
    config = saved_config(s.work, MODE="gke", TOPOLOGY="2x2", CLUSTER_NAME="stub-cluster")
    ran = s.run(["--yes", "--config", str(config), "--workdir", str(s.work)])
    assert ran[0] == 0 and "get-credentials stub-cluster" in ran[1]
    assert any(c.startswith("kubectl get nodes") for c in ran[3])
    return {"runs": [ran], "state": s.state()}


def sc_resume(s):
    first = s.run(["--yes", "--config", str(saved_config(s.work)), "--workdir", str(s.work)])
    second = s.run(["--yes", "--workdir", str(s.work)])
    assert "Previous run detected" in second[1] and "journal-verified; skipping" in second[2]
    assert not [c for c in second[3] if c.startswith(("terraform apply", "ansible-playbook"))]
    journal = s.state()["provision-journal.jsonl"]
    assert len({r["task"] for r in journal}) == len(journal)
    assert {r["status"] for r in journal} == {"done"}
    return {"runs": [first, second], "state": s.state()}


def sc_warm_rerun(s):
    runs = [s.run(["--yes", "--config", str(saved_config(s.work)), "--workdir", str(s.work)])]
    paths = s.m.state.RunPaths(s.work)
    paths.journal.unlink()
    runs.append(s.run(["--yes", "--workdir", str(s.work)]))
    assert "warm cache" in runs[1][2]
    assert [c for c in runs[1][3] if c.startswith("terraform apply")]
    assert not [c for c in runs[1][3] if c.startswith("ansible-playbook")]
    (s.work / "ansible" / "clusterUp.yml").write_text("[]\n# edited\n")
    paths.journal.unlink()
    runs.append(s.run(["--yes", "--workdir", str(s.work)]))
    assert [c for c in runs[2][3] if c.startswith("ansible-playbook")]
    return {"runs": runs, "state": s.state()}


def sc_config_change(s):
    runs = [s.run(["--yes", "--config", str(saved_config(s.work)), "--workdir", str(s.work)])]
    runs.append(s.run(["--yes", "--config", str(saved_config(s.work, TOPOLOGY="2x4")),
                       "--workdir", str(s.work)]))
    assert "overriding saved" in runs[1][1]
    assert [c for c in runs[1][3] if c.startswith("terraform apply")]
    assert s.m.store.load_config_file(s.m.state.RunPaths(s.work).config_file).topology == "2x4"
    return {"runs": runs, "state": s.state()}


def sc_kill_resume(s):
    plan = json.dumps([{"match": "ansible-playbook", "kill": True}])
    runs = [s.run(["--yes", "--config", str(saved_config(s.work)), "--workdir", str(s.work),
                   "--fault-plan", plan])]
    assert runs[0][0][0] == "SupervisorKilled"
    killed = s.state()
    statuses = {r["task"]: r["status"] for r in killed["provision-journal.jsonl"]}
    assert statuses["terraform-apply"] == "done" and statuses["configure-slice-0"] == "running"
    runs.append(s.run(["--yes", "--workdir", str(s.work)]))
    assert runs[1][0] == 0 and "journal-verified; skipping" in runs[1][2]
    assert not [c for c in runs[1][3] if c.startswith("terraform apply")]
    return {"runs": runs, "killed": killed, "state": s.state()}


def sc_show_config(s):
    runs = [s.run(["--show-config", "--config", str(saved_config(s.work)),
                   "--workdir", str(s.work)]),
            s.run(["--show-config", "--workdir", str(s.work)])]
    assert runs[0][0] == 0 and "file-proj" in runs[0][1] and "v5litepod-16" in runs[0][1]
    assert runs[1][0] == 1 and "No configuration found" in runs[1][1]
    assert not s.m.state.RunPaths(s.work).hosts_file.exists()
    return {"runs": runs, "state": s.state()}


def sc_probe(s):
    config = saved_config(s.work, MODE="gke", TOPOLOGY="2x2")
    runs = [s.run(["--yes", "--probe", "--config", str(config), "--workdir", str(s.work)])]
    assert runs[0][0] == 0
    assert any("tpu-probe" in c for c in runs[0][3] if c.startswith("kubectl apply -f"))
    assert (s.work / "manifests" / "probe" / "tpu-probe.yaml").exists()
    # --probe on tpu-vm is refused before any resource is made
    runs.append(s.run(["--yes", "--probe", "--config", str(saved_config(s.work)),
                       "--workdir", str(s.work)]))
    assert runs[1][0] == 1 and "requires mode=gke" in runs[1][2]
    return {"runs": runs, "state": s.state()}


def sc_missing_terraform(s):
    (s.root / "bin" / "terraform").unlink()
    ran = s.run(["--yes", "--config", str(saved_config(s.work)), "--workdir", str(s.work)])
    assert ran[0] == 1 and "ERROR:" in ran[2] and "terraform" in ran[2]
    return {"runs": [ran], "state": s.state()}


def sc_checkpoint_dir(s):
    config = saved_config(s.work, MODE="gke", TOPOLOGY="2x2", CLUSTER_NAME="stub-cluster")
    ran = s.run(["--yes", "--config", str(config), "--workdir", str(s.work),
                 "--checkpoint-dir", "gs://bkt/ckpt"])
    job = s.state()["manifests/generated/bench-job-0.yaml"][0]
    script = job["spec"]["template"]["spec"]["containers"][0]["command"][-1]
    assert ran[0] == 0 and "--checkpoint-dir gs://bkt/ckpt" in script and "gcsfs" in script
    return {"runs": [ran], "state": s.state()}


def sc_bench_workload(s):
    config = saved_config(s.work, MODE="gke", TOPOLOGY="2x2", CLUSTER_NAME="stub-cluster")
    ran = s.run(["--yes", "--config", str(config), "--workdir", str(s.work),
                 "--bench-workload", "lm", "--bench-flags",
                 "--seq-len 8192 --sequence-parallelism 4"])
    job = s.state()["manifests/generated/bench-job-0.yaml"][0]
    script = job["spec"]["template"]["spec"]["containers"][0]["command"][-1]
    assert ran[0] == 0 and ".benchmarks.lm" in script
    assert "--seq-len 8192 --sequence-parallelism 4" in script
    return {"runs": [ran], "state": s.state()}


def sc_resize(s):
    config = saved_config(s.work, MODE="gke", TOPOLOGY="2x2", CLUSTER_NAME="stub-cluster")
    runs = [s.run(["--yes", "--config", str(config), "--workdir", str(s.work)])]
    gen = s.work / "manifests" / "generated"
    one = sorted(p.name for p in gen.iterdir())
    runs.append(s.run(["--yes", "--resize", "2", "--skip-readiness", "--workdir", str(s.work)]))
    assert runs[1][0] == 0 and "Resizing: 1 -> 2" in runs[1][1]
    two = s.state()
    assert "manifests/generated/bench-job-1.yaml" in two
    runs.append(s.run(["--yes", "--resize", "1", "--skip-readiness", "--workdir", str(s.work)]))
    assert runs[2][0] == 0 and not (gen / "bench-job-1.yaml").exists()
    return {"runs": runs, "one": one, "two": two, "state": s.state()}


def sc_resize_without_run(s):
    ran = s.run(["--yes", "--resize", "2", "--workdir", str(s.work)])
    assert ran[0] == 1 and "no saved config" in ran[2]
    return {"runs": [ran], "state": s.state()}


# the wizard's answers in its order: project, env name, env description,
# cluster name, node prefix, mode, generation, topology, slices, zone,
# network, subnetwork; then the verification gate
WIZARD_GKE = ["", "", "", "wizard-cluster", "", "1", "", "", "", "", "", "", "yes"]


def sc_wizard(s):
    runs = [s.run(["--workdir", str(s.work)], answers=WIZARD_GKE)]
    assert runs[0][0] == 0 and "Verify the configuration:" in runs[0][1]
    assert "Cluster is ready" in runs[0][1]
    config = s.m.store.load_config_file(s.m.state.RunPaths(s.work).config_file)
    assert (config.project, config.mode, config.cluster_name) == ("stub-proj", "gke",
                                                                  "wizard-cluster")
    # a rerun resumes at the gate; a "no" there provisions nothing more
    runs.append(s.run(["--workdir", str(s.work)], answers=["no"]))
    assert runs[1][0] == 1 and "Aborted; nothing was provisioned." in runs[1][1]
    return {"runs": runs, "state": s.state()}


def sc_interrupt(s):
    ran = s.run(["--workdir", str(s.work)], stream=Interrupting())
    assert ran[0] == 130
    assert "Interrupted; nothing further was changed. Re-run ./setup.sh to resume" in ran[2]
    return {"runs": [ran], "state": s.state()}


def sc_input_runs_out(s):
    ran = s.run(["--workdir", str(s.work)], answers=WIZARD_GKE[:5])
    assert ran[0] == 1 and "ERROR: ran out of input while prompting" in ran[2]
    return {"runs": [ran], "state": s.state()}


SCENARIOS = {
    "tpu-vm, then clean": sc_tpu_vm_then_clean,
    "gke": sc_gke,
    "resume with every task skipped": sc_resume,
    "warm rerun without the journal": sc_warm_rerun,
    "config change": sc_config_change,
    "kill and resume": sc_kill_resume,
    "show-config": sc_show_config,
    "probe": sc_probe,
    "missing terraform": sc_missing_terraform,
    "checkpoint dir": sc_checkpoint_dir,
    "bench workload and flags": sc_bench_workload,
    "resize up and down": sc_resize,
    "resize without a run": sc_resize_without_run,
    "through the wizard": sc_wizard,
    "interrupt": sc_interrupt,
    "input runs out": sc_input_runs_out,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_provision_matches_the_reference(world, capsys, name):
    both(world, capsys, SCENARIOS[name])


def test_a_dag_8_wide_leaves_the_reference_s_state(world, capsys):
    """Two slices, 8 workers: the threads interleave their lines and their
    journal and runlog records, so only the exit code, the calls and the
    state are compared, each record file as a multiset."""
    world.monkeypatch.setenv("TK8S_SCHED_WORKERS", "8")

    def scenario(s):
        ran = s.run(["--yes", "--config", str(saved_config(s.work, NUM_SLICES="2")),
                     "--workdir", str(s.work)])
        assert ran[0] == 0
        state = {name: sorted(doc, key=json.dumps) if name.endswith(".jsonl") else doc
                 for name, doc in s.state().items()}
        return {"rc": ran[0], "calls": sorted(ran[3] + ran[4]), "state": state}

    both(world, capsys, scenario)


@pytest.mark.parametrize("env", [{}, {"TK8S_SCHED_WORKERS": "1"}, {"TK8S_SCHED_WORKERS": "16"},
                                 {"TK8S_SCHED_WORKERS": "0"}, {"TK8S_SCHED_WORKERS": "-3"},
                                 {"TK8S_SCHED_WORKERS": "eight"}, {"TK8S_SCHED_WORKERS": ""}])
def test_scheduler_workers_matches_the_reference(env):
    assert cli.scheduler_workers(env) == ref_cli.scheduler_workers(env)


def test_provision_flags_and_defaults_equal_the_reference(monkeypatch):
    names = ["skip_readiness", "probe", "probe_image", "bench_image", "bench_workload",
             "bench_flags", "workload_image", "workload_command", "workload_name", "resize",
             "independent_slices", "show_config", "checkpoint_dir", "config", "yes",
             "readiness_timeout", "fault_plan", "command", "clean"]
    argv = ["--probe", "--probe-image", "p:1", "--bench-image", "b:2", "--bench-workload",
            "vit", "--bench-flags", "--steps 3", "--workload-image", "w:3",
            "--workload-command", "python t.py", "--workload-name", "wl", "--resize", "3",
            "--independent-slices", "--show-config", "--skip-readiness"]
    for name in ("BENCH_IMAGE", "TK8S_BENCH_WORKLOAD", "TK8S_BENCH_FLAGS",
                 "TK8S_CHECKPOINT_DIR"):
        monkeypatch.delenv(name, raising=False)
    out = {}
    for side, m in SIDES.items():
        defaults = vars(m.cli.build_parser().parse_args([]))
        given = vars(m.cli.build_parser().parse_args(argv))
        out[side] = [{n: defaults[n] for n in names}, {n: given[n] for n in names}]
    assert out["port"] == out["reference"]
    assert out["port"][0]["bench_workload"] == "resnet50" and out["port"][0]["command"] is None
