"""`cli.main supervise` and `cli.main -c` of the port against the
reference's, in a stub world: `terraform`, `ansible-playbook`, `gcloud`,
`ssh`, `ssh-keygen` and `kubectl` as `sh` scripts on a temporary PATH that
log their calls, a fake HOME with an SSH key, and a deployment seeded on
disk (config, hosts.json, terraform state, the ansible tree). The cases of
tests/test_main_e2e.py: one supervise tick over a healthy deployment and
`status` of it, a lost slice healed unattended, supervise without a
deployment, `-c` stopping a live supervisor (a `supervise` process running
until SIGTERM) and scrubbing the ledger, `-c` without a config, `-c` from
orphaned terraform state, and `-c` over every mode with state. Both
packages give equal exit codes, printed lines, stub calls and files left
behind (wall-clock stamps, pids and durations set aside). Also the repair
of a closed stdout: `main` returns 0 on `BrokenPipeError` in both packages.
No tolerance."""

import json
import os
import re
import subprocess
import sys
import time
import types

import pytest

from tritonk8ssupervisor_tpu.cli import main as ref_cli
from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.config import store as ref_store
from tritonk8ssupervisor_tpu.provision import state as ref_state
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.config import schema, store
from tritonk8ssupervisor_tpu_torch.provision import state

# autouse: the reference compiles the port's TPU cluster smoke, the one
# string the compilers differ in by design (F9, tests/test_torch_compile.py)
from test_torch_compile import port_cluster_smoke  # noqa: E402,F401

SIDES = {
    "port": types.SimpleNamespace(cli=cli, schema=schema, store=store, state=state,
                                  module="tritonk8ssupervisor_tpu_torch.cli.main"),
    "reference": types.SimpleNamespace(cli=ref_cli, schema=ref_schema, store=ref_store,
                                       state=ref_state,
                                       module="tritonk8ssupervisor_tpu.cli.main"),
}

STUBS = {
    "terraform": """#!/bin/sh
echo "terraform $*" >> "$CALLS_LOG"
case "$1" in
  apply) echo '{"resources": [{"type": "google_tpu_v2_vm"}]}' > terraform.tfstate ;;
  output) echo '{"host_ips": {"value": [["10.0.0.1", "10.0.0.2"]]}}' ;;
  destroy) rm -f terraform.tfstate ;;
esac
""",
    "ansible-playbook": '#!/bin/sh\necho "ansible-playbook $*" >> "$CALLS_LOG"\n',
    "gcloud": """#!/bin/sh
echo "gcloud $*" >> "$CALLS_LOG"
case "$*" in
  *"tpu-vm list"*) printf 'tpunode-0\\tREADY\\n' ;;
  *describe*) echo READY ;;
esac
""",
    "ssh-keygen": '#!/bin/sh\necho "ssh-keygen $*" >> "$CALLS_LOG"\n',
    "ssh": '#!/bin/sh\necho "ssh $*" >> "$CALLS_LOG"\n',
    "kubectl": '#!/bin/sh\necho "kubectl $*" >> "$CALLS_LOG"\n',
}


@pytest.fixture
def stub_world(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in STUBS.items():
        (bin_dir / name).write_text(body)
        (bin_dir / name).chmod(0o755)
    home = tmp_path / "home"
    (home / ".ssh").mkdir(parents=True)
    (home / ".ssh" / "id_rsa").write_text("fake-key\n")
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("TK8S_SSH_USER", "tester")
    monkeypatch.setenv("TK8S_RETRY_BASE_DELAY", "0.01")
    monkeypatch.setenv("TK8S_RETRY_MAX_DELAY", "0.02")
    for name in ("TK8S_FAULT_PLAN", "TF_PLUGIN_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name in list(os.environ):
        if name.startswith(("TK8S_SUPERVISE_", "TK8S_AUTOSCALE_", "TK8S_ALLOC_")):
            monkeypatch.delenv(name)
    return monkeypatch


def seed_deployment(m, work, modes=("tpu-vm",), config=True, lost=False):
    """What provisioning leaves on disk: the saved config (of the first
    mode), hosts.json, each mode's terraform state, the ansible tree."""
    paths = m.state.RunPaths(work)
    for sub in ("terraform/tpu-vm", "terraform/gke", "ansible"):
        (work / sub).mkdir(parents=True, exist_ok=True)
    paths.ansible_cfg.write_text("[defaults]\nhost_key_checking = False\nprivate_key_file =\n")
    (paths.ansible_dir / "clusterUp.yml").write_text("[]\n")
    for mode in modes:
        paths.tfstate(mode).write_text('{"resources": [{"type": "google_tpu_v2_vm"}]}\n')
    if config:
        topology = "4x4" if modes[0] == "tpu-vm" else "2x2"
        m.store.save_config_file(m.schema.ClusterConfig(
            project="file-proj", zone="us-west4-a", mode=modes[0], generation="v5e",
            topology=topology, num_slices=1), paths.config_file)
    m.state.ClusterHosts(host_ips=[[] if lost else ["10.0.0.1", "10.0.0.2"]],
                         internal_ips=[] if lost else [["10.1.0.1", "10.1.0.2"]],
                         coordinator_ip="10.1.0.1").save(paths.hosts_file)
    return paths


VOLATILE = {"ts", "updated", "pid", "seconds", "mttr_s", "last_tick_s", "span_log_bytes",
            "started", "since", "t_start", "t_end", "reopen_at", "last", "mean", "max"}


def stable(value):
    """A document with its wall-clock stamps, pids and durations set aside."""
    if isinstance(value, dict):
        return {k: "-" if k in VOLATILE else stable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [stable(v) for v in value]
    if isinstance(value, str):
        return re.sub(r"heal-\d+-", "heal-T-", value)  # a heal id names its start second
    return value


def text(value: str) -> str:
    value = re.sub(r"\d+\.\d+s", "Ns", value)
    value = re.sub(r"(mean|last) \d+s", r"\1 Ns", value)  # wall-clock MTTR, whole seconds
    value = re.sub(r"\(\d+ B\)", "(N B)", value)
    return re.sub(r"pid \d+", "pid N", value)


# wall-clock telemetry; and the warm converge cache, whose keys hash the
# staged role tree, which holds each package's own archive (files/)
SET_ASIDE = {"metrics.json", "telemetry-spans.jsonl", "provision-cache.json"}


def files(root) -> dict:
    """Every file left under the workdir: parsed and stabilised where it
    is JSON or JSON lines, else its text."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file() or "files" in p.parts or p.name in SET_ASIDE:
            continue
        raw = p.read_text()
        try:
            doc = stable(json.loads(raw))
        except ValueError:
            try:
                doc = [stable(json.loads(line)) for line in raw.splitlines() if line.strip()]
            except ValueError:
                doc = text(raw)
        out[p.relative_to(root).as_posix()] = doc
    return out


def drive(m, work, calls_log, capsys, argv) -> list:
    """One `main(argv)`: its exit code, printed lines and stub calls. The
    calls are sorted (readiness probes its hosts from concurrent threads),
    and the read-only probes (`gcloud`, `ssh`) counted once: the fleet
    listing's cache lives half a tick of wall time, so how often a tick
    lists depends on how fast it runs."""
    calls_log.write_text("")
    rc = m.cli.main(argv)
    captured = capsys.readouterr()
    lines = calls_log.read_text().splitlines(keepends=True)
    probes = {c for c in lines if c.split()[0] in ("gcloud", "ssh")}
    calls = "".join(sorted([c for c in lines if c not in probes] + list(probes)))
    return [rc, text(captured.out), text(captured.err), calls]


def both(tmp_path, stub_world, capsys, scenario) -> dict:
    out = {}
    for side, m in SIDES.items():
        work = tmp_path / side
        work.mkdir()
        calls_log = tmp_path / f"calls-{side}.log"
        stub_world.setenv("CALLS_LOG", str(calls_log))
        doc = scenario(m, work, calls_log, capsys)
        doc = json.loads(json.dumps(doc, sort_keys=True).replace(str(work), "ROOT"))
        if side == "reference":
            doc = json.loads(json.dumps(doc).replace("tritonk8ssupervisor_tpu",
                                                     "tritonk8ssupervisor_tpu_torch"))
        out[side] = doc
    assert out["port"] == out["reference"]
    return out["port"]


def sc_one_tick_and_status(m, work, calls_log, capsys):
    seed_deployment(m, work)
    paths = m.state.RunPaths(work)
    ran = [drive(m, work, calls_log, capsys, ["supervise", "--yes", "--workdir", str(work),
                                                "--ticks", "1", "--interval", "0.01"])]
    assert ran[0][0] == 0 and "supervising 1 slice(s)" in ran[0][1]
    kinds = [json.loads(line)["kind"] for line in paths.events.read_text().splitlines()]
    assert {"supervisor-start", "tick", "supervisor-stop"} <= set(kinds)
    doc = json.loads(paths.fleet_status.read_text())
    assert doc["verdict"] == "healthy" and doc["slice_states"] == {"healthy": 1}
    assert doc["slices"] == {} and not paths.supervisor_pid.exists()
    status = drive(m, work, calls_log, capsys, ["status", "--workdir", str(work)])
    assert status[0] == 0 and "fleet: healthy" in status[1] and "1 healthy (of 1)" in status[1]
    as_json = drive(m, work, calls_log, capsys, ["status", "--json", "--workdir", str(work)])
    assert as_json[0] == 0 and json.loads(as_json[1])["verdict"] == "healthy"
    full = drive(m, work, calls_log, capsys, ["status", "--json", "--all", "--workdir",
                                              str(work)])
    assert json.loads(full[1])["slices"]["0"]["state"] == "healthy"
    as_json[1], full[1] = stable(json.loads(as_json[1])), stable(json.loads(full[1]))
    return {"runs": ran + [status, as_json, full], "files": files(work)}


def sc_lost_slice_healed(m, work, calls_log, capsys):
    paths = seed_deployment(m, work, lost=True)
    ran = drive(m, work, calls_log, capsys, ["supervise", "--yes", "--workdir", str(work),
                                             "--ticks", "3", "--interval", "0.01"])
    assert ran[0] == 0
    assert "-replace=google_tpu_v2_vm.slice[0]" in ran[3]
    assert ran[3].count("terraform apply") == 1
    assert json.loads(paths.hosts_file.read_text())["host_ips"] == [["10.0.0.1", "10.0.0.2"]]
    doc = json.loads(paths.fleet_status.read_text())
    assert doc["verdict"] == "healthy"
    assert doc["heals"] == {"attempted": 1, "succeeded": 1, "failed": 0, "rate_limited": 0,
                            "held_ticks": 0, "in_flight": 0, "suppressed": 0, "deferred": 0}
    assert doc["mttr_s"]["count"] == 1
    status = drive(m, work, calls_log, capsys, ["status", "--workdir", str(work)])
    assert status[0] == 0 and "heals: 1/1 succeeded" in status[1]
    return {"runs": [ran, status], "files": files(work)}


def sc_no_deployment(m, work, calls_log, capsys):
    ran = drive(m, work, calls_log, capsys, ["supervise", "--yes", "--workdir", str(work)])
    assert ran[0] == 1 and "ERROR:" in ran[2] and "provision first" in ran[2]
    return {"runs": [ran], "files": files(work)}


def sc_clean_stops_a_live_supervisor(m, work, calls_log, capsys):
    """`-c` while a `supervise` process runs until SIGTERM: teardown
    signals it, the loop records its stop and exits 0, and the ledgers go
    last."""
    paths = seed_deployment(m, work)
    proc = subprocess.Popen(
        [sys.executable, "-m", m.module, "supervise", "--yes", "--workdir", str(work),
         "--interval", "0.2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        while not (paths.fleet_status.exists() and paths.supervisor_pid.exists()):
            assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
            time.sleep(0.05)
        ran = drive(m, work, calls_log, capsys, ["-c", "--yes", "--workdir", str(work)])
        supervised, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, supervised  # a SIGTERM'd loop exits cleanly
    assert ran[0] == 0 and "stopping running supervisor (pid N)" in ran[1]
    for gone in (paths.supervisor_pid, paths.events, paths.fleet_status, paths.journal,
                 paths.config_file, paths.hosts_file, paths.tfstate("tpu-vm")):
        assert not gone.exists(), gone
    # the calls of the live loop's ticks interleave with teardown's: keep
    # teardown's own
    ran[3] = [c for c in ran[3].splitlines() if c.split()[0] in ("terraform", "ssh-keygen")]
    first_line = text(supervised.splitlines()[0])
    return {"runs": [ran], "supervised": first_line, "files": files(work)}


def sc_stale_lock_and_ledger_scrubbed(m, work, calls_log, capsys):
    paths = seed_deployment(m, work)
    ran = [drive(m, work, calls_log, capsys, ["supervise", "--yes", "--workdir", str(work),
                                                "--ticks", "1", "--interval", "0.01"])]
    paths.supervisor_pid.write_text("99999999\n")  # a crashed supervisor
    assert paths.events.exists() and paths.fleet_status.exists()
    ran.append(drive(m, work, calls_log, capsys, ["-c", "--yes", "--workdir", str(work)]))
    assert ran[-1][0] == 0
    for gone in (paths.supervisor_pid, paths.events, paths.fleet_status, paths.journal):
        assert not gone.exists(), gone
    return {"runs": ran, "files": files(work)}


def sc_clean_without_config(m, work, calls_log, capsys):
    ran = drive(m, work, calls_log, capsys, ["-c", "--yes", "--workdir", str(work)])
    assert ran[0] == 0 and "nothing to clean" in ran[1]
    return {"runs": [ran], "files": files(work)}


def sc_clean_from_orphaned_tfstate(m, work, calls_log, capsys):
    paths = seed_deployment(m, work, config=False)
    ran = drive(m, work, calls_log, capsys, ["-c", "--yes", "--workdir", str(work)])
    assert ran[0] == 0 and "orphaned terraform state" in ran[1]
    assert "terraform destroy" in ran[3]
    assert not paths.tfstate("tpu-vm").exists() and not paths.hosts_file.exists()
    return {"runs": [ran], "files": files(work)}


def sc_clean_every_mode(m, work, calls_log, capsys):
    paths = seed_deployment(m, work, modes=("gke", "tpu-vm"))
    ran = drive(m, work, calls_log, capsys, ["-c", "--yes", "--workdir", str(work)])
    assert ran[0] == 0 and "gke, tpu-vm deployment(s)" in ran[1]
    assert len([c for c in ran[3].splitlines() if c.startswith("terraform destroy")]) == 2
    assert not paths.tfstate("tpu-vm").exists() and not paths.tfstate("gke").exists()
    return {"runs": [ran], "files": files(work)}


def sc_clean_only_host_record(m, work, calls_log, capsys):
    seed_deployment(m, work, modes=("tpu-vm",), config=False)
    m.state.RunPaths(work).tfstate("tpu-vm").unlink()
    ran = drive(m, work, calls_log, capsys, ["-c", "--yes", "--workdir", str(work)])
    assert ran[0] == 0 and "nothing was destroyed" in ran[1] and "10.0.0.1" in ran[1]
    return {"runs": [ran], "files": files(work)}


SCENARIOS = {
    "supervise: one tick, then status": sc_one_tick_and_status,
    "supervise: a lost slice healed unattended": sc_lost_slice_healed,
    "supervise: no deployment": sc_no_deployment,
    "-c: stops a live supervisor": sc_clean_stops_a_live_supervisor,
    "-c: a stale lock and the ledger scrubbed": sc_stale_lock_and_ledger_scrubbed,
    "-c: without a config": sc_clean_without_config,
    "-c: from orphaned terraform state": sc_clean_from_orphaned_tfstate,
    "-c: every mode with state": sc_clean_every_mode,
    "-c: only a host record": sc_clean_only_host_record,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cli_matches_the_reference(tmp_path, stub_world, capsys, name):
    both(tmp_path, stub_world, capsys, SCENARIOS[name])


def test_supervise_flags_and_defaults_equal_the_reference():
    names = ["interval", "ticks", "flap_threshold", "heal_burst", "heal_refill",
             "breaker_threshold", "breaker_window", "breaker_cooldown", "page_size",
             "sweep_slices", "heal_workers", "domain_threshold", "domain_window",
             "domain_cooldown", "quota_defer_cap", "compact_records", "autoscale",
             "min_slices", "max_slices", "allocate", "train_slices", "min_serving",
             "readiness_timeout", "fault_plan", "max_degraded", "clean", "yes", "config"]
    argv = ["supervise", "--interval", "7", "--heal-burst", "3", "--domain-window", "60",
            "--max-degraded", "2", "--compact-records", "0"]
    out = {}
    for side, m in SIDES.items():
        defaults = vars(m.cli.build_parser().parse_args(["supervise"]))
        given = m.cli.build_parser().parse_args(argv)
        policy = m.cli.supervise_policy_from_args(given)
        out[side] = [{n: defaults[n] for n in names}, vars(policy),
                     vars(m.cli.build_parser().parse_args(["-c"]))["clean"]]
    assert out["port"] == out["reference"]
    assert out["port"][1]["interval"] == 7.0 and out["port"][1]["max_degraded"] == 2
    assert out["port"][1]["compact_records"] == 0 and out["port"][2] is True


@pytest.mark.parametrize("side", sorted(SIDES))
def test_main_returns_0_when_stdout_goes_away(tmp_path, monkeypatch, side):
    """`status --json | head`: the consumer closed the pipe, which is not
    an error of the command's."""
    m = SIDES[side]

    def closed(*args, **kwargs):
        raise BrokenPipeError(32, "Broken pipe")

    monkeypatch.setattr(m.cli, "status_cmd", closed)
    assert m.cli.main(["status", "--workdir", str(tmp_path)]) == 0
