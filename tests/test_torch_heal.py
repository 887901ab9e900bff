"""The port's slice-granular healer (`provision/heal.py`) and `cli.main
heal` against the reference's: over the scenarios of tests/test_heal.py (a
healthy fleet, a missing, an unready and a draining slice, a slice absent
from the Cloud TPU listing or stuck in another state, `only_slices`, a
pre-computed `health=`, `max_degraded`, a repair that crashes, GKE mode)
both packages give equal `diagnose` results, `drain_verdicts`, repaired
slices, command sequences, quarantine records, `hosts.json`, warm-cache
entries and printed lines, under one injected clock. Then `cli.main
heal` runs in a stub world (`terraform`, `ansible-playbook`, `ssh` and
`gcloud` as `sh` scripts on a temporary PATH) and gives the reference's
exit codes, output and files. Each side runs in its own temporary root,
replaced by one name before the comparison. No tolerance."""

import json
import re
import threading
import types

import pytest

from tritonk8ssupervisor_tpu.cli import main as ref_cli
from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.config import store as ref_store
from tritonk8ssupervisor_tpu.provision import cache as ref_cache
from tritonk8ssupervisor_tpu.provision import heal as ref_heal
from tritonk8ssupervisor_tpu.provision import readiness as ref_readiness
from tritonk8ssupervisor_tpu.provision import runner as ref_runner
from tritonk8ssupervisor_tpu.provision import state as ref_state
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.config import schema, store
from tritonk8ssupervisor_tpu_torch.provision import cache, heal, readiness, runner, state

# autouse: the reference compiles the port's TPU cluster smoke, the one
# string the compilers differ in by design (F9, tests/test_torch_compile.py)
from test_torch_compile import port_cluster_smoke  # noqa: E402,F401

SIDES = {
    "port": types.SimpleNamespace(schema=schema, store=store, cache=cache, heal=heal,
                                  readiness=readiness, runner=runner, state=state, cli=cli),
    "reference": types.SimpleNamespace(schema=ref_schema, store=ref_store, cache=ref_cache,
                                       heal=ref_heal, readiness=ref_readiness,
                                       runner=ref_runner, state=ref_state, cli=ref_cli),
}


def cfg(m, **overrides):
    base = dict(project="my-proj", zone="us-west4-a", generation="v5e", topology="4x4",
                mode="tpu-vm", num_slices=3)
    base.update(overrides)
    return m.schema.ClusterConfig(**base)


def outcome(fn):
    try:
        return ["ok", fn()]
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return [type(e).__name__, str(e)]


def normalized(value, root) -> object:
    text = json.dumps(value, sort_keys=True, default=str).replace(str(root), "ROOT")
    return json.loads(text)


def port_names(value) -> object:
    text = json.dumps(value, sort_keys=True)
    text = text.replace("tritonk8ssupervisor_tpu", "tritonk8ssupervisor_tpu_torch")
    return json.loads(text.replace("tritonk8ssupervisor-tpu", "tritonk8ssupervisor-tpu-torch"))


class Say:
    def __init__(self):
        self.lines = []

    def say(self, text=""):
        self.lines.append(text)


class Ticks:
    """A clock that advances by one second at every read."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1.0
        return self.t


def seed_world(m, root, num_slices=3, lost=()):
    paths = m.state.RunPaths(root)
    paths.terraform_module("tpu-vm").mkdir(parents=True)
    hosts = m.state.ClusterHosts(
        host_ips=[[f"10.0.{i}.1"] for i in range(num_slices)],
        internal_ips=[[f"10.1.{i}.1"] for i in range(num_slices)],
        coordinator_ip="10.1.0.1",
    )
    for i in lost:
        hosts.host_ips[i] = []
        hosts.internal_ips[i] = []
    hosts.save(paths.hosts_file)
    paths.tfstate("tpu-vm").write_text(json.dumps(
        {"resources": [{"index": i} for i in range(num_slices)]}))
    return paths, hosts


class World:
    """Scripted run / run_quiet for diagnosis and repair: the gcloud
    listing, per-IP ssh verdicts, drain files, and terraform outputs that
    give each replaced slice a new IP. Calls are recorded; the SSH probes
    run in threads, so their calls are compared as a set."""

    def __init__(self, m, num_slices=3, listing=None, ssh_fail=(), drains=None,
                 new_ip="10.9.9.9", fail_apply=False):
        self.m = m
        self.num_slices = num_slices
        self.listing = listing if listing is not None else {
            f"tpunode-{i}": "READY" for i in range(num_slices)}
        self.ssh_fail = set(ssh_fail)
        self.drains = drains or {}
        self.new_ip = new_ip
        self.fail_apply = fail_apply
        self.replaced: list = []
        self.calls: list = []
        self.ssh_calls: list = []
        self.lock = threading.Lock()

    def run(self, args, cwd=None, **kwargs):
        line = " ".join(str(a) for a in args)
        with self.lock:
            self.calls.append(line)
        if self.fail_apply and "apply" in args:
            raise self.m.runner.CommandError(args, 1, tail="QUOTA_EXCEEDED")
        for a in args:
            if str(a).startswith("-replace="):
                self.replaced.append(int(str(a).split("[")[1].rstrip("]")))
        return ""

    def run_quiet(self, args, cwd=None, **kwargs):
        line = " ".join(str(a) for a in args)
        if args and args[0] == "ssh":
            with self.lock:
                self.ssh_calls.append(line)
            ip = args[-2]
            if "cat" in args[-1]:
                return self.drains.get(ip, "")
            if ip in self.ssh_fail:
                raise self.m.runner.CommandError(args, 255)
            return ""
        with self.lock:
            self.calls.append(line)
        if list(args[:3]) == ["terraform", "output", "-json"]:
            ips = [[f"10.0.{i}.1"] for i in range(self.num_slices)]
            for i in self.replaced:
                ips[i] = [self.new_ip]
            return json.dumps({"host_ips": {"value": ips}, "internal_ips": {"value": [
                [f"10.1.{i}.1"] for i in range(self.num_slices)]}})
        if args and args[0] == "gcloud":
            return "\n".join(f"{n}\t{s}" for n, s in self.listing.items())
        return ""

    def record(self) -> dict:
        return {"calls": self.calls, "ssh": sorted(self.ssh_calls), "replaced": self.replaced}


def health_doc(health) -> list:
    return [[s.index, s.state, s.detail, list(s.hosts), s.domain] for s in health.slices] + [
        health.healthy, health.degraded, health.summary(),
        {k: [s.index for s in v] for k, v in health.by_domain().items()}]


def files_doc(m, paths, root) -> dict:
    """hosts.json, the quarantine record without its time stamp, and the
    warm cache's entries: a prior key as it stood, a converged one as
    whether it is the slice's content key now."""
    doc = {"hosts": json.loads(paths.hosts_file.read_text()) if paths.hosts_file.exists()
           else None}
    if paths.quarantine_file.exists():
        quarantine = json.loads(paths.quarantine_file.read_text())
        quarantine.pop("updated")
        doc["quarantine"] = quarantine
    if paths.warm_cache.exists():
        hosts = json.loads(paths.hosts_file.read_text())["host_ips"]
        entries = {}
        for task, entry in json.loads(paths.warm_cache.read_text()).items():
            key = entry["key"]
            if not key.startswith("prior"):
                i = int(task.rsplit("-", 1)[1])
                key = ["converged", key == m.cache.converge_key(paths, i, hosts[i])]
            entries[task] = key
        doc["warm_cache"] = entries
    return normalized(doc, root)


def compare(scenario, tmp_path):
    out = {}
    for side, m in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        result = normalized(outcome(lambda: scenario(m, root)), root)
        out[side] = result if side == "port" else port_names(result)
    assert out["port"] == out["reference"]
    return out["port"]


# --------------------------------------------------------------- diagnosis

DIAGNOSE_CASES = {
    "healthy": ({}, {}, {}),
    "missing, unready, draining": (
        {"lost": (0,)}, {"ssh_fail": {"10.0.1.1"},
                         "drains": {"10.0.2.1": "maintenance-event: TERMINATE"}}, {}),
    "absent and stuck": ({}, {"listing": {"tpunode-0": "READY", "tpunode-1": "PREEMPTED"}}, {}),
    "no listing": ({}, {"listing": {}}, {}),
    "only slice 1": ({}, {"ssh_fail": {"10.0.1.1"},
                          "drains": {"10.0.2.1": "maintenance-event: TERMINATE"}},
                     {"only_slices": [1]}),
    "only slices 0 and 2": ({}, {"ssh_fail": {"10.0.1.1"},
                                 "drains": {"10.0.2.1": "maintenance-event: TERMINATE"}},
                            {"only_slices": [0, 2]}),
    "out of range": ({}, {}, {"only_slices": [99]}),
    "drain unchecked": ({}, {"drains": {"10.0.2.1": "x"}}, {"check_drain": False}),
    "credentials": ({}, {"ssh_fail": {"10.0.0.1"}}, {"ssh_user": "alice", "ssh_key": "/k"}),
}


@pytest.mark.parametrize("case", sorted(DIAGNOSE_CASES))
def test_diagnose_matches_the_reference(tmp_path, case):
    seed, world_kwargs, kwargs = DIAGNOSE_CASES[case]

    def scenario(m, root):
        paths, _ = seed_world(m, root, **seed)
        world = World(m, **world_kwargs)
        config = cfg(m, failure_domains=3) if case == "healthy" else cfg(m)
        health = m.heal.diagnose(config, paths, run_quiet=world.run_quiet, **kwargs)
        return [health_doc(health), world.record()]

    compare(scenario, tmp_path)


def test_diagnose_without_a_hosts_record_and_drain_verdicts_match_the_reference(tmp_path):
    def scenario(m, root):
        paths = m.state.RunPaths(root)
        paths.terraform_module("tpu-vm").mkdir(parents=True)
        world = World(m)
        out = [health_doc(m.heal.diagnose(cfg(m), paths, run_quiet=world.run_quiet))]

        def refused(args, cwd=None, **kwargs):
            raise m.runner.CommandError(args, 255)

        drains = World(m, drains={"10.0.1.2": "maintenance-event: MIGRATE"})
        out += [m.heal.drain_verdicts([["10.0.0.1"]], run_quiet=refused),
                m.heal.drain_verdicts([["10.0.0.1"], ["10.0.1.1", "10.0.1.2"]],
                                      ssh_user="u", ssh_key="/k",
                                      run_quiet=drains.run_quiet, drain_file="/run/x"),
                m.heal.drain_verdicts([["10.0.0.1"], ["10.0.1.1", "10.0.1.2"]],
                                      run_quiet=drains.run_quiet, only_slices=[0]),
                drains.record()]
        return out

    compare(scenario, tmp_path)


def test_record_quarantine_matches_the_reference(tmp_path):
    def scenario(m, root):
        paths = m.state.RunPaths(root)
        paths.terraform_dir.mkdir()
        clock = Ticks()
        out = []
        for entries in ({1: {"state": "unready", "detail": "x", "hosts": []}},
                        {2: {"state": "missing", "detail": "y", "hosts": ["h"]}},
                        {1: None}, {7: None}):
            m.heal.record_quarantine(paths, entries, clock=clock)
            out.append(json.loads(paths.quarantine_file.read_text()))
        paths.quarantine_file.write_text('{"slices": {"2": trunc')
        m.heal.record_quarantine(paths, {3: {"state": "draining", "detail": "", "hosts": []}},
                                 clock=clock)
        out.append(json.loads(paths.quarantine_file.read_text()))
        return out

    compare(scenario, tmp_path)


# -------------------------------------------------------------------- heal

HEAL_CASES = {
    "healthy no-op": ({}, {}, {}),
    "lost slice": ({"lost": (1,)}, {}, {"readiness_timeout": 10.0}),
    "lost slice, with credentials": ({"lost": (1,)}, {},
                                     {"ssh_key": "/k", "ssh_user": "alice"}),
    "unready and draining": ({}, {"ssh_fail": {"10.0.0.1"},
                                  "drains": {"10.0.2.1": "maintenance-event: TERMINATE"}}, {}),
    "stays broken, max_degraded 1": ({"lost": (1,)}, {"ssh_fail": {"10.9.9.9"}},
                                     {"max_degraded": 1, "readiness_timeout": 0.0}),
    "stays broken, max_degraded 0": ({"lost": (1,)}, {"ssh_fail": {"10.9.9.9"}},
                                     {"max_degraded": 0, "readiness_timeout": 0.0}),
    "crashed repair": ({"lost": (2,)}, {"fail_apply": True}, {}),
    "health and only_slices": ({"lost": (1,)}, {}, {"only_slices": [1], "health": True}),
    "health excluding every bad slice": ({"lost": (1,)}, {}, {"only_slices": [0],
                                                              "health": True}),
}


@pytest.mark.parametrize("case", sorted(HEAL_CASES))
def test_heal_matches_the_reference(tmp_path, case):
    seed, world_kwargs, kwargs = HEAL_CASES[case]

    def scenario(m, root):
        paths, _ = seed_world(m, root, **seed)
        warm = m.cache.WarmCache(paths.warm_cache)
        for i in range(3):
            warm.record(f"configure-slice-{i}", f"prior-key-{i}")
        world = World(m, **world_kwargs)
        extra = dict(kwargs)
        if extra.pop("health", False):
            extra["health"] = m.heal.FleetHealth([
                m.heal.SliceHealth(0, m.heal.HEALTHY, hosts=("10.0.0.1",)),
                m.heal.SliceHealth(1, m.heal.MISSING, "no hosts recorded"),
                m.heal.SliceHealth(2, m.heal.DRAINING, "10.0.2.1: maintenance-event: TERMINATE",
                                   hosts=("10.0.2.1",)),
            ])
        say = Say()
        result = outcome(lambda: m.heal.heal(cfg(m), paths, say, run=world.run,
                                             run_quiet=world.run_quiet, sleep=lambda s: None,
                                             clock=Ticks(), cache=warm, **extra))
        return [result, say.lines, world.record(), files_doc(m, paths, root),
                sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                       if p.is_file())]

    result = compare(scenario, tmp_path)
    if case == "lost slice":
        assert result[1][0] == ["ok", True]
        warm = result[1][3]["warm_cache"]
        assert warm["configure-slice-0"] == "prior-key-0"
        assert warm["configure-slice-1"] == ["converged", True]


def test_heal_refuses_gke_as_the_reference(tmp_path):
    def scenario(m, root):
        return outcome(lambda: m.heal.heal(cfg(m, mode="gke", topology="2x2"),
                                           m.state.RunPaths(root), Say()))

    result = compare(scenario, tmp_path)
    assert result[1][0] == "ConfigError"


# ------------------------------------------------------------ cli.main heal

STUBS = {
    "terraform": """#!/bin/sh
case "$1" in
  output) cat "$STUB_STATE/tf_output.json" ;;
  *) echo "terraform $*" ;;
esac
""",
    "ansible-playbook": '#!/bin/sh\necho "ansible-playbook $*"\n',
    "gcloud": """#!/bin/sh
case "$*" in
  *list*) printf 'tpunode-0\\tREADY\\ntpunode-1\\tREADY\\ntpunode-2\\tREADY\\n' ;;
esac
""",
    "ssh": """#!/bin/sh
ip=""; cmd=""
for a in "$@"; do ip=$cmd; cmd=$a; done
case "$cmd" in cat*) exit 0 ;; esac
case " $BAD_IPS " in *" $ip "*) exit 255 ;; esac
exit 0
""",
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
    stub_state = tmp_path / "stub-state"
    stub_state.mkdir()
    monkeypatch.setenv("PATH", f"{bin_dir}:{__import__('os').environ['PATH']}")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("TK8S_SSH_USER", "tester")
    monkeypatch.setenv("STUB_STATE", str(stub_state))
    monkeypatch.setenv("BAD_IPS", "")
    monkeypatch.delenv("TK8S_FAULT_PLAN", raising=False)
    # the retry engine's backoff, shortened: an ssh refusal is retried as
    # it would be, without real seconds of sleep
    monkeypatch.setenv("TK8S_RETRY_BASE_DELAY", "0.01")
    monkeypatch.setenv("TK8S_RETRY_MAX_DELAY", "0.02")
    monkeypatch.delenv("TF_PLUGIN_CACHE_DIR", raising=False)
    return stub_state


CLI_CASES = {
    "healthy": ({}, [], ""),
    "lost slice": ({"lost": (1,)}, [], ""),
    "gke config": ({"mode": "gke"}, [], ""),
    "missing config": ({"no_config": True}, [], ""),
    "explicit config": ({"lost": (2,), "config_elsewhere": True}, [], ""),
    "stays broken, max-degraded 1": ({"lost": (1,)}, ["--max-degraded", "1",
                                                      "--readiness-timeout", "0"], "10.9.9.9"),
    "stays broken": ({"lost": (1,)}, ["--readiness-timeout", "0"], "10.9.9.9"),
    "fault plan": ({"lost": (1,)}, ["--fault-plan", json.dumps({"faults": [
        {"match": "terraform apply", "times": 1, "rc": 1,
         "output": "Error: Invalid value for variable"}]})], ""),
    "bad fault plan": ({}, ["--fault-plan", "{not json"], ""),
}


def _timing_free(text: str) -> str:
    return re.sub(r"\d+\.\d+s", "Ns", text)


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_heal_matches_the_reference(tmp_path, capsys, monkeypatch, stub_world, case):
    seed, flags, bad_ips = CLI_CASES[case]
    seed = dict(seed)
    mode = seed.pop("mode", "tpu-vm")
    no_config = seed.pop("no_config", False)
    elsewhere = seed.pop("config_elsewhere", False)
    monkeypatch.setenv("BAD_IPS", bad_ips)
    out = {}
    for side, m in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        paths, _ = seed_world(m, root, **seed)
        (root / "ansible").mkdir()
        (root / "ansible" / "ansible.cfg").write_text("[defaults]\nprivate_key_file =\n")
        ips = [[f"10.0.{i}.1"] for i in range(3)]
        for i in seed.get("lost", ()):
            ips[i] = ["10.9.9.9"]
        (stub_world / "tf_output.json").write_text(json.dumps(
            {"host_ips": {"value": ips},
             "internal_ips": {"value": [[f"10.1.{i}.1"] for i in range(3)]}}))
        argv = ["heal", "--workdir", str(root), *flags]
        config = cfg(m, mode=mode) if mode == "tpu-vm" else cfg(m, mode=mode, topology="2x2")
        if elsewhere:
            m.store.save_config_file(config, root / "elsewhere.cfg")
            argv += ["--config", str(root / "elsewhere.cfg")]
        elif not no_config:
            m.store.save_config_file(config, paths.config_file)
        rc = m.cli.main(argv)
        captured = capsys.readouterr()
        doc = files_doc(m, paths, root)
        doc["ansible"] = {p.relative_to(root).as_posix(): p.read_text()
                          for p in sorted((root / "ansible").rglob("*"))
                          if p.is_file() and "files" not in p.parts}
        doc["runlog_phases"] = ([json.loads(line).get("phase") for line in
                                 paths.runlog.read_text().splitlines()]
                                if paths.runlog.exists() else None)
        result = [rc, _timing_free(captured.out), _timing_free(captured.err), doc]
        text = json.dumps(result, sort_keys=True).replace(str(root), "ROOT")
        out[side] = json.loads(text) if side == "port" else port_names(json.loads(text))
    assert out["port"] == out["reference"]
    expected_rc = {"healthy": 0, "lost slice": 0, "gke config": 1, "missing config": 1,
                   "explicit config": 0, "stays broken, max-degraded 1": 0, "stays broken": 1,
                   "fault plan": 1, "bad fault plan": 1}[case]
    assert out["port"][0] == expected_rc
