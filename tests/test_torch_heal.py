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
replaced by one name before the comparison. No tolerance.

The reference has no GPU mode, so every case also runs as a mirrored
pair: the reference on a tpu-vm config, the port on a gpu-vm `h100` `2x8`
config (two host VMs a slice) of as many slices, both over one scripted
world seen through `GpuMirror`. The mirror turns the port's Compute Engine
listing into the reference's Cloud TPU listing and back (a slice absent
from the listing reads as one of its host VMs absent, PREEMPTED or
CREATING as one host TERMINATED or STAGING), and each slice's H
`google_compute_instance.host[k]` addresses into its one
`google_tpu_v2_vm.slice[s]`, and `clusterUpGpu.yml` into `clusterUp.yml`,
refusing any address set that is not every host of its slices in order.
`as_tpu` maps the port's printed words back the same way; everything else
is compared as is. The gke-gpu refusals are the reference's gke ones."""

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


# ------------------------------------------------------- the mirrored world

MIRROR_ZONE = "europe-west4-b"  # a zone of both the v5e and the h100 catalog
GPU_VM = dict(mode="gpu-vm", generation="h100", topology="2x8", node_prefix="gpunode",
              zone=MIRROR_ZONE)
# a TPU node's state in the reference's world, and the status of one of
# the slice's host VMs in the port's (the other hosts stay RUNNING)
GPU_STATUS = {"READY": "RUNNING", "PREEMPTED": "TERMINATED", "CREATING": "STAGING"}
TPU_STATE = {v: k for k, v in GPU_STATUS.items()}
TPU_LIST = ["gcloud", "compute", "tpus", "tpu-vm", "list"]
MIRROR_PROBLEMS: list = []  # every command the mirror could not map
# what no gpu-vm heal may print (gke-gpu's refusal is the reference's gke one)
TPU_WORDS = re.compile(r"TPU|tpu-vm|google_tpu|clusterUp\.yml|jax|JAX|libtpu")


def sides(mode: str) -> dict:
    """The two packages for one mode: `tpu-vm` compares like for like;
    `gpu-vm` is the mirrored pair (the port's side has `gpu`)."""
    return {side: types.SimpleNamespace(**vars(m), mirror=mode == "gpu-vm",
                                        gpu=mode == "gpu-vm" and side == "port")
            for side, m in SIDES.items()}


def hosts_of(m) -> int:
    """Host IPs a slice holds in the scripted world."""
    return 2 if getattr(m, "mirror", False) else 1


def cfg(m, **overrides):
    """The config the side's code runs: the port's gpu-vm one on the
    port's side of a mirrored pair, else a tpu-vm one."""
    base = dict(project="my-proj", zone="us-west4-a", generation="v5e", topology="4x4",
                mode="tpu-vm", num_slices=3)
    if getattr(m, "mirror", False):
        base["zone"] = MIRROR_ZONE
    if getattr(m, "gpu", False):
        base.update(GPU_VM)
    base.update(overrides)
    return m.schema.ClusterConfig(**base)


def host_slices(addresses, hosts, kind):
    """The slices whose every host `addresses` names, in order, or None."""
    ks = [int(a.split("[")[1].rstrip("]")) for a in addresses]
    slices = sorted({k // hosts for k in ks})
    want = [f"-{kind}=google_compute_instance.host[{s * hosts + h}]"
            for s in slices for h in range(hosts)]
    return slices if list(addresses) == want else None


class GpuMirror:
    """The port's gpu-vm view of a TPU world (`world.run`, `world.run_quiet`,
    looked up at each call, so a scenario may rewrap them): each GPU command
    is mapped to the reference's, and each listing back."""

    def __init__(self, world, gpu_config):
        self.world = world
        self.config = gpu_config
        self.hosts = gpu_config.hosts_per_slice

    def to_tpu(self, args) -> list:
        args = [str(a) for a in args]
        prefix = self.config.node_prefix
        if args[:4] == ["gcloud", "compute", "instances", "list"]:
            zone = args[4].split("=", 1)[1]
            out = TPU_LIST + [f"--zone={zone}", "--format=value(name,state)"]
            if args[6] == f"--filter=name~^{prefix}-" and len(args) == 7:
                return out
            names = args[6][len("--filter=name:("):-1].split()
            slices = list(dict.fromkeys(int(n.split("-")[1]) for n in names))
            if (names != [f"{prefix}-{s}-{h}" for s in slices for h in range(self.hosts)]
                    or args[7:] != [f"--page-size={len(names)}"]):
                MIRROR_PROBLEMS.append(args)
            tpu_names = " ".join(f"tpunode-{s}" for s in slices)
            return out + [f"--filter=name:({tpu_names})", f"--page-size={len(slices)}"]
        if args[:1] == ["terraform"]:
            for kind in ("replace", "target"):
                flag = f"-{kind}=google_compute_instance.host["
                addresses = [a for a in args if a.startswith(flag)]
                if not addresses:
                    continue
                slices = host_slices(addresses, self.hosts, kind)
                if slices is None:
                    MIRROR_PROBLEMS.append(args)
                    return args
                first = args.index(addresses[0])
                rest = [a for a in args if not a.startswith(flag)]
                return (rest[:first] + [f"-{kind}=google_tpu_v2_vm.slice[{s}]" for s in slices]
                        + rest[first:])
            return args
        if args[:1] == ["ansible-playbook"]:
            if "clusterUpGpu.yml" not in args:
                MIRROR_PROBLEMS.append(args)
            return [("clusterUp.yml" if a == "clusterUpGpu.yml" else a) for a in args]
        return args

    def listing(self, text: str) -> str:
        """A Cloud TPU listing as the gpu-vm hosts would show it."""
        if not text.strip():
            return text
        states = {int(line.split()[0].rsplit("-", 1)[1]): line.split()[1]
                  for line in text.splitlines() if line.strip()}
        lines = []
        for s in range(self.config.num_slices):
            names = [f"{self.config.node_prefix}-{s}-{h}" for h in range(self.hosts)]
            lines.append(f"{names[0]}\tRUNNING")
            if s in states:
                lines += [f"{n}\t{GPU_STATUS.get(states[s], states[s])}" for n in names[1:]]
        return "\n".join(lines)

    def run(self, args, cwd=None, **kwargs):
        return self.world.run(self.to_tpu(args), cwd=cwd, **kwargs)

    def run_quiet(self, args, cwd=None, **kwargs):
        tpu_args = self.to_tpu(args)
        out = self.world.run_quiet(tpu_args, cwd=cwd, **kwargs)
        return self.listing(out) if tpu_args[:5] == TPU_LIST else out


def _slice_addresses(match, hosts) -> str:
    kind = match.group(1)
    addresses = match.group(0).split()
    slices = host_slices(addresses, hosts, kind)
    if slices is None:
        return match.group(0)
    return " ".join(f"-{kind}=google_tpu_v2_vm.slice[{s}]" for s in slices)


def as_tpu(value, hosts=2) -> object:
    """The port's gpu-vm words, as the reference prints them on the
    mirrored tpu-vm world: addresses, playbook, module and listing details."""
    text = json.dumps(value, sort_keys=True)
    text = re.sub(r"-(replace|target)=google_compute_instance\.host\[\d+\]"
                  r"(?: -(?:replace|target)=google_compute_instance\.host\[\d+\])*",
                  lambda match: _slice_addresses(match, hosts), text)
    text = re.sub(r"absent from the Compute Engine listing: gpunode-\d+-\d+(, gpunode-\d+-\d+)*",
                  "absent from the Cloud TPU listing", text)
    text = re.sub(r"host VM status gpunode-\d+-\d+ ([A-Z]+) \(want RUNNING\)",
                  lambda match: f"TPU state {TPU_STATE.get(match.group(1), match.group(1))}",
                  text)
    text = text.replace("clusterUpGpu.yml", "clusterUp.yml").replace("gpu-vm", "tpu-vm")
    return json.loads(text)


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


def slice_ips(i, hosts, net="0"):
    return [f"10.{net}.{i}.{h + 1}" for h in range(hosts)]


def seed_world(m, root, num_slices=3, lost=()):
    paths = m.state.RunPaths(root)
    mode = cfg(m).mode
    paths.terraform_module(mode).mkdir(parents=True)
    hosts = m.state.ClusterHosts(
        host_ips=[slice_ips(i, hosts_of(m)) for i in range(num_slices)],
        internal_ips=[slice_ips(i, hosts_of(m), "1") for i in range(num_slices)],
        coordinator_ip="10.1.0.1",
    )
    for i in lost:
        hosts.host_ips[i] = []
        hosts.internal_ips[i] = []
    hosts.save(paths.hosts_file)
    paths.tfstate(mode).write_text(json.dumps(
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
        self.hosts = hosts_of(m)
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
            ips = [slice_ips(i, self.hosts) for i in range(self.num_slices)]
            for i in self.replaced:
                ips[i] = [self.new_ip] + slice_ips(i, self.hosts, "8")[1:]
            return json.dumps({"host_ips": {"value": ips}, "internal_ips": {"value": [
                slice_ips(i, self.hosts, "1") for i in range(self.num_slices)]}})
        if args and args[0] == "gcloud":
            return "\n".join(f"{n}\t{s}" for n, s in self.listing.items())
        return ""

    def record(self) -> dict:
        return {"calls": self.calls, "ssh": sorted(self.ssh_calls), "replaced": self.replaced}

    def view(self, m):
        """The RunFn pair the side's code runs against."""
        return GpuMirror(self, cfg(m)) if m.gpu else self


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


def compare(scenario, tmp_path, mode="tpu-vm"):
    out = {}
    MIRROR_PROBLEMS.clear()
    for side, m in sides(mode).items():
        root = tmp_path / side
        root.mkdir()
        result = normalized(outcome(lambda: scenario(m, root)), root)
        out[side] = (as_tpu(result) if m.gpu else result) if side == "port" \
            else port_names(result)
    assert MIRROR_PROBLEMS == []
    assert out["port"] == out["reference"]
    return out["port"]


MODES = pytest.mark.parametrize("mode", ["tpu-vm", "gpu-vm"])


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


@MODES
@pytest.mark.parametrize("case", sorted(DIAGNOSE_CASES))
def test_diagnose_matches_the_reference(tmp_path, case, mode):
    seed, world_kwargs, kwargs = DIAGNOSE_CASES[case]

    def scenario(m, root):
        paths, _ = seed_world(m, root, **seed)
        world = World(m, **world_kwargs)
        config = cfg(m, failure_domains=3) if case == "healthy" else cfg(m)
        health = m.heal.diagnose(config, paths, run_quiet=world.view(m).run_quiet, **kwargs)
        return [health_doc(health), world.record()]

    compare(scenario, tmp_path, mode)


@MODES
def test_diagnose_without_a_hosts_record_and_drain_verdicts_match_the_reference(tmp_path, mode):
    def scenario(m, root):
        paths = m.state.RunPaths(root)
        paths.terraform_module(cfg(m).mode).mkdir(parents=True)
        world = World(m)
        out = [health_doc(m.heal.diagnose(cfg(m), paths, run_quiet=world.view(m).run_quiet))]

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

    compare(scenario, tmp_path, mode)


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


@MODES
@pytest.mark.parametrize("case", sorted(HEAL_CASES))
def test_heal_matches_the_reference(tmp_path, case, mode):
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
                m.heal.SliceHealth(0, m.heal.HEALTHY, hosts=tuple(slice_ips(0, hosts_of(m)))),
                m.heal.SliceHealth(1, m.heal.MISSING, "no hosts recorded"),
                m.heal.SliceHealth(2, m.heal.DRAINING, "10.0.2.1: maintenance-event: TERMINATE",
                                   hosts=tuple(slice_ips(2, hosts_of(m)))),
            ])
        say = Say()
        view = world.view(m)
        result = outcome(lambda: m.heal.heal(cfg(m), paths, say, run=view.run,
                                             run_quiet=view.run_quiet, sleep=lambda s: None,
                                             clock=Ticks(), cache=warm, **extra))
        return [result, say.lines, world.record(), files_doc(m, paths, root),
                # the files, the module and the role named as the reference's
                sorted(p.relative_to(root).as_posix().replace("gpu-vm", "tpu-vm")
                       .replace("gpuhost", "tpuhost") for p in root.rglob("*") if p.is_file())]

    result = compare(scenario, tmp_path, mode)
    if case == "lost slice":
        assert result[1][0] == ["ok", True]
        warm = result[1][3]["warm_cache"]
        assert warm["configure-slice-0"] == "prior-key-0"
        assert warm["configure-slice-1"] == ["converged", True]


@pytest.mark.parametrize("mode", ["gke", "gke-gpu"])
def test_heal_refuses_gke_as_the_reference(tmp_path, mode):
    """gke-gpu's node pools self-repair as gke's do: the port refuses it
    with the reference's gke message, word for word."""
    def scenario(m, root):
        config = (cfg(m, mode="gke", topology="2x2") if not m.gpu else
                  cfg(m, mode="gke-gpu", topology="1x8"))
        return outcome(lambda: m.heal.heal(config, m.state.RunPaths(root), Say()))

    result = compare(scenario, tmp_path, "gpu-vm" if mode == "gke-gpu" else "tpu-vm")
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
  *"instances list"*) for s in 0 1 2; do for h in 0 1; do
    printf 'gpunode-%s-%s\\tRUNNING\\n' $s $h; done; done ;;
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


@MODES
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_heal_matches_the_reference(tmp_path, capsys, monkeypatch, stub_world, case, mode):
    seed, flags, bad_ips = CLI_CASES[case]
    seed = dict(seed)
    config_mode = seed.pop("mode", "tpu-vm")
    no_config = seed.pop("no_config", False)
    elsewhere = seed.pop("config_elsewhere", False)
    monkeypatch.setenv("BAD_IPS", bad_ips)
    out = {}
    for side, m in sides(mode).items():
        root = tmp_path / side
        root.mkdir()
        paths, _ = seed_world(m, root, **seed)
        (root / "ansible").mkdir()
        (root / "ansible" / "ansible.cfg").write_text("[defaults]\nprivate_key_file =\n")
        hosts = hosts_of(m)
        ips = [slice_ips(i, hosts) for i in range(3)]
        for i in seed.get("lost", ()):
            ips[i] = ["10.9.9.9"] + slice_ips(i, hosts, "8")[1:]
        (stub_world / "tf_output.json").write_text(json.dumps(
            {"host_ips": {"value": ips},
             "internal_ips": {"value": [slice_ips(i, hosts, "1") for i in range(3)]}}))
        argv = ["heal", "--workdir", str(root), *flags]
        if config_mode == "tpu-vm":
            config = cfg(m)
        else:  # gke; on the port's side of the pair gke-gpu
            config = (cfg(m, mode="gke-gpu", topology="1x8") if m.gpu
                      else cfg(m, mode="gke", topology="2x2"))
        if elsewhere:
            m.store.save_config_file(config, root / "elsewhere.cfg")
            argv += ["--config", str(root / "elsewhere.cfg")]
        elif not no_config:
            m.store.save_config_file(config, paths.config_file)
        rc = m.cli.main(argv)
        captured = capsys.readouterr()
        doc = files_doc(m, paths, root)
        # the ansible documents are the mode's own (tests/test_torch_gpu_plane.py)
        doc["ansible"] = {p.relative_to(root).as_posix(): not m.mirror and p.read_text()
                          for p in sorted((root / "ansible").rglob("*"))
                          if p.is_file() and "files" not in p.parts}
        doc["runlog_phases"] = ([json.loads(line).get("phase") for line in
                                 paths.runlog.read_text().splitlines()]
                                if paths.runlog.exists() else None)
        result = [rc, _timing_free(captured.out), _timing_free(captured.err), doc]
        text = json.dumps(result, sort_keys=True).replace(str(root), "ROOT")
        if m.gpu:
            assert config.mode == "gke-gpu" or not TPU_WORDS.search(text), text
            out[side] = as_tpu(json.loads(text))
        else:
            out[side] = json.loads(text) if side == "port" else port_names(json.loads(text))
    assert out["port"] == out["reference"]
    expected_rc = {"healthy": 0, "lost slice": 0, "gke config": 1, "missing config": 1,
                   "explicit config": 0, "stays broken, max-degraded 1": 0, "stays broken": 1,
                   "fault plan": 1, "bad fault plan": 1}[case]
    assert out["port"][0] == expected_rc
