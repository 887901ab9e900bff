"""The port's terraform and ansible wrappers (`provision/terraform.py`,
`provision/ansible.py`) and readiness probing (`provision/readiness.py`)
against the reference's, over the scenarios of tests/test_provision.py:
the same scripted runners see the same command sequences, working
directories and child environments; the same `hosts.json`, tfvars,
inventories and warm-cache records are written; outputs fall back, init
is skipped and `modes_with_state` answers alike; and `poll`,
`AdaptiveInterval`, `FleetSnapshot`, the SSH and GKE probes,
`tpu_vm_states`, `run_probe_job` and `collect_job_diagnostics` give the
same verdicts, errors, sleeps and files under one injected clock. Each
side runs in its own temporary root, replaced by one name before the
comparison; a document that names the package is compared after the
package rename. No tolerance."""

import json
import random
import threading
import types

import pytest

from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.provision import ansible as ref_ansible
from tritonk8ssupervisor_tpu.provision import cache as ref_cache
from tritonk8ssupervisor_tpu.provision import readiness as ref_readiness
from tritonk8ssupervisor_tpu.provision import retry as ref_retry
from tritonk8ssupervisor_tpu.provision import runner as ref_runner
from tritonk8ssupervisor_tpu.provision import state as ref_state
from tritonk8ssupervisor_tpu.provision import terraform as ref_terraform
from tritonk8ssupervisor_tpu_torch.config import schema
from tritonk8ssupervisor_tpu_torch.provision import (
    ansible,
    cache,
    readiness,
    retry,
    runner,
    state,
    terraform,
)

# autouse: the reference compiles the port's TPU cluster smoke, the one
# string the compilers differ in by design (F9, tests/test_torch_compile.py)
from test_torch_compile import port_cluster_smoke  # noqa: E402,F401

SIDES = {
    "port": types.SimpleNamespace(schema=schema, ansible=ansible, cache=cache,
                                  readiness=readiness, retry=retry, runner=runner,
                                  state=state, terraform=terraform),
    "reference": types.SimpleNamespace(schema=ref_schema, ansible=ref_ansible, cache=ref_cache,
                                       readiness=ref_readiness, retry=ref_retry,
                                       runner=ref_runner, state=ref_state,
                                       terraform=ref_terraform),
}


def cfg(m, **overrides):
    base = dict(project="my-proj", zone="us-west4-a", generation="v5e", topology="4x4",
                mode="tpu-vm")
    base.update(overrides)
    return m.schema.ClusterConfig(**base)


def port_names(text: str) -> str:
    return text.replace("tritonk8ssupervisor_tpu", "tritonk8ssupervisor_tpu_torch").replace(
        "tritonk8ssupervisor-tpu", "tritonk8ssupervisor-tpu-torch")


class Recorder:
    """Stands in for run_streaming / run_capture: scripted by command
    prefix, recording each call's argv, working directory and the child
    env's TF_PLUGIN_CACHE_DIR; a prefix in `errors` fails with that exit
    code, as `runner_mod`'s CommandError. Thread-safe (the SSH probes fan
    out)."""

    def __init__(self, responses=None, errors=None, runner_mod=runner):
        self.calls = []
        self.responses = responses or {}
        self.errors = errors or {}
        self.runner_mod = runner_mod
        self.lock = threading.Lock()

    def __call__(self, args, cwd=None, env=None, **kwargs):
        with self.lock:
            self.calls.append([list(map(str, args)), str(cwd),
                               None if env is None else env.get("TF_PLUGIN_CACHE_DIR")])
        for prefix, rc in self.errors.items():
            if tuple(args[: len(prefix)]) == prefix:
                raise self.runner_mod.CommandError(args, rc, tail=f"scripted rc {rc}")
        for prefix, out in self.responses.items():
            if tuple(args[: len(prefix)]) == prefix:
                return out(args) if callable(out) else out
        return ""


def compare(scenario, tmp_path, capsys=None):
    """Run `scenario(m, root)` for each side in its own root and compare
    the results with the roots (and the package name) normalized; the
    captured stdout and stderr of each run are part of the result."""
    out = {}
    for side, m in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        result = outcome(lambda: scenario(m, root))
        if capsys is not None:
            captured = capsys.readouterr()
            result = [result, captured.out, captured.err]
        text = json.dumps(result, sort_keys=True, default=str).replace(str(root), "ROOT")
        out[side] = json.loads(text if side == "port" else port_names(text))
    assert out["port"] == out["reference"]
    return out["port"]


def outcome(fn):
    try:
        return ["ok", fn()]
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return [type(e).__name__, str(e)]


def files(root) -> dict:
    return {str(p.relative_to(root)): p.read_text() for p in sorted(root.rglob("*"))
            if p.is_file() and "files" not in p.parts}


OUTPUTS = {
    "both": {"host_ips": {"value": [["34.1.1.1", "34.1.1.2"]]},
             "internal_ips": {"value": [["10.0.0.1", "10.0.0.2"]]}},
    "external_only": {"host_ips": {"value": [["34.1.1.1"]]}},
    "gke": {"endpoint": {"value": "34.1.2.3"}},
    "empty": {},
}


def make_paths(m, root, mode="tpu-vm"):
    paths = m.state.RunPaths(root)
    paths.terraform_module(mode).mkdir(parents=True, exist_ok=True)
    return paths


# ----------------------------------------------------------------- terraform


@pytest.mark.parametrize("outputs", sorted(OUTPUTS))
@pytest.mark.parametrize("mode", ["tpu-vm", "gke"])
def test_terraform_apply_matches_the_reference(tmp_path, capsys, monkeypatch, mode, outputs):
    monkeypatch.delenv("TF_PLUGIN_CACHE_DIR", raising=False)

    def scenario(m, root):
        paths = make_paths(m, root, mode)
        run = Recorder()
        quiet = Recorder({("terraform", "output", "-json"): json.dumps(OUTPUTS[outputs])})
        first = m.terraform.apply(cfg(m, mode=mode), paths, run=run, run_quiet=quiet)
        (paths.terraform_module(mode) / ".terraform").mkdir()
        second = m.terraform.apply(cfg(m, mode=mode), paths, run=run, run_quiet=quiet)
        return {"hosts": [vars(first), vars(second)], "run": run.calls, "quiet": quiet.calls,
                "files": files(root), "applied": m.terraform.already_applied(cfg(m, mode=mode),
                                                                           paths)}

    result = compare(scenario, tmp_path, capsys)
    assert result[0][0] == "ok"


def test_terraform_env_init_state_and_destroy_match_the_reference(tmp_path, monkeypatch):
    def scenario(m, root):
        paths = make_paths(m, root)
        out = []
        monkeypatch.delenv("TF_PLUGIN_CACHE_DIR", raising=False)
        env = m.terraform.terraform_env(paths, {"PATH": "/bin", "HOME": "h"})
        out.append(env)
        out.append(m.terraform.terraform_env(paths, {"TF_PLUGIN_CACHE_DIR": "/operator/cache"}))
        out.append(m.terraform.init_needed(cfg(m), paths))
        (paths.terraform_module("tpu-vm") / ".terraform").mkdir()
        out.append(m.terraform.init_needed(cfg(m), paths))
        out.append(m.terraform.modes_with_state(paths))
        for body in ('{"resources": []}', '{"resources": [{"type": "x"}]}', "{torn"):
            paths.tfstate("tpu-vm").write_text(body)
            out.append([m.terraform.already_applied(cfg(m), paths),
                        m.terraform.modes_with_state(paths)])
        paths.terraform_module("gke").mkdir(parents=True)
        paths.tfstate("gke").write_text('{"resources": [{"type": "x"}]}')
        out.append(m.terraform.modes_with_state(paths))
        run = Recorder()
        m.terraform.destroy(cfg(m), paths, run=run)
        m.terraform.destroy_mode("gke", paths, run=run)
        paths.tfstate("gke").unlink()
        m.terraform.destroy_mode("gke", paths, run=run)
        out.append(run.calls)
        out.append([m.terraform.slice_replace_addresses([2, 0, 2]),
                    m.terraform.slice_target_addresses([3, 1])])
        return out

    compare(scenario, tmp_path)


@pytest.mark.parametrize("mode,indices", [("tpu-vm", [1]), ("tpu-vm", [2, 0, 2]),
                                          ("tpu-vm", []), ("gke", [1])])
def test_slice_scoped_apply_and_destroy_match_the_reference(tmp_path, capsys, monkeypatch,
                                                            mode, indices):
    monkeypatch.delenv("TF_PLUGIN_CACHE_DIR", raising=False)
    listing = {"host_ips": {"value": [["34.1.0.1"], ["34.9.9.9"], ["34.1.2.1"]]},
               "internal_ips": {"value": [["10.0.0.1"], ["10.0.1.1"], ["10.0.2.1"]]}}

    def scenario(m, root):
        paths = make_paths(m, root, mode)
        run = Recorder()
        quiet = Recorder({("terraform", "output", "-json"): json.dumps(listing)})
        config = cfg(m, mode=mode, num_slices=3)
        applied = outcome(lambda: vars(m.terraform.apply_slices(config, paths, indices, run=run,
                                                                run_quiet=quiet)))
        destroyed = outcome(lambda: m.terraform.destroy_slices(config, paths, indices, run=run))
        return {"applied": applied, "destroyed": destroyed, "run": run.calls,
                "quiet": quiet.calls, "files": files(root)}

    compare(scenario, tmp_path, capsys)


# ------------------------------------------------------------------- ansible


def test_ansible_wrappers_match_the_reference(tmp_path, capsys):
    def scenario(m, root):
        paths = m.state.RunPaths(root)
        paths.ansible_dir.mkdir()
        paths.ansible_cfg.write_text("[defaults]\nhost_key_checking = False\nprivate_key_file =\n")
        out = []
        m.ansible.patch_private_key(paths.ansible_cfg, "/home/me/.ssh/key")
        out.append(paths.ansible_cfg.read_text())
        m.ansible.reset_private_key(paths.ansible_cfg)
        out.append(paths.ansible_cfg.read_text())
        bare = root / "bare.cfg"
        bare.write_text("[defaults]\nforks = 20")
        m.ansible.patch_private_key(bare, "/k")
        out.append(bare.read_text())
        m.ansible.reset_private_key(root / "absent.cfg")
        hosts = m.state.ClusterHosts(host_ips=[["34.1.1.1"], ["34.2.2.1", "34.2.2.2"]],
                                     internal_ips=[["10.0.0.1"], ["10.0.1.1", "10.0.1.2"]],
                                     coordinator_ip="10.0.0.1")
        m.ansible.write_runtime_configs(cfg(m, num_slices=2), hosts, paths, ssh_key="/k",
                                        ansible_user="alice")
        out.append(files(root))
        run = Recorder()
        m.ansible.run_playbook(paths, run=run)
        m.ansible.run_playbook(paths, run=run, extra_args=["--limit", "34.1.1.1"])
        out.append(run.calls)
        warm = m.cache.WarmCache(paths.warm_cache)
        lines = []
        converged = [m.ansible.converge_slice(cfg(m, num_slices=2), paths, hosts, i, run=run,
                                              cache=c, ssh_key="/k", ssh_user="alice",
                                              echo=lines.append)
                     for i, c in ((0, warm), (0, warm), (1, warm), (5, warm), (1, None))]
        out += [converged, lines, run.calls[2:], sorted(warm._load())]
        key = m.cache.converge_key(paths, 0, ["34.1.1.1"], ssh_key="/k", ansible_user="alice")
        out.append(warm._load()["configure-slice-0"]["key"] == key)
        return out

    result = compare(scenario, tmp_path, capsys)
    assert result[0][1][-1] is True and result[0][1][5] == [True, False, True, False, True]


# ----------------------------------------------------------------- readiness


def gke_node(name, tpu="8", ready=True):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"google.com/tpu": tpu, "cpu": "96"},
                       "conditions": [{"type": "Ready",
                                       "status": "True" if ready else "False"}]}}


GKE_LISTINGS = [
    {"items": [gke_node("n1")]},
    {"items": [gke_node("n1"), gke_node("n2", ready=False)]},
    {"items": [gke_node("n1"), gke_node("n2")]},
    {"items": [gke_node("n1"), gke_node("n2", tpu="0")]},
    {"items": [gke_node("n1"), gke_node("n2"), gke_node("n3")]},
    {"items": []},
    "not json",
]


def test_gke_and_tpu_vm_probes_match_the_reference(tmp_path):
    def scenario(m, root):
        config = cfg(m, mode="gke")
        out = [outcome(lambda: m.readiness.gke_tpu_probe(
            config, Recorder({("kubectl",): doc if isinstance(doc, str) else json.dumps(doc)})))
            for doc in GKE_LISTINGS]
        for listing, names in [("n-0\tCREATING\nn-1\tREADY\n", ["n-0", "n-1", "n-2"]),
                               ("n-0\tREADY\nn-1\tREADY\n", ["n-0", "n-1"]),
                               ("projects/p/locations/z/nodes/n-0\tREADY\n", ["n-0"]),
                               ("n-0\tREADY\nprojects/p/locations/z/nodes/n-1\tCREATING\nn-2\n",
                                ["n-2"])]:
            quiet = Recorder({("gcloud",): listing})
            out.append([m.readiness.tpu_vm_probe(cfg(m), names, quiet),
                        m.readiness.tpu_vm_states(cfg(m), quiet),
                        m.readiness.tpu_vm_states(cfg(m), quiet, names=names), quiet.calls])
        return out

    compare(scenario, tmp_path)


SSH_CASES = [
    ({}, ["10.0.0.1", "10.0.0.2"], "alice", "/k"),
    ({"10.0.0.9": 255}, ["10.0.0.9"], "", ""),
    ({"10.0.0.2": 255, "10.0.0.4": 124}, [f"10.0.0.{i}" for i in range(1, 5)], "", "/k"),
    ({}, [], "", ""),
]


@pytest.mark.parametrize("index", range(len(SSH_CASES)))
def test_ssh_probes_match_the_reference(tmp_path, monkeypatch, index):
    bad, ips, user, key = SSH_CASES[index]
    slices = [ips[:1], ips[1:], []]

    def scenario(m, root):
        def quiet(args, cwd=None, **kwargs):
            with lock:
                seen.append(list(args))
            if args[-2] in bad:
                raise m.runner.CommandError(args, bad[args[-2]])
            return ""

        lock, seen = threading.Lock(), []
        out = [m.readiness.ssh_ready_probe(ips, ssh_user=user, ssh_key=key, run_quiet=quiet),
               m.readiness.ssh_ready_probe(ips, run_quiet=quiet, max_workers=1,
                                           connect_timeout=9),
               m.readiness.slice_ssh_verdicts(slices, ssh_user=user, ssh_key=key,
                                              run_quiet=quiet),
               m.readiness.slice_ssh_verdicts(slices, run_quiet=quiet, only_slices=[1])]
        monkeypatch.setenv("TK8S_PROBE_WORKERS", "2")
        out.append(m.readiness.probe_workers())
        monkeypatch.setenv("TK8S_PROBE_WORKERS", "x")
        out.append(m.readiness.probe_workers())
        monkeypatch.delenv("TK8S_PROBE_WORKERS")
        out.append(sorted(seen))  # the probes run concurrently: compare the set of calls
        return out

    compare(scenario, tmp_path)


def test_a_hung_host_blocks_no_other_probe_in_either_package():
    """Every host's probe waits at one barrier, so the probes meet only if
    they run concurrently; the hung host's verdict names it. No clock."""
    for m in SIDES.values():
        ips = [f"10.0.0.{i}" for i in range(8)]
        barrier = threading.Barrier(len(ips), timeout=60)

        def quiet(args, cwd=None, _m=m, _barrier=barrier, **kwargs):
            _barrier.wait()
            if args[-2] == "10.0.0.5":
                raise _m.runner.CommandError(args, 124)
            return ""

        why = m.readiness.ssh_ready_probe(ips, run_quiet=quiet)
        assert why == "1/8 host(s) ssh not ready: 10.0.0.5 (rc 124)"


POLL_CASES = [
    (["booting", "booting", ""], dict(interval=0.0, timeout=60)),
    (["stuck"] * 4, dict(interval=0.0, timeout=0.0)),
    (["booting"] * 10, dict(interval=15.0, timeout=40.0)),
    (["booting", "booting", ""], dict(interval=15.0, timeout=40.0)),
    (["booting", "booting", "booting", "ssh pending", ""], dict(timeout=900.0, adapt=True)),
    (["a", "a", "a", "a", "a", "a", "a", "b", "b", ""], dict(timeout=300.0, adapt=True)),
    (["err", "x", ""], dict(interval=1.0, timeout=10.0)),
    (["fatal"], dict(interval=1.0, timeout=10.0)),
]


@pytest.mark.parametrize("index", range(len(POLL_CASES)))
def test_poll_matches_the_reference(tmp_path, index):
    verdicts, kwargs = POLL_CASES[index]

    def scenario(m, root):
        script, clock, sleeps, lines = list(verdicts), {"t": 0.0}, [], []

        def sleep(s):
            sleeps.append(s)
            clock["t"] += s

        def probe():
            why = script.pop(0) if script else verdicts[-1]
            if why == "err":
                raise OSError("api hiccup")
            if why == "fatal":
                raise m.readiness.NotReadyError("Job Failed")
            return why

        extra = dict(kwargs)
        if extra.pop("adapt", False):
            extra["adapt"] = m.readiness.AdaptiveInterval(base=5.0, max_interval=45.0,
                                                          rng=random.Random(7).random)
        result = outcome(lambda: m.readiness.poll(probe, sleep=sleep, echo=lines.append,
                                                  clock=lambda: clock["t"], **extra))
        return [result, sleeps, lines, clock["t"]]

    compare(scenario, tmp_path)


def test_adaptive_interval_matches_the_reference(tmp_path):
    def scenario(m, root):
        out = []
        for seed, base, cap in ((0, 2.0, 15.0), (1, 5.0, 45.0), (2, 1.0, 1.0)):
            adapt = m.readiness.AdaptiveInterval(base=base, max_interval=cap,
                                                 rng=random.Random(seed).random)
            prev, seq = adapt.base, []
            for _ in range(20):
                prev = adapt.next(prev)
                seq.append(prev)
            out.append(seq)
        return out

    result = compare(scenario, tmp_path)
    assert all(2.0 <= x <= 15.0 for x in result[1][0])


def test_fleet_snapshot_matches_the_reference(tmp_path):
    def scenario(m, root):
        out = []
        clock = {"t": 0.0}
        quiet = Recorder({("gcloud",): "n-0\tREADY\n"})
        config = cfg(m)
        snap = m.readiness.FleetSnapshot(config, run_quiet=quiet, ttl=10.0,
                                         clock=lambda: clock["t"])
        out += [snap.states(), m.readiness.tpu_vm_probe(config, ["n-0"], snapshot=snap),
                snap.fetches, snap.page_count]
        clock["t"] = 11.0
        snap.states()
        snap.invalidate()
        snap.states()
        out += [snap.fetches, snap.staleness(), snap.states(max_age=0.0), snap.fetches]
        out.append(quiet.calls)

        # a failed fetch is not cached
        flip = {"fail": True}

        def flaky(args, cwd=None, **kwargs):
            if flip["fail"]:
                raise m.runner.CommandError(args, 1, tail="503")
            return "n-0\tREADY\n"

        snap = m.readiness.FleetSnapshot(config, run_quiet=flaky, ttl=1000.0)
        out.append(outcome(snap.states))
        flip["fail"] = False
        out += [snap.states(), snap.fetch_errors, snap.last_error]

        # paged fetch over ten slices, four to a page
        config10 = cfg(m, num_slices=10)
        listing = "\n".join(f"{config10.node_prefix}-{i}\tREADY" for i in range(10))
        paged = Recorder({("gcloud",): listing})
        clock["t"] = 0.0
        snap = m.readiness.FleetSnapshot(config10, run_quiet=paged, ttl=10.0,
                                         clock=lambda: clock["t"], page_size=4)
        out += [snap.page_count, snap.states()]
        snap.states()
        clock["t"] = 11.0
        snap.states()
        out += [snap.fetches, paged.calls]

        # a quota throttle serves the last good copy stale and backs off
        config2 = cfg(m, num_slices=2)
        throttle = {"on": False}
        calls = []

        def quota(args, cwd=None, **kwargs):
            calls.append(list(args))
            if throttle["on"]:
                raise m.runner.CommandError(args, 1, tail="ERROR: 429 Too Many Requests")
            return f"{config2.node_prefix}-0\tREADY\n{config2.node_prefix}-1\tREADY"

        clock["t"] = 0.0
        snap = m.readiness.FleetSnapshot(config2, run_quiet=quota, ttl=5.0,
                                         clock=lambda: clock["t"], page_size=1)
        seq = [snap.states(), snap.fetches]
        throttle["on"] = True
        clock["t"] = 6.0
        seq += [snap.states(), snap.fetch_errors, snap.served_stale, snap.last_error,
                sorted(snap.parked_slices())]
        clock["t"] = 12.0
        seq += [snap.states(), len(calls), snap.served_stale, snap.staleness()]
        throttle["on"] = False
        clock["t"] = 6.0 + m.retry.QUOTA_BACKOFF_FLOOR + 1.0
        seq += [snap.states(), len(calls), snap.staleness(), sorted(snap.parked_slices())]
        out.append(seq)
        return out

    compare(scenario, tmp_path)


def job_json(conditions=None, succeeded=0, completions=2):
    return json.dumps({"spec": {"completions": completions},
                       "status": {"conditions": conditions or [], "succeeded": succeeded}})


FAILED = [{"type": "Failed", "status": "True", "message": "BackoffLimitExceeded"}]
PROBE_CASES = [
    ({("kubectl", "get", "job"): job_json([{"type": "Complete", "status": "True"}])}, {}, {}),
    ({("kubectl", "get", "job"): job_json(FAILED),
      ("kubectl", "get", "pods"): json.dumps({"items": [{"metadata": {"name": "tpu-probe-0-a"}}]}),
      ("kubectl", "logs"): "ImportError: libtpu not found",
      ("kubectl", "get", "events"): "28s Warning FailedScheduling pod/tpu-probe-0-a"}, {}, {}),
    ({("kubectl", "get", "job"): job_json(FAILED)},
     {("kubectl", "get", "pods"): 1, ("kubectl", "get", "events"): 1}, {}),
    ({("kubectl", "get", "job"): job_json(succeeded=1)}, {}, {"timeout_seconds": 0.0}),
    ({("kubectl", "get", "job"): job_json(succeeded=1),
      ("kubectl", "get", "pods"): "not-json"}, {}, {"timeout_seconds": 0.0, "image": "img"}),
    ({("kubectl", "get", "job"): job_json([{"type": "Complete", "status": "True"}])}, {},
     {"delete_fails": True}),
]


@pytest.mark.parametrize("index", range(len(PROBE_CASES)))
def test_run_probe_job_matches_the_reference(tmp_path, capsys, index):
    responses, errors, kwargs = PROBE_CASES[index]
    kwargs = dict(kwargs)
    delete_fails = kwargs.pop("delete_fails", False)

    def scenario(m, root):
        run = Recorder(errors={("kubectl", "delete"): 1} if delete_fails else None,
                       runner_mod=m.runner)
        quiet = Recorder(responses, errors, runner_mod=m.runner)
        result = outcome(lambda: m.readiness.run_probe_job(
            cfg(m, mode="gke"), root / "probe", run=run, run_quiet=quiet, sleep=lambda s: None,
            **kwargs))
        return [result, run.calls, quiet.calls, files(root)]

    compare(scenario, tmp_path, capsys)


def test_collect_job_diagnostics_matches_the_reference(tmp_path):
    def scenario(m, root):
        def broken(args, cwd=None, **kwargs):
            raise RuntimeError("connection refused")

        out = [m.readiness.collect_job_diagnostics("j", root, run_quiet=broken),
               (root / "diagnostics" / "j").exists()]
        partial = Recorder({("kubectl", "get", "pods"): "not-json"})
        out.append(m.readiness.collect_job_diagnostics("j2", root, run_quiet=partial))
        full = Recorder({("kubectl", "get", "pods"): json.dumps(
            {"items": [{"metadata": {"name": "a"}}, {"metadata": {"name": "b"}}]}),
            ("kubectl", "logs"): "log line"})
        out += [m.readiness.collect_job_diagnostics("j3", root, run_quiet=full), full.calls,
                files(root)]
        return out

    compare(scenario, tmp_path)


def test_the_smoke_command_is_the_compiler_s():
    assert readiness.jax_smoke_command(8) == ref_readiness.jax_smoke_command(8)
    from tritonk8ssupervisor_tpu_torch.config import compile as cc

    assert readiness.jax_smoke_command is cc.jax_smoke_command
