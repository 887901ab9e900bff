"""The port's prompt primitives (`cli/io.py`) and GCP discovery
(`cli/discovery.py`) against the reference's: scripted input streams give
the same answers, re-prompts, menus, confirmations, printed text and
end-of-input errors; scripted gcloud runners give the same environments,
credential verdicts, zone, network and subnetwork lists and fallbacks;
key discovery and the SSH user answer alike. No tolerance."""

import io
import subprocess
import threading
import types

import pytest

from tritonk8ssupervisor_tpu.cli import discovery as ref_discovery
from tritonk8ssupervisor_tpu.cli import io as ref_io
from tritonk8ssupervisor_tpu_torch.cli import discovery
from tritonk8ssupervisor_tpu_torch.cli import io as port_io

SIDES = {"port": types.SimpleNamespace(io=port_io, discovery=discovery),
         "reference": types.SimpleNamespace(io=ref_io, discovery=ref_discovery)}


def outcome(fn):
    try:
        return ["ok", fn()]
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return [type(e).__name__, str(e)]


PROMPT_CASES = [
    ("ask", "hello\n", lambda p: p.ask("Name", "default")),
    ("ask default", "\n", lambda p: p.ask("Name", "default")),
    ("ask strip", "  spaced  \n", lambda p: p.ask("Name")),
    ("ask eof", "", lambda p: p.ask("Name")),
    ("validated", "BAD\nbad too\nok\n",
     lambda p: p.ask_validated("Host", "d", lambda v: "" if v == "ok" else f"not {v}")),
    ("menu", "2\n", lambda p: p.menu("Pick", ["a", "b", "c"])),
    ("menu default", "\n", lambda p: p.menu("Pick", ["a", "b", "c"], default_index=2)),
    ("menu reprompt", "9\nx\n0\n3\n", lambda p: p.menu("Pick", ["a", "b", "c"])),
    ("menu eof", "9\n", lambda p: p.menu("Pick", ["a", "b"])),
    ("confirm yes", "yes\n", lambda p: p.confirm("Go?")),
    ("confirm y", "Y\n", lambda p: p.confirm("Go?")),
    ("confirm no", "yeah\n", lambda p: p.confirm("Go?")),
    ("confirm default", "\n", lambda p: p.confirm("Go?")),
    ("say", "", lambda p: [p.say("line"), p.say()]),
]


@pytest.mark.parametrize("case", range(len(PROMPT_CASES)))
def test_the_prompter_answers_as_the_reference(case):
    _, text, action = PROMPT_CASES[case]
    out = {}
    for side, m in SIDES.items():
        stream = io.StringIO()
        prompter = m.io.Prompter(io.StringIO(text), stream)
        out[side] = [outcome(lambda: action(prompter)), stream.getvalue()]
    assert out["port"] == out["reference"]


def fake_runner(responses, seen=None, lock=None):
    """responses: {argv suffix after `gcloud`: (returncode, stdout) or an
    exception to raise}; unknown commands fail with rc 1."""
    def run(args, **kwargs):
        if seen is not None:
            with lock:
                seen.append(list(args))
        for key, answer in responses.items():
            if tuple(args[1: 1 + len(key)]) == key:
                if isinstance(answer, Exception):
                    raise answer
                code, out = answer
                return subprocess.CompletedProcess(args, code, stdout=out, stderr="")
        return subprocess.CompletedProcess(args, 1, stdout="", stderr="unknown")

    return run


def zone_runner(offering: set, fail: bool = False):
    def run(args, **kwargs):
        if fail:
            raise subprocess.TimeoutExpired(args, 30)
        zone = next(a.split("=")[1] for a in args if a.startswith("--zone="))
        out = (f"projects/p/locations/{zone}/acceleratorTypes/v5litepod-16\n"
               f"projects/p/locations/{zone}/acceleratorTypes/v6e-8\n"
               if zone in offering else "")
        return subprocess.CompletedProcess(args, 0, stdout=out, stderr="")

    return run


DISCOVERY_RESPONSES = [
    {("config", "get-value", "project"): (0, "my-proj\n"),
     ("config", "get-value", "account"): (0, "me@example.com\n"),
     ("config", "get-value", "compute/zone"): (0, "us-east5-b\n")},
    {("config", "get-value", "project"): (0, "(unset)\n")},
    {("config", "get-value", "project"): OSError("no gcloud")},
    {("auth", "list"): (0, "sa@proj.iam.gserviceaccount.com\nother@x\n")},
    {("auth", "list"): (0, "")},
    {("compute", "networks", "list"): (0, "default\nprod-vpc\n"),
     ("compute", "networks", "subnets"): (0, "subnet-a\n\n")},
    {("compute", "networks", "list"): (0, "")},
    {("compute", "networks", "list"): OSError("no gcloud"),
     ("compute", "networks", "subnets"): subprocess.TimeoutExpired(["gcloud"], 30)},
]


@pytest.mark.parametrize("index", range(len(DISCOVERY_RESPONSES)))
def test_discovery_answers_as_the_reference(index):
    responses = DISCOVERY_RESPONSES[index]
    out = {}
    for side, m in SIDES.items():
        seen, lock = [], threading.Lock()
        run = fake_runner(responses, seen, lock)
        d = m.discovery
        env = d.discover(run)
        results = [vars(env), outcome(lambda: d.require_credentials(env, run)), vars(env),
                   outcome(lambda: d.require_credentials(d.GcloudEnv(account="me@x.com"), run)),
                   d.list_networks("my-proj", run), d.list_networks("", run),
                   d.list_subnetworks("p", "us-west4", "vpc-a", run),
                   d.list_subnetworks("", "r", "", run)]
        out[side] = [results, sorted(seen)]
    assert out["port"] == out["reference"]


ZONE_CASES = [("v5e", {"us-west4-a"}, False), ("v5e", set(), False),
              ("v6e", {"us-east5-b"}, False), ("v5e", {"us-west4-a"}, True),
              ("v4", set(), False), ("v99", set(), False)]


@pytest.mark.parametrize("index", range(len(ZONE_CASES)))
def test_tpu_zones_answer_as_the_reference(index):
    generation, offering, fail = ZONE_CASES[index]
    ours = outcome(lambda: discovery.list_tpu_zones(generation, zone_runner(offering, fail)))
    ref = outcome(lambda: ref_discovery.list_tpu_zones(generation, zone_runner(offering, fail)))
    assert ours == ref
    failing = fake_runner({})
    assert outcome(lambda: discovery.list_tpu_zones(generation, failing)) == outcome(
        lambda: ref_discovery.list_tpu_zones(generation, failing))


def test_ssh_keys_and_user_answer_as_the_reference(tmp_path, monkeypatch, capsys):
    out = {}
    for side, m in SIDES.items():
        d = m.discovery
        results = []
        ssh = tmp_path / side
        ssh.mkdir()
        results.append(outcome(lambda: d.find_ssh_key(ssh)))
        for name in ("id_rsa", "id_ed25519", "google_compute_engine"):
            (ssh / name).write_text("k")
            results.append(d.find_ssh_key(ssh).name)
        monkeypatch.setenv("HOME", str(tmp_path / f"home-{side}"))
        results.append(outcome(lambda: d.find_ssh_key()))
        monkeypatch.setenv("TK8S_SSH_USER", "os-login-user")
        results.append(d.ssh_username())
        monkeypatch.delenv("TK8S_SSH_USER")
        monkeypatch.setattr("getpass.getuser", lambda: "root")
        results += [d.ssh_username(), capsys.readouterr().err]
        monkeypatch.setattr("getpass.getuser", lambda: "alice")
        results += [d.ssh_username(), capsys.readouterr().err]
        text = str(results).replace(str(tmp_path / side), "SSH").replace(
            str(tmp_path / f"home-{side}"), "HOME")
        out[side] = text
    assert out["port"] == out["reference"]
    assert "DiscoveryError" in out["port"] and "root" in out["port"]
