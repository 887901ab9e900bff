"""The port's teardown (`provision/teardown.py`) against the reference's:
the cases of tests/test_provision.py (a full scrub, a re-run over partial
residue, the journal scrubbed last after a crashed clean, an abort), of
tests/test_fleet.py (the fleet's journal and demand-signal shards) and of
tests/test_obs.py (the span log and the metrics snapshot), each run
through both packages in its own temporary root. Both give equal return
values, commands, printed lines and files left behind, with the roots
replaced by one name. No tolerance."""

import inspect
import io
import json
import types

import pytest

from tritonk8ssupervisor_tpu.cli import io as ref_io
from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.provision import ansible as ref_ansible
from tritonk8ssupervisor_tpu.provision import journal as ref_journal
from tritonk8ssupervisor_tpu.provision import state as ref_state
from tritonk8ssupervisor_tpu.provision import teardown as ref_teardown
from tritonk8ssupervisor_tpu_torch.cli import io as cli_io
from tritonk8ssupervisor_tpu_torch.config import schema
from tritonk8ssupervisor_tpu_torch.provision import ansible, journal, state, teardown

SIDES = {
    "port": types.SimpleNamespace(io=cli_io, schema=schema, ansible=ansible, journal=journal,
                                  state=state, teardown=teardown),
    "reference": types.SimpleNamespace(io=ref_io, schema=ref_schema, ansible=ref_ansible,
                                       journal=ref_journal, state=ref_state,
                                       teardown=ref_teardown),
}


def cfg(m, **overrides):
    base = dict(project="my-proj", zone="us-west4-a", generation="v5e", topology="4x4",
                mode="tpu-vm")
    base.update(overrides)
    return m.schema.ClusterConfig(**base)


class Recorder:
    """A RunFn that records every command and returns nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, args, cwd=None, **kwargs):
        self.calls.append(" ".join(str(a) for a in args))
        return ""


def tree(root) -> dict:
    return {p.relative_to(root).as_posix(): p.read_text()
            for p in sorted(root.rglob("*")) if p.is_file()}


def prompter(m, answers: str):
    out = io.StringIO()
    return m.io.Prompter(io.StringIO(answers), out), out


def make_paths(m, root):
    paths = m.state.RunPaths(root)
    paths.terraform_module("tpu-vm").mkdir(parents=True, exist_ok=True)
    return paths


def journal_of(m, paths):
    return m.journal.Journal(paths.journal, clock=lambda: 1000.0, echo=lambda line: None)


def case_full_scrub(m, root):
    paths = make_paths(m, root)
    paths.tfstate("tpu-vm").write_text(json.dumps({"resources": [{}]}))
    paths.tfvars("tpu-vm").write_text("{}")
    m.state.ClusterHosts(host_ips=[["10.0.0.1"]], coordinator_ip="10.0.0.1").save(
        paths.hosts_file)
    paths.ansible_dir.mkdir()
    paths.ansible_cfg.write_text("[defaults]\nprivate_key_file = /k\n")
    paths.inventory.write_text("[TPUHOST]\n10.0.0.1\n")
    (paths.ansible_dir / "group_vars").mkdir()
    (paths.ansible_dir / "group_vars" / "all.yml").write_text("x: 1\n")
    paths.manifests_dir.mkdir(parents=True)
    (paths.manifests_dir / "job.yaml").write_text("{}")
    paths.config_file.write_text("PROJECT=my-proj\n")
    paths.runlog.write_text("{}\n")
    paths.supervisor_pid.write_text("99999999\n")  # a crashed supervisor's lock
    run = Recorder()
    ask, out = prompter(m, "yes\n")
    ok = m.teardown.clean(cfg(m), paths, ask, run=run)
    assert ok is True
    assert any(c.startswith("terraform destroy") for c in run.calls)
    assert "ssh-keygen -R 10.0.0.1" in run.calls
    for gone in (paths.tfstate("tpu-vm"), paths.tfvars("tpu-vm"), paths.hosts_file,
                 paths.inventory, paths.config_file, paths.runlog, paths.manifests_dir,
                 paths.supervisor_pid):
        assert not gone.exists(), gone
    assert "private_key_file = " in paths.ansible_cfg.read_text()
    return [ok, run.calls, out.getvalue(), tree(root)]


def case_idempotent_over_partial_residue(m, root):
    paths = make_paths(m, root)
    paths.config_file.write_text("PROJECT=my-proj\n")
    paths.hosts_file.parent.mkdir(parents=True, exist_ok=True)
    paths.hosts_file.write_text('{"host_ips": [["10.0')  # torn record
    paths.quarantine_file.write_text('{"slices": {}}')
    journal_of(m, paths).note_running("terraform-apply", "h", 1)
    run = Recorder()
    ask, out = prompter(m, "yes\nyes\n")
    first = m.teardown.clean(cfg(m), paths, ask, run=run)
    assert first is True
    assert not paths.journal.exists() and not paths.quarantine_file.exists()
    paths.config_file.write_text("PROJECT=my-proj\n")
    second = m.teardown.clean(cfg(m), paths, ask, run=run)
    assert second is True
    return [first, second, run.calls, out.getvalue(), tree(root)]


def case_journal_scrubbed_last(m, root, monkeypatch):
    paths = make_paths(m, root)
    paths.config_file.write_text("PROJECT=my-proj\n")
    journal_of(m, paths).note_done("terraform-apply", "h")

    def exploding_reset(ansible_cfg):
        raise OSError("disk went away mid-clean")

    monkeypatch.setattr(m.ansible, "reset_private_key", exploding_reset)
    ask, out = prompter(m, "yes\n")
    with pytest.raises(OSError, match="mid-clean"):
        m.teardown.clean(cfg(m), paths, ask, run=Recorder())
    assert paths.journal.exists()
    crashed = tree(root)
    monkeypatch.undo()
    paths.config_file.write_text("PROJECT=my-proj\n")
    ask, again = prompter(m, "yes\n")
    ok = m.teardown.clean(cfg(m), paths, ask, run=Recorder())
    assert ok is True and not paths.journal.exists()
    return [crashed, ok, out.getvalue(), again.getvalue(), tree(root)]


def case_abort_leaves_everything(m, root):
    paths = make_paths(m, root)
    paths.config_file.write_text("PROJECT=my-proj\n")
    run = Recorder()
    ask, out = prompter(m, "no\n")
    ok = m.teardown.clean(cfg(m), paths, ask, run=run)
    assert ok is False and run.calls == [] and paths.config_file.exists()
    return [ok, out.getvalue(), tree(root)]


def case_fleet_shards_and_telemetry(m, root):
    paths = m.state.RunPaths(root)
    paths.config_file.write_text("PROJECT=my-proj\n")
    doomed = [paths.request_log, paths.demand_signal, paths.span_log, paths.metrics_snapshot,
              paths.fleet_status, paths.job_ack, paths.events]
    for rid in ("g0", "g1", "g2"):
        doomed += [paths.request_log_replica(rid), paths.demand_signal_replica(rid)]
    for artifact in doomed:
        artifact.write_text("{}\n")
    ask, out = prompter(m, "yes\nyes\n")
    ok = m.teardown.clean(cfg(m), paths, ask, run=lambda args, cwd=None, **kwargs: "")
    assert ok is True
    for artifact in doomed:
        assert not artifact.exists(), artifact
    source = inspect.getsource(m.teardown.clean)
    assert "span_log" in source and "metrics_snapshot" in source
    return [ok, out.getvalue(), tree(root)]


CASES = {
    "full scrub": case_full_scrub,
    "idempotent over partial residue": case_idempotent_over_partial_residue,
    "journal scrubbed last": case_journal_scrubbed_last,
    "abort leaves everything": case_abort_leaves_everything,
    "fleet shards and telemetry": case_fleet_shards_and_telemetry,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_teardown_matches_the_reference(tmp_path, monkeypatch, name):
    case = CASES[name]
    out = {}
    for side, m in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        args = (m, root, monkeypatch) if "monkeypatch" in inspect.signature(case).parameters \
            else (m, root)
        text = json.dumps(case(*args), sort_keys=True).replace(str(root), "ROOT")
        out[side] = json.loads(text)
    assert out["port"] == out["reference"]
