"""The port's static validators (`infra/hcl.py`, `infra/ansiblecheck.py`)
against the reference's: both modes' `terraform/` modules and the crafted
defects of tests/test_hcl.py parse to the same blocks and give the same
problems, tfvars drift and plan renderings (and the plans equal the
goldens in tests/goldens/); the playbook under `ansible/`, crafted task
defects and the roles' jinja conditions give the same verdicts; and the
port's `to_ansible_vars` covers every variable the roles consume. The
shared trees are read, never written. No tolerance."""

import json
import re
import warnings
from pathlib import Path

import pytest
import yaml

from tritonk8ssupervisor_tpu.config import compile as ref_cc
from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.infra import ansiblecheck as ref_ac
from tritonk8ssupervisor_tpu.infra import hcl as ref_hcl
from tritonk8ssupervisor_tpu_torch.config import compile as cc
from tritonk8ssupervisor_tpu_torch.config import schema
from tritonk8ssupervisor_tpu_torch.infra import ansiblecheck as ac
from tritonk8ssupervisor_tpu_torch.infra import hcl

REPO = Path(__file__).resolve().parent.parent
GOLDENS = Path(__file__).resolve().parent / "goldens"
SIDES = {"port": (hcl, ac, cc, schema), "reference": (ref_hcl, ref_ac, ref_cc, ref_schema)}


def cfg(side, **overrides):
    base = dict(project="golden-proj", zone="us-west4-a", generation="v5e",
                topology="4x4", num_slices=2)
    base.update(overrides)
    return SIDES[side][3].ClusterConfig(**base)


def outcome(fn):
    """fn()'s value with the warnings it gave, or what it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = ["ok", fn()]
        except Exception as e:  # noqa: BLE001 - the message is what is compared
            value = [type(e).__name__, str(e)]
    return value + [[str(w.message) for w in caught]]


def blocks(module) -> list:
    return [(b.kind, list(b.labels)) for b in module.blocks]


SNIPPETS = [
    ('variable "a" { default = 1 }\n'
     'resource "x" "y" { name = var.missing\n idx = count.index }\n', {}),
    ('resource "google_a" "x" { name = google_container_cluster.nope.name }\n', {}),
    ('data "google_project" "p" { }\n'
     'resource "google_a" "x" { num = data.google_project.p.number }\n', {}),
    ('resource "google_a" "x" { num = data.google_project.nope.number }\n', {}),
    ('resource "x" "y" { name = "${var.prefix}-0" }\n', {}),
    ('variable "needed" {}\nvariable "opt" { default = 1 }\n'
     'resource "x" "y" { a = var.needed  b = var.opt }\n', {"stray": 1}),
    ('\nvariable "startup" { default = "x" }\nvariable "net" {}\n'
     'resource "google_tpu_v2_vm" "slice" {\n  metadata = {\n    startup-script = <<-EOT\n'
     '    #!/bin/bash\n    echo ${var.startup}\n    EOT\n  }\n  network = var.net\n}\n'
     'output "ips" {\n  value = google_tpu_v2_vm.slice[*].network_endpoints\n}\n'
     'output "alt" {\n  value = google_tpu_v2_vm.slice.*.network_endpoints\n}\n', {"net": "n"}),
    ('resource "x" "y" {\n  a = <<EOF\n${var.ghost}\nEOF\n}\n', {}),
    ('variable "names" { default = "a" }\n'
     'resource "x" "y" {\n  s = <<EOF\n${join(",", var.names)}\nEOF\n}\n', {}),
    ('resource "x" "y" {\n  s = <<EOT\nEOTlike line\nEOT\n}\n', {}),
    ('resource "x" "y" {\n  s = <<EOF\nEOF\n}\n', {}),
    ('resource "x" "y" {\n  s = <<EOF\nline1\nline2 "quoted"\nEOF\n}\n', {}),
    ('resource "google_tpu_v2_vm" "slice" { name = "s" }\n'
     'output "ips" { value = google_tpu_v2_vm.slice[*].network_endpoints }\n', {}),
    ('variable "objs" { default = [] }\nresource "x" "y" { ids = var.objs[*].id }\n',
     {"objs": [{"id": "a"}, {"id": "b"}]}),
    ('variable "xs" { default = [] }\nresource "x" "y" { firsts = var.xs[*][0] }\n',
     {"xs": [["a1", "a2"], ["b1", "b2"]]}),
    ('variable "xs" { default = [] }\nresource "x" "y" { v = var.xs[*].ids[1] }\n',
     {"xs": [{"ids": ["a1", "a2"]}, {"ids": ["b1", "b2"]}]}),
    ('resource "x" "y" {\n  s = "${%%not-grammar%%}"\n}\n', {}),
    ('resource "x" "y" {\n  m = {for k, v in var.tags : k => v}\n}\n', {}),
    ('resource "x" "y" { name = var.never_declared }\n', {}),
    ('resource "x" "y" { unclosed = \n', {}),
]


def describe_snippet(side: str, text: str, tfvars: dict) -> list:
    mod = SIDES[side][0]
    parsed = outcome(lambda: mod.parse_hcl(text))
    if parsed[0] != "ok":
        return parsed
    module = parsed[1]
    return [blocks(module), outcome(lambda: mod.validate_module(module)),
            outcome(lambda: mod.check_tfvars(module, tfvars)),
            outcome(lambda: mod.render_plan(module, tfvars))]


@pytest.mark.parametrize("index", range(len(SNIPPETS)))
def test_crafted_hcl_gives_the_reference_s_verdicts(index):
    text, tfvars = SNIPPETS[index]
    assert describe_snippet("port", text, tfvars) == describe_snippet("reference", text, tfvars)


TFVARS_CASES = [{}, {"num_slices": 3}, {"topology": "2x2"}, {"broad_node_scopes": True},
                {"num_slices": 1, "project": "p2"}]


@pytest.mark.parametrize("mode", ["tpu-vm", "gke"])
def test_the_modules_give_the_reference_s_validation_and_plans(mode):
    out = {}
    for side in SIDES:
        mod, _, comp, _ = SIDES[side]
        module = mod.parse_module_dir(REPO / "terraform" / mode)
        out[side] = [blocks(module), mod.validate_module(module)]
        for overrides in TFVARS_CASES:
            tfvars = comp.to_tfvars(cfg(side, mode=mode, **overrides))
            out[side] += [tfvars, mod.check_tfvars(module, tfvars),
                          outcome(lambda: mod.render_plan(module, tfvars))]
        out[side].append(mod.check_tfvars(module, {"stray": 1}))
    assert out["port"] == out["reference"]
    assert out["port"][1] == []
    module = hcl.parse_module_dir(REPO / "terraform" / mode)
    plan = hcl.render_plan(module, cc.to_tfvars(cfg("port", mode=mode)))
    assert plan == json.loads((GOLDENS / f"plan_{mode}.json").read_text())


def test_the_playbook_and_crafted_tasks_give_the_reference_s_verdicts():
    bad = [
        {"no_name_module": {}},
        {"name": "two modules", "ansible.builtin.copy": {}, "ansible.builtin.shell": "x"},
        {"name": "bad when", "ansible.builtin.command": "x", "when": "foo |"},
        {"name": "retries without until", "ansible.builtin.command": "x", "retries": 3},
        {"name": "ok", "ansible.builtin.command": "x", "until": "r.rc == 0", "retries": 3},
        {"name": "unknown module", "community.general.thing": {}},
    ]
    out = {}
    for side in SIDES:
        check = SIDES[side][1]
        out[side] = [check.validate_playbook(REPO / "ansible", {"TPUHOST", "LOCAL"}),
                     check.validate_playbook(REPO / "ansible", {"TPUHOST"}),
                     check.validate_tasks(bad, "test")]
    assert out["port"] == out["reference"]
    assert out["port"][0] == [] and len(out["port"][2]) >= 4


def _tasks(role: str) -> list:
    return yaml.safe_load((REPO / "ansible" / "roles" / role / "tasks" / "main.yml").read_text())


def test_the_roles_conditions_evaluate_as_the_reference_s():
    wait = next(t for t in _tasks("gkejoin") if "node registration" in t["name"])
    tpuhost = _tasks("tpuhost")
    jax_install = next(t for t in tpuhost if t["name"] == "Install JAX with libtpu")
    pkg_install = next(t for t in tpuhost if t["name"] == "Install the framework package")
    cases = [(wait["until"], {"tpu_alloc": {"stdout": stdout}, "expected_total_chips": chips})
             for stdout in ("8 8", "8", "", "8 0 8", " 8  8 ", "4 4") for chips in (16, 8)]
    cases += [(jax_install["when"], {"jax_installed": {"stdout_lines": installed.splitlines()},
                                     "jax_version": "0.4.38"})
              for installed in ("Version: 0.4.38", "Version: 0.4.30", "", "Version: 0.4.38.1")]
    cases += [(pkg_install["when"], {"pkg_copy": {"changed": changed},
                                     "pkg_installed": {"stdout_lines": installed.splitlines()},
                                     "pkg_version": "0.1.0"})
              for changed in (True, False)
              for installed in ("Version: 0.1.0", "Version: 0.0.9", "Version: 0.1.0rc1",
                                "Version: 0.1.01")]
    cases += [("foo |", {}), ("x | int > 2", {"x": "3"}), ("undefined_var", {})]
    ours = [outcome(lambda: ac.evaluate_expression(e, v)) for e, v in cases]
    ref = [outcome(lambda: ref_ac.evaluate_expression(e, v)) for e, v in cases]
    assert ours == ref


def test_the_port_s_ansible_vars_cover_what_the_roles_consume():
    """As tests/test_infra.py holds the reference's: every templated var
    the roles read comes from the port's generated vars, its inventory's
    hostvars or the role defaults, and the per-cluster ones from the
    generator."""
    config = cfg("port", num_slices=1)
    generated = set(cc.to_ansible_vars(config, coordinator_ip="10.0.0.1"))
    inventory = cc.to_inventory(config, [["10.0.0.1", "10.0.0.2"]])
    provided = generated | set(re.findall(r"(\w+)=", inventory))
    defaults: set = set()
    consumed: set = set()
    for role in ("tpuhost", "gkejoin"):
        role_dir = REPO / "ansible" / "roles" / role
        defaults |= set(yaml.safe_load((role_dir / "defaults" / "main.yml").read_text()) or {})
        text = (role_dir / "tasks" / "main.yml").read_text()
        consumed |= set(re.findall(r"{{\s*(\w+)", text))
        consumed |= set(re.findall(r"when: (\w+)\s*==", text))
        consumed |= set(re.findall(r"when: \((\w+)", text))
        consumed |= set(re.findall(r"until: \((\w+)", text))
    consumed -= {"jax_installed", "jax_install", "jax_smoke", "tpu_alloc", "n", "watch_unit",
                 "cluster_smoke"}
    assert not consumed - provided - defaults
    per_cluster = {"hosts_per_slice", "num_slices", "expected_total_chips",
                   "expected_devices_per_host", "cluster_name", "project", "zone", "mode",
                   "jax_smoke_cmd", "cluster_smoke_cmd"}
    assert per_cluster <= generated
    role_defaults = yaml.safe_load(
        (REPO / "ansible" / "roles" / "tpuhost" / "defaults" / "main.yml").read_text())
    assert role_defaults["jax_version"] == cc.JAX_VERSION_PIN


def test_the_precheck_warns_rejects_and_passes_as_the_reference_s(tmp_path, capsys):
    from tritonk8ssupervisor_tpu.provision import state as ref_state
    from tritonk8ssupervisor_tpu.provision import terraform as ref_terraform
    from tritonk8ssupervisor_tpu_torch.provision import state, terraform

    pairs = {"port": (terraform, state), "reference": (ref_terraform, ref_state)}
    bodies = {"unsupported": 'resource "x" "y" {\n  m = {for k, v in var.tags : k => v}\n}\n',
              "broken": 'resource "x" "y" { name = var.never_declared }\n'}
    out = {}
    for side, (tf, st) in pairs.items():
        results = []
        for name, body in bodies.items():
            module_dir = tmp_path / side / name / "terraform" / "tpu-vm"
            module_dir.mkdir(parents=True)
            (module_dir / "main.tf").write_text(body)
            results.append(outcome(lambda: tf.precheck(cfg(side, mode="tpu-vm"),
                                                       st.RunPaths(tmp_path / side / name))))
            results.append(capsys.readouterr().err.replace(str(tmp_path / side), "ROOT"))
        for mode in ("tpu-vm", "gke"):
            results.append(outcome(lambda: tf.precheck(cfg(side, mode=mode), st.RunPaths(REPO))))
            results.append(capsys.readouterr().err)
        out[side] = results
    assert out["port"] == out["reference"]
    assert "HCL precheck skipped" in out["port"][1] and "never_declared" in out["port"][2][1]
    assert out["port"][5] == "" and out["port"][7] == ""
