"""The GPU cluster plane's static surface: the H100 catalog entries and the
GPU modes' validation, the terraform modules `terraform/gke-gpu` and
`terraform/gpu-vm` through the port's `infra/hcl.py` (parsed, validated,
covered by the compiled tfvars and rendered to plans), and the GPU
playbook and roles through `infra/ansiblecheck.py` (structure, the roles'
jinja conditions over sample outputs, and the generated vars and
inventory covering every variable the roles read). The TPU catalog, modes
and documents stay the reference's: tests/test_torch_config.py,
test_torch_compile.py and test_torch_infra.py hold them."""

import dataclasses
import re
from pathlib import Path

import pytest
import yaml

from tritonk8ssupervisor_tpu.config import catalog as ref_catalog
from tritonk8ssupervisor_tpu_torch import __version__, packaging
from tritonk8ssupervisor_tpu_torch.config import catalog, schema, store
from tritonk8ssupervisor_tpu_torch.config import compile as cc
from tritonk8ssupervisor_tpu_torch.infra import ansiblecheck as ac
from tritonk8ssupervisor_tpu_torch.infra import hcl

REPO = Path(__file__).resolve().parent.parent


def gpu(**overrides) -> schema.ClusterConfig:
    base = dict(project="gpu-proj", zone="us-central1-a", generation="h100", topology="1x8",
                mode="gke-gpu")
    return schema.ClusterConfig(**{**base, **overrides})


def errors(config) -> str:
    try:
        config.validate()
    except schema.ConfigError as e:
        return str(e)
    return ""


# ------------------------------------------------------------------ catalog


def test_the_gpu_families_sit_beside_the_tpu_catalog():
    assert sorted(catalog.ACCELERATORS) == sorted(ref_catalog.ACCELERATORS)
    assert sorted(catalog.GPU_ACCELERATORS) == ["h100", "h100-mega"]
    assert not set(catalog.GPU_ACCELERATORS) & set(catalog.ACCELERATORS)
    for gen in catalog.ACCELERATORS:
        assert catalog.get_spec(gen).kind == "tpu"
        assert "kind" not in dataclasses.asdict(catalog.get_spec(gen))
    h100, mega = catalog.get_spec("h100"), catalog.get_spec("h100-mega")
    assert (h100.kind, mega.kind) == ("gpu", "gpu")
    assert (h100.type_prefix, mega.type_prefix) == ("nvidia-h100-80gb", "nvidia-h100-mega-80gb")
    assert h100.gke_machine_type == {1: "a3-highgpu-1g", 2: "a3-highgpu-2g",
                                     4: "a3-highgpu-4g", 8: "a3-highgpu-8g"}
    assert mega.gke_machine_type == {8: "a3-megagpu-8g"}
    assert "devel" in h100.job_image and "cuda12" in h100.job_image
    assert "family/" in h100.default_runtime
    with pytest.raises(ValueError, match="unknown TPU generation 'a100'"):
        catalog.get_spec("a100")


@pytest.mark.parametrize("family", ["h100", "h100-mega"])
def test_every_gpu_topology_packs_whole_hosts(family):
    spec = catalog.get_spec(family)
    for text in spec.topologies:
        topo = spec.topology(text)
        hosts, per_host = (int(x) for x in text.split("x"))
        assert (spec.hosts(topo), spec.chips_on_host(topo), topo.chips) == (
            hosts, per_host, hosts * per_host)
        assert per_host in spec.gke_machine_type
        assert catalog.accelerator_type_name(family, text) == spec.type_prefix
    with pytest.raises(ValueError, match="not a valid"):
        spec.topology("3x8")


# ------------------------------------------------------------------- schema


@pytest.mark.parametrize("mode", schema.GPU_MODES)
@pytest.mark.parametrize("family,topology", [("h100", "1x1"), ("h100", "2x8"),
                                             ("h100-mega", "4x8")])
def test_gpu_configs_validate_and_round_trip(tmp_path, mode, family, topology):
    config = gpu(mode=mode, generation=family, topology=topology, num_slices=2)
    assert errors(config) == "" and config.is_gpu
    assert config.chips_per_slice == config.hosts_per_slice * config.spec.chips_on_host(
        config.parsed_topology)
    path = tmp_path / "config"
    store.save_config_file(config, path)
    assert store.load_config_file(path) == config


def test_mixed_family_and_mode_pairs_are_refused():
    assert errors(gpu(mode="gke")) == (
        "mode 'gke' does not deploy the GPU family 'h100'; choose one of ('gke-gpu', 'gpu-vm')")
    assert errors(gpu(mode="tpu-vm")).startswith("mode 'tpu-vm' does not deploy the GPU family")
    tpu = schema.ClusterConfig(project="p", zone="us-west4-a", mode="gke-gpu")
    assert errors(tpu) == ("mode 'gke-gpu' does not deploy the TPU generation 'v5e'; "
                           "choose one of ('tpu-vm', 'gke')")
    assert errors(gpu(mode="bare")) == "mode must be one of ('gke-gpu', 'gpu-vm'), got 'bare'"
    assert "zone 'us-west4-a' has no h100 capacity" in errors(gpu(zone="us-west4-a"))
    assert "not a valid h100-mega slice" in errors(gpu(generation="h100-mega", topology="1x1"))
    assert schema.ALL_MODES == ("tpu-vm", "gke", "gke-gpu", "gpu-vm")
    assert schema.MODES == ("tpu-vm", "gke")  # the reference's, the TPU modes


# ---------------------------------------------------------------- terraform


@pytest.mark.parametrize("mode", schema.GPU_MODES)
def test_the_gpu_modules_validate_and_take_the_compiled_tfvars(mode):
    module = hcl.parse_module_dir(REPO / "terraform" / mode)
    assert hcl.validate_module(module) == []
    for overrides in ({}, {"topology": "2x8", "num_slices": 3}, {"topology": "1x1"},
                      {"generation": "h100-mega", "topology": "4x8"}):
        tfvars = cc.to_tfvars(gpu(mode=mode, **overrides))
        assert hcl.check_tfvars(module, tfvars) == []
    assert hcl.check_tfvars(module, {"stray": 1}) != []


def test_the_gpu_vm_plan_fans_out_slices_by_hosts():
    module = hcl.parse_module_dir(REPO / "terraform" / "gpu-vm")
    config = gpu(mode="gpu-vm", topology="2x8", num_slices=2, node_prefix="h")
    tfvars = cc.to_tfvars(config)
    assert tfvars == {"project": "gpu-proj", "zone": "us-central1-a", "network": "default",
                      "subnetwork": "default", "name_prefix": "h", "num_slices": 2,
                      "machine_type": "a3-highgpu-8g", "hosts_per_slice": 2,
                      "boot_image": catalog.get_spec("h100").default_runtime}
    plan = hcl.render_plan(module, tfvars)
    assert list(plan) == [f"google_compute_instance.host[{i}]" for i in range(4)]
    names = [vm["name"] for vm in plan.values()]
    assert names == ["h-0-0", "h-0-1", "h-1-0", "h-1-1"]
    from tritonk8ssupervisor_tpu_torch.provision import readiness
    assert readiness.gpu_vm_names(config) == names
    vm = plan["google_compute_instance.host[3]"]
    assert vm["labels"] == {"role": "gpu-worker", "slice": "1"}
    assert vm["scheduling"] == [{"on_host_maintenance": "TERMINATE", "automatic_restart": True}]
    assert vm["machine_type"] == "a3-highgpu-8g"
    assert vm["boot_disk"][0]["initialize_params"][0]["image"] == tfvars["boot_image"]
    assert vm["metadata"] == {"ssh-keys": ""}
    outputs = hcl.parse_module_dir(REPO / "terraform" / "gpu-vm").outputs()
    assert {"host_ips", "internal_ips"} <= set(outputs)
    assert hcl._FUNCTIONS["chunklist"]([1, 2, 3, 4], 2) == [[1, 2], [3, 4]]


def test_the_gke_gpu_plan_has_one_a3_pool_per_slice():
    module = hcl.parse_module_dir(REPO / "terraform" / "gke-gpu")
    for topology, compact in (("1x4", False), ("2x8", True)):
        tfvars = cc.to_tfvars(gpu(topology=topology, num_slices=2, cluster_name="c"))
        assert tfvars["gpus_per_node"] == int(topology.split("x")[1])
        plan = hcl.render_plan(module, tfvars)
        assert plan["google_container_cluster.cluster"]["name"] == "c"
        pools = [plan[f"google_container_node_pool.gpu_pool[{i}]"] for i in range(2)]
        for i, pool in enumerate(pools):
            node = pool["node_config"][0]
            assert node["machine_type"] == tfvars["machine_type"]
            assert node["labels"] == {"role": "gpu-worker", "slice": str(i)}
            assert node["guest_accelerator"][0]["type"] == "nvidia-h100-80gb"
            assert node["guest_accelerator"][0]["gpu_driver_installation_config"] == [
                {"gpu_driver_version": "LATEST"}]
            assert pool["node_count"] == int(topology.split("x")[0])
            assert ("placement_policy" in pool) == compact
            assert pool["management"] == [{"auto_repair": True, "auto_upgrade": False}]


# ------------------------------------------------------------------ ansible


def _tasks(role: str) -> list:
    return yaml.safe_load((REPO / "ansible" / "roles" / role / "tasks" / "main.yml").read_text())


def test_the_gpu_playbook_and_roles_validate():
    assert ac.validate_playbook(REPO / "ansible", {"GPUHOST", "LOCAL"}, "clusterUpGpu.yml") == []
    assert ac.validate_playbook(REPO / "ansible", {"GPUHOST"}, "clusterUpGpu.yml") != []
    plays = yaml.safe_load((REPO / "ansible" / "clusterUpGpu.yml").read_text())
    assert [(p["hosts"], p["roles"]) for p in plays] == [("GPUHOST", ["gpuhost"]),
                                                        ("LOCAL", ["gkegpujoin"])]
    # the image carries torch and CUDA; the launcher carries the coordinates
    tasks = yaml.safe_dump(_tasks("gpuhost") + _tasks("gkegpujoin"))
    assert not re.search(r"jax|libtpu|google\.com/tpu|tpu-cluster\.env", tasks, re.IGNORECASE)


def test_the_gpu_roles_conditions_evaluate():
    wait = next(t for t in _tasks("gkegpujoin") if "registration" in t["name"])
    install = next(t for t in _tasks("gpuhost") if t["name"] == "Install the framework package")
    cases = [(stdout, gpus, sum(int(x) for x in stdout.split()) >= gpus)
             for stdout in ("8 8", "8", "", "8 0 8", " 1 ", "0") for gpus in (16, 8, 1)]
    for stdout, gpus, want in cases:
        assert ac.evaluate_expression(wait["until"], {"gpu_alloc": {"stdout": stdout},
                                                      "expected_total_gpus": gpus}) is want
    for changed in (True, False):
        for installed, same in (("Version: 0.1.0", True), ("Version: 0.1.0rc1", False), ("", False)):
            assert ac.evaluate_expression(install["when"], {
                "pkg_copy": {"changed": changed},
                "pkg_installed": {"stdout_lines": installed.splitlines()},
                "pkg_version": "0.1.0"}) is (changed or not same)


@pytest.mark.parametrize("mode", schema.GPU_MODES)
def test_the_gpu_vars_and_inventory_cover_what_the_roles_read(mode):
    config = gpu(mode=mode, topology="2x8", num_slices=2)
    generated = cc.to_ansible_vars(config, coordinator_ip="10.0.0.1")
    inventory = cc.to_inventory(config, [["34.0.0.1", "34.0.0.2"], ["34.0.1.1", "34.0.1.2"]],
                                internal_ips=[["10.0.0.1", "10.0.0.2"], ["10.0.1.1", "10.0.1.2"]])
    provided = set(generated) | set(re.findall(r"(\w+)=", inventory))
    defaults, consumed = set(), set()
    for role in ("gpuhost", "gkegpujoin"):
        role_dir = REPO / "ansible" / "roles" / role
        defaults |= set(yaml.safe_load((role_dir / "defaults" / "main.yml").read_text()))
        text = (role_dir / "tasks" / "main.yml").read_text()
        text += (role_dir / "templates").is_dir() and "".join(
            p.read_text() for p in (role_dir / "templates").iterdir()) or ""
        consumed |= set(re.findall(r"{{\s*(\w+)", text))
        consumed |= set(re.findall(r"when: (\w+)\s*==", text))
        consumed |= set(re.findall(r"until: \((\w+)", text))
    # and what the generated commands template per host
    for value in generated.values():
        consumed |= set(re.findall(r"{{\s*(\w+)", str(value)))
    consumed -= {"gpu_alloc", "gpu_smoke", "cluster_smoke", "watch_unit", "pkg_install",
                 "pkg_copy", "pkg_installed"}
    assert consumed, "the roles read no variables"
    assert not consumed - provided - defaults
    assert {"node_rank", "global_coordinator"} <= consumed
    role_defaults = yaml.safe_load(
        (REPO / "ansible" / "roles" / "gpuhost" / "defaults" / "main.yml").read_text())
    assert (role_defaults["pkg_version"], role_defaults["pkg_archive"]) == (
        __version__, packaging.ARCHIVE_NAME)
    assert inventory.startswith("[GPUHOST]\n34.0.0.1 slice_index=0 process_id=0 node_rank=0 "
                                "slice_coordinator=10.0.0.1 global_coordinator=10.0.0.1\n")
    assert ("34.0.1.2 slice_index=1 process_id=1 node_rank=3 slice_coordinator=10.0.1.1 "
            "global_coordinator=10.0.0.1") in inventory
    assert "[GPUHOST:vars]" in inventory and "TPUHOST" not in inventory
