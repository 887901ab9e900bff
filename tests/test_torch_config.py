"""The port's cluster configuration (`config/{catalog,schema,store}.py`,
`utils/topology.py`) against the reference's: the valid and invalid
configurations of tests/test_schema.py, test_store.py, test_catalog.py
and test_topology.py, and a seeded sweep over the catalog, give equal
fields, derived properties, `ConfigError` messages and `to_flat`
documents, and a store round trip writes byte-equal files. The CLI
raises the schema's `ConfigError`. No tolerance."""

import dataclasses
import inspect

import numpy as np
import pytest

from tritonk8ssupervisor_tpu import config as ref_config
from tritonk8ssupervisor_tpu.config import catalog as ref_catalog
from tritonk8ssupervisor_tpu.config import schema as ref_schema
from tritonk8ssupervisor_tpu.config import store as ref_store
from tritonk8ssupervisor_tpu.utils import topology as ref_topology
from tritonk8ssupervisor_tpu_torch import config
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.config import catalog, schema, store
from tritonk8ssupervisor_tpu_torch.parallel import distributed
from tritonk8ssupervisor_tpu_torch.utils import topology

PROPERTIES = ("region", "chips_per_slice", "hosts_per_slice", "accelerator_type",
              "effective_runtime_version", "gke_machine_type")


def _outcome(fn):
    """fn()'s value, or the class name and message of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return (type(e).__name__, str(e))


def _describe(cfg) -> dict:
    """Everything a ClusterConfig answers: its fields, its derived
    properties, its domains, its validation verdict and its flat form."""
    out = {"fields": dataclasses.asdict(cfg), "validate": _outcome(cfg.validate),
           "flat": _outcome(cfg.to_flat)}
    for name in PROPERTIES:
        out[name] = _outcome(lambda: getattr(cfg, name))
    out["topology"] = _outcome(lambda: str(cfg.parsed_topology))
    out["domains"] = _outcome(lambda: (cfg.domain_map(), cfg.domain_slices()))
    return out


CONFIGS = [
    {"project": "my-proj", "zone": "us-west4-a", "generation": "v5e", "topology": "4x4"},
    {"project": "my-proj", "zone": "us-west4-a", "generation": "v5e", "topology": "4x4",
     "runtime_version": "custom"},
    {"project": "", "zone": "us-west4-a", "generation": "v5e", "topology": "4x4"},
    {"project": "p", "zone": "us-west4-a", "mode": "bare-metal"},
    {"project": "p", "zone": "us-west4-a", "cluster_name": "Bad_Name"},
    {"project": "p", "zone": "us-west4-a", "num_slices": 0},
    {"project": "p", "zone": "us-west4-a", "num_slices": 10},
    {"project": "p", "zone": "us-west4-a", "num_slices": -1},
    {"project": "p", "zone": "us-central2-b", "generation": "v5e"},
    {"project": "", "zone": "", "cluster_name": "X", "num_slices": 0},
    {"project": "p", "zone": "us-west4-a", "num_slices": 8, "failure_domains": 4},
    {"project": "p", "zone": "us-west4-a", "num_slices": 4},
    {"project": "p", "zone": "us-west4-a", "failure_domains": 1},
    {"project": "p", "zone": "us-west4-a", "failure_domains": -1},
    {"project": "p", "zone": "us-west4-a", "num_slices": 2, "failure_domains": 5},
    {"project": "p", "zone": "us-west4-a", "num_slices": 3, "env_name": "my env"},
    {"project": "p", "zone": "us-west4-a", "generation": "v5e", "topology": "3x3"},
    {"project": "p", "zone": "us-west4-a", "generation": "v99"},
    {"project": "p", "zone": "z"},
]


@pytest.mark.parametrize("index", range(len(CONFIGS)))
def test_configs_describe_as_the_reference(index):
    kwargs = CONFIGS[index]
    ours = _describe(schema.ClusterConfig(**kwargs))
    ref = _describe(ref_schema.ClusterConfig(**kwargs))
    assert ours == ref


def _catalog_sweep(seed: int) -> list:
    """Seeded configurations over the catalog: valid topologies and zones
    mixed with invalid ones."""
    rng = np.random.default_rng(seed)
    out = []
    gens = sorted(ref_catalog.ACCELERATORS) + ["v99"]
    for _ in range(40):
        gen = gens[int(rng.integers(0, len(gens)))]
        spec = ref_catalog.ACCELERATORS.get(gen)
        topologies = list(spec.topologies) if spec else ["4x4"]
        topo = topologies[int(rng.integers(0, len(topologies)))] if rng.random() < 0.8 \
            else ["3x3", "2x2x2", "4x4", "1x1"][int(rng.integers(0, 4))]
        zones = list(spec.zones) if spec else ["us-west4-a"]
        zone = zones[int(rng.integers(0, len(zones)))] if rng.random() < 0.8 else "eu-nowhere1-z"
        out.append({"generation": gen, "topology": topo, "zone": zone,
                    "num_slices": int(rng.integers(0, 11)),
                    "failure_domains": int(rng.integers(-1, 6)),
                    "mode": ["tpu-vm", "gke", "bare-metal"][int(rng.integers(0, 3))]})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_catalog_sweep_as_the_reference(seed):
    for entry in _catalog_sweep(seed):
        kwargs = {"project": "p", **entry}
        assert (_describe(schema.ClusterConfig(**kwargs))
                == _describe(ref_schema.ClusterConfig(**kwargs)))
        gen, topo = entry["generation"], entry["topology"]
        assert (_outcome(lambda: catalog.accelerator_type_name(gen, topo))
                == _outcome(lambda: ref_catalog.accelerator_type_name(gen, topo)))
    specs = [dataclasses.asdict(catalog.get_spec(g)) for g in sorted(catalog.ACCELERATORS)]
    assert specs == [dataclasses.asdict(ref_catalog.get_spec(g))
                     for g in sorted(ref_catalog.ACCELERATORS)]
    assert _outcome(lambda: catalog.get_spec("v99")) == _outcome(
        lambda: ref_catalog.get_spec("v99"))
    for gen, spec in catalog.ACCELERATORS.items():
        ref_spec = ref_catalog.ACCELERATORS[gen]
        for t in spec.topologies:
            assert (spec.hosts(spec.topology(t)), spec.chips_on_host(spec.topology(t))) == (
                ref_spec.hosts(ref_spec.topology(t)),
                ref_spec.chips_on_host(ref_spec.topology(t)))


@pytest.mark.parametrize("text", ["4x4", "2x2x4", " 2x2 ", "", "4", "4x", "x4", "4x4x4x4",
                                  "ax4", "0x4", "-1x2", "16x16"])
def test_topology_parse_as_the_reference(text):
    ours = _outcome(lambda: topology.parse_topology(text))
    ref = _outcome(lambda: ref_topology.parse_topology(text))
    if ours[0] == "ok":
        assert (ours[1].dims, ours[1].chips, ours[1].ndim, str(ours[1])) == (
            ref[1].dims, ref[1].chips, ref[1].ndim, str(ref[1]))
    else:
        assert ours == ref
    for chips, per_host in ((4, 8), (8, 8), (16, 8), (16, 4), (1, 8)):
        assert topology.hosts_for(chips, per_host) == ref_topology.hosts_for(chips, per_host)


def test_store_round_trip_is_byte_equal(tmp_path):
    for kwargs in (CONFIGS[0], CONFIGS[10], CONFIGS[15]):
        ours, ref = tmp_path / "port-config", tmp_path / "reference-config"
        store.save_config_file(schema.ClusterConfig(**kwargs), ours)
        ref_store.save_config_file(ref_schema.ClusterConfig(**kwargs), ref)
        assert ours.read_bytes() == ref.read_bytes()
        loaded = store.load_config_file(ours)
        assert loaded == schema.ClusterConfig(**kwargs)
        assert dataclasses.asdict(loaded) == dataclasses.asdict(ref_store.load_config_file(ref))
        env_ours, env_ref = {}, {}
        store.export_to_env(loaded, env_ours)
        ref_store.export_to_env(ref_store.load_config_file(ref), env_ref)
        assert env_ours == env_ref
    text = "# a comment\n\nPROJECT=p\nZONE=us-west4-a\nnot a kv line\n SDC_URL = legacy \n"
    assert store.parse_flat(text) == ref_store.parse_flat(text)
    assert (dataclasses.asdict(schema.ClusterConfig.from_flat(store.parse_flat(text)))
            == dataclasses.asdict(ref_schema.ClusterConfig.from_flat(ref_store.parse_flat(text))))


def test_one_config_error_and_one_parse_flat_in_the_port():
    assert config.ConfigError is schema.ConfigError is cli.ConfigError
    assert distributed.parse_flat is store.parse_flat
    assert config.ClusterConfig is schema.ClusterConfig
    assert _exports(config) == _exports(ref_config)


def _exports(package) -> list:
    """The names a package's __init__ exports: its submodules are left out,
    since which of them are attributes depends on what was imported."""
    return sorted(n for n, v in vars(package).items()
                  if not n.startswith("_") and not inspect.ismodule(v))
