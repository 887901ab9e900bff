"""The port's wizard (`cli/wizard.py`) against the reference's: the cases of
tests/test_wizard.py. Each package gets the same scripted answers and the
same zone, network and subnetwork listers; the resulting `ClusterConfig`
(as a dict), the transcript, `config_rows` and `verify_config`'s summary
and answer are equal. No tolerance."""

import dataclasses
import io
import types

import pytest

from tritonk8ssupervisor_tpu.cli import discovery as ref_discovery
from tritonk8ssupervisor_tpu.cli import io as ref_io
from tritonk8ssupervisor_tpu.cli import wizard as ref_wizard
from tritonk8ssupervisor_tpu_torch.cli import discovery, wizard
from tritonk8ssupervisor_tpu_torch.cli import io as cli_io
from tritonk8ssupervisor_tpu_torch.config import catalog

SIDES = {
    "port": types.SimpleNamespace(wizard=wizard, discovery=discovery, io=cli_io),
    "reference": types.SimpleNamespace(wizard=ref_wizard, discovery=ref_discovery, io=ref_io),
}


def catalog_zones(gen):
    return list(catalog.ACCELERATORS[gen].zones)


def fake_networks(project):
    return ["default", "prod-net"]


def fake_subnets(project, region, network):
    return [network, f"{network}-{region}"]


def scripted(m, lines, network_lister=fake_networks, **env):
    """The wizard of package `m` over `lines`: (config as a dict, or the
    error it raised; the transcript)."""
    out = io.StringIO()
    prompter = m.io.Prompter(io.StringIO("\n".join(lines) + "\n"), out)
    try:
        config = m.wizard.run_wizard(
            prompter, env=m.discovery.GcloudEnv(**{"project": "test-proj", **env}),
            zone_lister=catalog_zones, network_lister=network_lister,
            subnet_lister=fake_subnets)
    except m.io.EndOfInput as e:
        return ["EndOfInput", str(e)], out.getvalue()
    return dataclasses.asdict(config), out.getvalue()


ALL_DEFAULTS = [""] * 12  # project ... subnetwork, each its default

CASES = {
    "all defaults": ALL_DEFAULTS,
    "custom selection": ["other-proj", "prod tpus", "production slice", "prod-cluster",
                         "prodnode", "2", "1", "2", "3", "1", "2", "2"],
    "network escape hatch": ALL_DEFAULTS[:10] + ["3", "xpn-host-net"] + ALL_DEFAULTS[11:],
    "live network listing": ALL_DEFAULTS[:10] + ["2"] + ALL_DEFAULTS[11:],
    "invalid names re-prompt": ALL_DEFAULTS[:3] + ["Bad_Name", "good-name"] + ALL_DEFAULTS[4:],
    "slice-count guard rail": ALL_DEFAULTS[:8] + ["42", "9"] + ALL_DEFAULTS[9:],
    "menus re-prompt": ALL_DEFAULTS[:5] + ["x", "9", "2"] + ALL_DEFAULTS[6:],
    "input runs out": ALL_DEFAULTS[:7],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_wizard_matches_the_reference(name):
    seen = {}

    def lister(project):
        seen.setdefault(project, 0)
        seen[project] += 1
        return ["vpc-a", "vpc-b"] if name == "live network listing" else fake_networks(project)

    out = {side: scripted(m, CASES[name], network_lister=lister) for side, m in SIDES.items()}
    assert out["port"] == out["reference"]
    config, transcript = out["port"]
    if name == "all defaults":
        assert config["project"] == "test-proj" and config["mode"] == "gke"
        assert (config["generation"], config["topology"], config["num_slices"],
                config["zone"]) == ("v5e", "2x2", 1, "us-west4-a")
    elif name == "custom selection":
        assert (config["mode"], config["generation"], config["topology"],
                config["num_slices"], config["zone"], config["network"],
                config["subnetwork"]) == ("tpu-vm", "v4", "2x2x2", 3, "us-central2-b",
                                          "prod-net", "prod-net-us-central2")
    elif name == "network escape hatch":
        assert config["network"] == config["subnetwork"] == "xpn-host-net"
    elif name == "live network listing":
        assert config["network"] == "vpc-b" and seen == {"test-proj": 2}
    elif name == "invalid names re-prompt":
        assert config["cluster_name"] == "good-name" and "RFC1035" in transcript
    elif name == "slice-count guard rail":
        assert config["num_slices"] == 9 and "no HA support" in transcript
    elif name == "menus re-prompt":
        assert config["mode"] == "tpu-vm" and "enter a number 1-2" in transcript
    else:
        assert config[0] == "EndOfInput"


@pytest.mark.parametrize("given", [
    ([""], ["default", "prod-net"], "xpn-host-net"),
    (["2"], ["default", "prod-net"], "xpn-host-net"),
    ([""], ["default"], ""),
    ([""], ["vpc-a", "vpc-b"], "default"),
    (["3", "typed-net"], ["default", "prod-net"], "prod-net"),
])
def test_choose_named_matches_the_reference(given):
    """A configured name the listing cannot see keeps plain Enter; listed
    names stay selectable; the schema's own "default" guess falls to the
    first live option; "other" asks for a name."""
    lines, options, default = given
    out = {}
    for side, m in SIDES.items():
        text = io.StringIO()
        prompter = m.io.Prompter(io.StringIO("\n".join(lines) + "\n"), text)
        out[side] = [m.wizard._choose_named(prompter, "VPC network", options, default),
                     text.getvalue()]
    assert out["port"] == out["reference"]


@pytest.mark.parametrize("answer", ["yes", "no", "y", ""])
@pytest.mark.parametrize("name", ["all defaults", "custom selection"])
def test_verify_config_and_rows_match_the_reference(name, answer):
    out = {}
    for side, m in SIDES.items():
        config = m.wizard.run_wizard(
            m.io.Prompter(io.StringIO("\n".join(CASES[name]) + "\n"), io.StringIO()),
            env=m.discovery.GcloudEnv(project="test-proj"), zone_lister=catalog_zones,
            network_lister=fake_networks, subnet_lister=fake_subnets)
        text = io.StringIO()
        ok = m.wizard.verify_config(config, m.io.Prompter(io.StringIO(answer + "\n"), text))
        out[side] = [ok, text.getvalue(), m.wizard.config_rows(config)]
    assert out["port"] == out["reference"]
    ok, text, rows = out["port"]
    assert ok is (answer in ("yes", "y"))
    assert ("test-proj" if name == "all defaults" else "other-proj") in text
    if name == "all defaults":
        assert "v5litepod-4" in text and "ct5lp-hightpu-4t" in text
    assert [label for label, _ in rows][:3] == ["GCP project", "Zone", "Mode"]
