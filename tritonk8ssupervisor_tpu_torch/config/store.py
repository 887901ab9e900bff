"""Flat KEY=value config persistence.

Mirrors the reference's `config` file contract: written by setConfigToFile
(setup.sh:199-208), re-exported into the process environment by exportVars
(setup.sh:543-549), and its *existence* doubles as the "a run is already in
flight" guard (setup.sh:241-244). Keeping the same shape keeps the same
crash-resume property: every phase's inputs live in files the next phase
re-reads.

The port's copy of `tritonk8ssupervisor_tpu/config/store.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from pathlib import Path

from tritonk8ssupervisor_tpu_torch.config.schema import ClusterConfig

CONFIG_FILENAME = "config"


def save_config_file(config: ClusterConfig, path: Path) -> None:
    lines = [f"{k}={v}" for k, v in config.to_flat().items()]
    path.write_text("\n".join(lines) + "\n")


def parse_flat(text: str) -> dict[str, str]:
    """Parse flat KEY=value lines (comments/blank lines skipped). Shared by
    the config file and /etc/tpu-cluster.env (parallel/distributed.py) —
    one definition of the flat-file format."""
    flat: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        flat[key.strip()] = value.strip()
    return flat


def load_config_file(path: Path) -> ClusterConfig:
    return ClusterConfig.from_flat(parse_flat(path.read_text()))


def export_to_env(config: ClusterConfig, environ: dict | None = None) -> dict:
    """exportVars analogue (setup.sh:543-549): push config into the env so
    child processes (terraform, ansible) see it."""
    environ = os.environ if environ is None else environ
    environ.update(config.to_flat())
    return environ
