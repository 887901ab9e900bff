"""TPU pod-slice topology arithmetic.

The reference framework sized clusters with a "number of nodes" prompt
(reference setup.sh:297-307, hard limit 1-9). TPU slices are instead sized
by a physical chip topology string like ``"2x2"`` (2D, v5e/v6e) or
``"2x2x2"`` (3D torus, v4/v5p). This module is the pure arithmetic shared
by the wizard, the catalog validation, and the manifest compiler.

The port's copy of `tritonk8ssupervisor_tpu/utils/topology.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import re

_TOPOLOGY_RE = re.compile(r"^(\d+)x(\d+)(?:x(\d+))?$")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A parsed TPU slice topology, e.g. 4x4 or 2x2x4."""

    dims: tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def chips(self) -> int:
        return math.prod(self.dims)

    def __str__(self) -> str:
        return "x".join(str(d) for d in self.dims)


def parse_topology(text: str) -> Topology:
    """Parse ``"AxB"`` / ``"AxBxC"`` into a Topology.

    Raises ValueError on malformed input — the wizard surfaces this the way
    the reference surfaced hostname-regex failures (setup.sh:276-283).
    """
    m = _TOPOLOGY_RE.match(text.strip())
    if not m:
        raise ValueError(
            f"invalid topology {text!r}: expected AxB or AxBxC (e.g. 4x4, 2x2x2)"
        )
    dims = tuple(int(g) for g in m.groups() if g is not None)
    if any(d < 1 for d in dims):
        raise ValueError(f"invalid topology {text!r}: dims must be >= 1")
    return Topology(dims)


def hosts_for(chips: int, chips_per_host: int) -> int:
    """Number of TPU VM hosts backing a slice of `chips` chips."""
    return max(1, math.ceil(chips / chips_per_host))
