"""Weight carrier, performance accounting, phase timing and slice
topology of the port."""
from tritonk8ssupervisor_tpu_torch.utils.topology import (  # noqa: F401
    Topology,
    parse_topology,
)
