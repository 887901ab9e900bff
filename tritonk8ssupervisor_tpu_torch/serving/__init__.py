"""Serving in the port: the continuous-batching gateway (`gateway.py`:
admission, sequence-length bucketing, slot-based continuous batching,
fleet-status routing), the request journal (`reqlog.py`), open-loop traffic
(`traffic.py`), the HTTP surface and drill behind `cli.main serve`
(`server.py`), and under them the paged `SlotEngine` with prefix reuse and
speculative decoding (`engine.py`) and its page pool and prefix store
(`kvpool.py`)."""

from tritonk8ssupervisor_tpu_torch.serving.engine import SlotEngine
from tritonk8ssupervisor_tpu_torch.serving.gateway import (
    Admission,
    DecodeCostModel,
    Gateway,
    GatewayPolicy,
    ModeledEngine,
    Request,
    SequenceBuckets,
    SliceWorker,
    StepResult,
)
from tritonk8ssupervisor_tpu_torch.serving.kvpool import PagePool, PrefixStore

__all__ = [
    "Admission",
    "DecodeCostModel",
    "Gateway",
    "GatewayPolicy",
    "ModeledEngine",
    "PagePool",
    "PrefixStore",
    "Request",
    "SequenceBuckets",
    "SliceWorker",
    "SlotEngine",
    "StepResult",
]
