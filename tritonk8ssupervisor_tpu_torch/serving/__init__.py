"""Serving in the port: the paged continuous-batching `SlotEngine` with
prefix reuse and speculative decoding, its page pool and prefix store, and
the two gateway types its surface uses."""

from tritonk8ssupervisor_tpu_torch.serving.engine import SlotEngine
from tritonk8ssupervisor_tpu_torch.serving.gateway import Request, StepResult
from tritonk8ssupervisor_tpu_torch.serving.kvpool import PagePool, PrefixStore

__all__ = ["PagePool", "PrefixStore", "Request", "SlotEngine", "StepResult"]
