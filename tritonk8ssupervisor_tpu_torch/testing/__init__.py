"""Deterministic test and chaos instrumentation shipped with the port:
the virtual clock (`simclock.py`) and the gateway-plane drills and their
invariant checker (`chaos.py`), the port's copies of the reference's
`tritonk8ssupervisor_tpu/testing/` modules of the same names."""
