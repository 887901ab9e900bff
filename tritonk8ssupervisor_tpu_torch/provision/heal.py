"""The slice states of the reference's healer: the port's copy of the
constants of `tritonk8ssupervisor_tpu/provision/heal.py` (:54-58), which
`provision/events.fleet_status` classifies slices by. The healer itself
is not ported (ROADMAP.md)."""

HEALTHY = "healthy"
MISSING = "missing"
UNREADY = "unready"
DRAINING = "draining"
DEGRADED = "degraded"  # quarantine-file state: left out of service
