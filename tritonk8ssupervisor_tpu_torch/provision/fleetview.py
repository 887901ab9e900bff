"""Torn-read-tolerant reader of the supervisor's fleet-status.json: the
port's copy of `tritonk8ssupervisor_tpu/provision/fleetview.py`, whole.

The supervisor atomically rewrites `fleet-status.json` every reconcile
tick. The elastic trainer (`parallel/elastic.py`) polls it and keys
checkpoint-resume on the membership generation and the heal_in_progress
flag. The reading discipline:

- a missing file, a mid-copy truncation, or a document of the wrong
  shape is **unknown, retry**, never healthy. A consumer that misread
  a torn status as "healthy" would resume straight into a half-healed
  fleet;
- a successful read is a complete, immutable `FleetView`: the writer's
  atomic temp+rename means readers see the old document or the new one,
  never a blend (tests/test_torch_elastic.py holds this under a
  concurrent rewrite);
- fields added by newer supervisors (the `serving` block) parse to
  explicit "absent" defaults, so old documents keep folding.

`ScriptedHealthSource` is the injectable fake the tests share.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class FleetView:
    """What a fleet-status.json consumer needs from one observation."""

    generation: int
    heal_in_progress: bool
    verdict: str
    draining: tuple = ()
    degraded: tuple = ()
    updated: float | None = None
    # the `serving` block (documents written before it existed parse to
    # serving=None — "no routing advice", distinct from "no slices"):
    # route-eligible slice indices, and the supervisor's shed request
    # (breaker open / degraded-hold: stop admitting, retry later)
    serving: tuple | None = None
    shed: bool = False
    slices_total: int = 0


def parse_fleet_status(raw: Any) -> FleetView | None:
    """A FleetView from a parsed fleet-status document, or None when the
    document is not one (wrong type, mangled fields) — the same "unknown,
    retry" verdict as a torn read."""
    try:
        if not isinstance(raw, dict):
            return None
        membership = raw.get("membership")
        membership = membership if isinstance(membership, dict) else {}
        slices = raw.get("slices")
        slices = slices if isinstance(slices, dict) else {}
        draining = membership.get("draining")
        if draining is None:
            draining = [int(i) for i, entry in slices.items()
                        if isinstance(entry, dict)
                        and entry.get("state") == "draining"]
        serving_block = raw.get("serving")
        serving: tuple | None = None
        shed = False
        if isinstance(serving_block, dict):
            eligible = serving_block.get("eligible")
            if isinstance(eligible, (list, tuple)):
                serving = tuple(sorted(int(i) for i in eligible))
            shed = bool(serving_block.get("shed", False))
        return FleetView(
            generation=int(membership.get("generation", 1)),
            heal_in_progress=bool(membership.get("heal_in_progress",
                                                 False)),
            verdict=str(raw.get("verdict", "unknown")),
            draining=tuple(sorted(int(i) for i in draining)),
            degraded=tuple(sorted(int(i)
                                  for i in raw.get("degraded") or [])),
            updated=raw.get("updated"),
            serving=serving,
            shed=shed,
            slices_total=int(raw.get("slices_total") or 0),
        )
    except (TypeError, ValueError):
        return None


class HealthSource:
    """Where a consumer learns about membership. `poll()` returns the
    current FleetView, or None for *unknown* — a missing or mid-rewrite
    status file must read as "retry", never as healthy."""

    def poll(self) -> FleetView | None:  # pragma: no cover - interface
        raise NotImplementedError


class FileHealthSource(HealthSource):
    """File-backed reader of the supervisor's fleet-status.json (the
    atomic-rewrite side lives in events.write_fleet_status; readers only
    ever see a whole document or nothing)."""

    def __init__(self, path: Path | str) -> None:
        self.path = Path(path)

    def poll(self) -> FleetView | None:
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return None  # absent or torn: unknown, retry
        return parse_fleet_status(raw)


class ScriptedHealthSource(HealthSource):
    """The injectable fake for tests: yields a scripted sequence of
    views (None entries model unknown reads); the last view repeats
    forever."""

    def __init__(self, views) -> None:
        self._views = list(views)
        self.polls = 0

    def poll(self) -> FleetView | None:
        self.polls += 1
        if len(self._views) > 1:
            return self._views.pop(0)
        return self._views[0] if self._views else None
