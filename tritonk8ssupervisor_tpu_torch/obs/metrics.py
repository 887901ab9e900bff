"""Thread-safe metrics registry: labeled Counters, Gauges, and
log-bucketed Histograms with Prometheus text exposition and atomic JSON
snapshots. The port's copy of `tritonk8ssupervisor_tpu/obs/metrics.py`,
whole: the same operations render the same text and snapshot
(tests/test_torch_obs.py).

Every plane grew its own ad-hoc counters — `Gateway.report()`'s dicts,
`SlotEngine.stats`, the supervisor's `fleet_status()` tallies — and
nobody could scrape one surface for "what is this deployment doing".
This registry is that surface, with the same design constraints the
rest of the repo lives by:

- **Injectable clock**: snapshot timestamps come from the registry's
  clock, so SimClock drills produce byte-identical telemetry on every
  run — wall time never leaks into a deterministic campaign.
- **Thread-safe**: one lock per registry covers every mutation; the
  gateway's handler threads, the EngineLoop, and the supervisor's
  parallel heal workers all increment concurrently (pinned by a
  threaded test in tests/test_obs.py).
- **Cheap on the hot path**: an unlabeled `Counter.inc()` is a lock +
  one float add — the engine-step and gateway-claim paths are gated
  <5% overhead in the reference (`bench_provision.py --obs`).
- **Two read surfaces**: `render()` is Prometheus text exposition
  (text/plain; version=0.0.4 — GET /metrics serves it), and
  `snapshot()`/`write_snapshot()` is an atomic JSON document
  (metrics.json, temp+os.replace like fleet-status.json) that the
  status command and the chaos checker consume.

Metric catalog of record: docs/observability.md.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from pathlib import Path

SNAPSHOT_VERSION = 1

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def log_buckets(start: float = 0.001, factor: float = 2.0,
                count: int = 21) -> tuple:
    """Log-spaced histogram bucket upper bounds: `count` edges growing
    by `factor` from `start` (0.001 * 2^k covers 1ms..~17min by
    default). Latency distributions are heavy-tailed; linear buckets
    either blur the tail or waste resolution on the floor."""
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** k for k in range(count))


def escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote,
    and newline must be escaped or the sample line is unparseable."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(value: float) -> str:
    """Render ints without a trailing .0 (counters read naturally) and
    floats with repr precision."""
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Metric:
    """Shared per-metric state: name, help, and a label-tuple -> value
    map guarded by the registry's lock."""

    kind = ""

    def __init__(self, name: str, help: str, lock: threading.Lock) -> None:
        self.name = name
        self.help = str(help)
        self._lock = lock
        self._values: dict = {}  # label key tuple -> float

    def samples(self) -> list:
        """[(labels dict, value)] sorted by label key — the exposition
        and snapshot order, deterministic."""
        with self._lock:
            return [(dict(key), value)
                    for key, value in sorted(self._values.items())]


class Counter(_Metric):
    """Monotonically increasing count. `inc(n, **labels)` adds to the
    labeled child (no labels = the bare series)."""

    kind = COUNTER

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        # no-label fast path: the claim/step hot-path counters take it
        key = () if not labels else _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def per_label(self, label: str, **match) -> dict:
        """{label value: count} for one label name — how report() folds
        e.g. rejected-per-reason out of the registry. `match` narrows
        to children carrying those exact label values first — the
        gateway fleet's per-replica reports fold a shared registry with
        per_label("reason", replica="g0") while the unfiltered call
        keeps summing fleet-wide."""
        out: dict = {}
        with self._lock:
            for key, value in self._values.items():
                if match:
                    kd = dict(key)
                    if any(kd.get(name) != want
                           for name, want in match.items()):
                        continue
                for name, lv in key:
                    if name == label:
                        out[lv] = out.get(lv, 0.0) + value
        return out


class Gauge(_Metric):
    """A value that goes up and down (queue depth, pages in use,
    breaker state)."""

    kind = GAUGE

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float | None:
        with self._lock:
            return self._values.get(_label_key(labels))


class Histogram(_Metric):
    """Log-bucketed distribution. Buckets are UPPER bounds, inclusive
    (`le` semantics): an observation exactly on an edge lands in that
    edge's bucket — pinned in tests/test_obs.py. Exposition renders the
    Prometheus cumulative form (name_bucket{le=...}, name_sum,
    name_count)."""

    kind = HISTOGRAM

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: tuple | None = None) -> None:
        super().__init__(name, help, lock)
        edges = tuple(sorted(buckets)) if buckets else log_buckets()
        if not edges:
            raise ValueError(f"histogram {self.name} needs >= 1 bucket")
        self.buckets = edges
        # label key -> [per-bucket counts..., overflow, sum, count]

    def observe(self, value: float, **labels) -> None:
        idx = bisect.bisect_left(self.buckets, float(value))
        key = () if not labels else _label_key(labels)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = [0] * (len(self.buckets) + 1) + [0.0, 0]
                self._values[key] = state
            state[idx] += 1
            state[-2] += float(value)
            state[-1] += 1

    def snapshot_value(self, **labels) -> dict | None:
        with self._lock:
            state = self._values.get(_label_key(labels))
            if state is None:
                return None
            return {
                "buckets": list(zip(self.buckets, state[:len(self.buckets)])),
                "overflow": state[len(self.buckets)],
                "sum": state[-2],
                "count": state[-1],
            }

    def count(self, **labels) -> int:
        with self._lock:
            state = self._values.get(_label_key(labels))
            return 0 if state is None else int(state[-1])

    def sum(self, **labels) -> float:
        with self._lock:
            state = self._values.get(_label_key(labels))
            return 0.0 if state is None else float(state[-2])


class MetricsRegistry:
    """The per-process metric namespace. `counter/gauge/histogram` are
    get-or-create (idempotent — instrumentation sites can resolve their
    metric once at construction and hold the handle); re-registering a
    name as a different kind is a programming error and raises."""

    def __init__(self, clock=time.time) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._order: list[str] = []

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                return existing
            metric = cls(name, help, self._lock, **kwargs)
            self._metrics[name] = metric
            self._order.append(name)
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    # ------------------------------------------------------- exposition

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4): HELP/TYPE pairs
        then one sample line per labeled child, names sorted so scrapes
        diff cleanly."""
        lines: list[str] = []
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for metric in metrics:
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            if isinstance(metric, Histogram):
                self._render_histogram(metric, lines)
                continue
            for labels, value in metric.samples():
                lines.append(
                    f"{metric.name}{self._label_str(labels)} "
                    f"{_format_value(value)}"
                )
        return "\n".join(lines) + "\n"

    @staticmethod
    def _label_str(labels: dict, extra: dict | None = None) -> str:
        merged = dict(labels)
        if extra:
            merged.update(extra)
        if not merged:
            return ""
        inner = ",".join(
            f'{name}="{escape_label_value(value)}"'
            for name, value in sorted(merged.items())
        )
        return "{" + inner + "}"

    def _render_histogram(self, metric: Histogram, lines: list) -> None:
        for labels, state in metric.samples():
            cumulative = 0
            for edge, n in zip(metric.buckets,
                               state[:len(metric.buckets)]):
                cumulative += n
                lines.append(
                    f"{metric.name}_bucket"
                    f"{self._label_str(labels, {'le': _format_value(edge)})}"
                    f" {cumulative}"
                )
            cumulative += state[len(metric.buckets)]
            lines.append(
                f"{metric.name}_bucket"
                f"{self._label_str(labels, {'le': '+Inf'})} {cumulative}"
            )
            lines.append(
                f"{metric.name}_sum{self._label_str(labels)} "
                f"{_format_value(state[-2])}"
            )
            lines.append(
                f"{metric.name}_count{self._label_str(labels)} "
                f"{int(state[-1])}"
            )

    # -------------------------------------------------------- snapshots

    def snapshot(self) -> dict:
        """The whole registry as one JSON-able document — what
        metrics.json holds and the chaos checker's metrics-vs-ledger
        invariants read."""
        doc: dict = {"v": SNAPSHOT_VERSION, "ts": self._clock(),
                     "metrics": {}}
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for metric in metrics:
            entry: dict = {"type": metric.kind, "help": metric.help,
                           "samples": []}
            if isinstance(metric, Histogram):
                entry["buckets"] = list(metric.buckets)
                for labels, state in metric.samples():
                    entry["samples"].append({
                        "labels": labels,
                        "counts": state[:len(metric.buckets) + 1],
                        "sum": state[-2],
                        "count": state[-1],
                    })
            else:
                for labels, value in metric.samples():
                    entry["samples"].append(
                        {"labels": labels, "value": value}
                    )
            doc["metrics"][metric.name] = entry
        return doc

    def write_snapshot(self, path: Path) -> dict:
        """Atomic (temp + os.replace) JSON snapshot — a scraper or the
        status command racing the write sees the old or the new
        document, never a torn one. Same contract as fleet-status.json."""
        from tritonk8ssupervisor_tpu_torch.provision.state import (
            atomic_write_text,
        )

        doc = self.snapshot()
        atomic_write_text(
            Path(path), json.dumps(doc, indent=2, sort_keys=True) + "\n"
        )
        return doc


# -------------------------------------------------- snapshot query helpers


def counter_total(snapshot: dict, name: str) -> float:
    """Sum of a counter's samples in a snapshot document (0.0 when the
    metric never fired)."""
    entry = (snapshot.get("metrics") or {}).get(name)
    if entry is None or entry.get("type") != COUNTER:
        return 0.0
    return sum(s.get("value", 0.0) for s in entry.get("samples", []))


def counter_by_label(snapshot: dict, name: str, label: str) -> dict:
    """{label value: count} from a snapshot counter."""
    entry = (snapshot.get("metrics") or {}).get(name)
    out: dict = {}
    if entry is None:
        return out
    for s in entry.get("samples", []):
        lv = (s.get("labels") or {}).get(label)
        if lv is not None:
            out[lv] = out.get(lv, 0.0) + s.get("value", 0.0)
    return out


def gauge_value(snapshot: dict, name: str, labels: dict | None = None):
    """One gauge sample's value from a snapshot, or None."""
    entry = (snapshot.get("metrics") or {}).get(name)
    if entry is None:
        return None
    want = dict(labels or {})
    for s in entry.get("samples", []):
        if (s.get("labels") or {}) == want:
            return s.get("value")
    return None
