"""Cross-plane timeline analysis: one request's life, and latency
spikes attributed to fleet events.

Two questions the unified telemetry plane exists to answer:

- **"Where did THIS request's 9.9s go?"** — `request_timeline(key)`
  joins the span log (obs/trace.py) with the request journal
  (serving/reqlog.py) under one idempotency key and orders every
  record on the shared clock: admission, each dispatch (with the
  queue wait and the routed view's age from the journal), per-chunk
  prefill spans (real engine), the prefill/decode occupancy spans,
  requeues with their cause, and the terminal settle. Spans carry the
  writer's INCARNATION, so a request that survived a gateway SIGKILL
  shows records from both gateway lives — and `complete` is the
  conservation verdict: every acceptance matched by exactly one
  terminal record, no gaps.

- **"Did that latency spike overlap a heal wave?"** — `correlate()`
  buckets completion latencies into fixed windows, flags the windows
  whose p99 stands above the run's baseline, and intersects them with
  the supervisor's activity intervals rebuilt from its event ledger
  (heal-start..done, breaker open..close, domain outages) and span log
  (tick/heal/heal-wave spans). The output names the overlap:
  "p99 window t=300-480 overlaps heal heal-17 for slice(s) 2".

Both functions are pure folds over replayed records — they never touch
a live gateway or supervisor, so `./setup.sh trace` / `analyze` work on
a crashed workdir exactly as on a running one.

The port's copy of `tritonk8ssupervisor_tpu/obs/analyze.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from tritonk8ssupervisor_tpu_torch.obs import trace as trace_mod
from tritonk8ssupervisor_tpu_torch.provision import events as events_mod
from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod


# ------------------------------------------------------- request timeline


def _journal_entry(record: dict) -> dict:
    entry = {
        "t": record.get("ts", 0.0),
        "source": "journal",
        "kind": record.get("kind", ""),
    }
    for field in ("slice", "where", "reason", "cause", "queued_s",
                  "served_s", "generation", "view_age_s", "latency_s",
                  "deadline_s", "retries", "depth", "retry_after_s",
                  "prompt_len", "max_new_tokens"):
        if record.get(field) is not None:
            entry[field] = record[field]
    return entry


def _span_entry(record: dict) -> dict:
    entry = {
        "t": record.get("start", record.get("ts", 0.0)),
        "source": "span",
        "kind": record.get("span", ""),
        "plane": record.get("plane", ""),
        "start": record.get("start"),
        "end": record.get("end"),
        "incarnation": record.get("incarnation", 0),
    }
    if (record.get("end") is not None
            and record.get("start") is not None):
        entry["duration_s"] = round(record["end"] - record["start"], 6)
    for field, value in record.items():
        if field in ("v", "ts", "kind", "span", "plane", "start", "end",
                     "key", "incarnation"):
            continue
        entry[field] = value
    return entry


def request_timeline(key: str, span_records: list,
                     req_records: list) -> dict:
    """One request's end-to-end timeline. `complete` is the terminal-
    accounting verdict: acceptances == terminal settles with at least
    one acceptance on record (a key that survived a gateway SIGKILL
    must still sum to exactly-once). Works on compacted journals too:
    a STATE snapshot record carries the folded accept/terminal counts."""
    entries: list = []
    accepts = terminals = 0
    state = ""
    for record in req_records:
        if record.get("key") != key:
            continue
        kind = record.get("kind")
        if kind == reqlog_mod.STATE:
            accepts += int(record.get("accepts", 0))
            terminals += int(record.get("completions", 0))
            terminals += int(record.get("expiries", 0))
            state = record.get("state", state)
            entry = {"t": record.get("accepted_ts") or record.get("ts", 0.0),
                     "source": "journal", "kind": "state(compacted)",
                     "state": record.get("state")}
            entries.append(entry)
            continue
        if kind == reqlog_mod.ACCEPTED:
            accepts += 1
            state = "accepted"
        elif kind in reqlog_mod.TERMINAL:
            terminals += 1
            state = kind
        elif kind == reqlog_mod.DISPATCHED:
            state = "dispatched"
        entries.append(_journal_entry(record))
    incarnations: set = set()
    phases: dict = {}
    for record in span_records:
        if record.get("key") != key:
            continue
        incarnations.add(record.get("incarnation", 0))
        entries.append(_span_entry(record))
        name = record.get("span", "")
        if (name in ("queue-wait", "prefill", "decode")
                and record.get("end") is not None
                and record.get("start") is not None):
            phases[name] = round(
                phases.get(name, 0.0)
                + (record["end"] - record["start"]), 6
            )
    entries.sort(key=lambda e: (e["t"], e["source"]))
    return {
        "key": key,
        "found": bool(entries),
        "entries": entries,
        "incarnations": sorted(incarnations),
        "accepts": accepts,
        "terminals": terminals,
        "state": state,
        "phases": phases,
        # the conservation verdict the trace CLI's exit code reports
        "complete": accepts > 0 and terminals == accepts,
    }


def render_timeline(timeline: dict) -> list[str]:
    """Human-readable rows for the trace CLI."""
    lines = [f"request {timeline['key']}: "
             + ("no records found" if not timeline["found"] else
                f"{timeline['accepts']} acceptance(s), "
                f"{timeline['terminals']} terminal settle(s), "
                f"state={timeline['state'] or 'unknown'}, "
                + ("COMPLETE" if timeline["complete"]
                   else "INCOMPLETE (terminal accounting has gaps)"))]
    if timeline.get("incarnations"):
        inc = ", ".join(str(i) for i in timeline["incarnations"])
        lines.append(f"  span writers (gateway incarnations): {inc}")
    for entry in timeline["entries"]:
        attrs = " ".join(
            f"{k}={v}" for k, v in sorted(entry.items())
            if k not in ("t", "source", "kind", "plane", "start", "end")
            and v is not None
        )
        tag = entry["source"]
        if entry.get("plane"):
            tag = f"{entry['plane']} {tag}"
        duration = ""
        if entry.get("duration_s"):
            duration = f" [{entry['duration_s']:.3f}s]"
        lines.append(
            f"  t={entry['t']:>10.3f}  {tag:<18} "
            f"{entry['kind']}{duration}"
            + (f"  {attrs}" if attrs else "")
        )
    if timeline.get("phases"):
        parts = ", ".join(f"{name} {secs:.3f}s"
                          for name, secs in sorted(
                              timeline["phases"].items()))
        lines.append(f"  phase totals: {parts}")
    return lines


# ----------------------------------------------------- spike correlation


def _percentile(values: list, q: float) -> float | None:
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1,
              max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


def _completions(span_records: list, req_records: list) -> list:
    """[(ts, latency_s)] — from `complete` spans when available, from
    the journal's COMPLETED records otherwise (the two agree; spans
    just avoid re-reading the journal when both are on disk)."""
    out = [
        (r.get("end", r.get("ts", 0.0)), float(r["latency_s"]))
        for r in span_records
        if r.get("span") == "complete" and r.get("latency_s") is not None
    ]
    if out:
        return sorted(out)
    return sorted(
        (r.get("ts", 0.0), float(r["latency_s"]))
        for r in req_records
        if r.get("kind") == reqlog_mod.COMPLETED
        and r.get("latency_s") is not None
    )


def fleet_intervals(ledger_records: list,
                    span_records: list = ()) -> list:
    """The supervisor's activity as [start, end] intervals with labels:
    heals (start..done/failed, slices attached), breaker holds
    (open..close, global and per-domain), domain outage episodes, and —
    when the supervisor's span log is on hand — heal-wave spans. An
    interval the ledger never closed (kill mid-heal) runs to +inf: it
    is exactly the overlap a spike analysis must still see."""
    intervals: list = []
    open_heals: dict = {}
    open_breakers: dict = {}  # domain ("" = global) -> (start, trip rec)
    open_outages: dict = {}
    for record in ledger_records:
        kind = record.get("kind", "")
        ts = record.get("ts", 0.0)
        if kind == events_mod.HEAL_START:
            open_heals[record.get("id")] = record
        elif kind in (events_mod.HEAL_DONE, events_mod.HEAL_FAILED):
            start = open_heals.pop(record.get("id"), None)
            if start is not None:
                intervals.append({
                    "kind": "heal",
                    "id": record.get("id"),
                    "start": start.get("ts", ts),
                    "end": ts,
                    "slices": sorted(start.get("slices", [])),
                    "ok": kind == events_mod.HEAL_DONE,
                    "canary": bool(start.get("canary")),
                })
        elif kind in (events_mod.BREAKER_OPEN,
                      events_mod.DOMAIN_BREAKER_OPEN):
            open_breakers.setdefault(record.get("domain", ""), ts)
        elif kind in (events_mod.BREAKER_CLOSE,
                      events_mod.DOMAIN_BREAKER_CLOSE):
            start = open_breakers.pop(record.get("domain", ""), None)
            if start is not None:
                intervals.append({
                    "kind": "breaker-hold",
                    "domain": record.get("domain", "") or "global",
                    "start": start, "end": ts,
                })
        elif kind == events_mod.DOMAIN_OUTAGE:
            open_outages.setdefault(record.get("domain", ""), ts)
        elif kind == events_mod.DOMAIN_RECOVERED:
            start = open_outages.pop(record.get("domain", ""), None)
            if start is not None:
                intervals.append({
                    "kind": "domain-outage",
                    "domain": record.get("domain", ""),
                    "start": start, "end": ts,
                })
    inf = float("inf")
    for heal_id, start in open_heals.items():
        intervals.append({
            "kind": "heal", "id": heal_id,
            "start": start.get("ts", 0.0), "end": inf,
            "slices": sorted(start.get("slices", [])),
            "ok": None, "canary": bool(start.get("canary")),
            "orphaned": True,
        })
    for domain, start in open_breakers.items():
        intervals.append({"kind": "breaker-hold",
                          "domain": domain or "global",
                          "start": start, "end": inf})
    for domain, start in open_outages.items():
        intervals.append({"kind": "domain-outage", "domain": domain,
                          "start": start, "end": inf})
    for record in span_records:
        if (record.get("plane") == trace_mod.SUPERVISOR
                and record.get("span") in ("heal-wave", "heal")
                and record.get("start") is not None):
            intervals.append({
                "kind": record["span"],
                "start": record["start"],
                "end": record.get("end", record["start"]),
                "slices": record.get("slices"),
                "source": "span",
            })
    return sorted(intervals, key=lambda iv: (iv["start"], iv["kind"]))


def _interval_label(iv: dict) -> str:
    if iv["kind"] == "heal" and iv.get("source") != "span":
        slices = ", ".join(str(i) for i in iv.get("slices") or [])
        tag = " (canary)" if iv.get("canary") else ""
        tag += " (orphaned: killed mid-heal)" if iv.get("orphaned") else ""
        return f"heal {iv.get('id')!r} for slice(s) {slices}{tag}"
    if iv["kind"] in ("heal-wave", "heal"):
        slices = iv.get("slices")
        extra = (f" for slice(s) {', '.join(str(i) for i in slices)}"
                 if slices else "")
        return f"{iv['kind']} span{extra}"
    if iv["kind"] == "breaker-hold":
        return f"breaker hold ({iv.get('domain', 'global')})"
    if iv["kind"] == "domain-outage":
        return f"domain outage ({iv.get('domain', '')})"
    return iv["kind"]


def correlate(span_records: list, ledger_records: list,
              req_records: list = (), window_s: float = 60.0,
              spike_factor: float = 2.0) -> dict:
    """Attribute latency spikes to fleet events. Completions are
    bucketed into `window_s` windows; a window whose p99 is at least
    `spike_factor` x the run's overall p50 (and above its overall p99's
    floor) is a SPIKE, and every fleet interval overlapping it is named
    as a candidate cause. No completions or no spikes is a clean
    verdict, not an error."""
    completions = _completions(list(span_records), list(req_records))
    intervals = fleet_intervals(list(ledger_records), list(span_records))
    latencies = [lat for _, lat in completions]
    overall_p50 = _percentile(latencies, 0.50)
    overall_p99 = _percentile(latencies, 0.99)
    windows: list = []
    if completions and window_s > 0:
        t_lo = completions[0][0]
        by_window: dict = {}
        for ts, lat in completions:
            by_window.setdefault(int((ts - t_lo) // window_s),
                                 []).append(lat)
        for index in sorted(by_window):
            vals = by_window[index]
            windows.append({
                "start": round(t_lo + index * window_s, 3),
                "end": round(t_lo + (index + 1) * window_s, 3),
                "completions": len(vals),
                "p50_s": round(_percentile(vals, 0.50), 4),
                "p99_s": round(_percentile(vals, 0.99), 4),
            })
    threshold = (max(spike_factor * overall_p50, overall_p50)
                 if overall_p50 is not None else None)
    spikes: list = []
    attributions: list = []
    for window in windows:
        if threshold is None or window["p99_s"] < threshold:
            continue
        overlapping = [
            iv for iv in intervals
            if iv["start"] < window["end"] and iv["end"] > window["start"]
        ]
        spike = dict(window)
        spike["overlaps"] = [
            {k: (v if v != float("inf") else None)
             for k, v in iv.items()}
            for iv in overlapping
        ]
        spikes.append(spike)
        head = (f"p99 window t={window['start']:.0f}-"
                f"{window['end']:.0f} (p99 {window['p99_s']:.1f}s over "
                f"{window['completions']} request(s))")
        if overlapping:
            for iv in overlapping:
                attributions.append(
                    f"{head} overlaps {_interval_label(iv)} "
                    f"(t={iv['start']:.0f}-"
                    + ("..." if iv["end"] == float("inf")
                       else f"{iv['end']:.0f}")
                    + ")"
                )
        else:
            attributions.append(
                f"{head}: no overlapping fleet event on record "
                "(traffic-side cause — check queue depth and sheds)"
            )
    return {
        "completions": len(completions),
        "window_s": window_s,
        "overall_p50_s": (round(overall_p50, 4)
                          if overall_p50 is not None else None),
        "overall_p99_s": (round(overall_p99, 4)
                          if overall_p99 is not None else None),
        "spike_threshold_s": (round(threshold, 4)
                              if threshold is not None else None),
        "windows": windows,
        "fleet_intervals": len(intervals),
        "spikes": spikes,
        "attributions": attributions,
    }
