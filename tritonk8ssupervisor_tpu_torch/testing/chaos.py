"""Seeded drills of the request plane and the checker that proves its
invariants: the port's copy of the parts of
`tritonk8ssupervisor_tpu/testing/chaos.py` that drive no supervisor.

- `ServeInvariantChecker` (reference :1060-1969), whole: folds a request
  journal (serving/reqlog.py), or all of a gateway fleet's journal shards
  merged, next to the supervisor's event ledger, and names every record
  that breaks request conservation, exactly-once service, deadline
  honesty, honest Retry-After, bounded routing staleness, the cross-ledger
  contract, the metrics-vs-journal contract, and the fleet's partition,
  lease and epoch-fence invariants. Its scale, allocation and handover
  checks read only ledger records, so they come with it.
- `run_gateway_kill_drill` (:1988): one gateway over modeled engines on a
  `SimClock`, dropped mid-dispatch and resumed from its journal.
- `generate_fleet_scenario`, `run_fleet_campaign` and
  `run_fleet_kill_drill` (:3467-3838): the gateway fleet
  (serving/fleet.py) through replica kills, revivals and forced lease
  expiries, checked by `check_fleet` over all shards and the lease ledger.

The same seeds give the same journals, lease records and reports as the
reference (tests/test_torch_fleet.py, tests/test_torch_chaos.py). The
reference's supervisor-driven campaigns (`ChaosFleet`, `run_campaign`,
`InvariantChecker`, `run_serve_campaign`) and its autoscale and
co-scheduling drives wait for the port's supervisor (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path

from tritonk8ssupervisor_tpu_torch.provision import events as events_mod
from tritonk8ssupervisor_tpu_torch.provision.state import RunPaths
from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod
from tritonk8ssupervisor_tpu_torch.testing.simclock import SimClock


class ServeInvariantChecker:
    """Fold a campaign's request journal (serving/reqlog.py) — and the
    supervisor's event ledger next to it — and assert the request
    plane's safety contract. Like the provisioning InvariantChecker,
    the checks work on the RAW record stream: the journal is the
    gateway's flight recorder, and a fold that summarised away an
    illegal transition must not be able to hide it.

    - **request conservation**: every ACCEPTED acceptance ends in
      exactly one terminal record (COMPLETED or EXPIRED) — work is
      never silently lost, not across requeues, not across gateway
      SIGKILLs; and nothing reaches a terminal state it was never
      accepted for.
    - **no double-service**: no idempotency key carries two COMPLETED
      records, and no key is dispatched or requeued after its terminal
      record without a fresh acceptance — exactly-once from the
      client's view.
    - **deadline honesty**: no dispatch at/after the deadline, no
      completion past it (a late result is a 504, not a stale 200), no
      expiry BEFORE it (shedding early is lying too), and every SHED
      carries an honest Retry-After (positive for retryable reasons,
      absent for unservable, with overload sheds naming a queue depth
      that actually bound).
    - **bounded staleness**: every dispatch records the age of the
      routed fleet view; none may exceed the bound (worst honest gap =
      one heal-length tick + a few intervals of keep-last-good).
    - **cross-ledger**: the generations the gateway routed on must
      exist in the supervisor's ledger, and a breaker-open shed is only
      legal once the ledger actually shows a breaker opening.
    - **metrics-vs-ledger** (`metrics=` a registry snapshot): the
      telemetry plane must agree with the flight recorders it claims to
      summarise — the accepted/completed/expired/requeued/replayed/
      rejected counters equal the journal's fold, and the occupancy
      gauges respect capacity (peak busy slots <= slots, peak pages <=
      pool). A scrape surface that drifts from the ledgers is worse
      than none: operators page off it.
    """

    _EPS = 1e-9
    # expiries that are NOT deadline-driven (may legally land before
    # the deadline): handler gave up, process stopped, or the restarted
    # gateway could not faithfully re-serve the key (bucket config
    # changed / prompt tokens unreconstructable)
    _UNTIMED_EXPIRY = ("timeout", "shutdown", "recover-unroutable",
                       "recover-unrecoverable")

    def __init__(self, gw_policy, interval_s: float = 30.0,
                 staleness_bound_s: float | None = None,
                 autoscale_policy=None,
                 drain_grace_s: float | None = None,
                 alloc_policy=None) -> None:
        self.policy = gw_policy
        self.interval_s = float(interval_s)
        self.staleness_bound_s = (
            float(staleness_bound_s) if staleness_bound_s is not None
            else 6.0 * self.interval_s + float(gw_policy.poll_every_s)
        )
        # the autoscale contract (provision/autoscale.py): set when the
        # campaign ran the second controller. drain_grace_s is the
        # propagation window between a SCALE_START(down) landing on the
        # ledger and the gateway's Router observing the draining list —
        # one status publish (same tick) plus a poll interval.
        self.autoscale_policy = autoscale_policy
        self.drain_grace_s = (
            float(drain_grace_s) if drain_grace_s is not None
            else 2.0 * float(gw_policy.poll_every_s) + 1.0
        )
        # the co-scheduling contract (provision/allocator.py): set when
        # the campaign ran the third controller. The same propagation
        # grace applies between a PREEMPT_NOTICE landing and the Router
        # observing the role change.
        self.alloc_policy = alloc_policy

    def check(self, req_records: list, ledger_records: list = (),
              metrics: dict | None = None) -> list:
        violations: list = []
        violations += self.check_conservation(req_records)
        violations += self.check_no_double_service(req_records)
        violations += self.check_deadline_honesty(req_records)
        violations += self.check_retry_after_honesty(req_records)
        violations += self.check_view_staleness(req_records)
        if ledger_records:
            violations += self.check_cross_ledger(req_records,
                                                  ledger_records)
        if metrics is not None:
            violations += self.check_metrics_consistency(req_records,
                                                         metrics)
        if self.autoscale_policy is not None and ledger_records:
            violations += self.check_scale_confirmation(ledger_records)
            violations += self.check_scale_breaker_gate(ledger_records)
            violations += self.check_scale_serialised(ledger_records)
            violations += self.check_no_dispatch_to_draining(
                req_records, ledger_records)
        if self.alloc_policy is not None and ledger_records:
            violations += self.check_alloc_confirmation(ledger_records)
            violations += self.check_handover_protocol(ledger_records)
            violations += self.check_role_exclusivity(ledger_records)
            violations += self.check_no_dispatch_to_training(
                req_records, ledger_records)
        return violations

    # -- 1: request conservation -----------------------------------------

    def check_conservation(self, records: list) -> list:
        violations: list = []
        accepts: dict = {}
        terminals: dict = {}
        for r in records:
            key = r.get("key")
            if not key:
                continue
            kind = r.get("kind")
            if kind == reqlog_mod.ACCEPTED:
                accepts[key] = accepts.get(key, 0) + 1
            elif kind in (reqlog_mod.COMPLETED, reqlog_mod.EXPIRED):
                terminals[key] = terminals.get(key, 0) + 1
        for key in sorted(accepts):
            if terminals.get(key, 0) != accepts[key]:
                violations.append(
                    f"request-conservation: key {key} accepted "
                    f"{accepts[key]}x but reached "
                    f"{terminals.get(key, 0)} terminal state(s)"
                )
        for key in sorted(set(terminals) - set(accepts)):
            violations.append(
                f"request-conservation: key {key} reached a terminal "
                "state without ever being accepted"
            )
        return violations

    # -- 2: no double-service --------------------------------------------

    def check_no_double_service(self, records: list) -> list:
        violations: list = []
        completed: dict = {}
        phase: dict = {}  # key -> open | terminal
        for idx, r in enumerate(records):
            key = r.get("key")
            if not key:
                continue
            kind = r.get("kind")
            if kind == reqlog_mod.COMPLETED:
                completed[key] = completed.get(key, 0) + 1
                if completed[key] > 1:
                    violations.append(
                        f"double-service: key {key} COMPLETED twice "
                        f"(second at record {idx})"
                    )
                phase[key] = "terminal"
            elif kind == reqlog_mod.EXPIRED:
                phase[key] = "terminal"
            elif kind == reqlog_mod.ACCEPTED:
                phase[key] = "open"
            elif kind in (reqlog_mod.DISPATCHED, reqlog_mod.REQUEUED):
                if phase.get(key) == "terminal":
                    violations.append(
                        f"double-service: key {key} {kind} at record "
                        f"{idx} AFTER its terminal state (no fresh "
                        "acceptance in between)"
                    )
        return violations

    # -- 3: deadline honesty ---------------------------------------------

    def check_deadline_honesty(self, records: list) -> list:
        violations: list = []
        deadline_at: dict = {}  # key -> absolute deadline or None
        for idx, r in enumerate(records):
            key = r.get("key")
            if not key:
                continue
            kind = r.get("kind")
            ts = r.get("ts", 0.0)
            if kind == reqlog_mod.ACCEPTED:
                deadline_at[key] = (
                    ts + float(r["deadline_s"])
                    if r.get("deadline_s") is not None else None
                )
            elif kind == reqlog_mod.DISPATCHED:
                bound = deadline_at.get(key)
                if bound is not None and ts >= bound - self._EPS:
                    violations.append(
                        f"deadline-honesty: key {key} dispatched at "
                        f"t={ts:.3f} on/after its deadline "
                        f"t={bound:.3f} (record {idx})"
                    )
            elif kind == reqlog_mod.COMPLETED:
                bound = deadline_at.get(key)
                if bound is not None and ts > bound + 1e-6:
                    violations.append(
                        f"deadline-honesty: key {key} served at "
                        f"t={ts:.3f}, past its deadline t={bound:.3f} "
                        f"(record {idx}) — a late result must be a 504"
                    )
            elif kind == reqlog_mod.EXPIRED:
                if r.get("where") in self._UNTIMED_EXPIRY:
                    continue
                bound = deadline_at.get(key)
                if bound is not None and ts < bound - 1e-6:
                    violations.append(
                        f"deadline-honesty: key {key} expired at "
                        f"t={ts:.3f}, BEFORE its deadline "
                        f"t={bound:.3f} (record {idx})"
                    )
        return violations

    # -- 4: honest Retry-After -------------------------------------------

    def check_retry_after_honesty(self, records: list) -> list:
        violations: list = []
        for idx, r in enumerate(records):
            if r.get("kind") != reqlog_mod.SHED:
                continue
            reason = r.get("reason", "")
            retry_after = r.get("retry_after_s")
            if reason == "unservable":
                if retry_after is not None:
                    violations.append(
                        f"retry-after: unservable shed at record {idx} "
                        "carries a retry hint (retrying cannot help)"
                    )
                continue
            if retry_after is None or retry_after <= 0:
                violations.append(
                    f"retry-after: {reason} shed at record {idx} has "
                    f"no positive Retry-After ({retry_after!r})"
                )
            if reason == "overload":
                depth = r.get("depth")
                if depth is None or depth < self.policy.queue_budget:
                    violations.append(
                        f"retry-after: overload shed at record {idx} "
                        f"without a binding queue (depth {depth!r} < "
                        f"budget {self.policy.queue_budget})"
                    )
        return violations

    # -- 5: bounded view staleness ---------------------------------------

    def check_view_staleness(self, records: list) -> list:
        violations: list = []
        for idx, r in enumerate(records):
            if r.get("kind") != reqlog_mod.DISPATCHED:
                continue
            age = r.get("view_age_s")
            if age is not None and age > self.staleness_bound_s:
                violations.append(
                    f"view-staleness: dispatch at record {idx} routed "
                    f"on a {age:.0f}s-old fleet view (bound "
                    f"{self.staleness_bound_s:.0f}s)"
                )
        return violations

    # -- 6: cross-ledger consistency -------------------------------------

    def check_cross_ledger(self, req_records: list,
                           ledger_records: list) -> list:
        violations: list = []
        final_gen = events_mod.fold(
            list(ledger_records)).membership_generation
        for idx, r in enumerate(req_records):
            if r.get("kind") != reqlog_mod.DISPATCHED:
                continue
            gen = r.get("generation")
            if gen is not None and gen > final_gen:
                violations.append(
                    f"cross-ledger: dispatch at record {idx} routed on "
                    f"membership generation {gen}, but the supervisor's "
                    f"ledger never got past {final_gen}"
                )
        breaker_opens = [
            r.get("ts", 0.0) for r in ledger_records
            if r.get("kind") in (events_mod.BREAKER_OPEN,
                                 events_mod.DOMAIN_BREAKER_OPEN)
        ]
        for idx, r in enumerate(req_records):
            if (r.get("kind") == reqlog_mod.SHED
                    and r.get("reason") == "breaker-open"):
                ts = r.get("ts", 0.0)
                if not any(open_ts <= ts for open_ts in breaker_opens):
                    violations.append(
                        f"cross-ledger: breaker-open shed at record "
                        f"{idx} (t={ts:.0f}) but the supervisor's "
                        "ledger shows no breaker opening before it"
                    )
        return violations

    # -- 7: metrics-vs-ledger consistency --------------------------------

    def check_metrics_consistency(self, req_records: list,
                                  metrics: dict) -> list:
        """`metrics` is an obs.MetricsRegistry snapshot taken over the
        same lifetime as the journal (the campaign shares ONE registry
        across gateway incarnations, the way it shares the reqlog —
        in-process kills drop the gateway object, not the telemetry
        plane). Counters must equal the journal's fold, which survives
        compaction; occupancy gauges must respect capacity. Retention-
        cap evictions would relax the counter side, but campaigns never
        reach the caps (the raw-record checkers above would notice)."""
        from tritonk8ssupervisor_tpu_torch.obs import metrics as metrics_mod

        violations: list = []
        view = reqlog_mod.fold(list(req_records))
        folded = {
            "serving_requests_accepted_total":
                sum(kv.accepts for kv in view.keys.values()),
            "serving_requests_completed_total":
                sum(kv.completions for kv in view.keys.values()),
            "serving_requests_expired_total":
                sum(kv.expiries for kv in view.keys.values()),
            "serving_requests_requeued_total":
                sum(kv.requeues for kv in view.keys.values()),
            "serving_requests_replayed_total":
                sum(kv.replays for kv in view.keys.values()),
            "serving_requests_rejected_total": view.sheds,
        }
        for name, expected in sorted(folded.items()):
            got = metrics_mod.counter_total(metrics, name)
            if int(got) != int(expected):
                violations.append(
                    f"metrics-vs-ledger: counter {name} reads "
                    f"{int(got)} but the request journal folds to "
                    f"{int(expected)}"
                )
        pairs = (
            ("serving_slots_busy_peak", "serving_slots_total"),
            ("serving_kv_pages_in_use_peak", "serving_kv_pages_total"),
            ("serving_slots_busy", "serving_slots_total"),
            ("serving_kv_pages_in_use", "serving_kv_pages_total"),
        )
        for used_name, cap_name in pairs:
            used = metrics_mod.gauge_value(metrics, used_name)
            cap = metrics_mod.gauge_value(metrics, cap_name)
            if used is not None and cap is not None and used > cap:
                violations.append(
                    f"metrics-vs-ledger: gauge {used_name}={used} "
                    f"exceeds capacity {cap_name}={cap}"
                )
        return violations


    # -- 8: autoscale — confirmed windows on fresh evidence ----------------

    def check_scale_confirmation(self, ledger_records: list) -> list:
        """Every SCALE_DECISION must carry a confirming streak at least
        as long as the policy demands for its direction, built on a
        FRESH signal — a decision on one window (or on a stale
        document) is the hysteresis contract broken."""
        ap = self.autoscale_policy
        violations: list = []
        for idx, r in enumerate(ledger_records):
            if r.get("kind") != events_mod.SCALE_DECISION:
                continue
            need = (ap.confirm_up if r.get("direction") == "up"
                    else ap.confirm_down)
            windows = r.get("windows") or 0
            if windows < max(1, int(need)):
                violations.append(
                    f"scale-confirmation: {r.get('direction')} decision "
                    f"at record {idx} confirmed by {windows} window(s), "
                    f"policy demands {need}"
                )
            age = r.get("signal_age_s")
            if age is None or age > ap.signal_max_age_s:
                violations.append(
                    f"scale-confirmation: decision at record {idx} "
                    f"fired on a stale/unknown signal "
                    f"(age {age!r}s, max {ap.signal_max_age_s:.0f}s)"
                )
        return violations

    # -- 9: autoscale — no action while the thrash breaker holds -----------

    def check_scale_breaker_gate(self, ledger_records: list) -> list:
        violations: list = []
        open_until: float | None = None
        for idx, r in enumerate(ledger_records):
            kind = r.get("kind")
            if kind == events_mod.SCALE_BREAKER_OPEN:
                open_until = r.get("reopen_at")
                if open_until is None:
                    open_until = float("inf")
            elif kind in (events_mod.SCALE_BREAKER_HALF_OPEN,
                          events_mod.SCALE_BREAKER_CLOSE):
                open_until = None
            elif kind == events_mod.SCALE_START:
                ts = r.get("ts", 0.0)
                if open_until is not None and ts < open_until:
                    violations.append(
                        f"scale-breaker: scale action at record {idx} "
                        f"(t={ts:.0f}) while the thrash breaker holds "
                        f"until t={open_until:.0f}"
                    )
        return violations

    # -- 10: autoscale — serialised scales + cooldown spacing --------------

    def check_scale_serialised(self, ledger_records: list) -> list:
        """At most ONE scale in flight ever (a SCALE_START while an
        earlier one later closes is a double-scale — the restart path
        must RESUME an orphan, not mint a sibling), and consecutive
        actions respect the recorded cooldown."""
        violations: list = []
        closed_at: dict = {}
        for idx, r in enumerate(ledger_records):
            if r.get("kind") in (events_mod.SCALE_DONE,
                                 events_mod.SCALE_ABORT):
                closed_at[r.get("id")] = idx
        open_scale: tuple | None = None  # (idx, id)
        cooldown_until: float | None = None
        for idx, r in enumerate(ledger_records):
            kind = r.get("kind")
            if kind == events_mod.SCALE_START:
                ts = r.get("ts", 0.0)
                if (open_scale is not None
                        and closed_at.get(open_scale[1], -1) > idx):
                    violations.append(
                        f"scale-serialised: scale {r.get('id')!r} "
                        f"started at record {idx} while scale "
                        f"{open_scale[1]!r} (record {open_scale[0]}) "
                        "was still in flight"
                    )
                if (cooldown_until is not None
                        and ts < cooldown_until - self._EPS):
                    violations.append(
                        f"scale-serialised: scale {r.get('id')!r} at "
                        f"t={ts:.0f} (record {idx}) inside the previous "
                        f"action's cooldown (until "
                        f"t={cooldown_until:.0f})"
                    )
                open_scale = (idx, r.get("id"))
                if r.get("cooldown_until") is not None:
                    cooldown_until = r["cooldown_until"]
            elif kind in (events_mod.SCALE_DONE, events_mod.SCALE_ABORT):
                if open_scale is not None and open_scale[1] == r.get("id"):
                    open_scale = None
        return violations

    # -- 11: autoscale — DRAINING slices receive zero dispatches -----------

    def check_no_dispatch_to_draining(self, req_records: list,
                                      ledger_records: list) -> list:
        """From one propagation grace after a SCALE_START(down) lands
        until its DONE/ABORT, the named slices may receive NO dispatch:
        the Router saw the draining list and stopped pulling. A
        dispatch inside the window means capacity was torn down under
        live work on purpose."""
        intervals: dict = {}  # slice -> list of (t0, t1)
        open_downs: dict = {}  # id -> (ts, slices)
        for r in ledger_records:
            kind = r.get("kind")
            if (kind == events_mod.SCALE_START
                    and r.get("direction") == "down"):
                open_downs[r.get("id")] = (
                    r.get("ts", 0.0), [int(i) for i in r.get("slices", [])]
                )
            elif kind in (events_mod.SCALE_DONE, events_mod.SCALE_ABORT):
                opened = open_downs.pop(r.get("id"), None)
                if opened is not None:
                    t0, slices = opened
                    for i in slices:
                        intervals.setdefault(i, []).append(
                            (t0, r.get("ts", float("inf")))
                        )
        for rid, (t0, slices) in open_downs.items():
            for i in slices:  # still draining when the campaign ended
                intervals.setdefault(i, []).append((t0, float("inf")))
        violations: list = []
        grace = self.drain_grace_s
        for idx, r in enumerate(req_records):
            if r.get("kind") != reqlog_mod.DISPATCHED:
                continue
            index = r.get("slice")
            if index is None:
                continue
            ts = r.get("ts", 0.0)
            for t0, t1 in intervals.get(int(index), []):
                if t0 + grace < ts <= t1:
                    violations.append(
                        f"dispatch-to-draining: slice {index} claimed "
                        f"work at t={ts:.1f} (record {idx}) while "
                        f"draining for scale-down since t={t0:.1f}"
                    )
        return violations

    # -- 12: allocation — confirmed windows on fresh evidence --------------

    def check_alloc_confirmation(self, ledger_records: list) -> list:
        """Every ALLOC_DECISION must carry a confirming streak at least
        as long as the policy demands for its direction, on a FRESH
        signal — the hysteresis contract, applied to role changes."""
        ap = self.alloc_policy
        violations: list = []
        for idx, r in enumerate(ledger_records):
            if r.get("kind") != events_mod.ALLOC_DECISION:
                continue
            need = (ap.confirm_to_serving
                    if r.get("direction") == "to-serving"
                    else ap.confirm_to_training)
            windows = r.get("windows") or 0
            if windows < max(1, int(need)):
                violations.append(
                    f"alloc-confirmation: {r.get('direction')} decision "
                    f"at record {idx} confirmed by {windows} window(s), "
                    f"policy demands {need}"
                )
            age = r.get("signal_age_s")
            if age is None or age > ap.signal_max_age_s:
                violations.append(
                    f"alloc-confirmation: decision at record {idx} "
                    f"fired on a stale/unknown signal "
                    f"(age {age!r}s, max {ap.signal_max_age_s:.0f}s)"
                )
        return violations

    # -- 13: allocation — the preemption protocol is a protocol ------------

    def check_handover_protocol(self, ledger_records: list) -> list:
        """At most ONE handover open at a time (a PREEMPT_NOTICE while
        an earlier one later closes is a double-handover — the restart
        path must RESUME an orphan, not mint a sibling); every
        to-serving ROLE_CHANGED must be preceded by a PREEMPT_ACK for
        its handover id; and a FORCED ack may land only at/after the
        notice's recorded ack deadline — forcing early is a kill, not
        a bounded wait."""
        violations: list = []
        closed_at: dict = {}
        for idx, r in enumerate(ledger_records):
            if r.get("kind") == events_mod.ROLE_CHANGED \
                    and r.get("id") not in (None, "alloc-initial"):
                closed_at[r.get("id")] = idx
        open_handover: tuple | None = None  # (idx, id, record)
        acked: dict = {}  # handover id -> ack record idx
        for idx, r in enumerate(ledger_records):
            kind = r.get("kind")
            if kind == events_mod.PREEMPT_NOTICE:
                if (open_handover is not None
                        and closed_at.get(open_handover[1], -1) > idx):
                    violations.append(
                        f"handover-protocol: handover {r.get('id')!r} "
                        f"opened at record {idx} while handover "
                        f"{open_handover[1]!r} (record {open_handover[0]}) "
                        "was still in flight"
                    )
                open_handover = (idx, r.get("id"), r)
            elif kind == events_mod.PREEMPT_ACK:
                acked[r.get("id")] = idx
                if r.get("forced"):
                    notice = (open_handover[2]
                              if open_handover is not None
                              and open_handover[1] == r.get("id")
                              else None)
                    deadline = (notice.get("ack_deadline")
                                if notice is not None else None)
                    ts = r.get("ts", 0.0)
                    if deadline is not None and ts < deadline - self._EPS:
                        violations.append(
                            f"handover-protocol: FORCED ack for "
                            f"{r.get('id')!r} at t={ts:.1f} (record "
                            f"{idx}) BEFORE the ack deadline "
                            f"t={deadline:.1f} — forcing early is a "
                            "kill, not a bounded wait"
                        )
            elif kind == events_mod.ROLE_CHANGED:
                rid = r.get("id")
                if rid in (None, "alloc-initial"):
                    continue
                if (r.get("role") == "serving" and not r.get("aborted")
                        and rid not in acked):
                    violations.append(
                        f"handover-protocol: to-serving ROLE_CHANGED "
                        f"{rid!r} at record {idx} without a "
                        "PREEMPT_ACK — the trainer was never given its "
                        "checkpoint window"
                    )
                if open_handover is not None and open_handover[1] == rid:
                    open_handover = None
        return violations

    # -- 14: allocation — a slice is never in both roles at once -----------

    _ROLE_LEGAL = {
        ("serving", "transitioning"), ("training", "transitioning"),
        ("transitioning", "serving"), ("transitioning", "training"),
        # the initial assignment flips serving -> training directly
        # (no handover: nothing is running on either side yet)
        ("serving", "training:initial"),
    }

    def check_role_exclusivity(self, ledger_records: list) -> list:
        """Replay the role state machine per slice: serving <->
        transitioning <-> training, nothing else. A PREEMPT_NOTICE
        naming a slice already mid-handover, or a ROLE_CHANGED flipping
        a slice that was never transitioned, is a slice in two roles at
        once — the invariant the whole protocol exists to hold."""
        violations: list = []
        role: dict = {}  # slice -> current role (default serving)
        for idx, r in enumerate(ledger_records):
            kind = r.get("kind")
            if kind == events_mod.PREEMPT_NOTICE:
                for i in r.get("slices", []):
                    current = role.get(int(i), "serving")
                    if (current, "transitioning") not in self._ROLE_LEGAL:
                        violations.append(
                            f"role-exclusivity: slice {i} entered a "
                            f"handover at record {idx} while "
                            f"{current} (already mid-handover?)"
                        )
                    role[int(i)] = "transitioning"
            elif kind == events_mod.ROLE_CHANGED:
                new = r.get("role", "serving")
                tag = (f"{new}:initial" if r.get("initial") else new)
                for i in r.get("slices", []):
                    current = role.get(int(i), "serving")
                    if (current, tag) not in self._ROLE_LEGAL:
                        violations.append(
                            f"role-exclusivity: slice {i} moved "
                            f"{current} -> {new} at record {idx} "
                            "without a handover"
                        )
                    role[int(i)] = new
        return violations

    # -- 15: allocation — TRAINING slices receive zero dispatches ----------

    def check_no_dispatch_to_training(self, req_records: list,
                                      ledger_records: list) -> list:
        """From one propagation grace after a slice's role leaves
        SERVING (a PREEMPT_NOTICE in either direction, or the initial
        training assignment) until a ROLE_CHANGED hands it back, the
        slice may receive NO dispatch: the Router saw the role and
        stopped pulling. A dispatch inside the window is inference
        work landing on the training job's slice — the two-workloads
        invariant broken."""
        intervals: dict = {}  # slice -> list of (t0, t1)
        left_at: dict = {}  # slice -> ts it left SERVING
        for r in ledger_records:
            kind = r.get("kind")
            ts = r.get("ts", 0.0)
            if kind == events_mod.PREEMPT_NOTICE:
                for i in r.get("slices", []):
                    left_at.setdefault(int(i), ts)
            elif kind == events_mod.ROLE_CHANGED:
                role = r.get("role", "serving")
                for i in r.get("slices", []):
                    if role == "serving":
                        t0 = left_at.pop(int(i), None)
                        if t0 is not None:
                            intervals.setdefault(int(i), []).append(
                                (t0, ts))
                    else:
                        left_at.setdefault(int(i), ts)
        for i, t0 in left_at.items():  # never returned to serving
            intervals.setdefault(int(i), []).append((t0, float("inf")))
        violations: list = []
        grace = self.drain_grace_s
        for idx, r in enumerate(req_records):
            if r.get("kind") != reqlog_mod.DISPATCHED:
                continue
            index = r.get("slice")
            if index is None:
                continue
            ts = r.get("ts", 0.0)
            for t0, t1 in intervals.get(int(index), []):
                # end-exclusive: a claim at EXACTLY the ROLE_CHANGED
                # timestamp followed the same-tick status publish that
                # made the slice eligible again (abort path) — the
                # role IS serving at that instant
                if t0 + grace < ts < t1:
                    violations.append(
                        f"dispatch-to-training: slice {index} claimed "
                        f"inference work at t={ts:.1f} (record {idx}) "
                        f"while out of the serving role since "
                        f"t={t0:.1f}"
                    )
        return violations

    # -- 16: allocation — per-tenant goodput within WFQ weight bounds ------

    def check_tenant_fairness(self, req_records: list, weights: dict,
                              flood_tenant: str,
                              window: tuple,
                              slack: float = 1.75) -> list:
        """Inside the flood window every tenant kept demand queued, so
        completed work must track the WFQ weights: the flooding tenant
        may not exceed `slack` x its weight share of the window's
        completions, and the other tenants together must not be
        squeezed below (1 - flood_share * slack). One stream must not
        buy more than its weight."""
        t0, t1 = window
        t1 += 60.0  # completions of work admitted in the window
        tenant_of: dict = {}
        for r in req_records:
            if r.get("kind") == reqlog_mod.ACCEPTED and r.get("key"):
                tenant_of[r["key"]] = r.get("tenant") or "default"
        done: dict = {}
        for r in req_records:
            if r.get("kind") != reqlog_mod.COMPLETED:
                continue
            ts = r.get("ts", 0.0)
            if not (t0 <= ts <= t1):
                continue
            tenant = tenant_of.get(r.get("key"), "default")
            done[tenant] = done.get(tenant, 0) + 1
        total = sum(done.values())
        if total < 10:
            return []  # too little service in the window to judge
        w_total = sum(float(v) or 1.0 for v in weights.values())
        w_flood = float(weights.get(flood_tenant, 1.0)) or 1.0
        flood_share = done.get(flood_tenant, 0) / total
        weight_share = w_flood / w_total
        if flood_share > min(1.0, weight_share * slack):
            return [
                f"tenant-fairness: tenant {flood_tenant!r} took "
                f"{flood_share:.0%} of window completions, over "
                f"{slack:.2f}x its {weight_share:.0%} weight share"
            ]
        return []

    # -- 17: fleet — merged journal shards + the lease protocol ------------

    def check_fleet(self, journals: list, ledger_records: list = (),
                    metrics: dict | None = None) -> list:
        """The federated request plane's verdict (serving/fleet.py)
        from the evidence that survives any one replica's death: ALL N
        journal shards merged into global time order plus the
        supervisor's event ledger. The single-gateway contract must
        hold on the MERGED stream — conservation and exactly-once
        across replica kills, lease churn, and journal adoption — and
        three fleet-only invariants on top: no key open in two shards
        at once (partition exclusivity), no slice ever under two live
        leases (lease exclusivity), and every dispatch inside a lease
        its replica actually held (the epoch fence, PROVEN from the
        records instead of trusted)."""
        journals = [list(j) for j in journals]
        merged = reqlog_mod.merge_records(*journals)
        violations: list = []
        violations += self.check_conservation(merged)
        violations += self.check_no_double_service(merged)
        violations += self.check_deadline_honesty(merged)
        violations += self.check_retry_after_honesty(merged)
        violations += self.check_view_staleness(merged)
        violations += self.check_partition_exclusivity(journals)
        ledger_records = list(ledger_records)
        if ledger_records:
            violations += self.check_lease_exclusivity(ledger_records)
            violations += self.check_cross_lease_dispatch(
                merged, ledger_records)
        if metrics is not None:
            violations += self.check_metrics_consistency(merged,
                                                         metrics)
        return violations

    def check_partition_exclusivity(self, journals: list) -> list:
        """No idempotency key is OPEN (accepted, not yet terminal) in
        two journal shards at once. The key-partition contract routes
        every key to exactly one replica; the only legal ways a key's
        records span shards are adoption (REQUEUED/terminal land in
        the successor's shard — never a second ACCEPTED) and a fresh
        acceptance epoch opened AFTER the original settled."""
        tagged = []
        for j, records in enumerate(journals):
            for i, r in enumerate(records):
                ts = r.get("ts")
                tagged.append((ts if ts is not None else 0.0, j, i, r))
        tagged.sort(key=lambda t: (t[0], t[1], t[2]))
        violations: list = []
        open_in: dict = {}  # key -> shard index of the open epoch
        for ts, j, _i, r in tagged:
            key = r.get("key")
            if not key:
                continue
            kind = r.get("kind")
            if kind == reqlog_mod.ACCEPTED:
                prior = open_in.get(key)
                if prior is not None and prior != j:
                    violations.append(
                        f"partition-exclusivity: key {key} accepted "
                        f"into journal shard {j} at t={ts:.3f} while "
                        f"still open in shard {prior} — two replicas "
                        "owned one key"
                    )
                open_in[key] = j
            elif kind in (reqlog_mod.COMPLETED, reqlog_mod.EXPIRED):
                open_in.pop(key, None)
        return violations

    def check_lease_exclusivity(self, ledger_records: list) -> list:
        """The ledger's lease history, replayed: at no instant do two
        live leases cover one slice, and grant epochs are fleet-
        monotonic (the fence a stale holder can never re-present). A
        GRANT while the slice's previous lease is still live — not
        lapsed by TTL, not closed by an EXPIRE/REVOKE record — is the
        double-ownership the lease protocol exists to rule out."""
        violations: list = []
        live: dict = {}  # slice -> {replica, epoch, expires_at}
        last_epoch = 0
        for idx, r in enumerate(ledger_records):
            kind = r.get("kind")
            if kind not in (events_mod.LEASE_GRANT,
                            events_mod.LEASE_RENEW,
                            events_mod.LEASE_EXPIRE,
                            events_mod.LEASE_REVOKE):
                continue
            index = int(r.get("slice", -1))
            ts = float(r.get("ts", 0.0))
            epoch = int(r.get("epoch", 0))
            cur = live.get(index)
            if kind == events_mod.LEASE_GRANT:
                if epoch <= last_epoch:
                    violations.append(
                        f"lease-exclusivity: grant at record {idx} "
                        f"(slice {index}) reuses epoch {epoch} — the "
                        f"fence high-water mark was {last_epoch}"
                    )
                last_epoch = max(last_epoch, epoch)
                # expiry is inclusive at the boundary (a lease is DEAD
                # at exactly its expires_at), so a re-grant AT the old
                # expiry is legal
                if (cur is not None
                        and ts < float(cur["expires_at"]) - self._EPS):
                    violations.append(
                        f"lease-exclusivity: slice {index} granted to "
                        f"{r.get('replica')} (epoch {epoch}) at "
                        f"t={ts:.3f} while epoch {cur['epoch']} "
                        f"({cur['replica']}) was live until "
                        f"t={float(cur['expires_at']):.3f} "
                        f"(record {idx})"
                    )
                live[index] = {
                    "replica": r.get("replica"), "epoch": epoch,
                    "expires_at": float(r.get("expires_at", ts)),
                }
            elif kind == events_mod.LEASE_RENEW:
                if cur is not None and cur["epoch"] == epoch:
                    cur["expires_at"] = float(r.get("expires_at", ts))
            elif cur is not None and cur["epoch"] == epoch:
                live.pop(index, None)  # EXPIRE/REVOKE close the lease
        return violations

    def check_cross_lease_dispatch(self, merged: list,
                                   ledger_records: list) -> list:
        """Every DISPATCHED record must land inside a lease interval
        its replica actually held on that slice — the epoch fence
        cross-checked between the two flight recorders. An interval
        opens at the GRANT and closes at the earliest of its (last
        renewed) expiry or an EXPIRE/REVOKE record; a dispatch outside
        it is a stale holder pulling from a slot pool it no longer
        owns."""
        intervals: dict = {}  # (slice, replica, epoch) -> [start, end]
        lease_evidence = False
        for r in ledger_records:
            kind = r.get("kind")
            if kind == events_mod.LEASE_GRANT:
                lease_evidence = True
                k = (int(r.get("slice", -1)), r.get("replica"),
                     int(r.get("epoch", 0)))
                ts = float(r.get("ts", 0.0))
                intervals[k] = [ts, float(r.get("expires_at", ts))]
            elif kind == events_mod.LEASE_RENEW:
                k = (int(r.get("slice", -1)), r.get("replica"),
                     int(r.get("epoch", 0)))
                if k in intervals:
                    intervals[k][1] = max(
                        intervals[k][1],
                        float(r.get("expires_at", intervals[k][1])))
            elif kind in (events_mod.LEASE_EXPIRE,
                          events_mod.LEASE_REVOKE):
                k = (int(r.get("slice", -1)), r.get("replica"),
                     int(r.get("epoch", 0)))
                if k in intervals:
                    closed = float(r.get("at", r.get("ts", 0.0)))
                    intervals[k][1] = min(intervals[k][1], closed)
        if not lease_evidence:
            return []
        violations: list = []
        for idx, r in enumerate(merged):
            if r.get("kind") != reqlog_mod.DISPATCHED:
                continue
            replica = r.get("replica")
            if replica is None:
                continue  # standalone-gateway records in a mixed log
            index = r.get("slice")
            epoch = r.get("lease_epoch")
            ts = float(r.get("ts", 0.0))
            if epoch is None:
                violations.append(
                    f"cross-lease-dispatch: replica {replica} "
                    f"dispatched on slice {index} at t={ts:.3f} with "
                    f"no lease epoch (record {idx}) while the ledger "
                    "records leases"
                )
                continue
            span = intervals.get((int(index), replica, int(epoch)))
            if span is None:
                violations.append(
                    f"cross-lease-dispatch: dispatch at record {idx} "
                    f"cites lease epoch {epoch} on slice {index} that "
                    f"the ledger never granted to replica {replica}"
                )
            elif not (span[0] - 1e-6 <= ts <= span[1] + 1e-6):
                violations.append(
                    f"cross-lease-dispatch: replica {replica} "
                    f"dispatched on slice {index} at t={ts:.3f}, "
                    f"outside its epoch-{epoch} lease "
                    f"[{span[0]:.3f}, {span[1]:.3f}] (record {idx})"
                )
        return violations


def _static_status_doc(now: float, num_slices: int,
                       generation: int = 1) -> dict:
    """A healthy fleet-status document with the serving/membership
    blocks the gateway routes on — the kill drill's scripted
    supervisor side (the campaigns use the REAL supervisor)."""
    return {
        "v": 1,
        "updated": now,
        "verdict": "healthy",
        "slices_total": num_slices,
        "membership": {"generation": generation,
                       "heal_in_progress": False, "draining": []},
        "degraded": [],
        "serving": {"eligible": list(range(num_slices)), "avoid": {},
                    "shed": False},
    }


def run_gateway_kill_drill(
    workdir: Path,
    num_slices: int = 2,
    kill_at: float = 100.0,
    duration_s: float = 240.0,
    base_rps: float = 2.0,
    deadline_s: float = 120.0,
    resubmit: int = 3,
    seed: int = 17,
) -> dict:
    """THE gateway crash-resume acceptance drill, fully deterministic
    (one actor, scripted healthy fleet): open-loop traffic with
    idempotency keys and deadlines; at `kill_at` the in-memory gateway
    is dropped mid-dispatch (queued + in-flight state gone) and a fresh
    one resumes from the request journal. Measured: requests redone
    (re-admitted front-of-queue) vs LOST (accepted but never terminal —
    must be 0), duplicates of pre-kill completions answered from the
    journal without regenerating, and restart-to-first-token MTTR."""
    from tritonk8ssupervisor_tpu_torch import obs as obs_lib
    from tritonk8ssupervisor_tpu_torch.provision.fleetview import FileHealthSource
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod
    from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod
    from tritonk8ssupervisor_tpu_torch.serving import traffic as traffic_mod

    root = Path(workdir)
    root.mkdir(parents=True, exist_ok=True)
    clock = SimClock()
    status_path = root / "fleet-status.json"
    events_mod.write_fleet_status(
        status_path, _static_status_doc(0.0, num_slices)
    )
    reqlog = reqlog_mod.RequestLog(root / "serve-requests.jsonl",
                                   clock=clock.time,
                                   echo=lambda line: None, fsync=False)
    # spans shared across both gateway incarnations (bump at the kill):
    # the `./setup.sh trace <key>` acceptance reads this workdir —
    # a redone key must show spans from BOTH lives with no gap in
    # terminal accounting (tests/test_serve_chaos.py pins it)
    drill_paths = RunPaths(root)
    telemetry = obs_lib.Telemetry(
        obs_lib.MetricsRegistry(clock=clock.time),
        obs_lib.Tracer(
            obs_lib.SpanLog(drill_paths.span_log, clock=clock.time,
                            echo=lambda line: None, fsync=False),
            plane=obs_lib.SERVING, clock=clock.time, incarnation=1,
        ),
        snapshot_path=drill_paths.metrics_snapshot,
    )
    policy = gw_mod.GatewayPolicy(
        max_seq_len=512, slots_per_slice=4, prefill_chunk=64,
        queue_budget=64, bucket_bounds=(64, 128, 256),
        poll_every_s=2.0, default_deadline_s=deadline_s,
    )
    cost = gw_mod.DecodeCostModel()

    def make_gateway() -> "gw_mod.Gateway":
        engines = {
            i: gw_mod.ModeledEngine(slots=policy.slots_per_slice,
                                    prefill_chunk=policy.prefill_chunk,
                                    cost=cost)
            for i in range(num_slices)
        }
        return gw_mod.Gateway(
            engines, FileHealthSource(status_path), policy=policy,
            clock=clock.time, reqlog=reqlog, telemetry=telemetry,
        )

    model = traffic_mod.TrafficModel(
        base_rps=base_rps, diurnal_amplitude=0.0, seed=seed,
        deadline_s=deadline_s, key_prefix="kill",
    )
    arrivals = traffic_mod.generate_arrivals(model, duration_s)
    gateway = make_gateway()
    i_arr = 0
    next_step: dict = {i: None for i in gateway.workers}
    # the scripted supervisor side republishes on a tick cadence, like
    # the real one — otherwise every dispatch routes on an ever-older
    # view and the staleness invariant (rightly) fires
    status_every = 30.0
    next_status_at = status_every
    killed = False
    inflight_at_kill = queued_at_kill = 0
    redone = 0
    redone_keys: list = []
    replays_ok = 0
    resubmitted = 0
    post_kill_metrics = None
    hard_stop = duration_s + 600.0
    clock.launch()
    clock.begin()
    try:
        while True:
            now = clock.time()
            while next_status_at <= now:
                events_mod.write_fleet_status(
                    status_path,
                    _static_status_doc(next_status_at, num_slices),
                )
                next_status_at += status_every
            if not killed and now >= kill_at:
                killed = True
                inflight_at_kill = sum(
                    len(w.inflight) for w in gateway.workers.values()
                )
                queued_at_kill = gateway.queue_depth()
                pre_kill_view = reqlog_mod.fold(reqlog.replay())
                pre_kill_done = [
                    kv.key for kv in sorted(
                        pre_kill_view.keys.values(),
                        key=lambda kv: kv.key)
                    if kv.state == "completed"
                ]
                # the keys mid-flight at the kill — what recover() owes
                # a terminal, and what the trace acceptance replays
                redone_keys = [kv.key for kv
                               in pre_kill_view.incomplete()]
                telemetry.bump_incarnation()
                gateway = make_gateway()  # SIGKILL: memory gone
                recovered = gateway.recover(now)
                redone = recovered["redone"]
                post_kill_metrics = gateway.metrics
                next_step = {i: None for i in gateway.workers}
                # duplicate submissions of already-completed keys: the
                # journal must answer them, nothing may regenerate
                for n, key in enumerate(pre_kill_done[:resubmit]):
                    resubmitted += 1
                    duplicate = gw_mod.Request(
                        rid=900000 + n, prompt_len=8, max_new_tokens=4,
                        key=key,
                    )
                    admission = gateway.submit(duplicate, now)
                    if (admission.ok
                            and admission.reason == gw_mod.REPLAYED
                            and admission.result is not None):
                        replays_ok += 1
            gateway.poll(now)
            while (i_arr < len(arrivals)
                   and arrivals[i_arr].arrival <= now):
                gateway.submit(arrivals[i_arr], now)
                i_arr += 1
            for i in sorted(gateway.workers):
                if next_step[i] is not None and next_step[i] <= now:
                    dt = gateway.workers[i].step(now)
                    next_step[i] = None if dt is None else now + dt
            for i, worker in gateway.workers.items():
                if (next_step[i] is None and worker.alive
                        and (worker.inflight or (
                            gateway.queue_depth()
                            and gateway.slice_mode(i)
                            == gw_mod.SERVE))):
                    next_step[i] = now
            quiet = (i_arr >= len(arrivals) and killed
                     and gateway.queue_depth() == 0
                     and all(w.idle()
                             for w in gateway.workers.values()))
            if quiet or now >= hard_stop:
                break
            candidates = [t for t in next_step.values()
                          if t is not None]
            if i_arr < len(arrivals):
                candidates.append(arrivals[i_arr].arrival)
            if not killed:
                candidates.append(kill_at)
            candidates.append(next_status_at)
            t_next = min(candidates) if candidates else hard_stop
            if t_next > now:
                clock.sleep(t_next - now)
    finally:
        clock.release()

    records = reqlog.replay()
    view = reqlog_mod.fold(records)
    lost = [kv.key for kv in view.incomplete()]
    first_tokens_after_kill = [
        r.first_token_at for r in post_kill_metrics.completed
        if r.first_token_at is not None and r.first_token_at >= kill_at
    ] if post_kill_metrics is not None else []
    restart_mttr = (round(min(first_tokens_after_kill) - kill_at, 3)
                    if first_tokens_after_kill else None)
    gateway.update_gauges()
    metrics_snapshot = telemetry.write_snapshot()
    checker = ServeInvariantChecker(policy, interval_s=30.0)
    violations = checker.check(records, metrics=metrics_snapshot)
    if lost:
        violations.append(
            f"gateway-kill: {len(lost)} accepted request(s) lost "
            f"across the restart: {lost[:5]}"
        )
    return {
        "num_slices": num_slices,
        "kill_at_s": kill_at,
        "duration_s": duration_s,
        "offered": len(arrivals),
        "accepted": sum(1 for kv in view.keys.values()
                        if kv.accepts > 0),
        "completed": sum(kv.completions for kv in view.keys.values()),
        "expired": sum(kv.expiries for kv in view.keys.values()),
        "inflight_at_kill": inflight_at_kill,
        "queued_at_kill": queued_at_kill,
        "requests_redone": redone,
        "redone_keys": redone_keys,
        "requests_lost": len(lost),
        "duplicates_resubmitted": resubmitted,
        "duplicates_replayed_from_journal": replays_ok,
        "restart_to_first_token_s": restart_mttr,
        "violations": violations,
    }



# ------------------------------------------------- gateway fleet (sharding)


@dataclasses.dataclass
class FleetScenario:
    """One seeded composition of fleet fault primitives over the
    sharded request plane (serving/fleet.py). Every scenario keeps at
    least one replica alive and every lease re-grantable, so 'merged
    N-shard conservation with zero lost keys' is always the expected
    verdict."""

    seed: int
    replicas: int
    num_slices: int
    duration_s: float
    base_rps: float
    deadline_s: float
    session_share: float
    events: list
    drain_grace_s: float = 1800.0

    @property
    def fault_times(self) -> list:
        return sorted(e.get("at", 0.0) for e in self.events)


FLEET_PRIMITIVES = ("replica-kill", "replica-revive", "lease-expiry")


def generate_fleet_scenario(seed: int, replicas: int = 4,
                            num_slices: int = 6) -> FleetScenario:
    """Deterministic fleet scenario from `seed`: keyed + deadlined
    open-loop traffic (a seeded share of it multi-turn sessions)
    across N gateway replicas, one anchor replica-kill, and up to two
    extra primitives — a revive of the victim (it rejoins the grant
    rotation as a NEW process) and forced lease expiries (a holder
    whose renewals stopped landing: the epoch fence must refuse its
    residual pulls until the re-grant)."""
    rng = random.Random(int(seed))
    events: list = []
    anchor_at = 40.0 + 10.0 * rng.randrange(0, 5)
    if replicas > 1:
        victim = rng.randrange(replicas)
        events.append({"kind": "replica-kill",
                       "replica": f"g{victim}", "at": anchor_at})
        if rng.random() < 0.5:
            events.append({
                "kind": "replica-revive", "replica": f"g{victim}",
                "at": anchor_at + 30.0 * (1 + rng.randrange(0, 3)),
            })
    for _ in range(rng.randrange(0, 3)):
        events.append({
            "kind": "lease-expiry",
            "slice": rng.randrange(num_slices),
            "at": 30.0 + 15.0 * rng.randrange(0, 10),
        })
    return FleetScenario(
        seed=int(seed), replicas=int(replicas),
        num_slices=int(num_slices),
        duration_s=180.0 + 60.0 * rng.randrange(0, 2),
        base_rps=3.0 + 1.0 * rng.randrange(0, 3),
        deadline_s=90.0 + 30.0 * rng.randrange(0, 2),
        session_share=(0.25 if rng.random() < 0.5 else 0.0),
        events=events,
    )


def run_fleet_campaign(scenario: FleetScenario, workdir: Path,
                       fleet_policy=None, gw_policy=None) -> dict:
    """Drive one seeded fleet campaign, fully deterministic: ONE actor
    on a SimClock — no supervisor co-actor, because the lease
    protocol (not healing) is under test, so the replicas run with no
    health source and serve on every slice they hold a lease for. A
    replica kill drops its gateway's memory; the next fleet tick
    revokes its leases, reassigns its key-partitions, and has the
    successor adopt the dead journal shard. Afterwards `check_fleet`
    folds ALL N shards plus the lease ledger; the campaign verdict
    carries its violations."""
    from tritonk8ssupervisor_tpu_torch.serving import fleet as fleet_mod
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod
    from tritonk8ssupervisor_tpu_torch.serving import traffic as traffic_mod

    root = Path(workdir)
    root.mkdir(parents=True, exist_ok=True)
    clock = SimClock()
    paths = RunPaths(root)
    ledger = events_mod.EventLedger(paths.events, clock=clock.time,
                                    echo=lambda line: None, fsync=False)
    gw_policy = gw_policy or _fleet_gw_policy(scenario.deadline_s)
    fleet_policy = fleet_policy or fleet_mod.FleetPolicy(
        replicas=scenario.replicas,
    )
    fleet = fleet_mod.GatewayFleet(
        _fleet_engines(scenario.num_slices, gw_policy), paths, ledger,
        policy=fleet_policy, gateway_policy=gw_policy,
        clock=clock.time, fsync=False,
    )
    model = traffic_mod.TrafficModel(
        base_rps=scenario.base_rps, diurnal_amplitude=0.2,
        diurnal_period_s=600.0, seed=scenario.seed,
        deadline_s=scenario.deadline_s,
        key_prefix=f"f{scenario.seed}",
        session_share=scenario.session_share,
        session_turns=3, session_think_s=5.0,
    )
    arrivals = traffic_mod.generate_arrivals(model, scenario.duration_s)
    world_events = []
    kills = 0
    for event in scenario.events:
        kind = event["kind"]
        if kind == "replica-kill":
            kills += 1
            world_events.append(traffic_mod.WorldEvent(
                at=float(event["at"]),
                fn=_fleet_kill_fn(event["replica"])))
        elif kind == "replica-revive":
            world_events.append(traffic_mod.WorldEvent(
                at=float(event["at"]),
                fn=_fleet_revive_fn(event["replica"])))
        elif kind == "lease-expiry":
            world_events.append(traffic_mod.WorldEvent(
                at=float(event["at"]),
                fn=_fleet_expire_fn(event["slice"], event["at"])))

    clock.launch()
    clock.begin()
    try:
        report = fleet_mod.drive_fleet(
            fleet, arrivals, clock, scenario.duration_s,
            events=tuple(world_events),
            drain_grace_s=scenario.drain_grace_s,
        )
    finally:
        clock.release()

    journals = [fleet.reqlogs[rid].replay()
                for rid in fleet.replica_ids]
    led_records = ledger.replay()
    checker = ServeInvariantChecker(gw_policy)
    violations = checker.check_fleet(journals, led_records)
    if not report["quiescent"]:
        violations.append(
            f"convergence: fleet not quiescent by "
            f"t={scenario.duration_s + scenario.drain_grace_s:.0f}s "
            f"(seed {scenario.seed})"
        )
    view = reqlog_mod.fold(reqlog_mod.merge_records(*journals))
    fenced = sum(
        fleet.gateways[rid]._total(fleet.gateways[rid]._c_lease_fenced)
        for rid in fleet.replica_ids
    )
    return {
        "seed": scenario.seed,
        "events": [e["kind"] for e in scenario.events],
        "replicas": scenario.replicas,
        "num_slices": scenario.num_slices,
        "offered": report["offered"],
        "accepted": sum(1 for kv in view.keys.values()
                        if kv.accepts > 0),
        "completed": sum(kv.completions for kv in view.keys.values()),
        "expired": sum(kv.expiries for kv in view.keys.values()),
        "requeues": sum(kv.requeues for kv in view.keys.values()),
        "sheds": view.sheds,
        "replica_kills": kills,
        "reassignments": len(fleet.reassignments),
        "lease_grants": sum(
            1 for r in led_records
            if r.get("kind") == events_mod.LEASE_GRANT),
        "lease_expiries": sum(
            1 for r in led_records
            if r.get("kind") == events_mod.LEASE_EXPIRE),
        "lease_revokes": sum(
            1 for r in led_records
            if r.get("kind") == events_mod.LEASE_REVOKE),
        "lease_fenced_pulls": int(fenced),
        "violations": violations,
        "converged": report["quiescent"],
        "end_s": clock.time(),
    }


def _fleet_gw_policy(deadline_s: float):
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod

    return gw_mod.GatewayPolicy(
        max_seq_len=512, slots_per_slice=4, prefill_chunk=64,
        queue_budget=64, bucket_bounds=(64, 128, 256),
        poll_every_s=2.0, default_deadline_s=deadline_s,
    )


def _fleet_engines(num_slices: int, gw_policy) -> dict:
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod

    cost = gw_mod.DecodeCostModel()
    return {
        i: gw_mod.ModeledEngine(slots=gw_policy.slots_per_slice,
                                prefill_chunk=gw_policy.prefill_chunk,
                                cost=cost)
        for i in range(num_slices)
    }


def _fleet_kill_fn(rid: str):
    return lambda fleet: fleet.kill(rid)


def _fleet_revive_fn(rid: str):
    return lambda fleet: fleet.revive(rid)


def _fleet_expire_fn(index: int, at: float):
    def force(fleet) -> None:
        # the missed-renewal fault: the WORKING COPY of the lease
        # lapses NOW (the fence refuses the holder's next pull
        # immediately); the next tick's sweep writes the LEASE_EXPIRE
        # and re-grants. Mutating the table and not the ledger is the
        # point — the renewals simply stopped landing.
        entry = fleet.leases.table.get(int(index))
        if entry is not None:
            entry["expires_at"] = float(at)
    return force


def run_fleet_kill_drill(
    workdir: Path,
    replicas: int = 4,
    num_slices: int = 4,
    # off the tick grid on purpose: a kill AT a tick boundary would be
    # reaped the same instant and report a degenerate 0s MTTR
    kill_at: float = 61.0,
    duration_s: float = 180.0,
    base_rps: float = 4.0,
    deadline_s: float = 120.0,
    seed: int = 23,
    resubmit: int = 3,
) -> dict:
    """THE fleet kill acceptance drill (bench_provision.py --fleet),
    fully deterministic: at `kill_at` one replica dies mid-dispatch.
    Measured: its key-partitions reassigned to a successor, requests
    redone from the adopted journal shard vs LOST across the merged
    N-shard fold (must be 0), pre-kill completions still answerable
    as duplicates AT THE SUCCESSOR, and the kill-to-reassignment MTTR
    (bounded by one fleet tick plus the adoption)."""
    from tritonk8ssupervisor_tpu_torch.serving import fleet as fleet_mod
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod
    from tritonk8ssupervisor_tpu_torch.serving import traffic as traffic_mod

    root = Path(workdir)
    root.mkdir(parents=True, exist_ok=True)
    clock = SimClock()
    paths = RunPaths(root)
    ledger = events_mod.EventLedger(paths.events, clock=clock.time,
                                    echo=lambda line: None, fsync=False)
    gw_policy = _fleet_gw_policy(deadline_s)
    fleet = fleet_mod.GatewayFleet(
        _fleet_engines(num_slices, gw_policy), paths, ledger,
        policy=fleet_mod.FleetPolicy(replicas=replicas),
        gateway_policy=gw_policy, clock=clock.time, fsync=False,
    )
    model = traffic_mod.TrafficModel(
        base_rps=base_rps, diurnal_amplitude=0.0, seed=seed,
        deadline_s=deadline_s, key_prefix="fkill",
    )
    arrivals = traffic_mod.generate_arrivals(model, duration_s)
    victim = fleet.replica_ids[0]
    drill: dict = {"pre_kill_done": [], "redone_keys": [],
                   "resubmitted": 0, "replays_ok": 0,
                   "inflight_at_kill": 0, "queued_at_kill": 0}

    def kill_fn(fleet) -> None:
        gw = fleet.gateways[victim]
        drill["inflight_at_kill"] = sum(
            len(w.inflight) for w in gw.workers.values())
        drill["queued_at_kill"] = gw.queue_depth()
        pre = reqlog_mod.fold(fleet.reqlogs[victim].replay())
        drill["pre_kill_done"] = [
            kv.key for kv in sorted(pre.keys.values(),
                                    key=lambda kv: kv.key)
            if kv.state == "completed"
        ]
        # the keys mid-flight in the dead shard — what adoption owes a
        # terminal in the SUCCESSOR's shard
        drill["redone_keys"] = [kv.key for kv in pre.incomplete()]
        fleet.kill(victim, clock.time())

    def resubmit_fn(fleet) -> None:
        # duplicates of the DEAD replica's completions, offered after
        # the reassignment window: they route to the successor, whose
        # adopted journal must answer them without regenerating
        now = clock.time()
        for n, key in enumerate(drill["pre_kill_done"][:resubmit]):
            drill["resubmitted"] += 1
            duplicate = gw_mod.Request(
                rid=900000 + n, prompt_len=8, max_new_tokens=4,
                key=key,
            )
            admission = fleet.submit(duplicate, now)
            if (admission.ok and admission.reason == gw_mod.REPLAYED
                    and admission.result is not None):
                drill["replays_ok"] += 1

    world_events = (
        traffic_mod.WorldEvent(at=kill_at, fn=kill_fn),
        traffic_mod.WorldEvent(
            at=kill_at + 5.0 * fleet.policy.tick_every_s,
            fn=resubmit_fn),
    )
    clock.launch()
    clock.begin()
    try:
        report = fleet_mod.drive_fleet(
            fleet, arrivals, clock, duration_s, events=world_events)
    finally:
        clock.release()

    journals = [fleet.reqlogs[rid].replay()
                for rid in fleet.replica_ids]
    merged = reqlog_mod.merge_records(*journals)
    led_records = ledger.replay()
    view = reqlog_mod.fold(merged)
    lost = [kv.key for kv in view.incomplete()]
    checker = ServeInvariantChecker(gw_policy)
    violations = checker.check_fleet(journals, led_records)
    if lost:
        violations.append(
            f"fleet-kill: {len(lost)} accepted request(s) lost across "
            f"the replica death: {lost[:5]}"
        )
    audit = fleet.reassignments[0] if fleet.reassignments else None
    if audit is None:
        violations.append(
            "fleet-kill: the dead replica's partitions were never "
            "reassigned"
        )
    # kill -> partitions reassigned + shard adopted (the window during
    # which the dead partitions 429); then the first REDONE key's
    # completion closes the client-visible gap
    mttr = (round(float(audit["at"]) - kill_at, 3)
            if audit is not None else None)
    redone_done = [
        r.get("ts") for r in merged
        if r.get("kind") == reqlog_mod.COMPLETED
        and r.get("key") in set(drill["redone_keys"])
        and r.get("ts", 0.0) >= kill_at
    ]
    return {
        "replicas": replicas,
        "num_slices": num_slices,
        "kill_at_s": kill_at,
        "victim": victim,
        "duration_s": duration_s,
        "offered": report["offered"],
        "accepted": sum(1 for kv in view.keys.values()
                        if kv.accepts > 0),
        "completed": sum(kv.completions for kv in view.keys.values()),
        "expired": sum(kv.expiries for kv in view.keys.values()),
        "inflight_at_kill": drill["inflight_at_kill"],
        "queued_at_kill": drill["queued_at_kill"],
        "partitions_reassigned": (int(audit["partitions"])
                                  if audit is not None else 0),
        "successor": audit["to"] if audit is not None else None,
        "requests_redone": (int(audit["redone"])
                            if audit is not None else 0),
        "redone_keys": drill["redone_keys"],
        "requests_lost": len(lost),
        "duplicates_resubmitted": drill["resubmitted"],
        "duplicates_replayed_from_journal": drill["replays_ok"],
        "kill_to_reassign_s": mttr,
        "redone_first_completion_s": (
            round(min(redone_done) - kill_at, 3)
            if redone_done else None),
        "dead_routed_429s": fleet.dead_routed,
        "violations": violations,
        "converged": report["quiescent"],
    }
