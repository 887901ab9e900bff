"""Federated gateway fleet: the sharded request plane. The port's copy of
`tritonk8ssupervisor_tpu/serving/fleet.py`, whole, over the port's
`Gateway`, request journal and event ledger; the same scenario gives the
same journal shards, lease records and report as the reference
(tests/test_torch_fleet.py).

One gateway (serving/gateway.py) is one admission door: every submit
serializes through one journal fsync and one queue, so past a few
hundred requests/sec the FRONT DOOR saturates long before the decode
slots do. This module scales the request plane OUT without giving up
any of the single-gateway guarantees:

- **Key-partitioned replicas**: N `Gateway` replicas (`g0..gN-1`),
  each owning a stable partition of the idempotency-key space
  (`partition_of`: crc32 of the routing key mod `partitions` — crc32,
  not `hash()`, so the mapping survives PYTHONHASHSEED and restarts).
  Each replica journals ONLY its partition into its own
  `serve-requests-<replica>.jsonl` shard, so admission fsyncs stop
  serializing fleet-wide. The exactly-once contract is preserved
  because a key always routes to the same partition: duplicates meet
  the replica that journaled the original. Multi-turn SESSIONS route
  by `session_id` instead of the per-turn key, pinning a whole
  conversation to one replica — its KV prefix chain
  (serving/kvpool.py) stays warm on the slices that replica leases.

- **Slice leases**: replicas never share a slot pool. Every slice is
  owned by at most one replica under a TTL'd lease recorded on the
  SUPERVISOR'S EVENT LEDGER (provision/events.py: LEASE_GRANT /
  LEASE_RENEW / LEASE_EXPIRE / LEASE_REVOKE), so the ownership history
  is replayable evidence, not an in-memory accident. Each grant mints
  a fleet-monotonic `epoch`; the gateway's claim path presents it as a
  fence (`Gateway._lease_guard`) — a replica whose lease expired or
  was revoked behind its back gets its pull REFUSED, which is what
  makes "two replicas never dispatch from the same pool" an invariant
  `testing/chaos.ServeInvariantChecker.check_fleet` can prove from the
  journals, not a scheduling coincidence.

- **Aggregated demand**: each replica publishes its own
  `demand-signal-<replica>.json`; the reference's
  `provision/autoscale.py` `read_fleet_demand` merges the shards
  (per-replica staleness guards) so the autoscaler and allocator keep
  consuming ONE signal (the port's autoscaler is not written yet:
  ROADMAP.md). Nothing in the provisioning plane knows how many
  gateways exist.

- **Fleet-wide WFQ**: every replica shares ONE `WfqClock`, so tenant
  virtual time advances globally and a flooding tenant cannot escape
  its weight by spraying requests across replicas.

- **Replica death**: `kill()` marks a replica dead; the next `tick()`
  revokes its leases (epoch fence: anything it still thinks it owns is
  refused), re-grants the slices, reassigns its key-partitions to a
  surviving replica, and has the successor ADOPT the dead journal
  shard (`Gateway.adopt`): completed keys stay answerable, incomplete
  keys are re-admitted front-of-queue and journaled into the
  successor's shard — the merged N-journal fold still conserves every
  accepted key. MTTR is bounded by the tick cadence, and the
  reassignment audit (`reassignments`) is the bench's MTTR evidence.

Chaos bar: testing/chaos.py `run_fleet_campaign` (replica-kill and
lease-expiry faults) and `run_fleet_kill_drill`; on the card,
chip_smoke.py's phase 30 drives two full-width engines through a kill.
Runbook: docs/failure-modes.md "Gateway fleet".
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable

from tritonk8ssupervisor_tpu_torch.provision import events as events_mod
from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod
from tritonk8ssupervisor_tpu_torch.serving.gateway import (
    REJECT_NO_CAPACITY,
    REJECT_OVERLOAD,
    SERVE,
    Admission,
    Gateway,
    GatewayPolicy,
    Request,
    WfqClock,
)


def partition_of(key, partitions: int) -> int:
    """The stable key-space shard for a routing key: crc32, not
    hash() — the mapping must survive process restarts and
    PYTHONHASHSEED, because a key that re-routed after a restart would
    meet a replica that never journaled it (exactly-once would leak)."""
    return zlib.crc32(str(key).encode("utf-8")) % max(1, int(partitions))


def route_key(request: Request) -> str:
    """What a request routes by: the session pins every turn of one
    conversation to one partition (KV affinity); otherwise the
    idempotency key (duplicates must meet the original's journal);
    keyless requests spread by rid."""
    if request.session_id is not None:
        return f"sess:{request.session_id}"
    if request.key is not None:
        return f"key:{request.key}"
    return f"rid:{request.rid}"


@dataclasses.dataclass
class FleetPolicy:
    """Fleet knobs (docs/failure-modes.md "Gateway fleet")."""

    replicas: int = 4
    # key-space shards; >> replicas so a reassignment moves partitions,
    # not "half the key space to whoever is left"
    partitions: int = 32
    lease_ttl_s: float = 30.0
    # renew when a held lease is within (ttl - renew_margin) of expiry
    lease_renew_margin_s: float = 10.0
    # fleet housekeeping cadence (sweep/renew/grant/reassign): the MTTR
    # bound for a replica kill is one tick + one adoption
    tick_every_s: float = 2.0
    # the front-door serialization cost model (sim drives only): each
    # replica admits one request per admit_cost_s — the fsync'd-journal
    # admission ceiling the fleet exists to scale past. A submit that
    # would queue more than admit_backlog_s behind the door is refused
    # 429-overload instead of silently absorbed (0 = no front-door
    # model, the real-path behavior where the fsync itself is the cost)
    admit_cost_s: float = 0.0
    admit_backlog_s: float = 1.0


class LeaseHeld(Exception):
    """grant() refused: the slice already has a live lease."""


class SliceLeases:
    """The slice-ownership table, ledger-recorded. All mutations append
    LEASE_* records to the supervisor's event ledger FIRST — the table
    here is the working copy a restart rebuilds from the fold
    (`restore`), which is why a crash mid-RENEW resumes without a
    double-grant: either the renew landed (same epoch, later expiry) or
    it didn't (same epoch, earlier expiry); both fold to exactly one
    live lease."""

    def __init__(self, ledger: events_mod.EventLedger) -> None:
        self.ledger = ledger
        self.epoch = 0  # fleet-monotonic grant fence, high-water mark
        self.table: dict = {}  # slice -> {replica, epoch, expires_at}

    def restore(self, view: events_mod.LedgerView) -> None:
        """Resume from a folded ledger: the epoch high-water mark must
        be the max ever granted (a re-grant after a crash can never
        reuse a dead holder's fence), the table the live leases."""
        self.epoch = max(self.epoch, int(view.lease_epoch))
        self.table = {int(i): dict(entry)
                      for i, entry in view.leases.items()}

    def live(self, index: int, now: float) -> dict | None:
        """The slice's lease if it is live at `now`. Expiry is
        inclusive at the boundary: a lease granted until T is DEAD at
        exactly T (the holder must renew strictly before), so a fence
        check and a sweep at the same instant agree."""
        entry = self.table.get(int(index))
        if entry is None or now >= float(entry["expires_at"]):
            return None
        return entry

    def check(self, index: int, replica: str, now: float) -> int | None:
        """The dispatch fence: the lease epoch iff `replica` holds a
        live lease on the slice at `now`, else None (refuse the pull)."""
        entry = self.live(index, now)
        if entry is None or entry["replica"] != replica:
            return None
        return int(entry["epoch"])

    def grant(self, index: int, replica: str, now: float,
              ttl_s: float) -> dict:
        """Open ownership: mints a FRESH epoch (the fence a stale
        holder can never present). A lapsed-but-unswept lease on the
        slice is expired first; a live one raises LeaseHeld — the
        caller must revoke explicitly, never silently overlap."""
        index = int(index)
        entry = self.table.get(index)
        if entry is not None:
            if now < float(entry["expires_at"]):
                raise LeaseHeld(
                    f"slice {index} leased to {entry['replica']} "
                    f"(epoch {entry['epoch']}) until "
                    f"{entry['expires_at']}"
                )
            self.expire(index, now)
        self.epoch += 1
        entry = {"replica": str(replica), "epoch": self.epoch,
                 "expires_at": now + float(ttl_s)}
        self.ledger.append(events_mod.LEASE_GRANT, slice=index,
                           replica=entry["replica"], epoch=self.epoch,
                           expires_at=entry["expires_at"])
        self.table[index] = entry
        return entry

    def renew(self, index: int, replica: str, now: float,
              ttl_s: float) -> dict | None:
        """Extend a LIVE lease the replica holds — same epoch, later
        expiry. None (no record appended) when there is nothing to
        renew: lapsed, revoked, or held by a peer."""
        entry = self.live(int(index), now)
        if entry is None or entry["replica"] != str(replica):
            return None
        entry["expires_at"] = now + float(ttl_s)
        self.ledger.append(events_mod.LEASE_RENEW, slice=int(index),
                           replica=entry["replica"],
                           epoch=entry["epoch"],
                           expires_at=entry["expires_at"])
        return entry

    def expire(self, index: int, now: float) -> dict | None:
        """Close a lapsed lease on the ledger (swept at fleet ticks)."""
        entry = self.table.pop(int(index), None)
        if entry is None:
            return None
        self.ledger.append(events_mod.LEASE_EXPIRE, slice=int(index),
                           replica=entry["replica"],
                           epoch=entry["epoch"], at=now)
        return entry

    def revoke(self, index: int, now: float, reason: str = "") -> dict | None:
        """Administratively close a lease (dead replica, rebalance).
        The epoch dies with it: the old holder's next fenced claim gets
        None even if its clock still thinks the lease is live."""
        entry = self.table.pop(int(index), None)
        if entry is None:
            return None
        self.ledger.append(events_mod.LEASE_REVOKE, slice=int(index),
                           replica=entry["replica"],
                           epoch=entry["epoch"], at=now, reason=reason)
        return entry

    def sweep(self, now: float) -> list:
        """Expire every lapsed lease; returns [(slice, entry)] for the
        caller to detach workers / reset engines."""
        lapsed = sorted(i for i, e in self.table.items()
                        if now >= float(e["expires_at"]))
        return [(i, self.expire(i, now)) for i in lapsed]

    def held_by(self, replica: str) -> list:
        return sorted(i for i, e in self.table.items()
                      if e["replica"] == str(replica))


class GatewayFleet:
    """N gateway replicas sharding the request plane. The fleet is the
    control loop (tick: sweep/renew/grant/reassign) plus the router
    (submit: partition -> owning replica); the replicas are ordinary
    `Gateway` instances — same admission, same journal discipline, same
    report — differing only in identity (`replica=`), journal shard,
    demand-signal shard, lease fence, and the shared WFQ clock."""

    def __init__(
        self,
        engines: dict,
        paths,
        ledger: events_mod.EventLedger,
        policy: FleetPolicy | None = None,
        gateway_policy: GatewayPolicy | None = None,
        health=None,
        clock: Callable[[], float] = time.monotonic,
        echo: Callable[[str], None] = lambda line: None,
        telemetry=None,
        fsync: bool = True,
    ) -> None:
        self.policy = policy or FleetPolicy()
        self.engines = {int(i): e for i, e in engines.items()}
        self.ledger = ledger
        self.clock = clock
        self._echo = echo
        self._paths = paths
        # what a replica restart needs to rebuild its gateway fresh
        # (revive(): a new process over the same journal shard)
        self._gw_ctor = {"health": health, "policy": gateway_policy,
                         "telemetry": telemetry}
        self.leases = SliceLeases(ledger)
        self.leases.restore(events_mod.fold(ledger.replay()))
        self.wfq = WfqClock()  # ONE clock: fleet-wide tenant weights
        self.replica_ids = [f"g{i}"
                            for i in range(max(1, self.policy.replicas))]
        self.alive = {rid: True for rid in self.replica_ids}
        self.reqlogs = {
            rid: reqlog_mod.RequestLog(
                paths.request_log_replica(rid), clock=clock,
                echo=echo, fsync=fsync,
            )
            for rid in self.replica_ids
        }
        self.gateways = {rid: self._make_gateway(rid)
                         for rid in self.replica_ids}
        # stable initial ownership: partition p -> replica p mod N
        n = len(self.replica_ids)
        self.partition_owner = {
            p: self.replica_ids[p % n]
            for p in range(max(1, self.policy.partitions))
        }
        self._admit_free_at = {rid: 0.0 for rid in self.replica_ids}
        self._adopted: set = set()  # dead replicas whose shard was folded
        self.reassignments: list = []  # {"from","to","at","partitions",..}
        self.frontdoor_sheds = 0  # refused at the admission-cost door
        self.dead_routed = 0  # routed to a dead owner pre-reassignment
        self._ticks = 0
        self._last_tick: float | None = None

    def _guard_for(self, rid: str) -> Callable:
        return lambda index, now: self.leases.check(index, rid, now)

    def _make_gateway(self, rid: str) -> Gateway:
        return Gateway(
            engines={},  # slices arrive by lease grant, not ctor
            health=self._gw_ctor["health"],
            policy=self._gw_ctor["policy"],
            clock=self.clock,
            echo=self._echo,
            reqlog=self.reqlogs[rid],
            telemetry=self._gw_ctor["telemetry"],
            demand_path=self._paths.demand_signal_replica(rid),
            replica=rid,
            lease_guard=self._guard_for(rid),
            wfq=self.wfq,
        )

    # ------------------------------------------------------------- control

    def live_replicas(self) -> list:
        return [rid for rid in self.replica_ids if self.alive[rid]]

    def _least_loaded(self, live: list) -> str:
        """The live replica holding the fewest leases (ties by name —
        deterministic grants for a given history)."""
        return min(live, key=lambda rid: (len(self.leases.held_by(rid)),
                                          rid))

    def _grant_pool(self) -> list:
        """Who may receive lease grants: live PARTITION OWNERS. A
        replica no key routes to (a revived standby whose partitions
        moved on) would serve nobody from a leased pool — gateways
        dispatch their OWN queues, so slot leases must follow request
        ownership."""
        live = self.live_replicas()
        owners = set(self.partition_owner.values())
        return [rid for rid in live if rid in owners] or live

    def tick(self, now: float | None = None) -> dict:
        """One housekeeping round: sweep lapsed leases, reap dead
        replicas (revoke + partition reassignment + journal adoption),
        renew what live holders still need, grant what is unowned.
        Idempotent at one instant; the drive calls it at
        `tick_every_s`. Returns a small audit of what moved."""
        now = self.clock() if now is None else now
        self._ticks += 1
        self._last_tick = now
        pol = self.policy
        moved = {"expired": 0, "revoked": 0, "granted": 0,
                 "renewed": 0, "adopted": []}
        # 1) lapsed leases: the holder (if alive) loses the slice and
        # requeues its in-flight; a dead holder's engine is reset when
        # the slice is re-granted below
        for index, entry in self.leases.sweep(now):
            moved["expired"] += 1
            rid = entry["replica"]
            if self.alive.get(rid):
                self.gateways[rid].detach_worker(index, now,
                                                 cause="lease-expired")
        # 2) dead replicas: revoke every lease they still hold (the
        # epoch fence turns their residual claims into refusals even
        # before this lands), reset the engines so the next holder
        # starts clean, then reassign partitions + adopt the journal
        live = self.live_replicas()
        for rid in self.replica_ids:
            if self.alive[rid]:
                continue
            for index in self.leases.held_by(rid):
                self.leases.revoke(index, now, reason="replica-dead")
                moved["revoked"] += 1
                try:
                    self.engines[index].reset()
                except Exception as e:  # noqa: BLE001 - keep reaping
                    self._echo(f"[fleet] slice {index} reset failed "
                               f"after {rid} died: {e!r}")
            if rid not in self._adopted and live:
                # never hand partitions to a once-dead replica: its
                # shard history is already spoken for (adopted), so a
                # second death there could not be adopted again without
                # re-admitting keys the first successor settled
                candidates = [r for r in live
                              if r not in self._adopted] or live
                successor = self._least_loaded(candidates)
                owned = [p for p, o in self.partition_owner.items()
                         if o == rid]
                for p in owned:
                    self.partition_owner[p] = successor
                adopted = self.gateways[successor].adopt(
                    self.reqlogs[rid].replay(), now)
                self._adopted.add(rid)
                audit = {"from": rid, "to": successor, "at": now,
                         "partitions": len(owned), **adopted}
                self.reassignments.append(audit)
                moved["adopted"].append(audit)
                self._echo(
                    f"[fleet] {rid} dead: {len(owned)} partition(s) -> "
                    f"{successor}, journal adopted "
                    f"({adopted['redone']} re-admitted)"
                )
        # 3) renew live holders' leases inside the margin
        for index, entry in sorted(self.leases.table.items()):
            rid = entry["replica"]
            if not self.alive.get(rid):
                continue
            margin = pol.lease_ttl_s - pol.lease_renew_margin_s
            if float(entry["expires_at"]) - now <= margin:
                if self.leases.renew(index, rid, now,
                                     pol.lease_ttl_s) is not None:
                    moved["renewed"] += 1
        # 4) grant unowned slices to the least-loaded live replica
        if live:
            for index in sorted(self.engines):
                if self.leases.live(index, now) is not None:
                    continue
                target = self._least_loaded(self._grant_pool())
                entry = self.leases.grant(index, target, now,
                                          pol.lease_ttl_s)
                self.gateways[target].attach_worker(
                    index, self.engines[index])
                moved["granted"] += 1
        return moved

    def kill(self, rid: str, now: float | None = None) -> None:
        """A replica process dies: its journal shard and leases survive
        on disk/ledger (that is the point); the next tick revokes,
        reassigns, and adopts. In-flight work on its leased slices is
        recovered FROM THE JOURNAL by the successor — the live Request
        objects die with the process, exactly like a real crash."""
        now = self.clock() if now is None else now
        rid = str(rid)
        if not self.alive.get(rid, False):
            return
        self.alive[rid] = False
        self._echo(f"[fleet] replica {rid} killed at {now:.3f}")

    def revive(self, rid: str, now: float | None = None) -> None:
        """A killed replica returns AS A NEW PROCESS: a FRESH gateway
        (the old memory died with the kill — queued and in-flight
        Request objects must not resurrect) appending to the same
        journal shard. It does NOT recover() the shard: the successor
        already adopted it, and a second re-admission here would
        double-serve those keys. It rejoins as a standby — partitions
        stay where the reassignment put them, and lease grants follow
        partition ownership (`_grant_pool`)."""
        rid = str(rid)
        if self.alive.get(rid, True):
            return
        self.gateways[rid] = self._make_gateway(rid)
        self._admit_free_at[rid] = 0.0
        self.alive[rid] = True

    # -------------------------------------------------------------- routing

    def owner_of(self, request: Request) -> str:
        p = partition_of(route_key(request), self.policy.partitions)
        return self.partition_owner[p]

    def submit(self, request: Request,
               now: float | None = None) -> Admission:
        """Route the request to its partition's owner. A dead owner
        (kill not yet reassigned — the MTTR window) refuses 429-style
        with the tick cadence as the Retry-After; nothing is journaled
        because nothing was accepted. The front-door cost model (sim
        drives) charges each replica `admit_cost_s` of serialized
        admission work per accepted offer — the ceiling the N-way shard
        exists to scale past."""
        now = self.clock() if now is None else now
        if self._last_tick is None:
            self.tick(now)  # bootstrap: leases before the first offer
        rid = self.owner_of(request)
        if not self.alive[rid]:
            self.dead_routed += 1
            return Admission(False, REJECT_NO_CAPACITY,
                             retry_after_s=self.policy.tick_every_s)
        if self.policy.admit_cost_s > 0:
            free_at = max(self._admit_free_at[rid], now)
            backlog = free_at - now
            if backlog > self.policy.admit_backlog_s:
                self.frontdoor_sheds += 1
                return Admission(False, REJECT_OVERLOAD,
                                 retry_after_s=max(1.0, backlog))
            self._admit_free_at[rid] = free_at \
                + self.policy.admit_cost_s
        return self.gateways[rid].submit(request, now)

    # -------------------------------------------------------------- reports

    def partition_counts(self) -> dict:
        counts = {rid: 0 for rid in self.replica_ids}
        for owner in self.partition_owner.values():
            counts[owner] += 1
        return counts

    def merged_records(self) -> list:
        """All replicas' journal shards, chronologically merged — what
        the fleet invariant checker folds."""
        return reqlog_mod.merge_records(
            *[self.reqlogs[rid].replay() for rid in self.replica_ids]
        )

    def report(self, now: float | None = None) -> dict:
        """The fleet summary: per-replica gateway reports plus merged
        totals and the lease/reassignment audit."""
        now = self.clock() if now is None else now
        per_replica = {rid: self.gateways[rid].report()
                       for rid in self.replica_ids}
        merged = {
            field: sum(int(r[field]) for r in per_replica.values())
            for field in ("submitted", "completed", "expired",
                          "tokens_generated", "replayed_from_journal")
        }
        rejected: dict = {}
        for r in per_replica.values():
            for reason, count in r["rejected"].items():
                rejected[reason] = rejected.get(reason, 0) + int(count)
        merged["rejected"] = dict(sorted(rejected.items()))
        latencies = sorted(
            lat for rid in self.replica_ids
            for lat in self.gateways[rid].metrics.latencies()
        )

        def pct(q):
            if not latencies:
                return None
            idx = min(len(latencies) - 1,
                      max(0, int(round(q * (len(latencies) - 1)))))
            return latencies[idx]

        merged["p50_latency_s"] = pct(0.50)
        merged["p99_latency_s"] = pct(0.99)
        return {
            "replicas": len(self.replica_ids),
            "alive": sorted(r for r in self.replica_ids
                            if self.alive[r]),
            "partitions": self.policy.partitions,
            "partition_counts": self.partition_counts(),
            "leases": {str(i): dict(e) for i, e
                       in sorted(self.leases.table.items())},
            "lease_epoch": self.leases.epoch,
            "ticks": self._ticks,
            "frontdoor_sheds": self.frontdoor_sheds,
            "dead_routed": self.dead_routed,
            "reassignments": list(self.reassignments),
            **merged,
            "per_replica": per_replica,
        }


def drive_fleet(
    fleet: GatewayFleet,
    arrivals: list,
    clock,
    horizon_s: float,
    events: tuple = (),
    drain_grace_s: float = 600.0,
) -> dict:
    """The fleet twin of serving/traffic.drive_open_loop: one
    deterministic discrete-event actor interleaving arrivals, scripted
    world events (`fn(fleet)` — replica kills, forced lease expiries),
    fleet ticks at the policy cadence, and per-SLICE step boundaries in
    time order. A slice's worker is whatever replica currently holds
    its lease — stepping is keyed by slice, so ownership moving between
    replicas mid-drive never double-steps an engine. Ends when every
    arrival was offered and the fleet is quiescent (live queues empty,
    workers idle, no dead shard awaiting adoption), or at
    horizon+grace with `quiescent: False`."""
    arrivals = sorted(arrivals, key=lambda r: r.arrival)
    events = sorted(events, key=lambda e: e.at)
    i_arr = 0
    i_ev = 0
    pol = fleet.policy
    next_step: dict = {i: None for i in fleet.engines}  # slice -> time
    t_tick = 0.0  # fleet housekeeping is due at/after this instant
    hard_stop = horizon_s + drain_grace_s

    def worker_of(index):
        """The slice's CURRENT lease holder's worker, or None (unowned,
        dead holder, or not yet attached)."""
        entry = fleet.leases.table.get(index)
        if entry is None:
            return None
        rid = entry["replica"]
        if not fleet.alive.get(rid):
            return None
        return fleet.gateways[rid].workers.get(index)

    def wake_idle(now: float) -> None:
        for index in fleet.engines:
            if next_step[index] is not None:
                continue
            worker = worker_of(index)
            if worker is None or not worker.alive:
                continue
            gw = worker.gateway
            if worker.inflight or (
                gw.queue_depth() and gw.slice_mode(index) == SERVE
                and fleet.leases.check(index, gw.replica, now) is not None
            ):
                next_step[index] = now

    def pending_adoption() -> bool:
        live = fleet.live_replicas()
        return bool(live) and any(
            not fleet.alive[rid] and rid not in fleet._adopted
            for rid in fleet.replica_ids
        )

    while True:
        now = clock.time()
        drained = (
            i_arr >= len(arrivals) and i_ev >= len(events)
            and not pending_adoption()
            and all(fleet.gateways[rid].queue_depth() == 0
                    for rid in fleet.live_replicas())
            and all(w.idle() for rid in fleet.live_replicas()
                    for w in fleet.gateways[rid].workers.values())
        )
        if drained:
            break
        candidates = [t_tick]
        if i_arr < len(arrivals):
            candidates.append(arrivals[i_arr].arrival)
        if i_ev < len(events):
            candidates.append(events[i_ev].at)
        candidates.extend(t for t in next_step.values()
                          if t is not None)
        t_next = min(candidates)
        if t_next >= hard_stop:
            break
        if t_next > now:
            clock.sleep(t_next - now)
            now = t_next
        # tie order: arrivals, then world events, then the fleet tick,
        # then workers by slice index — matches drive_open_loop, with
        # the tick slotted before stepping so a kill at a boundary is
        # reaped before anyone pulls
        while i_arr < len(arrivals) and arrivals[i_arr].arrival <= now:
            fleet.submit(arrivals[i_arr], now)
            i_arr += 1
        while i_ev < len(events) and events[i_ev].at <= now:
            events[i_ev].fn(fleet)
            i_ev += 1
        if now >= t_tick:
            fleet.tick(now)
            for rid in fleet.live_replicas():
                fleet.gateways[rid].expire_queued(now)
            t_tick = now + pol.tick_every_s
        for index in sorted(fleet.engines):
            if next_step[index] is not None and next_step[index] <= now:
                worker = worker_of(index)
                if worker is None:
                    next_step[index] = None
                    continue
                dt = worker.step(now)
                next_step[index] = None if dt is None else now + dt
        wake_idle(now)

    quiescent = (
        i_arr >= len(arrivals)
        and not pending_adoption()
        and all(fleet.gateways[rid].queue_depth() == 0
                for rid in fleet.live_replicas())
        and all(w.idle() for rid in fleet.live_replicas()
                for w in fleet.gateways[rid].workers.values())
    )
    report = fleet.report(clock.time())
    report.update({
        "offered": len(arrivals),
        "drive_end_s": clock.time(),
        "quiescent": quiescent,
    })
    return report
