"""Seeded chaos campaigns and the checkers that prove their invariants:
the port's copy of `tritonk8ssupervisor_tpu/testing/chaos.py`, whole.

The supervisor campaign core:

- `ChaosFleet`: a scripted world whose slice health is a function of
  virtual time (testing/simclock.py) and of fault primitives: domain
  outages, preemption storms, quota storms, flapping SSH, torn
  `fleet-status.json` copies, SIGKILL mid-heal-wave.
- `generate_scenario(seed)`: the same seed always composes the same
  faults at the same virtual times.
- `run_campaign`: drives the port's `Supervisor`
  (provision/supervisor.py) tick by tick through a scenario, restarting
  it from the event ledger after every injected kill.
- `InvariantChecker`: folds the campaign's ledger and names every record
  that breaks no double-heal, token conservation, legal breaker
  transitions, or the domain canary gate.

The request plane's part:

- `generate_serve_scenario` and `run_serve_campaign`: a real
  `Supervisor` and a real `Gateway` over modeled engines on one
  `SimClock`; a gateway kill drops the gateway and resumes a fresh one
  from the request journal.
- `ServeInvariantChecker`: folds a request journal (serving/reqlog.py),
  or all of a gateway fleet's journal shards merged, next to the
  supervisor's event ledger, and names every record that breaks request
  conservation, exactly-once service, deadline honesty, honest
  Retry-After, bounded routing staleness, the cross-ledger contract, the
  metrics-vs-journal contract, and the fleet's partition, lease and
  epoch-fence invariants.
- `run_gateway_kill_drill`: one gateway over modeled engines on a
  `SimClock`, dropped mid-dispatch and resumed from its journal.
- `run_autoscale_drive` and `run_autoscale_campaign`: the loop from
  gateway demand to the autoscaler (provision/autoscale.py) through
  preemptions, torn status and demand copies, gateway kills, failed
  applies and supervisor kills.
- `run_coschedule_drive` and `run_coschedule_campaign`: serving and a
  `VirtualTrainer` sharing one fleet through the allocator
  (provision/allocator.py), with kills mid-handover (`KillOnKindLedger`),
  a trainer that never acks, and a tenant flood against the admission
  queue.
- `generate_fleet_scenario`, `run_fleet_campaign` and
  `run_fleet_kill_drill`: the gateway fleet (serving/fleet.py) through
  replica kills, revivals and forced lease expiries, checked by
  `check_fleet` over all shards and the lease ledger.

The same seeds give the same ledgers, journals, lease records and reports
as the reference (tests/test_torch_chaos.py, tests/test_torch_fleet.py,
tests/test_torch_serve_chaos.py, tests/test_torch_autoscale_chaos.py,
tests/test_torch_coschedule.py).
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
from pathlib import Path

from tritonk8ssupervisor_tpu_torch.config.schema import ClusterConfig
from tritonk8ssupervisor_tpu_torch.provision import events as events_mod
from tritonk8ssupervisor_tpu_torch.provision import heal as heal_mod
from tritonk8ssupervisor_tpu_torch.provision import supervisor as sup_mod
from tritonk8ssupervisor_tpu_torch.provision.runner import CommandError
from tritonk8ssupervisor_tpu_torch.provision.state import ClusterHosts, RunPaths
from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod
from tritonk8ssupervisor_tpu_torch.testing.faults import (
    FaultPlan,
    FaultRule,
    SupervisorKilled,
)
from tritonk8ssupervisor_tpu_torch.testing.simclock import SimClock

QUOTA_OUTPUT = ("Error: googleapi: Error 429: Too Many Requests, "
                "rateLimitExceeded (RESOURCE_EXHAUSTED)")


class _Quiet:
    """Prompter that keeps the transcript (drills assert on say lines)."""

    def __init__(self) -> None:
        self.lines: list = []

    def say(self, text: str = "") -> None:
        self.lines.append(text)

    def text(self) -> str:
        return "\n".join(self.lines)


def sim_config(num_slices: int, failure_domains: int = 0) -> ClusterConfig:
    return ClusterConfig(
        project="sim-proj", zone="us-west4-a", generation="v5e",
        topology="4x4", mode="tpu-vm", num_slices=num_slices,
        failure_domains=failure_domains,
    )


class ChaosFleet:
    """A scripted fleet whose health is a function of virtual time and
    the scenario's fault primitives. Implements the run/run_quiet RunFn
    pair every layer under the supervisor consumes; thread-safe, because
    parallel heal waves drive it from several workers at once."""

    def __init__(self, root: Path, clock, config: ClusterConfig,
                 heal_seconds: float = 120.0,
                 teardown_seconds: float = 10.0) -> None:
        self.paths = RunPaths(Path(root))
        self.paths.terraform_module("tpu-vm").mkdir(parents=True,
                                                    exist_ok=True)
        self.config = config
        self.clock = clock
        self.heal_seconds = heal_seconds
        self.teardown_seconds = teardown_seconds
        n = config.num_slices
        self.num_slices = n
        self.down: set = set()
        self.down_at: list = []  # (ts, slice)
        # slices the autoscaler tore down ON PURPOSE (terraform destroy
        # -target): absent from the listing like `down`, but the
        # supervisor's active-set scoping means nothing diagnoses or
        # heals them; a scale-up's scoped apply brings them back
        self.removed: set = set()
        # heals into these slices do not stick until the given ts
        # (a truly dead compartment: replace "succeeds" but readiness
        # never does) — inf means never
        self.heal_refuses: dict = {}  # slice -> until ts
        # the next N terraform applies FAIL (CommandError) — the
        # slice-loss-mid-scale-up primitive: provisioning new capacity
        # dies under the autoscaler, which must SCALE_ABORT and retry
        # behind its cooldown/breaker instead of double-provisioning
        self.apply_failures_remaining = 0
        self.quota_windows: list = []  # (start, until)
        self.flap_windows: dict = {}  # slice -> (start, until, period)
        self.applies: list = []
        self.destroys: list = []  # scale-down teardown orders
        self._lock = threading.Lock()
        self.ips = {i: f"10.0.{i}.1" for i in range(n)}
        ClusterHosts(
            host_ips=[[self.ips[i]] for i in range(n)],
            internal_ips=[[f"10.1.{i}.1"] for i in range(n)],
            coordinator_ip="10.1.0.1",
        ).save(self.paths.hosts_file)
        self.paths.tfstate("tpu-vm").write_text(json.dumps(
            {"resources": [{"index": i} for i in range(n)]}
        ))

    # ------------------------------------------------------ fault wiring

    def preempt(self, slice_index: int, at: float) -> None:
        self.down_at.append((float(at), int(slice_index)))

    def domain_outage(self, domain: str, at: float,
                      heals_stick_after: float | None = None) -> None:
        """Every slice of `domain` goes down at `at` — one correlated
        loss. With `heals_stick_after`, replaces before that time do not
        bring slices back (the compartment itself is dead)."""
        for i, name in self.config.domain_map().items():
            if name == domain:
                self.preempt(i, at)
                if heals_stick_after is not None:
                    self.heal_refuses[i] = float(heals_stick_after)

    def quota_storm(self, at: float, until: float) -> None:
        self.quota_windows.append((float(at), float(until)))

    def flap_ssh(self, slice_index: int, at: float, until: float,
                 period: float) -> None:
        self.flap_windows[int(slice_index)] = (
            float(at), float(until), max(1.0, float(period))
        )

    # ------------------------------------------------------- world state

    def _sync_locked(self) -> None:
        now = self.clock.time()
        for at, i in list(self.down_at):
            if now >= at:
                self.down.add(i)
                self.down_at.remove((at, i))

    def down_now(self) -> set:
        """The currently-dead slice set at this virtual instant — what
        the serve-chaos drive syncs its engine liveness against.
        Includes slices the autoscaler tore down: their engines are
        gone exactly like a preempted slice's, on purpose."""
        with self._lock:
            self._sync_locked()
            return set(self.down) | set(self.removed)

    def _quota_throttled(self, now: float) -> bool:
        return any(start <= now < until
                   for start, until in self.quota_windows)

    def _flapping(self, index: int, now: float) -> bool:
        window = self.flap_windows.get(index)
        if window is None or index in self.down:
            return False
        start, until, period = window
        if not (start <= now < until):
            return False
        return int((now - start) // period) % 2 == 1

    # ------------------------------------------------------------ RunFns

    def run(self, args, cwd=None, **kwargs) -> str:
        line = " ".join(str(a) for a in args)
        with self._lock:
            self._sync_locked()
        if line.startswith("terraform apply"):
            replaced = [int(str(a).split("[")[1].rstrip("]"))
                        for a in args if str(a).startswith("-replace=")]
            with self._lock:
                self.applies.append(replaced)
                failing = self.apply_failures_remaining > 0
                if failing:
                    self.apply_failures_remaining -= 1
            if failing:
                # capacity died mid-provision (quota pulled, stockout):
                # the apply burns time, then fails
                self.clock.sleep(self.heal_seconds / 2.0)
                raise CommandError(list(args), 1,
                                   tail="Error: resource exhausted "
                                        "mid-apply (scripted)")
            self.clock.sleep(self.heal_seconds)
            now = self.clock.time()
            with self._lock:
                for i in replaced:
                    if now >= self.heal_refuses.get(i, float("-inf")):
                        self.down.discard(i)
                        self.removed.discard(i)
                        self.ips[i] = f"10.9.{i}.{len(self.applies)}"
        elif line.startswith("terraform destroy"):
            targets = [int(str(a).split("[")[1].rstrip("]"))
                       for a in args if str(a).startswith("-target=")]
            with self._lock:
                self.destroys.append(targets)
            self.clock.sleep(self.teardown_seconds)
            with self._lock:
                for i in targets:
                    self.removed.add(i)
                    self.down.discard(i)
        return ""

    def run_quiet(self, args, cwd=None, **kwargs) -> str:
        with self._lock:
            self._sync_locked()
            now = self.clock.time()
            if args[:3] == ["terraform", "output", "-json"]:
                return json.dumps({
                    "host_ips": {"value": [
                        [self.ips[i]] for i in range(self.num_slices)
                    ]},
                    "internal_ips": {"value": [
                        [f"10.1.{i}.1"] for i in range(self.num_slices)
                    ]},
                })
            if args and args[0] == "gcloud" and "list" in list(args):
                if self._quota_throttled(now):
                    raise CommandError(list(args), 1, tail=QUOTA_OUTPUT)
                return "\n".join(
                    f"{self.config.node_prefix}-{i}\tREADY"
                    for i in range(self.num_slices)
                    if i not in self.down and i not in self.removed
                )
            if args and args[0] == "ssh":
                ip = args[-2]
                index = next(
                    (i for i, x in self.ips.items() if x == ip), None
                )
                if "cat" in args[-1]:
                    return ""  # no drain files in chaos scenarios
                if index in self.down or index in self.removed or (
                    index is not None and self._flapping(index, now)
                ):
                    raise CommandError(list(args), 255)
                return ""
            return ""


# ---------------------------------------------------------------- scenarios


@dataclasses.dataclass
class Scenario:
    """One seeded composition of fault primitives. `events` is the
    declarative fault list (kind + params at virtual times); everything
    downstream — the world, the campaign, the reproduction — is a pure
    function of it."""

    seed: int
    num_slices: int
    failure_domains: int
    events: list
    max_ticks: int = 80
    mttr_bound_s: float = 2400.0

    @property
    def fault_times(self) -> list:
        return sorted(e.get("at", 0.0) for e in self.events)


PRIMITIVES = ("domain-outage", "preemption-storm", "quota-storm",
              "flapping-ssh", "torn-status", "sigkill-mid-heal")


def generate_scenario(
    seed: int,
    num_slices: int = 16,
    failure_domains: int = 4,
    interval: float = 30.0,
) -> Scenario:
    """Deterministic scenario from `seed`: one anchor fault (a domain
    outage or a cross-domain preemption storm) plus up to two extra
    primitives. Every generated scenario is heal-able — outages stick,
    quota storms end, flaps settle — so convergence to healthy within
    the MTTR bound is always the expected verdict."""
    rng = random.Random(int(seed))
    config = sim_config(num_slices, failure_domains)
    domains = sorted(set(config.domain_map().values()))
    events: list = []
    anchor_at = 60.0 + interval * rng.randrange(0, 5)
    if rng.random() < 0.6:
        events.append({"kind": "domain-outage",
                       "domain": rng.choice(domains), "at": anchor_at})
    else:
        count = 2 + rng.randrange(max(1, num_slices // 4))
        events.append({
            "kind": "preemption-storm",
            "slices": sorted(rng.sample(range(num_slices), count)),
            "at": anchor_at,
        })
    used = {"sigkill-mid-heal": False, "torn-status": False}
    for _ in range(rng.randrange(0, 3)):
        kind = rng.choice(PRIMITIVES[2:])
        at = anchor_at + interval * rng.randrange(0, 6)
        if kind == "quota-storm":
            events.append({"kind": kind, "at": at,
                           "duration": 60.0 + 60.0 * rng.randrange(0, 4)})
        elif kind == "flapping-ssh":
            events.append({
                "kind": kind, "slice": rng.randrange(num_slices),
                "at": at, "duration": 4 * interval,
                "period": 2 * interval,
            })
        elif kind == "torn-status" and not used["torn-status"]:
            used["torn-status"] = True
            events.append({"kind": kind, "at": at})
        elif kind == "sigkill-mid-heal" and not used["sigkill-mid-heal"]:
            used["sigkill-mid-heal"] = True
            events.append({"kind": kind, "nth": 1 + rng.randrange(2)})
    return Scenario(seed=int(seed), num_slices=num_slices,
                    failure_domains=failure_domains, events=events)


def default_policy(interval: float = 30.0) -> sup_mod.SupervisePolicy:
    """The campaign policy: tight enough that every safety rail is
    exercised inside the tick budget, deterministic (rng pinned by the
    campaign), heal-able storms."""
    return sup_mod.SupervisePolicy(
        interval=interval, flap_threshold=2, heal_burst=2,
        heal_refill_s=3600.0, breaker_threshold=3,
        breaker_window_s=7200.0, breaker_cooldown_s=600.0,
        breaker_cooldown_cap_s=3600.0, heal_workers=4,
        domain_threshold=3, domain_window_s=300.0,
        domain_cooldown_s=300.0, quota_defer_cap_s=600.0,
        page_size=8, max_degraded=0,
    )


def _tear_file(path: Path) -> None:
    """Simulate a half-copied (rsync mid-flight) status file: keep the
    first half of the bytes — invalid JSON, exactly what tolerant
    readers must survive."""
    try:
        raw = path.read_bytes()
    except OSError:
        return
    if raw:
        path.write_bytes(raw[: max(1, len(raw) // 2)])


def run_campaign(
    scenario: Scenario,
    workdir: Path,
    policy: sup_mod.SupervisePolicy | None = None,
    heal_seconds: float = 120.0,
) -> dict:
    """Drive one seeded campaign: REAL Supervisor, scripted world,
    virtual clock. Injected SIGKILLs restart the supervisor from its
    event ledger (the crash-resume path, not a fresh world). Returns the
    campaign verdict: violations (from InvariantChecker), convergence,
    MTTR, restart count."""
    policy = policy or default_policy()
    clock = SimClock()
    config = sim_config(scenario.num_slices, scenario.failure_domains)
    world = ChaosFleet(Path(workdir), clock, config,
                       heal_seconds=heal_seconds)
    torn_at: list = []
    kill_plan: FaultPlan | None = None
    run_fn = world.run
    for event in scenario.events:
        kind = event["kind"]
        if kind == "domain-outage":
            world.domain_outage(event["domain"], at=event["at"])
        elif kind == "preemption-storm":
            for i in event["slices"]:
                world.preempt(i, at=event["at"])
        elif kind == "quota-storm":
            world.quota_storm(event["at"],
                              event["at"] + event["duration"])
        elif kind == "flapping-ssh":
            world.flap_ssh(event["slice"], event["at"],
                           event["at"] + event["duration"],
                           event["period"])
        elif kind == "torn-status":
            torn_at.append(float(event["at"]))
        elif kind == "sigkill-mid-heal":
            kill_plan = FaultPlan(
                [FaultRule(match="terraform apply",
                           after=int(event["nth"]) - 1, kill=True)],
                echo=lambda line: None,
            )
            run_fn = kill_plan.wrap(world.run)

    ledger = events_mod.EventLedger(world.paths.events, clock=clock.time,
                                    echo=lambda line: None)

    def make_supervisor() -> sup_mod.Supervisor:
        return sup_mod.Supervisor(
            config, world.paths, _Quiet(),
            run=run_fn, run_quiet=world.run_quiet, policy=policy,
            ledger=ledger, clock=clock.time, sleep=clock.sleep,
            rng=lambda: 0.0, readiness_timeout=60.0, hooks=clock,
        )

    supervisor = make_supervisor()
    last_fault = max(scenario.fault_times, default=0.0)
    restarts = 0
    ticks_run = 0
    healthy_streak = 0
    converged_at: float | None = None
    clock.begin()
    try:
        supervisor.restore()
        while ticks_run < scenario.max_ticks:
            while torn_at and torn_at[0] <= clock.time():
                torn_at.pop(0)
                _tear_file(world.paths.fleet_status)
            try:
                supervisor.tick()
            except SupervisorKilled:
                restarts += 1
                supervisor = make_supervisor()
                supervisor.restore()
                continue
            ticks_run += 1
            doc = supervisor.status_doc(clock.time())
            settled = (clock.time() >= last_fault
                       and doc["verdict"] == "healthy" and not world.down)
            healthy_streak = healthy_streak + 1 if settled else 0
            if healthy_streak >= 2:
                converged_at = clock.time()
                break
            clock.sleep(policy.interval)
    finally:
        clock.release()

    records = ledger.replay()
    checker = InvariantChecker(config, policy,
                               mttr_bound_s=scenario.mttr_bound_s)
    violations = checker.check(records)
    first_fault = min(scenario.fault_times, default=0.0)
    mttr = (converged_at - first_fault) if converged_at is not None else None
    if converged_at is None:
        violations.append(
            f"convergence: fleet not healthy within {scenario.max_ticks} "
            f"ticks (seed {scenario.seed})"
        )
    elif mttr is not None and mttr > scenario.mttr_bound_s:
        violations.append(
            f"convergence: MTTR {mttr:.0f}s exceeds the "
            f"{scenario.mttr_bound_s:.0f}s bound (seed {scenario.seed})"
        )
    status_parses = True
    try:
        json.loads(world.paths.fleet_status.read_text())
    except (OSError, ValueError):
        status_parses = False
        violations.append("torn-status: final fleet-status.json does not "
                          "parse (atomic publish broken)")
    kinds = [r["kind"] for r in records]
    return {
        "seed": scenario.seed,
        "events": [e["kind"] for e in scenario.events],
        "ticks": ticks_run,
        "restarts": restarts,
        "violations": violations,
        "converged": converged_at is not None,
        "mttr_s": mttr,
        "status_parses": status_parses,
        "heals_attempted": kinds.count(events_mod.HEAL_START),
        "heals_done": kinds.count(events_mod.HEAL_DONE),
        "domain_outages": kinds.count(events_mod.DOMAIN_OUTAGE),
        "heals_deferred": kinds.count(events_mod.HEAL_DEFERRED),
        "canaries": sum(1 for r in records
                        if r["kind"] == events_mod.HEAL_START
                        and r.get("canary")),
    }


# --------------------------------------------------------------- invariants


class InvariantChecker:
    """Fold a campaign's event ledger and assert the supervisor's safety
    contract. Each violated property yields one human-readable string
    naming what broke and where; an empty list is the pass verdict.

    The checks deliberately work on the RAW record stream (not the
    LedgerView): the ledger is the supervisor's flight recorder, and the
    invariants are statements about the recorded history itself —
    a fold that summarises away an illegal transition must not be able
    to hide it."""

    def __init__(self, config: ClusterConfig,
                 policy: sup_mod.SupervisePolicy,
                 mttr_bound_s: float = 2400.0) -> None:
        self.config = config
        self.policy = policy
        self.mttr_bound_s = mttr_bound_s
        self._domains = config.domain_map()

    def check(self, records: list) -> list:
        violations: list = []
        violations += self.check_no_double_heal(records)
        violations += self.check_token_conservation(records)
        violations += self.check_breaker_transitions(records)
        violations += self.check_domain_canary_gate(records)
        return violations

    # -- 1: no double-heal ------------------------------------------------

    def check_no_double_heal(self, records: list) -> list:
        """No slice may have two CONCURRENT heals (a second heal-start
        while an earlier one for the same slice later completes), and a
        heal-done slice is never healed again without fresh unhealthy
        evidence (a non-healthy verdict) in between. An orphaned start
        (kill mid-heal, no done/failed ever) followed by a re-heal is
        the documented recovery path, not a violation."""
        violations: list = []
        closed_at: dict = {}  # heal id -> index of its done/failed
        for idx, r in enumerate(records):
            if r.get("kind") in (events_mod.HEAL_DONE,
                                 events_mod.HEAL_FAILED):
                rid = r.get("id")
                if rid in closed_at:
                    violations.append(
                        f"double-heal: heal {rid!r} closed twice "
                        f"(records {closed_at[rid]} and {idx})"
                    )
                closed_at[r.get("id")] = idx
        open_heals: dict = {}  # slice -> (start idx, heal id)
        needs_evidence: dict = {}  # slice -> heal id that healed it
        for idx, r in enumerate(records):
            kind = r.get("kind")
            if kind == events_mod.VERDICT:
                state = r.get("state")
                if state not in (heal_mod.HEALTHY, heal_mod.DRAINING):
                    needs_evidence.pop(r.get("slice"), None)
            elif kind == events_mod.HEAL_START:
                for i in r.get("slices", []):
                    prior = open_heals.get(i)
                    if prior is not None and closed_at.get(prior[1],
                                                           -1) > idx:
                        violations.append(
                            f"double-heal: slice {i} heal {r.get('id')!r} "
                            f"started while heal {prior[1]!r} was in "
                            f"flight (records {prior[0]} and {idx})"
                        )
                    if i in needs_evidence:
                        violations.append(
                            f"double-heal: slice {i} healed again "
                            f"(record {idx}) without a fresh unhealthy "
                            f"verdict after heal "
                            f"{needs_evidence[i]!r} succeeded"
                        )
                    open_heals[i] = (idx, r.get("id"))
            elif kind in (events_mod.HEAL_DONE, events_mod.HEAL_FAILED):
                for i in r.get("slices", []):
                    prior = open_heals.get(i)
                    if prior is not None and prior[1] == r.get("id"):
                        open_heals.pop(i, None)
                    if kind == events_mod.HEAL_DONE:
                        needs_evidence[i] = r.get("id")
        return violations

    # -- 2: token conservation -------------------------------------------

    def check_token_conservation(self, records: list) -> list:
        """Replay every heal-start through a fresh per-slice TokenBucket
        at its recorded timestamp: the rate limit must hold over the
        ENTIRE ledger — kills, restarts, and compactions included. A
        start the bucket refuses means a crash minted an extra heal."""
        violations: list = []
        buckets: dict = {}
        for idx, r in enumerate(records):
            if r.get("kind") != events_mod.HEAL_START:
                continue
            for i in r.get("slices", []):
                bucket = buckets.setdefault(i, sup_mod.TokenBucket(
                    self.policy.heal_burst, self.policy.heal_refill_s
                ))
                if not bucket.try_take(r.get("ts", 0.0)):
                    violations.append(
                        f"token-conservation: slice {i} heal at "
                        f"t={r.get('ts')} (record {idx}) exceeds the "
                        f"burst-{self.policy.heal_burst}/"
                        f"{self.policy.heal_refill_s:.0f}s budget"
                    )
        return violations

    # -- 3: legal breaker transitions ------------------------------------

    _LEGAL = {
        ("closed", "open"), ("open", "half-open"), ("open", "closed"),
        ("half-open", "open"), ("half-open", "closed"),
        # re-recording open while open happens when a storm keeps
        # tripping during a hold wave — same state, legal
        ("open", "open"),
        # half-open re-announced: the probe/canary was rate-limited (or
        # the supervisor restarted mid-canary and re-armed the gate) and
        # the next tick re-enters the half-open dispatch — same state
        ("half-open", "half-open"),
    }

    def _transition_stream(self, records: list, domain: str | None):
        for idx, r in enumerate(records):
            kind = r.get("kind")
            if domain is None:
                state = {events_mod.BREAKER_OPEN: "open",
                         events_mod.BREAKER_HALF_OPEN: "half-open",
                         events_mod.BREAKER_CLOSE: "closed"}.get(kind)
            else:
                if r.get("domain") != domain:
                    continue
                state = {events_mod.DOMAIN_BREAKER_OPEN: "open",
                         events_mod.DOMAIN_BREAKER_HALF_OPEN: "half-open",
                         events_mod.DOMAIN_BREAKER_CLOSE: "closed"}.get(
                             kind)
            if state is not None:
                yield idx, state

    def check_breaker_transitions(self, records: list) -> list:
        """Breaker state machines (global AND per-domain) may only move
        closed->open, open->half-open, open/half-open->closed or back to
        open. Closing a never-opened breaker or half-opening a closed
        one is a corrupt history."""
        violations: list = []
        streams = [(None, "global breaker")]
        streams += [(d, f"domain {d} breaker") for d in sorted(
            {r.get("domain") for r in records if r.get("domain")}
        )]
        for domain, label in streams:
            state = "closed"
            for idx, nxt in self._transition_stream(records, domain):
                if (state, nxt) not in self._LEGAL:
                    violations.append(
                        f"breaker-transition: {label} moved "
                        f"{state} -> {nxt} at record {idx}"
                    )
                state = nxt
        return violations

    # -- 4: canary gates re-entry ----------------------------------------

    def check_domain_canary_gate(self, records: list) -> list:
        """After a DOMAIN_OUTAGE classification, no heal may be
        dispatched into that domain until a single canary heal
        (HEAL_START canary=true) has SUCCEEDED — and at most one canary
        may be in flight per domain."""
        violations: list = []
        closed_at: dict = {}  # heal id -> record index of done/failed
        for idx, r in enumerate(records):
            if r.get("kind") in (events_mod.HEAL_DONE,
                                 events_mod.HEAL_FAILED):
                closed_at[r.get("id")] = idx
        gated: dict = {}  # domain -> open canary heal id or None
        for idx, r in enumerate(records):
            kind = r.get("kind")
            if kind == events_mod.DOMAIN_OUTAGE:
                gated.setdefault(r.get("domain", ""), None)
            elif kind in (events_mod.DOMAIN_BREAKER_CLOSE,
                          events_mod.DOMAIN_RECOVERED):
                gated.pop(r.get("domain", ""), None)
            elif kind == events_mod.HEAL_START:
                touched = {self._domains.get(int(i), "")
                           for i in r.get("slices", [])}
                for domain in touched:
                    if domain not in gated:
                        continue
                    if not r.get("canary"):
                        violations.append(
                            f"canary-gate: non-canary heal "
                            f"{r.get('id')!r} (record {idx}) dispatched "
                            f"into outage-classified domain {domain} "
                            "before its canary succeeded"
                        )
                    elif (gated[domain] is not None
                          and closed_at.get(gated[domain], -1) > idx):
                        # the prior canary later completes, so it WAS in
                        # flight here — two concurrent canaries. A prior
                        # canary that never closes is a kill orphan and
                        # this start is its legitimate recovery.
                        violations.append(
                            f"canary-gate: second canary "
                            f"{r.get('id')!r} (record {idx}) for domain "
                            f"{domain} while canary "
                            f"{gated[domain]!r} was in flight"
                        )
                    else:
                        gated[domain] = r.get("id")
            elif kind == events_mod.HEAL_FAILED:
                for domain in list(gated):
                    if gated[domain] == r.get("id"):
                        gated[domain] = None  # canary failed: gate re-arms
        return violations


# ----------------------------------------------- request-plane (serving)


@dataclasses.dataclass
class ServeScenario:
    """One seeded composition of traffic + faults spanning BOTH planes:
    the supervisor's world (preemptions, quota storms, flapping SSH,
    torn status copies) and the gateway's own process (SIGKILL
    mid-dispatch, modeled as dropping the in-memory Gateway and
    resuming a fresh one from the request journal)."""

    seed: int
    num_slices: int
    failure_domains: int
    duration_s: float
    base_rps: float
    deadline_s: float
    events: list
    drain_grace_s: float = 1800.0

    @property
    def fault_times(self) -> list:
        return sorted(e.get("at", 0.0) for e in self.events)


SERVE_PRIMITIVES = ("slice-outage", "preemption-storm", "quota-storm",
                    "flapping-ssh", "torn-status", "gateway-kill")


def generate_serve_scenario(
    seed: int,
    num_slices: int = 4,
    failure_domains: int = 2,
    interval: float = 30.0,
) -> ServeScenario:
    """Deterministic serve scenario from `seed`: open-loop traffic with
    per-request deadlines and idempotency keys, one anchor fault (a
    slice outage the supervisor must heal while the gateway routes
    around it), and up to two extra primitives, the gateway SIGKILL
    among them. Every scenario is
    heal-able, so 'every accepted request reaches exactly one terminal
    state' is always the expected verdict."""
    rng = random.Random(int(seed))
    events: list = []
    anchor_at = 60.0 + interval * rng.randrange(0, 4)
    count = 1 + (1 if num_slices >= 4 and rng.random() < 0.3 else 0)
    events.append({
        "kind": "slice-outage",
        "slices": sorted(rng.sample(range(num_slices), count)),
        "at": anchor_at,
    })
    used = {"gateway-kill": False, "torn-status": False,
            "flapping-ssh": False}
    for _ in range(rng.randrange(0, 3)):
        kind = rng.choice(SERVE_PRIMITIVES[2:])
        at = anchor_at + interval * rng.randrange(0, 5)
        if kind == "quota-storm":
            events.append({"kind": kind, "at": at,
                           "duration": 60.0 + 60.0 * rng.randrange(0, 3)})
        elif kind == "flapping-ssh" and not used["flapping-ssh"]:
            used["flapping-ssh"] = True
            events.append({
                "kind": kind, "slice": rng.randrange(num_slices),
                "at": at, "duration": 4 * interval,
                "period": 2 * interval,
            })
        elif kind == "torn-status" and not used["torn-status"]:
            used["torn-status"] = True
            events.append({"kind": kind, "at": at})
        elif kind == "gateway-kill" and not used["gateway-kill"]:
            used["gateway-kill"] = True
            events.append({"kind": kind, "at": at + 7.0})
    return ServeScenario(
        seed=int(seed), num_slices=num_slices,
        failure_domains=failure_domains,
        duration_s=240.0 + 60.0 * rng.randrange(0, 3),
        base_rps=1.0 + 0.5 * rng.randrange(0, 3),
        deadline_s=90.0 + 30.0 * rng.randrange(0, 3),
        events=events,
    )


def run_serve_campaign(
    scenario: ServeScenario,
    workdir: Path,
    policy: "sup_mod.SupervisePolicy | None" = None,
    gw_policy=None,
    heal_seconds: float = 120.0,
) -> dict:
    """Drive one seeded request-plane campaign: a REAL Supervisor and a
    REAL Gateway as co-actors on ONE SimClock (the elastic drill's
    shape). The supervisor reconciles the scripted world and publishes
    fleet-status.json; the gateway serves the seeded open-loop arrival
    stream through that file, journaling every request transition.
    Scheduled gateway kills drop the in-memory gateway and resume a
    fresh one from the journal. Afterwards the ServeInvariantChecker
    folds BOTH ledgers; the campaign verdict carries its violations."""
    from tritonk8ssupervisor_tpu_torch import obs as obs_lib
    from tritonk8ssupervisor_tpu_torch.provision.fleetview import FileHealthSource
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod
    from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod
    from tritonk8ssupervisor_tpu_torch.serving import traffic as traffic_mod

    policy = policy or default_policy()
    interval = policy.interval
    clock = SimClock(stall_timeout=60.0)
    config = sim_config(scenario.num_slices, scenario.failure_domains)
    world = ChaosFleet(Path(workdir), clock, config,
                       heal_seconds=heal_seconds)
    torn_at: list = []
    kill_at: list = []
    for event in scenario.events:
        kind = event["kind"]
        if kind == "slice-outage":
            for i in event["slices"]:
                world.preempt(i, at=event["at"])
        elif kind == "preemption-storm":
            for i in event["slices"]:
                world.preempt(i, at=event["at"])
        elif kind == "quota-storm":
            world.quota_storm(event["at"], event["at"] + event["duration"])
        elif kind == "flapping-ssh":
            world.flap_ssh(event["slice"], event["at"],
                           event["at"] + event["duration"],
                           event["period"])
        elif kind == "torn-status":
            torn_at.append(float(event["at"]))
        elif kind == "gateway-kill":
            kill_at.append(float(event["at"]))
    torn_at.sort()
    kill_at.sort()

    ledger = events_mod.EventLedger(world.paths.events, clock=clock.time,
                                    echo=lambda line: None, fsync=False)
    # fsync=False is honest here: the campaign's "SIGKILL" drops
    # in-memory objects, which OS-buffered writes survive by
    # construction; the REAL fsync path is pinned by the reqlog unit
    # tests and the `./setup.sh serve` wiring
    reqlog = reqlog_mod.RequestLog(world.paths.request_log,
                                   clock=clock.time,
                                   echo=lambda line: None, fsync=False)
    # ONE telemetry plane for the whole campaign, shared across gateway
    # incarnations exactly like the reqlog (the in-process "SIGKILL"
    # drops the gateway object, not the process): spans from both
    # gateway lives land in one span log tagged by incarnation, and the
    # registry's counters stay comparable to the journal's fold — the
    # metrics-vs-ledger invariant the checker asserts at the end. The
    # supervisor co-actor SHARES the registry and span log (metric
    # names are disjoint; spans carry plane=supervisor).
    span_log = obs_lib.SpanLog(world.paths.span_log, clock=clock.time,
                               echo=lambda line: None, fsync=False)
    registry = obs_lib.MetricsRegistry(clock=clock.time)
    telemetry = obs_lib.Telemetry(
        registry,
        obs_lib.Tracer(span_log, plane=obs_lib.SERVING,
                       clock=clock.time, incarnation=1),
        snapshot_path=world.paths.metrics_snapshot,
    )
    sup_telemetry = obs_lib.Telemetry(
        registry,
        obs_lib.Tracer(span_log, plane=obs_lib.SUPERVISOR,
                       clock=clock.time),
    )
    gw_policy = gw_policy or gw_mod.GatewayPolicy(
        max_seq_len=512, slots_per_slice=4, prefill_chunk=64,
        queue_budget=32, bucket_bounds=(64, 128, 256),
        poll_every_s=2.0, default_deadline_s=scenario.deadline_s,
    )
    cost = gw_mod.DecodeCostModel()

    stop = threading.Event()
    clock.launch()

    def sup_body() -> None:
        clock.begin()
        try:
            supervisor = sup_mod.Supervisor(
                config, world.paths, _Quiet(),
                run=world.run, run_quiet=world.run_quiet, policy=policy,
                ledger=ledger, clock=clock.time, sleep=clock.sleep,
                rng=lambda: 0.0, readiness_timeout=60.0, hooks=clock,
                telemetry=sup_telemetry,
            )
            supervisor.restore()
            while not stop.is_set():
                supervisor.tick()
                if stop.is_set():
                    break
                clock.sleep(interval)
        finally:
            clock.release()

    thread = threading.Thread(target=sup_body, daemon=True)

    def make_gateway() -> "gw_mod.Gateway":
        engines = {
            i: gw_mod.ModeledEngine(slots=gw_policy.slots_per_slice,
                                    prefill_chunk=gw_policy.prefill_chunk,
                                    cost=cost)
            for i in range(scenario.num_slices)
        }
        return gw_mod.Gateway(
            engines, FileHealthSource(world.paths.fleet_status),
            policy=gw_policy, clock=clock.time, reqlog=reqlog,
            telemetry=telemetry,
        )

    model = traffic_mod.TrafficModel(
        base_rps=scenario.base_rps, diurnal_amplitude=0.2,
        diurnal_period_s=600.0, seed=scenario.seed,
        deadline_s=scenario.deadline_s,
        key_prefix=f"c{scenario.seed}",
    )
    arrivals = traffic_mod.generate_arrivals(model, scenario.duration_s)
    hard_stop = scenario.duration_s + scenario.drain_grace_s

    thread.start()
    gateway = make_gateway()
    gateway.recover(0.0)
    kills = 0
    redone = 0
    i_arr = 0
    next_step: dict = {i: None for i in gateway.workers}
    quiet = False
    clock.launch()
    clock.begin()
    try:
        while True:
            now = clock.time()
            while torn_at and torn_at[0] <= now:
                torn_at.pop(0)
                _tear_file(world.paths.fleet_status)
            if kill_at and kill_at[0] <= now:
                # SIGKILL mid-dispatch: every queued and in-flight
                # request in MEMORY is gone; the journal is not
                kill_at.pop(0)
                kills += 1
                telemetry.bump_incarnation()
                gateway = make_gateway()
                recovered = gateway.recover(now)
                redone += recovered["redone"]
                next_step = {i: None for i in gateway.workers}
            gateway.poll(now)
            gateway.expire_queued(now)
            # engine liveness follows the world: a preempted slice's
            # engine dies with it, a healed slice's engine comes back
            down = world.down_now()
            for i, worker in gateway.workers.items():
                if i in down and worker.alive:
                    worker.fail()
                    next_step[i] = None
                elif i not in down and not worker.alive:
                    worker.revive()
                    next_step[i] = now
            while i_arr < len(arrivals) and arrivals[i_arr].arrival <= now:
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
                            and gateway.slice_mode(i) == gw_mod.SERVE))):
                    next_step[i] = now
            quiet = (i_arr >= len(arrivals) and not kill_at
                     and gateway.queue_depth() == 0
                     and all(w.idle()
                             for w in gateway.workers.values()))
            if quiet or now >= hard_stop:
                break
            candidates = [t for t in next_step.values() if t is not None]
            if i_arr < len(arrivals):
                candidates.append(arrivals[i_arr].arrival)
            if kill_at:
                candidates.append(kill_at[0])
            if torn_at:
                candidates.append(torn_at[0])
            # watchdog boundary: even a fully-idle gateway keeps
            # polling, so a post-heal generation bump still requeues
            # stranded work and deadline sweeps keep their timing
            candidates.append(now + 2.0 * gw_policy.poll_every_s)
            t_next = min(candidates)
            if t_next > now:
                clock.sleep(t_next - now)
    finally:
        stop.set()
        clock.release()
    thread.join(timeout=120)

    req_records = reqlog.replay()
    led_records = ledger.replay()
    # final telemetry publish: gauges refreshed from the surviving
    # gateway, then the registry snapshot the metrics-vs-ledger
    # invariants are asserted against (and metrics.json on disk)
    gateway.update_gauges()
    metrics_snapshot = telemetry.write_snapshot() or registry.snapshot()
    # the worst HONEST view age: a tick that waits out up to two heal
    # waves cannot publish mid-wait, plus flap-confirm ticks either
    # side — the gateway keeps routing on its last good view throughout
    checker = ServeInvariantChecker(
        gw_policy, interval_s=interval,
        staleness_bound_s=2.0 * heal_seconds + 4.0 * interval
        + gw_policy.poll_every_s,
    )
    violations = checker.check(req_records, led_records,
                               metrics=metrics_snapshot)
    if not quiet:
        violations.append(
            f"convergence: request plane not quiescent by "
            f"t={hard_stop:.0f}s (seed {scenario.seed})"
        )
    view = reqlog_mod.fold(req_records)
    accepted = sum(1 for kv in view.keys.values() if kv.accepts > 0)
    return {
        "seed": scenario.seed,
        "events": [e["kind"] for e in scenario.events],
        "offered": len(arrivals),
        "accepted": accepted,
        "completed": sum(kv.completions for kv in view.keys.values()),
        "expired": sum(kv.expiries for kv in view.keys.values()),
        "requeues": sum(kv.requeues for kv in view.keys.values()),
        "sheds": view.sheds,
        "shed_reasons": dict(sorted(view.shed_reasons.items())),
        "gateway_kills": kills,
        "redone_after_kill": redone,
        "spans": len(span_log.spans()),
        "violations": violations,
        "converged": quiet,
        "end_s": clock.time(),
    }


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


# ------------------------------------------------- autoscale (elasticity)


def default_autoscale_policy(num_slices: int = 4):
    """The campaign autoscale policy: thresholds sized to the modeled
    engine's capacity (one 4-slot slice serves ~2-3 rps of the traffic
    mix), confirmation windows short enough to exercise inside a
    bounded sim, drains short enough to finish inside one."""
    from tritonk8ssupervisor_tpu_torch.provision import autoscale as as_mod

    return as_mod.AutoscalePolicy(
        min_slices=1, max_slices=num_slices,
        up_queue_per_slice=6.0, down_queue_per_slice=2.0,
        slo_p99_s=60.0, down_p99_margin=0.5,
        confirm_up=2, confirm_down=3,
        cooldown_s=60.0, cooldown_cap_s=600.0,
        drain_timeout_s=120.0, signal_max_age_s=75.0,
        breaker_threshold=3, breaker_window_s=3600.0,
    )


def _active_slice_seconds(ledger_records: list, initial: int,
                          end_s: float) -> float:
    """Integrate the active slice count over the run — the cost side of
    cost-per-served-token. Capacity being PROVISIONED bills from its
    SCALE_START (the machines exist the moment the apply runs);
    capacity draining bills until its SCALE_DONE tears it down."""
    total = 0.0
    t_prev = 0.0
    active = float(initial)
    for r in ledger_records:
        kind = r.get("kind")
        delta = 0.0
        if kind == events_mod.SCALE_START and r.get("direction") == "up":
            delta = float(len(r.get("slices", [])))
        elif (kind == events_mod.SCALE_ABORT
              and r.get("direction") == "up"):
            delta = -float(len(r.get("slices", [])))
        elif (kind == events_mod.SCALE_DONE
              and r.get("direction") == "down"):
            delta = -float(len(r.get("slices", [])))
        if delta == 0.0:
            continue
        ts = min(float(r.get("ts", 0.0)), end_s)
        total += active * max(0.0, ts - t_prev)
        t_prev = ts
        active += delta
    total += active * max(0.0, end_s - t_prev)
    return total


def _scale_summary(ledger_records: list) -> dict:
    kinds = [r.get("kind") for r in ledger_records]
    up_done = [r for r in ledger_records
               if r.get("kind") == events_mod.SCALE_DONE
               and r.get("direction") == "up"]
    down_done = [r for r in ledger_records
                 if r.get("kind") == events_mod.SCALE_DONE
                 and r.get("direction") == "down"]
    return {
        "decisions": kinds.count(events_mod.SCALE_DECISION),
        "started": kinds.count(events_mod.SCALE_START),
        "done_up": len(up_done),
        "done_down": len(down_done),
        "aborted": kinds.count(events_mod.SCALE_ABORT),
        "held": kinds.count(events_mod.SCALE_HELD),
        "breaker_opens": kinds.count(events_mod.SCALE_BREAKER_OPEN),
        "stragglers_requeued": sum(
            int(r.get("stragglers") or 0) for r in down_done
        ),
    }


def run_autoscale_drive(
    workdir: Path,
    num_slices: int = 4,
    duration_s: float = 1500.0,
    base_rps: float = 5.0,
    diurnal_amplitude: float = 0.55,
    diurnal_period_s: float = 900.0,
    bursts: tuple = (),
    deadline_s: float = 120.0,
    seed: int = 11,
    autoscale_policy=None,
    policy: "sup_mod.SupervisePolicy | None" = None,
    gw_policy=None,
    heal_seconds: float = 30.0,
    teardown_seconds: float = 10.0,
    preempt: tuple = (),  # ((slice, at), ...) world faults
    torn_status_at: tuple = (),
    torn_demand_at: tuple = (),
    gateway_kill_at: tuple = (),
    kill_gateway_on_drain: bool = False,
    fail_applies: int = 0,
    supervisor_kill_on: str | None = None,  # "apply" / "destroy"
    drain_grace_s: float = 1800.0,
) -> dict:
    """Drive the CLOSED gateway→supervisor loop on one SimClock: a REAL
    Supervisor (with the second controller when `autoscale_policy` is
    set — `None` is the static-fleet baseline arm) reconciles and
    scales the scripted world, while a REAL Gateway serves the seeded
    diurnal(+burst) open-loop stream and publishes demand-signal.json.
    Faults compose: slice preemptions, torn status/demand copies,
    gateway SIGKILLs (absolute times, or triggered the moment a
    scale-down drain is observed), provisioning failures mid-scale-up,
    and a supervisor SIGKILL on its own scale order. Afterwards the
    ServeInvariantChecker folds BOTH ledgers with the scale invariants
    armed; the result carries cost (active-slice-seconds per served
    token) and the scale-up MTTR under the first burst."""
    from tritonk8ssupervisor_tpu_torch import obs as obs_lib
    from tritonk8ssupervisor_tpu_torch.provision import autoscale as as_mod
    from tritonk8ssupervisor_tpu_torch.provision.fleetview import FileHealthSource
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod
    from tritonk8ssupervisor_tpu_torch.serving import traffic as traffic_mod

    policy = policy or default_policy()
    interval = policy.interval
    clock = SimClock(stall_timeout=60.0)
    config = sim_config(num_slices, failure_domains=0)
    world = ChaosFleet(Path(workdir), clock, config,
                       heal_seconds=heal_seconds,
                       teardown_seconds=teardown_seconds)
    world.apply_failures_remaining = max(0, int(fail_applies))
    for index, at in preempt:
        world.preempt(int(index), at=float(at))
    torn_at = sorted(float(t) for t in torn_status_at)
    torn_demand = sorted(float(t) for t in torn_demand_at)
    kill_at = sorted(float(t) for t in gateway_kill_at)

    run_fn = world.run
    if supervisor_kill_on:
        kill_plan = FaultPlan(
            [FaultRule(match=f"terraform {supervisor_kill_on}",
                       kill=True)],
            echo=lambda line: None,
        )
        run_fn = kill_plan.wrap(world.run)

    ledger = events_mod.EventLedger(world.paths.events, clock=clock.time,
                                    echo=lambda line: None, fsync=False)
    reqlog = reqlog_mod.RequestLog(world.paths.request_log,
                                   clock=clock.time,
                                   echo=lambda line: None, fsync=False)
    span_log = obs_lib.SpanLog(world.paths.span_log, clock=clock.time,
                               echo=lambda line: None, fsync=False)
    registry = obs_lib.MetricsRegistry(clock=clock.time)
    telemetry = obs_lib.Telemetry(
        registry,
        obs_lib.Tracer(span_log, plane=obs_lib.SERVING,
                       clock=clock.time, incarnation=1),
        snapshot_path=world.paths.metrics_snapshot,
    )
    sup_telemetry = obs_lib.Telemetry(
        registry,
        obs_lib.Tracer(span_log, plane=obs_lib.SUPERVISOR,
                       clock=clock.time),
    )
    gw_policy = gw_policy or gw_mod.GatewayPolicy(
        max_seq_len=512, slots_per_slice=4, prefill_chunk=64,
        queue_budget=48, bucket_bounds=(64, 128, 256),
        poll_every_s=2.0, default_deadline_s=deadline_s,
        demand_signal_every_s=5.0,
        # the raw record stream IS the evidence the invariant checkers
        # fold — a long drive must not hit the long-running-server
        # retention caps, whose whole point is dropping old keys
        terminal_key_retention=0, journal_compact_records=0,
        audit_retention=0,
    )
    cost = gw_mod.DecodeCostModel()
    status_path = world.paths.fleet_status

    stop = threading.Event()
    sup_restarts = [0]
    clock.launch()

    def make_supervisor() -> "sup_mod.Supervisor":
        autoscaler = None
        if autoscale_policy is not None:
            autoscaler = as_mod.Autoscaler(autoscale_policy, num_slices)
        return sup_mod.Supervisor(
            config, world.paths, _Quiet(),
            run=run_fn, run_quiet=world.run_quiet, policy=policy,
            ledger=ledger, clock=clock.time, sleep=clock.sleep,
            rng=lambda: 0.0, readiness_timeout=60.0, hooks=clock,
            telemetry=sup_telemetry, autoscaler=autoscaler,
        )

    def sup_body() -> None:
        clock.begin()
        try:
            supervisor = make_supervisor()
            supervisor.restore()
            while not stop.is_set():
                try:
                    supervisor.tick()
                except SupervisorKilled:
                    # SIGKILL mid-scale: resume from the event ledger —
                    # the open SCALE_START must be finished, never
                    # restarted as a sibling (no double-provision)
                    sup_restarts[0] += 1
                    supervisor = make_supervisor()
                    supervisor.restore()
                    continue
                if stop.is_set():
                    break
                clock.sleep(interval)
        finally:
            clock.release()

    def make_gateway() -> "gw_mod.Gateway":
        engines = {
            i: gw_mod.ModeledEngine(slots=gw_policy.slots_per_slice,
                                    prefill_chunk=gw_policy.prefill_chunk,
                                    cost=cost)
            for i in range(num_slices)
        }
        return gw_mod.Gateway(
            engines, FileHealthSource(status_path),
            policy=gw_policy, clock=clock.time, reqlog=reqlog,
            telemetry=telemetry,
            demand_path=world.paths.demand_signal,
        )

    model = traffic_mod.TrafficModel(
        base_rps=base_rps, diurnal_amplitude=diurnal_amplitude,
        diurnal_period_s=diurnal_period_s, bursts=tuple(bursts),
        seed=seed, deadline_s=deadline_s, key_prefix=f"a{seed}",
    )
    arrivals = traffic_mod.generate_arrivals(model, duration_s)
    hard_stop = duration_s + drain_grace_s

    def autoscale_in_progress() -> dict | None:
        try:
            doc = json.loads(status_path.read_text())
        except (OSError, ValueError):
            return None
        block = doc.get("autoscale") if isinstance(doc, dict) else None
        return block.get("in_progress") if isinstance(block, dict) \
            else None

    thread = threading.Thread(target=sup_body, daemon=True)
    thread.start()
    gateway = make_gateway()
    gateway.recover(0.0)
    kills = 0
    redone = 0
    drain_kill_done = False
    drains_seen = 0
    draining_before = False
    last_status_read = -1e9
    i_arr = 0
    next_step: dict = {i: None for i in gateway.workers}
    quiet = False
    clock.launch()
    clock.begin()
    try:
        while True:
            now = clock.time()
            while torn_at and torn_at[0] <= now:
                torn_at.pop(0)
                _tear_file(status_path)
            while torn_demand and torn_demand[0] <= now:
                torn_demand.pop(0)
                _tear_file(world.paths.demand_signal)
            if (autoscale_policy is not None
                    and now - last_status_read >= gw_policy.poll_every_s):
                last_status_read = now
                in_progress = autoscale_in_progress()
                draining = (in_progress is not None
                            and in_progress.get("direction") == "down")
                if draining and not draining_before:
                    drains_seen += 1
                draining_before = draining
                if draining and kill_gateway_on_drain \
                        and not drain_kill_done:
                    # THE gateway-kill-mid-drain moment: every queued
                    # and in-flight request in memory is gone while the
                    # supervisor is mid-way through a drain; the
                    # journal resumes the work, the drain still settles
                    drain_kill_done = True
                    kill_at.insert(0, now)
            if kill_at and kill_at[0] <= now:
                kill_at.pop(0)
                kills += 1
                telemetry.bump_incarnation()
                gateway = make_gateway()
                recovered = gateway.recover(now)
                redone += recovered["redone"]
                next_step = {i: None for i in gateway.workers}
            gateway.poll(now)
            gateway.expire_queued(now)
            down = world.down_now()
            for i, worker in gateway.workers.items():
                if i in down and worker.alive:
                    worker.fail()
                    next_step[i] = None
                elif i not in down and not worker.alive:
                    worker.revive()
                    next_step[i] = now
            while i_arr < len(arrivals) and arrivals[i_arr].arrival <= now:
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
                            and gateway.slice_mode(i) == gw_mod.SERVE))):
                    next_step[i] = now
            quiet = (i_arr >= len(arrivals) and not kill_at
                     and gateway.queue_depth() == 0
                     and all(w.idle()
                             for w in gateway.workers.values()))
            if quiet and autoscale_policy is not None:
                # let a scale already in flight finish (an abandoned
                # drain would read as an orphaned SCALE_START)
                quiet = autoscale_in_progress() is None
            if quiet or now >= hard_stop:
                break
            candidates = [t for t in next_step.values() if t is not None]
            if i_arr < len(arrivals):
                candidates.append(arrivals[i_arr].arrival)
            if kill_at:
                candidates.append(kill_at[0])
            if torn_at:
                candidates.append(torn_at[0])
            if torn_demand:
                candidates.append(torn_demand[0])
            candidates.append(now + 2.0 * gw_policy.poll_every_s)
            t_next = min(candidates)
            if t_next > now:
                clock.sleep(t_next - now)
    finally:
        stop.set()
        clock.release()
    thread.join(timeout=120)

    req_records = reqlog.replay()
    led_records = ledger.replay()
    end_s = clock.time()
    gateway.update_gauges()
    metrics_snapshot = telemetry.write_snapshot() or registry.snapshot()
    checker = ServeInvariantChecker(
        gw_policy, interval_s=interval,
        staleness_bound_s=2.0 * max(heal_seconds, teardown_seconds)
        + 4.0 * interval + gw_policy.poll_every_s,
        autoscale_policy=autoscale_policy,
    )
    violations = checker.check(req_records, led_records,
                               metrics=metrics_snapshot)
    if not quiet:
        violations.append(
            f"convergence: request plane not quiescent by "
            f"t={hard_stop:.0f}s (seed {seed})"
        )
    view = reqlog_mod.fold(req_records)
    latencies = sorted(
        r["latency_s"] for r in req_records
        if r.get("kind") == reqlog_mod.COMPLETED
        and r.get("latency_s") is not None
    )

    def pct(q: float):
        if not latencies:
            return None
        idx = min(len(latencies) - 1,
                  max(0, int(round(q * (len(latencies) - 1)))))
        return round(latencies[idx], 3)

    from tritonk8ssupervisor_tpu_torch.obs import metrics as metrics_mod

    tokens = int(metrics_mod.counter_total(
        metrics_snapshot, "serving_tokens_generated_total"))
    slice_seconds = _active_slice_seconds(led_records, num_slices, end_s)
    first_burst = min((b[0] for b in bursts), default=None)
    scale_up_mttr = None
    if first_burst is not None:
        ups = [r.get("ts", 0.0) for r in led_records
               if r.get("kind") == events_mod.SCALE_DONE
               and r.get("direction") == "up"
               and r.get("ts", 0.0) >= first_burst]
        if ups:
            scale_up_mttr = round(min(ups) - first_burst, 3)
    return {
        "seed": seed,
        "autoscale": autoscale_policy is not None,
        "num_slices": num_slices,
        "duration_s": duration_s,
        "end_s": round(end_s, 3),
        "offered": len(arrivals),
        "accepted": sum(1 for kv in view.keys.values()
                        if kv.accepts > 0),
        "completed": sum(kv.completions for kv in view.keys.values()),
        "expired": sum(kv.expiries for kv in view.keys.values()),
        "requeues": sum(kv.requeues for kv in view.keys.values()),
        "sheds": view.sheds,
        "tokens": tokens,
        "p50_latency_s": pct(0.50),
        "p99_latency_s": pct(0.99),
        "slice_seconds": round(slice_seconds, 1),
        "slice_hours_per_1k_tokens": (
            round(slice_seconds / 3600.0 / (tokens / 1000.0), 6)
            if tokens else None
        ),
        "scale_up_mttr_s": scale_up_mttr,
        "scales": _scale_summary(led_records),
        "gateway_kills": kills,
        "redone_after_kill": redone,
        "supervisor_restarts": sup_restarts[0],
        "drains_observed": drains_seen,
        "violations": violations,
        "converged": quiet,
    }


@dataclasses.dataclass
class AutoscaleScenario:
    """One seeded composition of diurnal(+burst) traffic and the
    elasticity fault primitives. Every scenario is convergeable: bursts
    end, torn files are rewritten by the next publish, kills resume
    from the ledgers."""

    seed: int
    num_slices: int
    duration_s: float
    base_rps: float
    diurnal_amplitude: float
    diurnal_period_s: float
    bursts: tuple
    deadline_s: float
    events: list


AUTOSCALE_PRIMITIVES = (
    "burst", "gateway-kill-mid-drain", "slice-loss-mid-scale-up",
    "torn-demand", "torn-status", "slice-outage",
    "supervisor-kill-mid-scale",
)


def generate_autoscale_scenario(seed: int,
                                num_slices: int = 4) -> AutoscaleScenario:
    """Deterministic elasticity scenario from `seed`: a diurnal trace
    whose trough takes the fleet down and whose recovery (usually
    sharpened by a burst landing IN the trough) forces it back up,
    composed with up to two fault primitives — the gateway SIGKILL
    mid-drain and the provisioning failure mid-scale-up being the two
    the acceptance criteria name."""
    rng = random.Random(int(seed))
    period = 900.0
    duration = 1200.0 + 150.0 * rng.randrange(0, 3)
    base = 4.5 + 0.5 * rng.randrange(0, 3)
    amplitude = 0.5 + 0.05 * rng.randrange(0, 3)
    events: list = []
    bursts: list = []
    if rng.random() < 0.8:
        # the burst lands in the diurnal trough (sin < 0 after
        # period/2), where the fleet has scaled down — the honest
        # scale-up-MTTR shape, and the drain-abort trigger
        at = 0.55 * period + 30.0 * rng.randrange(0, 8)
        bursts.append((at, 120.0 + 60.0 * rng.randrange(0, 2),
                       2.5 + 0.5 * rng.randrange(0, 2)))
        events.append({"kind": "burst", "at": at})
    used: set = set()
    for _ in range(rng.randrange(0, 3)):
        kind = rng.choice(AUTOSCALE_PRIMITIVES[1:])
        if kind in used:
            continue
        used.add(kind)
        if kind == "gateway-kill-mid-drain":
            events.append({"kind": kind})
        elif kind == "slice-loss-mid-scale-up":
            events.append({"kind": kind, "fail_applies": 1})
        elif kind == "torn-demand":
            events.append({"kind": kind,
                           "at": 120.0 + 60.0 * rng.randrange(0, 8)})
        elif kind == "torn-status":
            events.append({"kind": kind,
                           "at": 120.0 + 60.0 * rng.randrange(0, 8)})
        elif kind == "slice-outage":
            events.append({"kind": kind,
                           "slice": rng.randrange(num_slices),
                           "at": 90.0 + 60.0 * rng.randrange(0, 5)})
        elif kind == "supervisor-kill-mid-scale":
            events.append({"kind": kind, "on": "destroy"})
    return AutoscaleScenario(
        seed=int(seed), num_slices=num_slices, duration_s=duration,
        base_rps=base, diurnal_amplitude=amplitude,
        diurnal_period_s=period, bursts=tuple(bursts),
        deadline_s=120.0, events=events,
    )


def run_autoscale_campaign(scenario: AutoscaleScenario,
                           workdir: Path) -> dict:
    """One seeded elasticity campaign: the scenario's traffic and
    faults through `run_autoscale_drive` with the default campaign
    policies. The verdict carries the checker's violations (scale
    invariants armed) plus the scale/kill bookkeeping."""
    kwargs: dict = dict(
        num_slices=scenario.num_slices,
        duration_s=scenario.duration_s,
        base_rps=scenario.base_rps,
        diurnal_amplitude=scenario.diurnal_amplitude,
        diurnal_period_s=scenario.diurnal_period_s,
        bursts=scenario.bursts,
        deadline_s=scenario.deadline_s,
        seed=scenario.seed,
        autoscale_policy=default_autoscale_policy(scenario.num_slices),
    )
    preempt: list = []
    torn_status: list = []
    torn_demand: list = []
    for event in scenario.events:
        kind = event["kind"]
        if kind == "gateway-kill-mid-drain":
            kwargs["kill_gateway_on_drain"] = True
        elif kind == "slice-loss-mid-scale-up":
            kwargs["fail_applies"] = event.get("fail_applies", 1)
        elif kind == "torn-demand":
            torn_demand.append(event["at"])
        elif kind == "torn-status":
            torn_status.append(event["at"])
        elif kind == "slice-outage":
            preempt.append((event["slice"], event["at"]))
        elif kind == "supervisor-kill-mid-scale":
            kwargs["supervisor_kill_on"] = event.get("on", "destroy")
    kwargs["preempt"] = tuple(preempt)
    kwargs["torn_status_at"] = tuple(torn_status)
    kwargs["torn_demand_at"] = tuple(torn_demand)
    out = run_autoscale_drive(Path(workdir), **kwargs)
    out["events"] = [e["kind"] for e in scenario.events]
    return out


# ------------------------------------------- co-scheduling (one fleet)


class KillOnKindLedger(events_mod.EventLedger):
    """An event ledger that SIGKILLs the supervisor right AFTER the Nth
    record of `kill_kind` lands — the record is durable, the process
    dies on the next instruction. This is how the campaigns kill a
    supervisor between PREEMPT_NOTICE and ROLE_CHANGED: a handover
    cannot be interrupted from the RunFn side (no terraform runs in a
    role flip), so the crash seam is the ledger append itself."""

    def __init__(self, *args, kill_kind: str | None = None,
                 kill_after: int = 1, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._kill_kind = kill_kind
        self._kill_remaining = max(0, int(kill_after))

    def append(self, kind: str, **fields) -> dict:
        record = super().append(kind, **fields)
        if kind == self._kill_kind and self._kill_remaining > 0:
            self._kill_remaining -= 1
            if self._kill_remaining == 0:
                raise SupervisorKilled(
                    f"scripted SIGKILL after {kind} record"
                )
        return record


class VirtualTrainer:
    """The elastic trainer's virtual-clock twin for the co-scheduling
    drives: it models parallel/elastic.py's loop over the slices the
    supervisor's `allocation.training` list assigns it. Steps accrue at
    `steps_per_slice_s` per owned slice; a periodic checkpoint every
    `checkpoint_every` steps bounds any loss; a drain notice touching
    its slices (membership.draining) triggers the ~0-cost checkpoint
    flush plus a job-ack `notified` (the PREEMPT_NOTICE handshake); a
    membership generation bump costs the steps since the last
    checkpoint (~0 when the drain notice was honored) plus `resume_s`
    of rejoin time, then training continues at the NEW world size.
    `ack=False` models a wedged trainer that never acknowledges — the
    supervisor's bounded wait must FORCE the preemption, and the last
    periodic checkpoint must bound the loss."""

    def __init__(self, status_path: Path, ack_path: Path, clock,
                 steps_per_slice_s: float = 0.5,
                 checkpoint_every: int = 60,
                 resume_s: float = 20.0,
                 poll_every_s: float = 5.0,
                 ack: bool = True) -> None:
        from tritonk8ssupervisor_tpu_torch.parallel.elastic import JobAck

        self.status_path = Path(status_path)
        self.clock = clock
        self.rate = float(steps_per_slice_s)
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.resume_s = float(resume_s)
        self.poll_every_s = max(0.5, float(poll_every_s))
        self.ack_enabled = bool(ack)
        self._ack = JobAck(ack_path, clock=clock.time)
        self.owned: list = []
        self.generation: int | None = None
        self._step = 0.0
        self._saved = 0.0
        self._busy_until = 0.0
        self._last = 0.0
        self._last_poll = float("-inf")
        self._flushed = False
        self.report: dict = {
            "steps": 0, "steps_lost": 0, "resumes": [],
            "drain_flushes": 0, "acks_written": 0,
        }

    def _read_status(self) -> dict | None:
        try:
            doc = json.loads(self.status_path.read_text())
        except (OSError, ValueError):
            return None  # absent or torn: unknown, retry
        return doc if isinstance(doc, dict) else None

    def _write_ack(self, phase: str, generation, reason: str = "") -> None:
        if not self.ack_enabled:
            return
        self._ack.write(phase, generation, int(self._step),
                        world=len(self.owned), slices=(),
                        reason=reason)
        self.report["acks_written"] += 1

    def next_wake(self, now: float) -> float:
        return max(now, self._last_poll + self.poll_every_s)

    def advance(self, now: float) -> None:
        """Accrue training progress up to `now` and poll the status
        file on the poll cadence. Called from the drive's main loop —
        the trainer is a co-actor on the same virtual clock."""
        if now > self._last:
            start = max(self._last, self._busy_until)
            if now > start and self.owned:
                self._step += self.rate * len(self.owned) * (now - start)
            self._last = now
        # periodic durability: the bound on any preemption's loss
        while self._step - self._saved >= self.checkpoint_every:
            self._saved += self.checkpoint_every
        if now - self._last_poll < self.poll_every_s:
            return
        self._last_poll = now
        doc = self._read_status()
        if doc is None:
            return
        membership = doc.get("membership") or {}
        alloc = doc.get("allocation") or {}
        gen = membership.get("generation")
        draining = set(membership.get("draining") or [])
        training = sorted(int(i) for i in alloc.get("training") or [])
        if self.generation is None:
            self.generation = gen
            self.owned = training
            return
        if draining & set(self.owned) and not self._flushed:
            # the drain-notice checkpoint window: flush NOW (costs ~0
            # steps), acknowledge, keep stepping until the world moves
            self._saved = self._step
            self._flushed = True
            self.report["drain_flushes"] += 1
            self._write_ack("notified", gen, reason="drain notice")
        if gen != self.generation:
            if self.ack_enabled:
                # a planned membership change: the real ElasticTrainer
                # flushes AT the boundary (state_intact=True), so the
                # loss is ~0; only a wedged trainer (ack=False) rolls
                # back to its last periodic checkpoint
                self._saved = self._step
            lost = int(self._step - self._saved)
            self.report["steps_lost"] += lost
            self.report["resumes"].append({
                "ts": round(now, 3), "steps_lost": lost,
                "world": len(training), "generation": gen,
            })
            self._step = self._saved
            self._busy_until = now + self.resume_s
            self.generation = gen
            self.owned = training
            self._flushed = False
            self._write_ack("resumed", gen)
        self.report["steps"] = int(self._step)

    def finish(self) -> dict:
        self.report["steps"] = int(self._step)
        return dict(self.report)


def default_alloc_policy(num_slices: int = 4):
    """The campaign allocation policy: thresholds sized to the modeled
    engine's capacity (like default_autoscale_policy), confirmation
    windows short enough to exercise inside a bounded sim, an ack
    timeout that a healthy trainer beats by one poll interval and a
    wedged one forces within the drive."""
    from tritonk8ssupervisor_tpu_torch.provision import allocator as alloc_mod

    return alloc_mod.AllocatorPolicy(
        min_serving=1, min_training=0,
        train_slices=max(1, num_slices // 2),
        up_queue_per_slice=6.0, slo_p99_s=60.0,
        idle_queue_per_slice=3.0, idle_p99_margin=0.5,
        confirm_to_serving=2, confirm_to_training=2,
        cooldown_s=45.0, cooldown_cap_s=600.0,
        ack_timeout_s=90.0, drain_timeout_s=120.0,
        idle_inflight_per_slice=3.0,
        signal_max_age_s=75.0,
    )


def _alloc_summary(ledger_records: list) -> dict:
    kinds = [r.get("kind") for r in ledger_records]
    to_serving = [r for r in ledger_records
                  if r.get("kind") == events_mod.ROLE_CHANGED
                  and r.get("role") == "serving"
                  and not r.get("initial") and not r.get("aborted")]
    to_training = [r for r in ledger_records
                   if r.get("kind") == events_mod.ROLE_CHANGED
                   and r.get("role") == "training"
                   and not r.get("initial")]
    return {
        "decisions": kinds.count(events_mod.ALLOC_DECISION),
        "notices": kinds.count(events_mod.PREEMPT_NOTICE),
        "acks": kinds.count(events_mod.PREEMPT_ACK),
        "forced": sum(1 for r in ledger_records
                      if r.get("kind") == events_mod.PREEMPT_ACK
                      and r.get("forced")),
        "preemptions": len(to_serving),
        "handbacks": len(to_training),
        "aborted": sum(1 for r in ledger_records
                       if r.get("kind") == events_mod.ROLE_CHANGED
                       and r.get("aborted")),
        "stragglers_requeued": sum(int(r.get("stragglers") or 0)
                                   for r in to_training),
    }


def _training_slice_seconds(ledger_records: list, end_s: float) -> float:
    """Integrate the TRAINING-role slice count over the run — the
    training side of the co-scheduling ledger. TRANSITIONING time
    bills to neither side (the handover is the overhead both pay)."""
    total = 0.0
    t_prev = 0.0
    roles: dict = {}
    for r in ledger_records:
        kind = r.get("kind")
        if kind not in (events_mod.PREEMPT_NOTICE,
                        events_mod.ROLE_CHANGED):
            continue
        ts = min(float(r.get("ts", 0.0)), end_s)
        training = sum(1 for v in roles.values() if v == "training")
        total += training * max(0.0, ts - t_prev)
        t_prev = ts
        if kind == events_mod.PREEMPT_NOTICE:
            for i in r.get("slices", []):
                roles[int(i)] = "transitioning"
        else:
            for i in r.get("slices", []):
                roles[int(i)] = r.get("role", "serving")
    training = sum(1 for v in roles.values() if v == "training")
    total += training * max(0.0, end_s - t_prev)
    return total


def run_coschedule_drive(
    workdir: Path,
    num_slices: int = 4,
    duration_s: float = 1500.0,
    base_rps: float = 3.0,
    diurnal_amplitude: float = 0.6,
    diurnal_period_s: float = 900.0,
    diurnal_phase: float = 0.0,
    bursts: tuple = (),
    deadline_s: float = 120.0,
    seed: int = 13,
    alloc_policy=None,
    policy: "sup_mod.SupervisePolicy | None" = None,
    gw_policy=None,
    trainer_rate: float = 0.5,
    checkpoint_every: int = 60,
    trainer_resume_s: float = 20.0,
    trainer_ack: bool = True,
    kill_on_notice: int = 0,  # SIGKILL the supervisor after the Nth
    # PREEMPT_NOTICE lands on the ledger (mid-handover crash)
    tenants: dict | None = None,  # tenant -> weight (arms gateway WFQ)
    flood: dict | None = None,  # {"tenant", "at", "duration",
    # "rps", "priority"}: a second open-loop stream from ONE tenant
    preempt: tuple = (),  # ((slice, at), ...) world faults
    torn_status_at: tuple = (),
    torn_demand_at: tuple = (),
    drain_grace_s: float = 1800.0,
) -> dict:
    """Drive ONE fleet under BOTH workloads on one SimClock: a REAL
    Supervisor (with the third controller when `alloc_policy` is set —
    `None` is the serving-only arm) reconciles the scripted world and
    executes the preemption protocol, a REAL Gateway serves the seeded
    diurnal(+burst) open-loop stream and publishes demand-signal.json,
    and a VirtualTrainer fills the TRAINING slices, answering drain
    notices with the ~0-cost checkpoint flush + job-ack. Faults
    compose: slice preemptions, torn status/demand copies, a
    supervisor SIGKILL right after a PREEMPT_NOTICE lands (the
    mid-handover crash), a trainer that never acks (bounded wait →
    forced preemption), and a tenant flood against the WFQ admission
    queue. Afterwards the ServeInvariantChecker folds BOTH ledgers
    with the allocation invariants armed; the result carries goodput,
    training steps, and the preemption MTTR under the first burst."""
    from tritonk8ssupervisor_tpu_torch import obs as obs_lib
    from tritonk8ssupervisor_tpu_torch.provision import allocator as alloc_mod
    from tritonk8ssupervisor_tpu_torch.provision.fleetview import FileHealthSource
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gw_mod
    from tritonk8ssupervisor_tpu_torch.serving import traffic as traffic_mod

    policy = policy or default_policy()
    interval = policy.interval
    clock = SimClock(stall_timeout=60.0)
    config = sim_config(num_slices, failure_domains=0)
    world = ChaosFleet(Path(workdir), clock, config, heal_seconds=30.0)
    for index, at in preempt:
        world.preempt(int(index), at=float(at))
    torn_at = sorted(float(t) for t in torn_status_at)
    torn_demand = sorted(float(t) for t in torn_demand_at)

    if kill_on_notice > 0:
        ledger: events_mod.EventLedger = KillOnKindLedger(
            world.paths.events, clock=clock.time,
            echo=lambda line: None, fsync=False,
            kill_kind=events_mod.PREEMPT_NOTICE,
            kill_after=int(kill_on_notice),
        )
    else:
        ledger = events_mod.EventLedger(world.paths.events,
                                        clock=clock.time,
                                        echo=lambda line: None,
                                        fsync=False)
    reqlog = reqlog_mod.RequestLog(world.paths.request_log,
                                   clock=clock.time,
                                   echo=lambda line: None, fsync=False)
    span_log = obs_lib.SpanLog(world.paths.span_log, clock=clock.time,
                               echo=lambda line: None, fsync=False)
    registry = obs_lib.MetricsRegistry(clock=clock.time)
    telemetry = obs_lib.Telemetry(
        registry,
        obs_lib.Tracer(span_log, plane=obs_lib.SERVING,
                       clock=clock.time, incarnation=1),
        snapshot_path=world.paths.metrics_snapshot,
    )
    sup_telemetry = obs_lib.Telemetry(
        registry,
        obs_lib.Tracer(span_log, plane=obs_lib.SUPERVISOR,
                       clock=clock.time),
    )
    gw_policy = gw_policy or gw_mod.GatewayPolicy(
        max_seq_len=512, slots_per_slice=4, prefill_chunk=64,
        queue_budget=48, bucket_bounds=(64, 128, 256),
        poll_every_s=2.0, default_deadline_s=deadline_s,
        demand_signal_every_s=5.0,
        tenant_weights=dict(tenants) if tenants else None,
        # raw record streams ARE the checker evidence: no retention caps
        terminal_key_retention=0, journal_compact_records=0,
        audit_retention=0,
    )
    cost = gw_mod.DecodeCostModel()
    status_path = world.paths.fleet_status

    stop = threading.Event()
    sup_restarts = [0]
    clock.launch()

    def make_supervisor() -> "sup_mod.Supervisor":
        from tritonk8ssupervisor_tpu_torch.provision import retry as retry_mod

        allocator = None
        if alloc_policy is not None:
            # rng pinned like the supervisor's: the drives must be a
            # pure function of (scenario, seed)
            allocator = alloc_mod.Allocator(
                alloc_policy, num_slices,
                cooldown=retry_mod.Cooldown(alloc_policy.cooldown_s,
                                            alloc_policy.cooldown_cap_s,
                                            rng=lambda: 0.0),
            )
        return sup_mod.Supervisor(
            config, world.paths, _Quiet(),
            run=world.run, run_quiet=world.run_quiet, policy=policy,
            ledger=ledger, clock=clock.time, sleep=clock.sleep,
            rng=lambda: 0.0, readiness_timeout=60.0, hooks=clock,
            telemetry=sup_telemetry, allocator=allocator,
        )

    def sup_body() -> None:
        clock.begin()
        try:
            supervisor = make_supervisor()
            supervisor.restore()
            while not stop.is_set():
                try:
                    supervisor.tick()
                except SupervisorKilled:
                    # SIGKILL between PREEMPT_NOTICE and ROLE_CHANGED:
                    # resume from the ledger — the open handover must
                    # be finished under its ORIGINAL id, never
                    # restarted as a sibling
                    sup_restarts[0] += 1
                    supervisor = make_supervisor()
                    supervisor.restore()
                    continue
                if stop.is_set():
                    break
                clock.sleep(interval)
        finally:
            clock.release()

    def make_gateway() -> "gw_mod.Gateway":
        engines = {
            i: gw_mod.ModeledEngine(slots=gw_policy.slots_per_slice,
                                    prefill_chunk=gw_policy.prefill_chunk,
                                    cost=cost)
            for i in range(num_slices)
        }
        return gw_mod.Gateway(
            engines, FileHealthSource(status_path),
            policy=gw_policy, clock=clock.time, reqlog=reqlog,
            telemetry=telemetry,
            demand_path=world.paths.demand_signal,
        )

    model = traffic_mod.TrafficModel(
        base_rps=base_rps, diurnal_amplitude=diurnal_amplitude,
        diurnal_period_s=diurnal_period_s, diurnal_phase=diurnal_phase,
        bursts=tuple(bursts),
        seed=seed, deadline_s=deadline_s, key_prefix=f"co{seed}",
        tenant=("base" if tenants else None),
    )
    arrivals = traffic_mod.generate_arrivals(model, duration_s)
    flood_window = None
    if flood is not None:
        flood_model = traffic_mod.TrafficModel(
            base_rps=float(flood.get("rps", 8.0)),
            diurnal_amplitude=0.0, seed=seed + 7919,
            deadline_s=deadline_s,
            key_prefix=f"fl{seed}",
            tenant=str(flood.get("tenant", "flood")),
            priority=int(flood.get("priority", 0)),
        )
        at = float(flood.get("at", duration_s / 3.0))
        dur = float(flood.get("duration", 180.0))
        extra = [r for r in traffic_mod.generate_arrivals(
            flood_model, dur, rid0=10_000_000)]
        for r in extra:
            r.arrival += at
        arrivals = sorted(arrivals + extra, key=lambda r: r.arrival)
        flood_window = (at, at + dur)
    hard_stop = duration_s + drain_grace_s

    trainer = None
    if alloc_policy is not None:
        trainer = VirtualTrainer(
            status_path, world.paths.job_ack, clock,
            steps_per_slice_s=trainer_rate,
            checkpoint_every=checkpoint_every,
            resume_s=trainer_resume_s, ack=trainer_ack,
        )

    def handover_in_progress() -> dict | None:
        try:
            doc = json.loads(status_path.read_text())
        except (OSError, ValueError):
            return None
        block = doc.get("allocation") if isinstance(doc, dict) else None
        return block.get("in_progress") if isinstance(block, dict) \
            else None

    thread = threading.Thread(target=sup_body, daemon=True)
    thread.start()
    gateway = make_gateway()
    gateway.recover(0.0)
    i_arr = 0
    next_step: dict = {i: None for i in gateway.workers}
    quiet = False
    clock.launch()
    clock.begin()
    try:
        while True:
            now = clock.time()
            while torn_at and torn_at[0] <= now:
                torn_at.pop(0)
                _tear_file(status_path)
            while torn_demand and torn_demand[0] <= now:
                torn_demand.pop(0)
                _tear_file(world.paths.demand_signal)
            if trainer is not None:
                trainer.advance(now)
            gateway.poll(now)
            gateway.expire_queued(now)
            down = world.down_now()
            for i, worker in gateway.workers.items():
                if i in down and worker.alive:
                    worker.fail()
                    next_step[i] = None
                elif i not in down and not worker.alive:
                    worker.revive()
                    next_step[i] = now
            while i_arr < len(arrivals) and arrivals[i_arr].arrival <= now:
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
                            and gateway.slice_mode(i) == gw_mod.SERVE))):
                    next_step[i] = now
            quiet = (i_arr >= len(arrivals)
                     and gateway.queue_depth() == 0
                     and all(w.idle()
                             for w in gateway.workers.values()))
            if quiet and alloc_policy is not None:
                # let a handover already in flight close — an abandoned
                # one would read as an orphaned PREEMPT_NOTICE
                quiet = handover_in_progress() is None
            if quiet or now >= hard_stop:
                break
            candidates = [t for t in next_step.values() if t is not None]
            if i_arr < len(arrivals):
                candidates.append(arrivals[i_arr].arrival)
            if torn_at:
                candidates.append(torn_at[0])
            if torn_demand:
                candidates.append(torn_demand[0])
            if trainer is not None:
                candidates.append(trainer.next_wake(now))
            candidates.append(now + 2.0 * gw_policy.poll_every_s)
            t_next = min(candidates)
            if t_next > now:
                clock.sleep(t_next - now)
    finally:
        stop.set()
        clock.release()
    thread.join(timeout=120)

    req_records = reqlog.replay()
    led_records = ledger.replay()
    end_s = clock.time()
    gateway.update_gauges()
    metrics_snapshot = telemetry.write_snapshot() or registry.snapshot()
    checker = ServeInvariantChecker(
        gw_policy, interval_s=interval,
        staleness_bound_s=2.0 * 30.0 + 4.0 * interval
        + gw_policy.poll_every_s,
        alloc_policy=alloc_policy,
        # propagation grace covers one full tick: a status copy torn
        # at the PREEMPT_NOTICE's own publish leaves the gateway on
        # its last-good (pre-notice) view until the NEXT tick rewrites
        # the file — keep-last-good is the reader contract, not a leak
        drain_grace_s=interval + 2.0 * gw_policy.poll_every_s + 1.0,
    )
    violations = checker.check(req_records, led_records,
                               metrics=metrics_snapshot)
    if not quiet:
        violations.append(
            f"convergence: request plane not quiescent by "
            f"t={hard_stop:.0f}s (seed {seed})"
        )
    trainer_report = trainer.finish() if trainer is not None else None
    if trainer_report is not None:
        # THE preemption-cost invariant: the drain-notice checkpoint
        # window (acked) or the periodic checkpoint (forced) bounds
        # every preemption to <= one checkpoint interval of steps
        for resume in trainer_report["resumes"]:
            if resume["steps_lost"] > checkpoint_every:
                violations.append(
                    f"preemption-cost: resume at t={resume['ts']} lost "
                    f"{resume['steps_lost']} steps > one checkpoint "
                    f"interval ({checkpoint_every})"
                )
    if flood_window is not None and tenants:
        violations += checker.check_tenant_fairness(
            req_records, tenants, flood["tenant"], flood_window)
    view = reqlog_mod.fold(req_records)
    latencies = sorted(
        r["latency_s"] for r in req_records
        if r.get("kind") == reqlog_mod.COMPLETED
        and r.get("latency_s") is not None
    )

    def pct(q: float):
        if not latencies:
            return None
        idx = min(len(latencies) - 1,
                  max(0, int(round(q * (len(latencies) - 1)))))
        return round(latencies[idx], 3)

    from tritonk8ssupervisor_tpu_torch.obs import metrics as metrics_mod

    tokens = int(metrics_mod.counter_total(
        metrics_snapshot, "serving_tokens_generated_total"))
    completed = sum(kv.completions for kv in view.keys.values())
    accepted = sum(1 for kv in view.keys.values() if kv.accepts > 0)
    first_burst = min((b[0] for b in bursts), default=None)
    preempt_mttr = None
    if first_burst is not None:
        reclaims = [r.get("ts", 0.0) for r in led_records
                    if r.get("kind") == events_mod.ROLE_CHANGED
                    and r.get("role") == "serving"
                    and not r.get("initial") and not r.get("aborted")
                    and r.get("ts", 0.0) >= first_burst]
        if reclaims:
            preempt_mttr = round(min(reclaims) - first_burst, 3)
    return {
        "seed": seed,
        "coscheduled": alloc_policy is not None,
        "num_slices": num_slices,
        "duration_s": duration_s,
        "end_s": round(end_s, 3),
        "offered": len(arrivals),
        "accepted": accepted,
        "completed": completed,
        "expired": sum(kv.expiries for kv in view.keys.values()),
        "requeues": sum(kv.requeues for kv in view.keys.values()),
        "sheds": view.sheds,
        "tokens": tokens,
        "goodput": (round(completed / len(arrivals), 4)
                    if arrivals else None),
        "p50_latency_s": pct(0.50),
        "p99_latency_s": pct(0.99),
        "training": trainer_report,
        "training_slice_seconds": round(
            _training_slice_seconds(led_records, end_s), 1),
        "preempt_mttr_s": preempt_mttr,
        "handovers": _alloc_summary(led_records),
        "supervisor_restarts": sup_restarts[0],
        "violations": violations,
        "converged": quiet,
    }


@dataclasses.dataclass
class CoscheduleScenario:
    """One seeded composition of diurnal(+burst) traffic, a training
    job filling the troughs, and the co-scheduling fault primitives.
    Every scenario is convergeable: bursts end, torn files are
    rewritten by the next publish, kills resume from the ledgers, a
    wedged trainer is forced past the bounded wait."""

    seed: int
    num_slices: int
    duration_s: float
    base_rps: float
    diurnal_amplitude: float
    diurnal_period_s: float
    bursts: tuple
    deadline_s: float
    events: list


COSCHEDULE_PRIMITIVES = (
    "surge-during-training", "supervisor-kill-mid-handover",
    "never-acking-trainer", "tenant-flood", "torn-status",
    "torn-demand", "slice-outage",
)


def generate_coschedule_scenario(seed: int,
                                 num_slices: int = 4
                                 ) -> CoscheduleScenario:
    """Deterministic co-scheduling scenario from `seed`: a diurnal
    trace whose trough lends slices to training and whose peak (or a
    burst landing IN the trough) forces preemption back, composed with
    up to two fault primitives — the supervisor SIGKILL mid-handover,
    the never-acking trainer, and the tenant flood being the three the
    acceptance criteria name."""
    rng = random.Random(int(seed))
    period = 900.0
    duration = 1200.0 + 150.0 * rng.randrange(0, 3)
    base = 2.6 + 0.3 * rng.randrange(0, 3)
    amplitude = 0.55 + 0.05 * rng.randrange(0, 3)
    events: list = []
    bursts: list = []
    if rng.random() < 0.8:
        # surge-during-training: the burst lands in the trough, where
        # the fleet has lent the most slices to training — the moment
        # the preemption protocol earns its keep
        at = 0.55 * period + 30.0 * rng.randrange(0, 8)
        bursts.append((at, 150.0 + 60.0 * rng.randrange(0, 2),
                       2.5 + 0.5 * rng.randrange(0, 2)))
        events.append({"kind": "surge-during-training", "at": at})
    used: set = set()
    for _ in range(rng.randrange(0, 3)):
        kind = rng.choice(COSCHEDULE_PRIMITIVES[1:])
        if kind in used:
            continue
        used.add(kind)
        if kind == "supervisor-kill-mid-handover":
            events.append({"kind": kind, "nth": 1 + rng.randrange(2)})
        elif kind == "never-acking-trainer":
            events.append({"kind": kind})
        elif kind == "tenant-flood":
            events.append({
                "kind": kind,
                "at": 120.0 + 60.0 * rng.randrange(0, 6),
                "duration": 120.0 + 60.0 * rng.randrange(0, 2),
                "rps": 6.0 + 2.0 * rng.randrange(0, 2),
            })
        elif kind in ("torn-status", "torn-demand"):
            events.append({"kind": kind,
                           "at": 120.0 + 60.0 * rng.randrange(0, 8)})
        elif kind == "slice-outage":
            events.append({"kind": kind,
                           "slice": rng.randrange(num_slices),
                           "at": 90.0 + 60.0 * rng.randrange(0, 5)})
    return CoscheduleScenario(
        seed=int(seed), num_slices=num_slices, duration_s=duration,
        base_rps=base, diurnal_amplitude=amplitude,
        diurnal_period_s=period, bursts=tuple(bursts),
        deadline_s=120.0, events=events,
    )


def run_coschedule_campaign(scenario: CoscheduleScenario,
                            workdir: Path) -> dict:
    """One seeded co-scheduling campaign: the scenario's traffic and
    faults through `run_coschedule_drive` with the default campaign
    policies. The verdict carries the checker's violations (allocation
    + WFQ invariants armed) plus the handover bookkeeping."""
    kwargs: dict = dict(
        num_slices=scenario.num_slices,
        duration_s=scenario.duration_s,
        base_rps=scenario.base_rps,
        diurnal_amplitude=scenario.diurnal_amplitude,
        diurnal_period_s=scenario.diurnal_period_s,
        bursts=scenario.bursts,
        deadline_s=scenario.deadline_s,
        seed=scenario.seed,
        alloc_policy=default_alloc_policy(scenario.num_slices),
    )
    preempt: list = []
    torn_status: list = []
    torn_demand: list = []
    for event in scenario.events:
        kind = event["kind"]
        if kind == "supervisor-kill-mid-handover":
            kwargs["kill_on_notice"] = event.get("nth", 1)
        elif kind == "never-acking-trainer":
            kwargs["trainer_ack"] = False
        elif kind == "tenant-flood":
            kwargs["tenants"] = {"base": 3.0, "flood": 1.0}
            kwargs["flood"] = {
                "tenant": "flood", "at": event["at"],
                "duration": event["duration"], "rps": event["rps"],
            }
        elif kind == "torn-status":
            torn_status.append(event["at"])
        elif kind == "torn-demand":
            torn_demand.append(event["at"])
        elif kind == "slice-outage":
            preempt.append((event["slice"], event["at"]))
    kwargs["preempt"] = tuple(preempt)
    kwargs["torn_status_at"] = tuple(torn_status)
    kwargs["torn_demand_at"] = tuple(torn_demand)
    out = run_coschedule_drive(Path(workdir), **kwargs)
    out["events"] = [e["kind"] for e in scenario.events]
    return out


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
