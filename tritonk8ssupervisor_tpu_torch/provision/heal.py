"""Slice-granular fleet health and repair.

Before this module, one dead slice aborted the whole deployment: the
readiness poll timed out, the run failed, and the only recovery was a
full re-provision — the opposite of how Podracer-style TPU orchestration
(PAPERS.md, 2104.06272) treats pod loss, where slices come and go and the
controller degrades instead of dying. Here the fleet gets a health model
and a scoped repair path:

- `diagnose()` builds a `FleetHealth`: per slice, `healthy`, `missing`
  (no hosts recorded / node absent from the Cloud TPU listing, or a host
  VM absent from the Compute Engine listing), `unready` (TPU state not
  READY, a host VM not RUNNING, or a host refusing authenticated SSH), or
  `draining` (the maintenance watchdog's drain file is present on a host
  — provision/maintenance.py). One dead host condemns its slice (the JAX
  gang loses the collective anyway) but never the fleet.
- `heal()` quarantines the bad slices (terraform/quarantine.json, written
  atomically), re-creates ONLY them (`terraform apply -replace=` on the
  slice addresses — healthy slices' state entries are untouched),
  reconverges ansible with `--limit` to the healed hosts, polls readiness
  for just those hosts, and rewrites hosts.json atomically.
- `--max-degraded N` turns abort-on-loss into degrade-on-loss: slices
  that stay broken after repair are recorded as degraded and emptied from
  hosts.json, and the run SUCCEEDS on the remaining healthy slices —
  N-of-M semantics. (Cross-slice training manifests still span the
  original slice count; `./setup.sh --resize` shrinks the training
  surface when the loss is long-lived — see docs/failure-modes.md.)

The VM modes only, tpu-vm and gpu-vm (whose slice is its H host VMs:
`readiness.fold_listing` reads their listing, `terraform.apply_slices`
replaces every one of them): GKE slice repair, gke-gpu's included, is the
node pool's auto-repair job (terraform/gke*/main.tf
`management.auto_repair`), not ours.

The port's copy of `tritonk8ssupervisor_tpu/provision/heal.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
`provision/events.fleet_status` classifies slices by its states.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time

from tritonk8ssupervisor_tpu_torch.config.schema import (
    VM_MODES,
    ClusterConfig,
    ConfigError,
)
from tritonk8ssupervisor_tpu_torch.provision import ansible as ansible_mod
from tritonk8ssupervisor_tpu_torch.provision import cache as cache_mod
from tritonk8ssupervisor_tpu_torch.provision import maintenance
from tritonk8ssupervisor_tpu_torch.provision import readiness
from tritonk8ssupervisor_tpu_torch.provision import runner as run_mod
from tritonk8ssupervisor_tpu_torch.provision import terraform as terraform_mod
from tritonk8ssupervisor_tpu_torch.provision.state import (
    MissingStateError,
    RunPaths,
    atomic_write_text,
    load_hosts,
)

HEALTHY = "healthy"
MISSING = "missing"
UNREADY = "unready"
DRAINING = "draining"
DEGRADED = "degraded"  # quarantine-file state: left out of service


@dataclasses.dataclass(frozen=True)
class SliceHealth:
    index: int
    state: str  # HEALTHY / MISSING / UNREADY / DRAINING
    detail: str = ""
    hosts: tuple = ()
    # the failure domain this slice shares fate with
    # (ClusterConfig.domain_of); "" when the caller has no config in
    # hand — consumers must treat "" as "unknown", never as a domain
    domain: str = ""


@dataclasses.dataclass
class FleetHealth:
    """Per-slice verdicts for one deployment, in slice order."""

    slices: list

    @property
    def healthy(self) -> list:
        return [s.index for s in self.slices if s.state == HEALTHY]

    @property
    def degraded(self) -> list:
        return [s.index for s in self.slices if s.state != HEALTHY]

    def by_domain(self) -> dict:
        """{domain: [SliceHealth, ...]} — what the correlated-failure
        classifier (provision/supervisor.py) groups over."""
        grouped: dict = {}
        for s in self.slices:
            grouped.setdefault(s.domain, []).append(s)
        return grouped

    def summary(self) -> list:
        lines = []
        for s in self.slices:
            detail = f" ({s.detail})" if s.detail else ""
            lines.append(f"slice {s.index}: {s.state}{detail}")
        return lines


def _ssh_args(ssh_user: str, ssh_key: str, connect_timeout: int = 5) -> list:
    args = [
        "ssh",
        "-o", "BatchMode=yes",
        "-o", f"ConnectTimeout={connect_timeout}",
        "-o", "StrictHostKeyChecking=no",
        "-o", "UserKnownHostsFile=/dev/null",
    ]
    if ssh_key:
        args += ["-i", str(ssh_key)]
    if ssh_user:
        args += ["-l", ssh_user]
    return args


def drain_verdicts(
    host_ips: list,
    ssh_user: str = "",
    ssh_key: str = "",
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    drain_file: str = maintenance.DEFAULT_DRAIN_FILE,
    only_slices=None,
) -> dict:
    """{slice index: drain reason} for slices where ANY host carries the
    maintenance watchdog's drain file. An unreachable host is NOT
    draining (it shows up as unready via the SSH probe instead); a
    reachable host without the file returns empty output — also not
    draining. `only_slices` bounds the asking to that subset (the
    supervisor's dirty-set reconcile never drain-checks 256 slices a
    tick)."""
    wanted = (None if only_slices is None
              else {int(i) for i in only_slices})
    verdicts: dict = {}
    for i, slice_ips in enumerate(host_ips):
        if wanted is not None and i not in wanted:
            continue
        for ip in slice_ips:
            try:
                reason = run_quiet(
                    _ssh_args(ssh_user, ssh_key)
                    + [ip, f"cat {drain_file} 2>/dev/null || true"]
                ).strip()
            except run_mod.CommandError:
                continue  # cannot ask — the SSH probe owns that verdict
            if reason:
                verdicts[i] = f"{ip}: {reason}"
                break
    return verdicts


def diagnose(
    config: ClusterConfig,
    paths: RunPaths,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    ssh_user: str = "",
    ssh_key: str = "",
    check_drain: bool = True,
    snapshot: "readiness.FleetSnapshot | None" = None,
    only_slices=None,
) -> FleetHealth:
    """Readiness verdicts + the drain signal, folded into per-slice
    health. Probes are batched and concurrent: one `tpu-vm
    list`, or gpu-vm's `instances list`, (windowed into pages at fleet
    scale) for the whole fleet, folded by `readiness.fold_listing`, SSH
    fan-out on a bounded pool. With `snapshot`
    (readiness.FleetSnapshot) the listing is the run's shared TTL-cached
    one — a heal that just polled readiness does not issue a second
    `tpu-vm list` to diagnose the same fleet.

    `only_slices` scopes the EXPENSIVE probes (per-host SSH + drain
    files) to that subset and returns a FleetHealth over just those
    slices — the supervisor's dirty-set reconcile diagnoses the slices
    whose listing page changed plus a slow sweep rotation, never the
    whole fleet per tick."""
    try:
        hosts = load_hosts(paths)
        host_ips = hosts.host_ips
    except MissingStateError:
        host_ips = []
    try:
        listing = (
            snapshot.states() if snapshot is not None
            else readiness.vm_lister(config)(config, run_quiet)
        )
    except Exception:  # noqa: BLE001 - listing is advisory; SSH decides
        listing = {}
    indices = (
        list(range(config.num_slices)) if only_slices is None
        else sorted({int(i) for i in only_slices
                     if 0 <= int(i) < config.num_slices})
    )
    ssh_verdicts = readiness.slice_ssh_verdicts(
        host_ips, ssh_user=ssh_user, ssh_key=ssh_key, run_quiet=run_quiet,
        only_slices=None if only_slices is None else indices,
    )
    drains = (
        drain_verdicts(host_ips, ssh_user=ssh_user, ssh_key=ssh_key,
                       run_quiet=run_quiet,
                       only_slices=None if only_slices is None else indices)
        if check_drain else {}
    )

    listed = readiness.fold_listing(config, listing, indices) if listing else {}
    slices = []
    for i in indices:
        domain = config.domain_of(i)
        slice_ips = tuple(host_ips[i]) if i < len(host_ips) else ()
        verdict = listed.get(i)
        if not slice_ips:
            slices.append(SliceHealth(i, MISSING, "no hosts recorded",
                                      domain=domain))
        elif verdict is not None and verdict.state == readiness.ABSENT:
            slices.append(SliceHealth(i, MISSING, verdict.detail,
                                      hosts=slice_ips, domain=domain))
        elif verdict is not None and verdict.state == readiness.NOT_READY:
            slices.append(SliceHealth(i, UNREADY, verdict.detail,
                                      hosts=slice_ips, domain=domain))
        elif i in drains:
            slices.append(SliceHealth(i, DRAINING, drains[i],
                                      hosts=slice_ips, domain=domain))
        elif ssh_verdicts.get(i):
            slices.append(SliceHealth(i, UNREADY, ssh_verdicts[i],
                                      hosts=slice_ips, domain=domain))
        else:
            slices.append(SliceHealth(i, HEALTHY, hosts=slice_ips,
                                      domain=domain))
    return FleetHealth(slices)


# Concurrent slice-scoped heals (the supervisor's parallel dispatch)
# merge into one quarantine record: the read-modify-write below must not
# interleave across heal worker threads or entries get lost.
_QUARANTINE_LOCK = threading.Lock()


def record_quarantine(
    paths: RunPaths,
    entries: dict,
    clock=time.time,
) -> None:
    """Merge {slice index: {state, detail, hosts}} into
    terraform/quarantine.json (atomic write, serialised across heal
    worker threads). The record survives the heal so an operator can see
    WHAT was pulled and WHY even after hosts.json has been rewritten;
    healed slices are removed again."""
    with _QUARANTINE_LOCK:
        _record_quarantine_locked(paths, entries, clock)


def _record_quarantine_locked(paths, entries, clock) -> None:
    existing: dict = {}
    if paths.quarantine_file.exists():
        try:
            existing = json.loads(paths.quarantine_file.read_text())
        except (json.JSONDecodeError, OSError):
            existing = {}  # a torn quarantine record is rewritten whole
    slices = existing.get("slices", {})
    for index, entry in entries.items():
        if entry is None:
            slices.pop(str(index), None)
        else:
            slices[str(index)] = entry
    atomic_write_text(
        paths.quarantine_file,
        json.dumps({"updated": clock(), "slices": slices},
                   indent=2, sort_keys=True) + "\n",
    )


def heal(
    config: ClusterConfig,
    paths: RunPaths,
    prompter,
    run: run_mod.RunFn = run_mod.run_streaming,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    ssh_key: str = "",
    ssh_user: str = "",
    max_degraded: int = 0,
    readiness_timeout: float = 900.0,
    timer=None,
    check_drain: bool = True,
    sleep=time.sleep,
    clock=time.monotonic,
    cache: "cache_mod.WarmCache | None" = None,
    health: "FleetHealth | None" = None,
    only_slices=None,
) -> bool:
    """Diagnose and repair the fleet at slice granularity.

    Returns True when every slice is healthy afterwards, or when the
    leftover breakage fits inside `max_degraded` (those slices are
    quarantined and emptied from hosts.json — N-of-M success). Breakage
    beyond the budget re-raises the readiness timeout; terraform/ansible
    failures raise through the normal error path, retries included.

    `health` supplies a pre-computed diagnosis instead of probing again —
    the supervisor (provision/supervisor.py) diagnoses every reconcile
    tick and must not pay (or race) a second probe round inside the heal
    it then orders. `only_slices` restricts the repair to that subset of
    the degraded slices: the supervisor's flap filter and drain verdicts
    decide WHAT is heal-eligible (a slice draining for maintenance is
    expected, not broken), the rate limiter decides WHEN, and this
    function only executes the order. Manual `./setup.sh heal` passes
    neither and keeps repairing everything degraded, draining included —
    an operator typing `heal` has decided the drain is over.

    Converge shares the provision pipeline's warm path
    (provision/cache.py): each repaired slice's cache entry is
    invalidated first (new endpoints MUST reconverge even if the key
    collides) and re-recorded on success by the shared
    `ansible_mod.converge_slice`, while the healthy slices' entries are
    never touched — so a follow-up provision run warm-skips them, and
    only the replaced slice's converge ever runs here.
    """
    if config.mode not in VM_MODES:
        raise ConfigError(
            "heal repairs standalone TPU VM slices; GKE node pools "
            "self-repair (auto_repair) and gang-restart via the Job "
            "backoff budget — see docs/failure-modes.md"
        )
    if cache is None:
        cache = cache_mod.WarmCache(paths.warm_cache)

    def phase(name: str):
        return (timer.phase(name) if timer is not None
                else contextlib.nullcontext())

    if health is None:
        # one batched `tpu-vm list` snapshot feeds the diagnosis AND any
        # readiness probes inside this run
        snapshot = readiness.FleetSnapshot(config, run_quiet=run_quiet)
        with phase("heal-diagnose"):
            health = diagnose(
                config, paths, run_quiet=run_quiet,
                ssh_user=ssh_user, ssh_key=ssh_key, check_drain=check_drain,
                snapshot=snapshot,
            )
    for line in health.summary():
        prompter.say(f"  {line}")
    bad = health.degraded
    if only_slices is not None:
        wanted = {int(i) for i in only_slices}
        bad = [i for i in bad if i in wanted]
    if not bad:
        prompter.say("Fleet healthy; nothing to heal.")
        return True

    # Quarantine BEFORE touching anything: if the repair itself crashes,
    # the record of which slices were condemned (and why) survives.
    record_quarantine(paths, {
        s.index: {"state": s.state, "detail": s.detail,
                  "hosts": list(s.hosts), "domain": s.domain}
        for s in health.slices if s.index in bad
    })
    prompter.say(
        f"Healing slice(s) {', '.join(str(i) for i in bad)} "
        f"(quarantined in {paths.quarantine_file}); healthy slice(s) "
        f"{', '.join(str(i) for i in health.healthy) or '(none)'} untouched."
    )

    with phase("heal-apply"):
        hosts = terraform_mod.apply_slices(
            config, paths, bad, run=run, run_quiet=run_quiet
        )
    healed_ips = [
        ip for i in bad if i < len(hosts.host_ips)
        for ip in hosts.host_ips[i]
    ]
    with phase("heal-configure"):
        ansible_mod.write_runtime_configs(
            config, hosts, paths, ssh_key=ssh_key, ansible_user=ssh_user
        )
        # Per-slice converge through the SAME cache-aware unit the
        # provision DAG runs: healthy slices keep their warm entries
        # (nothing runs for them), repaired slices are forced cold first
        # — a recycled IP must not fake a warm hit on a fresh VM.
        for i in bad:
            cache.invalidate(f"configure-slice-{i}")
        for i in bad:
            ansible_mod.converge_slice(
                config, paths, hosts, i, run=run, cache=cache,
                ssh_key=ssh_key, ssh_user=ssh_user,
                echo=lambda line: prompter.say(line),
            )
    still_bad: list = []
    with phase("heal-readiness"):
        try:
            readiness.poll(
                lambda: readiness.ssh_ready_probe(
                    healed_ips, ssh_user=ssh_user, ssh_key=str(ssh_key),
                    run_quiet=run_quiet,
                ),
                interval=5.0,
                timeout=readiness_timeout,
                sleep=sleep,
                clock=clock,
                # progress through the prompter: the supervisor's drills
                # (and bench JSON consumers) capture say(), and the CLI's
                # prompter prints — same visibility, no stray stdout
                echo=lambda line: prompter.say(line),
            )
        except readiness.NotReadyError:
            verdicts = readiness.slice_ssh_verdicts(
                hosts.host_ips, ssh_user=ssh_user, ssh_key=str(ssh_key),
                run_quiet=run_quiet,
            )
            still_bad = [i for i in bad if verdicts.get(i)]
            if len(still_bad) > max_degraded:
                raise

    if still_bad:
        # N-of-M degradation: pull the unhealable slices from service —
        # empty their host records (atomic rewrite) and keep the
        # quarantine entries — instead of failing the whole fleet.
        for i in still_bad:
            if i < len(hosts.host_ips):
                hosts.host_ips[i] = []
            if i < len(hosts.internal_ips):
                hosts.internal_ips[i] = []
            # a degraded slice's converge record must not read as warm
            # when the slice is later re-provisioned
            cache.invalidate(f"configure-slice-{i}")
        hosts.save(paths.hosts_file)
        record_quarantine(paths, {
            i: {"state": DEGRADED,
                "detail": "still unready after heal; left out of service "
                          f"(--max-degraded {max_degraded})",
                "hosts": []}
            for i in still_bad
        })
        prompter.say(
            f"WARNING: slice(s) {', '.join(str(i) for i in still_bad)} "
            "stayed unhealthy and were left out of service "
            f"(--max-degraded {max_degraded}). Running degraded on "
            f"{config.num_slices - len(still_bad)}/{config.num_slices} "
            "slices; use --resize to shrink the training surface, or "
            "re-run heal later."
        )
    else:
        # everything healed: clear the quarantine entries for these slices
        record_quarantine(paths, {i: None for i in bad})
        prompter.say(
            f"Healed slice(s) {', '.join(str(i) for i in bad)}; "
            "fleet fully healthy."
        )
    return True
