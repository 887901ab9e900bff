"""Cluster readiness probes.

The reference's readiness layer was a scrape-and-kill workaround: curl the
K8s dashboard through the Rancher proxy every 15 s, and on a particular
error SSH in and docker-stop a wedged container (setup.sh:59-85, marked
`# BUG`). The rebuild makes readiness deterministic (SURVEY.md §7 "hard
parts"): poll declared conditions — K8s node Ready + allocatable
`google.com/tpu` chips for GKE, TPU VM state READY + a JAX device-count
smoke test over SSH for standalone slices — with bounded timeouts.

The port's copy of `tritonk8ssupervisor_tpu/provision/readiness.py`, whole
and under the reference's names: the port imports nothing of the JAX
package. The GPU modes have their counterparts: allocatable
`nvidia.com/gpu` for gke-gpu (`gke_gpu_probe`), Compute Engine status
RUNNING of every host VM for gpu-vm (`gpu_vm_states`, `gpu_vm_probe`,
through the same batched snapshot), and the `gpu-probe` Job.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from typing import Callable, Iterable

from tritonk8ssupervisor_tpu_torch.config.schema import ClusterConfig
from tritonk8ssupervisor_tpu_torch.provision import retry
from tritonk8ssupervisor_tpu_torch.provision import runner as run_mod


class NotReadyError(RuntimeError):
    """Cluster did not become ready within the timeout."""


@dataclasses.dataclass
class AdaptiveInterval:
    """Decorrelated-backoff probe cadence (the retry engine's jitter
    formula, pointed at polling): while a probe keeps returning the SAME
    "why not yet", the next interval is drawn from [base, 3*previous]
    capped at `max_interval` — a slow slice stops being probed every few
    seconds once it's clearly minutes away. The moment the verdict TEXT
    changes (progress: fewer unready hosts, a new TPU state), the cadence
    snaps back to `base` so the tail of the wait stays responsive. With N
    per-slice polls sharing one API, the jitter also de-synchronises them
    (thundering-herd control, same as provision/retry.py)."""

    base: float = 5.0
    max_interval: float = 45.0
    rng: Callable[[], float] = random.random

    def next(self, previous: float) -> float:
        low = self.base
        high = max(low, 3.0 * previous)
        return min(self.max_interval, low + self.rng() * (high - low))


def poll(
    probe: Callable[[], str],
    *,
    interval: float = 15.0,
    timeout: float = 900.0,
    sleep: Callable[[float], None] = time.sleep,
    echo: Callable[[str], None] = lambda line: print(line, flush=True),
    clock: Callable[[], float] = time.monotonic,
    adapt: AdaptiveInterval | None = None,
) -> None:
    """Run `probe` until it returns "" (ready) or the timeout lapses.

    A non-empty return is the human-readable "why not yet" — echoed like
    the reference's progress ticker (setup.sh:62,80) but with content.
    Probe exceptions count as "not yet" (transient API errors mid-boot).
    The default fixed 15 s cadence matches the reference's dashboard poll
    (setup.sh:66); passing `adapt` switches to the decorrelated-backoff
    cadence above (per-slice pipelined readiness uses it so N concurrent
    slice polls don't hammer the API at a fixed beat). The final sleep is
    clamped to the time left so the deadline cannot overshoot by a full
    interval; the last probe fires AT the deadline (one genuine last
    chance) and its verdict decides.
    """
    deadline = clock() + timeout
    current = interval if adapt is None else adapt.base
    last_why: str | None = None
    while True:
        try:
            why_not = probe()
        except NotReadyError:
            raise  # a probe's definitive verdict (e.g. Job Failed) — no retry
        except Exception as e:  # noqa: BLE001 - transient infra errors
            why_not = f"probe error: {e}"
        if not why_not:
            return
        now = clock()
        if now >= deadline:
            raise NotReadyError(f"timed out after {timeout:.0f}s: {why_not}")
        echo(f"  ... {why_not}")
        if adapt is not None:
            current = adapt.base if why_not != last_why else adapt.next(current)
            last_why = why_not
        sleep(min(current, deadline - now))


# ------------------------------------------------------------------ GKE mode


def gke_tpu_probe(
    config: ClusterConfig,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
) -> str:
    """Ready when every node is Ready and the summed allocatable
    `google.com/tpu` covers the requested chips."""
    raw = run_quiet(["kubectl", "get", "nodes", "-o", "json"])
    nodes = json.loads(raw).get("items", [])
    expected_hosts = config.num_slices * config.hosts_per_slice
    tpu_nodes = [
        n
        for n in nodes
        if "google.com/tpu" in n.get("status", {}).get("allocatable", {})
    ]
    if len(tpu_nodes) < expected_hosts:
        return f"{len(tpu_nodes)}/{expected_hosts} TPU nodes registered"
    not_ready = [
        n["metadata"]["name"]
        for n in tpu_nodes
        if not _node_is_ready(n)
    ]
    if not_ready:
        return f"nodes not Ready: {', '.join(sorted(not_ready)[:3])}"
    allocatable = sum(
        int(n["status"]["allocatable"]["google.com/tpu"]) for n in tpu_nodes
    )
    expected_chips = config.num_slices * config.chips_per_slice
    if allocatable < expected_chips:
        return f"{allocatable}/{expected_chips} TPU chips allocatable"
    return ""


def gke_gpu_probe(
    config: ClusterConfig,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
) -> str:
    """The gke-gpu counterpart of gke_tpu_probe: ready when every A3 node
    is Ready and the summed allocatable `nvidia.com/gpu` covers the
    deployment's GPUs (a node whose driver still installs reports 0)."""
    raw = run_quiet(["kubectl", "get", "nodes", "-o", "json"])
    nodes = json.loads(raw).get("items", [])
    expected_hosts = config.num_slices * config.hosts_per_slice
    gpu_nodes = [
        n for n in nodes
        if "nvidia.com/gpu" in n.get("status", {}).get("allocatable", {})
    ]
    if len(gpu_nodes) < expected_hosts:
        return f"{len(gpu_nodes)}/{expected_hosts} GPU nodes registered"
    not_ready = [n["metadata"]["name"] for n in gpu_nodes if not _node_is_ready(n)]
    if not_ready:
        return f"nodes not Ready: {', '.join(sorted(not_ready)[:3])}"
    allocatable = sum(int(n["status"]["allocatable"]["nvidia.com/gpu"]) for n in gpu_nodes)
    expected = config.num_slices * config.chips_per_slice
    if allocatable < expected:
        return f"{allocatable}/{expected} GPUs allocatable"
    return ""


def _node_is_ready(node: dict) -> bool:
    for cond in node.get("status", {}).get("conditions", []):
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


# --------------------------------------------------------------- tpu-vm mode


DEFAULT_PROBE_WORKERS = 16


def probe_workers(default: int = DEFAULT_PROBE_WORKERS) -> int:
    """The bounded SSH fan-out width (TK8S_PROBE_WORKERS, same convention
    as TK8S_SCHED_WORKERS). At 256 slices an unbounded one-thread-per-host
    probe would spawn hundreds of ssh children at once; the pool caps the
    concurrency while the verdict still names EVERY unready host."""
    raw = os.environ.get("TK8S_PROBE_WORKERS", "")
    try:
        return max(1, int(raw)) if raw else default
    except ValueError:
        return default


def _ssh_probe_one(
    ip: str,
    ssh_user: str,
    ssh_key: str,
    run_quiet: run_mod.RunFn,
    connect_timeout: int,
) -> str:
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
    try:
        run_quiet(args + [ip, "true"])
    except run_mod.CommandError as e:
        return f"{ip} (rc {e.returncode})"
    return ""


def ssh_ready_probe(
    ips: list[str],
    ssh_user: str = "",
    ssh_key: str = "",
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    connect_timeout: int = 5,
    max_workers: int | None = None,
) -> str:
    """Ready when `ssh <ip> true` succeeds on every host with the exact
    credentials ansible will use.

    The deterministic replacement for the reference's sleep-30-then-hope
    bootstrap (reference terraform/master/main.tf:22): ansible must not
    start until sshd accepts *authenticated* sessions, and "VM state
    READY" does not imply that (GCP propagates metadata SSH keys after
    boot). BatchMode fails instead of hanging on a password prompt;
    known_hosts stays untouched so teardown's scrub list remains accurate.

    Hosts are probed concurrently on a BOUNDED pool (TK8S_PROBE_WORKERS,
    default 16 — one thread per host does not survive 256 slices) and the
    verdict names every unready host: one straggler costs one
    ConnectTimeout, not N of them, and the operator sees the whole
    unready set instead of rediscovering it one poll cycle at a time.
    """
    if not ips:
        return ""
    workers = probe_workers() if max_workers is None else max(1, max_workers)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(
        max_workers=min(workers, len(ips)),
        thread_name_prefix="ssh-probe",
    ) as pool:
        verdicts = list(pool.map(
            lambda ip: _ssh_probe_one(ip, ssh_user, ssh_key, run_quiet,
                                      connect_timeout),
            ips,
        ))
    unready = [v for v in verdicts if v]
    if unready:
        return (f"{len(unready)}/{len(ips)} host(s) ssh not ready: "
                + ", ".join(unready))
    return ""


def slice_ssh_verdicts(
    host_ips: list[list[str]],
    ssh_user: str = "",
    ssh_key: str = "",
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    connect_timeout: int = 5,
    only_slices: "Iterable[int] | None" = None,
    max_workers: int | None = None,
) -> dict[int, str]:
    """Per-slice SSH readiness verdict ("" = every host in the slice
    accepts authenticated sessions). The heal diagnosis needs verdicts at
    SLICE granularity — one dead host condemns its slice (the JAX gang
    loses the whole collective anyway) but must not condemn the fleet.

    ALL probed hosts share ONE bounded pool (TK8S_PROBE_WORKERS): the old
    slice-at-a-time loop serialised the fleet — at 256 slices the last
    slice's verdict waited behind 255 probe rounds. `only_slices`
    restricts the probing to that subset (the supervisor's dirty-set
    reconcile diagnoses only changed slices); every probed slice still
    gets a verdict naming each of its unready hosts."""
    wanted = (None if only_slices is None
              else {int(i) for i in only_slices})
    targets = [
        (i, ip)
        for i, slice_ips in enumerate(host_ips)
        if wanted is None or i in wanted
        for ip in slice_ips
    ]
    verdicts: dict[int, str] = {
        i: "" for i, _ in enumerate(host_ips)
        if wanted is None or i in wanted
    }
    if not targets:
        return verdicts
    workers = probe_workers() if max_workers is None else max(1, max_workers)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(
        max_workers=min(workers, len(targets)),
        thread_name_prefix="ssh-probe",
    ) as pool:
        results = list(pool.map(
            lambda t: (t[0], _ssh_probe_one(t[1], ssh_user, ssh_key,
                                            run_quiet, connect_timeout)),
            targets,
        ))
    unready: dict[int, list[str]] = {}
    for index, verdict in results:
        if verdict:
            unready.setdefault(index, []).append(verdict)
    for index, bad in unready.items():
        total = len(host_ips[index])
        verdicts[index] = (f"{len(bad)}/{total} host(s) ssh not ready: "
                           + ", ".join(bad))
    return verdicts


def tpu_vm_states(
    config: ClusterConfig,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    names: "Iterable[str] | None" = None,
) -> dict[str, str]:
    """Cloud TPU state per node name from ONE batched `tpu-vm list` call.
    Shared by the readiness poll (every slice) and the heal diagnosis
    (which slices are missing/stuck while the rest of the fleet is up).
    With `names`, the listing is windowed to that page of nodes (a
    server-side name filter + matching --page-size) — how FleetSnapshot
    pages a 256-slice fleet instead of asking for everything at once."""
    args = [
        "gcloud",
        "compute",
        "tpus",
        "tpu-vm",
        "list",
        f"--zone={config.zone}",
        "--format=value(name,state)",
    ]
    if names is not None:
        page = [str(n) for n in names]
        args += [f"--filter=name:({' '.join(page)})",
                 f"--page-size={max(1, len(page))}"]
    raw = run_quiet(args)
    states: dict[str, str] = {}
    for line in raw.splitlines():
        parts = line.split()
        if not parts:
            continue
        # value() output is NAME<tab>STATE; a bare NAME means no state yet
        name = parts[0].rsplit("/", 1)[-1]  # tolerate full resource paths
        states[name] = parts[1] if len(parts) > 1 else "UNKNOWN"
    return states


def gpu_vm_names(config: ClusterConfig, slices: "Iterable[int] | None" = None) -> list[str]:
    """The host VM names of the given slices (all by default): host h of
    slice s is `<node_prefix>-<s>-<h>` (terraform/gpu-vm)."""
    slices = range(config.num_slices) if slices is None else slices
    return [f"{config.node_prefix}-{s}-{h}"
            for s in slices for h in range(config.hosts_per_slice)]


def gpu_vm_states(
    config: ClusterConfig,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    names: "Iterable[str] | None" = None,
) -> dict[str, str]:
    """Compute Engine status per VM name from ONE batched `instances list`
    call, the gpu-vm counterpart of tpu_vm_states (same paging)."""
    if names is None:
        name_filter = f"--filter=name~^{config.node_prefix}-"
        page_size: list[str] = []
    else:
        page = [str(n) for n in names]
        name_filter = f"--filter=name:({' '.join(page)})"
        page_size = [f"--page-size={max(1, len(page))}"]
    raw = run_quiet([
        "gcloud", "compute", "instances", "list", f"--zones={config.zone}",
        "--format=value(name,status)", name_filter, *page_size,
    ])
    states: dict[str, str] = {}
    for line in raw.splitlines():
        parts = line.split()
        if parts:
            states[parts[0].rsplit("/", 1)[-1]] = parts[1] if len(parts) > 1 else "UNKNOWN"
    return states


def vm_lister(config: ClusterConfig) -> Callable[..., dict[str, str]]:
    """The batched listing of the deployment's VM mode: a TPU slice is one
    Cloud TPU node, a GPU slice lists each host VM."""
    return gpu_vm_states if config.is_gpu else tpu_vm_states


# The listing's verdict on a slice (`SliceListing.state`)
LISTED = "listed"
ABSENT = "absent"
NOT_READY = "not-ready"


@dataclasses.dataclass(frozen=True)
class SliceListing:
    """What one listing says of one slice: its verdict, the detail a
    diagnosis prints, and the signature the supervisor's change detector
    compares from tick to tick (the slice's raw listed states)."""

    state: str  # LISTED / ABSENT / NOT_READY
    detail: str = ""
    signature: str = ""


def fold_listing(
    config: ClusterConfig, listing: dict[str, str], slices: Iterable[int],
) -> dict[int, SliceListing]:
    """Fold a `vm_lister` listing into per-slice verdicts, for either VM
    mode. tpu-vm: node `<prefix>-<i>` absent, or in a state other than
    READY. gpu-vm: ABSENT when any host VM `<prefix>-<i>-<h>` is absent,
    else NOT_READY when any host's status is not RUNNING (TERMINATED after
    a host maintenance event, STAGING while it boots); the detail names
    each such host."""
    out: dict[int, SliceListing] = {}
    for i in slices:
        if not config.is_gpu:
            name = f"{config.node_prefix}-{i}"
            state = listing.get(name, "")
            if name not in listing:
                out[i] = SliceListing(ABSENT, "absent from the Cloud TPU listing")
            elif state != "READY":
                out[i] = SliceListing(NOT_READY, f"TPU state {state}", state)
            else:
                out[i] = SliceListing(LISTED, signature=state)
            continue
        names = gpu_vm_names(config, [i])
        signature = " ".join(listing.get(n, "") for n in names)
        absent = [n for n in names if n not in listing]
        stopped = [f"{n} {listing[n]}" for n in names
                   if n in listing and listing[n] != "RUNNING"]
        if absent:
            out[i] = SliceListing(
                ABSENT, "absent from the Compute Engine listing: "
                + ", ".join(absent), signature)
        elif stopped:
            out[i] = SliceListing(
                NOT_READY, "host VM status " + ", ".join(stopped)
                + " (want RUNNING)", signature)
        else:
            out[i] = SliceListing(LISTED, signature=signature)
    return out


def gpu_vm_probe(
    config: ClusterConfig,
    vm_names: list[str],
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    snapshot: "FleetSnapshot | None" = None,
) -> str:
    """Ready when every named host VM is RUNNING; a VM absent from the
    listing is still being created."""
    states = (snapshot.states() if snapshot is not None
              else gpu_vm_states(config, run_quiet))
    unready = [f"{name} is {states.get(name) or 'CREATING'}"
               for name in vm_names if states.get(name) != "RUNNING"]
    if unready:
        return f"host VM(s) not running: {', '.join(unready)}"
    return ""


@dataclasses.dataclass
class _SnapshotPage:
    """One window of the fleet listing: the node names it covers, the
    last good fetch, and the quota-backoff gate."""

    names: tuple
    slices: tuple = ()  # the slice indices whose nodes the page lists
    states: dict | None = None
    fetched_at: float = float("-inf")
    backoff_until: float = float("-inf")


class FleetSnapshot:
    """The batched `tpu-vm list` shared by every consumer in a run —
    fetched in bounded WINDOWED PAGES at fleet scale.

    Per-slice pipelined readiness runs N slice polls concurrently, and
    `heal` diagnoses right after its own readiness checks — without
    sharing, each would issue its own `tpu-vm list` (at ~1 s of gcloud
    startup + API latency per call, N slices turn every poll beat into
    N round-trips). The snapshot caches the listing for `ttl` seconds:
    concurrent slice polls inside one beat see the same fetch, and the
    TTL bounds staleness to less than a poll interval.

    `page_size` > 0 splits the fleet into pages of that many slices,
    each fetched by its own name-filtered list call with its OWN TTL and
    staleness tracking — a 256-slice fleet is four 64-slice pages, and a
    consumer that only cares about one page's worth of slices never
    forces the rest to refetch. A page fetch that fails with a
    rate/quota throttle (HTTP 429 / RESOURCE_EXHAUSTED — the retry
    classifier's verdict) parks that page behind the classifier's
    QUOTA_BACKOFF_FLOOR and serves the last good copy STALE (counted in
    `served_stale`) instead of hammering the API; a failure with no
    stale copy to serve still raises (never cached), and `fetch_errors`
    / `last_error` keep the reconcile loop honest about a listing that
    is quietly erroring. Thread-safe; `fetches` counts real calls.
    """

    def __init__(
        self,
        config: ClusterConfig,
        run_quiet: run_mod.RunFn = run_mod.run_capture,
        ttl: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        page_size: int = 0,
        quota_backoff_s: float | None = None,
    ) -> None:
        self._config = config
        self._run_quiet = run_quiet
        self._ttl = ttl
        self._clock = clock
        self._lock = threading.Lock()
        n = max(1, int(config.num_slices))
        size = n if int(page_size) <= 0 else min(int(page_size), n)
        self._lister = vm_lister(config)

        def page_names(slices: range) -> tuple:
            if config.is_gpu:
                return tuple(gpu_vm_names(config, slices))
            return tuple(f"{config.node_prefix}-{j}" for j in slices)

        self._pages = [
            _SnapshotPage(page_names(slices), tuple(slices))
            for slices in (range(i, min(i + size, n)) for i in range(0, n, size))
        ]
        self._quota_backoff = (retry.QUOTA_BACKOFF_FLOOR
                               if quota_backoff_s is None
                               else float(quota_backoff_s))
        self.fetches = 0
        self.served_stale = 0  # pages served past their TTL (backoff)
        # Failed fetches are never cached, but a LONG-RUNNING consumer
        # (the supervisor's reconcile loop) needs to see that its
        # listings are erroring — a fleet that "looks healthy" because
        # every listing failed is the opposite of supervised.
        self.fetch_errors = 0
        self.last_error = ""

    @property
    def page_count(self) -> int:
        return len(self._pages)

    def _fetch_backoff(self, error: Exception, now: float) -> float:
        """Next-allowed-fetch time after a failed page fetch: a throttle
        verdict (429/RESOURCE_EXHAUSTED) waits the classifier's quota
        floor; anything else may retry immediately (the old never-cache
        contract)."""
        if isinstance(error, run_mod.CommandError):
            verdict = retry.classify(error)
            if verdict.min_delay > 0:
                return now + max(verdict.min_delay, self._quota_backoff)
        return now

    def states(self, max_age: float | None = None) -> dict[str, str]:
        ttl = self._ttl if max_age is None else max_age
        with self._lock:
            now = self._clock()
            merged: dict[str, str] = {}
            single = len(self._pages) == 1
            for page in self._pages:
                fresh = (page.states is not None
                         and now - page.fetched_at <= ttl)
                if not fresh and now >= page.backoff_until:
                    try:
                        listing = self._lister(
                            self._config, self._run_quiet,
                            names=None if single else page.names,
                        )
                    except Exception as e:  # noqa: BLE001 - classify below
                        self.fetch_errors += 1
                        self.last_error = str(e)
                        page.backoff_until = self._fetch_backoff(e, now)
                        if page.states is None:
                            raise  # nothing stale to serve
                        self.served_stale += 1
                    else:
                        wanted = set(page.names)
                        page.states = (
                            dict(listing) if single
                            else {k: v for k, v in listing.items()
                                  if k in wanted}
                        )
                        page.fetched_at = now
                        self.fetches += 1
                elif not fresh:
                    self.served_stale += 1  # quota backoff: stale by choice
                merged.update(page.states)
            return merged

    def parked_slices(self, now: float | None = None) -> set:
        """Slice indices whose listing page is currently quota-parked
        (a 429/RESOURCE_EXHAUSTED fetch put the page behind the backoff
        floor; its data is being served STALE). The supervisor DEFERS
        non-urgent heals for these slices: a heal is itself a burst of
        API calls, and dispatching it into an already-throttled API on
        stale evidence deepens the very quota storm that parked the
        page."""
        with self._lock:
            now = self._clock() if now is None else now
            parked: set = set()
            for page in self._pages:
                if page.backoff_until > now:
                    parked.update(page.slices)
            return parked

    def staleness(self, now: float | None = None) -> float:
        """Age of the OLDEST page's data (inf when a page has never been
        fetched) — what "how stale could this verdict be" means once
        pages refresh independently."""
        with self._lock:
            now = self._clock() if now is None else now
            return max(
                (now - page.fetched_at) for page in self._pages
            )

    def invalidate(self) -> None:
        """Mark every page stale. Data is KEPT for the quota-backoff
        stale-serve path; the next states() refetches whatever is
        allowed to refetch."""
        with self._lock:
            for page in self._pages:
                page.fetched_at = float("-inf")


def tpu_vm_probe(
    config: ClusterConfig,
    slice_names: list[str],
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    snapshot: FleetSnapshot | None = None,
) -> str:
    """Ready when every slice's Cloud TPU state is READY.

    One `tpu-vm list` call covers every slice (instead of N per-slice
    `describe` round-trips — at ~1 s of gcloud startup + API latency
    each, that's the whole poll interval burned on a 16-slice pool), and
    the verdict names every slice still in flight. A slice absent from
    the listing reads CREATING: the QueuedResource has not materialised
    a node yet, which is the normal early-boot state, not an error.
    With `snapshot`, concurrent per-slice polls share one TTL-cached
    listing instead of each fetching their own.
    """
    states = (
        snapshot.states() if snapshot is not None
        else tpu_vm_states(config, run_quiet)
    )
    unready = [
        f"{name} is {states.get(name) or 'CREATING'}"
        for name in slice_names
        if states.get(name) != "READY"
    ]
    if unready:
        return f"slice(s) not ready: {', '.join(unready)}"
    return ""


# One definition of the per-host acceptance tests, shared with the tpuhost
# and gpuhost ansible roles via to_ansible_vars (config/compile.py).
from tritonk8ssupervisor_tpu_torch.config.compile import (  # noqa: E402,F401
    gpu_smoke_command,
    jax_smoke_command,
)


class ProbeFailed(NotReadyError):
    """The probe Job reached the Failed condition."""


def _probe_job_status(raw: str) -> str:
    """Map `kubectl get job -o json` output to ""/why-not; raises
    ProbeFailed on the Failed condition (kubectl wait can't fast-fail:
    waiting on condition=complete never fires for a failed Job)."""
    job = json.loads(raw)
    name = job.get("metadata", {}).get("name", "tpu-probe")
    status = job.get("status", {})
    for cond in status.get("conditions", []):
        if cond.get("type") == "Failed" and cond.get("status") == "True":
            raise ProbeFailed(
                f"probe job failed: {cond.get('message', f'see kubectl logs job/{name}')}"
            )
        if cond.get("type") == "Complete" and cond.get("status") == "True":
            return ""
    want = job.get("spec", {}).get("completions", 1)
    return f"{status.get('succeeded', 0)}/{want} probe pods succeeded"


def collect_job_diagnostics(
    job_name: str,
    out_dir,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
) -> "Path | None":
    """Capture the evidence for a failed Job before it is cleaned up:
    pod listing, per-pod logs, and cluster events, written under
    `out_dir`/diagnostics/<job_name>/.

    The reference *remediated* its wedged dashboard by SSHing in and
    killing the container (setup.sh:69-82, marked # BUG); deterministic
    detection replaced that, but detection without evidence left the
    operator a bare "see kubectl logs" pointer to pods the cleanup was
    about to delete. Each capture is
    best-effort: whatever kubectl can still produce is written, missing
    pieces record their error instead. When EVERY capture fails (cluster
    unreachable), the placeholder files are removed again and None is
    returned — an error-stub-only directory would read like captured
    evidence.
    """
    import shutil
    from pathlib import Path

    diag_dir = Path(out_dir) / "diagnostics" / job_name
    wrote_anything = False

    def capture(path: Path, args: list[str]) -> str:
        nonlocal wrote_anything
        try:
            text = run_quiet(args)
        except Exception as e:  # noqa: BLE001 - capture what we can
            text = f"<capture failed: {e}>"
        else:
            wrote_anything = True
        path.write_text(text if text.endswith("\n") else text + "\n")
        return text

    diag_dir.mkdir(parents=True, exist_ok=True)
    pods_raw = capture(
        diag_dir / "pods.json",
        ["kubectl", "get", "pods", "-l", f"job-name={job_name}", "-o", "json"],
    )
    pod_names = []
    try:
        pod_names = [
            p["metadata"]["name"]
            for p in json.loads(pods_raw).get("items", [])
        ]
    except (json.JSONDecodeError, KeyError, TypeError):
        pass
    for pod in pod_names:
        capture(
            diag_dir / f"{pod}.log",
            ["kubectl", "logs", pod, "--all-containers", "--tail=500"],
        )
    capture(
        diag_dir / "events.txt",
        ["kubectl", "get", "events", "--sort-by=.lastTimestamp"],
    )
    if not wrote_anything:
        shutil.rmtree(diag_dir, ignore_errors=True)
        return None
    return diag_dir


def run_probe_job(
    config: ClusterConfig,
    probe_dir,
    run: run_mod.RunFn = run_mod.run_streaming,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
    timeout_seconds: float = 600,
    image: str | None = None,
    sleep=time.sleep,
) -> None:
    """Apply the TPU probe Job (config/compile.py to_probe_job), poll until
    Complete (fast-failing on Failed), clean it up. Raises NotReadyError —
    the workload-level acceptance test behind the node-level probes. A
    GPU deployment's is `gpu-probe`, which installs the port from the
    package ConfigMap: that is applied first and left in place (the
    benchmark Jobs mount the same one).

    `probe_dir` must NOT be the benchmark manifests directory: the README
    tells users to `kubectl apply -f manifests/generated/` wholesale, and
    the probe must not ride along and contend for the TPU hosts.
    """
    import yaml

    from tritonk8ssupervisor_tpu_torch.config import compile as compiler
    from pathlib import Path

    probe_dir = Path(probe_dir)
    probe_dir.mkdir(parents=True, exist_ok=True)
    job_name = "gpu-probe" if config.is_gpu else "tpu-probe"
    manifest = probe_dir / f"{job_name}.yaml"
    job_kwargs = {"image": image} if image else {}
    manifest.write_text(
        yaml.safe_dump(compiler.to_probe_job(config, **job_kwargs), sort_keys=False)
    )
    if config.is_gpu:
        package = probe_dir / "package-configmap.yaml"
        package.write_text(yaml.safe_dump(compiler.to_package_configmap(), sort_keys=False))
        run(["kubectl", "apply", "-f", str(package)])
    run(["kubectl", "apply", "-f", str(manifest)])
    try:
        poll(
            lambda: _probe_job_status(
                run_quiet(["kubectl", "get", "job", job_name, "-o", "json"])
            ),
            timeout=timeout_seconds,
            sleep=sleep,
        )
    except NotReadyError as e:
        # Evidence before cleanup: the finally below deletes the pods
        # the operator would want to inspect, so capture their logs +
        # events first and point at the capture in the error itself.
        diag_dir = collect_job_diagnostics(
            job_name, probe_dir, run_quiet=run_quiet
        )
        if diag_dir is not None:
            raise type(e)(f"{e} [diagnostics: {diag_dir}]") from e
        raise
    finally:
        try:
            run(["kubectl", "delete", "-f", str(manifest), "--ignore-not-found"])
        except run_mod.CommandError:
            pass
