"""On-disk layout of generated artifacts and runtime state.

The reference's resume-after-crash property came from files-as-phase-contract:
`config` (setup.sh:199-208), generated `rancher.tf` + tfstate (skip-if-present,
setup.sh:139-143), `masters.ip`/`hosts.ip` (terraform local-exec,
terraform/master/main.tf:29-31), the Ansible inventory/vars
(setup.sh:116-137), and `kubernetes_environment.id`
(ranchermaster/tasks/main.yml:51-52). This module centralises the same
contract so every phase — and the teardown scrub (cleanRunner,
setup.sh:509-513) — agrees on what lives where.

The port's copy of `tritonk8ssupervisor_tpu/provision/state.py`, whole and
under the reference's names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path


def atomic_write_text(path: Path, text: str) -> None:
    """Write via a same-directory temp file + os.replace so readers only
    ever see the old or the new content, never a torn half-write — the
    contract every polled state file here needs (hosts.json is read by
    heal/teardown, the drain file by training loops mid-step). The temp
    name carries pid AND thread id: the supervisor's parallel slice
    heals write hosts.json/quarantine from worker threads of ONE
    process, and a shared temp name would let two writers replace each
    other's half-written file."""
    import threading

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    )
    tmp.write_text(text)
    os.replace(tmp, path)


class LockHeldError(RuntimeError):
    """Another LIVE process holds the pid lockfile. Carries the holder's
    pid so callers can name it (or, for teardown, signal it)."""

    def __init__(self, path: Path, pid: int) -> None:
        super().__init__(f"{path} is held by live pid {pid}")
        self.path = Path(path)
        self.pid = pid


class PidLock:
    """Single-writer pid lockfile: O_CREAT|O_EXCL with the owner's pid
    inside. A LIVE pid in an existing lockfile means a second writer is
    running — acquire raises LockHeldError; a dead pid is the residue of
    a crash and the lock is stolen (exactly the case crash-resume exists
    for). Shared by the provisioning journal (provision/journal.py) and
    the supervisor's event ledger (provision/events.py): both are
    append-only files whose integrity two interleaved writers would
    destroy."""

    def __init__(
        self,
        path: Path,
        echo=lambda line: None,
    ) -> None:
        self.path = Path(path)
        self._echo = echo
        self._locked = False

    def holder(self) -> int | None:
        """Pid in the lockfile when that process is still alive, else None
        (stale lock or unreadable file — both safe to steal)."""
        try:
            pid = int(self.path.read_text().strip())
        except (OSError, ValueError):
            return None
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return None
        except PermissionError:
            return pid  # alive, just not ours to signal
        return pid

    def acquire(self) -> "PidLock":
        self.path.parent.mkdir(parents=True, exist_ok=True)
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                pid = self.holder()
                if pid is not None:
                    raise LockHeldError(self.path, pid)
                self._echo(
                    f"stale lock {self.path} (holder dead); taking over"
                )
                self.path.unlink(missing_ok=True)
                continue
            os.write(fd, f"{os.getpid()}\n".encode())
            os.close(fd)
            self._locked = True
            return self

    def release(self) -> None:
        if self._locked:
            self.path.unlink(missing_ok=True)
            self._locked = False

    def __enter__(self) -> "PidLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


@dataclasses.dataclass(frozen=True)
class RunPaths:
    """All paths the pipeline reads/writes, rooted at the repo checkout."""

    root: Path

    @property
    def config_file(self) -> Path:
        # the reference `config` file (setup.sh:199-208)
        return self.root / "config"

    @property
    def terraform_dir(self) -> Path:
        return self.root / "terraform"

    def terraform_module(self, mode: str) -> Path:
        # static module dirs (no generated rancher.tf analogue)
        return self.terraform_dir / mode

    def tfvars(self, mode: str) -> Path:
        return self.terraform_module(mode) / "terraform.tfvars.json"

    def tfstate(self, mode: str) -> Path:
        return self.terraform_module(mode) / "terraform.tfstate"

    @property
    def hosts_file(self) -> Path:
        # masters.ip / hosts.ip analogue, one JSON file instead of two
        return self.terraform_dir / "hosts.json"

    @property
    def ansible_dir(self) -> Path:
        return self.root / "ansible"

    @property
    def inventory(self) -> Path:
        return self.ansible_dir / "hosts"

    @property
    def ansible_cfg(self) -> Path:
        return self.ansible_dir / "ansible.cfg"

    @property
    def manifests_dir(self) -> Path:
        return self.root / "manifests" / "generated"

    @property
    def probe_dir(self) -> Path:
        # separate from manifests_dir: users `kubectl apply -f` the whole
        # generated dir, and the probe Job must not ride along
        return self.root / "manifests" / "probe"

    @property
    def runlog(self) -> Path:
        return self.root / "runlog.jsonl"

    @property
    def journal(self) -> Path:
        # the durable provisioning ledger (provision/journal.py) — crash
        # resume and teardown both key off it, so it lives at the root
        # next to `config`, not under any one phase's directory
        return self.root / "provision-journal.jsonl"

    @property
    def warm_cache(self) -> Path:
        # the content-addressed converge cache (provision/cache.py) —
        # shared by provision, heal, and crash-resume, so it lives at
        # the root next to the journal
        return self.root / "provision-cache.json"

    @property
    def quarantine_file(self) -> Path:
        # hosts/slices pulled from service by heal (provision/heal.py)
        return self.terraform_dir / "quarantine.json"

    @property
    def events(self) -> Path:
        # the supervisor's durable event ledger (provision/events.py):
        # every observation / verdict / heal attempt / breaker transition,
        # replayed on restart so a killed supervisor resumes its rate
        # limiter and breaker state instead of forgetting them
        return self.root / "supervisor-events.jsonl"

    @property
    def fleet_status(self) -> Path:
        # atomically rewritten machine-readable status document for
        # external scrapers (./setup.sh status reads it too)
        return self.root / "fleet-status.json"

    @property
    def job_ack(self) -> Path:
        # the training job's half of the membership contract
        # (parallel/elastic.py JobAck): atomically rewritten by the
        # trainer on notify/resume/degraded-continuation; the supervisor
        # folds phase transitions into the event ledger (job-notified /
        # job-resumed / degraded-ack) for MTTR attribution
        return self.root / "job-ack.json"

    @property
    def request_log(self) -> Path:
        # the serving gateway's durable request journal
        # (serving/reqlog.py): ACCEPTED/DISPATCHED/COMPLETED/EXPIRED/SHED
        # per idempotency key, replayed on gateway restart so accepted
        # work is re-admitted and completed keys answer duplicates from
        # the recorded result instead of regenerating
        return self.root / "serve-requests.jsonl"

    @property
    def demand_signal(self) -> Path:
        # the serving gateway's atomically rewritten demand signal
        # (provision/autoscale.py): queue depth, observed completion
        # rate, recent p99/sheds, per-slice in-flight — what the
        # supervisor's autoscaler folds into a desired slice count.
        # Torn-read tolerant like fleet-status.json; scrubbed by
        # teardown with the other contract files
        return self.root / "demand-signal.json"

    # ---- gateway-fleet artifacts (serving/fleet.py): each replica
    # owns a key-partition, its OWN request journal shard, and its own
    # demand signal; the merged views are folds over the globs below.
    # The glob patterns deliberately require the "-<replica>" suffix,
    # so the single-gateway files above are separate artifacts — the
    # plural helpers return base + shards together for teardown and
    # the fleet-wide folds.

    def request_log_replica(self, replica) -> Path:
        return self.root / f"serve-requests-{replica}.jsonl"

    def demand_signal_replica(self, replica) -> Path:
        return self.root / f"demand-signal-{replica}.json"

    def request_logs(self) -> list:
        """Every request journal on disk: the single-gateway file (when
        present) plus the fleet's per-replica shards, sorted."""
        out = [self.request_log] if self.request_log.exists() else []
        return out + sorted(self.root.glob("serve-requests-*.jsonl"))

    def demand_signals(self) -> list:
        """Every demand signal on disk: single-gateway + per-replica."""
        out = [self.demand_signal] if self.demand_signal.exists() else []
        return out + sorted(self.root.glob("demand-signal-*.json"))

    @property
    def span_log(self) -> Path:
        # the unified telemetry plane's span ledger (obs/trace.py):
        # request-keyed serving spans (admission -> queue-wait ->
        # prefill -> decode -> terminal) and supervisor spans (tick,
        # diagnose, heal waves, breaker transitions) in one fsync'd
        # torn-line-truncating JSONL — `./setup.sh trace <key>` and
        # `analyze --correlate` fold it (docs/observability.md)
        return self.root / "telemetry-spans.jsonl"

    @property
    def metrics_snapshot(self) -> Path:
        # the metrics registry's atomic JSON snapshot (obs/metrics.py):
        # rewritten by the supervisor every tick (and by serve drills at
        # exit) next to fleet-status.json; `./setup.sh status --json`
        # surfaces it in the telemetry block
        return self.root / "metrics.json"

    @property
    def supervisor_pid(self) -> Path:
        # the running supervisor's pid lockfile — one resident reconcile
        # loop per workdir, and what teardown signals to stop it
        return self.root / "supervisor.pid"


@dataclasses.dataclass
class ClusterHosts:
    """Provisioned endpoints — what terraform's local-exec used to append to
    masters.ip/hosts.ip (terraform/master/main.tf:29-31)."""

    # per-slice list of worker host external IPs (SSH/inventory addressing)
    host_ips: list  # list[list[str]]
    coordinator_ip: str = ""  # first host of slice 0 (the "master" analogue)
    gke_endpoint: str = ""  # gke mode: cluster control-plane endpoint
    # per-slice list of worker host VPC-internal IPs: the JAX coordinator
    # address source — worker->coordinator traffic must ride the VPC, not
    # external NAT (default firewall rules block inbound NAT dial-in)
    internal_ips: list = dataclasses.field(default_factory=list)

    @property
    def flat_ips(self) -> list[str]:
        return [ip for slice_ips in self.host_ips for ip in slice_ips]

    def save(self, path: Path) -> None:
        # atomic: hosts.json is the terraform→ansible phase contract AND
        # what heal rewrites on a live deployment — a reader racing the
        # write must never see a truncated record
        atomic_write_text(
            path, json.dumps(dataclasses.asdict(self), indent=2) + "\n"
        )

    @classmethod
    def load(cls, path: Path) -> "ClusterHosts":
        """Tolerant load: unknown keys are dropped (a newer supervisor's
        hosts.json must stay readable — forward compat), and a truncated
        or stale-schema file raises MissingStateError with a repair hint
        instead of a raw JSONDecodeError/TypeError traceback."""
        try:
            raw = json.loads(Path(path).read_text())
            if not isinstance(raw, dict):
                raise TypeError(f"expected a JSON object, got {type(raw).__name__}")
            known = {f.name for f in dataclasses.fields(cls)}
            hosts = cls(**{k: v for k, v in raw.items() if k in known})
        except (json.JSONDecodeError, TypeError, ValueError, OSError) as e:
            raise MissingStateError(
                f"{path} is unreadable or stale ({e}) — the hosts record "
                "is the terraform→ansible phase contract; re-run "
                "./setup.sh to converge, or ./setup.sh heal to repair it"
            ) from e
        if not isinstance(hosts.host_ips, list):
            raise MissingStateError(
                f"{path} has a stale schema (host_ips is "
                f"{type(hosts.host_ips).__name__}, expected per-slice "
                "lists) — re-run provision or ./setup.sh heal"
            )
        return hosts


class MissingStateError(RuntimeError):
    """A phase's input file is absent or unreadable — the analogue of the
    reference's missing-ip-file abort (setup.sh:117-120), extended to
    truncated/stale records (a torn write is a missing record, not a
    traceback)."""


def load_hosts(paths: RunPaths) -> ClusterHosts:
    if not paths.hosts_file.exists():
        raise MissingStateError(
            f"{paths.hosts_file} missing — terraform did not record any "
            "hosts; the apply likely failed (check quota / API errors) "
        )
    return ClusterHosts.load(paths.hosts_file)
