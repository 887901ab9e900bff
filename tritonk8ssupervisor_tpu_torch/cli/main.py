"""The port's command line: the counterpart of
`tritonk8ssupervisor_tpu/cli/main.py`, the pipeline orchestrator
(reference setup.sh:8-92) and the commands beside it.

    python -m tritonk8ssupervisor_tpu_torch.cli.main [--workdir W] [--config F] [--yes] \
        [--accelerator tpu|gpu] [--skip-readiness] [--readiness-timeout S] [--fault-plan PLAN] [--probe] \
        [--probe-image IMAGE] [--bench-image IMAGE] [--checkpoint-dir DIR] \
        [--bench-workload resnet50|vit|lm|decode] [--bench-flags FLAGS] \
        [--workload-image IMAGE [--workload-command CMD] [--workload-name NAME]] \
        [--resize N] [--independent-slices] [--show-config]
    python -m tritonk8ssupervisor_tpu_torch.cli.main train --checkpoint-dir DIR \
        [--workdir W] [--steps N] [--checkpoint-every N] [--status-file F] \
        [--ack-file F] [--env-file F] [--max-wait S] [--max-degraded N] \
        [--train-report F] [--device cuda|cpu] [--backend nccl|gloo] [--yes]
    python -m tritonk8ssupervisor_tpu_torch.cli.main serve [--drill N] [--port P] \
        [--workdir W] [--slots N] [--prefill-chunk T] [--tenant-weights T=W,...] \
        [--queue-budget N] [--serve-report F] [--deadline S] [--allow-no-fleet-view] \
        [--kv-page-size T] [--kv-pages N] [--no-prefix-cache] [--draft-model tiny|none] \
        [--spec-k K] [--no-spec] [--status-file F] [--device cuda|cpu]
    python -m tritonk8ssupervisor_tpu_torch.cli.main status [--json] [--all] [--workdir W]
    python -m tritonk8ssupervisor_tpu_torch.cli.main trace KEY [--json] [--workdir W]
    python -m tritonk8ssupervisor_tpu_torch.cli.main analyze [--correlate] [--window S] \
        [--json] [--workdir W]
    python -m tritonk8ssupervisor_tpu_torch.cli.main heal [--config F] [--max-degraded N] \
        [--readiness-timeout S] [--fault-plan PLAN] [--workdir W]
    python -m tritonk8ssupervisor_tpu_torch.cli.main supervise [--ticks N] [--interval S] \
        [--flap-threshold N] [--heal-burst N] [--heal-refill S] [--breaker-threshold K] \
        [--breaker-window S] [--breaker-cooldown S] [--page-size N] [--sweep-slices N] \
        [--heal-workers N] [--domain-threshold K] [--domain-window S] \
        [--domain-cooldown S] [--quota-defer-cap S] [--compact-records N] \
        [--autoscale [--min-slices N] [--max-slices N]] \
        [--allocate [--train-slices N] [--min-serving N]] [--max-degraded N] \
        [--config F] [--readiness-timeout S] [--fault-plan PLAN] [--workdir W]
    python -m tritonk8ssupervisor_tpu_torch.cli.main -c [--yes] [--fault-plan PLAN] \
        [--workdir W]

`train` is the elastic-training drill (the reference's `train_cmd`): a
small causal LM driven by `parallel/elastic.ElasticTrainer` through the
port's `make_lm_train_step`, watching the workdir's `fleet-status.json`
and acknowledging membership changes through `job-ack.json`. Run it on a
provisioned deployment (each host has the cluster env) or locally against
a supervisor, or a test, rewriting the status file. It runs on the card
unless `--device cpu` asks for the host, and raises without a card
otherwise. The process group is NCCL on the card and gloo on the CPU;
`--backend gloo` on the card lets two processes share one card, which
NCCL refuses.

`serve` is the reference's `serve_cmd`: the continuous-batching gateway
(`serving/gateway.py`) over the port's `SlotEngine`, routed by the
workdir's `fleet-status.json`, journaling every request to
`serve-requests.jsonl` and its spans to `telemetry-spans.jsonl`. It
recovers the journal first (incomplete work re-admitted, completed keys
answerable). `--drill N` sends N seeded requests with no network, prints
the report and exits 0 when every request completed; without it, it
listens on 127.0.0.1:`--port` (POST /generate, GET /healthz, GET
/metrics). The model is the reference's drill model, randomly
initialised from fixed seeds; it runs on the card unless `--device cpu`.

`status` is the reference's `status_cmd`: it prints the workdir's
`fleet-status.json`, or, when that is missing or `--all` asks for every
slice, the fold of the event ledger (`supervisor-events.jsonl`), with the
`gateway_fleet` block of a gateway fleet's leases (`serving/fleet.py`).
It exits 0 when the fleet is healthy and 2 otherwise; it needs no card.

`trace KEY` and `analyze` are the reference's `trace_cmd` and
`analyze_cmd`, the cross-plane analyzers of `obs/analyze.py` over the
workdir's span log, request journal and event ledger. `trace` prints one
request's timeline and exits 0 when its terminal accounting is complete,
2 when it has gaps; `analyze` counts the spans by kind and, with
`--correlate`, attributes latency-spike windows to overlapping fleet
events. A workdir with no telemetry exits 1. Neither needs a card.

`heal` is the reference's `heal_cmd`: slice-granular repair of an
existing deployment (`provision/heal.py`) from the workdir's saved
`config` (or `--config`). It diagnoses each slice (missing, unready,
draining), quarantines the bad ones, re-creates only them (`terraform
apply -replace=`), reconverges ansible with `--limit`, polls their
readiness and rewrites `hosts.json`; `--max-degraded N` lets it succeed
with up to N slices left degraded. It drives `terraform`,
`ansible-playbook`, `ssh` and `gcloud` through the retrying runners and
needs no card. A missing config exits 1.

`supervise` is the reference's `supervise_cmd`: the resident reconcile
loop (`provision/supervisor.py`) over the same deployment. Each tick it
diagnoses the fleet and heals confirmed losses through the slice-scoped
heal path, behind the flap filter, the per-slice heal rate limiter and
the circuit breakers; every observation lands in the event ledger and
`fleet-status.json` is rewritten every tick. It runs until SIGTERM (or
`--ticks N`) and holds the workdir's pid lock, so a second instance exits
1. `--autoscale` and `--allocate` add the autoscaler and the train/serve
allocator. The `TK8S_SUPERVISE_*` env knobs set the policy; a flag
overrides its knob. It needs no card.

With no command, `main` provisions (the reference's `provision`): the
previous-run guard, environment discovery, the wizard (`cli/wizard.py`;
`--config F` loads a file instead), the verification gate (`--yes` skips
it), the saved config, then the provisioning phases as a dependency DAG
(`provision/scheduler.py`, `TK8S_SCHED_WORKERS` wide, 8 by default):
terraform apply, the manifest compile (the benchmark Job runs the port's
module: `--bench-workload`, `--bench-flags`), and per mode the host
configuration (ansible), the readiness wait and, with `--probe`, the
probe Job. Every task transition is fsync'd to the journal, so a rerun
resumes the dirty suffix, and a fully green run compacts it; the warm
cache makes an unchanged compile and converge no-ops. `--resize N`
reconverges a saved deployment at N slices; `--show-config` prints the
resolved configuration and provisions nothing. It drives `gcloud`,
`terraform`, `ansible-playbook`, `ssh` and `kubectl`, and needs no card.
`--accelerator gpu` makes the wizard ask for an H100 deployment: `gke-gpu`
(a GKE cluster with A3 node pools; its Jobs launch the port under `python
-m torch.distributed.run`) or `gpu-vm` (standalone A3 VMs configured by
the GPU playbook); a saved GPU config resumes without the flag. `heal`
and `supervise` repair and watch a gpu-vm deployment as they do a tpu-vm
one, a slice being its host VMs, and refuse gke-gpu as they refuse gke:
its node pools self-repair.

`-c`/`--clean` is the reference's `clean`: teardown
(`provision/teardown.py`). It lists what it will destroy, asks (unless
`--yes`), stops a running supervisor, destroys every mode that holds
terraform state, scrubs known_hosts and every generated file, and
removes the ledgers last. With no config it still destroys from orphaned
terraform state; with neither it says so and exits 0.

An interrupt exits 130 with the reference's resume hint; the errors of
the provisioning plane exit 1 with `ERROR:` on stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shlex
import signal
import sys
import time
from pathlib import Path

import yaml

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.cli import discovery, wizard
from tritonk8ssupervisor_tpu_torch.cli.io import EndOfInput, Prompter
from tritonk8ssupervisor_tpu_torch.config import compile as compiler
from tritonk8ssupervisor_tpu_torch.config import store
from tritonk8ssupervisor_tpu_torch.config.schema import VM_MODES, ClusterConfig, ConfigError
from tritonk8ssupervisor_tpu_torch.provision import ansible as ansible_mod
from tritonk8ssupervisor_tpu_torch.provision import cache as cache_mod
from tritonk8ssupervisor_tpu_torch.provision import heal as heal_mod
from tritonk8ssupervisor_tpu_torch.provision import journal as journal_mod
from tritonk8ssupervisor_tpu_torch.provision import readiness, retry
from tritonk8ssupervisor_tpu_torch.provision import runner as run_mod
from tritonk8ssupervisor_tpu_torch.provision import state
from tritonk8ssupervisor_tpu_torch.provision import supervisor as supervisor_mod
from tritonk8ssupervisor_tpu_torch.provision import teardown
from tritonk8ssupervisor_tpu_torch.provision import terraform as terraform_mod
from tritonk8ssupervisor_tpu_torch.provision.events import EventLedgerError
from tritonk8ssupervisor_tpu_torch.provision.scheduler import Task, run_dag
from tritonk8ssupervisor_tpu_torch.testing import faults
from tritonk8ssupervisor_tpu_torch.utils.phases import PhaseTimer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tritonk8ssupervisor_tpu_torch.cli.main",
        description="Provision a TPU-backed Kubernetes cluster on GCP (no command), "
        "or run one of the PyTorch port's commands.",
    )
    parser.add_argument(
        "command", nargs="?",
        choices=["heal", "supervise", "status", "train", "serve", "trace", "analyze"],
        metavar="command",
        help="`heal` diagnoses per-slice fleet health (missing / unready / "
        "draining) and repairs ONLY the broken slices — scoped terraform "
        "replace, ansible --limit, scoped readiness — leaving healthy "
        "slices untouched; `supervise` runs the resident reconcile loop "
        "(detect drift, rate-limited auto-heal, circuit breaker, durable "
        "event ledger); `train` runs the elastic-training drill: a small causal LM "
        "that survives membership changes by checkpoint, rejoin and restore; "
        "`serve` runs the inference gateway over the slot engine (HTTP, or "
        "a drill with --drill N); `status` prints the fleet status: "
        "fleet-status.json, or the event ledger's fold; `trace <key>` "
        "reconstructs one request's end-to-end timeline from the span log "
        "and request journal; `analyze` summarises the span log, and with "
        "--correlate joins supervisor ledger events with request spans to "
        "attribute latency spikes to fleet events",
    )
    parser.add_argument(
        "arg", nargs="?", default=None, metavar="key",
        help="trace: the request idempotency key to reconstruct",
    )
    parser.add_argument(
        "-c", "--clean", action="store_true", help="destroy the cluster and all state"
    )
    parser.add_argument(
        "--workdir", type=Path, default=Path.cwd(),
        help="repo root holding terraform/ and ansible/ (provision, heal, "
        "supervise, -c), and the supervisor's workdir, holding "
        "fleet-status.json, job-ack.json and the serving journal and spans "
        "(default: cwd)",
    )
    parser.add_argument(
        "--config", type=Path, default=None,
        help="load config from file instead of the interactive wizard; "
        "heal, supervise: the saved configuration to repair from (default: "
        "the workdir's config)",
    )
    parser.add_argument(
        "--fault-plan", default=None, metavar="PLAN",
        help="provision, heal, supervise, -c: deterministic fault-injection plan "
        "(inline JSON or a file path; also read from TK8S_FAULT_PLAN): fail "
        "the Nth child command matching a pattern with a chosen exit "
        "code/output/hang",
    )
    parser.add_argument(
        "--readiness-timeout", type=float, default=900.0, metavar="SECONDS",
        help="provision: how long to wait for the cluster's readiness; heal, "
        "supervise: for the repaired slices' (default 900)",
    )
    parser.add_argument(
        "--accelerator", choices=["tpu", "gpu"], default="tpu",
        help="provision: the wizard's accelerator, the reference's TPU "
        "catalog (default) or the H100 families (modes gke-gpu, gpu-vm); "
        "a saved or --config configuration keeps its own",
    )
    parser.add_argument(
        "--skip-readiness",
        action="store_true",
        help="do not wait for the cluster to become ready",
    )
    parser.add_argument(
        "--probe",
        action="store_true",
        help="gke mode: after readiness, run the TPU probe Job "
        "(workload-level JAX device acceptance test)",
    )
    parser.add_argument(
        "--probe-image",
        default=None,
        metavar="IMAGE",
        help="container image for the probe Job (default: plain python; "
        "the probe self-installs pinned jax[tpu])",
    )
    parser.add_argument(
        "--bench-image",
        default=os.environ.get("BENCH_IMAGE") or None,
        metavar="IMAGE",
        help="container image for the generated benchmark Job (default: "
        "plain python + self-install of the framework from a ConfigMap; "
        "build a custom image with the repo Dockerfile). Also read from "
        "the BENCH_IMAGE environment variable.",
    )
    parser.add_argument(
        "--bench-workload",
        choices=sorted(compiler.BENCH_WORKLOADS),
        default=os.environ.get("TK8S_BENCH_WORKLOAD") or "resnet50",
        help="benchmark family for the generated Job: resnet50 (the "
        "flagship), vit (transformer vision), lm (long-context "
        "Transformer — combine with --bench-flags for ring/MoE/pipeline "
        "parallelism), or decode (KV-cache serving throughput). Also "
        "read from TK8S_BENCH_WORKLOAD.",
    )
    parser.add_argument(
        "--bench-flags",
        default=os.environ.get("TK8S_BENCH_FLAGS") or "",
        metavar="FLAGS",
        help="extra flags appended to the benchmark Job's module "
        "invocation, shell-style (e.g. \"--sequence-parallelism 4\" or "
        "\"--moe-experts 8 --expert-parallelism 4\"). Also read from "
        "TK8S_BENCH_FLAGS.",
    )
    parser.add_argument(
        "--workload-image",
        default=None,
        metavar="IMAGE",
        help="also compile a bring-your-own workload Job per slice for "
        "this container image (same coordinator/topology wiring as the "
        "benchmark Job; docs/detailed.md section 2b)",
    )
    parser.add_argument(
        "--workload-command",
        default=None,
        metavar="CMD",
        help='command line for --workload-image, one shell-style string '
        '(e.g. "python train.py --steps 10000")',
    )
    parser.add_argument(
        "--workload-name",
        default="workload",
        metavar="NAME",
        help="Job/Service name prefix for --workload-image manifests",
    )
    parser.add_argument(
        "--resize",
        type=int,
        default=None,
        metavar="N",
        help="change the deployment to N slices and reconverge: terraform "
        "adds/removes slice node pools (or TPU VMs), ansible reconverges "
        "hosts, manifests recompile with the new cross-slice topology. "
        "Requires a previous run (the saved config is updated). With "
        "cross-slice training and --checkpoint-dir, the re-deployed "
        "workload resumes from the shared checkpoint at the new "
        "data-parallel width.",
    )
    parser.add_argument(
        "--independent-slices",
        action="store_true",
        help="with num_slices > 1, compile each slice's Jobs as an "
        "independent JAX cluster (the pre-r5 behavior) instead of the "
        "default single cross-slice training surface spanning all "
        "slices over DCN (docs/parallelism.md)",
    )
    parser.add_argument(
        "--show-config",
        action="store_true",
        help="print the resolved configuration and exit (no provisioning)",
    )
    parser.add_argument(
        "--checkpoint-dir", default=os.environ.get("TK8S_CHECKPOINT_DIR") or None,
        metavar="DIR",
        help="train: the shared checkpoint the job resumes from at the new "
        "world size: a local path or a URL (gs://...); provision: the "
        "checkpoint directory for the generated benchmark Job — use a "
        "gs:// bucket so checkpoints survive pod restarts (cross-slice "
        "training shares DIR; with --independent-slices each slice "
        "writes DIR/slice-N). Also read from TK8S_CHECKPOINT_DIR.",
    )
    parser.add_argument(
        "--steps", type=int, default=200, metavar="N",
        help="train: total optimizer steps for the elastic drill (default 200)",
    )
    parser.add_argument(
        "--checkpoint-every", type=int, default=25, metavar="N",
        help="train: steps between durable checkpoints, the bound on work "
        "lost to an unplanned membership change (default 25)",
    )
    parser.add_argument(
        "--status-file", type=Path, default=None, metavar="FILE",
        help="train, serve: fleet-status.json to watch (default: the "
        "workdir's; a missing or mid-rewrite file reads as unknown, never "
        "healthy)",
    )
    parser.add_argument(
        "--ack-file", type=Path, default=None, metavar="FILE",
        help="train: job-ack.json to write membership acknowledgements to "
        "(default: the workdir's)",
    )
    parser.add_argument(
        "--env-file", type=Path, default=None, metavar="FILE",
        help="train: cluster env file re-read on every rejoin (rewritten "
        "with the new process set after a heal; default: the standard "
        "location)",
    )
    parser.add_argument(
        "--max-wait", type=float, default=600.0, metavar="SECONDS",
        help="train: bounded wait for the supervisor's heal before declaring "
        "degraded continuation (default 600)",
    )
    parser.add_argument(
        "--max-degraded", type=int, default=0, metavar="N",
        help="heal, supervise: tolerate up to N slices that stay broken after "
        "repair — they are quarantined (terraform/quarantine.json) and "
        "emptied from hosts.json, and heal succeeds on the remaining "
        "healthy slices instead of aborting (N-of-M semantics); train: "
        "slices the job will continue without (default 0)",
    )
    parser.add_argument(
        "--train-report", type=Path, default=None, metavar="FILE",
        help="train: also write the run report (resumes, steps lost, world "
        "size) as JSON to FILE",
    )
    parser.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="train, serve: where to run (default: the CUDA card; `cpu` asks "
        "for the host)",
    )
    parser.add_argument(
        "--backend", choices=["nccl", "gloo"], default=None,
        help="train: the process group's backend (default: NCCL on the card, "
        "gloo on the CPU)",
    )
    parser.add_argument("--yes", action="store_true", help="skip confirmation gates (CI use)")
    parser.add_argument(
        "--json", action="store_true",
        help="status, trace, analyze: print the raw JSON document instead "
        "of the human summary",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="status: include EVERY slice in the per-slice detail "
        "(folded from the event ledger) — the default document stays "
        "bounded at fleet scale: per-state counts plus only the "
        "not-healthy slices",
    )
    # ---------------------------------------------------------- supervise
    # Defaults of None mean "take the SupervisePolicy default (or its
    # TK8S_SUPERVISE_* env override)"; an explicit flag always wins.
    parser.add_argument(
        "--interval", type=float, default=None, metavar="SECONDS",
        help="supervise: seconds between reconcile ticks (default 30; "
        "env TK8S_SUPERVISE_INTERVAL)",
    )
    parser.add_argument(
        "--ticks", type=int, default=0, metavar="N",
        help="supervise: run exactly N reconcile ticks then exit "
        "(default 0 = run until SIGTERM/SIGINT; teardown stops a "
        "running supervisor via its pid lockfile)",
    )
    parser.add_argument(
        "--flap-threshold", type=int, default=None, metavar="N",
        help="supervise: consecutive unhealthy snapshots before a slice "
        "is heal-eligible (default 2 — one transient SSH blip or stale "
        "snapshot never triggers a terraform replace)",
    )
    parser.add_argument(
        "--heal-burst", type=int, default=None, metavar="N",
        help="supervise: per-slice heal token-bucket capacity "
        "(default 2)",
    )
    parser.add_argument(
        "--heal-refill", type=float, default=None, metavar="SECONDS",
        help="supervise: seconds to mint one heal token per slice "
        "(default 600)",
    )
    parser.add_argument(
        "--breaker-threshold", type=int, default=None, metavar="K",
        help="supervise: failed heals within --breaker-window that trip "
        "the global circuit breaker to degraded-hold (default 3)",
    )
    parser.add_argument(
        "--breaker-window", type=float, default=None, metavar="SECONDS",
        help="supervise: sliding window for breaker failures "
        "(default 1800)",
    )
    parser.add_argument(
        "--breaker-cooldown", type=float, default=None, metavar="SECONDS",
        help="supervise: base breaker cooldown before a half-open probe "
        "heal; grows between consecutive trips with the retry engine's "
        "decorrelated jitter (default 300)",
    )
    parser.add_argument(
        "--page-size", type=int, default=None, metavar="N",
        help="supervise: slices per fleet-listing page (default 64 — "
        "sized so one page is one `tpu-vm list` call; a 256-slice fleet "
        "is fetched as bounded pages with per-page TTLs and the retry "
        "classifier's 429 backoff floor instead of one giant ask; "
        "env TK8S_SUPERVISE_PAGE_SIZE)",
    )
    parser.add_argument(
        "--sweep-slices", type=int, default=None, metavar="N",
        help="supervise: slices re-diagnosed per tick beyond the dirty "
        "set (default 4) — the slow full-sweep rotation that bounds how "
        "long listing-invisible drift can hide to "
        "ceil(num_slices/N) ticks (env TK8S_SUPERVISE_SWEEP)",
    )
    parser.add_argument(
        "--heal-workers", type=int, default=None, metavar="N",
        help="supervise: parallel slice-scoped heals per wave (default "
        "8; 1 restores the serial combined heal order) — a zone outage "
        "killing K slices converges in ceil(K/N) heal times "
        "(env TK8S_SUPERVISE_HEAL_WORKERS)",
    )
    parser.add_argument(
        "--domain-threshold", type=int, default=None, metavar="K",
        help="supervise: K slices of one failure domain lost within "
        "--domain-window is classified a DOMAIN_OUTAGE — heals into "
        "that domain are held behind its per-domain breaker and "
        "re-entry is gated by ONE canary heal, while healthy domains "
        "keep healing (default 3; 0 disables the classifier; domains "
        "come from the config's FAILURE_DOMAINS striping; "
        "env TK8S_SUPERVISE_DOMAIN_THRESHOLD)",
    )
    parser.add_argument(
        "--domain-window", type=float, default=None, metavar="SECONDS",
        help="supervise: incident-start span that counts as one "
        "correlated domain failure (default 300; "
        "env TK8S_SUPERVISE_DOMAIN_WINDOW)",
    )
    parser.add_argument(
        "--domain-cooldown", type=float, default=None, metavar="SECONDS",
        help="supervise: base hold before the canary heal re-enters an "
        "outaged domain; grows between re-trips (default 300; "
        "env TK8S_SUPERVISE_DOMAIN_COOLDOWN)",
    )
    parser.add_argument(
        "--quota-defer-cap", type=float, default=None, metavar="SECONDS",
        help="supervise: longest a heal is deferred because its "
        "fleet-listing page is quota-parked (429 backoff floor) — past "
        "this incident age the repair outweighs the API pressure "
        "(default 900; env TK8S_SUPERVISE_QUOTA_DEFER_CAP)",
    )
    parser.add_argument(
        "--compact-records", type=int, default=None, metavar="N",
        help="supervise: auto-compact the event ledger to one snapshot "
        "record once it holds N records (default 20000; 0 disables) — "
        "restart-resume state is preserved exactly "
        "(env TK8S_SUPERVISE_COMPACT)",
    )
    parser.add_argument(
        "--autoscale", action="store_true",
        help="supervise: enable the demand-driven autoscaler — fold "
        "the serving gateway's demand-signal.json into a desired slice "
        "count (hysteresis + cooldown + scale-thrash breaker; "
        "TK8S_AUTOSCALE_* env knobs) and execute it: scale-up through "
        "the warm incremental-provision path, scale-down via "
        "drain-then-teardown with the request journal proving no "
        "accepted request is lost",
    )
    parser.add_argument(
        "--min-slices", type=int, default=None, metavar="N",
        help="supervise --autoscale: never drain below N slices "
        "(default 1; env TK8S_AUTOSCALE_MIN_SLICES) — pin it when a "
        "workload needs a capacity floor regardless of demand",
    )
    parser.add_argument(
        "--max-slices", type=int, default=None, metavar="N",
        help="supervise --autoscale: never provision past N slices "
        "(default: the config's num_slices envelope; "
        "env TK8S_AUTOSCALE_MAX_SLICES) — pin it to cap spend",
    )
    parser.add_argument(
        "--allocate", action="store_true",
        help="supervise: enable train/serve co-scheduling — the third "
        "controller folds the gateway's demand signal into per-slice "
        "roles (SERVING / TRAINING / TRANSITIONING): idle troughs lend "
        "slices to elastic training, a queue surge preempts them back "
        "through the ledger-recorded PREEMPT_NOTICE -> job-ack -> "
        "ROLE_CHANGED protocol (TK8S_ALLOC_* env knobs)",
    )
    parser.add_argument(
        "--train-slices", type=int, default=None, metavar="N",
        help="supervise --allocate: the N highest-index slices start "
        "as the training world (default 0 — training only gets what "
        "idle troughs lend it; env TK8S_ALLOC_TRAIN_SLICES)",
    )
    parser.add_argument(
        "--min-serving", type=int, default=None, metavar="N",
        help="supervise --allocate: never lend serving below N slices "
        "(default 1; env TK8S_ALLOC_MIN_SERVING)",
    )
    # --------------------------------------------------- trace / analyze
    parser.add_argument(
        "--correlate", action="store_true",
        help="analyze: join the supervisor's event ledger with the "
        "request spans and attribute latency-spike windows to fleet "
        "events (heal waves, breaker holds, domain outages)",
    )
    parser.add_argument(
        "--window", type=float, default=60.0, metavar="SECONDS",
        help="analyze --correlate: latency-window width for spike "
        "detection (default 60)",
    )
    # ----------------------------------------------------- serving gateway
    parser.add_argument(
        "--port", type=int, default=8777, metavar="PORT",
        help="serve: HTTP port for the gateway (default 8777; POST /generate, "
        "GET /healthz, GET /metrics)",
    )
    parser.add_argument(
        "--slots", type=int, default=8, metavar="N",
        help="serve: continuous-batching decode slots per engine (default 8)",
    )
    parser.add_argument(
        "--prefill-chunk", type=int, default=32, metavar="TOKENS",
        help="serve: prompt tokens advanced per step boundary (default 32)",
    )
    parser.add_argument(
        "--tenant-weights", type=str, default="", metavar="T=W,...",
        help="serve: per-tenant WFQ weights, e.g. 'interactive=3,batch=1'; "
        "empty = one homogeneous stream",
    )
    parser.add_argument(
        "--queue-budget", type=int, default=64, metavar="N",
        help="serve: queued requests before the gateway sheds with a "
        "429-style retry-after (default 64)",
    )
    parser.add_argument(
        "--drill", type=int, default=0, metavar="N",
        help="serve: run N seeded requests through the gateway and engine and "
        "print a JSON report instead of listening on --port",
    )
    parser.add_argument(
        "--serve-report", type=Path, default=None, metavar="FILE",
        help="serve --drill: also write the JSON report to FILE",
    )
    parser.add_argument(
        "--deadline", type=float, default=None, metavar="S",
        help="serve: default per-request deadline in seconds (past it the "
        "request settles as a 504-class expiry)",
    )
    parser.add_argument(
        "--allow-no-fleet-view", action="store_true",
        help="serve: admit traffic even before fleet-status.json has ever "
        "been read (default: shed no-fleet-view 429s on cold start)",
    )
    parser.add_argument(
        "--kv-page-size", type=int, default=16, metavar="TOKENS",
        help="serve: KV-cache page size in tokens (default 16)",
    )
    parser.add_argument(
        "--kv-pages", type=int, default=0, metavar="N",
        help="serve: total KV pages in the engine's pool (0 = memory-equal to "
        "the dense cache: slots * ceil(max_len / page_size))",
    )
    parser.add_argument(
        "--no-prefix-cache", action="store_true",
        help="serve: disable cross-request prefix/KV reuse",
    )
    parser.add_argument(
        "--draft-model", type=str, default="tiny", choices=("tiny", "none"),
        help="serve: drafter for speculative decoding ('none' disables, same "
        "as --no-spec)",
    )
    parser.add_argument(
        "--spec-k", type=int, default=4, metavar="K",
        help="serve: drafter tokens proposed per speculative round (default "
        "4; 0 disables)",
    )
    parser.add_argument(
        "--no-spec", action="store_true",
        help="serve: disable speculative decoding",
    )
    return parser


def train_cmd(args, say=print) -> int:
    """The elastic-training drill. Every process builds step i's tokens
    from `np.random.default_rng(i)` and trains on its shard of them, so a
    resume is reproducible across worlds. The first join uses the
    inherited process environment; every rejoin re-reads `--env-file`,
    which the provisioning layer rewrote with the new process set. A
    world of one trains without a process group or mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.parallel import elastic as elastic_mod
    from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
    from tritonk8ssupervisor_tpu_torch.parallel import train as train_lib
    from tritonk8ssupervisor_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from tritonk8ssupervisor_tpu_torch.provision.state import atomic_write_text
    from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

    if not args.checkpoint_dir:
        raise ConfigError(
            "the elastic train drill needs --checkpoint-dir (or TK8S_CHECKPOINT_DIR): "
            "resume at the new world size IS the drill, and it resumes from the "
            "shared checkpoint"
        )
    device = resolve_device(args.device)
    batch, seq, vocab = 8, 16, 64
    trainer = None

    def setup() -> elastic_mod.TrainSession:
        mesh = None
        if dist.is_initialized():
            # the slice count of the world just joined, not of the process
            # environment, which still describes the first world
            world = trainer.world
            mesh = mesh_lib.make_workload_mesh(
                device_type=device.type, num_slices=world.num_slices if world else 1)
        model = TransformerLM(
            vocab_size=vocab, num_layers=1, num_heads=2, embed_dim=32, max_seq_len=seq,
            dtype=torch.float32, logits_dtype=torch.float32,
            generator=torch.Generator().manual_seed(0),
        )
        state = train_lib.create_train_state(
            model, train_lib.default_optimizer(learning_rate=0.05), device, mesh=mesh)
        step = train_lib.make_lm_train_step(state)
        return elastic_mod.TrainSession(state, None, elastic_mod.state_step_fn(step), mesh)

    def batch_fn(session, step_index: int) -> tuple:
        # the same global batch in every process, whatever the world
        fill = np.random.default_rng(step_index).integers(0, vocab, (batch, seq))
        tokens = torch.from_numpy(fill.astype(np.int32))
        if session.mesh is not None:
            tokens = batch_shard(session.mesh, tokens)
        return (tokens.to(device),)

    def join(env_file=None):
        return elastic_mod.default_initialize(env_file, device=device, backend=args.backend)

    env_file = args.env_file
    trainer = elastic_mod.ElasticTrainer(
        setup,
        batch_fn,
        checkpoint=elastic_mod.ElasticCheckpoint(
            lambda: TrainCheckpointer(args.checkpoint_dir)),
        health=elastic_mod.FileHealthSource(
            args.status_file or args.workdir / "fleet-status.json"),
        policy=elastic_mod.ElasticPolicy(
            checkpoint_every=max(1, args.checkpoint_every),
            max_wait_s=args.max_wait,
            max_degraded=max(0, args.max_degraded),
        ),
        ack=elastic_mod.JobAck(args.ack_file or args.workdir / "job-ack.json"),
        init_fn=join,
        rejoin_fn=(lambda: join(env_file)) if env_file is not None else None,
        echo=say,
    )
    try:
        report = trainer.run(max(1, args.steps))
    finally:
        elastic_mod.default_shutdown()
    if args.train_report:
        atomic_write_text(args.train_report,
                          json.dumps(report, indent=2, sort_keys=True) + "\n")
    say(
        f"elastic train drill done: steps {report['start_step']} -> "
        f"{report['final_step']} at world size {report.get('world')}, "
        f"{len(report['resumes'])} membership resume(s), "
        f"{report['steps_lost']} step(s) lost, "
        f"{report['drain_flushes']} drain flush(es)"
    )
    return 0


def _parse_tenant_weights(raw: str) -> dict | None:
    """'interactive=3,batch=1' -> {'interactive': 3.0, 'batch': 1.0};
    empty/blank -> None (WFQ off). A malformed entry is a usage error,
    not a silently-dropped tenant."""
    raw = (raw or "").strip()
    if not raw:
        return None
    weights: dict = {}
    for part in raw.split(","):
        name, sep, value = part.partition("=")
        if not sep or not name.strip():
            raise SystemExit(
                f"--tenant-weights: expected TENANT=WEIGHT, got {part!r}"
            )
        try:
            weight = float(value)
        except ValueError:
            raise SystemExit(
                f"--tenant-weights: weight for {name.strip()!r} is not "
                f"a number: {value!r}"
            ) from None
        if weight <= 0:
            raise SystemExit(
                f"--tenant-weights: weight for {name.strip()!r} must "
                f"be positive, got {weight}"
            )
        weights[name.strip()] = weight
    return weights


def serve_cmd(args, say=print) -> int:
    """The continuous-batching gateway over the port's `SlotEngine`,
    routed by the workdir's fleet-status.json. The drill model is the
    reference's (vocab 256, 2 layers, 2 heads, embed 64, max seq 256, f32;
    the drafter 1 layer, embed 32), randomly initialised from fixed seeds:
    the machinery is the product, the weights are not."""
    import time

    import torch

    from tritonk8ssupervisor_tpu_torch import obs as obs_mod
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.models import decode as dec
    from tritonk8ssupervisor_tpu_torch.provision.fleetview import FileHealthSource
    from tritonk8ssupervisor_tpu_torch.serving import engine as engine_mod
    from tritonk8ssupervisor_tpu_torch.serving import gateway as gateway_mod
    from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod
    from tritonk8ssupervisor_tpu_torch.serving import server as server_mod

    device = resolve_device(args.device)
    paths = state.RunPaths(args.workdir)
    vocab, max_seq = 256, 256
    model = TransformerLM(
        vocab_size=vocab, num_layers=2, num_heads=2, embed_dim=64,
        max_seq_len=max_seq, dtype=torch.float32, logits_dtype=torch.float32,
        generator=torch.Generator().manual_seed(1),
    )
    params = dec.lm_params(model, device)
    # speculative decoding: a smaller drafter proposes --spec-k tokens a
    # round and the target verifies them in one forward with exact
    # accept/reject, so greedy serving stays token-identical to plain decode
    spec_on = (not args.no_spec and args.spec_k > 0
               and args.draft_model != "none")
    draft_model = draft_params = None
    if spec_on:
        draft_model = TransformerLM(
            vocab_size=vocab, num_layers=1, num_heads=2, embed_dim=32,
            max_seq_len=max_seq, dtype=torch.float32, logits_dtype=torch.float32,
            generator=torch.Generator().manual_seed(2),
        )
        draft_params = dec.lm_params(draft_model, device)
    policy = gateway_mod.GatewayPolicy(
        max_seq_len=max_seq,
        slots_per_slice=max(1, args.slots),
        prefill_chunk=max(1, args.prefill_chunk),
        queue_budget=max(1, args.queue_budget),
        bucket_bounds=(32, 64, 128, max_seq - 32),
        default_deadline_s=args.deadline,
        # a standalone drill has no fleet to take advice from; the HTTP
        # mode fronting a supervised workdir sheds no-fleet-view 429s
        # until the supervisor's first publish
        allow_no_view=bool(args.allow_no_fleet_view or args.drill > 0),
        page_size=max(1, args.kv_page_size),
        pages_per_slice=(args.kv_pages if args.kv_pages > 0 else None),
        prefix_cache=not args.no_prefix_cache,
        tenant_weights=_parse_tenant_weights(args.tenant_weights),
        spec_k=(args.spec_k if spec_on else 0),
    )
    # spans fsync'd to the workdir's span log, the registry scraped by GET
    # /metrics and snapshotted at drill exit; incarnation = pid, so a
    # restarted gateway's spans are told apart
    telemetry = obs_mod.Telemetry.for_run(
        paths, clock=time.monotonic, plane=obs_mod.SERVING,
        incarnation=os.getpid(), echo=say,
    )
    # one local engine: this process serves as slice 0 of whatever fleet
    # the status file describes
    eng = engine_mod.SlotEngine(
        model, params, slots=policy.slots_per_slice, max_len=max_seq,
        prefill_chunk=policy.prefill_chunk,
        page_size=policy.page_size,
        num_pages=policy.pages_per_slice,
        prefix_cache=policy.prefix_cache,
        tracer=telemetry.tracer, slice_index=0,
        draft_model=draft_model, draft_params=draft_params,
        spec_k=policy.spec_k,
    )
    if spec_on:
        say(f"[serve] speculative decoding ON: drafter '{args.draft_model}' "
            f"proposes k={policy.spec_k} tokens per round, exact accept/reject "
            "(--no-spec to disable)")
    gw = gateway_mod.Gateway(
        {0: eng},
        FileHealthSource(args.status_file or paths.fleet_status),
        policy=policy,
        echo=say,
        reqlog=reqlog_mod.RequestLog(paths.request_log, echo=say),
        telemetry=telemetry,
        demand_path=paths.demand_signal,
    )
    # crash-resume: incomplete work re-admitted front-of-queue, completed
    # keys answered from the recorded result
    gw.recover(time.monotonic())
    if args.drill > 0:
        report = server_mod.run_drill(gw, args.drill, vocab)
        doc = json.dumps(report, indent=2, sort_keys=True)
        say(doc)
        if args.serve_report:
            state.atomic_write_text(args.serve_report, doc + "\n")
        say(f"serve drill done: {report['completed']}/{report['submitted']} "
            f"completed, {report['tokens_generated']} tokens, p50 "
            f"{report['p50_latency_s']:.3f}s")
        spec = (report.get("engine") or {}).get("spec")
        if spec and spec.get("drafted"):
            say(f"speculative: k={spec['spec_k']}, acceptance "
                f"{spec['acceptance_rate']:.0%} ({spec['accepted']}/"
                f"{spec['drafted']} drafted accepted, "
                f"{spec['rolled_back']} rolled back)")
        return 0 if report["completed"] == report["submitted"] else 1
    return server_mod.serve_http(gw, "127.0.0.1", args.port, echo=say)


def status_cmd(args, say=print) -> int:
    """`status [--json] [--all]`, the reference's `status_cmd`: the
    machine-readable fleet status. Prefers the atomically rewritten
    fleet-status.json (cheap, what scrapers poll); falls back to folding
    the event ledger when the status file is missing (e.g. the supervisor
    died before its first publish), and `--all` always folds it, with
    every slice and the gateway fleet's lease block. Exit code 0 =
    healthy, 2 = degraded/holding."""
    import json as json_mod
    import time as time_mod

    from tritonk8ssupervisor_tpu_torch.obs import metrics as metrics_mod
    from tritonk8ssupervisor_tpu_torch.provision import events as events_mod

    paths = state.RunPaths(args.workdir)

    # Tolerant read: a missing OR unreadable status file is "unknown,
    # retry" — the atomic rewrite makes torn reads near-impossible, but
    # a half-copied file (rsync, scraper snapshot) must fall back to the
    # ledger fold, never crash or read as healthy.
    doc = None
    if paths.fleet_status.exists() and not args.all:
        try:
            doc = json_mod.loads(paths.fleet_status.read_text())
        except ValueError:
            say(
                f"NOTE: {paths.fleet_status} is unreadable (torn copy?); "
                "falling back to the event ledger"
            )
    if not isinstance(doc, dict):
        doc = None
    if doc is None and paths.events.exists():
        # --all re-folds the ledger: fleet-status.json is deliberately
        # BOUNDED (counts + not-healthy details), the full per-slice
        # dump only exists on demand
        ledger = events_mod.EventLedger(paths.events)
        doc = events_mod.fleet_status(
            events_mod.fold(ledger.replay()), time_mod.time(),
            all_slices=args.all,
        )
    if doc is None and args.all and paths.fleet_status.exists():
        # --all without a ledger: the bounded document is all there is
        try:
            doc = json_mod.loads(paths.fleet_status.read_text())
        except ValueError:
            doc = None
    if not isinstance(doc, dict):
        doc = None
    if doc is None:
        raise state.MissingStateError(
            f"no fleet status at {paths.fleet_status} and no event "
            f"ledger at {paths.events}: run the supervisor, or a gateway "
            "fleet, over this workdir first"
        )
    if "telemetry" not in doc:
        # a ledger fold (or a pre-telemetry status file) carries no
        # telemetry block; synthesize one from the on-disk artifacts so
        # `status --json` always answers "where do I scrape"
        last_tick = None
        if paths.metrics_snapshot.exists():
            try:
                snap = json_mod.loads(paths.metrics_snapshot.read_text())
                last_tick = metrics_mod.gauge_value(
                    snap, "supervisor_last_tick_seconds"
                )
            except ValueError:
                pass  # torn copy: the pointer is still worth printing
        try:
            span_bytes = paths.span_log.stat().st_size
        except OSError:
            span_bytes = None
        doc["telemetry"] = {
            "metrics_snapshot": (str(paths.metrics_snapshot)
                                 if paths.metrics_snapshot.exists()
                                 else None),
            "span_log": (str(paths.span_log)
                         if paths.span_log.exists() else None),
            "span_log_bytes": span_bytes,
            "last_tick_s": last_tick,
        }
    fleet_block = doc.get("gateway_fleet")
    if (isinstance(fleet_block, dict)
            and fleet_block.get("stalest_demand_age_s") is None):
        # a ledger fold (or a supervisor without a live demand fold)
        # leaves the staleness slot empty; fill it from the on-disk
        # shards' mtimes — wall clock, because mtimes are wall clock,
        # NOT the supervisor's monotonic timeline
        ages = []
        for shard in paths.demand_signals():
            try:
                ages.append(time_mod.time() - shard.stat().st_mtime)
            except OSError:
                continue  # scrubbed between glob and stat: not stale
        if ages:
            fleet_block["stalest_demand_age_s"] = round(max(0.0,
                                                            *ages), 3)
    if args.json:
        say(json_mod.dumps(doc, indent=2, sort_keys=True))
    else:
        sup = doc.get("supervisor", {})
        say(f"fleet: {doc.get('verdict', 'unknown')}")
        running = "running" if sup.get("running") else "stopped"
        uptime = sup.get("uptime_s")
        say(
            f"supervisor: {running}"
            + (f" (pid {sup.get('pid')}, up {uptime:.0f}s, "
               f"{sup.get('ticks', 0)} ticks)"
               if sup.get("running") and uptime is not None else "")
        )
        counts = doc.get("slice_states") or {}
        if counts:
            total = doc.get("slices_total", sum(counts.values()))
            summary = ", ".join(f"{n} {state}"
                                for state, n in sorted(counts.items()))
            say(f"slices: {summary} (of {total})")
        for index, entry in sorted(doc.get("slices", {}).items(),
                                   key=lambda kv: int(kv[0])):
            detail = f" ({entry['detail']})" if entry.get("detail") else ""
            say(f"  slice {index}: {entry.get('state')}{detail}")
        heals = doc.get("heals", {})
        say(
            f"heals: {heals.get('succeeded', 0)}/"
            f"{heals.get('attempted', 0)} succeeded, "
            f"{heals.get('failed', 0)} failed, "
            f"{heals.get('rate_limited', 0)} rate-limited"
        )
        mttr = doc.get("mttr_s", {})
        if mttr.get("count"):
            say(
                f"mttr: mean {mttr['mean']:.0f}s over {mttr['count']} "
                f"incident(s) (last {mttr['last']:.0f}s)"
            )
        breaker = doc.get("breaker", {})
        say(
            f"breaker: {breaker.get('state', 'closed')}"
            + (f" (reopen at {breaker.get('reopen_at'):.0f})"
               if breaker.get("reopen_at") else "")
        )
        domains = doc.get("domains") or {}
        if domains or doc.get("domain_outages"):
            open_domains = sorted(
                name for name, entry in domains.items()
                if entry.get("breaker", "closed") != "closed"
            )
            active = sorted(
                name for name, entry in domains.items()
                if entry.get("outage_active")
            )
            say(
                f"domains: {doc.get('domain_outages', 0)} outage(s) on "
                f"record across {len(domains)} tracked domain(s)"
                + (f"; breaker open: {', '.join(open_domains)}"
                   if open_domains else "")
                + (f"; outage active: {', '.join(active)}"
                   if active else "")
            )
        autoscale = doc.get("autoscale") or {}
        if autoscale.get("enabled"):
            last = autoscale.get("last_decision") or {}
            breaker_as = autoscale.get("breaker") or {}
            cooldown = autoscale.get("cooldown_remaining_s")
            in_progress = autoscale.get("in_progress")
            say(
                f"autoscale: desired {autoscale.get('desired')} / "
                f"actual {autoscale.get('actual')}"
                + (f", scaling {in_progress.get('direction')} "
                   f"{in_progress.get('slices')}"
                   if in_progress else "")
                + (f", last {last.get('direction')} "
                   f"{last.get('from_count')}->{last.get('to_count')} "
                   f"({last.get('reason')})" if last else "")
                + f", breaker {breaker_as.get('state', 'closed')}"
                + (f", cooldown {cooldown:.0f}s"
                   if cooldown else "")
            )
        allocation = doc.get("allocation") or {}
        if allocation.get("enabled"):
            roles = allocation.get("roles") or {}
            last = allocation.get("last_decision") or {}
            in_progress = allocation.get("in_progress")
            handovers = allocation.get("handovers") or {}
            say(
                f"allocation: {roles.get('serving', 0)} serving / "
                f"{roles.get('training', 0)} training"
                + (f" / {roles.get('transitioning', 0)} transitioning"
                   if roles.get("transitioning") else "")
                + (f" (training slices "
                   f"{allocation.get('training')})"
                   if allocation.get("training") else "")
                + (f", handover {in_progress.get('direction')} "
                   f"{in_progress.get('slices')}"
                   f"{' acked' if in_progress.get('acked') else ''}"
                   if in_progress else "")
                + (f", last {last.get('direction')} x{last.get('count')}"
                   f" ({last.get('reason')})" if last else "")
                + (f", {handovers.get('forced', 0)} forced"
                   if handovers.get("forced") else "")
            )
        fleet = doc.get("gateway_fleet") or {}
        if fleet:
            stale = fleet.get("stalest_demand_age_s")
            say(
                f"gateway fleet: {len(fleet.get('replicas') or [])} "
                f"replica(s), {fleet.get('leases_total', 0)} lease(s) "
                f"(epoch {fleet.get('lease_epoch', 0)}; "
                f"{fleet.get('grants', 0)} granted, "
                f"{fleet.get('renews', 0)} renewed, "
                f"{fleet.get('expiries', 0)} expired, "
                f"{fleet.get('revokes', 0)} revoked)"
                + (f", stalest demand signal {stale:.0f}s"
                   if stale is not None else "")
            )
        membership = doc.get("membership", {})
        if membership:
            say(
                f"membership: generation {membership.get('generation')}"
                + (", heal in progress"
                   if membership.get("heal_in_progress") else "")
                + (f", draining {membership.get('draining')}"
                   if membership.get("draining") else "")
            )
        tel = doc.get("telemetry") or {}
        if tel.get("metrics_snapshot") or tel.get("span_log"):
            last_tick = tel.get("last_tick_s")
            span_bytes = tel.get("span_log_bytes")
            say(
                "telemetry: "
                + (f"last tick {last_tick:.3f}s, "
                   if last_tick is not None else "")
                + f"metrics {tel.get('metrics_snapshot') or '(none)'}"
                + (f", spans {tel['span_log']}" if tel.get("span_log")
                   else "")
                + (f" ({span_bytes} B)" if span_bytes is not None else "")
            )
        job = doc.get("job", {})
        if job.get("phase"):
            job_mttr = (job.get("mttr_s") or {}).get("last")
            say(
                f"job: {job['phase']} (generation "
                f"{job.get('generation')}, step {job.get('step')}"
                + (f", acked degraded {job['acked_degraded']}"
                   if job.get("acked_degraded") else "")
                + (f", job MTTR {job_mttr:.0f}s"
                   if job_mttr is not None else "")
                + ")"
            )
    return 0 if doc.get("verdict") == "healthy" else 2


def trace_cmd(args, say=print) -> int:
    """`trace <key>`, the reference's `trace_cmd`: one request's
    end-to-end timeline, reconstructed from the span log (obs/trace.py)
    joined with the request journal (serving/reqlog.py) under the
    idempotency key. Works on a crashed workdir (both are durable
    ledgers); spans carry the writer's incarnation, so a request that
    survived a gateway SIGKILL shows records from both gateway lives.
    Exit 0 when the terminal accounting is complete (every acceptance
    settled exactly once), 2 when it has gaps."""
    from tritonk8ssupervisor_tpu_torch.obs import analyze as analyze_mod
    from tritonk8ssupervisor_tpu_torch.obs.trace import SpanLog
    from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod

    paths = state.RunPaths(args.workdir)
    if not args.arg:
        raise state.MissingStateError(
            "trace needs a request idempotency key: python -m "
            "tritonk8ssupervisor_tpu_torch.cli.main trace <key> (keys are "
            "journaled in serve-requests.jsonl; `analyze` lists recent "
            "activity)"
        )
    spans = SpanLog(paths.span_log).spans() if paths.span_log.exists() else []
    req_records = (reqlog_mod.RequestLog(paths.request_log).replay()
                   if paths.request_log.exists() else [])
    if not spans and not req_records:
        raise state.MissingStateError(
            f"no span log at {paths.span_log} and no request journal "
            f"at {paths.request_log} — run `serve` (or a chaos drill) first"
        )
    timeline = analyze_mod.request_timeline(args.arg, spans, req_records)
    if args.json:
        say(json.dumps(timeline, indent=2, sort_keys=True))
    else:
        for line in analyze_mod.render_timeline(timeline):
            say(line)
    return 0 if timeline["complete"] else 2


def analyze_cmd(args, say=print) -> int:
    """`analyze [--correlate]`, the reference's `analyze_cmd`: the
    cross-plane telemetry summary. The base report counts spans per kind
    and plane over the span log's time range; `--correlate` also joins
    the supervisor's event ledger with the request spans and attributes
    latency-spike windows to overlapping fleet events ("p99 window
    t=300-480 overlaps heal-wave span for slice 2"). Exit 0."""
    from tritonk8ssupervisor_tpu_torch.obs import analyze as analyze_mod
    from tritonk8ssupervisor_tpu_torch.obs.trace import SpanLog
    from tritonk8ssupervisor_tpu_torch.provision import events as ev_mod
    from tritonk8ssupervisor_tpu_torch.serving import reqlog as reqlog_mod

    paths = state.RunPaths(args.workdir)
    spans = SpanLog(paths.span_log).spans() if paths.span_log.exists() else []
    req_records = (reqlog_mod.RequestLog(paths.request_log).replay()
                   if paths.request_log.exists() else [])
    ledger_records = (ev_mod.EventLedger(paths.events).replay()
                      if paths.events.exists() else [])
    if not spans and not req_records and not ledger_records:
        raise state.MissingStateError(
            f"no telemetry on record ({paths.span_log}, "
            f"{paths.request_log}, {paths.events} all absent) — run "
            "`serve` (or a supervisor) over this workdir first"
        )
    by_kind: dict = {}
    t_lo = t_hi = None
    for span in spans:
        label = f"{span.get('plane', '?')}/{span.get('span', '?')}"
        by_kind[label] = by_kind.get(label, 0) + 1
        start = span.get("start")
        if start is not None:
            t_lo = start if t_lo is None else min(t_lo, start)
            t_hi = (span.get("end", start) if t_hi is None
                    else max(t_hi, span.get("end", start)))
    doc: dict = {
        "span_log": str(paths.span_log),
        "spans": len(spans),
        "spans_by_kind": dict(sorted(by_kind.items())),
        "span_time_range": ([round(t_lo, 3), round(t_hi, 3)]
                            if t_lo is not None else None),
        "journal_records": len(req_records),
        "ledger_records": len(ledger_records),
    }
    if args.correlate:
        doc["correlate"] = analyze_mod.correlate(
            spans, ledger_records, req_records=req_records,
            window_s=max(1.0, args.window),
        )
    if args.json:
        say(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    say(f"telemetry: {doc['spans']} span(s) in {doc['span_log']}, "
        f"{doc['journal_records']} request-journal record(s), "
        f"{doc['ledger_records']} supervisor ledger record(s)")
    for label, count in sorted(by_kind.items()):
        say(f"  {label:<28} {count}")
    if args.correlate:
        cor = doc["correlate"]
        say(f"correlate: {cor['completions']} completion(s), overall "
            f"p50 {cor['overall_p50_s']}s / p99 {cor['overall_p99_s']}s "
            f"over {cor['window_s']:.0f}s windows "
            f"({cor['fleet_intervals']} fleet interval(s) on record)")
        if cor["attributions"]:
            for line in cor["attributions"]:
                say(f"  {line}")
        else:
            say("  no latency-spike windows above the threshold — "
                "nothing to attribute")
    return 0


def _prompter(say) -> Prompter:
    """The Prompter whose `say` this is (`main` passes its prompter's), or
    else one that speaks through `say` and reads answers from stdin."""
    if isinstance(getattr(say, "__self__", None), Prompter):
        return say.__self__
    prompter = Prompter()
    prompter.say = lambda text="": say(text)
    return prompter


def build_runners(
    fault_plan_spec: str | None,
    timer: PhaseTimer | None = None,
) -> tuple[run_mod.RunFn, run_mod.RunFn]:
    """The reference's `build_runners`: the shared (streaming, quiet)
    RunFn stack for a run, fault injection innermost (so injected faults
    exercise exactly the classify/backoff path real ones take), then the
    retry engine, which reports retried attempts into the open phase's
    runlog record. The policy comes from the TK8S_RETRY_* and
    TK8S_ATTEMPT_TIMEOUT env knobs."""
    stream: run_mod.RunFn = run_mod.run_streaming
    quiet: run_mod.RunFn = run_mod.run_capture
    plan = faults.load_fault_plan(fault_plan_spec)
    if plan is not None:
        stream, quiet = plan.wrap(stream), plan.wrap(quiet)
    policy = retry.RetryPolicy.from_env()
    record = timer.note_retry if timer is not None else None
    return (
        retry.retrying_runner(stream, policy, record=record),
        retry.retrying_runner(quiet, policy, record=record),
    )


def heal_cmd(args, say=print) -> int:
    """`heal [--max-degraded N]`, the reference's `heal_cmd`: slice-granular
    repair of an existing deployment (provision/heal.py). Works from the
    saved config (or an explicit --config): heal converges what provision
    recorded, it never invents a new deployment."""
    paths = state.RunPaths(args.workdir)
    source = args.config or paths.config_file
    if not source.exists():
        raise state.MissingStateError(
            f"no configuration at {source} — heal repairs an existing "
            "deployment; run ./setup.sh to provision first"
        )
    config = store.load_config_file(source)
    config.validate()
    prompter = _prompter(say)  # heal speaks through a Prompter
    timer = PhaseTimer(logfile=paths.runlog)
    run, run_quiet = build_runners(args.fault_plan, timer)
    ssh_key: Path | str = ""
    ssh_user = ""
    if config.mode in VM_MODES:
        ssh_key = discovery.find_ssh_key()
        ssh_user = discovery.ssh_username()
    heal_mod.heal(
        config, paths, prompter,
        run=run, run_quiet=run_quiet,
        ssh_key=str(ssh_key), ssh_user=ssh_user,
        max_degraded=max(0, args.max_degraded),
        readiness_timeout=args.readiness_timeout,
        timer=timer,
    )
    timer.report()
    return 0


def clean(args, say=print) -> int:
    """`-c`/`--clean`, the reference's `clean`: teardown of the workdir's
    deployment (provision/teardown.py)."""
    paths = state.RunPaths(args.workdir)
    prompter = _prompter(say)
    if paths.config_file.exists():
        config = store.load_config_file(paths.config_file)
    elif terraform_mod.modes_with_state(paths) or paths.hosts_file.exists():
        # Config gone but terraform state remains (partial manual cleanup):
        # resources must not leak just because `config` was deleted — the
        # reference's cleanRunner keyed off state files (setup.sh:484-521).
        config = None
    else:
        prompter.say("No config or terraform state found — nothing to clean.")
        return 0
    run, _ = build_runners(args.fault_plan)
    ok = teardown.clean(config, paths, prompter, run=run, assume_yes=args.yes)
    return 0 if ok else 1


def supervise_policy_from_args(args) -> supervisor_mod.SupervisePolicy:
    """TK8S_SUPERVISE_* env defaults, overridden by explicit flags."""
    policy = supervisor_mod.SupervisePolicy.from_env()
    overrides = {
        "interval": args.interval,
        "flap_threshold": args.flap_threshold,
        "heal_burst": args.heal_burst,
        "heal_refill_s": args.heal_refill,
        "breaker_threshold": args.breaker_threshold,
        "breaker_window_s": args.breaker_window,
        "breaker_cooldown_s": args.breaker_cooldown,
        "max_degraded": max(0, args.max_degraded) or None,
        "page_size": args.page_size,
        "sweep_slices": args.sweep_slices,
        "heal_workers": args.heal_workers,
        "compact_records": args.compact_records,
        "domain_threshold": args.domain_threshold,
        "domain_window_s": args.domain_window,
        "domain_cooldown_s": args.domain_cooldown,
        "quota_defer_cap_s": args.quota_defer_cap,
    }
    for field, value in overrides.items():
        if value is not None:
            setattr(policy, field, value)
    return policy


def supervise_cmd(args, say=print) -> int:
    """`supervise`, the reference's `supervise_cmd`: the resident reconcile
    loop (provision/supervisor.py). Each tick diagnoses the fleet and
    drives it back to spec through the slice-scoped heal path, governed
    by the flap filter, the per-slice heal rate limiter and the circuit
    breakers; every observation, verdict, heal and breaker transition
    lands in the durable event ledger, and fleet-status.json is rewritten
    atomically for scrapers. Runs until SIGTERM/SIGINT (or --ticks N);
    teardown stops it via the pid lockfile."""
    from tritonk8ssupervisor_tpu_torch import obs as obs_mod

    paths = state.RunPaths(args.workdir)
    source = args.config or paths.config_file
    if not source.exists():
        raise state.MissingStateError(
            f"no configuration at {source} — supervise watches an "
            "existing deployment; run ./setup.sh to provision first"
        )
    config = store.load_config_file(source)
    config.validate()
    prompter = _prompter(say)
    timer = PhaseTimer(logfile=paths.runlog)
    run, run_quiet = build_runners(args.fault_plan, timer)
    ssh_key: Path | str = ""
    ssh_user = ""
    if config.mode in VM_MODES:
        ssh_key = discovery.find_ssh_key()
        ssh_user = discovery.ssh_username()
    autoscaler = None
    if args.autoscale:
        from tritonk8ssupervisor_tpu_torch.provision import autoscale as autoscale_mod

        autoscale_policy = autoscale_mod.AutoscalePolicy.from_env()
        if args.min_slices is not None:
            autoscale_policy.min_slices = max(1, args.min_slices)
        if args.max_slices is not None:
            autoscale_policy.max_slices = max(1, args.max_slices)
        autoscaler = autoscale_mod.Autoscaler(autoscale_policy, envelope=config.num_slices)
    allocator = None
    if args.allocate:
        from tritonk8ssupervisor_tpu_torch.provision import allocator as allocator_mod

        alloc_policy = allocator_mod.AllocatorPolicy.from_env()
        if args.train_slices is not None:
            alloc_policy.train_slices = max(0, args.train_slices)
        if args.min_serving is not None:
            alloc_policy.min_serving = max(1, args.min_serving)
        allocator = allocator_mod.Allocator(alloc_policy, envelope=config.num_slices)
    sup = supervisor_mod.Supervisor(
        config, paths, prompter,
        run=run, run_quiet=run_quiet,
        policy=supervise_policy_from_args(args),
        ssh_key=str(ssh_key), ssh_user=ssh_user,
        timer=timer,
        readiness_timeout=args.readiness_timeout,
        autoscaler=autoscaler,
        allocator=allocator,
        # tick/diagnose/heal-wave spans + the /metrics-shaped registry,
        # snapshotted to metrics.json every tick
        telemetry=obs_mod.Telemetry.for_run(
            paths, plane=obs_mod.SUPERVISOR, echo=lambda line: prompter.say(line),
        ),
    )
    # a signalled stop finishes the current tick, appends supervisor-stop,
    # and releases the pid lock — what teardown's SIGTERM relies on
    try:
        signal.signal(signal.SIGTERM, lambda *_: sup.request_stop())
    except ValueError:
        pass  # not the main thread (tests): --ticks bounds the loop
    return sup.run(ticks=max(0, args.ticks))


def main(argv: list[str] | None = None, prompter: Prompter | None = None) -> int:
    args = build_parser().parse_args(argv)
    prompter = prompter or Prompter()
    paths = state.RunPaths(args.workdir)
    say = prompter.say
    commands = {"heal": heal_cmd, "supervise": supervise_cmd, "status": status_cmd,
                "train": train_cmd, "serve": serve_cmd, "trace": trace_cmd,
                "analyze": analyze_cmd}
    try:
        if args.clean:
            return clean(args, say)
        if args.command is not None:
            return commands[args.command](args, say)
        if args.show_config:
            return show_config(args, paths, prompter)
        return provision(args, paths, prompter)
    except (
        ConfigError,
        discovery.DiscoveryError,
        state.MissingStateError,
        readiness.NotReadyError,
        run_mod.CommandError,
        faults.FaultPlanError,
        journal_mod.JournalError,
        EventLedgerError,
        supervisor_mod.SupervisorError,
        EndOfInput,
    ) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        print("\nInterrupted; nothing further was changed. "
              "Re-run ./setup.sh to resume or ./setup.sh -c to clean up.",
              file=sys.stderr)
        return 130
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) went away; not an error of ours
        return 0


def show_config(args, paths: state.RunPaths, prompter: Prompter) -> int:
    """The debugVars analogue (reference setup.sh:522-531) — but wired up."""
    source = args.config or paths.config_file
    if not source.exists():
        prompter.say(f"No configuration found at {source}.")
        return 1
    config = store.load_config_file(source)
    prompter.say(f"Configuration from {source}:")
    for label, value in wizard.config_rows(config):
        prompter.say(f"  {label:<24} {value}")
    return 0


def provision(args, paths: state.RunPaths, prompter: Prompter) -> int:
    """The reference's `provision`: wizard (or `--config`), verification
    gate, saved config, then the provisioning DAG under the durable
    journal, compacted once fully green; the banner and the phase table
    last."""
    # Refuse-if-previous-run guard (setup.sh:14-18, 241-244): a config file
    # means a provision is (or was) in flight; converge or clean first. An
    # explicit --config always wins over the saved one.
    resuming = paths.config_file.exists() and args.config is None
    if args.resize is not None:
        # Elastic resize: same converging pipeline, new slice count.
        # Gated on an existing run BEFORE the wizard could prompt:
        # resizing nothing is a typo, not a provision.
        if not (resuming or args.config is not None):
            raise ConfigError(
                "--resize N reconverges an existing deployment; no saved "
                "config found (provision first, then resize)"
            )
        if args.resize < 1:
            raise ConfigError(f"--resize {args.resize}: need >= 1 slice")
    if resuming:
        prompter.say(
            f"Previous run detected ({paths.config_file} exists); "
            "resuming with the saved configuration. Run ./setup.sh -c to start over."
        )
    elif paths.config_file.exists():
        prompter.say(
            f"NOTE: overriding saved {paths.config_file} with --config {args.config}"
        )

    timer = PhaseTimer(logfile=paths.runlog)
    # one composed runner pair (fault injection -> retry/backoff) shared
    # by every phase, so transient-fault handling is uniform end to end
    run, run_quiet = build_runners(args.fault_plan, timer)

    with timer.phase("discover-environment"):
        env = discovery.discover()
        discovery.require_credentials(env)

    if args.config is not None:
        config = store.load_config_file(args.config)
        if not config.project:
            config.project = env.project
        config.validate()
    elif resuming:
        config = store.load_config_file(paths.config_file)
        config.validate()
    else:
        config = wizard.run_wizard(prompter, env=env, accelerator=args.accelerator)

    if args.resize is not None and args.resize != config.num_slices:
        prompter.say(
            f"Resizing: {config.num_slices} -> {args.resize} slice(s)"
        )
        config.num_slices = args.resize
        config.validate()

    # Fail preconditions BEFORE any resources are created — the reference
    # validated its key up front too (setup.sh:231-237). Cheapest first.
    ssh_key: Path | str = ""
    ssh_user = ""
    if config.mode in VM_MODES:
        if args.probe:
            raise ConfigError(
                "--probe runs a Kubernetes Job and requires mode=gke; "
                "tpu-vm slices get the same acceptance test from the "
                "tpuhost ansible role"
                if config.mode == "tpu-vm" else
                "--probe runs a Kubernetes Job and requires mode=gke-gpu; "
                "gpu-vm hosts get the same acceptance test from the "
                "gpuhost ansible role"
            )
        ssh_key = discovery.find_ssh_key()
        ssh_user = discovery.ssh_username()

    if not args.yes and not wizard.verify_config(config, prompter):
        prompter.say("Aborted; nothing was provisioned.")
        return 1

    store.save_config_file(config, paths.config_file)
    store.export_to_env(config)

    tasks = build_provision_dag(
        args, config, paths, prompter,
        run=run, run_quiet=run_quiet, ssh_key=ssh_key, ssh_user=ssh_user,
    )
    # The durable ledger: every task transition is fsync'd, so a SIGKILL'd
    # run resumes the dirty suffix of the DAG instead of starting over.
    # The lock rejects a second concurrent run over the same workdir.
    journal = journal_mod.Journal(paths.journal)
    with journal:
        results = run_dag(
            tasks, max_workers=scheduler_workers(), timer=timer,
            journal=journal,
        )
        # Fully green: fold the append-only ledger down to its verified
        # snapshot so heal cycles and daily converges don't grow it
        # unboundedly. A failed run never reaches here, so the attempt
        # history resume needs is still intact when it matters.
        journal.compact()

    banner(config, results["terraform-apply"], results["compile-manifests"],
           prompter)
    timer.report()
    return 0


def scheduler_workers(environ: dict | None = None) -> int:
    """Pool width for the provision DAG. 8 covers the widest antichain of
    the per-slice pipeline at the default 4-slice ceiling (a readiness
    poll + a converge per slice, with terraform/manifests/host-prep done
    by then); more slices queue harmlessly. TK8S_SCHED_WORKERS=1
    degrades to the old strictly sequential pipeline for debugging."""
    env = os.environ if environ is None else environ
    try:
        return max(1, int(env.get("TK8S_SCHED_WORKERS", "8")))
    except ValueError:
        return 8


def build_provision_dag(
    args,
    config: ClusterConfig,
    paths: state.RunPaths,
    prompter: Prompter,
    run: run_mod.RunFn,
    run_quiet: run_mod.RunFn,
    ssh_key: Path | str = "",
    ssh_user: str = "",
    warm: "cache_mod.WarmCache | None" = None,
) -> list[Task]:
    """The provisioning phases as an explicit dependency graph.

    Edges encode real data/order constraints and nothing else:

    - tpu-vm mode is per-slice pipelined: `readiness-slice-N` (TPU state
      via a shared fleet snapshot, then authenticated SSH) needs only
      terraform's hosts, and `configure-slice-N` (ansible --limit) needs
      only THAT slice's readiness plus the short shared `host-prep`
      (inventory/vars/key patch);
    - GKE keeps the monolith: the gkejoin play drives gcloud/kubectl
      from the control machine, and readiness comes after because node
      registration is what the wait observes;
    - compile-manifests needs only the config, so it overlaps the whole
      cloud-facing pipeline;
    - the probe Job needs a ready cluster.

    Each task also carries its journal metadata (provision/journal.py):
    an inputs-hash over everything that must dirty it when changed, the
    artifact paths whose digests get recorded at done-time, and a
    `restore` that recomputes the task's return value from those
    artifacts when a resume skips it. The probe Job carries none — a
    health check is only meaningful re-run. Independently of the
    journal, compile-manifests and the per-slice converges consult the
    content-addressed warm cache (provision/cache.py) INSIDE their task
    body, so a warm re-run is a no-op even after the ledger is gone.
    """
    cfg_fp = dataclasses.asdict(config)  # the config fingerprint
    cache = warm if warm is not None else cache_mod.WarmCache(paths.warm_cache)

    def do_terraform(results: dict) -> state.ClusterHosts:
        if terraform_mod.already_applied(config, paths):
            prompter.say("terraform state present; converging existing deployment")
        return terraform_mod.apply(config, paths, run=run, run_quiet=run_quiet)

    job_kwargs = {"image": args.bench_image} if args.bench_image else {}
    if args.checkpoint_dir:
        job_kwargs["checkpoint_dir"] = args.checkpoint_dir
    if args.bench_workload != "resnet50":
        job_kwargs["workload"] = args.bench_workload
    if args.bench_flags:
        job_kwargs["bench_flags"] = tuple(shlex.split(args.bench_flags))
    if args.workload_image:
        job_kwargs["workload_image"] = args.workload_image
        job_kwargs["workload_command"] = shlex.split(
            args.workload_command or ""
        )
        job_kwargs["workload_name"] = args.workload_name
    if args.independent_slices:
        job_kwargs["cross_slice"] = False

    manifest_key = journal_mod.inputs_hash(
        "compile-manifests", cfg_fp, job_kwargs
    )

    def do_manifests(results: dict) -> list:
        if cache.fresh("compile-manifests", manifest_key,
                       artifacts=(paths.manifests_dir,)):
            prompter.say("  compile-manifests: inputs unchanged "
                         "(warm cache); reusing compiled manifests")
            return sorted(paths.manifests_dir.glob("*.yaml"))
        out = compiler.write_manifests(
            config, paths.manifests_dir, **job_kwargs
        )
        cache.record("compile-manifests", manifest_key,
                     artifacts=(paths.manifests_dir,))
        return out

    def do_probe(results: dict) -> None:
        readiness.run_probe_job(
            config,
            paths.probe_dir,
            run=run,
            run_quiet=run_quiet,
            timeout_seconds=args.readiness_timeout,
            image=args.probe_image,
        )

    tf_task = Task(
        "terraform-apply", do_terraform,
        inputs_hash=journal_mod.inputs_hash(
            "terraform-apply", compiler.to_tfvars(config)
        ),
        artifacts=(paths.tfstate(config.mode), paths.hosts_file),
        restore=lambda results: state.load_hosts(paths),
    )
    manifests_task = Task(
        "compile-manifests", do_manifests,
        inputs_hash=manifest_key,
        artifacts=(paths.manifests_dir,),
        restore=lambda results: sorted(paths.manifests_dir.glob("*.yaml")),
    )
    tasks = [tf_task, manifests_task]

    if config.mode in VM_MODES:
        tasks += build_slice_pipeline(
            args, config, paths, cache,
            run=run, run_quiet=run_quiet,
            ssh_key=ssh_key, ssh_user=ssh_user, cfg_fp=cfg_fp,
        )
        return tasks

    # ------------------------------------------------------------ gke mode

    def do_ansible(results: dict) -> None:
        ansible_mod.write_runtime_configs(
            config, results["terraform-apply"], paths,
            ssh_key=ssh_key, ansible_user=ssh_user,
        )
        ansible_mod.run_playbook(paths, run=run,
                                 playbook=ansible_mod.playbook_for(config))

    def do_readiness(results: dict) -> None:
        wait_ready(config, args.readiness_timeout, run_quiet=run_quiet)

    tasks.append(Task(
        "host-configuration", do_ansible, after=("terraform-apply",),
        inputs_hash=journal_mod.inputs_hash(
            "host-configuration", cfg_fp, str(ssh_key), ssh_user
        ),
        artifacts=(paths.inventory, paths.hosts_file),
    ))
    ready_gate = "host-configuration"
    if not args.skip_readiness:
        tasks.append(Task(
            "readiness-wait", do_readiness, after=("host-configuration",),
            inputs_hash=journal_mod.inputs_hash("readiness-wait", cfg_fp),
            artifacts=(paths.hosts_file,),
        ))
        ready_gate = "readiness-wait"
    if args.probe:
        # no journal metadata: the probe is an acceptance test, and a
        # resumed run must re-prove the cluster, not trust a record
        tasks.append(Task("probe-job", do_probe, after=(ready_gate,)))
    return tasks


def build_slice_pipeline(
    args,
    config: ClusterConfig,
    paths: state.RunPaths,
    cache: "cache_mod.WarmCache",
    run: run_mod.RunFn,
    run_quiet: run_mod.RunFn,
    ssh_key: Path | str,
    ssh_user: str,
    cfg_fp: dict,
) -> list[Task]:
    """The tpu-vm (and gpu-vm) per-slice tail of the DAG: one shared
    `host-prep` (runtime configs — seconds of local file writes) plus, per
    slice, a `readiness-slice-N` (shared fleet snapshot + adaptive-backoff
    polls) and a `configure-slice-N` (cache-aware `ansible --limit`). The
    only cross-slice edge is host-prep; each slice's converge starts the
    moment ITS hosts accept authenticated SSH. A gpu-vm slice is ready
    when each of its host VMs is RUNNING."""
    # one batched `tpu-vm list` (`instances list`) per TTL window serves
    # every slice's poll
    snapshot = readiness.FleetSnapshot(config, run_quiet=run_quiet)

    def do_host_prep(results: dict) -> None:
        ansible_mod.write_runtime_configs(
            config, results["terraform-apply"], paths,
            ssh_key=ssh_key, ansible_user=ssh_user,
        )

    tasks = [Task(
        "host-prep", do_host_prep, after=("terraform-apply",),
        inputs_hash=journal_mod.inputs_hash(
            "host-prep", cfg_fp, str(ssh_key), ssh_user
        ),
        artifacts=(paths.inventory,),
    )]

    def slice_readiness_task(i: int) -> Task:
        name = f"readiness-slice-{i}"
        node = f"{config.node_prefix}-{i}"

        def vm_probe() -> str:
            if config.is_gpu:  # each host VM of the slice RUNNING
                return readiness.gpu_vm_probe(
                    config, readiness.gpu_vm_names(config, [i]), run_quiet,
                    snapshot=snapshot)
            return readiness.tpu_vm_probe(config, [node], run_quiet, snapshot=snapshot)

        def fn(results: dict) -> None:
            # one shared budget for both polls — the user's timeout caps
            # the whole slice's wait, not each poll
            hosts = results["terraform-apply"]
            poll_start = time.monotonic()
            readiness.poll(
                vm_probe,
                timeout=args.readiness_timeout,
                adapt=readiness.AdaptiveInterval(base=5.0, max_interval=45.0),
            )
            remaining = max(
                0.0,
                args.readiness_timeout - (time.monotonic() - poll_start),
            )
            slice_ips = (
                hosts.host_ips[i] if i < len(hosts.host_ips) else []
            )
            readiness.poll(
                lambda: readiness.ssh_ready_probe(
                    slice_ips, ssh_user=ssh_user, ssh_key=str(ssh_key),
                    run_quiet=run_quiet,
                ),
                timeout=remaining,
                adapt=readiness.AdaptiveInterval(base=2.0, max_interval=15.0),
            )

        return Task(
            name, fn, after=("terraform-apply",),
            inputs_hash=journal_mod.inputs_hash(name, cfg_fp),
            artifacts=(paths.hosts_file,),
        )

    def slice_converge_task(i: int, after: tuple) -> Task:
        name = f"configure-slice-{i}"

        def fn(results: dict) -> bool:
            return ansible_mod.converge_slice(
                config, paths, results["terraform-apply"], i,
                run=run, cache=cache,
                ssh_key=ssh_key, ssh_user=ssh_user,
            )

        return Task(
            name, fn, after=after,
            inputs_hash=journal_mod.inputs_hash(
                name, cfg_fp, str(ssh_key), ssh_user
            ),
            artifacts=(paths.inventory,),
        )

    for i in range(config.num_slices):
        converge_after = ["host-prep"]
        if not args.skip_readiness:
            tasks.append(slice_readiness_task(i))
            converge_after.append(f"readiness-slice-{i}")
        tasks.append(slice_converge_task(i, tuple(converge_after)))
    return tasks


def wait_ready(
    config: ClusterConfig,
    timeout: float,
    run_quiet: run_mod.RunFn = run_mod.run_capture,
) -> None:
    if config.mode == "gke":
        readiness.poll(
            lambda: readiness.gke_tpu_probe(config, run_quiet),
            timeout=timeout,
        )
    elif config.mode == "gke-gpu":
        readiness.poll(
            lambda: readiness.gke_gpu_probe(config, run_quiet),
            timeout=timeout,
        )
    elif config.mode == "gpu-vm":
        readiness.poll(
            lambda: readiness.gpu_vm_probe(
                config, readiness.gpu_vm_names(config), run_quiet),
            timeout=timeout,
        )
    else:
        names = [
            f"{config.node_prefix}-{i}" for i in range(config.num_slices)
        ]
        readiness.poll(
            lambda: readiness.tpu_vm_probe(config, names, run_quiet),
            timeout=timeout,
        )


def banner(config, hosts: state.ClusterHosts, manifest_paths, prompter: Prompter) -> None:
    """Success banner with the URLs of record — the dashboard/kubectl-config
    URL printout analogue (setup.sh:49-91). The benchmark line names the
    port's module, as the compiled Jobs do."""
    prompter.say("")
    prompter.say("---------------------------------------------------------")
    prompter.say(" Cluster is ready.")
    prompter.say("---------------------------------------------------------")
    if config.is_gpu:
        gpu_banner(config, hosts, manifest_paths, prompter)
    elif config.mode == "gke":
        prompter.say(
            "  Workloads:  https://console.cloud.google.com/kubernetes/"
            f"workload/overview?project={config.project}"
        )
        prompter.say(
            f"  kubeconfig: gcloud container clusters get-credentials "
            f"{config.cluster_name} --zone {config.zone} --project {config.project}"
        )
        prompter.say(
            f"  Benchmark:  kubectl apply -f {manifest_paths[0].parent}/"
        )
    else:
        for i, slice_ips in enumerate(hosts.host_ips):
            prompter.say(f"  slice {i}: {', '.join(slice_ips)}")
        prompter.say(
            f"  SSH:       gcloud compute tpus tpu-vm ssh {config.node_prefix}-0 "
            f"--zone {config.zone}"
        )
        prompter.say(
            "  Benchmark: python -m tritonk8ssupervisor_tpu_torch.benchmarks.resnet50"
        )


def gpu_banner(config, hosts: state.ClusterHosts, manifest_paths, prompter: Prompter) -> None:
    """The GPU modes' lines of the banner: the benchmark line is the GPU
    Job's launcher command (gke-gpu), or the command each host runs with
    its node rank (gpu-vm)."""
    if config.mode == "gke-gpu":
        prompter.say(
            "  Workloads:  https://console.cloud.google.com/kubernetes/"
            f"workload/overview?project={config.project}"
        )
        prompter.say(
            f"  kubeconfig: gcloud container clusters get-credentials "
            f"{config.cluster_name} --zone {config.zone} --project {config.project}"
        )
        prompter.say(f"  Benchmark:  kubectl apply -f {manifest_paths[0].parent}/")
        job = yaml.safe_load((manifest_paths[0].parent / "bench-job-0.yaml").read_text())
        command = job["spec"]["template"]["spec"]["containers"][0]["command"][-1]
        prompter.say(f"  Job runs:   {command.split(' && ', 1)[-1]}")
        return
    for i, slice_ips in enumerate(hosts.host_ips):
        prompter.say(f"  slice {i}: {', '.join(slice_ips)}")
    prompter.say(f"  SSH:       gcloud compute ssh {config.node_prefix}-0-0 --zone {config.zone}")
    launcher = compiler.gpu_launcher_args(
        config.num_slices * config.hosts_per_slice,
        config.spec.chips_on_host(config.parsed_topology), "RANK",
        hosts.coordinator_ip or "COORDINATOR")
    module = compiler.BENCH_WORKLOADS["resnet50"][0]
    prompter.say(f"  Benchmark: python3 -m torch.distributed.run {launcher} -m {module}")
    prompter.say("             (RANK: slice x hosts a slice + the host's index)")


if __name__ == "__main__":
    sys.exit(main())
