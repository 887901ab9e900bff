"""The port's command line: the counterpart of
`tritonk8ssupervisor_tpu/cli/main.py` for the commands the port has.

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.provision.events import EventLedgerError


class ConfigError(ValueError):
    """A command line that cannot run; main prints it and exits 1."""


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tritonk8ssupervisor_tpu_torch.cli.main",
        description="The PyTorch port's commands.",
    )
    parser.add_argument(
        "command", choices=["train", "serve", "status"],
        help="`train` runs the elastic-training drill: a small causal LM "
        "that survives membership changes by checkpoint, rejoin and restore; "
        "`serve` runs the inference gateway over the slot engine (HTTP, or "
        "a drill with --drill N); `status` prints the fleet status: "
        "fleet-status.json, or the event ledger's fold",
    )
    parser.add_argument(
        "--workdir", type=Path, default=Path.cwd(),
        help="the supervisor's workdir, holding fleet-status.json, "
        "job-ack.json and the serving journal and spans (default: cwd)",
    )
    parser.add_argument(
        "--checkpoint-dir", default=os.environ.get("TK8S_CHECKPOINT_DIR") or None,
        metavar="DIR",
        help="train: the shared checkpoint the job resumes from at the new "
        "world size: a local path or a URL (gs://...). Also read from "
        "TK8S_CHECKPOINT_DIR.",
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
        help="train: slices the job will continue without (default 0)",
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
        help="status: print the raw fleet-status JSON document instead "
        "of the human summary",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="status: include EVERY slice in the per-slice detail "
        "(folded from the event ledger) — the default document stays "
        "bounded at fleet scale: per-state counts plus only the "
        "not-healthy slices",
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
    from tritonk8ssupervisor_tpu_torch.provision import state
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
    from tritonk8ssupervisor_tpu_torch.provision import state

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
        raise ConfigError(
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


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "train":
            return train_cmd(args, lambda line: print(line, flush=True))
        if args.command == "serve":
            return serve_cmd(args, lambda line: print(line, flush=True))
        if args.command == "status":
            return status_cmd(args, lambda line: print(line, flush=True))
    except (ConfigError, EventLedgerError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        print("\nInterrupted.", file=sys.stderr)
        return 130
    return 2


if __name__ == "__main__":
    sys.exit(main())
