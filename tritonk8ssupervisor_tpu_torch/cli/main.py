"""The port's command line: the counterpart of
`tritonk8ssupervisor_tpu/cli/main.py` for the commands the port has.

    python -m tritonk8ssupervisor_tpu_torch.cli.main train --checkpoint-dir DIR \
        [--workdir W] [--steps N] [--checkpoint-every N] [--status-file F] \
        [--ack-file F] [--env-file F] [--max-wait S] [--max-degraded N] \
        [--train-report F] [--device cuda|cpu] [--backend nccl|gloo] [--yes]

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from tritonk8ssupervisor_tpu_torch import resolve_device


class ConfigError(ValueError):
    """A command line that cannot run; main prints it and exits 1."""


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tritonk8ssupervisor_tpu_torch.cli.main",
        description="The PyTorch port's commands.",
    )
    parser.add_argument(
        "command", choices=["train"],
        help="`train` runs the elastic-training drill: a small causal LM "
        "that survives membership changes by checkpoint, rejoin and restore",
    )
    parser.add_argument(
        "--workdir", type=Path, default=Path.cwd(),
        help="the supervisor's workdir, holding fleet-status.json and "
        "job-ack.json (default: cwd)",
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
        help="train: fleet-status.json to watch (default: the workdir's; a "
        "missing or mid-rewrite file reads as unknown, never healthy)",
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
        help="train: where to train (default: the CUDA card; `cpu` asks for "
        "the host)",
    )
    parser.add_argument(
        "--backend", choices=["nccl", "gloo"], default=None,
        help="train: the process group's backend (default: NCCL on the card, "
        "gloo on the CPU)",
    )
    parser.add_argument("--yes", action="store_true", help="skip confirmation gates (CI use)")
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


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "train":
            return train_cmd(args, lambda line: print(line, flush=True))
    except ConfigError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        print("\nInterrupted.", file=sys.stderr)
        return 130
    return 2


if __name__ == "__main__":
    sys.exit(main())
