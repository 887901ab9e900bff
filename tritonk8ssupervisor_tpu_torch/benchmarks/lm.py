"""Transformer-LM training-throughput benchmark (tokens/sec/card): the port
of `tritonk8ssupervisor_tpu/benchmarks/lm.py`, on one NVIDIA card.

    python -m tritonk8ssupervisor_tpu_torch.benchmarks.lm --json

A causal LM (12 layers, 12 heads, embed 768, vocab 32768 by default)
trained on synthetic tokens made on the card from a seeded generator,
bf16 compute with f32 parameters, SGD with Nesterov momentum. Attention
goes through kernel K2 (ops/flash_attention.py) and the loss through K1
(ops/cross_entropy.py). Timing is `utils/perf.timed_windows`, the same
discipline as the ResNet-50 benchmark.

    python -m tritonk8ssupervisor_tpu_torch.benchmarks.lm --moe-experts 8 --json

`--moe-experts E` makes every `--moe-every`-th block a mixture of E
experts (models/moe.py, k = 2, capacity factor 1.25), whose router losses
join the objective. `--checkpoint-dir` resumes from the directory's
latest step and saves at every window boundary (parallel/checkpoint.py).

    torchrun --nproc-per-node N -m tritonk8ssupervisor_tpu_torch.benchmarks.lm --json

In a process group (torchrun, or `parallel/ranks.run_ranks`) the step
runs on the mesh (`parallel/mesh.make_workload_mesh`), each rank on its
shard of a global batch of `--batch-per-data-shard` x the batch degree:
`--sequence-parallelism S` shards the sequence over S ranks of the
"model" axis with ring attention (ops/ring_attention.py), and
`--expert-parallelism E` shards the experts of `--moe-experts` over the
"expert" axis (all_to_all dispatch), and `--pipeline-parallelism P` stages
the block stack over P ranks of the "pipe" axis (parallel/pipeline.py,
GPipe with `--num-microbatches` microbatches a step, K2 once a layer and
microbatch). A degree that does not divide the ranks raises ValueError,
also without a process group (one rank), as do the reference's refused
combinations: the pipeline with sequence parallelism, MoE blocks,
`--head-major` or `--grad-accum`. The FLOP count is what the ranks run,
the pipeline's fill and drain ticks included.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models.transformer import dense_attention
from tritonk8ssupervisor_tpu_torch.ops.flash_attention import flash_attention
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import ring_attention
from tritonk8ssupervisor_tpu_torch.parallel import checkpoint as ckpt_lib
from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu_torch.parallel import pipeline as pp_lib
from tritonk8ssupervisor_tpu_torch.parallel import train as train_lib
from tritonk8ssupervisor_tpu_torch.parallel.distributed import init_from_launcher
from tritonk8ssupervisor_tpu_torch.parallel.mesh import MODEL_AXIS
from tritonk8ssupervisor_tpu_torch.utils import perf
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard


def _check_options(seq_len: int, sequence_parallelism: int, expert_parallelism: int,
                   moe_experts: int, pipeline_parallelism: int, head_major: bool,
                   grad_accum: int) -> None:
    """The reference's refusals (:73-119)."""
    if seq_len % max(sequence_parallelism, 1):
        raise ValueError(
            f"--seq-len {seq_len} must be divisible by --sequence-parallelism "
            f"{sequence_parallelism} (the sequence axis shards evenly across the ring)")
    if pipeline_parallelism > 1 and sequence_parallelism > 1:
        raise ValueError(
            "--pipeline-parallelism and --sequence-parallelism are separate strategies "
            "in this benchmark: the pipeline stages the block stack, the ring shards "
            "inside every block")
    if pipeline_parallelism > 1 and moe_experts:
        raise ValueError(
            "--pipeline-parallelism with --moe-experts is not wired: the pipeline's "
            "stage function runs the dense block")
    if head_major and sequence_parallelism > 1:
        raise ValueError(
            "--head-major with --sequence-parallelism is not wired: the ring "
            "attention path is seq-major")
    if head_major and pipeline_parallelism > 1:
        raise ValueError(
            "--head-major with --pipeline-parallelism is not wired: the pipeline's "
            "stage function runs the seq-major block")
    if grad_accum < 1:
        raise ValueError(f"--grad-accum {grad_accum} must be >= 1 (1 = no accumulation)")
    if pipeline_parallelism > 1 and grad_accum > 1:
        raise ValueError(
            "--grad-accum with --pipeline-parallelism is not wired: the pipeline "
            "already microbatches inside the step (--num-microbatches)")
    if moe_experts and moe_experts % expert_parallelism:
        raise ValueError(
            f"--moe-experts {moe_experts} must be divisible by --expert-parallelism "
            f"{expert_parallelism}: a non-dividing expert count would replicate every "
            "expert weight while the run reports itself expert-parallel")


def run_benchmark(
    vocab_size: int = 32768,
    num_layers: int = 12,
    num_heads: int = 12,
    embed_dim: int = 768,
    seq_len: int = 1024,
    batch_per_data_shard: int = 8,
    steps: int = 50,
    warmup: int = 3,
    windows: int = 3,
    sequence_parallelism: int = 1,
    expert_parallelism: int = 1,
    moe_experts: int = 0,
    moe_every: int = 2,
    pipeline_parallelism: int = 1,
    num_microbatches: int = 4,
    grad_accum: int = 1,
    remat: bool = False,
    head_major: bool = False,
    attention: str = "auto",
    learning_rate: float = 3e-2,
    checkpoint_dir: str | None = None,
    profile_dir: str | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Train a causal LM on synthetic tokens and measure steady-state
    throughput; returns the reference's metrics plus `device`,
    `device_kind` and `flops_source`.

    `attention`: "flash" (K2 on the card; the plain version on the CPU),
    "dense" (plain torch) or "auto" ("flash" on the card, "dense" on the
    CPU, as the reference picks flash on its accelerator). One extra step
    before the warm-up runs under the FLOP counter (utils/perf.py). A MoE
    run also returns `router_loss`, the router losses of the last step.
    With `checkpoint_dir`, the latest step there is restored first (its
    time is `restore_seconds`, not start-up time), every window boundary
    saves, and the run ends with a save. `pipeline_parallelism` > 1 runs
    the block stack through the pipeline (`parallel/pipeline.py`) with
    `num_microbatches` microbatches a step.
    """
    _check_options(seq_len, sequence_parallelism, expert_parallelism, moe_experts,
                   pipeline_parallelism, head_major, grad_accum)
    if attention not in ("auto", "dense", "flash"):
        raise ValueError(f"attention={attention!r}: expected 'auto', 'dense' or 'flash'")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if attention == "auto":
        attention = "flash" if on_card else "dense"
    mesh = None
    if (dist.is_initialized() or sequence_parallelism != 1 or expert_parallelism != 1
            or pipeline_parallelism != 1):
        mesh = mesh_lib.make_workload_mesh(model_parallelism=sequence_parallelism,
                                           expert_parallelism=expert_parallelism,
                                           pipeline_parallelism=pipeline_parallelism,
                                           device_type=device.type)
    num_chips = mesh.size() if mesh is not None else 1
    global_batch = batch_per_data_shard * (mesh_lib.batch_degree(mesh) if mesh is not None else 1)
    seq_axis = MODEL_AXIS if sequence_parallelism > 1 else None
    if seq_axis is not None:
        attention = "ring"

        def attention_fn(q, k, v, causal=True):
            return ring_attention(q, k, v, mesh=mesh, axis_name=MODEL_AXIS, causal=causal)
    else:
        attention_fn = flash_attention if attention == "flash" else dense_attention

    init_start = time.monotonic()
    model = TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        embed_dim=embed_dim,
        max_seq_len=seq_len,
        attention_fn=attention_fn,
        moe_experts=moe_experts,
        moe_every=moe_every,
        moe_mesh=mesh if moe_experts else None,
        remat_blocks=remat,
        head_major=head_major,
    )
    tx = train_lib.default_optimizer(learning_rate=learning_rate)
    if pipeline_parallelism > 1:
        state = pp_lib.create_pp_lm_state(model, tx, mesh, device)
        step = pp_lib.make_pp_lm_train_step(state, num_microbatches)
    else:
        state = train_lib.create_train_state(model, tx, device, mesh=mesh)
        step = train_lib.make_lm_train_step(state, seq_axis=seq_axis, grad_accum=grad_accum)
    ckpt, state, start_step, restore_seconds = ckpt_lib.maybe_restore(checkpoint_dir, state)
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, vocab_size, (global_batch, seq_len), generator=gen,
                           device=device, dtype=torch.int32)
    if mesh is not None:  # this rank's shard: batch rows, and a sequence block
        tokens = batch_shard(mesh, tokens)
        if seq_axis is not None:
            tokens = mesh_lib.local_shard(tokens, mesh, (None, seq_axis))

    last: dict = {}

    def run_once() -> dict:
        last.update(step(tokens))
        return last

    flops = perf.flops_per_step(lambda: run_once()["loss"].item())
    if flops["flops_per_step"]:  # the ranks' counts summed (they run the same step)
        flops["flops_per_step"] *= num_chips
    timing = perf.timed_windows(
        run_once, steps=steps, warmup=warmup, windows=windows,
        profile_dir=profile_dir, on_window=ckpt_lib.window_save_hook(ckpt, state),
    )
    compile_seconds = timing.pop("first_fence_seconds") - init_start - restore_seconds
    ckpt_lib.save_and_close(ckpt, state)

    device_kind = torch.cuda.get_device_name(device) if on_card else device.type
    step_ms = timing["step_ms"]
    tokens_per_sec = global_batch * seq_len / (step_ms / 1000)
    flops_per_step = flops["flops_per_step"]
    return {
        "start_step": start_step,
        "final_step": state.step,
        "model": "transformer_lm",
        "platform": "gpu" if on_card else device.type,
        "device": str(device),
        "device_kind": device_kind,
        "num_chips": num_chips,
        "sequence_parallelism": sequence_parallelism,
        "expert_parallelism": expert_parallelism,
        "moe_experts": moe_experts,
        "pipeline_parallelism": pipeline_parallelism,
        "num_microbatches": num_microbatches,
        "attention": attention,
        "global_batch": global_batch,
        "seq_len": seq_len,
        "num_layers": num_layers,
        "embed_dim": embed_dim,
        **timing,
        "tokens_per_sec": tokens_per_sec,
        "tokens_per_sec_per_chip": tokens_per_sec / num_chips,
        **flops,
        "flops_per_token": (
            flops_per_step / (global_batch * seq_len) if flops_per_step else None
        ),
        "mfu": (
            perf.mfu(flops_per_step, step_ms / 1000, num_chips, device_kind)
            if on_card else None
        ),
        "compile_seconds": compile_seconds,
        "restore_seconds": restore_seconds,
        **({"router_loss": last["router_loss"].item()} if moe_experts else {}),
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--vocab-size", type=int, default=32768)
    parser.add_argument("--num-layers", type=int, default=12)
    parser.add_argument("--num-heads", type=int, default=12)
    parser.add_argument("--embed-dim", type=int, default=768)
    parser.add_argument("--seq-len", type=int, default=1024)
    parser.add_argument("--batch-per-data-shard", type=int, default=8)
    parser.add_argument("--steps", type=int, default=50, help="steps per window")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--windows", type=int, default=3, help="timed windows")
    parser.add_argument("--sequence-parallelism", type=int, default=1,
                        help="shard the sequence over this many ranks (ring attention)")
    parser.add_argument("--expert-parallelism", type=int, default=1,
                        help="shard the MoE experts over this many ranks")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="make every --moe-every'th block a mixture of this many "
                        "experts (models/moe.py); 0 = dense MLPs")
    parser.add_argument("--moe-every", type=int, default=2)
    parser.add_argument("--pipeline-parallelism", type=int, default=1,
                        help="stage the block stack over this many ranks of the 'pipe' "
                        "axis (parallel/pipeline.py, GPipe)")
    parser.add_argument("--num-microbatches", type=int, default=4,
                        help="microbatches a step when --pipeline-parallelism > 1")
    parser.add_argument("--remat", action="store_true",
                        help="recompute blocks in the backward (torch.utils.checkpoint)")
    parser.add_argument("--head-major", action="store_true",
                        help="q/k/v born (b, h, s, d) from the projection")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="microbatches per optimizer update")
    parser.add_argument("--attention", choices=("auto", "dense", "flash"), default="auto",
                        help="auto = flash (kernel K2) on the card, dense on the CPU")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of one steady-state step into DIR")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="resume from this directory's latest step; save at every "
                        "window boundary and at the end (local paths)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    return parser


def _run(args) -> dict:
    return run_benchmark(
        vocab_size=args.vocab_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        embed_dim=args.embed_dim,
        seq_len=args.seq_len,
        batch_per_data_shard=args.batch_per_data_shard,
        steps=args.steps,
        warmup=args.warmup,
        windows=args.windows,
        sequence_parallelism=args.sequence_parallelism,
        expert_parallelism=args.expert_parallelism,
        moe_experts=args.moe_experts,
        moe_every=args.moe_every,
        pipeline_parallelism=args.pipeline_parallelism,
        num_microbatches=args.num_microbatches,
        grad_accum=args.grad_accum,
        remat=args.remat,
        head_major=args.head_major,
        attention=args.attention,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    joined = init_from_launcher()  # under torchrun: every rank runs the mesh path
    rank = dist.get_rank() if joined else 0
    try:
        result = _run(args)
    finally:
        if joined:
            dist.destroy_process_group()
    if rank:
        return 0
    if args.json:
        print(json.dumps(result, sort_keys=True))
    else:
        print(
            f"{result['model']} on {result['num_chips']} {result['device_kind']}, "
            f"seq {result['seq_len']}: {result['tokens_per_sec']:.0f} tok/s, "
            + perf.timing_summary(result)
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
