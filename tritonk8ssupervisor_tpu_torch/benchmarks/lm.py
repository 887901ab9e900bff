"""Transformer-LM training-throughput benchmark (tokens/sec/card): the port
of `tritonk8ssupervisor_tpu/benchmarks/lm.py`, on one NVIDIA card.

    python -m tritonk8ssupervisor_tpu_torch.benchmarks.lm --json

A causal LM (12 layers, 12 heads, embed 768, vocab 32768 by default)
trained on synthetic tokens made on the card from a seeded generator,
bf16 compute with f32 parameters, SGD with Nesterov momentum. Attention
goes through kernel K2 (ops/flash_attention.py) and the loss through K1
(ops/cross_entropy.py). Timing is `utils/perf.timed_windows`, the same
discipline as the ResNet-50 benchmark.

Not ported yet, and raising: sequence parallelism (ring attention),
mixture-of-experts and expert parallelism, pipeline parallelism
(ROADMAP.md queue 1, item 4) and checkpointing (item 5).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models.transformer import dense_attention
from tritonk8ssupervisor_tpu_torch.ops.flash_attention import flash_attention
from tritonk8ssupervisor_tpu_torch.parallel import train as train_lib
from tritonk8ssupervisor_tpu_torch.utils import perf


def _unported(**options) -> None:
    for name, (value, default, item) in options.items():
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: ROADMAP.md queue 1, item {item}"
            )


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
    before the warm-up runs under the FLOP counter (utils/perf.py).
    """
    _unported(
        sequence_parallelism=(sequence_parallelism, 1, 4),
        expert_parallelism=(expert_parallelism, 1, 4),
        moe_experts=(moe_experts, 0, 4),
        pipeline_parallelism=(pipeline_parallelism, 1, 4),
        checkpoint_dir=(checkpoint_dir, None, 5),
    )
    if grad_accum < 1:
        raise ValueError(f"--grad-accum {grad_accum} must be >= 1 (1 = no accumulation)")
    if attention not in ("auto", "dense", "flash"):
        raise ValueError(f"attention={attention!r}: expected 'auto', 'dense' or 'flash'")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if attention == "auto":
        attention = "flash" if on_card else "dense"
    num_chips = 1
    global_batch = batch_per_data_shard

    init_start = time.monotonic()
    model = TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        embed_dim=embed_dim,
        max_seq_len=seq_len,
        attention_fn=flash_attention if attention == "flash" else dense_attention,
        remat_blocks=remat,
        head_major=head_major,
    )
    state = train_lib.create_train_state(
        model, train_lib.default_optimizer(learning_rate=learning_rate), device
    )
    step = train_lib.make_lm_train_step(state, grad_accum=grad_accum)
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, vocab_size, (global_batch, seq_len), generator=gen,
                           device=device, dtype=torch.int32)

    flops = perf.flops_per_step(lambda: step(tokens)["loss"].item())
    timing = perf.timed_windows(
        lambda: step(tokens), steps=steps, warmup=warmup, windows=windows,
        profile_dir=profile_dir,
    )
    compile_seconds = timing.pop("first_fence_seconds") - init_start

    device_kind = torch.cuda.get_device_name(device) if on_card else device.type
    step_ms = timing["step_ms"]
    tokens_per_sec = global_batch * seq_len / (step_ms / 1000)
    flops_per_step = flops["flops_per_step"]
    return {
        "start_step": 0,
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
                        help="ring attention (not ported yet)")
    parser.add_argument("--expert-parallelism", type=int, default=1,
                        help="(not ported yet)")
    parser.add_argument("--moe-experts", type=int, default=0, help="(not ported yet)")
    parser.add_argument("--moe-every", type=int, default=2)
    parser.add_argument("--pipeline-parallelism", type=int, default=1,
                        help="(not ported yet)")
    parser.add_argument("--num-microbatches", type=int, default=4)
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
    parser.add_argument("--checkpoint-dir", default=None, help="(not ported yet)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    result = run_benchmark(
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
