"""ResNet-50 training-throughput benchmark (images/sec/card): the port of
`tritonk8ssupervisor_tpu/benchmarks/resnet50.py`, on one NVIDIA card.

    python -m tritonk8ssupervisor_tpu_torch.benchmarks.resnet50 --json

Data is synthetic and made on the card from a seeded generator, so the
benchmark measures the training computation, not a host input pipeline.
The loss and accuracy go through kernel K1 (ops/cross_entropy.py); with
`--fused-1x1-bwd` the backward of every stride-1 1x1 convolution goes
through kernel K4 (ops/conv_backward.py).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.models import ResNet18, ResNet50
from tritonk8ssupervisor_tpu_torch.parallel import train as train_lib
from tritonk8ssupervisor_tpu_torch.utils import perf

MODELS = {"resnet50": ResNet50, "resnet18": ResNet18}


def run_benchmark(
    model_name: str = "resnet50",
    batch_per_chip: int = 128,
    image_size: int = 224,
    num_classes: int = 1000,
    steps: int = 30,
    warmup: int = 5,
    windows: int = 3,
    steps_per_call: int = 0,
    model_parallelism: int = 1,
    learning_rate: float = 0.1,
    fused_1x1_bwd: bool = False,
    remat: bool = False,
    checkpoint_dir: str | None = None,
    profile_dir: str | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Train on synthetic data and measure steady-state throughput.

    The same signature and returned fields as the reference, plus
    `device` (the card unless told otherwise), `device_kind` and
    `flops_source`. One extra step before the warm-up runs under the
    FLOP counter (utils/perf.py); `windows` windows of `steps` steps are
    then timed, each fenced by reading the loss.
    """
    if model_name == "vit":
        raise NotImplementedError(
            "ViT is not ported yet: ROADMAP.md queue 1, ViT"
        )
    if model_name not in MODELS:
        raise ValueError(f"unknown model {model_name!r}; choose from {sorted(MODELS)}")
    if model_parallelism != 1:
        raise NotImplementedError(
            "model parallelism needs the mesh and tensor parallelism, not "
            "ported yet: ROADMAP.md queue 1, mesh and DDP"
        )
    if checkpoint_dir:
        raise NotImplementedError(
            "checkpointing is not ported yet: ROADMAP.md queue 1, checkpointing"
        )
    device = resolve_device(device)
    if steps_per_call <= 0:
        steps_per_call = 1
    if steps % steps_per_call:
        raise ValueError(
            f"steps ({steps}) must be a multiple of steps_per_call "
            f"({steps_per_call})"
        )
    num_chips = 1
    global_batch = batch_per_chip

    init_start = time.monotonic()
    model = MODELS[model_name](
        num_classes=num_classes, remat_blocks=remat, fused_1x1_bwd=fused_1x1_bwd
    )
    state = train_lib.create_train_state(
        model, train_lib.default_optimizer(learning_rate=learning_rate), device
    )
    step = train_lib.make_train_step(state, steps_per_call=steps_per_call)

    # synthetic batch born on the device: bf16 NHWC images, int32 labels
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.randn(
        (global_batch, image_size, image_size, 3),
        generator=gen, device=device, dtype=torch.bfloat16,
    )
    labels = torch.randint(
        0, num_classes, (global_batch,),
        generator=gen, device=device, dtype=torch.int32,
    )

    flops = perf.flops_per_step(lambda: step(images, labels)["loss"].item())
    timing = perf.timed_windows(
        lambda: step(images, labels),
        steps=steps,
        warmup=warmup,
        windows=windows,
        steps_per_call=steps_per_call,
        profile_dir=profile_dir,
    )
    compile_seconds = timing.pop("first_fence_seconds") - init_start

    on_card = device.type == "cuda"
    device_kind = torch.cuda.get_device_name(device) if on_card else device.type
    step_ms = timing["step_ms"]
    images_per_sec = global_batch / (step_ms / 1000)
    flops_per_step = flops["flops_per_step"]
    return {
        "start_step": 0,
        "final_step": state.step,
        "model": model_name,
        "platform": "gpu" if on_card else device.type,
        "device_kind": device_kind,
        "num_chips": num_chips,
        "data_parallelism": 1,
        "model_parallelism": model_parallelism,
        "global_batch": global_batch,
        "image_size": image_size,
        **timing,
        "images_per_sec": images_per_sec,
        "images_per_sec_per_chip": images_per_sec / num_chips,
        **flops,
        "flops_per_image": (
            flops_per_step / global_batch if flops_per_step else None
        ),
        "mfu": (
            perf.mfu(flops_per_step, step_ms / 1000, num_chips, device_kind)
            if on_card else None
        ),
        "compile_seconds": compile_seconds,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=sorted([*MODELS, "vit"]),
                        default="resnet50")
    parser.add_argument("--batch-per-chip", type=int, default=128)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--steps", type=int, default=30, help="steps per window")
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--windows", type=int, default=3, help="timed windows")
    parser.add_argument(
        "--steps-per-call", type=int, default=0,
        help="optimizer steps per call on the same batch (0 = 1)",
    )
    parser.add_argument("--model-parallelism", type=int, default=1)
    parser.add_argument(
        "--fused-1x1-bwd", action="store_true",
        help="backward of every stride-1 1x1 conv through kernel K4 "
        "(ops/conv_backward.py; CUDA C++, built at first use)",
    )
    parser.add_argument(
        "--remat", action="store_true",
        help="recompute residual blocks in the backward (torch.utils.checkpoint)",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace of one steady-state step into DIR",
    )
    parser.add_argument(
        "--checkpoint-dir", default=None,
        help="checkpoint directory (not ported yet)",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    result = run_benchmark(
        model_name=args.model,
        batch_per_chip=args.batch_per_chip,
        image_size=args.image_size,
        num_classes=args.num_classes,
        steps=args.steps,
        warmup=args.warmup,
        windows=args.windows,
        steps_per_call=args.steps_per_call,
        model_parallelism=args.model_parallelism,
        fused_1x1_bwd=args.fused_1x1_bwd,
        remat=args.remat,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile,
    )
    if args.json:
        print(json.dumps(result, sort_keys=True))
    else:
        print(
            f"{result['model']} on {result['num_chips']} {result['device_kind']}: "
            f"{result['images_per_sec']:.1f} img/s, "
            + perf.timing_summary(result)
            + f" (batch {result['global_batch']}, start-up "
            f"{result['compile_seconds']:.1f}s)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
