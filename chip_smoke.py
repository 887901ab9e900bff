#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout (the port's package sits beside this
script). It needs one CUDA card and takes no arguments. Phases, each of
which raises on failure (exit code not 0, no result line):

1. the card: name and power limit, as nvidia-smi reports them; kernels
   K2 and K4 (CUDA C++, `csrc/flash_attention.cu` and
   `csrc/conv_backward.cu`) start building from the checkout in the
   background, one nvcc each;
2. kernel K1 (Triton, built from the checkout on first launch) against
   its plain PyTorch version on the card: f32 at the ResNet shape
   (256, 1000) and at (4096, 32000), bf16 at the LM shape (8192, 32768),
   with labels -1 and C and tied rows; times the kernel, the plain version
   and the library call `F.cross_entropy` (a yardstick only: the port
   never calls it);
3. one small ResNet-18 train step on the card (through K1) against the
   same step on the CPU (K1's plain version), from one set of weights;
4. kernel K2 against its plain version on the card, forward and
   backward: the LM's (8, 1024, 12, 64) bf16 causal in both layouts, a
   ragged (2, 1000, 4, 64) causal and a (2, 512, 4, 128) full; times the
   forward, the backward and the two together for the kernel, the plain
   version and `F.scaled_dot_product_attention` (a yardstick only),
   and prints the forward's and the backward's time over SDPA's;
5. two bf16 LM train steps (2 layers, 2 heads of 64, seq 128, vocab 512)
   on the card (K1 and K2) against the same steps on the CPU (the plain
   versions), from one set of weights;
6. the ResNet-50 main path: the training benchmark at full width (batch
   256, 224x224 bf16 images, 1000 classes), with K1's launches counted
   around it;
7. the LM main path: the LM training benchmark at its published widths
   (12 layers, 12 heads, embed 768, vocab 32768, seq 1024, batch 8, bf16),
   10 steps a window, with K1's and K2's launches and K2's input copies
   counted around it (the qkv views are read in place: 0 copies); then
   K2's backward device time by kernel (the rows pre-pass, dK/dV, dQ;
   torch.profiler) at the shapes of 4, profiled only now so that no
   profiler session comes before the host-bound LM step;
8. kernel K4 (the fused 1x1-conv backward) against its plain version on
   the card at the 12 stride-1 1x1 shapes of ResNet-50 at batch 256,
   bf16; times the kernel, the plain version and cuDNN's
   `convolution_backward` on the same channels_last tensors (a yardstick
   only), with the kernel's time over cuDNN's at each shape and its
   device time by kernel (dgrad, wgrad, reduction; torch.profiler), and
   sums calls x time per step against the summed bound and cuDNN's sum;
9. two bf16 steps of a small bottleneck ResNet with `fused_1x1_bwd` and
   `fast_pool_bwd` on the card (K1, K4) against the same steps on the CPU
   (the plain versions), from one set of weights;
10. the ResNet-50 fused path: the training benchmark as in 6 with
   `fused_1x1_bwd`, with K1's and K4's launches and K4's layout copies
   counted around it; its FLOP count must equal the default path's, and
   its step is printed beside the default path's;
11. kernel K3 (the int8-KV decode attention, `csrc/decode_attention.cu`)
   against its plain version on the card: the dense `generate` shape
   (8, 12, 640, 64) `blhd` bf16 at pos 0, 127 and 639, a (4, 512, 12, 64)
   cache with per-slot positions, a 5-query verify window, head_dim 16
   (the drafter) and 128, and a head-major `bhld` case; the same engine
   shapes on a paged pool read through page tables (the engine's own
   calls); one query over 65,536 positions; each with q in its dtype and
   in f32; times the kernel and the plain version (no PyTorch call
   computes this function, so there is no library time) and one launch's
   floor (a one-element fill), printed beside K1's (256, 1000) and K3's
   pos-0 times;
12. decode card against CPU on one set of weights: greedy `generate` with
   the int8 cache on f32 and bf16 2-layer LMs (2 heads of 64, vocab 512),
   tokens equal on f32, the logits of every decode step within the stated
   tolerance, the top-2 margin printed; and a small f32 `SlotEngine` with a
   drafter and the int8 cache, tokens equal;
13. the decode main path: `benchmarks.decode.run_benchmark` at its
   defaults (12 layers, 12 heads of 64, embed 768, vocab 32768, bf16,
   batch 8, prompt 128, 512 new tokens) with the bf16 cache, the int8
   cache, and int8 weights with the int8 cache, with K3's launches
   counted around each (exactly num_layers x 511 a call with the int8
   cache, 0 with the bf16 cache); before it, one decode forward of that
   model with each cache: its wall time and the card's busy time by
   operator, K3's row of which is printed beside each int8 run;
14. the serving main path: `run_engine_benchmark` at the LM's full width
   with the int8 cache (cold, warm, spec_base, spec), with K3's launches
   counted around it: cold equals warm, spec equals spec_base, every
   timed request hits the prefix store, none re-prefills the prefix;
15. one engine decode step at that shape (4 slots of 512, pages of 16, 4
   requests of 256 prompt tokens) profiled with torch.profiler: K3's and
   the page gathers' (`aten::index`) device ms and calls a step. With
   `--engine-step` this phase runs alone, on the package beside the
   script;
16. (after 5) two bf16 steps of a small MoE LM (2 layers, 2 heads of 64,
   seq 128, vocab 512, its second block 4 experts, k = 2, capacity factor
   0.5) on the card (K1, K2) against the CPU (the plain versions), with
   the top-k choices the capacity dropped counted and printed; then two
   bf16 steps of a small ViT (2 layers, 2 heads of 64, 32x32 images,
   patch 8, 10 classes) the same way, with dense attention and with
   `flash_attention`;
17. (in 4) K2 at ViT-S/16's attention, (256, 197, 6, 64) bf16
   non-causal: forward and backward against the plain version, timed
   beside the plain version and SDPA, with its bound;
18. (after 7) the ViT main path: the image benchmark with
   model_name="vit" at ViT-S/16's configuration (batch 256, 224x224, 1000
   classes, dense attention as in the reference: 1 K1 launch a step, no
   K2), then the same step with `flash_attention` (12 K2 forward and 12
   backward launches a step, 0 copies of the qkv views), its step beside
   the dense one's and the first step's loss of both;
19. the MoE LM main path: the LM benchmark at its published widths with
   every second block a mixture of 8 experts (k = 2, capacity factor
   1.25): K1 once a step, K2 12 + 12 a step, the router loss of the last
   step;
20. checkpoint and resume: a small MoE LM through the LM benchmark, 6
   steps straight against 3 with `checkpoint_dir` and 3 more in a fresh
   process that restores them (parameters and momentum bit-equal), then
   a torn step 6 that a restore must skip for step 3; restore_seconds;
21. where a ViT-S/16 step and a MoE LM step go on the card
   (torch.profiler, by operator; for the MoE LM, the expert products'
   and the dispatch and combine products' shares);
22. (after 20) the mesh at a world of one over NCCL: a process group of
   one rank from a FileStore and `make_mesh()` (1, 1, 1, 1) on the card;
   the LM of 7 and ResNet-50 with `fused_1x1_bwd` each take a first step
   on the mesh (the gradient all_reduce made) from their default
   weights, held against the single-device step from the same weights:
   equal to the bit, or the largest difference and the single-device
   step's own run-to-run difference; the reduction's own time; then both
   benchmarks' mesh paths with K1's, K2's and K4's launches counted
   around each; ring attention and the vocab-parallel loss at n = 1 on
   CUDA tensors against their plain versions;
23. two processes on the one card over gloo, data parallel: the LM at
   global batch 8 (4 a rank) and ResNet-50 with `fused_1x1_bwd` at 256
   (128 a rank, BatchNorm over the global batch), each rank's first step
   against this process's step on the whole batch, then the step's wall
   time and the gloo all_reduce's share, as two processes sharing one
   card (not a two-card number);
24. (after 21) the pipeline at a world of one over NCCL: the pipelined LM
   (`parallel/pipeline.create_pp_lm_state` and `make_pp_lm_train_step`)
   at the LM's published widths on the (1, 1, 1, 1) mesh in 4
   microbatches; its first update against the dense single-device step's
   from the same weights, as a relative norm within `VIT_UPDATE_REL`;
   K1 once and K2 48 + 48 times in the step, at (2, 1024, 12, 64) (K2 at
   that shape against its plain version in 4); both steps' host-clock
   times;
25. the MoE LM at the published widths (every second block 8 experts) on
   that mesh: its first step with `seq_axis="model"` (one shard, the
   slot offsets from an all_gather of one) equal to the bit to the step
   without a sequence axis;
26. decode over the mesh: `benchmarks.decode.run_benchmark` at its
   defaults with the int8 cache on that mesh, its tokens equal to phase
   13's single-device run's, K3 counted; then two processes sharing the
   card over gloo, 4 of 8 streams each, 128 new tokens (cut from 512 to
   keep the phase short), each rank's tokens equal to this process's
   `generate` of its 4 rows (K3 at a rank's (4, 12, 256, 64) against its
   plain version in 11); tokens/s as two processes sharing one card, not
   a two-card rate; then the same two processes sampled at temperature
   1.5, each rank's tokens equal to its rows of this process's run on all
   8 streams with the same seed;
27. (after 26) the elastic trainer at full width: `parallel/elastic
   .ElasticTrainer` drives the LM of 7 on a one-rank mesh over NCCL,
   with a real `TrainCheckpointer`; a scripted fleet status bumps the
   generation 1 -> 2 at step 3 of 6, and the trainer flushes, leaves the
   group, forms a new one, rebuilds and restores: one resume, 0 steps
   lost, acks notified -> resumed, the final parameters and momentum
   bit-equal to an uninterrupted 6-step run, K1 6 and K2 72 + 72 times;
   the step, save, restore and reconfigure seconds;
28. the SIGKILL drill: two processes of `python -m
   tritonk8ssupervisor_tpu_torch.cli.main train --device cuda --backend
   gloo` on the card (NCCL refuses two ranks on one card), coordinates
   from the `JAX_*` env contract; process 1 SIGKILLed as a process group
   after the first committed checkpoint; once the survivor acknowledges
   notified, the fleet status says generation 2 with slice 1 degraded
   and the env file names one process; the survivor must rejoin at
   world size 1, restore the state the two saved, and reach step 400
   having lost at most 25 steps; the seconds from the kill to its
   notified ack and to its resume;
29. the serving plane at full width: a `Gateway` over a `SlotEngine` of
   the LM at its published widths (512 positions, pages of 16, 4 slots,
   the int8 cache) with the engine benchmark's drafter (spec_k 4; not its
   shared head bias), its request journal and spans fsync'd in a
   temporary workdir as `cli.main serve` wires them; the prefix store
   seeded by one warm-up request; `server.run_drill` with 16 requests of
   64-256 prompt tokens opening with 48-192 tokens of a shared 192-token
   prefix, 64 new tokens each at temperature 0,
   with K3 counted around it, each request's tokens equal to a fresh
   engine's with the prompts run one at a time; then `make_handler` on a
   ThreadingHTTPServer on port 0 (/healthz 200, a plain and a streamed
   /generate equal to the engine alone, 400 for an over-long prompt,
   /metrics); a gateway restarted on the journal answering a completed
   key `replayed` with its tokens and no engine step; `cli.main serve
   --drill 8` on the card. It fails on an engine crash (the loop's
   `crashed`, the `serving_engine_crashed` gauge), an expiry or a
   requeue. It prints the drill's p50 and p99 latency, tokens/s, TTFT,
   the engine-step histogram's count and mean, the span count and K3's
   launches. With `--serving-plane` this phase runs alone;
30. the gateway fleet at full width: `serving/fleet.GatewayFleet` with two
   replicas over two `SlotEngine`s as in 29 (one set of weights, a KV
   pool each, slice leases on the fsync'd event ledger, journal shards
   fsync'd), driven by `drive_fleet` on a wall clock: 8 keyed greedy
   requests, then 16 more (prompts of 64-256 tokens from seed 30, sharing
   no prefix, 64 new tokens each), replica g1 killed at the first step
   boundary at which it holds an in-flight slot and a queued key and
   revived a few seconds later as a standby, and 4 duplicates of
   first-wave keys resubmitted. It fails unless every key settles
   exactly once and none expires, `ServeInvariantChecker.check_fleet`
   over the shards and the ledger finds nothing, the successor's
   adoption re-admitted at least one key, the duplicates are answered
   from the journal with no engine step, every key's tokens equal a
   fresh engine's, g1's slices are revoked and granted again at higher
   epochs, the reassignment comes within one fleet tick and one drive
   pass of the kill, and `cli.main status --json --all` exits 0 with the
   ledger's grant and revoke counts. It prints p50 and p99 latency, TTFT,
   tokens/s, kill-to-reassignment, keys redone and K3's launches. With
   `--gateway-fleet` this phase runs alone.

Phase 6 asserts that the default path launches K4 no time.

It prints the card line, one JSON line with every kernel of the paths
(each with its design and its time over the library call's in this run,
`library_ratio`), and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import math
import os
import pathlib
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import torch
import torch.distributed as dist
import torch.nn.functional as F

import numpy as np

from tritonk8ssupervisor_tpu_torch import obs
from tritonk8ssupervisor_tpu_torch.benchmarks import decode as decode_bench
from tritonk8ssupervisor_tpu_torch.benchmarks import lm as lm_bench
from tritonk8ssupervisor_tpu_torch.benchmarks.resnet50 import run_benchmark
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.models import ResNet18, ResNet50, TransformerLM, ViT
from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.models import moe
from tritonk8ssupervisor_tpu_torch.models.resnet import BottleneckBlock, ResNet
from tritonk8ssupervisor_tpu_torch.models.transformer import dense_attention
from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb
from tritonk8ssupervisor_tpu_torch.ops import conv_backward_cuda
from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce
from tritonk8ssupervisor_tpu_torch.ops import cuda_build
from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da
from tritonk8ssupervisor_tpu_torch.ops import decode_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import attention_reference, ring_attention
from tritonk8ssupervisor_tpu_torch.parallel import checkpoint as ckpt_lib
from tritonk8ssupervisor_tpu_torch.parallel import distributed, elastic
from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu_torch.parallel import pipeline as pp
from tritonk8ssupervisor_tpu_torch.parallel import spmd, train
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks
from tritonk8ssupervisor_tpu_torch.provision import events
from tritonk8ssupervisor_tpu_torch.provision.state import RunPaths
from tritonk8ssupervisor_tpu_torch.serving import SlotEngine, reqlog, server, traffic
from tritonk8ssupervisor_tpu_torch.serving import fleet as fleet_mod
from tritonk8ssupervisor_tpu_torch.serving import gateway as gateway_mod
from tritonk8ssupervisor_tpu_torch.testing import chaos
from tritonk8ssupervisor_tpu_torch.serving.gateway import Request
from tritonk8ssupervisor_tpu_torch.utils import perf
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

# H100 SXM data sheet: device memory rate, f32 rate outside the tensor
# cores (K1's bound), dense bf16/fp16 tensor-core rate (K2's bound)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# K1's f32 work per logit: max, subtract, exp, add, label compare
K1_OPS_PER_LOGIT = 5
# the kernel against its plain version (same f32 arithmetic, reduced in
# another order; exp and log on the card's fast units)
K1_RTOL = K1_ATOL = 1e-5
# K2 against its plain version, relative to the reference's largest
# magnitude (at least 1), as tests/test_torch_kernels.py states: the
# kernel keeps scores in f32 and rounds P and dS to bf16 for the next
# product; the plain version in bf16 also rounds the scores (2e-2); on
# f32 copies of the same inputs it rounds nothing (1e-2)
K2_REL_SAME_DTYPE = 2e-2
K2_REL_F32 = 1e-2
# the loss of one bf16 step on the card against the CPU: bf16 activations
# rounded at other points by cuDNN/cuBLAS/K2 and by the CPU kernels
PARITY_LOSS_ATOL = 2e-2
# ViT-S/16's whole first update with K2 against dense attention, as a
# relative norm: the bf16 gradient tolerance of
# tests/test_torch_transformer.py; dense attention rounds its scores to
# bf16 where K2 keeps them in f32
VIT_UPDATE_REL = 5e-2
# K4 against its plain version (the same exact bf16 products summed in f32
# in other orders): dX, rounded to bf16, relative to its largest
# magnitude; dW, f32 throughout, relative to its own
K4_REL_DX = 1e-2
K4_REL_DW = 1e-3
# a fused step's FLOP count against the default path's
FLOPS_RTOL = 1e-3
K2_SOURCE = "flash_attention.cu"
K4_SOURCE = conv_backward_cuda.SOURCE
K3_SOURCE = decode_attention_cuda.SOURCE
# K3 against its plain version, relative to the reference's own largest
# magnitude, as tests/test_torch_kernels.py states: both compute the same
# f32 output up to summation order and __expf (f32: 2e-5) and round it once
# to q's dtype, so a bf16 or fp16 output differs by at most one ulp at the
# largest magnitude (2^-7, 2^-10). Every shape also runs on f32 copies of q,
# which holds its masks and positions to the f32 limit.
K3_REL = {torch.float32: 2e-5, torch.float16: 2**-10, torch.bfloat16: 2**-7}
# decode logits, card against CPU, teacher-forced on the CPU's tokens: f32
# (cuBLAS without TF32 and K3's __expf against the CPU's kernels) 2e-3; bf16
# (activations rounded to bf16 at other points; a logit near 4 steps by
# 2^-5) four steps
DECODE_LOGITS_ATOL = {torch.float32: 2e-3, torch.bfloat16: 1.25e-1}
# ResNet-50's stride-1 1x1 convolutions at batch 256, 224x224 (the
# stage sizes (3, 4, 6, 3) over models/resnet.py's bottleneck blocks):
# (spatial size, C = dX width, N = dY width, calls per step)
K4_SHAPES = [
    (56, 64, 64, 1), (56, 64, 256, 4), (56, 256, 64, 2), (56, 256, 128, 1),
    (28, 128, 512, 4), (28, 512, 128, 3), (28, 512, 256, 1),
    (14, 256, 1024, 6), (14, 1024, 256, 5), (14, 1024, 512, 1),
    (7, 512, 2048, 3), (7, 2048, 512, 2),
]
K4_BATCH = 256


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _build_in_background(source: str):
    """Start one source's nvcc build, so it overlaps the phases before the
    kernel's own."""
    errors: list[BaseException] = []

    def build():
        try:
            cuda_build.load(source)
        except Exception as exc:  # re-raised by the kernel's phase
            errors.append(exc)

    thread = threading.Thread(target=build, daemon=True)
    thread.start()
    return thread, errors


def _join_build(source: str, build, started: float) -> None:
    thread, errors = build
    thread.join()
    if errors:
        raise errors[0]
    print(f"built: {cuda_build.library_path(source).name} "
          f"({time.monotonic() - started:.1f} s into the run)", flush=True)


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call on the card: CUDA events around back-to-back
    calls. The inputs stay in L2 between calls where they fit, as the
    producer leaves them for the kernel on the main path."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 10) -> float | None:
    """The card's time per call, without the gaps where it waits for the
    host: the card first spins in a sleep kernel while the host queues
    `iters` calls behind it, and CUDA events time the calls from the end
    of the sleep. It counts only when the host finished queueing before
    the sleep ended (else a 4x longer sleep is tried); None if it never
    did. A call whose Python and autograd overhead exceeds its device
    work then still reads what the card spent."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's 1.98 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    return None


def _timings(calls: dict) -> dict:
    """{prefix: (fn, iters)} -> {prefix + "ms": event time, prefix +
    "device_ms": device time}."""
    out = {}
    for prefix, (fn, iters) in calls.items():
        out[f"{prefix}ms"] = _time_ms(fn, iters=iters, warmup=min(20, iters))
        out[f"{prefix}device_ms"] = _device_ms(fn)
    return out


def _kernels_ms(fn, calls: int = 10) -> dict:
    """The card's time per call of each kernel that `fn` launches, by the
    kernel's name, from torch.profiler over `calls` calls; empty when the
    profiler recorded no kernels."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def _max_abs_err(actual: torch.Tensor, expected: torch.Tensor) -> float:
    """max |actual - expected|, with entries where both sides are the same
    infinity counted as equal (inf - inf would read NaN)."""
    actual, expected = actual.float(), expected.float()
    same_inf = torch.isinf(actual) & (actual == expected)
    return torch.where(same_inf, 0.0, (actual - expected).abs()).max().item()


def _bound(n_bytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flops * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _library_ratio(r: dict) -> float | None:
    """The kernel's time over the library call's in this run: device times
    where both were read, else event times; None without a library call."""
    if r.get("library_ms") is None:
        return None
    if r.get("device_ms") is not None and r.get("library_device_ms") is not None:
        return r["device_ms"] / r["library_device_ms"]
    return r["ms"] / r["library_ms"]


def _ratio_text(r: dict, library: str) -> str:
    ratio = _library_ratio(r)
    return "" if ratio is None else f", kernel / {library} {ratio:.2f}x"


def _k1_inputs(batch: int, classes: int, seed: int, dtype: torch.dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(batch, classes, generator=gen, device="cuda") * 4
    labels = torch.randint(0, classes, (batch,), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels[0], labels[1] = -1, classes  # outside [0, C): read incorrect
    for row in range(2, 6):  # two equal maxima, the label on one of them
        top = logits[row].max() + 1.0
        logits[row, 3] = logits[row, classes - 2] = top
        labels[row] = 3 if row % 2 else classes - 2
    return logits.to(dtype), labels


def check_k1(batch: int, classes: int, seed: int, dtype=torch.float32) -> dict:
    logits, labels = _k1_inputs(batch, classes, seed, dtype)
    loss, correct = ce.cross_entropy_forward(logits, labels)
    torch.cuda.synchronize()
    ref_loss, ref_correct = ce.cross_entropy_forward_plain(logits, labels)
    torch.testing.assert_close(loss, ref_loss, rtol=K1_RTOL, atol=K1_ATOL)
    if not torch.equal(correct, ref_correct):
        raise AssertionError(f"K1 correct flags differ at {(batch, classes)}")
    if not correct[2:6].all() or correct[:2].any():
        raise AssertionError("K1: tied labels must read correct, out-of-range incorrect")

    in_range = labels.clamp(0, classes - 1).long()  # the library takes only these
    times = _timings({
        "": (lambda: ce.cross_entropy_forward(logits, labels), 200),
        "plain_": (lambda: ce.cross_entropy_forward_plain(logits, labels), 200),
        "library_": (lambda: F.cross_entropy(logits, in_range, reduction="none"), 200),
    })
    # each input read once, each output written once
    n_bytes = (batch * classes * logits.element_size()
               + batch * (labels.element_size() + 4 + 1))
    bound_ms, bound_by = _bound(n_bytes, batch * classes * K1_OPS_PER_LOGIT, F32_FLOPS)
    return {
        "shape": [batch, classes],
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": _max_abs_err(loss, ref_loss),
        **times,
        "kernel_ms": times["ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def check_parity() -> None:
    """Two bf16 ResNet-18 steps through K1 on the card against the same
    steps through K1's plain version on the CPU, from one set of weights;
    the second step's loss reads the first step's update."""
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(16, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen, dtype=torch.int32)
    losses = {}
    for device in ("cpu", "cuda"):
        model = ResNet18(num_classes=10, num_filters=8,
                         generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, train.default_optimizer(0.1), device)
        step = train.make_train_step(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        before = ce.cross_entropy_forward.launches
        x, y = images.to(device), labels.to(device)
        losses[device] = [step(x, y)["loss"].item() for _ in range(2)]
        launched = ce.cross_entropy_forward.launches - before
        if launched != (2 if device == "cuda" else 0):
            raise AssertionError(f"K1 launched {launched} times on {device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"parity: ResNet-18 bf16 losses over 2 steps, card {losses['cuda']} "
          f"cpu {losses['cpu']}, max |diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL})",
          flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError("card and CPU train steps disagree")


def _attention_grads(fn, q, k, v, dout):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return [out.detach(), q.grad, k.grad, v.grad]


def _grad_calls(fn, q, k, v, dout):
    """(the backward alone, through one saved forward graph; the forward
    and the backward together), as calls to time."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    return (lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True),
            lambda: torch.autograd.grad(fn(q, k, v), (q, k, v), dout))


def _k2_inputs(shape, dtype: torch.dtype, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)]


def check_k2(b: int, s: int, h: int, d: int, causal: bool, layout: str,
             dtype=torch.bfloat16, seed: int = 0) -> dict:
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v, dout = _k2_inputs(shape, dtype, seed)

    def kernel(*x):
        return fa.flash_attention(*x, causal=causal, layout=layout)

    def plain(*x):
        return fa.attention_reference_layout(*x, causal, layout)

    def library(*x):  # SDPA takes (b, h, s, d)
        if layout == "bshd":
            x = [t.transpose(1, 2) for t in x]
        out = F.scaled_dot_product_attention(*x, is_causal=causal)
        return out.transpose(1, 2) if layout == "bshd" else out

    got = _attention_grads(kernel, q, k, v, dout)
    torch.cuda.synchronize()
    same = _attention_grads(plain, q, k, v, dout)
    f32 = _attention_grads(plain, q.float(), k.float(), v.float(), dout.float())
    errors = {}
    for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, same, f32):
        if not torch.isfinite(a).all():
            raise AssertionError(f"K2 {name} not finite at {shape}")
        scale_p = p.float().abs().max().clamp(min=1.0).item()
        scale_e = e.float().abs().max().clamp(min=1.0).item()
        errors[name] = _max_abs_err(a, p)
        rel_p, rel_e = errors[name] / scale_p, _max_abs_err(a, e) / scale_e
        if not (rel_p <= K2_REL_SAME_DTYPE and rel_e <= K2_REL_F32):
            raise AssertionError(
                f"K2 {name} at {shape} {layout} causal={causal}: relative error "
                f"{rel_p:.2e} vs the plain version, {rel_e:.2e} vs f32"
            )

    out, lse = torch.ops.tk8s.flash_attn_fwd(q, k, v, causal, layout)

    grads = {name: _grad_calls(fn, q, k, v, dout)
             for name, fn in (("", kernel), ("plain_", plain), ("library_", library))}
    times = {
        "forward": _timings({"": (lambda: kernel(q, k, v), 100),
                             "plain_": (lambda: plain(q, k, v), 20),
                             "library_": (lambda: library(q, k, v), 100)}),
        # the kernel's backward alone is its op; plain and SDPA go through
        # autograd on a saved forward graph
        "backward": _timings({"": (lambda: torch.ops.tk8s.flash_attn_bwd(
                                  dout, q, k, v, out, lse, causal, layout), 100),
                              "plain_": (grads["plain_"][0], 20),
                              "library_": (grads["library_"][0], 100)}),
        "fwd_bwd": _timings({name: (calls[1], 20 if name == "plain_" else 100)
                             for name, calls in grads.items()}),
    }

    pairs = s * (s + 1) // 2 if causal else s * s
    n, elem = b * s * h * d, q.element_size()
    # forward: q, k, v read, O and the f32 logsumexp written; backward:
    # q, k, v, O, dO and the logsumexp read, dq, dk, dv written, and five
    # products (the kernel recomputes P) against the forward's two
    fwd_bound, fwd_by = _bound(4 * n * elem + b * h * s * 4, 4 * b * h * d * pairs, BF16_FLOPS)
    bwd_bound, bwd_by = _bound(8 * n * elem + b * h * s * 4, 10 * b * h * d * pairs, BF16_FLOPS)
    return {
        "shape": list(shape), "layout": layout, "causal": causal, "seed": seed,
        "dtype": str(dtype).removeprefix("torch."),
        "forward": {"max_abs_err": errors["out"], **times["forward"],
                    "bound_ms": fwd_bound, "bound_by": fwd_by},
        "backward": {"max_abs_err": max(errors["dq"], errors["dk"], errors["dv"]),
                     **times["backward"], "bound_ms": bwd_bound, "bound_by": bwd_by,
                     "forward_and_backward": {**times["fwd_bwd"],
                                              "bound_ms": fwd_bound + bwd_bound}},
    }


def k2_backward_by_kernel(row: dict) -> dict:
    """The device ms of each kernel of one K2 backward call on `row`'s
    inputs (the rows pre-pass, dK/dV, dQ), from torch.profiler. Taken
    after the LM main path: with these sessions before it, the host-bound
    LM step read 80-90 ms on an H100 that reads it at 51-74 ms without."""
    q, k, v, dout = _k2_inputs(row["shape"], getattr(torch, row["dtype"]), row["seed"])
    out, lse = torch.ops.tk8s.flash_attn_fwd(q, k, v, row["causal"], row["layout"])
    return _kernels_ms(lambda: torch.ops.tk8s.flash_attn_bwd(
        dout, q, k, v, out, lse, row["causal"], row["layout"]))


def check_lm_parity() -> None:
    """Two bf16 LM steps through K1 and K2 on the card against the same
    steps through their plain versions on the CPU, from one set of
    weights; the second step's loss reads the first step's update."""
    tokens = torch.randint(0, 512, (4, 128), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    counters = (ce.cross_entropy_forward, fa.flash_attention_forward,
                fa.flash_attention_backward)
    losses = {}
    for device in ("cpu", "cuda"):
        model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                              max_seq_len=128, attention_fn=fa.flash_attention,
                              generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, train.default_optimizer(0.03), device)
        step = train.make_lm_train_step(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        before = [c.launches for c in counters]
        x = tokens.to(device)
        losses[device] = [step(x)["loss"].item() for _ in range(2)]
        launched = [c.launches - n for c, n in zip(counters, before)]
        expected = [2, 4, 4] if device == "cuda" else [0, 0, 0]
        if launched != expected:
            raise AssertionError(f"K1, K2 fwd, K2 bwd launched {launched} times on {device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"parity: LM bf16 losses over 2 steps, card {losses['cuda']} "
          f"cpu {losses['cpu']}, max |diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL})",
          flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError("card and CPU LM train steps disagree")


def run_resnet50(card: str, fused_1x1_bwd: bool = False) -> dict:
    """The ResNet-50 benchmark at batch 256, the default path or the fused
    one; K1's and K4's launches and K4's layout copies counted around it."""
    ce.cross_entropy_forward.launches = 0
    cb.conv1x1_backward_kernel.launches = 0
    cb.conv1x1_backward.copies = 0
    torch.cuda.reset_peak_memory_stats()
    result = run_benchmark(
        model_name="resnet50", batch_per_chip=256, image_size=224,
        num_classes=1000, steps=10, warmup=2, windows=2, fused_1x1_bwd=fused_1x1_bwd,
    )
    k1, k4 = ce.cross_entropy_forward.launches, cb.conv1x1_backward_kernel.launches
    steps = result["final_step"]
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    result["k4_copies_per_step"] = cb.conv1x1_backward.copies / steps
    name = "resnet50_fused_1x1_bwd" if fused_1x1_bwd else "resnet50"
    print(f"{name}: " + json.dumps(result, sort_keys=True), flush=True)
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"{name} path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    k4_per_step = sum(calls for *_, calls in K4_SHAPES) if fused_1x1_bwd else 0
    if (k1, k4) != (steps, k4_per_step * steps):
        raise AssertionError(f"{name}: K1 launched {k1} and K4 {k4} times in {steps} steps")
    mfu = result["mfu"]
    print(f"main path: {name} batch 256 224x224 bf16, "
          f"{result['images_per_sec']:.1f} img/s, step {result['step_ms']:.2f} ms, "
          f"MFU {'not known' if mfu is None else f'{mfu:.4f}'} "
          f"({result['flops_per_step']:.6g} FLOP/step), peak memory "
          f"{result['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} steps: "
          f"K1 {k1}, K4 {k4}, K4 layout copies {result['k4_copies_per_step']:g} a step, "
          f"on {card}", flush=True)
    return {"k1": k1, "k4": k4, **result}


def check_k4(size: int, c: int, n: int, calls: int, seed: int) -> dict:
    """K4 against its plain version at one full-width shape, with the
    times of the kernel, the plain version and cuDNN's backward."""
    m = K4_BATCH * size * size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x2 = torch.randn(m, c, generator=gen, device="cuda").bfloat16()
    dy2 = torch.randn(m, n, generator=gen, device="cuda").bfloat16()
    w2 = (torch.randn(n, c, generator=gen, device="cuda") / c ** 0.5).bfloat16()
    dx, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    ref_dx, ref_dw = cb.conv1x1_backward_plain(x2, dy2, w2, torch.bfloat16)
    err_dx, err_dw = _max_abs_err(dx, ref_dx), _max_abs_err(dw, ref_dw)
    rel_dx = err_dx / ref_dx.float().abs().max().item()
    rel_dw = err_dw / ref_dw.abs().max().item()
    if not (torch.isfinite(dx).all() and torch.isfinite(dw).all()
            and rel_dx <= K4_REL_DX and rel_dw <= K4_REL_DW):
        raise AssertionError(f"K4 at (M, C, N) = {(m, c, n)}: relative error dX "
                             f"{rel_dx:.2e}, dW {rel_dw:.2e}")
    del ref_dx, ref_dw, dx, dw

    # the memory one call holds beyond its inputs and outputs (the dW
    # workspace), measured: the allocator's peak during the call less
    # what it still holds after it, with the outputs alive
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    workspace = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del out

    # cuDNN on the same memory as (256, C, size, size) channels_last tensors
    x4 = x2.view(K4_BATCH, size, size, c).permute(0, 3, 1, 2)
    dy4 = dy2.view(K4_BATCH, size, size, n).permute(0, 3, 1, 2)
    w4 = w2.view(n, c, 1, 1)

    def library():
        return torch.ops.aten.convolution_backward(
            dy4, x4, w4, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, True, False])

    iters = 50 if m * (c + n) < 2e8 else 20
    times = _timings({
        "": (lambda: cb.conv1x1_backward_kernel(x2, dy2, w2), iters),
        "plain_": (lambda: cb.conv1x1_backward_plain(x2, dy2, w2, torch.bfloat16), 10),
        "library_": (library, iters),
    })
    # the call's device time by kernel: dgrad, wgrad and the reduction
    parts = {}
    for key, ms in _kernels_ms(lambda: cb.conv1x1_backward_kernel(x2, dy2, w2)).items():
        part = next((p for p in ("dgrad", "wgrad", "reduce") if p in key), "other")
        parts[part] = parts.get(part, 0.0) + ms
    # X, dY and W read once; dX (bf16) and dW (f32) written once
    n_bytes = 2 * (m * c + m * n + n * c) + 2 * m * c + 4 * n * c
    bound_ms, bound_by = _bound(n_bytes, 4 * m * c * n, BF16_FLOPS)
    return {
        "shape": [m, c, n], "calls_per_step": calls, "dtype": "bfloat16",
        "max_abs_err": err_dx, "max_abs_err_dw": err_dw,
        **times, "bound_ms": bound_ms, "bound_by": bound_by,
        "workspace_bytes": workspace, "device_ms_by_kernel": parts,
    }


def check_fused_parity() -> None:
    """Two bf16 steps of a small bottleneck ResNet with both levers on,
    through K1 and K4 on the card against the same steps through their
    plain versions on the CPU, from one set of weights."""
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(16, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen, dtype=torch.int32)
    losses = {}
    for device in ("cpu", "cuda"):
        model = ResNet(stage_sizes=(1, 1), block_cls=BottleneckBlock, num_classes=10,
                       num_filters=16, fused_1x1_bwd=True, fast_pool_bwd=True,
                       generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, train.default_optimizer(0.1), device)
        step = train.make_train_step(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        before = cb.conv1x1_backward_kernel.launches
        x, y = images.to(device), labels.to(device)
        losses[device] = [step(x, y)["loss"].item() for _ in range(2)]
        launched = cb.conv1x1_backward_kernel.launches - before
        # Conv_0 and Conv_2 of both blocks and stage 0's shortcut, 2 steps
        if launched != (10 if device == "cuda" else 0):
            raise AssertionError(f"K4 launched {launched} times on {device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"parity: fused bottleneck ResNet bf16 losses over 2 steps, card "
          f"{losses['cuda']} cpu {losses['cpu']}, max |diff| {diff:.2e} "
          f"(tolerance {PARITY_LOSS_ATOL})", flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError("card and CPU fused train steps disagree")


def run_lm(card: str) -> dict:
    counters = (ce.cross_entropy_forward, fa.flash_attention_forward,
                fa.flash_attention_backward)
    for counter in counters:
        counter.launches = 0
    fa.flash_attention_forward.copies = 0
    torch.cuda.reset_peak_memory_stats()
    result = lm_bench.run_benchmark(steps=10, warmup=2, windows=2)
    k1, k2_fwd, k2_bwd = (c.launches for c in counters)
    copies = fa.flash_attention_forward.copies
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print("lm: " + json.dumps(result, sort_keys=True), flush=True)
    steps = result["final_step"]
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"LM path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    if result["attention"] != "flash":
        raise AssertionError(f"LM path ran {result['attention']} attention")
    layers = result["num_layers"]
    if (k1, k2_fwd, k2_bwd) != (steps, layers * steps, layers * steps):
        raise AssertionError(
            f"LM path: {steps} steps launched K1 {k1}, K2 forward {k2_fwd} and "
            f"backward {k2_bwd} times ({layers} layers)"
        )
    if copies:
        raise AssertionError(f"LM path: K2's forward copied {copies} of its q, k, v views")
    mfu = result["mfu"]
    print(f"main path: LM 12L/768/seq 1024/batch 8 bf16, "
          f"{result['tokens_per_sec']:.1f} tokens/s, step {result['step_ms']:.2f} ms, "
          f"MFU {'not known' if mfu is None else f'{mfu:.4f}'} "
          f"({result['flops_per_step']:.4g} FLOP/step, {result['flops_source']}), "
          f"peak memory {result['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} "
          f"steps: K1 {k1}, K2 forward {k2_fwd}, K2 backward {k2_bwd}, K2 input copies "
          f"{copies}, on {card}", flush=True)
    return {"k1": k1, "k2_forward": k2_fwd, "k2_backward": k2_bwd, "k2_copies": copies,
            "step_ms": result["step_ms"]}


def _k3_rows(pos, b: int, w: int, length: int) -> list[int]:
    """Positions each batch row of a K3 call reads: [0, max pos] of its
    queries, all L when a pos is negative or past the end."""
    if not isinstance(pos, list):
        pos = [[pos] * w] * b
    rows = [p if isinstance(p, list) else [p] for p in pos]
    return [length if min(r) < 0 else min(max(r) + 1, length) for r in rows]


K3_PAGE_SIZE = 16  # the engine benchmark's page size


def _k3_inputs(b: int, w: int, h: int, length: int, d: int, pos, dtype, layout: str,
               seed: int):
    """q, the cache (dense, or for "paged" a pool of b * length / 16 + 1
    pages of 16 positions read through shuffled tables, one page shared by
    two rows, the last table column on the last page), pos (a list made an
    int32 tensor on the card) and the tables (None when dense)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, w, h, d) if w > 1 else (b, h, d), generator=gen, device="cuda").to(dtype)
    tables = None
    if layout == "paged":
        n_pages = length // K3_PAGE_SIZE
        pages = b * n_pages + 1
        cache_shape = (pages, K3_PAGE_SIZE, h, d)
        tables = torch.randperm(pages - 1, generator=gen, device="cuda")[: b * n_pages]
        tables = tables.view(b, n_pages).to(torch.int32)
        if b > 1:
            tables[1, 0] = tables[0, 1]
        tables[:, -1] = pages - 1
    else:
        cache_shape = (b, h, length, d) if layout == "bhld" else (b, length, h, d)
    k8, ks = dec._quant_kv(torch.randn(cache_shape, generator=gen, device="cuda"))
    v8, vs = dec._quant_kv(torch.randn(cache_shape, generator=gen, device="cuda"))
    pos_arg = torch.tensor(pos, dtype=torch.int32, device="cuda") if isinstance(pos, list) else pos
    return q, k8, ks, v8, vs, pos_arg, tables


def check_k3(label: str, b: int, w: int, h: int, length: int, d: int, pos,
             dtype=torch.bfloat16, layout: str = "blhd", seed: int = 0) -> dict:
    """K3 against its plain version at one shape; `pos` an int or a list
    (per row, or per row and query), made an int32 tensor on the card;
    layout "paged" reads a pool through page tables."""
    q, k8, ks, v8, vs, pos_arg, tables = _k3_inputs(b, w, h, length, d, pos, dtype, layout,
                                                    seed)
    args = (q, k8, ks, v8, vs, pos_arg)
    errors = []  # max |err| with q in its dtype, then in f32
    for q_check in (q, q.float()):
        out = da.decode_attention_int8(q_check, *args[1:], layout=layout, tables=tables)
        torch.cuda.synchronize()
        ref = da.decode_attention_int8_plain(q_check, *args[1:], layout=layout, tables=tables)
        errors.append(_max_abs_err(out, ref))
        rel = errors[-1] / ref.float().abs().max().item()
        if not (torch.isfinite(out).all() and rel <= K3_REL[q_check.dtype]):
            raise AssertionError(f"K3 {label}, q {q_check.dtype}: relative error {rel:.2e} "
                                 f"(tolerance {K3_REL[q_check.dtype]:.2e})")
    times = _timings({
        "": (lambda: da.decode_attention_int8(*args, layout=layout, tables=tables), 200),
        "plain_": (lambda: da.decode_attention_int8_plain(*args, layout=layout, tables=tables),
                   20 if length > 4096 else 50),
    })
    positions = sum(_k3_rows(pos, b, w, length))
    # int8 K and V rows and their f32 scales read once for the positions
    # the queries attend (and the page ids of those positions), q read, out
    # written; 4 D operations a position a query (the two products) and
    # ~10 for the scale, mask and softmax
    n_bytes = h * positions * (2 * d + 2 * 4) + 2 * q.numel() * q.element_size()
    if tables is not None:
        n_bytes += 4 * sum(-(-n // K3_PAGE_SIZE) for n in _k3_rows(pos, b, w, length))
    bound_ms, bound_by = _bound(n_bytes, w * h * positions * (4 * d + 10), F32_FLOPS)
    return {
        "label": label, "shape": [b, w, h, length, d], "layout": layout,
        "dtype": str(dtype).removeprefix("torch."), "pos": pos,
        "max_abs_err": errors[0], "max_abs_err_f32_q": errors[1],
        **times, "kernel_ms": times["ms"],
        "library_ms": None, "library_device_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def launch_floor_ms() -> float | None:
    """The card's time for a one-element in-place fill, timed as the
    kernels are (`_device_ms`): the least a launch costs on this card."""
    x = torch.zeros(1, device="cuda")
    return _device_ms(lambda: x.fill_(1.0), iters=50)


def profile_engine_step(card: str) -> dict:
    """One engine decode step at the engine benchmark's shape (the LM's
    full width, int8 cache, 4 slots of 512, pages of 16; random weights)
    with 4 requests of 256 prompt tokens prefilled: its wall time and the
    card's time by operator from torch.profiler over 5 steps. Returns K3's
    and `aten::index`'s (the page gathers') device ms and calls a step,
    and the step's device total."""
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=512, generator=torch.Generator().manual_seed(1))
    engine = SlotEngine(model, dec.lm_params(model, "cuda"), slots=4, max_len=512,
                        prefill_chunk=64, page_size=K3_PAGE_SIZE, cache_int8=True,
                        prefix_cache=False)
    rng = np.random.default_rng(0)
    for slot in range(engine.slots):
        tokens = rng.integers(0, 32768, 256).astype(np.int32)
        engine.join(slot, Request(rid=slot, prompt_len=256, max_new_tokens=64, tokens=tokens))
    while not engine.active.all():
        engine.step()

    def step():
        return engine._decode(engine.model, engine.params, engine.pool, engine.last,
                              engine.pos, engine.active.copy())

    step()
    torch.cuda.synchronize()
    start = time.monotonic()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - start) / 20 * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    by_op = {e.key: (e.self_device_time_total / 5e3, e.count // 5) for e in ops}
    device_ms = sum(ms for ms, _ in by_op.values()) if ops else None
    k3_ms, k3_calls = by_op.get("tk8s::decode_attn_int8", (0.0, 0))
    gather_ms, gather_calls = by_op.get("aten::index", (0.0, 0))
    result = {"wall_ms": wall_ms, "device_ms": device_ms, "k3_device_ms": k3_ms,
              "k3_calls": k3_calls, "gather_device_ms": gather_ms, "gather_calls": gather_calls,
              "pos": int(engine.pos.max())}
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    print("engine step: " + json.dumps(result, sort_keys=True), flush=True)
    print(f"engine decode step, 4 slots at pos {result['pos']}, int8 cache: wall {wall_ms:.3f} ms, "
          f"card busy {'not measured' if device_ms is None else f'{device_ms:.4f} ms'}; K3 "
          f"{k3_calls} calls {k3_ms:.4f} device ms, page gathers (aten::index) {gather_calls} "
          f"calls {gather_ms:.4f} device ms a step; by operator: " + ", ".join(
              f"{e.key} {e.self_device_time_total / 5e3:.4f} ms ({e.count // 5})" for e in top)
          + f" on {card}", flush=True)
    if device_ms is not None and k3_calls != model.num_layers:
        raise AssertionError(f"engine step: K3 ran {k3_calls} times, not once a layer")
    return result


def _decode_logits(model, params, prompt, tokens) -> torch.Tensor:
    """The logits of every step of `generate` with the int8 cache, fed
    `tokens` (B, N) in turn: (B, N, vocab) f32 on the host."""
    s = prompt.shape[1]
    cache, logits = dec.prefill(model, params, prompt, model.max_seq_len, cache_int8=True)
    steps = [logits]
    for t in range(tokens.shape[1] - 1):
        steps.append(dec.decode_step(model, params, cache, tokens[:, t:t + 1], s + t))
    return torch.stack(steps, 1).float().cpu()


def check_decode_parity() -> None:
    """Greedy int8-cache `generate` of f32 and bf16 2-layer LMs on the card
    (K3) against the CPU (its plain version), from one set of weights."""
    prompt = torch.randint(0, 512, (4, 16), generator=torch.Generator().manual_seed(6))
    for dtype in (torch.float32, torch.bfloat16):
        model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                              max_seq_len=64, dtype=dtype, logits_dtype=dtype,
                              generator=torch.Generator().manual_seed(0))
        tokens, logits = {}, {}
        for device in ("cpu", "cuda"):
            params = dec.lm_params(model, device)
            before = da.decode_attention_kernel.launches
            tokens[device] = dec.generate(model, params, prompt.to(device), 24,
                                          cache_int8=True).cpu()
            launched = da.decode_attention_kernel.launches - before
            if launched != (2 * 23 if device == "cuda" else 0):
                raise AssertionError(f"K3 launched {launched} times on {device}")
            logits[device] = _decode_logits(model, params, prompt.to(device),
                                            tokens["cpu"].to(device))
        diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
        top2 = logits["cpu"].topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).min().item()
        flips = int((tokens["cuda"] != tokens["cpu"]).sum())
        name = str(dtype).removeprefix("torch.")
        print(f"parity: decode {name} int8 cache, 4 x 24 tokens: {flips} tokens differ, max "
              f"|logit diff| {diff:.2e} (tolerance {DECODE_LOGITS_ATOL[dtype]}), min top-2 "
              f"margin {margin:.3e}", flush=True)
        if not diff <= DECODE_LOGITS_ATOL[dtype]:
            raise AssertionError(f"card and CPU decode logits disagree ({name})")
        if dtype == torch.float32 and flips:
            raise AssertionError("card and CPU f32 decode tokens differ")


def check_engine_parity() -> None:
    """A small f32 `SlotEngine` with a drafter and the int8 cache (decode,
    drafter and verify attention through K3) on the card against the CPU,
    from one set of weights: the same tokens."""
    model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                          max_seq_len=64, dtype=torch.float32, logits_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    draft = TransformerLM(vocab_size=512, num_layers=1, num_heads=2, embed_dim=32,
                          max_seq_len=64, dtype=torch.float32, logits_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (10, 20, 14)]
    outs = {}
    for device in ("cpu", "cuda"):
        engine = SlotEngine(model, dec.lm_params(model, device), slots=2, max_len=64,
                            prefill_chunk=8, page_size=8, cache_int8=True, draft_model=draft,
                            draft_params=dec.lm_params(draft, device), spec_k=3)
        before = da.decode_attention_kernel.launches
        outs[device] = decode_bench.drive(engine, prompts, 12)
        launched = da.decode_attention_kernel.launches - before
        if len(outs[device]) != len(prompts):
            raise AssertionError(f"the engine on {device} answered {len(outs[device])} of "
                                 f"{len(prompts)} requests")
        if (launched > 0) != (device == "cuda"):
            raise AssertionError(f"K3 launched {launched} times on {device}")
    print(f"parity: f32 SlotEngine with a drafter, int8 cache, 3 requests x 12 tokens: "
          f"card {'equals' if outs['cuda'] == outs['cpu'] else 'differs from'} CPU", flush=True)
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"engine tokens differ: card {outs['cuda']} cpu {outs['cpu']}")


def profile_decode(card: str) -> dict | None:
    """One decode forward of the decode benchmark's model (batch 8, a
    640-long cache, pos 383: the mean position of a call) with each cache:
    its wall time, and the card's busy time by operator from
    torch.profiler over 5 steps. (A step is ~700 launches, more than the
    launch queue holds behind `_device_ms`'s sleep, so the card's time is
    the profiler's sum of kernel times.) Returns K3's row of the int8
    step, {"device_ms": a step, "calls": a step, "pos": 383}, or None
    when the profiler recorded no K3 kernel."""
    k3 = None
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=640, generator=torch.Generator().manual_seed(1))
    params = dec.lm_params(model, "cuda")
    prompt = torch.randint(0, 32768, (8, 128), generator=torch.Generator().manual_seed(0)).cuda()
    for cache_int8 in (False, True):
        cache, _ = dec.prefill(model, params, prompt, 640, cache_int8=cache_int8)

        def step():
            return dec.decode_step(model, params, cache, prompt[:, :1], 383)

        step()
        torch.cuda.synchronize()
        start = time.monotonic()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) / 20 * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in ops) / 5e3
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
        busy = ("not measured (the profiler recorded no kernels)" if not ops else
                f"{busy_ms:.4f} ms, the card idle {1 - busy_ms / wall_ms:.1%}")
        k3 = next(({"device_ms": e.self_device_time_total / 5e3, "calls": e.count // 5,
                    "pos": 383} for e in ops if e.key == "tk8s::decode_attn_int8"), k3)
        print(f"decode step {'int8' if cache_int8 else 'bf16'} cache, batch 8, pos 383: wall "
              f"{wall_ms:.3f} ms, card busy {busy}; by operator (calls a step): " + ", ".join(
                  f"{e.key} {e.self_device_time_total / 5e3:.4f} ms ({e.count // 5})" for e in top)
              + f" on {card}", flush=True)
    return k3


def run_decode(card: str, k3_step: dict | None) -> tuple[dict, dict]:
    """The decode benchmark at its defaults three ways, with K3's launches
    counted around each; returns them and the int8-cache run's result
    (its tokens kept for phase 26)."""
    launches = {}
    for name, options in (("decode_bf16_cache", {}), ("decode_cache_int8", {"cache_int8": True}),
                          ("decode_int8_weights_cache_int8", {"int8": True, "cache_int8": True})):
        da.decode_attention_kernel.launches = 0
        result = decode_bench.run_benchmark(keep_tokens=True, **options)
        launches[name] = da.decode_attention_kernel.launches
        tokens = result.pop("tokens")
        if name == "decode_cache_int8":
            single = {**result, "tokens": tokens}
        print(f"{name}: " + json.dumps(result, sort_keys=True), flush=True)
        if result["platform"] != "gpu":
            raise AssertionError(f"{name} ran on {result['platform']}")
        calls = 4  # the first call and the 3 timed repeats
        expected = result["num_layers"] * (result["new_tokens"] - 1) * calls
        if launches[name] != (expected if result["cache_int8"] else 0):
            raise AssertionError(f"{name}: K3 launched {launches[name]} times "
                                 f"({expected} expected with the int8 cache)")
        k3_text = ("" if not result["cache_int8"] else
                   ", K3 device time not measured (the profiler recorded no K3 kernel)"
                   if k3_step is None else
                   f", K3 {k3_step['calls']} x {k3_step['device_ms'] / k3_step['calls']:.4f} = "
                   f"{k3_step['device_ms']:.4f} device ms in a step at pos {k3_step['pos']} "
                   f"({k3_step['device_ms'] / result['ms_per_token_per_stream']:.1%} of a "
                   f"step's wall time; torch.profiler)")
        print(f"main path: {name} 12L/768/vocab 32768 bf16, batch 8, prompt 128, 512 new: "
              f"{result['tokens_per_sec']:.1f} tokens/s, "
              f"{result['ms_per_token_per_stream']:.3f} ms a step (ms/token/stream){k3_text}, "
              f"peak memory {result['peak_memory_gb']:.2f} GB, K3 launches "
              f"{launches[name]}, on {card}", flush=True)
    return launches, single


def run_engine(card: str) -> int:
    """The engine benchmark at the LM's full width with the int8 cache, with
    K3's launches counted around it; returns them."""
    da.decode_attention_kernel.launches = 0
    result = decode_bench.run_engine_benchmark(vocab_size=32768, num_layers=12, num_heads=12,
                                               embed_dim=768, cache_int8=True)
    launched = da.decode_attention_kernel.launches
    print("engine: " + json.dumps(result, sort_keys=True), flush=True)
    spec = result["speculative"]
    hits = result["warm"]["prefix"]["hits"]
    if not (result["platform"] == "gpu" and result["token_identical"]
            and spec["token_identical"] and hits >= result["requests"]
            and result["shared_prefix_reprefilled_on_hits"] == 0 and launched > 0):
        raise AssertionError(
            f"engine path: token_identical {result['token_identical']}, spec token_identical "
            f"{spec['token_identical']}, hits {hits}, re-prefilled "
            f"{result['shared_prefix_reprefilled_on_hits']}, K3 launches {launched}")
    print(f"main path: engine 12L/768/vocab 32768 int8 cache, {result['requests']} requests, "
          f"{result['slots']} slots: warm/cold {result['value']}x "
          f"({result['warm']['tokens_per_sec']:.1f} vs {result['cold']['tokens_per_sec']:.1f} "
          f"tokens/s), spec/spec_base {spec['value']}x "
          f"({spec['spec']['tokens_per_sec']:.1f} vs {spec['baseline']['tokens_per_sec']:.1f}), "
          f"acceptance {spec['acceptance_rate']}, cold = warm and spec = spec_base token for "
          f"token, peak memory {result['peak_memory_gb']:.2f} GB, K3 launches {launched}, "
          f"on {card}", flush=True)
    return launched


# Phases of the ViT, the mixture-of-experts LM and checkpointing
MOE_PARITY_CAPACITY_FACTOR = 0.5  # low enough that choices drop
VIT_STEPS = dict(steps=10, warmup=2, windows=2)
MOE_LM_STEPS = dict(steps=10, warmup=2, windows=2)


def _count_drops(model) -> list[int]:
    """Hooks on every MoE block of `model` that append, on each forward,
    the number of top-k choices its capacity dropped (the dispatch
    recomputed from the block's input); returns the list they fill."""
    drops: list[int] = []

    def hook(layer, inputs, _output):
        with torch.no_grad():
            x = inputs[0]
            probs = torch.softmax(x.float() @ layer.router_kernel, dim=-1)
            capacity = moe.compute_capacity(x.shape[1], layer.num_experts, layer.k,
                                            layer.capacity_factor)
            dispatch = moe.top_k_dispatch(probs, layer.k, capacity)[0]
            drops.append(int(x.shape[0] * x.shape[1] * layer.k - dispatch.sum().item()))

    for module in model.modules():
        if isinstance(module, moe.MoEMLP):
            module.register_forward_hook(hook)
    return drops


def _paired_losses(label: str, make_model, batch_on, step_factory, expected: list[int]) -> None:
    """Two bf16 steps of `make_model()` on the card (through K1 and K2)
    and on the CPU (their plain versions), from one set of weights;
    `expected` is K1's, K2's forward's and K2's backward's launches on the
    card. Prints the losses and the choices the MoE blocks dropped."""
    counters = (ce.cross_entropy_forward, fa.flash_attention_forward,
                fa.flash_attention_backward)
    losses, drops = {}, {}
    for device in ("cpu", "cuda"):
        model = make_model()
        drops[device] = _count_drops(model)
        state = train.create_train_state(model, train.default_optimizer(0.03), device)
        step = step_factory(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        before = [c.launches for c in counters]
        batch = batch_on(device)
        losses[device] = [step(*batch)["loss"].item() for _ in range(2)]
        launched = [c.launches - n for c, n in zip(counters, before)]
        if launched != (expected if device == "cuda" else [0, 0, 0]):
            raise AssertionError(f"{label}: K1, K2 fwd, K2 bwd launched {launched} times "
                                 f"on {device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    dropped = (f", top-k choices dropped by capacity a forward: card {drops['cuda']} cpu "
               f"{drops['cpu']}" if drops["cuda"] else "")
    print(f"parity: {label} bf16 losses over 2 steps, card {losses['cuda']} cpu "
          f"{losses['cpu']}, max |diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL}){dropped}",
          flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError(f"card and CPU {label} train steps disagree")
    if drops["cuda"] and not min(drops["cuda"]) > 0:
        raise AssertionError(f"{label}: the capacity dropped no choice")


def check_moe_lm_parity() -> None:
    """Two bf16 steps of a 2-layer LM (2 heads of 64, seq 128, vocab 512)
    whose second block is a mixture of 4 experts (k = 2) at a capacity
    factor that drops choices."""
    tokens = torch.randint(0, 512, (4, 128), generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    _paired_losses(
        "MoE LM",
        lambda: TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                              max_seq_len=128, attention_fn=fa.flash_attention, moe_experts=4,
                              moe_capacity_factor=MOE_PARITY_CAPACITY_FACTOR,
                              generator=torch.Generator().manual_seed(0)),
        lambda device: (tokens.to(device),), train.make_lm_train_step, [2, 4, 4])


def check_vit_parity() -> None:
    """Two bf16 steps of a 2-layer ViT (2 heads of 64, 32x32 images,
    patch 8, 10 classes), with dense attention and with `flash_attention`."""
    gen = torch.Generator().manual_seed(6)
    images = torch.randn(16, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen, dtype=torch.int32)
    for name, attention, k2 in (("dense", dense_attention, 0), ("flash", fa.flash_attention, 4)):
        _paired_losses(
            f"ViT ({name} attention)",
            lambda attention=attention: ViT(
                num_classes=10, patch_size=8, num_layers=2, num_heads=2, embed_dim=128,
                image_size=32, attention_fn=attention, generator=torch.Generator().manual_seed(0)),
            lambda device: (images.to(device), labels.to(device)), train.make_train_step,
            [2, k2, k2])


def _counted(run):
    """run() with K1's, K2's and K4's launch counters and K2's copies set
    to 0 just before it: (its result, {counter: count just after})."""
    ce.cross_entropy_forward.launches = 0
    fa.flash_attention_forward.launches = fa.flash_attention_backward.launches = 0
    fa.flash_attention_forward.copies = 0
    cb.conv1x1_backward_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    result = run()
    return result, {"k1": ce.cross_entropy_forward.launches,
                    "k2_forward": fa.flash_attention_forward.launches,
                    "k2_backward": fa.flash_attention_backward.launches,
                    "k2_copies": fa.flash_attention_forward.copies,
                    "k4": cb.conv1x1_backward_kernel.launches,
                    "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _vit_s16(attention_fn) -> ViT:
    return ViT(num_classes=1000, image_size=224, attention_fn=attention_fn)


def _vit_batch():
    """The image benchmark's synthetic batch at ViT-S/16's configuration."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((256, 224, 224, 3), generator=gen, device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (256,), generator=gen, device="cuda", dtype=torch.int32)
    return images, labels


def run_vit(card: str) -> dict:
    """The ViT main path: the image benchmark with model_name="vit" at
    ViT-S/16's configuration (batch 256, 224x224, 1000 classes; the
    reference's default dense attention), then the same step with
    `flash_attention` (K2), timed by the same windows; from the same
    weights and batch, the first update and the second step's loss of
    both."""
    result, counts = _counted(lambda: run_benchmark(
        model_name="vit", batch_per_chip=256, image_size=224, num_classes=1000, **VIT_STEPS))
    steps = result["final_step"]
    result["peak_memory_bytes"] = counts["peak_memory_bytes"]
    print("vit: " + json.dumps(result, sort_keys=True), flush=True)
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"ViT path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    if (counts["k1"], counts["k2_forward"], counts["k2_backward"]) != (steps, 0, 0):
        raise AssertionError(f"ViT path: {steps} steps launched {counts}")
    mfu = result["mfu"]
    print(f"main path: ViT-S/16 batch 256 224x224 bf16, dense attention, "
          f"{result['images_per_sec']:.1f} img/s, step {result['step_ms']:.2f} ms "
          f"(windows {result['step_ms_windows']}), MFU "
          f"{'not known' if mfu is None else f'{mfu:.4f}'} ({result['flops_per_step']:.6g} "
          f"FLOP/step, {result['flops_source']}), peak memory "
          f"{counts['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} steps: K1 "
          f"{counts['k1']}, K2 0, on {card}", flush=True)

    images, labels = _vit_batch()
    deltas, second = {}, {}
    for name, attention in (("dense", dense_attention), ("flash", fa.flash_attention)):
        state = train.create_train_state(_vit_s16(attention), train.default_optimizer(0.1))
        step = train.make_train_step(state)
        before = torch.cat([p.detach().flatten() for p in state.model.parameters()])
        step(images, labels)
        deltas[name] = torch.cat([p.detach().flatten() for p in state.model.parameters()]) - before
        second[name] = step(images, labels)["loss"].item()
        del state, step, before
    # the first update is -lr (1 + momentum) times the gradient, which runs
    # through K2's forward and backward in all 12 blocks
    rel = ((deltas["flash"] - deltas["dense"]).norm() / deltas["dense"].norm()).item()
    diff = abs(second["flash"] - second["dense"])
    print(f"ViT-S/16 from one set of weights and batch, flash against dense attention: "
          f"first update |d_flash - d_dense| / |d_dense| {rel:.2e} (tolerance {VIT_UPDATE_REL}), "
          f"second-step loss flash {second['flash']:.6f} dense {second['dense']:.6f}, "
          f"|diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL})", flush=True)
    del deltas
    if not (rel <= VIT_UPDATE_REL and diff <= PARITY_LOSS_ATOL):
        raise AssertionError("ViT-S/16: flash and dense attention disagree")

    def flash_run():
        state = train.create_train_state(_vit_s16(fa.flash_attention),
                                         train.default_optimizer(0.1))
        step = train.make_train_step(state)
        timing = perf.timed_windows(lambda: step(images, labels), **VIT_STEPS)
        return {**timing, "steps_run": state.step}

    flash, fcounts = _counted(flash_run)
    fsteps = flash["steps_run"]
    print(f"ViT-S/16 with flash_attention (K2, non-causal, 197 tokens): step "
          f"{flash['step_ms']:.2f} ms (windows {flash['step_ms_windows']}) against dense "
          f"{result['step_ms']:.2f} ms, peak memory {fcounts['peak_memory_bytes'] / 1e9:.2f} GB, "
          f"launches in {fsteps} steps: K1 {fcounts['k1']}, K2 forward "
          f"{fcounts['k2_forward']}, backward {fcounts['k2_backward']}, K2 input copies "
          f"{fcounts['k2_copies']}, on {card}", flush=True)
    layers = 12
    if (fcounts["k1"], fcounts["k2_forward"], fcounts["k2_backward"], fcounts["k2_copies"]) != (
            fsteps, layers * fsteps, layers * fsteps, 0):
        raise AssertionError(f"ViT flash path: {fsteps} steps launched {fcounts}")
    return {"k1": counts["k1"], "k2_forward": 0, "flash_k1": fcounts["k1"],
            "flash_k2_forward": fcounts["k2_forward"],
            "flash_k2_backward": fcounts["k2_backward"], "flash_k2_copies": fcounts["k2_copies"],
            "step_ms": result["step_ms"], "flash_step_ms": flash["step_ms"],
            "flops_per_step": result["flops_per_step"]}


def run_moe_lm(card: str) -> dict:
    """The MoE LM main path: the LM benchmark at its published widths with
    every second block a mixture of 8 experts (k = 2, capacity factor
    1.25)."""
    result, counts = _counted(lambda: lm_bench.run_benchmark(
        moe_experts=8, moe_every=2, **MOE_LM_STEPS))
    steps, layers = result["final_step"], result["num_layers"]
    result["peak_memory_bytes"] = counts["peak_memory_bytes"]
    print("moe_lm: " + json.dumps(result, sort_keys=True), flush=True)
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"MoE LM path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    if not (math.isfinite(result["router_loss"]) and result["router_loss"] > 0):
        raise AssertionError(f"MoE LM path: router loss {result['router_loss']}")
    if (counts["k1"], counts["k2_forward"], counts["k2_backward"], counts["k2_copies"]) != (
            steps, layers * steps, layers * steps, 0):
        raise AssertionError(f"MoE LM path: {steps} steps launched {counts}")
    mfu = result["mfu"]
    print(f"main path: MoE LM 12L/768/seq 1024/batch 8 bf16, 6 blocks of 8 experts (k 2, "
          f"capacity factor 1.25), {result['tokens_per_sec']:.1f} tokens/s, step "
          f"{result['step_ms']:.2f} ms (windows {result['step_ms_windows']}), MFU "
          f"{'not known' if mfu is None else f'{mfu:.4f}'} ({result['flops_per_step']:.4g} "
          f"FLOP/step, {result['flops_source']}; the MoE blocks' dispatch and combine products "
          f"with the one-hots and the expert products at capacity, 320 slots an expert a row, "
          f"are counted), router loss of the last step {result['router_loss']:.6f}, peak memory "
          f"{counts['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} steps: K1 "
          f"{counts['k1']}, K2 forward {counts['k2_forward']}, backward "
          f"{counts['k2_backward']}, K2 input copies {counts['k2_copies']}, on {card}",
          flush=True)
    return {**counts, "step_ms": result["step_ms"]}


CKPT_LM = ["--vocab-size", "512", "--num-layers", "2", "--num-heads", "2", "--embed-dim",
           "128", "--seq-len", "128", "--batch-per-data-shard", "4", "--moe-experts", "4"]


def _lm_kwargs(args: list[str]) -> dict:
    parsed = lm_bench.build_parser().parse_args(args)
    return {k: getattr(parsed, k) for k in (
        "vocab_size", "num_layers", "num_heads", "embed_dim", "seq_len",
        "batch_per_data_shard", "moe_experts", "steps", "warmup", "windows", "checkpoint_dir")}


def _restored(directory: str, step: int | None = None) -> train.TrainState:
    kw = _lm_kwargs(CKPT_LM)
    model = TransformerLM(vocab_size=kw["vocab_size"], num_layers=kw["num_layers"],
                          num_heads=kw["num_heads"], embed_dim=kw["embed_dim"],
                          max_seq_len=kw["seq_len"], moe_experts=kw["moe_experts"],
                          generator=torch.Generator().manual_seed(7))
    state = train.create_train_state(model, train.default_optimizer())
    return ckpt_lib.TrainCheckpointer(directory).restore(state, step)


def check_checkpoint_resume(card: str) -> dict:
    """A small MoE LM through the LM benchmark (K1, K2): 6 steps straight,
    against 3 steps with `checkpoint_dir` and 3 more in a fresh process
    that restores them. The two step-6 checkpoints must be bit-equal
    (tolerance 0: K2's backward has no atomics and every product runs at
    the same shapes). Then the resumed run's step 6 is torn: a restore
    must fall back to step 3."""
    with tempfile.TemporaryDirectory() as root:
        straight, halves = f"{root}/straight", f"{root}/halves"
        lm_bench.run_benchmark(**_lm_kwargs(
            CKPT_LM + ["--steps", "2", "--warmup", "1", "--windows", "2",
                       "--checkpoint-dir", straight]))
        first = lm_bench.run_benchmark(**_lm_kwargs(
            CKPT_LM + ["--steps", "1", "--warmup", "1", "--windows", "1",
                       "--checkpoint-dir", halves]))
        out = subprocess.run(
            [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.benchmarks.lm", *CKPT_LM,
             "--steps", "1", "--warmup", "1", "--windows", "1", "--checkpoint-dir", halves,
             "--json"], capture_output=True, text=True, timeout=300,
            cwd=pathlib.Path(__file__).resolve().parent)
        if out.returncode:
            raise AssertionError(f"the resumed run failed: {out.stderr[-2000:]}")
        second = json.loads(out.stdout.strip().splitlines()[-1])
        if (first["final_step"], second["start_step"], second["final_step"]) != (3, 3, 6):
            raise AssertionError(f"resume: first run ended at {first['final_step']}, the "
                                 f"second ran {second['start_step']} -> {second['final_step']}")
        a, b = _restored(straight), _restored(halves)
        diffs = [(x.float() - y.float()).abs().max().item()
                 for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values())]
        diffs += [(a.optimizer.state[p]["momentum_buffer"]
                   - b.optimizer.state[q]["momentum_buffer"]).abs().max().item()
                  for p, q in zip(a.model.parameters(), b.model.parameters())]
        steps = (a.step, b.step)
        for f in pathlib.Path(halves, "6").rglob("*"):  # torn, its marker intact
            if f.is_file():
                f.write_bytes(b"x")
        fallback = _restored(halves).step
    result = {"steps": steps, "max_abs_diff": max(diffs), "fallback_step": fallback,
              "restore_seconds": second["restore_seconds"]}
    print(f"checkpoint: 6 LM steps straight against 3 + save + a fresh process that restores "
          f"and runs 3: steps {steps}, max |diff| over parameters and momentum "
          f"{result['max_abs_diff']:.3g} (tolerance 0), restore_seconds "
          f"{result['restore_seconds']:.4f}; the resumed run's step 6 torn: restore fell back "
          f"to step {fallback}, on {card}", flush=True)
    if steps != (6, 6) or result["max_abs_diff"] != 0.0 or fallback != 3:
        raise AssertionError(f"checkpoint resume: {result}")
    return result


def _profile_step(step, steps: int = 2):
    """step() run `steps` times under torch.profiler after one warm call:
    (wall ms a step, the card's busy ms a step, the operator rows grouped
    by input shape)."""
    step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        start = time.monotonic()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) / steps * 1e3
    rows = prof.key_averages(group_by_input_shape=True)
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA) / steps / 1e3
    ops = [e for e in rows if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    return wall_ms, busy, ops


def _by_operator(ops, steps: int = 2) -> dict:
    out: dict[str, float] = {}
    for e in ops:
        out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / steps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_breakdowns(card: str) -> dict:
    """Where a ViT-S/16 step (dense attention, the benchmark's path) and a
    MoE LM step go on the card, from torch.profiler over 2 steps; for the
    MoE LM, the einsum products (aten::bmm: the only bmm calls of that
    step) split by shape into the expert products (a dimension of the
    3072-wide FFN) and the dispatch and combine products (the rest; their
    forward and backward products have the same shapes, so they are
    summed together). Run last: a profiler session slows later host-bound
    paths."""
    out = {}
    images, labels = _vit_batch()
    state = train.create_train_state(_vit_s16(dense_attention), train.default_optimizer(0.1))
    step = train.make_train_step(state)
    wall, busy, ops = _profile_step(lambda: step(images, labels))
    out["vit"] = {"wall_ms": wall, "device_ms": busy,
                  "by_operator": dict(list(_by_operator(ops).items())[:10])}
    del state, step

    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=1024, attention_fn=fa.flash_attention, moe_experts=8)
    state = train.create_train_state(model, train.default_optimizer(0.03))
    lm_step = train.make_lm_train_step(state)
    tokens = _lm_tokens()
    wall, busy, ops = _profile_step(lambda: lm_step(tokens))
    expert = sum(e.self_device_time_total for e in ops if e.key == "aten::bmm"
                 and any(3072 in shape for shape in e.input_shapes)) / 2e3
    bmm = sum(e.self_device_time_total for e in ops if e.key == "aten::bmm") / 2e3
    out["moe_lm"] = {"wall_ms": wall, "device_ms": busy, "expert_products_ms": expert,
                     "dispatch_and_combine_products_ms": bmm - expert,
                     "by_operator": dict(list(_by_operator(ops).items())[:10])}
    del state, lm_step
    for name, r in out.items():
        shares = (f"; expert products {r['expert_products_ms']:.3f} ms "
                  f"({r['expert_products_ms'] / r['device_ms']:.1%}), dispatch and combine "
                  f"products {r['dispatch_and_combine_products_ms']:.3f} ms "
                  f"({r['dispatch_and_combine_products_ms'] / r['device_ms']:.1%})"
                  if name == "moe_lm" else "")
        print(f"profile: {name} step, wall {r['wall_ms']:.2f} ms, card busy "
              f"{r['device_ms']:.3f} ms (idle {1 - r['device_ms'] / r['wall_ms']:.1%}, an upper "
              f"bound: the profiler's own host cost){shares}; by operator: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["by_operator"].items()) + f" on {card}",
              flush=True)
    return out


# slice 9: the mesh. The mesh paths' steps (a few: the LM step is host-bound)
MESH_STEPS = dict(steps=5, warmup=1, windows=2)
MESH_LR = {"lm": 3e-2, "resnet50": 0.1}
# the first update of 2 ranks sharing the card (each on half of the batch,
# bf16; for ResNet-50, BatchNorm over the global batch by gloo) against one
# process on the whole batch, as max |d_ranks - d_one| / max |d_one|: the
# bf16 tolerance of VIT_UPDATE_REL (other GEMM shapes round the bf16
# activations at other points; the sums cross ranks in another order)
DP_UPDATE_REL = 5e-2
# ring attention at n = 1 against the plain version on f32 copies of its
# bf16 inputs, relative to the plain version's largest magnitude (at least
# 1), as K2's: the ring rounds its scores to bf16 (its einsum runs in q's
# dtype, as the reference's does) and its output once
RING_REL = 2e-2
# the vocab-parallel loss at n = 1 against the plain f32 loss and gradient
VP_ATOL = 1e-5


def _lm_model():
    """The LM benchmark's model at its published widths (its default
    weights: the seed-0 generator)."""
    return TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                         max_seq_len=1024, attention_fn=fa.flash_attention)


def _lm_tokens():
    return torch.randint(0, 32768, (8, 1024), generator=torch.Generator(device="cuda")
                         .manual_seed(1), device="cuda", dtype=torch.int32)


def _resnet_model():
    return ResNet50(num_classes=1000, fused_1x1_bwd=True)


def _resnet_batch():
    """The image benchmark's synthetic batch at batch 256, 224x224."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((256, 224, 224, 3), generator=gen, device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (256,), generator=gen, device="cuda", dtype=torch.int32)
    return images, labels


MESH_MODELS = {
    "lm": (_lm_model, lambda: (_lm_tokens(),), train.make_lm_train_step),
    "resnet50": (_resnet_model, _resnet_batch, train.make_train_step),
}


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _first_step(name: str, mesh=None, shard=None) -> dict:
    """One step of `name`'s model from its default weights: loss, the
    parameters before and after (this rank's, where `shard` cuts the
    batch)."""
    make_model, make_batch, make_step = MESH_MODELS[name]
    state = train.create_train_state(make_model(), train.default_optimizer(MESH_LR[name]),
                                     "cuda", mesh=mesh)
    step = make_step(state)
    batch = make_batch()
    if shard is not None:
        batch = tuple(shard(x) for x in batch)
    before = _params(state.model)
    loss = step(*batch)["loss"].item()
    return {"loss": loss, "before": before, "after": _params(state.model),
            "state": state, "step": step, "batch": batch}


def _update_diff(ours: dict, ref_after: dict, before: dict) -> tuple[float, float]:
    """(max |ours - ref|, that over the reference's largest update)."""
    diff = max((ours[n] - ref_after[n]).abs().max().item() for n in ours)
    update = max((ref_after[n] - before[n]).abs().max().item() for n in ours)
    return diff, diff / update


def _reduce_ms(state) -> dict:
    """The gradient reduction of a mesh step alone (flatten, all_reduce,
    copies back), by CUDA events and on the card's own clock."""
    def reduce():
        spmd.reduce_gradients(state.model, state.mesh, state.specs,
                              spmd.split_axes(state.mesh, None))

    grads = sum(p.grad.numel() for p in state.model.parameters() if p.grad is not None)
    # two calls behind the sleep: a call launches a copy per parameter
    # (~150-160), and ten would fill the launch queue, which blocks the
    # host until the sleep ends
    return {"ms": _time_ms(reduce, iters=20, warmup=3), "device_ms": _device_ms(reduce, iters=2),
            "gradient_bytes": 4 * grads}


def check_mesh_ops(mesh, card: str) -> dict:
    """`ring_attention` and `vocab_parallel_cross_entropy` at n = 1 on CUDA
    tensors against their plain counterparts."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(2, 512, 4, 64, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    out = {}
    for causal in (True, False):
        ring = ring_attention(q, k, v, mesh=mesh, axis_name="model", causal=causal)
        ref = attention_reference(q.float(), k.float(), v.float(), causal=causal)
        out[f"ring_causal_{causal}_rel"] = (_max_abs_err(ring, ref)
                                            / max(1.0, ref.abs().max().item()))
    logits = torch.randn(256, 1000, generator=gen, device="cuda").requires_grad_()
    labels = torch.randint(0, 1000, (256,), generator=gen, device="cuda")
    with torch.no_grad():  # a tie: row 0's label shares the row's max
        logits[0, labels[0]] = logits[0, (labels[0] + 1) % 1000] = logits[0].max() + 1
    g = torch.randn(256, generator=gen, device="cuda")
    losses, correct = ce.vocab_parallel_cross_entropy(logits, labels, mesh_lib.mesh_group(mesh, "model"))
    (losses * g).sum().backward()
    ref_losses, ref_correct = ce.cross_entropy_loss_and_correct_reference(logits.detach(), labels)
    ref_grad = (torch.softmax(logits.detach(), -1)
                - F.one_hot(labels.long(), 1000).float()) * g[:, None]
    out["vp_loss_err"] = _max_abs_err(losses, ref_losses)
    out["vp_grad_err"] = _max_abs_err(logits.grad, ref_grad)
    out["vp_correct_equal"] = bool(torch.equal(correct, ref_correct)) and bool(correct[0])
    print(f"mesh ops at n = 1 on the card: ring attention (2, 512, 4, 64) bf16 against the plain "
          f"version on f32 copies, max |err| / max(1, max |plain|) causal {out['ring_causal_True_rel']:.2e}, "
          f"full {out['ring_causal_False_rel']:.2e} (tolerance {RING_REL}); vocab-parallel "
          f"cross-entropy (256, 1000) f32 against the plain loss: max |err| loss "
          f"{out['vp_loss_err']:.2e}, dlogits {out['vp_grad_err']:.2e} (tolerance {VP_ATOL}), "
          f"correct equal (a tie included): {out['vp_correct_equal']}, on {card}", flush=True)
    if not (out["ring_causal_True_rel"] <= RING_REL and out["ring_causal_False_rel"] <= RING_REL
            and out["vp_loss_err"] <= VP_ATOL and out["vp_grad_err"] <= VP_ATOL
            and out["vp_correct_equal"]):
        raise AssertionError(f"mesh ops disagree with their plain versions: {out}")
    return out


def run_mesh_one_rank(card: str, lm_single_ms: float) -> dict:
    """The mesh path at a world of one, over NCCL: a process group of one
    rank from a FileStore, `make_mesh()` (1, 1, 1, 1) on the card. For the
    LM (K2 forward and backward, K1) and ResNet-50 with `fused_1x1_bwd`
    (K4, K1): the first step from the default weights on the mesh against
    the single-device step, whose loss and update it should equal to the
    bit (the reduction over one rank copies); then the benchmarks' mesh
    paths with K1's, K2's and K4's launches counted; the reduction's own
    cost; the mesh ops at n = 1."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            if tuple(mesh.shape) != (1, 1, 1, 1):
                raise AssertionError(f"make_mesh() at a world of one: {mesh}")
            for name in MESH_MODELS:
                single = _first_step(name)
                ref_loss, ref_after, before = single["loss"], single["after"], single["before"]
                del single
                ours, counts = _counted(lambda: _first_step(name, mesh))
                diff, rel = _update_diff(ours["after"], ref_after, before)
                ours_loss = ours["loss"]
                equal = ours_loss == ref_loss and diff == 0.0
                reduce = _reduce_ms(ours["state"])
                del ours
                spread = None
                if not equal:  # the single-device step's own run-to-run difference
                    again = _first_step(name)
                    spread = _update_diff(again["after"], ref_after, before)[0]
                    del again
                del ref_after, before
                torch.cuda.empty_cache()
                device_ms = ("not measured" if reduce["device_ms"] is None
                             else f"{reduce['device_ms']:.3f} ms")
                print(f"mesh ({name}), one rank over NCCL, first step from the default weights "
                      f"against the single-device step: loss {ours_loss!r} against "
                      f"{ref_loss!r}, equal to the bit (loss and every parameter): {equal}; "
                      f"max |param diff| {diff:.3g} ({rel:.3g} of the largest update); "
                      f"launches in the step {counts}; the gradient reduction alone "
                      f"({reduce['gradient_bytes'] / 1e6:.1f} MB of f32 gradients flattened, "
                      f"all_reduce over one rank, copied back) {reduce['ms']:.3f} ms (device "
                      f"{device_ms}), on {card}", flush=True)
                if not equal:
                    why = ("the card's own run-to-run variation: the single-device step run "
                           f"twice differs by {spread:.3g}" if spread else
                           "not known: the single-device step repeats to the bit")
                    print(f"mesh ({name}): not equal to the bit, the largest parameter "
                          f"difference is {diff:.3g}; why: {why}", flush=True)
                if rel > DP_UPDATE_REL:
                    raise AssertionError(f"mesh ({name}) at one rank: update off by {rel:.3g}")
                out[name] = {"bit_equal": equal, "max_abs_diff": diff, "update_rel": rel,
                             "single_run_to_run": spread, "first_step_launches": counts,
                             "reduce": reduce}
            lm, counts = _counted(lambda: lm_bench.run_benchmark(**MESH_STEPS))
            steps = lm["final_step"]
            if lm["num_chips"] != 1 or (counts["k1"], counts["k2_forward"],
                                        counts["k2_backward"]) != (steps, 12 * steps, 12 * steps):
                raise AssertionError(f"mesh LM path: {steps} steps, {lm['num_chips']} "
                                     f"ranks, launches {counts}")
            resnet, rcounts = _counted(lambda: run_benchmark(
                model_name="resnet50", batch_per_chip=256, image_size=224, num_classes=1000,
                fused_1x1_bwd=True, **MESH_STEPS))
            rsteps = resnet["final_step"]
            k4_per_step = sum(calls for *_, calls in K4_SHAPES)
            if (rcounts["k1"], rcounts["k4"]) != (rsteps, k4_per_step * rsteps):
                raise AssertionError(f"mesh ResNet-50 path: {rsteps} steps, launches {rcounts}")
            for label, r, c, single in (
                    ("LM 12L/768/seq 1024/batch 8", lm, counts,
                     f"the single-device path's {lm_single_ms:.2f} ms earlier in this run"),
                    ("ResNet-50 fused_1x1_bwd batch 256", resnet, rcounts,
                     "the single-device fused path, timed later in this run")):
                print(f"main path on the mesh, one rank over NCCL: {label}, step "
                      f"{r['step_ms']:.2f} ms (windows {r['step_ms_windows']}) against "
                      f"{single}, final loss "
                      f"{r['final_loss']:.6f}, launches in {r['final_step']} steps: K1 "
                      f"{c['k1']}, K2 forward {c['k2_forward']}, K2 backward "
                      f"{c['k2_backward']}, K2 input copies {c['k2_copies']}, K4 {c['k4']}, "
                      f"on {card}", flush=True)
            out["lm_path"] = {**counts, "step_ms": lm["step_ms"], "steps": steps}
            out["resnet50_fused_1x1_bwd_path"] = {**rcounts, "step_ms": resnet["step_ms"],
                                                  "steps": rsteps}
            out["ops"] = check_mesh_ops(mesh, card)
        finally:
            dist.destroy_process_group()
    return out


def two_rank_step(name: str, reference_path: str, timed_steps: int) -> dict:
    """One rank of the two-process data-parallel phase (gloo, both on the
    one card): the first step on this rank's half of the batch against the
    one-process step's parameters at `reference_path`, then `timed_steps`
    steps timed on the host clock, the reduction (gloo all_reduce of the
    CUDA gradients) timed apart."""
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.make_mesh(device_type="cuda")
    reduce_s: list[float] = []
    reduce = spmd.reduce_gradients

    def timed_reduce(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(*args)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    spmd.reduce_gradients = timed_reduce
    try:
        first = _first_step(name, mesh, shard=lambda x: batch_shard(mesh, x))
        ref = torch.load(reference_path, map_location="cuda")
        diff, rel = _update_diff(first["after"], ref["after"], first["before"])
        step, batch = first["step"], first["batch"]
        times = []
        for _ in range(timed_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*batch)["loss"].item()
            times.append(time.perf_counter() - t0)
        reduce_ms = 1e3 * statistics.median(reduce_s[1:])
    finally:
        spmd.reduce_gradients = reduce
    # this rank's kernels in one more step (torch.profiler), after the timing
    _, device_ms, _ = _profile_step(lambda: step(*batch)["loss"].item(), steps=1)
    return {"loss": first["loss"], "ref_loss": ref["loss"], "max_abs_diff": diff,
            "update_rel": rel, "step_ms": 1e3 * statistics.median(times),
            "reduce_ms": reduce_ms, "device_ms": device_ms,
            "batch_per_rank": batch[0].shape[0]}


def run_two_ranks(card: str) -> dict:
    """Data parallelism in two processes on the one card over gloo: the LM
    (global batch 8, 4 a rank) and ResNet-50 with `fused_1x1_bwd` (256,
    128 a rank, BatchNorm over the global batch), each first step against
    this process's step on the whole batch."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, global_batch, unit in (("lm", 8 * 1024, "tokens"),
                                         ("resnet50", 256, "images")):
            single = _first_step(name)
            path = f"{tmp}/{name}.pt"
            torch.save({"loss": single["loss"], "after": single["after"]}, path)
            del single
            torch.cuda.empty_cache()
            ranks = run_ranks(two_rank_step, 2, args=(name, path, 3), backend="gloo",
                              timeout=600, threads=4)
            r = ranks[0]
            loss_diff = abs(r["loss"] - r["ref_loss"])
            rate = global_batch / (max(x["step_ms"] for x in ranks) / 1e3)
            print(f"two ranks (gloo) on one card, {name} data parallel, {r['batch_per_rank']} "
                  f"a rank: first-step loss {r['loss']:.6f} against one process's "
                  f"{r['ref_loss']:.6f} (|diff| {loss_diff:.2e}, tolerance {PARITY_LOSS_ATOL}), "
                  f"first update max |diff| {r['max_abs_diff']:.3g} = {r['update_rel']:.3g} of "
                  f"the largest (tolerance {DP_UPDATE_REL}); step {r['step_ms']:.1f} ms wall "
                  f"(rank 1 {ranks[1]['step_ms']:.1f}), of which the gloo gradient all_reduce "
                  f"{r['reduce_ms']:.1f} ms; the card busy with a step's kernels "
                  f"{r['device_ms']:.1f} + {ranks[1]['device_ms']:.1f} ms (rank 0 + rank 1, "
                  f"torch.profiler); {rate:.1f} {unit}/s by two processes sharing one card "
                  f"(not a two-card number), on {card}", flush=True)
            if not (loss_diff <= PARITY_LOSS_ATOL and all(
                    x["update_rel"] <= DP_UPDATE_REL for x in ranks)):
                raise AssertionError(f"two ranks ({name}) disagree with one process: {ranks}")
            out[name] = {"ranks": ranks, "rate_per_s": rate, "unit": unit}
    return out


# slice 10: the pipeline over "pipe", sequence-parallel MoE blocks and
# decode over a mesh
PP_MICROBATCHES = 4
# steps timed on the host clock, each ended by a host copy of its loss
PP_TIMED_STEPS = 5
# the two-process decode: 128 new tokens, one timed call after the first
# (the one-rank run of phase 26 keeps the defaults)
TWO_RANK_DECODE = dict(new_tokens=128, repeats=1)
# the sampled run of the two-process decode
DECODE_TEMPERATURE = 1.5


def _pp_params_as_dense(pp_model) -> dict:
    """A `PipelinedLM`'s parameters at one rank (every stage) under the
    dense LM's names."""
    named = dict(pp_model.named_parameters())
    out = {k.removeprefix("outer."): p.detach().clone() for k, p in named.items()
           if k.startswith("outer.")}
    stages = {k.removeprefix("stages."): p.detach()[0] for k, p in named.items()
              if k.startswith("stages.")}
    out.update({k: v.clone() for k, v in pp.unstack_block_params(stages, pp_model.num_layers)
                .items()})
    return out


def _step_ms(step, batch: tuple, steps: int) -> list[float]:
    """Host-clock ms of each of `steps` steps, each ended by a host copy of
    its loss."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step(*batch)["loss"].item()
        times.append(1e3 * (time.perf_counter() - start))
    return times


def run_pipeline_one_rank(card: str, mesh) -> dict:
    """Phase 24: the pipelined LM at the LM's published widths on the
    (1, 1, 1, 1) mesh, 4 microbatches: its first update against the dense
    single-device step's from the same weights, K1's and K2's launches in
    it, both steps' host-clock times, then where each step goes on the
    card (torch.profiler, after the timing)."""
    single = _first_step("lm")
    ref_after, before, ref_loss = single["after"], single["before"], single["loss"]
    dense_ms = _step_ms(single["step"], single["batch"], PP_TIMED_STEPS)
    state = pp.create_pp_lm_state(_lm_model(), train.default_optimizer(MESH_LR["lm"]), mesh,
                                  "cuda")
    step = pp.make_pp_lm_train_step(state, PP_MICROBATCHES)
    tokens = _lm_tokens()
    loss, counts = _counted(lambda: step(tokens)["loss"].item())
    after = _pp_params_as_dense(state.model)
    num = math.sqrt(sum((after[n] - ref_after[n]).double().norm().item() ** 2 for n in after))
    den = math.sqrt(sum((ref_after[n] - before[n]).double().norm().item() ** 2 for n in after))
    rel = num / den
    pp_ms = _step_ms(step, (tokens,), PP_TIMED_STEPS)
    profiles = {}
    for name, run in (("pipelined", lambda: step(tokens)["loss"].item()),
                      ("dense", lambda: single["step"](*single["batch"])["loss"].item())):
        wall, busy, ops = _profile_step(run)
        profiles[name] = {"wall_ms": wall, "device_ms": busy,
                          "by_operator": dict(list(_by_operator(ops).items())[:8])}
    del state, step, after, ref_after, before, single
    torch.cuda.empty_cache()
    layers = 12
    expected = (1, layers * PP_MICROBATCHES, layers * PP_MICROBATCHES)
    got = (counts["k1"], counts["k2_forward"], counts["k2_backward"])
    print(f"pipeline (phase 24), one rank over NCCL, LM 12L/768/seq 1024/batch 8 bf16 in "
          f"{PP_MICROBATCHES} microbatches of (2, 1024): first step loss {loss!r} against the "
          f"dense single-device step's {ref_loss!r}; first update |d_pp - d_dense| / |d_dense| "
          f"{rel:.3e} (tolerance {VIT_UPDATE_REL}); launches in the step: K1 {got[0]}, K2 "
          f"forward {got[1]}, backward {got[2]} (expected {expected}), K2 input copies "
          f"{counts['k2_copies']}, peak memory {counts['peak_memory_bytes'] / 1e9:.2f} GB; "
          f"step ms (host clock, {PP_TIMED_STEPS} steps) pipelined median "
          f"{statistics.median(pp_ms):.2f} {[round(t, 2) for t in pp_ms]} against dense median "
          f"{statistics.median(dense_ms):.2f} {[round(t, 2) for t in dense_ms]}, on {card}",
          flush=True)
    for name, r in profiles.items():
        print(f"profile: {name} LM step (phase 24), wall {r['wall_ms']:.2f} ms, card busy "
              f"{r['device_ms']:.3f} ms (idle {1 - r['device_ms'] / r['wall_ms']:.1%}, an upper "
              f"bound: the profiler's own host cost); by operator: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["by_operator"].items()) + f" on {card}",
              flush=True)
    if got != expected or not rel <= VIT_UPDATE_REL or abs(loss - ref_loss) > PARITY_LOSS_ATOL:
        raise AssertionError(f"pipeline at one rank: launches {got}, update {rel:.3g}, "
                             f"loss {loss} against {ref_loss}")
    return {**counts, "update_rel": rel, "loss": loss, "dense_loss": ref_loss,
            "step_ms": statistics.median(pp_ms), "step_ms_all": pp_ms,
            "dense_step_ms": statistics.median(dense_ms), "dense_step_ms_all": dense_ms,
            "profiles": profiles}


def run_moe_seq_one_rank(card: str, mesh) -> dict:
    """Phase 25: the MoE LM at the LM's published widths (every second
    block 8 experts) on the (1, 1, 1, 1) mesh, its first step with
    seq_axis="model" (one shard: the slot offsets from an all_gather of
    one, all zero) against the step without a sequence axis: equal to the
    bit."""
    out = {}
    for seq_axis in (None, "model"):
        model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                              max_seq_len=1024, attention_fn=fa.flash_attention,
                              moe_experts=8, moe_every=2, moe_mesh=mesh)
        state = train.create_train_state(model, train.default_optimizer(MESH_LR["lm"]),
                                         "cuda", mesh=mesh)
        step = train.make_lm_train_step(state, seq_axis=seq_axis)
        metrics, counts = _counted(lambda: {k: v.item() for k, v in step(_lm_tokens()).items()})
        out[seq_axis] = {"metrics": metrics, "params": _params(model), "counts": counts}
        del model, state, step
        torch.cuda.empty_cache()
    plain, seq = out[None], out["model"]
    equal = plain["metrics"] == seq["metrics"] and all(
        torch.equal(v, seq["params"][k]) for k, v in plain["params"].items())
    diff = max((v - seq["params"][k]).abs().max().item() for k, v in plain["params"].items())
    print(f"MoE LM with seq_axis='model' (phase 25), one rank over NCCL, 12L/768/seq 1024/batch "
          f"8 bf16, 6 blocks of 8 experts: first step {seq['metrics']} against the step without a "
          f"sequence axis {plain['metrics']}, equal to the bit (metrics and every parameter): "
          f"{equal}, max |param diff| {diff:.3g}; launches K1 {seq['counts']['k1']}, K2 "
          f"{seq['counts']['k2_forward']} + {seq['counts']['k2_backward']}, on {card}",
          flush=True)
    if not equal:
        raise AssertionError("MoE LM: the step with a sequence axis of one differs")
    return {"bit_equal": equal, "metrics": seq["metrics"],
            **{k: seq["counts"][k] for k in ("k1", "k2_forward", "k2_backward")}}


def run_decode_mesh_one_rank(card: str, single: dict) -> dict:
    """Phase 26, first part: the decode benchmark at its defaults with the
    int8 cache on the (1, 1, 1, 1) mesh over NCCL: the tokens of phase
    13's single-device run, K3 12 x 511 times a call."""
    da.decode_attention_kernel.launches = 0
    result = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True)
    launches = da.decode_attention_kernel.launches
    # the first call and the 3 timed repeats
    expected = result["num_layers"] * (result["new_tokens"] - 1) * 4
    equal = result["tokens"] == single["tokens"]
    print(f"decode over the mesh (phase 26), one rank over NCCL, defaults with the int8 cache: "
          f"num_chips {result['num_chips']}, {result['tokens_per_sec']:.1f} tokens/s, "
          f"{result['ms_per_token_per_stream']:.3f} ms a step against the single-device run's "
          f"{single['ms_per_token_per_stream']:.3f}; tokens equal the single-device run's: "
          f"{equal}; K3 launches {launches} (expected {expected}), on {card}", flush=True)
    if not equal or result["num_chips"] != 1 or launches != expected:
        raise AssertionError(f"decode over the mesh: tokens equal {equal}, launches {launches}")
    return {"k3": launches, "tokens_per_sec": result["tokens_per_sec"],
            "ms_per_token_per_stream": result["ms_per_token_per_stream"]}


def two_rank_decode(options: dict) -> dict:
    """One rank of the two-process decode (gloo, both on the one card): the
    benchmark with the int8 cache on this rank's 4 of the 8 streams, greedy
    and then sampled at DECODE_TEMPERATURE."""
    torch.cuda.set_device(0)
    da.decode_attention_kernel.launches = 0
    result = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True, **options)
    k3 = da.decode_attention_kernel.launches
    sampled = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True,
                                         temperature=DECODE_TEMPERATURE, **options)
    return {**result, "k3": k3, "sampled_tokens": sampled["tokens"]}


def run_two_rank_decode(card: str) -> dict:
    """Phase 26, second part: two processes sharing the card over gloo, 4
    of 8 streams each; each rank's tokens against this process's
    `generate` of the same 4 rows."""
    ranks = run_ranks(two_rank_decode, 2, args=(TWO_RANK_DECODE,), backend="gloo", timeout=600,
                      threads=4)
    new = TWO_RANK_DECODE["new_tokens"]
    max_len = 128 + new
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=max_len, generator=torch.Generator().manual_seed(1))
    params = dec.lm_params(model, "cuda")
    prompt = torch.randint(0, 32768, (8, 128), generator=torch.Generator().manual_seed(0))
    equal = [dec.generate(model, params, prompt[4 * r:4 * r + 4].cuda(), new, max_len=max_len,
                          cache_int8=True).cpu().tolist() == ranks[r]["tokens"] for r in range(2)]
    # sampled: each rank's rows of one process's run on the 8 streams with
    # the same seed (every rank draws the whole batch's noise)
    single = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True,
                                        temperature=DECODE_TEMPERATURE, **TWO_RANK_DECODE)
    sampled_equal = [single["tokens"][4 * r:4 * r + 4] == ranks[r]["sampled_tokens"]
                     for r in range(2)]
    distinct = single["tokens"][:4] != single["tokens"][4:]
    print(f"sampled decode in two processes (gloo) on one card (phase 26), temperature "
          f"{DECODE_TEMPERATURE}: each rank's tokens equal its rows of one process's run on the 8 "
          f"streams with the same seed: {sampled_equal}; the halves differ: {distinct}, on "
          f"{card}", flush=True)
    if not (all(sampled_equal) and distinct):
        raise AssertionError(f"sampled two-process decode: equal {sampled_equal}, halves "
                             f"differ {distinct}")
    r = ranks[0]
    expected = 12 * (new - 1) * (1 + TWO_RANK_DECODE["repeats"])
    print(f"decode in two processes (gloo) on one card (phase 26), 4 of 8 streams each, "
          f"{new} new tokens, int8 cache: num_chips {r['num_chips']}, {r['tokens_per_sec']:.1f} "
          f"tokens/s by two processes sharing one card (not a two-card number; the slowest "
          f"rank's time), {r['ms_per_token_per_stream']:.3f} ms a step; each rank's tokens equal "
          f"this process's generate of its 4 rows: {equal}; K3 launches {r['k3']} + "
          f"{ranks[1]['k3']} (expected {expected} each), on {card}", flush=True)
    if not all(equal) or r["num_chips"] != 2 or any(x["k3"] != expected for x in ranks):
        raise AssertionError(f"two-process decode: equal {equal}, ranks {ranks}")
    return {"k3": [x["k3"] for x in ranks], "tokens_per_sec": r["tokens_per_sec"],
            "ms_per_token_per_stream": r["ms_per_token_per_stream"],
            "sampled_equal": sampled_equal}


def run_slice10(card: str, decode_single: dict) -> dict:
    """Phases 24-26: a process group of one rank over NCCL for the
    pipeline, the MoE LM's sequence axis and decode over the mesh; then
    decode in two processes over gloo."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            out["pipeline"] = run_pipeline_one_rank(card, mesh)
            out["moe_seq_axis"] = run_moe_seq_one_rank(card, mesh)
            out["decode_mesh"] = run_decode_mesh_one_rank(card, decode_single)
        finally:
            dist.destroy_process_group()
    out["decode_two_ranks"] = run_two_rank_decode(card)
    return out


# slice 11: the elastic trainer at full width, and the train drill's SIGKILL
ELASTIC_STEPS = 6
# the generation goes 1 -> 2 at this step's boundary
ELASTIC_BUMP_AT = 3
ELASTIC_EVERY = 2
# the drill in two processes: long enough that the kill lands mid-run
DRILL_STEPS = 400
DRILL_EVERY = 25
# a phase of the drill that does not finish in this time fails
DRILL_TIMEOUT_S = 300.0


def _elastic_tokens(step: int) -> torch.Tensor:
    """Step `step`'s batch of the LM of 7: the same in every run."""
    return torch.randint(0, 32768, (8, 1024), generator=torch.Generator(device="cuda")
                         .manual_seed(1000 + step), device="cuda", dtype=torch.int32)


def _lm_values(state) -> dict:
    out = {f"param.{n}": p.detach().clone() for n, p in state.model.named_parameters()}
    for n, p in state.model.named_parameters():
        out[f"momentum.{n}"] = state.optimizer.state[p]["momentum_buffer"].clone()
    return out


class _AckLog(elastic.JobAck):
    """The job-ack file, with the phases written in order."""

    def __init__(self, path) -> None:
        super().__init__(path)
        self.phases: list[str] = []

    def write(self, phase: str, *args, **kwargs) -> None:
        super().write(phase, *args, **kwargs)
        self.phases.append(phase)


class _TimedCheckpoint(elastic.ElasticCheckpoint):
    """ElasticCheckpoint with its saves' and restores' seconds kept."""

    def __init__(self, factory) -> None:
        super().__init__(factory)
        self.seconds: dict[str, list[float]] = {"save": [], "restore": []}

    def save(self, step: int, state) -> None:
        t0 = time.monotonic()
        super().save(step, state)
        torch.cuda.synchronize()
        self.seconds["save"].append(time.monotonic() - t0)

    def restore(self, state, shardings=None, step=None):
        t0 = time.monotonic()
        out = super().restore(state, shardings, step)
        torch.cuda.synchronize()
        self.seconds["restore"].append(time.monotonic() - t0)
        return out


def run_elastic_one_rank(card: str) -> dict:
    """Phase 27: `parallel/elastic.ElasticTrainer` driving the LM of 7 at its
    published widths (K1, K2) on a one-rank mesh over NCCL. A scripted
    fleet status bumps the generation 1 -> 2 at the step-3 boundary of 6:
    the trainer flushes a real `TrainCheckpointer` checkpoint, leaves the
    group (`distributed.shutdown`), forms a new one-rank group, rebuilds
    the state from fresh weights and restores. Its final parameters and
    momentum must equal an uninterrupted 6-step run's to the bit, with one
    resume, 0 steps lost, acks notified -> resumed, and K1 once and K2
    12 + 12 times a step."""
    with tempfile.TemporaryDirectory() as tmp:
        stores = iter(range(1000))

        def join():
            dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store{next(stores)}", 1),
                                    rank=0, world_size=1)
            return None  # the world of one the trainer reports

        def setup() -> elastic.TrainSession:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            state = train.create_train_state(_lm_model(), train.default_optimizer(MESH_LR["lm"]),
                                             "cuda", mesh=mesh)
            return elastic.TrainSession(state, None,
                                        elastic.state_step_fn(train.make_lm_train_step(state)),
                                        mesh)

        def batch_fn(session, step: int) -> tuple:
            return (_elastic_tokens(step),)

        # the uninterrupted run, on the same mesh path
        join()
        try:
            session = setup()
            times = []
            for i in range(ELASTIC_STEPS):
                t0 = time.monotonic()
                session.step_fn(session.state, *batch_fn(session, i))[1]["loss"].item()
                times.append(1e3 * (time.monotonic() - t0))
            straight = _lm_values(session.state)
            del session
        finally:
            distributed.shutdown()
        torch.cuda.empty_cache()

        views = ([elastic.FleetView(generation=1, heal_in_progress=False, verdict="healthy")]
                 * (ELASTIC_BUMP_AT + 1)
                 + [elastic.FleetView(generation=2, heal_in_progress=False, verdict="healthy")])
        ack = _AckLog(f"{tmp}/job-ack.json")
        ckpt = _TimedCheckpoint(lambda: ckpt_lib.TrainCheckpointer(f"{tmp}/ckpt"))
        trainer = elastic.ElasticTrainer(
            setup, batch_fn, checkpoint=ckpt, health=elastic.ScriptedHealthSource(views),
            policy=elastic.ElasticPolicy(checkpoint_every=ELASTIC_EVERY), ack=ack,
            init_fn=join, shutdown_fn=distributed.shutdown, drain_fn=None,
            echo=lambda line: print(f"phase 27: {line}", flush=True))
        try:
            report, counts = _counted(lambda: trainer.run(ELASTIC_STEPS))
            resumed = _lm_values(trainer.session.state)
            final_step = trainer.session.state.step
        finally:
            trainer.session = None
            distributed.shutdown()
    diffs = [(resumed[k] - v).abs().max().item() for k, v in straight.items()]
    max_diff = max(diffs)
    resume = report["resumes"][0] if report["resumes"] else None
    reconfigure_s = resume["ts"] - resume["notice_ts"] if resume else float("nan")
    out = {"report": report, "ack_phases": ack.phases, "max_abs_diff": max_diff,
           "bit_equal": max_diff == 0.0, "final_step": final_step, "launches": counts,
           "step_ms": times, "save_s": ckpt.seconds["save"],
           "restore_s": ckpt.seconds["restore"], "reconfigure_s": reconfigure_s}
    print(f"elastic trainer (phase 27), LM 12L/768/seq 1024/batch 8 bf16 on a one-rank NCCL mesh, "
          f"generation 1 -> 2 at step {ELASTIC_BUMP_AT} of {ELASTIC_STEPS}: resumes "
          f"{len(report['resumes'])}, steps lost {report['steps_lost']}, acks {ack.phases}; final "
          f"parameters and momentum against an uninterrupted run: max |diff| {max_diff!r} "
          f"(tolerance 0); launches in the trainer's run {counts}; uninterrupted step ms "
          f"{[round(t, 2) for t in times]} (host clock, each ended by loss.item()); saves "
          f"{[round(t, 3) for t in ckpt.seconds['save']]} s, restore "
          f"{[round(t, 3) for t in ckpt.seconds['restore']]} s, reconfigure (flush, leave, "
          f"rejoin, rebuild, restore) {reconfigure_s:.3f} s, on {card}", flush=True)
    if (len(report["resumes"]) != 1 or report["steps_lost"] != 0 or final_step != ELASTIC_STEPS
            or ack.phases != ["notified", "resumed"] or max_diff != 0.0):
        raise AssertionError(f"elastic trainer at a world of one: {out}")
    if (counts["k1"], counts["k2_forward"], counts["k2_backward"]) != (
            ELASTIC_STEPS, 12 * ELASTIC_STEPS, 12 * ELASTIC_STEPS):
        raise AssertionError(f"elastic trainer: launches {counts} in {ELASTIC_STEPS} steps")
    return out


def _write_json(path: pathlib.Path, doc: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(doc))
    tmp.replace(path)


def _fleet_status(generation: int, degraded: list[int]) -> dict:
    return {"verdict": "degraded" if degraded else "healthy", "updated": time.time(),
            "membership": {"generation": generation, "heal_in_progress": False,
                           "draining": []}, "degraded": degraded}


def _wait_for(predicate, what: str, procs) -> float:
    """Poll `predicate` until it holds; its time on the monotonic clock.
    Fails at DRILL_TIMEOUT_S or when a process ends first."""
    deadline = time.monotonic() + DRILL_TIMEOUT_S
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"SIGKILL drill: {what} did not happen in {DRILL_TIMEOUT_S} s")
        if any(p.poll() is not None for p in procs):
            raise AssertionError(f"SIGKILL drill: a process ended before {what}: "
                                 + "\n".join(p.communicate()[0][-3000:] for p in procs
                                             if p.poll() is not None))
        time.sleep(0.01)
    return time.monotonic()


def run_sigkill_drill(card: str) -> dict:
    """Phase 28: two processes of `cli.main train --device cuda --backend
    gloo` (NCCL refuses two ranks on one card), their coordinates from the
    `JAX_*` env contract. After the first committed checkpoint, process 1
    is SIGKILLed as a process group. Once the survivor acknowledges
    `notified` (its step's gloo all_reduce failed), the fleet status says
    generation 2 with slice 1 degraded and the env file names one process.
    The survivor must rejoin at world size 1, restore the state two ranks
    saved, and reach the last step having lost at most one checkpoint
    interval, acknowledging degraded or resumed."""
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        status, env_file, ckpt = tmp / "fleet-status.json", tmp / "cluster.env", tmp / "ckpt"
        _write_json(status, _fleet_status(1, []))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        base = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "TK8S_"))}
        procs = []
        try:
            for pid in (0, 1):
                argv = [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.cli.main", "train",
                        "--device", "cuda", "--backend", "gloo", "--workdir", str(tmp),
                        "--checkpoint-dir", str(ckpt), "--steps", str(DRILL_STEPS),
                        "--checkpoint-every", str(DRILL_EVERY), "--status-file", str(status),
                        "--ack-file", str(tmp / f"ack-{pid}.json"), "--env-file", str(env_file),
                        "--max-wait", "60", "--max-degraded", "1",
                        "--train-report", str(tmp / f"report-{pid}.json"), "--yes"]
                env = {**base, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid),
                       "OMP_NUM_THREADS": "2"}
                procs.append(subprocess.Popen(argv, env=env, cwd=root, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True,
                                              start_new_session=True))
            markers = ckpt / ckpt_lib.COMMIT_DIR
            started = time.monotonic()
            _wait_for(lambda: markers.is_dir() and any(int(m.name) >= DRILL_EVERY
                                                        for m in markers.iterdir()),
                      "a committed checkpoint", procs)
            committed = max(int(m.name) for m in markers.iterdir())
            os.killpg(procs[1].pid, signal.SIGKILL)
            killed = time.monotonic()
            # the step both processes saved (the survivor prunes it later)
            two_rank_files = len(list((ckpt / str(committed)).glob("*.distcp")))
            ack = tmp / "ack-0.json"

            def acked(phase: str) -> bool:
                try:
                    return json.loads(ack.read_text())["phase"] == phase
                except (OSError, ValueError):
                    return False

            notified = _wait_for(lambda: acked("notified"), "the survivor's notified ack",
                                 procs[:1])
            # the supervisor's side: slice 1 gone, no heal coming, one process
            env_file.write_text("JAX_NUM_PROCESSES=1\nJAX_PROCESS_ID=0\n")
            _write_json(status, _fleet_status(2, [1]))
            out = procs[0].communicate(timeout=DRILL_TIMEOUT_S)[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
        if procs[0].returncode != 0:
            raise AssertionError(f"SIGKILL drill: the survivor failed:\n{out[-4000:]}")
        report = json.loads((tmp / "report-0.json").read_text())
        final_ack = json.loads(ack.read_text())
    resume = report["resumes"][0] if report["resumes"] else {}
    result = {"report": report, "final_ack": final_ack["phase"],
              "first_committed_step": committed, "killed_after_s": killed - started,
              "kill_to_notified_s": notified - killed,
              # the survivor's resume stamp is on the host's monotonic clock
              "kill_to_resume_s": resume.get("ts", float("nan")) - killed,
              "files_in_two_rank_step": two_rank_files}
    print(f"SIGKILL drill (phase 28), two processes of cli.main train --device cuda "
          f"--backend gloo on one card, {DRILL_STEPS} steps, checkpoint every {DRILL_EVERY}: "
          f"process 1 killed after step {committed} committed; the survivor acknowledged "
          f"notified {result['kill_to_notified_s']:.3f} s after the kill (its failed all_reduce), "
          f"resumed {result['kill_to_resume_s']:.3f} s after it (the fleet status was rewritten "
          f"once it acknowledged), at step {resume.get('resumed_step')} of "
          f"{resume.get('at_step')} (lost {report['steps_lost']}), world size "
          f"{report['world']}, final step {report['final_step']}, last ack "
          f"{final_ack['phase']}, on {card}", flush=True)
    if not (report["final_step"] == DRILL_STEPS and report["world"] == 1
            and len(report["resumes"]) == 1 and report["steps_lost"] <= DRILL_EVERY
            and final_ack["phase"] in ("degraded", "resumed") and two_rank_files == 2
            and resume.get("resumed_step", -1) >= committed):
        raise AssertionError(f"SIGKILL drill: {result}")
    return result


def run_slice11(card: str) -> dict:
    """Phases 27-28."""
    return {"elastic_one_rank": run_elastic_one_rank(card), "sigkill_drill": run_sigkill_drill(card)}


# ---------------------------------------------------------------------------
# Phase 29: the serving plane at full width on the card

SERVE_SLOTS = 4
SERVE_MAX_LEN = 512
SERVE_PREFIX = 192  # the shared system prompt, as the engine benchmark's
SERVE_NEW_TOKENS = 64
SERVE_SPEC_K = 4
SERVE_REQUESTS = 16
# the drill's prompts, cycled over its requests: (tokens of the shared
# prefix, a whole number of pages; then tokens of its own), 64-256 in all
SERVE_PROMPTS = ((48, 16), (112, 16), (192, 8), (192, 64))
# a drill that has not settled in this time fails the phase
SERVE_TIMEOUT_S = 180.0
HTTP_TIMEOUT_S = 120


def _serving_models():
    """The LM at its published widths and the engine benchmark's drafter
    (1 layer, 2 heads, embed 32, from the same seeds), on the card. The
    benchmark's shared lm_head bias is left out: it makes every greedy
    token the bias's top token, which would leave the token-identity
    check nothing to compare. Without it the drafter's proposals are
    rejected and every round rolls back."""
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=SERVE_MAX_LEN, generator=torch.Generator().manual_seed(1))
    draft = TransformerLM(vocab_size=32768, num_layers=1, num_heads=2, embed_dim=32,
                          max_seq_len=SERVE_MAX_LEN, generator=torch.Generator().manual_seed(5))
    return model, dec.lm_params(model, "cuda"), draft, dec.lm_params(draft, "cuda")


def _serving_prompts() -> tuple[list, np.ndarray]:
    """The drill's prompts and the warm-up prompt (the whole prefix and 16
    tokens of its own) that seeds the prefix store before either run, so
    that every request matches the same prefix pages in the drill and in
    the engine alone, and prefills the same chunks."""
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, 32768, SERVE_PREFIX)

    def prompt(shared: int, own: int) -> np.ndarray:
        return np.concatenate([prefix[:shared], rng.integers(0, 32768, own)]).astype(np.int32)

    prompts = [prompt(*SERVE_PROMPTS[i % len(SERVE_PROMPTS)]) for i in range(SERVE_REQUESTS)]
    return prompts, prompt(SERVE_PREFIX, 16)


def _serving_engine(model, params, draft, draft_params, tracer=None,
                    slice_index: int = 0) -> SlotEngine:
    return SlotEngine(model, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      prefill_chunk=64, page_size=K3_PAGE_SIZE, cache_int8=True,
                      draft_model=draft, draft_params=draft_params, spec_k=SERVE_SPEC_K,
                      tracer=tracer, slice_index=slice_index)


def _percentile(values: list, q: float) -> float:
    """The gateway's percentile (`GatewayMetrics.percentile`): the sample
    at round(q * (n - 1)) of the sorted values."""
    values = sorted(values)
    return values[min(len(values) - 1, max(0, int(round(q * (len(values) - 1)))))]


def _serving_policy():
    return gateway_mod.GatewayPolicy(
        max_seq_len=SERVE_MAX_LEN, slots_per_slice=SERVE_SLOTS, prefill_chunk=64,
        bucket_bounds=(64, 128, 256), page_size=K3_PAGE_SIZE, spec_k=SERVE_SPEC_K)


def _check_serving(what: str, report: dict, crashed) -> None:
    """The phase fails on an engine crash, an expiry or a requeue: the
    engine loop's containment must not hide a CUDA error on the card."""
    if (crashed is not None or report["serving"]["engine_failures"]
            or report["expired"] or report["requeued_after_slice_loss"]):
        raise AssertionError(
            f"{what}: engine crashed {crashed!r}, engine failures "
            f"{report['serving']['engine_failures']}, expired {report['expired']}, requeued "
            f"{report['requeued_after_slice_loss']}")


def _http_generate(port: int, doc: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/generate", body=json.dumps(doc),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _http_get(port: int, path: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def check_http(gateway, prompts: list, alone: list) -> dict:
    """`make_handler` on a ThreadingHTTPServer on port 0 over the drill's
    gateway, as tests/test_serving.py starts it: /healthz 200, a plain and
    a streamed /generate equal to the engine alone for their prompt, a 400
    for an over-long prompt, /metrics with the completion counter and the
    step histogram."""
    lock = threading.Lock()
    loop = server.EngineLoop(gateway, lock)
    http_server = ThreadingHTTPServer(("127.0.0.1", 0),
                                      server.make_handler(gateway, lock, loop=loop))
    port = http_server.server_address[1]
    thread = threading.Thread(target=http_server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    # the 200- and 64-token prompts: the pages of their own tokens that the
    # drill registered lie past their match cap (prompt_len - 1 tokens), so
    # they match the same prefix pages as in the engine alone and prefill
    # the same chunks. A longer match moves the chunk boundaries, and a
    # position inside the chunk attends its fresh K/V where it would read
    # the int8 pool: other bits, and bf16 logits tie often enough at this
    # width for that to change a greedy token
    plain_i = SERVE_PROMPTS.index((192, 8))
    stream_i = SERVE_PROMPTS.index((48, 16))
    loop.start()
    thread.start()
    try:
        health, _ = _http_get(port, "/healthz")
        status, body = _http_generate(port, {"tokens": prompts[plain_i].tolist(),
                                             "max_new_tokens": SERVE_NEW_TOKENS})
        plain = json.loads(body)["tokens"] if status == 200 else None
        stream_status, body = _http_generate(port, {"tokens": prompts[stream_i].tolist(),
                                                    "max_new_tokens": SERVE_NEW_TOKENS,
                                                    "stream": True})
        lines = [json.loads(line) for line in body.decode().splitlines()]
        streamed = [t for line in lines[:-1] for t in line["tokens"]]
        streamed_tail = lines[-1].get("tokens") if lines else None
        too_long, _ = _http_generate(port, {"tokens": [1] * (SERVE_MAX_LEN + 1),
                                            "max_new_tokens": 4})
        metrics_status, metrics_body = _http_get(port, "/metrics")
    finally:
        http_server.shutdown()
        http_server.server_close()
        loop.stop()
    text = metrics_body.decode()
    out = {"healthz": health, "plain_status": status, "stream_status": stream_status,
           "too_long": too_long, "metrics_status": metrics_status,
           "plain_equal": plain == alone[plain_i],
           "stream_equal": streamed == streamed_tail == alone[stream_i],
           "stream_chunks": len(lines) - 1,
           "metrics_has": all(name in text for name in ("serving_requests_completed_total",
                                                         "serving_engine_step_seconds"))}
    if not (health == status == stream_status == metrics_status == 200 and too_long == 400
            and out["plain_equal"] and out["stream_equal"] and out["metrics_has"]):
        raise AssertionError(f"HTTP over the full-width gateway: {out}")
    _check_serving("HTTP", gateway.report(), loop.crashed)
    return out


def check_recover(workdir: pathlib.Path, engine, results: dict) -> dict:
    """A gateway restarted on the drill's request log: `recover()` makes the
    completed keys answerable; a resubmitted key is answered `replayed`
    with the recorded tokens (`results`: key -> the journal's tokens), and
    the engine takes no step for it."""
    gateway = gateway_mod.Gateway(
        {0: engine}, None, policy=_serving_policy(),
        reqlog=reqlog.RequestLog(RunPaths(workdir).request_log, echo=lambda line: None))
    counts = gateway.recover(time.monotonic())
    key = sorted(results)[0]
    steps, launches = engine.steps, da.decode_attention_kernel.launches
    admission = gateway.submit(gateway_mod.Request(
        rid=99, prompt_len=4, max_new_tokens=SERVE_NEW_TOKENS,
        tokens=np.arange(4, dtype=np.int32), key=key), time.monotonic())
    out = {"recover": counts, "key": key, "reason": admission.reason,
           "tokens_equal": (admission.result or {}).get("tokens") == results[key],
           "engine_steps": engine.steps - steps,
           "k3_launches": da.decode_attention_kernel.launches - launches}
    if not (admission.reason == gateway_mod.REPLAYED and out["tokens_equal"]
            and out["engine_steps"] == out["k3_launches"] == 0
            and counts["completed_cached"] == SERVE_REQUESTS and counts["redone"] == 0):
        raise AssertionError(f"recover over the drill's journal: {out}")
    return out


def run_cli_drill(workdir: pathlib.Path) -> dict:
    """`cli.main serve --drill 8` on the card at the reference's drill size
    (its own f32 model and drafter); its output goes to a buffer, its last
    line is printed."""
    report_path = workdir / "cli-report.json"
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        rc = cli.main(["serve", "--drill", "8", "--workdir", str(workdir),
                       "--serve-report", str(report_path)])
    report = json.loads(report_path.read_text())
    out = {"rc": rc, "completed": report["completed"], "submitted": report["submitted"],
           "tokens_generated": report["tokens_generated"],
           "p50_latency_s": report["p50_latency_s"], "last_line": buffer.getvalue()
           .strip().splitlines()[-1]}
    if rc != 0 or not report["completed"] == report["submitted"] == 8:
        raise AssertionError(f"cli.main serve --drill 8: {out}")
    _check_serving("the CLI drill", report, None)
    return out


def run_serving_plane(card: str) -> dict:
    """Phase 29: the gateway over the full-width int8-cache `SlotEngine` with
    a drafter, journal and telemetry wired as `cli.main serve` wires them
    (spans and journal records fsync'd): a 16-request drill token-identical
    to the engine alone, K3 counted around it; HTTP; recover; the CLI
    drill."""
    started = time.monotonic()
    model, params, draft, draft_params = _serving_models()
    prompts, warm = _serving_prompts()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = pathlib.Path(tmp)
        paths = RunPaths(workdir)
        telemetry = obs.Telemetry.for_run(paths, clock=time.monotonic, incarnation=os.getpid(),
                                          echo=lambda line: print(line, flush=True))
        engine = _serving_engine(model, params, draft, draft_params, telemetry.tracer)
        decode_bench.drive(engine, [warm], 1)  # seeds the prefix store
        gateway = gateway_mod.Gateway(
            {0: engine}, None, policy=_serving_policy(),
            reqlog=reqlog.RequestLog(paths.request_log, echo=lambda line: print(line)),
            telemetry=telemetry, demand_path=paths.demand_signal)
        gateway.recover(time.monotonic())
        da.decode_attention_kernel.launches = 0
        drill_start = time.monotonic()
        report = server.run_drill(gateway, SERVE_REQUESTS, vocab_size=32768,
                                  max_new_tokens=SERVE_NEW_TOKENS, prompts=prompts,
                                  timeout_s=SERVE_TIMEOUT_S)
        drill_s = time.monotonic() - drill_start
        launched = da.decode_attention_kernel.launches
        crashed = telemetry.metrics.get("serving_engine_crashed").value()
        _check_serving("the drill", report, None if not crashed else "the crash gauge is 1")
        if report["completed"] != SERVE_REQUESTS or launched == 0:
            raise AssertionError(f"drill: {report['completed']} of {SERVE_REQUESTS} completed, "
                                 f"K3 launches {launched}")
        served = [r["tokens"] for r in report["results"]]
        completed = gateway.metrics.completed
        ttft = [r.first_token_at - r.arrival for r in completed]
        # read now: the HTTP check's engine loop adds its steps to the same
        # histogram
        step = telemetry.metrics.get("serving_engine_step_seconds")
        step_count, step_seconds = step.count(), step.sum()
        spans = len(telemetry.tracer.log.spans())
        results = {r["key"]: r["result"]["tokens"] for r in gateway.reqlog.replay()
                   if r["kind"] == reqlog.COMPLETED}

        alone_engine = _serving_engine(model, params, draft, draft_params)
        decode_bench.drive(alone_engine, [warm], 1)
        alone_start = time.monotonic()
        alone = [decode_bench.drive(alone_engine, [p], SERVE_NEW_TOKENS)[0] for p in prompts]
        alone_s = time.monotonic() - alone_start
        diverging = [i for i, (a, b) in enumerate(zip(served, alone)) if a != b]
        if diverging:
            i = diverging[0]
            at = next(j for j, (a, b) in enumerate(zip(served[i], alone[i])) if a != b)
            raise AssertionError(
                f"drill request {i} (prompt {prompts[i].size} tokens) diverges from the engine "
                f"alone at token {at}: {served[i][at]} against {alone[i][at]}; "
                f"{len(diverging)} of {SERVE_REQUESTS} requests differ")

        http = check_http(gateway, prompts, alone)
        recovered = check_recover(workdir, engine, results)
        cli_drill = run_cli_drill(workdir / "cli")
    spec = report["engine"]["spec"]
    out = {
        "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW_TOKENS,
        "prompts": [list(p) for p in SERVE_PROMPTS], "shared_prefix": SERVE_PREFIX,
        "drill_seconds": drill_s, "tokens_generated": report["tokens_generated"],
        "tokens_per_sec": report["tokens_generated"] / drill_s,
        "p50_latency_s": report["p50_latency_s"], "p99_latency_s": report["p99_latency_s"],
        "ttft_p50_s": _percentile(ttft, 0.5), "ttft_p99_s": _percentile(ttft, 0.99),
        "engine_step_count": step_count, "engine_step_mean_s": step_seconds / step_count,
        "spans": spans, "k3_launches": launched, "spec": spec,
        "prefix": report["engine"]["prefix"],
        "distinct_tokens": len({t for toks in served for t in toks}),
        "engine_alone_seconds": alone_s, "token_identical": True,
        "http": http, "recover": recovered, "cli_drill": cli_drill,
        "phase_seconds": time.monotonic() - started,
    }
    print("serving plane: " + json.dumps(out, sort_keys=True, default=str), flush=True)
    print(f"serving plane (phase 29): gateway over the LM 12L/768/vocab 32768 SlotEngine, int8 "
          f"cache, {SERVE_SLOTS} slots, drafter k={SERVE_SPEC_K} (acceptance "
          f"{spec['acceptance_rate']}), journal and spans fsync'd; drill of {SERVE_REQUESTS} x "
          f"{SERVE_NEW_TOKENS} tokens: p50 {out['p50_latency_s']:.4f} s, p99 "
          f"{out['p99_latency_s']:.4f} s, {out['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
          f"{out['ttft_p50_s']:.4f} s p99 {out['ttft_p99_s']:.4f} s; engine step histogram "
          f"{out['engine_step_count']} steps, mean {out['engine_step_mean_s'] * 1e3:.3f} ms; "
          f"{spans} spans; K3 {launched} launches; token-identical to the engine alone "
          f"({out['distinct_tokens']} distinct tokens); HTTP plain = streamed = alone; "
          f"recover replays; CLI drill {cli_drill['completed']}/{cli_drill['submitted']}; "
          f"{out['phase_seconds']:.1f} s; on {card}", flush=True)
    return out


FLEET_REQUESTS = 24
FLEET_FIRST_WAVE = 8  # completed before the kill is armed
FLEET_DUPLICATES = 4
FLEET_SEED = 30
FLEET_REVIVE_AFTER_S = 3.0
FLEET_VICTIM = "g1"


class _WallClock:
    """`drive_fleet`'s clock over wall time: seconds since the phase began,
    `time.sleep` to wait. The drive loop alone reads `time()`, once a pass
    (the fleet, its gateways and journals read `now()`), so the longest
    stretch between two reads that no sleep began is the longest pass:
    the most a fleet tick can wait behind the engines' steps."""

    def __init__(self):
        self.start = time.monotonic()
        self.last = 0.0
        self.longest_pass_s = 0.0

    def now(self) -> float:
        return time.monotonic() - self.start

    def time(self) -> float:
        now = self.now()
        self.longest_pass_s = max(self.longest_pass_s, now - self.last)
        self.last = now
        return now

    def sleep(self, seconds: float) -> None:
        time.sleep(max(0.0, seconds))
        self.last = self.now()


class _KillWhenBusy:
    """A world event for `drive_fleet`: kills `rid` at the first step
    boundary at which it holds an in-flight slot and a queued key. Its `at`
    is the past while that holds and never otherwise, so the drive fires it
    between two passes of its engines and waits for it before it ends."""

    def __init__(self, fleet, rid: str):
        self.fleet, self.rid = fleet, rid
        self.killed_at: float | None = None
        self.inflight = self.queued = 0

    @property
    def at(self) -> float:
        gateway = self.fleet.gateways[self.rid]
        busy = (self.fleet.alive[self.rid] and gateway.queue_depth() > 0
                and any(w.inflight for w in gateway.workers.values()))
        return -math.inf if busy else math.inf

    def fn(self, fleet) -> None:
        gateway = fleet.gateways[self.rid]
        self.inflight = sum(len(w.inflight) for w in gateway.workers.values())
        self.queued = gateway.queue_depth()
        self.killed_at = fleet.clock()
        fleet.kill(self.rid)


def _fleet_prompts() -> list:
    """24 prompts of 64-256 tokens from seed 30, sharing no prefix: a
    re-admitted prompt prefills from position 0 on a reset engine, as it
    does on a fresh one, so each has one right answer wherever it is
    served."""
    rng = np.random.default_rng(FLEET_SEED)
    return [rng.integers(0, 32768, int(n)).astype(np.int32)
            for n in rng.integers(64, 257, FLEET_REQUESTS)]


def drive_gateway_fleet(model, params, draft, draft_params, workdir: pathlib.Path) -> dict:
    """The gateway fleet (`serving/fleet.GatewayFleet`, 2 replicas, the
    reference's other defaults) over two `SlotEngine`s that share the
    model's weights, each with its own KV pool, its slice leases on the
    fsync'd event ledger at `RunPaths(workdir).events`, its journal
    shards fsync'd, driven by `drive_fleet` on a wall clock: a first wave
    of 8 keyed greedy requests; a second of 16, during which g1 is killed
    at the first step boundary at which it holds an in-flight slot and a
    queued key; then, a few seconds after the kill, g1 revived as a
    standby while 4 duplicates of first-wave keys (g1's first) are
    resubmitted. Raises unless every key settled once, `check_fleet`
    finds nothing, the successor re-admitted a key, the duplicates came
    from the journal with no engine step, the tokens equal the engine
    alone's, g1's slices were revoked and granted again at higher epochs,
    the reassignment came within one tick and one drive pass of the kill,
    and `cli.main status --json --all` reads the lease counts back."""
    started = time.monotonic()
    paths = RunPaths(workdir)
    engines = {i: _serving_engine(model, params, draft, draft_params, slice_index=i)
               for i in range(2)}
    clock = _WallClock()
    ledger = events.EventLedger(paths.events, clock=clock.now, echo=lambda line: None)
    gw_policy = _serving_policy()
    fleet = fleet_mod.GatewayFleet(
        engines, paths, ledger, policy=fleet_mod.FleetPolicy(replicas=2),
        gateway_policy=gw_policy, clock=clock.now,
        echo=lambda line: print(f"phase 30: {line}", flush=True))
    prompts = _fleet_prompts()
    keys = [f"fleet-{i}" for i in range(FLEET_REQUESTS)]

    def wave(indices, at: float) -> list:
        return [Request(rid=i, prompt_len=int(prompts[i].size),
                        max_new_tokens=SERVE_NEW_TOKENS, tokens=prompts[i], key=keys[i],
                        arrival=at) for i in indices]

    da.decode_attention_kernel.launches = 0
    first = fleet_mod.drive_fleet(fleet, wave(range(FLEET_FIRST_WAVE), clock.now()), clock,
                                  horizon_s=clock.now() + 1.0)
    kill = _KillWhenBusy(fleet, FLEET_VICTIM)
    second = fleet_mod.drive_fleet(fleet, wave(range(FLEET_FIRST_WAVE, FLEET_REQUESTS),
                                                   clock.now()),
                                   clock, horizon_s=clock.now() + 1.0, events=(kill,))
    drive_s = clock.now()
    if kill.killed_at is None or not (first["quiescent"] and second["quiescent"]):
        raise AssertionError(f"fleet: kill at {kill.killed_at}, quiescent "
                             f"{first['quiescent']} / {second['quiescent']}")
    # read before the revival replaces g1's gateway and its metrics
    completed_requests = [r for gw in fleet.gateways.values() for r in gw.metrics.completed]
    steps_before = sum(e.steps for e in engines.values())
    launches_before = da.decode_attention_kernel.launches

    # the duplicates: first-wave keys, those g1's partitions held first
    owned_by_victim = [k for k in keys[:FLEET_FIRST_WAVE]
                       if fleet_mod.partition_of(f"key:{k}", fleet.policy.partitions) % 2 == 1]
    duplicates = (owned_by_victim + [k for k in keys[:FLEET_FIRST_WAVE]
                                     if k not in owned_by_victim])[:FLEET_DUPLICATES]
    admissions: dict = {}

    def resubmit(fleet) -> None:
        for n, key in enumerate(duplicates):
            i = keys.index(key)
            admissions[key] = fleet.submit(Request(
                rid=1000 + n, prompt_len=int(prompts[i].size),
                max_new_tokens=SERVE_NEW_TOKENS, tokens=prompts[i], key=key))

    third = fleet_mod.drive_fleet(
        fleet, [], clock, horizon_s=clock.now() + FLEET_REVIVE_AFTER_S + 1.0,
        events=(traffic.WorldEvent(clock.now(), resubmit),
                traffic.WorldEvent(kill.killed_at + FLEET_REVIVE_AFTER_S,
                                   lambda fleet: fleet.revive(FLEET_VICTIM))))
    duplicate_steps = sum(e.steps for e in engines.values()) - steps_before
    duplicate_launches = da.decode_attention_kernel.launches - launches_before
    launches = da.decode_attention_kernel.launches

    journals = [fleet.reqlogs[rid].replay() for rid in fleet.replica_ids]
    merged = reqlog.merge_records(*journals)
    led = ledger.replay()
    violations = chaos.ServeInvariantChecker(gw_policy).check_fleet(journals, led)
    terminal = {}
    for r in merged:
        if r["kind"] in (reqlog.COMPLETED, reqlog.EXPIRED):
            terminal.setdefault(r["key"], []).append(r)
    served = {k: rs[0]["result"]["tokens"] for k, rs in terminal.items()
              if len(rs) == 1 and rs[0]["kind"] == reqlog.COMPLETED}
    audit = fleet.reassignments[0] if fleet.reassignments else {}

    alone_engine = _serving_engine(model, params, draft, draft_params)
    alone_start = time.monotonic()
    alone = dict(zip(keys, decode_bench.drive(alone_engine, prompts, SERVE_NEW_TOKENS)))
    alone_s = time.monotonic() - alone_start
    diverging = [k for k in keys if served.get(k) != alone[k]]

    revoked = [r for r in led if r["kind"] == events.LEASE_REVOKE
               and r["replica"] == FLEET_VICTIM]
    regranted = [any(g["kind"] == events.LEASE_GRANT and g["slice"] == r["slice"]
                     and g["epoch"] > r["epoch"] and g["ts"] >= r["ts"] for g in led)
                 for r in revoked]
    status = subprocess.run(
        [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.cli.main", "status", "--json",
         "--all", "--workdir", str(workdir)],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=120)
    block = json.loads(status.stdout).get("gateway_fleet", {}) if status.returncode == 0 else {}
    counts = {kind: sum(1 for r in led if r["kind"] == kind)
              for kind in (events.LEASE_GRANT, events.LEASE_REVOKE)}
    ttft = [r.first_token_at - r.arrival for r in completed_requests]
    latency = [r.done_at - r.arrival for r in completed_requests]
    tokens = sum(len(t) for t in served.values())
    out = {
        "requests": FLEET_REQUESTS, "first_wave": FLEET_FIRST_WAVE,
        "new_tokens": SERVE_NEW_TOKENS, "prompt_tokens": [int(p.size) for p in prompts],
        "replicas": fleet.replica_ids, "slices": sorted(engines),
        "drive_seconds": drive_s, "tokens_generated": tokens, "tokens_per_sec": tokens / drive_s,
        "p50_latency_s": _percentile(latency, 0.5), "p99_latency_s": _percentile(latency, 0.99),
        "ttft_p50_s": _percentile(ttft, 0.5), "ttft_p99_s": _percentile(ttft, 0.99),
        "killed": FLEET_VICTIM, "kill_at_s": kill.killed_at,
        "inflight_at_kill": kill.inflight, "queued_at_kill": kill.queued,
        "reassignment": audit, "keys_redone": audit.get("redone", 0),
        "kill_to_reassign_s": audit["at"] - kill.killed_at if audit else None,
        "tick_every_s": fleet.policy.tick_every_s, "longest_pass_s": clock.longest_pass_s,
        "duplicates": {k: admissions[k].reason for k in duplicates},
        "duplicate_engine_steps": duplicate_steps, "duplicate_k3_launches": duplicate_launches,
        "third_drive_quiescent": third["quiescent"], "alive_at_end": fleet.live_replicas(),
        "lease_records": {kind: sum(1 for r in led if r["kind"] == kind) for kind in
                          (events.LEASE_GRANT, events.LEASE_RENEW, events.LEASE_EXPIRE,
                           events.LEASE_REVOKE)},
        "revoked_slices": [r["slice"] for r in revoked],
        "status_rc": status.returncode,
        "status_gateway_fleet": {k: block.get(k) for k in ("grants", "revokes", "lease_epoch",
                                                          "replicas", "leases_total")},
        "violations": violations, "k3_launches": launches,
        "distinct_tokens": len({t for toks in served.values() for t in toks}),
        "engine_alone_seconds": alone_s, "token_identical": not diverging,
    }
    problems = []
    if violations:
        problems.append(f"check_fleet: {violations[:5]}")
    if (sorted(served) != sorted(keys) or any(len(rs) != 1 for rs in terminal.values())
            or len(completed_requests) != FLEET_REQUESTS):
        problems.append(f"settled {sorted(terminal)} with "
                        f"{ {k: len(rs) for k, rs in terminal.items() if len(rs) != 1} }")
    if not audit or audit["redone"] < 1 or audit["from"] != FLEET_VICTIM:
        problems.append(f"no key re-admitted by the successor's adoption: {audit}")
    if any(a.reason != gateway_mod.REPLAYED or a.result["tokens"] != served[k]
           for k, a in admissions.items()) or duplicate_steps or duplicate_launches:
        problems.append(f"duplicates {out['duplicates']}, {duplicate_steps} engine steps, "
                        f"{duplicate_launches} K3 launches")
    if diverging:
        k = diverging[0]
        at = next((j for j, (a, b) in enumerate(zip(served.get(k, []), alone[k])) if a != b),
                  None)
        problems.append(f"{len(diverging)} of {FLEET_REQUESTS} keys differ from the engine "
                        f"alone, first {k} at token {at}")
    if not revoked or not all(regranted):
        problems.append(f"{FLEET_VICTIM}'s slices revoked {out['revoked_slices']}, granted "
                        f"again at a higher epoch {regranted}")
    if audit and out["kill_to_reassign_s"] > fleet.policy.tick_every_s + clock.longest_pass_s:
        problems.append(f"kill to reassignment {out['kill_to_reassign_s']:.3f} s, past one "
                        f"tick and one pass")
    if (status.returncode != 0 or block.get("grants") != counts[events.LEASE_GRANT]
            or block.get("revokes") != counts[events.LEASE_REVOKE]):
        problems.append(f"status --json --all: rc {status.returncode}, block {block}, "
                        f"ledger {counts}, stderr {status.stderr[-2000:]}")
    if not third["quiescent"] or fleet.live_replicas() != fleet.replica_ids:
        problems.append(f"revive: quiescent {third['quiescent']}, alive "
                        f"{fleet.live_replicas()}")
    if problems:
        raise AssertionError("gateway fleet: " + "; ".join(problems))
    out["phase_seconds"] = time.monotonic() - started
    return out


def run_gateway_fleet(card: str) -> dict:
    """Phase 30: the gateway fleet over two full-width int8-cache engines
    with drafters (`drive_gateway_fleet`), K3 counted around it."""
    started = time.monotonic()
    model, params, draft, draft_params = _serving_models()
    with tempfile.TemporaryDirectory() as tmp:
        out = drive_gateway_fleet(model, params, draft, draft_params, pathlib.Path(tmp))
    if out["k3_launches"] == 0:
        raise AssertionError("gateway fleet: K3 launched no time")
    out["phase_seconds"] = time.monotonic() - started
    print("gateway fleet: " + json.dumps(out, sort_keys=True, default=str), flush=True)
    print(f"gateway fleet (phase 30): 2 replicas over 2 LM 12L/768/vocab 32768 SlotEngines "
          f"(int8 cache, {SERVE_SLOTS} slots, drafter k={SERVE_SPEC_K}), leases and journals "
          f"fsync'd; {FLEET_REQUESTS} x {SERVE_NEW_TOKENS} tokens: p50 "
          f"{out['p50_latency_s']:.4f} s, p99 {out['p99_latency_s']:.4f} s, TTFT p50 "
          f"{out['ttft_p50_s']:.4f} s p99 {out['ttft_p99_s']:.4f} s, "
          f"{out['tokens_per_sec']:.1f} tokens/s; {FLEET_VICTIM} killed with "
          f"{out['inflight_at_kill']} in flight and {out['queued_at_kill']} queued, "
          f"reassigned {out['kill_to_reassign_s']:.3f} s after the kill (a tick every "
          f"{out['tick_every_s']} s), {out['keys_redone']} keys redone; "
          f"{FLEET_DUPLICATES} duplicates replayed; token-identical to the engine alone "
          f"({out['distinct_tokens']} distinct tokens); K3 {out['k3_launches']} launches; "
          f"{out['phase_seconds']:.1f} s; on {card}", flush=True)
    return out


def _times_text(r: dict, library: str) -> str:
    def device(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    return ", ".join(
        f"{name} {r[prefix + 'ms']:.4f} ms (device {device(r[prefix + 'device_ms'])})"
        for name, prefix in (("kernel", ""), ("plain", "plain_"), (library, "library_"))
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test needs the card", file=sys.stderr)
        return 2
    started = time.monotonic()

    # f32 convolutions and matrix products (the classifier) in full f32,
    # not TF32, on the card as on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = _card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    builds = {source: _build_in_background(source)
              for source in (K2_SOURCE, K4_SOURCE, K3_SOURCE)}

    k1_main = check_k1(256, 1000, seed=0)
    k1_other = [check_k1(4096, 32000, seed=1),
                check_k1(8192, 32768, seed=2, dtype=torch.bfloat16)]
    for row in (k1_main, *k1_other):
        print(f"K1 {row['shape']} {row['dtype']}: {_times_text(row, 'F.cross_entropy')}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"max |err| {row['max_abs_err']:.2e} on {card}", flush=True)

    check_parity()

    _join_build(K2_SOURCE, builds[K2_SOURCE], started)
    k2_rows = [
        check_k2(8, 1024, 12, 64, causal=True, layout="bshd"),
        check_k2(8, 1024, 12, 64, causal=True, layout="bhsd", seed=1),
        check_k2(2, 1000, 4, 64, causal=True, layout="bshd", seed=2),
        check_k2(2, 512, 4, 128, causal=False, layout="bshd", seed=3),
        # ViT-S/16's attention: non-causal, 197 tokens, 256 x 6 heads of 64
        check_k2(256, 197, 6, 64, causal=False, layout="bshd", seed=4),
        # the pipelined LM's microbatch (phase 24: 8 rows in 4 microbatches)
        check_k2(2, 1024, 12, 64, causal=True, layout="bshd", seed=5),
    ]
    k2_vit = k2_rows[4]
    for row in k2_rows:
        for part, r in (("forward", row["forward"]), ("backward", row["backward"]),
                        ("forward+backward", row["backward"]["forward_and_backward"])):
            err = f", max |err| {r['max_abs_err']:.2e}" if "max_abs_err" in r else ""
            ratio = _ratio_text(r, "SDPA") if part != "forward+backward" else ""
            print(f"K2 {part} {row['shape']} {row['layout']} causal={row['causal']}: "
                  f"{_times_text(r, 'SDPA')}{ratio}, bound {r['bound_ms']:.4f} ms{err} on {card}",
                  flush=True)

    check_lm_parity()
    check_moe_lm_parity()
    check_vit_parity()
    resnet = run_resnet50(card)
    lm_launches = run_lm(card)
    vit = run_vit(card)
    moe_lm = run_moe_lm(card)
    ckpt = check_checkpoint_resume(card)
    _join_build(K4_SOURCE, builds[K4_SOURCE], started)
    mesh_one = run_mesh_one_rank(card, lm_launches["step_ms"])
    two_ranks = run_two_ranks(card)
    for row in k2_rows:
        by_kernel = row["backward"]["device_ms_by_kernel"] = k2_backward_by_kernel(row)
        print(f"K2 backward {row['shape']} {row['layout']} causal={row['causal']}: device ms "
              "by kernel " + (", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items())
                              or "not measured (the profiler recorded no kernels)")
              + f" on {card}", flush=True)

    k4_rows = [check_k4(size, c, n, calls, seed)
               for seed, (size, c, n, calls) in enumerate(K4_SHAPES)]
    for row in k4_rows:
        print(f"K4 (M, C, N) {tuple(row['shape'])} x{row['calls_per_step']}: "
              f"{_times_text(row, 'cuDNN')}{_ratio_text(row, 'cuDNN')}, "
              f"bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), max |err| dX {row['max_abs_err']:.2e} "
              f"dW {row['max_abs_err_dw']:.2e}, device ms by kernel "
              + (", ".join(f"{k} {v:.4f}" for k, v in row["device_ms_by_kernel"].items())
                 or "not measured (the profiler recorded no kernels)")
              + f" on {card}", flush=True)
    k4_step = {
        prefix + "device_ms": sum(r["calls_per_step"] * r[prefix + "device_ms"] for r in k4_rows)
        if all(r[prefix + "device_ms"] is not None for r in k4_rows) else None
        for prefix in ("", "plain_", "library_")
    }
    k4_step["bound_ms"] = sum(r["calls_per_step"] * r["bound_ms"] for r in k4_rows)
    k4_step["max_workspace_bytes"] = max(r["workspace_bytes"] for r in k4_rows)
    k4_step["library_ratio"] = (None if None in (k4_step["device_ms"], k4_step["library_device_ms"])
                                else k4_step["device_ms"] / k4_step["library_device_ms"])
    print("K4 per ResNet-50 step (sum of calls x device time): " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in k4_step.items())
        + f" (library_ratio: kernel / cuDNN) on {card}", flush=True)

    check_fused_parity()
    fused = run_resnet50(card, fused_1x1_bwd=True)
    if not math.isclose(fused["flops_per_step"], resnet["flops_per_step"], rel_tol=FLOPS_RTOL):
        raise AssertionError(f"fused path counts {fused['flops_per_step']} FLOP/step, the "
                             f"default path {resnet['flops_per_step']}")
    print(f"ResNet-50 step: fused {fused['step_ms']:.2f} ms against default "
          f"{resnet['step_ms']:.2f} ms ({fused['step_ms'] / resnet['step_ms'] - 1:+.1%}), "
          f"on {card}", flush=True)
    print(f"ResNet-50 fused_1x1_bwd step: on the mesh (one rank over NCCL, the gradient "
          f"all_reduce made) {mesh_one['resnet50_fused_1x1_bwd_path']['step_ms']:.2f} ms "
          f"against the single-device path's {fused['step_ms']:.2f} ms, on {card}", flush=True)

    _join_build(K3_SOURCE, builds[K3_SOURCE], started)
    floor_ms = launch_floor_ms()
    engine_pos = [300, 511, 17, -1]  # an inactive slot reads all L through trash pages
    verify_pos = [[p + i for i in range(5)] for p in (300, 507, 17, 0)]
    k3_rows = [
        check_k3("generate, pos 639", 8, 1, 12, 640, 64, 639),
        check_k3("generate, pos 127", 8, 1, 12, 640, 64, 127, seed=1),
        check_k3("generate, pos 0", 8, 1, 12, 640, 64, 0, seed=2),
        check_k3("engine decode, per-slot pos", 4, 1, 12, 512, 64, engine_pos, seed=3),
        check_k3("engine verify, 5-query window", 4, 5, 12, 512, 64, verify_pos, seed=4),
        check_k3("drafter, head_dim 16", 4, 1, 2, 512, 16, [300, 511, 17, 200], seed=5),
        check_k3("head_dim 128", 8, 1, 8, 640, 128, 639, seed=6),
        check_k3("head-major bhld", 8, 1, 12, 640, 64, 639, layout="bhld", seed=7),
        check_k3("f32 q", 8, 1, 12, 640, 64, 639, dtype=torch.float32, seed=8),
        # the engine's own calls: its pool read through the page tables
        check_k3("paged engine decode, per-slot pos", 4, 1, 12, 512, 64, engine_pos,
                 layout="paged", seed=9),
        check_k3("paged engine verify, 5-query window", 4, 5, 12, 512, 64, verify_pos,
                 layout="paged", seed=10),
        check_k3("paged drafter, head_dim 16", 4, 1, 2, 512, 16, [300, 511, 17, 200],
                 layout="paged", seed=11),
        # past the first design's 227 KB of scores in shared memory
        check_k3("one query over 65,536 positions", 1, 1, 12, 65536, 64, 65535, seed=12),
        # a rank's half of the batch in the two-process decode of phase 26
        check_k3("two-process decode rank, pos 255", 4, 1, 12, 256, 64, 255, seed=13),
    ]
    for row in k3_rows:
        device = {k: "not measured" if row[k] is None else f"{row[k]:.4f}"
                  for k in ("device_ms", "plain_device_ms")}
        floor = (f", one launch's floor {floor_ms:.4f} ms" if row is k3_rows[2]
                 and floor_ms is not None else "")
        print(f"K3 {row['label']} {row['shape']} {row['layout']} {row['dtype']}: kernel "
              f"{row['ms']:.4f} ms (device {device['device_ms']}), plain {row['plain_ms']:.4f} "
              f"ms (device {device['plain_device_ms']}), no library call, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}){floor}, max |err| "
              f"{row['max_abs_err']:.2e} (f32 q {row['max_abs_err_f32_q']:.2e}) on {card}",
              flush=True)
    print(f"one launch's floor (a one-element fill, device time): "
          f"{'not measured' if floor_ms is None else f'{floor_ms:.4f} ms'}, beside K1 "
          f"(256, 1000) f32 {k1_main['device_ms']} and K3 at pos 0 {k3_rows[2]['device_ms']} "
          f"device ms on {card}", flush=True)

    check_decode_parity()
    check_engine_parity()
    k3_step = profile_decode(card)
    decode_launches, decode_single = run_decode(card, k3_step)
    engine_launches = run_engine(card)
    engine_step = profile_engine_step(card)
    breakdowns = profile_breakdowns(card)
    slice10 = run_slice10(card, decode_single)
    slice11 = run_slice11(card)
    serving_plane = run_serving_plane(card)
    gateway_fleet = run_gateway_fleet(card)

    k2_lm = k2_rows[0]
    k4_main = max(k4_rows, key=lambda r: r["calls_per_step"] * (r["device_ms"] or r["ms"]))
    kernels = [
        {
            "name": "cross_entropy_forward (K1)",
            "route": "triton",
            "source": "tritonk8ssupervisor_tpu_torch/ops/cross_entropy_triton.py",
            "replaces": "tritonk8ssupervisor_tpu/ops/cross_entropy.py:56",
            "launches": lm_launches["k1"],
            "launches_by_path": {"resnet50": resnet["k1"], "lm": lm_launches["k1"],
                                 "resnet50_fused_1x1_bwd": fused["k1"], "vit": vit["k1"],
                                 "vit_flash_attention": vit["flash_k1"],
                                 "moe_lm": moe_lm["k1"],
                                 "mesh_lm": mesh_one["lm_path"]["k1"],
                                 "pp_lm_first_step": slice10["pipeline"]["k1"],
                                 "moe_lm_seq_axis_first_step": slice10["moe_seq_axis"]["k1"],
                                 "mesh_resnet50_fused_1x1_bwd":
                                     mesh_one["resnet50_fused_1x1_bwd_path"]["k1"],
                                 "elastic_lm": slice11["elastic_one_rank"]["launches"]["k1"]},
            "design": "one program per row, online logsumexp over column tiles, the label's "
                      "logit picked in its tile; logits read once",
            "launch_floor_ms": floor_ms,
            **k1_other[1],
            "library_ratio": _library_ratio(k1_other[1]),
            "other_shapes": [k1_main, k1_other[0]],
        },
        {
            "name": "flash_attn_fwd (K2)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:128",
            "also_replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:163",
            "launches": lm_launches["k2_forward"],
            "input_copies": lm_launches["k2_copies"],
            "design": "TMA-fed wgmma: work items of 128 q rows walked by one persistent CTA "
                      "per SM; q by TMA (two buffers), k/v through a 4-stage TMA ring over 4-d "
                      "tensor maps, one producer thread, two consumer warpgroups of 64 rows; "
                      "S = QK^T wgmma SS, online softmax in f32 registers, O += PV wgmma RS with "
                      "V read MN-major; O stored by TMA",
            "shape": k2_lm["shape"], "layout": k2_lm["layout"],
            **k2_lm["forward"],
            "library_ratio": _library_ratio(k2_lm["forward"]),
            "launches_by_path": {"lm": lm_launches["k2_forward"],
                                 "moe_lm": moe_lm["k2_forward"],
                                 "vit_flash_attention": vit["flash_k2_forward"], "vit": 0,
                                 "mesh_lm": mesh_one["lm_path"]["k2_forward"],
                                 "pp_lm_first_step": slice10["pipeline"]["k2_forward"],
                                 "moe_lm_seq_axis_first_step":
                                     slice10["moe_seq_axis"]["k2_forward"],
                                 "elastic_lm":
                                     slice11["elastic_one_rank"]["launches"]["k2_forward"]},
            "other_shapes": [{**{k: r[k] for k in ("shape", "layout", "causal")},
                              **r["forward"]} for r in (*k2_rows[1:4], k2_rows[5])],
        },
        {
            "name": "flash_attn_bwd (K2)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:128",
            "also_replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:163",
            "launches": lm_launches["k2_backward"],
            "design": "TMA-fed wgmma: a pre-pass writes each q row's lse*log2e and "
                      "rowsum(dO*O) (padded rows +inf and 0); then a dK/dV kernel over 128-key "
                      "items and a dQ kernel over 128-row q items, each with one persistent CTA "
                      "per SM, one producer thread, two consumer warpgroups of 64 rows (setmaxnreg "
                      "40/232), the item's own tiles loaded once by TMA (two buffers) and 64-row "
                      "tiles of the other side through a TMA ring over 4-d tensor maps; S and dP "
                      "wgmma SS, P and dS in f32 registers, dV, dK and dQ wgmma RS with Q, dO and "
                      "K read MN-major; outputs staged in the item's input tiles and stored by "
                      "TMA; no atomics, bit-equal calls",
            "shape": k2_lm["shape"], "layout": k2_lm["layout"],
            **k2_lm["backward"],
            "library_ratio": _library_ratio(k2_lm["backward"]),
            "launches_by_path": {"lm": lm_launches["k2_backward"],
                                 "moe_lm": moe_lm["k2_backward"],
                                 "vit_flash_attention": vit["flash_k2_backward"], "vit": 0,
                                 "mesh_lm": mesh_one["lm_path"]["k2_backward"],
                                 "pp_lm_first_step": slice10["pipeline"]["k2_backward"],
                                 "moe_lm_seq_axis_first_step":
                                     slice10["moe_seq_axis"]["k2_backward"],
                                 "elastic_lm":
                                     slice11["elastic_one_rank"]["launches"]["k2_backward"]},
            "other_shapes": [{**{k: r[k] for k in ("shape", "layout", "causal")},
                              **r["backward"]} for r in (*k2_rows[1:4], k2_rows[5])],
        },
        *({
            "name": f"flash_attn_{part[0]}w{part[-1]} (K2), ViT-S/16 shape",  # fwd, bwd
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:128",
            "launches": vit[f"flash_k2_{part}"],
            "input_copies": vit["flash_k2_copies"],
            "path": "ViT-S/16 step with attention_fn=flash_attention (the benchmark's ViT "
                    "runs dense attention, as the reference's)",
            "shape": k2_vit["shape"], "layout": k2_vit["layout"], "causal": False,
            **k2_vit[part],
            "library_ratio": _library_ratio(k2_vit[part]),
        } for part in ("forward", "backward")),
        {
            "name": "conv1x1_bwd (K4)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/conv_backward.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/conv_backward.py:83",
            "launches": fused["k4"],
            "launches_by_path": {"resnet50": resnet["k4"], "resnet50_fused_1x1_bwd": fused["k4"],
                                 "mesh_resnet50_fused_1x1_bwd":
                                     mesh_one["resnet50_fused_1x1_bwd_path"]["k4"]},
            "design": "TMA-fed wgmma: persistent dgrad over 128 x {64, 128, 256} tiles (all of "
                      "C up to 256) and wgrad over 128 x 128 tiles and one wave of M splits, each "
                      "a TMA ring with one producer thread and two consumer warpgroups; W, dY^T "
                      "and X read MN-major by the descriptor; dX stored by TMA; dW partials "
                      "summed in split order",
            # the shape with the largest share of a step's K4 time
            **k4_main,
            "library_ratio": _library_ratio(k4_main),
            "per_step": k4_step,
            "other_shapes": [r for r in k4_rows if r is not k4_main],
        },
        {
            "name": "decode_attn_int8 (K3)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/decode_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/decode_attention.py:58",
            "launches": decode_launches["decode_cache_int8"],
            "launches_by_path": {**decode_launches, "engine_cache_int8": engine_launches,
                                 "mesh_decode_cache_int8": slice10["decode_mesh"]["k3"],
                                 "two_process_decode_cache_int8_per_rank":
                                     slice10["decode_two_ranks"]["k3"],
                                 "serving_plane_drill": serving_plane["k3_launches"],
                                 "gateway_fleet_drive": gateway_fleet["k3_launches"]},
            "library_none_reason": "no PyTorch call computes attention over an int8 cache "
                                   "with per-token scales",
            "library_ratio": None,
            "design": "split-K over fixed 64-position chunks (flash-decoding): one CTA of "
                      "128 threads per (b, h, chunk), chunks past the row's last position exit; "
                      "all of a chunk's K/V rows and scales in flight at once (16- and 4-byte "
                      "cp.async, the paged layout through the page table, one copy a row); "
                      "scores, chunk softmax and values from shared memory in f32, int8 to f32 "
                      "by byte permute; per-chunk (m, l, o) partials, combined in chunk order "
                      "by the row's last CTA (an acquire-release counter), or written directly "
                      "when the row has one chunk; a query's bits depend only on its own pos",
            "first_design": "one CTA of 256 threads per (b, h) holding the window's queries; "
                            "scores, f32 softmax and values over 16-byte int8 rows, reads stop "
                            "at pos + 1; fixed-order reductions",
            "launch_floor_ms": floor_ms,
            # the last position of the dense decode benchmark
            **k3_rows[0],
            # K3's profiled device time in one dense decode step at pos 383
            "decode_step": k3_step,
            # K3 and the page gathers in one engine decode step (torch.profiler)
            "engine_step": engine_step,
            "other_shapes": k3_rows[1:],
        },
    ]
    print("slice 8: " + json.dumps({"vit": vit, "moe_lm": moe_lm, "checkpoint": ckpt,
                                    "profiles": breakdowns}, sort_keys=True), flush=True)
    print("slice 9: " + json.dumps({"mesh_one_rank": mesh_one, "two_ranks": two_ranks},
                                   sort_keys=True, default=str), flush=True)
    print("slice 10: " + json.dumps(slice10, sort_keys=True, default=str), flush=True)
    print("slice 11: " + json.dumps(slice11, sort_keys=True, default=str), flush=True)
    print("slice 12: " + json.dumps(serving_plane, sort_keys=True, default=str), flush=True)
    print("slice 13: " + json.dumps(gateway_fleet, sort_keys=True, default=str), flush=True)
    print(f"chip_smoke: all phases passed in {time.monotonic() - started:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--engine-step"]:  # that phase alone, e.g. on another tree's package
        if not torch.cuda.is_available():
            sys.exit(2)
        profile_engine_step(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--serving-plane"]:  # phase 29 alone, K3 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_build.load(K3_SOURCE)
        run_serving_plane(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--gateway-fleet"]:  # phase 30 alone, K3 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_build.load(K3_SOURCE)
        run_gateway_fleet(_card_line())
        sys.exit(0)
    sys.exit(main())
