"""Autoregressive decode throughput benchmark (tokens/sec, ms/token) and the
serving engine's A/B: the port of
`tritonk8ssupervisor_tpu/benchmarks/decode.py`, on NVIDIA cards.

    python -m tritonk8ssupervisor_tpu_torch.benchmarks.decode --json [--cache-int8] [--int8]
    python -m tritonk8ssupervisor_tpu_torch.benchmarks.decode --engine --json [--cache-int8]

`run_benchmark` measures KV-cache generation (`models/decode.generate`) for
the LM the training benchmark uses (12 layers, 12 heads of 64, embed 768,
vocab 32768, bf16, random weights from a seed): `repeats` timed calls after
a first one, each fenced by a host copy of the generated tokens. With
`cache_int8` every decode attention runs through kernel K3
(`ops/decode_attention.py`); `int8` quantises the weights.

`run_engine_benchmark` drives the paged `serving/engine.SlotEngine` through
its modes: `cold`/`warm` (the same shared-system-prompt stream with the
prefix cache off and on: warm must give exactly the cold tokens while
re-prefilling none of the shared prefix) and `spec_base`/`spec` (a
decode-heavy stream without and with a drafter proposing `spec_k` tokens a
round: exact acceptance, so `spec` must be token-identical).

    torchrun --nproc-per-node N -m tritonk8ssupervisor_tpu_torch.benchmarks.decode --json

In a process group (torchrun, or `parallel/ranks.run_ranks`) `run_benchmark`
decodes data parallel over the mesh (`parallel/mesh.make_workload_mesh`), as
the reference does over every chip of its slice: the parameters are
replicated, each rank generates its `batch / batch degree` rows of the
prompts, `num_chips` is the mesh's size, `tokens_per_sec` counts every
rank's streams over the slowest rank's time and the `*_per_chip` rates
divide it by `num_chips`. A batch the degree does not divide raises
ValueError. The engine benchmark runs on one card, as the reference's
engine does. The multi-host rendezvous (`initialize_from_env`) is not
ported (ROADMAP.md queue 1, item 5b): the group is the launcher's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu_torch.parallel.distributed import init_from_launcher
from tritonk8ssupervisor_tpu_torch.serving.engine import SlotEngine
from tritonk8ssupervisor_tpu_torch.serving.gateway import Request
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard


def _check_chips(num_chips: int | None, ranks: int, what: str) -> None:
    """`num_chips`, where the caller names it, must be the cards the run
    has: the process group's ranks (one without a group)."""
    if num_chips is not None and num_chips != ranks:
        raise ValueError(
            f"num_chips={num_chips}: {what} runs on the process group's {ranks} "
            "rank(s), one card each; start that many ranks (torchrun "
            "--nproc-per-node N) to decode on N cards")


def _device_fields(device: torch.device, num_chips: int = 1) -> dict:
    on_card = device.type == "cuda"
    return {
        "platform": "gpu" if on_card else device.type,
        "device": str(device),
        "device_kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "num_chips": num_chips,
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
    }


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_benchmark(
    vocab_size: int = 32768,
    num_layers: int = 12,
    num_heads: int = 12,
    embed_dim: int = 768,
    prompt_len: int = 128,
    new_tokens: int = 512,
    batch: int = 8,
    temperature: float = 0.0,
    repeats: int = 3,
    int8: bool = False,
    cache_int8: bool = False,
    unroll: int = 1,
    num_chips: int | None = None,
    keep_tokens: bool = False,
    device: str | torch.device | None = None,
) -> dict:
    """Time `generate` on a batch of random prompts; returns the reference's
    metrics plus `device`, `device_kind` and `peak_memory_gb`.
    `compile_seconds` is the first call (it builds K3 and warms the
    libraries; there is no compilation step otherwise). In a process
    group the batch is decoded data parallel over the mesh (the module's
    docstring); `num_chips`, when given, must be the group's size.
    `keep_tokens` adds `tokens`, this rank's rows of the last call's
    output, as a list of lists."""
    device = resolve_device(device)
    mesh = None
    if dist.is_initialized():
        mesh = mesh_lib.make_workload_mesh(device_type=device.type)
    ranks = mesh.size() if mesh is not None else 1
    _check_chips(num_chips, ranks, "decode")
    degree = mesh_lib.batch_degree(mesh) if mesh is not None else 1
    if batch % degree:
        raise ValueError(
            f"--batch {batch} must be divisible by the {ranks}-chip data-parallel "
            "degree (each chip decodes batch/chips streams)")
    _reset_peak(device)
    max_len = prompt_len + new_tokens
    model = TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        embed_dim=embed_dim,
        max_seq_len=max_len,
        generator=torch.Generator().manual_seed(1),
    )
    params = dec.lm_params(model, device)
    if int8:
        # weight-only int8: halves the per-token weight read
        params = dec.quantize_params_int8(params)
    prompt = torch.randint(0, vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(0))
    if mesh is not None:  # this rank's streams
        prompt = batch_shard(mesh, prompt)
    prompt = prompt.to(device)
    rng = torch.Generator(device=device).manual_seed(2)
    last = {}

    def timed_call():
        # fenced by a host copy of the tokens: they exist when it returns
        start = time.monotonic()
        out = dec.generate(model, params, prompt, max_new_tokens=new_tokens,
                           temperature=temperature, rng=rng, max_len=max_len,
                           cache_int8=cache_int8, unroll=unroll).cpu()
        elapsed = time.monotonic() - start
        if tuple(out.shape) != (batch // degree, new_tokens):
            raise AssertionError(f"generate returned {tuple(out.shape)}")
        last["tokens"] = out
        if mesh is None:
            return elapsed
        # the slowest rank's time: every stream of the batch exists then
        slowest = torch.tensor([elapsed], dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        return slowest.item()

    compile_seconds = timed_call()
    times = sorted(timed_call() for _ in range(repeats))
    median = times[len(times) // 2]
    total_tokens = batch * new_tokens
    return {
        "model": "transformer_lm_decode",
        **_device_fields(device, ranks),
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "num_layers": num_layers,
        "temperature": temperature,
        "int8": bool(int8),
        "cache_int8": bool(cache_int8),
        "unroll": unroll,
        "decode_tokens_per_sec": total_tokens / median,
        "decode_tokens_per_sec_per_chip": total_tokens / median / ranks,
        "tokens_per_sec": total_tokens / median,
        "tokens_per_sec_per_chip": total_tokens / median / ranks,
        "ms_per_token_per_stream": median / new_tokens * 1000,
        "seconds_median": median,
        "seconds_min": times[0],
        "compile_seconds": compile_seconds,
        **({"tokens": last["tokens"].tolist()} if keep_tokens else {}),
    }


def drive(engine, stream, budget: int) -> list:
    """Fill slots, step to completion, keep every slot busy: each prompt of
    `stream` (int32 numpy) a request of `budget` new tokens. Returns the
    outputs in request order (fewer if the engine stops early)."""
    pending = list(enumerate(stream))
    done: dict = {}
    inflight: dict = {}
    while pending or inflight:
        for slot in range(engine.slots):
            if slot in inflight or not pending:
                continue
            rid, tokens = pending[0]
            req = Request(rid=rid, prompt_len=int(tokens.size),
                          max_new_tokens=budget, tokens=tokens)
            if not engine.can_join(req):
                break
            pending.pop(0)
            engine.join(slot, req)
            inflight[slot] = rid
        result = engine.step()
        if result is None:
            break
        for slot, ids in result.finished.items():
            done[inflight.pop(slot)] = ids
            engine.release(slot)
    return [done[i] for i in sorted(done)]


def run_engine_benchmark(
    vocab_size: int = 512,
    num_layers: int = 4,
    num_heads: int = 4,
    embed_dim: int = 128,
    max_len: int = 512,
    prompt_len: int = 256,
    shared_prefix_len: int = 192,
    new_tokens: int = 32,
    requests: int = 8,
    slots: int = 4,
    page_size: int = 16,
    prefill_chunk: int = 64,
    cache_int8: bool = False,
    spec_k: int = 4,
    spec_new_tokens: int = 96,
    draft_layers: int = 1,
    draft_heads: int = 2,
    draft_embed_dim: int = 32,
    bias_scale: float = 32.0,
    num_chips: int = 1,
    device: str | torch.device | None = None,
) -> dict:
    """The engine A/B through the real `SlotEngine` (paged KV and the prefix
    store), reported as a `modes` list: `cold`/`warm` and, with spec_k > 0,
    `spec_base`/`spec`.

    Both models share a strong lm_head bias (`bias_scale`): randomly
    initialised models have unrelated argmaxes, so a shared dominant bias
    puts drafter and target in the high-acceptance regime, and the
    measured speed-up is the engine mechanics', not a drafter's quality.
    The warm-up request of each engine seeds the warm engine's store, so
    the timed window is the steady state. It runs on one card, as the
    reference's engine does: `num_chips` other than 1 raises ValueError."""
    _check_chips(num_chips, 1, "the engine")
    device = resolve_device(device)
    _reset_peak(device)
    model = TransformerLM(
        vocab_size=vocab_size,
        num_layers=num_layers,
        num_heads=num_heads,
        embed_dim=embed_dim,
        max_seq_len=max_len,
        generator=torch.Generator().manual_seed(1),
    )
    draft_model = TransformerLM(
        vocab_size=vocab_size,
        num_layers=draft_layers,
        num_heads=draft_heads,
        embed_dim=draft_embed_dim,
        max_seq_len=max_len,
        generator=torch.Generator().manual_seed(5),
    )
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab_size, shared_prefix_len)
    prompts = [
        np.concatenate([
            prefix,
            rng.integers(0, vocab_size, prompt_len - shared_prefix_len),
        ]).astype(np.int32)
        for _ in range(requests + 1)  # +1: the warm-up request
    ]
    params = dec.lm_params(model, device)
    draft_params = dec.lm_params(draft_model, device)
    if bias_scale > 0:
        # one dominant token in a shared strong head bias makes both models
        # follow the same preference (the gaussian part alone is draw-lucky:
        # the target's own logit noise can out-shout it)
        bias_host = rng.normal(0.0, bias_scale, vocab_size)
        bias_host[int(rng.integers(0, vocab_size))] += 10.0 * bias_scale
        bias = torch.as_tensor(bias_host, dtype=torch.float32, device=device)
        for tree in (params, draft_params):
            tree["lm_head"] = {**tree["lm_head"], "bias": tree["lm_head"]["bias"] + bias}

    def run_mode(name, prefix_cache, budget, use_draft):
        engine = SlotEngine(
            model, params, slots=slots, max_len=max_len,
            prefill_chunk=prefill_chunk, page_size=page_size,
            cache_int8=cache_int8, prefix_cache=prefix_cache,
            draft_model=(draft_model if use_draft else None),
            draft_params=(draft_params if use_draft else None),
            spec_k=(spec_k if use_draft else 0),
        )
        drive(engine, prompts[:1], budget)  # warm up + seed the store
        prefill_before = engine.prefill_tokens
        start = time.monotonic()
        outs = drive(engine, prompts[1:], budget)
        elapsed = time.monotonic() - start
        stats = engine.stats()
        total = sum(len(o) for o in outs)
        return {
            "name": name,
            "new_tokens": budget,
            "prefix_cache": prefix_cache,
            "spec_k": spec_k if use_draft else 0,
            "seconds": elapsed,
            "tokens_generated": total,
            "tokens_per_sec": total / elapsed,
            "tokens_per_sec_per_chip": total / elapsed,
            "prefill_tokens": stats["prefill_tokens"] - prefill_before,
            "prefix": stats["prefix"],
            "spec": stats["spec"],
            "outputs": outs,
        }

    results = {
        "cold": run_mode("cold", False, new_tokens, False),
        "warm": run_mode("warm", True, new_tokens, False),
    }
    if spec_k > 0:
        # the decode-heavy budget, clamped so small configs still fit
        spec_budget = max(1, min(spec_new_tokens,
                                 max_len - prompt_len - spec_k))
        results["spec_base"] = run_mode("spec_base", True,
                                        spec_budget, False)
        results["spec"] = run_mode("spec", True, spec_budget, True)
    cold, warm = results["cold"], results["warm"]
    token_identical = cold["outputs"] == warm["outputs"]
    spec_identical = None
    spec_over_baseline = None
    acceptance_rate = None
    if spec_k > 0:
        spec_identical = (results["spec"]["outputs"]
                          == results["spec_base"]["outputs"])
        base_tps = results["spec_base"]["tokens_per_sec"]
        spec_over_baseline = (
            round(results["spec"]["tokens_per_sec"] / base_tps, 3)
            if base_tps else None
        )
        acceptance_rate = (results["spec"]["spec"] or {}).get(
            "acceptance_rate")
    for mode in results.values():
        del mode["outputs"]  # evidence checked, not reported
    aligned = (shared_prefix_len // page_size) * page_size
    hits = (warm["prefix"] or {}).get("hits", 0)
    hit_tokens = (warm["prefix"] or {}).get("hit_tokens", 0)
    reprefilled = hits * aligned - hit_tokens
    speedup = (cold["seconds"] / warm["seconds"]
               if warm["seconds"] else None)
    # the reference's gate, thresholds included
    passes = bool(
        token_identical
        and hits >= requests  # every timed request hit the warm store
        and reprefilled == 0
        and speedup is not None and speedup >= 1.05
        and (spec_k == 0 or (
            spec_identical
            and acceptance_rate is not None and acceptance_rate >= 0.8
            and spec_over_baseline is not None
            and spec_over_baseline >= 1.4
        ))
    )
    return {
        "benchmark": "engine_hot_path",
        "metric": "prefix_warm_over_cold_speedup",
        "unit": "x (same shared-system-prompt stream through the real "
                "SlotEngine, paged KV both sides; warm = prefix store "
                "seeded, token-identical output required)",
        **_device_fields(device),
        "model": {"vocab_size": vocab_size, "num_layers": num_layers,
                  "num_heads": num_heads, "embed_dim": embed_dim},
        "draft_model": ({"num_layers": draft_layers,
                         "num_heads": draft_heads,
                         "embed_dim": draft_embed_dim}
                        if spec_k > 0 else None),
        "max_len": max_len,
        "prompt_len": prompt_len,
        "shared_prefix_len": shared_prefix_len,
        "new_tokens": new_tokens,
        "requests": requests,
        "slots": slots,
        "page_size": page_size,
        "prefill_chunk": prefill_chunk,
        "cache_int8": bool(cache_int8),
        "bias_scale": float(bias_scale),
        "value": round(speedup, 3) if speedup is not None else None,
        "token_identical": token_identical,
        "shared_prefix_reprefilled_on_hits": int(reprefilled),
        "cold": cold,
        "warm": warm,
        "speculative": ({
            "metric": "spec_over_paged_baseline_tokens_per_sec_per_chip",
            "unit": "x (decode-heavy stream, prefix-warm both sides, "
                    "matched KV memory; drafter proposes spec_k "
                    "tokens/round, exact accept/reject, "
                    "token-identical required)",
            "spec_k": spec_k,
            "value": spec_over_baseline,
            "token_identical": spec_identical,
            "acceptance_rate": acceptance_rate,
            "baseline": {k: v for k, v in results["spec_base"].items()
                         if k != "name"},
            "spec": {k: v for k, v in results["spec"].items()
                     if k != "name"},
        } if spec_k > 0 else None),
        "modes": [results[name] for name in
                  ("cold", "warm", "spec_base", "spec")
                  if name in results],
        "passes": passes,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--vocab-size", type=int, default=32768)
    parser.add_argument("--num-layers", type=int, default=12)
    parser.add_argument("--num-heads", type=int, default=12)
    parser.add_argument("--embed-dim", type=int, default=768)
    parser.add_argument("--prompt-len", type=int, default=128)
    parser.add_argument("--new-tokens", type=int, default=512)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 (per-output-channel scales)")
    parser.add_argument("--unroll", type=int, default=1,
                        help="accepted for the reference's interface; changes nothing")
    parser.add_argument("--cache-int8", action="store_true",
                        help="int8 KV cache with per-(token, head) scales; decode "
                        "attention through kernel K3 on the card")
    parser.add_argument("--engine", action="store_true",
                        help="run the engine A/B instead: the paged SlotEngine serving "
                        "a shared-system-prompt stream cold and warm, and a "
                        "decode-heavy stream without and with a drafter")
    parser.add_argument("--engine-requests", type=int, default=8,
                        help="--engine: timed requests per drive (one more warms up)")
    parser.add_argument("--shared-prefix-len", type=int, default=192,
                        help="--engine: shared system-prompt tokens opening every prompt")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="--engine: drafter tokens a speculative round (0 skips "
                        "the speculative modes)")
    parser.add_argument("--page-size", type=int, default=16,
                        help="--engine: KV page size in tokens")
    parser.add_argument("--num-chips", type=int, default=None,
                        help="cards to decode on: the launcher's ranks (checked when "
                        "given; the engine runs on one)")
    parser.add_argument("--json", action="store_true")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.engine:
        result = run_engine_benchmark(
            requests=args.engine_requests,
            shared_prefix_len=args.shared_prefix_len,
            page_size=args.page_size,
            cache_int8=args.cache_int8,
            spec_k=args.spec_k,
            num_chips=args.num_chips,
        )
        if args.json:
            print(json.dumps(result, sort_keys=True))
        else:
            print(
                f"engine on {result['device_kind']}: prefix-warm "
                f"{result['value']}x over cold "
                f"({result['warm']['tokens_per_sec']:.0f} vs "
                f"{result['cold']['tokens_per_sec']:.0f} tok/s), "
                f"token-identical={result['token_identical']}, "
                f"shared-prefix re-prefilled "
                f"{result['shared_prefix_reprefilled_on_hits']} tokens"
            )
            spec = result.get("speculative")
            if spec is not None:
                print(
                    f"speculative k={spec['spec_k']}: "
                    f"{spec['value']}x over the paged baseline "
                    f"({spec['spec']['tokens_per_sec']:.0f} vs "
                    f"{spec['baseline']['tokens_per_sec']:.0f} tok/s), "
                    f"acceptance {spec['acceptance_rate']:.0%}, "
                    f"token-identical={spec['token_identical']}"
                )
        return 0 if result["passes"] else 1
    joined = init_from_launcher()  # under torchrun: every rank decodes its streams
    rank = dist.get_rank() if joined else 0
    try:
        result = run_benchmark(
            vocab_size=args.vocab_size,
            num_layers=args.num_layers,
            num_heads=args.num_heads,
            embed_dim=args.embed_dim,
            prompt_len=args.prompt_len,
            new_tokens=args.new_tokens,
            batch=args.batch,
            temperature=args.temperature,
            repeats=args.repeats,
            int8=args.int8,
            cache_int8=args.cache_int8,
            unroll=args.unroll,
            num_chips=args.num_chips,
        )
    finally:
        if joined:
            dist.destroy_process_group()
    if rank:
        return 0
    if args.json:
        print(json.dumps(result, sort_keys=True))
    else:
        print(
            f"decode on {result['num_chips']} {result['device_kind']}: batch {result['batch']}, "
            f"{result['decode_tokens_per_sec']:.0f} tok/s, "
            f"{result['ms_per_token_per_stream']:.2f} ms/token/stream "
            f"(prompt {result['prompt_len']}, {result['new_tokens']} new, "
            f"first call {result['compile_seconds']:.1f}s)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
