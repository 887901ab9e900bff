"""Autoregressive decoding with a KV cache for the port's TransformerLM: the
port of `tritonk8ssupervisor_tpu/models/decode.py`.

Prefill runs the prompt through one full-sequence forward while writing
each layer's K/V into a static-shape cache; decode then steps one token at
a time, each step a forward of one token per row against the cache,
masked past its position. The reference's `lax.scan` over decode steps is
a Python loop here: PyTorch runs eagerly, and a CUDA graph of the step is
a later lever.

- `(model, params)`: `model` is the port's `TransformerLM`, read for its
  hyperparameters only (`num_layers`, `num_heads`, `embed_dim`,
  `mlp_ratio`, `max_seq_len`, `vocab_size`, `dtype`, `logits_dtype`);
  `params` is its `state_dict` as a nested dict (`lm_params(model)`:
  `params["Block_0"]["qkv"]["weight"]`, `params["pos_embed"]`), the
  counterpart of the flax `params` tree. Weights are (out, in), as the
  port's `Dense` holds them.
- The cache is {Block_i: {k, v: (B, L, H, D)}} bf16, or with `int8` the
  int8 values and (B, L, H) f32 scales, allocated once (zeros) and
  written in place: the port updates the cache where the reference
  returns a new one.
- Every int8-cache single-token attention goes through
  `ops/decode_attention.decode_attention_int8` on the cache as it lies
  (`layout="blhd"`): kernel K3 on the card. The reference computes the
  same function as an einsum chain, which on a bf16 model rounds the
  scores and probabilities to bf16 where K3 keeps them in f32. The bf16
  cache and both prefills stay plain torch in the reference's order.
- Weight-only int8 (`quantize_params_int8`) matches the reference's codes
  and scales bit for bit; its product is a plain matrix product.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.models.transformer import dense, layer_norm
from tritonk8ssupervisor_tpu_torch.ops.decode_attention import decode_attention_int8
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import attention_reference

NEG_INF = -1e30
DENSE_NAMES = ("qkv", "proj", "mlp_up", "mlp_down", "lm_head")


def lm_params(model, device=None) -> dict:
    """The nested parameter tree of a port `TransformerLM`: its state_dict
    split on dots, detached, moved to `device` when one is given."""
    tree: dict = {}
    for name, value in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.detach() if device is None else value.detach().to(device)
    return tree


def _cache_layers(model, shape, int8: bool, device) -> dict:
    device = resolve_device(device)
    if int8:
        return {
            f"Block_{i}": {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            }
            for i in range(model.num_layers)
        }
    return {
        f"Block_{i}": {
            "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        }
        for i in range(model.num_layers)
    }


def init_kv_cache(model, batch: int, max_len: int, int8: bool = False, device=None) -> dict:
    """Zeroed per-layer K/V cache: {Block_i: {k, v: (B, L, H, D)}} bf16, or
    with `int8` {k, v: int8, k_scale, v_scale: (B, L, H) f32}: symmetric
    per-(token, head) quantisation, 1 + 4/D bytes an element against 2.
    `device=None` is the card."""
    head_dim = model.embed_dim // model.num_heads
    return _cache_layers(model, (batch, max_len, model.num_heads, head_dim), int8, device)


def init_kv_pool(model, num_pages: int, page_size: int, int8: bool = False,
                 device=None) -> dict:
    """Zeroed paged K/V pool: {Block_i: {k, v: (P, page_size, H, D)}} bf16,
    or int8 values with (P, page_size, H) f32 scales, as `init_kv_cache`
    page-wise (serving/engine.SlotEngine maps slots onto pages). Scales
    are per-(token, head), so quantising a chunk and scattering values and
    scales into pages is bit-identical to quantising into the dense cache.
    `device=None` is the card."""
    head_dim = model.embed_dim // model.num_heads
    return _cache_layers(model, (num_pages, page_size, model.num_heads, head_dim), int8, device)


def softmax_np(logits, temperature: float = 1.0):
    """Host-side softmax over the last axis (numpy, float64 accumulation):
    the acceptance arithmetic of speculative decoding runs on the host
    between two device steps."""
    z = np.asarray(logits, np.float64) / max(1e-8, float(temperature))
    z = z - np.max(z, axis=-1, keepdims=True)
    e = np.exp(z)
    return e / np.sum(e, axis=-1, keepdims=True)


def speculative_accept(draft_tokens, draft_logits, target_logits,
                       temperature: float, rng):
    """Exact accept/reject for one slot's k-token draft (the engine calls
    this per slot per round).

    Inputs: `draft_tokens` (k,), the drafter's proposals; `draft_logits`
    (k, V), the drafter logits each proposal was drawn from (ignored when
    temperature == 0); `target_logits` (k+1, V), the target's logits at the
    k+1 verify positions (row k is the bonus position). `rng` is a numpy
    Generator.

    Returns (accepted, emitted): the leading drafts that survived, and
    those tokens plus exactly one more from the target (the correction at
    the first rejected position, or the bonus token).

    Greedy (temperature <= 0): accept d_i iff it equals the target's
    argmax, so the emitted chain is the target-only greedy chain. Sampled:
    accept d_i ~ q with probability min(1, p(d_i)/q(d_i)), else resample
    from norm(max(p - q, 0)), which yields exactly p at every emitted
    position for any draft distribution q."""
    draft_tokens = np.asarray(draft_tokens)
    k = int(draft_tokens.shape[0])
    emitted: list[int] = []
    if temperature <= 0:
        ref = np.argmax(np.asarray(target_logits, np.float64), axis=-1)
        accepted = 0
        for i in range(k):
            if int(draft_tokens[i]) != int(ref[i]):
                break
            emitted.append(int(draft_tokens[i]))
            accepted += 1
        emitted.append(int(ref[accepted]))
        return accepted, emitted
    p = softmax_np(target_logits, temperature)  # (k+1, V)
    q = softmax_np(draft_logits, temperature)  # (k, V)
    accepted = 0
    for i in range(k):
        tok = int(draft_tokens[i])
        ratio = p[i, tok] / max(q[i, tok], 1e-300)
        if rng.random() < min(1.0, ratio):
            emitted.append(tok)
            accepted += 1
            continue
        residual = np.maximum(p[i] - q[i], 0.0)
        total = residual.sum()
        if total <= 0.0:
            # p == q at this position: the rejection branch has measure
            # zero; fall back to the target distribution outright
            residual, total = p[i], p[i].sum()
        emitted.append(int(rng.choice(residual.size, p=residual / total)))
        return accepted, emitted
    emitted.append(int(rng.choice(p[k].size, p=p[k] / p[k].sum())))
    return accepted, emitted


def _quant_kv(x):
    """(..., D) -> (int8 values, (...) f32 scales): symmetric per-(token,
    head) quantisation, max|x| / 127 clamped at 1e-8, round half to even,
    clipped to [-127, 127]. The scale rides outside both cache
    contractions, so the dequantised cache is never materialised."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _ln(p, x, dtype):
    return layer_norm(x, p["weight"], p["bias"], dtype)


def _dense(p, x, dtype):
    if "weight_int8" in p:
        # weight-only int8: (x @ w_int8) * scale + bias in the reference's
        # rounding order; the per-output-channel scale applies to the output
        y = F.linear(x.to(dtype), p["weight_int8"].to(dtype))
        y = y * p["scale"].to(dtype)
        return y + p["bias"].to(dtype)
    return dense(x, p["weight"], p["bias"], dtype)


def quantize_params_int8(params: dict) -> dict:
    """Weight-only int8 of every Dense weight in an LM parameter tree
    (qkv, proj, mlp_up, mlp_down, lm_head), with per-output-channel
    symmetric scales max|w| / 127 clamped at 1e-8: each (out, in) `weight`
    becomes `weight_int8` (int8, same layout) and `scale` (out,) f32.
    Embeddings, positions, layernorms and biases stay full precision. The
    codes and scales equal the reference's (whose kernels are (in, out))."""

    def quant(weight):
        scale = (weight.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
        q = torch.clamp(torch.round(weight / scale[:, None]), -127, 127).to(torch.int8)
        return q, scale.float()

    def walk(tree):
        out = {}
        for name, sub in tree.items():
            if name in DENSE_NAMES and isinstance(sub, dict) and "weight" in sub:
                q, scale = quant(sub["weight"])
                out[name] = {"weight_int8": q, "scale": scale, "bias": sub["bias"]}
            elif isinstance(sub, dict):
                out[name] = walk(sub)
            else:
                out[name] = sub
        return out

    return walk(params)


def scaled_scores(q, k):
    """einsum("bqhd,bkhd->bhqk") in q's dtype divided by sqrt(head_dim), as
    the reference rounds it: the square root in f32, then to q's dtype."""
    d = q.shape[-1]
    scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype).item()
    return torch.einsum("bqhd,bkhd->bhqk", q, k.to(q.dtype)) / scale


def masked(scores, valid):
    """`scores` where `valid`, else -1e30 rounded to their dtype."""
    fill = torch.tensor(NEG_INF, dtype=scores.dtype).item()
    return scores.masked_fill(~valid, fill)


def attend_bf16_cache(q, k, v, valid, dtype):
    """The reference's bf16-cache decode attention: q (B, Q, H, D) against
    k, v (B, L, H, D), `valid` broadcastable to (B, H, Q, L); f32 softmax,
    value product in `dtype`."""
    scores = masked(scaled_scores(q, k), valid)
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v.to(dtype))


def _block_with_cache(bp, x, cache_kv, pos, num_heads, mlp_ratio, dtype, prefill: bool):
    """One transformer block over `x` ((B, S, E); S = prompt length in
    prefill, 1 in decode), reading and writing the layer cache in place.

    prefill=True: causal attention within x, and the cache written at
    [0, S). prefill=False: x is one token at position `pos` (an int); the
    cache is written at pos and attended over [0, pos]."""
    b, s, e = x.shape
    head_dim = e // num_heads
    y = _ln(bp["LayerNorm_0"], x, dtype)
    qkv = _dense(bp["qkv"], y, dtype)
    q, k, v = (t.reshape(b, s, num_heads, head_dim) for t in qkv.split(e, dim=-1))
    int8_cache = "k_scale" in cache_kv
    if prefill:
        if int8_cache:
            (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
            cache_kv["k"][:, :s], cache_kv["v"][:, :s] = kq, vq
            cache_kv["k_scale"][:, :s], cache_kv["v_scale"][:, :s] = ks, vs
        else:
            cache_kv["k"][:, :s] = k.to(torch.bfloat16)
            cache_kv["v"][:, :s] = v.to(torch.bfloat16)
        # causal attention on the fresh full-precision k/v either way: the
        # int8 error enters where decode steps re-read the cache
        attn = attention_reference(q, k, v, causal=True)
    elif int8_cache:
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        cache_kv["k"][:, pos], cache_kv["v"][:, pos] = kq[:, 0], vq[:, 0]
        cache_kv["k_scale"][:, pos], cache_kv["v_scale"][:, pos] = ks[:, 0], vs[:, 0]
        attn = decode_attention_int8(q[:, 0], cache_kv["k"], cache_kv["k_scale"], cache_kv["v"],
                                     cache_kv["v_scale"], pos, layout="blhd")[:, None]
    else:
        cache_kv["k"][:, pos] = k[:, 0].to(torch.bfloat16)
        cache_kv["v"][:, pos] = v[:, 0].to(torch.bfloat16)
        valid = torch.arange(cache_kv["k"].shape[1], device=x.device) <= pos
        attn = attend_bf16_cache(q, cache_kv["k"], cache_kv["v"], valid, dtype)
    x = x + _dense(bp["proj"], attn.reshape(b, s, e), dtype)
    y = _ln(bp["LayerNorm_1"], x, dtype)
    y = F.gelu(_dense(bp["mlp_up"], y, dtype), approximate="tanh")
    return x + _dense(bp["mlp_down"], y, dtype)


def _embed(params, tokens, pos_start: int, model):
    """Token plus position embeddings of (B, S) tokens at positions
    [pos_start, pos_start + S); the start clamps so the slice fits the
    table, as the reference's `lax.dynamic_slice` does."""
    s = tokens.shape[1]
    start = max(0, min(int(pos_start), model.max_seq_len - s))
    x = params["tok_embed"]["weight"][tokens].to(model.dtype)
    return x + params["pos_embed"][start:start + s].to(model.dtype)


def _head(params, x, model):
    # the configured logits dtype (bf16 by default), as the training forward
    return _dense(params["lm_head"], _ln(params["LayerNorm_0"], x, model.dtype),
                  model.logits_dtype)


@torch.no_grad()
def prefill(model, params, tokens, max_len: int, cache_int8: bool = False):
    """Run the prompt (B, S) through the stack, filling a length-max_len
    cache on the prompt's device. Returns (cache, last_logits (B, vocab)).
    Prompt attention runs on the fresh full-precision k/v, so the logits
    are exact with `cache_int8` too."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache length {max_len}")
    cache = init_kv_cache(model, b, max_len, int8=cache_int8, device=tokens.device)
    x = _embed(params, tokens, 0, model)
    for i in range(model.num_layers):
        name = f"Block_{i}"
        x = _block_with_cache(params[name], x, cache[name], 0, model.num_heads,
                              model.mlp_ratio, model.dtype, prefill=True)
    return cache, _head(params, x[:, -1:], model)[:, 0]


@torch.no_grad()
def decode_step(model, params, cache, token, pos: int):
    """One decode forward: `token` (B, 1) at position `pos` through every
    layer against the cache (written at pos in place); returns the next
    logits (B, vocab)."""
    x = _embed(params, token, pos, model)
    for i in range(model.num_layers):
        name = f"Block_{i}"
        x = _block_with_cache(params[name], x, cache[name], pos, model.num_heads,
                              model.mlp_ratio, model.dtype, prefill=False)
    return _head(params, x, model)[:, 0]


def _pick(logits, temperature: float, rng):
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0].to(torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)


@torch.no_grad()
def generate(
    model,
    params,
    prompt: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    rng: torch.Generator | None = None,
    max_len: int | None = None,
    cache_int8: bool = False,
    unroll: int = 1,
) -> torch.Tensor:
    """Greedy (temperature=0) or sampled continuation of `prompt` (B, S), on
    the prompt's device (which is the parameters').

    Returns (B, max_new_tokens) int32. The decode loop runs
    max_new_tokens - 1 forwards of one token a row: the reference's scan
    computes one more, whose logits no token reads. With `cache_int8` each
    forward launches K3 once a layer on the card, so a call launches it
    num_layers * (max_new_tokens - 1) times.

    Sampling draws from softmax(logits / temperature) with `rng`, a
    `torch.Generator` on the prompt's device: deterministic per generator,
    but not JAX's random bits. `unroll` is accepted and changes nothing:
    the reference's unrolled scan is token-identical by its own contract,
    and a Python loop has no scan iterations to amortise.

    cache_int8 stores the cache as int8 with per-(token, head) f32 scales;
    greedy continuations can diverge from the bf16 cache where the top-2
    logits are closer than the quantisation error.
    """
    del unroll
    b, s = prompt.shape
    max_len = max_len or model.max_seq_len
    if max_len > model.max_seq_len:
        # past max_seq_len there are no position embeddings
        raise ValueError(
            f"max_len {max_len} exceeds model.max_seq_len "
            f"{model.max_seq_len} (no position embeddings past it)"
        )
    if s + max_new_tokens > max_len:
        raise ValueError(f"prompt {s} + new {max_new_tokens} exceeds cache {max_len}")
    if temperature > 0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs an rng (a torch.Generator)")
    cache, logits = prefill(model, params, prompt, max_len, cache_int8=cache_int8)
    tokens = torch.empty((b, max_new_tokens), dtype=torch.int32, device=prompt.device)
    for t in range(max_new_tokens):
        token = _pick(logits, temperature, rng)
        tokens[:, t] = token
        if t == max_new_tokens - 1:
            break
        logits = decode_step(model, params, cache, token[:, None], s + t)
    return tokens
