"""A pre-LN GPT decoder in plain PyTorch float32, trained by SGD with
Nesterov momentum: the reference of the benchmark's LM cells.

Weights are a dict of leaves under the names the benchmark gives them
(`Block_<i>.qkv.weight`, ...; `portbench/families/lm.py` lists them).
Each block is x + proj(attn(LN(x))), then x + down(gelu_tanh(up(LN(x)))),
with LayerNorm over the last axis (epsilon from the configuration),
causal softmax attention scaled by 1/sqrt(head_dim), learned positions
added to the token embedding, a final LayerNorm and an output projection
with a bias. The loss is the mean next-token cross-entropy over
batch x (seq - 1) positions: the targets are the tokens shifted left by
one and the last position has none.

It is computed in blocks so that it fits beside nothing else on the card:
micro-batches of whole sequences whose gradients add up, each block
recomputed in the backward (`torch.utils.checkpoint`), attention a block
of queries at a time against the keys the causal mask keeps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import Precision

QUERY_BLOCK = 1024
MICRO_TOKENS = 8192


def _layer_norm(x, weight, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _linear(prec: Precision, x, weight, bias):
    return prec.product(F.linear, x, weight) + bias


def _attention_rows(prec: Precision, q, k, v, start: int):
    """Causal attention of the queries q (b, h, n, d), at positions start..
    start+n-1, over the keys and values (b, h, start+n, d) they may see."""
    n, d = q.shape[2], q.shape[3]
    scores = prec.product(torch.matmul, q, k.transpose(-1, -2)) / math.sqrt(d)
    rows = torch.arange(start, start + n, device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    return prec.product(torch.matmul, torch.softmax(scores, dim=-1), v)


def _attention(prec: Precision, q, k, v):
    s = q.shape[2]
    blocks = []
    for start in range(0, s, QUERY_BLOCK):
        end = min(start + QUERY_BLOCK, s)
        blocks.append(checkpoint(_attention_rows, prec, q[:, :, start:end], k[:, :, :end],
                                 v[:, :, :end], start, use_reentrant=False))
    return torch.cat(blocks, dim=2)


def _block(prec: Precision, w: dict, prefix: str, heads: int, eps: float, x):
    b, s, e = x.shape
    d = e // heads
    y = _layer_norm(x, w[prefix + "LayerNorm_0.weight"], w[prefix + "LayerNorm_0.bias"], eps)
    qkv = _linear(prec, y, w[prefix + "qkv.weight"], w[prefix + "qkv.bias"])
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2) for t in qkv.split(e, dim=-1))
    attn = _attention(prec, q, k, v).transpose(1, 2).reshape(b, s, e)
    x = x + _linear(prec, attn, w[prefix + "proj.weight"], w[prefix + "proj.bias"])
    y = _layer_norm(x, w[prefix + "LayerNorm_1.weight"], w[prefix + "LayerNorm_1.bias"], eps)
    y = _gelu_tanh(_linear(prec, y, w[prefix + "mlp_up.weight"], w[prefix + "mlp_up.bias"]))
    return x + _linear(prec, y, w[prefix + "mlp_down.weight"], w[prefix + "mlp_down.bias"])


def _loss_sum(prec: Precision, w: dict, eps: float, x, targets, mask):
    y = _layer_norm(x, w["LayerNorm_0.weight"], w["LayerNorm_0.bias"], eps)
    logits = _linear(prec, y, w["lm_head.weight"], w["lm_head.bias"])
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                             reduction="none")
    return (losses * mask.reshape(-1)).sum()


def loss_and_grads(w: dict, tokens: torch.Tensor, layers: int, heads: int, eps: float,
                   prec: Precision, batch_share: float = 1.0) -> torch.Tensor:
    """The mean next-token loss of `tokens` (batch, seq); its gradient is
    left in each leaf's `.grad` (leaves must require grad, `.grad` None).
    `batch_share` < 1 keeps that leading share of the rows and takes the
    mean over them alone (the harness's planted fault)."""
    b, s = tokens.shape
    b = max(1, int(b * batch_share))
    tokens = tokens[:b].long()
    denom = b * (s - 1)
    mask_row = (torch.arange(s, device=tokens.device) < s - 1).float()
    micro = max(1, MICRO_TOKENS // s)
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for start in range(0, b, micro):
        chunk = tokens[start:start + micro]
        targets = torch.roll(chunk, -1, dims=1)
        mask = mask_row.expand(chunk.shape[0], s)
        x = w["tok_embed.weight"][chunk] + w["pos_embed"][:s]
        for i in range(layers):
            x = checkpoint(_block, prec, w, f"Block_{i}.", heads, eps, x, use_reentrant=False)
        part = checkpoint(_loss_sum, prec, w, eps, x, targets, mask, use_reentrant=False) / denom
        part.backward()
        total += part.detach().double()
    return total
