"""Dense single-device attention: the port's copy of
`attention_reference` and `attention_reference_layout` from
`tritonk8ssupervisor_tpu/ops/ring_attention.py` (:73-99).

This is the plain version of kernel K2 (`ops/flash_attention.py`), with
the reference's arithmetic order kept so that CPU results match it: the
scores come from an einsum in q's dtype and are divided by sqrt(d) in
q's dtype, the causal mask is the finite -1e30, the softmax runs in f32,
and the probabilities are cast to v's dtype before the value einsum.

The ring itself (sequence parallelism over a device ring) is not ported
yet: ROADMAP.md queue 1, item 4.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # large-finite instead of -inf, as the reference


def attention_reference(q, k, v, causal: bool = False):
    """Dense attention over (batch, seq, heads, head_dim) q, k, v."""
    _, s, _, d = q.shape
    # sqrt(d) and the mask value rounded to q's dtype (-1e30 is -inf in
    # fp16, as in the reference) and passed as Python numbers: no
    # host-to-device copy, so a call on the card does not wait for the card
    scale = torch.tensor(float(d) ** 0.5, dtype=q.dtype).item()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
    if causal:
        pos = torch.arange(s, device=q.device)
        masked = torch.tensor(_NEG_INF, dtype=scores.dtype).item()
        scores = scores.masked_fill(pos[:, None] < pos[None, :], masked)
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_reference_layout(q, k, v, causal: bool, layout: str):
    """`attention_reference` for either layout: "bshd" (batch, seq, heads,
    head_dim) or "bhsd" (batch, heads, seq, head_dim), which pays a
    transpose pair."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout={layout!r}: expected 'bshd' or 'bhsd'")
    if layout == "bhsd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        return attention_reference(q, k, v, causal=causal).transpose(1, 2)
    return attention_reference(q, k, v, causal=causal)
