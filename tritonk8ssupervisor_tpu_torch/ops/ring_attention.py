"""Ring attention and dense attention: the port of
`tritonk8ssupervisor_tpu/ops/ring_attention.py`.

`attention_reference` and `attention_reference_layout` (:73-99) are the
dense attention of one device.

This is the plain version of kernel K2 (`ops/flash_attention.py`), with
the reference's arithmetic order kept so that CPU results match it: the
scores come from an einsum in q's dtype and are divided by sqrt(d) in
q's dtype, the causal mask is the finite -1e30, the softmax runs in f32,
and the probabilities are cast to v's dtype before the value einsum.

`ring_attention` (:331) is exact attention over a sequence sharded on a
mesh axis, per rank: each rank holds one block of q, k and v; the k/v
blocks travel the ring by point-to-point sends (`parallel/collectives.
ppermute`, whose gradient travels back the other way) while each rank
folds the visiting block into an online softmax in f32, as the
reference does with plain einsums (no flash kernel inside the ring). The
causal path uses the zigzag layout (rank i computes chunks i and 2n-1-i
of 2n), which folds two half-chunk products a hop on every rank, ~half
the dense ring's work; a sequence whose block does not halve takes the
contiguous ring with the full mask. Positions in the causal masks are
the global ones.
"""

from __future__ import annotations

import functools

import torch

from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll
from tritonk8ssupervisor_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    axis_sizes,
    mesh_group,
)

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


def _init_stats(b, rows, h, d, device):
    """Online-softmax state in f32: running max, running sum, output."""
    m = torch.full((b, h, rows), _NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((b, h, rows), dtype=torch.float32, device=device)
    acc = torch.zeros((b, rows, h, d), dtype=torch.float32, device=device)
    return m, l, acc


def _fold(stats, q, k, v, scale, qpos=None, kpos=None):
    """Fold one visiting k/v block into the online softmax; positions,
    when given, apply the causal mask (reference :115-131)."""
    m, l, acc = stats
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if qpos is not None:
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l = l * correction + p.sum(dim=-1)
    acc = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    return m_new, l, acc


def _finalize(stats, dtype):
    _, l, acc = stats
    return (acc / l.transpose(1, 2)[..., None]).to(dtype)


def _rotate_perm(n):
    return [(j, (j - 1) % n) for j in range(n)]


def _ring_shard_dense(q, k, v, *, group, causal: bool):
    """Contiguous layout: every rank folds all n k/v blocks (reference
    :143-182). Exact for both masks; the causal fallback."""
    n, idx = group.size(), group.rank()
    b, blk, h, d = q.shape
    scale = 1.0 / float(d) ** 0.5
    stats = _init_stats(b, blk, h, d, q.device)
    steps = torch.arange(blk, device=q.device)
    qpos = idx * blk + steps

    def fold_block(stats, k, v, src):
        if causal:
            return _fold(stats, q, k, v, scale, qpos, src * blk + steps)
        return _fold(stats, q, k, v, scale)

    stats = fold_block(stats, k, v, idx)  # hop 0: this rank's own block
    for hop in range(1, n):
        k = coll.ppermute(k, group, _rotate_perm(n))
        v = coll.ppermute(v, group, _rotate_perm(n))
        stats = fold_block(stats, k, v, (idx + hop) % n)
    return _finalize(stats, q.dtype)


def _select(pred, a, b):
    return tuple(torch.where(pred, x, y) for x, y in zip(a, b))


def _ring_shard_zigzag(q, k, v, *, group):
    """Causal, zigzag layout (reference :185-292). Rank i computes query
    chunks A = i and B = 2n-1-i (chunk c = block/2); the visiting pair
    from source s carries U = s and V = 2n-1-s. A x U iff s <= i, B x U
    always (unmasked), B x V iff s >= i, A x V never: hop 0 folds three
    products, every later hop B x U and one of A x U (s < i) or B x V,
    picked with selects on operands and accumulators, as the reference
    does. The selects keep every rank's autograd graph the same, so the
    ranks run their backward sends in the same order (a Python branch
    would wire each rank's graph differently)."""
    n, idx = group.size(), group.rank()
    b, blk, h, d = q.shape
    c = blk // 2
    scale = 1.0 / float(d) ** 0.5
    steps = torch.arange(c, device=q.device)

    def target(g):  # chunk id -> owning rank in the zigzag layout
        return g if g < n else 2 * n - 1 - g

    perm_even = [(dev, target(2 * dev)) for dev in range(n)]
    perm_odd = [(dev, target(2 * dev + 1)) for dev in range(n)]
    even_here = torch.tensor(idx % 2 == 0, device=q.device)

    def to_zigzag(x):
        """Contiguous block (chunks 2i, 2i+1) -> zigzag pair (i, 2n-1-i)."""
        recv_even = coll.ppermute(x[:, :c], group, perm_even)
        recv_odd = coll.ppermute(x[:, c:], group, perm_odd)
        return _select(even_here, (recv_even, recv_odd), (recv_odd, recv_even))

    def from_zigzag(low, high):
        send_even, send_odd = _select(even_here, (low, high), (high, low))
        inv_even = [(dst, src) for src, dst in perm_even]
        inv_odd = [(dst, src) for src, dst in perm_odd]
        return torch.cat([coll.ppermute(send_even, group, inv_even),
                          coll.ppermute(send_odd, group, inv_odd)], dim=1)

    qA, qB = to_zigzag(q)
    kU, kV = to_zigzag(k)
    vU, vV = to_zigzag(v)

    def chunk_pos(chunk_id):
        return chunk_id * c + steps

    posA, posB = chunk_pos(idx), chunk_pos(2 * n - 1 - idx)
    statsA = _init_stats(b, c, h, d, q.device)
    statsB = _init_stats(b, c, h, d, q.device)
    # hop 0: the resident pair, two diagonals and the fully visible B x U
    statsA = _fold(statsA, qA, kU, vU, scale, posA, posA)
    statsB = _fold(statsB, qB, kV, vV, scale, posB, posB)
    statsB = _fold(statsB, qB, kU, vU, scale)
    for hop in range(1, n):
        kU, kV, vU, vV = (coll.ppermute(t, group, _rotate_perm(n)) for t in (kU, kV, vU, vV))
        src = (idx + hop) % n
        statsB = _fold(statsB, qB, kU, vU, scale)
        # the second product: A x U when src < idx, else B x V
        pred = torch.tensor(src < idx, device=q.device)
        folded = _fold(_select(pred, statsA, statsB), torch.where(pred, qA, qB),
                       torch.where(pred, kU, kV), torch.where(pred, vU, vV), scale,
                       torch.where(pred, posA, posB),
                       torch.where(pred, chunk_pos(src), chunk_pos(2 * n - 1 - src)))
        statsA = _select(pred, folded, statsA)
        statsB = _select(pred, statsB, folded)
    return from_zigzag(_finalize(statsA, q.dtype), _finalize(statsB, q.dtype))


def _resolve_batch_axis(mesh, axis_name: str, batch_axis, batch: int | None):
    """The axes the batch dim shards over beside the ring axis (reference
    :295-328): "auto" is the mesh's batch axes (data, plus expert where
    it is larger than 1) when they exist, differ from the ring axis and
    divide `batch` (None skips that check), falling back to data alone,
    then to none."""
    if batch_axis != "auto":
        return batch_axis
    sizes = axis_sizes(mesh)
    cands = tuple(a for a in (DATA_AXIS, EXPERT_AXIS)
                  if a in sizes and a != axis_name and (a == DATA_AXIS or sizes[a] > 1))
    if not cands or DATA_AXIS not in cands:
        return None
    degree = functools.reduce(lambda x, a: x * sizes[a], cands, 1)
    if batch is None or batch % degree == 0:
        return cands if len(cands) > 1 else cands[0]
    if batch % sizes[DATA_AXIS] == 0:
        return DATA_AXIS
    return None


def ring_attention(q, k, v, mesh, axis_name: str, causal: bool = False,
                   batch_axis: str | None = "auto"):
    """Exact attention with the sequence sharded over `axis_name`, per
    rank: q, k, v are this rank's (batch shard, seq / n, heads, head_dim)
    blocks, laid out by `sequence_sharding`, and the result is this
    rank's block of the output. The causal path is the zigzag schedule
    whenever the block halves. `batch_axis` only names the layout of the
    batch dim (`sequence_sharding`); the ring itself runs within this
    rank's batch rows."""
    del batch_axis  # each rank already holds its batch rows
    group = mesh_group(mesh, axis_name)
    if causal and q.shape[1] % 2 == 0:
        return _ring_shard_zigzag(q, k, v, group=group)
    return _ring_shard_dense(q, k, v, group=group, causal=causal)


def causal_fold_units(n: int) -> int:
    """Half-chunk score products per rank on the causal zigzag path: 2 a
    hop plus the resident diagonal (reference :375-380)."""
    return 2 * n + 1


def dense_fold_units(n: int) -> int:
    """Half-chunk product equivalents per rank on the contiguous ring: n
    folds of a whole block, 4 half-chunk products each."""
    return 4 * n


def sequence_sharding(mesh, axis_name: str, batch_axis: str | None = "auto",
                      batch: int | None = None) -> tuple:
    """The spec of (batch, seq, heads, head_dim) activations: seq over the
    ring axis, batch over the resolved batch axes (`parallel/mesh.
    local_shard` takes a rank's block of a global array by it)."""
    return (_resolve_batch_axis(mesh, axis_name, batch_axis, batch), axis_name, None, None)
