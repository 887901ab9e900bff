"""Decode attention over the int8 KV cache: the port of
`tritonk8ssupervisor_tpu/ops/decode_attention.py::decode_attention_int8`
(:79-113, kernel :58-75).

For each batch row b, head h and query w, with int8 keys and values and
their per-(token, head) f32 scales:

    scores = sum_d(k8 * q) * k_scale * (1 / sqrt(D))    in f32
    scores = -1e30 where position > pos[b, w]
    p      = softmax(scores) * v_scale                  exact, in f32
    out    = sum_l p * v8                               in f32, cast to q's dtype

The reference reads one query per (b, h) against a head-major cache at one
scalar position. The port's contract generalises only what its paths need,
and each generalisation reduces to that function:

- `layout="bhld"`: k8/v8 (B, H, L, D) and scales (B, H, L), the TPU
  kernel's head-major layout; `layout="blhd"`: k8/v8 (B, L, H, D) and
  scales (B, L, H), the cache's own layout (`models/decode.py`);
  `layout="paged"`: the serving engine's pool, k8/v8 (P, page_size, H, D)
  and scales (P, page_size, H), read through `tables`, an int32
  (B, n_pages) page table: position j of row b lies at
  `[tables[b, j // page_size], j % page_size]`, for j < L = n_pages *
  page_size. It is the "blhd" function on the engine's gathered view
  `t[tables[:, j // page_size], j % page_size]`, by construction.
- `pos`: a Python int (dense `generate`), a (B,) int32 tensor (the engine's
  per-slot positions), or, with q of shape (B, W, H, D), a (B, W) int32
  tensor: the speculative verify window, where query w attends
  [0, pos[b, w]].

In the port every int8-cache single-token attention goes through this
function: `models/decode.generate` with `cache_int8` ("blhd"), and the
engine's decode, drafter and verify steps ("paged"). The reference computes
the same function there as an einsum chain (`models/decode.py:328-345`),
which rounds the scores and probabilities to the model dtype on a bf16
model; this function keeps them in f32, as the TPU kernel does.

On CPU tensors this is the plain version (`decode_attention_int8_plain`).
On CUDA tensors it launches kernel K3 (`csrc/decode_attention.cu`), bound
as the `torch.library` op `tk8s::decode_attn_int8` (a fake implementation
gives the output's shape); what K3 does not take raises,
and nothing falls back to the plain version. Each call that launches K3
is counted once in `decode_attention_kernel.launches`.
"""

from __future__ import annotations

import torch

from tritonk8ssupervisor_tpu_torch.ops import decode_attention_cuda

LAYOUTS = ("bhld", "blhd", "paged")
NEG_INF = -1e30


def _check_shapes(q, k8, k_scale, v8, v_scale, pos, layout: str, tables=None) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}: expected 'bhld', 'blhd' or 'paged'")
    if (tables is not None) != (layout == "paged"):
        raise ValueError(f"layout={layout!r} with tables={'a tensor' if tables is not None else None}"
                         ": the paged layout and only it takes page tables")
    if q.dim() not in (3, 4) or k8.dim() != 4 or v8.shape != k8.shape:
        raise ValueError(
            f"expected q (B, H, D) or (B, W, H, D) and k8, v8 of one 4-d shape, got "
            f"{tuple(q.shape)}, {tuple(k8.shape)}, {tuple(v8.shape)}"
        )
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    if layout == "paged":
        cache = (k8.shape[0], k8.shape[1], h, d)
        if tables.dim() != 2 or tables.shape[0] != b:
            raise ValueError(f"tables of shape {tuple(tables.shape)} for q {tuple(q.shape)}: "
                             f"expected ({b}, n_pages)")
    else:
        cache = (b, h, k8.shape[2], d) if layout == "bhld" else (b, k8.shape[1], h, d)
    if tuple(k8.shape) != cache or k_scale.shape != k8.shape[:3] or v_scale.shape != k8.shape[:3]:
        raise ValueError(
            f"q {tuple(q.shape)} against a {layout} cache {tuple(k8.shape)} with scales "
            f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}"
        )
    if isinstance(pos, torch.Tensor):
        rows = (b,) if q.dim() == 3 else (b, q.shape[1])
        if tuple(pos.shape) != rows:
            raise ValueError(f"pos of shape {tuple(pos.shape)} for q {tuple(q.shape)}: "
                             f"expected an int or a tensor of shape {rows}")


def gather_pages(x, tables):
    """The (B, L, ...) logical view of a (P, page_size, ...) pool through
    (B, n_pages) page tables, L = n_pages * page_size: the serving
    engine's gather."""
    page_size = x.shape[1]
    logical = torch.arange(tables.shape[1] * page_size, device=x.device)
    return x[tables.long()[:, logical // page_size], logical % page_size]


def decode_attention_int8_plain(q, k8, k_scale, v8, v_scale, pos, layout: str = "bhld",
                                tables=None):
    """K3's arithmetic in plain torch, in the TPU kernel's order: q and the
    keys upcast to f32, scores summed and scaled, masked, an exact f32
    softmax, times the value scales, summed against the values in f32, and
    cast to q's dtype. The paged layout gathers each row's logical view
    first. Arguments as `decode_attention_int8`."""
    _check_shapes(q, k8, k_scale, v8, v_scale, pos, layout, tables)
    if layout == "paged":
        k8, k_scale, v8, v_scale = (gather_pages(t, tables) for t in (k8, k_scale, v8, v_scale))
        layout = "blhd"
    window = q.dim() == 4
    qw = q if window else q[:, None]  # (B, W, H, D)
    if layout == "blhd":  # head-major views: (B, H, L, D) and (B, H, L)
        k8, v8 = k8.transpose(1, 2), v8.transpose(1, 2)
        k_scale, v_scale = k_scale.transpose(1, 2), v_scale.transpose(1, 2)
    b, w, _, d = qw.shape
    length = k8.shape[2]
    scores = torch.einsum("bwhd,bhld->bhwl", qw.float(), k8.float())
    scores = scores * k_scale[:, :, None, :] * (1.0 / (d ** 0.5))
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(b, 1, -1, 1)  # (B, 1, W or 1, 1)
    valid = torch.arange(length, device=q.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    scores = scores - scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores)
    p = p / p.sum(dim=-1, keepdim=True)
    p = p * v_scale[:, :, None, :]
    out = torch.einsum("bhwl,bhld->bwhd", p, v8.float()).to(q.dtype)
    return out if window else out[:, 0]


def _on_one_cuda_device(*tensors) -> bool:
    return all(t.device.type == "cuda" and t.device == tensors[0].device for t in tensors)


def _check_kernel_inputs(q, k8, k_scale, v8, v_scale, pos, tables) -> None:
    """Raise unless q (B, W, H, D), the cache, the tables and pos are what
    K3 takes."""
    extra = [t for t in (pos, tables) if isinstance(t, torch.Tensor)]
    tensors = [q, k8, k_scale, v8, v_scale, *extra]
    if not _on_one_cuda_device(*tensors):
        raise ValueError(
            f"{[str(t.device) for t in tensors]}: K3 needs q, the cache, its scales, the page "
            "tables and a tensor pos on one CUDA device (CPU tensors take the plain version)"
        )
    if (q.dtype not in decode_attention_cuda.DTYPES or k8.dtype != torch.int8
            or v8.dtype != torch.int8 or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32
            or any(t.dtype != torch.int32 for t in extra)):
        raise TypeError(
            f"K3 takes q in bf16, fp16 or f32, int8 k8/v8, f32 scales, an int or int32 pos "
            f"and int32 page tables, got {q.dtype}, {k8.dtype}, {v8.dtype}, {k_scale.dtype}, "
            f"{v_scale.dtype}, {pos.dtype if isinstance(pos, torch.Tensor) else type(pos)}"
            + ("" if tables is None else f", tables {tables.dtype}")
        )
    b, w, h, d = q.shape
    if d % decode_attention_cuda.HEAD_DIM_MULTIPLE or d > decode_attention_cuda.MAX_HEAD_DIM:
        raise ValueError(f"K3 takes a head_dim that is a multiple of 16 up to 256, got {d}")
    if q.stride(-1) != 1 or k8.stride(-1) != 1 or v8.stride(-1) != 1:
        raise ValueError("K3 reads q, k8 and v8 with unit stride on head_dim")
    if not all(x.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in x.stride()[:3])
               for x in (k8, v8)):
        raise ValueError("K3 reads k8 and v8 as 16-byte aligned rows")
    length = tables.shape[1] * k8.shape[1] if tables is not None else k8.numel() // (b * h * d)
    if length > 2**31 - 1:
        raise ValueError(f"K3 indexes positions with int32, got L = {length}")
    chunks = decode_attention_cuda.n_chunks(pos, length)
    if b * h * max(w, chunks) > 2**31 - 1:
        raise ValueError(f"K3's grid takes at most 2^31 - 1 blocks, got {b * h * max(w, chunks)}")


def decode_attention_kernel(q, k8, k_scale, v8, v_scale, pos, layout: str, tables=None):
    """K3's wrapper: q (B, W, H, D) and the cache on one CUDA device ->
    (B, W, H, D) in q's dtype; anything K3 does not take raises. One call
    (the chunk kernel and its combine), counted once in
    `decode_attention_kernel.launches`."""
    _check_kernel_inputs(q, k8, k_scale, v8, v_scale, pos, tables)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    decode_attention_cuda.forward(q, k8, k_scale, v8, v_scale, pos, out, layout, tables)
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0


# K3 runs up to num_layers times a decode token, so its binding is the
# dispatcher's own: `torch.library.Library.define` and `impl` call the
# launcher directly, where `torch.library.custom_op` adds its Python
# autograd and aliasing wrappers to every call (~20 us a call on a CPU)
_LIB = torch.library.Library("tk8s", "FRAGMENT")
_LIB.define("decode_attn_int8(Tensor q, Tensor k8, Tensor k_scale, Tensor v8, Tensor v_scale, "
            "Tensor? pos, int pos_scalar, str layout, Tensor? tables=None) -> Tensor")


def _decode_attn_int8(q, k8, k_scale, v8, v_scale, pos, pos_scalar, layout, tables=None):
    return decode_attention_kernel(q, k8, k_scale, v8, v_scale,
                                   pos_scalar if pos is None else pos, layout, tables)


_LIB.impl("decode_attn_int8", _decode_attn_int8, "CUDA")


@torch.library.register_fake("tk8s::decode_attn_int8", lib=_LIB)
def _(q, k8, k_scale, v8, v_scale, pos, pos_scalar, layout, tables=None):
    return q.new_empty(q.shape)


def decode_attention_int8(q, k8, k_scale, v8, v_scale, pos, layout: str = "bhld", tables=None):
    """One decode step's attention against an int8 KV cache.

    Args:
      q: (B, H, D) queries, or (B, W, H, D) for a window of W queries a row
        (any float dtype on the CPU; bf16, fp16 or f32 on the card).
      k8, v8: int8 keys and values, (B, H, L, D) for `layout="bhld"`,
        (B, L, H, D) for `layout="blhd"`, or a (P, page_size, H, D) pool
        for `layout="paged"`.
      k_scale, v_scale: f32 per-(token, head) scales, (B, H, L), (B, L, H)
        or (P, page_size, H).
      pos: the last position each query attends, [0, pos]: a Python int
        for every row, a (B,) int32 tensor per row, or with a window a
        (B, W) int32 tensor per query. A pos below 0 masks every position,
        and the softmax is then uniform over all L, as in the reference.
      tables: with `layout="paged"` only, the (B, n_pages) int32 page
        table of each row (int64 too on the CPU); L = n_pages *
        page_size. Every id must name a page of the pool.

    Returns q's shape and dtype. CPU tensors: the plain version. CUDA
    tensors: K3.
    """
    tensors = [t for t in (q, k8, k_scale, v8, v_scale, pos, tables)
               if isinstance(t, torch.Tensor)]
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_int8_plain(q, k8, k_scale, v8, v_scale, pos, layout, tables)
    _check_shapes(q, k8, k_scale, v8, v_scale, pos, layout, tables)
    window = q.dim() == 4
    qw = q if window else q[:, None]
    if isinstance(pos, torch.Tensor):
        out = torch.ops.tk8s.decode_attn_int8(qw, k8, k_scale, v8, v_scale, pos, 0, layout,
                                              tables)
    else:
        out = torch.ops.tk8s.decode_attn_int8(qw, k8, k_scale, v8, v_scale, None, int(pos),
                                              layout, tables)
    return out if window else out[:, 0]
