"""K3's launcher: the ctypes binding of `csrc/decode_attention.cu`.

The kernel source says what it replaces and how it is built; this module
turns tensors into its arguments: data pointers, the (batch, page, length
or window, head) strides of every operand, the page tables, the position
(a device pointer or one scalar), the f32 scratch of the per-chunk
partial results (`torch.empty` a call), the per-row counters by which
the last CTA of a row finds itself (one int32 buffer a device and
stream, zeroed once; every launch leaves it zero), and PyTorch's current
stream. The caller
(`ops/decode_attention.py`) has checked device, dtypes, widths and
alignment and allocated the output; a launch that the runtime refuses
raises here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

SOURCE = "decode_attention.cu"
# q's dtypes the kernel is instantiated for -> their code in the C interface
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
HEAD_DIM_MULTIPLE = 16  # a key row is whole 16-byte vectors of int8
MAX_HEAD_DIM = 256
# positions a chunk (one CTA each), the kernel's kChunk
CHUNK = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.tk8s_decode_attn_int8.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                                          _STRIDES, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.tk8s_decode_attn_int8.restype = _I
    lib.tk8s_decode_attn_error_string.argtypes = [_I]
    lib.tk8s_decode_attn_error_string.restype = ctypes.c_char_p
    return lib


_counters: dict = {}


def counters(device: torch.device, stream: int, rows: int) -> torch.Tensor:
    """At least `rows` int32 zeros on `device` for launches on `stream`:
    kept between calls (each launch leaves them zero), grown as needed."""
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < rows:
        buf = _counters[key] = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
    return buf


def n_chunks(pos, length: int) -> int:
    """Chunks a launch covers: those of [0, n) for a Python-int pos (n =
    pos + 1, or L when pos < 0 or pos >= L), all of L for a tensor pos,
    which stays on the card."""
    n = length
    if not isinstance(pos, torch.Tensor) and 0 <= pos < length:
        n = pos + 1
    return -(-n // CHUNK)


def _cache_strides(x, layout: str) -> tuple[int, int, int, int]:
    """(b, page, l, h) strides of a cache operand (int8 rows or scales)."""
    if layout == "bhld":
        return x.stride(0), 0, x.stride(2), x.stride(1)
    if layout == "blhd":
        return x.stride(0), 0, x.stride(1), x.stride(2)
    return 0, x.stride(0), x.stride(1), x.stride(2)  # paged: (P, page_size, H, ...)


def forward(q, k8, k_scale, v8, v_scale, pos, out, layout: str, tables=None) -> None:
    """out (B, W, H, D) from q (B, W, H, D), the cache in `layout`
    ("bhld", "blhd", or "paged": a (P, page_size, H, D) pool read through
    the int32 (B, n_pages) `tables`) and `pos`: an int, or an int32 tensor
    of shape (B,) or (B, W)."""
    lib = _lib()
    b, w, h, d = q.shape
    if layout == "paged":
        page_size = k8.shape[1]
        length = tables.shape[1] * page_size
        table_ptr, table_strides = tables.data_ptr(), tables.stride()
    else:
        page_size, table_ptr, table_strides = 0, None, (0, 0)
        length = k8.shape[2] if layout == "bhld" else k8.shape[1]
    if isinstance(pos, torch.Tensor):
        pos_ptr, pos_scalar = pos.data_ptr(), 0
        pos_strides = (pos.stride(0), pos.stride(1) if pos.dim() == 2 else 0)
    else:
        pos_ptr, pos_scalar, pos_strides = None, int(pos), (0, 0)
    chunks = n_chunks(pos, length)
    # the partial results of every (b, h, query, chunk): o over D, then (m, l)
    part_o = torch.empty(b * h * w * chunks * d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(b * h * w * chunks * 2, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rows = counters(q.device, stream, b * h)
    flat = [*q.stride()[:3],
            *(s for x in (k8, k_scale, v8, v_scale) for s in _cache_strides(x, layout)),
            *table_strides, *pos_strides, *out.stride()[:3]]
    code = lib.tk8s_decode_attn_int8(
        DTYPES[q.dtype], q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
        v_scale.data_ptr(), table_ptr, page_size, pos_ptr, pos_scalar, out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), rows.data_ptr(),
        (ctypes.c_longlong * len(flat))(*flat), len(flat), b, w, h, length, d, CHUNK, chunks,
        1.0 / d ** 0.5, stream,
    )
    if code != 0:
        rows.zero_()  # a launch that did not run to its end may leave counts
        raise RuntimeError(
            f"K3 launch failed at (B, W, H, L, D) = {(b, w, h, length, d)}, {layout}: "
            f"{lib.tk8s_decode_attn_error_string(code).decode()} ({code})"
        )
