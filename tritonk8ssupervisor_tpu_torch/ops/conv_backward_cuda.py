"""K4's launcher: the ctypes binding of `csrc/conv_backward.cu` and of its
TF32 instance, `csrc/conv_backward_tf32.cu`.

The kernel sources say what they replace and how they are built; this
module picks the instance an input runs on from its dtype and widths
alone (`instance`): the bf16/fp16 wgmma kernels at widths that are
multiples of 8, the TF32 kernels for float32 (3xTF32) and for bf16 or
fp16 at every other width (one exact TF32 product). It turns tensors into
their arguments (data pointers, the row count, the split of M for dW,
PyTorch's current stream) and allocates dW's f32 workspace. The caller
(`ops/conv_backward.py`) has checked device, dtype, widths and layout and
allocated the outputs; a launch that the runtime refuses raises here, and
nothing picks another instance.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

SOURCE = "conv_backward.cu"
TF32_SOURCE = "conv_backward_tf32.cu"
# the compute dtypes the wgmma kernels are instantiated for -> their code
# in the C interface
DTYPES = {torch.bfloat16: 0, torch.float16: 1}
# their widths are whole 16-byte rows of 2-byte elements
WIDTH_MULTIPLE = 8
# the TF32 kernels' dtypes -> their codes; they take any width
TF32_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# a contraction shorter than this is summed with exact f32 FMAs by the TF32
# kernels (dX when N < K_MIN, dW when M < K_MIN): the source's header says why
K_MIN = 16

# dW is split over M so that the wgrad grid fills the card in one wave:
# one CTA (128 x 128 of (N, C), 384 threads, 129 KB of shared memory) per
# SM of the H100's 132, so at most WAVE // tiles splits, each at least
# MIN_SPLIT_ROWS rows and a whole number of the kernel's 64-row steps (a
# split's last step must not read the next split's rows). The f32
# workspace is then splits * N * C * 4 bytes <= WAVE * 128 * 128 * 4
# (8.7 MB), whatever the shape.
WAVE = 132
MIN_SPLIT_ROWS = 512
_WG_TILE = 128
_WG_STEP = 64

# the TF32 wgrad's splits of M: one CTA an SM (384 threads, up to 201 KB
# of shared memory) over work items of 128 rows of the wider of N and C by
# a column tile of the narrower (`tf32_tile`), one wave of items, each split
# a whole number of 32-row stages (at least 4, so that the reduction reads
# few partials) and none empty: a narrow call is many short serial loops,
# not one long one. The workspace is at most WAVE items' tiles, 132 * 128 *
# 128 * 4 bytes (8.7 MB)
_TF32_ROWS = 128
_TF32_STEP = 32
_TF32_MIN_SPLIT_ROWS = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split(m: int, c: int, n: int) -> tuple[int, int]:
    """(splits, rows per split) of M for the dW reduction: a fixed
    function of the shape, so dW is summed in the same order every call.
    An empty M is one split of no rows (the wrapper launches nothing)."""
    if m == 0:
        return 1, 0
    tiles = _cdiv(c, _WG_TILE) * _cdiv(n, _WG_TILE)
    splits = max(1, min(WAVE // tiles, _cdiv(m, MIN_SPLIT_ROWS)))
    rows = _cdiv(_cdiv(m, splits), _WG_STEP) * _WG_STEP
    return _cdiv(m, rows), rows


def instance(dtype: torch.dtype, c: int, n: int) -> str:
    """The kernel instance that takes X (M, C), dY (M, N), W (N, C) of
    compute `dtype`, a function of the dtype and widths alone: "wgmma-64",
    "wgmma-128" or "wgmma-256" (dgrad's tile of C) for bf16 and fp16 at
    widths that are multiples of 8, "tf32x3" for float32 and "tf32x1" for
    bf16 or fp16 at any other width. Raises TypeError for any other dtype."""
    if dtype not in TF32_DTYPES:
        raise TypeError(
            f"K4 computes in float32, bf16 or fp16, got {dtype}: other dtypes are "
            "outside its contract (ROADMAP.md, the kernels' limits)"
        )
    if dtype in DTYPES and c % WIDTH_MULTIPLE == 0 and n % WIDTH_MULTIPLE == 0:
        return f"wgmma-{64 if c <= 64 else 128 if c <= 128 else 256}"
    return "tf32x3" if dtype == torch.float32 else "tf32x1"


def tf32_tile(q: int) -> int:
    """The TF32 kernels' column tile for Q columns: 64 where it holds them,
    else 128 (several tiles past 128)."""
    return 64 if q <= 64 else 128


def tf32_split(m: int, c: int, n: int) -> tuple[int, int]:
    """(splits, rows per split) of M for the TF32 instance's dW, a fixed
    function of the shape as `split` is for the wgmma one: its work items
    are 128 rows of max(N, C) by `tf32_tile(min(N, C))` columns, and the
    splits fill one wave of them, in whole 32-row stages, at least 4 a
    split, none empty."""
    if m == 0:
        return 1, 0
    wide, narrow = max(c, n), min(c, n)
    tiles = _cdiv(wide, _TF32_ROWS) * _cdiv(narrow, tf32_tile(narrow))
    splits = max(1, min(WAVE // tiles, _cdiv(m, _TF32_MIN_SPLIT_ROWS)))
    rows = _cdiv(_cdiv(m, splits), _TF32_STEP) * _TF32_STEP
    return _cdiv(m, rows), rows


@functools.cache
def _tf32_lib() -> ctypes.CDLL:
    lib = cuda_build.load(TF32_SOURCE)
    lib.tk8s_conv1x1_tf32_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _L, _P]
    lib.tk8s_conv1x1_tf32_bwd.restype = _I
    lib.tk8s_conv1x1_tf32_error_string.argtypes = [_I]
    lib.tk8s_conv1x1_tf32_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.tk8s_conv1x1_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _L, _P]
    lib.tk8s_conv1x1_bwd.restype = _I
    lib.tk8s_conv1x1_error_string.argtypes = [_I]
    lib.tk8s_conv1x1_error_string.restype = ctypes.c_char_p
    return lib


def backward(x2, dy2, w2, dx2, dw) -> None:
    """dX (M, C) into `dx2` and dW (N, C) f32 into `dw`, from X (M, C),
    dY (M, N) and W (N, C), all dense and in one compute dtype, on the
    instance `instance` names."""
    m, c = x2.shape
    n = dy2.shape[1]
    route = instance(x2.dtype, c, n)
    tf32 = route.startswith("tf32")
    lib = _tf32_lib() if tf32 else _lib()
    splits, rows = (tf32_split if tf32 else split)(m, c, n)
    partial = (torch.empty((splits, n, c), dtype=torch.float32, device=x2.device)
               if splits > 1 else None)
    launch, codes, error_string = (
        (lib.tk8s_conv1x1_tf32_bwd, TF32_DTYPES, lib.tk8s_conv1x1_tf32_error_string) if tf32
        else (lib.tk8s_conv1x1_bwd, DTYPES, lib.tk8s_conv1x1_error_string))
    code = launch(
        codes[x2.dtype], x2.data_ptr(), dy2.data_ptr(), w2.data_ptr(), dx2.data_ptr(),
        dw.data_ptr(), None if partial is None else partial.data_ptr(),
        m, c, n, splits, rows, torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            f"K4 {route} launch failed at (M, C, N) = {(m, c, n)}: "
            f"{error_string(code).decode()} ({code})"
        )
