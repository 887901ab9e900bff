"""K4's launcher: the ctypes binding of `csrc/conv_backward.cu`.

The kernel source says what it replaces and how it is built; this module
turns tensors into its arguments (data pointers, the row count, the split
of M for dW, PyTorch's current stream) and allocates dW's f32 workspace.
The caller (`ops/conv_backward.py`) has checked device, dtype, widths and
layout and allocated the outputs; a launch that the runtime refuses
raises here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

SOURCE = "conv_backward.cu"
# the compute dtypes the kernel is instantiated for -> their code in the C
# interface
DTYPES = {torch.bfloat16: 0, torch.float16: 1}
# widths are whole 16-byte rows of 2-byte elements
WIDTH_MULTIPLE = 8
# the dgrad grid's row axis (128 rows a CTA) is at most 65535 CTAs
MAX_ROWS = 65535 * 128

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
    dY (M, N) and W (N, C), all dense and in one compute dtype."""
    lib = _lib()
    m, c = x2.shape
    n = dy2.shape[1]
    splits, rows = split(m, c, n)
    partial = (torch.empty((splits, n, c), dtype=torch.float32, device=x2.device)
               if splits > 1 else None)
    code = lib.tk8s_conv1x1_bwd(
        DTYPES[x2.dtype], x2.data_ptr(), dy2.data_ptr(), w2.data_ptr(), dx2.data_ptr(),
        dw.data_ptr(), None if partial is None else partial.data_ptr(),
        m, c, n, splits, rows, torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            f"K4 launch failed at (M, C, N) = {(m, c, n)}: "
            f"{lib.tk8s_conv1x1_error_string(code).decode()} ({code})"
        )
