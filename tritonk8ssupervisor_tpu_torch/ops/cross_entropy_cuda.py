"""K1's launcher: the ctypes binding of `csrc/cross_entropy.cu`.

The kernel source says what it replaces and how it is built; this module
chooses each launch's regime from the shape and turns tensors into the
kernel's arguments (data pointers, the batch and class counts, g's
stride, PyTorch's current stream as its raw handle):

- `elems_per_load`: 16 bytes a load (8 bf16 or f16, 4 f32) when every
  row of the logits (and of the gradient) starts on a 16-byte boundary,
  else one element;
- `loads_per_lane`: the forward takes one warp a row when the row fits
  16 loads a lane (C * elem <= 8 KB with 16-byte loads), with the loads a
  lane rounded up to a power of two; else 0, one CTA a row;
- `chunk_shift`: the backward covers a row in chunks of
  2**chunk_shift loads, the row's loads rounded up to a power of two and
  at most 1024 (one CTA of 256 threads, 4 loads each), 1024 >> shift
  rows a CTA.

The caller (`ops/cross_entropy.py`) has checked devices, dtypes, shapes
and contiguity and allocated the outputs; a launch that the runtime
refuses raises here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

SOURCE = "cross_entropy.cu"
# the logits' dtypes the kernels are instantiated for -> their code in the
# C interface
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
LABEL_DTYPES = (torch.int32, torch.int64)
LOAD_BYTES = 16
WARP = 32
MAX_LOADS_PER_LANE = 16  # the kernel's kMaxPerLane
BWD_ITEMS_LOG2 = 10  # loads a backward CTA covers: 256 threads x 4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.tk8s_cross_entropy_fwd.argtypes = [_I, _P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _P]
    lib.tk8s_cross_entropy_fwd.restype = _I
    lib.tk8s_cross_entropy_bwd.argtypes = [_I, _P, _P, _I, _P, _P, _L, _P, _L, _I, _I, _I, _P]
    lib.tk8s_cross_entropy_bwd.restype = _I
    lib.tk8s_cross_entropy_error_string.argtypes = [_I]
    lib.tk8s_cross_entropy_error_string.restype = ctypes.c_char_p
    return lib


def elems_per_load(classes: int, elem_size: int, *pointers: int) -> int:
    """16 // elem_size when rows of `classes` elements that start at each
    of `pointers` all start on 16-byte boundaries, else 1."""
    vec = LOAD_BYTES // elem_size
    if classes % vec or any(p % LOAD_BYTES for p in pointers):
        return 1
    return vec


def loads_per_lane(classes: int, vec: int) -> int:
    """The narrow forward's loads a lane (1, 2, 4, 8 or 16) for rows of
    `classes` elements read `vec` at a time; 0 when the row does not fit
    16 loads a lane (the wide forward, one CTA a row)."""
    loads = -(-classes // vec)
    per_lane = -(-loads // WARP)
    if per_lane > MAX_LOADS_PER_LANE:
        return 0
    return 1 << (per_lane - 1).bit_length()


def chunk_shift(classes: int, vec: int) -> int:
    """log2 of the backward's loads a chunk of a row."""
    loads = -(-classes // vec)
    return min((loads - 1).bit_length(), BWD_ITEMS_LOG2)


def _stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, as the raw handle: without
    building a `torch.cuda.Stream` object a call, as `torch.cuda.current_stream`
    does."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _raise(lib, code: int, what: str, logits: torch.Tensor) -> None:
    if code != 0:
        raise RuntimeError(
            f"K1 {what} launch failed at (B, C) = {tuple(logits.shape)} {logits.dtype}: "
            f"{lib.tk8s_cross_entropy_error_string(code).decode()} ({code})")


def forward(logits, labels, loss, correct, lse) -> None:
    """loss, correct and lse (B,) from the (B, C) logits and (B,) labels,
    all contiguous on one device, B > 0."""
    lib = _lib()
    batch, classes = logits.shape
    vec = elems_per_load(classes, logits.element_size(), logits.data_ptr())
    code = lib.tk8s_cross_entropy_fwd(
        DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
        int(labels.dtype == torch.int64), loss.data_ptr(), correct.data_ptr(), lse.data_ptr(),
        batch, classes, vec, loads_per_lane(classes, vec), _stream(logits))
    _raise(lib, code, "forward", logits)


def backward(logits, labels, lse, g, dlogits) -> None:
    """dlogits (B, C) from the logits, labels, the forward's lse and the
    losses' cotangent g (B,) f32 at any stride; B > 0."""
    lib = _lib()
    batch, classes = logits.shape
    vec = elems_per_load(classes, logits.element_size(), logits.data_ptr(),
                         dlogits.data_ptr())
    code = lib.tk8s_cross_entropy_bwd(
        DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
        int(labels.dtype == torch.int64), lse.data_ptr(), g.data_ptr(), g.stride(0),
        dlogits.data_ptr(), batch, classes, vec, chunk_shift(classes, vec), _stream(logits))
    _raise(lib, code, "backward", logits)
