"""Roofline attribution of a torch.profiler trace: where the step time goes
and how close each kernel runs to the card's memory and tensor-core
ceilings. The port of `tritonk8ssupervisor_tpu/utils/roofline.py`, with its
public names, flags and `--json` keys.

The reference reads jax.profiler's "XLA Ops" track, on which XLA states
each op's `bytes_accessed` and `model_flops`. A torch.profiler trace has
no such field. It has, for each CPU operator, the dims and dtypes of its
inputs (`utils/perf.maybe_trace` records them: `record_shapes=True`), and
for each device event the External id of the operator that launched it.
So this module:

- takes every event whose `cat` is `kernel`, `gpu_memcpy` or `gpu_memset`
  as one device op occurrence, its `dur` in µs;
- names it by the kernel and files it under the operator whose External
  id it carries (through its runtime call's when the event has none of its
  own); a device event that matches no operator goes under "no operator".
  A `torch.library.custom_op` with an autograd formula (K2's forward)
  is recorded under its generated autograd Function's name,
  `GeneratedBackwardFor_tk8s_<op>_default`, which reads as `tk8s::<op>`;
- gives each operator its bytes: its tensor inputs as recorded (a
  stride-0 dimension read once) plus its outputs by rule. The
  matrix-product family writes M x N; elementwise and copy ops write the
  broadcast shape (an in-place op its first input, which a copy or a fill
  does not read); the port's own kernels (`tk8s::*`) move what their
  modules' cost functions say, the ones `chip_smoke.py`'s bounds use. An
  operator with no rule gets 0 bytes, as the reference gives an XLA op
  without `bytes_accessed`;
- gives it FLOPs: its `flops` arg where `with_flops` recorded one, else
  2·M·N·K for the matrix family, else the `tk8s::*` cost functions, else
  0. K3's (`tk8s::decode_attn_int8`) depend on the positions its call
  attends, which the trace does not record, so it has no rule. K2's
  depend on which of its dims is the sequence: the layout is read from
  the op's recorded arguments where torch records strings, else from the
  (B, H, S) logsumexp that a backward op on the same q dims takes; left
  unknown, the forward keeps its bytes and counts 0 FLOPs. An f32 call of
  K2 or K4 takes f32-accurate products (K2's and K4's 3xTF32
  instances): its FLOPs count against the card's rate for those
  (`PEAK_F32_PRODUCT_FLOPS`, a third of dense TF32) in the compute bound
  and the claw-back, the rest against the tensor cores' bf16 rate;
- shares an operator's bytes and FLOPs among its device events in
  proportion to their device time, so the totals stay exact (K2's
  backward launches three kernels, cuBLAS's split-K two).

Input: the profile directory written by `--profile DIR`
(benchmarks/resnet50.py, benchmarks/lm.py), which holds `trace.json`;
also `*.trace.json[.gz]`, or the path of a trace file.

CLI: python -m tritonk8ssupervisor_tpu_torch.utils.roofline DIR
[--dispatches N] (divides by the number of step dispatches when the
capture wrapped more than one).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import math
import os
from dataclasses import dataclass

import torch

from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb
from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops.flash_attention_cuda import dims as attention_dims
from tritonk8ssupervisor_tpu_torch.utils import perf

# Data-sheet device-memory rate per card (bytes/s), keyed like
# perf.PEAK_BF16_FLOPS by torch.cuda.get_device_name() prefix.
PEAK_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 2.0e12,  # H100 PCIe, HBM2e
    "NVIDIA H200": 4.8e12,  # H200 SXM
}
# Data-sheet f32 rate outside the tensor cores (FLOP/s): the ceiling of
# K1's and K3's f32 arithmetic (elementwise work and reductions) in
# chip_smoke.py's bounds.
PEAK_F32_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
    "NVIDIA H100 PCIe": 51e12,
    "NVIDIA H200": 67e12,
}
# Data-sheet rate of f32-accurate products on the tensor cores (FLOP/s):
# the dense TF32 rate (H100 SXM and H200 495, H100 PCIe 378) over 3, since
# a 3xTF32 product (csrc/flash_attention_tf32.cu, csrc/conv_backward_tf32.cu)
# takes three TF32 ones. The ceiling of K2's and K4's f32 calls in
# chip_smoke.py's bounds: no f32-accurate product can go faster.
PEAK_F32_PRODUCT_FLOPS = {
    "NVIDIA H100 80GB HBM3": 495e12 / 3,
    "NVIDIA H100 PCIe": 378e12 / 3,
    "NVIDIA H200": 495e12 / 3,
}

# the port's kernels whose float32 calls take f32-accurate products
# (csrc/flash_attention_tf32.cu, csrc/conv_backward_tf32.cu)
F32_PRODUCT_KERNELS = ("tk8s::flash_attn_fwd", "tk8s::flash_attn_bwd", "tk8s::conv1x1_bwd")

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NO_OPERATOR = "no operator"
# `torch.library.custom_op`'s autograd records an op's forward under the
# name of the autograd Function it generates for it
GENERATED_AUTOGRAD = "GeneratedBackwardFor_tk8s_"

# bytes an element of each dtype name torch.profiler records
ELEMENT_BYTES = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    "signed char": 1, "unsigned char": 1, "short int": 2, "int": 4,
    "long int": 8, "bool": 1, "c10::complex<float>": 8,
    "c10::complex<double>": 16,
}
# ScalarType codes, as `aten::to`/`aten::_to_copy` record their dtype
# argument -> bytes an element
SCALAR_TYPE_BYTES = {0: 1, 1: 1, 2: 2, 3: 4, 4: 8, 5: 2, 6: 4, 7: 8, 9: 8,
                     10: 16, 11: 1, 15: 2}
# the matrix-product family: out = (batch...) M x N, FLOPs 2 M N K
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
              "aten::matmul", "aten::linear", "aten::_addmm_activation")
# elementwise and copy ops: out = the broadcast shape of the inputs
ELEMENTWISE_OPS = frozenset(
    f"aten::{name}" for name in (
        "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
        "neg", "neg_", "abs", "exp", "exp_", "log", "sqrt", "rsqrt", "rsqrt_",
        "reciprocal", "square", "pow", "erf", "tanh", "tanh_", "tanh_backward",
        "sigmoid", "sigmoid_backward", "relu", "relu_", "threshold_backward",
        "gelu", "gelu_backward", "silu", "silu_", "silu_backward", "clamp",
        "clamp_", "clamp_min", "clamp_min_", "maximum", "minimum", "where",
        "masked_fill", "masked_fill_", "addcmul", "addcmul_", "addcdiv",
        "addcdiv_", "lerp", "lerp_", "clone", "copy_", "fill_", "zero_", "to",
        "_to_copy",
    ))
# in-place ops that write their first input without reading it
WRITE_ONLY_OPS = frozenset(f"aten::{name}" for name in ("copy_", "fill_", "zero_"))


def operator_name(event: dict) -> str:
    """The operator an event names: `tk8s::flash_attn_fwd` for the
    autograd Function `GeneratedBackwardFor_tk8s_flash_attn_fwd_default`
    that records it, else the event's own name."""
    name = event.get("name", "?")
    if name.startswith(GENERATED_AUTOGRAD):
        return "tk8s::" + name[len(GENERATED_AUTOGRAD):].rsplit("_", 1)[0]
    return name


def _device_name(device_name: str | None) -> str | None:
    if device_name is not None:
        return device_name
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def peak_hbm_bytes_per_sec(device_name: str | None = None) -> float | None:
    """Device-memory peak of this card (or the one named), or None when
    unknown or when there is no card (host-only analysis)."""
    name = _device_name(device_name)
    return None if name is None else perf.peak_for_device(PEAK_HBM_BYTES, name)


def peak_tensor_flops_per_sec(device_name: str | None = None) -> float | None:
    """Dense bf16 tensor-core peak of this card (or the one named), or
    None when unknown or when there is no card."""
    name = _device_name(device_name)
    return None if name is None else perf.peak_flops_per_chip(name)


def kernel_peak_flops(elem: int, device_name: str | None = None) -> float | None:
    """The compute ceiling of K2's and K4's products on `elem`-byte
    operands: the rate of f32-accurate products (3xTF32, a third of dense
    TF32) for 4, the dense bf16/fp16 tensor-core rate for 2. None when the
    card is unknown or there is none."""
    name = _device_name(device_name)
    if name is None:
        return None
    return perf.peak_for_device(PEAK_F32_PRODUCT_FLOPS if elem == 4 else perf.PEAK_BF16_FLOPS,
                                name)


def bound_ms(n_bytes: float, flops: float, peak_bytes_per_sec: float,
             peak_flops_per_sec: float) -> tuple[float, str]:
    """The least time the work can take on the card, in ms, and what sets
    it ("bytes" or "operations"): the larger of the bytes over the memory
    rate and the operations over the compute rate."""
    bytes_ms = n_bytes / peak_bytes_per_sec * 1e3
    ops_ms = flops / peak_flops_per_sec * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


@dataclass
class OpStat:
    """One device op (a kernel under one operator) aggregated across the
    capture."""

    name: str
    category: str
    duration_ms: float
    bytes_accessed: float
    flops: float
    occurrences: int = 1
    f32_products: bool = False  # an f32 call of K2 or K4 (F32_PRODUCT_KERNELS)

    @property
    def gbytes_per_sec(self) -> float:
        if self.duration_ms <= 0:
            return 0.0
        return self.bytes_accessed / (self.duration_ms / 1e3) / 1e9

    @property
    def tflops_per_sec(self) -> float:
        if self.duration_ms <= 0:
            return 0.0
        return self.flops / (self.duration_ms / 1e3) / 1e12


@dataclass
class RooflineReport:
    """Whole-capture summary + per-op stats, peaks attached when known."""

    total_ms: float
    total_bytes: float
    total_flops: float
    ops: list[OpStat]
    by_category_ms: dict[str, float]
    peak_bytes_per_sec: float | None = None
    peak_flops_per_sec: float | None = None
    dispatches: int = 1
    f32_flops: float = 0.0  # of total_flops, the f32-accurate products
    peak_f32_flops_per_sec: float | None = None

    @property
    def achieved_bytes_per_sec(self) -> float:
        if self.total_ms <= 0:
            return 0.0
        return self.total_bytes / (self.total_ms / 1e3)

    @property
    def hbm_bound_ms(self) -> float | None:
        """Lower bound on device time if every byte moved at the memory
        peak — the program's bandwidth roofline at its CURRENT kernel
        boundaries. Time below this requires moving fewer bytes."""
        if not self.peak_bytes_per_sec:
            return None
        return self.total_bytes / self.peak_bytes_per_sec * 1e3

    @property
    def mxu_bound_ms(self) -> float | None:
        """Lower bound on device time if every FLOP ran at its unit's
        peak: the tensor cores' bf16 rate, and the f32-product rate for
        `f32_flops` where that rate is known (the reference's name, kept for `--json`)."""
        if not self.peak_flops_per_sec:
            return None
        if not (self.f32_flops and self.peak_f32_flops_per_sec):
            return self.total_flops / self.peak_flops_per_sec * 1e3
        return ((self.total_flops - self.f32_flops) / self.peak_flops_per_sec
                + self.f32_flops / self.peak_f32_flops_per_sec) * 1e3

    @property
    def hbm_efficiency(self) -> float | None:
        """achieved/peak average bandwidth — ~1.0 means the schedule is
        saturated and only byte reduction can speed the program up."""
        if not self.peak_bytes_per_sec:
            return None
        return self.achieved_bytes_per_sec / self.peak_bytes_per_sec

    def clawback(
        self,
        min_ms: float = 0.08,
        bw_fraction: float = 0.8,
        mxu_fraction: float = 0.3,
    ) -> list[OpStat]:
        """Ops meaningfully below BOTH ceilings: the (bounded) pool of
        time recoverable by better scheduling/kernels alone."""
        if not (self.peak_bytes_per_sec and self.peak_flops_per_sec):
            return []
        bw_cut = self.peak_bytes_per_sec * bw_fraction / 1e9
        mxu_cut = self.peak_flops_per_sec * mxu_fraction / 1e12
        f32_cut = (self.peak_f32_flops_per_sec or self.peak_flops_per_sec) * mxu_fraction / 1e12
        return [
            op
            for op in self.ops
            if op.duration_ms >= min_ms
            and op.gbytes_per_sec < bw_cut
            and op.tflops_per_sec < (f32_cut if op.f32_products else mxu_cut)
        ]


def find_trace_file(profile_dir: str) -> str:
    """Locate the trace under a --profile directory (`trace.json[.gz]`,
    else the latest `*.trace.json[.gz]`), or accept a direct path to one."""
    if os.path.isfile(profile_dir):
        return profile_dir
    for name in ("trace.json", "trace.json.gz"):
        if os.path.isfile(os.path.join(profile_dir, name)):
            return os.path.join(profile_dir, name)
    matches = sorted(
        glob.glob(os.path.join(profile_dir, "*.trace.json"))
        + glob.glob(os.path.join(profile_dir, "*.trace.json.gz"))
    )
    if not matches:
        raise FileNotFoundError(
            f"no trace.json or *.trace.json[.gz] under {profile_dir!r} — pass "
            "the directory given to --profile (or the trace file itself)"
        )
    return matches[-1]  # latest run


def _load_events(trace_path: str) -> list[dict]:
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def load_device_ops(trace_path: str) -> list[dict]:
    """The device events (one per kernel, copy or fill occurrence), each
    with `operator` set to the CPU op event that launched it, or None."""
    events = _load_events(trace_path)
    operators: dict = {}
    runtime_ids: dict = {}
    # an operator before an annotation that shares its id
    for cat in ("cpu_op", "user_annotation"):
        for e in events:
            args = e.get("args") or {}
            if e.get("ph") == "X" and e.get("cat") == cat and "External id" in args:
                operators.setdefault(args["External id"], e)
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime" and "correlation" in args:
            runtime_ids[args["correlation"]] = args.get("External id")
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        args = e.get("args") or {}
        ext = args.get("External id", runtime_ids.get(args.get("correlation")))
        device.append({**e, "operator": operators.get(ext)})
    return device


def _tensor_inputs(args: dict) -> list[tuple[list[int], int, int, str]]:
    """(dims, bytes an element, elements read, dtype name) of each
    recorded tensor input, in order; a stride-0 dimension is read once."""
    dims_list = args.get("Input Dims") or []
    types = args.get("Input type") or []
    strides_list = args.get("Input Strides") or []
    out = []
    for i, (dims, dtype) in enumerate(zip(dims_list, types)):
        if dtype not in ELEMENT_BYTES or not all(isinstance(d, int) for d in dims):
            continue
        strides = strides_list[i] if i < len(strides_list) else None
        if isinstance(strides, list) and len(strides) == len(dims):
            read = math.prod(d for d, s in zip(dims, strides) if s != 0)
        else:
            read = math.prod(dims)
        out.append((dims, ELEMENT_BYTES[dtype], read, dtype))
    return out


def _broadcast(shapes: list[list[int]]) -> list[int]:
    ndim = max((len(s) for s in shapes), default=0)
    out = [1] * ndim
    for shape in shapes:
        for i, d in enumerate(shape, start=ndim - len(shape)):
            out[i] = d if out[i] == 1 else out[i]
    return out


def _concrete(args: dict, index: int) -> str:
    values = args.get("Concrete Inputs") or []
    return values[index] if index < len(values) and isinstance(values[index], str) else ""


def _matmul_cost(name: str, tensors: list) -> tuple[float, float] | None:
    """(output bytes, FLOPs) of a matrix-product op, None when its inputs
    are not the family's."""
    if name == "aten::linear":
        if len(tensors) < 2 or len(tensors[0][0]) < 1 or len(tensors[1][0]) != 2:
            return None
        x, w = tensors[0][0], tensors[1][0]
        rows = math.prod(x[:-1])
        return rows * w[0] * tensors[0][1], 2.0 * rows * w[0] * w[1]
    operands = tensors[-2:] if name in ("aten::addmm", "aten::baddbmm",
                                        "aten::_addmm_activation") else tensors[:2]
    if len(operands) != 2 or min(len(t[0]) for t in operands) < 1:
        return None
    (a, elem, *_), (b, *_) = operands
    k = a[-1]
    a_rows = a[:-1] if len(a) > 1 else []
    b_cols = b[-1:] if len(b) > 1 else []
    batch = _broadcast([a[:-2], b[:-2]]) if min(len(a), len(b)) > 2 else (
        a[:-2] if len(a) > 2 else b[:-2])
    out = batch + a_rows[-1:] + b_cols
    return math.prod(out) * elem, 2.0 * math.prod(out) * k


def _elementwise_out(name: str, args: dict, tensors: list) -> float:
    """Output bytes of an elementwise or copy op: the broadcast shape, in
    its first input's dtype for an in-place op, else in the first
    non-bool, non-scalar input's (a cast in the dtype it names)."""
    if name.endswith("_"):
        return math.prod(tensors[0][0]) * tensors[0][1]
    shape = _broadcast([t[0] for t in tensors])
    shaped = [t for t in tensors if t[0]] or tensors
    elem = next((t[1] for t in shaped if t[3] != "bool"), shaped[0][1])
    if name in ("aten::to", "aten::_to_copy"):
        code = _concrete(args, 1)
        if code.isdigit():
            elem = SCALAR_TYPE_BYTES.get(int(code), elem)
    return math.prod(shape) * elem


def _attention_layout(args: dict, layout_index: int, q_dims: list[int],
                      layouts: dict) -> str | None:
    given = _concrete(args, layout_index)
    if given in fa.LAYOUTS:
        return given
    if len(q_dims) == 4 and q_dims[1] == q_dims[2]:
        return "bshd"  # heads == seq: either reading gives the same cost
    return layouts.get(tuple(q_dims))


def _tk8s_cost(name: str, args: dict, tensors: list, layouts: dict
               ) -> tuple[float, float] | None:
    """(bytes, FLOPs) of the port's own kernels from their modules' cost
    functions; None for an op with no rule."""
    if not tensors or len(tensors[0][0]) != (4 if "flash_attn" in name else 2):
        return None
    if name == "tk8s::cross_entropy_fwd" and len(tensors) == 2:
        (batch, classes), elem = tensors[0][0], tensors[0][1]
        return ce.forward_cost(batch, classes, elem, tensors[1][1])
    if name == "tk8s::cross_entropy_bwd" and len(tensors) == 4:
        (batch, classes), elem = tensors[0][0], tensors[0][1]
        return ce.backward_cost(batch, classes, elem, tensors[1][1])
    if name == "tk8s::conv1x1_bwd" and len(tensors) == 3 and len(tensors[1][0]) == 2:
        (m, c), n = tensors[0][0], tensors[1][0][1]
        return cb.backward_cost(m, c, n, tensors[0][1])
    attention = {"tk8s::flash_attn_fwd": (0, 3, fa.forward_cost),
                 "tk8s::flash_attn_bwd": (1, 6, fa.backward_cost)}
    if name in attention and len(tensors) >= 3 and len(tensors[attention[name][0]][0]) == 4:
        q_index, causal_index, cost = attention[name]
        q_dims, elem = tensors[q_index][0], tensors[q_index][1]
        causal = _concrete(args, causal_index)
        layout = _attention_layout(args, causal_index + 1, q_dims, layouts)
        b, one, two, d = q_dims
        n_bytes, flops = cost(b, one, two, d, causal == "True", elem)
        if layout is None or causal not in ("True", "False"):
            return n_bytes, 0.0  # the bytes do not depend on the layout
        b, h, s, d = attention_dims(q_dims, layout)
        return cost(b, h, s, d, causal == "True", elem)
    return None


def op_cost(event: dict, layouts: dict | None = None) -> tuple[float, float]:
    """(bytes, FLOPs) of one CPU operator event from its recorded inputs,
    by the rules above; (0, 0) for an operator with no rule. `layouts`
    maps K2's q dims to the layout learned from the capture's backward
    ops (`attention_layouts`)."""
    name, args = operator_name(event), event.get("args") or {}
    tensors = _tensor_inputs(args)
    recorded_flops = args.get("flops")
    if name.startswith("tk8s::"):
        cost = _tk8s_cost(name, args, tensors, layouts or {})
        if cost is None:
            return 0.0, 0.0
        return float(cost[0]), float(recorded_flops or cost[1])
    if not tensors:
        return 0.0, float(recorded_flops or 0)
    read = sum(t[1] * t[2] for t in tensors)
    if name in MATMUL_OPS:
        cost = _matmul_cost(name, tensors)
        if cost is None:
            return 0.0, float(recorded_flops or 0)
        return read + cost[0], float(recorded_flops or cost[1])
    if name in ELEMENTWISE_OPS:
        if name in WRITE_ONLY_OPS:
            read -= tensors[0][1] * tensors[0][2]
        return read + _elementwise_out(name, args, tensors), float(recorded_flops or 0)
    return 0.0, float(recorded_flops or 0)


def f32_products(event: dict) -> bool:
    """Whether a CPU operator event is an f32 call of K2 or K4, whose
    FLOPs are f32-accurate products (`PEAK_F32_PRODUCT_FLOPS`)."""
    name = operator_name(event)
    if name not in F32_PRODUCT_KERNELS:
        return False
    tensors = _tensor_inputs(event.get("args") or {})
    q = 1 if name == "tk8s::flash_attn_bwd" else 0  # the backward's first input is dO
    return len(tensors) > q and tensors[q][1] == 4


def attention_layouts(operators) -> dict:
    """q dims -> K2 layout, read off each backward op's (B, H, S)
    logsumexp input: the forward op on those q dims has the same."""
    layouts = {}
    for event in operators:
        if operator_name(event) != "tk8s::flash_attn_bwd":
            continue
        tensors = _tensor_inputs(event.get("args") or {})
        if len(tensors) < 6 or len(tensors[1][0]) != 4 or len(tensors[5][0]) != 3:
            continue
        q, lse = tensors[1][0], tensors[5][0]
        if q[1:3] == lse[1:3]:
            layouts[tuple(q)] = "bhsd"
        elif q[1:3] == lse[2:0:-1]:
            layouts[tuple(q)] = "bshd"
    return layouts


def analyze(
    profile_dir: str,
    dispatches: int = 1,
    peak_bytes_per_sec: float | None = None,
    peak_flops_per_sec: float | None = None,
    peak_f32_flops_per_sec: float | None = None,
) -> RooflineReport:
    """Aggregate the capture into a RooflineReport. `dispatches` divides
    everything when the capture wrapped more than one step dispatch, so
    the report reads per-step. The peaks default to this host's card."""
    events = load_device_ops(find_trace_file(profile_dir))
    operators = {id(e["operator"]): e["operator"] for e in events if e["operator"]}
    layouts = attention_layouts(operators.values())
    costs = {key: op_cost(op, layouts) for key, op in operators.items()}
    f32 = {key for key, op in operators.items() if f32_products(op)}
    op_device_us: dict = collections.defaultdict(float)
    for e in events:
        if e["operator"] is not None:
            op_device_us[id(e["operator"])] += float(e.get("dur", 0))
    merged: dict[tuple, OpStat] = {}
    by_cat: dict[str, float] = collections.defaultdict(float)
    total_ms = total_bytes = total_flops = f32_flops = 0.0
    for e in events:
        dur_us = float(e.get("dur", 0))
        op = e["operator"]
        if op is None:
            cat = NO_OPERATOR
            nbytes = float((e.get("args") or {}).get("bytes", 0))
            flops = 0.0
        else:
            cat = operator_name(op)
            op_bytes, op_flops = costs[id(op)]
            spent = op_device_us[id(op)]
            share = dur_us / spent if spent > 0 else 0.0
            nbytes, flops = op_bytes * share, op_flops * share
        dur_ms = dur_us / 1e3 / dispatches
        nbytes /= dispatches
        flops /= dispatches
        total_ms += dur_ms
        total_bytes += nbytes
        total_flops += flops
        by_cat[cat] += dur_ms
        cores = op is not None and id(op) in f32
        if cores:
            f32_flops += flops
        key = (e.get("name", "?"), cat)
        stat = merged.get(key)
        if stat is None:
            merged[key] = OpStat(key[0], cat, dur_ms, nbytes, flops, f32_products=cores)
        else:
            stat.duration_ms += dur_ms
            stat.bytes_accessed += nbytes
            stat.flops += flops
            stat.occurrences += 1
    if dispatches > 1:
        # everything in the report reads per dispatch, including how
        # many times each op ran
        for stat in merged.values():
            stat.occurrences = max(1, round(stat.occurrences / dispatches))
    if peak_bytes_per_sec is None:
        peak_bytes_per_sec = peak_hbm_bytes_per_sec()
    if peak_flops_per_sec is None:
        peak_flops_per_sec = peak_tensor_flops_per_sec()
    if peak_f32_flops_per_sec is None:
        peak_f32_flops_per_sec = kernel_peak_flops(4)
    ops = sorted(merged.values(), key=lambda s: -s.duration_ms)
    return RooflineReport(
        total_ms=total_ms,
        total_bytes=total_bytes,
        total_flops=total_flops,
        ops=ops,
        by_category_ms=dict(by_cat),
        peak_bytes_per_sec=peak_bytes_per_sec,
        peak_flops_per_sec=peak_flops_per_sec,
        dispatches=dispatches,
        f32_flops=f32_flops,
        peak_f32_flops_per_sec=peak_f32_flops_per_sec,
    )


def format_report(report: RooflineReport, top: int = 20) -> str:
    lines = []
    lines.append(
        f"device time {report.total_ms:.2f} ms | traffic "
        f"{report.total_bytes / 1e9:.2f} GB | compute "
        f"{report.total_flops / 1e12:.3f} TFLOP"
        + (f" | per dispatch (/{report.dispatches})" if report.dispatches > 1 else "")
    )
    if report.peak_bytes_per_sec:
        lines.append(
            f"HBM roofline  {report.hbm_bound_ms:.2f} ms at "
            f"{report.peak_bytes_per_sec / 1e9:.0f} GB/s peak | achieved "
            f"{report.achieved_bytes_per_sec / 1e9:.0f} GB/s "
            f"({report.hbm_efficiency * 100:.0f}% of peak)"
        )
    if report.peak_flops_per_sec:
        lines.append(
            f"tensor-core roofline  {report.mxu_bound_ms:.2f} ms at "
            f"{report.peak_flops_per_sec / 1e12:.0f} TFLOP/s peak"
        )
    lines.append("by category (ms):")
    for cat, ms in sorted(report.by_category_ms.items(), key=lambda kv: -kv[1]):
        if ms >= 0.01:
            lines.append(f"  {ms:8.3f}  {cat}")
    lines.append(
        f"top {top} ops:  ms        x     GB/s   TFLOP/s  category"
    )
    for op in report.ops[:top]:
        lines.append(
            f"  {op.duration_ms:8.3f} {op.occurrences:4d} "
            f"{op.gbytes_per_sec:8.0f} {op.tflops_per_sec:9.2f}  "
            f"{op.category:<20} {op.name[:48]}"
        )
    claw = report.clawback()
    if claw:
        recoverable = sum(op.duration_ms for op in claw)
        lines.append(
            f"claw-back (sub-roofline ops >=0.08 ms): {recoverable:.2f} ms "
            "recoverable by scheduling/kernels alone"
        )
        for op in claw[:10]:
            lines.append(
                f"  {op.duration_ms:8.3f}  {op.gbytes_per_sec:6.0f} GB/s "
                f"{op.tflops_per_sec:7.2f} TF/s  {op.name[:52]}"
            )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("profile_dir", help="directory given to --profile")
    parser.add_argument(
        "--dispatches",
        type=int,
        default=1,
        help="step dispatches inside the capture (divides all numbers)",
    )
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument(
        "--peak-gbs",
        type=float,
        default=None,
        help="memory peak GB/s override (default: this host's card)",
    )
    parser.add_argument(
        "--peak-tflops",
        type=float,
        default=None,
        help="bf16 tensor-core peak TFLOP/s override (default: this host's card)",
    )
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    report = analyze(
        args.profile_dir,
        dispatches=args.dispatches,
        peak_bytes_per_sec=args.peak_gbs * 1e9 if args.peak_gbs else None,
        peak_flops_per_sec=(
            args.peak_tflops * 1e12 if args.peak_tflops else None
        ),
    )
    if args.json:
        print(
            json.dumps(
                {
                    "total_ms": report.total_ms,
                    "total_gbytes": report.total_bytes / 1e9,
                    "total_tflops": report.total_flops / 1e12,
                    "achieved_gbytes_per_sec": report.achieved_bytes_per_sec / 1e9,
                    "hbm_bound_ms": report.hbm_bound_ms,
                    "mxu_bound_ms": report.mxu_bound_ms,
                    "hbm_efficiency": report.hbm_efficiency,
                    "by_category_ms": report.by_category_ms,
                    "clawback_ms": sum(
                        op.duration_ms for op in report.clawback()
                    ),
                },
                sort_keys=True,
            )
        )
    else:
        print(format_report(report, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
