"""The yardstick's frozen arithmetic: copies of the port's peak table, K2's
and K4's cost formulas and the card-work filter, taken from commit
fed0c00650610e55bfa80359e5b5dec8d22a915a. Later changes to the port do
not move them; a change to this file is a change to the benchmark.
"""

from __future__ import annotations

import torch

# tritonk8ssupervisor_tpu_torch/utils/perf.py PEAK_BF16_FLOPS and
# utils/roofline.py PEAK_HBM_BYTES, H100 SXM data sheet: dense bf16
# tensor-core rate (2 FLOPs a multiply-add, no sparsity) and HBM3 rate.
H100_NAME = "NVIDIA H100 80GB HBM3"
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _pairs(seq: int, causal: bool) -> int:
    """(query, key) pairs a mask keeps: S(S+1)/2 causal, S^2 full."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def k2_forward_cost(b: int, h: int, s: int, d: int, causal: bool, elem: int) -> tuple[int, int]:
    """(bytes, operations) of K2's forward, from
    tritonk8ssupervisor_tpu_torch/ops/flash_attention.py::forward_cost:
    q, k, v read and O written once, the f32 logsumexp written; two
    products (4 D a pair) over the pairs the mask keeps."""
    n = b * s * h * d
    return 4 * n * elem + b * h * s * 4, 4 * b * h * d * _pairs(s, causal)


def k2_backward_cost(b: int, h: int, s: int, d: int, causal: bool, elem: int) -> tuple[int, int]:
    """(bytes, operations) of K2's backward. Bytes from
    ops/flash_attention.py::backward_cost (q, k, v, O, dO and the
    logsumexp read, dq, dk, dv written once). Operations are the model
    work of ops/flash_attention.py::_bwd_flops, four products a pair (dV,
    dP, dQ, dK): the kernel's recompute of P is its own choice, not work
    the chip has to do."""
    n = b * s * h * d
    return 8 * n * elem + b * h * s * 4, 8 * b * h * d * _pairs(s, causal)


def k4_backward_cost(m: int, c: int, n: int, elem: int) -> tuple[int, int]:
    """(bytes, operations) of one K4 call on X (M, C), dY (M, N), W (N, C),
    from ops/conv_backward.py::backward_cost: the three read once, dX
    written once in their dtype and dW once in f32; two products of
    2 M C N."""
    n_bytes = elem * (m * c + m * n + n * c) + elem * m * c + 4 * n * c
    return n_bytes, 4 * m * c * n


def bound_s(n_bytes: float, operations: float) -> float:
    """The least time the work can take on one H100 SXM at bf16: the
    larger of bytes over the HBM rate and operations over the bf16 rate."""
    return max(n_bytes / PEAK_HBM_BYTES, operations / PEAK_BF16_FLOPS)


def is_card_work(event) -> bool:
    """From utils/perf.py::card_work: an event is work on the card
    (kernel, copy, fill) when it is a CUDA-side row and not the device
    span of a user annotation (a `record_function` range such as
    `Optimizer.step#SGD.step` also shows on the card's timeline, over
    kernels that are rows of their own)."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))
