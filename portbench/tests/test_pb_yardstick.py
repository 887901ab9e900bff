"""The yardstick's arithmetic against counts made by hand at small shapes:
model FLOPs, the kernels' rooflines, the idle share, the window's tail."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import frozen, readers, training
from portbench.families import lm, resnet
from portbench.trace import CardStretch, Trace
from portbench.window import Window


def test_lm_model_flops_by_hand():
    config = {"n_layer": 1, "n_embd": 4, "vocab_size": 10, "n_head": 2}
    traffic = {"batch": 2, "seq": 3}
    # per token: qkv 4x12, proj 4x4, up 4x16, down 16x4, head 4x10 multiply-adds
    dense = 2 * (48 + 16 + 64 + 64 + 40) * 2 * 3
    # 6 (query, key) pairs a sequence; two products of 4 multiply-adds a pair
    attention = 2 * 2 * 4 * 6 * 2
    assert lm.model_flops_per_step(config, traffic) == 3 * (dense + attention)


def test_resnet50_model_flops_match_its_published_count():
    config = {"stages": [3, 4, 6, 3], "num_filters": 64, "expansion": 4, "num_classes": 1000}
    forward = resnet.model_flops_per_step(config, {"batch": 1, "image_size": 224}) / 3
    # ResNet-50 at 224x224: 4.09 G multiply-adds forward
    assert forward / 2 == pytest.approx(4.09e9, rel=0.01)


def test_resnet_flops_of_one_block_by_hand():
    config = {"stages": [1], "num_filters": 2, "expansion": 4, "num_classes": 3}
    # 8x8 image: stem 7x7/2 -> 4x4, pool -> 2x2; block 2->2 (1x1), 2->2 (3x3), 2->8 (1x1),
    # shortcut 2->8 (1x1), all at 2x2; classifier 8x3
    stem = 2 * 3 * 2 * 49 * 16
    block = 2 * 4 * (2 * 2 + 2 * 2 * 9 + 2 * 8 + 2 * 8)
    assert resnet.model_flops_per_step(config, {"batch": 1, "image_size": 8}) == \
        3 * (stem + block + 2 * 8 * 3)


def test_k4_calls_are_the_33_stride_one_1x1_convolutions_and_their_bound():
    config = {"stages": [3, 4, 6, 3], "num_filters": 64, "expansion": 4, "num_classes": 1000}
    calls = resnet.kernel_calls(config, {"batch": 256, "image_size": 224, "fused_1x1_bwd": True})
    assert len(calls["k4"]) == 33
    # the bound PERF.md's kernel table gives the step's 33 calls: 3.6630 ms
    assert sum(frozen.bound_s(*c) for c in calls["k4"]) * 1e3 == pytest.approx(3.6630, abs=1e-4)
    assert resnet.kernel_calls(config, {"batch": 256, "image_size": 224,
                                        "fused_1x1_bwd": False}) == {"k4": []}


def test_cost_formulas_by_hand():
    # K2 forward at b=1, h=1, s=2, d=4, causal, bf16: q, k, v, O of 8 values, lse of 2
    assert frozen.k2_forward_cost(1, 1, 2, 4, True, 2) == (4 * 8 * 2 + 2 * 4, 4 * 4 * 3)
    assert frozen.k2_backward_cost(1, 1, 2, 4, False, 2) == (8 * 8 * 2 + 2 * 4, 8 * 4 * 4)
    # K4 on X (2, 3), dY (2, 5), W (5, 3)
    assert frozen.k4_backward_cost(2, 3, 5, 2) == (2 * (6 + 10 + 15) + 2 * 6 + 4 * 15, 120)
    assert frozen.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert frozen.bound_s(0, 989e12 * 2) == pytest.approx(2.0)


def _event(name, start, end, device=False, parent=None, kernel_us=(), annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    event = types.SimpleNamespace(
        name=name, device_type=kind, cpu_parent=parent, cpu_children=[],
        is_user_annotation=annotation,
        kernels=[types.SimpleNamespace(duration=us) for us in kernel_us],
        time_range=types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))
    if parent is not None:
        parent.cpu_children.append(event)
    return event


def _trace():
    step = _event("aten::linear", 0, 50)
    mm = _event("aten::addmm", 5, 45, parent=step, kernel_us=(30.0,))
    k2 = _event("GeneratedBackwardFor_tk8s_flash_attn_fwd_default", 50, 60)
    _event("tk8s::flash_attn_fwd", 51, 59, parent=k2, kernel_us=(10.0,))
    # an annotation's own entry is its device span (here 25 us, gaps included)
    opt = _event("Optimizer.step#SGD.step", 70, 95, kernel_us=(25.0,), annotation=True)
    add = _event("aten::_foreach_add_", 71, 80, parent=opt, kernel_us=(4.0, 6.0))
    # the profiler files kernels that ran while a launch waited under this event
    _event("Command Buffer Full", 72, 79, parent=add, kernel_us=(30.0,))
    kernels = [_event("gemm", 10, 40, device=True), _event("attn_fwd", 60, 70, device=True),
               _event("add", 90, 100, device=True)]
    host = [step, *step.cpu_children, k2, *k2.cpu_children, opt, add, *add.cpu_children]
    return Trace(steps=2, window_s=100e-6, busy_s=50e-6, host=host,
                 device=kernels, start_us=0.0, end_us=100.0)


def test_an_op_is_counted_once_through_nested_matches_and_by_its_port_name():
    trace = _trace()
    assert trace.op_seconds(readers.is_product) == (pytest.approx(30e-6), 1)
    assert trace.op_seconds(readers.is_port_kernel) == (pytest.approx(10e-6), 1)
    assert trace.op_seconds(readers.is_optimizer) == (pytest.approx(10e-6), 1)


def test_idle_share_and_gaps_by_hand():
    trace = _trace()
    # 250 us busy in a card-only stretch of 400 us: both of the one stretch
    run = types.SimpleNamespace(trace=trace, window=Window(steps=10, seconds=1.0, step_ms=[]),
                                card=CardStretch(steps=10, busy_s=250e-6, window_s=400e-6))
    assert readers.idle_percent(run) == pytest.approx(37.5)
    run.card = None
    assert readers.idle_percent(run) is None
    gaps = trace.idle_gaps()
    # kernels at 10-40, 60-70 and 90-100 of a 0-100 window
    assert [(name, round(s * 1e6)) for name, s in gaps] == [
        ("tk8s::flash_attn_fwd", 20), ("aten::_foreach_add_", 20), ("aten::addmm", 10)]
    out = trace.breakdown(top=2)
    assert out["device_ops"] == [["gemm", pytest.approx(30e-6)], ["attn_fwd", pytest.approx(10e-6)]]


def test_roofline_share_is_the_bound_over_the_device_time_of_the_calls():
    family = types.SimpleNamespace(kernel_calls=lambda c, t: {"k2": [(3.35e12 * 5e-6, 0)]})
    run = types.SimpleNamespace(family=family, config={}, traffic={}, trace=types.SimpleNamespace(
        steps=2, op_seconds=lambda match: (20e-6, 2)))
    assert readers.roofline_percent(run, "k2", ("tk8s::flash_attn_fwd",)) == pytest.approx(50.0)
    off_path = types.SimpleNamespace(steps=2, op_seconds=lambda match: (0.0, 0))
    run.trace = off_path
    assert readers.roofline_percent(run, "k2", ("tk8s::flash_attn_fwd",)) is None


def test_the_tail_leaves_a_tenth_of_the_steps_above_it():
    window = Window(steps=100, seconds=1.0, step_ms=[float(i) for i in range(100, 0, -1)])
    assert window.percentile_ms(0.9) == 90.0
    assert sum(t > window.percentile_ms(0.9) for t in window.step_ms) == 10


def test_the_comparison_by_hand():
    """Worst leaf gaps, and the median leaf's parameter difference, over the
    larger of the leaf's and the median leaf's reference norm; a leaf whose
    reference gradient stays under a thousandth of the median's is left out
    of the change."""
    names = ["w1", "w2", "w3", "w4"]
    ref = training.Readings(names, [1.0, 1.0], [1.0, 2.0, 4.0, 8.0], [1.0, 2.0, 4.0, 8.0],
                            [[1.0, 2.0, 4.0, 1e-6]], {n: torch.zeros(2) for n in names})
    moved = {"w1": [0.0, 0.4], "w2": [0.1, 0.0], "w3": [0.0, -0.4], "w4": [100.0, 0.0]}
    side = training.Readings(names, [1.0, 1.1], [1.0, 2.3, 4.0, 8.0], [1.2, 2.1, 4.0, 100.0],
                             params={n: torch.tensor(v) for n, v in moved.items()})
    numbers = training.compare(side, ref)
    assert numbers["loss_gap"] == (pytest.approx(0.1), "step 2")
    # first gradients: median 3, so w2's gap is 0.3 / 3
    assert numbers["grad_gap"] == (pytest.approx(0.1), "w2")
    # changes of w1-w3 (w4 moves by round-off): median 2; gaps 0.1, 0.05, 0
    assert numbers["change_gap"] == (pytest.approx(0.1), "w1")
    # differences of the parameters over the same scales 2, 2, 4: 0.2, 0.05, 0.1
    assert numbers["change_diff_median"] == (pytest.approx(0.1), "w3")
