"""The span readers (`portbench/spans.py`) on hand-made profiler events and on
a real CPU trace of a tiny LM step, and the readers that were there before
the spans, which must read the same with spans in the trace."""

from __future__ import annotations

import time
import types

import pytest
import torch

from portbench import manifest, run, spans
from portbench.tests.conftest import ROOT
from portbench.trace import Trace

NEW = ("forward_ms.lm", "backward_ms.lm", "norm_ms.lm", "attention_ms.lm", "mlp_ms.lm")
OLD = ("elementwise_ms.lm", "optimizer_ms.lm", "batchnorm_ms.resnet")


def _event(name, start, end, parent=None, kernel_us=(), annotation=False, thread=1,
           fwd_thread=0, seq=-1):
    event = types.SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CPU, cpu_parent=parent,
        cpu_children=[], is_user_annotation=annotation, thread=thread, fwd_thread=fwd_thread,
        sequence_nr=seq, kernels=[types.SimpleNamespace(duration=us) for us in kernel_us],
        time_range=types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))
    if parent is not None:
        parent.cpu_children.append(event)
    return event


def _span(name, start, end, parent=None):
    return _event(name, start, end, parent, annotation=True)


def _trace(events, steps=1, busy_us=0.0, device=()):
    ends = [e.time_range.end for e in events] or [0.0]
    return Trace(steps=steps, window_s=max(ends) * 1e-6, busy_s=busy_us * 1e-6, host=events,
                 device=list(device), start_us=0.0, end_us=max(ends))


def _reader(name):
    return manifest.load_module(manifest.reader_path(ROOT, name), f"portbench.metrics.{name}").read


def test_backward_kernels_count_by_their_launch_time_on_any_thread():
    step = _span("train.step", 0, 250)
    forward = _span("train.forward", 0, 100, step)
    _event("aten::addmm", 10, 20, _event("aten::linear", 5, 30, forward), kernel_us=(40,))
    backward = _span("train.backward", 100, 250, step)
    seed = _event("aten::ones_like", 101, 102, backward, kernel_us=(1,))
    # autograd's device thread: one node inside the span, one after it
    inside = _event("autograd::engine::evaluate_function: MmBackward0", 110, 200, thread=2,
                    fwd_thread=1, seq=7)
    _event("aten::mm", 120, 130, inside, kernel_us=(30, 8), thread=2)
    late = _event("aten::mul", 260, 270, kernel_us=(5,), thread=2)
    events = [step, forward, *forward.cpu_children, *forward.cpu_children[0].cpu_children,
              backward, seed, inside, *inside.cpu_children, late]
    trace = _trace(events, steps=2)
    assert spans.launched_ms(trace, "train.forward") == pytest.approx(40e-3 / 2)
    assert spans.launched_ms(trace, "train.backward") == pytest.approx(39e-3 / 2)
    assert spans.launched_ms(trace, "train.step") == pytest.approx(79e-3 / 2)
    assert spans.launched_ms(trace, "train.optimizer") is None


def _sublayer_trace():
    """A forward of two sublayers and its backward on a second thread. The
    embedding's last op records sequence number 5 without making a node (it
    reads the number the next node will take); the norm's `mul` makes
    node 5, the MLP's `addmm` node 6."""
    forward = _span("train.forward", 0, 100)
    embed = _span("model.embed", 0, 20, forward)
    _event("aten::embedding", 1, 10, embed, kernel_us=(3,), seq=4)
    _event("aten::arange", 11, 19, embed, kernel_us=(1,), seq=5)
    norm = _span("model.norm", 20, 50, forward)
    _event("aten::mul", 21, 40, norm, kernel_us=(4,), seq=5)
    mlp = _span("model.mlp", 50, 100, forward)
    _event("aten::addmm", 51, 90, mlp, kernel_us=(10,), seq=6)
    nodes = []
    for seq, kernel_us, start in ((6, (12,), 110), (5, (7,), 140), (4, (2,), 170)):
        node = _event("autograd::engine::evaluate_function: Node", start, start + 25, thread=2,
                      fwd_thread=1, seq=seq)
        inner = _event("Node", start + 1, start + 24, node, thread=2, fwd_thread=1, seq=seq)
        _event("aten::op", start + 2, start + 20, inner, kernel_us=kernel_us, thread=2)
        nodes.append(node)
    # AccumulateGrad carries no sequence number: under no sublayer
    accumulate = _event("aten::detach", 200, 201, kernel_us=(100,), thread=2)
    events, stack = [], [forward, *nodes, accumulate]
    while stack:
        event = stack.pop()
        events.append(event)
        stack.extend(event.cpu_children)
    return _trace(events)


def test_a_backward_node_counts_under_the_sublayer_whose_op_made_it():
    trace = _sublayer_trace()
    assert spans.sublayer_ms(trace, "model.norm") == pytest.approx((4 + 7) * 1e-3)
    assert spans.sublayer_ms(trace, "model.mlp") == pytest.approx((10 + 12) * 1e-3)
    assert spans.sublayer_ms(trace, "model.embed") == pytest.approx((3 + 1 + 2) * 1e-3)
    assert spans.sublayer_ms(trace, "model.attention") is None


def test_a_kernel_counts_once_under_nested_spans_and_never_through_the_profilers_events():
    step = _span("train.step", 0, 100)
    forward = _span("train.forward", 0, 90, step)
    attention = _span("model.attention", 1, 80, forward)
    # a range's own entry is its device span, first kernel to last
    attention.kernels.append(types.SimpleNamespace(duration=70.0))
    linear = _event("aten::linear", 2, 60, attention)
    addmm = _event("aten::addmm", 3, 50, linear, kernel_us=(10,))
    full = _event("Command Buffer Full", 4, 40, addmm, kernel_us=(30,))
    trace = _trace([step, forward, attention, linear, addmm, full])
    for name in ("train.step", "train.forward"):
        assert spans.launched_ms(trace, name) == pytest.approx(10e-3)
    assert spans.sublayer_ms(trace, "model.attention") == pytest.approx(10e-3)


def test_without_spans_the_new_readers_read_nothing():
    plain = _trace([_event("aten::addmm", 0, 10, kernel_us=(5,))])
    for name in NEW + ("forward_ms.resnet", "backward_ms.resnet"):
        assert _reader(name)(types.SimpleNamespace(trace=plain)) is None, name


def _old_trace(with_spans: bool) -> Trace:
    """Ops as the benchmark's own yardstick tests lay them out, with or
    without the program's spans above them."""
    step = _span("train.step", 0, 100) if with_spans else None
    forward = _span("train.forward", 0, 50, step) if with_spans else None
    linear = _event("aten::linear", 0, 30, forward)
    optimizer = _span("train.optimizer", 70, 100, step) if with_spans else None
    opt = _event("Optimizer.step#SGD.step", 70, 95, optimizer, kernel_us=(25.0,), annotation=True)
    host = [e for e in (step, forward, optimizer) if e is not None] + [
        linear, _event("aten::addmm", 5, 25, linear, kernel_us=(30.0,)),
        _event("aten::batch_norm", 30, 45, forward, kernel_us=(6.0,)),
        opt, _event("aten::_foreach_add_", 71, 80, opt, kernel_us=(4.0, 6.0))]
    device = [types.SimpleNamespace(name=n, time_range=types.SimpleNamespace(
        start=s, end=e, elapsed_us=lambda s=s, e=e: e - s)) for n, s, e in
        (("gemm", 10, 40), ("bn", 40, 46), ("add", 90, 100))]
    return _trace(host, steps=2, busy_us=60.0, device=device)


def test_the_readers_that_were_there_read_the_same_with_spans_in_the_trace():
    before, after = _old_trace(False), _old_trace(True)
    for name in OLD:
        assert _reader(name)(types.SimpleNamespace(trace=after)) == pytest.approx(
            _reader(name)(types.SimpleNamespace(trace=before))), name
    gaps_before, gaps_after = before.idle_gaps(), after.idle_gaps()
    assert [s for _, s in gaps_after] == pytest.approx([s for _, s in gaps_before])
    # the card idles from 46 to 90 us; no op runs at 68 us, the step's range does
    assert ("host: none", pytest.approx(44e-6)) in gaps_before
    assert ("train.step", pytest.approx(44e-6)) in gaps_after


def test_on_a_real_trace_each_kernel_of_the_step_falls_under_one_sublayer_or_the_loss():
    """A tiny LM's step traced on the CPU, one unit kernel given to each leaf
    op: the sublayers and the loss are disjoint and cover the forward and
    the backward but for the backward's seed and the gradients' hand-over
    to the leaves, which no sublayer made."""
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.parallel import train

    model = TransformerLM(vocab_size=64, num_layers=2, num_heads=2, embed_dim=16,
                          max_seq_len=16, dtype=torch.float32, logits_dtype=torch.float32)
    state = train.create_train_state(model, train.default_optimizer(0.1), device="cpu")
    step = train.make_lm_train_step(state)
    tokens = torch.randint(0, 64, (4, 8), generator=torch.Generator().manual_seed(1))
    step(tokens)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(tokens)
    events = list(prof.events())
    for e in events:
        if not e.cpu_children and not e.is_user_annotation:
            e.kernels.append(types.SimpleNamespace(duration=1.0))
    trace = _trace(events, steps=2)
    parts = ("model.embed", "model.norm", "model.attention", "model.mlp", "model.head",
             "train.loss")
    sublayers = sum(spans.sublayer_ms(trace, name) for name in parts)
    launched = sum(spans.launched_ms(trace, name)
                   for name in ("train.forward", "train.loss", "train.backward"))
    backward = spans._merged(spans._spans(trace, "train.backward"))
    unmade = [op for op, _ in spans._own_kernels(trace) if spans._node(op) is None
              and any(start <= op.time_range.start <= end for start, end in backward)]
    assert sublayers == pytest.approx(launched - len(unmade) * 1e-3 / 2)
    assert sublayers >= 0.9 * launched


@pytest.mark.cuda
@pytest.mark.parametrize("cell, expected", [
    ("tiny-gpt-train", set(NEW)),
    ("tiny-resnet-train", {"forward_ms.resnet", "backward_ms.resnet"}),
])
def test_a_traced_run_on_the_card_reads_the_span_metrics(bench_root, card, cell, expected):
    bench = manifest.load(bench_root)
    result, _ = run.run_cell(bench, bench.cell(cell), 2**31 + 7, 1.0, True, card,
                             start=time.monotonic())
    metrics = result["metrics"]
    assert expected <= set(metrics)
    assert all(metrics[name]["value"] > 0 for name in expected)
