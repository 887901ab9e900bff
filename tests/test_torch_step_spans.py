"""The train steps' and the LM's profiler spans (`obs/trace.annotate`): which
spans a step records and where, that without a profiler a step builds no
range and computes the same bits, that the ranges sit on the Unix clock,
and that a backward node carries the sequence number of the forward op
that made it, which is how `portbench/spans.py` files backward kernels
under a sublayer."""

import time

import pytest
import torch

from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models.resnet import BasicBlock, ResNet
from tritonk8ssupervisor_tpu_torch.parallel import train

LAYERS = 2
STEP_SPANS = ("train.step", "train.forward", "train.loss", "train.backward", "train.optimizer")


def _lm_step(grad_accum: int = 1):
    model = TransformerLM(vocab_size=64, num_layers=LAYERS, num_heads=2, embed_dim=16,
                          max_seq_len=16, dtype=torch.float32, logits_dtype=torch.float32)
    state = train.create_train_state(model, train.default_optimizer(0.1), device="cpu")
    tokens = torch.randint(0, 64, (4, 8), generator=torch.Generator().manual_seed(1))
    step = train.make_lm_train_step(state, grad_accum=grad_accum)
    return state, lambda: step(tokens)


def _resnet_step():
    model = ResNet(stage_sizes=(1, 1), block_cls=BasicBlock, num_classes=10, num_filters=4,
                   dtype=torch.float32)
    state = train.create_train_state(model, train.default_optimizer(0.1), device="cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(4, 16, 16, 3, generator=gen)
    labels = torch.randint(0, 10, (4,), generator=gen)
    step = train.make_train_step(state)
    return state, lambda: step(images, labels)


def _profiled(run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        metrics = run()
        t1 = time.time_ns()
    return metrics, list(prof.events()), prof.profiler.kineto_results.trace_start_ns(), t0, t1


def _counts(events) -> dict:
    counts: dict = {}
    for e in events:
        if e.name.startswith(("train.", "model.")):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _inside(event, name: str) -> bool:
    parent = event.cpu_parent
    while parent is not None:
        if parent.name == name:
            return True
        parent = parent.cpu_parent
    return False


def _lm_counts(chunks: int) -> dict:
    return {"train.step": 1, "train.forward": chunks, "train.loss": chunks,
            "train.backward": chunks, "train.optimizer": 1,
            "model.embed": chunks, "model.head": chunks, "model.norm": (2 * LAYERS + 1) * chunks,
            "model.attention": LAYERS * chunks, "model.mlp": LAYERS * chunks}


@pytest.mark.parametrize("build, expected", [
    (_lm_step, _lm_counts(1)),
    (lambda: _lm_step(grad_accum=2), _lm_counts(2)),
    (_resnet_step, dict.fromkeys(STEP_SPANS, 1)),
], ids=["lm", "lm-grad-accum-2", "resnet"])
def test_a_step_records_its_spans(build, expected):
    _, run = build()
    _, events, *_ = _profiled(run)
    assert _counts(events) == expected
    for e in events:
        if e.name.startswith("model."):
            assert _inside(e, "train.forward"), e.name
        elif e.name in STEP_SPANS[1:]:
            assert _inside(e, "train.step"), e.name


@pytest.mark.parametrize("build", [_lm_step, _resnet_step], ids=["lm", "resnet"])
def test_without_a_profiler_a_step_builds_no_range_and_computes_the_same_bits(build, monkeypatch):
    built = []
    init = torch.autograd.profiler.record_function.__init__

    def counting_init(self, name, *args, **kwargs):
        built.append(name)
        init(self, name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", counting_init)
    # two steps built alike hold the same weights and batch
    (plain_state, plain_run), (traced_state, traced_run) = build(), build()
    plain = plain_run()
    # torch's optimizer opens its own ranges whether or not a profiler runs
    assert all(name.startswith("Optimizer.") for name in built), sorted(set(built))
    traced, *_ = _profiled(traced_run)
    assert "train.step" in built
    assert torch.equal(plain["loss"], traced["loss"])
    traced_leaves = traced_state.model.state_dict()
    for key, value in plain_state.model.state_dict().items():
        assert torch.equal(value, traced_leaves[key]), key


def test_the_spans_lie_on_the_unix_clock():
    _, run = _lm_step()
    _, events, start_ns, t0, t1 = _profiled(run)
    (span,) = [e for e in events if e.name == "train.step"]
    begin = start_ns + span.time_range.start * 1e3
    end = start_ns + span.time_range.end * 1e3
    assert t0 - 1e6 <= begin <= end <= t1 + 1e6


def test_a_backward_node_carries_its_forward_ops_sequence_number():
    _, run = _lm_step()
    _, events, *_ = _profiled(run)
    in_norm = {(e.thread, e.sequence_nr) for e in events
               if e.sequence_nr >= 0 and not e.fwd_thread and _inside(e, "model.norm")}
    # rsqrt runs in the LayerNorm alone: each of its backward nodes points into a norm span
    nodes = [(e.fwd_thread, e.sequence_nr) for e in events if e.name == "RsqrtBackward0"]
    assert len(nodes) == 2 * LAYERS + 1
    assert set(nodes) <= in_norm
