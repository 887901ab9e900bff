"""The plain references against the port's models at tiny sizes on the
CPU, both in float32: the same loss and the same gradients, leaf by leaf,
from the weights and batches the benchmark makes."""

from __future__ import annotations

import pytest
import torch

from portbench.families import lm, resnet
from portbench.reference.common import Precision
from portbench.tests.conftest import TINY_GPT, TINY_RESNET

CPU = torch.device("cpu")


def _port_loss_and_grads(model, step, batch) -> tuple[float, dict]:
    metrics = step(*batch) if isinstance(batch, tuple) else step(batch)
    return float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()}


def _reference(family, config, traffic, batch):
    leaves = {n: t.clone().requires_grad_()
              for n, t in family.make_weights(config, traffic, 3, CPU).items()}
    loss = family.reference_loss(leaves, batch, config, Precision("float32"))
    return float(loss), {n: t.grad for n, t in leaves.items()}


def _load(model, weights):
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    with torch.no_grad():
        for name, w in weights.items():
            params[name].copy_(w)


def _assert_close(port, ref, tol):
    (port_loss, port_grads), (ref_loss, ref_grads) = port, ref
    assert port_loss == pytest.approx(ref_loss, rel=tol)
    scale = max(float(g.norm()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        assert float((port_grads[name] - g).norm()) <= tol * scale, name


def test_gpt_reference_matches_the_port_lm():
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.parallel import train

    traffic = {"batch": 3, "seq": 12, "token_ids": 120}
    model = TransformerLM(vocab_size=TINY_GPT["vocab_size"], num_layers=TINY_GPT["n_layer"],
                          num_heads=TINY_GPT["n_head"], embed_dim=TINY_GPT["n_embd"],
                          max_seq_len=TINY_GPT["n_positions"], dtype=torch.float32,
                          logits_dtype=torch.float32)
    _load(model, lm.make_weights(TINY_GPT, traffic, 3, CPU))
    state = train.create_train_state(model, train.default_optimizer(0.03), "cpu")
    batch = lm.make_batch(TINY_GPT, traffic, 3, 0, CPU)
    port = _port_loss_and_grads(model, train.make_lm_train_step(state), batch)
    _assert_close(port, _reference(lm, TINY_GPT, traffic, batch), 2e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_resnet_reference_matches_the_port_resnet50(fused):
    from tritonk8ssupervisor_tpu_torch.models import ResNet50
    from tritonk8ssupervisor_tpu_torch.parallel import train

    traffic = {"batch": 4, "image_size": 32, "fused_1x1_bwd": fused}
    model = ResNet50(num_classes=TINY_RESNET["num_classes"], dtype=torch.float32,
                     fused_1x1_bwd=fused)
    _load(model, resnet.make_weights(TINY_RESNET, traffic, 3, CPU))
    state = train.create_train_state(model, train.default_optimizer(0.1), "cpu")
    batch = resnet.make_batch(TINY_RESNET, traffic, 3, 0, CPU)
    port = _port_loss_and_grads(model, train.make_train_step(state), batch)
    _assert_close(port, _reference(resnet, TINY_RESNET, traffic, batch), 1e-4)


def test_the_leaves_are_the_port_models_leaves():
    from tritonk8ssupervisor_tpu_torch.models import ResNet50, TransformerLM

    with torch.device("meta"):
        gpt = TransformerLM(vocab_size=50304, num_layers=12, num_heads=12, embed_dim=768,
                            max_seq_len=16384)
        rn = ResNet50(fused_1x1_bwd=True)
    config = {"n_layer": 12, "n_head": 12, "n_embd": 768, "n_positions": 16384,
              "vocab_size": 50304}
    for model, leaves in ((gpt, lm.leaves(config)), (rn, resnet.leaves(
            {"stages": [3, 4, 6, 3], "num_filters": 64, "expansion": 4, "num_classes": 1000}))):
        assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
            {n: tuple(shape) for n, shape, _, _ in leaves}
