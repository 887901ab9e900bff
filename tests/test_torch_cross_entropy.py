"""K1 in the PyTorch port against the JAX reference.

The JAX side runs the Pallas kernel itself, in interpret mode on the
CPU (`cross_entropy_loss_and_correct(..., True)`), as tests/test_ops.py
does; the port runs on CPU tensors, which take K1's plain torch version.
Inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu.ops import cross_entropy as jax_ce
from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce


def _inputs(batch, classes, seed, labels=None, ties=0):
    """f32 logits with `ties` rows whose two largest entries are exactly
    equal (the label on one of them), and labels that may include values
    outside [0, C)."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(batch, classes)) * 4).astype(np.float32)
    if labels is None:
        labels = rng.integers(0, classes, size=batch)
    labels = np.asarray(labels, dtype=np.int32)
    for row in range(ties):
        a, b = rng.choice(classes, size=2, replace=False)
        logits[row, a] = logits[row, b] = logits[row].max() + 1.0
        labels[row] = b if row % 2 else a
    return logits, labels


# (batch, classes): C off the 128-lane multiple; B over the JAX kernel's
# block (130 rows at C=5000 is blocks of 128 plus padding); labels -1 and C
CASES = [
    pytest.param(33, 200, None, 4, id="c200"),
    pytest.param(130, 5000, None, 3, id="b130-c5000"),
    pytest.param(8, 64, [0, 5, -1, 63, 64, 1000, 2, -7], 0, id="out-of-range"),
]


@pytest.mark.parametrize("batch,classes,labels,ties", CASES)
def test_forward_matches_jax_kernel(batch, classes, labels, ties):
    logits, labels = _inputs(batch, classes, seed=batch, labels=labels, ties=ties)
    ref_loss, ref_correct = jax_ce.cross_entropy_loss_and_correct(
        jnp.asarray(logits), jnp.asarray(labels), True
    )
    before = ce.cross_entropy_forward.launches
    loss, correct = ce.cross_entropy_loss_and_correct(
        torch.from_numpy(logits), torch.from_numpy(labels)
    )
    # a CPU tensor takes the plain version: no kernel launch
    assert ce.cross_entropy_forward.launches == before
    assert loss.dtype == torch.float32 and correct.dtype == torch.bool
    np.testing.assert_array_equal(correct.numpy(), np.asarray(ref_correct))
    # A label in [C, C rounded up to 128) picks one of the TPU kernel's
    # padding lanes, whose shifted logit is -inf: the loss reads +inf on
    # both sides (assert_allclose holds inf equal to inf); any other label
    # outside [0, C) reads logsumexp(x) - max(x).
    lane_pad = (labels >= classes) & (labels < ce.padded_classes(classes))
    assert np.isinf(loss.numpy()[lane_pad]).all() and np.isfinite(loss.numpy()[~lane_pad]).all()
    # f32 on both sides, the same arithmetic in another op order: 1e-5
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    if ties:
        # both tied labels read correct, as the kernel's picked >= 0 says
        assert correct[:ties].all()


@pytest.mark.parametrize("batch,classes,labels,ties", CASES)
def test_gradient_matches_jax_custom_vjp(batch, classes, labels, ties):
    logits, labels = _inputs(batch, classes, seed=batch + 1, labels=labels, ties=ties)
    g_ref = jax.grad(
        lambda lo: jnp.mean(
            jax_ce.cross_entropy_loss_and_correct(lo, jnp.asarray(labels), True)[0]
        )
    )(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    ce.cross_entropy_loss_and_correct(x, torch.from_numpy(labels))[0].mean().backward()
    # (softmax - onehot) * g in f32 on both sides; labels outside [0, C)
    # give a zero one-hot row on both
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-7)


def test_bf16_logits_and_int64_labels_match_jax_kernel():
    logits, labels = _inputs(40, 300, seed=5, ties=2)
    bf16 = jnp.asarray(logits).astype(jnp.bfloat16)
    ref_loss, ref_correct = jax_ce.cross_entropy_loss_and_correct(
        bf16, jnp.asarray(labels), True
    )
    x = torch.from_numpy(np.array(bf16.astype(jnp.float32))).to(torch.bfloat16)
    loss, correct = ce.cross_entropy_forward(x, torch.from_numpy(labels).long())
    # the same bf16 values upcast to f32 on both sides: f32 tolerance
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(ref_correct))


def test_loss_only_entry_and_references_match_jax():
    logits, labels = _inputs(17, 130, seed=9)
    jl, jll = jnp.asarray(logits), jnp.asarray(labels)
    tl, tll = torch.from_numpy(logits), torch.from_numpy(labels)
    ref = np.asarray(jax_ce.cross_entropy_loss_reference(jl, jll))
    np.testing.assert_allclose(
        ce.cross_entropy_loss(tl, tll).numpy(),
        np.asarray(jax_ce.cross_entropy_loss(jl, jll, True)), rtol=1e-5, atol=1e-5,
    )
    loss, correct = ce.cross_entropy_loss_and_correct_reference(tl, tll)
    np.testing.assert_allclose(loss.numpy(), ref, rtol=1e-5, atol=1e-5)
    ref_correct = jax_ce.cross_entropy_loss_and_correct_reference(jl, jll)[1]
    np.testing.assert_array_equal(correct.numpy(), np.asarray(ref_correct))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    before = ce.cross_entropy_forward.launches
    with pytest.raises(ValueError, match="expected logits"):
        ce.cross_entropy_forward(torch.zeros(4, 10), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected logits"):
        ce.cross_entropy_forward(torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    # neither CPU nor CUDA: no plain path and no kernel, so it raises
    meta = torch.empty(4, 10, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ce.cross_entropy_forward(meta, torch.zeros(4, dtype=torch.int32, device="meta"))
    assert ce.cross_entropy_forward.launches == before
