"""The port's KV-cache decoding (`models/decode.py`) against the JAX
package's on the same weights: the quantisers bit for bit, prefill logits,
greedy `generate` token for token on an f32 model (bf16 cache, int8 cache,
int8 weights with the int8 cache), the argument checks, sampling, and the
speculative acceptance arithmetic on the same numpy random draws.

The weights are drawn with numpy into the flax tree and carried to the
port by `utils/convert.py`; f32 models with head_dim 16, where both sides
differ only in the order of summation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_transformer import lm_variables

from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
from tritonk8ssupervisor_tpu.models import decode as jax_dec
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

CONFIG = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=32)
# prefill logits of an f32 model: the same math in other op orders
LOGITS_TOLERANCE = 1e-4


def lm_pair(dtype="float32", seed=0, **overrides):
    """(JAX model, flax params, port model, port params) on one set of
    numpy-drawn weights."""
    cfg = {**CONFIG, **overrides}
    jmodel = JaxLM(**cfg, dtype=getattr(jnp, dtype), logits_dtype=getattr(jnp, dtype))
    variables = lm_variables(jmodel, seed, seq=cfg["max_seq_len"])
    model = TransformerLM(**cfg, dtype=getattr(torch, dtype), logits_dtype=getattr(torch, dtype))
    model.load_state_dict(state_dict_from_flax(variables, model))
    return jmodel, variables["params"], model, dec.lm_params(model)


@pytest.fixture(scope="module")
def f32_lm():
    return lm_pair()


def prompts(seed=1, batch=2, length=6):
    return np.random.default_rng(seed).integers(0, CONFIG["vocab_size"],
                                                (batch, length)).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quant_kv_is_bit_equal(dtype):
    x = (np.random.default_rng(2).standard_normal((2, 5, 3, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5 * np.abs(x[1, 2, 1]).max() / 127]  # near halves
    xj = jnp.asarray(x).astype(dtype)
    codes, scale = jax_dec._quant_kv(xj)
    got_codes, got_scale = dec._quant_kv(torch.from_numpy(np.array(xj.astype(jnp.float32)))
                                         .to(torch.float32 if dtype is np.float32
                                             else torch.bfloat16))
    assert got_codes.dtype == torch.int8 and got_scale.dtype == torch.float32
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(got_scale.numpy(), np.asarray(scale))


def test_quantize_params_int8_is_bit_equal(f32_lm):
    _, jparams, _, params = f32_lm
    want = jax_dec.quantize_params_int8(jparams)
    got = dec.quantize_params_int8(params)
    for block in ("Block_0", "Block_1"):
        for name in ("qkv", "proj", "mlp_up", "mlp_down"):
            ref, port = want[block][name], got[block][name]
            assert set(port) == {"weight_int8", "scale", "bias"}
            assert port["weight_int8"].dtype == torch.int8
            np.testing.assert_array_equal(port["weight_int8"].numpy().T,
                                          np.asarray(ref["kernel_int8"]))
            np.testing.assert_array_equal(port["scale"].numpy(), np.asarray(ref["scale"]))
            np.testing.assert_array_equal(port["bias"].numpy(), np.asarray(ref["bias"]))
        # layernorms stay full precision
        assert got[block]["LayerNorm_0"]["weight"] is params[block]["LayerNorm_0"]["weight"]
    np.testing.assert_array_equal(got["lm_head"]["weight_int8"].numpy().T,
                                  np.asarray(want["lm_head"]["kernel_int8"]))
    assert got["tok_embed"]["weight"] is params["tok_embed"]["weight"]
    assert got["pos_embed"] is params["pos_embed"]


@pytest.mark.parametrize("cache_int8", [False, True], ids=["bf16-cache", "int8-cache"])
def test_prefill_logits_match_jax(f32_lm, cache_int8):
    jmodel, jparams, model, params = f32_lm
    tokens = prompts(3, batch=2, length=9)
    _, want = jax_dec.prefill(jmodel, jparams, jnp.asarray(tokens), 16, cache_int8=cache_int8)
    cache, got = dec.prefill(model, params, torch.from_numpy(tokens), 16, cache_int8=cache_int8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGITS_TOLERANCE)
    layer = cache["Block_1"]
    if cache_int8:
        assert layer["k"].dtype == torch.int8 and layer["k_scale"].shape == (2, 16, 2)
    else:
        assert layer["k"].dtype == torch.bfloat16 and layer["k"].shape == (2, 16, 2, 16)
    assert not layer["v"][:, 9:].any()  # past the prompt: still the zeros


@pytest.mark.parametrize("cache_int8,int8", [(False, False), (True, False), (True, True)],
                         ids=["bf16-cache", "int8-cache", "int8-weights-int8-cache"])
def test_greedy_generate_is_token_identical_to_jax(f32_lm, cache_int8, int8):
    jmodel, jparams, model, params = f32_lm
    if int8:
        jparams, params = jax_dec.quantize_params_int8(jparams), dec.quantize_params_int8(params)
    prompt = prompts(4)
    want = np.asarray(jax_dec.generate(jmodel, jparams, jnp.asarray(prompt), 12,
                                       max_len=32, cache_int8=cache_int8))
    got = dec.generate(model, params, torch.from_numpy(prompt), 12, max_len=32,
                       cache_int8=cache_int8, unroll=4)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_is_deterministic_per_generator_and_in_range(f32_lm):
    _, _, model, params = f32_lm
    prompt = torch.from_numpy(prompts(5))

    def sample(seed):
        return dec.generate(model, params, prompt, 10, temperature=1.5,
                            rng=torch.Generator().manual_seed(seed))

    first = sample(0)
    assert torch.equal(first, sample(0))
    assert not torch.equal(first, sample(1))
    assert int(first.min()) >= 0 and int(first.max()) < CONFIG["vocab_size"]


def test_generate_checks_lengths_and_rng(f32_lm):
    _, _, model, params = f32_lm
    prompt = torch.from_numpy(prompts(6))
    with pytest.raises(ValueError, match="exceeds cache"):
        dec.generate(model, params, prompt, 30, max_len=32)
    with pytest.raises(ValueError, match="max_seq_len"):
        dec.generate(model, params, prompt, 4, max_len=64)
    with pytest.raises(ValueError, match="rng"):
        dec.generate(model, params, prompt, 4, temperature=1.0)
    with pytest.raises(ValueError, match="exceeds cache length"):
        dec.prefill(model, params, prompt, 4)
    assert dec.generate(model, params, prompt, 0).shape == (2, 0)


def test_softmax_np_and_speculative_accept_equal_the_reference():
    """Greedy and sampled acceptance on the same draws of one numpy
    Generator: the same (accepted, emitted) and the same stream state."""
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 2.0, size=(5, 12))
    for temp in (0.5, 1.0, 3.0):
        np.testing.assert_array_equal(dec.softmax_np(logits, temp),
                                      jax_dec.softmax_np(logits, temp))
    k, vocab = 3, 12
    for trial in range(200):
        target = rng.normal(0, 2.0, size=(k + 1, vocab))
        draft = rng.normal(0, 2.0, size=(k, vocab))
        drafts = rng.integers(0, vocab, k)
        if trial % 4 == 0:  # drafts that agree with the target's argmax
            drafts = np.argmax(target[:k], axis=-1)
        temp = 0.0 if trial % 2 else 1.0
        seed = int(rng.integers(0, 2**31))
        ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
        assert (dec.speculative_accept(drafts, draft, target, temp, ours)
                == jax_dec.speculative_accept(drafts, draft, target, temp, theirs))
        assert ours.random() == theirs.random()


def test_lm_params_is_the_state_dict_as_a_tree(f32_lm):
    _, jparams, model, params = f32_lm
    assert set(params) == set(jparams)
    assert set(params["Block_0"]) == set(jparams["Block_0"])
    assert params["Block_0"]["qkv"]["weight"].shape == (96, 32)
    state = model.state_dict()
    assert torch.equal(params["Block_1"]["mlp_up"]["bias"], state["Block_1.mlp_up.bias"])
    assert (model.num_heads, model.embed_dim, model.mlp_ratio, model.max_seq_len,
            model.vocab_size, model.logits_dtype) == (2, 32, 4, 32, 64, torch.float32)


def test_jax_and_port_agree_on_the_reference_bf16_lm():
    """On the reference's default bf16 dtypes the two sides round at
    different points (the port's int8 decode attention keeps f32 scores):
    no token identity is claimed, only prefill logits within bf16 steps and
    finite, in-range tokens."""
    jmodel, jparams, model, params = lm_pair("bfloat16", seed=7)
    tokens = prompts(8)
    _, want = jax_dec.prefill(jmodel, jparams, jnp.asarray(tokens), 32)
    _, got = dec.prefill(model, params, torch.from_numpy(tokens), 32)
    # bf16 logits near 4 step by 2^-5: up to two steps
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=6.25e-2)
    out = dec.generate(model, params, torch.from_numpy(tokens), 6, cache_int8=True)
    assert out.shape == (2, 6) and int(out.max()) < CONFIG["vocab_size"]
