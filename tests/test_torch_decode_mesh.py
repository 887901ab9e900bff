"""Data-parallel decode over a mesh (benchmarks/decode.py) against the JAX
package: each of 2 gloo ranks generates its half of the batch, and the
halves equal the reference's `generate` of the whole batch token for
token (tests/test_decode.py's mesh contract), with the bf16 and the int8
cache; the decode benchmark on 2 ranks reports 2 chips and refuses a
batch that does not split over them. Sampled decode over the 2 ranks
(temperature 1.5) gives exactly the rows of one process's run on the whole
batch with the same seed, through `generate` and through the benchmark:
every rank draws the whole batch's noise and keeps its rows.

f32 models with head_dim 16, as tests/test_torch_decode.py: both sides
differ only in the order of summation.
"""

import numpy as np
import pytest
import torch

from tritonk8ssupervisor_tpu_torch.benchmarks import decode as bench
from tritonk8ssupervisor_tpu_torch.models import TransformerLM
from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.parallel import mesh
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks
from tritonk8ssupervisor_tpu_torch.utils.data import batch_shard

CONFIG = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=32)
NEW_TOKENS = 8
TINY = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32, prompt_len=8, new_tokens=4,
            repeats=1, device="cpu")
TEMPERATURE = 1.5


def _sampled(model, params, prompt, m=None):
    return dec.generate(model, params, prompt, NEW_TOKENS, temperature=TEMPERATURE,
                        rng=torch.Generator().manual_seed(3), mesh=m)


def decode_ranks(sd, prompt):
    """This rank's rows of `prompt` through `generate` with each cache; then
    the benchmark on the mesh, and its refusal of a batch of 3; then both
    sampled at TEMPERATURE."""
    m = mesh.make_mesh(device_type="cpu")
    model = TransformerLM(**CONFIG, dtype=torch.float32, logits_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = dec.lm_params(model)
    local = batch_shard(m, torch.from_numpy(prompt))
    tokens = {int8: dec.generate(model, params, local, NEW_TOKENS, cache_int8=int8)
              for int8 in (False, True)}
    result = bench.run_benchmark(batch=4, cache_int8=True, keep_tokens=True, **TINY)
    try:
        bench.run_benchmark(batch=3, **TINY)
        refused = None
    except ValueError as e:
        refused = str(e)
    sampled = {"generate": _sampled(model, params, local, m),
               "benchmark": bench.run_benchmark(batch=4, temperature=TEMPERATURE,
                                                keep_tokens=True, **TINY)["tokens"]}
    return tokens, result, refused, sampled


@pytest.fixture(scope="module")
def reference():
    """The JAX model's weights as a state dict, the prompts, and the
    reference's greedy tokens of the whole batch with each cache."""
    import jax.numpy as jnp
    from test_torch_transformer import lm_variables

    from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
    from tritonk8ssupervisor_tpu.models import decode as jax_dec
    from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

    jmodel = JaxLM(**CONFIG, dtype=jnp.float32, logits_dtype=jnp.float32)
    variables = lm_variables(jmodel, 11, seq=CONFIG["max_seq_len"])
    prompt = np.random.default_rng(12).integers(0, 64, (4, 6)).astype(np.int32)
    want = {int8: np.asarray(jax_dec.generate(jmodel, variables["params"], jnp.asarray(prompt),
                                              NEW_TOKENS, cache_int8=int8))
            for int8 in (False, True)}
    model = TransformerLM(**CONFIG, dtype=torch.float32, logits_dtype=torch.float32)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables, model).items()}
    return sd, prompt, want


@pytest.fixture(scope="module")
def decoded(reference):
    sd, prompt, want = reference
    return run_ranks(decode_ranks, 2, args=(sd, prompt), timeout=240.0, threads=1), want


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache", "int8_cache"])
def test_data_parallel_generate_equals_the_reference_on_the_whole_batch(decoded, int8):
    results, want = decoded
    got = np.concatenate([tokens[int8].numpy() for tokens, *_ in results])
    np.testing.assert_array_equal(got, want[int8])


def test_decode_benchmark_runs_on_two_ranks(decoded):
    """`num_chips` is the mesh's size, each rank decodes 2 of the 4 streams
    (the rows of its own generate of them), the per-chip rate is the rate
    over 2, and a batch of 3 raises ValueError on both ranks."""
    results, _ = decoded
    # the benchmark's model and prompts, as it makes them
    max_len = TINY["prompt_len"] + TINY["new_tokens"]
    model = TransformerLM(**{k: TINY[k] for k in ("vocab_size", "num_layers", "num_heads",
                                                  "embed_dim")},
                          max_seq_len=max_len, generator=torch.Generator().manual_seed(1))
    prompt = torch.randint(0, 64, (4, TINY["prompt_len"]),
                           generator=torch.Generator().manual_seed(0))
    for rank, (_, result, refused, _) in enumerate(results):
        assert result["num_chips"] == 2 and result["batch"] == 4, rank
        rows = dec.generate(model, dec.lm_params(model, "cpu"), prompt[2 * rank:2 * rank + 2],
                            TINY["new_tokens"], max_len=max_len, cache_int8=True)
        assert result["tokens"] == rows.tolist(), rank
        assert result["tokens_per_sec_per_chip"] == pytest.approx(result["tokens_per_sec"] / 2)
        assert result["tokens_per_sec"] == results[0][1]["tokens_per_sec"]  # one rate, the slowest
        assert "must be divisible by the 2-chip data-parallel degree" in refused


@pytest.mark.parametrize("path", ["generate", "benchmark"])
def test_sampled_decode_over_two_ranks_equals_one_process(reference, decoded, path):
    """Each rank's sampled rows equal its rows of one process's run on the
    whole batch with the same seed (F4: each rank drew noise for its own
    rows only, so rank 1's row i repeated rank 0's draws)."""
    results, _ = decoded
    got = torch.cat([torch.as_tensor(sampled[path]) for *_, sampled in results])
    if path == "generate":
        sd, prompt, _ = reference
        model = TransformerLM(**CONFIG, dtype=torch.float32, logits_dtype=torch.float32)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        want = _sampled(model, dec.lm_params(model), torch.from_numpy(prompt))
    else:
        want = torch.tensor(bench.run_benchmark(batch=4, temperature=TEMPERATURE,
                                                keep_tokens=True, **TINY)["tokens"])
    assert got.shape == want.shape
    assert torch.equal(got, want.to(got.dtype))
