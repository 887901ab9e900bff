"""The port's serving path against the JAX package's on the same weights:
the page pool and prefix store on one scripted sequence of calls, the paged
`SlotEngine` token for token against JAX's `generate` and JAX's
`SlotEngine` (staggered joins, chunked prefill, warm prefix, eviction,
page-boundary crossings, reset, the int8 cache, speculative decoding), and
`benchmarks.decode` at a tiny size on the CPU.

Models are f32 with head_dim 16 (tests/test_torch_decode.py says why), so
every schedule must give exactly the reference's tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import lm_pair

from tritonk8ssupervisor_tpu.models import decode as jax_dec
from tritonk8ssupervisor_tpu.serving import gateway as jax_gw
from tritonk8ssupervisor_tpu.serving import kvpool as jax_kvpool
from tritonk8ssupervisor_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tritonk8ssupervisor_tpu_torch.benchmarks import decode as bench
from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.serving import Request, SlotEngine, kvpool

MAX_LEN = 48


@pytest.fixture(scope="module")
def lm():
    """Target and drafter (unrelated random weights: the reject path runs),
    both sides; the agreeing pair (a shared dominant head bias: high
    acceptance); three prompts, two sharing an 8-token prefix; and the JAX
    `generate` references."""
    jmodel, jparams, model, params = lm_pair(seed=0, max_seq_len=MAX_LEN)
    jdraft, jdparams, draft, dparams = lm_pair(seed=1, num_layers=1, max_seq_len=MAX_LEN)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 64, 6).astype(np.int32)
    b = rng.integers(0, 64, 9).astype(np.int32)
    sibling = np.concatenate([b[:8], [3, 41, 7]]).astype(np.int32)

    def reference(prompt, n, cache_int8=False):
        return [int(t) for t in np.asarray(jax_dec.generate(
            jmodel, jparams, jnp.asarray(prompt[None]), n, max_len=MAX_LEN,
            cache_int8=cache_int8))[0]]

    bias = torch.zeros(64)
    bias[17] = 200.0
    agree = {**params, "lm_head": {**params["lm_head"], "bias": params["lm_head"]["bias"] + bias}}
    dagree = {**dparams, "lm_head": {**dparams["lm_head"],
                                     "bias": dparams["lm_head"]["bias"] + bias}}
    return {
        "jmodel": jmodel, "jparams": jparams, "jdraft": jdraft, "jdparams": jdparams,
        "model": model, "params": params, "draft": draft, "dparams": dparams,
        "agree": agree, "dagree": dagree, "a": a, "b": b, "sibling": sibling,
        # greedy continuations are prefixes of longer ones
        "ref_a": reference(a, 12), "ref_b": reference(b, 8), "ref_sibling": reference(sibling, 6),
        "ref_a_int8": reference(a, 6, cache_int8=True),
    }


def request(rid, tokens, new):
    return Request(rid=rid, prompt_len=int(tokens.size), max_new_tokens=new, tokens=tokens)


def drain(engine, outs, max_steps=200):
    for _ in range(max_steps):
        res = engine.step()
        if res is None:
            return
        for slot, ids in res.finished.items():
            outs[slot] = ids
            engine.release(slot)


def run_one(engine, tokens, new):
    engine.join(0, request(0, tokens, new))
    outs: dict = {}
    drain(engine, outs, max_steps=60)
    return outs[0]


def staggered(engine, a, b, make_request=request, join_at=3):
    """A decodes 8 tokens; B (5 tokens) joins the running batch at step
    `join_at`."""
    engine.join(0, make_request(0, a, 8))
    outs: dict = {}
    for step in range(1, 100):
        res = engine.step()
        if res is None:
            break
        for slot, ids in res.finished.items():
            outs[slot] = ids
            engine.release(slot)
        if step == join_at:
            engine.join(1, make_request(1, b, 5))
        if len(outs) == 2:
            break
    return outs


def jax_request(rid, tokens, new):
    return jax_gw.Request(rid=rid, prompt_len=int(tokens.size), max_new_tokens=new, tokens=tokens)


def test_page_pool_and_prefix_store_match_the_reference():
    """One scripted sequence of alloc, ref, unref, match, register, peek,
    evict, release_span and flush on both copies: the same return values,
    counters and page ids."""
    trace = []
    for mod in (kvpool, jax_kvpool):
        pool = mod.PagePool(6, page_size=4)
        store = mod.PrefixStore(pool)
        tokens = np.arange(20, dtype=np.int32)
        keys = mod.token_block_keys(tokens, 4, mod.full_blocks(tokens.size, 4))
        other = mod.token_block_keys(np.arange(1, 21), 4, 3)
        out = [mod.full_blocks(20, 4), mod.match_cap_blocks(20, 4), mod.match_cap_blocks(8, 4)]
        first = pool.alloc(3)
        out += [first, pool.alloc(4), store.match(keys), store.register(keys[:3], first),
                store.register(keys[:2], first), store.peek(keys), store.peek(other),
                store.match(keys[:2]), store.match(other)]
        pool.ref(first[:1])
        out += [pool.unref(first), pool.pages_in_use, store.evictable_pages(),
                store.evict_for(1), pool.refcount(first[0]), pool.pages_free]
        span = pool.alloc(3)
        out += [span, pool.release_span(span, 1), span, pool.peak_in_use]
        out += [pool.unref(first[:1]), store.flush(), pool.unref(span), pool.pages_in_use,
                store.stats(), len(store)]
        with pytest.raises(ValueError, match="free page"):
            pool.unref([0])
        trace.append(out)
    assert trace[0] == trace[1]


@pytest.mark.parametrize("chunk", [4, 16])
def test_staggered_join_matches_jax_generate_and_engine(lm, chunk):
    """A request joining the running batch mid-stream, with chunked
    prefill: exactly the tokens of request-at-a-time generate, and of the
    JAX engine on the same schedule."""
    outs = staggered(SlotEngine(lm["model"], lm["params"], slots=3, max_len=MAX_LEN,
                                prefill_chunk=chunk), lm["a"], lm["b"])
    assert outs[0] == lm["ref_a"][:8] and outs[1] == lm["ref_b"][:5]
    ref = staggered(JaxSlotEngine(lm["jmodel"], lm["jparams"], slots=3, max_len=MAX_LEN,
                                  prefill_chunk=chunk), lm["a"], lm["b"], jax_request)
    assert outs == ref


def test_single_token_request(lm):
    eng = SlotEngine(lm["model"], lm["params"], slots=1, max_len=MAX_LEN, prefill_chunk=16)
    eng.join(0, request(0, lm["a"], 1))
    res = eng.step()
    assert res.finished[0] == lm["ref_a"][:1]
    eng.release(0)
    assert eng.busy_slots() == 0


def test_rejects_overflow_slot_conflict_and_bad_configurations(lm):
    model, params = lm["model"], lm["params"]
    eng = SlotEngine(model, params, slots=1, max_len=MAX_LEN, prefill_chunk=8)
    with pytest.raises(ValueError, match="exceeds cache"):
        eng.join(0, request(0, np.zeros((40,), np.int32), 10))
    eng.join(0, request(1, lm["a"], 2))
    with pytest.raises(ValueError, match="already occupied"):
        eng.join(0, request(2, lm["a"], 2))
    with pytest.raises(ValueError, match="no prompt tokens"):
        SlotEngine(model, params, slots=1, max_len=MAX_LEN).join(
            0, Request(rid=3, prompt_len=4, max_new_tokens=2))
    with pytest.raises(ValueError, match="max_seq_len"):
        SlotEngine(model, params, slots=1, max_len=4096)
    with pytest.raises(ValueError, match="draft_model"):
        SlotEngine(model, params, slots=1, max_len=MAX_LEN, spec_k=2)
    wide, _ = lm_pair(seed=2, vocab_size=128, max_seq_len=MAX_LEN)[2:]
    with pytest.raises(ValueError, match="vocabulary"):
        SlotEngine(model, params, slots=1, max_len=MAX_LEN, draft_model=wide,
                   draft_params=dec.lm_params(wide), spec_k=2)


def test_warm_prefix_staggered_join_token_parity(lm):
    """A prefills and registers its prompt's pages; B, sharing A's 8-token
    prefix, joins mid-decode of a third stream, matches 2 pages and
    prefills only its 3-token suffix, with exactly generate's tokens."""
    eng = SlotEngine(lm["model"], lm["params"], slots=3, max_len=MAX_LEN,
                     prefill_chunk=4, page_size=4)
    eng.join(0, request(0, lm["b"], 4))
    outs: dict = {}
    drain(eng, outs, max_steps=30)
    assert outs[0] == lm["ref_b"][:4]
    assert eng.prefix.stats()["entries"] == 2
    eng.join(1, request(1, lm["a"], 8))
    for _ in range(3):
        eng.step()
    before = eng.prefill_tokens
    eng.join(2, request(2, lm["sibling"], 4))
    drain(eng, outs)
    assert outs[2] == lm["ref_sibling"][:4] and outs[1] == lm["ref_a"][:8]
    assert eng.prefill_tokens - before == 3
    stats = eng.prefix.stats()
    assert stats["hits"] == 1 and stats["hit_tokens"] == 8


def test_page_eviction_and_refcount_release_while_sharing(lm):
    """Shared prefix pages survive the first holder's release; eviction
    drops index entries but frees only pages no live slot maps; a join
    that would need them waits until the sharer releases."""
    eng = SlotEngine(lm["model"], lm["params"], slots=3, max_len=MAX_LEN,
                     prefill_chunk=4, page_size=4, num_pages=8)
    outs: dict = {}
    eng.join(0, request(0, lm["b"], 2))
    drain(eng, outs, max_steps=10)
    assert 0 in outs
    eng.join(1, request(1, lm["sibling"], 6))
    assert eng.prefix.stats()["hits"] == 1
    eng.join(2, request(2, np.arange(20, 28, dtype=np.int32), 4))
    assert eng.pages.pages_free == 0
    fat = request(3, np.arange(40, 52, dtype=np.int32), 4)
    assert eng.prefix.evictable_pages() == 0
    assert not eng.can_join(fat)
    while 1 not in outs:
        res = eng.step()
        assert res is not None
        for slot, ids in res.finished.items():
            outs[slot] = ids
            eng.release(slot)
    assert outs[1] == lm["ref_sibling"][:6]
    assert eng.prefix.evictable_pages() >= 2
    assert eng.can_join(fat)


@pytest.mark.parametrize("chunk,ps", [(16, 4), (4, 8), (5, 3)])
def test_prompt_crosses_page_boundaries_mid_chunk(lm, chunk, ps):
    eng = SlotEngine(lm["model"], lm["params"], slots=2, max_len=MAX_LEN,
                     prefill_chunk=chunk, page_size=ps)
    assert run_one(eng, lm["b"], 5) == lm["ref_b"][:5]


def test_reset_clears_pool_with_zero_leaked_pages(lm):
    eng = SlotEngine(lm["model"], lm["params"], slots=3, max_len=MAX_LEN,
                     prefill_chunk=4, page_size=4)
    eng.join(0, request(0, lm["b"], 4))
    for _ in range(4):
        eng.step()
    eng.join(1, request(1, lm["a"], 4))
    eng.step()
    assert eng.pages.pages_in_use > 0
    eng.reset()
    assert eng.pages.pages_in_use == 0 and eng.pages.pages_free == eng.num_pages
    assert len(eng.prefix) == 0 and eng.busy_slots() == 0
    assert run_one(eng, lm["a"], 4) == lm["ref_a"][:4]


def test_paged_int8_token_identity(lm):
    """The int8 cache through pages: a single-chunk prompt equals dense int8
    generate (JAX's), and the page layout never changes a token (page 4
    against one page, chunked prefill)."""
    model, params = lm["model"], lm["params"]
    single = SlotEngine(model, params, slots=2, max_len=MAX_LEN, prefill_chunk=16,
                        page_size=4, cache_int8=True)
    assert run_one(single, lm["a"], 6) == lm["ref_a_int8"]
    got = dec.generate(model, params, torch.from_numpy(lm["a"][None]), 6, max_len=MAX_LEN,
                       cache_int8=True)
    assert got[0].tolist() == lm["ref_a_int8"]
    small = SlotEngine(model, params, slots=2, max_len=MAX_LEN, prefill_chunk=4,
                       page_size=4, cache_int8=True)
    one_page = SlotEngine(model, params, slots=2, max_len=MAX_LEN, prefill_chunk=4,
                          page_size=MAX_LEN, cache_int8=True)
    assert run_one(small, lm["b"], 5) == run_one(one_page, lm["b"], 5)


@pytest.mark.parametrize("cache_int8", [False, True], ids=["bf16-cache", "int8-cache"])
def test_speculative_matches_plain_and_the_jax_engine(lm, cache_int8):
    """An unrelated drafter (every round rolls back) under staggered joins:
    exactly the plain engine's tokens, the JAX spec engine's, and, with the
    bf16 cache, generate's."""
    spec_kw = dict(slots=3, max_len=MAX_LEN, prefill_chunk=4, page_size=4,
                   cache_int8=cache_int8, spec_k=3)
    eng = SlotEngine(lm["model"], lm["params"], draft_model=lm["draft"],
                     draft_params=lm["dparams"], **spec_kw)
    outs = staggered(eng, lm["a"], lm["b"], join_at=2)
    plain = staggered(SlotEngine(lm["model"], lm["params"], slots=3, max_len=MAX_LEN,
                                 prefill_chunk=4, page_size=4, cache_int8=cache_int8),
                      lm["a"], lm["b"], join_at=2)
    assert outs == plain
    if not cache_int8:
        assert outs[0] == lm["ref_a"][:8] and outs[1] == lm["ref_b"][:5]
    stats = eng.spec_stats()
    assert stats["rounds"] > 0 and stats["accepted"] + stats["rolled_back"] == stats["drafted"]
    ref = staggered(JaxSlotEngine(lm["jmodel"], lm["jparams"], draft_model=lm["jdraft"],
                                  draft_params=lm["jdparams"], **spec_kw),
                    lm["a"], lm["b"], jax_request, join_at=2)
    assert outs == ref


def test_speculative_high_acceptance_backfills_and_stays_exact(lm):
    """The agreeing pair: acceptance near 1, several tokens a round (the
    drafter's catch-up backfill runs), still the plain engine's tokens."""
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=8, page_size=4)
    eng = SlotEngine(lm["model"], lm["agree"], draft_model=lm["draft"],
                     draft_params=lm["dagree"], spec_k=3, **kw)
    got = run_one(eng, lm["a"], 12)
    assert got == run_one(SlotEngine(lm["model"], lm["agree"], **kw), lm["a"], 12)
    stats = eng.spec_stats()
    assert stats["acceptance_rate"] >= 0.9 and stats["rounds"] < 12


def test_speculative_pages_trimmed_on_finish_and_degenerate_budgets(lm):
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=4, page_size=4, prefix_cache=False)
    eng = SlotEngine(lm["model"], lm["params"], draft_model=lm["draft"],
                     draft_params=lm["dparams"], spec_k=3, **kw)
    plain = SlotEngine(lm["model"], lm["params"], **kw)
    assert eng._span_pages(9, 7, 0) == 5 and plain._span_pages(9, 7, 0) == 4
    eng.join(0, request(0, lm["b"], 7))
    assert eng.pages.pages_in_use == 5
    for _ in range(60):
        res = eng.step()
        if res and 0 in res.finished:
            break
    assert eng.pages.pages_in_use == 4 and len(eng._requests[0]["pages"]) == 4
    eng.release(0)
    assert eng.pages.pages_in_use == 0 and eng.pages.pages_free == eng.num_pages
    stats = eng.stats()
    assert stats["kv_pages_free"] == stats["pages_free"] and stats["spec"]["spec_k"] == 3
    assert plain.stats()["spec"] is None
    for budget in (1, 2):
        spec = SlotEngine(lm["model"], lm["params"], draft_model=lm["draft"],
                          draft_params=lm["dparams"], spec_k=3, **kw)
        assert run_one(spec, lm["a"], budget) == lm["ref_a"][:budget]


def test_sampled_engines_are_seeded_deterministic(lm):
    """temperature > 0: the host sampler draws from the engine's seeded
    stream, with and without a drafter."""
    def run(seed, spec):
        kw = (dict(draft_model=lm["draft"], draft_params=lm["dparams"], spec_k=2)
              if spec else {})
        eng = SlotEngine(lm["model"], lm["params"], slots=1, max_len=MAX_LEN,
                         prefill_chunk=4, page_size=4, temperature=2.0, seed=seed, **kw)
        return run_one(eng, lm["a"], 8)

    for spec in (False, True):
        assert run(5, spec) == run(5, spec)
        assert run(5, spec) != run(6, spec)


def test_decode_benchmark_on_the_cpu_returns_the_reference_fields():
    result = bench.run_benchmark(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32,
                                 prompt_len=8, new_tokens=6, batch=2, repeats=1,
                                 cache_int8=True, int8=True, num_chips=1, device="cpu")
    for key in ("tokens_per_sec", "tokens_per_sec_per_chip", "ms_per_token_per_stream",
                "seconds_median", "compile_seconds", "decode_tokens_per_sec"):
        assert result[key] > 0, key
    assert (result["platform"], result["device_kind"], result["num_chips"]) == ("cpu", "cpu", 1)
    assert result["peak_memory_gb"] is None and result["cache_int8"] and result["int8"]
    # more cards are more ranks (tests/test_torch_decode_mesh.py): one process is one
    with pytest.raises(ValueError, match="num_chips=2: decode runs on the process group's 1"):
        bench.run_benchmark(num_chips=2, device="cpu")
    with pytest.raises(ValueError, match="num_chips=2: the engine runs on"):
        bench.run_engine_benchmark(num_chips=2, device="cpu")


def test_engine_benchmark_on_the_cpu_is_exact():
    result = bench.run_engine_benchmark(
        vocab_size=64, num_layers=2, num_heads=2, embed_dim=32, max_len=64, prompt_len=32,
        shared_prefix_len=24, new_tokens=4, requests=3, slots=2, page_size=8,
        prefill_chunk=16, cache_int8=True, spec_new_tokens=8, device="cpu")
    assert result["token_identical"] and result["speculative"]["token_identical"]
    assert result["shared_prefix_reprefilled_on_hits"] == 0
    assert result["warm"]["prefix"]["hits"] >= 3
    assert result["warm"]["prefill_tokens"] < result["cold"]["prefill_tokens"]
    assert [m["name"] for m in result["modes"]] == ["cold", "warm", "spec_base", "spec"]
    assert result["speculative"]["acceptance_rate"] >= 0.8
    assert {"value", "passes", "platform", "device_kind", "peak_memory_gb"} <= set(result)
