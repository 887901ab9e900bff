"""The port's real-text corpus (`utils/corpus.py`), benchmark comparison
tables (`utils/benchcompare.py`) and host benchmark
(`benchmarks/containerbench.py`) against the JAX package's copies, and the
worked example of docs/detailed.md ("Training on real text") at a tiny
size through both packages.

- corpus: the same ids, splits, windows and `ValueError` messages;
- benchcompare: the same rows, markdown, guard verdicts, printed output
  and exit codes, on BENCH_r01.json-BENCH_r05.json and on crafted records
  (the BENCH_r{N}.json envelope with and without `parsed`, a raw bench line, a
  failed family, an unreadable file, a regression);
- containerbench: the same md5 stream, and the CLI's `--json` records,
  `disk` then `cpu`;
- the worked example: this repo's README as bytes, a 2-layer f32 LM
  (2 heads, embed 64, seq 64) from JAX's initial weights carried over by
  `utils/convert`, five steps of `lm_optimizer` through
  `prefetch_to_mesh` on a one-rank gloo mesh; each step's loss and the
  held-out loss within tests/test_torch_lm_train.py's tolerance of JAX's
  (rtol 1e-5, atol 1e-5), perplexity below 256, and greedy `generate`
  token for token equal to JAX's on JAX's trained weights carried over and
  on the port's own (five steps leave a crude model: the reference's
  non-degeneracy check, after 40 steps, is the card's in phase 34, at
  full width). The JAX side's loss
  runs its Pallas kernel in interpret mode, as tests/test_parallel.py
  does.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tritonk8ssupervisor_tpu.benchmarks import containerbench as ref_containerbench
from tritonk8ssupervisor_tpu.utils import benchcompare as ref_benchcompare
from tritonk8ssupervisor_tpu.utils import corpus as ref_corpus
from tritonk8ssupervisor_tpu_torch.benchmarks import containerbench
from tritonk8ssupervisor_tpu_torch.utils import benchcompare, corpus

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = sorted(ROOT.glob("BENCH_r0*.json"))
TEXTS = ["", "plain ascii", "naïve — ünïcode ✓ 漢字", "line\nbreaks\tand\0nul"]


def readme_ids() -> np.ndarray:
    return corpus.ByteTokenizer().encode((ROOT / "README.md").read_text())


# ----------------------------------------------------------------- corpus


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_equals_the_reference(text):
    ours, ref = corpus.ByteTokenizer(), ref_corpus.ByteTokenizer()
    assert ours.vocab_size == ref.vocab_size == 256
    for value in (text, text.encode("utf-8")):
        ids = ours.encode(value)
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, ref.encode(value))
        assert ours.decode(ids) == ref.decode(ids) == text
    broken = np.array([0xE2, 0x82, 65, 0xFF], dtype=np.int32)  # torn and invalid UTF-8
    assert ours.decode(broken) == ref.decode(broken)


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5, 0.999])
def test_train_val_split_equals_the_reference(fraction):
    ids = readme_ids()
    for stream in (ids, ids[:7], ids[:1]):
        ours, ref = corpus.train_val_split(stream, fraction), ref_corpus.train_val_split(stream,
                                                                                      fraction)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    train, val = corpus.train_val_split(ids, fraction)
    np.testing.assert_array_equal(np.concatenate([train, val]), ids)


def test_batches_equal_the_reference_per_seed():
    train, _ = corpus.train_val_split(readme_ids(), 0.1)
    for seed, (b, s, steps) in enumerate([(8, 64, 3), (1, 16, 5), (32, 1024, 2)]):
        ours = list(corpus.batches(train, b, s, steps=steps, seed=seed))
        ref = list(ref_corpus.batches(train, b, s, steps=steps, seed=seed))
        assert len(ours) == steps
        for a, r in zip(ours, ref):
            assert a.shape == (b, s) and a.dtype == np.int32
            np.testing.assert_array_equal(a, r)
    endless = corpus.batches(train, 2, 8, seed=7)
    ref_endless = ref_corpus.batches(train, 2, 8, seed=7)
    for _ in range(50):
        np.testing.assert_array_equal(next(endless), next(ref_endless))
    exact = np.arange(9, dtype=np.int32)  # seq_len + 1 tokens: the shortest corpus
    np.testing.assert_array_equal(next(corpus.batches(exact, 3, 8)),
                                  next(ref_corpus.batches(exact, 3, 8)))


@pytest.mark.parametrize("call", [
    lambda m, ids: m.train_val_split(ids, 0.0),
    lambda m, ids: m.train_val_split(ids, 1.0),
    lambda m, ids: m.train_val_split(ids, 1.5),
    lambda m, ids: m.train_val_split(ids, -0.1),
    lambda m, ids: next(m.batches(ids[:4], 1, 16)),
    lambda m, ids: next(m.batches(ids[:16], 2, 16)),
], ids=["zero", "one", "above-one", "negative", "short", "one-short"])
def test_errors_equal_the_reference(call):
    ids = readme_ids()
    messages = []
    for m in (corpus, ref_corpus):
        with pytest.raises(ValueError) as info:
            call(m, ids)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


# ----------------------------------------------------------- benchcompare


def crafted_records(tmp_path) -> list:
    """Bench files of every shape `load_records` takes, and a few it
    cannot read, in the order a guard run would see them."""
    line = {"metric": "lm_tokens_per_sec", "value": 1000.0, "unit": "tokens/s",
            "vs_baseline": 1.0, "step_ms": 50.0, "mfu": 0.4}
    docs = {
        "a_raw.json": line,
        "b_parsed.json": {"cmd": "bench", "rc": 0, "tail": "", "parsed": dict(line, value=1040.0)},
        "c_tail.json": {"cmd": "bench", "rc": 0, "parsed": None,
                        "tail": "noise\n" + json.dumps(dict(line, value=900.0)) + "\n"},
        "d_families.json": {"benchmarks": [dict(line, value=960.0),
                                           {"metric": "resnet", "value": 10, "unit": "img/s"},
                                           {"metric": "vit", "error": "timed out"}]},
        "e_empty_tail.json": {"cmd": "bench", "rc": 1, "tail": "no json here", "parsed": {}},
        "f_drop.json": {"metric": "resnet", "value": 9, "unit": "img/s"},
    }
    paths = []
    for name, doc in docs.items():
        path = tmp_path / name
        path.write_text(json.dumps(doc))
        paths.append(path)
    bad = tmp_path / "g_broken.json"
    bad.write_text("{not json")
    return paths + [bad, tmp_path / "h_missing.json"]


@pytest.mark.parametrize("which", ["rounds", "crafted"])
def test_benchcompare_rows_markdown_and_guard_equal_the_reference(tmp_path, which):
    paths = ROUNDS if which == "rounds" else crafted_records(tmp_path)
    if which == "rounds":
        assert len(paths) == 5
        for path in paths:
            assert benchcompare.load_records(path) == ref_benchcompare.load_records(path)
    rows = benchcompare.comparison_rows(paths)
    assert rows == ref_benchcompare.comparison_rows(paths)
    assert benchcompare.to_markdown(rows) == ref_benchcompare.to_markdown(rows)
    for tolerance in (0.0, 0.05, 0.2):
        problems = benchcompare.guard_regressions(rows, tolerance)
        assert problems == ref_benchcompare.guard_regressions(rows, tolerance)
    assert benchcompare.guard_regressions(rows)  # both sets hold a failure or a drop


@pytest.mark.parametrize("flags", [[], ["--json"], ["--guard"], ["--guard", "--tolerance", "0.5"],
                                   ["--json", "--guard"]])
def test_benchcompare_cli_equals_the_reference(tmp_path, capsys, flags):
    crafted = crafted_records(tmp_path)
    for files in ([str(p) for p in ROUNDS], [str(p) for p in crafted],
                  [str(ROUNDS[0]), str(ROUNDS[2])]):
        got = benchcompare.main(files + flags)
        ours = capsys.readouterr().out
        want = ref_benchcompare.main(files + flags)
        assert ours == capsys.readouterr().out
        assert got == want
    assert benchcompare.main([str(ROUNDS[0]), str(ROUNDS[2]), "--guard"]) == 0  # r01 -> r03 rose


def test_benchcompare_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    args = [str(p) for p in ROUNDS] + ["--guard"]
    runs = [subprocess.run([sys.executable, "-m", f"{package}.utils.benchcompare", *args],
                           cwd=ROOT, capture_output=True, text=True, timeout=120)
            for package in ("tritonk8ssupervisor_tpu_torch", "tritonk8ssupervisor_tpu")]
    assert runs[0].returncode == runs[1].returncode == 1  # r05 failed
    assert runs[0].stdout == runs[1].stdout
    assert "REGRESSION: BENCH_r05.json" in runs[0].stdout


# ---------------------------------------------------------- containerbench


@pytest.mark.parametrize("mib", [13, 16, 5])
def test_cpu_benchmark_md5_equals_the_reference(mib):
    size = mib << 20
    ours, ref = containerbench.cpu_benchmark(size), ref_containerbench.cpu_benchmark(size)
    assert ours["md5"] == ref["md5"]
    assert (ours["workload"], ours["bytes"]) == (ref["workload"], ref["bytes"]) == ("cpu", size)
    assert ours["seconds"] > 0 and ours["mb_per_sec"] == pytest.approx(size / 1e6
                                                                       / ours["seconds"])
    assert containerbench.cpu_benchmark(size, seed=3)["md5"] == ref_containerbench.cpu_benchmark(
        size, seed=3)["md5"] != ours["md5"]
    # the md5 of the LCG stream, written out here from its definition
    rng, digest, done = 0, hashlib.md5(), 0
    while done < size:
        n = min(4 << 20, size - done)
        rng = (rng * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
        digest.update((rng.to_bytes(8, "little") * ((n + 7) // 8))[:n])
        done += n
    assert ours["md5"] == digest.hexdigest()


def test_containerbench_cli_prints_disk_then_cpu(tmp_path, capsys):
    args = ["--disk-bytes", str(3 << 20), "--cpu-bytes", str(5 << 20), "--workdir", str(tmp_path)]
    assert containerbench.main(args + ["--json"]) == 0
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["workload"] for r in records] == ["disk", "cpu"]
    assert [r["bytes"] for r in records] == [3 << 20, 5 << 20]
    assert records[1]["md5"] == ref_containerbench.cpu_benchmark(5 << 20)["md5"]
    assert list(tmp_path.iterdir()) == []  # the disk file is removed
    assert ref_containerbench.main(args + ["--json"]) == 0
    ref_records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [sorted(r) for r in records] == [sorted(r) for r in ref_records]
    assert containerbench.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" ")[0] for line in lines] == ["/disk", "/cpu"]
    assert all(line.endswith(" MB/s") for line in lines)


# ------------------------------------------------- the worked example, tiny


WORKED = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=64, max_seq_len=64)
WORKED_BATCH, WORKED_STEPS = 8, 5
WORKED_OPT = dict(learning_rate=3e-3, warmup_steps=2, decay_steps=40)
PROMPT = "# TPU Cluster"


def jax_worked_example(train_ids, val_ids):
    """The worked example through the JAX package: initial variables, the
    losses of five steps, the held-out loss, and the trained parameters."""
    import jax
    import jax.numpy as jnp

    from tritonk8ssupervisor_tpu.models import TransformerLM as JaxLM
    from tritonk8ssupervisor_tpu.ops.cross_entropy import (
        cross_entropy_loss_and_correct_interpret,
    )
    from tritonk8ssupervisor_tpu.parallel import batch_sharding
    from tritonk8ssupervisor_tpu.parallel import mesh as mesh_lib
    from tritonk8ssupervisor_tpu.parallel import train as jax_train
    from tritonk8ssupervisor_tpu.utils import data as jax_data

    model = JaxLM(**WORKED, dtype=jnp.float32, logits_dtype=jnp.float32)
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    tx = jax_train.lm_optimizer(**WORKED_OPT)
    state, shardings = jax_train.create_train_state(
        model, jax.random.key(0), jax.ShapeDtypeStruct((WORKED_BATCH, 64), jnp.int32), mesh, tx)
    initial = jax.device_get(state.params)
    step = jax_train.make_lm_train_step(model, tx, mesh, shardings,
                                        metrics_fn=cross_entropy_loss_and_correct_interpret)
    eval_step = jax_train.make_lm_eval_step(model, mesh, shardings,
                                            metrics_fn=cross_entropy_loss_and_correct_interpret)
    val = jax.device_put(next(ref_corpus.batches(val_ids, WORKED_BATCH, 64, seed=1)),
                         batch_sharding(mesh, 2))
    val_before = float(eval_step(state, val)["loss"])
    losses = []
    for tokens in jax_data.prefetch_to_mesh(
            ref_corpus.batches(train_ids, WORKED_BATCH, 64, steps=WORKED_STEPS),
            batch_sharding(mesh, 2)):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
    return model, initial, losses, val_before, float(eval_step(state, val)["loss"]), \
        jax.device_get(state.params)


def test_worked_example_matches_jax_at_a_tiny_size(tmp_path):
    import jax.numpy as jnp

    from tritonk8ssupervisor_tpu.models import decode as jax_dec
    from tritonk8ssupervisor_tpu_torch.models import TransformerLM
    from tritonk8ssupervisor_tpu_torch.models import decode as dec
    from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
    from tritonk8ssupervisor_tpu_torch.parallel import train
    from tritonk8ssupervisor_tpu_torch.utils import data
    from tritonk8ssupervisor_tpu_torch.utils.convert import state_dict_from_flax

    tok = corpus.ByteTokenizer()
    train_ids, val_ids = corpus.train_val_split(readme_ids(), val_fraction=0.1)
    jmodel, initial, jlosses, jval_before, jval_after, jtrained = jax_worked_example(
        train_ids, val_ids)

    model = TransformerLM(**WORKED, dtype=torch.float32, logits_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax({"params": initial}, model))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_mesh(device_type="cpu")
        state = train.create_train_state(model, train.lm_optimizer(**WORKED_OPT), mesh=mesh)
        step = train.make_lm_train_step(state)
        eval_step = train.make_lm_eval_step(state)
        val = torch.from_numpy(next(corpus.batches(val_ids, WORKED_BATCH, 64, seed=1)))
        val_before = float(eval_step(val)["loss"])
        losses = [float(step(tokens)["loss"]) for tokens in data.prefetch_to_mesh(
            corpus.batches(train_ids, WORKED_BATCH, 64, steps=WORKED_STEPS), mesh)]
        val_after = float(eval_step(val)["loss"])
    finally:
        dist.destroy_process_group()

    assert len(losses) == WORKED_STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([val_before, val_after], [jval_before, jval_after],
                               rtol=1e-5, atol=1e-5)
    assert losses[-1] < losses[0] and val_after < val_before
    ppl = float(np.exp(val_after))
    assert np.isfinite(ppl) and ppl < 256.0  # better than uniform over the byte vocab

    # serving the trained weights: JAX's trained parameters carried over,
    # greedy decode token for token; then the port's own trained weights
    prompt = tok.encode(PROMPT)[None, :]
    want = np.asarray(jax_dec.generate(jmodel, jtrained, jnp.asarray(prompt), 32))
    carried = TransformerLM(**WORKED, dtype=torch.float32, logits_dtype=torch.float32)
    carried.load_state_dict(state_dict_from_flax({"params": jtrained}, carried))
    got = dec.generate(carried, dec.lm_params(carried, "cpu"), torch.from_numpy(prompt), 32)
    np.testing.assert_array_equal(got.numpy(), want)
    ours = dec.generate(state.model, dec.lm_params(state.model, "cpu"),
                        torch.from_numpy(prompt), 32)
    np.testing.assert_array_equal(ours.numpy(), want)
    assert isinstance(tok.decode(ours.numpy()[0]), str)


def test_the_card_worked_example_corpus_holds_its_windows():
    """chip_smoke.py's phase 34 corpus (`worked_example_ids`: docs/*.md in
    sorted name order, files that predate the port and are never edited):
    both splits hold a window of the phase's batch and sequence length,
    and `worked_example_prompt` finds its held-out prose line."""
    import chip_smoke

    ids = chip_smoke.worked_example_ids()
    docs = sorted((ROOT / "docs").glob("*.md"))
    assert len(ids) == sum(p.stat().st_size for p in docs)
    train_ids, val_ids = corpus.train_val_split(ids, val_fraction=0.1)
    batch, seq = chip_smoke.WORKED_BATCH, chip_smoke.WORKED_LM["max_seq_len"]
    assert len(val_ids) > seq + 1 and len(train_ids) > 9 * len(val_ids) - 9
    assert next(corpus.batches(val_ids, batch, seq, seed=0)).shape == (batch, seq)
    prompt = chip_smoke.worked_example_prompt(val_ids)
    assert len(prompt) == chip_smoke.WORKED_PROMPT
    text = prompt.astype(np.uint8).tobytes()
    assert text[:1].isupper() and b"\n" not in text
    assert text in val_ids.astype(np.uint8).tobytes()
