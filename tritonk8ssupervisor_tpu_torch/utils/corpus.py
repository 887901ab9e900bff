"""Real-text corpus -> LM training batches: the missing first mile.

The benchmarks synthesize tokens on device by design (they measure the
training computation); a user training on an actual corpus needs the
three pieces here, and nothing else — they compose directly with
`utils/data.prefetch_to_mesh` and the `parallel/train.py` step
factories (worked example: docs/detailed.md §"Training on real text";
held against the reference by tests/test_torch_corpus.py, and run at
full width on the card by chip_smoke.py's phase 34):

- `ByteTokenizer` — the zero-dependency tokenizer: UTF-8 bytes ARE the
  ids (vocab 256). No merges file, no external model, loss-free
  round-trip for any input. The right default for a worked example and
  a respectable baseline (byte-level GPT); anything fancier (BPE et
  al.) produces the same (N,) int32 array and slots into the same two
  functions below.
- `train_val_split` — held-out tail split so the perplexity loop
  evaluates on bytes the model never saw.
- `batches` — (B, S)-shaped random-crop windows from the id stream,
  host NumPy, ready for `prefetch_to_mesh`/`global_batch_from_local`.
  Plain (B, S): the LM step computes next-token loss by shifting
  WITHIN the window and masking the final position
  (`make_lm_train_step`), so the window arithmetic stays here and the
  model sees exactly what the benchmarks feed it.

The reference framework had no data plane at all (SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes as token ids. vocab_size 256, exact round-trip."""

    vocab_size = 256

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return np.frombuffer(data, dtype=np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        arr = np.asarray(ids).astype(np.uint8)
        return arr.tobytes().decode("utf-8", errors="replace")


def train_val_split(
    ids: np.ndarray, val_fraction: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Split an id stream into (train, val) — the val set is the TAIL
    (contiguous text, not shuffled windows: perplexity on shuffled
    windows of seen text is self-grading)."""
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(f"val_fraction must be in (0, 1), got {val_fraction}")
    split = max(1, int(len(ids) * (1.0 - val_fraction)))
    return ids[:split], ids[split:]


def batches(
    ids: np.ndarray,
    batch_size: int,
    seq_len: int,
    steps: int | None = None,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Yield `steps` (or unbounded) (batch_size, seq_len) int32 windows
    sampled uniformly from the id stream — the standard random-crop LM
    regime (every epoch boundary is a reshuffle by construction). Host
    NumPy; wrap with data.prefetch_to_mesh(it, mesh) so the host->device
    copy overlaps compute, or with data.global_batch_from_local on a
    multi-host deployment where each process samples its own shard.
    """
    if len(ids) < seq_len + 1:
        raise ValueError(
            f"corpus has {len(ids)} tokens; need at least seq_len + 1 = "
            f"{seq_len + 1} (shorter corpora: reduce seq_len)"
        )
    rng = np.random.default_rng(seed)
    produced = 0
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    max_start = len(ids) - seq_len
    while steps is None or produced < steps:
        starts = rng.integers(0, max_start + 1, size=batch_size)
        yield np.stack([ids[s:s + seq_len] for s in starts])
        produced += 1
