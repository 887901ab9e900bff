"""Continuous-batching decode engine over paged KV slots with cross-request
prefix reuse and speculative decoding: the port of
`tritonk8ssupervisor_tpu/serving/engine.py::SlotEngine` (:108-1035).

Each of a fixed number of slots runs its own request, joining, decoding and
leaving at step boundaries independently. K/V lives in a pool of
fixed-size pages (`models/decode.init_kv_pool`), and each slot maps
logical token positions onto pages through a per-slot page table
(host-side, numpy) whose last column is a sentinel pointing at the pool's
trash page:

- a slot holds pages for its own span only, and a shared prompt prefix is
  one set of pages, matched through the `PrefixStore` (`serving/kvpool.py`)
  and mapped copy-free (refcounted); prefill then starts at the first
  unshared token, and at least one suffix token always re-prefills;
- inactive rows (empty slots, slots mid-prefill) park their writes on the
  trash page, which nothing attends;
- a prefill chunk's own positions attend their fresh full-precision K/V;
  decode and verify steps read K/V back from the pool;
- a drafter (`draft_model=`, `draft_params=`, `spec_k=`) proposes `spec_k`
  tokens a round, and the target scores all `spec_k + 1` window positions
  in one forward; acceptance is exact (`models/decode.speculative_accept`)
  on the host, so greedy output is token-identical to plain decoding. The
  drafter's pool shadows the target's page for page; after an all-accept
  round the drafter's K/V at the last accepted position is backfilled
  before the next round proposes.

The reference's three `jax.jit` closures are plain calls here
(`_prefill_chunk_paged`, `_decode_step_paged`, `_verify_window_paged`) on
the device that holds the parameters; the host state (`tables`, `pos`,
`last`, `active`) stays in numpy and is shipped each step, with the page
and offset indices computed from it on the host. The page gathers and
scatters are torch index operations. Every int8-cache attention of a
decode, drafter or verify step goes through
`ops/decode_attention.decode_attention_int8` with `layout="paged"`: the
pool and the slots' page tables (cut to `max_pages` columns, int32) with
per-slot (decode) or per-query (verify) positions, so kernel K3 reads the
pages on the card and nothing gathers the int8 pool. The bf16 cache and
the prefill chunk gather each slot's logical view and stay plain torch in
the reference's order.

Positions past `max_seq_len` (only over-budget speculative candidates,
whose emissions the host truncates, reach them) read the last position
embedding: the reference's `jnp.take` there fills NaN.

With a `tracer=` (`obs/trace.Tracer`, wired by `cli.main serve`), each
prefill chunk is one `"prefill-chunk"` span on the tracer's clock, with
the request's key, rid, slot, `slice_index`, first token and token count,
as the reference's. The span reads the tracer's clock around the chunk's
calls and adds no synchronisation of its own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.obs.trace import Tracer
from tritonk8ssupervisor_tpu_torch.ops.decode_attention import decode_attention_int8
from tritonk8ssupervisor_tpu_torch.serving import kvpool
from tritonk8ssupervisor_tpu_torch.serving.gateway import Request, StepResult


def _ship(device, *arrays):
    """Host numpy arrays as tensors on `device` (int64 for indices, int32
    positions and bool masks keep their dtype)."""
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays]


def _logits_host(logits) -> np.ndarray:
    return logits.float().cpu().numpy().astype(np.float64)


class SlotEngine:
    """Slot-based continuous batching for a port `TransformerLM` and its
    parameter tree (`models/decode.lm_params`), on the parameters' device.
    Implements the gateway's engine surface: join/step/release/reset/
    busy_slots, plus the paged-KV capacity surface (can_join/stats)."""

    # a real decode engine serves content, not sizes: a request whose prompt
    # tokens are unknown cannot be re-admitted
    requires_tokens = True

    def __init__(self, model, params, slots: int, max_len: int,
                 prefill_chunk: int = 32, page_size: int = 32,
                 num_pages: int | None = None,
                 cache_int8: bool = False,
                 prefix_cache: bool = True,
                 draft_model=None, draft_params=None, spec_k: int = 0,
                 temperature: float = 0.0, seed: int = 0,
                 tracer: Tracer | None = None,
                 slice_index: int | None = None) -> None:
        if max_len > model.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds model.max_seq_len "
                f"{model.max_seq_len} (no position embeddings past it)"
            )
        if spec_k and (draft_model is None or draft_params is None):
            raise ValueError(
                "spec_k > 0 needs a draft_model AND draft_params "
                "(a smaller models/ config; quantize_params_int8 "
                "applies to it like any LM tree)"
            )
        if draft_model is not None and max_len > draft_model.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds draft_model.max_seq_len "
                f"{draft_model.max_seq_len} (the drafter decodes the "
                "same positions the target does)"
            )
        if (draft_model is not None
                and draft_model.vocab_size != model.vocab_size):
            raise ValueError(
                "draft and target models must share a vocabulary "
                f"({draft_model.vocab_size} != {model.vocab_size}): "
                "acceptance compares token ids"
            )
        self.model = model
        self.params = params
        self.device = params["pos_embed"].device
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.page_size = max(1, int(page_size))
        self.max_pages = -(-self.max_len // self.page_size)
        # memory-equal default: the pool holds exactly what a dense
        # [slots, max_len] cache would
        self.num_pages = (int(num_pages) if num_pages is not None
                          else self.slots * self.max_pages)
        self.cache_int8 = bool(cache_int8)
        self.trash = self.num_pages  # parking page for masked writes
        self.pool = dec.init_kv_pool(model, self.num_pages + 1, self.page_size,
                                     int8=self.cache_int8, device=self.device)
        self.pages = kvpool.PagePool(self.num_pages, self.page_size)
        self.prefix = (kvpool.PrefixStore(self.pages)
                       if prefix_cache else None)
        # per-slot page tables; one sentinel column past max_pages so the
        # clamp min(p // ps, max_pages) parks out-of-range writes on trash
        self.tables = np.full((self.slots, self.max_pages + 1),
                              self.trash, np.int64)
        # host-side per-slot decode state, shipped each step
        self.pos = np.zeros((self.slots,), np.int32)
        self.last = np.zeros((self.slots,), np.int32)
        self.active = np.zeros((self.slots,), bool)
        # drafter catch-up: after an all-accept round the drafter proposed
        # d_k but never embedded it, so its K/V at the last accepted
        # position is a hole the next round backfills before proposing
        self._catchup_need = np.zeros((self.slots,), bool)
        self._catchup_tok = np.zeros((self.slots,), np.int32)
        self._catchup_pos = np.zeros((self.slots,), np.int32)
        self._requests: dict = {}  # slot -> {tokens, done, budget, out, ...}
        self._prefill_rr = 0
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.spec_k = int(spec_k) if draft_model is not None else 0
        self.spec = self.spec_k >= 1
        self.temperature = float(temperature)
        self._rng = np.random.default_rng(int(seed))
        # the drafter's pool shadows the target's page for page: same page
        # count and size, its own storage, the same tables
        self.draft_pool = (dec.init_kv_pool(draft_model, self.num_pages + 1,
                                            self.page_size, int8=self.cache_int8,
                                            device=self.device)
                           if self.spec else None)
        self.joins = 0
        self.steps = 0  # step boundaries that did work
        self.prefill_tokens = 0  # prompt tokens actually processed
        self.peak_slots_busy = 0
        self.spec_rounds = 0
        self.spec_drafted = 0  # drafter proposals offered to verify
        self.spec_accepted = 0  # proposals that survived
        self.spec_rolled_back = 0  # proposals truncated by a reject
        # per-chunk prefill spans; a disabled tracer costs one attribute
        # test a chunk
        self._tracer = tracer if tracer is not None else Tracer(None)
        self._slice_index = slice_index

    # ------------------------------------------------------- step bodies

    def _prefill(self, model, params, pool, chunk, slot, start, last_row):
        return _prefill_chunk_paged(model, params, pool, chunk, self.tables[slot], start,
                                    last_row, self.prefill_chunk, self.page_size,
                                    self.max_pages, self.cache_int8)

    def _decode(self, model, params, pool, last, pos, active):
        return _decode_step_paged(model, params, pool, self.tables, last, pos, active,
                                  self.page_size, self.max_pages, self.trash,
                                  self.cache_int8)

    # ------------------------------------------------------- page plumbing

    def _span_pages(self, prompt_len: int, max_new: int,
                    shared_blocks: int) -> int:
        """Total pages a slot needs: the larger of the padded prefill reach
        and prompt + budget, plus the speculative window when a drafter is
        wired, clamped to the table (writes past max_len park on trash)."""
        start0 = shared_blocks * self.page_size
        suffix = max(1, prompt_len - start0)
        prefill_end = start0 + -(-suffix // self.prefill_chunk) \
            * self.prefill_chunk
        reach = prompt_len + max_new + (self.spec_k if self.spec else 0)
        span = min(max(prefill_end, reach),
                   self.max_pages * self.page_size)
        return min(-(-span // self.page_size), self.max_pages)

    def _alloc(self, need: int) -> list | None:
        got = self.pages.alloc(need)
        if got is None and self.prefix is not None:
            self.prefix.evict_for(need - self.pages.pages_free)
            got = self.pages.alloc(need)
        return got

    def can_join(self, request: Request) -> bool:
        """Whether a join for this request would find pages right now (free
        plus evictable from the store): admission is in pages, not slots."""
        n = int(request.prompt_len)
        shared = 0
        if self.prefix is not None and request.tokens is not None:
            cap = kvpool.match_cap_blocks(n, self.page_size)
            keys = kvpool.token_block_keys(request.tokens,
                                           self.page_size, cap)
            shared = self.prefix.peek(keys)
        need = self._span_pages(n, int(request.max_new_tokens),
                                shared) - shared
        budget = self.pages.pages_free
        if self.prefix is not None:
            budget += self.prefix.evictable_pages()
        return need <= budget

    # ------------------------------------------------------------- surface

    def busy_slots(self) -> int:
        return len(self._requests)

    def join(self, slot: int, request: Request) -> None:
        """Claim `slot` for a request at a step boundary, seeding its page
        table from the prefix store's longest match so prefill only
        processes the unshared suffix. The prompt must fit and the pool
        must hold the pages (the caller checked can_join); a violation is
        a programming error, not traffic."""
        if slot in self._requests:
            raise ValueError(f"slot {slot} already occupied")
        if request.tokens is None:
            raise ValueError(
                f"request {request.rid} carries no prompt tokens"
            )
        tokens = np.asarray(request.tokens, np.int32)
        n = int(tokens.size)
        if n + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {n} + new {request.max_new_tokens} "
                f"exceeds cache {self.max_len}"
            )
        keys = kvpool.token_block_keys(
            tokens, self.page_size, kvpool.full_blocks(n, self.page_size)
        )
        shared_n, shared_pages = 0, []
        if self.prefix is not None:
            cap = kvpool.match_cap_blocks(n, self.page_size)
            shared_n, shared_pages = self.prefix.match(keys[:cap])
        total = self._span_pages(n, int(request.max_new_tokens), shared_n)
        # the slot's refs land before any eviction could free the matched
        # pages out from under it
        self.pages.ref(shared_pages)
        private = self._alloc(total - shared_n)
        if private is None:
            self.pages.unref(shared_pages)
            raise RuntimeError(
                f"page pool exhausted: slot {slot} needs "
                f"{total - shared_n} pages, {self.pages.pages_free} free "
                f"(gateway admission should have refused the claim)"
            )
        row = self.tables[slot]
        row[:] = self.trash
        row[:shared_n] = shared_pages
        row[shared_n:total] = private
        self._requests[slot] = {
            "tokens": tokens,
            "done": shared_n * self.page_size,  # prefix pages: prefilled
            "budget": int(request.max_new_tokens),
            "out": [],
            "key": request.key,
            "rid": request.rid,
            "keys": keys,
            "pages": list(shared_pages) + list(private),
            # nothing to register when every full-prompt block matched
            "registered": shared_n >= len(keys),
        }
        self.active[slot] = False
        self.pos[slot] = 0
        self._catchup_need[slot] = False
        self.joins += 1
        self.peak_slots_busy = max(self.peak_slots_busy,
                                   len(self._requests))

    def release(self, slot: int) -> None:
        st = self._requests.pop(slot, None)
        if st is not None:
            self.pages.unref(st["pages"])
            self.tables[slot][:] = self.trash
        self.active[slot] = False
        self._catchup_need[slot] = False

    def reset(self) -> None:
        """Drop every request and flush the prefix store (a reset wipes the
        cache content the store's pages point at); leaves zero pages in
        use."""
        for slot in list(self._requests):
            self.release(slot)
        if self.prefix is not None:
            self.prefix.flush()
        self.tables[:] = self.trash
        self.active[:] = False
        self.pos[:] = 0
        self._catchup_need[:] = False

    def stats(self) -> dict:
        """The paged-KV and prefix observability block."""
        in_use = self.pages.pages_in_use
        out = {
            "page_size": self.page_size,
            "pages_total": self.num_pages,
            "pages_in_use": in_use,
            "pages_free": self.pages.pages_free,
            "kv_pages_free": self.pages.pages_free,
            "kv_utilization": round(in_use / self.num_pages, 4),
            "peak_pages_in_use": self.pages.peak_in_use,
            "peak_slots_busy": self.peak_slots_busy,
            "joins": self.joins,
            "steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "cache_int8": self.cache_int8,
        }
        out["prefix"] = (self.prefix.stats() if self.prefix is not None
                         else None)
        out["spec"] = self.spec_stats()
        return out

    def spec_stats(self) -> dict | None:
        """The speculative-decoding block (None without a drafter):
        proposal, acceptance and rollback counters and the acceptance
        rate."""
        if not self.spec:
            return None
        return {
            "spec_k": self.spec_k,
            "rounds": self.spec_rounds,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "rolled_back": self.spec_rolled_back,
            "acceptance_rate": (round(self.spec_accepted
                                      / self.spec_drafted, 4)
                                if self.spec_drafted else None),
        }

    def _sample(self, logits) -> int:
        """One host-side draw from softmax(logits / T) on the engine's
        seeded stream."""
        probs = dec.softmax_np(logits, self.temperature)[None]
        return int(self._rng.choice(probs.shape[-1], p=probs[0]))

    def _finish(self, slot: int, st: dict, finished: dict) -> None:
        """Terminal bookkeeping for a slot whose budget filled. In
        speculative mode the span was allocated `spec_k` tokens past
        prompt + budget; those overhang pages go back to the pool now
        (`release_span` truncates the slot's page list, so the final
        `release` cannot double-unref)."""
        self.active[slot] = False
        finished[slot] = list(st["out"])
        if self.spec:
            need = -(-(st["tokens"].size + st["budget"])
                     // self.page_size)
            if len(st["pages"]) > need:
                self.pages.release_span(st["pages"], need)
                self.tables[slot][need:] = self.trash

    def step(self) -> StepResult | None:
        """One step boundary: one prefill chunk (round-robin) and one decode
        round for every active slot: a single greedy or sampled token each,
        or a drafter-propose / target-verify round emitting `accepted + 1`
        tokens each when a drafter is wired. dt=0.0: the caller's clock
        measures the step."""
        if not self._requests:
            return None
        emitted: dict = {}
        finished: dict = {}
        tokens: dict = {}
        prefilling = sorted(s for s, st in self._requests.items()
                            if st["done"] < st["tokens"].size)
        if prefilling:
            slot = prefilling[self._prefill_rr % len(prefilling)]
            self._prefill_rr += 1
            st = self._requests[slot]
            start = st["done"]
            remaining = st["tokens"].size - start
            take = min(self.prefill_chunk, remaining)
            chunk = np.zeros((self.prefill_chunk,), np.int64)  # padded
            chunk[:take] = st["tokens"][start:start + take]
            t0 = self._tracer.now() if self._tracer.enabled else 0.0
            logits = self._prefill(self.model, self.params, self.pool, chunk, slot,
                                   start, take - 1)
            if self.spec:
                # the drafter shadows the target chunk for chunk
                self._prefill(self.draft_model, self.draft_params, self.draft_pool,
                              chunk, slot, start, take - 1)
            if self._tracer.enabled:
                self._tracer.emit(
                    "prefill-chunk", t0, self._tracer.now(),
                    key=st["key"], rid=st["rid"], slot=slot,
                    slice=self._slice_index, start_token=start,
                    tokens=take,
                )
            st["done"] += take
            self.prefill_tokens += take
            if st["done"] >= st["tokens"].size:
                if not st["registered"] and self.prefix is not None:
                    # the full-prompt pages now hold real K/V
                    self.prefix.register(
                        st["keys"],
                        self.tables[slot][:len(st["keys"])],
                    )
                    st["registered"] = True
                # the final chunk's logits are the first generated token
                logits_host = _logits_host(logits)
                first = (self._sample(logits_host)
                         if self.temperature > 0
                         else int(np.argmax(logits_host)))
                st["out"].append(first)
                self.last[slot] = first
                self.pos[slot] = st["tokens"].size
                self.active[slot] = True
                emitted[slot] = 1
                tokens[slot] = [first]
                if len(st["out"]) >= st["budget"]:
                    self._finish(slot, st, finished)
        decoding = sorted(s for s in self._requests if self.active[s])
        if decoding and self.spec:
            for slot, toks in self._spec_round().items():
                st = self._requests[slot]
                toks = toks[:st["budget"] - len(st["out"])]
                if not toks:
                    continue
                st["out"].extend(toks)
                self.last[slot] = toks[-1]
                # pos = prompt + generated - 1, the position `last` will
                # occupy; the rejected K/V past it is overwritten before
                # anything attends it
                self.pos[slot] = st["tokens"].size + len(st["out"]) - 1
                emitted[slot] = emitted.get(slot, 0) + len(toks)
                tokens[slot] = tokens.get(slot, []) + list(toks)
                if len(st["out"]) >= st["budget"]:
                    self._finish(slot, st, finished)
        elif decoding:
            active = self.active.copy()
            next_tokens, logits = self._decode(self.model, self.params, self.pool,
                                               self.last, self.pos, active)
            if self.temperature > 0:
                logits_host = _logits_host(logits)
                next_host = next_tokens.cpu().numpy().copy()
                for slot in decoding:
                    next_host[slot] = self._sample(logits_host[slot])
            else:
                next_host = next_tokens.cpu().numpy()
            self.pos = self.pos + active.astype(np.int32)
            for slot in decoding:
                st = self._requests[slot]
                tok = int(next_host[slot])
                st["out"].append(tok)
                self.last[slot] = tok
                emitted[slot] = emitted.get(slot, 0) + 1
                tokens[slot] = tokens.get(slot, []) + [tok]
                if len(st["out"]) >= st["budget"]:
                    self._finish(slot, st, finished)
        if not emitted and not prefilling:
            return None
        self.steps += 1
        return StepResult(dt=0.0, emitted=emitted, finished=finished,
                          tokens=tokens)

    def _spec_round(self) -> dict:
        """One drafter-propose / target-verify round for every active slot:
        `spec_k` drafter decode steps propose a draft, one target forward
        scores all `spec_k + 1` positions through the page tables, and
        exact rejection sampling on the host decides how much of each
        slot's draft survives. Returns slot -> emitted tokens.

        The drafter runs on a shadow of the host decode state (last/pos
        copies): a reject leaves the real state where the last accepted
        token put it, and the next round re-writes every position it
        touches before attending it."""
        k = self.spec_k
        active = self.active.copy()
        idx = np.nonzero(active)[0]
        catchup = self._catchup_need & active
        if catchup.any():
            # backfill the drafter's K/V hole from the last all-accept
            # round (write-only; masked rows park on the trash page)
            self._decode(self.draft_model, self.draft_params, self.draft_pool,
                         self._catchup_tok, self._catchup_pos, catchup)
            self._catchup_need &= ~catchup
        window = np.zeros((self.slots, k + 1), np.int32)
        window[:, 0] = self.last
        draft_tokens = np.zeros((self.slots, k), np.int32)
        draft_logits = None  # (S, k, V), shaped from the first step
        d_last = self.last.copy()
        d_pos = self.pos.copy()
        for i in range(k):
            toks, logits = self._decode(self.draft_model, self.draft_params,
                                        self.draft_pool, d_last, d_pos, active)
            logits_host = _logits_host(logits)
            if draft_logits is None:
                draft_logits = np.zeros(
                    (self.slots, k, logits_host.shape[-1]), np.float64)
            draft_logits[:, i] = logits_host
            toks_host = toks.cpu().numpy().copy()
            if self.temperature > 0:
                # sampled mode proposes by sampling the drafter (the
                # rejection rule's q must be the proposal law)
                for slot in idx:
                    toks_host[slot] = self._sample(logits_host[slot])
            draft_tokens[:, i] = toks_host
            window[:, i + 1] = toks_host
            d_last = toks_host
            d_pos = d_pos + active.astype(np.int32)
        v_logits = _verify_window_paged(self.model, self.params, self.pool, self.tables,
                                        window, self.pos, active, self.page_size,
                                        self.max_pages, self.trash, self.cache_int8)
        v_host = _logits_host(v_logits)  # (S, k+1, V)
        out: dict = {}
        self.spec_rounds += 1
        for slot in idx:
            accepted, toks = dec.speculative_accept(
                draft_tokens[slot], draft_logits[slot], v_host[slot],
                self.temperature, self._rng,
            )
            self.spec_drafted += k
            self.spec_accepted += accepted
            self.spec_rolled_back += k - accepted
            if accepted >= k:
                # all accepted: d_k was proposed but never embedded; mark
                # its position for the next round's backfill
                self._catchup_need[slot] = True
                self._catchup_tok[slot] = draft_tokens[slot, k - 1]
                self._catchup_pos[slot] = self.pos[slot] + k
            out[int(slot)] = toks
        return out


# --------------------------------------------------------- step bodies


def _layer_mlp(bp, x, attn, model):
    """The rest of a block after attention: projection, residual, MLP."""
    x = x + dec._dense(bp["proj"], attn.reshape(*x.shape), model.dtype)
    y = dec._ln(bp["LayerNorm_1"], x, model.dtype)
    y = F.gelu(dec._dense(bp["mlp_up"], y, model.dtype), approximate="tanh")
    return x + dec._dense(bp["mlp_down"], y, model.dtype)


def _qkv(bp, x, model):
    """(q, k, v), each (..., H, D), of one block's input."""
    head_dim = model.embed_dim // model.num_heads
    y = dec._ln(bp["LayerNorm_0"], x, model.dtype)
    qkv = dec._dense(bp["qkv"], y, model.dtype)
    return (t.reshape(*x.shape[:-1], model.num_heads, head_dim)
            for t in qkv.split(model.embed_dim, dim=-1))


def _write(layer, page, off, k, v, int8: bool) -> None:
    """Scatter K/V (quantised with `int8`) into the pool at (page, off)."""
    if int8:
        (kq, ks), (vq, vs) = dec._quant_kv(k), dec._quant_kv(v)
        layer["k"][page, off], layer["v"][page, off] = kq, vq
        layer["k_scale"][page, off], layer["v_scale"][page, off] = ks, vs
    else:
        layer["k"][page, off] = k.to(torch.bfloat16)
        layer["v"][page, off] = v.to(torch.bfloat16)


def _gather(layer, page, off):
    """A slot's logical view of one layer's pool through its page table."""
    return {name: t[page, off] for name, t in layer.items()}


def _attend_int8(q, layer, tables, reach):
    """K3 over the int8 pool, read through the slots' page tables."""
    return decode_attention_int8(q, layer["k"], layer["k_scale"], layer["v"], layer["v_scale"],
                                 reach, layout="paged", tables=tables)


@torch.no_grad()
def _prefill_chunk_paged(model, params, pool, tokens, table, start, last_row, chunk,
                         page_size, max_pages, int8):
    """Advance one slot's prompt by one padded chunk of length `chunk`:
    scatter the chunk's K/V into the slot's pages at logical positions
    [start, start + chunk), gather the slot's logical view back through
    the page table (host numpy), attend causally, and return the logits
    at the chunk's last real row (`last_row`). The chunk's own positions
    attend their fresh full-precision K/V; writes past the table's last
    page land on the trash page, and positions past the logical window
    are dropped from the gathered view, as the reference's scatters drop
    them."""
    device = params["pos_embed"].device
    length = max_pages * page_size  # the logical attend window
    logical = np.arange(length)
    w_pos = start + np.arange(chunk)  # query i sits at position start + i
    inside = w_pos < length
    tok, valid, w_page, w_off, g_page, g_off, own, rows = _ship(
        device, tokens, logical[None, :] <= w_pos[:, None],
        table[np.minimum(w_pos // page_size, max_pages)], w_pos % page_size,
        table[logical // page_size], logical % page_size, w_pos[inside],
        np.arange(chunk)[inside],
    )
    x = dec._embed(params, tok[None], start, model)  # (1, C, E)
    for i in range(model.num_layers):
        name = f"Block_{i}"
        bp = params[name]
        q, k, v = _qkv(bp, x, model)  # (1, C, H, D)
        layer = pool[name]
        _write(layer, w_page, w_off, k[0], v[0], int8)
        view = _gather(layer, g_page, g_off)  # (L, H, D), (L, H)
        vals = view["v"].to(model.dtype)
        vals[own] = v[0, rows].to(model.dtype)
        scores = dec.scaled_scores(q, view["k"][None])
        if int8:
            vsc = view["v_scale"]
            vsc[own] = 1.0  # own chunk: fresh values, unit scales
            scores = scores * view["k_scale"].T[None, :, None, :].to(scores.dtype)
        scores[:, :, :, own] = dec.scaled_scores(q, k)[:, :, :, rows]
        probs = torch.softmax(dec.masked(scores, valid[None, None]).float(), dim=-1)
        if int8:
            probs = probs * vsc.T[None, :, None, :].to(probs.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(model.dtype), vals[None])
        x = _layer_mlp(bp, x, attn, model)
    return dec._head(params, x[:, last_row:last_row + 1], model)[0, 0]


def _positions(model, pos):
    """Position-embedding rows for positions `pos`: past max_seq_len, the
    last row."""
    return np.minimum(pos, model.max_seq_len - 1)


@torch.no_grad()
def _decode_step_paged(model, params, pool, tables, last, pos, active, page_size,
                       max_pages, trash, int8):
    """One decode token for every slot at once, with per-slot positions and
    page tables: slot s embeds its last token at pos[s], scatters K/V into
    page tables[s, pos[s] // page_size] (the trash page when inactive),
    and attends [0, pos[s]] of its logical view: K3 reads the int8 pool
    through the tables, the bf16 cache's attention gathers the view.
    Inactive slots (pos -1 or a stale pos) read their trash-page entries.
    Returns (greedy next tokens (S,) int32, logits (S, vocab)) on the
    device; the caller advances pos where active."""
    device = params["pos_embed"].device
    slots = last.shape[0]
    length = max_pages * page_size
    logical = np.arange(length)
    own = tables[np.arange(slots), np.minimum(pos // page_size, max_pages)]
    tok, emb_pos, w_page, w_off = _ship(
        device, last.astype(np.int64), _positions(model, pos), np.where(active, own, trash),
        np.where(active, pos % page_size, 0),
    )
    # K3 reads the positions and the tables; the bf16 cache's attention a
    # dense mask and the gather indices
    if int8:
        reach, table = _ship(device, pos.astype(np.int32),
                             tables[:, :max_pages].astype(np.int32))
    else:
        reach, g_page, g_off = _ship(device, logical[None, :] <= pos[:, None],
                                     tables[:, logical // page_size], logical % page_size)
    x = (params["tok_embed"]["weight"][tok][:, None].to(model.dtype)
         + params["pos_embed"][emb_pos][:, None].to(model.dtype))
    for i in range(model.num_layers):
        name = f"Block_{i}"
        bp = params[name]
        q, k, v = _qkv(bp, x, model)  # (S, 1, H, D)
        layer = pool[name]
        _write(layer, w_page, w_off, k[:, 0], v[:, 0], int8)
        if int8:
            attn = _attend_int8(q[:, 0], layer, table, reach)
        else:
            view = _gather(layer, g_page, g_off[None])  # (S, L, H, D)
            attn = dec.attend_bf16_cache(q, view["k"], view["v"], reach[:, None, None, :],
                                         model.dtype)
        x = _layer_mlp(bp, x, attn, model)
    logits = dec._head(params, x, model)[:, 0]  # (S, vocab)
    return logits.argmax(dim=-1).to(torch.int32), logits


@torch.no_grad()
def _verify_window_paged(model, params, pool, tables, window, pos, active, page_size,
                         max_pages, trash, int8):
    """Score a window for every slot in one forward: slot s's window holds
    [last, d_1, .., d_{W-1}] at positions [pos[s], pos[s] + W); K/V
    scatters into the slot's pages at those positions, attention reads the
    slot's view back through the table (K3 on the int8 pool, a gather for
    the bf16 cache), and query i attends [0, pos[s] + i]. Like the decode
    step, the window's own K/V is read back from the pool (bf16-rounded or
    int8-quantised), which is what W consecutive decode steps would have
    attended. Inactive rows park on the trash page; writes past the
    table's end clamp onto the sentinel column, and a query past it
    attends all L positions, as it did on the gathered view of length L.
    Returns logits (S, W, vocab)."""
    device = params["pos_embed"].device
    slots, win = window.shape
    length = max_pages * page_size
    logical = np.arange(length)
    pos_idx = pos[:, None] + np.arange(win)[None, :]  # (S, W)
    own = np.take_along_axis(tables, np.minimum(pos_idx // page_size, max_pages), axis=1)
    tok, emb_pos, w_page, w_off = _ship(
        device, window.astype(np.int64), _positions(model, pos_idx),
        np.where(active[:, None], own, trash), np.where(active[:, None], pos_idx % page_size, 0),
    )
    if int8:
        reach, table = _ship(device, pos_idx.astype(np.int32),
                             tables[:, :max_pages].astype(np.int32))
    else:
        reach, g_page, g_off = _ship(device, logical[None, None, :] <= pos_idx[:, :, None],
                                     tables[:, logical // page_size], logical % page_size)
    x = (params["tok_embed"]["weight"][tok].to(model.dtype)
         + params["pos_embed"][emb_pos].to(model.dtype))  # (S, W, E)
    for i in range(model.num_layers):
        name = f"Block_{i}"
        bp = params[name]
        q, k, v = _qkv(bp, x, model)  # (S, W, H, D)
        layer = pool[name]
        _write(layer, w_page, w_off, k, v, int8)
        if int8:
            attn = _attend_int8(q, layer, table, reach)
        else:
            view = _gather(layer, g_page, g_off[None])
            attn = dec.attend_bf16_cache(q, view["k"], view["v"], reach[:, None], model.dtype)
        x = _layer_mlp(bp, x, attn, model)
    return dec._head(params, x, model)  # (S, W, vocab)
