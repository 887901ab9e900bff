"""Host-side paged-KV bookkeeping, the page pool and the prefix store: the
port's own copy of `tritonk8ssupervisor_tpu/serving/kvpool.py` (:50-276),
pure Python, so that the port imports nothing of the JAX package.

- `PagePool`: a free list plus per-page refcounts. A page is allocated
  when its refcount leaves 0 and freed the moment the last holder unrefs
  it. Slots hold one ref per page they map; the prefix store holds one
  ref per page it keeps shareable, so `pages_in_use == 0` after a full
  release is the no-leak invariant.
- `PrefixStore`: a longest-match index over chained block keys (block j
  of a prompt is shareable iff its page is full of real prompt K/V, and
  key_j = H(key_{j-1}, tokens of block j)), with LRU eviction over
  entries whose pages no slot is using.

A match is capped at `prompt_len - 1` tokens (`match_cap_blocks`): the
first generated token is the argmax of the logits at the last prompt
position, so at least one suffix token always re-prefills.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque


def token_block_keys(tokens, page_size: int, n_blocks: int) -> list[bytes]:
    """Chained content hashes for the first `n_blocks` full pages of a
    prompt. `tokens` is any int sequence; the digest chain makes key j
    depend on blocks 0..j (K/V content does too)."""
    keys: list[bytes] = []
    digest = b""
    for j in range(n_blocks):
        block = b"".join(
            b"%d," % int(t)
            for t in tokens[j * page_size:(j + 1) * page_size]
        )
        digest = hashlib.sha1(digest + block).digest()
        keys.append(digest)
    return keys


def full_blocks(prompt_len: int, page_size: int) -> int:
    """Pages completely covered by real prompt tokens — the registerable
    set (positions past prompt_len hold padded-prefill garbage or
    future decode writes; a page containing them must never be
    shared)."""
    return max(0, int(prompt_len)) // int(page_size)


def match_cap_blocks(prompt_len: int, page_size: int) -> int:
    """The most blocks a NEW prompt of `prompt_len` may take from the
    store: at least one token must remain to prefill (its logits seed
    the first generated token), so the cap is the full pages within the
    first prompt_len - 1 tokens."""
    return max(0, int(prompt_len) - 1) // int(page_size)


class PagePool:
    """Fixed-size page allocator with refcounts. `num_pages=None` is
    the modeled-engine's unbounded mode: pages are minted on demand
    (accounting still runs, capacity never binds) so legacy sims keep
    their exact behavior."""

    def __init__(self, num_pages: int | None, page_size: int) -> None:
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self.num_pages = None if num_pages is None else int(num_pages)
        if self.num_pages is not None and self.num_pages < 1:
            raise ValueError("num_pages must be >= 1 (or None)")
        self._free: deque = deque(range(self.num_pages or 0))
        self._next_minted = 0  # unbounded mode: next fresh id
        self._refs: dict = {}  # page id -> refcount (> 0)
        self.peak_in_use = 0

    @property
    def pages_in_use(self) -> int:
        return len(self._refs)

    @property
    def pages_free(self) -> int:
        if self.num_pages is None:
            return 1 << 30  # effectively unbounded
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Claim `n` pages with refcount 1 each, or None when the free
        list cannot cover it (caller evicts from the store and
        retries)."""
        n = int(n)
        if n < 0:
            raise ValueError("alloc of negative page count")
        if self.num_pages is None:
            got = list(range(self._next_minted, self._next_minted + n))
            self._next_minted += n
        else:
            if len(self._free) < n:
                return None
            got = [self._free.popleft() for _ in range(n)]
        for page in got:
            self._refs[page] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return got

    def ref(self, pages) -> None:
        for page in pages:
            if page not in self._refs:
                raise ValueError(f"ref of free page {page}")
            self._refs[page] += 1

    def unref(self, pages) -> int:
        """Drop one ref per page; pages reaching 0 return to the free
        list. Returns how many were freed."""
        freed = 0
        for page in pages:
            count = self._refs.get(page)
            if count is None:
                raise ValueError(f"unref of free page {page}")
            if count > 1:
                self._refs[page] = count - 1
            else:
                del self._refs[page]
                if self.num_pages is not None:
                    self._free.append(page)
                freed += 1
        return freed

    def release_span(self, table, from_page: int) -> int:
        """The rollback primitive: unref EXACTLY the pages at indices
        >= `from_page` of a slot's page list, truncating the list in
        place so a later whole-slot `release` cannot double-unref them.
        A speculative reject (or an early finish inside a speculative
        window) shrinks the slot's logical span; the pages past the
        truncation point are unreachable for THIS slot but may live on
        under other holders (a shared prefix, the store) — refcounts,
        not ownership, decide what actually frees. Returns pages
        returned to the free list (refcount-conservation is pinned in
        tests/test_kvpool.py)."""
        from_page = max(0, int(from_page))
        tail = list(table[from_page:])
        freed = self.unref(tail)
        del table[from_page:]
        return freed

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)


class PrefixStore:
    """Longest-chain-match index of shareable prefix pages. Holds ONE
    ref on every registered page, so a prefix outlives the request that
    prefilled it until eviction — that ref is what 'warm cache' means.

    LRU order is bumped on match AND register; `evict_for(n)` walks
    oldest-first dropping entries until `n` pages have actually been
    FREED (an entry whose page a live slot still maps is dropped from
    the index — future requests can no longer match it — but its page
    only frees when that slot releases; the walk keeps going)."""

    def __init__(self, pool: PagePool) -> None:
        self.pool = pool
        self._entries: OrderedDict = OrderedDict()  # key -> page id
        self.hits = 0  # requests that matched >= 1 block
        self.misses = 0  # requests that matched none
        self.block_hits = 0
        self.evictions = 0  # entries dropped
        self.hit_tokens = 0  # prefill tokens skipped via matches

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, keys) -> tuple[int, list[int]]:
        """Longest chained match: (blocks matched, their page ids).
        Counts one hit/miss per call and bumps matched entries' LRU
        age."""
        pages: list[int] = []
        for key in keys:
            page = self._entries.get(key)
            if page is None:
                break
            self._entries.move_to_end(key)
            pages.append(page)
        if pages:
            self.hits += 1
            self.block_hits += len(pages)
            self.hit_tokens += len(pages) * self.pool.page_size
        else:
            self.misses += 1
        return len(pages), pages

    def peek(self, keys) -> int:
        """match() without counters or LRU bumps — what admission's
        can-this-fit probe uses (the real match happens at join)."""
        n = 0
        for key in keys:
            if key not in self._entries:
                break
            n += 1
        return n

    def register(self, keys, pages) -> int:
        """Insert (key, page) pairs a completed prefill produced; the
        store refs each NEWLY inserted page. Existing keys keep their
        page (first writer wins — both copies hold identical K/V, and
        re-pointing would strand the old page's sharers' accounting).
        Returns how many entries were inserted."""
        inserted = 0
        for key, page in zip(keys, pages):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self.pool.ref([int(page)])
            self._entries[key] = int(page)
            inserted += 1
        return inserted

    def evictable_pages(self) -> int:
        """Pages the store could free RIGHT NOW (refcount 1 = only the
        store holds them) — what capacity probes add to the free
        list."""
        return sum(1 for page in self._entries.values()
                   if self.pool.refcount(page) == 1)

    def evict_for(self, need: int) -> int:
        """Drop LRU entries until `need` pages have been freed (or the
        store is empty). Returns pages actually freed."""
        freed = 0
        while freed < need and self._entries:
            _key, page = self._entries.popitem(last=False)
            self.evictions += 1
            freed += self.pool.unref([page])
        return freed

    def flush(self) -> int:
        """Drop every entry (an engine reset wiped the cache content
        the pages pointed at). Returns pages freed."""
        freed = 0
        while self._entries:
            _key, page = self._entries.popitem(last=False)
            self.evictions += 1
            freed += self.pool.unref([page])
        return freed

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "block_hits": self.block_hits,
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
        }
