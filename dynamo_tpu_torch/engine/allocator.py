"""Paged-KV allocator with prefix caching and KV event emission.

TPU-native equivalent of the reference's block machinery, which lives in
its vLLM fork patch (prefix-caching block allocator + KVCacheEventManager,
reference: container/deps/vllm/vllm_v0.7.2-dynamo-kv-disagg-patch.patch:426-935)
and the CUDA-side reuse pool (reference: lib/llm/src/kv/reuse.rs:50-638).
Single-threaded by design — the engine loop is the only caller, mirroring
the reference's progress-engine pattern instead of locks (SURVEY.md §5
race-detection note).

Pages are identified by the chained **sequence hash** of the tokens they
hold (dynamo_tpu_torch/llm/tokens.py). A page is:

- **free**: on the free list, contents dead;
- **active**: referenced by >=1 sequences (refs > 0);
- **cached**: refs == 0 but contents indexed by sequence hash — reusable by
  `match_prefix`, evictable in LRU order when the free list runs dry.

Every register/evict emits a KV event (stored/removed) through `on_event` —
the feed for the KV-aware router (reference: kv_router/protocols.rs:58-121).
Page 0 is the trash page: never allocated, padded writes land there.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class PageMeta:
    refs: int = 0
    sequence_hash: Optional[int] = None  # set once contents are a full hashed block
    local_hash: Optional[int] = None
    parent_hash: Optional[int] = None


def stored_event(blocks: list[tuple[int, int, int]], parent_hash: Optional[int]) -> dict:
    """blocks: [(sequence_hash, local_hash, page_id)]."""
    return {
        "type": "stored",
        "parent_hash": parent_hash,
        "blocks": [
            {"block_hash": sh, "tokens_hash": lh, "page_id": pid}
            for sh, lh, pid in blocks
        ],
    }


def removed_event(hashes: list[int]) -> dict:
    return {"type": "removed", "block_hashes": hashes}


class PageAllocator:
    def __init__(
        self,
        num_pages: int,
        page_size: int,
        on_event: Optional[Callable[[dict], None]] = None,
        on_cached: Optional[Callable[[int, "PageMeta"], None]] = None,
        ledger=None,
    ):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.on_event = on_event
        # called when a hashed page's refcount drops to 0 (it became
        # reusable-and-evictable) — the offload tier's write-through hook
        self.on_cached = on_cached
        # optional KvLedger (engine/kv_ledger.py): every lifecycle
        # transition gets stamped; release misuse becomes a typed
        # violation instead of silent corruption
        self.ledger = ledger
        # standalone counters so direct-allocator users (tests) see the
        # release-misuse taxonomy even without a ledger attached
        self.release_violations = {"double_release": 0, "unknown_page": 0}
        self._free: deque[int] = deque(range(1, num_pages))
        self._meta: dict[int, PageMeta] = {}
        self._by_hash: dict[int, int] = {}  # sequence_hash -> page_id
        self._lru: OrderedDict[int, int] = OrderedDict()  # seq_hash -> page_id, refs==0
        # counters for metrics / hit-rate
        self.lookups = 0
        self.hits = 0
        # high-water mark of referenced (refs>0) pages — the telemetry
        # plane's "how close did this pool ever get to exhaustion"
        self.peak_used = 0

    # ---- queries ------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Pages obtainable right now (free list + evictable cached)."""
        return len(self._free) + len(self._lru)

    @property
    def num_active(self) -> int:
        return len(self._meta)

    @property
    def pages_free(self) -> int:
        """Pages on the free list proper (contents dead); `num_free`
        additionally counts evictable cached pages."""
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        """Hashed pages at refs==0: reusable by prefix match, evictable
        under pressure — occupied-but-reclaimable capacity."""
        return len(self._lru)

    @property
    def pages_used(self) -> int:
        """Pages referenced by live sequences (refs > 0)."""
        return len(self._meta) - len(self._lru)

    def fragmentation(self) -> float:
        """Fraction of occupied pages that are cached rather than live:
        0.0 = every occupied page serves a running sequence, 1.0 = the
        pool is all cold cache. High fragmentation + allocation failures
        means eviction churn, not true capacity exhaustion."""
        occupied = len(self._meta)
        return len(self._lru) / occupied if occupied else 0.0

    def usage(self) -> float:
        usable = self.num_pages - 1
        return (usable - len(self._free) - len(self._lru)) / usable if usable else 0.0

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    # ---- prefix cache -------------------------------------------------

    def match_prefix(self, sequence_hashes: list[int]) -> list[int]:
        """Longest cached prefix: returns page ids (ref'd) for the leading
        run of hashes present in the cache."""
        pages: list[int] = []
        for h in sequence_hashes:
            self.lookups += 1
            pid = self.pin(h)
            if pid is None:
                break
            self.hits += 1
            pages.append(pid)
        return pages

    def pin(self, sequence_hash: int) -> Optional[int]:
        """Take a reference on a cached page by hash (the cached->active
        transition; also keeps a page unevictable while the offload tier
        copies it out); pair with `release`."""
        pid = self._by_hash.get(sequence_hash)
        if pid is None:
            return None
        meta = self._meta[pid]
        if meta.refs == 0:
            self._lru.pop(sequence_hash, None)
        meta.refs += 1
        if self.ledger is not None:
            self.ledger.page_event(pid, "pin")
        self.peak_used = max(self.peak_used, self.pages_used)
        return pid

    def peek_prefix_tokens(
        self,
        token_ids: Optional[list[int]] = None,
        hashes: Optional[list[int]] = None,
    ) -> int:
        """Non-destructive longest-cached-prefix length in tokens (no
        refcounts taken) — the disagg decision input. Pass `hashes` when
        the caller already holds the prompt's chained block hashes (the
        serve path computes them again at allocation; hashing the full
        prompt twice per request is pure waste on long prompts)."""
        if hashes is None:
            from dynamo_tpu_torch.llm.tokens import compute_block_hashes

            hashes = compute_block_hashes(token_ids or [], self.page_size)
        n = 0
        for h in hashes:
            if h not in self._by_hash:
                break
            n += 1
        return n * self.page_size

    # ---- allocation ---------------------------------------------------

    def allocate(self, n: int) -> Optional[list[int]]:
        """n fresh pages (refs=1 each), evicting LRU cached pages if needed.
        Returns None (no side effects) if impossible."""
        if n > self.num_free:
            return None
        evicted: list[int] = []
        while len(self._free) < n:
            h, pid = self._lru.popitem(last=False)
            meta = self._meta.pop(pid)
            del self._by_hash[h]
            evicted.append(meta.sequence_hash)
            self._free.append(pid)
            if self.ledger is not None:
                self.ledger.page_event(pid, "evict")
        if evicted and self.on_event:
            self.on_event(removed_event(evicted))
        pages = [self._free.popleft() for _ in range(n)]
        for pid in pages:
            self._meta[pid] = PageMeta(refs=1)
            if self.ledger is not None:
                self.ledger.page_event(pid, "alloc")
        self.peak_used = max(self.peak_used, self.pages_used)
        return pages

    def register(
        self,
        page_ids: list[int],
        blocks: list[tuple[int, int]],  # (sequence_hash, local_hash) per page
        parent_hash: Optional[int],
    ) -> None:
        """Mark pages as holding completed, hashed blocks (emits `stored`).
        If a hash is already cached for another page (two sequences computed
        the same block), the new page keeps working storage but the index
        keeps the first page."""
        stored: list[tuple[int, int, int]] = []
        event_parent: Optional[int] = None
        for pid, (sh, lh) in zip(page_ids, blocks):
            meta = self._meta[pid]
            if meta.sequence_hash is not None:
                parent_hash = meta.sequence_hash
                continue  # already registered (shared prefix page)
            meta.sequence_hash, meta.local_hash, meta.parent_hash = sh, lh, parent_hash
            if self.ledger is not None:
                self.ledger.page_event(pid, "register")
            if sh not in self._by_hash:
                self._by_hash[sh] = pid
                if not stored:
                    event_parent = parent_hash
                stored.append((sh, lh, pid))
            parent_hash = sh
        if stored and self.on_event:
            self.on_event(stored_event(stored, parent_hash=event_parent))

    def _release_violation(self, kind: str, pid: int) -> None:
        self.release_violations[kind] += 1
        if self.ledger is not None:
            self.ledger.violation(kind, page_ids=[pid])

    def release(self, page_ids: list[int]) -> None:
        """Drop one reference per page. Hashed pages at refs==0 stay cached
        (LRU-evictable); unhashed pages free immediately.

        Misuse is a counted, typed violation, never a silent mutation:
        releasing an unknown page id ticks ``unknown_page``; releasing a
        page whose refs are already 0 ticks ``double_release`` and skips
        the page entirely — the old behavior drove refs negative and
        re-freed/re-cached the page (free-list duplication, double
        `on_cached` offload enqueues)."""
        for pid in page_ids:
            meta = self._meta.get(pid)
            if meta is None:
                self._release_violation("unknown_page", pid)
                continue
            if meta.refs <= 0:
                self._release_violation("double_release", pid)
                continue
            meta.refs -= 1
            if meta.refs > 0:
                continue
            if meta.sequence_hash is not None and self._by_hash.get(meta.sequence_hash) == pid:
                self._lru[meta.sequence_hash] = pid
                if self.ledger is not None:
                    self.ledger.page_event(pid, "cache")
                if self.on_cached:
                    self.on_cached(pid, meta)
            else:
                del self._meta[pid]
                self._free.append(pid)
                if self.ledger is not None:
                    self.ledger.page_event(pid, "free")

    def clear_cache(self) -> None:
        """Drop all refs==0 cached pages (emits removed)."""
        if not self._lru:
            return
        hashes = list(self._lru.keys())
        for h, pid in self._lru.items():
            del self._by_hash[h]
            del self._meta[pid]
            self._free.append(pid)
            if self.ledger is not None:
                self.ledger.page_event(pid, "clear")
        self._lru.clear()
        if self.on_event:
            self.on_event(removed_event(hashes))
