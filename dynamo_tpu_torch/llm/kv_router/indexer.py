"""Radix index of which workers hold which KV blocks.

Semantics follow the reference indexer (reference:
lib/llm/src/kv_router/indexer.rs:239-379): blocks are identified by
*chained* sequence hashes, so a block hash encodes its whole prefix; the
index maps block hash -> set of workers currently holding it, with parent
links for bookkeeping. `find_matches` walks a request's block-hash chain
accumulating per-worker overlap — a worker only keeps scoring while it
holds *every* block of the prefix so far (contiguity is what makes the
overlap usable as a KV-cache hit).

Single-threaded: the router's event-subscription task is the only writer
(the reference funnels through an mpsc for the same reason, indexer.rs:499).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent


@dataclass
class OverlapScores:
    """Per-worker count of contiguously matched prefix blocks
    (reference: indexer.rs OverlapScores).

    `scores` is the total overlap per worker regardless of tier (the
    back-compat view); `device_scores`/`host_scores` split it by where
    the worker holds each block — a device-tier hit is free reuse while
    a host-tier hit still pays an H2D restore (and may be declined by
    the worker's cost gate), so the selector weights host blocks below
    device blocks (docs/kv_cache.md "Router scoring")."""

    scores: dict[int, int] = field(default_factory=dict)
    device_scores: dict[int, int] = field(default_factory=dict)
    host_scores: dict[int, int] = field(default_factory=dict)
    matched_blocks: int = 0  # length of the longest matched chain

    def best(self) -> int:
        return max(self.scores.values(), default=0)


@dataclass
class _Node:
    # worker -> tiers ("device"/"host") holding the block; a worker keeps
    # the block while ANY tier has it (the offload pool restores host-tier
    # blocks with one H2D scatter, far cheaper than recompute)
    workers: dict[int, set[str]] = field(default_factory=dict)
    parent: Optional[int] = None


class RadixTree:
    def __init__(self):
        self._nodes: dict[int, _Node] = {}
        self._worker_blocks: dict[int, set[int]] = defaultdict(set)
        self.event_count = 0

    def apply_event(self, ev: RouterEvent) -> None:
        self.event_count += 1
        worker, e = ev.worker_id, ev.event
        tier = getattr(e, "tier", "device") or "device"
        if e.type == "stored":
            parent = e.parent_hash
            for blk in e.blocks:
                node = self._nodes.get(blk.block_hash)
                if node is None:
                    node = self._nodes[blk.block_hash] = _Node(parent=parent)
                node.workers.setdefault(worker, set()).add(tier)
                self._worker_blocks[worker].add(blk.block_hash)
                parent = blk.block_hash
        elif e.type == "removed":
            for h in e.block_hashes:
                node = self._nodes.get(h)
                if node is None:
                    continue
                tiers = node.workers.get(worker)
                if tiers is None:
                    continue
                tiers.discard(tier)
                if not tiers:
                    del node.workers[worker]
                    self._worker_blocks[worker].discard(h)
                if not node.workers:
                    del self._nodes[h]

    def remove_worker(self, worker_id: int) -> None:
        """Worker gone (lease expired): purge all its blocks
        (reference: indexer.rs:380)."""
        for h in self._worker_blocks.pop(worker_id, set()):
            node = self._nodes.get(h)
            if node is None:
                continue
            node.workers.pop(worker_id, None)
            if not node.workers:
                del self._nodes[h]

    def find_matches(self, sequence_hashes: list[int]) -> OverlapScores:
        out = OverlapScores()
        active: Optional[set[int]] = None
        for h in sequence_hashes:
            node = self._nodes.get(h)
            if node is None:
                break
            holders = set(node.workers)
            active = holders if active is None else active & holders
            if not active:
                break
            out.matched_blocks += 1
            for w in active:
                out.scores[w] = out.scores.get(w, 0) + 1
                # tier split: a block present on device counts there even
                # if the host pool also holds a copy (restore never needed)
                if "device" in node.workers[w]:
                    out.device_scores[w] = out.device_scores.get(w, 0) + 1
                else:
                    out.host_scores[w] = out.host_scores.get(w, 0) + 1
        return out

    @property
    def num_blocks(self) -> int:
        return len(self._nodes)

    def workers(self) -> list[int]:
        return sorted(self._worker_blocks.keys())


class KvIndexer:
    """RadixTree + hub event subscription (reference: KvIndexer
    indexer.rs:499-613). `start()` subscribes to the component's
    `kv_events` subject and applies events as they arrive; instance-down
    notifications purge workers."""

    def __init__(self, component, block_size: int):
        import asyncio

        self.component = component
        self.block_size = block_size
        self.tree = RadixTree()
        self._task: Optional["asyncio.Task"] = None
        self._sub = None

    async def start(self) -> None:
        import asyncio

        from dynamo_tpu_torch.llm.kv_router.protocols import KV_EVENT_SUBJECT

        self._sub = await self.component.subscribe(KV_EVENT_SUBJECT)
        self._task = asyncio.create_task(self._pump())

    async def _pump(self) -> None:
        from dynamo_tpu_torch.utils import msgpack

        async for ev in self._sub:
            try:
                d = msgpack.unpackb(ev["data"])
                self.tree.apply_event(RouterEvent.from_dict(d))
            except Exception:  # noqa: BLE001 — a bad event must not kill routing
                import logging

                logging.getLogger("dynamo_tpu_torch.kv_router").exception(
                    "bad kv event dropped"
                )

    def find_matches(self, sequence_hashes: list[int]) -> OverlapScores:
        return self.tree.find_matches(sequence_hashes)

    def find_matches_for_tokens(self, token_ids: list[int]) -> OverlapScores:
        from dynamo_tpu_torch.llm.tokens import compute_block_hashes

        return self.tree.find_matches(
            compute_block_hashes(token_ids, self.block_size)
        )

    def remove_worker(self, worker_id: int) -> None:
        self.tree.remove_worker(worker_id)

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
        if self._sub is not None:
            await self._sub.unsubscribe()
