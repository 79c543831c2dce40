"""The HBM -> host KV offload tier.

Port of `dynamo_tpu/engine/offload.py` (the reference's multi-tier KV
block manager: lib/llm/src/kv/reuse.rs:50-638 reuse pool, manager.rs
tiered lookup, layer.rs CopyStream device<->host copies): pages whose
refcount drops to zero are copied write-through to a host-RAM pool in
batched background gathers, so when the HBM prefix cache later evicts
them, a request with the same prefix restores the pages from host RAM
instead of recomputing its prefill.

Buffers ride `dynamo_tpu_torch.utils.pool.Pool`: page buffers are CPU
tensors (pinned when the engine runs on a CUDA device, so the copies to
and from the card run without blocking the host), made on first need up
to the pool's capacity, checked out per offloaded page and returned on
LRU eviction, so steady-state offload allocates nothing. A buffer has the
reference's layout, byte for byte: [2, L, page_size, row width] (K then
V) in the pool's dtype, or with quantized KV {"kv": int8 [2, L,
page_size, row width], "scales": float32 [2, L, page_size, K]}, the row
width K*Hd, or K*Hd/2 for nibble-packed int4 rows. A bf16 buffer's
`.view(torch.int16).numpy()` equals the reference's bf16 array's bits.

Event plane: the host tier emits the device tier's stored/removed KV
events, tagged `"tier": "host"`.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from dynamo_tpu_torch.engine.allocator import removed_event, stored_event
from dynamo_tpu_torch.utils.pool import Pool, PoolItem


@dataclass
class HostPageEntry:
    local_hash: int
    parent_hash: Optional[int]
    buf: PoolItem  # .value: a page buffer (see the module docstring)


class HostKvPool:
    """LRU host-RAM pool of KV pages keyed by chained sequence hash."""

    def __init__(
        self,
        capacity_pages: int,
        num_layers: int,
        page_size: int,
        kv_width: int,
        dtype: torch.dtype = torch.float32,
        on_event: Optional[Callable[[dict], None]] = None,
        scale_width: Optional[int] = None,
        pin_memory: bool = False,
    ):
        """`scale_width` (= num_kv_heads) makes quantized-KV buffers: {"kv":
        int8 [2, L, ps, kv_width], "scales": f32 [2, L, ps, scale_width]}.
        `pin_memory` page-locks each buffer (a CUDA engine's pool)."""
        self.capacity = capacity_pages
        self.scale_width = scale_width
        shape = (2, num_layers, page_size, kv_width)
        # bytes of one page buffer (what a restore moves to the device)
        self.page_bytes = 2 * num_layers * page_size * (
            kv_width * torch.empty((), dtype=dtype).element_size() + 4 * (scale_width or 0))
        if scale_width:
            sshape = (2, num_layers, page_size, scale_width)

            def factory():
                return {
                    "kv": torch.empty(shape, dtype=dtype, pin_memory=pin_memory),
                    "scales": torch.empty(sshape, dtype=torch.float32, pin_memory=pin_memory),
                }
        else:
            def factory():
                return torch.empty(shape, dtype=dtype, pin_memory=pin_memory)

        self._buffers: Pool = Pool(factory=factory, capacity=capacity_pages)
        self._entries: "OrderedDict[int, HostPageEntry]" = OrderedDict()
        self.on_event = on_event
        self.lookups = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, sequence_hash: int) -> bool:
        return sequence_hash in self._entries

    @property
    def buffer_bytes(self) -> int:
        """Host bytes held by the buffers made so far."""
        return self._buffers.total * self.page_bytes

    def reserve(self) -> Optional[PoolItem]:
        """A free page buffer, LRU-evicting if at capacity."""
        item = self._buffers.try_acquire()
        if item is not None:
            return item
        if not self._entries:
            return None
        evicted_hash, entry = self._entries.popitem(last=False)
        entry.buf.release()
        if self.on_event:
            self.on_event({**removed_event([evicted_hash]), "tier": "host"})
        return self._buffers.try_acquire()

    def put(
        self,
        sequence_hash: int,
        local_hash: int,
        parent_hash: Optional[int],
        buf: PoolItem,
    ) -> None:
        """Index a filled buffer (from `reserve`) under its hash."""
        if sequence_hash in self._entries:
            buf.release()
            return
        self._entries[sequence_hash] = HostPageEntry(local_hash, parent_hash, buf)
        if self.on_event:
            self.on_event(
                {
                    **stored_event(
                        [(sequence_hash, local_hash, -1)], parent_hash=parent_hash
                    ),
                    "tier": "host",
                }
            )

    def match_prefix(self, sequence_hashes: list[int]) -> list[int]:
        """Length of the leading run present in the pool, as hash list."""
        out = []
        for h in sequence_hashes:
            self.lookups += 1
            if h not in self._entries:
                break
            self.hits += 1
            self._entries.move_to_end(h)
            out.append(h)
        return out

    def get(self, sequence_hash: int):
        entry = self._entries.get(sequence_hash)
        if entry is None:
            return None
        self._entries.move_to_end(sequence_hash)
        return entry.buf.value

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0
