"""Worker-side KV plane publishers.

- `KvEventPublisher` bridges the engine's synchronous KV-event callback
  onto the hub event plane as RouterEvents (reference:
  lib/llm/src/kv_router/publisher.rs:34-76 + the C-FFI path the vLLM patch
  uses; here the engine is in-process so it is just a queue).
- `KvMetricsPublisher` snapshots engine metrics as ForwardPassMetrics and
  doubles as the endpoint stats handler scraped by aggregators (reference:
  publisher.rs:78-139).
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Callable, Optional

from dynamo_tpu_torch.utils import msgpack

from dynamo_tpu_torch.llm.kv_router.protocols import (
    KV_EVENT_SUBJECT,
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
)
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.kv_router")


class KvEventPublisher:
    """Queue engine KV events (sync callback) and publish them in order on
    the component's `kv_events` subject. `stored_at` keeps the host's wall
    time (`time.time()`) at which each of the last `STAMPS` events left
    the allocator, as (event_id, seconds): an indexer on the same host
    reads its event lag, store to apply, against it."""

    STAMPS = 64

    def __init__(self, component, worker_id: int):
        self.component = component
        self.worker_id = worker_id
        self._queue: asyncio.Queue[Optional[dict]] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self.stored_at: collections.deque = collections.deque(maxlen=self.STAMPS)

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._pump())

    def attach(self, engine) -> "KvEventPublisher":
        """Subscribe to a TorchEngine's allocator events
        (`TorchEngine.subscribe_events`)."""
        engine.subscribe_events(self.on_event)
        return self

    def on_event(self, event: dict) -> None:
        """Synchronous callback from the engine's allocator."""
        self.stored_at.append((event.get("event_id", 0), time.time()))
        self._queue.put_nowait(event)

    async def _pump(self) -> None:
        while True:
            event = await self._queue.get()
            if event is None:
                return
            router_event = RouterEvent(
                worker_id=self.worker_id, event=KvCacheEvent.from_dict(event)
            )
            try:
                await self.component.publish(
                    KV_EVENT_SUBJECT, msgpack.packb(router_event.to_dict())
                )
            except Exception:  # noqa: BLE001
                log.exception("kv event publish failed")

    async def close(self) -> None:
        self._queue.put_nowait(None)
        if self._task:
            await self._task


class KvMetricsPublisher:
    """Latest ForwardPassMetrics snapshot + stats handler for scrapes."""

    def __init__(
        self,
        source: Optional[Callable[[], dict]] = None,
        slo: Optional[object] = None,
        ledger_source: Optional[Callable[[], dict]] = None,
    ):
        self._source = source
        # llm/http/metrics.SloTracker (duck-typed: anything with a
        # snapshot() -> dict): its attained fractions ride every stats
        # reply so the aggregator sees fleet attainment without a
        # second scrape plane
        self._slo = slo
        # engine/kv_ledger.KvLedger.summary_counts (duck-typed
        # callable): the worker's custody-census summary rides the same
        # reply — fleet leak visibility without a second scrape plane
        self._ledger = ledger_source
        self.current = ForwardPassMetrics()

    @classmethod
    def for_engine(
        cls,
        engine,
        slo: Optional[object] = None,
    ) -> "KvMetricsPublisher":
        ledger = getattr(engine, "kv_ledger", None)
        return cls(
            source=engine.metrics, slo=slo,
            ledger_source=ledger.summary_counts if ledger is not None else None,
        )

    def publish(self, metrics: ForwardPassMetrics) -> None:
        self.current = metrics

    def stats_handler(self) -> dict:
        """Wire into EndpointConfigBuilder.stats_handler — scraped via the
        data plane (reference: NATS $SRV.STATS)."""
        if self._source is not None:
            self.current = ForwardPassMetrics.from_dict(self._source())
        if self._slo is not None:
            try:
                self.current.slo_attainment = dict(self._slo.snapshot())
            except Exception:  # noqa: BLE001 — stats must never fail on SLO
                log.exception("slo snapshot failed; sending without it")
        if self._ledger is not None:
            try:
                self.current.kv_ledger = dict(self._ledger())
            except Exception:  # noqa: BLE001 — nor on the custody census
                log.exception("kv ledger stats failed; sending without them")
        return self.current.to_dict()
