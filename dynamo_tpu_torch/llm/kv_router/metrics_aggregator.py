"""Router-side metrics aggregation.

Background scrape of every live instance's stats handler into a
`ProcessedEndpoints` snapshot (reference:
lib/llm/src/kv_router/metrics_aggregator.rs:26-51, scoring.rs:24): the
scheduler reads the latest snapshot; staleness between polls is acceptable
by design (same as the reference's watch-channel model).
"""

from __future__ import annotations

import asyncio
import statistics
import time
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics


@dataclass
class ProcessedEndpoints:
    endpoints: dict[int, ForwardPassMetrics] = field(default_factory=dict)

    @property
    def worker_ids(self) -> list[int]:
        return sorted(self.endpoints.keys())



class KvMetricsAggregator:
    def __init__(
        self,
        client,
        poll_interval: float = 1.0,
        stale_after: Optional[float] = None,
    ):
        self.client = client  # runtime Client of the workers' endpoint
        self.poll_interval = poll_interval
        # heartbeat staleness horizon: a worker that has not answered a
        # stats scrape for this long is excluded from routing (its lease
        # may still be alive — a wedged worker keeps a healthy keepalive
        # thread); default 3 poll intervals so one dropped scrape never
        # flaps a healthy worker out
        self.stale_after = (
            stale_after if stale_after is not None else 3.0 * poll_interval
        )
        self.current = ProcessedEndpoints()
        # worker -> monotonic stamp of its last successful stats reply
        self.last_seen: dict[int, float] = {}
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        await self._scrape_once()
        self._task = asyncio.create_task(self._poll())

    async def _poll(self) -> None:
        import logging

        while True:
            await asyncio.sleep(self.poll_interval)
            try:
                await self._scrape_once()
            except Exception:  # noqa: BLE001 — one bad scrape must not
                # freeze routing metrics forever
                logging.getLogger("dynamo_tpu_torch.kv_router").exception(
                    "metrics scrape failed; keeping last snapshot"
                )

    async def _scrape_once(self) -> None:
        stats = await self.client.scrape_stats()
        endpoints = {}
        now = time.monotonic()
        for wid, s in stats.items():
            try:
                endpoints[wid] = ForwardPassMetrics.from_dict(s)
            except Exception:  # noqa: BLE001 — skip one worker's bad stats
                continue
            self.last_seen[wid] = now
        self.current = ProcessedEndpoints(endpoints=endpoints)

    def endpoints_for(self, worker_ids: list[int]) -> dict[int, ForwardPassMetrics]:
        """Metrics for the given live workers; workers missing from the last
        scrape get default (zero-load) metrics so new instances are
        immediately routable."""
        return {
            wid: self.current.endpoints.get(wid, ForwardPassMetrics())
            for wid in worker_ids
        }

    def stale_workers(self, worker_ids: list[int]) -> set[int]:
        """Workers whose heartbeat (last successful stats reply) is older
        than `stale_after`. Workers never seen yet are NOT stale — a new
        instance must be routable before its first scrape lands; its
        first missed horizon starts at registration."""
        now = time.monotonic()
        out = set()
        for wid in worker_ids:
            seen = self.last_seen.get(wid)
            if seen is None:
                # start the horizon now so a worker that NEVER answers
                # does eventually go stale
                self.last_seen[wid] = now
            elif now - seen > self.stale_after:
                out.add(wid)
        return out

    def mark_gone(self, worker_id: int) -> None:
        """Instance-down: drop the heartbeat record so a re-registered
        worker id starts fresh."""
        self.last_seen.pop(worker_id, None)
        self.current.endpoints.pop(worker_id, None)

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
