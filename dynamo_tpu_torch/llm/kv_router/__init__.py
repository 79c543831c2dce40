"""KV-cache-aware routing (reference: lib/llm/src/kv_router.rs:67-169), the
port of the JAX package's `dynamo_tpu/llm/kv_router`.

`KvRouter` ties the pieces: a radix indexer fed by worker `kv_events`, a
metrics aggregator scraping worker load, and the scheduler's logit formula.
`KvPushRouter` plugs it into the runtime client as routing mode "kv": each
request's token ids are block-hashed, matched, scheduled, and sent direct
to the chosen worker. Worker death (lease expiry -> instance-down) purges
the worker from the index.

Not ported yet (ROADMAP M17): the cross-worker prefix pull
(`kv_router/pull.py`). `pull_threshold_tokens` keeps its default of 0,
under which the reference's `_maybe_pull` returns the decision untouched;
any other value raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, OverlapScores, RadixTree
from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import (
    KvMetricsAggregator,
    ProcessedEndpoints,
)
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, KvMetricsPublisher
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvScheduler,
    SchedulingDecision,
    WorkerSelector,
)
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.client import Client, PushRouter
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.utils import tracing

__all__ = [
    "KvRouter",
    "KvPushRouter",
    "KvIndexer",
    "RadixTree",
    "OverlapScores",
    "KvScheduler",
    "DefaultWorkerSelector",
    "WorkerSelector",
    "SchedulingDecision",
    "KvEventPublisher",
    "KvMetricsPublisher",
    "KvMetricsAggregator",
    "ProcessedEndpoints",
    "ForwardPassMetrics",
    "RouterEvent",
    "KvCacheEvent",
]


class KvRouter:
    """Indexer + aggregator + scheduler for one worker component."""

    def __init__(
        self,
        component,
        client: Client,
        block_size: int = 16,
        selector: Optional[WorkerSelector] = None,
        poll_interval: float = 1.0,
        pull_threshold_tokens: int = 0,
        host_tier_weight: float = 0.5,
    ):
        self.component = component
        self.client = client
        self.block_size = block_size
        self.indexer = KvIndexer(component, block_size)
        self.aggregator = KvMetricsAggregator(client, poll_interval)
        self.scheduler = KvScheduler(
            component=component,
            selector=selector
            or DefaultWorkerSelector(host_tier_weight=host_tier_weight),
            block_size=block_size,
        )
        if pull_threshold_tokens:
            raise NotImplementedError(
                f"pull_threshold_tokens={pull_threshold_tokens}: the cross-worker prefix "
                "pull (llm/kv_router/pull.py) is not ported to dynamo_tpu_torch yet "
                "(ROADMAP M17, later); 0 routes every request toward its cache")
        self._started = False

    async def start(self) -> "KvRouter":
        if self._started:
            return self
        await self.indexer.start()
        await self.aggregator.start()
        self.component._drt.on_instance_down(self._on_instance_down)
        self._started = True
        return self

    def _on_instance_down(self, endpoint_id, worker_id: int) -> None:
        if endpoint_id.subject.startswith(
            f"{self.component.namespace.name}.{self.component.name}."
        ):
            self.indexer.remove_worker(worker_id)
            self.aggregator.mark_gone(worker_id)

    def _healthy_candidates(self, ids: list[int]) -> list[int]:
        """Health-aware routing (docs/robustness.md): drop workers whose
        heartbeat is stale (no stats reply within the aggregator horizon
        — a wedged engine can keep a healthy lease) or whose data-plane
        circuit breaker is open (recent transport failures). If that
        empties the pool, fall back to every live instance: routing to a
        suspect worker beats refusing service outright."""
        stale = self.aggregator.stale_workers(ids)
        open_brk = {
            wid for wid in ids
            if hasattr(self.client, "breaker_open")
            and self.client.breaker_open(wid)
        }
        bad = stale | open_brk
        if bad:
            from dynamo_tpu_torch.utils import counters

            counters.inc("router_workers_excluded_total", len(bad))
            if tracing.enabled():
                tracing.instant(
                    "kv_router.excluded", cat="router",
                    stale=sorted(stale), breaker_open=sorted(open_brk),
                )
        healthy = [w for w in ids if w not in bad]
        return healthy or ids

    async def schedule(
        self, token_ids: list[int], hashes: Optional[list[int]] = None
    ) -> SchedulingDecision:
        """Pick the worker for these tokens (reference:
        kv_router.rs:129-141 `schedule`). Pass `hashes` when the caller
        already chained the prompt's block hashes (KvPushRouter hashes
        once and also ships the chain to the worker — the prompt must
        never be hashed twice on the hot path)."""
        if hashes is None:
            hashes = compute_block_hashes(token_ids, self.block_size)
        overlaps = self.indexer.find_matches(hashes)
        candidates = self._healthy_candidates(self.client.instance_ids())
        workers = self.aggregator.endpoints_for(candidates)
        decision = await self.scheduler.schedule(
            workers, overlaps, isl_tokens=len(token_ids)
        )
        if decision is None:
            from dynamo_tpu_torch.runtime.client import NoInstancesError

            raise NoInstancesError(
                f"no live instances of {self.client.endpoint_id.subject}"
            )
        return decision

    async def close(self) -> None:
        await self.indexer.close()
        await self.aggregator.close()


class KvPushRouter(PushRouter):
    """PushRouter in mode "kv": schedule per request, then route direct
    (reference: PushRouter KV mode + examples/llm/components/kv_router.py)."""

    def __init__(self, client: Client, router: KvRouter):
        super().__init__(client, mode="kv")
        self.router = router

    @classmethod
    async def create(
        cls,
        component,
        client: Client,
        block_size: int = 16,
        selector: Optional[WorkerSelector] = None,
        pull_threshold_tokens: int = 0,
        host_tier_weight: float = 0.5,
    ) -> "KvPushRouter":
        router = KvRouter(
            component, client, block_size=block_size, selector=selector,
            pull_threshold_tokens=pull_threshold_tokens,
            host_tier_weight=host_tier_weight,
        )
        await router.start()
        return cls(client, router)

    async def generate(
        self, payload: Any, context: Optional[Context] = None
    ) -> AsyncIterator[Any]:
        token_ids = (
            payload.get("token_ids")
            if isinstance(payload, dict)
            else getattr(payload, "token_ids", None)
        )
        if not token_ids:
            # no token-level view (chat/completion-type models do their own
            # preprocessing): KV affinity is unknowable, load-balance instead
            return await self.client.generate(
                payload, context=context, mode="round_robin"
            )
        from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

        # hash ONCE: the same chain scores the workers here and rides
        # Context metadata to the chosen worker, whose engine rebuilds
        # its block sequence from it instead of re-hashing the prompt
        tbs = TokenBlockSequence(list(token_ids), self.router.block_size)
        seq_hashes = tbs.sequence_hashes()
        decision = await self.router.schedule(list(token_ids), hashes=seq_hashes)
        context = context or Context(payload)
        context.metadata["kv_block_size"] = self.router.block_size
        context.metadata["kv_seq_hashes"] = seq_hashes
        context.metadata["kv_local_hashes"] = [
            b.local_hash for b in tbs.blocks
        ]
        return await self.client.generate(
            payload, context=context, mode="direct", instance_id=decision.worker_id
        )
