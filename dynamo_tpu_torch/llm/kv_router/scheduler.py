"""KV-aware worker selection.

Ports the reference's decision logic, not its plumbing (reference:
lib/llm/src/kv_router/scheduler.rs:236-339): a pluggable `WorkerSelector`
scores each candidate worker

    logit = 2 * (overlap_blocks * block_size / isl_tokens)
            - gpu_cache_usage_perc
            - active_slots / max(active_slots across workers)

(the formula at scheduler.rs:290, with active slots normalized by the
max across candidate workers as the reference does) and the best logit
wins, ties broken randomly. Every decision emits a KVHitRateEvent on the component's
`kv-hit-rate` subject for the metrics plane.

Deliberate deviation: when max_active == 0 the reference returns a
NoEndpoints error (scheduler.rs:263); here every worker being idle simply
zeroes the slot term — an all-idle pool is a fine place to schedule, not
an error.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Protocol

from dynamo_tpu_torch.llm.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, KVHitRateEvent
from dynamo_tpu_torch.utils import tracing


@dataclass
class SchedulingDecision:
    worker_id: int
    overlap_blocks: int
    logit: float
    # cross-worker prefix pull (docs/kv_cache.md): when the best-overlap
    # worker was saturated, `worker_id` is the alternative the request
    # routes to and `pull_from` names the holder it should pull the
    # prefix from instead of recomputing it; None = no pull. The port's
    # router never sets them (the pull is not ported, ROADMAP M17).
    pull_from: Optional[int] = None
    pull_tokens: int = 0


class WorkerSelector(Protocol):
    def select(
        self,
        workers: dict[int, ForwardPassMetrics],
        overlaps: OverlapScores,
        isl_tokens: int,
        block_size: int,
    ) -> Optional[SchedulingDecision]: ...


class DefaultWorkerSelector:
    def __init__(
        self,
        rng: Optional[random.Random] = None,
        host_tier_weight: float = 0.5,
    ):
        self._rng = rng or random.Random()
        # host-tier blocks weigh below device-tier in the overlap term:
        # a host hit still pays an H2D restore (and the worker's cost
        # gate may decline it), so it must not tie with free device
        # reuse. 0.0 ignores the host tier entirely; 1.0 restores the
        # tier-blind pre-PR behavior.
        self.host_tier_weight = host_tier_weight

    def select(
        self,
        workers: dict[int, ForwardPassMetrics],
        overlaps: OverlapScores,
        isl_tokens: int,
        block_size: int,
    ) -> Optional[SchedulingDecision]:
        if not workers:
            return None
        # reference normalizes active slots by the max across candidate
        # workers (scheduler.rs:252-290); max_active == 0 means every
        # worker is idle and the slot term vanishes
        max_active = max(m.request_active_slots for m in workers.values())
        best: list[tuple[int, int, float]] = []  # (worker, overlap, logit)
        for wid, m in workers.items():
            overlap = overlaps.scores.get(wid, 0)
            # tier-weighted overlap: device blocks full weight, host
            # blocks discounted (older events predate the tier split and
            # land in `scores` only — treat the untagged remainder as
            # device so the formula degrades to the reference's)
            host = overlaps.host_scores.get(wid, 0)
            dev = overlap - host
            eff = dev + self.host_tier_weight * host
            score = 2.0 * (eff * block_size / max(isl_tokens, 1))
            usage = m.gpu_cache_usage_perc
            slots = m.request_active_slots / max_active if max_active else 0.0
            logit = score - usage - slots
            if not best or logit > best[0][2] + 1e-9:
                best = [(wid, overlap, logit)]
            elif abs(logit - best[0][2]) <= 1e-9:
                best.append((wid, overlap, logit))
        wid, overlap, logit = self._rng.choice(best)
        return SchedulingDecision(worker_id=wid, overlap_blocks=overlap, logit=logit)


class KvScheduler:
    """Selector + hit-rate emission (reference: scheduler.rs:181-339)."""

    def __init__(
        self,
        component=None,
        selector: Optional[WorkerSelector] = None,
        block_size: int = 16,
    ):
        self.component = component
        self.selector = selector or DefaultWorkerSelector()
        self.block_size = block_size

    async def schedule(
        self,
        workers: dict[int, ForwardPassMetrics],
        overlaps: OverlapScores,
        isl_tokens: int,
    ) -> Optional[SchedulingDecision]:
        decision = self.selector.select(
            workers, overlaps, isl_tokens, self.block_size
        )
        if decision is not None and tracing.enabled():
            # request id rides the contextvar (schedule() runs inside the
            # frontend handler's task tree) — the span shows WHICH worker
            # won and why next to the request's preprocess/engine spans
            tracing.instant(
                "kv_router.decision", cat="router",
                worker_id=decision.worker_id,
                overlap_blocks=decision.overlap_blocks,
                logit=round(decision.logit, 4),
                isl_tokens=isl_tokens,
            )
        if decision is not None and self.component is not None:
            import asyncio

            from dynamo_tpu_torch.utils import msgpack

            from dynamo_tpu_torch.llm.kv_router.protocols import KV_HIT_RATE_SUBJECT

            ev = KVHitRateEvent(
                worker_id=decision.worker_id,
                isl_blocks=-(-isl_tokens // self.block_size),
                overlap_blocks=decision.overlap_blocks,
            )
            # fire-and-forget: telemetry must not add a hub RTT to TTFT
            task = asyncio.create_task(
                self.component.publish(KV_HIT_RATE_SUBJECT, msgpack.packb(ev.to_dict()))
            )
            task.add_done_callback(
                lambda t: None if t.cancelled() else t.exception()
            )
        return decision
