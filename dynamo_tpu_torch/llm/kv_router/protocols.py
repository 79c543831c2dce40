"""KV routing plane protocols.

Mirrors the reference's event/metric shapes (reference:
lib/llm/src/kv_router/protocols.rs:43-121): `RouterEvent` wraps a worker's
KV-cache event (stored/removed, parent-linked chained block hashes);
`ForwardPassMetrics` is the per-worker load snapshot the scheduler weighs.
Everything is plain dicts on the wire (msgpack via the hub event plane);
these dataclasses are the typed views.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

KV_EVENT_SUBJECT = "kv_events"
KV_HIT_RATE_SUBJECT = "kv-hit-rate"
LOAD_METRICS_ENDPOINT = "load_metrics"


@dataclass
class StoredBlock:
    block_hash: int          # chained sequence hash (identity in prefix context)
    tokens_hash: int         # local hash of the block's tokens
    page_id: int = 0         # worker-local page (informational)

    @classmethod
    def from_dict(cls, d: dict) -> "StoredBlock":
        return cls(
            block_hash=d["block_hash"],
            tokens_hash=d.get("tokens_hash", 0),
            page_id=d.get("page_id", 0),
        )


@dataclass
class KvCacheEvent:
    """type: "stored" | "removed" (reference: KvCacheEventData).

    `tier` distinguishes where the blocks live on the worker: "device"
    (HBM) or "host" (the offload pool, engine/offload.py) — a worker
    holds a block as long as ANY tier does."""

    type: str
    event_id: int = 0
    parent_hash: Optional[int] = None
    blocks: list[StoredBlock] = field(default_factory=list)   # stored
    block_hashes: list[int] = field(default_factory=list)      # removed
    block_size: int = 0
    tier: str = "device"

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KvCacheEvent":
        return cls(
            type=d["type"],
            event_id=d.get("event_id", 0),
            parent_hash=d.get("parent_hash"),
            blocks=[StoredBlock.from_dict(b) for b in d.get("blocks") or []],
            block_hashes=list(d.get("block_hashes") or []),
            block_size=d.get("block_size", 0),
            tier=d.get("tier", "device"),
        )


@dataclass
class RouterEvent:
    """reference: RouterEvent{worker_id, KvCacheEvent}."""

    worker_id: int
    event: KvCacheEvent

    def to_dict(self) -> dict:
        return {"worker_id": self.worker_id, "event": self.event.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "RouterEvent":
        return cls(worker_id=d["worker_id"], event=KvCacheEvent.from_dict(d["event"]))


@dataclass
class ForwardPassMetrics:
    """reference: protocols.rs:43-54 (+ the JAX package's SLO extension)."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    # prefix-cache hit rate of the worker's device tier. This is the ONLY
    # key (the older `gpu_prefix_cache_hit_rate` alias is gone); from_dict
    # ignores the old key from stale senders rather than erroring.
    prefix_cache_hit_rate: float = 0.0
    data_parallel_rank: int = 0
    # per-worker SLO attainment, {"tenant/metric": fraction} over the
    # worker's rolling window (llm/http/metrics.SloTracker.snapshot) —
    # folded through the stats scrape into KvMetricsAggregator so fleet
    # attainment is one aggregator read (the planner's scale signal).
    # Workers without a tracker send nothing; from_dict tolerates both.
    slo_attainment: dict = field(default_factory=dict)
    # disaggregated-serving counters from DisaggDecodeWorker.stats()
    # (remote/local prefill counts, remote-wait timeouts, last observed
    # prefill-queue depth) — empty on aggregated workers; from_dict
    # tolerates both (metrics_export renders them as labeled gauges)
    disagg: dict = field(default_factory=dict)
    # KV custody-ledger summary (engine/kv_ledger.py summary_counts():
    # violations/orphan_pages/audits/inflight/...) — the fleet's leak
    # census rides the same stats scrape as everything else; empty on
    # engines without a ledger, from_dict tolerates both
    kv_ledger: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ForwardPassMetrics":
        known = {f: d.get(f) for f in cls.__dataclass_fields__ if f in d}
        for optional in ("slo_attainment", "disagg", "kv_ledger"):
            if known.get(optional) is None:
                known.pop(optional, None)
        return cls(**known)


@dataclass
class KVHitRateEvent:
    """Emitted per routing decision (reference: scheduler.rs:32)."""

    worker_id: int
    isl_blocks: int
    overlap_blocks: int

    def to_dict(self) -> dict:
        return asdict(self)
