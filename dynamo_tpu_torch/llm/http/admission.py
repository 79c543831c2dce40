"""Frontend admission control: shed lowest-priority tenants first under
overload (docs/control.md "Admission ladder").

The fault-tolerance spine types the shed responses — 429 +
Retry-After for "back off and retry" and 503 + Retry-After for "capacity
is gone" — but only sheds on per-request deadlines and pool exhaustion,
i.e. AFTER work was attempted. This gate sheds at the front door, before
any tokenization or engine work, from the same two signals the planner
scales on:

- **queue depth** — requests waiting for a decode slot (per-worker mean
  for a fleet; the local engine's ``num_requests_waiting`` standalone);
- **attainment burn** — the worst (tenant, metric) rolling SLO fraction
  (`SloTracker` locally, `KvMetricsAggregator.attainment()` fleet-wide).

Tenant **priority classes** ride the same ``--slo-targets`` config file
that defines the SLO targets: a tenant spec may carry ``"priority": int``
(higher = more important; unconfigured tenants inherit the "default"
entry, else priority 0). The admitted request's class is stamped into
Context metadata as ``priority`` and becomes ``Sequence.priority`` — the
engine's admission picks and preemption-victim selection use it, so the
ladder is consistent end to end: under overload the frontend sheds the
lowest class, and whatever low-priority work is already inside yields
pages to interactive tenants first (engine/scheduler.py).

Ladder (evaluated per request, signals cached ``eval_interval_s``):

| state    | condition                                   | action |
|----------|---------------------------------------------|--------|
| ok       | neither condition below                     | admit all |
| overload | attainment burning AND queue > watermark    | priority < ``overload_shed_below`` -> 429 + Retry-After |
| critical | overload AND queue > ``critical_factor`` x watermark | priority < top configured class -> 503 + Retry-After |

429 means "you, specifically, should back off" (the tenant's class was
shed); 503 means "capacity is gone for everyone but the top class" — the
same status semantics as the deadline/pool ladder.

The JAX package's `llm/http/admission.py` on the port's `Counter` and
`Gauge`: the same verdicts on the same signals. Standalone, the queue
signal is the local TorchEngine's ``num_requests_waiting`` and the
attainment its `SloTracker`'s (`run.py --admission`); the fleet signals
of the ingress modes wait for the runtime (ROADMAP M17).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from dynamo_tpu_torch.llm.http.metrics import Counter, Gauge
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.admission")


def priorities_from_targets(targets: Optional[dict]) -> dict[str, int]:
    """Extract per-tenant priority classes from the --slo-targets file
    shape ({tenant: {"ttft_s": ..., "priority": int}}). Tenants without
    a priority key get class 0."""
    out: dict[str, int] = {}
    for tenant, spec in (targets or {}).items():
        try:
            out[tenant] = int((spec or {}).get("priority") or 0)
        except (TypeError, ValueError):
            out[tenant] = 0
    return out


@dataclass
class Shed:
    """A shed verdict: HTTP status + Retry-After seconds + message."""

    status: int
    retry_after_s: int
    message: str


@dataclass
class AdmissionConfig:
    # overload watermark: mean waiting requests per live worker (the
    # planner's queue signal); standalone engines count as one worker
    queue_high_watermark: float = 8.0
    # attainment burn threshold (worst tenant, rolling window); keep in
    # step with PlannerConfig.slo_attainment_target
    attainment_floor: float = 0.99
    # queue over critical_factor * watermark escalates overload->critical
    critical_factor: float = 2.0
    # shed classes strictly below this priority under overload (default:
    # class 0, the unconfigured/batch tier)
    overload_shed_below: int = 1
    retry_after_s: int = 1
    # signal cache TTL so a request burst doesn't hammer engine.metrics()
    eval_interval_s: float = 0.25


class AdmissionController:
    """Per-request admission verdicts from live overload signals.

    ``queue_depth_fn`` returns the current waiting-request depth (per
    worker); ``attainment_fn`` returns the worst rolling SLO fraction or
    None when unknown (no targets configured -> never burning). Both are
    plain callables so the controller wires identically to a local
    engine (engine.metrics / SloTracker) or a fleet aggregator
    (KvMetricsAggregator), and tests drive it with lambdas."""

    def __init__(
        self,
        priorities: Optional[dict[str, int]] = None,
        cfg: Optional[AdmissionConfig] = None,
        queue_depth_fn: Optional[Callable[[], float]] = None,
        attainment_fn: Optional[Callable[[], Optional[float]]] = None,
        prefix: str = "dynamo_tpu",
    ):
        self.priorities = dict(priorities or {})
        self.cfg = cfg or AdmissionConfig()
        self._queue_depth_fn = queue_depth_fn
        self._attainment_fn = attainment_fn
        self._top = max(self.priorities.values(), default=0)
        self._state = "ok"
        self._last_eval = 0.0
        self._last_queue = 0.0
        self._last_attain: Optional[float] = None
        self.shed_total = Counter(
            f"{prefix}_admission_shed_total",
            "Requests shed at the front door by the admission ladder",
        )
        self.state_gauge = Gauge(
            f"{prefix}_admission_state",
            "Admission ladder state (0=ok, 1=overload, 2=critical)",
        )
        self.state_gauge.set(0.0)

    # ------------------------------------------------------------- signals

    def bind(
        self,
        queue_depth_fn: Optional[Callable[[], float]] = None,
        attainment_fn: Optional[Callable[[], Optional[float]]] = None,
    ) -> "AdmissionController":
        """Late-bind the overload signals (the engine / aggregator often
        exists only after the controller is configured)."""
        if queue_depth_fn is not None:
            self._queue_depth_fn = queue_depth_fn
        if attainment_fn is not None:
            self._attainment_fn = attainment_fn
        return self

    @property
    def state(self) -> str:
        """Last evaluated ladder state ("ok"/"overload"/"critical") —
        refreshed by request traffic through check(); read-only for
        dashboards and harnesses (no signal evaluation, no shed
        counting)."""
        return self._state

    def priority_of(self, tenant: str) -> int:
        """Tenant's priority class: its own entry, else the "default"
        entry, else 0 — mirrors SloTracker._resolve fall-through."""
        if tenant in self.priorities:
            return self.priorities[tenant]
        return self.priorities.get("default", 0)

    def _evaluate(self, now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        if now - self._last_eval < self.cfg.eval_interval_s and self._last_eval:
            return self._state
        self._last_eval = now
        try:
            queue = float(self._queue_depth_fn()) if self._queue_depth_fn else 0.0
        except Exception:  # noqa: BLE001 — a broken signal must fail OPEN
            # (admit): shedding everyone on a metrics hiccup is an outage
            queue = 0.0
        try:
            attain = self._attainment_fn() if self._attainment_fn else None
        except Exception:  # noqa: BLE001
            attain = None
        self._last_queue = queue
        self._last_attain = attain
        burning = attain is not None and attain < self.cfg.attainment_floor
        state = "ok"
        if burning and queue > self.cfg.queue_high_watermark:
            state = "overload"
            if queue > self.cfg.critical_factor * self.cfg.queue_high_watermark:
                state = "critical"
        if state != self._state:
            log.info(
                "admission state %s -> %s (queue=%.1f attain=%s)",
                self._state, state, queue,
                f"{attain:.4f}" if attain is not None else "n/a",
            )
        self._state = state
        self.state_gauge.set({"ok": 0.0, "overload": 1.0, "critical": 2.0}[state])
        return state

    # ------------------------------------------------------------- verdict

    def _row(self, tenant: str) -> str:
        """Metrics row for a tenant: its own CONFIGURED name, else
        "default" — the SloTracker._resolve rule. The x-tenant-id
        header is attacker-controlled; labeling counters with the raw
        value would let unique headers mint unbounded Prometheus series
        exactly during an overload episode."""
        return tenant if tenant in self.priorities else "default"

    def check(self, tenant: str) -> Optional[Shed]:
        """None = admit; otherwise the typed shed verdict. Lowest
        priority sheds first; the top configured class is never shed by
        this gate (deadline/pool conditions downstream still apply) —
        the overload threshold is clamped to the top class, so with no
        priority classes configured at all the gate is inert rather
        than shedding 100% of (uniform-class) traffic."""
        state = self._evaluate()
        if state == "ok":
            return None
        prio = self.priority_of(tenant)
        if state == "critical" and prio < self._top:
            self.shed_total.inc(tenant=self._row(tenant), level="critical")
            return Shed(
                503, self.cfg.retry_after_s,
                "service overloaded; low-priority traffic shed",
            )
        if prio < min(self.cfg.overload_shed_below, self._top):
            self.shed_total.inc(tenant=self._row(tenant), level="overload")
            return Shed(
                429, self.cfg.retry_after_s,
                "service overloaded; retry after backoff",
            )
        return None

    def render(self) -> Iterable[str]:
        """ServiceMetrics.extra renderable: the ladder state and shed
        counters ride the same /metrics scrape as everything else."""
        yield from self.state_gauge.render()
        yield from self.shed_total.render()
