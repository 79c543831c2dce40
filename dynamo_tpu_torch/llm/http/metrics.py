"""Prometheus-format service metrics (no external prometheus dependency).

Equivalent of the reference's HTTP metrics (reference:
lib/llm/src/http/service/metrics.rs:36-201): `{prefix}_requests_total`
(model/endpoint/status labels), `{prefix}_inflight_requests`,
`{prefix}_request_duration_seconds` histogram, plus the RAII
`InflightGuard` that records status on exit.

A copy of the JAX package's `llm/http/metrics.py` without `EngineMetrics`
and `SloTracker` (the engine's histograms and SLO attainment, M12/M17).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Iterable

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_le(bound: float) -> str:
    """Bucket `le` label value: canonical float repr ("1.0", "0.005",
    "+Inf"), never locale-dependent and never the bare-int "1" an
    int-typed bucket tuple would produce via str() — consecutive scrapes
    must diff cleanly whatever Python built the bucket bounds."""
    f = float(bound)
    if f == float("inf"):
        return "+Inf"
    return repr(f)


class Counter:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = defaultdict(float)

    def declare(self, **labels: str) -> None:
        """Materialize a labeled series at 0 BEFORE its first increment
        (the Histogram zero-series rule applied to counters): rate()
        queries and dashboards need the series present from the first
        scrape, and a counter that appears mid-flight reads as a reset."""
        self._values.setdefault(tuple(sorted(labels.items())), 0.0)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        self._values[tuple(sorted(labels.items()))] += amount

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        if not self._values:
            yield f"{self.name} 0"
        # sorted keys: consecutive scrapes diff cleanly whatever order
        # the series were first touched in
        for key in sorted(self._values):
            yield f"{self.name}{_fmt_labels(dict(key))} {self._values[key]}"


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = defaultdict(float)

    def declare(self, **labels: str) -> None:
        """Materialize a labeled series at 0 before its first set/add
        (see Counter.declare)."""
        self._values.setdefault(tuple(sorted(labels.items())), 0.0)

    def set(self, value: float, **labels: str) -> None:
        self._values[tuple(sorted(labels.items()))] = value

    def add(self, amount: float, **labels: str) -> None:
        self._values[tuple(sorted(labels.items()))] += amount

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        if not self._values:
            yield f"{self.name} 0"
        for key in sorted(self._values):
            yield f"{self.name}{_fmt_labels(dict(key))} {self._values[key]}"


class Histogram:
    def __init__(self, name: str, help_: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = buckets
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        if key not in self._counts:
            self._counts[key] = [0] * len(self.buckets)
        # per-bucket counts here; render() accumulates into cumulative form
        for i, b in enumerate(self.buckets):
            if value <= b:
                self._counts[key][i] += 1
                break
        self._sums[key] += value
        self._totals[key] += 1

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        # the unlabeled base series ALWAYS renders (zero before any
        # observation, and it stays once labeled series appear): scrapers
        # and rate() queries need _sum/_count points to exist from the
        # first scrape AND never go stale later — a series that appears,
        # vanishes and reappears breaks continuity. Sorted keys + .get
        # (no defaultdict insertion side effects) keep scrapes diffable.
        for key in sorted({(), *self._counts}):
            counts = self._counts.get(key) or [0] * len(self.buckets)
            labels = dict(key)
            total = self._totals.get(key, 0)
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                yield f'{self.name}_bucket{_fmt_labels({**labels, "le": _fmt_le(b)})} {cum}'
            yield f'{self.name}_bucket{_fmt_labels({**labels, "le": "+Inf"})} {total}'
            yield f"{self.name}_sum{_fmt_labels(labels)} {self._sums.get(key, 0.0)}"
            yield f"{self.name}_count{_fmt_labels(labels)} {total}"


class ServiceMetrics:
    def __init__(self, prefix: str = "dynamo_tpu"):
        self._prefix = prefix
        self.requests_total = Counter(
            f"{prefix}_http_service_requests_total", "Total HTTP LLM requests"
        )
        self.inflight = Gauge(
            f"{prefix}_http_service_inflight_requests", "In-flight HTTP LLM requests"
        )
        self.duration = Histogram(
            f"{prefix}_http_service_request_duration_seconds",
            "HTTP LLM request duration",
        )
        self.extra: list = []  # extra renderables (engine metrics etc.)

    def inflight_guard(self, model: str, endpoint: str) -> "InflightGuard":
        return InflightGuard(self, model, endpoint)

    def render(self) -> str:
        # leading instance-info series (build_info convention): the ONE
        # place a scrape names the emitting process, joinable in PromQL
        # against every other series of this endpoint — multi-worker
        # fleets attribute scrapes without labeling every series
        from dynamo_tpu_torch.utils import instance

        lines: list[str] = [
            f"# TYPE {self._prefix}_instance_info gauge",
            f'{self._prefix}_instance_info'
            f'{{worker_id="{instance.worker_id()}"}} 1',
        ]
        for metric in (self.requests_total, self.inflight, self.duration, *self.extra):
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"


class InflightGuard:
    """RAII request accounting (reference: metrics.rs:201 InflightGuard)."""

    def __init__(self, metrics: ServiceMetrics, model: str, endpoint: str):
        self._m = metrics
        self._model = model
        self._endpoint = endpoint
        self._start = time.monotonic()
        self.status = "error"
        self._m.inflight.add(1, model=model)

    def mark_ok(self) -> None:
        self.status = "success"

    def close(self) -> None:
        self._m.inflight.add(-1, model=self._model)
        self._m.requests_total.inc(
            1, model=self._model, endpoint=self._endpoint, status=self.status
        )
        self._m.duration.observe(time.monotonic() - self._start, model=self._model)
