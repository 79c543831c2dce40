"""Process-global named health counters (a copy of the JAX package's
`utils/counters.py`).

The robustness plane spans layers that must not import each other's
metrics machinery (the hub client cannot depend on ``llm/http``), yet a
single ``GET /metrics`` scrape has to tell the whole story: lease churn,
transport retries, breaker trips, injected faults. This module is the
meeting point — a flat, thread-safe ``name -> float`` registry any layer
can increment, plus a renderable (`PromCounters`) that plugs into
``ServiceMetrics.extra`` so the counters ride the existing Prometheus
exposition (see llm/http/metrics.py).

Counter inventory (incremented where the event happens):

- ``hub_reconnects_total``       — keepalive thread re-established its
                                   hub connection (runtime/hub/client.py)
- ``lease_expired_total``        — a keepalive found its lease already
                                   expired hub-side (silent worker death)
- ``client_retries_total``       — data-plane request re-attempted after
                                   a transport failure (runtime/client.py)
- ``breaker_open_total``         — a per-endpoint circuit breaker opened
- ``router_workers_excluded_total`` — KV-router candidates dropped for
                                   stale heartbeats / open breakers
- ``faults_injected_total``      — faults actually fired (utils/faults.py)
"""

from __future__ import annotations

import threading
from typing import Iterable

_lock = threading.Lock()
_values: dict[str, float] = {}
_declared: set[str] = set()


def declare(name: str) -> None:
    """Register a counter so it renders a zero-valued series BEFORE its
    first increment (the histograms' zero-series rule, applied to the
    registry): dashboards and rate() queries need the series to exist
    from the first scrape, not from the first event."""
    with _lock:
        _declared.add(name)


def inc(name: str, amount: float = 1.0) -> None:
    with _lock:
        _values[name] = _values.get(name, 0.0) + amount


def get(name: str) -> float:
    with _lock:
        return _values.get(name, 0.0)


def snapshot() -> dict[str, float]:
    with _lock:
        return dict(_values)


def reset() -> None:
    """Zero everything (tests only — Prometheus counters never reset in
    production, resets break rate() queries)."""
    with _lock:
        _values.clear()
        _declared.clear()


class PromCounters:
    """Prometheus-text renderable over the global registry; append to
    ``ServiceMetrics.extra`` so one scrape covers every layer's health
    counters. Known counters render 0 before their first increment —
    scrapers need the series to exist from the first scrape."""

    KNOWN = (
        "hub_reconnects_total",
        "lease_expired_total",
        "client_retries_total",
        "breaker_open_total",
        "router_workers_excluded_total",
        "faults_injected_total",
    )

    def __init__(self, prefix: str = "dynamo_tpu"):
        self._prefix = prefix

    def render(self) -> Iterable[str]:
        with _lock:
            vals = dict(_values)
            declared = set(_declared)
        for name in sorted(set(self.KNOWN) | declared | set(vals)):
            full = f"{self._prefix}_{name}"
            yield f"# TYPE {full} counter"
            yield f"{full} {float(vals.get(name, 0.0))}"
