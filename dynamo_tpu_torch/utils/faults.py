"""Deterministic fault injection for chaos testing (a copy of the JAX
package's `utils/faults.py`: the same grammar and the same seeded
`random.Random`, so one spec fires at the same hits in both engines).

The reference system survives partial failure by construction (NATS leases
expire dead workers, the frontend kills abandoned requests) but proving a
reproduction survives requires *injecting* the failures on demand — and a
chaos test that cannot replay the exact same fault sequence twice cannot
bisect a regression. This registry gives every failure-prone site a named
**fault point** that production code checks in one call:

    from dynamo_tpu_torch.utils import faults
    faults.fire("engine.dispatch")        # sync sites (worker threads)
    await faults.afire("hub.send")        # async sites (event loop)

When nothing is configured the check is a single module-global flag test —
effectively compiled to a no-op — so the hot path pays nothing in
production.

Configuration comes from ``DYN_FAULTS`` (or ``configure()`` in tests), a
comma-separated list of ``point.action`` specs:

    DYN_FAULTS="engine.dispatch.delay=0.5,hub.send.drop@3,kv_transfer.fail"

Grammar per entry (the LAST dotted component is the action)::

    <point>.<action>[=<value>][@<hit>][x<count>][~<prob>]

    action   delay  — sleep <value> seconds at the site (default 0.1)
             fail   — raise FaultError (typed; sites map it to their own
                      contained-failure path)
             drop   — raise ConnectionError (transport sites: simulates
                      the peer vanishing mid-conversation)
    @<hit>   arm starting at the <hit>-th arrival (1-based; default 1)
    x<count> fire at most <count> times, then disarm (default unlimited)
    ~<prob>  fire with probability <prob> per eligible arrival, drawn
             from a dedicated RNG seeded by DYN_FAULTS_SEED (default 0)
             so probabilistic chaos runs are still reproducible

Every arrival and every firing is counted per point (``stats()``), and the
process-wide fired total is mirrored into the ``faults_injected_total``
counter (utils/counters.py) so an injected-fault run is self-describing on
``/metrics``. The engine's points: ``engine.reserve``, ``engine.prefill``,
``engine.mixed``, ``engine.dispatch``, ``engine.release`` and
``kv_transfer``.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.utils import counters
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.faults")

ACTIONS = ("delay", "fail", "drop")


class FaultError(RuntimeError):
    """An injected 'fail' fault. Sites catch it exactly where they catch
    their real failure class, so the contained-failure path under test is
    the production one."""


@dataclass
class FaultPoint:
    name: str            # dotted site name, e.g. "engine.dispatch"
    action: str          # delay | fail | drop
    value: float = 0.1   # delay seconds (delay action only)
    at: int = 1          # arm from this arrival (1-based)
    count: Optional[int] = None  # max firings; None = unlimited
    prob: Optional[float] = None  # per-arrival firing probability
    hits: int = 0        # arrivals observed
    fired: int = 0       # faults actually injected

    def _should_fire(self, rng: random.Random) -> bool:
        if self.hits < self.at:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.prob is not None and rng.random() >= self.prob:
            return False
        return True


_lock = threading.Lock()
_points: dict[str, list[FaultPoint]] = {}
_rng = random.Random(0)
_active = False  # fast-path flag: no registry lookups when unset


def _parse_entry(entry: str) -> FaultPoint:
    spec = entry.strip()
    if not spec:
        raise ValueError("empty fault spec")
    # suffixes bind tighter than the point/action split: peel ~p, xN, @N
    prob = None
    if "~" in spec:
        spec, _, p = spec.rpartition("~")
        prob = float(p)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault probability {prob} outside [0, 1]")
    count = None
    if "x" in spec.rsplit(".", 1)[-1]:
        head, _, c = spec.rpartition("x")
        if c.isdigit():
            spec, count = head, int(c)
    at = 1
    if "@" in spec:
        spec, _, a = spec.rpartition("@")
        at = int(a)
        if at < 1:
            raise ValueError(f"fault @hit must be >= 1 (got {at})")
    value = 0.1
    if "=" in spec:
        spec, _, v = spec.partition("=")
        value = float(v)
    point, _, action = spec.rpartition(".")
    if action not in ACTIONS:
        raise ValueError(
            f"unknown fault action {action!r} in {entry!r}; "
            f"expected one of {ACTIONS}"
        )
    if not point:
        raise ValueError(f"fault spec {entry!r} names no point")
    return FaultPoint(
        name=point, action=action, value=value, at=at, count=count, prob=prob
    )


def configure(spec: Optional[str] = None, seed: Optional[int] = None) -> int:
    """Install fault points from a DYN_FAULTS-grammar string (None/"" =
    clear). Returns the number of points installed. Tests call this
    directly; production processes pick the env var up via `load_env()`
    at import of the first instrumented module."""
    global _active, _rng
    pts: dict[str, list[FaultPoint]] = {}
    for entry in (spec or "").split(","):
        if not entry.strip():
            continue
        fp = _parse_entry(entry)
        pts.setdefault(fp.name, []).append(fp)
    with _lock:
        _points.clear()
        _points.update(pts)
        _rng = random.Random(
            seed if seed is not None
            else int(os.environ.get("DYN_FAULTS_SEED", "0"))
        )
        _active = bool(_points)
    if _active:
        log.warning(
            "fault injection ARMED: %s",
            ", ".join(f"{p.name}.{p.action}" for v in pts.values() for p in v),
        )
    return sum(len(v) for v in pts.values())


_env_loaded = False


def load_env() -> int:
    """Configure from ``DYN_FAULTS`` if set. Parses the env at most once
    per process — instrumented modules call this at init, and a second
    engine/client must not zero the first one's hit counters. Tests use
    `configure()` directly, which always replaces the registry."""
    global _env_loaded
    if _env_loaded:
        return 0
    _env_loaded = True
    spec = os.environ.get("DYN_FAULTS")
    if not spec:
        return 0
    return configure(spec)


def reset() -> None:
    """Clear every fault point (test teardown)."""
    configure(None)


def active() -> bool:
    return _active


def install(point: FaultPoint) -> None:
    """Add one programmatic fault point (tests)."""
    global _active
    with _lock:
        _points.setdefault(point.name, []).append(point)
        _active = True


def _check(name: str) -> Optional[FaultPoint]:
    """Count an arrival at `name`; return the point to fire, if any.
    Mutates hit/fired counters under the lock so concurrent worker
    threads see a consistent deterministic sequence."""
    with _lock:
        pts = _points.get(name)
        if not pts:
            return None
        chosen = None
        for p in pts:
            p.hits += 1
            if chosen is None and p._should_fire(_rng):
                p.fired += 1
                chosen = p
        if chosen is not None:
            counters.inc("faults_injected_total")
        return chosen


def _raise_for(p: FaultPoint) -> None:
    log.warning("injected fault %s.%s (hit %d)", p.name, p.action, p.hits)
    if p.action == "drop":
        raise ConnectionError(f"injected drop at {p.name}")
    raise FaultError(f"injected failure at {p.name}")


def fire(name: str) -> None:
    """Synchronous fault check (worker threads / loop-safe fast path).
    `delay` blocks the calling thread — call from worker threads only."""
    if not _active:
        return
    p = _check(name)
    if p is None:
        return
    if p.action == "delay":
        log.warning(
            "injected delay %.3fs at %s (hit %d)", p.value, p.name, p.hits
        )
        time.sleep(p.value)
        return
    _raise_for(p)


async def afire(name: str) -> None:
    """Async fault check for event-loop sites (delays don't block the
    loop's other tasks)."""
    if not _active:
        return
    p = _check(name)
    if p is None:
        return
    if p.action == "delay":
        log.warning(
            "injected delay %.3fs at %s (hit %d)", p.value, p.name, p.hits
        )
        await asyncio.sleep(p.value)
        return
    _raise_for(p)


def stats() -> dict[str, dict[str, int]]:
    """{point: {hits, fired}} snapshot (merged across a point's specs)."""
    out: dict[str, dict[str, int]] = {}
    with _lock:
        for name, pts in _points.items():
            out[name] = {
                "hits": max(p.hits for p in pts),
                "fired": sum(p.fired for p in pts),
            }
    return out


def fired_total() -> int:
    with _lock:
        return sum(p.fired for pts in _points.values() for p in pts)
