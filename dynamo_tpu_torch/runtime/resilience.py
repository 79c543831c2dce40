"""Transport resilience primitives: jittered backoff + circuit breakers.

The reference leans on NATS/etcd semantics for these (leases expire dead
workers, the router stops picking them); our hub transport is plain TCP,
so the client layer needs its own:

- `Backoff` — capped exponential delays with full jitter. Every retrying
  site in the codebase draws delays from here so no two workers hammer a
  recovering peer in lockstep (the thundering-herd failure the reference
  avoids by NATS's own jittered reconnect).
- `CircuitBreaker` — per-endpoint failure accounting. `threshold`
  consecutive failures OPEN the breaker: the endpoint is skipped by
  routing for `cooldown_s`, then HALF-OPEN lets exactly one probe
  through; its outcome closes or re-opens the breaker. Open/close
  transitions are counted (`breaker_open_total`) and traced.

See docs/robustness.md for defaults and the breaker state machine.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Callable, Optional

from dynamo_tpu_torch.utils import counters, tracing
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.resilience")

# exception classes that mean "the transport, not the request, failed" —
# the only failures it is sound to retry or count against a breaker
TRANSIENT_ERRORS = (ConnectionError, OSError, asyncio.TimeoutError)


class StreamBrokenError(ConnectionError):
    """A response stream died MID-FLIGHT (transport break, injected
    worker death, or a lease-expiry break forced by the failover plane)
    — as opposed to a handle-establishment failure, which the client
    retries transparently. Carries the instance that was serving so
    failover detection and per-instance breakers key off the typed
    error instead of string-matching transport messages
    (docs/robustness.md "Request failover")."""

    def __init__(
        self,
        message: str,
        instance_id: Optional[int] = None,
        reason: str = "transport",
    ):
        super().__init__(message)
        self.instance_id = instance_id
        # "transport" | "lease_expired" | "breaker_open" | "injected"
        self.reason = reason


class Backoff:
    """Capped exponential backoff with full jitter:
    delay(n) = U(0, min(cap, base * factor**n))."""

    def __init__(
        self,
        base: float = 0.1,
        cap: float = 2.0,
        factor: float = 2.0,
        rng: Optional[random.Random] = None,
    ):
        self.base = base
        self.cap = cap
        self.factor = factor
        self._rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        """Jittered delay before retry `attempt` (0-based)."""
        return self._rng.uniform(
            0.0, min(self.cap, self.base * self.factor ** attempt)
        )

    def delay_hinted(
        self,
        attempt: int,
        retry_after_s: Optional[float] = None,
        deadline_epoch: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Jittered delay honoring a peer's Retry-After hint.

        A 429/503-shedding peer already computed when capacity returns
        (`retry_after_s` rides the typed DeadlineExceededError /
        PoolExhaustedError) — retrying sooner just re-sheds, so the hint
        FLOORS the jittered delay. `deadline_epoch` (absolute epoch
        seconds, the PR-6 request deadline) CAPS it: a delay that cannot
        finish inside the caller's budget returns None, meaning "do not
        retry — shed now"."""
        d = self.delay(attempt)
        if retry_after_s is not None and retry_after_s > 0:
            d = max(d, float(retry_after_s))
        if deadline_epoch is not None:
            remaining = deadline_epoch - (now if now is not None else time.time())
            if d >= remaining:
                return None
        return d


class CircuitBreaker:
    """Per-endpoint breaker: closed -> open after `threshold` consecutive
    failures; open -> half-open after `cooldown_s` (one probe allowed);
    half-open -> closed on probe success, -> open on probe failure.

    Thread-compatible (single event loop); `clock` is injectable for
    deterministic tests."""

    def __init__(
        self,
        threshold: int = 5,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
        on_open: Optional[Callable[[], None]] = None,
    ):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.name = name
        # fired on the closed -> open transition only (not on half-open
        # probe refailures): the failover plane uses it to break streams
        # still flowing to an endpoint the transport has condemned
        self.on_open = on_open
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False  # a half-open probe is in flight
        self._probe_at = 0.0   # when that probe claimed its slot

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """May a call go to this endpoint right now? MUTATING on a
        half-open breaker: it claims the single probe slot, so call it
        only for the instance actually being routed to (a filter
        predicate belongs on `state`). The probe's record_* decides what
        happens next; a claim whose call never reports back (hung, or
        an unexpected exception path) expires after `cooldown_s` so the
        breaker cannot wedge half-open forever."""
        s = self.state
        if s == "closed":
            return True
        if s == "half_open":
            now = self._clock()
            if self._probing and now - self._probe_at < self.cooldown_s:
                return False
            self._probing = True
            self._probe_at = now
            return True
        return False

    def record_success(self) -> None:
        if self._opened_at is not None:
            log.info("breaker %s closed (probe succeeded)", self.name)
            if tracing.enabled():
                tracing.instant("breaker.close", cat="transport",
                                endpoint=self.name)
        self._failures = 0
        self._opened_at = None
        self._probing = False

    def record_failure(self) -> None:
        self._probing = False
        if self._opened_at is not None:
            # half-open probe failed (or failures while open): restart
            # the cooldown window
            self._opened_at = self._clock()
            return
        self._failures += 1
        if self._failures >= self.threshold:
            self._opened_at = self._clock()
            counters.inc("breaker_open_total")
            log.warning(
                "breaker %s OPEN after %d consecutive failures "
                "(cooldown %.1fs)", self.name, self._failures, self.cooldown_s,
            )
            if tracing.enabled():
                tracing.instant(
                    "breaker.open", cat="transport", endpoint=self.name,
                    failures=self._failures,
                )
            if self.on_open is not None:
                try:
                    self.on_open()
                except Exception:  # noqa: BLE001 — listeners must not
                    # poison failure accounting
                    log.exception("breaker %s on_open hook failed", self.name)
