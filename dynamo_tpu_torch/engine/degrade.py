"""Degrade ladder: ordered feature shedding with re-probe recovery (a copy
of the JAX package's `engine/degrade.py`).

Until now the engine had exactly one graceful-degradation path — the
one-way ``mixed_disabled`` trip when a mixed dispatch fails. This module
generalizes it into a **ladder**: an ordered list of rungs, each naming a
feature the engine can serve without, walked top-down by the watchdog
when a dispatch hangs (engine.py `_watchdog_loop`):

    step_pipeline  →  spec  →  mixed  →  decode_scan

The order is "shed the most speculative machinery first": the step
pipeline overlaps dispatches (most timing-sensitive), speculative decode
adds data-dependent verify windows, mixed steps fuse the two planes, and
`decode_scan` last — tripping it drops multi-step decode scans to one
step per dispatch, the maximally-conservative serialized baseline that
still makes progress.

Every non-permanent trip arms a **re-probe timer**: after ``reprobe_s``
the rung re-enables itself on the next `disabled()` check, so a feature
disabled by a transient fault (a slow host, a one-off compile storm)
recovers without a restart — if the fault persists the watchdog simply
trips it again. Permanent trips (a dispatch family that *failed*, not
stalled — retrying it every tick would wedge the loop) never re-probe.

State transitions are counted (`counters`) and emitted as trace instants
so the trace shows exactly when and why a feature came and went.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from dynamo_tpu_torch.utils import tracing
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.degrade")

# ladder order: first untripped rung is the next to shed
RUNGS = ("step_pipeline", "spec", "mixed", "decode_scan")

_PERMANENT = float("inf")


class DegradeLadder:
    """Tracks which feature rungs are currently shed and when each
    re-probes. Single-threaded from the engine loop's perspective;
    `disabled()` is also read from dispatch worker threads, where a
    slightly-stale answer is harmless (the loop is the only writer)."""

    def __init__(
        self,
        reprobe_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        on_trip: Optional[Callable[[str, str], None]] = None,
    ):
        self.reprobe_s = reprobe_s
        self._clock = clock
        # fired once per NEW trip with (rung, reason) — the engine uses
        # it to invalidate rate calibrations (restore-gate EMAs) that
        # were measured on the pre-degrade configuration. Exceptions are
        # contained: a bad observer must not block the shed itself.
        self._on_trip = on_trip
        # rung -> re-enable deadline (monotonic); _PERMANENT = never
        self._tripped: dict[str, float] = {}
        self.degrades_total = 0
        self.recoveries_total = 0

    # ------------------------------------------------------------ queries

    def disabled(self, rung: str) -> bool:
        """Is `rung` currently shed? Re-probe timers are evaluated here,
        so expired rungs recover lazily on their next gate check — no
        timer task needed."""
        deadline = self._tripped.get(rung)
        if deadline is None:
            return False
        if deadline is not _PERMANENT and self._clock() >= deadline:
            self._recover(rung)
            return False
        return True

    def tripped(self, rung: str) -> bool:
        """Non-probing read for metrics/state dumps (a scrape must not
        flip engine behavior the way `disabled()` lazily can)."""
        return rung in self._tripped

    def state(self) -> dict[str, int]:
        """{degraded_<rung>: 0/1} for metrics() — reads do not re-probe
        (a /metrics scrape must not flip engine behavior)."""
        return {f"degraded_{r}": int(r in self._tripped) for r in RUNGS}

    def any_tripped(self) -> bool:
        return bool(self._tripped)

    def mask(self) -> int:
        """Bit i set = RUNGS[i] currently tripped — the compact degrade
        field of a flight-recorder step digest (non-probing read, like
        `state()`)."""
        m = 0
        for i, rung in enumerate(RUNGS):
            if rung in self._tripped:
                m |= 1 << i
        return m

    # ------------------------------------------------------ transitions

    def trip(self, rung: str, reason: str, permanent: bool = False) -> None:
        if rung not in RUNGS:
            raise ValueError(f"unknown degrade rung {rung!r}")
        already = rung in self._tripped
        self._tripped[rung] = (
            _PERMANENT if permanent else self._clock() + self.reprobe_s
        )
        if already:
            return  # timer extended; not a new degrade
        self.degrades_total += 1
        log.warning(
            "degrade: %s disabled (%s)%s", rung, reason,
            " permanently" if permanent
            else f"; re-probe in {self.reprobe_s:.1f}s",
        )
        if tracing.enabled():
            tracing.instant(
                "degrade.trip", cat="degrade", rung=rung, reason=reason,
                permanent=permanent,
            )
        if self._on_trip is not None:
            try:
                self._on_trip(rung, reason)
            except Exception:  # noqa: BLE001 — observer must not block the shed
                log.exception("degrade on_trip hook failed")

    def trip_next(self, reason: str) -> Optional[str]:
        """Walk the ladder: shed the first rung still enabled. Returns
        the rung tripped, or None when everything is already shed (the
        engine is as conservative as it can get)."""
        for rung in RUNGS:
            if rung not in self._tripped:
                self.trip(rung, reason)
                return rung
        return None

    def _recover(self, rung: str) -> None:
        self._tripped.pop(rung, None)
        self.recoveries_total += 1
        log.warning("degrade: %s re-enabled (re-probe timer expired)", rung)
        if tracing.enabled():
            tracing.instant("degrade.recover", cat="degrade", rung=rung)

    def recover_all(self) -> None:
        """Force-recover every non-permanent rung (tests/operators)."""
        for rung in list(self._tripped):
            if self._tripped[rung] is not _PERMANENT:
                self._recover(rung)
