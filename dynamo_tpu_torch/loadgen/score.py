"""SLO-gated scoring of a replayed trace — the goodput machinery of the
SLO tracker applied per scenario (the JAX package's `loadgen/score.py`).

A request's tokens count toward GOODPUT only when the request finished
AND met every configured SLO target (TTFT always; ITL when set) —
throughput that blows the latency budget is not serving capacity
(docs/observability.md "Fleet plane"). Typed sheds (429/503) are scored
as sheds, not errors: under the bursty+admission scenario shedding the
batch tier IS the correct behavior, and the score must show both the
shed fraction and the goodput defended for the tenants that stayed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dynamo_tpu_torch.loadgen.driver import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED,
    RequestResult,
)


def _pct(vals: list, q: float) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return round(float(np.percentile(vals, q)), 4)


def score_results(
    results: list[RequestResult],
    wall_s: float,
    slo_ttft_s: float = 2.0,
    slo_itl_s: Optional[float] = None,
    n_chips: int = 1,
    kv_census: Optional[dict] = None,
) -> dict:
    """Score one replay: latency percentiles, throughput, SLO-gated
    goodput, shed/error accounting, open-loop proof, reuse-ledger sums.

    `kv_census` (the port's engine/kv_ledger.quiesce_census output) rides the
    section verbatim when provided — the zero-orphan gate scores next
    to goodput so a run that leaked pages cannot headline clean."""
    ok = [r for r in results if r.status == STATUS_OK]
    shed = [r for r in results if r.status == STATUS_SHED]
    errors = [r for r in results if r.status == STATUS_ERROR]

    def attained(r: RequestResult) -> bool:
        if r.ttft_s is None or r.ttft_s > slo_ttft_s:
            return False
        if slo_itl_s is not None and r.itl_s is not None \
                and r.itl_s > slo_itl_s:
            return False
        return True

    good = [r for r in ok if attained(r)]
    total_tokens = sum(r.tokens for r in ok)
    good_tokens = sum(r.tokens for r in good)
    wall_s = max(wall_s, 1e-9)
    return {
        "requests": {
            "total": len(results),
            "ok": len(ok),
            "shed": len(shed),
            "errors": len(errors),
        },
        "ttft": {
            "p50_s": _pct([r.ttft_s for r in ok], 50),
            "p99_s": _pct([r.ttft_s for r in ok], 99),
        },
        "itl": {
            "p50_s": _pct([r.itl_s for r in ok], 50),
            "p99_s": _pct([r.itl_s for r in ok], 99),
        },
        "queue_wait_p50_s": _pct([r.queue_wait_s for r in ok], 50),
        "throughput_toks_per_sec": round(total_tokens / wall_s / n_chips, 2),
        "goodput": {
            "ttft_target_s": slo_ttft_s,
            **({"itl_target_s": slo_itl_s} if slo_itl_s is not None else {}),
            # attained fraction over requests that were ADMITTED; the
            # shed fraction is reported alongside, not folded in
            "attained_frac": (
                round(len(good) / len(ok), 4) if ok else 0.0
            ),
            "good_requests": len(good),
            "goodput_toks_per_sec": round(
                good_tokens / wall_s / n_chips, 2
            ),
        },
        "open_loop": {
            # launch lag is driver-side scheduling delay vs the trace
            # clock; small values under overload PROVE arrivals were
            # not gated on completions
            "max_launch_lag_s": round(
                max((r.launch_lag_s for r in results), default=0.0), 4
            ),
        },
        "reuse": {
            "joined": sum(1 for r in results if r.prefix),
            "reused_blocks": sum(
                int(r.prefix.get("reused_blocks") or 0) for r in results
            ),
            "restored_blocks": sum(
                int(r.prefix.get("restored_blocks") or 0) for r in results
            ),
            "requests_with_reuse": sum(
                1 for r in results
                if (r.prefix.get("reused_blocks") or 0)
                + (r.prefix.get("restored_blocks") or 0) > 0
            ),
        },
        "wall_s": round(wall_s, 4),
        **({"kv_census": kv_census} if kv_census is not None else {}),
    }
