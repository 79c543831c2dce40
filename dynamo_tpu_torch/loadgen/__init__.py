"""Trace-driven scenario load harness: the measurement plane.

The JAX package's `loadgen` on the port: seeded deterministic trace
generators (Poisson, bursty/diurnal, multi-tenant shared-prefix; the same
bytes for the same seed), an open-loop async replay driver that never
gates arrivals on completions, SLO-gated goodput scoring, and a scenario
registry with one scenario per workload the engine claims to support
(`scenarios.py`), run as a suite by `bench.run_suite` and
`python -m dynamo_tpu_torch.scripts.run_scenarios`.
"""

from dynamo_tpu_torch.loadgen.trace import (
    Trace,
    TraceRecord,
    bursty_trace,
    poisson_trace,
    shared_prefix_trace,
)
from dynamo_tpu_torch.loadgen.prompts import PromptFactory
from dynamo_tpu_torch.loadgen.driver import (
    LedgerJoin,
    RequestResult,
    engine_submitter,
    replay,
)
from dynamo_tpu_torch.loadgen.score import score_results

__all__ = [
    "Trace",
    "TraceRecord",
    "poisson_trace",
    "bursty_trace",
    "shared_prefix_trace",
    "PromptFactory",
    "RequestResult",
    "LedgerJoin",
    "replay",
    "engine_submitter",
    "score_results",
]
