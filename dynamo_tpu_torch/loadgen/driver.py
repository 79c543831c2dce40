"""Open-loop trace replay driver.

Open-loop means arrivals are scheduled from the TRACE CLOCK alone: the
driver sleeps until each record's ``arrival_ts`` and fires the request
as a task, never awaiting an earlier request first. Under overload the
queue grows and latency blows up — which is the point; a closed-loop
driver (next request only after the last completes) self-throttles and
can never show the knee (the genai-perf / Mooncake replay discipline).

Each request records client-side TTFT/ITL/tokens; :class:`LedgerJoin`
joins the engine's per-request finish summaries (queue wait, engine
TTFT, the prefix/offload reuse ledger) by request id afterwards — both
for in-process engine targets and for HTTP targets served from the same
process (the driver stamps ``x-request-id``).

The JAX package's `loadgen/driver.py` on the port's protocols, `Context`
and logging. The driver runs on the engine's own event loop, as the
reference's does: a long prefill's host enqueue delays the next arrival,
which `RequestResult.launch_lag_s` measures.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from dynamo_tpu_torch.llm.protocols.common import (
    DeadlineExceededError,
    PoolExhaustedError,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.loadgen.prompts import PromptFactory
from dynamo_tpu_torch.loadgen.trace import Trace, TraceRecord
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.loadgen")

# request outcome classes: "ok" finished with tokens; "shed" was a typed
# admission/deadline refusal (HTTP 429/503 — honest load-shedding data,
# not a harness error); "error" is anything else
STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_ERROR = "error"


@dataclass
class RequestResult:
    index: int
    request_id: str
    tenant: str = "default"
    workload: str = "chat"
    scheduled_s: float = 0.0   # trace arrival offset
    launched_s: float = 0.0    # actual task-creation offset
    status: str = STATUS_OK
    http_status: Optional[int] = None
    error: Optional[str] = None
    ttft_s: Optional[float] = None
    itl_s: Optional[float] = None   # mean inter-token gap
    tokens: int = 0
    prompt_tokens: int = 0
    queue_wait_s: Optional[float] = None
    engine_ttft_s: Optional[float] = None
    prefix: dict = field(default_factory=dict)  # joined reuse ledger
    extra: dict = field(default_factory=dict)

    @property
    def launch_lag_s(self) -> float:
        """How late the driver fired vs the trace clock — stays small
        even under total backend overload (the open-loop property)."""
        return self.launched_s - self.scheduled_s


Submit = Callable[[TraceRecord, RequestResult], Awaitable[None]]


async def replay(
    trace: Trace,
    submit: Submit,
    speed: float = 1.0,
    request_id_prefix: str = "lg",
) -> tuple[list[RequestResult], float]:
    """Replay `trace` against `submit`; returns (results, wall_s).

    `submit` must fill its RequestResult and swallow request-level
    failures into it (the driver additionally catches and marks
    anything that escapes). `speed` > 1 compresses the trace clock.
    """
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    results: list[RequestResult] = []
    tasks: list[asyncio.Task] = []
    for i, rec in enumerate(trace.records):
        target = rec.arrival_ts / speed
        delay = (t0 + target) - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        res = RequestResult(
            index=i,
            request_id=f"{request_id_prefix}-{i:05d}",
            tenant=rec.tenant,
            workload=rec.workload,
            scheduled_s=target,
            launched_s=loop.time() - t0,
        )
        results.append(res)
        tasks.append(asyncio.create_task(submit(rec, res)))
    failures = await asyncio.gather(*tasks, return_exceptions=True)
    for res, exc in zip(results, failures):
        if isinstance(exc, BaseException):
            res.status = STATUS_ERROR
            res.error = f"{type(exc).__name__}: {exc}"
            log.warning("request %s failed: %s", res.request_id, res.error)
    return results, loop.time() - t0


class LedgerJoin:
    """Collects the engine's finish summaries (`TorchEngine.
    subscribe_requests`) and joins them onto the driver's results by
    request id (queue wait, engine-side TTFT, token counts, the
    prefix/offload reuse ledger)."""

    def __init__(self, engine):
        self.summaries: dict[str, dict] = {}
        engine.subscribe_requests(self._observe)

    def _observe(self, summary: dict) -> None:
        rid = summary.get("request_id")
        if rid:
            self.summaries[rid] = summary

    def apply(self, results: list[RequestResult]) -> int:
        joined = 0
        for res in results:
            s = self.summaries.get(res.request_id)
            if s is None:
                continue
            joined += 1
            res.queue_wait_s = s.get("queue_wait_s")
            res.engine_ttft_s = s.get("ttft_s")
            res.prefix = dict(s.get("prefix") or {})
            if not res.tokens:
                res.tokens = int(s.get("tokens") or 0)
            if not res.prompt_tokens:
                res.prompt_tokens = int(s.get("prompt_tokens") or 0)
        return joined


def sampling_for(record: TraceRecord) -> SamplingOptions:
    """Record's sampling dict -> SamplingOptions; empty = greedy (the
    deterministic default every scenario can score against)."""
    if record.sampling:
        return SamplingOptions.from_dict(record.sampling)
    return SamplingOptions(greedy=True)


def engine_submitter(
    engine,
    factory: PromptFactory,
    decorate: Optional[Callable[[TraceRecord, RequestResult,
                                 PreprocessedRequest], None]] = None,
) -> Submit:
    """Token-level submitter driving an engine (or preprocessor-less
    pipeline) directly — the target for workloads the OpenAI surface
    cannot express (prompt_embeds vision requests) and for real-model
    runs without a tokenizer dir. `decorate(record, result, pre)` may
    mutate the request before submit (e.g. attach embeddings)."""

    async def submit(rec: TraceRecord, res: RequestResult) -> None:
        tokens = factory.tokens_for(rec, res.index)
        pre = PreprocessedRequest(
            token_ids=tokens,
            stop_conditions=StopConditions(
                max_tokens=rec.osl, ignore_eos=True
            ),
            sampling_options=sampling_for(rec),
        )
        if decorate is not None:
            decorate(rec, res, pre)
        res.prompt_tokens = len(tokens)
        ctx = Context(pre.to_dict(), request_id=res.request_id)
        if rec.tenant:
            ctx.metadata["tenant"] = rec.tenant
        ctx.metadata["priority"] = rec.priority
        t0 = time.perf_counter()
        ticks: list[float] = []
        n_tokens = 0
        try:
            async for frame in await engine.generate(ctx):
                ids = frame.get("token_ids")
                if ids:
                    # frames may carry multi-token bursts (decode_steps):
                    # ticks time the frames, n_tokens counts the tokens
                    n_tokens += len(ids)
                    ticks.append(time.perf_counter())
        except Exception as exc:  # noqa: BLE001 — typed sheds are data
            if isinstance(exc, (DeadlineExceededError, PoolExhaustedError)):
                res.status = STATUS_SHED
            else:
                res.status = STATUS_ERROR
            res.error = f"{type(exc).__name__}: {exc}"
            return
        _fill_ticks(res, t0, ticks, n_tokens)

    return submit


def _fill_ticks(
    res: RequestResult, t0: float, ticks: list[float],
    n_tokens: Optional[int] = None,
) -> None:
    if not ticks:
        res.status = STATUS_ERROR
        res.error = res.error or "no tokens streamed"
        return
    res.ttft_s = ticks[0] - t0
    res.tokens = n_tokens if n_tokens is not None else len(ticks)
    if res.tokens > 1:
        # mean token-to-token latency over the decode (frames arrive in
        # multi-step bursts, so intra-burst diffs are meaningless)
        res.itl_s = (ticks[-1] - ticks[0]) / (res.tokens - 1)
