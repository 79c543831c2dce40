"""Request deadlines in TorchEngine against JaxEngine, on the tiny config
with the same weights (JaxEngine's seeded init carried over to the port),
in float32 on the CPU.

A deadline is epoch seconds in Context metadata "deadline" (or now +
`request_timeout_s` when the request carries none). Three points act on
it, in both engines: `generate` raises DeadlineExceededError for a request
already past it; a queued request past it is finished with "timeout" and
no tokens; a running one is finished with "timeout". `deadline_shed` and
`deadline_timeouts` in `phase_stats` count them.

The clock is a fake `time.time` that the test advances at token
boundaries, so no case waits on the wall clock. One engine per
implementation serves every case (max_batch_size=1, so a second request
queues), on one event loop that the module keeps.
"""

from __future__ import annotations

import asyncio
import time

import jax
import pytest

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.runtime.pipeline.context import Context
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

ENGINE_KW = dict(
    model="tiny", dtype="float32", page_size=16, num_pages=32, max_batch_size=1,
    max_model_len=128, prefill_chunk=32, decode_steps=4, seed=0,
)
PROMPT = [5, 17, 42, 99, 3, 64, 128, 7, 200, 11]
START = 1_700_000_000.0


class Clock:
    def __init__(self):
        self.now = START

    def __call__(self) -> float:
        return self.now


class Impl:
    """One engine with its package's request types."""

    def __init__(self, engine, ctx_cls, common):
        self.engine, self.ctx_cls, self.common = engine, ctx_cls, common

    def request(self, n, deadline=None):
        c = self.common
        pre = c.PreprocessedRequest(
            token_ids=list(PROMPT),
            stop_conditions=c.StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=c.SamplingOptions(greedy=True),
        )
        ctx = self.ctx_cls(pre.to_dict())
        if deadline is not None:
            ctx.metadata["deadline"] = deadline
        return ctx

    def stats(self):
        s = self.engine.phase_stats
        return s["deadline_shed"], s["deadline_timeouts"]


async def _drain(stream, on_token=None):
    toks, reasons = [], []
    async for f in stream:
        for t in f.get("token_ids") or []:
            toks.append(t)
            if on_token is not None:
                on_token(len(toks))
        if f.get("finish_reason"):
            reasons.append(f["finish_reason"])
    return toks, reasons


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def impls(loop):
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    async def build():
        jeng = JaxEngine(JaxConfig(**ENGINE_KW, attn_backend="gather", step_pipeline=False))
        params = llama.params_from_jax(jax.device_get(jeng.params), device="cpu")
        teng = TorchEngine(EngineConfig(**ENGINE_KW, step_pipeline=False), params=params,
                           device="cpu")
        return {"jax": Impl(jeng, JaxContext, jcommon), "torch": Impl(teng, Context, tcommon)}

    out = loop.run_until_complete(build())
    yield out
    for impl in out.values():
        loop.run_until_complete(impl.engine.close())


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time", c)
    return c


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=60))


def test_stream_without_deadline_is_unchanged(loop, impls, clock):
    got = {}
    for name, impl in impls.items():
        before = impl.stats()
        got[name] = _run(loop, _drain(
            _run(loop, impl.engine.generate(impl.request(12)))))
        assert impl.stats() == before
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == ["length"] and len(got["torch"][0]) == 12


def test_passed_deadline_raises_before_admission(loop, impls, clock):
    for name, impl in impls.items():
        shed, timeouts = impl.stats()
        with pytest.raises(impl.common.DeadlineExceededError):
            _run(loop, impl.engine.generate(impl.request(8, deadline=clock.now - 1.0)))
        assert impl.stats() == (shed + 1, timeouts), name
        assert not impl.engine.waiting, name


def test_queued_request_past_deadline_is_shed(loop, impls, clock):
    for name, impl in impls.items():
        shed, timeouts = impl.stats()

        async def go():
            first = asyncio.Event()
            held = asyncio.ensure_future(_drain(
                await impl.engine.generate(impl.request(16)),
                lambda n: n == 1 and first.set()))
            await first.wait()
            # the one slot is taken: this request queues, and its
            # deadline passes before the slot frees
            queued = await impl.engine.generate(impl.request(8, deadline=clock.now + 5.0))
            clock.now += 10.0
            return await _drain(queued), await held

        (q_toks, q_reasons), (h_toks, h_reasons) = _run(loop, go())
        assert (q_toks, q_reasons) == ([], ["timeout"]), name
        assert len(h_toks) == 16 and h_reasons == ["length"], name
        assert impl.stats() == (shed + 1, timeouts), name


@pytest.mark.parametrize("source", ["metadata", "request_timeout_s"])
def test_running_request_past_deadline_times_out(loop, impls, clock, source):
    for name, impl in impls.items():
        shed, timeouts = impl.stats()

        def past_first_token(n):
            if n == 1:
                clock.now += 10.0

        async def go():
            if source == "metadata":
                ctx = impl.request(40, deadline=clock.now + 5.0)
            else:
                # the engine's default budget, for a request without one
                impl.engine.config.request_timeout_s = 5.0
                ctx = impl.request(40)
            try:
                stream = await impl.engine.generate(ctx)
            finally:
                impl.engine.config.request_timeout_s = 0.0
            return await _drain(stream, past_first_token)

        toks, reasons = _run(loop, go())
        assert reasons == ["timeout"], name
        assert 1 <= len(toks) < 40, name
        assert impl.stats() == (shed, timeouts + 1), name
