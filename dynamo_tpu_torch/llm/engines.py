"""Engines façade: echo/test engines and engine dispatch.

Equivalent of the reference's engines module (reference:
lib/llm/src/engines.rs:41-296): `echo_core` (token-level echo — the
universal CPU-only fake backend for distributed-graph tests) and
`echo_full` (text-level echo), with the reference's token delay knob
(env ``DYN_TOKEN_ECHO_DELAY_MS``). A copy of the JAX package's
`llm/engines.py` without `MultiNodeConfig` (multi-node serving is M13).
"""

from __future__ import annotations

import asyncio
import os
from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import (
    FINISH_REASON_LENGTH,
    EngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.pipeline.context import Context


def _token_delay_s() -> float:
    return float(os.environ.get("DYN_TOKEN_ECHO_DELAY_MS", "1")) / 1000.0


class EchoEngineCore:
    """Token-level echo: streams the prompt's token ids back one at a time
    (reference: engines.rs echo_core). Sits below Backend, so the full
    detokenization/stop path is exercised."""

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        pre = PreprocessedRequest.from_dict(request.payload)
        delay = _token_delay_s()
        max_tokens = pre.stop_conditions.max_tokens or len(pre.token_ids)

        async def _gen() -> AsyncIterator[dict]:
            emitted = 0
            for tid in pre.token_ids:
                if request.is_stopped() or emitted >= max_tokens:
                    break
                yield EngineOutput(token_ids=[tid]).to_dict()
                emitted += 1
                if delay:
                    await asyncio.sleep(delay)
            yield EngineOutput.final(FINISH_REASON_LENGTH).to_dict()

        return _gen()


class EchoEngineFull:
    """Text-level echo (reference: engines.rs echo_full): echoes the last
    user message as word chunks. Replaces the whole preprocessor/backend
    pipeline — register directly against the HTTP service."""

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        req = request.payload
        if hasattr(req, "messages"):
            content = next(
                (
                    m.get("content") or ""
                    for m in reversed(req.messages)
                    if m.get("role") == "user"
                ),
                "",
            )
            model, kind = req.model, "chat"
        else:
            content = req.prompt if isinstance(req.prompt, str) else ""
            model, kind = req.model, "completion"
        delay = _token_delay_s()

        from dynamo_tpu_torch.llm.protocols.openai import DeltaGenerator

        delta = DeltaGenerator(model, kind=kind)

        async def _gen() -> AsyncIterator[dict]:
            words = content.split(" ")
            for i, word in enumerate(words):
                if request.is_stopped():
                    break
                piece = word if i == 0 else " " + word
                delta.completion_tokens += 1
                yield delta.chunk(piece, None)
                if delay:
                    await asyncio.sleep(delay)
            yield delta.chunk(None, "stop")
            yield {**delta.chunk(None, None), "usage": delta.usage(), "choices": []}

        return _gen()


class CountingEngine:
    """Streams n integers then finishes — for http/pipeline tests
    (reference: lib/llm/tests/http-service.rs counting engine)."""

    def __init__(self, n: int = 10):
        self.n = n

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        async def _gen() -> AsyncIterator[dict]:
            for i in range(self.n):
                yield EngineOutput(token_ids=[i]).to_dict()
            yield EngineOutput.final("stop").to_dict()

        return _gen()


class AlwaysFailEngine:
    """Raises on generate — error-path fixture (reference:
    lib/llm/tests/http-service.rs:92-107)."""

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        raise RuntimeError("always fail")
