"""Serve a token-level engine through a LIVE HttpService for replay.

The loadgen scenarios drive the real OpenAI surface — admission gate,
deadline headers, tenant stamping, SSE streaming — over a real socket,
without needing a tokenizer dir: prompts go in as token-id lists (the
legacy completions API accepts them) and :class:`TokenCodec` renders
output ids as their decimal text, which is all the scoring needs. Real
model dirs keep using run.py's full pipeline; this is the harness path
that works for any preset, tiny to 8B.

The JAX package's `loadgen/http.py` on the port's `HttpService` and its
raw-socket client (`llm/http/client.py`) in place of aiohttp: each SSE
message is stamped with the time the client parsed it, and TTFT and ITL
are read from those stamps.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.http import client
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.loadgen.driver import (
    STATUS_ERROR,
    STATUS_SHED,
    RequestResult,
    Submit,
    _fill_ticks,
)
from dynamo_tpu_torch.loadgen.prompts import PromptFactory
from dynamo_tpu_torch.loadgen.trace import TraceRecord
from dynamo_tpu_torch.runtime.pipeline.engine import link


class _NumericDecodeStream:
    def step(self, token_id: int) -> Optional[str]:
        return f"{token_id} "


class TokenCodec:
    """Minimal tokenizer duck-type for the preprocessor/backend pair:
    encodes text as modular byte ids (only exercised by string prompts,
    which loadgen never sends) and decodes ids to their decimal repr."""

    def __init__(self, vocab_size: int = 256):
        self.vocab = int(vocab_size)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return [1 + (b % (self.vocab - 1)) for b in text.encode()]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(str(int(t)) for t in ids)

    def eos_token_ids(self) -> list[int]:
        return []

    def decode_stream(self, skip_special_tokens: bool = True):
        return _NumericDecodeStream()


@contextlib.asynccontextmanager
async def engine_http_service(
    engine,
    model: str = "loadgen",
    vocab_size: int = 256,
    context_length: int = 65536,
    admission=None,
    request_timeout_s: Optional[float] = None,
):
    """Async CM: preprocessor -> backend -> engine pipeline behind a
    started HttpService on 127.0.0.1:<ephemeral>; yields the service
    (``svc.port`` is live)."""
    codec = TokenCodec(vocab_size)
    card = ModelDeploymentCard(
        display_name=model, service_name=model,
        context_length=context_length,
    )
    pipeline = link(
        OpenAIPreprocessor(card, tokenizer=codec), Backend(codec), engine
    )
    svc = HttpService(
        admission=admission, request_timeout_s=request_timeout_s
    )
    svc.manager.add_completion_model(model, pipeline)
    svc.manager.add_chat_model(model, pipeline)
    await svc.start("127.0.0.1", 0)
    try:
        yield svc
    finally:
        await svc.stop()


def http_submitter(
    address: tuple[str, int],
    factory: PromptFactory,
    model: str = "loadgen",
    timeout_s: Optional[float] = None,
) -> Submit:
    """SSE submitter against ``POST /v1/completions`` at `address` (host,
    port). Stamps ``x-request-id`` (the ledger join key) and
    ``x-tenant-id``; 429/503 record as typed sheds."""
    host, port = address

    async def submit(rec: TraceRecord, res: RequestResult) -> None:
        tokens = factory.tokens_for(rec, res.index)
        res.prompt_tokens = len(tokens)
        body = {
            "model": model,
            "prompt": tokens,
            "stream": True,
            "max_tokens": rec.osl,
            "dyn_ext": {"ignore_eos": True, "greed_sampling": True},
        }
        if rec.sampling:
            ext = dict(body["dyn_ext"])
            for k in ("temperature", "top_p", "seed",
                      "frequency_penalty", "presence_penalty"):
                if rec.sampling.get(k) is not None:
                    body[k] = rec.sampling[k]
                    ext["greed_sampling"] = False
            for k in ("top_k", "repetition_penalty"):
                if rec.sampling.get(k) is not None:
                    ext[k] = rec.sampling[k]
                    ext["greed_sampling"] = False
            if rec.sampling.get("greedy"):
                ext["greed_sampling"] = True
            body["dyn_ext"] = ext
        headers = {
            "x-request-id": res.request_id,
            "x-tenant-id": rec.tenant,
        }
        if timeout_s is not None:
            headers["x-request-timeout"] = str(timeout_s)
        t0 = time.perf_counter()
        ticks: list[float] = []
        n_tokens = 0
        reply = await client.request(host, port, "POST", "/v1/completions", body,
                                     headers=headers)
        res.http_status = reply.status
        if reply.status in (429, 503):
            reply.close()
            res.status = STATUS_SHED
            res.error = f"http {reply.status}"
            return
        if reply.status != 200:
            res.status = STATUS_ERROR
            res.error = f"http {reply.status}: {(await reply.read()).decode(errors='replace')}"
            return
        async for t, msg in reply.sse():
            if msg.done:
                break
            if msg.data is None or msg.event is not None:
                continue
            item = msg.json()
            text = "".join(
                c.get("text") or "" for c in item.get("choices") or []
            )
            if text:
                n_tokens += len(text.split())
                ticks.append(t)
        _fill_ticks(res, t0, ticks, n_tokens)

    return submit
