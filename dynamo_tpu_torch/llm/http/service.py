"""OpenAI-compatible HTTP service of the port.

The port of the JAX package's `llm/http/service.py` (reference:
lib/llm/src/http/service/service_v2.rs:25-130, openai.rs:133-559) on the
port's own asyncio server (`server.py`):

- ``POST /v1/chat/completions`` / ``POST /v1/completions`` — streaming (SSE)
  and non-streaming; client disconnect kills the request context so engines
  stop wasting compute (openai.rs:433 monitor_for_disconnects);
- ``GET /v1/models`` — model listing;
- ``GET /metrics`` — Prometheus text;
- ``GET /debug/trace``, ``GET /debug/snapshot``, ``GET /debug/kv`` and
  ``POST /debug/profile`` — the trace ring, a manual flight-recorder dump,
  the KV custody snapshot and an on-demand profiler capture, with the
  JAX service's parameters and response schemas;
- ``GET /health`` / ``GET /live``.

As in the JAX service: the `x-request-id` echo, the `x-request-timeout`
deadline into Context metadata, the request template, SSE frames with a
`: ready` comment, `event:` annotations, monotonic `id:` lines, `error`
events and `data: [DONE]`, non-streaming aggregation and one status policy
(`_classify_error`), the ``http.request`` span of every completion and
the request id bound for its task tree (the JSONL log join and the
preprocessor's span), and the front-door admission gate
(`llm/http/admission.py`: the typed 429/503 with `Retry-After` before any
tokenization or engine work, the tenant's priority class stamped into
Context metadata, the gate's series on `/metrics`). Left out (ROADMAP
M17): the SSE relay and failover (`Last-Event-ID` resume).

`ModelManager` (reference: lib/llm/src/http/service.rs:59-130) maps model
name → engine per flavor (chat/completion).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time
import uuid
from typing import Optional

from dynamo_tpu_torch.llm.http.metrics import ServiceMetrics
from dynamo_tpu_torch.llm.http.server import (
    HttpServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)
from dynamo_tpu_torch.llm.protocols.common import (
    FINISH_REASON_TIMEOUT,
    DeadlineExceededError,
    PoolExhaustedError,
)
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    RequestError,
    aggregate_chat_stream,
    aggregate_completion_stream,
)
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.runtime.pipeline.engine import AsyncEngine
from dynamo_tpu_torch.utils import tracing
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.http")


class ModelManager:
    def __init__(self) -> None:
        self._chat: dict[str, AsyncEngine] = {}
        self._completion: dict[str, AsyncEngine] = {}
        self.cards: dict[str, dict] = {}  # display info for /v1/models

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self._chat[name] = engine

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self._completion[name] = engine

    def remove_model(self, name: str) -> None:
        self._chat.pop(name, None)
        self._completion.pop(name, None)
        self.cards.pop(name, None)

    def get_chat(self, name: str) -> Optional[AsyncEngine]:
        return self._chat.get(name)

    def get_completion(self, name: str) -> Optional[AsyncEngine]:
        return self._completion.get(name)

    def list_models(self) -> list[str]:
        return sorted(set(self._chat) | set(self._completion))


class HttpService:
    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        metrics: Optional[ServiceMetrics] = None,
        request_template=None,
        request_timeout_s: Optional[float] = None,
        admission=None,
    ):
        self.manager = manager or ModelManager()
        self.metrics = metrics or ServiceMetrics()
        # llm.http.admission.AdmissionController: under overload it sheds the
        # lowest-priority tenants with the typed 429/503 + Retry-After before
        # any engine work, and stamps the tenant's priority class into Context
        # metadata, which becomes Sequence.priority (the engine's admission
        # and preemption order). None admits every request.
        self.admission = admission
        if admission is not None:
            self.metrics.extra.append(admission)
        # llm.request_template.RequestTemplate: deployment defaults filled
        # into bodies that omit model/temperature/max tokens
        self.request_template = request_template
        # deployment-default end-to-end deadline (seconds; None = none); a
        # request's `x-request-timeout` header overrides it. The resolved
        # deadline rides Context metadata into the engine.
        self.request_timeout_s = request_timeout_s
        self._routes = {
            ("POST", "/v1/chat/completions"): self._chat_completions,
            ("POST", "/v1/completions"): self._completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/metrics"): self._metrics,
            ("GET", "/debug/trace"): self._debug_trace,
            ("GET", "/debug/snapshot"): self._debug_snapshot,
            ("GET", "/debug/kv"): self._debug_kv,
            ("POST", "/debug/profile"): self._debug_profile,
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._health,
        }
        self._server = HttpServer(self._route)
        self.port: int = 0

    # ------------------------------------------------------------ lifecycle

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> None:
        await self._server.start(host, port)
        self.port = self._server.port
        log.info("http service listening on %s:%d", host, self.port)

    async def stop(self) -> None:
        await self._server.stop()

    async def _route(self, request: Request):
        handler = self._routes.get((request.method, request.path))
        if handler is not None:
            return await handler(request)
        if any(path == request.path for _, path in self._routes):
            return _error_response(405, f"method {request.method} not allowed")
        return _error_response(404, f"no route for {request.path}")

    # --------------------------------------------------------------- routes

    async def _health(self, request: Request) -> Response:
        return json_response({"status": "ok", "models": self.manager.list_models()})

    async def _models(self, request: Request) -> Response:
        return json_response(
            {
                "object": "list",
                "data": [
                    {"id": name, "object": "model", "owned_by": "dynamo-tpu"}
                    for name in self.manager.list_models()
                ],
            }
        )

    async def _metrics(self, request: Request) -> Response:
        return Response(self.metrics.render().encode())

    async def _debug_trace(self, request: Request) -> Response:
        """Chrome/Perfetto trace-event JSON of the span ring
        (utils/tracing.py). `?request_id=<id>` filters to one request,
        `?track=<name>` to one named track (e.g. ``engine.steps``); the
        body keeps the `?limit=` newest events (default
        ``DYN_TRACE_HTTP_MAX_EVENTS``, 20000; ``limit=0`` lifts the cap),
        and a capped body carries ``truncatedEvents``. Empty unless
        tracing is armed (DYN_TRACE=1)."""
        import os

        raw_limit = request.query.get("limit")
        if raw_limit is not None:
            try:
                limit = int(raw_limit)
            except ValueError:
                return _error_response(400, f"invalid limit {raw_limit!r} (want an int)")
        else:
            try:
                limit = int(os.environ.get("DYN_TRACE_HTTP_MAX_EVENTS", "") or 20000)
            except ValueError:
                limit = 20000
        return json_response(tracing.export(
            request_id=request.query.get("request_id"), track=request.query.get("track"),
            max_events=limit if limit > 0 else None))

    async def _debug_snapshot(self, request: Request) -> Response:
        """Manual flight-recorder trigger: every registered recorder dumps
        its correlated forensic artifact now (the rate limit bypassed) and
        the paths come back; ``?request_id=<id>`` scopes the embedded
        trace slice to one request."""
        from dynamo_tpu_torch.engine import flight_recorder

        rid = request.query.get("request_id")
        arts = []
        for rec in flight_recorder.registered():
            path = rec.trigger("manual", request_id=rid, force=True)
            arts.append({"path": path, "digests": rec.count, "dumps_total": rec.dumps_total})
        return json_response({"recorders": len(arts), "artifacts": arts})

    async def _debug_kv(self, request: Request) -> Response:
        """KV page-custody snapshot of every registered ledger: tiers,
        per-tenant attribution, the top holders (``?top=N``, default 10),
        churn, open in-flight windows and the bounded violation log."""
        from dynamo_tpu_torch.engine import kv_ledger

        try:
            top_n = int(request.query.get("top", "") or 10)
        except ValueError:
            return _error_response(400, "invalid top= (want an int)")
        ledgers = [led.snapshot(top_n=top_n) for led in kv_ledger.registered()]
        return json_response({"ledgers": len(ledgers), "kv": ledgers})

    async def _debug_profile(self, request: Request) -> Response:
        """On-demand profiling (``POST /debug/profile?duration_ms=N``): one
        bounded `torch.profiler` capture whose Chrome trace lands in
        ``<dir>/trace.json`` under ``DYN_PROFILE_DIR``, the dispatches
        annotated to join the trace ring by name (engine/profiler.py). A
        capture already in flight answers 409."""
        from dynamo_tpu_torch.engine import profiler

        raw = request.query.get("duration_ms", "1000")
        try:
            duration_ms = float(raw)
        except ValueError:
            return _error_response(400, f"invalid duration_ms {raw!r} (want milliseconds)")
        duration_ms = min(max(duration_ms, 1.0), 60000.0)
        if not profiler.available():
            return _error_response(501, "torch.profiler unavailable (or DYN_PROFILE=0)")
        try:
            info = await profiler.capture(duration_ms)
        except profiler.ProfilerBusy as exc:
            return _error_response(409, str(exc))
        except profiler.ProfilerUnavailable as exc:
            return _error_response(501, str(exc))
        except Exception as exc:  # noqa: BLE001 (capture is best-effort)
            log.exception("profile capture failed")
            return _error_response(500, f"profile capture failed: {exc}")
        return json_response(info)

    async def _chat_completions(self, request: Request):
        return await self._serve_llm(
            request, kind="chat", parse=ChatCompletionRequest.from_body
        )

    async def _completions(self, request: Request):
        return await self._serve_llm(
            request, kind="completion", parse=CompletionRequest.from_body
        )

    async def _serve_llm(self, request: Request, kind: str, parse):
        # request id: echo the caller's x-request-id or mint one; it
        # becomes the Context id, the trace key and the JSONL log join key
        # of everything downstream in this task tree
        rid = request.headers.get("x-request-id") or uuid.uuid4().hex
        t0 = time.perf_counter()
        status = 500
        token = tracing.set_request(rid)
        try:
            resp = await self._handle_llm(request, kind, parse, rid)
            status = resp.status
            if not resp.prepared:
                # streaming responses already sent their headers (the echo
                # rides in _stream_sse); only unsent ones take it here
                resp.headers.setdefault("X-Request-Id", rid)
            return resp
        except (asyncio.CancelledError, ConnectionResetError):
            # the client closed the request (nginx's 499 convention)
            status = 499
            raise
        finally:
            tracing.reset_request(token)
            tracing.complete("http.request", t0, time.perf_counter(), cat="http", req=rid,
                             endpoint=kind, status=status)

    async def _handle_llm(self, request: Request, kind: str, parse, rid: str):
        try:
            body = await request.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _error_response(400, "invalid JSON body")
        if self.request_template is not None:
            body = self.request_template.apply(body)
        try:
            req = parse(body)
        except RequestError as exc:
            return _error_response(400, str(exc))

        engine = (
            self.manager.get_chat(req.model)
            if kind == "chat"
            else self.manager.get_completion(req.model)
        )
        if engine is None:
            return _error_response(404, f"model {req.model!r} not found")

        # end-to-end deadline: x-request-timeout (seconds) or the service
        # default, stamped into Context metadata as an absolute epoch
        # deadline. A non-positive service default means disabled; only an
        # explicit header can express "already expired".
        timeout_s = (
            self.request_timeout_s
            if self.request_timeout_s and self.request_timeout_s > 0
            else None
        )
        hdr = request.headers.get("x-request-timeout")
        if hdr is not None:
            try:
                timeout_s = float(hdr)
            except ValueError:
                return _error_response(
                    400, f"invalid x-request-timeout {hdr!r} (want seconds)"
                )
            if timeout_s <= 0:
                # an already-spent budget is shed before any work at all
                return _error_response(
                    429, "request deadline already expired",
                    headers={"Retry-After": "1"},
                )

        tenant = request.headers.get("x-tenant-id")
        # the admission ladder: under overload the lowest classes shed here,
        # before tokenization or engine admission
        if self.admission is not None:
            verdict = self.admission.check(tenant or "default")
            if verdict is not None:
                return _error_response(
                    verdict.status, verdict.message,
                    headers={"Retry-After": str(max(1, verdict.retry_after_s))},
                )

        guard = self.metrics.inflight_guard(req.model, kind)
        ctx = Context(req, request_id=rid)
        if tenant:
            ctx.metadata["tenant"] = tenant
        if self.admission is not None:
            ctx.metadata["priority"] = self.admission.priority_of(tenant or "default")
        if timeout_s is not None:
            ctx.metadata["timeout_s"] = timeout_s
            ctx.metadata["deadline"] = time.time() + timeout_s
        try:
            stream = await engine.generate(ctx)
        except Exception as exc:  # noqa: BLE001 — admission or engine failure
            if not isinstance(
                exc, (ValueError, DeadlineExceededError, PoolExhaustedError)
            ):
                log.error("engine failed for %s", req.model, exc_info=exc)
            guard.close()
            return _classify_error(exc)

        try:
            if req.stream:
                return await self._stream_sse(request, ctx, stream, guard)
            return await self._respond_full(ctx, stream, guard, kind)
        except asyncio.CancelledError:
            # client disconnected (the server cancels the handler) → kill
            # the context so the engine stops generating for a vanished
            # caller
            log.info("client disconnected; killing request %s", ctx.id)
            ctx.kill()
            raise
        finally:
            guard.close()

    async def _stream_sse(self, request: Request, ctx, stream, guard) -> StreamResponse:
        # Peek the first item BEFORE committing the 200/SSE headers: with
        # lazily-started streams (the n>1 fan-out) admission errors only
        # surface at first iteration, and they should map to a real HTTP
        # status, matching the eager n==1 path.
        it = stream.__aiter__()
        first_items: list = []
        try:
            first_items.append(await it.__anext__())
        except StopAsyncIteration:
            pass
        except Exception as exc:  # noqa: BLE001 — mapped to a status code
            if not isinstance(
                exc, (ValueError, DeadlineExceededError, PoolExhaustedError)
            ):
                log.error("stream failed before first frame for %s", ctx.id,
                          exc_info=exc)
            ctx.kill()
            return _classify_error(exc)

        async def _chained():
            for x in first_items:
                yield x
            async for x in it:
                yield x

        resp = request.stream(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Request-Id": ctx.id,
        })
        await resp.prepare()
        # frames carry monotonic ids; a dropped client cannot resume (the
        # relay is not ported): the disconnect kills the request
        eid = 0
        ok = False
        try:
            async for fkind, frame in self._sse_frames(ctx, _chained()):
                eid += 1
                await resp.write(b"id: %d\n" % eid + frame)
                if fkind == "done":
                    ok = True
            if ok:
                guard.mark_ok()
        except (ConnectionResetError, asyncio.CancelledError):
            # client went away → kill the context so the engine stops
            # (reference: openai.rs:433 monitor_for_disconnects)
            log.info("client disconnected; killing request %s", ctx.id)
            ctx.kill()
            raise
        with contextlib.suppress(ConnectionResetError):
            await resp.write_eof()
        return resp

    async def _sse_frames(self, ctx, items):
        """Encode the engine stream as SSE frames: yields
        (kind, frame_bytes) with kind in comment/event/data/done/error.
        Engine faults become an `error` event + kill (the 200 is
        already on the wire); transport faults raise to the caller."""
        try:
            async for item in items:
                if "__annotation__" in item:
                    # SSE `event:` lines for annotations; the internal
                    # "ready" frame becomes an SSE comment
                    name, data = item["__annotation__"], item["data"]
                    if name == "ready":
                        yield "comment", b": ready\n\n"
                        continue
                    yield (
                        "event",
                        f"event: {name}\ndata: {json.dumps(data)}\n\n".encode(),
                    )
                    continue
                yield "data", f"data: {json.dumps(item)}\n\n".encode()
            yield "done", b"data: [DONE]\n\n"
        except (ConnectionResetError, asyncio.CancelledError):
            raise
        except Exception as exc:  # noqa: BLE001 — any mid-stream fault
            # becomes an SSE error event + kill rather than a truncation
            log.error("stream error for request %s: %s", ctx.id, exc)
            ctx.kill()
            yield (
                "error",
                f'event: error\ndata: {json.dumps({"message": str(exc)})}\n\n'.encode(),
            )

    async def _respond_full(self, ctx, stream, guard, kind) -> Response:
        async def _data_only():
            async for item in stream:
                if "__annotation__" not in item:
                    yield item

        try:
            if kind == "chat":
                full = await aggregate_chat_stream(_data_only())
            else:
                full = await aggregate_completion_stream(_data_only())
        except Exception as exc:  # noqa: BLE001 — mapped to a status code
            ctx.kill()
            return _classify_error(exc)
        if _timed_out_empty(full):
            # deadline expired in the admission queue: zero tokens were
            # produced and nothing had streamed, so the caller gets a real
            # 429 instead of a 200 with an empty "timeout" choice
            return _error_response(
                429, "request deadline expired in the admission queue",
                headers={"Retry-After": "1"},
            )
        guard.mark_ok()
        return json_response(full)


def _error_response(
    status: int, message: str, headers: Optional[dict] = None
) -> Response:
    kind = (
        "invalid_request_error" if status < 500 and status != 429
        else "rate_limit_error" if status == 429
        else "server_error"
    )
    return json_response(
        {"error": {"message": message, "type": kind}},
        status=status, headers=headers,
    )


def _timed_out_empty(full: dict) -> bool:
    """Did every choice of an aggregated response end `timeout` with no
    content? (= the deadline expired before the first token; eligible
    for conversion to a real 429 since nothing has streamed yet)."""
    choices = full.get("choices") or []
    if not choices:
        return False
    for c in choices:
        if c.get("finish_reason") != FINISH_REASON_TIMEOUT:
            return False
        text = c.get("text") or (c.get("message") or {}).get("content")
        if text:
            return False
    return True


def _classify_error(exc: Exception) -> Response:
    """One policy for mapping stream/admission exceptions to HTTP status:
    DeadlineExceeded = the caller's budget expired before device work ->
    429 + Retry-After; PoolExhausted = a capacity condition -> 503 +
    Retry-After; ValueError (incl. RequestError) = the request was
    invalid -> 400; anything else = server fault -> 502."""
    if isinstance(exc, DeadlineExceededError):
        return _error_response(
            429, str(exc),
            headers={"Retry-After": str(max(1, int(exc.retry_after_s)))},
        )
    if isinstance(exc, PoolExhaustedError):
        return _error_response(
            503, str(exc),
            headers={"Retry-After": str(max(1, int(exc.retry_after_s)))},
        )
    if isinstance(exc, ValueError):
        return _error_response(400, str(exc))
    return _error_response(502, f"engine error: {exc}")
