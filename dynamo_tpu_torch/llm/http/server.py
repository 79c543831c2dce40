"""A minimal asyncio HTTP/1.1 server for the OpenAI frontend.

The JAX package serves its frontend on aiohttp, which the card's machine
does not promise; this is what that service needs, on
`asyncio.start_server` and the standard library:

- the request line, headers and a `Content-Length` body (a chunked
  request body is refused with 411); `Expect: 100-continue` (curl sends
  it for larger bodies) is answered before the body is read;
- keep-alive (HTTP/1.1 unless `Connection: close`; HTTP/1.0 only with
  `Connection: keep-alive`);
- whole responses (`Response`, `json_response`) and streamed ones
  (`StreamResponse`) in chunked transfer encoding, each write followed by
  `writer.drain()` for backpressure;
- while a handler runs, the connection is watched: when the client goes
  away the handler's task is cancelled, so a streaming handler can kill
  the request it serves (what `service.py` relies on).

A handler is `async def handler(request: Request) -> Response |
StreamResponse`; a `StreamResponse` is made with `request.stream(...)`,
prepared, written and ended by the handler.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from http import HTTPStatus
from typing import Awaitable, Callable, Optional, Union
from urllib.parse import parse_qsl, urlsplit

log = logging.getLogger("dynamo_tpu_torch.http.server")

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024


class Headers(dict):
    """Case-insensitive header lookup (keys stored lower-case)."""

    def get(self, key: str, default=None):
        return super().get(key.lower(), default)


class Request:
    def __init__(self, method: str, target: str, version: str, headers: Headers,
                 body: bytes, conn: "_Connection"):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path
        # the query string's parameters (the last value of a repeated name)
        self.query = dict(parse_qsl(parts.query))
        self.version = version
        self.headers = headers
        self.body = body
        self._conn = conn

    async def json(self):
        """The body as JSON (raises json.JSONDecodeError or
        UnicodeDecodeError on a malformed one)."""
        return json.loads(self.body.decode("utf-8"))

    def stream(self, status: int = 200, headers: Optional[dict] = None) -> "StreamResponse":
        return StreamResponse(self._conn, status, headers)


class Response:
    def __init__(self, body: bytes = b"", status: int = 200, headers: Optional[dict] = None,
                 content_type: str = "text/plain; charset=utf-8"):
        self.body = body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}
        self.prepared = False


def json_response(data, status: int = 200, headers: Optional[dict] = None) -> Response:
    return Response(json.dumps(data).encode(), status, headers,
                    content_type="application/json; charset=utf-8")


def _head(status: int, headers: dict) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = "Unknown"
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A response whose body is written piece by piece (chunked)."""

    def __init__(self, conn: "_Connection", status: int, headers: Optional[dict]):
        self._conn = conn
        self.status = status
        self.headers = dict(headers or {})
        self.prepared = False
        self.ended = False

    async def prepare(self) -> None:
        headers = {k: v for k, v in self.headers.items()
                   if k.lower() not in ("content-length", "transfer-encoding", "connection")}
        headers["Transfer-Encoding"] = "chunked"
        headers["Connection"] = "keep-alive" if self._conn.keep_alive else "close"
        self._conn.writer.write(_head(self.status, headers))
        self.prepared = True
        await self._drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        self._conn.writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._drain()

    async def write_eof(self) -> None:
        if not self.ended:
            self.ended = True
            self._conn.writer.write(b"0\r\n\r\n")
            await self._drain()

    async def _drain(self) -> None:
        if self._conn.writer.is_closing():
            raise ConnectionResetError("client disconnected")
        await self._conn.writer.drain()


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Connection:
    """One client connection: requests in turn (keep-alive), each handler
    run as a task that a watcher cancels if the client goes away."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 handler: Handler):
        self.reader = reader
        self.writer = writer
        self.handler = handler
        self.buf = bytearray()  # bytes read ahead (by the watcher)
        self.eof = False
        self.keep_alive = True

    async def _fill(self) -> bool:
        if self.eof:
            return False
        data = await self.reader.read(65536)
        if not data:
            self.eof = True
            return False
        self.buf += data
        return True

    async def _read_head(self) -> Optional[bytes]:
        while True:
            i = self.buf.find(b"\r\n\r\n")
            if i >= 0:
                head = bytes(self.buf[:i])
                del self.buf[:i + 4]
                return head
            if len(self.buf) > MAX_HEADER_BYTES:
                raise _BadRequest(431, "request headers too large")
            if not await self._fill():
                if self.buf.strip():
                    raise _BadRequest(400, "incomplete request")
                return None

    async def _read_body(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self._fill():
                raise _BadRequest(400, "incomplete request body")
        body = bytes(self.buf[:n])
        del self.buf[:n]
        return body

    async def _watch(self) -> None:
        """Return when the client has gone away (EOF or reset); bytes that
        arrive meanwhile (a pipelined request) are kept for later, up to the
        largest request, past which nothing more is read until the handler
        ends."""
        try:
            while await self._fill():
                if len(self.buf) > MAX_HEADER_BYTES + MAX_BODY_BYTES:
                    await asyncio.Event().wait()
        except (ConnectionError, OSError):
            self.eof = True

    async def serve(self) -> None:
        try:
            while self.keep_alive:
                try:
                    req = await self._next_request()
                except _BadRequest as exc:
                    self.keep_alive = False
                    await self._send(json_response(
                        {"error": {"message": str(exc), "type": "invalid_request_error"}},
                        status=exc.status))
                    return
                if req is None:
                    return
                if not await self._dispatch(req):
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            with contextlib.suppress(Exception):
                self.writer.close()

    async def _next_request(self) -> Optional[Request]:
        head = await self._read_head()
        if head is None:
            return None
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            raise _BadRequest(400, "malformed request line") from None
        headers = Headers()
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep:
                raise _BadRequest(400, "malformed header line")
            headers[name.strip().lower()] = value.strip()
        conn = headers.get("connection", "").lower()
        if version == "HTTP/1.0":
            self.keep_alive = conn == "keep-alive"
        else:
            self.keep_alive = conn != "close"
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _BadRequest(411, "chunked request bodies are not supported; "
                                   "send Content-Length")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "invalid Content-Length") from None
        if length < 0 or length > MAX_BODY_BYTES:
            raise _BadRequest(413, "request body too large")
        if length and headers.get("expect", "").lower() == "100-continue":
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await self.writer.drain()
        body = await self._read_body(length)
        return Request(method, target, version, headers, body, self)

    async def _dispatch(self, req: Request) -> bool:
        """Run the handler under the disconnect watcher; True to go on
        with the next request on this connection."""
        task = asyncio.ensure_future(self.handler(req))
        watch = asyncio.ensure_future(self._watch())
        try:
            done, _ = await asyncio.wait({task, watch}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            task.cancel()
            watch.cancel()
            raise
        if task not in done:
            # the client went away: cancel the handler (it kills its request)
            task.cancel()
            with contextlib.suppress(BaseException):
                await task
            return False
        watch.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await watch
        try:
            resp = task.result()
        except (ConnectionError, asyncio.CancelledError):
            return False
        except Exception:  # noqa: BLE001 - a handler fault is a 500, not a dropped socket
            log.exception("handler failed for %s %s", req.method, req.path)
            resp = json_response(
                {"error": {"message": "internal server error", "type": "server_error"}},
                status=500)
        if isinstance(resp, StreamResponse):
            if not resp.prepared:
                await resp.prepare()
            await resp.write_eof()
            return self.keep_alive
        await self._send(resp)
        return self.keep_alive

    async def _send(self, resp: Response) -> None:
        headers = dict(resp.headers)
        headers["Content-Length"] = str(len(resp.body))
        headers["Connection"] = "keep-alive" if self.keep_alive else "close"
        self.writer.write(_head(resp.status, headers) + resp.body)
        resp.prepared = True
        await self.writer.drain()


class HttpServer:
    """`await HttpServer(handler).start(host, port)`; `port` is the bound
    port (pass 0 for a free one); `await stop()` closes the listener and
    every open connection."""

    def __init__(self, handler: Handler):
        self.handler = handler
        self.port = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._on_client, host, port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _on_client(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await _Connection(reader, writer, self.handler).serve()
        finally:
            self._conns.discard(task)

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for task in list(self._conns):
            task.cancel()
        for task in list(self._conns):
            with contextlib.suppress(BaseException):
                await task
        await self._server.wait_closed()
        self._server = None
