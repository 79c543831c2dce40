"""A raw-socket HTTP/1.1 client for the OpenAI frontend (standard library).

What a load generator or a check needs without aiohttp: one request per
connection (`Connection: close`), a JSON body, the status and headers,
and the body read whole or, for SSE, message by message as the chunks
arrive (each message with the `time.perf_counter()` it was parsed at).
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.llm.protocols.codec import SseDecoder, SseMessage


class HttpReply:
    def __init__(self, status: int, headers: dict, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.status = status
        self.headers = headers
        self._reader = reader
        self._writer = writer

    async def chunks(self) -> AsyncIterator[bytes]:
        """The body's pieces as they arrive (chunked or sized)."""
        r = self._reader
        try:
            if "chunked" in self.headers.get("transfer-encoding", "").lower():
                while True:
                    size = int((await r.readline()).split(b";")[0].strip() or b"0", 16)
                    if size == 0:
                        await r.readline()
                        return
                    data = await r.readexactly(size)
                    await r.readexactly(2)
                    yield data
            elif "content-length" in self.headers:
                n = int(self.headers["content-length"])
                if n:
                    yield await r.readexactly(n)
            else:
                while data := await r.read(65536):
                    yield data
        finally:
            self.close()

    async def read(self) -> bytes:
        return b"".join([c async for c in self.chunks()])

    async def json(self):
        return json.loads(await self.read())

    async def sse(self) -> AsyncIterator[tuple[float, SseMessage]]:
        """SSE messages with their parse time; ends after `[DONE]` or at
        the end of the body."""
        dec = SseDecoder()
        buf = b""
        async for chunk in self.chunks():
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                msg = dec.feed_line(line.decode("utf-8", errors="replace"))
                if msg is not None:
                    yield time.perf_counter(), msg
                    if msg.done:
                        return
        msg = dec.flush()
        if msg is not None:
            yield time.perf_counter(), msg

    def close(self) -> None:
        self._writer.close()


async def request(host: str, port: int, method: str, path: str, body=None,
                  headers: Optional[dict] = None) -> HttpReply:
    """Send one request (`body` JSON-encoded) and read the status line and
    headers; the body is read from the returned reply."""
    reader, writer = await asyncio.open_connection(host, port)
    data = json.dumps(body).encode() if body is not None else b""
    head = {"Host": f"{host}:{port}", "Connection": "close", **(headers or {})}
    if data or method == "POST":
        head.setdefault("Content-Type", "application/json")
        head["Content-Length"] = str(len(data))
    lines = [f"{method} {path} HTTP/1.1"] + [f"{k}: {v}" for k, v in head.items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data)
    await writer.drain()
    status_line = await reader.readline()
    while status_line.startswith(b"HTTP/1.1 100"):  # interim response
        while (await reader.readline()).strip():
            pass
        status_line = await reader.readline()
    status = int(status_line.split()[1])
    resp_headers: dict = {}
    while True:
        line = (await reader.readline()).decode("latin-1").strip()
        if not line:
            break
        k, _, v = line.partition(":")
        resp_headers[k.strip().lower()] = v.strip()
    return HttpReply(status, resp_headers, reader, writer)
