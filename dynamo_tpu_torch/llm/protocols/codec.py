"""SSE codec: parse side.

The emit side lives in the HTTP service (SSE framing of response
streams); this is the counterpart the reference keeps in
lib/llm/src/protocols/codec.rs:30-120 (`SseLineCodec` + `Message`): turn
a byte/line stream back into typed messages — what a client, a stream
recorder's replay, or the aggregator needs to consume an OpenAI SSE
response.

Per the SSE spec honored by the reference codec: `data:` lines
accumulate (joined by newline) until a blank line dispatches the event;
`event:`/`id:` set the message's type/id; `:` lines are comments
(collected, not dispatched); the OpenAI `[DONE]` sentinel yields a
message with `done=True`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import AsyncIterator, Iterable, Optional

DONE_SENTINEL = "[DONE]"


@dataclass
class SseMessage:
    data: Optional[str] = None
    event: Optional[str] = None
    id: Optional[str] = None
    comments: list[str] = field(default_factory=list)
    done: bool = False

    def json(self):
        if self.data is None:
            return None
        return json.loads(self.data)


class SseDecoder:
    """Incremental decoder: feed lines, collect dispatched messages."""

    def __init__(self):
        self._data: list[str] = []
        self._event: Optional[str] = None
        self._id: Optional[str] = None
        self._comments: list[str] = []

    def feed_line(self, line: str) -> Optional[SseMessage]:
        line = line.rstrip("\r\n")
        if line == "":
            return self._dispatch()
        if line.startswith(":"):
            self._comments.append(line[1:].strip())
            return None
        field_name, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if field_name == "data":
            self._data.append(value)
        elif field_name == "event":
            self._event = value
        elif field_name == "id":
            self._id = value
        # unknown fields ignored per spec
        return None

    def _dispatch(self) -> Optional[SseMessage]:
        if not self._data and self._event is None and not self._comments:
            return None
        data = "\n".join(self._data) if self._data else None
        msg = SseMessage(
            data=None if data == DONE_SENTINEL else data,
            event=self._event,
            id=self._id,
            comments=self._comments,
            done=data == DONE_SENTINEL,
        )
        self._data = []
        self._event = None
        self._comments = []
        return msg

    def flush(self) -> Optional[SseMessage]:
        return self._dispatch()


def decode_sse_lines(lines: Iterable[str]) -> list[SseMessage]:
    dec = SseDecoder()
    out = []
    for line in lines:
        msg = dec.feed_line(line)
        if msg is not None:
            out.append(msg)
    tail = dec.flush()
    if tail is not None:
        out.append(tail)
    return out


async def decode_sse_stream(byte_stream) -> AsyncIterator[SseMessage]:
    """Parse an async byte-chunk stream (e.g. aiohttp response.content)
    into messages; stops after [DONE]."""
    dec = SseDecoder()
    buf = b""
    async for chunk in byte_stream:
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            msg = dec.feed_line(line.decode("utf-8", errors="replace"))
            if msg is not None:
                yield msg
                if msg.done:
                    return
    msg = dec.flush()
    if msg is not None:
        yield msg
