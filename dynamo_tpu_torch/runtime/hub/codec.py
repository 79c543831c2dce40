"""Length-prefixed msgpack framing shared by the hub and the data plane
(the port's `utils/msgpack.py`, byte-equal to the JAX package's frames).

The reference frames messages with a two-part (header+payload) codec
(reference: lib/runtime/src/pipeline/network/codec/two_part.rs:23). Here a
single msgpack map per frame carries both control fields and payload bytes;
msgpack keeps binary payloads zero-copy on decode.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any

from dynamo_tpu_torch.utils import msgpack

MAX_FRAME = 256 * 1024 * 1024  # 256 MiB hard cap
_LEN = struct.Struct(">I")


def encode_frame(msg: dict[str, Any]) -> bytes:
    payload = msgpack.packb(msg)
    return _LEN.pack(len(payload)) + payload


async def read_frame(reader: asyncio.StreamReader) -> dict[str, Any] | None:
    """Read one frame; returns None on clean EOF."""
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds cap {MAX_FRAME}")
    try:
        payload = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return msgpack.unpackb(payload)


def write_frame(writer: asyncio.StreamWriter, msg: dict[str, Any]) -> None:
    writer.write(encode_frame(msg))
