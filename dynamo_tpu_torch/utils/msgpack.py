"""A plain-Python MessagePack codec, byte-compatible with the C library.

The hub and data-plane frames, instance records, KV events and typed
payloads of the fleet planes are msgpack (the JAX package frames them with
the `msgpack` package). The port does not depend on that package, so this
module packs and unpacks the subset those frames use: nil, bool, int (every
width, -2**63 ... 2**64 - 1), float64, str, bin, array and map, nested.

`packb(obj)` is byte-equal to `msgpack.packb(obj, use_bin_type=True)`,
smallest encodings included (floats always as float64, as the library
packs them), and `unpackb(raw)` equals `msgpack.unpackb(raw, raw=False)`:
str comes back as str, bin as bytes, arrays as lists, maps as dicts in
their wire order, with map keys restricted to str and bytes
(`strict_map_key`). A float32 on the wire unpacks too. Ext types are not
used by the planes and raise.
"""

from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb", "ExtraData"]

_B = struct.Struct(">B").pack
_H = struct.Struct(">H").pack
_I = struct.Struct(">I").pack
_Q = struct.Struct(">Q").pack
_b = struct.Struct(">b").pack
_h = struct.Struct(">h").pack
_i = struct.Struct(">i").pack
_q = struct.Struct(">q").pack
_d = struct.Struct(">d").pack


class ExtraData(ValueError):
    """Bytes left over after one complete object (the library's ExtraData)."""


def _pack_int(v: int, out: list) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_B(v))
        elif v <= 0xFF:
            out.append(b"\xcc" + _B(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _H(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _I(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(_B(v & 0xFF))
    elif v >= -0x80:
        out.append(b"\xd0" + _b(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _q(v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, c16: bytes, c32: bytes, out: list,
              c8: bytes = b"") -> None:
    if n < fix_max:
        out.append(_B(fix | n))
    elif c8 and n <= 0xFF:
        out.append(c8 + _B(n))
    elif n <= 0xFFFF:
        out.append(c16 + _H(n))
    elif n <= 0xFFFFFFFF:
        out.append(c32 + _I(n))
    else:
        raise ValueError(f"object of length {n} is too large to pack")


def _pack_bin(data, out: list) -> None:
    data = bytes(data)
    n = len(data)
    if n <= 0xFF:
        out.append(b"\xc4" + _B(n))
    elif n <= 0xFFFF:
        out.append(b"\xc5" + _H(n))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xc6" + _I(n))
    else:
        raise ValueError(f"bytes of length {n} are too large to pack")
    out.append(data)


def _pack(obj: Any, out: list) -> None:
    # the library's order: nil, bool, int, float, bytes-like, str, dict,
    # list/tuple, memoryview; anything else is a TypeError
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d(obj))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bin(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xda", b"\xdb", out, c8=b"\xd9")
        out.append(data)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\xde", b"\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\xdc", b"\xdd", out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, memoryview):
        _pack_bin(obj, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """`msgpack.packb(obj, use_bin_type=True)`, byte for byte."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_UNPACK = {c: struct.Struct(f">{c}") for c in "BHIQbhiqfd"}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf) -> None:
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return bytes(chunk)

    def num(self, code: str):
        s = _UNPACK[code]
        end = self.pos + s.size
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        (v,) = s.unpack_from(self.buf, self.pos)
        self.pos = end
        return v


def _key(k):
    if type(k) not in (str, bytes):
        raise ValueError(f"{type(k).__name__} is not allowed for map key when "
                         "strict_map_key=True")
    return k


def _unpack(r: _Reader) -> Any:
    if r.pos >= len(r.buf):
        raise ValueError("Unpack failed: incomplete input")
    c = r.buf[r.pos]
    r.pos += 1
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0xA0 <= c <= 0xBF:
        return r.take(c & 0x1F).decode("utf-8")
    if 0x90 <= c <= 0x9F:
        return [_unpack(r) for _ in range(c & 0x0F)]
    if 0x80 <= c <= 0x8F:
        return _map(r, c & 0x0F)
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if c in _SIMPLE:
        return r.num(_SIMPLE[c])
    if c in _STR:
        return r.take(r.num(_STR[c])).decode("utf-8")
    if c in _BIN:
        return r.take(r.num(_BIN[c]))
    if c in _ARR:
        return [_unpack(r) for _ in range(r.num(_ARR[c]))]
    if c in _MAP:
        return _map(r, r.num(_MAP[c]))
    raise ValueError(f"Unpack failed: unsupported type byte {c:#04x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _key(_unpack(r))
        out[k] = _unpack(r)
    return out


_SIMPLE = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i",
           0xD3: "q", 0xCA: "f", 0xCB: "d"}
_STR = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
_BIN = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
_ARR = {0xDC: "H", 0xDD: "I"}
_MAP = {0xDE: "H", 0xDF: "I"}


def unpackb(raw) -> Any:
    """`msgpack.unpackb(raw, raw=False)`: one object, no bytes left over."""
    r = _Reader(memoryview(raw) if not isinstance(raw, (bytes, bytearray)) else raw)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ExtraData("unpack(b) received extra data.")
    return obj
