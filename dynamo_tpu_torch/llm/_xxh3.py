"""XXH3-64 (seed 0, default secret) in plain Python.

Bit-compatible with `xxhash.xxh3_64(data).intdigest()` for every input
length: the short (0-16 bytes), medium (17-240 bytes) and long (> 240
bytes, striped accumulator) paths of the XXH3 specification. Block hashes
are 4 * page_size bytes (256 at page 64) and chain hashes 16 bytes, so the
cost per hashed block is a few microseconds of host time.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX1 = 0x165667919E3779F9
_PMX2 = 0x9FB21C651E98DF25

_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_SECRET_SIZE = len(_SECRET)  # 192
_STRIPE = 64
_STRIPES_PER_BLOCK = (_SECRET_SIZE - _STRIPE) // 8
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK

_u32 = struct.Struct("<I").unpack_from
_u64 = struct.Struct("<Q").unpack_from
_u64x8 = struct.Struct("<8Q").unpack_from


def _r64(b: bytes, off: int) -> int:
    return _u64(b, off)[0]


def _r32(b: bytes, off: int) -> int:
    return _u32(b, off)[0]


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, n: int) -> int:
    h ^= _rotl(h, 49) ^ _rotl(h, 24)
    h = (h * _PMX2) & _M64
    h ^= (h >> 35) + n
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _mix16(b: bytes, off: int, soff: int) -> int:
    return _fold64(
        _r64(b, off) ^ _r64(_SECRET, soff),
        _r64(b, off + 8) ^ _r64(_SECRET, soff + 8),
    )


def _accumulate_512(acc: list, b: bytes, off: int, soff: int) -> None:
    data = _u64x8(b, off)
    keys = _u64x8(_SECRET, soff)
    for i in range(8):
        dk = data[i] ^ keys[i]
        acc[i ^ 1] = (acc[i ^ 1] + data[i]) & _M64
        acc[i] = (acc[i] + (dk & 0xFFFFFFFF) * (dk >> 32)) & _M64


def _scramble(acc: list) -> None:
    keys = _u64x8(_SECRET, _SECRET_SIZE - _STRIPE)
    for i in range(8):
        a = acc[i]
        a ^= a >> 47
        a ^= keys[i]
        acc[i] = (a * _P32_1) & _M64


def _long(b: bytes) -> int:
    n = len(b)
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    nb_blocks = (n - 1) // _BLOCK
    for blk in range(nb_blocks):
        for s in range(_STRIPES_PER_BLOCK):
            _accumulate_512(acc, b, blk * _BLOCK + s * _STRIPE, s * 8)
        _scramble(acc)
    nb_stripes = ((n - 1) - _BLOCK * nb_blocks) // _STRIPE
    for s in range(nb_stripes):
        _accumulate_512(acc, b, nb_blocks * _BLOCK + s * _STRIPE, s * 8)
    _accumulate_512(acc, b, n - _STRIPE, _SECRET_SIZE - _STRIPE - 7)
    result = (n * _P64_1) & _M64
    for i in range(4):
        result += _fold64(
            acc[2 * i] ^ _r64(_SECRET, 11 + 16 * i),
            acc[2 * i + 1] ^ _r64(_SECRET, 11 + 16 * i + 8),
        )
    return _avalanche(result & _M64)


def xxh3_64_intdigest(b: bytes) -> int:
    """XXH3-64 of `b` with seed 0, as an unsigned int."""
    n = len(b)
    if n == 0:
        return _xxh64_avalanche(_r64(_SECRET, 56) ^ _r64(_SECRET, 64))
    if n <= 3:
        combined = (b[0] << 16) | (b[n >> 1] << 24) | b[n - 1] | (n << 8)
        return _xxh64_avalanche(combined ^ (_r32(_SECRET, 0) ^ _r32(_SECRET, 4)))
    if n <= 8:
        inp = (_r32(b, n - 4) + (_r32(b, 0) << 32)) & _M64
        return _rrmxmx(inp ^ (_r64(_SECRET, 8) ^ _r64(_SECRET, 16)), n)
    if n <= 16:
        lo = _r64(b, 0) ^ (_r64(_SECRET, 24) ^ _r64(_SECRET, 32))
        hi = _r64(b, n - 8) ^ (_r64(_SECRET, 40) ^ _r64(_SECRET, 48))
        acc = n + _swap64(lo) + hi + _fold64(lo, hi)
        return _avalanche(acc & _M64)
    if n <= 128:
        acc = n * _P64_1
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(b, 48, 96) + _mix16(b, n - 64, 112)
                acc += _mix16(b, 32, 64) + _mix16(b, n - 48, 80)
            acc += _mix16(b, 16, 32) + _mix16(b, n - 32, 48)
        acc += _mix16(b, 0, 0) + _mix16(b, n - 16, 16)
        return _avalanche(acc & _M64)
    if n <= 240:
        acc = n * _P64_1
        for i in range(8):
            acc += _mix16(b, 16 * i, 16 * i)
        acc = _avalanche(acc & _M64)
        for i in range(8, n // 16):
            acc += _mix16(b, 16 * i, 16 * (i - 8) + 3)
        acc += _mix16(b, n - 16, 136 - 17)
        return _avalanche(acc & _M64)
    return _long(b)
