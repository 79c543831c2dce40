"""The port's plain-Python msgpack (`dynamo_tpu_torch/utils/msgpack.py`)
against the C library the JAX package frames its wire with: `packb` byte
for byte equal to `msgpack.packb(obj, use_bin_type=True)` (the smallest
encodings at every length and width edge, float64 always, map keys in
insertion order), `unpackb` equal to `msgpack.unpackb(raw, raw=False)`,
the same errors, and the hub codec's frames equal to the reference
codec's. Exact: bytes and values compare with `==` (NaN by its bytes)."""

from __future__ import annotations

import asyncio
import math
import struct

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime.hub import codec as ref_codec
from dynamo_tpu_torch.runtime.hub import codec
from dynamo_tpu_torch.utils import msgpack as mp
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)


def ref_pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def ref_unpack(raw):
    return msgpack.unpackb(raw, raw=False)


def assert_same(obj) -> None:
    raw = ref_pack(obj)
    assert mp.packb(obj) == raw, (obj, mp.packb(obj)[:16], raw[:16])
    assert mp.unpackb(raw) == ref_unpack(raw)


INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
             2**64 - 1, -1, -31, -32, -33, -127, -128, -129, -32767, -32768, -32769,
             -(2**31) + 1, -(2**31), -(2**31) - 1, -(2**63) + 1, -(2**63)]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def test_ints_at_every_width_edge():
    for v in INT_EDGES:
        assert_same(v)
    for v in (True, False, None):
        assert_same(v)
    for v in (2**64, -(2**63) - 1):
        with pytest.raises(OverflowError):
            ref_pack(v)
        with pytest.raises(OverflowError):
            mp.packb(v)


def test_str_and_bin_at_length_edges():
    for n in LENGTHS:
        assert_same("x" * n)
        assert_same(b"\x00" * n)
        assert_same(bytearray(b"y" * n))
        assert_same(memoryview(b"z" * n))
    # multi-byte UTF-8: the length is the encoding's, not the code points'
    for s in ("é" * 15, "é" * 16, "€" * 11, "€" * 86, "😀" * 64):
        assert_same(s)


def test_floats_always_float64():
    for v in (0.0, -0.0, 1.0, 0.5, 1e-310, 1.5e300, math.inf, -math.inf, 3.141592653589793):
        assert_same(v)
    nan = float("nan")
    assert mp.packb(nan) == ref_pack(nan)
    assert math.isnan(mp.unpackb(ref_pack(nan)))
    # a float32 on the wire unpacks as the library unpacks it
    raw = b"\xca" + struct.pack(">f", 0.1)
    assert mp.unpackb(raw) == ref_unpack(raw)


def test_arrays_and_maps_at_length_edges_keep_order():
    for n in LENGTHS[:-1]:
        assert_same(list(range(n)))
        assert_same(tuple(range(n)))
        assert_same({f"k{i}": i for i in range(n)})
    assert_same({"z": 1, "a": 2, "m": [{"y": None, "b": b"\x01"}]})
    assert list(mp.unpackb(ref_pack({"z": 1, "a": 2, "m": 3}))) == ["z", "a", "m"]
    assert_same({b"bytes-key": 1, "str-key": 2})
    assert_same(list(range(70000)))


def test_errors_match_the_library():
    for bad in (object(), {1, 2}, 1 + 2j):
        with pytest.raises(TypeError):
            ref_pack(bad)
        with pytest.raises(TypeError):
            mp.packb(bad)
    cases = [ref_pack({1: 2}), ref_pack(1) + b"\x01", b"\x92\x01", b"\xd9\x05ab", b"\xcd\x01"]
    for raw in cases:
        with pytest.raises(ValueError) as want:
            ref_unpack(raw)
        with pytest.raises(ValueError) as got:
            mp.unpackb(raw)
        assert isinstance(got.value, ValueError) and isinstance(want.value, ValueError)
    with pytest.raises(mp.ExtraData):
        mp.unpackb(ref_pack(1) + b"\x01")


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2**63), max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=40) | st.binary(max_size=8), inner,
                                     max_size=20)),
    max_leaves=60,
)


@settings(derandomize=True, max_examples=200, deadline=None, database=None)
@given(_values)
def test_corpus_against_the_library(obj):
    assert_same(obj)


def test_hub_codec_frames_equal_the_reference_codec():
    frames = [
        {"i": 1, "op": "kv_put", "key": "/a/b", "value": b"\x00" * 300, "lease": 0x1000},
        {"i": 7, "k": "data", "p": mp.packb({"token_ids": [128000, 5], "finish_reason": None})},
        {"push": 3, "ev": {"type": "delete", "key": "/x", "value": None, "rev": 2**33}},
        {"i": 2, "ok": False, "e": "lease 0x1 not found"},
        {"i": 9, "k": "req", "ep": "demo.backend.generate", "id": "r-1",
         "md": {"kv_seq_hashes": [2**64 - 1, 0, 12345], "deadline": 1.5e9}, "p": b""},
    ]
    for f in frames:
        assert codec.encode_frame(f) == ref_codec.encode_frame(f)

    async def read_all(read_frame, raw):
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        out = []
        while (msg := await read_frame(reader)) is not None:
            out.append(msg)
        return out

    raw = b"".join(ref_codec.encode_frame(f) for f in frames)
    assert asyncio.run(read_all(codec.read_frame, raw)) == frames
    assert asyncio.run(read_all(ref_codec.read_frame, raw)) == frames
