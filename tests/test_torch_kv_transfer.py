"""The device-path KV transfer between two TorchEngines in one process
(`dynamo_tpu_torch/engine/kv_transfer.py`) and the disaggregation pair it
serves, on the vendored trained checkpoint in float32 on the CPU, with
f32, int8 and int4 KV. The second engine of each pair is built on the
first's parameter tree.

- `prefill_only(device_arrays=True)` on one engine, `generate_remote` on
  the other: the stream equals the first engine's own serve.
- `device_transfer_kv` of a prompt's pages: the destination's rows (and
  scale tiles) byte-equal to the source's for the positions moved, a
  partial last page included; the moved pages, registered in the
  destination's prefix cache, carry a serve that streams the source's.
- The refusals the reference makes: another page size, another KV tier
  (both directions), another int4 scale grouping; and too few pages.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.kv_transfer import device_transfer_kv
from dynamo_tpu_torch.llm.protocols.common import KvQuantMismatchError
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from tests.test_torch_prefix_cache import PAGE, Impl, _line, _port_engine, _run

KV_FORMATS = [None, "int8", "int4"]


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def engines(loop):
    """kv format -> (source, destination) port engines, the destination on
    the source's parameters; each call clears both caches."""
    made = {}

    def get(kv):
        if kv not in made:
            src = _port_engine(kv)
            dst = TorchEngine(src.config, params=src.params, device="cpu")
            made[kv] = (Impl(src, False), Impl(dst, False))
        for impl in made[kv]:
            impl.engine.allocator.clear_cache()
        return made[kv]

    yield get
    for pair in made.values():
        for impl in pair:
            loop.run_until_complete(impl.engine.close())


def _rows(eng, pages, n):
    """The first `n` positions of `pages` in every pool, and the pages'
    scale tiles, as bytes."""
    ps, kv = eng.page_size, eng.kv
    slots = (np.asarray(pages)[:, None] * ps + np.arange(ps)).reshape(-1)[:n]
    idx = torch.from_numpy(slots)
    out = [x.index_select(0, idx).numpy().tobytes() for x in kv.k + kv.v]
    pid = torch.tensor(pages[:-(-n // ps)])
    return out + [x.index_select(0, pid).numpy().tobytes() for x in (kv.ks or ()) + (kv.vs or ())]


@pytest.mark.parametrize("kv", KV_FORMATS)
def test_prefill_only_device_arrays_into_generate_remote(loop, engines, kv):
    prompt = _line()[3:3 + 3 * PAGE + 5]
    src, dst = engines(kv)
    want, _ = _run(loop, src.serve(prompt, 10))
    src.engine.allocator.clear_cache()
    c = src.common
    pre = c.PreprocessedRequest(
        token_ids=list(prompt), stop_conditions=c.StopConditions(max_tokens=10, ignore_eos=True),
        sampling_options=c.SamplingOptions(greedy=True))
    first, *wire = _run(loop, src.engine.prefill_only(pre, device_arrays=True))
    assert first == want[0] and wire[0].device == src.engine.device
    assert (wire[2] is None) == (kv is None)

    async def remote():
        return [f async for f in await dst.engine.generate_remote(
            dst.ctx_cls(pre.to_dict()), first, *wire)]

    frames = _run(loop, remote())
    assert [t for f in frames for t in f.get("token_ids") or []] == want
    assert frames[0]["meta"]["remote_prefill"] is True


@pytest.mark.parametrize("kv", KV_FORMATS)
def test_device_transfer_reproduces_rows_and_tokens(loop, engines, kv):
    prompt = _line()[:3 * PAGE + 5]
    blocks = TokenBlockSequence(prompt, PAGE).blocks[:3]
    src, dst = engines(kv)
    want, _ = _run(loop, src.serve(prompt, 10))
    pages = [src.engine.allocator._by_hash[b.sequence_hash] for b in blocks]
    for n in (3 * PAGE - 5, 3 * PAGE):
        got = dst.engine.allocator.allocate(3)
        device_transfer_kv(src.engine, dst.engine, pages, got, n)
        assert _rows(dst.engine, got, n) == _rows(src.engine, pages, n)
        if n < 3 * PAGE:
            dst.engine.allocator.release(got)
    # the whole pages, registered, carry the destination's serve
    dst.engine.allocator.register(got, [(b.sequence_hash, b.local_hash) for b in blocks], None)
    dst.engine.allocator.release(got)
    toks, meta = _run(loop, dst.serve(prompt, 10))
    assert meta["prefix_cached_tokens"] == 3 * PAGE and toks == want


def test_transfer_refusals():
    """Another page size (ValueError), another KV tier either way and
    another int4 grouping (KvQuantMismatchError, a ValueError), too few
    pages (ValueError); nothing is written."""
    def eng(**kw):
        return TorchEngine(EngineConfig(**{**dict(model="tiny", dtype="float32", page_size=8,
                                                  num_pages=8, max_model_len=64,
                                                  prefill_chunk=16), **kw}), device="cpu")

    f32, q8 = eng(), eng(kv_quantization="int8")
    with pytest.raises(ValueError, match="page-size mismatch"):
        device_transfer_kv(f32, eng(page_size=16), [1], [1], 8)
    for a, b in ((f32, q8), (q8, f32)):
        with pytest.raises(KvQuantMismatchError, match="kv_quantization"):
            device_transfer_kv(a, b, [1], [1], 8)
    q4a, q4b = eng(kv_quantization="int4"), eng(kv_quantization="int4")
    q4b._kv_int4_groups = 2  # what a finer grouping (M16) would set
    with pytest.raises(KvQuantMismatchError, match="scale grouping"):
        device_transfer_kv(q4a, q4b, [1], [1], 8)
    with pytest.raises(ValueError, match="need 2 pages"):
        device_transfer_kv(f32, eng(), [1, 2], [1], 9)
    assert not f32.kv.k[0].any()


def test_prefill_only_refuses_penalties(loop, engines):
    """Penalties read a decode slot's count row, and a `prefill_only`
    sequence holds none: refused, no page taken (the reference reads and
    bumps slot 0's row, ROADMAP Queue 3)."""
    src, _ = engines(None)
    c = src.common
    pre = c.PreprocessedRequest(
        token_ids=_line()[:20], stop_conditions=c.StopConditions(max_tokens=4),
        sampling_options=c.SamplingOptions(temperature=0.7, frequency_penalty=0.5))
    with pytest.raises(NotImplementedError, match="penalties on prefill_only"):
        _run(loop, src.engine.prefill_only(pre))
    assert src.engine.allocator.pages_used == 0
