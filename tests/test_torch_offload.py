"""The host offload tier and the disaggregation entries of TorchEngine
against JaxEngine(attn_backend="gather", step_pipeline=False), on the
vendored trained checkpoint in float32 on the CPU, with f32, int8 and int4
KV.

One engine per implementation and KV format (a host pool of 16 pages)
serves the module's cases on one event loop the module keeps; each case
clears both HBM caches and resets both restore gates first. The two
engines' own prefills round f32 rows differently (the JAX forward's dot
products sum in another order; int8 and int4 codes agree, their scales
within one f32 ulp, ROADMAP Queue 3), so where bytes are compared both
pools first hold the same bytes: JaxEngine's export of the prompt,
ingested by the port.

- `Pool` and `HostKvPool` under the same scripted operations as the JAX
  classes: the same LRU order, buffer reuse and host-tagged events.
- The host tier (the reference's `test_host_tier_restores_evicted_prefix`
  traffic, the HBM cache cleared instead of evicted by fillers): host
  buffers byte-equal to JaxEngine's and to the port's own pool pages,
  peeks across both tiers, the restored stream, `prefix_*` counters,
  `offload_*` metrics and finish summaries equal to JaxEngine's.
- The restore gate's three decisions (restore, decline, a failed restore
  that recomputes), each serving the cold stream, counted as JaxEngine
  counts them.
- `prefill_only`: the first token JaxEngine samples, the wire's cached
  prefix byte-equal, its computed tail rows byte-equal in int8 and int4
  and within 1e-5 in f32, their scales within 1e-6 relative (an amax of
  f32 rows that differ); then `generate_remote`
  across the implementations both ways, each streaming a local serve.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine.offload import HostKvPool
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.utils.pool import Pool
from tests.test_torch_prefix_cache import PAGE, Impl, _jax_engine, _line, _np, _port_engine, _run

KV_FORMATS = [None, "int8", "int4"]
HOST_KW = dict(host_kv_pages=16, offload_batch_pages=4)
OFFLOAD_KEYS = ("offload_host_pages", "offload_restored", "offload_declined",
                "offload_restore_failed")
PREFIX_KEYS = ("prefix_hits", "prefix_full_hits", "prefix_reused_tokens",
               "prefix_restored_tokens", "prefix_tail_tokens")


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def pairs(loop):
    """kv format -> (JaxEngine, TorchEngine) as Impls with host pools and
    finish summaries, built at first use; each call clears both HBM
    caches and both restore gates."""
    made = {}

    def get(kv):
        if kv not in made:
            async def build():
                pair = Impl(_jax_engine(kv, **HOST_KW), True), Impl(_port_engine(kv, **HOST_KW),
                                                                     False)
                for impl in pair:
                    impl.summaries = []
                    impl.engine.subscribe_requests(impl.summaries.append)
                return pair

            made[kv] = loop.run_until_complete(build())
        for impl in made[kv]:
            impl.engine.allocator.clear_cache()
            impl.engine._reset_offload_ema()
        return made[kv]

    yield get
    for pair in made.values():
        for impl in pair:
            loop.run_until_complete(impl.engine.close())


def _buf_bytes(buf) -> list:
    """A host page buffer's bytes (kv then scales), bf16 by its bits."""
    parts = [buf["kv"], buf["scales"]] if isinstance(buf, dict) else [buf]
    return [_np(x).tobytes() for x in parts]


async def _offloaded(pair, hashes, timeout_s=60.0):
    """Wait until both host pools hold `hashes` (the write-through copies
    run in the background; JaxEngine's first one compiles its gather, which
    a loaded machine slows)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        if all(h in impl.engine.host_pool for impl in pair for h in hashes):
            return
        for impl in pair:
            impl.engine._maybe_start_offload()
        await asyncio.sleep(0.01)
    raise AssertionError("the host tier never received the prompt's pages")


def _seed_same_bytes(loop, pair, prompt, n=8):
    """JaxEngine serves `prompt` cold; the port serves it too (its stream
    must equal; its host tier parked meanwhile, so its own bytes never go
    out), then takes JaxEngine's exported prefix in place of its own pages,
    so both pools (and from there both host tiers) hold the same bytes.
    Returns the cold stream."""
    jax_impl, port = pair
    paused, port.engine.offload_paused = port.engine.offload_paused, True
    cold = [_run(loop, impl.serve(prompt, n))[0] for impl in pair]
    assert cold[0] == cold[1]
    wire = jax_impl.engine.export_prefix(prompt)
    port.engine.allocator.clear_cache()
    port.engine.offload_paused = paused
    assert port.engine.ingest_prefix(prompt, *wire[1:]) == wire[0]
    return cold[0]


def _deltas(impl, before) -> dict:
    m, s = impl.engine.metrics(), impl.engine.phase_stats
    now = {**{k: m[k] for k in OFFLOAD_KEYS}, **{k: s[k] for k in PREFIX_KEYS}}
    return {k: now[k] - before.get(k, 0) for k in now}


def _snapshot(impl) -> dict:
    return _deltas(impl, {})


def test_pool_and_host_pool_script_match_jax():
    """The copied `Pool` and the port's `HostKvPool` under the reference's
    scripted operations: acquisition order, capacity, take, shared items
    and an awaited acquire; the LRU eviction of a 2-page host pool, its
    buffer reuse, match runs, gets and the host-tagged events, one for
    one; and the quantized buffers' layout."""
    from dynamo_tpu.engine.offload import HostKvPool as JaxHostKvPool
    from dynamo_tpu.utils.pool import Pool as JaxPool

    def pool_script(cls):
        made = iter(range(100))
        pool = cls(factory=lambda: next(made), capacity=3)
        log = []
        a, b, c = pool.try_acquire(), pool.try_acquire(), pool.try_acquire()
        log += [a.value, b.value, c.value, pool.try_acquire(), pool.total, pool.available]
        b.release()
        s = c.share()
        s2 = s.clone()
        s.release()
        log += [pool.available]
        s2.release()
        log += [pool.available, a.take(), pool.total]
        d = pool.try_acquire()
        log += [d.value, pool.available, pool.total]

        async def wait_one():
            e, f = pool.try_acquire(), pool.try_acquire()
            fut = asyncio.ensure_future(pool.acquire())
            await asyncio.sleep(0)
            e.release()
            g = await fut
            return [f is None or f.value, g.value]

        log += asyncio.run(wait_one())
        return log

    assert pool_script(Pool) == pool_script(JaxPool)

    def host_script(cls, fill):
        events = []
        pool = cls(capacity_pages=2, num_layers=1, page_size=4, kv_width=8,
                   on_event=events.append)
        for h in (10, 20, 30):
            buf = pool.reserve()
            fill(buf.value, float(h))
            pool.put(h, h * 2, h - 1 if h > 10 else None, buf)
        dup = pool.reserve()  # at capacity: evicts 20, then a second put of 30 releases it
        pool.put(30, 60, 29, dup)
        out = [len(pool), [h in pool for h in (10, 20, 30)], pool._buffers.total,
               pool.match_prefix([30, 99]), pool.match_prefix([99, 30]),
               float(np.asarray(pool.get(30)).ravel()[0]), pool.get(20), pool.hit_rate()]
        return out, events

    def np_fill(a, x):
        a[:] = x

    def t_fill(a, x):
        a.fill_(x)

    jax_out, jax_events = host_script(JaxHostKvPool, np_fill)
    out, events = host_script(HostKvPool, t_fill)
    assert out == jax_out and events == jax_events
    assert all(e.get("tier") == "host" for e in events) and len(events) == 5
    jq = JaxHostKvPool(2, 3, 4, 8, dtype=np.int8, scale_width=2).reserve().value
    tq = HostKvPool(2, 3, 4, 8, dtype=torch.int8, scale_width=2).reserve().value
    for key in ("kv", "scales"):
        assert tuple(tq[key].shape) == jq[key].shape
        assert _np(tq[key]).dtype == jq[key].dtype
    bf = HostKvPool(1, 3, 4, 8, dtype=torch.bfloat16)
    assert bf.page_bytes == 2 * 3 * 4 * 8 * 2 and bf.buffer_bytes == 0
    bf.reserve()
    assert bf.buffer_bytes == bf.page_bytes


@pytest.mark.parametrize("kv", KV_FORMATS)
def test_host_tier_restores_evicted_prefix(loop, pairs, kv):
    """A prompt of 3 pages + 5 tokens: once its pages sit in both host
    pools, byte-equal to each other and to the port's pool pages, the HBM
    cache is cleared; both engines then peek 3 pages, restore them (the
    tail computes) and stream the cold serve, with equal prefix counters,
    offload metrics and finish summaries."""
    prompt = _line()[:3 * PAGE + 5]
    hashes = compute_block_hashes(prompt, PAGE)
    pair = pairs(kv)
    jax_impl, port = pair
    cold = _seed_same_bytes(loop, pair, prompt)
    port_pages = [port.page_rows(port.engine.allocator._by_hash[h]) for h in hashes]
    _run(loop, _offloaded(pair, hashes))
    for h, pool_rows in zip(hashes, port_pages):
        tbuf = port.engine.host_pool.get(h)
        assert _buf_bytes(tbuf) == _buf_bytes(jax_impl.engine.host_pool.get(h))
        # K then V, each [L, ps, w]: the pool's layer rows in order; scales
        # [2, L, ps, K], the pool's [K, ps] tiles transposed
        kvb = tbuf["kv"] if isinstance(tbuf, dict) else tbuf
        layers = kvb.shape[1]
        host_rows = [_np(kvb[i // layers, i % layers]).tobytes() for i in range(2 * layers)]
        if isinstance(tbuf, dict):
            host_rows += [_np(tbuf["scales"][i // layers, i % layers].T.contiguous()).tobytes()
                          for i in range(2 * layers)]
        assert host_rows == pool_rows
    got, before = {}, {}
    for impl in pair:
        impl.engine.allocator.clear_cache()
        assert impl.engine.peek_prefix_tokens(prompt) == 3 * PAGE
        assert impl.engine.peek_prefix_tokens(prompt, max_tokens=2 * PAGE) == 2 * PAGE
        before[impl.jax] = _snapshot(impl)
        n0 = len(impl.summaries)
        warm, meta = _run(loop, impl.serve(prompt, 8))
        assert warm == cold and meta["prefix_cached_tokens"] == 3 * PAGE
        prefix = impl.summaries[n0]["prefix"]
        got[impl.jax] = (_deltas(impl, before[impl.jax]), prefix)
    assert got[True] == got[False]
    assert got[False][1] == {"reused_blocks": 0, "restored_blocks": 3, "declined_blocks": 0,
                             "gate_reason": ""}
    d = got[False][0]
    assert (d["offload_restored"], d["prefix_restored_tokens"], d["prefix_tail_tokens"]) == (
        1, 3 * PAGE, 5)


def test_restore_gate_decisions(loop, pairs, monkeypatch):
    """Unknown rates restore; a losing economy declines and a winning one
    restores, as JaxEngine decides. End to end with the host copies of a
    prompt's pages in place: a declined restore and a failed one (the
    page-scatter write raising in the port, the jitted inject in
    JaxEngine) each recompute and stream the cold serve, counted and
    stamped in the finish summary as JaxEngine does."""
    prompt = _line()[2:2 * PAGE + 9]
    hashes = compute_block_hashes(prompt, PAGE)
    pair = pairs(None)
    cold = _seed_same_bytes(loop, pair, prompt)
    _run(loop, _offloaded(pair, hashes))

    def economy(eng, bps, tps):
        eng._ema_restore_bps, eng._ema_prefill_tps = bps, tps

    for impl in pair:
        eng = impl.engine
        assert eng._restore_worthwhile(4)
        economy(eng, 1e3, 1e6)
        assert not eng._restore_worthwhile(1)
        economy(eng, 1e12, 10.0)
        assert eng._restore_worthwhile(1)

    def boom(*a, **k):
        raise RuntimeError("injected restore failure")

    got = {}
    for impl in pair:
        eng, rows = impl.engine, []
        for mode in ("declined", "failed"):
            eng.allocator.clear_cache()
            if mode == "declined":
                economy(eng, 1e3, 1e6)
            else:
                economy(eng, 1e12, 10.0)
                if impl.jax:
                    monkeypatch.setattr(eng, "_inject_fn", boom)
                else:
                    monkeypatch.setattr(engine_mod, "paged_kv_write", boom)
            b0, n0 = _snapshot(impl), len(impl.summaries)
            toks, meta = _run(loop, impl.serve(prompt, 8))
            monkeypatch.undo()
            assert toks == cold and meta["prefix_cached_tokens"] == 0
            rows.append((_deltas(impl, b0), impl.summaries[n0]["prefix"]))
        got[impl.jax] = rows
    assert got[True] == got[False]
    (dec, dec_sum), (fail, fail_sum) = got[False]
    assert (dec["offload_declined"], dec["offload_restored"], fail["offload_restore_failed"]) == (
        1, 0, 1)
    assert dec_sum["gate_reason"] == "restore_slower_than_recompute"
    assert fail_sum["gate_reason"] == "restore_failed"
    assert dec_sum["declined_blocks"] == fail_sum["declined_blocks"] == 2


@pytest.mark.parametrize("kv", KV_FORMATS)
def test_prefill_only_wire_and_generate_remote_both_ways(loop, pairs, kv):
    """With the host tier parked, both engines hold JaxEngine's bytes for
    a prompt's 3 full pages. `prefill_only` returns JaxEngine's first token
    and wire layout; the cached prefix's rows are byte-equal, the computed
    tail's rows byte-equal with int8 and int4 KV and within 1e-5 in f32,
    its scales within 1e-6 relative. After both caches are cleared, each wire is
    landed by the other implementation's `generate_remote`, whose stream
    equals the local serve and whose first frame says `remote_prefill`."""
    prompt = _line()[7:7 + 3 * PAGE + 5]
    pair = pairs(kv)
    for impl in pair:
        impl.engine.offload_paused = True
    try:
        cold = _seed_same_bytes(loop, pair, prompt)
        wires = {}
        for impl in pair:
            c = impl.common
            pre = c.PreprocessedRequest(
                token_ids=list(prompt), stop_conditions=c.StopConditions(max_tokens=8,
                                                                         ignore_eos=True),
                sampling_options=c.SamplingOptions(greedy=True))
            wires[impl.jax] = _run(loop, impl.engine.prefill_only(pre))
            assert impl.engine.allocator.pages_used == 0
        (jtok, *jw), (ttok, *tw) = wires[True], wires[False]
        assert jtok == ttok == cold[0]
        n_pref = 3 * PAGE
        for a, b in zip(jw, tw):
            assert (a is None) == (b is None)
            if a is None:
                continue
            a, b = _np(a), _np(b)
            assert a.dtype == b.dtype and a.shape == b.shape == (*a.shape[:1], len(prompt),
                                                                 a.shape[2])
            assert a[:, :n_pref].tobytes() == b[:, :n_pref].tobytes()
            if a.dtype == np.float32 and kv is not None:
                # scales of the computed tail: their amax comes from f32
                # rows that differ by ~1e-6 (they came out 3 ulps apart)
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
            elif a.dtype == np.float32:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
            else:
                assert a.tobytes() == b.tobytes()
        for impl, wire in ((pair[1], jw), (pair[0], [None if x is None else _np(x) for x in tw])):
            impl.engine.allocator.clear_cache()
            c = impl.common
            pre = c.PreprocessedRequest(
                token_ids=list(prompt), stop_conditions=c.StopConditions(max_tokens=8,
                                                                         ignore_eos=True),
                sampling_options=c.SamplingOptions(greedy=True))

            async def remote():
                frames = [f async for f in await impl.engine.generate_remote(
                    impl.ctx_cls(pre.to_dict()), cold[0], *wire)]
                return frames

            frames = _run(loop, remote())
            assert [t for f in frames for t in f.get("token_ids") or []] == cold
            assert frames[0]["meta"]["remote_prefill"] is True
            assert frames[0]["meta"]["prefix_cached_tokens"] == 0
        with pytest.raises(ValueError, match="remote k KV shape"):
            _run(loop, pair[1].engine.generate_remote(
                pair[1].ctx_cls(pre.to_dict()), cold[0], jw[0][:, :-1], *jw[1:]))
    finally:
        for impl in pair:
            impl.engine.offload_paused = False
