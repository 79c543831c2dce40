"""The prefix cache of TorchEngine (reuse at admission, page registration,
KV events) and the prefix wire (`peek_prefix_tokens`, `export_prefix`,
`ingest_prefix`) against JaxEngine(attn_backend="gather",
step_pipeline=False), on the vendored trained checkpoint in float32 on the
CPU, with f32, int8 and int4 KV.

One engine per implementation and KV format serves the module's cases on
one event loop the module keeps; each case clears both caches first and
does the same operations on both engines. The KV-event case runs on a pair
of its own with a small pool, so the two allocators see the same history
from the start and the events compare whole, page ids and event ids
included. Cases that only the port runs (the step pipeline, speculative
decoding) build port engines of their own.

A finding carried in: the reference's
`test_rejected_tail_never_registered_in_prefix_cache` fails at its own
precondition (every draft on its traffic is accepted now). The port's
counterpart picks traffic with rejected drafts and asserts that it has
them.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence, compute_block_hashes
from dynamo_tpu_torch.runtime.pipeline.context import Context
from tests.test_torch_engine import CKPT, _tokenizer
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

PAGE = 16
ENGINE_KW = dict(page_size=PAGE, num_pages=40, max_batch_size=2, max_model_len=256,
                 prefill_chunk=32, decode_steps=4, seed=0)
PREFIX_KEYS = ("prefix_hits", "prefix_full_hits", "prefix_reused_tokens",
               "prefix_restored_tokens", "prefix_tail_tokens")
KV_FORMATS = [None, "int8", "int4"]


def _line():
    return _tokenizer().encode(" ".join(
        ["the capital of germany is berlin . berlin is the capital of germany ."] * 6))


class Impl:
    """One engine with its package's request types and its KV events."""

    def __init__(self, engine, jax: bool):
        self.engine = engine
        self.jax = jax
        if jax:
            from dynamo_tpu.llm.protocols import common
            from dynamo_tpu.runtime.pipeline.context import Context as ctx_cls
        else:
            common, ctx_cls = tcommon, Context
        self.common, self.ctx_cls = common, ctx_cls
        self.events: list[dict] = []
        engine.subscribe_events(self.events.append)

    async def serve(self, ids, n=8, metadata=None):
        """Greedy stream of `n` tokens and the first frame's meta."""
        c = self.common
        pre = c.PreprocessedRequest(
            token_ids=list(ids),
            stop_conditions=c.StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=c.SamplingOptions(greedy=True),
        )
        toks, meta = [], None
        async for f in await self.engine.generate(self.ctx_cls(pre.to_dict(), metadata=metadata)):
            toks.extend(f.get("token_ids") or [])
            if meta is None and f.get("meta"):
                meta = f["meta"]
        assert len(toks) == n
        return toks, meta

    def prefix_stats(self) -> dict:
        s = self.engine.phase_stats
        return {k: s[k] for k in PREFIX_KEYS}

    def page_rows(self, pid: int) -> list:
        """A page's rows in every pool (K, V and scales), as bytes."""
        if self.jax:
            raise NotImplementedError
        kv = self.engine.kv
        rows = [x[pid * PAGE:(pid + 1) * PAGE] for x in kv.k + kv.v]
        rows += [x[pid] for x in (kv.ks or ()) + (kv.vs or ())]
        return [_np(r).tobytes() for r in rows]


def _jax_engine(kv, **kw):
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel

    return JaxEngine(JaxConfig(
        model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT, dtype="float32",
        attn_backend="gather", kv_quantization=kv,
        **{**ENGINE_KW, "step_pipeline": False, **kw},
    ))


def _port_engine(kv=None, **kw):
    from dynamo_tpu_torch.models.weights import load_config

    cfg = dict(ENGINE_KW, model=load_config(CKPT), checkpoint_dir=CKPT, dtype="float32",
               step_pipeline=False, kv_quantization=kv)
    cfg.update(kw)
    return TorchEngine(EngineConfig(**cfg), device="cpu")


def _np(a) -> np.ndarray:
    """A wire array or pool slice as numpy, bf16 by its bits."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_wire(a, b) -> bool:
    """Two `export_prefix` results byte-equal, token count included."""
    if a[0] != b[0]:
        return False
    for x, y in zip(a[1:], b[1:]):
        if (x is None) != (y is None):
            return False
        if x is not None:
            x, y = _np(x), _np(y)
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                return False
    return True


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=120))


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def pairs(loop):
    """kv format -> (JaxEngine, TorchEngine) as Impls, built at first use."""
    made = {}

    def get(kv):
        if kv not in made:
            async def build():
                return Impl(_jax_engine(kv), True), Impl(_port_engine(kv), False)

            made[kv] = loop.run_until_complete(build())
        for impl in made[kv]:
            impl.engine.allocator.clear_cache()
        return made[kv]

    yield get
    for pair in made.values():
        for impl in pair:
            loop.run_until_complete(impl.engine.close())


def _close(loop, *engines):
    for eng in engines:
        loop.run_until_complete(eng.close())


def _peeks(impl, lists) -> list:
    eng = impl.engine
    return [eng.peek_prefix_tokens(ids) for ids in lists] + [
        eng.peek_prefix_tokens(lists[0], max_tokens=PAGE + 1),
        eng.peek_prefix_tokens([], hashes=compute_block_hashes(lists[0], PAGE)),
    ]


@pytest.mark.parametrize("kv", KV_FORMATS)
def test_warm_stream_equals_cold(loop, pairs, kv):
    """A prompt of 3 pages + 3 tokens: the warm serve reuses the 3 pages
    (prefix_cached_tokens 0, then 48) and streams what the cold one did,
    in both engines; the prefix counters move as JaxEngine's do."""
    prompt = _line()[:3 * PAGE + 3]
    got = {}
    for impl in pairs(kv):
        s0 = impl.prefix_stats()
        cold, m0 = _run(loop, impl.serve(prompt, 12))
        warm, m1 = _run(loop, impl.serve(prompt, 12))
        assert (m0["prefix_cached_tokens"], m1["prefix_cached_tokens"]) == (0, 3 * PAGE)
        assert m0["prompt_tokens"] == m1["prompt_tokens"] == len(prompt)
        s1 = impl.prefix_stats()
        got[impl.jax] = (cold, warm, {k: s1[k] - s0[k] for k in PREFIX_KEYS})
    jcold, jwarm, jd = got[True]
    tcold, twarm, td = got[False]
    assert tcold == twarm == jcold == jwarm
    assert td == jd == dict(prefix_hits=1, prefix_full_hits=1, prefix_reused_tokens=3 * PAGE,
                            prefix_restored_tokens=0, prefix_tail_tokens=3)


def test_prompt_of_whole_pages_recomputes_last_page(loop, pairs):
    """A prompt of exactly 3 full pages, served again: 2 pages are reused
    and the last is recomputed into a fresh page (one token must be
    computed), a full hit. The shared pages' bytes, the released last one
    included, are unchanged by the warm serve."""
    prompt = _line()[:3 * PAGE]
    hashes = compute_block_hashes(prompt, PAGE)
    jax_impl, port = pairs(None)
    streams, deltas = [], []
    for impl in (jax_impl, port):
        cold, _ = _run(loop, impl.serve(prompt, 10))
        if impl is port:
            pids = [port.engine.allocator._by_hash[h] for h in hashes]
            before = [port.page_rows(p) for p in pids]
        s0 = impl.prefix_stats()
        warm, meta = _run(loop, impl.serve(prompt, 10))
        s1 = impl.prefix_stats()
        assert meta["prefix_cached_tokens"] == 2 * PAGE
        streams += [cold, warm]
        deltas.append({k: s1[k] - s0[k] for k in PREFIX_KEYS})
    assert all(s == streams[0] for s in streams)
    assert deltas[0] == deltas[1] == dict(
        prefix_hits=1, prefix_full_hits=1, prefix_reused_tokens=2 * PAGE,
        prefix_restored_tokens=0, prefix_tail_tokens=PAGE)
    assert [port.engine.allocator._by_hash[h] for h in hashes] == pids
    assert [port.page_rows(p) for p in pids] == before


def test_kv_events_match_jax_engine(loop):
    """Serialized traffic on a fresh pair with a small pool: a cold serve,
    its warm re-serve, distinct prompts until the LRU evicts, then
    `clear_cache`. The stored and removed events (type, hashes, page ids,
    parent hash, event_id, block_size) equal JaxEngine's, one for one."""
    async def build():
        kw = dict(num_pages=24)
        return Impl(_jax_engine(None, **kw), True), Impl(_port_engine(None, **kw), False)

    pair = loop.run_until_complete(build())
    line = _line()
    rng = np.random.RandomState(3)
    traffic = [(line[:3 * PAGE + 3], 12), (line[:3 * PAGE + 3], 12)] + [
        (rng.randint(3, 60, size=4 * PAGE + 5).tolist(), 12) for _ in range(5)]
    try:
        for impl in pair:
            for ids, n in traffic:
                _run(loop, impl.serve(ids, n))
            impl.engine.allocator.clear_cache()
        jev, tev = pair[0].events, pair[1].events
        kinds = [e["type"] for e in tev]
        # eviction under pressure came before the clear's removed event
        assert kinds.count("removed") >= 2 and kinds[-1] == "removed"
        assert all(e["block_size"] == PAGE for e in tev)
        assert [e["event_id"] for e in tev] == list(range(len(tev)))
        assert tev == jev
        assert pair[1].prefix_stats() == pair[0].prefix_stats()
    finally:
        _close(loop, *(impl.engine for impl in pair))


def test_router_hash_chain_is_honoured_and_mismatch_ignored(loop, pairs):
    """`kv_block_size`/`kv_seq_hashes`/`kv_local_hashes` in the request's
    metadata: the pages register under exactly those hashes, a later
    plain request (hashed locally) hits them, and a chain of another block
    size or of the wrong length is ignored."""
    prompt = _line()[:2 * PAGE + 2]
    tbs = TokenBlockSequence(prompt, PAGE)
    md = {"kv_block_size": PAGE, "kv_seq_hashes": tbs.sequence_hashes(),
          "kv_local_hashes": [b.local_hash for b in tbs.blocks]}
    streams = []
    for impl in pairs(None):
        cold, m0 = _run(loop, impl.serve(prompt, 8, metadata=dict(md)))
        assert m0["prefix_cached_tokens"] == 0
        assert all(h in impl.engine.allocator._by_hash for h in tbs.sequence_hashes())
        warm, m1 = _run(loop, impl.serve(prompt, 8))
        for bad in (dict(md, kv_block_size=2 * PAGE),
                    dict(md, kv_seq_hashes=md["kv_seq_hashes"][:1])):
            again, m2 = _run(loop, impl.serve(prompt, 8, metadata=bad))
            assert again == cold and m2["prefix_cached_tokens"] == 2 * PAGE
        assert m1["prefix_cached_tokens"] == 2 * PAGE
        streams += [cold, warm]
    assert all(s == streams[0] for s in streams)


def test_peek_prefix_tokens_matches_jax_engine(loop, pairs):
    """After the same serves, `peek_prefix_tokens` (by tokens, by hashes
    and with max_tokens) gives JaxEngine's answers, and takes no page."""
    line = _line()
    lists = [line[:3 * PAGE + 5], line[:2 * PAGE], line[:PAGE - 1],
             line[:PAGE] + [3] * (2 * PAGE), [7] * (3 * PAGE)]
    got = []
    for impl in pairs(None):
        _run(loop, impl.serve(line[:3 * PAGE + 5], 4))
        _run(loop, impl.serve(line[:PAGE] + [3] * PAGE, 4))
        free = impl.engine.allocator.num_free
        got.append(_peeks(impl, lists))
        assert impl.engine.allocator.num_free == free
    assert got[0] == got[1]
    assert got[1][:5] == [3 * PAGE, 2 * PAGE, 0, 2 * PAGE, 0]


@pytest.mark.parametrize("pipe", [False, True])
def test_rejected_draft_never_registered(loop, pairs, pipe):
    """Speculative decoding, serialized and pipelined, on traffic whose
    drafts are partly rejected (asserted: the reference's own test lost
    its rejections when its data drifted). Every registered hash lies
    within the emitted tokens' chain, the warm re-serve rides the cache
    and streams the cold one, and both equal the plain greedy stream."""
    prompt = _line()[:3 * PAGE + 2]
    n = 40
    jax_impl, port = pairs(None)
    plain = [_run(loop, impl.serve(prompt, n))[0] for impl in (jax_impl, port)]
    spec = Impl(_port_engine(spec_decode=True, step_pipeline=pipe), False)
    try:
        cold, m0 = _run(loop, spec.serve(prompt, n))
        st = spec.engine.phase_stats
        assert st["spec_drafted"] > st["spec_accepted"] > 0
        chain = set(compute_block_hashes(prompt + cold, PAGE))
        stored = {b["block_hash"] for e in spec.events if e["type"] == "stored"
                  for b in e["blocks"]}
        assert stored and stored <= chain
        warm, m1 = _run(loop, spec.serve(prompt, n))
        assert (m0["prefix_cached_tokens"], m1["prefix_cached_tokens"]) == (0, 3 * PAGE)
        assert warm == cold == plain[0] == plain[1]
        stored = {b["block_hash"] for e in spec.events if e["type"] == "stored"
                  for b in e["blocks"]}
        assert stored <= chain
    finally:
        _close(loop, spec.engine)


def test_pipelined_finish_then_reserve_and_preemption(loop, pairs):
    """With the step pipeline on, the overshoot dispatch queued behind a
    finishing stream writes past its last emitted token only: a re-serve
    of the prompt rides the registered pages and streams the cold serve.
    Under page pressure the preempted sequence re-matches its own
    registered pages on re-admission, and every stream equals its solo
    serve."""
    line = _line()
    prompt = line[:3 * PAGE + 3]
    jax_impl, port = pairs(None)
    want = [_run(loop, impl.serve(prompt, 21))[0] for impl in (jax_impl, port)]
    pipe = Impl(_port_engine(step_pipeline=True), False)
    small = Impl(_port_engine(step_pipeline=True, num_pages=10), False)
    try:
        cold, _ = _run(loop, pipe.serve(prompt, 21))
        warm, meta = _run(loop, pipe.serve(prompt, 21))
        assert meta["prefix_cached_tokens"] == 3 * PAGE
        assert warm == cold == want[0] == want[1]

        traffic = [(line[:2 * PAGE + 4], 60), (line[5:2 * PAGE + 9], 60)]
        solo = [_run(loop, port.serve(ids, n))[0] for ids, n in traffic]

        async def both():
            return await asyncio.gather(*[small.serve(ids, n) for ids, n in traffic])

        got = [t for t, _ in _run(loop, both())]
        st = small.engine.phase_stats
        assert st["preemptions"] > 0
        assert st["prefix_hits"] > 0 and st["prefix_reused_tokens"] >= 2 * PAGE
        assert got == solo
    finally:
        _close(loop, pipe.engine, small.engine)


@pytest.mark.parametrize("kv", KV_FORMATS)
def test_prefix_trade_both_ways(loop, pairs, kv):
    """JaxEngine's `export_prefix` into TorchEngine's `ingest_prefix`, and
    the port's export into JaxEngine's ingest: each continues the prompt
    as the cold serve did, riding the 3 ingested pages; the wire the port
    ingested, exported again, is byte-equal to what went in; and both
    wires have the reference's layout (dtype and shape)."""
    prompt = _line()[:3 * PAGE + 5]
    jax_impl, port = pairs(kv)
    cold = [_run(loop, impl.serve(prompt, 12))[0] for impl in (jax_impl, port)]
    assert cold[0] == cold[1]
    jwire = jax_impl.engine.export_prefix(prompt)
    twire = port.engine.export_prefix(prompt)
    assert jwire[0] == twire[0] == 3 * PAGE
    for a, b in zip(jwire[1:], twire[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            assert _np(a).dtype == _np(b).dtype and _np(a).shape == _np(b).shape
    for impl in (jax_impl, port):
        impl.engine.allocator.clear_cache()
        assert impl.engine.peek_prefix_tokens(prompt) == 0
    assert port.engine.ingest_prefix(prompt, *jwire[1:]) == 3 * PAGE
    assert jax_impl.engine.ingest_prefix(prompt, *[_np(a) if a is not None else None
                                                   for a in twire[1:]]) == 3 * PAGE
    assert _same_wire(port.engine.export_prefix(prompt), jwire)
    # a second ingest of the same prefix finds it cached and writes nothing
    assert port.engine.ingest_prefix(prompt, *jwire[1:]) == 3 * PAGE
    for impl in (jax_impl, port):
        warm, meta = _run(loop, impl.serve(prompt, 12))
        assert meta["prefix_cached_tokens"] == 3 * PAGE
        assert warm == cold[0]


def test_wire_conversion_and_cross_tier(loop, pairs):
    """`_convert_wire_kv` as the reference's. An int8 wire entering an f32
    pool is dequantized, and a bf16 wire (numpy of the ml_dtypes type,
    read by its bits) is cast: each lands the bytes JaxEngine's ingest
    lands. An f32 wire entering an int8 or int4 pool is quantized: the
    rows and scales are byte-equal to the JAX package's quantizer run on
    the wire; JaxEngine's ingest (which runs it under jit, where XLA turns
    the division by 127 or 7 into a product by its reciprocal) lands the
    same rows and scales within one f32 ulp. Cross-tier wires (int8 into
    int4, int4 into int8 or f32) and int4 wires of other scale channels
    raise KvQuantMismatchError in both; the port then holds no page."""
    import ml_dtypes

    from dynamo_tpu.llm.protocols.common import KvQuantMismatchError as JaxMismatch
    from dynamo_tpu.ops import quant as jquant

    prompt = _line()[:2 * PAGE + 1]
    wires = {}
    for kv in KV_FORMATS:
        jax_impl, _ = pairs(kv)
        _run(loop, jax_impl.serve(prompt, 2))
        wires[kv] = jax_impl.engine.export_prefix(prompt)[1:]
    k, v = wires[None][:2]
    bf16 = (k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16), None, None)
    for kv, wire in [(None, wires["int8"]), (None, bf16), ("int8", wires[None]),
                     ("int4", wires[None])]:
        got = []
        for impl in pairs(kv):
            assert impl.engine.ingest_prefix(prompt, *wire) == 2 * PAGE
            got.append([_np(a) for a in impl.engine.export_prefix(prompt)[1:] if a is not None])
        if kv is None:
            assert all(a.tobytes() == b.tobytes() for a, b in zip(*got)), kv
            continue
        kh = wires["int8"][2].shape[-1]  # scale channels: one a kv head
        if kv == "int8":
            qz = [jquant.quantize_kv_rows(x, kh) for x in (k, v)]
        else:
            qz = [jquant.quantize_kv_rows_int4(x, kh) for x in (k, v)]
        want = [np.asarray(qz[0][0]), np.asarray(qz[1][0]), np.asarray(qz[0][1]),
                np.asarray(qz[1][1])]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got[1], want)), kv
        jrows, trows = got[0][:2], got[1][:2]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(jrows, trows)), kv
        for a, b in zip(got[0][2:], got[1][2:]):
            np.testing.assert_array_max_ulp(a, b, maxulp=1)
    ks = wires["int4"][2]
    for kv, wire in [("int4", wires["int8"]), ("int8", wires["int4"]), (None, wires["int4"]),
                     ("int4", (*wires["int4"][:2], np.repeat(ks, 2, -1), np.repeat(ks, 2, -1)))]:
        for impl in pairs(kv):
            err = JaxMismatch if impl.jax else tcommon.KvQuantMismatchError
            with pytest.raises(err):
                impl.engine.ingest_prefix(prompt, *wire)
            assert impl.engine.peek_prefix_tokens(prompt) == 0
        # the reference keeps the pages it allocated before the raise; the
        # port releases them (ROADMAP Queue 3)
        assert impl.engine.allocator.pages_used == 0
