"""The rest of M4 in the port against the JAX package, in float32 on the CPU:
penalties, logprobs with top-N, per-request seeds, `n > 1`, and the
engine's `metrics()` and `subscribe_requests`.

- Ops, on seeded numpy inputs: `apply_penalties` within one f32 ulp of
  JAX's (it is bit-equal here), `count_tokens` and `bump_counts`
  byte-equal, saturating at 127 over a 200-repeat stream; `sample_tokens`'
  logprobs and top-N within 1e-5 of JAX's, top ids equal wherever
  neighbouring logprobs differ by more than that; seeded draws, 4,000 fixed
  seeds on fixed logits, against the exact masked-shortlist probabilities
  of JAX's `_shortlist_mask` by chi-square (p > 1e-3; deterministic, the
  seeds are fixed).
- Engine, on the trained checkpoint: greedy streams with each penalty and
  with all three equal JaxEngine's (one set preempted and re-prefilled);
  greedy streams with `logprobs` (and `top_logprobs` 5) within 1e-4 of
  JaxEngine's, `cum_log_probs` their running sum; `metrics()` keys
  JaxEngine's less `TorchEngine.UNPORTED_METRICS`, their values equal but
  the timings and the counts of clock-driven or package-specific events
  (`CLOCKED`), and the finish summaries equal but the timings and ids.
  One JaxEngine and one TorchEngine, both serialized, serve these cases on
  one module event loop and see the same traffic.
- Seeds: a seeded sampled stream is the same alone, beside other traffic,
  at another dispatch width, with the step pipeline off, and preempted;
  wide and negative seeds fold into [0, 2**31). There is no reference to
  match draws bit for bit (the hash is the port's own).
- `n = 3` with a seed through the port's preprocessor: three choices,
  each the single request with `seed + idx`.
- With mixed steps and spec decoding on, traffic mixing extended-sampler
  and plain rows: the mixed, spec and pipeline counters equal JaxEngine's
  pipelined run (the extended row keeps the batch off both).
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import sampling as jsamp
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.ops import sampling as tsamp
from dynamo_tpu_torch.runtime.pipeline.context import Context
from tests.test_torch_engine import CKPT
from tests.test_torch_mixed_spec import _traffic
from tests.test_torch_mixed_spec_engine import COUNTERS
from tests.test_torch_step_pipeline import MIXED, PIPE_STATS, _jax_engine
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

KW = dict(page_size=16, num_pages=24, max_batch_size=4, max_model_len=256,
          prefill_chunk=32, decode_steps=4, seed=0)
PROMPT = [5, 7, 6, 35, 4]  # "the capital of france is"
# metrics() keys read from clocks
TIMINGS = ("step_device_s", "step_stall_s", "pipeline_overlap_s")
# metrics() keys whose events differ by package or are driven by clocks:
# JaxEngine counts its XLA compiles, the port its decode graph captures and
# kernel builds (none on the CPU); the audits run on a period; the flight
# recorder's digests count every sync, whose number depends on when the
# asynchronous first-token fetches land, and its anomalies and dumps judge
# walls
CLOCKED = ("compile_events", "compile_time_s", "kv_ledger_audits", "flight_digests",
           "flight_dumps", "flight_suppressed", "step_anomalies")


def _port_engine(**kw) -> TorchEngine:
    from dynamo_tpu_torch.models.weights import load_config

    cfg = dict(KW, model=load_config(CKPT), checkpoint_dir=CKPT, dtype="float32")
    cfg.update(kw)
    return TorchEngine(EngineConfig(**cfg), device="cpu")


class Impl:
    """One engine with its package's request types."""

    def __init__(self, engine, ctx_cls, common):
        self.engine, self.ctx_cls, self.common = engine, ctx_cls, common
        self.summaries: list = []
        engine.subscribe_requests(self.summaries.append)

    async def frames(self, ids, n, metadata=None, **so):
        c = self.common
        pre = c.PreprocessedRequest(
            token_ids=list(ids), stop_conditions=c.StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=c.SamplingOptions(**so))
        ctx = self.ctx_cls(pre.to_dict())
        ctx.metadata.update(metadata or {})
        frames = [f async for f in await self.engine.generate(ctx)]
        assert frames[-1]["finish_reason"] == "length"
        return frames


def _port(engine) -> Impl:
    return Impl(engine, Context, tcommon)


def _tokens(frames) -> list:
    return [t for f in frames for t in f.get("token_ids") or []]


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=120))


@pytest.fixture(scope="module")
def pair(loop):
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    async def build():
        jeng = JaxEngine(JaxConfig(model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT,
                                   dtype="float32", attn_backend="gather", step_pipeline=False,
                                   **KW))
        return {"jax": Impl(jeng, JaxContext, jcommon),
                "torch": _port(_port_engine(step_pipeline=False))}

    out = loop.run_until_complete(build())
    yield out
    for impl in out.values():
        loop.run_until_complete(impl.engine.close())


# ---------------------------------------------------------------- ops


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", ["random", "saturated", "off"])
def test_apply_penalties_within_one_ulp(case):
    rng = np.random.RandomState({"random": 0, "saturated": 1, "off": 2}[case])
    b, v = 6, 128
    logits = (rng.randn(b, v) * 4).astype(np.float32)
    counts = rng.randint(0, 4, size=(b, v)).astype(np.int8)
    fp = rng.uniform(0, 2, b).astype(np.float32)
    pp = rng.uniform(0, 2, b).astype(np.float32)
    rp = rng.uniform(0.5, 2.5, b).astype(np.float32)
    if case == "saturated":
        counts[:, :40] = 127
    if case == "off":
        fp[:], pp[:], rp[:] = 0.0, 0.0, 1.0
    want = np.asarray(jsamp.apply_penalties(_j(logits), _j(counts), _j(fp), _j(pp), _j(rp)))
    got = tsamp.apply_penalties(_t(logits), _t(counts), _t(fp), _t(pp), _t(rp)).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    if case == "off":
        assert (got == logits).all()


@pytest.mark.parametrize("case", ["prompt", "repeat_200", "on_saturated"])
def test_count_tokens_byte_equal(case):
    rng = np.random.RandomState(3)
    b, v = 4, 68
    counts = rng.randint(0, 3, size=(b, v)).astype(np.int8)
    if case == "prompt":
        tokens = rng.randint(0, v, size=90).astype(np.int32)
        tokens[:7] = 0  # the pad id is never counted
    else:
        tokens = np.full(200, 7, np.int32)
    if case == "on_saturated":
        counts[2, 7] = 126
    want = np.asarray(jsamp.count_tokens(_j(counts), jnp.int32(2), _j(tokens)))
    got = tsamp.count_tokens(_t(counts.copy()), 2, _t(tokens)).numpy()
    assert got.tobytes() == want.tobytes()
    if case != "prompt":
        assert got[2, 7] == 127


def test_bump_counts_byte_equal_and_saturates():
    """A 200-repeat stream saturates at 127 and never wraps negative (which
    would turn the penalty into a reward); inactive rows never bump."""
    counts = np.zeros((3, 32), np.int8)
    tokens = np.asarray([7, 7, 9], np.int32)
    active = np.asarray([True, False, True])
    jc, tc = _j(counts), _t(counts.copy())
    step = jax.jit(jsamp.bump_counts)
    for _ in range(200):
        jc = step(jc, _j(tokens), _j(active))
        tsamp.bump_counts(tc, _t(tokens), _t(active))
    got = tc.numpy()
    assert got.tobytes() == np.asarray(jc).tobytes()
    assert got[0, 7] == 127 and got[1, 7] == 0 and got[2, 9] == 127 and (got >= 0).all()
    pen = tsamp.apply_penalties(torch.zeros(3, 32), tc, torch.full((3,), 0.5),
                                torch.zeros(3), torch.ones(3))
    assert pen[0, 7] == -63.5  # a saturated count still penalizes


@pytest.mark.parametrize("mode", ["all_greedy", "greedy_rows", "penalties"])
def test_logprobs_and_tops_match_jax(mode):
    """Logprobs and top-8 of the raw distribution within 1e-5 of JAX's; top
    ids equal wherever neighbouring logprobs differ by more than that."""
    rng = np.random.RandomState(4)
    b, v = 8, 68
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    logits[1, 10:14] = logits[1].max() + 1.0  # ties among the alternatives
    temp = np.zeros(b, np.float32)
    topk = np.zeros(b, np.int32)
    topp = np.ones(b, np.float32)
    kw_j, kw_t = {}, {}
    if mode == "penalties":
        counts = rng.randint(0, 3, size=(b, v)).astype(np.int8)
        pens = [np.full(b, x, np.float32) for x in (0.7, 0.4, 1.3)]
        kw_j = dict(counts=_j(counts), freq_pen=_j(pens[0]), pres_pen=_j(pens[1]),
                    rep_pen=_j(pens[2]), seeds=_j(np.full(b, -1, np.int32)),
                    positions=_j(np.zeros(b, np.int32)))
        kw_t = dict(counts=_t(counts), freq_pen=_t(pens[0]), pres_pen=_t(pens[1]),
                    rep_pen=_t(pens[2]), seeds=_t(np.full(b, -1, np.int32)),
                    positions=_t(np.zeros(b, np.int32)))
    all_greedy = mode == "all_greedy"
    want = jsamp.sample_tokens(_j(logits), jax.random.PRNGKey(0), _j(temp), _j(topk), _j(topp),
                               all_greedy=all_greedy, return_logprobs=True, top_n=8, **kw_j)
    got = tsamp.sample_tokens(_t(logits), torch.Generator().manual_seed(0), _t(temp),
                              _t(topk), _t(topp), all_greedy=all_greedy,
                              return_logprobs=True, top_n=8, **kw_t)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    assert (got[0] == want[0]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)
    assert (got[1] <= 0).all()
    distinct = np.ones_like(want[3], bool)
    gaps = np.abs(np.diff(want[3], axis=1)) > 1e-5
    distinct[:, :-1] &= gaps
    distinct[:, 1:] &= gaps
    assert (got[2][distinct] == want[2][distinct]).all()
    assert distinct[1].sum() < 8 and distinct.sum() > 40


def test_seeded_draws_in_distribution():
    """4,000 fixed seeds on one row of fixed logits (temperature 0.8, top_k
    20, top_p 0.9) against the exact probabilities of JAX's masked
    shortlist, by chi-square (bins of expected count < 5 merged)."""
    from scipy.stats import chisquare

    rng = np.random.RandomState(5)
    v, n = 100, 4000
    logits = (rng.randn(v) * 2).astype(np.float32)
    temp, topk, topp = 0.8, 20, 0.9
    cand, masked = jsamp._shortlist_mask(_j(logits[None] / temp), _j(np.asarray([topk])),
                                         _j(np.asarray([topp], np.float32)))
    probs = np.asarray(jax.nn.softmax(masked[0])).astype(np.float64)
    probs /= probs.sum()
    cand = np.asarray(cand[0])
    got = tsamp.sample_tokens(
        _t(np.repeat(logits[None], n, 0)), torch.Generator().manual_seed(0),
        torch.full((n,), temp), torch.full((n,), topk, dtype=torch.int32),
        torch.full((n,), topp), seeds=torch.arange(n, dtype=torch.int32),
        positions=torch.full((n,), 17, dtype=torch.int32)).numpy()
    support = cand[probs > 0]
    assert np.isin(got, support).all(), "a draw outside the masked shortlist"
    expected = probs[probs > 0] * n
    observed = np.asarray([(got == c).sum() for c in support], np.float64)
    order = np.argsort(-expected)
    expected, observed = expected[order], observed[order]
    small = expected < 5
    if small.any():
        expected = np.append(expected[~small], expected[small].sum())
        observed = np.append(observed[~small], observed[small].sum())
    assert len(expected) > 5
    assert chisquare(observed, expected).pvalue > 1e-3


def test_seeded_uniforms_are_stateless():
    """The hash's uniforms depend on (seed, position, rank) only: a row
    draws the same bits alone or in any batch, and a seed or a position
    apart gives other bits."""
    seeds = torch.tensor([0, 1, 2**31 - 1, 12345], dtype=torch.int32)
    pos = torch.tensor([0, 5, 5, 255], dtype=torch.int32)
    batch = tsamp.seeded_uniforms(seeds, pos, 64)
    for i in range(4):
        alone = tsamp.seeded_uniforms(seeds[i:i + 1], pos[i:i + 1], 64)
        assert torch.equal(alone[0], batch[i])
    assert ((batch > 0) & (batch < 1)).all()
    other = tsamp.seeded_uniforms(seeds, pos + 1, 64)
    assert (other != batch).float().mean() > 0.99


# ---------------------------------------------------------------- engine


PENALTIES = {
    "frequency": dict(frequency_penalty=6.0),
    "presence": dict(presence_penalty=30.0),
    "repetition": dict(repetition_penalty=3.0),
    "all": dict(frequency_penalty=3.0, presence_penalty=3.0, repetition_penalty=2.0),
}


@pytest.mark.parametrize("which", list(PENALTIES))
def test_greedy_penalties_equal_jax(loop, pair, which):
    got = {name: _tokens(_run(loop, impl.frames(PROMPT, 24, greedy=True, **PENALTIES[which])))
           for name, impl in pair.items()}
    plain = _tokens(_run(loop, pair["torch"].frames(PROMPT, 24, greedy=True)))
    assert got["torch"] == got["jax"]
    assert got["torch"] != plain, "the penalty did not change the stream"


def _logprob_frames(loop, impl, top):
    frames = _run(loop, impl.frames(PROMPT, 16, greedy=True, logprobs=True, top_logprobs=top))
    return [f for f in frames if f.get("token_ids")]


@pytest.mark.parametrize("top", [0, 5])
@pytest.mark.parametrize("pipe", [False, True], ids=["serialized", "pipelined"])
def test_logprobs_equal_jax(loop, pair, top, pipe):
    """Greedy streams with logprobs: tokens equal, each logprob and top-N
    within 1e-4 of JaxEngine's, `cum_log_probs` the running sum. The
    pipelined port engine sends the first token's logprob through the
    carry override and the first-token fetch."""
    want = _logprob_frames(loop, pair["jax"], top)
    if pipe:
        eng = _port_engine()
        got = _logprob_frames(loop, _port(eng), top)
        _run(loop, eng.close())
    else:
        got = _logprob_frames(loop, pair["torch"], top)
    assert _tokens(got) == _tokens(want) and len(got) == 16
    lps = [f["log_probs"][0] for f in got]
    np.testing.assert_allclose(lps, [f["log_probs"][0] for f in want], rtol=0, atol=1e-4)
    np.testing.assert_allclose([f["cum_log_probs"] for f in got], np.cumsum(lps),
                               rtol=0, atol=1e-4)
    assert all(lp <= 0 for lp in lps)
    for g, w in zip(got, want):
        if not top:
            assert g["top_log_probs"] is None and w["top_log_probs"] is None
            continue
        (gt,), (wt,) = g["top_log_probs"], w["top_log_probs"]
        assert len(gt) == len(wt) == top
        np.testing.assert_allclose([e[1] for e in gt], [e[1] for e in wt], rtol=0, atol=1e-4)
        wl = [e[1] for e in wt]
        for j in range(top):
            if all(abs(wl[j] - wl[k]) > 1e-4 for k in (j - 1, j + 1) if 0 <= k < top):
                assert gt[j][0] == wt[j][0]
        assert gt[0][0] == g["token_ids"][0] and abs(gt[0][1] - g["log_probs"][0]) < 1e-6


def test_metrics_and_summaries_equal_jax(loop, pair):
    """On the same greedy traffic, `metrics()` keys are JaxEngine's less
    exactly `UNPORTED_METRICS`, every common key but the timings and the
    counts of clock-driven or package-specific events equal, and
    each finish summary equals JaxEngine's but its id and timings. It
    runs before the preemption case below: the two engines' rules for a
    row that preempts itself differ (ROADMAP Queue 3), which moves the
    prefix cache's lookup count and so `prefix_cache_hit_rate`."""
    got = {}
    for name, impl in pair.items():
        n0 = len(impl.summaries)

        async def go():
            return await asyncio.gather(
                impl.frames(PROMPT, 12, greedy=True, metadata={"tenant": "gold"}),
                impl.frames([3, 14, 15, 52, 65, 35] * 4, 9, greedy=True))

        _run(loop, go())
        got[name] = (impl.engine.metrics(), impl.summaries[n0:])
    (jm, js), (tm, ts) = got["jax"], got["torch"]
    assert set(jm) - set(tm) == TorchEngine.UNPORTED_METRICS
    assert set(tm) <= set(jm)
    skip = TIMINGS + CLOCKED
    assert {k: tm[k] for k in tm if k not in skip} == {k: jm[k] for k in tm if k not in skip}
    assert all(isinstance(tm[k], float) and tm[k] >= 0 for k in TIMINGS)
    assert all(tm[k] >= 0 for k in CLOCKED)

    def strip(s):
        return {k: v for k, v in s.items() if k not in ("request_id", "queue_wait_s", "ttft_s",
                                                        "itl_s")}

    key = lambda s: s["prompt_tokens"]  # noqa: E731
    assert [strip(s) for s in sorted(ts, key=key)] == [strip(s) for s in sorted(js, key=key)]
    assert [s["tenant"] for s in sorted(ts, key=key)] == ["gold", "default"]
    for s in ts:
        assert set(s) == set(js[0])
        assert 0 <= s["queue_wait_s"] <= s["ttft_s"] and s["itl_s"] > 0


def test_penalties_survive_preemption(loop, pair):
    """Four penalized streams at once overflow the pool (23 pages of 16):
    the preempted one re-prefills with its history recounted, and every
    stream equals JaxEngine's."""
    prompts = [[(7 * i + 3 * k) % 60 + 3 for i in range(40)] for k in range(4)]
    so = dict(greedy=True, frequency_penalty=6.0, presence_penalty=1.0)
    got = {}
    before = pair["torch"].engine.phase_stats["preemptions"]
    for name, impl in pair.items():

        async def go():
            return await asyncio.gather(*[impl.frames(p, 50, **so) for p in prompts])

        got[name] = [_tokens(f) for f in _run(loop, go())]
    assert pair["torch"].engine.phase_stats["preemptions"] > before
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------- seeds


SEEDED = dict(temperature=1.5, top_k=30, top_p=0.95, seed=1234)
SEEDED_PROMPT = [40, 12, 3, 60]  # an unlikely start: the model's draws spread
OTHERS = [([9, 10, 11, 12, 13], dict(temperature=1.0)), ([20, 21, 22], dict(greedy=True)),
          ([30, 31, 32, 33], dict(temperature=0.7, seed=99))]


async def _seeded_alone(seed=SEEDED["seed"], **kw):
    eng = _port_engine(**kw)
    toks = _tokens(await _port(eng).frames(SEEDED_PROMPT, 40, **dict(SEEDED, seed=seed)))
    await eng.close()
    return toks


@pytest.fixture(scope="module")
def seeded_ref(loop):
    ref = _run(loop, _seeded_alone())
    assert _run(loop, _seeded_alone(seed=SEEDED["seed"] + 1)) != ref, "the seed draws nothing"
    return ref


@pytest.mark.parametrize("how", ["beside_traffic", "other_width", "pipeline_off", "preempted"])
def test_seeded_stream_reproduced(loop, seeded_ref, how):
    """The seeded stream served alone (step pipeline on, width 4) is served
    again the same: beside other requests (sampled, greedy, seeded), at
    dispatch width 2, serialized, and preempted under a pool too small for
    the batch."""

    async def go():
        if how == "other_width":
            return await _seeded_alone(max_batch_size=2)
        if how == "pipeline_off":
            return await _seeded_alone(step_pipeline=False)
        kw = dict(num_pages=12, max_batch_size=4) if how == "preempted" else {}
        eng = _port_engine(**kw)
        impl = _port(eng)
        others = [impl.frames(ids * 8 if how == "preempted" else ids, 40, **so)
                  for ids, so in OTHERS]
        res = await asyncio.gather(impl.frames(SEEDED_PROMPT, 40, **SEEDED), *others)
        stats = eng.phase_stats
        await eng.close()
        assert how != "preempted" or stats["preemptions"] > 0
        return _tokens(res[0])

    assert _run(loop, go()) == seeded_ref


def test_wide_and_negative_seeds_fold(loop):
    """Seeds outside int32 fold into [0, 2**31): a wide seed and a
    negative one are reproducible, and a wide seed equals its fold."""
    eng = _port_engine()
    impl = _port(eng)

    async def go():
        out = {}
        for seed in (2**40 + 17, (2**40 + 17) & 0x7FFFFFFF, -5, -5):
            toks = _tokens(await impl.frames(SEEDED_PROMPT, 12, temperature=1.5, seed=seed))
            out.setdefault(seed, []).append(toks)
        await eng.close()
        return out

    out = _run(loop, go())
    assert out[2**40 + 17] == out[(2**40 + 17) & 0x7FFFFFFF]
    assert out[-5][0] == out[-5][1] and len(out[-5][0]) == 12
    assert out[-5][0] != out[2**40 + 17][0]


def test_n_choices_equal_single_requests_with_seed_plus_idx(loop):
    """`n = 3` with a seed through the port's preprocessor and backend: three
    choices, each the text of the single request with `seed + idx`."""
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import CompletionRequest
    from dynamo_tpu_torch.runtime.pipeline.engine import link

    card = ModelDeploymentCard.from_local_path(CKPT, name="m")
    eng = _port_engine()
    pipe = link(OpenAIPreprocessor(card), Backend.from_card(card), eng)
    body = dict(model="m", prompt="the capital of france is", max_tokens=10, temperature=3.0,
                seed=41, nvext={"ignore_eos": True})

    async def texts(b):
        out: dict = {}
        async for chunk in await pipe.generate(Context(CompletionRequest.from_body(b))):
            for ch in chunk.get("choices") or []:
                out[ch["index"]] = out.get(ch["index"], "") + (ch.get("text") or "")
        return out

    async def go():
        fanned = await texts(dict(body, n=3))
        singles = [(await texts(dict(body, seed=41 + i)))[0] for i in range(3)]
        await eng.close()
        return fanned, singles

    fanned, singles = _run(loop, go())
    assert [fanned[i] for i in range(3)] == singles
    assert len(set(singles)) > 1 and all(singles)


def test_counters_on_mixed_ext_traffic_equal_jax_pipelined(loop):
    """Mixed steps and spec decoding on, the step pipeline on: the three-
    request traffic with its short request asking for logprobs (so it
    rides the extended sampler) and the others plain. The streams equal
    JaxEngine's and so do the mixed, spec and pipeline counters (decode
    dispatches within one, as for the plain traffic)."""
    from tests.test_torch_step_pipeline import _classes

    kw = dict(MIXED, spec_decode=True)
    traffic = _traffic()
    sos = [dict(greedy=True), dict(greedy=True), dict(greedy=True, logprobs=True)]
    keys = COUNTERS + PIPE_STATS

    async def serve(impl):
        res = await asyncio.gather(*[impl.frames(ids, n, **so)
                                     for (ids, n), so in zip(traffic, sos)])
        stats = {k: impl.engine.phase_stats[k] for k in keys}
        await impl.engine.close()
        return [_tokens(r) for r in res], stats, res[2]

    ctx_cls, *_ = _classes(True)
    from dynamo_tpu.llm.protocols import common as jcommon

    want, jstats, jlp = _run(loop, serve(Impl(_jax_engine(**kw), ctx_cls, jcommon)))
    got, stats, tlp = _run(loop, serve(_port(_port_engine(
        num_pages=64, max_batch_size=4, max_model_len=256, **kw))))
    assert got == want
    assert abs(stats.pop("decode_dispatches") - jstats.pop("decode_dispatches")) <= 1
    assert stats == jstats
    assert stats["mixed_steps"] > 0 or stats["spec_dispatches"] > 0
    np.testing.assert_allclose([f["log_probs"][0] for f in tlp if f.get("token_ids")],
                               [f["log_probs"][0] for f in jlp if f.get("token_ids")],
                               rtol=0, atol=1e-4)
