"""TorchEngine (dynamo_tpu_torch.engine) end to end on the CPU: greedy
streams identical to JaxEngine on the vendored trained checkpoint, chunked
prefill and continuous batching that leave every stream as it runs alone,
preemption under page pressure, and the refusals of what is not ported."""

from __future__ import annotations

import asyncio
import os

import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.pipeline.context import Context
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tiny-trained-llama")
ENGINE_KW = dict(
    page_size=16, num_pages=64, max_batch_size=4, max_model_len=256,
    prefill_chunk=32, decode_steps=4, seed=0,
)


def _tokenizer():
    from dynamo_tpu.llm.tokenizer import HuggingFaceTokenizer

    return HuggingFaceTokenizer.from_file(CKPT)


def _port_engine(**kw):
    from dynamo_tpu_torch.models.weights import load_config

    cfg = dict(ENGINE_KW, model=load_config(CKPT), checkpoint_dir=CKPT, dtype="float32")
    cfg.update(kw)
    return TorchEngine(EngineConfig(**cfg), device="cpu")


async def _greedy(engine, ids, n, ctx_cls=Context, pre_cls=PreprocessedRequest,
                  stop_cls=StopConditions, samp_cls=SamplingOptions):
    pre = pre_cls(
        token_ids=list(ids),
        stop_conditions=stop_cls(max_tokens=n, ignore_eos=True),
        sampling_options=samp_cls(greedy=True),
    )
    toks, reasons = [], []
    async for f in await engine.generate(ctx_cls(pre.to_dict())):
        toks.extend(f.get("token_ids") or [])
        if f.get("finish_reason"):
            reasons.append(f["finish_reason"])
    assert reasons == ["length"]
    return toks


async def test_greedy_matches_jax_engine_on_trained_checkpoint():
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    tok = _tokenizer()
    ids = tok.encode("The capital of France is")
    n = 16

    lm = LocalModel.prepare(CKPT)
    jeng = JaxEngine(JaxConfig(
        model=lm.model_cfg, checkpoint_dir=CKPT, dtype="float32",
        attn_backend="gather", **ENGINE_KW,
    ))
    want = await _greedy(
        jeng, ids, n, JaxContext, jcommon.PreprocessedRequest,
        jcommon.StopConditions, jcommon.SamplingOptions,
    )
    await jeng.close()

    eng = _port_engine()
    got = await _greedy(eng, ids, n)
    await eng.close()
    assert got == want
    assert len(got) == n
    assert tok.decode(got).strip().startswith("paris"), tok.decode(got)


async def test_concurrent_streams_equal_solo_runs():
    # three requests on two slots; the first prompt is longer than
    # prefill_chunk (32), so it prefills in two chunks
    prompts = [
        [(7 * i) % 60 + 3 for i in range(45)],
        [5, 7, 6, 35, 4],
        [(3 * i) % 50 + 3 for i in range(20)],
    ]
    lens = [12, 9, 14]
    solo = []
    for p, n in zip(prompts, lens):
        eng = _port_engine(max_batch_size=2)
        solo.append(await _greedy(eng, p, n))
        await eng.close()

    eng = _port_engine(max_batch_size=2)
    got = await asyncio.gather(*[_greedy(eng, p, n) for p, n in zip(prompts, lens)])
    stats = eng.phase_stats
    await eng.close()
    assert list(got) == solo
    assert stats["prefill_dispatches"] >= 3


async def test_preemption_resumes_streams_unchanged():
    prompts = [[(5 * i) % 60 + 3 for i in range(20)], [(11 * i) % 60 + 3 for i in range(20)]]
    n = 40
    solo = []
    for p in prompts:
        eng = _port_engine(num_pages=7, max_batch_size=2)
        solo.append(await _greedy(eng, p, n))
        await eng.close()
    # each stream needs 4 pages by its end; 6 usable pages force a preemption
    eng = _port_engine(num_pages=7, max_batch_size=2)
    got = await asyncio.gather(*[_greedy(eng, p, n) for p in prompts])
    stats = eng.phase_stats
    await eng.close()
    assert stats["preemptions"] > 0
    assert list(got) == solo


@pytest.mark.parametrize("prios", [[0, 0, 0, 0], [0, 2, 1, 2], [3, 0, 3, 1, 0]])
def test_priority_policy_matches_jax(prios):
    from collections import deque
    from types import SimpleNamespace

    from dynamo_tpu.engine import scheduler as jsched
    from dynamo_tpu_torch.engine import scheduler

    seqs = [SimpleNamespace(priority=p, seq_id=i) for i, p in enumerate(prios)]
    assert scheduler.pick_admission_index(deque(seqs)) == jsched.pick_admission_index(deque(seqs))
    assert scheduler.pick_preemption_victim(seqs) is jsched.pick_preemption_victim(seqs)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(EngineConfig(model="tiny"))


@pytest.mark.parametrize(
    "field,value",
    [("spec_decode", True), ("mixed_batching", True), ("host_kv_pages", 8),
     ("kv_quant_group", 32)],
)
def test_unported_config_refused(field, value):
    if field == "kv_quant_group":
        # int4 scale groups finer than head_dim (32 < 128) are served: S = K * 4
        # scale channels a row, read by the kernels' grouped int4 forms
        cfg = EngineConfig(model="llama-3.1-8b", kv_quantization="int4", kv_quant_group=value)
        assert cfg.kv_quant_group == value
        eng = TorchEngine(EngineConfig(model="tiny", dtype="float32", num_pages=8,
                                       kv_quantization="int4", kv_quant_group=8), device="cpu")
        assert eng.kv.ks[0].shape[1] == eng.model_cfg.num_kv_heads * 16 // 8
        return
    if field == "host_kv_pages":
        # the host offload tier is served, with its batch size and the
        # disaggregated prefill's page wait
        assert (EngineConfig(model="tiny").offload_batch_pages,
                EngineConfig(model="tiny").prefill_wait_s) == (16, 60.0)
        cfg = EngineConfig(model="tiny", dtype="float32", host_kv_pages=value,
                           offload_batch_pages=4, prefill_wait_s=5.0)
        assert (cfg.host_kv_pages, cfg.offload_batch_pages, cfg.prefill_wait_s) == (8, 4, 5.0)
        eng = TorchEngine(cfg, device="cpu")
        assert eng.host_pool.capacity == 8 and eng.metrics()["offload_host_pages"] == 0
        return
    if field in ("spec_decode", "mixed_batching"):
        # served with the step pipeline (the default) and without it
        assert EngineConfig(model="tiny").step_pipeline
        for pipe in (True, False):
            cfg = EngineConfig(**{"model": "tiny", "step_pipeline": pipe, field: value})
            assert getattr(cfg, field) == value and cfg.step_pipeline == pipe
        return
    with pytest.raises(NotImplementedError, match=field):
        EngineConfig(**{"model": "tiny", field: value})


def test_int4_group_must_divide_head_dim():
    with pytest.raises(ValueError, match="must divide head_dim=16"):
        EngineConfig(model="tiny", kv_quantization="int4", kv_quant_group=6)
    EngineConfig(model="tiny", kv_quantization="int4", kv_quant_group=16)  # served


async def test_top_logprobs_without_logprobs_is_served():
    """`top_logprobs` without `logprobs` asks for nothing unported: the
    reference zeroes it (`Sequence.from_request`) and serves the request,
    and the port streams the same tokens."""
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu.llm.protocols import common as jc
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    ids = _tokenizer().encode("The capital of France is")

    async def serve(eng, ctx_cls, pre_cls, stop_cls, samp_cls):
        pre = pre_cls(token_ids=list(ids), stop_conditions=stop_cls(max_tokens=8, ignore_eos=True),
                      sampling_options=samp_cls(greedy=True, top_logprobs=1))
        frames = [f async for f in await eng.generate(ctx_cls(pre.to_dict()))]
        await eng.close()
        assert frames[-1]["finish_reason"] == "length"
        return [t for f in frames for t in f.get("token_ids") or []]

    jeng = JaxEngine(JaxConfig(model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT,
                               dtype="float32", attn_backend="gather", **ENGINE_KW))
    want = await serve(jeng, JaxContext, jc.PreprocessedRequest, jc.StopConditions,
                       jc.SamplingOptions)
    got = await serve(_port_engine(), Context, PreprocessedRequest, StopConditions,
                      SamplingOptions)
    assert got == want and len(got) == 8


async def test_unported_request_refused():
    """A request asking `generate` for disaggregated routing stays refused;
    prompt embeddings and the sampling options refused before (penalties,
    seed, logprobs, n > 1) are served."""
    eng = TorchEngine(EngineConfig(model="tiny", dtype="float32", num_pages=32), device="cpu")
    pre = PreprocessedRequest(token_ids=[1, 2, 3], disagg={"mode": "prefill"})
    with pytest.raises(NotImplementedError, match="disagg"):
        await eng.generate(Context(pre.to_dict()))
    pre = PreprocessedRequest(
        token_ids=[1, 2, 3], prompt_embeds=[[0.0] * 64], embeds_offset=1,
        stop_conditions=StopConditions(max_tokens=2, ignore_eos=True),
        sampling_options=SamplingOptions(greedy=True))
    frames = [f async for f in await eng.generate(Context(pre.to_dict()))]
    assert frames[-1]["finish_reason"] == "length"
    pre = PreprocessedRequest(
        token_ids=[1, 2, 3], stop_conditions=StopConditions(max_tokens=4, ignore_eos=True),
        sampling_options=SamplingOptions(n=2, frequency_penalty=0.5, presence_penalty=0.2,
                                         repetition_penalty=1.2, seed=7, temperature=0.7,
                                         logprobs=True, top_logprobs=2),
    )
    frames = [f async for f in await eng.generate(Context(pre.to_dict()))]
    await eng.close()
    toks = [f for f in frames if f.get("token_ids")]
    assert frames[-1]["finish_reason"] == "length" and len(toks) == 4
    assert all(len(f["log_probs"]) == 1 and len(f["top_log_probs"][0]) == 2 for f in toks)


async def test_prefill_batch_window_holds_trickling_arrivals():
    """The batching window for paced arrivals (the JAX engine's
    test_prefill_batch_window_serves_trickling_arrivals): an idle engine
    dispatches at once; fresh arrivals while a stream decodes are held and
    batched into fewer prefill dispatches than arrivals, and all served;
    the step pipeline's overshoot dispatch, queued behind a finished
    stream, holds nothing."""
    assert (EngineConfig(model="tiny").prefill_batch_window_s,
            EngineConfig(model="tiny").prefill_batch_min_rows) == (0.0, 8)
    eng = _port_engine(prefill_batch_window_s=2.0, prefill_batch_min_rows=4,
                       max_batch_size=8, num_pages=96)
    assert eng.config.step_pipeline
    held = []  # one entry each time a fresh first chunk met the window
    live = eng._any_mid_decode

    def spy():
        held.append(live())
        return held[-1]

    eng._any_mid_decode = spy
    assert len(await _greedy(eng, [5, 6, 7], 12)) == 12
    # right behind the finished stream (its overshoot dispatch may still be
    # in flight): neither arrival waits
    assert len(await _greedy(eng, [8, 9, 10], 4)) == 4
    assert held and not any(held)
    held.clear()

    decoding = asyncio.create_task(_greedy(eng, [11, 12, 13, 14], 240))
    while not any(s is not None and s.generated > 1 for s in eng.slots):
        await asyncio.sleep(0.005)
    before = eng.phase_stats["prefill_dispatches"]
    prompts = [[20, 21, 22], [30, 31, 32, 33, 34], [40, 41], [50, 51, 52, 53]]
    # the first arrival alone, until the engine holds it; then the rest
    # trickle in behind it
    first = asyncio.create_task(_greedy(eng, prompts[0], 4))
    for _ in range(1000):
        if any(held):
            break
        await asyncio.sleep(0.005)

    async def late(delay, prompt):
        await asyncio.sleep(delay)
        return await _greedy(eng, prompt, 4)

    rest = await asyncio.gather(*[late(0.01 * i, p) for i, p in enumerate(prompts[1:])])
    got = [await first] + list(rest)
    dispatched = eng.phase_stats["prefill_dispatches"] - before
    assert len(await decoding) == 240
    await eng.close()
    assert [len(t) for t in got] == [4] * 4
    assert any(held) and dispatched < len(prompts)

    # the liveness test itself: a dispatch whose rows left their slots
    # (decode or mixed) is the overshoot; a first token alone is no decode
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine.engine import _Dispatch

    eng = TorchEngine(EngineConfig(model="tiny", dtype="float32", num_pages=16), device="cpu")
    seq = SimpleNamespace(prefilling=False, generated=1)
    assert not eng._any_mid_decode()
    eng._inflight = _Dispatch(None, [(0, seq)], 1)
    assert not eng._inflight_live()  # the stream left its slot: the overshoot
    eng.slots[0] = seq
    assert eng._inflight_live() and eng._any_mid_decode()
    eng._inflight = _Dispatch(None, [], 1, mixed=True, bld={"entries": [("dec", 1, seq, 1)]})
    assert not eng._inflight_live()
    eng.slots[1] = seq
    assert eng._inflight_live()
    eng._inflight = None
    assert not eng._any_mid_decode()  # a first token alone is no decode
    seq.generated = 2
    assert eng._any_mid_decode()
