"""The step pipeline of TorchEngine (`EngineConfig.step_pipeline`, on by
default) against the serialized port (`step_pipeline=False`) and against
JaxEngine(attn_backend="gather", step_pipeline=True), on the vendored
trained checkpoint in float32 on the CPU. Mirrors
`tests/test_step_pipeline.py`:

- greedy streams byte-identical, pipelined against serialized against
  JaxEngine, in bf16/f32, int8 and int4 KV, under an admission wave that
  arrives while a held stream decodes, with mixed steps on, and the
  pipeline engaged: syncs overlapped with a queued dispatch, mixed steps
  read decode rows from the device carry, and no tick was held;
- preemption under page pressure between a dispatch and its sync re-arms
  the carry (a reused slot must not read a dead sequence's carry);
- the device-resident block tables follow page growth;
- spec carry rows whose gate is closed shed their drafts, and an open gate
  lands the in-flight dispatch first and drafts;
- the three-request traffic of `tests/test_torch_mixed_spec_engine.py`
  with the pipeline on: streams and counters equal JaxEngine's with its
  pipeline on (the first-token gap of the serialized engines is closed:
  both fetch a prefill's first token asynchronously).

The wave is triggered by the held stream's own token count, not by a
timer, so every run schedules the same way. On the CPU the engine runs its
dispatches in a worker thread and fetches through one, as the reference
does; the decode loop is the eager form of what the card replays as a CUDA
graph.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from dynamo_tpu_torch.engine import spec as port_spec
from tests.test_torch_engine import CKPT, ENGINE_KW, _greedy, _port_engine
from tests.test_torch_mixed_spec import _traffic
from tests.test_torch_mixed_spec_engine import COUNTERS
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

MIXED = dict(mixed_batching=True, mixed_step_tokens=64)
REPETITIVE = [5, 17, 42, 9] * 6
PIPE_STATS = ("pipeline_overlapped", "mixed_carry_rows", "mixed_holds", "mixed_spec_shed")


def _jax_engine(**kw):
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel

    return JaxEngine(JaxConfig(
        model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT, dtype="float32",
        attn_backend="gather", step_pipeline=True, **ENGINE_KW, **kw,
    ))


def _classes(jax: bool):
    if jax:
        from dynamo_tpu.llm.protocols import common as c
        from dynamo_tpu.runtime.pipeline.context import Context
    else:
        from dynamo_tpu_torch.llm.protocols import common as c
        from dynamo_tpu_torch.runtime.pipeline.context import Context
    return Context, c.PreprocessedRequest, c.StopConditions, c.SamplingOptions


def _jax_greedy(eng, ids, n):
    return _greedy(eng, ids, n, *_classes(True))


async def _wave(eng, jax=False, held_tokens=48, after=9):
    """A held stream decoding; once it has `after` tokens, three 45-token
    prompts (two prefill chunks each) arrive. Returns (held stream, wave
    streams)."""
    ctx_cls, pre_cls, stop_cls, samp_cls = _classes(jax)
    rng = np.random.RandomState(0)
    wave = [rng.randint(3, 60, size=45).tolist() for _ in range(3)]  # vocab 68
    go = asyncio.Event()

    async def held():
        pre = pre_cls(token_ids=list(REPETITIVE),
                      stop_conditions=stop_cls(max_tokens=held_tokens, ignore_eos=True),
                      sampling_options=samp_cls(greedy=True))
        toks = []
        async for f in await eng.generate(ctx_cls(pre.to_dict())):
            toks.extend(f.get("token_ids") or [])
            if len(toks) >= after:
                go.set()
        return toks

    async def arrivals():
        await go.wait()
        return await asyncio.gather(*[
            _greedy(eng, p, 10, ctx_cls, pre_cls, stop_cls, samp_cls) for p in wave])

    h, w = await asyncio.gather(held(), arrivals())
    return h, [list(x) for x in w]


async def _port_wave(**kw):
    eng = _port_engine(**kw)
    out = await _wave(eng)
    stats = eng.phase_stats
    await eng.close()
    return out, stats


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
async def test_wave_streams_equal_serialized_and_jax(kv):
    """Mixed steps pipelined behind in-flight dispatches emit exactly the
    serialized port's and JaxEngine's greedy streams, and the pipeline
    engaged."""
    jeng = _jax_engine(kv_quantization=kv, **MIXED)
    want = await _wave(jeng, jax=True)
    await jeng.close()
    got, st = await _port_wave(kv_quantization=kv, **MIXED)
    ser, sst = await _port_wave(kv_quantization=kv, step_pipeline=False, **MIXED)
    assert got == ser == want
    assert st["mixed_steps"] > 0 and sst["mixed_steps"] > 0
    assert st["pipeline_overlapped"] > 0, "no sync overlapped a dispatch"
    assert st["mixed_carry_rows"] > 0, "no mixed step read the device carry"
    assert st["mixed_holds"] == 0, "a pipelined engine never parks a tick"
    assert sst["mixed_carry_rows"] == sst["pipeline_overlapped"] == 0


async def test_preemption_rearms_carry(caplog):
    """Under page pressure a sequence is preempted, possibly between a
    dispatch and its sync, and its slot reused: the preemption revokes the
    carry license and re-admission re-arms it through the prefill
    override, so every stream equals the unpressured run's."""
    import logging

    ref, _ = await _port_wave(**MIXED)
    with caplog.at_level(logging.INFO, logger="dynamo_tpu_torch.engine"):
        got, st = await _port_wave(num_pages=14, **MIXED)
        ser, sst = await _port_wave(num_pages=14, step_pipeline=False, **MIXED)
    assert st["preemptions"] > 0 and sst["preemptions"] > 0, "no preemption: shrink num_pages"
    assert any("preempting" in r.message for r in caplog.records)
    assert got == ser == ref


async def test_device_tables_follow_page_growth():
    """One stream decoding across several page boundaries reads and writes
    through table rows scattered to the device at each growth."""
    prompt = [3, 14, 15, 52, 65, 35, 59, 9, 32, 38, 46]
    got = {}
    for pipe in (True, False):
        eng = _port_engine(step_pipeline=pipe)
        got[pipe] = await _greedy(eng, prompt, 40)
        await eng.close()
    # 51 positions on pages of 16: admitted on one page, grown three times
    assert len(got[True]) == 40 and (len(prompt) + 40 - 1) // ENGINE_KW["page_size"] == 3
    assert got[True] == got[False]


async def test_spec_stale_history_sheds_drafts(monkeypatch):
    """A carry row whose gate is closed cannot draft (its host history is
    stale): it sheds and still advances at q_len 1."""
    ref, _ = await _port_wave(**MIXED)
    monkeypatch.setattr(port_spec.NgramProposer, "gate_open", lambda self: False)
    got, st = await _port_wave(spec_decode=True, **MIXED)
    assert st["mixed_steps"] > 0
    assert st["mixed_spec_shed"] > 0, "no carry row shed a draft"
    assert got == ref


async def test_spec_gate_open_syncs_first_and_drafts():
    """Gate-open carry rows give up one overlap to land the in-flight
    dispatch and draft from fresh history: spec x mixed keeps drafting
    under pipelined flow."""
    ref, _ = await _port_wave(**MIXED)
    got, st = await _port_wave(spec_decode=True, **MIXED)
    assert st["mixed_spec_rows"] > 0, "pipelining starved the composition"
    assert st["spec_drafted"] > 0
    assert got == ref


@pytest.mark.parametrize("mode", ["mixed", "mixed_spec"])
async def test_traffic_counters_equal_jax_pipelined(mode):
    """The three-request traffic with the pipeline on: streams equal the
    serialized port's, and the mixed, spec and pipeline counters equal
    JaxEngine's with its pipeline on."""
    kw = dict(MIXED, spec_decode=True) if mode == "mixed_spec" else MIXED
    traffic = _traffic()
    keys = COUNTERS + PIPE_STATS
    jeng = _jax_engine(**kw)
    want = await asyncio.gather(*[_jax_greedy(jeng, ids, n) for ids, n in traffic])
    jstats = {k: jeng.phase_stats[k] for k in keys}
    await jeng.close()
    outs = {}
    for pipe in (True, False):
        eng = _port_engine(step_pipeline=pipe, **kw)
        outs[pipe] = await asyncio.gather(*[_greedy(eng, ids, n) for ids, n in traffic])
        if pipe:
            stats = {k: eng.phase_stats[k] for k in keys}
        await eng.close()
    assert list(outs[True]) == list(outs[False]) == list(want)
    # JaxEngine's count of decode dispatches depends on when its worker
    # threads land under load (one more dispatch behind the last syncs in
    # some runs of a loaded CPU); every other counter, those of the
    # first-token gap included, is exact
    assert abs(stats.pop("decode_dispatches") - jstats.pop("decode_dispatches")) <= 1
    assert stats == jstats
    assert stats["pipeline_overlapped"] > 0


class _Cycle:
    """Garbage in a reference cycle, as a closed engine's graphs are."""

    def __init__(self):
        self.me = self


@pytest.mark.parametrize("fails", [False, True], ids=["captures", "step_raises"])
def test_decode_graph_capture_frees_nothing_while_capturing(monkeypatch, fails):
    """DecodeGraphs._capture collects before the capture begins and keeps
    the collector off until it ends (destroying a CUDA graph during a
    capture invalidates it), and turns it back on after, also when the
    step raises. The CUDA graph API is stood in for: the CPU has none."""
    import gc
    import weakref

    import torch

    from dynamo_tpu_torch.engine import decode_graph

    seen = {}

    class FakeGraph:
        def register_generator_state(self, gen):
            seen["gen"] = gen

    class FakeCapture:
        def __init__(self, graph, pool=None):
            pass

        def __enter__(self):
            seen["garbage_alive_at_begin"] = dead() is not None
            seen["gc_on_at_begin"] = gc.isenabled()

        def __exit__(self, *exc):
            seen["gc_on_at_end"] = gc.isenabled()

    def step(width, all_greedy):
        seen["gc_on_in_step"] = gc.isenabled()
        if fails:
            raise RuntimeError("capture failed")
        return torch.zeros(3, width)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    graphs = decode_graph.DecodeGraphs(step, torch.device("cpu"), torch.Generator())
    dead = weakref.ref(_Cycle())
    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            graphs._capture(4, True)
    else:
        assert graphs._capture(4, True).out.shape == (3, 4)
    assert seen["gen"] is graphs._gen
    assert not seen["garbage_alive_at_begin"]
    assert not seen["gc_on_at_begin"] and not seen["gc_on_in_step"]
    assert not seen["gc_on_at_end"]
    assert gc.isenabled()
