"""TorchEngine on the sparse-MoE family (tiny-moe) against JaxEngine on
the CPU: the genuine-token mask each attention mode gives the router, and
greedy streams equal to JaxEngine(attn_backend="gather")'s on three
requests at once, with the step pipeline on and with mixed steps and
speculative decoding on (one JaxEngine, its weights carried over); the
other formats (int8 and int4 KV, W8A8 with the experts bf16) stream the
same pipelined as serialized; a prefix hit and `prefill_only` ->
`generate_remote` stream the cold tokens; `run.py` serves a Mixtral dir;
the KV auto-sizer sets the experts' buffers aside. tests/test_torch_moe.py
holds the block and the model.
"""

from __future__ import annotations

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jcfg
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import quant
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)
from tests.test_torch_engine import ENGINE_KW, _greedy

JC = jcfg.get_config("tiny-moe").with_(dtype="float32")
TC = tcfg.get_config("tiny-moe").with_(dtype="float32")
PAGE = 16


def test_genuine_tokens_of_each_mode():
    lengths = torch.tensor([3, 0], dtype=torch.int32)
    pw = llama.AttnSpec.page_write(None, None, None, lengths, PAGE)
    assert llama.genuine_tokens(pw, 2, 4).tolist() == [[True] * 3 + [False], [False] * 4]
    pd = llama.AttnSpec.paged_decode(None, None, PAGE, write_pos=torch.tensor([5, -1]))
    assert llama.genuine_tokens(pd, 2, 1).tolist() == [[True], [False]]
    rg = llama.AttnSpec.ragged(None, None, None, torch.tensor([17, 0, 0, 40]), PAGE)
    assert llama.genuine_tokens(rg, 2, 2).tolist() == [[True, False], [False, True]]



# ------------------------------------------------------------ engines


def _moe_traffic():
    """Three requests at once: a 30-token prompt, a 144-token one that
    prefills in chunks (and, with mixed steps, beside the others' decode
    rows), and a short one; the text repeats, so the proposer drafts."""
    rng = np.random.RandomState(0)
    line = rng.randint(1, TC.vocab_size, size=24).tolist() * 7
    return [(line[:30], 24), (line[:144], 12), (rng.randint(1, TC.vocab_size, 7).tolist(), 12)]


MIXED_SPEC = dict(mixed_batching=True, mixed_step_tokens=64, spec_decode=True)


@pytest.fixture(scope="module")
def jax_streams():
    """JaxEngine(attn_backend="gather") on tiny-moe with mixed steps and
    speculative decoding on, pipelined: its greedy streams (which every
    schedule of the same traffic must stream) and its weights."""
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.protocols import common as jcm
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    async def go():
        eng = JaxEngine(JaxConfig(model=JC, attn_backend="gather", **ENGINE_KW, **MIXED_SPEC))
        outs = await asyncio.gather(*[
            _greedy(eng, ids, n, JaxContext, jcm.PreprocessedRequest, jcm.StopConditions,
                    jcm.SamplingOptions) for ids, n in _moe_traffic()])
        stats = eng.phase_stats
        await eng.close()
        return list(outs), stats, jax.device_get(eng.params)

    outs, stats, tree = asyncio.run(go())
    assert stats["mixed_steps"] > 0 and stats["spec_dispatches"] > 0
    return outs, llama.params_from_jax(tree, device="cpu")


async def _port_streams(params, **kw):
    eng = TorchEngine(EngineConfig(model=TC, **ENGINE_KW, **kw), params=params, device="cpu")
    outs = await asyncio.gather(*[_greedy(eng, ids, n) for ids, n in _moe_traffic()])
    stats = eng.phase_stats
    await eng.close()
    return list(outs), stats


@pytest.mark.parametrize("case", ["pipeline", "mixed_spec"])
async def test_greedy_streams_match_jax_engine(case, jax_streams):
    want, params = jax_streams
    got, stats = await _port_streams(params, **(MIXED_SPEC if case == "mixed_spec" else {}))
    assert got == want
    if case == "mixed_spec":
        assert stats["mixed_steps"] > 0 and stats["spec_dispatches"] > 0
    else:
        assert stats["pipeline_overlapped"] > 0


@pytest.mark.parametrize("kw", [dict(kv_quantization="int8"), dict(kv_quantization="int4"),
                                dict(quantization="int8"),
                                dict(quantization="int8", kv_quantization="int8", **MIXED_SPEC)],
                         ids=["int8_kv", "int4_kv", "w8a8", "w8a8_int8_kv_mixed_spec"])
async def test_quantized_engines_serve_pipelined_as_serialized(kw, jax_streams):
    """The other formats, the port alone: the pipelined streams equal the
    serialized engine's on the same weights."""
    _, params = jax_streams
    if kw.get("quantization"):
        params = quant.quantize_params(params, TC)
    got, _ = await _port_streams(params, **kw)
    ref, _ = await _port_streams(params, step_pipeline=False, **kw)
    assert got == ref and [len(s) for s in got] == [n for _, n in _moe_traffic()]


def test_run_serves_a_mixtral_dir(tmp_path):
    """`python -m dynamo_tpu_torch.run in=http out=torch --model-path` on a
    Mixtral checkpoint dir (config.json `MixtralForCausalLM` with
    `num_local_experts`, the fixture BPE tokenizer, block_sparse_moe
    weights): one greedy /v1/completions request through the experts."""
    import json
    import os

    import jax.numpy as jnp

    from dynamo_tpu.models import llama as jllama
    from dynamo_tpu_torch.llm.http import client
    from dynamo_tpu_torch.run import build_parser, serve_http
    from tests.test_torch_moe import _mixtral_dir
    from tests.torch_fixtures import bpe_model_dir

    path = bpe_model_dir(str(tmp_path))
    jc = JC.with_(vocab_size=512, tie_word_embeddings=False)
    tree = jax.device_get(jllama.init_params(jc, jax.random.PRNGKey(2), dtype=jnp.float32))
    _mixtral_dir(path, tree, jc.num_experts)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
                   "vocab_size": 512, "hidden_size": jc.hidden_size,
                   "intermediate_size": jc.intermediate_size,
                   "num_hidden_layers": jc.num_layers, "num_attention_heads": jc.num_heads,
                   "num_key_value_heads": jc.num_kv_heads, "max_position_embeddings": 2048,
                   "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "tie_word_embeddings": False,
                   "num_local_experts": jc.num_experts,
                   "num_experts_per_tok": jc.num_experts_per_tok}, f)
    args = build_parser().parse_args(["in=http", "out=torch", "--model-path", path,
                                      "--device", "cpu", "--dtype", "float32",
                                      "--num-pages", "64", "--http-host", "127.0.0.1",
                                      "--http-port", "0"])
    body = {"model": os.path.basename(path), "prompt": "the capital of france is",
            "max_tokens": 6, "temperature": 0}

    async def go():
        svc, engine = await serve_http(args, "torch")
        try:
            reply = await client.request("127.0.0.1", svc.port, "POST", "/v1/completions", body)
            return reply.status, await reply.json(), engine
        finally:
            await svc.stop()
            await engine.close()

    status, resp, engine = asyncio.run(go())
    assert status == 200, resp
    assert engine.model_cfg.num_experts == jc.num_experts
    lp = engine.params["layers"][1]
    assert "w_gate" not in lp
    np.testing.assert_array_equal(lp["we_down"].numpy(), tree["layers"][1]["we_down"])
    assert resp["usage"]["completion_tokens"] == 6


def test_auto_sizer_reserves_the_expert_buffers(monkeypatch):
    """On a card the KV auto-sizer reads free memory after the weights are
    resident, and an MoE model's also sets aside its experts' buffers at
    the largest step: [E, C] rows, 2 D + 3 F wide."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.models.moe import expert_capacity

    free = 80 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, free))
    pages = {}
    for name in ("llama-3.1-8b", "mixtral-8x7b"):
        cfg = EngineConfig(model=name, dtype="bfloat16", page_size=64)
        m = cfg.model_config()
        pages[name] = TorchEngine._auto_num_pages(SimpleNamespace(
            config=cfg, model_cfg=m, _dtype=torch.bfloat16, device=torch.device("cuda")))
    m = tcfg.get_config("mixtral-8x7b")
    rows = m.num_experts * expert_capacity(m, 32768)
    page_bytes = m.num_layers * 64 * 2 * m.num_kv_heads * m.head_dim * 2
    reserve = rows * (2 * m.hidden_size + 3 * m.intermediate_size) * 2
    assert pages["mixtral-8x7b"] == int((free - reserve) * 0.85 // page_bytes)
    assert pages["llama-3.1-8b"] == int(free * 0.85 // page_bytes)


async def test_prefix_cache_and_disaggregation_serve_moe(jax_streams):
    """tiny-moe through the KV planes: a prompt served cold, then warm over
    its 3 cached pages (a prefix hit computing only its tail), then after
    `clear_cache` through `prefill_only` into `generate_remote` on a second
    engine on the same weights: the same greedy tokens every time."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    _, params = jax_streams
    prompt = _moe_traffic()[1][0][:3 * PAGE + 5]
    src, dst = (TorchEngine(EngineConfig(model=TC, **ENGINE_KW), params=params, device="cpu")
                for _ in range(2))
    want = await _greedy(src, prompt, 10)
    hits = src.phase_stats["prefix_hits"]
    assert await _greedy(src, prompt, 10) == want
    assert src.phase_stats["prefix_hits"] == hits + 1
    assert src.phase_stats["prefix_reused_tokens"] == 3 * PAGE
    src.allocator.clear_cache()
    pre = PreprocessedRequest(
        token_ids=list(prompt), stop_conditions=StopConditions(max_tokens=10, ignore_eos=True),
        sampling_options=SamplingOptions(greedy=True))
    first, *wire = await src.prefill_only(pre)
    assert first == want[0]
    frames = [f async for f in await dst.generate_remote(Context(pre.to_dict()), first, *wire)]
    assert [t for f in frames for t in f.get("token_ids") or []] == want
    assert frames[0]["meta"]["remote_prefill"] is True
    await src.close()
    await dst.close()
