"""W8A8 int8 weights (M10) on the port against the JAX package, on the CPU.

`quantize_weight`'s codes and scales are byte-equal to
`dynamo_tpu.ops.quant`'s (the port stores the codes [out, in], so they are
compared transposed); `quant_matmul` (the plain versions of
`quantize_rows` and `w8a8_gemm`) equals JAX's eager `quant_matmul` bit for
bit; `quantize_params` builds JAX's structure and `logical_param_count`
counts like JAX's; `params_from_jax` carries a quantized tree; the tiny
model's f32 logits on one quantized tree agree with JAX's eager forward;
and `TorchEngine(quantization="int8")` streams JaxEngine's greedy tokens
on the trained checkpoint, with the model-dtype (f32) KV, int8 KV, and
mixed steps with speculative decoding on. JaxEngine runs `quant_matmul`
under jit, where XLA may compute an activation scale one ulp away from
the eager division: the engines are held to equal streams, the functions
to equal bytes.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import quant, w8a8
from tests.test_torch_engine import CKPT, ENGINE_KW, _greedy, _port_engine
from tests.test_torch_mixed_spec import _traffic
from tests.test_torch_model import PAGE, _configs, _jax_tree, port_prefill_then_decode
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)


def _bytes(a) -> bytes:
    return np.asarray(a).tobytes()


def _weight(rng, k, n):
    w = (rng.randn(k, n) * rng.uniform(0.01, 3.0, size=(1, n))).astype(np.float32)
    w[:, 2] = 0.0  # an all-zero column: scale 1.0, codes 0
    # exact .5 ties: amax 127 makes the scale 1.0, so w / s is w and
    # round half to even sends 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 126.5 -> 126
    w[:, 5] = 0.0
    w[:6, 5] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_byte_equal(dtype):
    rng = np.random.RandomState(0)
    w = _weight(rng, 96, 40)
    jw = jquant.quantize_weight(jnp.asarray(w, dtype))
    tw = quant.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert quant.is_quantized(tw) and tw["q"].dtype == torch.int8
    assert tw["q"].shape == (40, 96) and tw["q"].is_contiguous()  # [out, in]
    assert _bytes(tw["q"].T.contiguous()) == _bytes(jw["q"])
    assert _bytes(tw["s"]) == _bytes(jw["s"])
    assert tw["s"][2] == 1.0 and not tw["q"][2].any()
    assert tw["q"][5, :6].tolist() == [127, 2, -4, 0, 0, 126]


@pytest.mark.parametrize("m", [1, 8, 17])
@pytest.mark.parametrize("n", [64, 68])
@pytest.mark.parametrize("x_dtype,out_dtype", [("bfloat16", None), ("float32", None),
                                               ("bfloat16", "float32")])
def test_quant_matmul_equals_jax_eager(m, n, x_dtype, out_dtype):
    rng = np.random.RandomState(m * 100 + n)
    k = 96
    x = (rng.randn(m, k) * rng.uniform(0.05, 4.0, size=(m, 1))).astype(np.float32)
    x[m // 2] = 0.0  # a zero row (padding rows are zeros): scale 1.0
    w = _weight(rng, k, n)
    jw = jquant.quantize_weight(jnp.asarray(w, jnp.bfloat16))
    tw = quant.quantize_weight(torch.from_numpy(w).to(torch.bfloat16))
    jod = None if out_dtype is None else getattr(jnp, out_dtype)
    tod = None if out_dtype is None else getattr(torch, out_dtype)
    want = jquant.quant_matmul(jnp.asarray(x, x_dtype), jw, out_dtype=jod)
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    got = quant.quant_matmul(xt, tw, out_dtype=tod)
    assert got.dtype == getattr(torch, out_dtype or x_dtype) and got.shape == (m, n)
    assert _bytes(got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32)) \
        == _bytes(np.asarray(want).view(np.int16 if got.dtype == torch.bfloat16 else np.int32))
    # the same through a leading batch shape, and an activation quantized once
    xa = quant.quantize_act(xt.reshape(1, m, k))
    again = quant.mm(xa, tw) if tod is None else quant.quant_matmul(xa, tw, out_dtype=tod)
    assert again.shape == (1, m, n) and torch.equal(again[0], got)
    # the activation codes and scales themselves
    q, s = w8a8.quantize_rows(xt)
    xf = jnp.asarray(x, x_dtype).astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    js = jnp.where(amax > 0, amax / 127.0, 1.0)
    jq = jnp.clip(jnp.round(xf / js), -127, 127).astype(jnp.int8)
    assert _bytes(q) == _bytes(jq) and _bytes(s) == _bytes(js[:, 0])


@pytest.mark.parametrize("tied", [True, False])
def test_quantize_params_structure_and_count(tied):
    jc, tc = _configs("tiny")
    jc, tc = jc.with_(tie_word_embeddings=tied), tc.with_(tie_word_embeddings=tied)
    tree = jax.device_get(jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32))
    jq = jax.device_get(jquant.quantize_params(tree, jc))
    port = llama.params_from_jax(tree, device="cpu")
    tq = quant.quantize_params(port, tc)
    assert set(tq) == set(jq) and "lm_head" in tq
    assert tq["embed"] is port["embed"]  # the table stays for the gather
    for lp_t, lp_j in zip(tq["layers"], jq["layers"]):
        assert set(lp_t) == set(lp_j)
        for key, v in lp_j.items():
            assert quant.is_quantized(lp_t[key]) == jquant.is_quantized(v), key
            if jquant.is_quantized(v):
                assert _bytes(lp_t[key]["q"].T.contiguous()) == _bytes(v["q"])
                assert _bytes(lp_t[key]["s"]) == _bytes(v["s"])
    assert _bytes(tq["lm_head"]["q"].T.contiguous()) == _bytes(jq["lm_head"]["q"])
    assert quant.logical_param_count(tq, tc) == jquant.logical_param_count(jq, jc)
    assert llama.param_count(tq, tc) == llama.param_count(port, tc) == sum(
        w.numel() for lp in port["layers"] for w in lp.values()) + sum(
        w.numel() for k, w in port.items() if k != "layers")
    # the carried JAX tree: codes transposed, never cast by `dtype`
    carried = llama.params_from_jax(jq, device="cpu", dtype=torch.bfloat16)
    for lp_c, lp_t in zip(carried["layers"], tq["layers"]):
        for key in quant.QUANT_KEYS:
            assert torch.equal(lp_c[key]["q"], lp_t[key]["q"])
            assert lp_c[key]["s"].dtype == torch.float32
            assert torch.equal(lp_c[key]["s"], lp_t[key]["s"])
        assert lp_c["attn_norm"].dtype == torch.bfloat16
    # in place: the same tree, each layer replaced
    layers = port["layers"]
    inplace = quant.quantize_params(port, tc, inplace=True)
    assert inplace is port and inplace["layers"] is layers
    assert all(quant.is_quantized(lp["wq"]) for lp in layers)
    # a seeded init quantized as it goes equals the dense init quantized after
    a = llama.init_params(tc, 7, device="cpu", dtype=torch.float32, quantize=True)
    b = quant.quantize_params(llama.init_params(tc, 7, device="cpu", dtype=torch.float32), tc)
    assert all(torch.equal(a["layers"][1][k]["q"], b["layers"][1][k]["q"])
               for k in quant.QUANT_KEYS)
    assert torch.equal(a["lm_head"]["s"], b["lm_head"]["s"])


def test_quantized_model_logits_match_jax_eager():
    jc, tc = _configs("tiny")
    tree = jquant.quantize_params(_jax_tree(jc), jc)
    params = llama.params_from_jax(jax.device_get(tree), device="cpu")
    rng = np.random.RandomState(5)
    t = 20
    toks = rng.randint(1, jc.vocab_size, size=(1, t + 1)).astype(np.int32)
    pages = np.array([3, 1, 4], np.int32)
    num_slots = 8 * PAGE

    def slots(n):
        pos = np.arange(n)
        return pages[pos // PAGE] * PAGE + pos % PAGE

    jkv = jllama.init_kv_cache(jc, num_slots, dtype=jnp.float32)
    smat = jnp.asarray(slots(3 * PAGE)[None])
    jh, jkv = jllama.forward(tree, jc, jnp.asarray(toks[:, :t]), jnp.arange(t)[None], jkv,
                             jnp.asarray(slots(t)), smat)
    j_pre = np.asarray(jllama.logits(tree, jc, jh))
    jh2, _ = jllama.forward(tree, jc, jnp.asarray(toks[:, t:]), jnp.asarray([[t]]), jkv,
                            jnp.asarray(slots(t + 1)[t:]), smat)
    j_dec = np.asarray(jllama.logits(tree, jc, jh2))

    kv = llama.init_kv_cache(tc, num_slots, dtype=torch.float32, device="cpu")
    calls = w8a8.quantize_rows_plain.calls, w8a8.w8a8_gemm_plain.calls
    t_pre, t_dec = port_prefill_then_decode(params, tc, kv, toks, t, pages)
    # two forwards and two heads: 4 quantizations a layer plus the head's,
    # 7 GEMMs a layer plus the head's
    assert w8a8.quantize_rows_plain.calls - calls[0] == 2 * (4 * tc.num_layers + 1)
    assert w8a8.w8a8_gemm_plain.calls - calls[1] == 2 * (7 * tc.num_layers + 1)
    for got, want in ((t_pre, j_pre), (t_dec, j_dec)):
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------------ engines

ENGINE_CASES = {
    "dense_kv": {},
    "int8_kv": dict(kv_quantization="int8"),
    "mixed_spec": dict(mixed_batching=True, mixed_step_tokens=64, spec_decode=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
async def test_greedy_streams_match_jax_engine(case):
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu.llm.protocols import common as jc
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    kw = ENGINE_CASES[case]
    traffic = _traffic()
    jeng = JaxEngine(JaxConfig(
        model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT, dtype="float32",
        attn_backend="gather", quantization="int8", **ENGINE_KW, **kw,
    ))
    want = await asyncio.gather(*[
        _greedy(jeng, ids, n, JaxContext, jc.PreprocessedRequest, jc.StopConditions,
                jc.SamplingOptions) for ids, n in traffic])
    await jeng.close()

    eng = _port_engine(quantization="int8", **kw)
    assert quant.is_quantized(eng.params["layers"][0]["wq"])
    assert quant.is_quantized(eng.params["lm_head"])
    assert eng.param_count == jeng.param_count
    calls = w8a8.w8a8_gemm_plain.calls
    got = await asyncio.gather(*[_greedy(eng, ids, n) for ids, n in traffic])
    stats = eng.phase_stats
    await eng.close()
    assert list(got) == list(want)
    assert w8a8.w8a8_gemm_plain.calls > calls
    if case == "mixed_spec":
        assert stats["mixed_steps"] > 0 and stats["spec_rows"] > 0


def test_quantization_refusals():
    with pytest.raises(ValueError, match="unknown quantization"):
        EngineConfig(model="tiny", quantization="int4")
    tc = EngineConfig(model="tiny", dtype="float32").model_config()
    params = llama.init_params(tc, 0, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="unquantized"):
        TorchEngine(EngineConfig(model="tiny", dtype="float32", quantization="int8",
                                 num_pages=16, page_size=16, prefill_chunk=32),
                    params=params, device="cpu")
    # quantized caller params are served
    eng = TorchEngine(EngineConfig(model="tiny", dtype="float32", quantization="int8",
                                   num_pages=16, page_size=16, prefill_chunk=32),
                      params=quant.quantize_params(params, tc), device="cpu")
    assert eng.param_count == llama.param_count(params, tc)
