"""int4 KV with scale groups finer than head_dim on the port against the JAX
package, in float32 on the CPU.

With `kv_quant_group` g < head_dim each kv head has head_dim / g scales a
token, S = K * head_dim / g channels a row. The reference serves it on its
gather backend: rows are codes times their group's scale, rounded to the
model dtype, then attended (`dynamo_tpu/ops/attention.py`
`paged_attention(int4_groups=...)`). Here: rows and scale pools byte-equal
to the JAX package's for groups 8 and 16 (head_dim 32); the plain decode,
prefill and ragged versions (the grouped forms' references on the card)
against that gather attention; TorchEngine's greedy streams on
`tests/data/tiny-trained-llama` equal to
`JaxEngine(attn_backend="gather", kv_quantization="int4", kv_quant_group=g)`;
the prefix wire byte-equal both ways; and a wire or transfer whose scale
channels are not the pool's refused.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import quant as jquant
from dynamo_tpu.ops.attention import paged_attention as jax_gather
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.kv_transfer import device_transfer_kv
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.ops.attention import slots_from_pages, write_kv_rows
from dynamo_tpu_torch.ops.decode_attention import (
    fused_paged_decode_attention,
    ragged_paged_attention,
)
from dynamo_tpu_torch.ops.prefill_attention import flash_prefill_attention
from dynamo_tpu_torch.runtime.pipeline.context import Context
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)
from tests.test_torch_engine import CKPT, ENGINE_KW, _tokenizer
from tests.test_torch_kv_quant import jax_scales
from tests.test_torch_prefix_cache import _np, _same_wire

KH, HD, PAGE = 2, 32, 16
GROUPS = (8, 16)


def _pools(rng, num_pages, group):
    """Packed int4 pools and scale pools [P, S, PAGE] quantized by the
    port from random rows, and the rows' dense scales."""
    rows = rng.randn(2, num_pages * PAGE, KH * HD).astype(np.float32)
    rows *= rng.uniform(0.05, 3.0, size=(2, num_pages * PAGE, 1)).astype(np.float32)
    (k, v), (ks, vs) = quant.quantize_kv_rows_int4(torch.from_numpy(rows), KH, group)
    return k, v, quant.scales_to_page_tiles(ks, PAGE), quant.scales_to_page_tiles(vs, PAGE)


def _tables(rng, b, w, num_pages):
    perm = rng.permutation(np.arange(1, num_pages))[: b * w]
    return torch.from_numpy(perm.reshape(b, w).astype(np.int32))


def _gather(q, k, v, ks, vs, tables, positions, group, q_lens=None):
    """The reference's gather attention over the port's pools (scale pools
    in the JAX layout)."""
    smat = slots_from_pages(tables, PAGE)
    out = jax_gather(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                     jnp.asarray(smat.numpy()), jnp.asarray(positions),
                     k_scales=jax_scales(ks.numpy()), v_scales=jax_scales(vs.numpy()),
                     q_lens=None if q_lens is None else jnp.asarray(q_lens),
                     int4_groups=HD // group)
    return np.asarray(out)


# ------------------------------------------------------------ rows and pools


@pytest.mark.parametrize("group", GROUPS)
def test_rows_and_scale_pools_byte_equal(group):
    """The row write of mixed and verify steps: packed rows and S-channel
    scales equal to the JAX package's quantizer and scale scatter."""
    rng = np.random.RandomState(group)
    n_pages, m = 6, 40
    cfg = llama.ModelConfig(name="t", vocab_size=8, hidden_size=64, intermediate_size=8,
                            num_layers=1, num_heads=4, num_kv_heads=KH, head_dim=HD)
    kv = llama.init_kv_cache(cfg, n_pages * PAGE, device="cpu", kv_quant="int4",
                             page_size=PAGE, kv_quant_group=group)
    s_ch = quant.int4_scale_channels(KH, HD, group)
    assert kv.ks[0].shape == (n_pages, s_ch, PAGE) and s_ch == KH * HD // group
    rows = (rng.randn(2, m, KH * HD) * rng.uniform(0.01, 9.0, size=(2, m, 1))).astype(np.float32)
    rows[0, 3, :group] = 0.0  # an all-zero group: scale 1.0, codes 0
    slots = torch.from_numpy(rng.permutation(np.arange(PAGE, n_pages * PAGE))[:m])
    write_kv_rows(kv.k[0], kv.v[0], slots, torch.from_numpy(rows[0]),
                  torch.from_numpy(rows[1]), kv.ks[0], kv.vs[0], int4=True, num_kv_heads=KH)
    for pool, spool, r in ((kv.k[0], kv.ks[0], rows[0]), (kv.v[0], kv.vs[0], rows[1])):
        jq, js = jquant.quantize_kv_rows_int4(jnp.asarray(r), KH, group)
        want = np.zeros((n_pages * PAGE, KH * HD // 2), np.int8)
        want[slots.numpy()] = np.asarray(jq)
        jpool = jquant.scatter_kv_scales(jquant.init_kv_scale_pool(n_pages, PAGE, s_ch),
                                         jnp.asarray(slots.numpy()), js, s_ch)
        assert pool.numpy().tobytes() == want.tobytes()
        assert np.asarray(jax_scales(spool.numpy())).tobytes() == np.asarray(jpool).tobytes()
        back = quant.dequantize_kv_rows_int4(pool[slots], quant.gather_kv_scales(spool, slots), KH)
        assert back.numpy().tobytes() == np.asarray(
            jquant.dequantize_kv_rows_int4(jq, js, KH)).tobytes()


# ------------------------------------------------------------ the plain versions


def test_plain_decode_matches_gather_attention():
    for group in GROUPS:
        rng = np.random.RandomState(10 + group)
        b, h, w, num_pages = 3, 4, 5, 20
        k, v, ks, vs = _pools(rng, num_pages, group)
        tables = _tables(rng, b, w, num_pages)
        q = torch.from_numpy(rng.randn(b, h, HD).astype(np.float32))
        new = torch.from_numpy(rng.randn(2, b, KH * HD).astype(np.float32))
        (nk, nv), (nks, nvs) = quant.quantize_kv_rows_int4(new, KH, group)
        lengths = torch.tensor([37, 1, 80], dtype=torch.int32)
        out, *_ = fused_paged_decode_attention(
            q, nk, nv, k, v, tables, lengths, lengths - 1, ks, vs, nks, nvs, page_size=PAGE,
            int4=True)
        want = _gather(q[:, None], k, v, ks, vs, tables, (lengths - 1)[:, None].numpy(), group)
        np.testing.assert_allclose(out.numpy(), want[:, 0], rtol=2e-5, atol=2e-5)
        # the new rows and their scales landed at write_pos
        slot = (tables[0, 36 // PAGE] * PAGE + 36 % PAGE).item()
        assert k[slot].numpy().tobytes() == nk[0].numpy().tobytes()
        assert torch.equal(quant.gather_kv_scales(ks, torch.tensor([slot]))[0], nks[0])


def test_plain_prefill_matches_gather_attention():
    for group in GROUPS:
        rng = np.random.RandomState(20 + group)
        b, t, h, w, num_pages = 3, 24, 4, 5, 20
        k, v, ks, vs = _pools(rng, num_pages, group)
        tables = _tables(rng, b, w, num_pages)
        q = torch.from_numpy(rng.randn(b, t, h, HD).astype(np.float32))
        pos0 = torch.tensor([0, 16, 7], dtype=torch.int32)
        tlen = torch.tensor([24, 20, 1], dtype=torch.int32)
        out = flash_prefill_attention(q, k, v, tables, pos0, tlen, ks, vs, page_size=PAGE,
                                      int4=True)
        pos = (pos0[:, None] + torch.arange(t)[None]).numpy()
        want = _gather(q, k, v, ks, vs, tables, pos, group, q_lens=tlen.numpy())
        valid = (torch.arange(t)[None] < tlen[:, None]).numpy()
        np.testing.assert_allclose(out.numpy()[valid], want[valid], rtol=2e-5, atol=2e-5)
        assert torch.all(out[~torch.from_numpy(valid)] == 0)


def test_plain_ragged_matches_gather_attention():
    for group in GROUPS:
        rng = np.random.RandomState(30 + group)
        t, h, w, num_pages = 8, 4, 6, 34
        rows = [(37, 1), (14, 5), (32, 8), (0, 0), (60, 1)]
        k, v, ks, vs = _pools(rng, num_pages, group)
        tables = _tables(rng, len(rows), w, num_pages)
        q = torch.from_numpy(rng.randn(len(rows), t, h, HD).astype(np.float32))
        p0 = torch.tensor([r[0] for r in rows], dtype=torch.int32)
        ql = torch.tensor([r[1] for r in rows], dtype=torch.int32)
        out = ragged_paged_attention(q, k, v, tables, p0, ql, ks, vs, page_size=PAGE, int4=True)
        pos = (p0[:, None] + torch.arange(t)[None]).numpy()
        want = _gather(q, k, v, ks, vs, tables, pos, group, q_lens=ql.numpy())
        valid = (torch.arange(t)[None] < ql[:, None]).numpy()
        np.testing.assert_allclose(out.numpy()[valid], want[valid], rtol=2e-5, atol=2e-5)
        assert torch.all(out[~torch.from_numpy(valid)] == 0)


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def pairs(loop):
    """group -> (JaxEngine(gather), TorchEngine) on the trained checkpoint,
    int4 KV in groups of `group`, built at first use."""
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu_torch.models.weights import load_config

    built = {}

    def get(group):
        if group not in built:
            kw = dict(ENGINE_KW, dtype="float32", checkpoint_dir=CKPT,
                      kv_quantization="int4", kv_quant_group=group)
            built[group] = (
                JaxEngine(JaxConfig(model=LocalModel.prepare(CKPT).model_cfg,
                                    attn_backend="gather", **kw)),
                TorchEngine(EngineConfig(model=load_config(CKPT), **kw), device="cpu"))
        return built[group]

    yield get
    for pair in built.values():
        for eng in pair:
            loop.run_until_complete(eng.close())


async def _greedy(engine, ids, n, common=tcommon, ctx_cls=Context):
    pre = common.PreprocessedRequest(
        token_ids=list(ids), stop_conditions=common.StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=common.SamplingOptions(greedy=True))
    frames = [f async for f in await engine.generate(ctx_cls(pre.to_dict()))]
    assert frames[-1]["finish_reason"] == "length"
    return [t for f in frames for t in f.get("token_ids") or []]


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=60))


@pytest.mark.parametrize("group", GROUPS)
def test_greedy_matches_jax_engine(loop, pairs, group):
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    jeng, teng = pairs(group)
    assert teng._kv_scale_channels() == jeng._kv_scale_channels() == KH * HD // group
    assert teng.kv.ks[0].shape[1] == KH * HD // group
    tok = _tokenizer()
    for text, n in (("The capital of France is", 16), ("the " * 20, 24)):
        ids = tok.encode(text)
        want = _run(loop, _greedy(jeng, ids, n, jcommon, JaxContext))
        got = _run(loop, _greedy(teng, ids, n))
        assert got == want
    assert tok.decode(_run(loop, _greedy(teng, tok.encode("The capital of France is"), 4))) \
        .strip().startswith("paris")


@pytest.mark.parametrize("group", GROUPS)
def test_prefix_wire_byte_equal_both_ways(loop, pairs, group):
    """JaxEngine's export into the port's ingest and the port's into
    JaxEngine's: the S-channel scales travel whole, and each side's export
    of what it ingested is byte-equal to the wire that came in."""
    jeng, teng = pairs(group)
    ids = _tokenizer().encode("the quick brown fox jumps over the lazy dog " * 8)[:3 * PAGE + 5]
    for eng in (jeng, teng):
        eng.allocator.clear_cache()
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    cold = [_run(loop, _greedy(jeng, ids, 4, jcommon, JaxContext)), _run(loop, _greedy(teng, ids, 4))]
    assert cold[0] == cold[1]
    jwire, twire = jeng.export_prefix(ids), teng.export_prefix(ids)
    assert jwire[0] == twire[0] == 3 * PAGE
    assert _np(jwire[3]).shape == _np(twire[3]).shape == (2, 3 * PAGE, KH * HD // group)
    for eng in (jeng, teng):
        eng.allocator.clear_cache()
    assert teng.ingest_prefix(ids, *jwire[1:]) == 3 * PAGE
    assert jeng.ingest_prefix(ids, *[_np(a) for a in twire[1:]]) == 3 * PAGE
    assert _same_wire(teng.export_prefix(ids), jwire)
    assert _same_wire(jeng.export_prefix(ids), (twire[0], *[_np(a) for a in twire[1:]]))
    assert _run(loop, _greedy(teng, ids, 4)) == cold[0]


def test_scale_channel_mismatch_raises(loop, pairs):
    """A wire or a transfer between int4 pools of other groupings would
    read scales at the wrong features: refused, as in the reference."""
    _, t8 = pairs(8)
    _, t16 = pairs(16)
    ids = _tokenizer().encode("the quick brown fox jumps over the lazy dog " * 8)[:2 * PAGE + 3]
    t16.allocator.clear_cache()
    _run(loop, _greedy(t16, ids, 2))
    wire16 = t16.export_prefix(ids)
    t8.allocator.clear_cache()
    with pytest.raises(tcommon.KvQuantMismatchError, match="kv_quant_group"):
        t8.ingest_prefix(ids, *wire16[1:])
    with pytest.raises(tcommon.KvQuantMismatchError, match="grouping"):
        device_transfer_kv(t16, t8, [1, 2], [1, 2], 2 * PAGE)
    pre = tcommon.PreprocessedRequest(token_ids=list(ids[:2 * PAGE]))
    k, v, ks, vs = (a[:, :2 * PAGE] for a in wire16[1:])
    with pytest.raises(ValueError, match="scale shape"):
        _run(loop, t8.generate_remote(Context(pre.to_dict()), 1, k, v, ks, vs))


def test_config_groups():
    from dynamo_tpu.engine import EngineConfig as JaxConfig

    for g in (8, 16, 32, None):
        EngineConfig(model="llama-3.1-8b", kv_quantization="int4", kv_quant_group=g)
    JaxConfig(model="llama-3.1-8b", kv_quantization="int4", kv_quant_group=4)
    # the reference serves groups under 8 on its gather backend; the port
    # refuses them by name (the kernels stage at most head_dim / 8 scales)
    with pytest.raises(NotImplementedError, match="kv_quant_group=4"):
        EngineConfig(model="llama-3.1-8b", kv_quantization="int4", kv_quant_group=4)
    with pytest.raises(ValueError, match="must divide head_dim=128"):
        EngineConfig(model="llama-3.1-8b", kv_quantization="int4", kv_quant_group=48)
    eng = TorchEngine(EngineConfig(model="tiny", dtype="float32", num_pages=8, page_size=16,
                                   kv_quantization="int4", kv_quant_group=8), device="cpu")
    assert eng.kv.ks[0].shape == (8, 4, 16) and eng.host_pool is None
    assert eng._kv_int4_groups == 2 and eng._kv_scale_channels() == 4
    # the KV auto-sizer (no num_pages) counts the groups' scales, and the
    # host tier's buffers carry S channels
    eng = TorchEngine(EngineConfig(model="tiny", dtype="float32", page_size=16, host_kv_pages=2,
                                   kv_quantization="int4", kv_quant_group=8), device="cpu")
    assert eng.kv.ks[0].shape[1:] == (4, 16) and eng.host_pool.scale_width == 4
