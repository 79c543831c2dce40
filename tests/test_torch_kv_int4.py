"""int4 KV on the port against the JAX package, in float32 on the CPU.

Packed rows, scales, unpacked codes and dequantized rows must be
byte-equal to `dynamo_tpu.ops.quant` at every grouping; K7's plain version
(the page write at half width) byte-equal to the JAX kernel in interpret
mode, scales included; K5's (fused int4 decode) and K6's (int4 flash
prefill) plain versions within the tolerances of the bf16 and int8 parity
tests (2e-5 and 2e-4), the pools and scale pools byte-equal after K5's
write; the int4 model within the model tolerance (2e-4) of the JAX
forward; and TorchEngine's greedy stream on the trained checkpoint equal
to JaxEngine's, both with int4 KV.

int4 rows are planar per kv head: byte j of a head holds feature j in its
low nibble and feature j + Hd/2 in its high nibble. Scale pools are the
int8 tier's ([num_pages, K, page_size], `jax_scales` converts them).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu.ops.pallas_attention import (
    fused_paged_decode_attention as jax_fused,
    paged_decode_attention as jax_paged,
)
from dynamo_tpu.ops.pallas_kv_write import paged_kv_write as jax_kv_write
from dynamo_tpu.ops.pallas_prefill import flash_prefill_attention as jax_flash
from dynamo_tpu_torch.engine import EngineConfig
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.ops.decode_attention import (
    fused_paged_decode_attention,
    paged_decode_attention,
)
from dynamo_tpu_torch.ops.kv_write import paged_kv_write
from dynamo_tpu_torch.ops.prefill_attention import flash_prefill_attention
from tests.test_torch_engine import ENGINE_KW, _greedy, _port_engine, _tokenizer
from tests.test_torch_kv_quant import _t, jax_scales, kv_cache_from_jax
from tests.test_torch_model import (
    PAGE,
    VARIANTS,
    _configs,
    _jax_tree,
    port_prefill_then_decode,
)
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)


def _int4_pools(rng, num_pages, kh, hd):
    """Random packed int4 pools (every byte is two codes in [-7, 7]) and
    positive scale pools in the port's layout."""
    n = num_pages * PAGE

    def packed():
        lo = rng.randint(-7, 8, size=(n, kh, hd // 2))
        hi = rng.randint(-7, 8, size=(n, kh, hd // 2))
        return ((hi << 4) | (lo & 15)).astype(np.int8).reshape(n, kh * hd // 2)

    ks = rng.uniform(0.05, 0.5, size=(num_pages, kh, PAGE)).astype(np.float32)
    vs = rng.uniform(0.05, 0.5, size=(num_pages, kh, PAGE)).astype(np.float32)
    return packed(), packed(), ks, vs


# ------------------------------------------------------------ quant.py


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_quantize_kv_rows_int4_byte_equal(groups):
    rng = np.random.RandomState(groups)
    kh, hd = 4, 32
    g = hd // groups
    rows = (rng.randn(10, kh * hd) * rng.uniform(0.01, 20.0, size=(10, 1))).astype(np.float32)
    rows[2, hd:2 * hd] = 0.0            # an all-zero head: scale 1.0, codes 0
    rows[5] = 0.0                       # an all-zero row
    # exact .5 ties: amax 7 makes each group's scale 1.0, so x / scale is
    # x; round half to even sends 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 6.5 -> 6,
    # and the amax itself lands on the clip edge 7
    tie = np.zeros(g, np.float32)
    tie[:6] = [7.0, 2.5, -3.5, 0.5, -0.5, 6.5]
    rows[7] = np.tile(tie, kh * groups)
    rows[8] = -rows[7]                  # the -7 edge
    rows[9] = np.tile(tie[::-1], kh * groups)
    size = None if groups == 1 else g
    jq, js = jquant.quantize_kv_rows_int4(jnp.asarray(rows), kh, size)
    tq, ts = quant.quantize_kv_rows_int4(torch.from_numpy(rows), kh, size)
    assert tq.dtype == torch.int8 and tq.shape == (10, kh * hd // 2)
    assert ts.dtype == torch.float32 and ts.shape == (10, kh * groups)
    assert ts.shape[1] == quant.int4_scale_channels(kh, hd, size)
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    codes = quant.unpack_int4_kv(tq, kh)
    assert codes.numpy().tobytes() == np.asarray(jquant.unpack_int4_kv(jq, kh)).tobytes()
    assert list(codes[7, :6]) == [7, 2, -4, 0, 0, 6]
    assert list(codes[8, :6]) == [-7, -2, 4, 0, 0, -6]
    assert torch.all(ts[5] == 1.0) and torch.all(codes[5] == 0)
    # planar: byte j of head 0 holds feature j (low) and j + hd/2 (high)
    b = int(tq[7, 1])
    assert ((b & 15) ^ 8) - 8 == codes[7, 1] and b >> 4 == codes[7, 1 + hd // 2]
    back = quant.dequantize_kv_rows_int4(tq, ts, kh)
    want = jquant.dequantize_kv_rows_int4(jq, js, kh)
    assert back.numpy().tobytes() == np.asarray(want).tobytes()
    # bf16 rows quantize through f32 on both sides
    jb, jbs = jquant.quantize_kv_rows_int4(jnp.asarray(rows, jnp.bfloat16), kh, size)
    tb, tbs = quant.quantize_kv_rows_int4(torch.from_numpy(rows).to(torch.bfloat16), kh, size)
    assert tb.numpy().tobytes() == np.asarray(jb).tobytes()
    assert tbs.numpy().tobytes() == np.asarray(jbs).tobytes()


def test_int4_scale_channels_and_cache_shapes():
    assert quant.int4_scale_channels(8, 128) == 8
    assert quant.int4_scale_channels(8, 128, 32) == 32
    with pytest.raises(ValueError, match="divide"):
        quant.int4_scale_channels(8, 128, 48)
    _, tc = _configs("tiny")
    kv = llama.init_kv_cache(tc, 4 * PAGE, device="cpu", kv_quant="int4", page_size=PAGE)
    width = tc.num_kv_heads * tc.head_dim // 2
    assert kv.int4 and kv.k[0].shape == (4 * PAGE, width) and kv.k[0].dtype == torch.int8
    assert kv.ks[0].shape == (4, tc.num_kv_heads, PAGE) and torch.all(kv.ks[0] == 1.0)
    with pytest.raises(ValueError, match="even"):
        llama.init_kv_cache(tc.with_(num_kv_heads=1, head_dim=15), PAGE, device="cpu",
                            kv_quant="int4", page_size=PAGE)


# ------------------------------------------------------------ K7


@pytest.mark.parametrize(
    "num_pages,kh,hd,table",
    [
        (8, 2, 32, [3, 1, 6]),          # non-contiguous destination pages
        (10, 4, 16, [0, 5, 2, 0, 9]),   # padding pages land in trash page 0
    ],
)
def test_kv_write_int4_byte_equal(num_pages, kh, hd, table):
    rng = np.random.RandomState(len(table))
    k, v, ks, vs = _int4_pools(rng, num_pages, kh, hd)
    n = len(table)
    nk, nv, nks, nvs = _int4_pools(rng, n, kh, hd)
    kw = kh * hd // 2
    nk, nv = nk.reshape(n, PAGE, kw), nv.reshape(n, PAGE, kw)
    tbl = np.asarray(table, np.int32)
    jk, jv, jks, jvs = jax_kv_write(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl), jnp.asarray(nk), jnp.asarray(nv),
        jax_scales(ks), jax_scales(vs), jax_scales(nks), jax_scales(nvs),
        page_size=PAGE, interpret=True,
    )
    tk, tv, tks, tvs = _t(k, v, ks, vs)
    out = paged_kv_write(tk, tv, torch.from_numpy(tbl), *_t(nk, nv), tks, tvs,
                         *_t(nks, nvs), page_size=PAGE, int4=True)
    assert all(a is b for a, b in zip(out, (tk, tv, tks, tvs)))  # in place
    assert tk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert np.asarray(jax_scales(tks.numpy())).tobytes() == np.asarray(jks).tobytes()
    assert np.asarray(jax_scales(tvs.numpy())).tobytes() == np.asarray(jvs).tobytes()


# ------------------------------------------------------------ K5


def _decode_setup(b, h, kh, hd, w, lengths, seed=0):
    rng = np.random.RandomState(seed)
    num_pages = b * w + 1
    k, v, ks, vs = _int4_pools(rng, num_pages, kh, hd)
    q = rng.randn(b, h, hd).astype(np.float32)
    tables = np.zeros((b, w), np.int32)
    for i in range(b):
        n = -(-lengths[i] // PAGE)
        tables[i, :n] = 1 + i * w + np.arange(n)
    new_k, new_ks = quant.quantize_kv_rows_int4(torch.from_numpy(rng.randn(b, kh * hd) * 2), kh)
    new_v, new_vs = quant.quantize_kv_rows_int4(torch.from_numpy(rng.randn(b, kh * hd)), kh)
    return (q, k, v, ks, vs, tables, np.asarray(lengths, np.int32),
            new_k.numpy(), new_v.numpy(), new_ks.float().numpy(), new_vs.float().numpy())


@pytest.mark.parametrize(
    "b,h,kh,hd,w,wpos",
    [
        (4, 8, 2, 32, 8, [37, 47, -1, 64]),   # G=4: mid-page, page end, idle row, new page
        (2, 4, 4, 32, 4, [0, 50]),            # G=1: first token
        (3, 16, 2, 64, 6, [5, -1, 90]),       # G=8, idle row in the middle
    ],
)
def test_fused_decode_int4_matches_jax_kernel(b, h, kh, hd, w, wpos):
    wpos = np.asarray(wpos, np.int32)
    lengths = np.where(wpos >= 0, wpos + 1, 0).astype(np.int32)
    q, k, v, ks, vs, tables, lens, nk, nv, nks, nvs = _decode_setup(
        b, h, kh, hd, w, lengths.tolist())
    subl = jquant.kv_scale_subl(kh)
    pad = np.ones((b, subl - kh), np.float32)
    want, jk, jv, jks, jvs = jax_fused(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(wpos),
        jax_scales(ks), jax_scales(vs), jnp.asarray(np.concatenate([nks, pad], 1)),
        jnp.asarray(np.concatenate([nvs, pad], 1)),
        page_size=PAGE, pages_per_block=4, interpret=True, int4=True,
    )
    tk, tv, tks, tvs = _t(k, v, ks, vs)
    got, *pools = fused_paged_decode_attention(
        torch.from_numpy(q), *_t(nk, nv), tk, tv, *_t(tables, lens, wpos),
        tks, tvs, *_t(nks, nvs), page_size=PAGE, int4=True,
    )
    assert all(a is b for a, b in zip(pools, (tk, tv, tks, tvs)))  # in place
    assert tk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert np.asarray(jax_scales(tks.numpy())).tobytes() == np.asarray(jks).tobytes()
    assert np.asarray(jax_scales(tvs.numpy())).tobytes() == np.asarray(jvs).tobytes()
    active = lens > 0
    np.testing.assert_allclose(
        got.numpy()[active], np.asarray(want)[active], rtol=2e-5, atol=2e-5
    )
    assert np.all(got.numpy()[~active] == 0.0)


def test_read_only_decode_int4_matches_jax_kernel():
    q, k, v, ks, vs, tables, lens, *_ = _decode_setup(4, 8, 2, 32, 8, [100, 0, 128, 17], 3)
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), jax_scales(ks), jax_scales(vs), page_size=PAGE,
        pages_per_block=4, interpret=True, int4=True,
    )
    tk, tks = _t(k, ks)
    got = paged_decode_attention(
        torch.from_numpy(q), tk, torch.from_numpy(v), *_t(tables, lens), tks,
        torch.from_numpy(vs), page_size=PAGE, int4=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert np.array_equal(tk.numpy(), k) and np.array_equal(tks.numpy(), ks)  # nothing written


# ------------------------------------------------------------ K6


@pytest.mark.parametrize(
    "b,t,h,kh,hd,w,pos0,tlen",
    [
        (2, 32, 8, 2, 16, 4, [0, 0], [32, 29]),          # G=4, ragged tail
        (3, 32, 8, 2, 32, 6, [0, 40, 7], [30, 17, 1]),   # G=4, ragged, mid-page pos0
        (2, 16, 16, 2, 32, 3, [16, 0], [16, 5]),         # G=8
    ],
)
def test_flash_prefill_int4_matches_jax_kernel(b, t, h, kh, hd, w, pos0, tlen):
    rng = np.random.RandomState(b * 100 + t + h)
    num_pages = b * w + 2
    k, v, ks, vs = _int4_pools(rng, num_pages, kh, hd)
    q = rng.randn(b, t, h, hd).astype(np.float32)
    tables = np.stack(
        [rng.permutation(num_pages - 1)[:w] + 1 for _ in range(b)]
    ).astype(np.int32)
    pos0 = np.asarray(pos0, np.int32)
    tlen = np.asarray(tlen, np.int32)
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(pos0), jnp.asarray(tlen), jax_scales(ks), jax_scales(vs),
        page_size=PAGE, t_tile=16, interpret=True, int4=True,
    ))
    got = flash_prefill_attention(
        *_t(q, k, v, tables, pos0, tlen, ks, vs), page_size=PAGE, int4=True,
    ).numpy()
    for i in range(b):
        n = int(tlen[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=2e-4, atol=2e-4)
        assert np.all(got[i, n:] == 0.0)


# ------------------------------------------------------------ model, engine


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_int4_prefill_then_decode_matches_jax(variant):
    jc, tc = _configs(variant)
    tree = _jax_tree(jc)
    params = llama.params_from_jax(tree, device="cpu")
    rng = np.random.RandomState(5)
    t = 20
    toks = rng.randint(1, jc.vocab_size, size=(1, t + 1)).astype(np.int32)
    pages = np.array([3, 1, 4], np.int32)  # the sequence's pages, out of order
    num_slots = 8 * PAGE

    def slots(n):
        pos = np.arange(n)
        return pages[pos // PAGE] * PAGE + pos % PAGE

    # JAX: gather-oracle prefill of t tokens into an int4 cache (one scale
    # group per kv head), then one decode step
    jkv = jllama.init_kv_cache(jc, num_slots, kv_quant="int4", page_size=PAGE)
    spec = jllama.AttnSpec.gather(jnp.asarray(slots(3 * PAGE)[None]), int4_groups=1)
    jh, jkv = jllama.forward(
        tree, jc, jnp.asarray(toks[:, :t]), jnp.arange(t)[None], jkv,
        jnp.asarray(slots(t)), spec,
    )
    j_pre = np.asarray(jllama.logits(tree, jc, jh))
    kv_from_jax = kv_cache_from_jax(jkv, jc.num_kv_heads)._replace(int4=True)
    jh2, _ = jllama.forward(
        tree, jc, jnp.asarray(toks[:, t:]), jnp.asarray([[t]]), jkv,
        jnp.asarray(slots(t + 1)[t:]), spec,
    )
    j_dec = np.asarray(jllama.logits(tree, jc, jh2))

    # port: page-write prefill and fused decode on its own int4 cache
    kv = llama.init_kv_cache(tc, num_slots, dtype=torch.float32, device="cpu",
                             kv_quant="int4", page_size=PAGE)
    t_pre, t_dec = port_prefill_then_decode(params, tc, kv, toks, t, pages)
    assert kv.k[0].shape == (num_slots, tc.num_kv_heads * tc.head_dim // 2)
    np.testing.assert_allclose(t_pre, j_pre, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t_dec, j_dec, rtol=2e-4, atol=2e-4)
    # the prefill's codes and scales as JAX wrote them (the chunk's own
    # positions; the rest of its pages is trash by contract), up to one
    # code where the two frameworks' f32 projections straddle a rounding
    # edge, and the scales (amax / 7 of those projections) up to f32
    # noise: rtol 1e-6 in layer 0, whose rows come from the embeddings
    # alone, as for int8; deeper layers' rows also carry layer 0's
    # attention and MLP computed in another summation order, measured up
    # to 1.6e-6 relative with identical codes, so 4e-6 there
    live = torch.from_numpy(slots(t)).long()
    kh = tc.num_kv_heads
    for l in range(tc.num_layers):
        for mine, theirs in ((kv.k[l], kv_from_jax.k[l]), (kv.v[l], kv_from_jax.v[l])):
            diff = quant.unpack_int4_kv(mine[live], kh).int() - quant.unpack_int4_kv(
                theirs[live], kh).int()
            assert diff.abs().max() <= 1
        for mine, theirs in ((kv.ks[l], kv_from_jax.ks[l]), (kv.vs[l], kv_from_jax.vs[l])):
            np.testing.assert_allclose(quant.gather_kv_scales(mine, live).numpy(),
                                       quant.gather_kv_scales(theirs, live).numpy(),
                                       rtol=1e-6 if l == 0 else 4e-6)

    # port decode from JAX's own prefill cache: the same step on the same state
    _, t_dec2 = port_prefill_then_decode(params, tc, kv_from_jax, toks, t, pages, prefill=False)
    np.testing.assert_allclose(t_dec2, j_dec, rtol=2e-4, atol=2e-4)


async def test_int4_greedy_matches_jax_engine_on_trained_checkpoint():
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext
    from tests.test_torch_engine import CKPT

    tok = _tokenizer()
    ids = tok.encode("The capital of France is")
    n = 16
    lm = LocalModel.prepare(CKPT)
    jeng = JaxEngine(JaxConfig(
        model=lm.model_cfg, checkpoint_dir=CKPT, dtype="float32",
        attn_backend="gather", kv_quantization="int4", **ENGINE_KW,
    ))
    want = await _greedy(
        jeng, ids, n, JaxContext, jcommon.PreprocessedRequest,
        jcommon.StopConditions, jcommon.SamplingOptions,
    )
    await jeng.close()

    eng = _port_engine(kv_quantization="int4", kv_quant_group=32)  # head_dim: served
    assert eng.kv.int4 and eng.kv.k[0].shape[1] == 2 * 32 // 2
    got = await _greedy(eng, ids, n)
    await eng.close()
    assert got == want
    assert tok.decode(got).strip().startswith("paris"), tok.decode(got)


def test_kv_quant_group_ignored_unless_int4():
    # as in the JAX package: the group size is an int4 setting only
    from dynamo_tpu.engine import EngineConfig as JaxConfig

    JaxConfig(model="tiny", kv_quantization="int8", kv_quant_group=3)
    cfg = EngineConfig(model="tiny", kv_quantization="int8", kv_quant_group=3)
    assert cfg.kv_quantization == "int8"
    EngineConfig(model="tiny", kv_quant_group=3)
