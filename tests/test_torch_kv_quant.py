"""int8 KV on the port against the JAX package, in float32 on the CPU.

Quantized rows and scales must be byte-equal to `dynamo_tpu.ops.quant`;
K7's plain version (int8 page write) byte-equal to the JAX kernel in
interpret mode, scales included; K5's (fused int8 decode) and K6's (int8
flash prefill) plain versions within the tolerances the bf16 parity tests
use (2e-5 and 2e-4), the pools and scale pools byte-equal after K5's
write; the int8 model within the model tolerance (2e-4) of the JAX
forward; and TorchEngine's greedy stream on the trained checkpoint equal
to JaxEngine's, both with int8 KV.

Scale pools: the port's [num_pages, K, page_size] is the JAX
[num_pages, SUBL, page_size] pool without its padding rows,
`jax_pool[:, _scale_rows(K, 1), :]`.
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
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.ops.decode_attention import (
    fused_paged_decode_attention,
    paged_decode_attention,
)
from dynamo_tpu_torch.ops.kv_write import paged_kv_write
from dynamo_tpu_torch.ops.prefill_attention import flash_prefill_attention
from tests.test_torch_engine import ENGINE_KW, _greedy, _port_engine, _tokenizer
from tests.test_torch_model import (
    PAGE,
    VARIANTS,
    _configs,
    _jax_tree,
    port_prefill_then_decode,
)
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)


def jax_scales(pool: np.ndarray) -> jnp.ndarray:
    """Port scale pool [P, K, S] -> the JAX pool layout [P, SUBL, S]."""
    p, kh, s = pool.shape
    out = np.ones((p, jquant.kv_scale_subl(kh), s), np.float32)
    out[:, np.asarray(jquant._scale_rows(kh, 1)), :] = pool
    return jnp.asarray(out)


def kv_cache_from_jax(jkv, num_kv_heads: int) -> llama.KVCache:
    """A JAX int8 KVCache (int8 pools + [P, SUBL, S] scale pools) in the
    port's layout, so both sides can step from the same cache."""
    rows = np.asarray(jquant._scale_rows(num_kv_heads, 1))

    def pools(xs):
        return tuple(torch.from_numpy(np.array(x)) for x in xs)

    def scales(xs):
        return tuple(torch.from_numpy(np.array(x)[:, rows, :]) for x in xs)

    return llama.KVCache(k=pools(jkv.k), v=pools(jkv.v), ks=scales(jkv.ks), vs=scales(jkv.vs))


def _int8_pools(rng, num_pages, kh, hd):
    """Random int8 pools and positive scale pools in the port's layout."""
    n = num_pages * PAGE
    k = rng.randint(-127, 128, size=(n, kh * hd)).astype(np.int8)
    v = rng.randint(-127, 128, size=(n, kh * hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, size=(num_pages, kh, PAGE)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, size=(num_pages, kh, PAGE)).astype(np.float32)
    return k, v, ks, vs


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------ quant.py


def test_quantize_kv_rows_byte_equal():
    rng = np.random.RandomState(0)
    kh, hd = 4, 32
    rows = (rng.randn(9, kh * hd) * rng.uniform(0.01, 20.0, size=(9, 1))).astype(np.float32)
    rows[2, hd:2 * hd] = 0.0            # an all-zero head: scale 1.0, codes 0
    rows[5] = 0.0                       # an all-zero row
    # exact .5 ties: amax 127 makes the scale 1.0, so x / scale is x;
    # round half to even sends 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 126.5 -> 126
    tie = np.zeros(hd, np.float32)
    tie[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    rows[7, :hd] = tie
    rows[8] = np.tile(tie[::-1], kh)
    jq, js = jquant.quantize_kv_rows(jnp.asarray(rows), kh)
    tq, ts = quant.quantize_kv_rows(torch.from_numpy(rows), kh)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert list(tq[7, :6]) == [127, 2, -4, 0, 0, 126]
    assert torch.all(ts[5] == 1.0) and ts[2, 1] == 1.0
    back = quant.dequantize_kv_rows(tq, ts)
    assert back.numpy().tobytes() == np.asarray(jquant.dequantize_kv_rows(jq, js)).tobytes()
    # bf16 rows quantize through f32 on both sides
    jb, jbs = jquant.quantize_kv_rows(jnp.asarray(rows, jnp.bfloat16), kh)
    tb, tbs = quant.quantize_kv_rows(torch.from_numpy(rows).to(torch.bfloat16), kh)
    assert tb.numpy().tobytes() == np.asarray(jb).tobytes()
    assert tbs.numpy().tobytes() == np.asarray(jbs).tobytes()


def test_scale_pool_helpers_match_jax():
    rng = np.random.RandomState(1)
    num_pages, kh = 6, 3
    dense = rng.uniform(0.01, 1.0, size=(10, kh)).astype(np.float32)
    slots = np.asarray([17, 3, 40, 95, 16, 50, 33, 64, 81, 2], np.int32)
    jpool = jquant.scatter_kv_scales(
        jquant.init_kv_scale_pool(num_pages, PAGE, kh), jnp.asarray(slots),
        jnp.asarray(dense), kh,
    )
    tpool = quant.init_kv_scale_pool(num_pages, PAGE, kh, device="cpu")
    quant.scatter_kv_scales(tpool, torch.from_numpy(slots), torch.from_numpy(dense))
    assert np.array_equal(np.asarray(jax_scales(tpool.numpy())), np.asarray(jpool))
    got = quant.gather_kv_scales(tpool, torch.from_numpy(slots[::-1].copy()))
    want = jquant.gather_kv_scales(jpool, jnp.asarray(slots[::-1].copy()), kh)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    tiles = rng.uniform(0.01, 1.0, size=(2 * PAGE, kh)).astype(np.float32)
    jt = jquant.scales_to_page_tiles(jnp.asarray(tiles), PAGE, kh)
    tt = quant.scales_to_page_tiles(torch.from_numpy(tiles), PAGE)
    assert np.array_equal(np.asarray(jax_scales(tt.numpy())), np.asarray(jt))


# ------------------------------------------------------------ K7


@pytest.mark.parametrize(
    "num_pages,kh,table",
    [
        (8, 2, [3, 1, 6]),             # non-contiguous destination pages
        (10, 4, [0, 5, 2, 0, 9]),      # padding pages land in trash page 0
    ],
)
def test_kv_write_int8_byte_equal(num_pages, kh, table):
    rng = np.random.RandomState(len(table))
    hd = 16
    k, v, ks, vs = _int8_pools(rng, num_pages, kh, hd)
    n = len(table)
    nk, nv, nks, nvs = _int8_pools(rng, n, kh, hd)
    nk, nv = nk.reshape(n, PAGE, kh * hd), nv.reshape(n, PAGE, kh * hd)
    tbl = np.asarray(table, np.int32)
    jk, jv, jks, jvs = jax_kv_write(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl), jnp.asarray(nk), jnp.asarray(nv),
        jax_scales(ks), jax_scales(vs), jax_scales(nks), jax_scales(nvs),
        page_size=PAGE, interpret=True,
    )
    tk, tv, tks, tvs = _t(k, v, ks, vs)
    out = paged_kv_write(tk, tv, torch.from_numpy(tbl), *_t(nk, nv), tks, tvs,
                         *_t(nks, nvs), page_size=PAGE)
    assert all(a is b for a, b in zip(out, (tk, tv, tks, tvs)))  # in place
    assert tk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert np.asarray(jax_scales(tks.numpy())).tobytes() == np.asarray(jks).tobytes()
    assert np.asarray(jax_scales(tvs.numpy())).tobytes() == np.asarray(jvs).tobytes()


# ------------------------------------------------------------ K5


def _decode_setup(b, h, kh, hd, w, lengths, seed=0):
    rng = np.random.RandomState(seed)
    num_pages = b * w + 1
    k, v, ks, vs = _int8_pools(rng, num_pages, kh, hd)
    q = rng.randn(b, h, hd).astype(np.float32)
    tables = np.zeros((b, w), np.int32)
    for i in range(b):
        tables[i, :-(-lengths[i] // PAGE)] = 1 + i * w + np.arange(-(-lengths[i] // PAGE))
    new_k, new_ks = quant.quantize_kv_rows(torch.from_numpy(rng.randn(b, kh * hd) * 2), kh)
    new_v, new_vs = quant.quantize_kv_rows(torch.from_numpy(rng.randn(b, kh * hd)), kh)
    return (q, k, v, ks, vs, tables, np.asarray(lengths, np.int32),
            new_k.numpy(), new_v.numpy(), new_ks.float().numpy(), new_vs.float().numpy())


@pytest.mark.parametrize(
    "b,h,kh,hd,w,wpos",
    [
        (4, 8, 2, 32, 8, [37, 47, -1, 64]),   # mid-page, page end, idle row, new page
        (2, 4, 4, 32, 4, [0, 50]),            # first token; G=1
        (3, 16, 2, 64, 6, [5, -1, 90]),       # G=8, idle row in the middle
    ],
)
def test_fused_decode_int8_matches_jax_kernel(b, h, kh, hd, w, wpos):
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
        page_size=PAGE, pages_per_block=4, interpret=True,
    )
    tk, tv, tks, tvs = _t(k, v, ks, vs)
    got, *pools = fused_paged_decode_attention(
        torch.from_numpy(q), *_t(nk, nv), tk, tv, *_t(tables, lens, wpos),
        tks, tvs, *_t(nks, nvs), page_size=PAGE,
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


def test_read_only_decode_int8_matches_jax_kernel():
    q, k, v, ks, vs, tables, lens, *_ = _decode_setup(4, 8, 2, 32, 8, [100, 0, 128, 17], 3)
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), jax_scales(ks), jax_scales(vs), page_size=PAGE,
        pages_per_block=4, interpret=True,
    )
    tk, tks = _t(k, ks)
    got = paged_decode_attention(
        torch.from_numpy(q), tk, torch.from_numpy(v), *_t(tables, lens), tks,
        torch.from_numpy(vs), page_size=PAGE,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert np.array_equal(tk.numpy(), k) and np.array_equal(tks.numpy(), ks)  # nothing written


# ------------------------------------------------------------ K6


@pytest.mark.parametrize(
    "b,t,h,kh,hd,w,pos0,tlen",
    [
        (2, 32, 4, 4, 16, 4, [0, 0], [32, 32]),        # G=1, full chunks from 0
        (3, 32, 8, 2, 32, 6, [0, 40, 7], [30, 17, 1]),  # G=4, ragged, mid-page pos0
    ],
)
def test_flash_prefill_int8_matches_jax_kernel(b, t, h, kh, hd, w, pos0, tlen):
    rng = np.random.RandomState(b * 100 + t)
    num_pages = b * w + 2
    k, v, ks, vs = _int8_pools(rng, num_pages, kh, hd)
    q = rng.randn(b, t, h, hd).astype(np.float32)
    tables = np.stack(
        [rng.permutation(num_pages - 1)[:w] + 1 for _ in range(b)]
    ).astype(np.int32)
    pos0 = np.asarray(pos0, np.int32)
    tlen = np.asarray(tlen, np.int32)
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(pos0), jnp.asarray(tlen), jax_scales(ks), jax_scales(vs),
        page_size=PAGE, t_tile=16, interpret=True,
    ))
    got = flash_prefill_attention(
        *_t(q, k, v, tables, pos0, tlen, ks, vs), page_size=PAGE,
    ).numpy()
    for i in range(b):
        n = int(tlen[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=2e-4, atol=2e-4)
        assert np.all(got[i, n:] == 0.0)


# ------------------------------------------------------------ model, engine


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_int8_prefill_then_decode_matches_jax(variant):
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

    # JAX: gather-oracle prefill of t tokens into an int8 cache, then one
    # decode step
    jkv = jllama.init_kv_cache(jc, num_slots, kv_quant="int8", page_size=PAGE)
    smat = jnp.asarray(slots(3 * PAGE)[None])
    jh, jkv = jllama.forward(
        tree, jc, jnp.asarray(toks[:, :t]), jnp.arange(t)[None], jkv,
        jnp.asarray(slots(t)), smat,
    )
    j_pre = np.asarray(jllama.logits(tree, jc, jh))
    kv_from_jax = kv_cache_from_jax(jkv, jc.num_kv_heads)
    jh2, _ = jllama.forward(
        tree, jc, jnp.asarray(toks[:, t:]), jnp.asarray([[t]]), jkv,
        jnp.asarray(slots(t + 1)[t:]), smat,
    )
    j_dec = np.asarray(jllama.logits(tree, jc, jh2))

    # port: page-write prefill and fused decode on its own int8 cache
    kv = llama.init_kv_cache(tc, num_slots, dtype=torch.float32, device="cpu",
                             kv_quant="int8", page_size=PAGE)
    t_pre, t_dec = port_prefill_then_decode(params, tc, kv, toks, t, pages)
    assert kv.k[0].dtype == torch.int8 and kv.ks[0].shape == (8, tc.num_kv_heads, PAGE)
    np.testing.assert_allclose(t_pre, j_pre, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t_dec, j_dec, rtol=2e-4, atol=2e-4)
    # the prefill's rows and scales as JAX wrote them (the chunk's own
    # positions; the rest of its pages is trash by contract), up to the
    # last bit of a scale and one code where the two frameworks' f32
    # projections straddle a rounding edge
    live = torch.from_numpy(slots(t)).long()
    for l in range(tc.num_layers):
        for mine, theirs in ((kv.k[l], kv_from_jax.k[l]), (kv.v[l], kv_from_jax.v[l])):
            assert (mine[live].int() - theirs[live].int()).abs().max() <= 1
        for mine, theirs in ((kv.ks[l], kv_from_jax.ks[l]), (kv.vs[l], kv_from_jax.vs[l])):
            np.testing.assert_allclose(quant.gather_kv_scales(mine, live).numpy(),
                                       quant.gather_kv_scales(theirs, live).numpy(), rtol=1e-6)

    # port decode from JAX's own prefill cache: the same step on the same state
    _, t_dec2 = port_prefill_then_decode(params, tc, kv_from_jax, toks, t, pages, prefill=False)
    np.testing.assert_allclose(t_dec2, j_dec, rtol=2e-4, atol=2e-4)


async def test_int8_greedy_matches_jax_engine_on_trained_checkpoint():
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
        attn_backend="gather", kv_quantization="int8", **ENGINE_KW,
    ))
    want = await _greedy(
        jeng, ids, n, JaxContext, jcommon.PreprocessedRequest,
        jcommon.StopConditions, jcommon.SamplingOptions,
    )
    await jeng.close()

    eng = _port_engine(kv_quantization="int8")
    assert eng.kv.quantized and eng.kv.k[0].dtype == torch.int8
    got = await _greedy(eng, ids, n)
    await eng.close()
    assert got == want
    assert tok.decode(got).strip().startswith("paris"), tok.decode(got)


async def test_int8_greedy_matches_jax_engine_at_odd_page_size():
    """int8 KV at page size 3 (K 2: a scale tile of 24 bytes, not whole
    16-byte vectors, which K7 copies in 4-byte words on the card): the
    port's greedy stream equals JaxEngine's on the trained checkpoint."""
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext
    from tests.test_torch_engine import CKPT

    odd = dict(ENGINE_KW, page_size=3, prefill_chunk=48)
    ids = _tokenizer().encode("the capital of germany is berlin . the capital of france is")
    n = 12
    jeng = JaxEngine(JaxConfig(
        model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT, dtype="float32",
        attn_backend="gather", kv_quantization="int8", **odd,
    ))
    want = await _greedy(
        jeng, ids, n, JaxContext, jcommon.PreprocessedRequest,
        jcommon.StopConditions, jcommon.SamplingOptions,
    )
    await jeng.close()
    eng = _port_engine(kv_quantization="int8", page_size=3, prefill_chunk=48)
    assert eng.kv.ks[0].shape[1:] == (2, 3)
    got = await _greedy(eng, ids, n)
    await eng.close()
    assert got == want
