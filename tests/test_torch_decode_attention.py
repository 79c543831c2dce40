"""Port K3's plain version (dynamo_tpu_torch.ops.decode_attention) against
the JAX fused decode kernel in interpret mode, in float32, at the
reference's own kernel tolerance (2e-5). The pools the port updates in
place must equal the pools the JAX kernel returns."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas_attention import (
    fused_paged_decode_attention as jax_fused,
    paged_decode_attention as jax_paged,
)
from dynamo_tpu_torch.ops.decode_attention import (
    fused_paged_decode_attention,
    paged_decode_attention,
)
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

PAGE = 16


def _setup(b, h, kh, hd, w, lengths, seed=0):
    rng = np.random.RandomState(seed)
    num_pages = b * w + 1
    k = rng.randn(num_pages * PAGE, kh * hd).astype(np.float32)
    v = rng.randn(num_pages * PAGE, kh * hd).astype(np.float32)
    q = rng.randn(b, h, hd).astype(np.float32)
    tables = np.zeros((b, w), np.int32)
    for i in range(b):
        used = -(-lengths[i] // PAGE)
        tables[i, :used] = 1 + i * w + np.arange(used)
    new_k = rng.randn(b, kh * hd).astype(np.float32)
    new_v = rng.randn(b, kh * hd).astype(np.float32)
    return q, k, v, tables, np.asarray(lengths, np.int32), new_k, new_v


@pytest.mark.parametrize(
    "b,h,kh,hd,w,wpos",
    [
        (4, 8, 2, 32, 8, [37, 47, -1, 64]),   # mid-page, page end, idle row, new page
        (2, 4, 4, 32, 4, [0, 50]),            # first token; G=1
        (3, 16, 2, 64, 6, [5, -1, 90]),       # G=8, idle row in the middle
    ],
)
def test_fused_matches_jax_kernel(b, h, kh, hd, w, wpos):
    wpos = np.asarray(wpos, np.int32)
    lengths = np.where(wpos >= 0, wpos + 1, 0).astype(np.int32)
    q, k, v, tables, lens, nk, nv = _setup(b, h, kh, hd, w, lengths.tolist())

    want, jk, jv = jax_fused(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(wpos), page_size=PAGE, pages_per_block=4, interpret=True,
    )
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got, rk, rv = fused_paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv), tk, tv,
        torch.from_numpy(tables), torch.from_numpy(lens), torch.from_numpy(wpos),
        page_size=PAGE,
    )
    assert rk is tk and rv is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    active = lens > 0
    np.testing.assert_allclose(
        got.numpy()[active], np.asarray(want)[active], rtol=2e-5, atol=2e-5
    )
    assert np.all(got.numpy()[~active] == 0.0)
    assert np.all(np.asarray(want)[~active] == 0.0)


def test_read_only_matches_jax_kernel():
    q, k, v, tables, lens, _, _ = _setup(4, 8, 2, 32, 8, [100, 0, 128, 17])
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), page_size=PAGE, pages_per_block=4, interpret=True,
    )
    tk = torch.from_numpy(k.copy())
    got = paged_decode_attention(
        torch.from_numpy(q), tk, torch.from_numpy(v), torch.from_numpy(tables),
        torch.from_numpy(lens), page_size=PAGE,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(tk.numpy(), k)  # nothing written


# ------------------------------------------------- the CUDA kernel's split

def test_split_plan_covers_every_key_once():
    """The wrapper's plan at the engine's widths (W 10 and 32 at page 64,
    W 5 at page 128; B 1 and 8; K 8 on 132 SMs): splits are whole multiples
    of 128 keys, the last one reaches past the table's last key and none
    starts past it, so every key position lies in exactly one split."""
    from dynamo_tpu_torch.ops.decode_attention import BLOCKS_PER_SM, SPLIT_KEYS, split_plan

    want = {  # (b, w, page) -> (chunk, splits)
        (8, 10, 64): (128, 5), (8, 32, 64): (128, 16), (8, 5, 128): (128, 5),
        (1, 10, 64): (128, 5), (1, 32, 64): (128, 16), (1, 5, 128): (128, 5),
    }
    for (b, w, page), plan in want.items():
        chunk, splits = split_plan(b, 8, w, page, 132)
        assert (chunk, splits) == plan
        span = w * page
        assert chunk % SPLIT_KEYS == 0 and splits >= 1
        assert (splits - 1) * chunk < span <= splits * chunk
        owner = torch.arange(span) // chunk
        assert torch.equal(torch.bincount(owner, minlength=splits).sum(), torch.tensor(span))
        assert int(owner.max()) == splits - 1 and int(owner.min()) == 0
        assert b * 8 * splits <= BLOCKS_PER_SM * 132
    # a small card doubles the chunk until the grid fits
    chunk, splits = split_plan(8, 8, 32, 64, 8)
    assert (chunk, splits) == (1024, 2) and 8 * 8 * splits <= BLOCKS_PER_SM * 8


# The kernel (csrc/decode_attention.cu) runs only on a GPU. What it computes
# is pinned here in torch, on the CPU, at the 8B shape (H 32, K 8, Hd 128,
# page 64): each row's keys split by `split_plan`; inside a split, 16-key
# tiles dealt to four warps in turn, each warp an online softmax in log2
# units (q scaled and rounded to bf16, f32 dot products with the bf16 rows
# or the int8/int4 codes, times the K scale; p times the V scale into an
# f32 P.V); the warps merged in order (a warp without keys contributing
# (-0.7 * f32 max, 0, 0)), then the splits in order, eight at a time, splits
# past the length contributing the same; the new row taken from the
# new-row input ("registers") and never from the pool, which the emulation
# reads unwritten. It must stay within the card's check (one bf16 ulp of the
# element plus 2**-16, chip_smoke.py) of the plain version.

LOG2E = 1.4426950408889634
NEG = -0.7 * torch.finfo(torch.float32).max


def emulate_split_kernel(q, new_k, new_v, k_cache, v_cache, tables, lengths, write_pos,
                         k_scales=None, v_scales=None, new_ks=None, new_vs=None, *,
                         page_size, chunk, int4=False):
    from dynamo_tpu_torch.ops.quant import gather_kv_scales, unpack_int4_kv

    b, h, hd = q.shape
    quant = k_scales is not None
    kh = k_scales.shape[1] if quant else k_cache.shape[1] // hd
    g, w = h // kh, tables.shape[1]
    splits = -(-w * page_size // chunk)
    span = splits * chunk
    pos = torch.arange(span)
    slot = (tables[:, (pos // page_size).clamp(max=w - 1)].long() * page_size
            + pos % page_size)  # [B, span]; positions past the table are masked

    def codes(x):
        return (unpack_int4_kv(x, kh) if int4 else x).float().reshape(*x.shape[:-1], kh, hd)

    k, v = codes(k_cache[slot]), codes(v_cache[slot])  # [B, span, K, Hd]
    if quant:
        ks, vs = (gather_kv_scales(x, slot.reshape(-1)).reshape(b, span, kh)
                  for x in (k_scales, v_scales))
    else:
        ks = vs = torch.ones((b, span, kh))
    length = lengths.long().clamp(max=w * page_size)
    for r in range(b):  # the new row, from the new-row input
        wp = int(write_pos[r])
        if 0 <= wp < int(length[r]):
            k[r, wp], v[r, wp] = codes(new_k[r:r + 1])[0], codes(new_v[r:r + 1])[0]
            if quant:
                ks[r, wp], vs[r, wp] = new_ks[r], new_vs[r]
    valid = pos[None] < length[:, None]  # [B, span]

    qs = (q.float() * hd ** -0.5).to(torch.bfloat16).float().reshape(b, kh, g, hd)
    s = torch.einsum("bkgd,bpkd->bkgp", qs, k) * (ks * LOG2E).transpose(1, 2)[:, :, None]
    tiles = chunk // 64  # a warp's tiles in a split
    shape = (b, kh, g, splits, tiles, 4, 16)  # position = split, tile i, warp, row
    s = s.reshape(shape)
    ok = valid[:, None, None].expand(b, kh, g, span).reshape(shape)
    s = torch.where(ok, s, torch.full_like(s, NEG))
    pv = vs.transpose(1, 2)[:, :, None].reshape(b, kh, 1, splits, tiles, 4, 16)
    vv = v.reshape(b, splits, tiles, 4, 16, kh, hd)
    m = torch.full((b, kh, g, splits, 4), NEG)
    l = torch.zeros((b, kh, g, splits, 4))
    o = torch.zeros((b, kh, g, splits, 4, hd))
    for i in range(tiles):
        si, oki = s[..., i, :, :], ok[..., i, :, :]
        mn = torch.maximum(m, si.amax(-1))
        al = torch.exp2(m - mn)
        p = torch.where(oki, torch.exp2(si - mn[..., None]), 0.0)
        l = l * al + p.sum(-1)
        o = o * al[..., None] + torch.einsum(
            "bkgswr,bswrkd->bkgswd", p * pv[..., i, :, :], vv[:, :, i])
        m = mn
    # the warps in order, under their common maximum
    mx = m.amax(4, keepdim=True)
    e = torch.exp2(m - mx)
    l, o, m = (l * e).sum(4), (o * e[..., None]).sum(4), mx.squeeze(4)
    # the splits in order, eight at a time, each batch rescaling the last
    mt, lt, ot = torch.full_like(m[..., 0], NEG), torch.zeros_like(l[..., 0]), 0.0
    for s0 in range(0, splits, 8):
        bm, bl, bo = m[..., s0:s0 + 8], l[..., s0:s0 + 8], o[..., s0:s0 + 8, :]
        nm = torch.maximum(mt, bm.amax(-1))
        r = torch.exp2(mt - nm)
        e = torch.exp2(bm - nm[..., None])
        lt = lt * r + (bl * e).sum(-1)
        ot = ot * r[..., None] + (bo * e[..., None]).sum(-2)
        mt = nm
    out = ot / lt.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(torch.bfloat16)


@pytest.mark.parametrize("sm_count", [132, 8])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_kernel_arithmetic_within_card_check(fmt, sm_count):
    """B 8 at the 8B shape, W 10 at page 64: lengths 1 (only the new row),
    0 (an idle row), 64, 65, 577, 128, 129 and 513 (the edges of 128- and
    512-key splits and one past them); write_pos 128 and 512 are each the
    first key of a split. The plan on 132 SMs takes 128-key splits (two
    tiles a warp), on 8 SMs two splits of 512 (eight tiles a warp, four
    times around its ring). The same arithmetic over the pool's stale row
    at write_pos must miss the check."""
    from dynamo_tpu_torch.ops.decode_attention import split_plan

    from dynamo_tpu_torch.ops import decode_attention as d
    from dynamo_tpu_torch.ops.quant import (
        quantize_kv_rows, quantize_kv_rows_int4, scales_to_page_tiles)
    from tests.test_torch_prefill_attention import misses_card_check

    b, h, kh, hd, page, w = 8, 32, 8, 128, 64, 10
    lengths = [1, 64, 65, 0, 577, 513, 129, 128]
    chunk = split_plan(b, kh, w, page, sm_count)[0]
    assert chunk == {132: 128, 8: 512}[sm_count]
    rng = np.random.RandomState(11 + len(fmt))
    num_pages = b * w + 2
    # disjoint pages: no row's write lands in another row's keys
    tables = torch.from_numpy(
        (rng.permutation(num_pages - 1)[:b * w] + 1).reshape(b, w).astype(np.int32))

    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)

    q = bf16(b, h, hd)
    k, v = bf16(num_pages * page, kh * hd), bf16(num_pages * page, kh * hd)
    nk, nv = bf16(b, kh * hd), bf16(b, kh * hd)
    lens = torch.tensor(lengths, dtype=torch.int32)
    wpos = torch.tensor([n - 1 if n else -1 for n in lengths], dtype=torch.int32)
    pools, rows, int4 = (k, v), (nk, nv), fmt == "int4"
    if fmt != "bf16":
        quantize = quantize_kv_rows_int4 if int4 else quantize_kv_rows
        (k, ks), (v, vs) = quantize(k, kh), quantize(v, kh)
        (nk, nks), (nv, nvs) = quantize(nk, kh), quantize(nv, kh)
        pools = (k, v, scales_to_page_tiles(ks, page), scales_to_page_tiles(vs, page))
        rows = (nk, nv, nks, nvs)

    def plain():
        mine = [x.clone() for x in pools]
        if fmt == "bf16":
            return d.fused_paged_decode_attention_plain(
                q, nk, nv, *mine, tables, lens, wpos, page_size=page)[0]
        fn = (d.fused_paged_decode_attention_q4_plain if int4
              else d.fused_paged_decode_attention_q_plain)
        return fn(q, nk, nv, mine[0], mine[1], tables, lens, wpos, *mine[2:], *rows[2:],
                  page_size=page)[0]

    def emulate(write_pos):
        return emulate_split_kernel(
            q, rows[0], rows[1], pools[0], pools[1], tables, lens, write_pos, *pools[2:],
            *rows[2:], page_size=page, chunk=chunk, int4=int4)

    want, got = plain(), emulate(wpos)
    idle = lens == 0
    assert torch.all(got[idle] == 0) and not torch.isnan(got.float()).any()
    assert misses_card_check(got, want) == 0
    # without the new row (the stale pool row read at write_pos)
    assert misses_card_check(emulate(torch.full_like(wpos, -1)), want) > 0
