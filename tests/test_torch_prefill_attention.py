"""Port K2's plain version (dynamo_tpu_torch.ops.prefill_attention) against
the JAX flash prefill kernel in interpret mode, in float32, at the
tolerance the reference holds its own kernel to (2e-4)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas_prefill import flash_prefill_attention as jax_flash
from dynamo_tpu_torch.ops.prefill_attention import flash_prefill_attention
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

PAGE = 16


@pytest.mark.parametrize(
    "b,t,h,kh,w,pos0,tlen",
    [
        (2, 32, 4, 4, 4, [0, 0], [32, 32]),     # G=1, full chunks from 0
        (2, 32, 4, 2, 5, [32, 16], [32, 20]),   # G=2, continuation chunks
        (3, 32, 8, 2, 6, [0, 40, 7], [30, 17, 1]),  # G=4, ragged, mid-page pos0
    ],
)
def test_matches_jax_kernel(b, t, h, kh, w, pos0, tlen):
    hd = 16
    rng = np.random.RandomState(b * 100 + t)
    num_pages = b * w + 2
    k = rng.randn(num_pages * PAGE, kh * hd).astype(np.float32)
    v = rng.randn(num_pages * PAGE, kh * hd).astype(np.float32)
    q = rng.randn(b, t, h, hd).astype(np.float32)
    tables = np.stack(
        [rng.permutation(num_pages - 1)[:w] + 1 for _ in range(b)]
    ).astype(np.int32)
    pos0 = np.asarray(pos0, np.int32)
    tlen = np.asarray(tlen, np.int32)

    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(pos0), jnp.asarray(tlen), page_size=PAGE, t_tile=16,
        interpret=True,
    ))
    got = flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(pos0), torch.from_numpy(tlen),
        page_size=PAGE,
    ).numpy()
    assert got.shape == (b, t, h, hd)
    for i in range(b):
        n = int(tlen[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=2e-4, atol=2e-4)
        assert np.all(got[i, n:] == 0.0)
        assert np.all(want[i, n:] == 0.0)


# ------------------------------------------------- the CUDA kernel's arithmetic

# The kernel (csrc/prefill_attention.cu) runs only on a GPU. What it
# computes is pinned here in torch, on the CPU: 64-key blocks with an online
# softmax in log2 units; bf16 q times bf16 K rows (or int8/int4 codes) summed
# in f32, then times hd**-0.5 * log2(e) (times the key's K scale); the
# probabilities (times the V scale) split into two bf16 terms, hi and lo,
# each multiplied by the V rows (or codes) in f32. It must stay within the
# card's check (one bf16 ulp of the element plus 2**-16, chip_smoke.py) of
# the plain version, and the same arithmetic with the probabilities rounded
# once to bf16 must not.

KEYS = 64
LOG2E = 1.4426950408889634
NEG = -0.7 * torch.finfo(torch.float32).max


def emulate_kernel(q, k_cache, v_cache, tables, pos0, t_valid, k_scales=None, v_scales=None,
                   *, page_size, int4=False, split=True):
    from dynamo_tpu_torch.ops.attention import slots_from_pages
    from dynamo_tpu_torch.ops.quant import gather_kv_scales, unpack_int4_kv

    b, t, h, hd = q.shape
    flat = slots_from_pages(tables, page_size).long()  # [B, C]
    c = flat.shape[1]
    if k_scales is None:
        kh = k_cache.shape[1] // hd
        kc, vc = k_cache[flat].float(), v_cache[flat].float()
        ks = vs = torch.ones((b, c, kh))
    else:
        kh = k_scales.shape[1]

        def codes(x):
            return (unpack_int4_kv(x, kh) if int4 else x).float()

        kc, vc = codes(k_cache[flat]), codes(v_cache[flat])
        ks, vs = (gather_kv_scales(x, flat.reshape(-1)).reshape(b, c, kh)
                  for x in (k_scales, v_scales))
    kc, vc = kc.reshape(b, c, kh, hd), vc.reshape(b, c, kh, hd)
    g = h // kh
    qf = q.to(torch.bfloat16).float().reshape(b, t, kh, g, hd).permute(0, 2, 3, 1, 4)
    sc = torch.tensor(hd ** -0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    post = 1.0 if k_scales is not None else sc
    q_pos = pos0.long()[:, None] + torch.arange(t)[None]  # [B, T]
    m = torch.full((b, kh, g, t), NEG)
    l = torch.zeros((b, kh, g, t))
    acc = torch.zeros((b, kh, g, t, hd))
    for k0 in range(0, c, KEYS):
        s = torch.einsum("bkgtd,bnkd->bkgtn", qf, kc[:, k0:k0 + KEYS])
        if k_scales is not None:
            s = s * (sc * ks[:, k0:k0 + KEYS].transpose(1, 2))[:, :, None, None, :]
        k_pos = torch.arange(k0, min(k0 + KEYS, c))
        late = (k_pos[None, None, :] > q_pos[:, :, None])[:, None, None]  # [B, 1, 1, T, n]
        s = torch.where(late, torch.full_like(s, NEG), s)
        m_new = torch.maximum(m, s.amax(-1) * post)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * post - m_new[..., None])
        l = l * alpha + p.sum(-1)
        x = p * vs[:, k0:k0 + KEYS].transpose(1, 2)[:, :, None, None, :]
        hi = x.to(torch.bfloat16).float()
        terms = (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)
        pv = sum(torch.einsum("bkgtn,bnkd->bkgtd", y, vc[:, k0:k0 + KEYS]) for y in terms)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc * (1.0 / l.clamp(min=1e-30))[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)
    out = torch.where((torch.arange(t)[None] < t_valid.long()[:, None])[..., None, None], out, 0.0)
    return out.to(torch.bfloat16)


def misses_card_check(got, want):
    """Elements outside one bf16 ulp (of the larger of the two) plus 2**-16,
    chip_smoke.py's check of the kernel against its plain version."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(((g - w).abs() > ulp + 2.0 ** -16).sum())


def _bf16_rows(rng, n, width):
    return torch.from_numpy(rng.randn(n, width).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("rows", ["chunk", "ragged"])
def test_kernel_arithmetic_within_card_check(fmt, rows):
    """H 8, K 2, Hd 128: a 128-query chunk from position 64, or one ragged
    rectangle (q_lens 1, 5 and 0; pos0 mid-page)."""
    from dynamo_tpu_torch.ops import decode_attention as d
    from dynamo_tpu_torch.ops import prefill_attention as p
    from dynamo_tpu_torch.ops.quant import quantize_kv_rows, quantize_kv_rows_int4

    h, kh, hd, w = 8, 2, 128, 13
    if rows == "chunk":
        pos0, tlen, t = [64], [128], 128
    else:
        pos0, tlen, t = [37, 70, 0], [1, 5, 0], 8
    b = len(pos0)
    rng = np.random.RandomState(7 + len(fmt) + t)
    num_pages = b * w + 2
    tables = torch.from_numpy(np.stack(
        [rng.permutation(num_pages - 1)[:w] + 1 for _ in range(b)]).astype(np.int32))
    q = torch.from_numpy(rng.randn(b, t, h, hd).astype(np.float32)).to(torch.bfloat16)
    k, v = (_bf16_rows(rng, num_pages * PAGE, kh * hd) for _ in range(2))
    p0, tl = torch.tensor(pos0, dtype=torch.int32), torch.tensor(tlen, dtype=torch.int32)
    scales, int4 = (), fmt == "int4"
    if fmt != "bf16":
        quantize = quantize_kv_rows_int4 if int4 else quantize_kv_rows
        (k, ks), (v, vs) = quantize(k, kh), quantize(v, kh)
        scales = tuple(x.reshape(num_pages, PAGE, kh).transpose(1, 2).contiguous()
                       for x in (ks, vs))
    if rows == "chunk":
        want = p.flash_prefill_attention(q, k, v, tables, p0, tl, *scales, page_size=PAGE,
                                         int4=int4)
    else:
        want = d.ragged_paged_attention(q, k, v, tables, p0, tl, *scales, page_size=PAGE,
                                        int4=int4)
    got = emulate_kernel(q, k, v, tables, p0, tl, *scales, page_size=PAGE, int4=int4)
    valid = torch.arange(t)[None] < tl[:, None]
    assert torch.all(got[~valid] == 0) and torch.all(want[~valid] == 0)
    assert misses_card_check(got[valid], want[valid]) == 0
    once = emulate_kernel(q, k, v, tables, p0, tl, *scales, page_size=PAGE, int4=int4,
                          split=False)
    assert misses_card_check(once[valid], want[valid]) > 0
