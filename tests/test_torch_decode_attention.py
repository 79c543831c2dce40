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
