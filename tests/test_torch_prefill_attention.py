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
