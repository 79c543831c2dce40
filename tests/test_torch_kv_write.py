"""Port K1 (dynamo_tpu_torch.ops.kv_write) against the JAX page-scatter
kernel, run in interpret mode. The write is a pure copy, so the pools must
agree byte for byte; the port's pools are updated in place."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas_kv_write import paged_kv_write as jax_paged_kv_write
from dynamo_tpu_torch.ops.kv_write import paged_kv_write

PAGE = 16


@pytest.mark.parametrize(
    "num_pages,kw,table",
    [
        (8, 32, [3, 1, 6]),            # non-contiguous destination pages
        (10, 64, [0, 5, 2, 0, 9]),     # padding pages land in trash page 0
        (6, 32, [5, 4, 3, 2, 1]),      # reversed order, every page
    ],
)
def test_matches_jax_byte_exact(num_pages, kw, table):
    rng = np.random.RandomState(len(table))
    k = rng.randn(num_pages * PAGE, kw).astype(np.float32)
    v = rng.randn(num_pages * PAGE, kw).astype(np.float32)
    tbl = np.asarray(table, np.int32)
    nk = rng.randn(len(table), PAGE, kw).astype(np.float32)
    nv = rng.randn(len(table), PAGE, kw).astype(np.float32)

    jk, jv = jax_paged_kv_write(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(nk), jnp.asarray(nv), page_size=PAGE, interpret=True,
    )
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    k_ptr = tk.data_ptr()
    rk, rv = paged_kv_write(
        tk, tv, torch.from_numpy(tbl), torch.from_numpy(nk),
        torch.from_numpy(nv), page_size=PAGE,
    )
    # in place: the returned pools are the caller's tensors
    assert rk is tk and rv is tv and tk.data_ptr() == k_ptr
    assert tk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()


def test_bf16_byte_exact():
    rng = np.random.RandomState(7)
    num_pages, kw, tbl = 6, 32, np.asarray([2, 4], np.int32)
    k = rng.randn(num_pages * PAGE, kw).astype(np.float32)
    nk = rng.randn(2, PAGE, kw).astype(np.float32)
    jk, _ = jax_paged_kv_write(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(tbl), jnp.asarray(nk, jnp.bfloat16),
        jnp.asarray(nk, jnp.bfloat16), page_size=PAGE, interpret=True,
    )
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = tk.clone()
    src = torch.from_numpy(nk).to(torch.bfloat16)
    paged_kv_write(tk, tv, torch.from_numpy(tbl), src, src.clone(), page_size=PAGE)
    assert tk.view(torch.int16).numpy().tobytes() == np.asarray(jk).view(np.int16).tobytes()
