"""Port K1 (dynamo_tpu_torch.ops.kv_write) against the JAX page-scatter
kernel, run in interpret mode. The write is a pure copy, so the pools must
agree byte for byte; the port's pools are updated in place. Then the CUDA
kernel's work plan (`copy_plan`, `plan_items`) at chip_smoke.py's shapes:
its items cover each byte once, and applying them gives the plain
version's bytes."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas_kv_write import paged_kv_write as jax_paged_kv_write
from dynamo_tpu_torch.ops import kv_write as m
from dynamo_tpu_torch.ops.kv_write import paged_kv_write
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

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


# The kernel's work plan (ops/kv_write.copy_plan), at the shapes chip_smoke.py
# launches it at: label -> (source pages, page rows, kv heads, head dim).
PLAN_SHAPES = {
    "8b-p64": (64, 64, 8, 128), "8b-p128": (32, 128, 8, 128),
    "small": (7, 16, 2, 32), "k1-hd32": (5, 16, 1, 32),
    # K 2 at page 3: a 24-byte scale tile, not whole 16-byte vectors, which
    # K7 copies in 4-byte words
    "odd-page3": (5, 3, 2, 32),
}
FORMATS = ("bf16", "int8", "int4")


def _plan_bytes(shape, fmt):
    """(n, page, kh, page bytes, scale tile bytes) of one pool."""
    n, page, kh, hd = shape
    row = {"bf16": kh * hd * 2, "int8": kh * hd, "int4": kh * hd // 2}[fmt]
    return n, page, kh, page * row, 0 if fmt == "bf16" else kh * page * 4


@pytest.mark.parametrize("sm", [1, 8, 132])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("label", list(PLAN_SHAPES))
def test_copy_plan_covers_every_byte_once(label, fmt, sm):
    n, _, _, page_bytes, tile_bytes = _plan_bytes(PLAN_SHAPES[label], fmt)
    plan = m.copy_plan(n, page_bytes, tile_bytes, sm)
    assert plan.chunk % 16 == 0 and 0 < plan.chunk <= m.MAX_CHUNK
    assert 1 <= plan.grid <= min(m.BLOCKS_PER_SM * sm, plan.n_items)
    # scale tiles go in 16-byte vectors when whole vectors, else in words
    assert plan.tile_vec == (16 if tile_bytes % 16 == 0 else 4)
    if plan.tile_vec == 4:
        assert plan.tile_chunk % 4 == 0 and 0 < plan.tile_chunk <= m.MAX_WORD_CHUNK
    spans = {}
    items = list(m.plan_items(plan))
    assert len(items) == plan.n_items
    for it in items:
        vec, size = (plan.tile_vec, plan.tile_chunk) if it.scale else (16, plan.chunk)
        assert it.offset % vec == 0 and it.nbytes % vec == 0 and 0 < it.nbytes <= size
        spans.setdefault((it.scale, it.pool, it.i), []).append((it.offset, it.nbytes))
    want_keys = {(False, p, i) for p in (0, 1) for i in range(n)}
    if tile_bytes:
        want_keys |= {(True, p, i) for p in (0, 1) for i in range(n)}
    assert set(spans) == want_keys
    for (scale, _, _), parts in spans.items():
        end = 0
        for off, nb in sorted(parts):  # back to back from 0: each byte exactly once
            assert off == end
            end += nb
        assert end == (tile_bytes if scale else page_bytes)


def _walk(plan, table, pools, srcs):
    """Apply the plan's items to CPU tensors as the kernel does: an item of
    source page i lands at pool page table[i] unless that id is outside
    the pool. `pools`/`srcs`: (k, v[, ks, vs]) as bytes [pages, bytes]."""
    num_pages = pools[0].shape[0]
    for it in m.plan_items(plan):
        page = int(table[it.i])
        if not 0 <= page < num_pages:
            continue
        dst, src = (pools[2 + it.pool], srcs[2 + it.pool]) if it.scale else (
            pools[it.pool], srcs[it.pool])
        dst[page, it.offset:it.offset + it.nbytes] = src[it.i, it.offset:it.offset + it.nbytes]


@pytest.mark.parametrize("sm", [1, 8, 132])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("label", list(PLAN_SHAPES))
def test_plan_walk_writes_what_plain_writes(label, fmt, sm):
    """The walk of the plan's items gives the plain version's bytes on a
    table that names page 0 twice (in item order the later source page wins
    there, as in the plain version), and, on a table with one id equal to
    num_pages, leaves every byte outside the other named pages as it was."""
    from dynamo_tpu_torch.ops import kv_write as m

    n, page, kh, page_bytes, tile_bytes = _plan_bytes(PLAN_SHAPES[label], fmt)
    num_pages = n + 3
    rng = np.random.RandomState(n * 131 + page_bytes + sm)
    kw = page_bytes // page // (2 if fmt == "bf16" else 1)
    dtype = torch.bfloat16 if fmt == "bf16" else torch.int8
    wide = 2 if fmt == "bf16" else 1

    def rand_bytes(*shape):
        return torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8))

    pools = [rand_bytes(num_pages * page, kw * wide).view(dtype) for _ in range(2)]
    srcs = [rand_bytes(n, page, kw * wide).view(dtype) for _ in range(2)]
    if tile_bytes:
        pools += [rand_bytes(num_pages, kh, page * 4).view(torch.float32) for _ in range(2)]
        srcs += [rand_bytes(n, kh, page * 4).view(torch.float32) for _ in range(2)]
    plan = m.copy_plan(n, page_bytes, tile_bytes, sm)

    def as_bytes(ts, rows):
        return [t.view(torch.uint8).view(rows, -1) for t in ts]

    table = torch.from_numpy(rng.permutation(num_pages - 1)[:n].astype(np.int32) + 1)
    table[0] = table[-1] = 0  # padding pages, both into the trash page
    mine = [t.clone() for t in pools]
    _walk(plan, table, as_bytes(mine[:2], num_pages) + as_bytes(mine[2:], num_pages),
          as_bytes(srcs[:2], n) + as_bytes(srcs[2:], n))
    want = [t.clone() for t in pools]
    if tile_bytes:
        plain = m.paged_kv_write_q4_plain if fmt == "int4" else m.paged_kv_write_q_plain
        plain(want[0], want[1], table, srcs[0], srcs[1], want[2], want[3], srcs[2], srcs[3],
              page_size=page)
    else:
        m.paged_kv_write_plain(want[0], want[1], table, srcs[0], srcs[1], page_size=page)
    for a, b in zip(mine, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    bad = table.clone()
    j = n // 2
    bad[j] = num_pages
    after = [t.clone() for t in pools]
    _walk(plan, bad, as_bytes(after[:2], num_pages) + as_bytes(after[2:], num_pages),
          as_bytes(srcs[:2], n) + as_bytes(srcs[2:], n))
    named = set(bad.tolist()) - {num_pages}
    for a, b in zip(as_bytes(after[:2], num_pages) + as_bytes(after[2:], num_pages),
                    as_bytes(pools[:2], num_pages) + as_bytes(pools[2:], num_pages)):
        for p in range(num_pages):
            if p not in named:
                assert torch.equal(a[p], b[p]), f"page {p}, not named, changed"
    # the named pages took their sources, as without the bad entry
    keep = [i for i in range(n) if i != j]
    for a, s in zip(as_bytes(after[:2], num_pages), as_bytes(srcs[:2], n)):
        for i in keep:
            if bad[i] != 0:
                assert torch.equal(a[int(bad[i])], s[i])
