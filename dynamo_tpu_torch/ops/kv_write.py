"""K1 and K7: page-scatter KV write, the prefill-side cache update.

Port of `dynamo_tpu/ops/pallas_kv_write.py::paged_kv_write`: K1 is the
bf16 branch (`_kernel`), K7 the quantized branch (`_kernel_q`) in its int8
and int4 forms; the CUDA kernels are in `csrc/kv_write.cu`. For each page
i of a prefill chunk the source block `new_k[i]`/`new_v[i]` ([page_size,
row width]) is copied into pool page `page_table[i]`, in place. With scale
pools (int8 or int4 KV) the page's scale tiles `new_ks[i]`/`new_vs[i]`
([K, page_size] f32, ops/quant.py layout) ride the same page-table
routing. int4 rows are nibble-packed, K*Hd/2 bytes; the copy is the same,
but the wrapper takes `int4=True` so the launch is counted as K7's int4
form. With scale groups finer than head_dim (`groups` > 1 per kv head) a
page's scale tiles are [S, page_size], S = K * groups: the grouped int4
form, the same copy of wider tiles, counted apart. Page 0 is the trash
page.

The kernel copies a flat list of work items (chunks of the source pages
and of their scale tiles) in 16-byte vectors, or, for scale tiles that are
not whole 16-byte vectors (K * page_size not a multiple of 4, e.g. K 2 at
page 3), in 4-byte words: such tiles sit at 4-byte offsets in their pools;
`copy_plan` sizes the items and the grid on the host from the shapes and
the SM count, and `plan_items` lists the items as the kernel decodes them
(the CPU tests walk that list).

Correct-use contract (the engine's chunking guarantees both):
- chunk starts are page-aligned (prefill_chunk % page_size == 0);
- rows past the chunk tail inside a page may be garbage: they belong to
  the same sequence's not-yet-computed positions (masked out of
  attention) or to the trash page.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple

import torch

from dynamo_tpu_torch.ops import _cuda

# the kernel's largest chunk (csrc/kv_write.cu kMaxChunk: one round of four
# 16-byte vectors for each of 256 threads), the largest scale-tile chunk
# copied in 4-byte words (one round of four words a thread), and its
# resident blocks an SM
MAX_CHUNK = 16384
MAX_WORD_CHUNK = 4096
BLOCKS_PER_SM = 8


class CopyPlan(NamedTuple):
    """K1/K7's work: page items of at most `chunk` bytes (a multiple of
    16), `page_chunks` for each source page of each pool, and `tile_chunks`
    scale-tile items of at most `tile_chunk` bytes for each scale tile,
    copied in `tile_vec`-byte vectors (16, or 4 for a tile that is not whole
    16-byte vectors); walked by `grid` blocks."""

    n_pages: int
    page_bytes: int
    tile_bytes: int
    chunk: int
    page_chunks: int
    tile_chunk: int
    tile_chunks: int
    tile_vec: int
    grid: int

    @property
    def n_items(self) -> int:
        return 2 * self.n_pages * (self.page_chunks + self.tile_chunks)


@functools.lru_cache(maxsize=256)
def copy_plan(n_pages: int, page_bytes: int, tile_bytes: int, sm_count: int) -> CopyPlan:
    """The kernel's plan for `n_pages` source pages of `page_bytes` a pool
    (and scale tiles of `tile_bytes`, 0 without) on a card of `sm_count`
    SMs: a page in the fewest equal chunks of at most MAX_CHUNK, a scale
    tile in chunks of the same size, and one block an item up to
    BLOCKS_PER_SM blocks an SM (past that, blocks take several). A scale
    tile that is not whole 16-byte vectors goes in 4-byte words, in chunks
    of at most MAX_WORD_CHUNK. From the shapes alone, never the table, so
    it costs no sync."""
    page_chunks = -(-page_bytes // MAX_CHUNK)
    chunk = -(-page_bytes // (16 * page_chunks)) * 16  # a multiple of 16 bytes
    tile_vec = 16 if tile_bytes % 16 == 0 else 4
    tile_chunk = chunk if tile_vec == 16 else min(MAX_WORD_CHUNK, tile_bytes)
    tile_chunks = -(-tile_bytes // tile_chunk) if tile_bytes else 0
    n_items = 2 * n_pages * (page_chunks + tile_chunks)
    grid = max(1, min(n_items, BLOCKS_PER_SM * sm_count))
    return CopyPlan(n_pages, page_bytes, tile_bytes, chunk, page_chunks, tile_chunk,
                    tile_chunks, tile_vec, grid)


class Item(NamedTuple):
    """One work item: `nbytes` at byte `offset` of source page `i`'s rows
    (`scale` False) or scale tile (`scale` True) in pool `pool` (0 k, 1 v),
    copied to the same offset of pool page `page_table[i]`."""

    scale: bool
    pool: int
    i: int
    offset: int
    nbytes: int


def plan_items(plan: CopyPlan) -> Iterator[Item]:
    """The plan's items in their flat order, decoded as the kernel decodes
    them (csrc/kv_write.cu `item_of`); block b takes items b, b + grid, ..."""
    per_pair = plan.page_chunks + plan.tile_chunks
    for it in range(plan.n_items):
        pair, c = divmod(it, per_pair)
        scale = c >= plan.page_chunks
        whole = plan.tile_bytes if scale else plan.page_bytes
        size = plan.tile_chunk if scale else plan.chunk
        off = (c - plan.page_chunks if scale else c) * size
        yield Item(scale, pair & 1, pair >> 1, off, min(size, whole - off))


def paged_kv_write_plain(k_cache, v_cache, page_table, new_k, new_v, *, page_size):
    """Plain PyTorch version of K1: whole-page copies through the free
    [num_pages, page_size, K*Hd] view of each pool, in page-table order
    (a page listed twice, e.g. trash page 0, keeps the last write)."""
    paged_kv_write_plain.calls += 1
    _copy_pages(k_cache, v_cache, page_table, new_k, new_v, page_size)
    return k_cache, v_cache


paged_kv_write_plain.calls = 0


def paged_kv_write_q_plain(k_cache, v_cache, page_table, new_k, new_v,
                           ks_cache, vs_cache, new_ks, new_vs, *, page_size):
    """Plain PyTorch version of K7 (int8): K1's page copies plus the scale
    tiles, page by page in the same order."""
    paged_kv_write_q_plain.calls += 1
    return _copy_q_pages(k_cache, v_cache, page_table, new_k, new_v,
                         ks_cache, vs_cache, new_ks, new_vs, page_size)


paged_kv_write_q_plain.calls = 0


def paged_kv_write_q4_plain(k_cache, v_cache, page_table, new_k, new_v,
                            ks_cache, vs_cache, new_ks, new_vs, *, page_size):
    """Plain PyTorch version of K7's int4 form: the same copies of packed
    rows [page_size, K*Hd/2] and scale tiles."""
    paged_kv_write_q4_plain.calls += 1
    return _copy_q_pages(k_cache, v_cache, page_table, new_k, new_v,
                         ks_cache, vs_cache, new_ks, new_vs, page_size)


paged_kv_write_q4_plain.calls = 0


def paged_kv_write_q4g_plain(k_cache, v_cache, page_table, new_k, new_v,
                             ks_cache, vs_cache, new_ks, new_vs, *, page_size):
    """Plain PyTorch version of K7's grouped int4 form: the same copies,
    with scale tiles of S = K * groups channels."""
    paged_kv_write_q4g_plain.calls += 1
    return _copy_q_pages(k_cache, v_cache, page_table, new_k, new_v,
                         ks_cache, vs_cache, new_ks, new_vs, page_size)


paged_kv_write_q4g_plain.calls = 0


def _copy_q_pages(k_cache, v_cache, page_table, new_k, new_v,
                  ks_cache, vs_cache, new_ks, new_vs, page_size):
    _copy_pages(k_cache, v_cache, page_table, new_k, new_v, page_size)
    for i, page in enumerate(page_table.tolist()):
        ks_cache[page] = new_ks[i]
        vs_cache[page] = new_vs[i]
    return k_cache, v_cache, ks_cache, vs_cache


def _copy_pages(k_cache, v_cache, page_table, new_k, new_v, page_size):
    kp = k_cache.view(-1, page_size, k_cache.shape[1])
    vp = v_cache.view(-1, page_size, v_cache.shape[1])
    for i, page in enumerate(page_table.tolist()):
        kp[page] = new_k[i]
        vp[page] = new_v[i]


def paged_kv_write(k_cache, v_cache, page_table, new_k, new_v,
                   ks_cache=None, vs_cache=None, new_ks=None, new_vs=None, *,
                   page_size, int4=False, groups=1):
    """Scatter whole pages into the slot pools [num_slots, row width], in
    place. `page_table` [n_pages] int32 destination page ids,
    `new_k`/`new_v` [n_pages, page_size, row width] source blocks. With
    scale pools `ks_cache`/`vs_cache` [num_pages, K, page_size] f32 the
    pools are int8 (rows K*Hd wide, or K*Hd/2 nibble-packed with
    `int4=True`) and `new_ks`/`new_vs` [n_pages, K, page_size] are the
    pages' scale tiles ([n_pages, K * groups, page_size] with int4 scale
    groups finer than head_dim, `groups` > 1). Returns the (same) pools:
    (k, v), or (k, v, ks, vs) with scales. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    quant = ks_cache is not None
    grouped = groups > 1
    _cuda.require(quant or not int4, "int4 KV needs scale pools")
    _cuda.require(int4 or not grouped, "scale groups finer than head_dim are int4's")
    if k_cache.device.type == "cpu":
        if quant:
            plain = (paged_kv_write_q4g_plain if grouped else
                     paged_kv_write_q4_plain if int4 else paged_kv_write_q_plain)
            return plain(
                k_cache, v_cache, page_table, new_k, new_v, ks_cache, vs_cache,
                new_ks, new_vs, page_size=page_size,
            )
        return paged_kv_write_plain(
            k_cache, v_cache, page_table, new_k, new_v, page_size=page_size
        )
    req = _cuda.require
    req(k_cache.device.type == "cuda", f"unsupported device {k_cache.device}")
    dev = k_cache.device
    num_slots, kw = k_cache.shape
    n = page_table.shape[0]
    num_pages = num_slots // page_size
    req(num_slots % page_size == 0, "pool rows must be whole pages")
    req(v_cache.shape == k_cache.shape, "k/v pools differ in shape")
    req(new_k.shape == (n, page_size, kw) and new_v.shape == new_k.shape,
        f"source pages must be [{n}, {page_size}, {kw}], got {tuple(new_k.shape)}")
    tensors = [k_cache, v_cache, new_k, new_v, page_table]
    for t in (v_cache, new_k, new_v):
        req(t.dtype == k_cache.dtype, "pools and source pages differ in dtype")
    if quant:
        req(k_cache.dtype == torch.int8, "pools with scale pools must be int8")
        for t in (vs_cache, new_ks, new_vs):
            req(t is not None, "quantized KV needs both scale pools and both scale tiles")
        kh = ks_cache.shape[1]  # scale channels: K, or K * groups
        req(kh % groups == 0 and kw % (kh // groups) == 0,
            "pool row width must be whole kv heads, scale channels whole groups")
        req(ks_cache.shape == (num_pages, kh, page_size) and vs_cache.shape == ks_cache.shape,
            f"scale pools must be [{num_pages}, S, {page_size}]")
        req(new_ks.shape == (n, kh, page_size) and new_vs.shape == new_ks.shape,
            f"scale tiles must be [{n}, {kh}, {page_size}]")
        for t in (ks_cache, vs_cache, new_ks, new_vs):
            req(t.dtype == torch.float32, "scale pools and tiles must be float32")
        tensors += [ks_cache, vs_cache, new_ks, new_vs]
    else:
        req(k_cache.dtype in (torch.bfloat16, torch.float16, torch.float32),
            f"unsupported pool dtype {k_cache.dtype}")
    for t in tensors:
        req(t.device == dev, "all tensors must be on one device")
        req(t.is_contiguous(), "tensors must be contiguous")
    req(page_table.dtype == torch.int32, "page_table must be int32")
    page_bytes = page_size * kw * k_cache.element_size()
    req(page_bytes % 16 == 0, "page bytes must be a multiple of 16")
    for t in tensors[:4] + tensors[5:]:
        req(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    plan = copy_plan(n, page_bytes, kh * page_size * 4 if quant else 0, _cuda.sm_count(dev))
    lib = _launcher()
    stream = _cuda.stream_ptr(dev)
    if quant:
        launch = (lib.paged_kv_write_q4g_launch if grouped else
                  lib.paged_kv_write_q4_launch if int4 else lib.paged_kv_write_q_launch)
        err = launch(
            k_cache.data_ptr(), v_cache.data_ptr(), page_table.data_ptr(),
            new_k.data_ptr(), new_v.data_ptr(), ks_cache.data_ptr(),
            vs_cache.data_ptr(), new_ks.data_ptr(), new_vs.data_ptr(),
            n, num_pages, page_bytes, kh * page_size, stream, plan.chunk,
            plan.tile_chunk, plan.grid,
        )
        _cuda.check(err, f"paged_kv_write ({'int4' if int4 else 'int8'}"
                         f"{f', {groups} groups' if grouped else ''})")
        if grouped:
            paged_kv_write.launches_q4g += 1
        elif int4:
            paged_kv_write.launches_q4 += 1
        else:
            paged_kv_write.launches_q += 1
        return k_cache, v_cache, ks_cache, vs_cache
    err = lib.paged_kv_write_launch(
        k_cache.data_ptr(), v_cache.data_ptr(), page_table.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), n, num_pages, page_bytes, stream,
        plan.chunk, plan.grid,
    )
    _cuda.check(err, "paged_kv_write")
    paged_kv_write.launches += 1
    return k_cache, v_cache


paged_kv_write.launches = 0    # K1 (bf16 pools)
paged_kv_write.launches_q = 0  # K7 (int8 pools + scale tiles)
paged_kv_write.launches_q4 = 0  # K7, int4 form (nibble-packed pools + scale tiles)
paged_kv_write.launches_q4g = 0  # K7, grouped int4 (scale tiles of K * groups channels)


def _launcher():
    lib = _cuda.load("kv_write")
    fn = lib.paged_kv_write_launch
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p] * 5 + [i64] * 3 + [p, i32, i32]  # stream, chunk, grid
        fn.restype = ctypes.c_int
        fq = lib.paged_kv_write_q_launch
        # stream, chunk, tile chunk, grid
        fq.argtypes = [p] * 9 + [i64] * 3 + [i32] + [p, i32, i32, i32]
        fq.restype = ctypes.c_int
        for f4 in (lib.paged_kv_write_q4_launch, lib.paged_kv_write_q4g_launch):
            f4.argtypes = fq.argtypes
            f4.restype = ctypes.c_int
    return lib
