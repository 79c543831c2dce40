"""K1: page-scatter KV write, the prefill-side cache update.

Port of `dynamo_tpu/ops/pallas_kv_write.py::paged_kv_write` (bf16 branch);
the CUDA kernel is `csrc/kv_write.cu`. For each page i of a prefill chunk
the source block `new_k[i]`/`new_v[i]` ([page_size, K*Hd]) is copied into
pool page `page_table[i]`, in place. Page 0 is the trash page.

Correct-use contract (the engine's chunking guarantees both):
- chunk starts are page-aligned (prefill_chunk % page_size == 0);
- rows past the chunk tail inside a page may be garbage: they belong to
  the same sequence's not-yet-computed positions (masked out of
  attention) or to the trash page.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _cuda


def paged_kv_write_plain(k_cache, v_cache, page_table, new_k, new_v, *, page_size):
    """Plain PyTorch version: whole-page copies through the free
    [num_pages, page_size, K*Hd] view of each pool, in page-table order
    (a page listed twice, e.g. trash page 0, keeps the last write)."""
    paged_kv_write_plain.calls += 1
    kp = k_cache.view(-1, page_size, k_cache.shape[1])
    vp = v_cache.view(-1, page_size, v_cache.shape[1])
    for i, page in enumerate(page_table.tolist()):
        kp[page] = new_k[i]
        vp[page] = new_v[i]
    return k_cache, v_cache


paged_kv_write_plain.calls = 0


def paged_kv_write(k_cache, v_cache, page_table, new_k, new_v, *, page_size):
    """Scatter whole pages into the slot pools [num_slots, K*Hd], in place;
    returns the (same) pools. `page_table` [n_pages] int32 destination page
    ids, `new_k`/`new_v` [n_pages, page_size, K*Hd] source blocks. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if k_cache.device.type == "cpu":
        return paged_kv_write_plain(
            k_cache, v_cache, page_table, new_k, new_v, page_size=page_size
        )
    req = _cuda.require
    req(k_cache.device.type == "cuda", f"unsupported device {k_cache.device}")
    dev = k_cache.device
    num_slots, kw = k_cache.shape
    n = page_table.shape[0]
    req(num_slots % page_size == 0, "pool rows must be whole pages")
    req(v_cache.shape == k_cache.shape, "k/v pools differ in shape")
    req(new_k.shape == (n, page_size, kw) and new_v.shape == new_k.shape,
        f"source pages must be [{n}, {page_size}, {kw}], got {tuple(new_k.shape)}")
    for t in (k_cache, v_cache, new_k, new_v, page_table):
        req(t.device == dev, "all tensors must be on one device")
        req(t.is_contiguous(), "tensors must be contiguous")
    for t in (v_cache, new_k, new_v):
        req(t.dtype == k_cache.dtype, "pools and source pages differ in dtype")
    req(k_cache.dtype in (torch.bfloat16, torch.float16, torch.float32),
        f"unsupported pool dtype {k_cache.dtype}")
    req(page_table.dtype == torch.int32, "page_table must be int32")
    page_bytes = page_size * kw * k_cache.element_size()
    req(page_bytes % 16 == 0, "page bytes must be a multiple of 16")
    for t in (k_cache, v_cache, new_k, new_v):
        req(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    lib = _launcher()
    err = lib.paged_kv_write_launch(
        k_cache.data_ptr(), v_cache.data_ptr(), page_table.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(),
        n, num_slots // page_size, page_bytes, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "paged_kv_write")
    paged_kv_write.launches += 1
    return k_cache, v_cache


paged_kv_write.launches = 0


def _launcher():
    lib = _cuda.load("kv_write")
    fn = lib.paged_kv_write_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
