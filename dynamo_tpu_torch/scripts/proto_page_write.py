"""K8: the page-scatter write prototype, on the GPU.

Port of the JAX package's `scripts/proto_page_write.py`
(`pallas_page_write`): bf16 source pages [n, PAGE, KW] are copied into two
slot pools [NUM_PAGES * PAGE, KW] at table ids, in place. The CUDA kernel
is `page_copy_kernel` in `csrc/probes.cu`; `page_copy_plain` is its plain
PyTorch version. Page 0 is the trash page and is never written: an id of 0
or outside the pool is skipped. Ids are distinct.

    python -m dynamo_tpu_torch.scripts.proto_page_write

checks the kernel against its plain version on copies of the pools, then
times L chained writes at the probe's shapes against two `index_copy_`
calls and against K1 (`ops/kv_write.py`) writing the same full pages.
"""

from __future__ import annotations

import sys

import torch

from dynamo_tpu_torch.ops import _cuda
from dynamo_tpu_torch.scripts import gpu_or_none, probes_lib, time_ms

PAGE = 64
KW = 512
N = 64
T = 512
W = 10
NUM_PAGES = N * W + 17
NUM_SLOTS = NUM_PAGES * PAGE
L = 16


def page_copy_plain(k_cache, v_cache, tables, new_k, new_v):
    """Plain PyTorch version of K8: index assignment through the
    [pages, page, KW] view of each pool, ids 0 and outside the pool
    skipped."""
    page_copy_plain.calls += 1
    n, page, kw = new_k.shape
    kp, vp = k_cache.view(-1, page, kw), v_cache.view(-1, page, kw)
    ids = tables.long()
    keep = (ids > 0) & (ids < kp.shape[0])
    kp[ids[keep]] = new_k[keep]
    vp[ids[keep]] = new_v[keep]
    return k_cache, v_cache


page_copy_plain.calls = 0


def page_copy(k_cache, v_cache, tables, new_k, new_v):
    """Copy `new_k[i]`/`new_v[i]` ([page, KW]) into page `tables[i]` of the
    slot pools `k_cache`/`v_cache` [num_pages * page, KW], in place; returns
    the pools. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if k_cache.device.type == "cpu":
        return page_copy_plain(k_cache, v_cache, tables, new_k, new_v)
    req = _cuda.require
    req(k_cache.device.type == "cuda", f"unsupported device {k_cache.device}")
    n, page, kw = new_k.shape
    num_slots = k_cache.shape[0]
    req(k_cache.dim() == 2 and k_cache.shape[1] == kw, f"pools must be [slots, {kw}]")
    req(num_slots % page == 0, "pool rows must be whole pages")
    req(v_cache.shape == k_cache.shape and new_v.shape == new_k.shape,
        "k and v pools or pages differ in shape")
    req(tables.shape == (n,) and tables.dtype == torch.int32, f"tables must be int32 [{n}]")
    for t in (k_cache, v_cache, new_k, new_v, tables):
        req(t.device == k_cache.device, "all tensors must be on one device")
        req(t.is_contiguous(), "tensors must be contiguous")
    for t in (v_cache, new_k, new_v):
        req(t.dtype == k_cache.dtype, "pools and pages differ in dtype")
    page_bytes = page * kw * k_cache.element_size()
    req(page_bytes % 16 == 0, "page bytes must be a multiple of 16")
    for t in (k_cache, v_cache, new_k, new_v):
        req(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    err = probes_lib().page_copy_launch(
        k_cache.data_ptr(), v_cache.data_ptr(), tables.data_ptr(), new_k.data_ptr(),
        new_v.data_ptr(), n, num_slots // page, page_bytes, _cuda.stream_ptr(k_cache.device),
    )
    _cuda.check(err, "page_copy")
    page_copy.launches += 1
    return k_cache, v_cache


page_copy.launches = 0


def probe_tables(device) -> torch.Tensor:
    """The probe's ids: N sequences of T // PAGE full pages, each sequence's
    pages at 1 + i * W onward (distinct, page 0 never named)."""
    n_full = T // PAGE
    ids = [1 + i * W + j for i in range(N) for j in range(n_full)]
    return torch.tensor(ids, dtype=torch.int32, device=device)


def run(dev) -> dict:
    from dynamo_tpu_torch.ops.kv_write import paged_kv_write

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kc = torch.randn((NUM_SLOTS, KW), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((NUM_SLOTS, KW), generator=gen, device=dev).to(torch.bfloat16)
    tables = probe_tables(dev)
    n = tables.numel()
    src_k = torch.randn((n, PAGE, KW), generator=gen, device=dev).to(torch.bfloat16)
    src_v = torch.randn((n, PAGE, KW), generator=gen, device=dev).to(torch.bfloat16)

    # correctness, on copies of the pools
    k1, v1 = page_copy(kc.clone(), vc.clone(), tables, src_k, src_v)
    k2, v2 = page_copy_plain(kc.clone(), vc.clone(), tables, src_k, src_v)
    torch.cuda.synchronize()
    same = (torch.equal(k1.view(torch.int16), k2.view(torch.int16))
            and torch.equal(v1.view(torch.int16), v2.view(torch.int16)))
    if not same:
        raise AssertionError("page_copy: pools differ from the plain version")
    print("correctness ok (byte-exact against the plain version)", flush=True)

    # speed: L chained writes of the same pages
    kp, vp = k1.view(NUM_PAGES, -1), v1.view(NUM_PAGES, -1)
    idx = tables.long()
    fk, fv = src_k.view(n, -1), src_v.view(n, -1)

    def chain(write):
        return lambda: [write() for _ in range(L)]

    def index_copy():
        kp.index_copy_(0, idx, fk)
        vp.index_copy_(0, idx, fv)

    ms = time_ms(chain(lambda: page_copy(k1, v1, tables, src_k, src_v))) / L
    lib_ms = time_ms(chain(index_copy)) / L
    k1_ms = time_ms(chain(lambda: paged_kv_write(
        k1, v1, tables, src_k, src_v, page_size=PAGE))) / L
    written = 2 * n * PAGE * KW * 2
    for what, t in (("page_copy (K8)", ms), ("index_copy_ x2", lib_ms),
                    ("paged_kv_write (K1)", k1_ms)):
        print(f"{what}: {t:.4f} ms/layer for {n} pages of [{PAGE}, {KW}] bf16 into "
              f"{NUM_PAGES} (x2 pools): {written / t / 1e6:.0f} GB/s written, "
              f"{2 * written / t / 1e6:.0f} GB/s moved", flush=True)
    return {"ms": ms, "index_copy_ms": lib_ms, "kv_write_ms": k1_ms, "bytes_written": written}


def main() -> int:
    dev = gpu_or_none("proto_page_write")
    if dev is None:
        return 2
    run(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
