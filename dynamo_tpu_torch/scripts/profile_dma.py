"""K10: how fast the GPU streams scattered pages, over page sizes and ring
depths.

Port of the JAX package's `scripts/profile_dma.py` (`make_bench`; the same
kernel is `bench_dma` in `scripts/probe_bitcast.py`): `n_pages` pages
[page, kw] named by a table are streamed from device memory through an
`nbuf`-deep ring, and the result is the [1, 1] f32 sum over the pages of
sum(row 0) * 0.0: 0.0, or NaN when a named page's row 0 holds a NaN or an
infinity. The CUDA kernel is `page_gather_kernel` in `csrc/probes.cu`;
`page_gather_plain` is its plain PyTorch version. The rate it reaches is
the floor under the paged decode reads (K3/K5, K4).

    python -m dynamo_tpu_torch.scripts.profile_dma

sweeps page in {16, 64, 128, 256} x nbuf in {2, 4, 8, 16} over bf16 pages
of kw 512, 64 MB streamed each, with the L2 cache evicted before each
timed call.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dynamo_tpu_torch.ops import _cuda
from dynamo_tpu_torch.scripts import gpu_or_none, probes_lib, time_ms

NBUFS = (2, 4, 8, 16)
# the sweep's pool and stream sizes, as in the JAX script
MIN_PAGES = 4096
STREAM_BYTES = 64 << 20
_DTYPES = {torch.int8: 0, torch.int32: 1, torch.bfloat16: 2}


def page_gather_plain(pool, tables):
    """Plain PyTorch version of K10: row 0 of each named page, summed in
    f32 per page, times 0.0, summed over the pages."""
    page_gather_plain.calls += 1
    rows = pool[tables.long(), 0].float()
    return (rows.sum(dim=-1) * 0.0).sum().reshape(1, 1)


page_gather_plain.calls = 0


def page_gather(pool, tables, nbuf=8):
    """Stream pages `tables` [n] int32 of `pool` [num_pages, page, kw]
    (int8, int32 or bf16) through an `nbuf`-deep ring; returns the [1, 1]
    f32 of `page_gather_plain`. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if pool.device.type == "cpu":
        return page_gather_plain(pool, tables)
    req = _cuda.require
    req(pool.device.type == "cuda", f"unsupported device {pool.device}")
    req(pool.dim() == 3, "pool must be [num_pages, page, kw]")
    req(pool.dtype in _DTYPES, f"pool dtype must be one of {sorted(map(str, _DTYPES))}")
    req(tables.dim() == 1 and tables.dtype == torch.int32, "tables must be int32 [n]")
    req(nbuf in NBUFS, f"nbuf must be one of {NBUFS}")
    for t in (pool, tables):
        req(t.device == pool.device and t.is_contiguous(), "tensors must be contiguous, one device")
    page_bytes = pool[0].numel() * pool.element_size()
    req(page_bytes % 16 == 0 and pool.data_ptr() % 16 == 0,
        "page bytes and the pool's address must be multiples of 16")
    out = torch.zeros((1, 1), dtype=torch.float32, device=pool.device)
    sms = torch.cuda.get_device_properties(pool.device).multi_processor_count
    err = probes_lib().page_gather_launch(
        pool.data_ptr(), tables.data_ptr(), tables.numel(), page_bytes,
        pool.shape[2] * pool.element_size(), _DTYPES[pool.dtype], nbuf, sms,
        out.data_ptr(), _cuda.stream_ptr(pool.device),
    )
    _cuda.check(err, "page_gather")
    page_gather.launches += 1
    return out


page_gather.launches = 0


def l2_flush(dev):
    """A callable that reads 128 MB, more than the H100's 50 MB L2, so the
    L2 holds clean lines of another buffer (a write would leave dirty lines
    that the timed reads then pay to write back)."""
    buf = torch.zeros(32 << 20, dtype=torch.float32, device=dev)
    return lambda: buf.sum()


def run(dev) -> list:
    kw = 512
    rng = np.random.RandomState(0)
    flush = l2_flush(dev)
    rows = []
    for page in (16, 64, 128, 256):
        page_bytes = page * kw * 2
        total_pages = max((1 << 24) // page_bytes, MIN_PAGES)
        pool = torch.zeros((total_pages, page, kw), dtype=torch.bfloat16, device=dev)
        n_pages = min(total_pages, STREAM_BYTES // page_bytes)
        for nbuf in (2, 4, 8, 16):
            tables = torch.from_numpy(
                rng.permutation(total_pages)[:n_pages].astype(np.int32)).to(dev)
            out = page_gather(pool, tables, nbuf)
            if out.item() != 0.0:
                raise AssertionError(f"page_gather on a zero pool returned {out.item()}")
            t = time_ms(lambda: page_gather(pool, tables, nbuf), flush=flush)
            data = n_pages * page_bytes
            print(f"page={page:4d} ({page_bytes // 1024:4d}KB) nbuf={nbuf:3d}: "
                  f"{t:7.4f} ms for {data >> 20} MB -> {data / t / 1e6:7.1f} GB/s", flush=True)
            rows.append({"page": page, "nbuf": nbuf, "ms": t, "bytes": data})
        del pool
    return rows


def main() -> int:
    dev = gpu_or_none("profile_dma")
    if dev is None:
        return 2
    run(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
