"""K9: the int32 <-> int8 bitcast of the packed KV pool layout, and the
page-streaming rate of int8, int32-packed and bf16 pages (K10), on the GPU.

Port of the JAX package's `scripts/probe_bitcast.py`. On the TPU the
packed layout (JAX `ops/quant.py` `pack_kv_slots`/`unpack_kv_slots`) holds
int8 rows in int32 words, H1: int32 row t holds int8 rows 4t..4t+3 as its
little-endian bytes. The three probes, each a CUDA kernel in
`csrc/probes.cu` with its plain PyTorch version here:

- `unpack_int8_rows` (`probe_forward`): int32 [T, C] -> int8 [4T, C];
- `pack_int8_rows` (`probe_reverse`): int8 [4T, C] -> int32 [T, C];
- `inject_int8_row` (`probe_roundtrip_inject`): one int8 row spliced into
  int8 row `off` of a packed [T/4, C] block by shift and mask, in place
  (the TPU kernel returned a new block).

    python -m dynamo_tpu_torch.scripts.probe_bitcast

runs the three probes with the H1/H2 report, then measures the
page-gather rate (K10, `profile_dma.page_gather`) for int8 [128, 1024],
int32 [32, 1024] and bf16 [64, 1024] pages (128 KB each), 8192 of 16384
pages, nbuf 8, and the int32-vs-int8 ratio.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dynamo_tpu_torch.ops import _cuda
from dynamo_tpu_torch.scripts import gpu_or_none, probes_lib, time_ms
from dynamo_tpu_torch.scripts.profile_dma import page_gather

# the page-gather rate: pages named of the pool's, as in the JAX script
TOTAL_PAGES = 16384
N_PAGES = 8192


def unpack_int8_rows_plain(packed):
    """Plain PyTorch version of the forward bitcast: int8 row 4t + j is
    byte j (bits 8j..8j+7) of int32 row t."""
    unpack_int8_rows_plain.calls += 1
    t, c = packed.shape
    lanes = [((packed >> (8 * j)) & 0xFF).to(torch.uint8) for j in range(4)]
    return torch.stack(lanes, dim=1).reshape(4 * t, c).view(torch.int8)


unpack_int8_rows_plain.calls = 0


def pack_int8_rows_plain(rows):
    """Plain PyTorch version of the reverse bitcast: int32 row t holds int8
    rows 4t..4t+3 as its bytes 0..3 (in int64, then wrapped to int32)."""
    pack_int8_rows_plain.calls += 1
    t4, c = rows.shape
    b = rows.view(torch.uint8).to(torch.int64).reshape(t4 // 4, 4, c)
    word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


pack_int8_rows_plain.calls = 0


def inject_int8_row_plain(packed, row, off):
    """Plain PyTorch version of the inject: byte lane off % 4 of packed row
    off // 4 replaced by `row` [C] int8, in place; returns `packed`."""
    inject_int8_row_plain.calls += 1
    shift = 8 * (off % 4)
    word = packed[off // 4].to(torch.int64) & 0xFFFFFFFF
    new = (word & ~(0xFF << shift)) | (row.view(torch.uint8).to(torch.int64) << shift)
    packed[off // 4] = torch.where(new >= 2 ** 31, new - 2 ** 32, new).to(torch.int32)
    return packed


inject_int8_row_plain.calls = 0


def _check_2d(t, dtype, what):
    req = _cuda.require
    req(t.device.type == "cuda", f"unsupported device {t.device}")
    req(t.dim() == 2 and t.dtype == dtype, f"{what} must be {dtype} [rows, C]")
    req(t.shape[1] % 4 == 0, f"{what}: C must be a multiple of 4")
    req(t.is_contiguous() and t.data_ptr() % 16 == 0, f"{what} must be contiguous, 16-byte aligned")


def unpack_int8_rows(packed):
    """int32 [T, C] -> int8 [4T, C] (H1). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if packed.device.type == "cpu":
        return unpack_int8_rows_plain(packed)
    _check_2d(packed, torch.int32, "packed")
    t, c = packed.shape
    rows = torch.empty((4 * t, c), dtype=torch.int8, device=packed.device)
    err = probes_lib().unpack_int8_rows_launch(
        packed.data_ptr(), rows.data_ptr(), t, c, _cuda.stream_ptr(packed.device))
    _cuda.check(err, "unpack_int8_rows")
    unpack_int8_rows.launches += 1
    return rows


unpack_int8_rows.launches = 0


def pack_int8_rows(rows):
    """int8 [4T, C] -> int32 [T, C] (H1), the inverse of
    `unpack_int8_rows`. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if rows.device.type == "cpu":
        return pack_int8_rows_plain(rows)
    _check_2d(rows, torch.int8, "rows")
    _cuda.require(rows.shape[0] % 4 == 0, "rows: a multiple of 4 rows")
    t4, c = rows.shape
    packed = torch.empty((t4 // 4, c), dtype=torch.int32, device=rows.device)
    err = probes_lib().pack_int8_rows_launch(
        rows.data_ptr(), packed.data_ptr(), t4 // 4, c, _cuda.stream_ptr(rows.device))
    _cuda.check(err, "pack_int8_rows")
    pack_int8_rows.launches += 1
    return packed


pack_int8_rows.launches = 0


def inject_int8_row(packed, row, off: int):
    """Splice `row` [C] int8 into int8 row `off` of the packed int32
    [T/4, C] block, in place; returns `packed`. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if packed.device.type == "cpu":
        return inject_int8_row_plain(packed, row, off)
    _check_2d(packed, torch.int32, "packed")
    req = _cuda.require
    req(0 <= off < 4 * packed.shape[0], f"off {off} outside the block's {4 * packed.shape[0]} rows")
    req(row.dtype == torch.int8 and row.numel() == packed.shape[1] and row.is_contiguous()
        and row.device == packed.device, f"row must be int8 [{packed.shape[1]}] on the block's device")
    err = probes_lib().inject_int8_row_launch(
        packed.data_ptr(), row.data_ptr(), packed.shape[1], off, _cuda.stream_ptr(packed.device))
    _cuda.check(err, "inject_int8_row")
    inject_int8_row.launches += 1
    return packed


inject_int8_row.launches = 0


def h1_pack(x8: np.ndarray) -> np.ndarray:
    """numpy H1: int32 row t packs int8 rows 4t..4t+3 little-endian."""
    t, c = x8.shape[0] // 4, x8.shape[1]
    h = x8.reshape(t, 4, c).astype(np.uint8).astype(np.uint32)
    return (h[:, 0] | (h[:, 1] << 8) | (h[:, 2] << 16) | (h[:, 3] << 24)).view(np.int32)


def h2_pack(x8: np.ndarray) -> np.ndarray:
    """numpy H2: int32 row t packs int8 rows t, T + t, 2T + t, 3T + t."""
    t, c = x8.shape[0] // 4, x8.shape[1]
    h = x8.reshape(4, t, c).astype(np.uint8).astype(np.uint32)
    return (h[0] | (h[1] << 8) | (h[2] << 16) | (h[3] << 24)).view(np.int32)


def probe_forward(dev) -> bool:
    t, c = 8, 128
    x8 = np.random.RandomState(0).randint(-127, 128, size=(4 * t, c)).astype(np.int8)
    ok = True
    for name, packed in (("H1-consecutive", h1_pack(x8)), ("H2-strided", h2_pack(x8))):
        y = unpack_int8_rows(torch.from_numpy(packed).to(dev)).cpu().numpy()
        match = np.array_equal(y, x8)
        print(f"forward {name}: match={match}", flush=True)
        if name.startswith("H1"):
            ok &= match
            continue
        # where H2's rows land: out row 4t + j is int8 row jT + t (H1 read
        # of an H2 pack), as on the TPU
        for r in range(8):
            src = np.where((x8 == y[r]).all(axis=1))[0]
            print(f"  out row {r} == in row(s) {src}", flush=True)
        ok &= all(np.array_equal(y[4 * i + j], x8[j * t + i]) for i in range(t) for j in range(4))
    return ok


def probe_reverse(dev) -> bool:
    t, c = 8, 128
    x8 = np.random.RandomState(1).randint(-127, 128, size=(4 * t, c)).astype(np.int8)
    y = pack_int8_rows(torch.from_numpy(x8).to(dev)).cpu().numpy()
    match = np.array_equal(y, h1_pack(x8))
    print(f"reverse bitcast: H1 match={match}", flush=True)
    return match


def probe_roundtrip_inject(dev) -> bool:
    t, c, off = 32, 128, 13  # int8 row 13 -> int32 row 3, byte 1
    rng = np.random.RandomState(2)
    x8 = rng.randint(-127, 128, size=(t, c)).astype(np.int8)
    new_row = rng.randint(-127, 128, size=(c,)).astype(np.int8)
    packed = torch.from_numpy(h1_pack(x8)).to(dev)
    inject_int8_row(packed, torch.from_numpy(new_row).to(dev), off)
    want = x8.copy()
    want[off] = new_row
    got = unpack_int8_rows_plain(packed.cpu()).numpy()
    match = np.array_equal(got, want)
    print(f"inject-in-int32-domain: match={match}", flush=True)
    return match


def bench_gather(dev, dtype, page, kw, nbuf=8) -> float:
    total_pages, n_pages = TOTAL_PAGES, N_PAGES
    pool = torch.zeros((total_pages, page, kw), dtype=dtype, device=dev)
    tables = torch.from_numpy(
        np.random.RandomState(0).permutation(total_pages)[:n_pages].astype(np.int32)).to(dev)
    out = page_gather(pool, tables, nbuf)
    if out.item() != 0.0:
        raise AssertionError(f"page_gather on a zero pool returned {out.item()}")
    t = time_ms(lambda: page_gather(pool, tables, nbuf))
    nbytes = n_pages * pool[0].numel() * pool.element_size()
    gbs = nbytes / t / 1e6
    print(f"page gather {str(dtype).replace('torch.', ''):8s} page=[{page},{kw}] "
          f"{nbytes / 1e6:.0f} MB in {t:.4f} ms -> {gbs:.0f} GB/s", flush=True)
    return gbs


def run(dev) -> dict:
    ok = probe_forward(dev) & probe_reverse(dev) & probe_roundtrip_inject(dev)
    if not ok:
        raise AssertionError("a bitcast probe disagrees with the H1 layout")
    # 8B-class dims: kw 1024, page 128 int8 -> packed [32, 1024] int32
    g8 = bench_gather(dev, torch.int8, 128, 1024)
    g32 = bench_gather(dev, torch.int32, 32, 1024)
    gbf = bench_gather(dev, torch.bfloat16, 64, 1024)  # the same 128 KB a page
    print(f"int32 vs int8 speedup: {g32 / g8:.3f}x ; bf16 ref {gbf:.0f} GB/s", flush=True)
    return {"int8_gbs": g8, "int32_gbs": g32, "bf16_gbs": gbf}


def main() -> int:
    dev = gpu_or_none("probe_bitcast")
    if dev is None:
        return 2
    run(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
