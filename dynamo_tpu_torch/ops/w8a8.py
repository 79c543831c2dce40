"""W8A8 kernels: per-token activation quantization and the int8 GEMM.

The two halves of the JAX package's `dynamo_tpu/ops/quant.py::quant_matmul`
(:60-77), which XLA compiles into fused ops (no `pl.pallas_call`); the CUDA
kernels are in `csrc/w8a8.cu`.

- `quantize_rows(x)`: x [M, K] bf16 or f32 -> (codes [M, K] int8, scales
  [M] f32), s = amax / 127 per row (1.0 for an all-zero row), codes
  clip(round(x / s), -127, 127) with the true division and round half to
  even, so they are byte-equal to the reference's.
- `rms_norm_quantize_rows(x, weight, eps, weight_offset, y=None)`: the
  codes and scales of `ops/norm.py` `rms_norm(x, ...)`, and
  `silu_mul_quantize_rows(gate, up, y=None)`: those of `F.silu(gate) * up`;
  one kernel each, the row's prologue fused ahead of its quantization (the
  model's W8A8 path, ops/quant.py). `y`, when given, receives the rows the
  kernel quantized. The norm's f32 sum of squares runs in the kernel's own
  order, so its y is within a bf16 ulp of `rms_norm`'s and its codes are
  `quantize_rows_plain(y)`.
- `quant_plan` splits a decode row across a thread block cluster where
  the kernel gains by it (SiLU x up) and gives a prefill row one block,
  from the shape alone.
- `w8a8_gemm(xq, xs, wq, ws, out_dtype)`: codes [M, K] x weight codes
  [N, K] (the port's K-contiguous [out, in] layout, ops/quant.py) -> [M, N]
  as (f32(acc) * xs[m]) * ws[n] rounded once to `out_dtype`; the dot is
  s8 x s8 -> s32, exact. `gemm_plan` picks the kernel's variant (wgmma
  block tiles fed by TMA: "tiles" for M > 64, "rows" and "rows_wide" for
  decode rows) and its split of K across blocks; a split launch merges its
  partials inside the launch, in scratch kept per device (`_cuda.scratch`).

Each wrapper runs its plain version on CPU tensors, launches its kernel on
CUDA tensors (counted in `<wrapper>.launches`) and raises for anything the
kernel does not take. The fused plain versions are the compositions they
replace (`rms_norm` or `F.silu(gate) * up`, then `quantize_rows_plain`), so
the CPU computes what it computed before the fusion; each counts its own
calls, and its quantization counts in `quantize_rows_plain.calls` too, as
the composition's did. The plain GEMM computes the dot as a float64 matmul
of the codes: every partial sum is an integer below 2**53, so it is exact
in any order, on the CPU and on the card (CUDA has no integer matmul).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops import _cuda
from dynamo_tpu_torch.ops.norm import rms_norm

# 127 * 127 * K must stay below 2**31 (the int32 accumulator)
MAX_K = 131072


# csrc/w8a8.cu's GEMM variants: id, consumer warpgroups (block rows 64 x
# that), block columns, ring stages, blocks resident on an SM
GEMM_VARIANTS = {
    "rows": (0, 1, 64, 6, 2),
    "rows_wide": (1, 1, 128, 4, 2),
    "tiles": (2, 2, 256, 4, 1),
}
# rows up to this take a "rows" variant (decode, verify and head rows)
ROWS_MAX = 64
# from this many columns on, decode rows take 128-column tiles ("rows_wide":
# w_gate/w_up and the head ran a few per cent faster so on the H100)
WIDE_N = 8192
K_TILE = 128  # bytes of K a ring stage holds


class GemmPlan(NamedTuple):
    variant: str
    variant_id: int
    bm: int  # block tile rows
    bn: int  # block tile columns
    k_tiles: int  # 128-byte k tiles of K
    per_split: int  # k tiles a split takes (the last may take fewer)
    splits: int  # blocks along K
    grid: tuple  # work items: (row tiles, column tiles, splits)
    blocks: int  # persistent blocks launched: the items, at most `resident` an SM
    workspace_bytes: int  # int32 partials [splits, M, N rounded up to 4]; 0 unsplit
    counters: int  # int32 tickets, one a block tile; 0 unsplit


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, n: int, k: int, sm_count: int) -> GemmPlan:
    """The GEMM's launch for [m, k] x [n, k]: its variant and its split of
    K. Decode rows (m <= ROWS_MAX) read the weights once and are bound by
    the memory rate: 64-column tiles (128 from WIDE_N columns on), split
    along K until one wave of blocks (`resident` an SM) holds the card, so
    the weight stream keeps every SM busy at any N. Prefill rows are bound
    by the tensor cores: K is split only when the block tiles would fill
    less than half the SMs, since each split writes and reads back an
    int32 tile. The kernel is persistent: `blocks` blocks walk the work
    items. Reads shapes only, so a graph replay launches what its capture
    planned; cached, since an eager prefill calls it 224 times."""
    variant = "tiles" if m > ROWS_MAX else "rows_wide" if n >= WIDE_N else "rows"
    vid, cons, bn, _stages, resident = GEMM_VARIANTS[variant]
    bm = 64 * cons
    tiles = -(-m // bm) * -(-n // bn)
    k_tiles = -(-k // K_TILE)
    if m <= ROWS_MAX:
        splits = max(1, min(k_tiles, resident * sm_count // tiles))
    elif 2 * tiles > sm_count:
        splits = 1
    else:
        splits = min(k_tiles, sm_count // tiles)
    per = -(-k_tiles // splits)
    splits = -(-k_tiles // per)
    ws = 4 * splits * m * (-(-n // 4) * 4) if splits > 1 else 0
    return GemmPlan(variant, vid, bm, bn, k_tiles, per, splits,
                    (-(-m // bm), -(-n // bn), splits), min(tiles * splits, resident * sm_count),
                    ws, tiles if splits > 1 else 0)


# csrc/w8a8.cu's row quantization: threads a block, 16-byte vectors a
# thread holds, blocks a cluster (the portable limit)
Q_THREADS = 1024
Q_VEC = 4
MAX_CLUSTER = 8
# the most blocks of a cluster a decode row is split across, by kernel:
# the cluster's exchange of partials costs a launch more than it saves,
# except for SiLU x up, whose expf and IEEE division an element repay
# spreading the row over more SMs (measured in the 8B decode chain; PERF.md)
DECODE_CLUSTER = {"quantize_rows": 1, "rms_norm_quantize_rows": 1, "silu_mul_quantize_rows": 8}
# a decode row's slice keeps at least a warp's worth of vectors a block
MIN_SLICE = 32


class QuantPlan(NamedTuple):
    cluster: int  # blocks a row (a thread block cluster when above 1)
    per: int  # 16-byte vectors of the row a block takes (the last may take fewer)
    threads: int  # threads a block
    blocks: int  # blocks launched: m * cluster


@functools.lru_cache(maxsize=None)
def quant_plan(m: int, k: int, sm_count: int, elem_bytes: int = 2, split: int = 1) -> QuantPlan:
    """The row quantization's launch for [m, k] rows of `elem_bytes`-byte
    elements. A row is K * elem_bytes / 16 vectors; a block holds at most
    Q_THREADS * Q_VEC of them, so a longer row needs a cluster. Decode rows
    (m <= ROWS_MAX) are split further, doubling the cluster up to `split`
    blocks (the kernel's DECODE_CLUSTER) while the rows still fit the SMs
    and each block keeps MIN_SLICE vectors; each thread then holds one
    vector where it can, so a row's blocks issue all their loads at once.
    Prefill rows take the fewest blocks a row and Q_VEC vectors a thread:
    the fewer threads a row, the more rows an SM holds in flight. Reads
    shapes only (a graph replay launches what its capture planned);
    cached."""
    nvec = k * elem_bytes // 16
    cluster = -(-nvec // (Q_THREADS * Q_VEC))
    if cluster > MAX_CLUSTER:
        raise ValueError(f"a row of {k} x {elem_bytes} bytes needs {cluster} blocks, "
                         f"more than a cluster's {MAX_CLUSTER}")
    decode = m <= ROWS_MAX
    if decode:
        while (2 * cluster <= split and 2 * cluster * m <= sm_count
               and nvec // (2 * cluster) >= MIN_SLICE):
            cluster *= 2
    per = -(-nvec // cluster)
    cluster = -(-nvec // per)  # no block without a vector
    need = -(-per // (1 if decode else Q_VEC))  # threads, before whole warps
    threads = min(Q_THREADS, -(-need // 32) * 32)
    return QuantPlan(cluster, per, threads, m * cluster)


# programmatic dependent launch of the W8A8 kernels (csrc/w8a8.cu): a launch
# may start while the kernel before it ends; scripts/trace_w8a8.py turns it
# off to measure what it saves
PDL = True
_FLOATS = (torch.bfloat16, torch.float32)


_divisors: dict = {}


def true_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a (f32) / d by IEEE division on every device. On CUDA, PyTorch
    divides a tensor by a Python scalar (or a 0-dim CPU tensor) as a
    product with the scalar's reciprocal, which is one ulp off the quotient
    for some a (f32 0.143 / 127 and / 7); a divisor on a's device takes the
    true division, as the JAX package's eager `amax / 127.0` does. The
    divisor is a 0-dim tensor made at the first call for (device, d) and
    kept, so a captured decode graph gains no fill launch; it is made
    outside any capture (the engine runs each step eagerly first), since a
    tensor made while capturing holds its value only once the graph
    replays."""
    key = (a.device, d)
    t = _divisors.get(key)
    if t is None:
        if a.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the divisor {d} on {a.device} is first needed inside a "
                               "CUDA-graph capture; run the step eagerly first")
        t = _divisors[key] = torch.full((), d, dtype=torch.float32, device=a.device)
    return a / t


def _fill(y, rows):
    if y is not None:
        y.copy_(rows)
    return rows


def quantize_rows_plain(x: torch.Tensor):
    """Plain PyTorch version of the row quantization."""
    quantize_rows_plain.calls += 1
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(amax > 0, true_div(amax, 127.0), 1.0)
    q = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return q, xs[:, 0]


def rms_norm_quantize_rows_plain(x, weight, eps, weight_offset=0.0, y=None):
    """Plain PyTorch version of the norm's row quantization: `rms_norm`,
    then `quantize_rows_plain`."""
    rms_norm_quantize_rows_plain.calls += 1
    return quantize_rows_plain(_fill(y, rms_norm(x, weight, eps, weight_offset)))


def silu_mul_quantize_rows_plain(gate, up, y=None):
    """Plain PyTorch version of SiLU x up's row quantization:
    `F.silu(gate) * up`, then `quantize_rows_plain`."""
    silu_mul_quantize_rows_plain.calls += 1
    return quantize_rows_plain(_fill(y, F.silu(gate) * up))


for _plain in (quantize_rows_plain, rms_norm_quantize_rows_plain, silu_mul_quantize_rows_plain):
    _plain.calls = 0


def w8a8_gemm_plain(xq, xs, wq, ws, out_dtype=torch.float32):
    """Plain PyTorch version of the GEMM (float64 dot of the codes, exact)."""
    w8a8_gemm_plain.calls += 1
    acc = (xq.double() @ wq.double().T).float()
    return (acc * xs[:, None] * ws[None, :]).to(out_dtype)


w8a8_gemm_plain.calls = 0


def _rows_ok(t, m, k, dtype, dev) -> bool:
    return (t.device == dev and t.dtype == dtype and t.shape == (m, k) and t.is_contiguous()
            and t.data_ptr() % 16 == 0)


def _rows_launch(what, x, others=(), y=None):
    """Checks the rows x [M, K] and the tensors beside them (`others`:
    (tensor, shape) pairs, of x's dtype and device; `y`, None or [M, K]),
    and returns the launch's plan, the codes and scales it fills, and the
    leading arguments every row launcher takes."""
    dev = x.device
    if not (dev.type == "cuda" and x.dim() == 2 and x.dtype in _FLOATS
            and x.shape[1] % 32 == 0 and 0 < x.shape[1] <= MAX_K and x.is_contiguous()
            and x.data_ptr() % 16 == 0
            and all(_rows_ok(t, *shape, x.dtype, dev) for t, shape in others)
            and (y is None or _rows_ok(y, *x.shape, x.dtype, dev))):
        raise ValueError(
            f"{what} takes contiguous, 16-byte aligned bf16 or f32 CUDA tensors of one dtype "
            f"on one device, rows [M, K] with K a multiple of 32, at most {MAX_K}: got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}"
                        for t in (x, *(t for t, _ in others), *(() if y is None else (y,)))))
    m, k = x.shape
    plan = quant_plan(m, k, _cuda.sm_count(dev), x.element_size(), DECODE_CLUSTER[what])
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    s = torch.empty((m,), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t, _ in others] + [q.data_ptr(), s.data_ptr()]
    return plan, q, s, ptrs


def quantize_rows(x: torch.Tensor):
    """x [M, K] bf16/f32 -> (int8 codes [M, K], f32 scales [M])."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    p, q, s, ptrs = _rows_launch("quantize_rows", x)
    err = _launcher().quantize_rows_launch(
        x.data_ptr(), *ptrs, *x.shape, int(x.dtype == torch.bfloat16), p.cluster, p.per,
        p.threads, int(PDL), _cuda.stream_ptr(x.device))
    _cuda.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, s


def rms_norm_quantize_rows(x, weight, eps: float, weight_offset: float = 0.0, y=None):
    """x [M, K] bf16/f32, weight [K] of x's dtype -> (int8 codes [M, K], f32
    scales [M]) of `rms_norm(x, weight, eps, weight_offset)`; `y` [M, K] of
    x's dtype, when given, receives the normed rows."""
    if x.device.type == "cpu":
        return rms_norm_quantize_rows_plain(x, weight, eps, weight_offset, y)
    p, q, s, ptrs = _rows_launch("rms_norm_quantize_rows", x,
                                 ((weight.reshape(1, -1), (1, x.shape[-1])),), y)
    err = _launcher().rms_norm_quantize_rows_launch(
        x.data_ptr(), *ptrs, 0 if y is None else y.data_ptr(), *x.shape,
        int(x.dtype == torch.bfloat16), eps, weight_offset, p.cluster, p.per, p.threads,
        int(PDL), _cuda.stream_ptr(x.device))
    _cuda.check(err, "rms_norm_quantize_rows")
    rms_norm_quantize_rows.launches += 1
    return q, s


def silu_mul_quantize_rows(gate, up, y=None):
    """gate, up [M, K] bf16/f32 of one dtype -> (int8 codes [M, K], f32
    scales [M]) of `F.silu(gate) * up`; `y` [M, K] of their dtype, when
    given, receives the product."""
    if gate.device.type == "cpu":
        return silu_mul_quantize_rows_plain(gate, up, y)
    p, q, s, ptrs = _rows_launch("silu_mul_quantize_rows", gate, ((up, tuple(gate.shape)),), y)
    err = _launcher().silu_mul_quantize_rows_launch(
        gate.data_ptr(), *ptrs, 0 if y is None else y.data_ptr(), *gate.shape,
        int(gate.dtype == torch.bfloat16), p.cluster, p.per, p.threads, int(PDL),
        _cuda.stream_ptr(gate.device))
    _cuda.check(err, "silu_mul_quantize_rows")
    silu_mul_quantize_rows.launches += 1
    return q, s


for _wrapper in (quantize_rows, rms_norm_quantize_rows, silu_mul_quantize_rows):
    _wrapper.launches = 0


def w8a8_gemm(xq, xs, wq, ws, out_dtype=torch.float32):
    """xq [M, K] int8, xs [M] f32, wq [N, K] int8, ws [N] f32 -> [M, N]
    in `out_dtype` (bf16 or f32)."""
    if xq.device.type == "cpu":
        return w8a8_gemm_plain(xq, xs, wq, ws, out_dtype)
    dev = xq.device
    m, k = xq.shape
    n = wq.shape[0]
    # one test on the host's hot path (an eager prefill makes 224 calls)
    if not (dev.type == "cuda" and out_dtype in _FLOATS and wq.shape == (n, k)
            and xs.shape == (m,) and ws.shape == (n,) and k % 32 == 0 and 0 < k <= MAX_K
            and xq.dtype == wq.dtype == torch.int8 and xs.dtype == ws.dtype == torch.float32
            and xs.device == wq.device == ws.device == dev
            and xq.is_contiguous() and xs.is_contiguous() and wq.is_contiguous()
            and ws.is_contiguous() and xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0):
        raise ValueError(
            "w8a8_gemm takes contiguous CUDA tensors on one device: codes xq [M, K] and wq "
            f"[N, K] int8 (16-byte aligned, K a multiple of 32, at most {MAX_K}), scales xs [M] "
            "and ws [N] float32, out_dtype bf16 or f32; got "
            + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}" for t in (xq, xs, wq, ws))
            + f", {out_dtype}")
    plan = gemm_plan(m, n, k, _cuda.sm_count(dev))
    part = tickets = 0  # null: an unsplit launch has no workspace
    if plan.splits > 1:
        part, tickets = (t.data_ptr() for t in _cuda.scratch(
            "w8a8_gemm", dev, plan.workspace_bytes // 4, torch.int32, plan.counters))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    err = _launcher().w8a8_gemm_launch(
        xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, k,
        int(out_dtype == torch.bfloat16), plan.variant_id, plan.splits, plan.blocks, int(PDL),
        part, tickets, _cuda.stream_ptr(dev))
    _cuda.check(err, "w8a8_gemm")
    w8a8_gemm.launches += 1
    return out


w8a8_gemm.launches = 0


def _launcher():
    lib = _cuda.load("w8a8")
    fn = lib.quantize_rows_launch
    if fn.argtypes is None:
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 3 + [i32] * 7 + [p]
        lib.rms_norm_quantize_rows_launch.argtypes = ([p] * 5 + [i32] * 3 + [f32] * 2
                                                      + [i32] * 4 + [p])
        lib.silu_mul_quantize_rows_launch.argtypes = [p] * 5 + [i32] * 7 + [p]
        fg = lib.w8a8_gemm_launch
        fg.argtypes = [p] * 5 + [i32] * 8 + [p] * 3
        lib.w8a8_occupancy.argtypes = [i32]
        for f in (fn, lib.rms_norm_quantize_rows_launch, lib.silu_mul_quantize_rows_launch, fg,
                  lib.w8a8_occupancy):
            f.restype = ctypes.c_int
        fe = lib.w8a8_encode_us
        fe.argtypes = [p, p] + [i32] * 4
        fe.restype = ctypes.c_double
    return lib
