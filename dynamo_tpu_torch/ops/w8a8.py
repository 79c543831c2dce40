"""W8A8 kernels: per-token activation quantization and the int8 GEMM.

The two halves of the JAX package's `dynamo_tpu/ops/quant.py::quant_matmul`
(:60-77), which XLA compiles into fused ops (no `pl.pallas_call`); the CUDA
kernels are in `csrc/w8a8.cu`.

- `quantize_rows(x)`: x [M, K] bf16 or f32 -> (codes [M, K] int8, scales
  [M] f32), s = amax / 127 per row (1.0 for an all-zero row), codes
  clip(round(x / s), -127, 127) with the true division and round half to
  even, so they are byte-equal to the reference's.
- `w8a8_gemm(xq, xs, wq, ws, out_dtype)`: codes [M, K] x weight codes
  [N, K] (the port's K-contiguous [out, in] layout, ops/quant.py) -> [M, N]
  as (f32(acc) * xs[m]) * ws[n] rounded once to `out_dtype`; the dot is
  s8 x s8 -> s32, exact.

Each wrapper runs its plain version on CPU tensors, launches its kernel on
CUDA tensors (counted in `<wrapper>.launches`) and raises for anything the
kernel does not take. The plain GEMM computes the dot as a float64 matmul
of the codes: every partial sum is an integer below 2**53, so it is exact
in any order, on the CPU and on the card (CUDA has no integer matmul).
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _cuda

# 127 * 127 * K must stay below 2**31 (the int32 accumulator)
MAX_K = 131072


def true_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d by IEEE division on every device. On CUDA, PyTorch divides a
    tensor by a Python scalar as a product with the scalar's reciprocal,
    which is one ulp off the quotient for some a; a tensor divisor takes
    the true division, as the JAX package's eager `amax / 127.0` does."""
    return a / torch.full_like(a, d)


def quantize_rows_plain(x: torch.Tensor):
    """Plain PyTorch version of the row quantization."""
    quantize_rows_plain.calls += 1
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(amax > 0, true_div(amax, 127.0), 1.0)
    q = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return q, xs[:, 0]


quantize_rows_plain.calls = 0


def w8a8_gemm_plain(xq, xs, wq, ws, out_dtype=torch.float32):
    """Plain PyTorch version of the GEMM (float64 dot of the codes, exact)."""
    w8a8_gemm_plain.calls += 1
    acc = (xq.double() @ wq.double().T).float()
    return (acc * xs[:, None] * ws[None, :]).to(out_dtype)


w8a8_gemm_plain.calls = 0


def quantize_rows(x: torch.Tensor):
    """x [M, K] bf16/f32 -> (int8 codes [M, K], f32 scales [M])."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    req = _cuda.require
    req(x.device.type == "cuda", f"unsupported device {x.device}")
    req(x.dim() == 2, f"quantize_rows takes [M, K], got {tuple(x.shape)}")
    req(x.dtype in (torch.bfloat16, torch.float32), f"unsupported dtype {x.dtype}")
    m, k = x.shape
    req(k % 32 == 0 and 0 < k <= MAX_K, f"K {k} must be a multiple of 32, at most {MAX_K}")
    req(x.is_contiguous() and x.data_ptr() % 16 == 0, "x must be contiguous and 16-byte aligned")
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    err = _launcher().quantize_rows_launch(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k, int(x.dtype == torch.bfloat16),
        _cuda.stream_ptr(x.device))
    _cuda.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0


def w8a8_gemm(xq, xs, wq, ws, out_dtype=torch.float32):
    """xq [M, K] int8, xs [M] f32, wq [N, K] int8, ws [N] f32 -> [M, N]
    in `out_dtype` (bf16 or f32)."""
    if xq.device.type == "cpu":
        return w8a8_gemm_plain(xq, xs, wq, ws, out_dtype)
    req = _cuda.require
    dev = xq.device
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(out_dtype in (torch.bfloat16, torch.float32), f"unsupported output dtype {out_dtype}")
    m, k = xq.shape
    n = wq.shape[0]
    req(wq.dim() == 2 and wq.shape[1] == k, f"weight codes must be [N, {k}], got {tuple(wq.shape)}")
    req(xs.shape == (m,) and ws.shape == (n,), "scales must be [M] and [N]")
    req(k % 32 == 0 and 0 < k <= MAX_K, f"K {k} must be a multiple of 32, at most {MAX_K}")
    for t in (xq, wq):
        req(t.dtype == torch.int8, "codes must be int8")
    for t in (xs, ws):
        req(t.dtype == torch.float32, "scales must be float32")
    for t in (xq, xs, wq, ws):
        req(t.device == dev, "all tensors must be on one device")
        req(t.is_contiguous(), "tensors must be contiguous")
    req(xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0, "codes must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    err = _launcher().w8a8_gemm_launch(
        xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, k,
        int(out_dtype == torch.bfloat16), _cuda.stream_ptr(dev))
    _cuda.check(err, "w8a8_gemm")
    w8a8_gemm.launches += 1
    return out


w8a8_gemm.launches = 0


def _launcher():
    lib = _cuda.load("w8a8")
    fn = lib.quantize_rows_launch
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i32, i32, i32, p]
        fn.restype = ctypes.c_int
        fg = lib.w8a8_gemm_launch
        fg.argtypes = [p] * 5 + [i32] * 4 + [p]
        fg.restype = ctypes.c_int
    return lib
