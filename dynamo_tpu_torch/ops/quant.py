"""int8 KV cache: the quantization scheme and the scale-pool helpers.

Port of `dynamo_tpu/ops/quant.py` (`quantize_kv_rows`,
`dequantize_kv_rows`, the scale-pool helpers and `scales_to_page_tiles`),
int8 tier only. KV rows are quantized symmetrically per token row and kv
head: scale = amax / 127 (1.0 for an all-zero head), q = clip(round(x /
scale), -127, 127). `torch.round` rounds half to even like `jnp.round`,
and the division is a true division as in the reference, so rows and
scales are byte-equal to the JAX package's.

Scale pools are per layer [num_pages, K, page_size] f32, initialised to
1.0: the JAX layout [num_pages, SUBL, page_size] without its sublane
padding rows (`jax_pool[:, _scale_rows(K, 1), :]` is this pool). A page's
scales are one contiguous K * page_size * 4-byte tile, head-major, so the
page-scatter write copies it beside the page and the attention kernels
read one head's scales for consecutive tokens contiguously.
"""

from __future__ import annotations

import torch


def quantize_kv_rows(rows: torch.Tensor, num_kv_heads: int):
    """KV rows [..., K*Hd] float -> (int8 [..., K*Hd], scales f32 [..., K])."""
    shape = rows.shape
    hd = shape[-1] // num_kv_heads
    rf = rows.float().reshape(*shape[:-1], num_kv_heads, hd)
    amax = rf.abs().amax(dim=-1)
    scales = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.round(rf / scales[..., None]).clamp_(-127, 127)
    return q.reshape(shape).to(torch.int8), scales


def dequantize_kv_rows(q: torch.Tensor, scales: torch.Tensor, out_dtype=torch.float32):
    """(int8 [..., K*Hd], scales [..., K]) -> float [..., K*Hd]."""
    shape = q.shape
    kh = scales.shape[-1]
    f = q.float().reshape(*shape[:-1], kh, shape[-1] // kh) * scales[..., None]
    return f.reshape(shape).to(out_dtype)


def init_kv_scale_pool(num_pages: int, page_size: int, num_kv_heads: int, *,
                       device) -> torch.Tensor:
    return torch.ones((num_pages, num_kv_heads, page_size), dtype=torch.float32,
                      device=device)


def scatter_kv_scales(pool: torch.Tensor, slots: torch.Tensor, scales: torch.Tensor):
    """Write dense per-row scales [M, K] at flat slot ids [M], in place."""
    s = pool.shape[2]
    sl = slots.long()
    heads = torch.arange(pool.shape[1], device=pool.device)
    pool[(sl // s)[:, None], heads[None, :], (sl % s)[:, None]] = scales.float()
    return pool


def gather_kv_scales(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[M, K] dense scales of the given flat slot ids."""
    s = pool.shape[2]
    sl = slots.long()
    heads = torch.arange(pool.shape[1], device=pool.device)
    return pool[(sl // s)[:, None], heads[None, :], (sl % s)[:, None]]


def scales_to_page_tiles(dense: torch.Tensor, page_size: int) -> torch.Tensor:
    """Dense per-row scales [N*page_size, K] -> page tiles [N, K, page_size],
    the source format of the page-scatter write's scale copy."""
    n = dense.shape[0] // page_size
    return dense.reshape(n, page_size, dense.shape[1]).transpose(1, 2).contiguous()
