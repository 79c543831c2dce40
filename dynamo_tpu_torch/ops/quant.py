"""int8 and int4 KV cache: the quantization schemes and the scale-pool helpers.

Port of `dynamo_tpu/ops/quant.py` (`quantize_kv_rows`,
`dequantize_kv_rows`, `int4_scale_channels`, `quantize_kv_rows_int4`,
`unpack_int4_kv`, `dequantize_kv_rows_int4`, the scale-pool helpers and
`scales_to_page_tiles`). int8 rows are quantized symmetrically per token
row and kv head: scale = amax / 127 (1.0 for an all-zero head), q =
clip(round(x / scale), -127, 127). int4 rows use scale = amax / 7 per
group of `group_size` features (default head_dim: one scale per token and
kv head, the only grouping the kernels take) and q = clip(round(x /
scale), -7, 7), two codes a byte. `torch.round` rounds half to even like
`jnp.round`, and the divisions are true divisions as in the reference, so
rows and scales are byte-equal to the JAX package's.

int4 packing is planar per kv head: a head's Hd features become Hd/2
bytes, byte j holding feature j in its low nibble and feature j + Hd/2 in
its high nibble (not adjacent pairs). A low nibble sign-extends as
((b & 15) ^ 8) - 8, a high one as the arithmetic shift b >> 4 of the
signed byte.

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


def int4_scale_channels(num_kv_heads: int, head_dim: int,
                        group_size: int | None = None) -> int:
    """Scale channels S of an int4 row (K * groups per head)."""
    g = head_dim if group_size is None else group_size
    if g <= 0 or head_dim % g:
        raise ValueError(f"kv_quant_group {g} must divide head_dim {head_dim}")
    return num_kv_heads * (head_dim // g)


def quantize_kv_rows_int4(rows: torch.Tensor, num_kv_heads: int,
                          group_size: int | None = None):
    """KV rows [..., K*Hd] float -> (packed int8 [..., K*Hd/2], scales f32
    [..., S]) with S = K * Hd / group_size. The pack is one remainder and
    one multiply-add in f32 (exact for codes in [-7, 7]): this runs on the
    host-bound decode step, where every eager launch costs."""
    shape = rows.shape
    hd = shape[-1] // num_kv_heads
    g = hd if group_size is None else group_size
    s = int4_scale_channels(num_kv_heads, hd, g)
    rf = rows.float().reshape(*shape[:-1], num_kv_heads, hd // g, g)
    amax = rf.abs().amax(dim=-1)
    scales = torch.where(amax > 0, amax / 7.0, 1.0)
    q = torch.round(rf / scales[..., None]).clamp_(-7, 7)
    q = q.reshape(*shape[:-1], num_kv_heads, hd)
    # byte = hi * 16 + (lo & 15), the value of (hi << 4) | (lo & 0xF)
    packed = torch.remainder(q[..., : hd // 2], 16).add_(q[..., hd // 2:], alpha=16)
    return (packed.to(torch.int8).reshape(*shape[:-1], shape[-1] // 2),
            scales.reshape(*shape[:-1], s))


def unpack_int4_kv(packed: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """Packed int8 [..., K*Hd/2] -> int8 codes [..., K*Hd] in [-7, 7]."""
    shape = packed.shape
    b = packed.to(torch.int32).reshape(*shape[:-1], num_kv_heads, shape[-1] // num_kv_heads)
    lo = ((b & 15) ^ 8) - 8
    hi = b >> 4
    full = torch.cat([lo, hi], dim=-1)
    return full.reshape(*shape[:-1], 2 * shape[-1]).to(torch.int8)


def dequantize_kv_rows_int4(packed: torch.Tensor, scales: torch.Tensor,
                            num_kv_heads: int, out_dtype=torch.float32):
    """(packed int8 [..., K*Hd/2], scales [..., S]) -> float [..., K*Hd];
    the group size follows from S."""
    shape = packed.shape
    hd = 2 * shape[-1] // num_kv_heads
    gph = scales.shape[-1] // num_kv_heads
    q = unpack_int4_kv(packed, num_kv_heads).float()
    qg = q.reshape(*shape[:-1], num_kv_heads, gph, hd // gph)
    f = qg * scales.reshape(*shape[:-1], num_kv_heads, gph)[..., None].float()
    return f.reshape(*shape[:-1], 2 * shape[-1]).to(out_dtype)


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
