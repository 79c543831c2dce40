"""The paged KV cache layout, and its slot arithmetic.

KV cache layout (per layer): flat **slot** pools

    k_cache, v_cache : [num_slots, num_kv_heads * head_dim]

where slot = page_id * page_size + offset. Slot 0 lives in the reserved
trash page: padded positions write there, and it is never allocated. The
view [num_pages, page_size, K*Hd] of a pool is free (no copy), which is
what the page-granular kernels (kv_write, prefill_attention,
decode_attention) read and write in place. With int8 or int4 KV the pools
are int8 and each has a scale pool beside it (ops/quant.py).

`write_kv_rows` is the row-granular write that mixed and verify steps
need: their decode and verify rows land mid-page, which the page-scatter
kernel (whole pages) cannot express. As in the reference (an XLA scatter
outside Pallas), it is plain tensor ops.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.quant import (
    int4_group_size,
    quantize_kv_rows,
    quantize_kv_rows_int4,
    scatter_kv_scales,
)


def slots_from_pages(block_tables: torch.Tensor, page_size: int) -> torch.Tensor:
    """Expand page-id tables [..., W] into slot matrices [..., W*page_size]."""
    offs = torch.arange(page_size, dtype=block_tables.dtype, device=block_tables.device)
    s = block_tables[..., :, None] * page_size + offs
    return s.reshape(*block_tables.shape[:-1], -1)


def write_kv_rows(k_cache, v_cache, slots, new_k, new_v, k_scales=None,
                  v_scales=None, *, int4=False, num_kv_heads=None):
    """Scatter per-token KV rows into the slot pools, in place (the JAX
    package's `write_kv_slots` and the row write of its `_write_rows`).

    `slots` [M] flat slot ids (0, the trash page, for padding columns);
    `new_k`/`new_v` [M, K*Hd] in the activations' dtype. With scale pools
    [num_pages, S, page_size] the pools are int8: the rows are quantized
    (K and V in one call; nibble-packed with `int4=True`, in groups of
    head_dim * K / S features when `num_kv_heads` K is given and S is a
    multiple of it; S is K otherwise) and their scales land beside them.
    Several padding columns may write slot 0; which one wins there is
    unspecified, as in the reference."""
    idx = slots.long()
    if k_scales is None:
        k_cache.index_copy_(0, idx, new_k.to(k_cache.dtype))
        v_cache.index_copy_(0, idx, new_v.to(v_cache.dtype))
        return
    rows = torch.stack((new_k, new_v))
    kh = num_kv_heads or k_scales.shape[1]
    if int4:
        group = int4_group_size(k_scales.shape[1], kh, new_k.shape[-1] // kh)
        (qk, qv), (sk, sv) = quantize_kv_rows_int4(rows, kh, group)
    else:
        (qk, qv), (sk, sv) = quantize_kv_rows(rows, kh)
    k_cache.index_copy_(0, idx, qk)
    v_cache.index_copy_(0, idx, qv)
    scatter_kv_scales(k_scales, idx, sk)
    scatter_kv_scales(v_scales, idx, sv)
