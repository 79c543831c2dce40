"""The paged KV cache layout, and its slot arithmetic.

KV cache layout (per layer): flat **slot** pools

    k_cache, v_cache : [num_slots, num_kv_heads * head_dim]

where slot = page_id * page_size + offset. Slot 0 lives in the reserved
trash page: padded positions write there, and it is never allocated. The
view [num_pages, page_size, K*Hd] of a pool is free (no copy), which is
what the page-granular kernels (kv_write, prefill_attention,
decode_attention) read and write in place. With int8 KV the pools are
int8 and each has a scale pool beside it (ops/quant.py).
"""

from __future__ import annotations

import torch


def slots_from_pages(block_tables: torch.Tensor, page_size: int) -> torch.Tensor:
    """Expand page-id tables [..., W] into slot matrices [..., W*page_size]."""
    offs = torch.arange(page_size, dtype=block_tables.dtype, device=block_tables.device)
    s = block_tables[..., :, None] * page_size + offs
    return s.reshape(*block_tables.shape[:-1], -1)
