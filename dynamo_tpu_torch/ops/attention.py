"""Attention over a paged KV cache: the plain gather oracle.

KV cache layout (per layer): flat **slot** pools

    k_cache, v_cache : [num_slots, num_kv_heads * head_dim]

where slot = page_id * page_size + offset. Slot 0 lives in the reserved
trash page: padded positions write there, and it is never allocated. The
view [num_pages, page_size, K*Hd] of a pool is free (no copy), which is
what the page-granular kernels (kv_write, prefill_attention,
decode_attention) read and write in place.

Everything here is plain PyTorch on any device: the reference the three
hand-written kernels are held against.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def write_kv_slots(
    k_cache: torch.Tensor,  # [N, K*Hd], updated in place
    v_cache: torch.Tensor,
    slots: torch.Tensor,    # [M] int flat slot ids (0 = trash)
    new_k: torch.Tensor,    # [M, K*Hd]
    new_v: torch.Tensor,
):
    """Scatter per-token KV into the slot pools, in place. Trash-slot
    writes (padding) are harmless by construction."""
    k_cache[slots.long()] = new_k.to(k_cache.dtype)
    v_cache[slots.long()] = new_v.to(v_cache.dtype)
    return k_cache, v_cache


def slots_from_pages(block_tables: torch.Tensor, page_size: int) -> torch.Tensor:
    """Expand page-id tables [..., W] into slot matrices [..., W*page_size]."""
    offs = torch.arange(page_size, dtype=block_tables.dtype, device=block_tables.device)
    s = block_tables[..., :, None] * page_size + offs
    return s.reshape(*block_tables.shape[:-1], -1)


def paged_attention(
    q: torch.Tensor,            # [B, T, H, Hd] (rope applied; KV already written)
    k_cache: torch.Tensor,      # [N, K*Hd]
    v_cache: torch.Tensor,
    slot_matrix: torch.Tensor,  # [B, C] int: the sequence's slots, position-ordered
    positions: torch.Tensor,    # [B, T] int absolute position of each query
    q_lens: torch.Tensor | None = None,  # [B] valid query rows per row
) -> torch.Tensor:
    """Gathered-slot attention. Gathered slot j holds absolute position j of
    the sequence, so causality is `j <= positions[b, t]`; 0-padded table
    tails are masked by the same comparison. Query columns >= q_lens[b]
    (when given) emit exact zeros."""
    b, t, h, hd = q.shape
    kh = k_cache.shape[1] // hd
    g = h // kh
    scale = hd ** -0.5
    c = slot_matrix.shape[1]
    sm = slot_matrix.long()
    k = k_cache[sm].reshape(b, c, kh, hd)
    v = v_cache[sm].reshape(b, c, kh, hd)
    qg = q.reshape(b, t, kh, g, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale

    j = torch.arange(c, device=q.device)
    mask = j[None, None, :] <= positions[:, :, None]  # [B, T, C]
    if q_lens is not None:
        mask = mask & (
            torch.arange(t, device=q.device)[None, :, None] < q_lens[:, None, None]
        )
    mask = mask[:, None, None, :, :]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    probs = p / (p.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(b, t, h, hd)
