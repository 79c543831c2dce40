"""K3: paged decode attention fused with the new token's KV write.

Port of `dynamo_tpu/ops/pallas_attention.py::fused_paged_decode_attention`
(bf16 branch) and its read-only use `paged_decode_attention`; the CUDA
kernel is `csrc/decode_attention.cu`. One query per sequence: when
`write_pos[b] >= 0` the new K/V row is stored at that position (the caller
keeps `write_pos < lengths`, as the engine does), then the query attends
`lengths[b]` keys, the new one included. Rows with `lengths == 0` output 0.
The pools are updated in place.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _cuda
from dynamo_tpu_torch.ops.attention import slots_from_pages

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8


def fused_paged_decode_attention_plain(
    q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos, *,
    page_size,
):
    """Plain PyTorch version: row write, then gathered attention over the
    first `lengths[b]` slots. As in the reference, q is scaled and rounded
    to its own dtype before the f32 dot products."""
    fused_paged_decode_attention_plain.calls += 1
    b, h, hd = q.shape
    kh = k_cache.shape[1] // hd
    g = h // kh
    rows = torch.nonzero(write_pos >= 0).flatten()
    if rows.numel():
        wp = write_pos[rows].long()
        page = block_tables[rows, wp // page_size].long()
        slots = page * page_size + wp % page_size
        k_cache[slots] = new_k[rows].to(k_cache.dtype)
        v_cache[slots] = new_v[rows].to(v_cache.dtype)
    smat = slots_from_pages(block_tables, page_size).long()  # [B, C]
    c = smat.shape[1]
    k = k_cache[smat].reshape(b, c, kh, hd).float()
    v = v_cache[smat].reshape(b, c, kh, hd).float()
    qs = (q.float() * hd ** -0.5).to(q.dtype).float().reshape(b, kh, g, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qs, k)
    valid = (torch.arange(c, device=q.device)[None, :] < lengths.long()[:, None])
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -0.7 * torch.finfo(torch.float32).max))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgc,bckd->bkgd", p / denom, v)
    return out.reshape(b, h, hd).to(q.dtype), k_cache, v_cache


fused_paged_decode_attention_plain.calls = 0


def fused_paged_decode_attention(
    q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos, *,
    page_size,
):
    """q [B, H, Hd] (rope applied, unscaled); new_k/new_v [B, K*Hd];
    pools [num_slots, K*Hd]; block_tables [B, W], lengths and write_pos [B]
    int32. Returns (out [B, H, Hd], k_cache, v_cache) with the pools
    updated in place. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16, head_dim in {32, 64, 128}, H/K <= 8)."""
    if q.device.type == "cpu":
        return fused_paged_decode_attention_plain(
            q, new_k, new_v, k_cache, v_cache, block_tables, lengths,
            write_pos, page_size=page_size,
        )
    out = _launch(q, new_k, new_v, k_cache, v_cache, block_tables, lengths,
                  write_pos, page_size)
    return out, k_cache, v_cache


def paged_decode_attention(q, k_cache, v_cache, block_tables, lengths, *, page_size):
    """Read-only decode attention (KV already written): the same kernel
    with every write skipped. Returns [B, H, Hd]."""
    b = q.shape[0]
    no_write = torch.full((b,), -1, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        kw = k_cache.shape[1]
        zeros = torch.zeros((b, kw), dtype=k_cache.dtype)
        return fused_paged_decode_attention_plain(
            q, zeros, zeros, k_cache, v_cache, block_tables, lengths,
            no_write, page_size=page_size,
        )[0]
    return _launch(q, None, None, k_cache, v_cache, block_tables, lengths,
                   no_write, page_size)


def _launch(q, new_k, new_v, k_cache, v_cache, block_tables, lengths,
            write_pos, page_size):
    req = _cuda.require
    req(q.device.type == "cuda", f"unsupported device {q.device}")
    b, h, hd = q.shape
    num_slots, kw = k_cache.shape
    req(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    req(kw % hd == 0, "pool width must be K * head_dim")
    kh = kw // hd
    req(h % kh == 0 and h // kh <= MAX_GROUP, f"unsupported GQA group {h}/{kh}")
    req(num_slots % page_size == 0, "pool rows must be whole pages")
    req(v_cache.shape == k_cache.shape, "k/v pools differ in shape")
    req(block_tables.dim() == 2 and block_tables.shape[0] == b, "block_tables must be [B, W]")
    req(lengths.shape == (b,) and write_pos.shape == (b,), "lengths/write_pos must be [B]")
    tensors = [q, k_cache, v_cache, block_tables, lengths, write_pos]
    if new_k is not None:
        req(new_k.shape == (b, kw) and new_v.shape == (b, kw), "new rows must be [B, K*Hd]")
        tensors += [new_k, new_v]
        for x in (new_k, new_v):
            req(x.dtype == torch.bfloat16, "new rows must be bfloat16")
    for x in (q, k_cache, v_cache):
        req(x.dtype == torch.bfloat16, "q and pools must be bfloat16")
    for x in (block_tables, lengths, write_pos):
        req(x.dtype == torch.int32, "tables, lengths and write_pos must be int32")
    for x in tensors:
        req(x.device == q.device, "all tensors must be on one device")
        req(x.is_contiguous(), "tensors must be contiguous")
    out = torch.empty_like(q)
    lib = _launcher()
    err = lib.fused_decode_launch(
        q.data_ptr(),
        new_k.data_ptr() if new_k is not None else None,
        new_v.data_ptr() if new_v is not None else None,
        k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), write_pos.data_ptr(), out.data_ptr(),
        b, h, kh, hd, block_tables.shape[1], page_size, hd ** -0.5,
        _cuda.stream_ptr(q.device),
    )
    _cuda.check(err, "fused_paged_decode_attention")
    fused_paged_decode_attention.launches += 1
    return out


fused_paged_decode_attention.launches = 0


def _launcher():
    lib = _cuda.load("decode_attention")
    fn = lib.fused_decode_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
