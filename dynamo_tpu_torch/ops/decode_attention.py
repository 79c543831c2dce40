"""K3 and K5: paged decode attention fused with the new token's KV write;
K4: the ragged paged-attention read of mixed and verify steps.

Port of `dynamo_tpu/ops/pallas_attention.py::fused_paged_decode_attention`
(K3 the bf16 branch `_decode_kernel`, K5 the quantized branch
`_decode_kernel_q` in its int8 and int4 forms) and its read-only use
`paged_decode_attention`; the CUDA kernels are in
`csrc/decode_attention.cu` (flash-decoding: each row's keys split over
several blocks, planned by `split_plan`, merged inside the one launch).
One query per sequence: when `write_pos[b] >= 0`
the new K/V row is stored at that position (the caller keeps `write_pos <
lengths`, as the engine does), then the query attends `lengths[b]` keys,
the new one included. Rows with `lengths == 0` output 0. The pools are
updated in place.

With scale pools (int8 KV, ops/quant.py layout) the pools and the new rows
are int8 and `new_ks`/`new_vs` [B, K] are the new rows' scales: they are
stored beside the row, and the new token is attended through its
quantized row, as in the reference. With `int4=True` the pools and new rows
are nibble-packed, K*Hd/2 bytes a row (ops/quant.py planar layout); the
width then no longer tells the number of kv heads, hence the flag. int4
scale pools (and new scales) may carry S = K * groups channels, scale
groups finer than head_dim: the grouped int4 form, which attends rows
dequantized to q's dtype (code times group scale in f32, then rounded), as
the reference's gather path does (ops/prefill_attention.py
`dequantize_gathered`).

K4, `ragged_paged_attention`, is the port of
`pallas_attention.py::ragged_paged_attention`: read-only attention with
per-row query lengths over KV already written (row-scattered by the
caller, ops/attention.write_kv_rows). Decode rows have q_len 1 at any
(mid-page) position, verify rows 1 + k, chunk rows are causal inside the
chunk, q_len 0 rows are 0. As in the reference it has no kernel body of
its own: it enters the flash prefill kernels (K2, K6 and K6's int4 forms,
`csrc/prefill_attention.cu`), whose rows already take any pos0 and any
t_valid, and counts its launches apart from theirs.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _cuda, prefill_attention
from dynamo_tpu_torch.ops.attention import slots_from_pages
from dynamo_tpu_torch.ops.prefill_attention import (
    MIN_GROUP,
    dequantize_gathered,
    is_grouped,
    num_kv_heads,
)
from dynamo_tpu_torch.ops.quant import gather_kv_scales, scatter_kv_scales

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
# the decode kernel's split quantum (csrc/decode_attention.cu kSplitKeys)
SPLIT_KEYS = 128
# the planner's bound on the decode grid, in blocks an SM; a split past its
# row's length exits at once, so the bound is loose
BLOCKS_PER_SM = 16


def split_plan(b, kh, w, page_size, sm_count):
    """The decode kernel's split of each row's keys: (chunk, splits).
    Split s covers key positions [s * chunk, (s + 1) * chunk), and the
    splits cover the table's `w * page_size` positions. `chunk` is the
    least of 128, 256, ... that keeps the grid (`b * kh * splits` blocks)
    within BLOCKS_PER_SM blocks an SM. The plan reads no lengths: on the
    host they would cost a device-to-host sync per layer, and a split that
    starts past its row's length exits at once."""
    span = max(1, w * page_size)
    chunk = SPLIT_KEYS
    while True:
        splits = -(-span // chunk)
        if splits == 1 or b * kh * splits <= BLOCKS_PER_SM * sm_count:
            return chunk, splits
        chunk *= 2


def _write_rows(k_cache, v_cache, block_tables, write_pos, new_k, new_v, page_size):
    """Store each writing row's new K/V at its position; returns the rows
    that wrote and their flat slots."""
    rows = torch.nonzero(write_pos >= 0).flatten()
    wp = write_pos[rows].long()
    slots = block_tables[rows, wp // page_size].long() * page_size + wp % page_size
    k_cache[slots] = new_k[rows].to(k_cache.dtype)
    v_cache[slots] = new_v[rows].to(v_cache.dtype)
    return rows, slots


def _attend(q, k, v, lengths):
    """One-query attention over gathered f32 KV [B, C, K, Hd], the first
    `lengths[b]` positions. As in the reference, q is scaled and rounded to
    its own dtype before the f32 dot products."""
    b, h, hd = q.shape
    c, kh = k.shape[1], k.shape[2]
    qs = (q.float() * hd ** -0.5).to(q.dtype).float().reshape(b, kh, h // kh, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qs, k)
    valid = (torch.arange(c, device=q.device)[None, :] < lengths.long()[:, None])
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -0.7 * torch.finfo(torch.float32).max))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgc,bckd->bkgd", p / denom, v)
    return out.reshape(b, h, hd).to(q.dtype)


def fused_paged_decode_attention_plain(
    q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos, *,
    page_size,
):
    """Plain PyTorch version of K3: row write, then gathered attention over
    the first `lengths[b]` slots."""
    fused_paged_decode_attention_plain.calls += 1
    b, _, hd = q.shape
    kh = k_cache.shape[1] // hd
    _write_rows(k_cache, v_cache, block_tables, write_pos, new_k, new_v, page_size)
    smat = slots_from_pages(block_tables, page_size).long()  # [B, C]
    k = k_cache[smat].reshape(b, smat.shape[1], kh, hd).float()
    v = v_cache[smat].reshape(b, smat.shape[1], kh, hd).float()
    return _attend(q, k, v, lengths), k_cache, v_cache


fused_paged_decode_attention_plain.calls = 0


def fused_paged_decode_attention_q_plain(
    q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos,
    k_scales, v_scales, new_ks, new_vs, *, page_size,
):
    """Plain PyTorch version of K5 (int8): row and scale write, then the
    gathered rows dequantized to f32 and K3's attention over them."""
    fused_paged_decode_attention_q_plain.calls += 1
    return _write_and_attend_quantized(
        q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos,
        k_scales, v_scales, new_ks, new_vs, page_size, False,
    )


fused_paged_decode_attention_q_plain.calls = 0


def fused_paged_decode_attention_q4_plain(
    q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos,
    k_scales, v_scales, new_ks, new_vs, *, page_size,
):
    """Plain PyTorch version of K5's int4 form: the same over nibble-packed
    rows, unpacked and dequantized to f32."""
    fused_paged_decode_attention_q4_plain.calls += 1
    return _write_and_attend_quantized(
        q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos,
        k_scales, v_scales, new_ks, new_vs, page_size, True,
    )


fused_paged_decode_attention_q4_plain.calls = 0


def fused_paged_decode_attention_q4g_plain(
    q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos,
    k_scales, v_scales, new_ks, new_vs, *, page_size,
):
    """Plain PyTorch version of K5's grouped int4 form: scale pools and new
    scales [B, S] of S = K * groups channels; the gathered rows are each
    code times its group's scale, rounded to q's dtype, then attended."""
    fused_paged_decode_attention_q4g_plain.calls += 1
    return _write_and_attend_quantized(
        q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos,
        k_scales, v_scales, new_ks, new_vs, page_size, True,
    )


fused_paged_decode_attention_q4g_plain.calls = 0


def _plain_q(int4, grouped):
    if grouped:
        return fused_paged_decode_attention_q4g_plain
    return fused_paged_decode_attention_q4_plain if int4 else fused_paged_decode_attention_q_plain


def _write_and_attend_quantized(q, new_k, new_v, k_cache, v_cache, block_tables,
                                lengths, write_pos, k_scales, v_scales, new_ks,
                                new_vs, page_size, int4):
    b, _, hd = q.shape
    kh = num_kv_heads(k_cache, hd, int4)
    rows, slots = _write_rows(
        k_cache, v_cache, block_tables, write_pos, new_k, new_v, page_size)
    scatter_kv_scales(k_scales, slots, new_ks[rows])
    scatter_kv_scales(v_scales, slots, new_vs[rows])
    flat = slots_from_pages(block_tables, page_size).long().reshape(-1)
    c = flat.shape[0] // b
    k = dequantize_gathered(k_cache[flat], gather_kv_scales(k_scales, flat), kh, int4, q.dtype)
    v = dequantize_gathered(v_cache[flat], gather_kv_scales(v_scales, flat), kh, int4, q.dtype)
    out = _attend(q, k.reshape(b, c, kh, hd), v.reshape(b, c, kh, hd), lengths)
    return out, k_cache, v_cache, k_scales, v_scales


def fused_paged_decode_attention(
    q, new_k, new_v, k_cache, v_cache, block_tables, lengths, write_pos,
    k_scales=None, v_scales=None, new_ks=None, new_vs=None, *, page_size,
    int4=False,
):
    """q [B, H, Hd] (rope applied, unscaled); new_k/new_v [B, K*Hd];
    pools [num_slots, K*Hd]; block_tables [B, W], lengths and write_pos [B]
    int32. With scale pools `k_scales`/`v_scales` [num_pages, K, page_size]
    f32, the pools and new rows are int8 (K*Hd/2 nibble-packed bytes a row
    with `int4=True`) and `new_ks`/`new_vs` [B, K] f32 (int4 scale pools
    [num_pages, S, page_size] and new scales [B, S] of S = K * groups
    channels take the grouped form). Returns
    (out [B, H, Hd], k_cache, v_cache[, k_scales, v_scales]) with the pools
    updated in place. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 q, head_dim in {32, 64, 128}, H/K <= 8)."""
    quant = k_scales is not None
    _cuda.require(quant or not int4, "int4 KV needs scale pools")
    if q.device.type == "cpu":
        if quant:
            kh = num_kv_heads(k_cache, q.shape[-1], int4)
            plain = _plain_q(int4, int4 and is_grouped(k_scales, kh))
            return plain(
                q, new_k, new_v, k_cache, v_cache, block_tables, lengths,
                write_pos, k_scales, v_scales, new_ks, new_vs, page_size=page_size,
            )
        return fused_paged_decode_attention_plain(
            q, new_k, new_v, k_cache, v_cache, block_tables, lengths,
            write_pos, page_size=page_size,
        )
    out = _launch(q, new_k, new_v, k_cache, v_cache, block_tables, lengths,
                  write_pos, page_size, k_scales, v_scales, new_ks, new_vs, int4)
    if quant:
        return out, k_cache, v_cache, k_scales, v_scales
    return out, k_cache, v_cache


def paged_decode_attention(q, k_cache, v_cache, block_tables, lengths,
                           k_scales=None, v_scales=None, *, page_size, int4=False):
    """Read-only decode attention (KV already written): the same kernel
    with every write skipped. Returns [B, H, Hd]."""
    b = q.shape[0]
    no_write = torch.full((b,), -1, dtype=torch.int32, device=q.device)
    _cuda.require(k_scales is not None or not int4, "int4 KV needs scale pools")
    if q.device.type == "cpu":
        zeros = torch.zeros((b, k_cache.shape[1]), dtype=k_cache.dtype)
        if k_scales is not None:
            ones = torch.ones((b, k_scales.shape[1]))
            kh = num_kv_heads(k_cache, q.shape[-1], int4)
            plain = _plain_q(int4, int4 and is_grouped(k_scales, kh))
            return plain(
                q, zeros, zeros, k_cache, v_cache, block_tables, lengths,
                no_write, k_scales, v_scales, ones, ones, page_size=page_size,
            )[0]
        return fused_paged_decode_attention_plain(
            q, zeros, zeros, k_cache, v_cache, block_tables, lengths,
            no_write, page_size=page_size,
        )[0]
    return _launch(q, None, None, k_cache, v_cache, block_tables, lengths,
                   no_write, page_size, k_scales, v_scales, None, None, int4)


def ragged_paged_attention_plain(q, k_cache, v_cache, block_tables, q_pos0,
                                 q_lens, *, page_size):
    """Plain PyTorch version of K4 (bf16 pools): gather the rows' slots and
    attend, causal by absolute position, rows past q_len 0."""
    ragged_paged_attention_plain.calls += 1
    return prefill_attention.attend_paged(
        q, k_cache, v_cache, block_tables, q_pos0, q_lens, page_size=page_size)


ragged_paged_attention_plain.calls = 0


def ragged_paged_attention_q_plain(q, k_cache, v_cache, block_tables, q_pos0,
                                   q_lens, k_scales, v_scales, *, page_size):
    """Plain PyTorch version of K4 over int8 pools: the gathered rows
    dequantized to f32, then the same attention."""
    ragged_paged_attention_q_plain.calls += 1
    return prefill_attention.attend_paged(
        q, k_cache, v_cache, block_tables, q_pos0, q_lens, k_scales, v_scales,
        page_size=page_size)


ragged_paged_attention_q_plain.calls = 0


def ragged_paged_attention_q4_plain(q, k_cache, v_cache, block_tables, q_pos0,
                                    q_lens, k_scales, v_scales, *, page_size):
    """Plain PyTorch version of K4 over nibble-packed int4 pools."""
    ragged_paged_attention_q4_plain.calls += 1
    return prefill_attention.attend_paged(
        q, k_cache, v_cache, block_tables, q_pos0, q_lens, k_scales, v_scales,
        page_size=page_size, int4=True)


ragged_paged_attention_q4_plain.calls = 0


def ragged_paged_attention_q4g_plain(q, k_cache, v_cache, block_tables, q_pos0,
                                     q_lens, k_scales, v_scales, *, page_size):
    """Plain PyTorch version of K4 over int4 pools with scale groups finer
    than head_dim: the rows dequantized to q's dtype, then attended."""
    ragged_paged_attention_q4g_plain.calls += 1
    return prefill_attention.attend_paged(
        q, k_cache, v_cache, block_tables, q_pos0, q_lens, k_scales, v_scales,
        page_size=page_size, int4=True)


ragged_paged_attention_q4g_plain.calls = 0


def ragged_paged_attention(q, k_cache, v_cache, block_tables, q_pos0, q_lens,
                           k_scales=None, v_scales=None, *, page_size, int4=False):
    """q [n, T, H, Hd] (rope applied, unscaled); pools [num_slots, K*Hd]
    (int8 with scale pools [num_pages, K, page_size] f32, nibble-packed
    with `int4=True`); block_tables [n, W], q_pos0 and q_lens [n] int32.
    Row r's queries sit at q_pos0[r] .. q_pos0[r] + q_lens[r] - 1 and
    attend keys at k_pos <= q_pos. Returns [n, T, H, Hd] in q.dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel, or
    raise for what it does not take."""
    quant = k_scales is not None
    _cuda.require(quant or not int4, "int4 KV needs scale pools")
    grouped = int4 and is_grouped(k_scales, num_kv_heads(k_cache, q.shape[-1], int4))
    if q.device.type == "cpu":
        if quant:
            plain = (ragged_paged_attention_q4g_plain if grouped else
                     ragged_paged_attention_q4_plain if int4 else ragged_paged_attention_q_plain)
            return plain(q, k_cache, v_cache, block_tables, q_pos0, q_lens, k_scales,
                         v_scales, page_size=page_size)
        return ragged_paged_attention_plain(q, k_cache, v_cache, block_tables, q_pos0,
                                            q_lens, page_size=page_size)
    out = prefill_attention.launch(q, k_cache, v_cache, block_tables, q_pos0, q_lens,
                                   k_scales, v_scales, page_size=page_size, int4=int4)
    if not quant:
        ragged_paged_attention.launches += 1
    elif grouped:
        ragged_paged_attention.launches_q4g += 1
    elif int4:
        ragged_paged_attention.launches_q4 += 1
    else:
        ragged_paged_attention.launches_q += 1
    return out


ragged_paged_attention.launches = 0     # K4 over bf16 pools (K2's kernel)
ragged_paged_attention.launches_q = 0   # K4 over int8 pools (K6's kernel)
ragged_paged_attention.launches_q4 = 0  # K4 over int4 pools (K6's int4 form)
ragged_paged_attention.launches_q4g = 0  # K4 over grouped int4 pools (K6's grouped form)


def _launch(q, new_k, new_v, k_cache, v_cache, block_tables, lengths,
            write_pos, page_size, k_scales, v_scales, new_ks, new_vs, int4):
    req = _cuda.require
    req(q.device.type == "cuda", f"unsupported device {q.device}")
    quant = k_scales is not None
    b, h, hd = q.shape
    num_slots, kw = k_cache.shape
    req(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    kwf = 2 * kw if int4 else kw  # the row's features
    req(kwf % hd == 0, "pool width must be K * head_dim (K * head_dim / 2 for int4)")
    kh = kwf // hd
    req(h % kh == 0 and h // kh <= MAX_GROUP, f"unsupported GQA group {h}/{kh}")
    req(num_slots % page_size == 0, "pool rows must be whole pages")
    req(v_cache.shape == k_cache.shape, "k/v pools differ in shape")
    req(block_tables.dim() == 2 and block_tables.shape[0] == b, "block_tables must be [B, W]")
    req(lengths.shape == (b,) and write_pos.shape == (b,), "lengths/write_pos must be [B]")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    tensors = [q, k_cache, v_cache, block_tables, lengths, write_pos]
    if new_k is not None:
        req(new_k.shape == (b, kw) and new_v.shape == (b, kw),
            f"new rows must be [B, {kw}], as wide as the pools")
        tensors += [new_k, new_v]
        for x in (new_k, new_v):
            req(x.dtype == pool_dtype, f"new rows must be {pool_dtype}")
    req(q.dtype == torch.bfloat16, "q must be bfloat16")
    for x in (k_cache, v_cache):
        req(x.dtype == pool_dtype, f"pools must be {pool_dtype}")
    s_ch = kh
    if quant:
        req(v_scales is not None, "quantized KV needs both scale pools")
        s_ch = k_scales.shape[1]
        req(s_ch == kh or int4, "int8 KV takes one scale a kv head")
        group = kh * hd // s_ch
        req(s_ch % kh == 0 and (s_ch == kh or (MIN_GROUP <= group < hd
                                                and group & (group - 1) == 0)),
            f"{s_ch} scale channels over {kh} kv heads: groups of a power of two of "
            f"{MIN_GROUP} to {hd // 2} features, or one a kv head")
        req(k_scales.shape == (num_slots // page_size, s_ch, page_size)
            and v_scales.shape == k_scales.shape,
            f"scale pools must be [{num_slots // page_size}, {s_ch}, {page_size}]")
        tensors += [k_scales, v_scales]
        scales = [k_scales, v_scales]
        if new_k is not None:
            req(new_ks is not None and new_vs is not None, "quantized rows need their scales")
            req(new_ks.shape == (b, s_ch) and new_vs.shape == (b, s_ch),
                f"new scales must be [B, {s_ch}]")
            tensors += [new_ks, new_vs]
            scales += [new_ks, new_vs]
        for x in scales:
            req(x.dtype == torch.float32, "scales must be float32")
    for x in (block_tables, lengths, write_pos):
        req(x.dtype == torch.int32, "tables, lengths and write_pos must be int32")
    for x in tensors:
        req(x.device == q.device, "all tensors must be on one device")
        req(x.is_contiguous(), "tensors must be contiguous")

    def ptr(x):
        return x.data_ptr() if x is not None else None

    out = torch.empty_like(q)
    lib = _launcher()
    w = block_tables.shape[1]
    chunk, splits = split_plan(b, kh, w, page_size, _cuda.sm_count(q.device))
    part = tickets = None
    if splits > 1:
        part, tickets = _cuda.scratch(
            "decode_attention", q.device, b * kh * splits * (2 * MAX_GROUP + (h // kh) * hd),
            torch.float32, b * kh)
    tail = (ptr(block_tables), ptr(lengths), ptr(write_pos), ptr(out),
            b, h, kh, hd, w, page_size, hd ** -0.5,
            _cuda.stream_ptr(q.device), ptr(part), ptr(tickets), chunk)
    if s_ch != kh:
        err = lib.fused_decode_q4g_launch(
            ptr(q), ptr(new_k), ptr(new_v), ptr(k_cache), ptr(v_cache),
            ptr(new_ks), ptr(new_vs), ptr(k_scales), ptr(v_scales), *tail, kh * hd // s_ch,
        )
        _cuda.check(err, f"fused_paged_decode_attention (int4, {s_ch // kh} groups)")
        fused_paged_decode_attention.launches_q4g += 1
        return out
    if quant:
        launch = lib.fused_decode_q4_launch if int4 else lib.fused_decode_q_launch
        err = launch(
            ptr(q), ptr(new_k), ptr(new_v), ptr(k_cache), ptr(v_cache),
            ptr(new_ks), ptr(new_vs), ptr(k_scales), ptr(v_scales), *tail,
        )
        _cuda.check(err, f"fused_paged_decode_attention ({'int4' if int4 else 'int8'})")
        if int4:
            fused_paged_decode_attention.launches_q4 += 1
        else:
            fused_paged_decode_attention.launches_q += 1
        return out
    err = lib.fused_decode_launch(
        ptr(q), ptr(new_k), ptr(new_v), ptr(k_cache), ptr(v_cache), *tail,
    )
    _cuda.check(err, "fused_paged_decode_attention")
    fused_paged_decode_attention.launches += 1
    return out


fused_paged_decode_attention.launches = 0    # K3 (bf16 pools)
fused_paged_decode_attention.launches_q = 0  # K5 (int8 pools + scale pools)
fused_paged_decode_attention.launches_q4 = 0  # K5, int4 form (nibble-packed pools)
fused_paged_decode_attention.launches_q4g = 0  # K5, grouped int4 (K * groups scale channels)


def _launcher():
    lib = _cuda.load("decode_attention")
    fn = lib.fused_decode_launch
    if fn.argtypes is None:
        split = [ctypes.c_void_p] * 2 + [ctypes.c_int]  # scratch, tickets, chunk
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p] + split
        )
        fn.restype = ctypes.c_int
        fq = lib.fused_decode_q_launch
        fq.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p] + split
        )
        fq.restype = ctypes.c_int
        f4 = lib.fused_decode_q4_launch
        f4.argtypes = fq.argtypes
        f4.restype = ctypes.c_int
        fg = lib.fused_decode_q4g_launch
        fg.argtypes = fq.argtypes + [ctypes.c_int]  # the group's features
        fg.restype = ctypes.c_int
    return lib
