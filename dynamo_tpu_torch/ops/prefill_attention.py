"""K2 and K6: causal chunked-prefill flash attention over the paged KV pool.

Port of `dynamo_tpu/ops/pallas_prefill.py::flash_prefill_attention`, its
bf16 branch (K2) and its int8 and int4 branches (K6); the CUDA kernels are
in `csrc/prefill_attention.cu`. Row b's queries sit at positions `pos0[b] ..
pos0[b] + t_valid[b] - 1` (pos0 need not be page-aligned) and attend keys
with `k_pos <= q_pos` through the row's block table. Rows at or past
`t_valid` are 0. q arrives with rope applied and unscaled; `hd**-0.5` is
applied here. With scale pools (int8 KV, ops/quant.py layout) the pools
are int8: the K scale multiplies the scores and the V scale the
probabilities, in f32, as in the reference. With `int4=True` the int8
pools are nibble-packed (K*Hd/2 bytes a row, ops/quant.py planar layout):
the pool's width no longer tells the number of kv heads, hence the flag,
as in the reference. With int4 scale groups finer than head_dim (scale
pools of S = K * groups channels) a scale varies across a head's features,
so it cannot be folded into the score or the probability: the grouped int4
form computes what the reference's gather path computes there
(`dynamo_tpu/ops/attention.py` `paged_attention`): each code times its
group's scale in f32, rounded to q's dtype, then attention over those rows.

The plain versions compute in f32 throughout. The kernel runs both
products on the tensor cores: bf16 operands that are exact for q, bf16 K
and V rows and the int8/int4 codes, f32 sums, the scales applied in f32,
and the probabilities (times the V scale) fed to P.V as two bf16 terms,
so it stays within one bf16 ulp of the plain version per element
(tests/test_torch_prefill_attention.py pins that arithmetic on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _cuda
from dynamo_tpu_torch.ops.attention import slots_from_pages
from dynamo_tpu_torch.ops.quant import (
    dequantize_kv_rows,
    dequantize_kv_rows_int4,
    gather_kv_scales,
)

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 64


def _attend(q, k, v, pos0, t_valid):
    """Causal attention of q [B, T, H, Hd] over gathered f32 KV
    [B, C, K, Hd], masked by absolute position and by t_valid, softmax in
    f32."""
    b, t, h, hd = q.shape
    c, kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, t, kh, h // kh, hd) * hd ** -0.5
    s = torch.einsum("btkgd,bckd->bkgtc", qf, k)
    tt = torch.arange(t, device=q.device)
    q_pos = pos0.long()[:, None] + tt[None, :]                         # [B, T]
    k_pos = torch.arange(c, device=q.device)
    valid = (k_pos[None, None, :] <= q_pos[:, :, None]) & (
        tt[None, :, None] < t_valid.long()[:, None, None]
    )                                                                  # [B, T, C]
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, -0.7 * torch.finfo(torch.float32).max))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgtc,bckd->btkgd", p / denom, v)
    return out.reshape(b, t, h, hd).to(q.dtype)


def num_kv_heads(k_cache, hd: int, int4: bool) -> int:
    """K of a pool [slots, K*Hd] (K*Hd/2 nibble-packed with `int4`)."""
    return (2 if int4 else 1) * k_cache.shape[1] // hd


def is_grouped(k_scales, kh: int) -> bool:
    """Scale pools of more than one channel a kv head: int4 with scale
    groups finer than head_dim."""
    return k_scales is not None and k_scales.shape[1] != kh


def dequantize_gathered(rows, scales, kh: int, int4: bool, dtype):
    """Gathered pool rows and their dense scales [M, S] as f32 [M, K*Hd]:
    int8 and one-group int4 dequantized in f32 (what K5/K6 fold into the
    scores and probabilities); grouped int4 rounded to `dtype` (the working
    type) after the f32 product, as the reference's gather path does."""
    if not int4:
        return dequantize_kv_rows(rows, scales)
    if scales.shape[-1] == kh:
        return dequantize_kv_rows_int4(rows, scales, kh)
    return dequantize_kv_rows_int4(rows, scales, kh, out_dtype=dtype).float()


def attend_paged(q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales=None,
                 v_scales=None, *, page_size, int4=False):
    """The plain computation behind K2/K6 (and the ragged read K4): gather
    the rows' slots (dequantized with scale pools, `dequantize_gathered`)
    and attend."""
    b, _, _, hd = q.shape
    flat = slots_from_pages(block_tables, page_size).long().reshape(-1)
    c = flat.shape[0] // b
    kh = num_kv_heads(k_cache, hd, int4)
    if k_scales is None:
        k, v = k_cache[flat].float(), v_cache[flat].float()
    else:
        k = dequantize_gathered(k_cache[flat], gather_kv_scales(k_scales, flat), kh, int4,
                                q.dtype)
        v = dequantize_gathered(v_cache[flat], gather_kv_scales(v_scales, flat), kh, int4,
                                q.dtype)
    return _attend(q, k.reshape(b, c, kh, hd), v.reshape(b, c, kh, hd), pos0, t_valid)


def flash_prefill_attention_plain(
    q, k_cache, v_cache, block_tables, pos0, t_valid, *, page_size
):
    """Plain PyTorch version of K2: gather the rows' slots and attend."""
    flash_prefill_attention_plain.calls += 1
    return attend_paged(q, k_cache, v_cache, block_tables, pos0, t_valid,
                        page_size=page_size)


flash_prefill_attention_plain.calls = 0


def flash_prefill_attention_q_plain(
    q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales, v_scales, *,
    page_size,
):
    """Plain PyTorch version of K6 (int8): gather the rows' slots,
    dequantize them to f32 and attend as K2's plain version does."""
    flash_prefill_attention_q_plain.calls += 1
    return attend_paged(q, k_cache, v_cache, block_tables, pos0, t_valid,
                        k_scales, v_scales, page_size=page_size)


flash_prefill_attention_q_plain.calls = 0


def flash_prefill_attention_q4_plain(
    q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales, v_scales, *,
    page_size,
):
    """Plain PyTorch version of K6's int4 form: the same over nibble-packed
    rows, unpacked and dequantized to f32."""
    flash_prefill_attention_q4_plain.calls += 1
    return attend_paged(q, k_cache, v_cache, block_tables, pos0, t_valid,
                        k_scales, v_scales, page_size=page_size, int4=True)


flash_prefill_attention_q4_plain.calls = 0


def flash_prefill_attention_q4g_plain(
    q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales, v_scales, *,
    page_size,
):
    """Plain PyTorch version of K6's grouped int4 form: nibble-packed rows
    times their groups' scales, rounded to q's dtype, then attended."""
    flash_prefill_attention_q4g_plain.calls += 1
    return attend_paged(q, k_cache, v_cache, block_tables, pos0, t_valid,
                        k_scales, v_scales, page_size=page_size, int4=True)


flash_prefill_attention_q4g_plain.calls = 0


def _plain_q(int4, grouped):
    if grouped:
        return flash_prefill_attention_q4g_plain
    return flash_prefill_attention_q4_plain if int4 else flash_prefill_attention_q_plain


def flash_prefill_attention(
    q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales=None,
    v_scales=None, *, page_size, int4=False
):
    """q [B, T, H, Hd] (rope applied, unscaled); pools [num_slots, K*Hd];
    block_tables [B, W], pos0 and t_valid [B] int32; with scale pools
    `k_scales`/`v_scales` [num_pages, K, page_size] f32 the pools are int8,
    [num_slots, K*Hd/2] nibble-packed with `int4=True`, whose scale pools
    may carry K * groups channels (the grouped form). Returns
    [B, T, H, Hd] in q.dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 q, head_dim in {32, 64, 128})."""
    quant = k_scales is not None
    _cuda.require(quant or not int4, "int4 KV needs scale pools")
    grouped = int4 and is_grouped(k_scales, num_kv_heads(k_cache, q.shape[-1], int4))
    if q.device.type == "cpu":
        if quant:
            plain = _plain_q(int4, grouped)
            return plain(
                q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales,
                v_scales, page_size=page_size,
            )
        return flash_prefill_attention_plain(
            q, k_cache, v_cache, block_tables, pos0, t_valid, page_size=page_size
        )
    out = launch(q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales,
                 v_scales, page_size=page_size, int4=int4)
    if not quant:
        flash_prefill_attention.launches += 1
    elif grouped:
        flash_prefill_attention.launches_q4g += 1
    elif int4:
        flash_prefill_attention.launches_q4 += 1
    else:
        flash_prefill_attention.launches_q += 1
    return out


flash_prefill_attention.launches = 0    # K2 (bf16 pools)
flash_prefill_attention.launches_q = 0  # K6 (int8 pools + scale pools)
flash_prefill_attention.launches_q4 = 0  # K6, int4 form (nibble-packed pools)
flash_prefill_attention.launches_q4g = 0  # K6, grouped int4 (K * groups scale channels)

# scale groups the grouped forms take: at least 8 features (a kernel stages
# at most head_dim / 8 scales a key), a power of two below head_dim
MIN_GROUP = 8


def launch(q, k_cache, v_cache, block_tables, pos0, t_valid, k_scales=None,
           v_scales=None, *, page_size, int4=False):
    """Check the shapes and launch the CUDA kernel (K2, or K6 with scale
    pools); counts nothing: each wrapper that launches it counts its own
    launches. Raises for anything the kernel does not take."""
    quant = k_scales is not None
    req = _cuda.require
    req(q.device.type == "cuda", f"unsupported device {q.device}")
    b, t, h, hd = q.shape
    num_slots, kw = k_cache.shape
    req(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    kwf = 2 * kw if int4 else kw  # the row's features
    req(kwf % hd == 0, "pool width must be K * head_dim (K * head_dim / 2 for int4)")
    kh = kwf // hd
    req(h % kh == 0 and h // kh <= MAX_GROUP, f"unsupported GQA group {h}/{kh}")
    req(num_slots % page_size == 0, "pool rows must be whole pages")
    req(v_cache.shape == k_cache.shape, "k/v pools differ in shape")
    req(block_tables.dim() == 2 and block_tables.shape[0] == b, "block_tables must be [B, W]")
    req(pos0.shape == (b,) and t_valid.shape == (b,), "pos0/t_valid must be [B]")
    req(q.dtype == torch.bfloat16, "q must be bfloat16")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    for x in (k_cache, v_cache):
        req(x.dtype == pool_dtype, f"pools must be {pool_dtype}")
    tensors = [q, k_cache, v_cache, block_tables, pos0, t_valid]
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
        for x in (k_scales, v_scales):
            req(x.dtype == torch.float32, "scale pools must be float32")
        tensors += [k_scales, v_scales]
    for x in (block_tables, pos0, t_valid):
        req(x.dtype == torch.int32, "tables and positions must be int32")
    for x in tensors:
        req(x.device == q.device, "all tensors must be on one device")
        req(x.is_contiguous(), "tensors must be contiguous")
    for x in (k_cache, v_cache):
        req(x.data_ptr() % 16 == 0, "pools must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _launcher()
    tail = (block_tables.data_ptr(), pos0.data_ptr(), t_valid.data_ptr(),
            out.data_ptr(), b, t, h, kh, hd, block_tables.shape[1], page_size,
            hd ** -0.5, _cuda.stream_ptr(q.device))
    if s_ch != kh:
        err = lib.flash_prefill_q4g_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), *tail, kh * hd // s_ch,
        )
        _cuda.check(err, f"flash_prefill_attention (int4, {s_ch // kh} groups)")
        return out
    if quant:
        fn = lib.flash_prefill_q4_launch if int4 else lib.flash_prefill_q_launch
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), *tail,
        )
        _cuda.check(err, f"flash_prefill_attention ({'int4' if int4 else 'int8'})")
        return out
    err = lib.flash_prefill_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *tail,
    )
    _cuda.check(err, "flash_prefill_attention")
    return out


def _launcher():
    lib = _cuda.load("prefill_attention")
    fn = lib.flash_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        fq = lib.flash_prefill_q_launch
        fq.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fq.restype = ctypes.c_int
        f4 = lib.flash_prefill_q4_launch
        f4.argtypes = fq.argtypes
        f4.restype = ctypes.c_int
        fg = lib.flash_prefill_q4g_launch
        fg.argtypes = fq.argtypes + [ctypes.c_int]  # the group's features
        fg.restype = ctypes.c_int
    return lib
