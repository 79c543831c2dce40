"""W8A8 int8 weights, and the int8 and int4 KV cache: the quantization
schemes and the scale-pool helpers.

Weights (M10; `QUANT_KEYS`, `is_quantized`, `quantize_weight`,
`quant_matmul`, `mm`, `logical_param_count`, `quantize_params` of
`dynamo_tpu/ops/quant.py`): each dense projection becomes the leaf
{"q": int8 codes, "s": f32 [out]}, symmetric per output channel with
s = amax / 127 (1.0 for an all-zero column) and q = clip(round(w / s),
-127, 127). The codes are stored [out, in], K-contiguous: the transpose of
the JAX package's [in, out], because the GEMM's s8 B operand is K-major on
the tensor cores. `quantize_weight` and `params_from_jax` own that
transpose; the values are the JAX package's, byte for byte. Activations
are quantized per row at run time the same way (ops/w8a8.py
`quantize_rows`), the dot is s8 x s8 -> s32 (`w8a8_gemm`) and the output
(f32(acc) * xs) * ws, cast once to the activation dtype (f32 for the
vocab head). `quantize_act` quantizes an input once for every projection
that reads it (wq/wk/wv, w_gate/w_up), as XLA's CSE does in the reference;
`rms_norm_quantize_act` and `silu_mul_quantize_act` do so for the outputs
of the layer's norms and of SiLU x up in the kernel that computes them.

KV (`quantize_kv_rows`,
`dequantize_kv_rows`, `int4_scale_channels`, `quantize_kv_rows_int4`,
`unpack_int4_kv`, `dequantize_kv_rows_int4`, the scale-pool helpers and
`scales_to_page_tiles`). int8 rows are quantized symmetrically per token
row and kv head: scale = amax / 127 (1.0 for an all-zero head), q =
clip(round(x / scale), -127, 127). int4 rows use scale = amax / 7 per
group of `group_size` features (default head_dim: one scale per token and
kv head; finer groups give each kv head head_dim / group_size scales, S =
K * groups channels a row, which the kernels' grouped int4 forms read) and
q = clip(round(x / scale), -7, 7), two codes a byte. `torch.round` rounds half to even like
`jnp.round`, and the divisions are true divisions as in the reference, so
rows and scales are byte-equal to the JAX package's (the scales divide
through `w8a8.true_div`: on CUDA PyTorch divides by a Python scalar as a
product with its reciprocal).

int4 packing is planar per kv head: a head's Hd features become Hd/2
bytes, byte j holding feature j in its low nibble and feature j + Hd/2 in
its high nibble (not adjacent pairs). A low nibble sign-extends as
((b & 15) ^ 8) - 8, a high one as the arithmetic shift b >> 4 of the
signed byte.

Scale pools are per layer [num_pages, S, page_size] f32 (S = K, or K *
groups for grouped int4), initialised to 1.0: the JAX layout [num_pages,
SUBL, page_size] without its sublane padding rows (`jax_pool[:,
_scale_rows(S, 1), :]` is this pool). A page's scales are one contiguous
S * page_size * 4-byte tile, channel-major (kv head, then group), so the
page-scatter write copies it beside the page and the attention kernels
read one channel's scales for consecutive tokens contiguously.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dynamo_tpu_torch.ops.w8a8 import (
    quantize_rows,
    rms_norm_quantize_rows,
    silu_mul_quantize_rows,
    true_div,
    w8a8_gemm,
)

# per-layer weight names eligible for quantization (dense Llama family)
# MoE experts and the router stay unquantized, as in the reference: 3-D
# batched weights, and routing is accuracy-critical
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def is_quantized(leaf: Any) -> bool:
    """A quantized-weight leaf is the exact dict {"q", "s"}."""
    return isinstance(leaf, dict) and len(leaf) == 2 and "q" in leaf and "s" in leaf


def quantize_weight(w: torch.Tensor) -> dict:
    """[in, out] float -> {"q": int8 [out, in] (K-contiguous), "s": f32 [out]}:
    the JAX package's codes transposed, and its scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax > 0, true_div(amax, 127.0), 1.0)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return {"q": q.T.contiguous(), "s": scale}


class QuantizedAct(NamedTuple):
    """An activation quantized once for the projections that read it:
    codes [M, K], scales [M], and the input's leading shape and dtype."""

    q: torch.Tensor
    s: torch.Tensor
    lead: tuple
    dtype: torch.dtype


def _act(x: torch.Tensor, codes) -> QuantizedAct:
    return QuantizedAct(*codes, tuple(x.shape[:-1]), x.dtype)


def quantize_act(x: torch.Tensor) -> QuantizedAct:
    return _act(x, quantize_rows(x.reshape(-1, x.shape[-1])))


def rms_norm_quantize_act(x: torch.Tensor, weight, eps: float,
                          weight_offset: float = 0.0) -> QuantizedAct:
    """`rms_norm(x, ...)` quantized for the projections that read it."""
    return _act(x, rms_norm_quantize_rows(x.reshape(-1, x.shape[-1]), weight, eps,
                                          weight_offset))


def silu_mul_quantize_act(gate: torch.Tensor, up: torch.Tensor) -> QuantizedAct:
    """`F.silu(gate) * up` quantized for the projection that reads it."""
    k = gate.shape[-1]
    return _act(gate, silu_mul_quantize_rows(gate.reshape(-1, k), up.reshape(-1, k)))


def quant_matmul(x, w: dict, out_dtype=None) -> torch.Tensor:
    """x [..., in] (bf16/f32, or a `QuantizedAct`) @ quantized w -> [..., out]
    in x's dtype (or `out_dtype`; the dequant itself is f32)."""
    xa = x if isinstance(x, QuantizedAct) else quantize_act(x)
    out = w8a8_gemm(xa.q, xa.s, w["q"], w["s"], out_dtype or xa.dtype)
    return out.reshape(*xa.lead, out.shape[-1])


def prepare_act(x, w):
    """x as `mm` should take it for weight `w`: quantized once when `w` is
    and x is not yet (the caller passes the result to every projection of
    x)."""
    return quantize_act(x) if is_quantized(w) and not isinstance(x, QuantizedAct) else x


def mm(x, w) -> torch.Tensor:
    """The model's matmul: quantized or plain depending on the leaf."""
    if is_quantized(w):
        return quant_matmul(x, w)
    if isinstance(x, QuantizedAct):
        raise TypeError("a quantized activation meets an unquantized weight")
    return x @ w


def _layer_count(lp: dict) -> int:
    return sum(int(v["q"].numel()) if is_quantized(v) else int(v.numel()) for v in lp.values())


def logical_param_count(params: dict, cfg) -> int:
    """Model parameter count on a quantized OR plain tree: scales are
    bookkeeping, a tied-embedding int8 head is a duplicate, int8 weights
    count by element like their bf16 originals."""
    total = 0
    for key, sub in params.items():
        if key == "lm_head" and cfg.tie_word_embeddings and is_quantized(sub):
            continue
        if key == "layers":
            total += sum(_layer_count(lp) for lp in sub)
        else:
            total += int(sub["q"].numel()) if is_quantized(sub) else int(sub.numel())
    return total


def quantize_layer(lp: dict) -> dict:
    return {k: (quantize_weight(v) if k in QUANT_KEYS else v) for k, v in lp.items()}


def quantize_params(params: dict, cfg, mode: str = "int8", inplace: bool = False) -> dict:
    """Quantize a llama.init_params-shaped tree in place of the dense
    projection weights; adds an int8 "lm_head" (from embed.T when tied).
    Norms, biases, embeddings, MoE experts and the router stay as they
    are. `inplace=True` replaces
    each layer of `params["layers"]` (and an untied head) as it goes, so a
    bf16 layer can be freed as soon as its codes exist; the returned tree
    is then `params` itself."""
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}; expected 'int8'")
    new = params if inplace else dict(params)
    layers = params["layers"] if inplace else list(params["layers"])
    for i, lp in enumerate(layers):
        layers[i] = quantize_layer(lp)
    new["layers"] = layers
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    new["lm_head"] = quantize_weight(head)
    return new


def quantize_kv_rows(rows: torch.Tensor, num_kv_heads: int):
    """KV rows [..., K*Hd] float -> (int8 [..., K*Hd], scales f32 [..., K])."""
    shape = rows.shape
    hd = shape[-1] // num_kv_heads
    rf = rows.float().reshape(*shape[:-1], num_kv_heads, hd)
    amax = rf.abs().amax(dim=-1)
    scales = torch.where(amax > 0, true_div(amax, 127.0), 1.0)
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
    scales = torch.where(amax > 0, true_div(amax, 7.0), 1.0)
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


def int4_group_size(scale_channels: int, num_kv_heads: int, head_dim: int) -> int:
    """The features a scale covers in an int4 pool of `scale_channels`
    channels a row (head_dim for one scale group per kv head)."""
    if scale_channels % num_kv_heads:
        raise ValueError(f"{scale_channels} scale channels are not whole groups of "
                         f"{num_kv_heads} kv heads")
    return head_dim * num_kv_heads // scale_channels


def init_kv_scale_pool(num_pages: int, page_size: int, channels: int, *,
                       device) -> torch.Tensor:
    """[num_pages, channels, page_size] f32 of 1.0: `channels` is K, or K *
    groups for grouped int4."""
    return torch.ones((num_pages, channels, page_size), dtype=torch.float32,
                      device=device)


def scatter_kv_scales(pool: torch.Tensor, slots: torch.Tensor, scales: torch.Tensor):
    """Write dense per-row scales [M, S] at flat slot ids [M], in place."""
    s = pool.shape[2]
    sl = slots.long()
    heads = torch.arange(pool.shape[1], device=pool.device)
    pool[(sl // s)[:, None], heads[None, :], (sl % s)[:, None]] = scales.float()
    return pool


def gather_kv_scales(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[M, S] dense scales of the given flat slot ids."""
    s = pool.shape[2]
    sl = slots.long()
    heads = torch.arange(pool.shape[1], device=pool.device)
    return pool[(sl // s)[:, None], heads[None, :], (sl % s)[:, None]]


def scales_to_page_tiles(dense: torch.Tensor, page_size: int) -> torch.Tensor:
    """Dense per-row scales [N*page_size, S] -> page tiles [N, S, page_size],
    the source format of the page-scatter write's scale copy."""
    n = dense.shape[0] // page_size
    return dense.reshape(n, page_size, dense.shape[1]).transpose(1, 2).contiguous()
