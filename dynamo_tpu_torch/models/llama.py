"""Llama-family forward over a paged KV cache, in PyTorch.

Port of `dynamo_tpu/models/llama.py`: the dense family and the sparse-MoE
one (models/moe.py, whose router reads each step's genuine-token mask,
`genuine_tokens`). One `forward()` serves chunked prefill and decode. Parameters are a plain dict of tensors (a
per-layer list under "layers") at the JAX package's layout: linear weights
are [in_features, out_features] so matmuls are `x @ w`, and KV pools are
per-layer [num_slots, K*Hd] tensors updated in place. With W8A8 weights
(`init_params(quantize=True)`, ops/quant.py `quantize_params`) each dense
projection and the vocab head is a {"q", "s"} leaf, and every projection
goes through `mm`: its input is quantized once per row and multiplied by
the int8 GEMM (`w8a8_gemm`). The two norms of a layer and, in a SiLU
model, SiLU x up are computed by the kernel that quantizes them
(ops/w8a8.py `rms_norm_quantize_rows`, `silu_mul_quantize_rows`); the
attention output and the head's input go through `quantize_rows`.

Attention goes through one of the three `AttnSpec` modes below; each runs
the hand-written kernels on a GPU (page-scatter write + flash prefill for
prefill chunks, fused write + decode attention for decode steps, row write
+ the ragged read for mixed and verify steps) and their plain versions on
the CPU. With int8 or int4 KV
(`init_kv_cache(kv_quant="int8" | "int4")`) the fresh rows are quantized
before they reach the pools, as in the reference, and the kernels' int8 or
int4 forms read them with their scales.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.moe import init_moe_params, moe_block
from dynamo_tpu_torch.ops.attention import write_kv_rows
from dynamo_tpu_torch.ops.decode_attention import (
    fused_paged_decode_attention,
    ragged_paged_attention,
)
from dynamo_tpu_torch.ops.kv_write import paged_kv_write
from dynamo_tpu_torch.ops.norm import rms_norm
from dynamo_tpu_torch.ops.prefill_attention import flash_prefill_attention
from dynamo_tpu_torch.ops.quant import (
    QuantizedAct,
    init_kv_scale_pool,
    int4_scale_channels,
    is_quantized,
    logical_param_count,
    mm,
    prepare_act,
    quant_matmul,
    quantize_kv_rows,
    quantize_kv_rows_int4,
    quantize_layer,
    quantize_weight,
    rms_norm_quantize_act,
    scales_to_page_tiles,
    silu_mul_quantize_act,
)
from dynamo_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq

Params = dict[str, Any]


class AttnSpec:
    """How a step writes the paged KV pool and attends over it:

    - page-write prefill (`page_write`): `write_tables` [n_pages] page ids
      -> the chunk's whole pages go through the page-scatter kernel (K1,
      or K7 for int8 and int4), then `block_tables` [B, W], `q_pos0` [B]
      and `lengths` [B] (valid chunk rows) drive the flash prefill kernel
      (K2, or K6) over them.
    - paged decode (`paged_decode`, T == 1): `block_tables` + `lengths`
      (attended KV count) + `write_pos` [B] (-1 = skip) -> the fused
      write + decode attention kernel (K3, or K5).
    - ragged (`ragged`, mixed prefill+decode and speculative verify
      steps): `write_slots` [B*T] flat slot per (row, column) (0 = the
      trash page) -> the row write (ops/attention.write_kv_rows; decode
      and verify rows land mid-page), then `block_tables` [B, W],
      `q_pos0` [B] and `lengths` [B] (each row's query count) drive the
      ragged paged-attention read (K4).
    """

    def __init__(self, block_tables, lengths, page_size: int, write_pos=None,
                 write_tables=None, q_pos0=None, write_slots=None):
        self.block_tables = block_tables
        self.lengths = lengths
        self.page_size = page_size
        self.write_pos = write_pos
        self.write_tables = write_tables
        self.q_pos0 = q_pos0
        self.write_slots = write_slots

    @classmethod
    def page_write(cls, write_tables, block_tables, q_pos0, lengths, page_size):
        """Counterpart of the JAX package's `AttnSpec.gather(None,
        write_tables=..., block_tables=..., q_pos0=...)` flash prefill."""
        return cls(block_tables=block_tables, lengths=lengths, page_size=page_size,
                   write_tables=write_tables, q_pos0=q_pos0)

    @classmethod
    def paged_decode(cls, block_tables, lengths, page_size, write_pos):
        """Counterpart of the JAX package's `AttnSpec.pallas_decode`."""
        return cls(block_tables=block_tables, lengths=lengths,
                   page_size=page_size, write_pos=write_pos)

    @classmethod
    def ragged(cls, block_tables, q_pos0, q_lens, write_slots, page_size):
        """Counterpart of the JAX package's `AttnSpec.gather(None,
        block_tables=..., q_pos0=..., lengths=...)` with row-scattered
        write slots (its mixed and spec-verify steps)."""
        return cls(block_tables=block_tables, lengths=q_lens, page_size=page_size,
                   q_pos0=q_pos0, write_slots=write_slots)


class KVCache(NamedTuple):
    """Per-layer flat slot pools: k/v are length-L tuples of
    [num_slots, K*Hd] tensors, updated in place by every step. A page is
    [page_size, K*Hd] contiguous rows, so the [num_pages, page_size, K*Hd]
    view the kernels take is free. With int8 KV, k/v hold int8 and ks/vs
    the per-token-per-kv-head f32 scale pools [num_pages, K, page_size]
    (ops/quant.py); with int4 KV (`int4` True) k/v are int8 pools of
    nibble-packed rows [num_slots, K*Hd/2] beside scale pools of S = K *
    `groups` channels [num_pages, S, page_size] (groups per kv head: 1,
    or head_dim / kv_quant_group); ks/vs are None with bf16/f32 pools."""

    k: tuple
    v: tuple
    ks: Optional[tuple] = None
    vs: Optional[tuple] = None
    int4: bool = False

    @property
    def quantized(self) -> bool:
        return self.ks is not None


def init_kv_cache(cfg: ModelConfig, num_slots: int, *, device,
                  dtype=torch.bfloat16, kv_quant: Optional[str] = None,
                  page_size: Optional[int] = None,
                  kv_quant_group: Optional[int] = None) -> KVCache:
    """Zeroed pools; `kv_quant="int8"` makes int8 pools plus scale pools of
    1.0 (the scale pools are page-blocked, so `page_size` is required),
    `kv_quant="int4"` int8 pools of half the width (two codes a byte) plus
    scale pools of one channel per group of `kv_quant_group` features of a
    kv head (None: head_dim, one a kv head)."""
    shape = (num_slots, cfg.num_kv_heads * cfg.head_dim)
    n = cfg.num_layers
    if kv_quant is None:
        return KVCache(
            k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)),
            v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)),
        )
    if kv_quant not in ("int8", "int4"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}; expected 'int8' or 'int4'")
    if not page_size or num_slots % page_size:
        raise ValueError(f"{kv_quant} KV needs a page_size that divides num_slots")
    int4 = kv_quant == "int4"
    if int4:
        if shape[1] % 2:
            raise ValueError("int4 KV needs an even K*Hd")
        shape = (num_slots, shape[1] // 2)

    channels = cfg.num_kv_heads
    if int4:
        channels = int4_scale_channels(cfg.num_kv_heads, cfg.head_dim, kv_quant_group)

    def scales():
        return init_kv_scale_pool(num_slots // page_size, page_size, channels,
                                  device=device)

    return KVCache(
        k=tuple(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(n)),
        v=tuple(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(n)),
        ks=tuple(scales() for _ in range(n)),
        vs=tuple(scales() for _ in range(n)),
        int4=int4,
    )


def _attn_block(lp: Params, cfg: ModelConfig, x, cos, sin, kv_k, kv_v,
                attn: AttnSpec, kv_ks=None, kv_vs=None, int4=False):
    b, t = x.lead if isinstance(x, QuantizedAct) else x.shape[:2]
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    quant = kv_ks is not None
    s_ch = kv_ks.shape[1] if quant else kh  # scale channels a row: K, or K * groups

    def quantize(rows):
        if int4:
            return quantize_kv_rows_int4(rows, kh, hd * kh // s_ch)
        return quantize_kv_rows(rows, kh)
    xa = prepare_act(x, lp["wq"])  # quantized once for the three projections
    q = mm(xa, lp["wq"])
    k = mm(xa, lp["wk"])
    v = mm(xa, lp["wv"])
    if cfg.attn_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = apply_rope(q.reshape(b, t, h, hd), cos, sin)
    k = apply_rope(k.reshape(b, t, kh, hd), cos, sin)
    v = v.reshape(b, t, kh, hd)

    if attn.write_slots is not None:
        pools = (kv_ks, kv_vs) if quant else ()
        write_kv_rows(kv_k, kv_v, attn.write_slots, k.reshape(b * t, kh * hd),
                      v.reshape(b * t, kh * hd), *pools, int4=int4, num_kv_heads=kh)
        out = ragged_paged_attention(
            q.contiguous(), kv_k, kv_v, attn.block_tables, attn.q_pos0,
            attn.lengths, *pools, page_size=attn.page_size, int4=int4,
        )
    elif attn.write_pos is not None:
        new_k = k[:, 0].reshape(b, kh * hd).contiguous()
        new_v = v[:, 0].reshape(b, kh * hd).contiguous()
        scales = ()
        if quant:
            # the kernel stores the quantized rows and their scales and
            # attends the new token through them; K and V rows quantize in
            # one call (one set of eager launches on a host-bound step)
            rows, sc = quantize(torch.stack((new_k, new_v)))
            new_k, new_v = rows
            scales = (kv_ks, kv_vs, sc[0], sc[1])
        out = fused_paged_decode_attention(
            q[:, 0].contiguous(), new_k, new_v,
            kv_k, kv_v, attn.block_tables, attn.lengths, attn.write_pos, *scales,
            page_size=attn.page_size, int4=int4,
        )[0][:, None]
    else:
        # whole [page, K*Hd] blocks: rows pad up to whole pages; the tail
        # garbage lands in the sequence's own not-yet-valid positions
        # (masked by position) or in the trash page. int8 and int4 rows
        # are quantized first and padded after (zero codes, packed byte 0
        # for int4) with scale 1.0 (the pool's initial value), as in the
        # reference.
        ps = attn.page_size
        t_pad = -(-t // ps) * ps
        k2 = k.reshape(b, t, kh * hd)
        v2 = v.reshape(b, t, kh * hd)
        if quant:
            (k2, v2), (ks2, vs2) = quantize(torch.stack((k2, v2)))
        if t_pad != t:
            k2 = F.pad(k2, (0, 0, 0, t_pad - t))
            v2 = F.pad(v2, (0, 0, 0, t_pad - t))
            if quant:
                ks2 = F.pad(ks2, (0, 0, 0, t_pad - t), value=1.0)
                vs2 = F.pad(vs2, (0, 0, 0, t_pad - t), value=1.0)
        n_pg = b * (t_pad // ps)
        row_w = k2.shape[-1]  # K*Hd, or K*Hd/2 for packed int4 rows
        scale_pages = pools = ()
        if quant:
            scale_pages = (scales_to_page_tiles(ks2.reshape(b * t_pad, s_ch), ps),
                           scales_to_page_tiles(vs2.reshape(b * t_pad, s_ch), ps))
            pools = (kv_ks, kv_vs)
        paged_kv_write(
            kv_k, kv_v, attn.write_tables,
            k2.reshape(n_pg, ps, row_w).contiguous(),
            v2.reshape(n_pg, ps, row_w).contiguous(),
            *pools, *scale_pages, page_size=ps, int4=int4, groups=s_ch // kh,
        )
        out = flash_prefill_attention(
            q.contiguous(), kv_k, kv_v, attn.block_tables, attn.q_pos0,
            attn.lengths, *pools, page_size=ps, int4=int4,
        )
    return mm(out.reshape(b, t, h * hd), lp["wo"])


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def _mlp_block(lp: Params, x, act: str = "silu"):
    xa = prepare_act(x, lp["w_gate"])  # quantized once for gate and up
    if act == "silu" and is_quantized(lp["w_down"]):
        # SiLU x up computed by the kernel that quantizes it for w_down
        gate = mm(xa, lp["w_gate"])
        return mm(silu_mul_quantize_act(gate, mm(xa, lp["w_up"])), lp["w_down"])
    gate = _ACTIVATIONS[act](mm(xa, lp["w_gate"]))
    return mm(gate * mm(xa, lp["w_up"]), lp["w_down"])


def _norm_in(x, weight, w, cfg: ModelConfig):
    """rms_norm(x) as the projections of weight `w` take it: with W8A8
    weights quantized by the kernel that computes the norm."""
    if is_quantized(w):
        return rms_norm_quantize_act(x, weight, cfg.rms_norm_eps, cfg.norm_weight_offset)
    return rms_norm(x, weight, cfg.rms_norm_eps, weight_offset=cfg.norm_weight_offset)


def layer_step(lp, cfg, x, cos, sin, kv_k, kv_v, attn, kv_ks=None, kv_vs=None,
               int4=False, real_mask=None):
    """One transformer layer (attention + FFN, pre-norm residuals); the
    layer's pools are updated in place. An MoE layer's FFN is
    `moe_block`, whose router reads the plain norm (experts and router
    stay bf16 under W8A8); `real_mask` marks its genuine tokens."""
    attn_in = _norm_in(x, lp["attn_norm"], lp["wq"], cfg)
    x = x + _attn_block(lp, cfg, attn_in, cos, sin, kv_k, kv_v, attn, kv_ks, kv_vs, int4)
    if cfg.num_experts:
        mlp_in = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps,
                          weight_offset=cfg.norm_weight_offset)
        return x + moe_block(lp, cfg, mlp_in, real_mask)
    mlp_in = _norm_in(x, lp["mlp_norm"], lp["w_gate"], cfg)
    return x + _mlp_block(lp, mlp_in, act=cfg.hidden_act)


def genuine_tokens(attn: AttnSpec, b: int, t: int) -> torch.Tensor:
    """[B, T] bool: the step's real tokens, the rows that take MoE
    capacity. Paged decode marks idle rows by write_pos -1, the ragged
    write sends padding to slot 0 (the trash page), and a page-write
    prefill's valid rows are the first `lengths` of each row: the rows
    whose write slots the reference sets non-zero."""
    if attn.write_pos is not None:
        return (attn.write_pos >= 0)[:, None].expand(b, t)
    if attn.write_slots is not None:
        return attn.write_slots.reshape(b, t) != 0
    cols = torch.arange(t, device=attn.lengths.device)
    return cols[None, :] < attn.lengths[:, None]


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B, T] int
    positions: torch.Tensor,    # [B, T] int absolute positions
    kv: KVCache,
    attn: AttnSpec,
    inv_freq: torch.Tensor | None = None,  # rope_inv_freq(cfg) on x's device
    embeds: torch.Tensor | None = None,       # [B, T, D] multimodal injections
    embeds_mask: torch.Tensor | None = None,  # [B, T] bool: take the embeds row
) -> tuple[torch.Tensor, KVCache]:
    """One model step. Returns (hidden [B, T, D] after the final norm, kv);
    the pools in `kv` are updated in place. Logits come from `logits()` on
    the (usually sliced) hidden states. Callers that step repeatedly pass
    `inv_freq` already on the device: uploading it from the host on every
    step would make the host wait for the device each time. With `embeds`,
    the positions `embeds_mask` marks take those rows (cast to x's dtype)
    in place of the token lookups, after any embedding scale: the
    LLaVA-style injection of image patches, as in the reference."""
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        # gemma: embedding outputs scaled by sqrt(d), rounded to x's dtype
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    if embeds is not None:
        x = torch.where(embeds_mask[..., None], embeds.to(x.dtype), x)
    if inv_freq is None:
        inv_freq = torch.from_numpy(rope_inv_freq(cfg)).to(x.device)
    cos, sin = rope_cos_sin(inv_freq, positions)  # [B, T, Hd]
    real_mask = genuine_tokens(attn, *tokens.shape) if cfg.num_experts else None
    for l, lp in enumerate(params["layers"]):
        scales = (kv.ks[l], kv.vs[l]) if kv.quantized else ()
        x = layer_step(lp, cfg, x, cos, sin, kv.k[l], kv.v[l], attn, *scales, int4=kv.int4,
                       real_mask=real_mask)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps,
                 weight_offset=cfg.norm_weight_offset)
    return x, kv


def logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Vocab projection [..., D] -> [..., V] in float32. A quantized
    "lm_head" (ops/quant.py adds one even for tied embeddings; the table
    stays for the gather) runs the W8A8 GEMM with f32 output."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if is_quantized(head):
        return quant_matmul(hidden, head, out_dtype=torch.float32)
    return (hidden @ head).float()


def init_params(cfg: ModelConfig, seed: int, *, device,
                dtype=torch.bfloat16, quantize: bool = False) -> Params:
    """Random-init params from an explicit seed (tests, benchmarks): normal
    weights scaled by fan_in**-0.5, embeddings by 0.02, unit norms — the
    JAX package's scheme, with torch's generator (so other values).

    `quantize=True` quantizes each layer's dense projections to int8 as
    they are made (ops/quant.py scheme, the same result as
    `quantize_params` on the full tree, with the same draws): the device
    holds the codes so far and one dense layer, never a whole dense tree.
    An MoE layer draws its router and experts (models/moe.py
    `init_moe_params`) in place of the dense FFN; they stay unquantized."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size
    qs, kvs = cfg.q_size, cfg.kv_size

    def dense(shape, scale=None):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(scale or shape[0] ** -0.5).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        lp = {
            "attn_norm": ones(d),
            "wq": dense((d, qs)),
            "wk": dense((d, kvs)),
            "wv": dense((d, kvs)),
            "wo": dense((qs, d)),
            "mlp_norm": ones(d),
        }
        if cfg.num_experts:
            lp.update(init_moe_params(cfg, gen, device=device, dtype=dtype))
        else:
            lp.update(w_gate=dense((d, f)), w_up=dense((d, f)), w_down=dense((f, d)))
        if cfg.attn_bias:
            for name, n in (("bq", qs), ("bk", kvs), ("bv", kvs)):
                lp[name] = torch.zeros(n, dtype=dtype, device=device)
        layers.append(quantize_layer(lp) if quantize else lp)
        del lp
    params: Params = {
        "embed": dense((cfg.vocab_size, d), scale=0.02),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    if quantize:
        head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
        params["lm_head"] = quantize_weight(head)
    return params


def param_count(params: Params, cfg: ModelConfig) -> int:
    """Logical parameter count of a dense or a W8A8 tree (ops/quant.py
    `logical_param_count`: codes count like their dense originals, scales
    and a tied model's int8 head do not)."""
    return logical_param_count(params, cfg)


def params_from_jax(tree: Params, *, device, dtype=None) -> Params:
    """Carry a JAX parameter tree (leaves as numpy arrays, e.g. from
    `jax.device_get`) over to the port's layout: same keys, same [in, out]
    orientation. bf16 leaves (ml_dtypes) go through float32, which is
    exact. `dtype` None keeps each leaf's own type. A quantized leaf
    {"q": int8 [in, out], "s": f32 [out]} keeps its codes and scales as
    they are (`dtype` never casts them), the codes transposed to the
    port's [out, in]."""

    def conv(a):
        if is_quantized(a):
            q = torch.from_numpy(np.ascontiguousarray(np.asarray(a["q"]).T))
            s = torch.from_numpy(np.array(a["s"], np.float32))
            return {"q": q.to(device), "s": s.to(device)}
        a = np.array(a)  # a writable copy the tensor may own
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in tree["layers"]]
    return out
