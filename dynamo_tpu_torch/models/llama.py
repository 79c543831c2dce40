"""Llama-family forward over a paged KV cache, in PyTorch.

Port of `dynamo_tpu/models/llama.py`, dense path. One `forward()` serves
chunked prefill and decode. Parameters are a plain dict of tensors (a
per-layer list under "layers") at the JAX package's layout: linear weights
are [in_features, out_features] so matmuls are `x @ w`, and KV pools are
per-layer [num_slots, K*Hd] tensors updated in place.

Attention goes through one of the `AttnSpec` modes below; the two the
engine's main path uses run the hand-written kernels on a GPU (page-scatter
write + flash prefill for prefill chunks, fused write + decode attention
for decode steps) and their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import paged_attention, write_kv_slots
from dynamo_tpu_torch.ops.decode_attention import fused_paged_decode_attention
from dynamo_tpu_torch.ops.kv_write import paged_kv_write
from dynamo_tpu_torch.ops.norm import rms_norm
from dynamo_tpu_torch.ops.prefill_attention import flash_prefill_attention
from dynamo_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq

Params = dict[str, Any]


class AttnSpec:
    """How attention reads (and the step writes) the paged KV pool:

    - gather: `slot_matrix` [B, C] position-ordered slots; new KV is
      row-scattered by `write_kv_slots`, then the plain oracle
      `paged_attention` reads it (`lengths` = ragged query lengths).
    - page-write prefill: `write_tables` [n_pages] page ids -> whole pages
      go through the page-scatter kernel (K1), then `block_tables` [B, W],
      `q_pos0` [B] and `lengths` [B] (valid chunk rows) drive the flash
      prefill kernel (K2) over them.
    - paged decode (T == 1): `block_tables` + `lengths` (attended KV count)
      + `write_pos` [B] (-1 = skip) -> the fused write + decode attention
      kernel (K3).
    """

    def __init__(self, slot_matrix=None, block_tables=None, lengths=None,
                 write_pos=None, page_size: int = 16, write_tables=None,
                 q_pos0=None):
        self.slot_matrix = slot_matrix
        self.block_tables = block_tables
        self.lengths = lengths
        self.write_pos = write_pos
        self.page_size = page_size
        self.write_tables = write_tables
        self.q_pos0 = q_pos0

    @classmethod
    def gather(cls, slot_matrix, write_tables=None, page_size: int = 16,
               block_tables=None, q_pos0=None, lengths=None):
        return cls(slot_matrix=slot_matrix, write_tables=write_tables,
                   page_size=page_size, block_tables=block_tables,
                   q_pos0=q_pos0, lengths=lengths)

    @classmethod
    def paged_decode(cls, block_tables, lengths, page_size, write_pos):
        """Counterpart of the JAX package's `AttnSpec.pallas_decode`."""
        return cls(block_tables=block_tables, lengths=lengths,
                   write_pos=write_pos, page_size=page_size)


class KVCache(NamedTuple):
    """Per-layer flat slot pools: k/v are length-L tuples of
    [num_slots, K*Hd] tensors, updated in place by every step. A page is
    [page_size, K*Hd] contiguous rows, so the [num_pages, page_size, K*Hd]
    view the kernels take is free."""

    k: tuple
    v: tuple


def init_kv_cache(cfg: ModelConfig, num_slots: int, *, device,
                  dtype=torch.bfloat16) -> KVCache:
    shape = (num_slots, cfg.num_kv_heads * cfg.head_dim)
    return KVCache(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
    )


def _attn_block(lp: Params, cfg: ModelConfig, x, cos, sin, kv_k, kv_v,
                write_slots, attn: AttnSpec, positions):
    b, t, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.attn_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = apply_rope(q.reshape(b, t, h, hd), cos, sin)
    k = apply_rope(k.reshape(b, t, kh, hd), cos, sin)
    v = v.reshape(b, t, kh, hd)

    if attn.block_tables is not None and attn.write_pos is not None:
        out, kv_k, kv_v = fused_paged_decode_attention(
            q[:, 0].contiguous(),
            k[:, 0].reshape(b, kh * hd).contiguous(),
            v[:, 0].reshape(b, kh * hd).contiguous(),
            kv_k, kv_v, attn.block_tables, attn.lengths, attn.write_pos,
            page_size=attn.page_size,
        )
        out = out[:, None]
    elif attn.write_tables is not None:
        # whole [page, K*Hd] blocks: rows pad up to whole pages; the tail
        # garbage lands in the sequence's own not-yet-valid positions
        # (masked by position) or in the trash page
        ps = attn.page_size
        t_pad = -(-t // ps) * ps
        k2 = k.reshape(b, t, kh * hd)
        v2 = v.reshape(b, t, kh * hd)
        if t_pad != t:
            k2 = F.pad(k2, (0, 0, 0, t_pad - t))
            v2 = F.pad(v2, (0, 0, 0, t_pad - t))
        n_pg = b * (t_pad // ps)
        kv_k, kv_v = paged_kv_write(
            kv_k, kv_v, attn.write_tables,
            k2.reshape(n_pg, ps, kh * hd).contiguous(),
            v2.reshape(n_pg, ps, kh * hd).contiguous(),
            page_size=ps,
        )
        out = flash_prefill_attention(
            q.contiguous(), kv_k, kv_v, attn.block_tables, attn.q_pos0,
            attn.lengths, page_size=ps,
        )
    else:
        write_kv_slots(
            kv_k, kv_v, write_slots,
            k.reshape(b * t, kh * hd), v.reshape(b * t, kh * hd),
        )
        out = paged_attention(
            q, kv_k, kv_v, attn.slot_matrix, positions, q_lens=attn.lengths,
        )
    return out.reshape(b, t, h * hd) @ lp["wo"], kv_k, kv_v


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def _mlp_block(lp: Params, x, act: str = "silu"):
    gate = _ACTIVATIONS[act](x @ lp["w_gate"])
    return (gate * (x @ lp["w_up"])) @ lp["w_down"]


def layer_step(lp, cfg, x, cos, sin, kv_k, kv_v, write_slots, attn, positions):
    """One transformer layer (attention + FFN, pre-norm residuals)."""
    w_off = cfg.norm_weight_offset
    attn_in = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps, weight_offset=w_off)
    attn_out, kv_k, kv_v = _attn_block(
        lp, cfg, attn_in, cos, sin, kv_k, kv_v, write_slots, attn, positions
    )
    x = x + attn_out
    mlp_in = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps, weight_offset=w_off)
    return x + _mlp_block(lp, mlp_in, act=cfg.hidden_act), kv_k, kv_v


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B, T] int
    positions: torch.Tensor,    # [B, T] int absolute positions
    kv: KVCache,
    write_slots: torch.Tensor,  # [B*T] int flat slots of the new tokens (0 = trash)
    attn,                       # AttnSpec, or a raw [B, C] slot matrix (gather)
    inv_freq: torch.Tensor | None = None,  # rope_inv_freq(cfg) on x's device
) -> tuple[torch.Tensor, KVCache]:
    """One model step. Returns (hidden [B, T, D] after the final norm, kv);
    the pools in `kv` are updated in place. Logits come from `logits()` on
    the (usually sliced) hidden states. Callers that step repeatedly pass
    `inv_freq` already on the device: uploading it from the host on every
    step would make the host wait for the device each time."""
    if cfg.num_experts:
        raise NotImplementedError("MoE models are not ported to dynamo_tpu_torch yet")
    if not isinstance(attn, AttnSpec):
        attn = AttnSpec.gather(attn)
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        # gemma: embedding outputs scaled by sqrt(d), rounded to x's dtype
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    if inv_freq is None:
        inv_freq = torch.from_numpy(rope_inv_freq(cfg)).to(x.device)
    cos, sin = rope_cos_sin(inv_freq, positions)  # [B, T, Hd]
    for l, lp in enumerate(params["layers"]):
        x, _, _ = layer_step(
            lp, cfg, x, cos, sin, kv.k[l], kv.v[l], write_slots, attn, positions
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps,
                 weight_offset=cfg.norm_weight_offset)
    return x, kv


def logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Vocab projection [..., D] -> [..., V] in float32."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return (hidden @ head).float()


def init_params(cfg: ModelConfig, seed: int, *, device,
                dtype=torch.bfloat16) -> Params:
    """Random-init params from an explicit seed (tests, benchmarks): normal
    weights scaled by fan_in**-0.5, embeddings by 0.02, unit norms — the
    JAX package's scheme, with torch's generator (so other values)."""
    if cfg.num_experts:
        raise NotImplementedError("MoE models are not ported to dynamo_tpu_torch yet")
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
            "w_gate": dense((d, f)),
            "w_up": dense((d, f)),
            "w_down": dense((f, d)),
        }
        if cfg.attn_bias:
            for name, n in (("bq", qs), ("bk", kvs), ("bv", kvs)):
                lp[name] = torch.zeros(n, dtype=dtype, device=device)
        layers.append(lp)
    params: Params = {
        "embed": dense((cfg.vocab_size, d), scale=0.02),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    return params


def param_count(params: Params) -> int:
    layers = sum(w.numel() for lp in params["layers"] for w in lp.values())
    return layers + sum(w.numel() for k, w in params.items() if k != "layers")


def params_from_jax(tree: Params, *, device, dtype=None) -> Params:
    """Carry a JAX parameter tree (leaves as numpy arrays, e.g. from
    `jax.device_get`) over to the port's layout: same keys, same [in, out]
    orientation. bf16 leaves (ml_dtypes) go through float32, which is
    exact. `dtype` None keeps each leaf's own type."""

    def conv(a):
        a = np.array(a)  # a writable copy the tensor may own
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in tree["layers"]]
    return out
