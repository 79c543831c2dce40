"""Sparse mixture-of-experts FFN (Mixtral-style), in PyTorch.

Port of `dynamo_tpu/models/moe.py`. The routing contract is the
reference's, so the same tokens are dropped and carry the same weights:

- routing in float32 (float64 stays float64): softmax over the router's
  logits, the top k experts, their weights renormalised over the k;
- ties in the top k go to the lower expert index first, as
  `jax.lax.top_k` orders them (a stable descending sort; `torch.topk`
  promises no order);
- GShard capacity: each expert takes at most `expert_capacity(cfg, n)` of
  the step's n = B*T rows, in slot-major priority (every token's slot 0
  is placed before any slot 1, each slot in row order); padding rows
  (`real_mask` False) take no capacity, and a token that overflows an
  expert gets weight 0 there;
- the per-slot outputs are summed, each the expert's output times its
  weight cast to x's dtype.

The reference builds one-hot [k*N, E, C] dispatch and combine tensors and
contracts them with einsums. Here the same placement is a table of
static shape: `route` gives each (slot, token) its expert and its place
in that expert's capacity, `dispatch` gathers the tokens into [E, C, D]
(an empty place reads an appended zero row), `experts` runs each expert's
SwiGLU as three `torch.bmm`, and `combine` gathers each token's rows back,
one slot after the other. No step syncs with the host and no shape
depends on the data, so the block runs inside a captured decode graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def init_moe_params(cfg, gen: torch.Generator, *, device,
                    dtype=torch.bfloat16) -> dict:
    """One layer's router [D, E] and experts we_gate/we_up [E, D, F],
    we_down [E, F, D]: normal draws from `gen` scaled by fan_in**-0.5,
    made one expert at a time, so no float32 copy of a whole [E, ...]
    tensor exists."""
    d, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts

    def draw(shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(shape[0] ** -0.5)

    def stacked(shape):
        out = torch.empty((e, *shape), dtype=dtype, device=device)
        for i in range(e):
            out[i].copy_(draw(shape))
        return out

    return {
        "router": draw((d, e)).to(dtype),
        "we_gate": stacked((d, f)),
        "we_up": stacked((d, f)),
        "we_down": stacked((f, d)),
    }


def expert_capacity(cfg, n_tokens: int) -> int:
    """Static per-expert row budget of a step of `n_tokens` rows (padding
    included), rounded up to a multiple of 8: the reference's formula."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = int(k * n_tokens / e * cfg.expert_capacity_factor) + 1
    return -(-cap // 8) * 8


class Routing(NamedTuple):
    """Where each (slot, token) goes, slot-major: [k, N] each."""

    expert: torch.Tensor  # int64 expert index
    weight: torch.Tensor  # float32 (float64 for a float64 x) renormalised weight
    pos: torch.Tensor     # int64 place within the expert's capacity
    keep: torch.Tensor    # bool: a real token that fits in its expert's capacity
    capacity: int


def route(lp: dict, cfg, xf: torch.Tensor,
          real_mask: Optional[torch.Tensor] = None) -> Routing:
    """Router, top-k and capacity for the flat rows xf [N, D]."""
    n = xf.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    rt = torch.promote_types(xf.dtype, torch.float32)
    probs = torch.softmax(xf.to(rt) @ lp["router"].to(rt), dim=-1)  # [N, E]
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)  # Mixtral's renormalisation
    expert, weight = top_i.T, top_w.T  # slot-major [k, N]
    flat = expert.reshape(1, k * n)
    # expert-major [E, k*N] assignments, so the running count is a scan
    # along the contiguous axis (a scan across rows is many times slower
    # on the card)
    onehot = flat == torch.arange(e, device=xf.device)[:, None]
    if real_mask is not None:
        real = real_mask.reshape(1, n).expand(k, n).reshape(1, k * n)
        onehot &= real
    count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    # a row's place in its expert: the 1-based running count at its own
    # expert, less one; a padding row counts nowhere and lands at -1
    pos = count.gather(0, flat).long() - 1
    if real_mask is not None:
        pos = torch.where(real, pos, -1)
    cap = expert_capacity(cfg, n)
    keep = (pos >= 0) & (pos < cap)
    return Routing(expert, weight, pos.reshape(k, n), keep.reshape(k, n), cap)


def dispatch(xf: torch.Tensor, r: Routing, num_experts: int) -> torch.Tensor:
    """Gather the kept rows into expert-major [E, C, D]; an empty place
    reads a zero row (whose SwiGLU output is exactly zero)."""
    n, d = xf.shape
    k = r.expert.shape[0]
    slots = num_experts * r.capacity
    # dropped and padding rows go to one dump place past the table
    dest = torch.where(r.keep, r.expert * r.capacity + r.pos, slots)
    table = torch.full((slots + 1,), n, dtype=torch.long, device=xf.device)
    rows = torch.arange(n, device=xf.device).expand(k, n)
    table.scatter_(0, dest.reshape(-1), rows.reshape(-1))
    padded = torch.cat((xf, xf.new_zeros(1, d)))
    return padded[table[:slots]].view(num_experts, r.capacity, d)


def experts(lp: dict, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: [E, C, D] -> [E, C, D]."""
    gate = torch.bmm(xe, lp["we_gate"])
    up = torch.bmm(xe, lp["we_up"])
    return torch.bmm(F.silu(gate) * up, lp["we_down"])


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """Each token's expert rows times its weights, summed over the slots in
    slot order: [E, C, D] -> [N, D]. A token has one row per slot, so this
    is a gather (no scatter, no atomics); a dropped or padding slot reads
    row 0 with weight 0."""
    e, c, d = ye.shape
    flat = ye.reshape(e * c, d)
    rows = torch.where(r.keep, r.expert * c + r.pos, 0)
    w = torch.where(r.keep, r.weight, 0.0).to(ye.dtype)  # cast as the reference does
    out = flat[rows[0]] * w[0, :, None]
    for s in range(1, rows.shape[0]):
        out = out + flat[rows[s]] * w[s, :, None]
    return out


def moe_block(lp: dict, cfg, x: torch.Tensor,
              real_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D]: route, dispatch, the experts' SwiGLU,
    combine. `real_mask` [B, T] bool marks the genuine tokens; padding
    rows take no capacity and come out zero."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    r = route(lp, cfg, xf, real_mask)
    ye = experts(lp, dispatch(xf, r, cfg.num_experts))
    return combine(ye, r).reshape(b, t, d)
