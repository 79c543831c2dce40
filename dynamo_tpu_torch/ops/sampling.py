"""On-device batched token sampling: greedy / temperature / top-k / top-p.

Top-k/top-p operate on a fixed `CANDIDATES`-wide shortlist (`torch.topk`)
— per-request k is a clamp within it, p a cumulative cutoff over it; the
same support set as the JAX package's `_shortlist_mask`. Random draws come
from an explicit `torch.Generator` on the logits' device (Gumbel-max over
the masked shortlist); they cannot replay JAX's threefry bits, so seeded
sampling is held to the reference in distribution only.

Penalties, logprobs and per-request seeds are not ported yet: the engine
refuses requests that ask for them.
"""

from __future__ import annotations

import torch

CANDIDATES = 64  # shortlist width for top-k/top-p


def shortlist_mask(scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor):
    """Scaled logits [N, V], per-row top_k [N] (<= 0: off) and top_p [N]
    (>= 1: off) -> (cand_ids [N, C] int64, masked shortlist logits [N, C]
    with excluded candidates at -1e30)."""
    v = scaled.shape[-1]
    cand_logits, cand_ids = torch.topk(scaled, min(CANDIDATES, v), dim=-1)
    n = cand_logits.shape[-1]
    ranks = torch.arange(n, device=scaled.device)
    k = torch.where(top_k <= 0, torch.full_like(top_k, n), top_k.clamp(max=n))
    keep_k = ranks[None, :] < k[:, None]
    probs = torch.softmax(cand_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose *preceding* cumulative mass is below p (>= 1 token)
    keep_p = (cum - probs) < top_p[:, None]
    masked = torch.where(
        keep_k & keep_p, cand_logits, torch.full_like(cand_logits, -1e30)
    )
    return cand_ids, masked


def sample_tokens(
    logits: torch.Tensor,       # [B, V] float
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B] f32 (<= 0 treated as greedy)
    top_k: torch.Tensor,        # [B] int (<= 0 means disabled)
    top_p: torch.Tensor,        # [B] f32 (>= 1 means disabled)
    all_greedy: bool = False,   # whole batch greedy -> argmax only
) -> torch.Tensor:
    """Returns sampled ids [B] int32, without leaving the device."""
    raw = logits.float()
    greedy_ids = torch.argmax(raw, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy_ids
    is_greedy = temperature <= 0.0
    temp = torch.where(is_greedy, torch.ones_like(temperature), temperature)
    scaled = raw / temp[:, None]
    cand_ids, masked = shortlist_mask(scaled, top_k, top_p)
    u = torch.rand(
        masked.shape, generator=generator, device=masked.device,
        dtype=torch.float32,
    ).clamp_(min=1e-20)
    choice = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    sampled = torch.gather(cand_ids, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(is_greedy, greedy_ids, sampled)
