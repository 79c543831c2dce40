"""On-device batched token sampling: greedy / temperature / top-k / top-p,
and the speculative verifier (`verify_draft_tokens`).

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


def _gumbel_choice(masked: torch.Tensor, generator) -> torch.Tensor:
    """A categorical draw over the last axis of masked logits (Gumbel-max)."""
    u = torch.rand(
        masked.shape, generator=generator, device=masked.device,
        dtype=torch.float32,
    ).clamp_(min=1e-20)
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


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
    choice = _gumbel_choice(masked, generator)
    sampled = torch.gather(cand_ids, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(is_greedy, greedy_ids, sampled)


def verify_draft_tokens(
    logits: torch.Tensor,       # [B, T, V] float; row j is the model's
    #                             distribution for position pos0 + j + 1
    draft: torch.Tensor,        # [B, T-1] int drafted tokens
    draft_len: torch.Tensor,    # [B] int valid draft count per row (0..T-1)
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B] f32 (<= 0 treated as greedy)
    top_k: torch.Tensor,        # [B] int (<= 0 means disabled)
    top_p: torch.Tensor,        # [B] f32 (>= 1 means disabled)
    all_greedy: bool = False,   # whole batch greedy
):
    """Speculative verification over a batch of drafted windows (port of
    the JAX package's `ops/sampling.verify_draft_tokens`).

    - greedy rows: d_j is accepted iff it equals the argmax at position
      j - 1, so the emitted stream is the non-speculative one;
    - sampled rows: rejection sampling against the proposer's point-mass
      draft — accept d_j with probability p_j(d_j) under the same
      shortlist/top-k/top-p-masked distribution `sample_tokens` draws
      from; on rejection resample from p_j with d_j masked out (the exact
      residual of a point mass).

    After the leading accepted run of length a one more token is emitted:
    the resample at slot a or, when every draft was accepted, a bonus draw
    from the unmodified distribution at slot a. The three draws (accept
    uniforms, resamples, bonus draws) come from `generator` in that order.
    Returns (out_tokens [B, T] int32, n_emit [B] int32 in [1, T]); out
    positions >= n_emit are garbage."""
    b, t, v = logits.shape
    kd = t - 1
    raw = logits.float()
    greedy_ids = torch.argmax(raw, dim=-1).to(torch.int32)          # [B, T]
    draft = draft.to(torch.int32)
    valid = torch.arange(kd, device=raw.device)[None, :] < draft_len[:, None]
    g_match = (draft == greedy_ids[:, :kd]) & valid

    if all_greedy:
        # accepted drafts ARE the argmaxes: only the emit count varies
        lead = torch.cumprod(g_match.to(torch.int32), dim=1)
        return greedy_ids, (lead.sum(dim=1) + 1).to(torch.int32)

    is_greedy = temperature <= 0.0
    temp = torch.where(is_greedy, torch.ones_like(temperature), temperature)
    scaled = raw / temp[:, None, None]
    cand_ids, masked = shortlist_mask(
        scaled.reshape(b * t, v),
        top_k.repeat_interleave(t), top_p.repeat_interleave(t),
    )
    n = cand_ids.shape[-1]
    cand_ids = cand_ids.reshape(b, t, n)
    masked = masked.reshape(b, t, n)
    p_masked = torch.softmax(masked, dim=-1)                         # [B, T, C]

    # acceptance: p_j(d_j) under the masked distribution (0 when the draft
    # is outside the shortlist/top-k/top-p mask -> reject)
    is_draft = cand_ids[:, :kd, :] == draft[:, :, None].long()       # [B, K, C]
    p_draft = torch.where(is_draft, p_masked[:, :kd], 0.0).sum(dim=-1)
    u = torch.rand((b, kd), generator=generator, device=raw.device, dtype=torch.float32)
    accept = torch.where(is_greedy[:, None], g_match, (u < p_draft) & valid)
    lead = torch.cumprod(accept.to(torch.int32), dim=1)              # [B, K]
    a = lead.sum(dim=1).to(torch.int32)

    # rejection resample at each draft slot: p with d_j removed
    masked_r = torch.where(is_draft, torch.full_like(masked[:, :kd], -1e30), masked[:, :kd])
    r_choice = _gumbel_choice(masked_r, generator)
    r_ids = torch.gather(cand_ids[:, :kd], 2, r_choice[..., None])[..., 0].to(torch.int32)
    # bonus draw at every slot (used at slot a when a == draft_len)
    b_choice = _gumbel_choice(masked, generator)
    b_ids = torch.gather(cand_ids, 2, b_choice[..., None])[..., 0].to(torch.int32)
    r_ids = torch.where(is_greedy[:, None], greedy_ids[:, :kd], r_ids)
    b_ids = torch.where(is_greedy[:, None], greedy_ids, b_ids)

    head = torch.where(lead.bool(), draft, torch.where(valid, r_ids, b_ids[:, :kd]))
    out = torch.cat([head, b_ids[:, kd:]], dim=1).to(torch.int32)
    return out, a + 1
