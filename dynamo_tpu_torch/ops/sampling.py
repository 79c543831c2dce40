"""On-device batched token sampling: greedy / temperature / top-k / top-p,
with sampled-token logprobs and top-N alternatives, frequency / presence /
repetition penalties and per-request seeds, and the speculative verifier
(`verify_draft_tokens`). Port of the JAX package's `ops/sampling.py`.

Top-k/top-p operate on a fixed `CANDIDATES`-wide shortlist (`torch.topk`)
— per-request k is a clamp within it, p a cumulative cutoff over it; the
same support set as the JAX package's `_shortlist_mask`. Unseeded draws
come from an explicit `torch.Generator` on the logits' device (Gumbel-max
over the masked shortlist).

Logprobs are of the sampled token under the raw (pre-temperature,
pre-penalty) model distribution, the convention the OpenAI API reports;
the top-N alternatives come from an exact `torch.topk` over the whole
vocabulary, not from the shortlist.

Penalties follow the OpenAI definitions over "the text so far" (prompt +
completion, one int8 count row per slot, saturating at 127):
  frequency: logit -= frequency_penalty * count(token)
  presence:  logit -= presence_penalty  * (count(token) > 0)
  repetition (vLLM/HF-style): seen tokens' positive logits are divided by
  the penalty, negative multiplied.

Per-request seeds. The JAX package derives a seeded row's key as
fold_in(fold_in(PRNGKey(seed), position), 1); torch's Philox cannot replay
that. Here a seeded row's Gumbel noise comes from a stateless counter hash
of (seed, position, shortlist rank): (seed, position) folded to 32 bits by
a multiply-add and murmur3's 32-bit finaliser, then a splitmix-style
counter over the rank, finaliser(h + rank * golden ratio), all in int64
tensor ops masked to 32 bits (no product leaves int64), the top 23 bits
mapped to a uniform in (0, 1) that float32 holds exactly. Each torch op is
a kernel launch, so the hash is written in few of them (~47). It has no
generator state, so a stream depends
on nothing else in the batch, on neither the width nor graph or eager
execution, and a CUDA graph captures it; it is integer math, so the card
and the CPU give the same uniforms bit for bit. It has no reference to
match bit for bit: seeded sampling is held to the JAX package in
distribution only. Rows with seed < 0 draw from the generator.
"""

from __future__ import annotations

import torch

CANDIDATES = 64  # shortlist width for top-k/top-p
TOP_LOGPROBS_MAX = 8  # alternatives width (the engine's carry shapes match)

_M32 = 0xFFFFFFFF
_GAMMA = 0x9E3779B9  # the golden-ratio increment
# odd multipliers below 2**30 for the (seed, position) multiply-add: each
# product of a value below 2**31 stays below 2**61
_C_SEED = 0x2545F491
_C_POS = 0x3C6EF373


def apply_penalties(
    logits: torch.Tensor,     # [B, V] f32
    counts: torch.Tensor,     # [B, V] int8 token occurrence counts
    freq_pen: torch.Tensor,   # [B] f32 (0 = off)
    pres_pen: torch.Tensor,   # [B] f32 (0 = off)
    rep_pen: torch.Tensor,    # [B] f32 (1 = off)
) -> torch.Tensor:
    cnt = counts.float()
    seen = cnt > 0
    logits = logits - freq_pen[:, None] * cnt
    logits = logits - pres_pen[:, None] * seen.float()
    rep = rep_pen[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(seen, penalized, logits)


def count_tokens(counts: torch.Tensor, row: int, tokens: torch.Tensor) -> torch.Tensor:
    """Add a prompt's tokens [T] into one slot's count row, in place
    (saturating at 127; token id 0, the pad id, is never counted). Used at
    admission so penalties see the prompt, not just the completion."""
    tokens = tokens.long()
    onehot = torch.zeros(counts.shape[1], dtype=torch.int32, device=counts.device)
    onehot.index_add_(0, tokens, (tokens > 0).to(torch.int32))
    counts[row] = torch.clamp(counts[row].to(torch.int32) + onehot, max=127).to(torch.int8)
    return counts


def bump_counts(counts: torch.Tensor, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Count each row's sampled token [B] where `active` [B], in place
    (saturating at 127: the sum is taken in int32, so a count never wraps
    into a negative one, which would turn the penalty into a reward)."""
    rows = torch.arange(tokens.shape[0], device=counts.device)
    tokens = tokens.long()
    cur = counts[rows, tokens].to(torch.int32)
    counts[rows, tokens] = torch.clamp(cur + active.to(torch.int32), max=127).to(torch.int8)
    return counts


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and c in [2**31, 2**32):
    x * c = x * (c - 2**31) + x * 2**31, and mod 2**32 the second term is
    the low bit of x moved to bit 31; the first product stays below 2**63."""
    return (x * (c - 2**31) + ((x & 1) << 31)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser (a bijection with full avalanche)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seeded_uniforms(seeds: torch.Tensor, positions: torch.Tensor, n: int) -> torch.Tensor:
    """Uniforms in (0, 1) [B, n] f32 from the stateless hash of (seed [B] in
    [0, 2**31), position [B] in [0, 2**31), rank 0..n-1); equal bits on
    every device."""
    k = seeds.long() * _C_SEED + positions.long() * _C_POS
    h = _fmix32((k ^ (k >> 32)) & _M32)
    steps = torch.arange(_GAMMA, _GAMMA * (n + 1), _GAMMA, dtype=torch.int64,
                         device=seeds.device)
    x = _fmix32((h[:, None] + steps[None, :]) & _M32)
    # (x >> 9) + 1/2 over 2**23: exact in float32, never 0 or 1
    return (x >> 9).to(torch.float32).mul_(2.0 ** -23).add_(2.0 ** -24)


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


def _gumbel_choice(masked: torch.Tensor, generator, seeded=None) -> torch.Tensor:
    """A categorical draw over the last axis of masked logits (Gumbel-max).
    `seeded`: (seeds [B], positions [B]); rows with seed >= 0 take the
    hash's uniforms instead of the generator's (which advances the same
    either way)."""
    u = torch.rand(
        masked.shape, generator=generator, device=masked.device,
        dtype=torch.float32,
    ).clamp_(min=1e-20)
    if seeded is not None:
        seeds, positions = seeded
        u = torch.where((seeds >= 0)[:, None],
                        seeded_uniforms(seeds, positions, masked.shape[-1]), u)
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(
    logits: torch.Tensor,       # [B, V] float
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B] f32 (<= 0 treated as greedy)
    top_k: torch.Tensor,        # [B] int (<= 0 means disabled)
    top_p: torch.Tensor,        # [B] f32 (>= 1 means disabled)
    all_greedy: bool = False,   # whole batch greedy -> argmax only
    return_logprobs: bool = False,  # also return the sampled logprob [B]
    counts: torch.Tensor | None = None,    # [B, V] int8 (penalties on)
    freq_pen: torch.Tensor | None = None,  # [B] f32
    pres_pen: torch.Tensor | None = None,  # [B] f32
    rep_pen: torch.Tensor | None = None,   # [B] f32
    seeds: torch.Tensor | None = None,     # [B] int (-1: the generator)
    positions: torch.Tensor | None = None,  # [B] int (the seeded hash)
    top_n: int = 0,             # also return the top-n alternatives
):
    """Returns sampled ids [B] int32, without leaving the device; with
    `return_logprobs` also the sampled logprob [B] f32, and with `top_n`
    > 0 the top-n alternative ids [B, n] int32 and their logprobs [B, n]
    (OpenAI `top_logprobs`), all under the raw distribution."""
    raw = logits.float()

    def outputs(ids):
        if not return_logprobs:
            return ids
        logz = torch.logsumexp(raw, dim=-1)
        picked = torch.gather(raw, 1, ids[:, None].long())[:, 0] - logz
        if top_n <= 0:
            return ids, picked
        t_lg, t_ids = torch.topk(raw, min(top_n, raw.shape[-1]), dim=-1)
        return ids, picked, t_ids.to(torch.int32), t_lg - logz[:, None]

    lg = raw
    if counts is not None:
        lg = apply_penalties(raw, counts, freq_pen, pres_pen, rep_pen)
    greedy_ids = torch.argmax(lg, dim=-1).to(torch.int32)
    if all_greedy:
        return outputs(greedy_ids)
    is_greedy = temperature <= 0.0
    temp = torch.where(is_greedy, torch.ones_like(temperature), temperature)
    scaled = lg / temp[:, None]
    cand_ids, masked = shortlist_mask(scaled, top_k, top_p)
    choice = _gumbel_choice(masked, generator,
                            None if seeds is None else (seeds, positions))
    sampled = torch.gather(cand_ids, 1, choice[:, None])[:, 0].to(torch.int32)
    return outputs(torch.where(is_greedy, greedy_ids, sampled))


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
