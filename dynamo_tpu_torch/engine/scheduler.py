"""Sequence state and admission/preemption policy for continuous batching.

Port of `dynamo_tpu/engine/scheduler.py`, holding only what the port's
engine reads. The scheduler is deliberately simple and single-threaded
(the engine loop is the only caller):

- FIFO admission into fixed decode **slots** (highest priority class
  first when the engine schedules by priority);
- prompt pages allocated up front (after the prefix-cache match), decode
  pages grown one at a time;
- when a decode-time page allocation fails, the most-recently admitted
  sequence is preempted: pages released, sequence requeued at the front,
  and its re-prefill rides the prefix cache (its own registered pages).

A sequence's tokens live in a `TokenBlockSequence`, which hashes each full
page of them as it completes: the hashes key the prefix cache.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.spec import NgramProposer
from dynamo_tpu_torch.llm.protocols.common import (
    FINISH_REASON_CANCELLED,
    FINISH_REASON_EOS,
    FINISH_REASON_LENGTH,
    PreprocessedRequest,
)
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from dynamo_tpu_torch.ops.sampling import TOP_LOGPROBS_MAX
from dynamo_tpu_torch.runtime.pipeline.context import Context

_seq_counter = itertools.count()


@dataclass
class Sequence:
    ctx: Context
    blocks: TokenBlockSequence          # prompt + sampled tokens, hashed per page
    out_queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    seq_id: int = field(default_factory=lambda: next(_seq_counter))

    prompt_len: int = 0
    page_ids: list[int] = field(default_factory=list)
    num_cached: int = 0        # prefix-cache tokens reused at admission
    num_computed: int = 0      # tokens whose KV is valid in pages
    registered_pages: int = 0  # leading pages whose hashes are registered
    # prefix pages the last reservation reused from HBM, restored from the
    # host tier, and found on the host but not restored (the restore gate
    # declined, or the restore failed: `gate_reason`); a preemption-resume
    # restamps them
    blocks_reused: int = 0
    blocks_restored: int = 0
    blocks_declined: int = 0
    gate_reason: str = ""
    # multimodal: [T_img, D] embeddings replacing the token lookups at
    # positions [embeds_offset, embeds_offset + T_img), f32 as the request
    # gave them until the engine holds them on its device in the model
    # dtype (`TorchEngine._take_embeds`); the prefix cache serves only the
    # text before them (`cacheable_pages`)
    prompt_embeds: Optional[torch.Tensor] = None
    embeds_offset: int = 0
    # disaggregated decode (`TorchEngine.generate_remote`): (first token,
    # k, v, ks, vs) of a prompt prefilled elsewhere, injected chunk by
    # chunk in place of the prefill; None once injected
    preloaded: Optional[tuple] = None
    slot: int = -1
    generated: int = 0
    prefilling: bool = False   # admitted but prompt KV not yet complete
    device_pos: int = 0        # next position a decode dispatch will write
    # step pipeline: the prefill's first token is still on the device
    # (the slot's carry override) and not yet emitted; `first_task` is the
    # asynchronous fetch that emits it early, if one was started
    carry_pending: bool = False
    first_task: Optional[object] = None
    # meta of the first emitted token after an admission (the prefix-cache
    # hit: prefix_cached_tokens, prompt_tokens)
    first_meta: Optional[dict] = None
    # tenant priority class (Context metadata "priority"; higher = more
    # important): orders admission picks and preemption-victim selection
    priority: int = 0
    # self-speculative decoding: the n-gram proposer (engine/spec.py),
    # created at admission when the engine runs spec_decode; it survives
    # preemption (the token history it indexes does not change across a
    # re-prefill)
    spec: Optional[NgramProposer] = None
    # end-to-end deadline, epoch seconds (time.time(), so it survives
    # process hops); 0.0 = none. Read from Context metadata "deadline" or
    # set from the engine's request_timeout_s; checked by the admission
    # shed and the sweep of running sequences.
    deadline: float = 0.0
    # perf_counter stamps: submit (generate), the latest admission to a
    # slot, the first emitted token; the finish summary reads them
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_emit: float = 0.0
    # tenant label for per-tenant SLO attainment (Context metadata
    # "tenant", stamped by the HTTP frontend from x-tenant-id)
    tenant: str = "default"

    # per-request sampling (resolved once at admission)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: int = -1                 # -1: the engine's generator
    want_logprobs: bool = False
    top_logprobs: int = 0          # alternatives per position (<= 8)
    cum_logprob: float = 0.0
    max_new_tokens: int = 0
    eos_ids: frozenset[int] = frozenset()
    ignore_eos: bool = False

    @classmethod
    def from_request(
        cls, ctx: Context, pre: PreprocessedRequest, page_size: int,
        max_model_len: int, blocks: Optional[TokenBlockSequence] = None,
    ) -> "Sequence":
        if blocks is not None and (
            blocks.block_size != page_size
            or blocks.total_tokens != len(pre.token_ids)
        ):
            # a stale or mismatched precompute would corrupt the prefix
            # cache (wrong chained hashes): hash here instead
            blocks = None
        seq = cls(
            ctx=ctx,
            blocks=blocks or TokenBlockSequence(pre.token_ids, page_size),
            prompt_len=len(pre.token_ids),
        )
        so = pre.sampling_options
        seq.temperature = 0.0 if so.greedy else float(so.temperature or 0.0)
        seq.top_k = int(so.top_k or 0)
        seq.top_p = float(so.top_p if so.top_p is not None else 1.0)
        seq.frequency_penalty = float(so.frequency_penalty or 0.0)
        seq.presence_penalty = float(so.presence_penalty or 0.0)
        seq.repetition_penalty = float(
            so.repetition_penalty if so.repetition_penalty else 1.0)
        # any seed folds into the non-negative int32 domain (-1 is the
        # unseeded sentinel), so wide and negative seeds stay reproducible
        seq.seed = (int(so.seed) & 0x7FFFFFFF) if so.seed is not None else -1
        seq.want_logprobs = bool(so.logprobs)
        seq.top_logprobs = (
            max(0, min(int(so.top_logprobs or 0), TOP_LOGPROBS_MAX))
            if seq.want_logprobs else 0
        )
        budget = max_model_len - seq.prompt_len
        mt = pre.stop_conditions.max_tokens
        seq.max_new_tokens = max(0, min(budget, mt) if mt is not None else budget)
        seq.eos_ids = frozenset(
            list(pre.eos_token_ids) + list(pre.stop_conditions.stop_token_ids)
        )
        seq.ignore_eos = pre.stop_conditions.ignore_eos
        if pre.prompt_embeds is not None:
            # the reference's np.asarray(..., np.float32): nested lists and
            # arrays; a tensor (the reference's jax array) stays where it is
            e = pre.prompt_embeds
            seq.prompt_embeds = (e.detach().float() if isinstance(e, torch.Tensor)
                                 else torch.from_numpy(np.asarray(e, np.float32)))
            seq.embeds_offset = int(pre.embeds_offset)
        try:
            seq.priority = int(ctx.metadata.get("priority") or 0)
        except (TypeError, ValueError):
            seq.priority = 0
        try:
            seq.deadline = float(ctx.metadata.get("deadline") or 0.0)
        except (TypeError, ValueError):
            seq.deadline = 0.0
        tenant = ctx.metadata.get("tenant")
        if tenant:
            seq.tenant = str(tenant)
        return seq

    @property
    def has_penalties(self) -> bool:
        return (
            self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
            or self.repetition_penalty != 1.0
        )

    @property
    def needs_ext_sampling(self) -> bool:
        """Penalties and seeds need the extended sampler (the count rows,
        the seeded hash), logprobs its logsumexp outputs. The host-built
        step families (spec verify, mixed steps) sample on the plain path
        only, so these requests take the normal dispatches: one predicate
        for the three gates."""
        return (
            self.has_penalties
            or self.seed >= 0
            or self.want_logprobs
            or self.top_logprobs > 0
        )

    def past_deadline(self, now: Optional[float] = None) -> bool:
        if not self.deadline:
            return False
        return (now if now is not None else time.time()) > self.deadline

    @property
    def no_cache(self) -> bool:
        """Prefix caching is unsound from the first embed position on: the
        block hashes cover the placeholder token ids, not the image. The
        text before `embeds_offset` stays cacheable (`cacheable_pages`)."""
        return self.prompt_embeds is not None

    def embeds_overlap(self, start: int, n: int) -> Optional[tuple[int, int]]:
        """[lo, hi) of positions [start, start + n) that take embeds rows,
        or None when the span misses them (or there are none)."""
        if self.prompt_embeds is None:
            return None
        lo = max(start, self.embeds_offset)
        hi = min(start + n, self.embeds_offset + len(self.prompt_embeds))
        return (lo, hi) if lo < hi else None

    def cacheable_pages(self, page_size: int) -> Optional[int]:
        """Pages eligible for prefix-cache match and registration; None is
        no limit. A sequence with prompt embeds: the whole pages before
        `embeds_offset`, as in the reference."""
        if self.prompt_embeds is None:
            return None
        return self.embeds_offset // page_size

    @property
    def tokens(self) -> list[int]:
        return self.blocks.all_tokens()

    @property
    def total_tokens(self) -> int:
        return self.blocks.total_tokens

    @property
    def last_token(self) -> int:
        if self.blocks.partial:
            return self.blocks.partial[-1]
        return self.blocks.blocks[-1].tokens[-1]

    def check_finish(self, new_token: int) -> Optional[str]:
        """Engine-level stop: eos/stop ids and token budget (stop *strings*
        are the detokenizing backend's job downstream)."""
        if self.ctx.is_stopped():
            return FINISH_REASON_CANCELLED
        if not self.ignore_eos and new_token in self.eos_ids:
            return FINISH_REASON_EOS
        if self.generated >= self.max_new_tokens:
            return FINISH_REASON_LENGTH
        return None


# ---------------------------------------------------------------- priority
# Pure scheduling policy over Sequence.priority, kept next to the state it
# orders so the engine's two call sites (admission pick in _admit_new,
# victim pick in _ensure_pages_through) cannot drift apart.


def pick_admission_index(waiting) -> int:
    """Index of the next sequence to admit: highest priority class
    first, FIFO within a class (index 0 when priorities are uniform).
    One enumerate pass: `waiting` is a deque, where positional indexing
    is O(i)."""
    best, best_prio = 0, None
    for i, seq in enumerate(waiting):
        if best_prio is None or seq.priority > best_prio:
            best, best_prio = i, seq.priority
    return best


def pick_preemption_victim(seqs: list) -> "Sequence":
    """The sequence to preempt when a page allocation fails: lowest
    priority class first, most-recently-admitted (highest seq_id) within
    the class; max(seq_id) when priorities are uniform."""
    return max(seqs, key=lambda s: (-s.priority, s.seq_id))
