"""Deterministic prompt synthesis for trace replay.

Token ids are a pure function of (factory seed, record index, prefix
group): replaying the same trace file against the same factory produces
identical prompts, so prefix-cache behavior is reproducible run to run.
Records with a ``prefix_group`` share that group's prefix tokens (the
shared system-prompt shape); the per-request suffix stays unique so no
request is a full-prompt duplicate of another.

The JAX package's `loadgen/prompts.py`: the same token lists for the same
factory and record.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dynamo_tpu_torch.loadgen.trace import TraceRecord, _seed32


class PromptFactory:
    """Seeded token synthesis. ``prefix_frac`` of a grouped record's ISL
    comes from its group's shared prefix (rounded DOWN to a multiple of
    ``page_size`` when given, so warm serves actually span full KV
    pages — a sub-page "prefix" reuses nothing, the BENCH_r06 trap)."""

    def __init__(
        self,
        vocab_size: int,
        seed: int = 0,
        prefix_frac: float = 0.75,
        page_size: Optional[int] = None,
    ):
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        self.prefix_frac = float(prefix_frac)
        self.page_size = page_size
        self._prefixes: dict[tuple[str, int], list[int]] = {}

    def _rand_tokens(self, key: str, n: int) -> list[int]:
        rng = np.random.RandomState(_seed32(self.seed, key))
        # 1..vocab-1: token 0 is a pad id in several tokenizers
        return rng.randint(1, self.vocab_size, size=n).tolist()

    def prefix_tokens(self, group: str, length: int) -> list[int]:
        """The group's shared prefix, identical for every caller."""
        got = self._prefixes.get((group, length))
        if got is None:
            got = self._rand_tokens(f"prefix/{group}", length)
            self._prefixes[(group, length)] = got
        return got

    def prefix_len(self, record: TraceRecord) -> int:
        if record.prefix_group is None:
            return 0
        n = int(record.isl * self.prefix_frac)
        if self.page_size:
            n = (n // self.page_size) * self.page_size
        return max(0, min(n, record.isl - 1))

    def tokens_for(self, record: TraceRecord, index: int) -> list[int]:
        """The record's full prompt: shared group prefix (if any) + a
        unique per-index suffix."""
        n_prefix = self.prefix_len(record)
        suffix = self._rand_tokens(f"suffix/{index}", record.isl - n_prefix)
        if n_prefix == 0:
            return suffix
        return self.prefix_tokens(record.prefix_group, n_prefix) + suffix
