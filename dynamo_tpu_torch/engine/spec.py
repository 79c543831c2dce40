"""Self-speculative decoding: n-gram draft proposal + adaptive gating.

A copy of `dynamo_tpu/engine/spec.py` (the port imports nothing of the JAX
package). Prompt-lookup drafting: the draft for a sequence's next k tokens
is the continuation of the most recent PRIOR occurrence of its current
n-gram suffix within its own token history. No extra model weights; the
verify step amortizes one full (memory-bandwidth-bound) model step over up
to k+1 accepted tokens.

The proposer is pure host-side bookkeeping, maintained incrementally from
the engine's append path; the engine consumes `maybe_draft()` when building
a verify step and feeds acceptance results back through `observe()`.

Adaptive gating: a per-sequence EMA of the acceptance rate turns drafting
off (k -> 0, the non-speculative behaviour) when the model keeps rejecting
the lookups. A periodic probe draft lets a gated-off stream recover when
its text becomes predictable again. Text with no n-gram repeats never
proposes at all.
"""

from __future__ import annotations

from collections import deque

# EMA smoothing for the per-sequence acceptance rate.
EMA_ALPHA = 0.35
# Below this EMA acceptance rate drafting is gated off for the stream.
GATE_THRESHOLD = 0.25
# While gated off, retry one probe draft every this many decode steps so a
# stream whose text turns predictable can re-enable itself.
RETRY_EVERY = 32
# Default sliding window (positions) the n-gram index covers. Without a
# cap the index gains up to ngram_max entries per appended token and
# never shrinks — a long stream leaks O(history x ngram_max) dict
# entries per sequence (EngineConfig.spec_index_window overrides).
INDEX_WINDOW = 8192


class NgramProposer:
    """Incremental prompt-lookup index over one sequence's token history.

    For every n in [1, ngram_max] the index maps the n-gram ENDING at a
    past position to the index just after it (the continuation start).
    N-grams ending at position i are registered when token i+1 arrives, so
    every index entry has at least one continuation token and the lookup
    of the current suffix always lands strictly before the sequence end.

    The proposer is bounded by a SLIDING WINDOW of `index_window`
    positions: index entries whose latest registration fell out of the
    window are evicted (an n-gram re-registered by a newer occurrence
    survives — newest wins, so only the stale mapping dies), capping the
    dict at `index_window * ngram_max` entries however long the stream
    runs; the token history keeps only the windowed tail (every
    surviving index value points inside it), truncated in amortized-O(1)
    chunks. Evicted n-grams simply stop drafting, exactly like n-grams
    that never recurred.
    """

    __slots__ = (
        "ngram_max", "history", "_index", "ema", "_cooldown",
        "drafted", "accepted", "index_window", "_added", "_added_base",
        "_hist_base",
    )

    def __init__(self, ngram_max: int = 3, index_window: int = INDEX_WINDOW):
        self.ngram_max = max(1, ngram_max)
        self.index_window = max(index_window, self.ngram_max + 1)
        # the windowed tail of the token history: local slot i holds
        # ABSOLUTE position _hist_base + i
        self.history: list[int] = []
        self._hist_base = 0
        self._index: dict[tuple, int] = {}  # n-gram -> ABSOLUTE position
        # per-position eviction queue: _added[i] holds the keys whose
        # registration pointed continuation position _added_base + i
        self._added: deque[list] = deque()
        self._added_base = 0
        self.ema = 1.0          # optimistic start: first drafts calibrate it
        self._cooldown = 0
        self.drafted = 0        # lifetime counters (metrics)
        self.accepted = 0

    def extend(self, tokens) -> None:
        """Append tokens, registering the n-grams they complete and
        evicting registrations (and history) older than the window."""
        h = self.history
        idx = self._index
        nmax = self.ngram_max
        for t in tokens:
            end = self._hist_base + len(h)  # the new token's abs index
            # n-grams ending at end-1 gain their first continuation token
            # (the one being appended) — register them now, newest wins
            added = []
            for n in range(1, min(nmax, len(h)) + 1):
                key = tuple(h[len(h) - n:])
                idx[key] = end
                added.append(key)
            self._added.append(added)
            h.append(int(t))
            while len(self._added) > self.index_window:
                for key in self._added.popleft():
                    # evict only if no newer occurrence re-registered it
                    if idx.get(key) == self._added_base:
                        del idx[key]
                self._added_base += 1
            # every surviving index value >= _added_base, so history
            # below it is dead; drop it in window-sized chunks (a
            # per-token del h[:1] would be O(window) each)
            if self._added_base - self._hist_base >= self.index_window:
                del h[: self._added_base - self._hist_base]
                self._hist_base = self._added_base

    def propose(self, k: int) -> list[int]:
        """Longest-suffix prompt lookup: up to k continuation tokens from
        the most recent prior occurrence of the current suffix."""
        h = self.history
        base = self._hist_base
        L = base + len(h)  # absolute sequence length
        if k <= 0 or L < 2:
            return []
        for n in range(min(self.ngram_max, L - 1, len(h)), 0, -1):
            cont = self._index.get(tuple(h[len(h) - n:]))
            if cont is not None:
                return h[cont - base:cont - base + k]
        return []

    def gate_open(self) -> bool:
        """Would `maybe_draft` consult the index right now (acceptance
        EMA above the gate, or the probe countdown expired)? Side-effect
        free — the step pipeline asks this to decide whether syncing the
        in-flight dispatch (so host history catches up and this stream
        can draft) is worth giving up one dispatch overlap."""
        return self.ema >= GATE_THRESHOLD or self._cooldown <= 0

    def shed_tick(self) -> None:
        """A pipelined carry row shed its draft this step (stale host
        history forbids proposing). Tick the probe countdown exactly
        like a gated `maybe_draft` would have — without this, sustained
        pipelined mixed flow never decrements it and a gated-off stream
        stays gated off for the whole flow (the stranding RETRY_EVERY
        exists to prevent). Once it reaches zero `gate_open` flips, and
        the next mixed tick takes the sync-first escape to probe from
        fresh history."""
        if self._cooldown > 0:
            self._cooldown -= 1

    def maybe_draft(self, k: int) -> list[int]:
        """Gated proposal: empty while the acceptance EMA is below the
        gate, except a periodic probe. Once the countdown expires the
        probe KEEPS proposing until a verify actually lands — only
        `observe()` re-arms the countdown, so a build the engine
        discards (e.g. while a dispatch is in flight) cannot eat the
        probe and strand the stream gated off forever."""
        if k <= 0:
            return []
        if self.ema < GATE_THRESHOLD and self._cooldown > 0:
            self._cooldown -= 1
            return []
        return self.propose(k)

    def observe(self, drafted: int, accepted: int) -> None:
        """Feed one verification result back into the gate's EMA."""
        if drafted <= 0:
            return
        self._cooldown = RETRY_EVERY
        self.drafted += drafted
        self.accepted += accepted
        self.ema = (1.0 - EMA_ALPHA) * self.ema + EMA_ALPHA * (
            accepted / drafted
        )
