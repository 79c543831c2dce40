"""The port's page allocator (dynamo_tpu_torch.engine.allocator) against the
JAX package's: the same random script of allocations, block registrations,
prefix matches, releases and cache clears gives the same pages, KV events
and counters on both; page 0 is never handed out."""

from __future__ import annotations

import numpy as np
import pytest

from dynamo_tpu.engine.allocator import PageAllocator as JaxPageAllocator
from dynamo_tpu.llm import tokens as jtokens
from dynamo_tpu_torch.engine.allocator import PageAllocator
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

PAGE = 4


def _state(a):
    return (
        a.num_free, a.pages_free, a.pages_cached, a.pages_used, a.peak_used,
        a.lookups, a.hits, dict(a.release_violations), a.usage(), a.fragmentation(),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_script_matches_jax_allocator(seed):
    rng = np.random.RandomState(seed)
    ev_t, ev_j = [], []
    ours = PageAllocator(24, PAGE, on_event=ev_t.append)
    ref = JaxPageAllocator(24, PAGE, on_event=ev_j.append)
    # a few shared prompt prefixes so prefix matches hit
    prefixes = [rng.randint(0, 50, size=3 * PAGE).tolist() for _ in range(3)]
    live = []  # (pages, hashes)
    for _ in range(300):
        op = rng.randint(0, 5)
        if op <= 1:  # admit: match the cached prefix, allocate the rest, register
            toks = prefixes[rng.randint(0, 3)][: PAGE * rng.randint(1, 4)]
            toks = toks + rng.randint(0, 50, size=rng.randint(0, 2 * PAGE)).tolist()
            blocks = jtokens.TokenBlockSequence(toks, PAGE).blocks
            hashes = [b.sequence_hash for b in blocks]
            assert ours.peek_prefix_tokens(hashes=hashes) == ref.peek_prefix_tokens(hashes=hashes)
            assert ours.peek_prefix_tokens(toks) == ref.peek_prefix_tokens(toks)
            hit = ours.match_prefix(hashes)
            assert hit == ref.match_prefix(hashes)
            need = -(-len(toks) // PAGE) - len(hit)
            fresh = ours.allocate(need)
            assert fresh == ref.allocate(need)
            if fresh is None:
                ours.release(hit)
                ref.release(hit)
                continue
            assert 0 not in fresh
            pages = hit + fresh
            pairs = [(b.sequence_hash, b.local_hash) for b in blocks]
            ours.register(pages[: len(pairs)], pairs, None)
            ref.register(pages[: len(pairs)], pairs, None)
            live.append(pages)
        elif op <= 3 and live:  # finish a sequence
            pages = live.pop(rng.randint(0, len(live)))
            ours.release(pages)
            ref.release(pages)
        elif op == 4:
            if rng.rand() < 0.2:
                ours.clear_cache()
                ref.clear_cache()
            else:  # misuse: a page nobody holds is a counted violation
                pid = int(rng.randint(1, 24))
                if not any(pid in p for p in live):
                    ours.release([pid])
                    ref.release([pid])
        assert _state(ours) == _state(ref)
        assert ev_t == ev_j
    assert ours.lookups > 0 and ours.hits > 0
    assert any(e["type"] == "removed" for e in ev_t)


def test_page_zero_is_never_allocated():
    a = PageAllocator(8, PAGE)
    assert a.allocate(8) is None
    got = a.allocate(7)
    assert sorted(got) == list(range(1, 8))
    assert a.allocate(1) is None
    a.release([got[2]])
    assert a.allocate(1) == [got[2]]
    with pytest.raises(ValueError):
        PageAllocator(1, PAGE)
