"""Mixed prefill+decode steps and speculative decoding on the port, against
the JAX package, in float32 on the CPU: the pieces.

- `write_kv_rows` (the row write of mixed and verify steps) byte-equal to
  the JAX row write (`write_kv_slots` and `scatter_kv_scales`, and the
  packed-pool byte-lane write read back through `unpack_kv_slots`), in
  bf16/f32, int8 and int4, at mid-page slots with trash padding;
- K4's plain versions (`ragged_paged_attention*_plain`) against the JAX
  `ragged_paged_attention` in interpret mode, decode, verify, chunk and
  q_len 0 rows in one rectangle, at 2e-5 (f32) and 2e-4 (quantized);
- the copied `NgramProposer` step for step equal to the JAX one;
- `verify_draft_tokens`: greedy rows exactly JAX's; sampled rows (a fixed
  generator) keep `sample_tokens`' marginals and JAX's acceptance rate
  within 5 sigma;
- the engine's policy on the trained checkpoint (mixed_spec off,
  mixed_decode_priority off, the budget cap with verify rows, preemption)
  and the config checks. The engine against JaxEngine is in
  tests/test_torch_mixed_spec_engine.py.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import spec as jspec
from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu.ops import sampling as jsampling
from dynamo_tpu.ops.pallas_attention import ragged_paged_attention as jax_ragged
from dynamo_tpu_torch.engine import EngineConfig, spec
from dynamo_tpu_torch.ops.attention import write_kv_rows
from dynamo_tpu_torch.ops.decode_attention import (
    ragged_paged_attention,
    ragged_paged_attention_plain,
    ragged_paged_attention_q4_plain,
    ragged_paged_attention_q_plain,
)
from dynamo_tpu_torch.ops.sampling import sample_tokens, verify_draft_tokens
from tests.test_torch_engine import _greedy, _port_engine, _tokenizer
from tests.test_torch_kv_int4 import _int4_pools
from tests.test_torch_kv_quant import _int8_pools, jax_scales
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

PAGE = 16
FORMATS = ("f32", "int8", "int4")
# the JAX side runs jitted: one compile per shape instead of one per op
jax_verify = jax.jit(jsampling.verify_draft_tokens, static_argnames=("all_greedy",))


# ------------------------------------------------------------ row write


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_kv_rows_byte_equal_to_jax(fmt):
    rng = np.random.RandomState(len(fmt))
    kh, hd, num_pages = 2, 32, 6
    n = num_pages * PAGE
    # mid-page slots of three pages, a page boundary crossed, and padding
    # columns into slot 0 (the trash page)
    slots = np.array([5 * PAGE + 3, 2 * PAGE + 15, 3 * PAGE, 3 * PAGE + 1, 0, 0,
                      4 * PAGE + 9, 1 * PAGE + 7], np.int32)
    m = len(slots)
    rows_k = (rng.randn(m, kh * hd) * rng.uniform(0.1, 4.0, size=(m, 1))).astype(np.float32)
    rows_v = (rng.randn(m, kh * hd) * rng.uniform(0.1, 4.0, size=(m, 1))).astype(np.float32)
    rows_k[6, :hd] = 0.0  # an all-zero head: scale 1.0
    live = slice(PAGE, None)  # several padding columns race on the trash page
    if fmt == "f32":
        k = rng.randn(n, kh * hd).astype(np.float32)
        v = rng.randn(n, kh * hd).astype(np.float32)
        jk, jv = jattn.write_kv_slots(jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots),
                                      jnp.asarray(rows_k), jnp.asarray(rows_v))
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        write_kv_rows(tk, tv, torch.from_numpy(slots), torch.from_numpy(rows_k),
                      torch.from_numpy(rows_v))
        assert tk.numpy()[live].tobytes() == np.asarray(jk)[live].tobytes()
        assert tv.numpy()[live].tobytes() == np.asarray(jv)[live].tobytes()
        return
    int4 = fmt == "int4"
    pools = _int4_pools if int4 else _int8_pools
    k, v, ks, vs = pools(rng, num_pages, kh, hd)

    # eager, as the quant helpers' own parity tests run them: under jit XLA
    # turns amax / 127 into a multiply by 1/127, one scale ulp off
    if int4:
        (jkr, jks_r), (jvr, jvs_r) = (jquant.quantize_kv_rows_int4(jnp.asarray(r), kh)
                                      for r in (rows_k, rows_v))
    else:
        (jkr, jks_r), (jvr, jvs_r) = (jquant.quantize_kv_rows(jnp.asarray(r), kh)
                                      for r in (rows_k, rows_v))
    js = jnp.asarray(slots)
    jks = jquant.scatter_kv_scales(jax_scales(ks), js, jks_r, kh)
    jvs = jquant.scatter_kv_scales(jax_scales(vs), js, jvs_r, kh)
    # the dense int8 pools of the gather path ...
    jk, jv = jattn.write_kv_slots(jnp.asarray(k), jnp.asarray(v), js, jkr, jvr)
    # ... and the int32-packed pools of the Pallas path, read back
    pk = jquant.unpack_kv_slots(jquant.scatter_packed_kv_rows(
        jquant.pack_kv_slots(jnp.asarray(k)), js, jkr))
    pv = jquant.unpack_kv_slots(jquant.scatter_packed_kv_rows(
        jquant.pack_kv_slots(jnp.asarray(v)), js, jvr))
    tk, tv, tks, tvs = (torch.from_numpy(x.copy()) for x in (k, v, ks, vs))
    write_kv_rows(tk, tv, torch.from_numpy(slots), torch.from_numpy(rows_k),
                  torch.from_numpy(rows_v), tks, tvs, int4=int4)
    for got, want in ((tk, jk), (tv, jv), (tk, pk), (tv, pv)):
        assert got.numpy()[live].tobytes() == np.asarray(want)[live].tobytes()
    for got, want in ((tks, jks), (tvs, jvs)):
        assert np.asarray(jax_scales(got.numpy()))[1:].tobytes() == np.asarray(want)[1:].tobytes()
    # the rows really landed (not a no-op on both sides)
    assert not np.array_equal(tk.numpy()[live], k[live])


# ------------------------------------------------------------ K4


@contextlib.contextmanager
def _one_torch_thread():
    """The port's side of a K4 parity case computed on the calling thread
    alone. With torch's default threads, the whole file run beside other
    test processes (tier-1's `-n 6` load) failed the [4-4-f32] case in 4
    of 44 runs: one thread's chunk of the port's batched (row, kv head)
    products came out off by up to 4.5e-5 (row 4 twice, with the same
    bits, rows 2 and 0 once each), while JAX's interpret-mode kernel gave
    the same bits every run, and the same call repeated right after (40
    times, at 8 threads and at 1) gave the usual ones. Pinned, 0 of 43
    runs failed under the same load (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 2)])  # G = 1, 2, 4
def test_ragged_attention_matches_jax_kernel(fmt, h, kh):
    hd, t, w = 16, 24, 5
    rng = np.random.RandomState(h * 10 + kh + len(fmt))
    # one rectangle: a decode row (q_len 1, mid-page), a verify row (q_len
    # 5 from pos0 14, across the page boundary at 16), a chunk row (causal
    # inside the chunk, mid-page pos0), a q_len 0 row, a second decode row
    pos0 = np.array([37, 14, 9, 0, 60], np.int32)
    q_lens = np.array([1, 5, 24, 0, 1], np.int32)
    b = len(pos0)
    num_pages = b * w + 2
    tables = np.stack([rng.permutation(num_pages - 1)[:w] + 1 for _ in range(b)]).astype(np.int32)
    q = rng.randn(b, t, h, hd).astype(np.float32)
    args = (tables, pos0, q_lens)
    jax_k4 = jax.jit(functools.partial(jax_ragged, page_size=PAGE, interpret=True,
                                       int4=fmt == "int4"))
    if fmt == "f32":
        k = rng.randn(num_pages * PAGE, kh * hd).astype(np.float32)
        v = rng.randn(num_pages * PAGE, kh * hd).astype(np.float32)
        want = jax_k4(*(jnp.asarray(x) for x in (q, k, v, *args)))
        with _one_torch_thread():
            got = ragged_paged_attention(*(torch.from_numpy(x) for x in (q, k, v, *args)),
                                         page_size=PAGE)
        tol, plain = 2e-5, ragged_paged_attention_plain
    else:
        int4 = fmt == "int4"
        k, v, ks, vs = (_int4_pools if int4 else _int8_pools)(rng, num_pages, kh, hd)
        want = jax_k4(*(jnp.asarray(x) for x in (q, k, v, *args)), jax_scales(ks),
                      jax_scales(vs))
        with _one_torch_thread():
            got = ragged_paged_attention(
                *(torch.from_numpy(x) for x in (q, k, v, *args, ks, vs)), page_size=PAGE,
                int4=int4)
        tol = 2e-4
        plain = ragged_paged_attention_q4_plain if int4 else ragged_paged_attention_q_plain
    assert plain.calls > 0
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == (b, t, h, hd)
    for i in range(b):
        n = int(q_lens[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=tol, atol=tol,
                                   err_msg=f"{fmt}: row {i} (q_pos0 {pos0[i]}, q_len {n})")
        tail_port = np.abs(got[i, n:]).max(initial=0.0)
        assert tail_port == 0.0, f"port: row {i} has |value| up to {tail_port} past q_len {n}"
        tail_jax = np.abs(want[i, n:]).max(initial=0.0)
        assert tail_jax == 0.0, f"JAX: row {i} has |value| up to {tail_jax} past q_len {n}"


def test_ragged_attention_counts_apart_from_prefill():
    from dynamo_tpu_torch.ops import prefill_attention as p

    before = (p.flash_prefill_attention_plain.calls, ragged_paged_attention_plain.calls)
    x = torch.zeros((1, 2, 2, 32))
    pool = torch.zeros((2 * PAGE, 64))
    one = torch.ones(1, dtype=torch.int32)
    ragged_paged_attention(x, pool, pool, one[:, None], one, one, page_size=PAGE)
    assert (p.flash_prefill_attention_plain.calls, ragged_paged_attention_plain.calls) == (
        before[0], before[1] + 1)
    with pytest.raises(ValueError, match="int4 KV needs scale pools"):
        ragged_paged_attention(x, pool, pool, one[:, None], one, one, page_size=PAGE, int4=True)


# ------------------------------------------------------------ NgramProposer


def _proposer_state(p):
    return (p.history, p._hist_base, dict(p._index), [list(a) for a in p._added],
            p._added_base, p.ema, p._cooldown, p.drafted, p.accepted, p.gate_open())


@pytest.mark.parametrize("stream", ["random", "periodic"])
def test_ngram_proposer_equals_jax(stream):
    rng = np.random.RandomState(7)
    if stream == "random":
        toks = rng.randint(1, 12, size=600).tolist()
    else:
        toks = ([3, 1, 4, 1, 5, 9, 2, 6] * 40 + rng.randint(1, 30, size=60).tolist()
                + [2, 7, 1, 8] * 30)
    mine, ref = spec.NgramProposer(3, index_window=64), jspec.NgramProposer(3, index_window=64)
    drafts = 0
    for i in range(0, len(toks), 3):
        mine.extend(toks[i:i + 3])
        ref.extend(toks[i:i + 3])
        k = i % 5
        assert mine.propose(k) == ref.propose(k)
        d_mine, d_ref = mine.maybe_draft(4), ref.maybe_draft(4)
        assert d_mine == d_ref
        drafts += bool(d_mine)
        if d_mine:
            acc = int(rng.randint(0, len(d_mine) + 1))
            mine.observe(len(d_mine), acc)
            ref.observe(len(d_ref), acc)
        elif i % 7 == 0:
            mine.shed_tick()
            ref.shed_tick()
        assert _proposer_state(mine) == _proposer_state(ref)
    # the window evicted (history and index stay bounded) and drafting ran
    assert mine._added_base > 0 and len(mine._index) <= 3 * 64
    assert drafts > 0


# ------------------------------------------------------------ verify_draft_tokens


def _greedy_case():
    rng = np.random.RandomState(11)
    b, t, v = 6, 5, 40
    logits = (rng.randn(b, t, v) * 3).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = greedy[:, : t - 1].copy().astype(np.int32)
    draft[1, 0] = (draft[1, 0] + 1) % v   # first draft wrong
    draft[2, 2] = (draft[2, 2] + 3) % v   # third draft wrong
    draft[4, 1] = (draft[4, 1] + 1) % v
    dlen = np.array([4, 4, 4, 0, 2, 3], np.int32)
    return logits, draft, dlen


@pytest.mark.parametrize("all_greedy", [True, False])
def test_verify_greedy_equals_jax(all_greedy):
    logits, draft, dlen = _greedy_case()
    b = logits.shape[0]
    jout, jn = jax_verify(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(dlen), jax.random.PRNGKey(0),
        jnp.zeros(b), jnp.zeros(b, jnp.int32), jnp.ones(b), all_greedy=all_greedy)
    gen = torch.Generator().manual_seed(0)
    out, n = verify_draft_tokens(
        torch.from_numpy(logits), torch.from_numpy(draft), torch.from_numpy(dlen), gen,
        torch.zeros(b), torch.zeros(b, dtype=torch.int32), torch.ones(b),
        all_greedy=all_greedy)
    assert n.tolist() == np.asarray(jn).tolist() == [5, 1, 3, 1, 2, 4]
    # emitted positions are exactly JAX's (and the argmaxes)
    for i, k in enumerate(n.tolist()):
        assert out[i, :k].tolist() == np.asarray(jout)[i, :k].tolist()
        assert out[i, :k].tolist() == logits[i, :k].argmax(-1).tolist()


def test_verify_sampled_keeps_distribution():
    n_draws, t, v = 20000, 3, 24
    temp, top_k, top_p = 0.8, 12, 0.95
    rng = np.random.RandomState(5)
    row = rng.randn(t, v).astype(np.float32)
    draft_row = np.array([3, 7], np.int32)
    row[np.arange(t - 1), draft_row] += 3.5  # the drafts are likely
    # the target distribution of each position (the sampler's own mask)
    from dynamo_tpu_torch.ops.sampling import shortlist_mask

    cand, masked = shortlist_mask(torch.from_numpy(row) / temp, torch.full((t,), top_k),
                                  torch.full((t,), top_p))
    p = torch.zeros(t, v).scatter_(1, cand, torch.softmax(masked, -1))
    assert (p[torch.arange(t - 1), torch.from_numpy(draft_row).long()] >= 0.3).all()

    logits = np.broadcast_to(row, (n_draws, t, v)).copy()
    draft = np.broadcast_to(draft_row, (n_draws, t - 1)).copy()
    dlen = np.full(n_draws, t - 1, np.int32)
    samp = (np.full(n_draws, temp, np.float32), np.full(n_draws, top_k, np.int32),
            np.full(n_draws, top_p, np.float32))
    gen = torch.Generator().manual_seed(1234)
    out, n_emit = verify_draft_tokens(
        torch.from_numpy(logits), torch.from_numpy(draft), torch.from_numpy(dlen), gen,
        *(torch.from_numpy(x) for x in samp))
    out, n_emit = out.numpy(), n_emit.numpy()
    assert set(np.unique(n_emit)) <= {1, 2, 3}

    def plain_freq(j):
        toks = sample_tokens(torch.from_numpy(logits[:, j]), gen,
                             *(torch.from_numpy(x) for x in samp)).numpy()
        return np.bincount(toks, minlength=v) / n_draws

    def assert_close(got_toks, want_freq):
        m = len(got_toks)
        got = np.bincount(got_toks, minlength=v) / m
        pr = np.maximum(want_freq, 1.0 / n_draws)
        sigma = np.sqrt(pr * (1 - pr) * (1.0 / m + 1.0 / n_draws))
        assert np.all(np.abs(got - want_freq) <= 5 * sigma), np.abs(got - want_freq) / sigma

    # position 0: always emitted (accepted draft, or the residual draw)
    assert_close(out[:, 0], plain_freq(0))
    # position 1, given the first draft was accepted
    acc0 = out[:, 0] == draft_row[0]
    assert acc0.sum() > 0.3 * n_draws
    assert np.all(n_emit[acc0] >= 2) and np.all(n_emit[~acc0] == 1)
    assert_close(out[acc0, 1], plain_freq(1))
    # acceptance rate against JAX's verifier on the same logits
    _, jn = jax_verify(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(dlen), jax.random.PRNGKey(3),
        *(jnp.asarray(x) for x in samp))
    a_mine, a_jax = n_emit - 1.0, np.asarray(jn) - 1.0
    sigma = np.sqrt((a_mine.var() + a_jax.var()) / n_draws)
    assert abs(a_mine.mean() - a_jax.mean()) <= 5 * sigma


# ------------------------------------------------------------ engine policy


def _traffic():
    """Three requests at once on the trained checkpoint: a 30-token
    prompt, a 144-token one (five chunks of 32 at most) and a short one.
    The text repeats, so the proposer drafts."""
    tok = _tokenizer()
    line = tok.encode(" ".join(["the capital of germany is berlin . berlin is the capital "
                                "of germany ."] * 6))
    return [(line[:30], 24), (line + line[:60], 12), (tok.encode("the capital of france is"), 12)]


async def _serve(traffic, **kw):
    eng = _port_engine(**kw)
    outs = await asyncio.gather(*[_greedy(eng, ids, n) for ids, n in traffic])
    stats = eng.phase_stats
    await eng.close()
    return list(outs), stats


async def test_mixed_spec_off_gives_no_verify_rows():
    traffic = _traffic()
    plain, _ = await _serve(traffic)
    outs, st = await _serve(traffic, mixed_batching=True, mixed_step_tokens=64,
                            spec_decode=True, mixed_spec=False)
    assert outs == plain
    assert st["mixed_steps"] > 0 and st["mixed_spec_rows"] == 0
    # mixed steps carried decode rows at q_len 1: 1 budget token each
    assert st["mixed_step_tokens_max"] == 32 + 2


async def test_decode_priority_off_defers_decode_when_budget_tight():
    # two prompts of exactly two chunks beside a short one: with the budget
    # at one chunk, every chunk fills it, so decode rows never fit beside
    # one and the mixed step stands down for the normal paths
    ids = [(7 * i) % 60 + 3 for i in range(64)]
    traffic = [([5, 7, 6, 35, 4], 16), (ids, 8), (ids[::-1], 8)]
    plain, _ = await _serve(traffic)
    kw = dict(mixed_batching=True, mixed_step_tokens=32)
    off, st_off = await _serve(traffic, mixed_decode_priority=False, **kw)
    on, st_on = await _serve(traffic, **kw)
    assert off == on == plain
    assert st_off["mixed_steps"] == 0
    # with priority the decode row joins and the chunks shrink around it
    assert st_on["mixed_steps"] > 0 and st_on["mixed_step_tokens_max"] <= 32


async def test_budget_cap_holds_with_verify_rows():
    traffic = _traffic()
    plain, _ = await _serve(traffic)
    budget = 26
    outs, st = await _serve(traffic, mixed_batching=True, mixed_step_tokens=budget,
                            spec_decode=True)
    assert outs == plain
    assert st["mixed_steps"] > 0 and st["mixed_spec_rows"] > 0
    assert 0 < st["mixed_step_tokens_max"] <= budget


async def test_preemption_under_mixed_and_spec_gives_plain_streams():
    traffic = _traffic()
    kw = dict(num_pages=14, max_batch_size=3)
    plain, _ = await _serve(traffic, **kw)
    outs, st = await _serve(traffic, mixed_batching=True, mixed_step_tokens=64,
                            spec_decode=True, **kw)
    assert outs == plain
    assert st["preemptions"] > 0 and st["mixed_steps"] > 0
    assert st["spec_rows"] > 0


def test_select_mixed_prefill_policy():
    eng = _port_engine(page_size=8, prefill_chunk=32, mixed_batching=True)

    class _Ctx:
        stopped = False

        def is_stopped(self):
            return self.stopped

    class _Seq:
        num_computed = 0
        needs_ext_sampling = False
        preloaded = None  # no remotely prefilled KV to land
        prompt_embeds = None  # no image span to inject

        def __init__(self, total):
            self.total_tokens = total
            self.ctx = _Ctx()

    a, b, c = _Seq(30), _Seq(45), _Seq(5)
    eng._prefilling.extend([a, b, c])
    # a: final chunk of 30; b: min(45, 32, 10) = 10, non-final, rounds down
    # to a page (8); c: 2 tokens left, non-final rounds to 0: the scan stops
    assert [(s, ch) for s, ch in eng._select_mixed_prefill(40)] == [(a, 30), (b, 8)]
    # a front sequence that cannot take a page stops the scan (strict FIFO)
    assert eng._select_mixed_prefill(7) == []
    # so does one on the extended sampler (it prefills on the normal path)
    b.needs_ext_sampling = True
    assert [(s, ch) for s, ch in eng._select_mixed_prefill(40)] == [(a, 30)]
    b.needs_ext_sampling = False
    # and one with prompt embeds (the normal dispatch injects them)
    b.prompt_embeds = object()
    assert [(s, ch) for s, ch in eng._select_mixed_prefill(40)] == [(a, 30)]
    b.prompt_embeds = None
    a.ctx.stopped = True
    assert eng._select_mixed_prefill(40) == []
    eng._prefilling.clear()


@pytest.mark.parametrize(
    "field,value,match",
    [("spec_k_max", 0, "spec_k_max"), ("mixed_step_tokens", 0, "mixed_step_tokens")],
)
def test_config_validation(field, value, match):
    on = {"spec_k_max": {"spec_decode": True}, "mixed_step_tokens": {"mixed_batching": True}}
    with pytest.raises(ValueError, match=match):
        EngineConfig(model="tiny", **on[field], **{field: value})
    EngineConfig(model="tiny", **{field: value})  # ignored while the feature is off


def test_config_defaults_match_jax():
    from dynamo_tpu.engine import EngineConfig as JaxConfig

    mine, ref = EngineConfig(model="tiny"), JaxConfig(model="tiny")
    for name in ("spec_decode", "spec_k_max", "spec_ngram_max", "spec_index_window",
                 "mixed_batching", "mixed_spec", "mixed_step_tokens",
                 "mixed_decode_priority"):
        assert getattr(mine, name) == getattr(ref, name), name
    served = EngineConfig(model="tiny", spec_decode=True, mixed_batching=True)
    assert served.spec_decode and served.mixed_batching
