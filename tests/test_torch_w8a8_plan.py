"""The W8A8 GEMM's host-side plan (`ops/w8a8.py` `gemm_plan`) walked over
every shape the 8B and tiny configs launch, the wrappers' refusals, the
split kernels' shared scratch (`ops/_cuda.scratch`), the decode-chain
trace's arithmetic (`scripts/trace_w8a8.py`), and the KV quantizer's true
division on the edge input the card check reuses.

No engine is built and no kernel runs: the plan reads shapes only, and
`chip_smoke.py` phase 3 holds the kernels it launches against the plain
version on the card. The KV case pins the inputs at which PyTorch's CUDA
division by a Python scalar (a product with the reciprocal) leaves the
reference's true division: f32 0.143 / 127 and 0.143 / 7.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import _cuda, quant, w8a8
from dynamo_tpu_torch.scripts import trace_w8a8
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

SMS = 132  # the H100 SXM's SM count
CSRC = os.path.join(os.path.dirname(w8a8.__file__), os.pardir, "csrc", "w8a8.cu")


def _projections(name):
    """(K, N) of every GEMM a model step of the config launches."""
    c = get_config(name)
    d, q, kv = c.hidden_size, c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    return [(d, q), (d, kv), (q, d), (d, c.intermediate_size), (c.intermediate_size, d),
            (d, c.vocab_size)]


# decode, verify and chunk rows, either side of the threshold, a prefill
# of 8 x 512, and the mixed rectangles' [pow2 rows, bucket] row counts
ROWS = sorted({1, 8, 17, 64, 65, 4096}
              | {r * t for r in (2, 4, 8, 16) for t in (5, 16, 128, 512)})
CASES = [(name, m, k, n) for name in ("llama-3.1-8b", "tiny") for m in ROWS
         for k, n in _projections(name)]


@pytest.mark.parametrize("name,m,k,n", CASES)
def test_plan_covers_k_once(name, m, k, n):
    p = w8a8.gemm_plan(m, n, k, SMS)
    assert p.variant in (("rows", "rows_wide") if m <= w8a8.ROWS_MAX else ("tiles",))
    vid, cons, bn, _stages, _resident = w8a8.GEMM_VARIANTS[p.variant]
    assert (p.variant_id, p.bm, p.bn) == (vid, 64 * cons, bn)
    assert p.k_tiles == -(-k // w8a8.K_TILE)
    # every split takes at least one k tile, and the splits take each once
    assert 1 <= p.splits <= p.k_tiles
    assert (p.splits - 1) * p.per_split < p.k_tiles <= p.splits * p.per_split
    tiles = -(-m // p.bm) * -(-n // p.bn)
    assert p.grid == (-(-m // p.bm), -(-n // p.bn), p.splits)
    assert p.blocks == min(tiles * p.splits, w8a8.GEMM_VARIANTS[p.variant][4] * SMS)
    if p.splits > 1:
        assert p.workspace_bytes == 4 * p.splits * m * (-(-n // 4) * 4)
        assert p.counters == tiles
    else:
        assert p.workspace_bytes == 0 and p.counters == 0
    if p.variant == "tiles" and 2 * tiles > SMS:
        assert p.splits == 1  # the tensor-core-bound tiles split only when few
    if p.variant != "tiles":
        slots = w8a8.GEMM_VARIANTS[p.variant][4] * SMS
        assert tiles * p.splits <= slots or p.splits == 1  # one wave, or no split to cut
        assert p.variant == ("rows_wide" if n >= w8a8.WIDE_N else "rows")


@pytest.mark.parametrize("k,n", _projections("llama-3.1-8b"))
def test_decode_shapes_fill_the_card(k, n):
    """At the 8B decode shapes (8 rows) the grid fills every SM in one
    wave of two blocks an SM, K split as the plan says (the head needs no
    split; it and w_gate/w_up take 128-column tiles)."""
    p = w8a8.gemm_plan(8, n, k, SMS)
    assert p.variant == ("rows_wide" if n >= 14336 else "rows") and p.blocks >= SMS
    want = {(4096, 4096): 4, (4096, 1024): 16, (4096, 14336): 2, (14336, 4096): 4,
            (4096, 128256): 1}
    assert p.splits == want[(k, n)]


def test_prefill_shapes_take_whole_k():
    for k, n in _projections("llama-3.1-8b")[:5]:
        p = w8a8.gemm_plan(4096, n, k, SMS)
        assert (p.variant, p.splits, p.workspace_bytes) == ("tiles", 1, 0)
        assert p.blocks == min(p.grid[0] * p.grid[1], SMS)


def test_variants_mirror_the_source():
    """GEMM_VARIANTS names the instantiations csrc/w8a8.cu launches by id."""
    src = open(CSRC).read()
    found = {int(i): tuple(map(int, t)) for *t, i in re.findall(
        r"using \w+ = Tile<(\d+), (\d+), (\d+)>;\s+// (\d+):", src)}
    assert found == {v[0]: v[1:4] for v in w8a8.GEMM_VARIANTS.values()}


def test_plan_is_cached():
    """An eager prefill plans 224 GEMMs: the plan of a shape is made once."""
    assert w8a8.gemm_plan(8, 1024, 4096, SMS) is w8a8.gemm_plan(8, 1024, 4096, SMS)


@pytest.mark.parametrize("what", ["device", "dtype", "shape", "k", "layout"])
def test_wrappers_refuse_what_the_kernels_do_not_take(what):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    on the meta device (no kernel), and on what the kernels do not take."""
    dev = "meta"
    xq = torch.empty((8, 64), dtype=torch.int8, device=dev)
    xs = torch.empty((8,), dtype=torch.float32, device=dev)
    wq = torch.empty((16, 64), dtype=torch.int8, device=dev)
    ws = torch.empty((16,), dtype=torch.float32, device=dev)
    x = torch.empty((8, 64), dtype=torch.bfloat16, device=dev)
    if what == "dtype":
        xs, x = xs.double(), x.half()
    elif what == "shape":
        wq, x = torch.empty((16, 32), dtype=torch.int8, device=dev), x[None]
    elif what == "k":
        xq, wq, x = xq[:, :40], wq[:, :40], x[:, :40]
    elif what == "layout":
        xq = torch.empty((64, 8), dtype=torch.int8, device=dev).T
        x = torch.empty((64, 8), dtype=torch.bfloat16, device=dev).T
    with pytest.raises(ValueError, match="w8a8_gemm takes"):
        w8a8.w8a8_gemm(xq, xs, wq, ws, torch.bfloat16)
    with pytest.raises(ValueError, match="quantize_rows takes"):
        w8a8.quantize_rows(x)


def test_scratch_is_one_registry_grown_on_demand():
    dev = torch.device("cpu")
    keys = [("_test_a", dev), ("_test_b", dev)]
    try:
        part, tickets = _cuda.scratch("_test_a", dev, 10, torch.float32, 3)
        assert part.dtype == torch.float32 and part.numel() == 10
        assert tickets.dtype == torch.int32 and tickets.tolist() == [0, 0, 0]
        again = _cuda.scratch("_test_a", dev, 4, torch.float32, 2)
        assert again[0] is part and again[1] is tickets  # big enough: kept
        grown = _cuda.scratch("_test_a", dev, 20, torch.float32, 2)
        assert grown[0].numel() == 20 and grown[1] is tickets
        other = _cuda.scratch("_test_b", dev, 5, torch.int32, 1)
        assert other[0].dtype == torch.int32 and other[0] is not grown[0]
        # what a decode graph keeps alive: every wrapper's buffers
        kept = [part for part, _ in _cuda.scratch_bufs.values()]
        assert any(p is grown[0] for p in kept) and any(p is other[0] for p in kept)
    finally:
        for k in keys:
            _cuda.scratch_bufs.pop(k, None)


def _trace_events(layers, replays, pdl_overlap=0.0):
    """A chrome trace's kernel events for `replays` replays of the chain:
    quantize kernels 2 us, starting 1 us after the end of the kernel
    before; GEMMs 10 us, starting as the kernel before ends, or, after a
    GEMM, `pdl_overlap` us before (a programmatic dependent launch, whose
    span then holds its wait); plus a foreign kernel the parser skips."""
    events, t = [{"cat": "kernel", "name": "elementwise_kernel", "ts": 0.0, "dur": 1.0}], 5.0
    for _ in range(replays):
        for _ in range(layers):
            prev = "quant"
            for role in trace_w8a8.ROLES:
                quant_ = role.startswith("quant")
                name = ("quantize_rows_kernel<bf16>" if quant_
                        else "w8a8_gemm_kernel<1, 64, 6, bf16>")
                early = 0.0 if quant_ or prev.startswith("quant") else pdl_overlap
                start = t + 1.0 if quant_ else t - early
                dur = 2.0 if quant_ else 10.0 + early
                prev = role
                events.append({"cat": "kernel", "name": name, "ts": start, "dur": dur})
                t = start + dur
        t += 100.0
    return events


@pytest.mark.parametrize("overlap", [0.0, 3.0])
def test_trace_stats(overlap):
    reps = trace_w8a8.chain_kernels(_trace_events(2, 3, overlap), 2)
    assert len(reps) == 3 and all(len(r) == 2 * len(trace_w8a8.ROLES) for r in reps)
    st = trace_w8a8.launch_stats(reps)
    assert st["quant_attn"] == {"dur": 2.0, "gap": 1.0, "step": 3.0}
    assert st["wk"] == {"dur": 10.0 + overlap, "gap": -overlap, "step": 10.0}
    assert st["wq"] == {"dur": 10.0, "gap": 0.0, "step": 10.0}
    # a layer's steps sum to the time the chain takes a layer
    assert sum(s["step"] for s in st.values()) == 4 * 3.0 + 7 * 10.0


def test_trace_refuses_a_broken_chain():
    events = _trace_events(1, 1)
    with pytest.raises(AssertionError, match="not a multiple"):
        trace_w8a8.chain_kernels(events[:-1], 1)
    events[1], events[2] = events[2], dict(events[1], ts=events[2]["ts"] + 0.5)
    with pytest.raises(AssertionError, match="not quant_in"):
        trace_w8a8.chain_kernels(events, 1)


def test_trace_script_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_w8a8.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _edge_rows():
    """[2, 8, 64] f32 rows (K 2, Hd 32), each head's amax an f32 at which
    the reciprocal's product leaves the true quotient for / 127 and / 7."""
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, size=(2, 8, 64)).astype(np.float32)
    heads = x.reshape(-1, 32)
    for i, h in enumerate(heads):
        amax = np.float32(0.143 if i % 2 == 0 else 0.141011)
        h *= 0.99 * amax / np.abs(h).max()
        h[i % 32] = -amax if i % 3 else amax
    return x


def test_kv_edge_inputs_are_division_edges():
    for d in (127, 7):
        a = np.float32(0.143)
        assert a / np.float32(d) != a * (np.float32(1) / np.float32(d))


@pytest.mark.parametrize("int4", [False, True])
def test_kv_quantizer_true_division_on_edges(int4):
    x = _edge_rows()
    fn, jfn = ((quant.quantize_kv_rows_int4, jquant.quantize_kv_rows_int4) if int4
               else (quant.quantize_kv_rows, jquant.quantize_kv_rows))
    q, s = fn(torch.from_numpy(x), 2)
    jq, js = jfn(jnp.asarray(x), 2)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    d = np.float32(7 if int4 else 127)
    assert s.numpy()[0, 0, 0] == np.float32(0.143) / d  # the true quotient, bit for bit
