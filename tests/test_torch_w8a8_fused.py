"""The fused row quantizations of the W8A8 path (`ops/w8a8.py`
`rms_norm_quantize_rows`, `silu_mul_quantize_rows`) on the CPU, where
their wrappers run the plain versions.

- Each plain version is byte-equal to the composition it replaces (torch's
  `rms_norm` or `F.silu(gate) * up`, then `quantize_rows_plain`) on rows
  with an all-zero row, exact .5 ties and an amax of 127, with the norm's
  weight offset 0.0 and 1.0 (Gemma's), and writes its rows to `y`.
- The GEMM of the fused norm's codes equals the JAX package's eager
  `rms_norm` then `quant_matmul` byte for byte, the tolerance of
  `tests/test_torch_w8a8.py::test_quant_matmul_equals_jax_eager`. The rows
  are bf16, the model's dtype on the card: there the two packages' norms
  agree bit for bit on the CPU, while in f32 XLA's reduction leaves the
  last bits of torch's.
- `quant_plan` covers each row's vectors once, within a cluster of 8 and a
  block's registers, at every shape the 8B and tiny configs quantize, and
  mirrors `csrc/w8a8.cu`'s constants.
- The wrappers refuse what the kernels do not take (on the meta device: no
  kernel runs).
- A CPU forward of a 2-layer W8A8 model, SiLU and GELU, calls each plain
  version as often as `chip_smoke.path_launches` says the card launches
  its kernel.

No kernel runs here: `chip_smoke.py` phase 3 holds the kernels to these
plain versions on the card.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu.ops.norm import rms_norm as jax_rms_norm
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import quant, w8a8
from dynamo_tpu_torch.ops.norm import rms_norm
from tests.test_torch_model import port_prefill_then_decode
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

SMS = 132  # the H100 SXM's SM count
CSRC = os.path.join(os.path.dirname(w8a8.__file__), os.pardir, "csrc", "w8a8.cu")
TIES = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]


def _bytes(t) -> bytes:
    return np.asarray(t).tobytes() if not isinstance(t, torch.Tensor) else \
        t.contiguous().view(torch.uint8).numpy().tobytes()


def _rows(rng, m, k):
    """Rows of several magnitudes, row m // 2 all zeros, row 0 holding the
    .5 ties and an amax of 127 (`chip_smoke._w8a8_x`'s pattern)."""
    x = (rng.randn(m, k) * rng.uniform(0.01, 8.0, size=(m, 1))).astype(np.float32)
    x[m // 2] = 0.0
    x[0] = rng.randn(k)
    x[0, :6] = TIES
    return x


def _silu_inputs(rng, m, k):
    """gate and up whose product's row 0 is 64 x TIES, amax 8128: silu(64)
    is 64 in f32, so the scale is 64 and the codes meet the ties exactly."""
    gate = _rows(rng, m, k)
    up = (rng.randn(m, k) * 2).astype(np.float32)
    gate[0] = 64.0
    up[0] = np.clip(up[0], -100, 100)
    up[0, :6] = TIES
    return gate, up


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_norm_plain_is_the_composition(dtype, offset):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(_rows(rng, 9, 96)).to(dtype)
    w = torch.from_numpy(rng.uniform(0.25, 1.75, size=96).astype(np.float32)).to(dtype)
    y = torch.empty_like(x)
    q, s = w8a8.rms_norm_quantize_rows(x, w, 1e-5, offset, y=y)
    want_y = rms_norm(x, w, 1e-5, offset)
    wq, ws = w8a8.quantize_rows_plain(want_y)
    assert _bytes(y) == _bytes(want_y)
    assert _bytes(q) == _bytes(wq) and _bytes(s) == _bytes(ws)
    assert s[4] == 1.0 and not q[4].any()  # the zero row
    again = quant.rms_norm_quantize_act(x.reshape(1, 9, 96), w, 1e-5, offset)
    assert again.lead == (1, 9) and again.dtype == dtype
    assert torch.equal(again.q, q) and torch.equal(again.s, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_mul_plain_is_the_composition(dtype):
    rng = np.random.RandomState(2)
    g, u = (torch.from_numpy(a).to(dtype) for a in _silu_inputs(rng, 9, 64))
    y = torch.empty_like(g)
    q, s = w8a8.silu_mul_quantize_rows(g, u, y=y)
    want_y = F.silu(g) * u
    wq, ws = w8a8.quantize_rows_plain(want_y)
    assert _bytes(y) == _bytes(want_y)
    assert _bytes(q) == _bytes(wq) and _bytes(s) == _bytes(ws)
    assert s[0] == 64.0 and q[0, :6].tolist() == [127, 2, -4, 0, 0, 126]
    again = quant.silu_mul_quantize_act(g.reshape(3, 3, 64), u.reshape(3, 3, 64))
    assert again.lead == (3, 3) and torch.equal(again.q, q) and torch.equal(again.s, s)


@pytest.mark.parametrize("out_dtype", [None, "float32"])
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_fused_norm_gemm_equals_jax_eager(out_dtype, offset):
    rng = np.random.RandomState(3)
    m, k, n = 17, 128, 68
    x = _rows(rng, m, k)
    nw = rng.uniform(0.25, 1.75, size=k).astype(np.float32)
    w = (rng.randn(k, n) * rng.uniform(0.01, 3.0, size=(1, n))).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w, jnp.bfloat16))
    tw = quant.quantize_weight(torch.from_numpy(w).to(torch.bfloat16))
    jod = None if out_dtype is None else getattr(jnp, out_dtype)
    jy = jax_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw, jnp.bfloat16), 1e-5,
                      weight_offset=offset)
    want = np.asarray(jquant.quant_matmul(jy, jw, out_dtype=jod))
    q, s = w8a8.rms_norm_quantize_rows(torch.from_numpy(x).to(torch.bfloat16),
                                       torch.from_numpy(nw).to(torch.bfloat16), 1e-5, offset)
    got = w8a8.w8a8_gemm_plain(q, s, tw["q"], tw["s"],
                               getattr(torch, out_dtype or "bfloat16"))
    bits = np.int16 if got.dtype == torch.bfloat16 else np.int32
    assert _bytes(got) == np.ascontiguousarray(want).view(bits).tobytes()


def _quantized_shapes(name):
    """(m, k) of every row quantization a model step of the config makes,
    at decode, verify, prefill and mixed row counts."""
    c = get_config(name)
    ks = {c.hidden_size, c.num_heads * c.head_dim, c.intermediate_size}
    rows = {1, 8, 9, 17, 64, 65, 130, 512, 4096}
    return sorted((m, k) for m in rows for k in ks)


QUANT_CASES = sorted({(m, k, e) for name in ("llama-3.1-8b", "tiny")
                      for m, k in _quantized_shapes(name) for e in (2, 4)}
                     | {(m, k, e) for m in (1, 8, 65) for k in (32, 4128, w8a8.MAX_K)
                        for e in (2, 4)})


@pytest.mark.parametrize("split", [1, 8])
@pytest.mark.parametrize("m,k,elem", QUANT_CASES)
def test_quant_plan_covers_each_row_once(m, k, elem, split):
    p = w8a8.quant_plan(m, k, SMS, elem, split)
    nvec = k * elem // 16
    fewest = -(-nvec // (w8a8.Q_THREADS * w8a8.Q_VEC))  # blocks a row needs
    assert 1 <= p.cluster <= w8a8.MAX_CLUSTER
    # every block takes at least one vector; the blocks take each once
    assert (p.cluster - 1) * p.per < nvec <= p.cluster * p.per
    assert p.threads % 32 == 0 and 32 <= p.threads <= w8a8.Q_THREADS
    assert p.per <= p.threads * w8a8.Q_VEC  # a block holds its slice in registers
    assert p.blocks == m * p.cluster
    if m > w8a8.ROWS_MAX or split == 1:
        assert p.cluster == fewest
    elif p.cluster > fewest:  # split for the SMs, within the kernel's bound
        assert p.cluster <= split and m * p.cluster <= SMS


def test_quant_plan_splits_decode_rows():
    """At the 8B decode shapes SiLU x up's row takes a cluster of 8 blocks
    and the other kernels' rows one block, a thread one vector (two of a
    14,336-wide row unsplit); a prefill row one block of four vectors a
    thread."""
    assert w8a8.DECODE_CLUSTER == {"quantize_rows": 1, "rms_norm_quantize_rows": 1,
                                   "silu_mul_quantize_rows": 8}
    assert w8a8.quant_plan(8, 14336, SMS, 2, 8) == (8, 224, 224, 64)
    assert w8a8.quant_plan(8, 4096, SMS, 2, 8) == (8, 64, 64, 64)
    assert w8a8.quant_plan(8, 4096, SMS) == (1, 512, 512, 8)
    assert w8a8.quant_plan(8, 14336, SMS) == (1, 1792, 1024, 8)
    assert w8a8.quant_plan(64, 4096, SMS, 2, 8).cluster == 2  # 128 blocks on 132 SMs
    for k in (4096, 14336):
        assert w8a8.quant_plan(4096, k, SMS, 2, 8) == (1, k // 8, -(-k // 32 // 32) * 32, 4096)
    assert w8a8.quant_plan(8, 4096, SMS) is w8a8.quant_plan(8, 4096, SMS)  # cached
    with pytest.raises(ValueError, match="cluster"):
        w8a8.quant_plan(1, 2 * w8a8.MAX_K, SMS, 4)


def test_quant_constants_mirror_the_source():
    src = open(CSRC).read()
    found = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (found["kQThreads"], found["kQVec"], found["kMaxCluster"]) == (
        w8a8.Q_THREADS, w8a8.Q_VEC, w8a8.MAX_CLUSTER)


@pytest.mark.parametrize("what", ["device", "dtype", "weight", "k", "layout", "y", "up"])
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(what):
    dev = "meta"
    x = torch.empty((8, 64), dtype=torch.bfloat16, device=dev)
    w = torch.empty((64,), dtype=torch.bfloat16, device=dev)
    up = torch.empty((8, 64), dtype=torch.bfloat16, device=dev)
    y = None
    if what == "dtype":
        x = x.half()
    elif what == "weight":
        w = w.float()
        up = torch.empty((8, 32), dtype=torch.bfloat16, device=dev)
    elif what == "k":
        x, w, up = x[:, :40].contiguous(), w[:40], up[:, :40].contiguous()
    elif what == "layout":
        x = torch.empty((64, 8), dtype=torch.bfloat16, device=dev).T
    elif what == "y":
        y = torch.empty((8, 64), dtype=torch.float32, device=dev)
    elif what == "up":
        up = up.float()
        w = torch.empty((32,), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="rms_norm_quantize_rows takes"):
        w8a8.rms_norm_quantize_rows(x, w, 1e-5, y=y)
    with pytest.raises(ValueError, match="silu_mul_quantize_rows takes"):
        w8a8.silu_mul_quantize_rows(x, up, y=y)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_model_calls_what_path_launches_predicts(act):
    """Prefill then decode on a 2-layer W8A8 model: each plain version runs
    as often as the card would launch its kernel (the fused plain versions
    quantize through quantize_rows_plain, which counts their calls too)."""
    tc = get_config("tiny").with_(num_layers=2, hidden_act=act)
    params = llama.init_params(tc, 0, device="cpu", dtype=torch.float32, quantize=True)
    rng = np.random.RandomState(4)
    t = 20
    toks = rng.randint(1, tc.vocab_size, size=(1, t + 1)).astype(np.int32)
    pages = np.array([3, 1, 4], np.int32)
    kv = llama.init_kv_cache(tc, 8 * 16, dtype=torch.float32, device="cpu")
    chip_smoke.reset_counts()
    _, logits = port_prefill_then_decode(params, tc, kv, toks, t, pages)
    assert np.isfinite(logits).all()
    stats = {"prefill_dispatches": 1, "decode_dispatches": 1, "mixed_steps": 0,
             "spec_dispatches": 0}
    want = chip_smoke.path_launches(stats, tc.num_layers, 1, None, w8a8=True, act=act)
    calls = {name: plain for name, (_, plain) in chip_smoke.read_counts().items()}
    calls["quantize_rows"] -= calls["rms_norm_quantize_rows"] + calls["silu_mul_quantize_rows"]
    assert {k: v for k, v in calls.items() if v} == want
    assert want["rms_norm_quantize_rows"] == 2 * 2 * tc.num_layers
    assert want.get("silu_mul_quantize_rows", 0) == (2 * tc.num_layers if act == "silu" else 0)
