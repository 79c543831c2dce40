"""The sparse-MoE family (dynamo_tpu_torch/models/moe.py) against the JAX
package on the CPU, on inputs made from a seed with numpy.

`moe_block` equals `dynamo_tpu.models.moe.moe_block` in float32 at the
tolerance of tests/test_moe.py (2e-4), and in bfloat16 within
`BF16_ROW_ULPS` ulps of each row's largest |value| and `BF16_REL_RMS` of
the output's RMS over all: the port computes SiLU in float32 and rounds
once, where JAX's CPU backend rounds the sigmoid and the product to bf16
each, and the batched products add in another order (measured: up to 4
such ulps, 0.4-0.55 % of the RMS). The cases of tests/test_moe.py hold: an
overflowing expert drops the same tokens, slot 0 of every token wins
capacity over any slot 1, padding rows take no capacity, and a tie in the
router's probabilities goes to the lower expert index. The tiny-moe
model's f32 logits equal JAX's in each attention mode (page-write prefill,
paged decode, ragged) and in int8 and int4 KV, with the JAX side run at
the port's padded shapes (capacity is a function of the step's row count);
W8A8 keeps the router and experts unquantized as JAX's `quantize_params`
does; `params_from_jax` and the safetensors loader carry Mixtral's leaves;
and tests/test_torch_moe_engine.py holds TorchEngine's streams.
"""

from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import moe as jmoe
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama, moe
from dynamo_tpu_torch.ops import quant
from tests.test_torch_kv_quant import kv_cache_from_jax
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

JC = jcfg.get_config("tiny-moe").with_(dtype="float32")
TC = tcfg.get_config("tiny-moe").with_(dtype="float32")
PAGE = 16
BF16_ROW_ULPS = 8
BF16_REL_RMS = 2.0 ** -6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX side jitted: one compile a shape costs less than eager op dispatch
_jmoe_block = jax.jit(jmoe.moe_block, static_argnums=(1,))
_jforward = jax.jit(jllama.forward, static_argnums=(1,))
_jlogits = jax.jit(jllama.logits, static_argnums=(1,))


def _layer(seed=0, **router_cols):
    """One layer's MoE leaves from JAX's init (f32 numpy), router columns
    overwritten by `router_cols` {column: value or array}."""
    lp = {k: np.array(v) for k, v in jax.device_get(
        jmoe.init_moe_params(JC, jax.random.PRNGKey(seed), dtype=jnp.float32)).items()}
    for col, val in router_cols.items():
        lp["router"][:, int(col[1:])] = val
    return lp


def _both(lp, cfg_kw, x, mask=None, dtype="float32"):
    """(JAX, port) moe_block outputs as f32 numpy, and the port's routing."""
    jc, tc = JC.with_(**cfg_kw), TC.with_(**cfg_kw)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jl = {k: jnp.asarray(v, jd) for k, v in lp.items()}
    tl = {k: torch.from_numpy(v).to(td) for k, v in lp.items()}
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(_jmoe_block(jl, jc, jnp.asarray(x, jd), real_mask=jm), np.float32)
    xt = torch.from_numpy(x).to(td)
    got = moe.moe_block(tl, tc, xt, tm).float().numpy()
    b, t, d = x.shape
    r = moe.route(tl, tc, xt.reshape(b * t, d), tm)
    return want, got, r


def _row_ulp(a):
    """bf16 ulp of each row's largest |value| (rows of the last axis)."""
    m = np.abs(a).max(axis=-1, keepdims=True)
    return np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("b,t,masked", [(2, 8, False), (1, 64, False), (4, 16, True),
                                        (8, 1, True)])
def test_moe_block_matches_jax(b, t, masked):
    rng = np.random.RandomState(b * 100 + t)
    x = rng.randn(b, t, JC.hidden_size).astype(np.float32)
    mask = (rng.rand(b, t) > 0.3) if masked else None
    lp = _layer()
    want, got, _ = _both(lp, {}, x, mask)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if masked:
        assert not got[~mask].any()  # padding rows come out zero
    want, got, _ = _both(lp, {}, x, mask, dtype="bfloat16")
    assert (np.abs(got - want) <= BF16_ROW_ULPS * _row_ulp(want)).all()
    assert np.sqrt(((got - want) ** 2).mean()) <= BF16_REL_RMS * np.sqrt((want ** 2).mean())


def _slot_major_keep(top, cap, real=None):
    """tests/test_moe.py's replication of GShard priority: all slot-0
    assignments in row order, then all slot-1; past `cap` in an expert a
    slot is dropped. top [N, k] expert ids -> keep [k, N]."""
    n, k = top.shape
    count = {}
    keep = np.zeros((k, n), bool)
    for s in range(k):
        for i in range(n):
            if real is not None and not real[i]:
                continue
            e = int(top[i, s])
            keep[s, i] = count.get(e, 0) < cap
            count[e] = count.get(e, 0) + 1
    return keep


def test_overflowing_expert_drops_the_same_tokens():
    # tests/test_moe.py's setup: a huge router column makes expert 0 the
    # first choice of every token whose features sum above 0, far past the
    # capacity of 8
    lp = _layer(c0=100.0)
    x = np.random.RandomState(2).randn(1, 64, JC.hidden_size).astype(np.float32)
    want, got, r = _both(lp, dict(expert_capacity_factor=0.1), x)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert r.capacity == 8 and int((r.expert[0] == 0).sum()) > 2 * r.capacity
    keep = _slot_major_keep(r.expert.T.numpy(), r.capacity)
    assert not keep.all() and (r.keep.numpy() == keep).all()


def test_slot_zero_wins_capacity_over_slot_one():
    # the first half routes (expert 0, expert 1), the second half expert 1
    # first: expert 1's capacity goes to the second half's slot 0 before
    # any of the first half's slot 1, which a row-major order would keep
    n, d = 64, JC.hidden_size
    rng = np.random.RandomState(3)
    x = (0.01 * rng.randn(1, n, d)).astype(np.float32)
    x[0, :, 0] = np.where(np.arange(n) < n // 2, 1.0, -1.0)
    x[0, :, 1] = np.where(np.arange(n) < n // 2, 0.0, 1.0)
    lp = _layer()
    lp["router"][:] = 0.0
    lp["router"][0, 0], lp["router"][0, 1], lp["router"][1, 1] = 10.0, 5.0, 20.0
    want, got, r = _both(lp, dict(expert_capacity_factor=1.0), x)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    keep = r.keep.numpy()
    assert (r.expert[1, : n // 2] == 1).all() and (r.expert[0, n // 2:] == 1).all()
    assert keep[0, n // 2:].all()  # slot 0 of the second half, all kept
    placed = r.capacity - n // 2  # what is left of expert 1 for slot 1
    assert keep[1, :placed].all() and not keep[1, placed: n // 2].any()
    assert (keep == _slot_major_keep(r.expert.T.numpy(), r.capacity)).all()


def test_padding_rows_take_no_capacity():
    lp = _layer(c0=100.0)
    n = 64
    x = np.random.RandomState(2).randn(1, n, JC.hidden_size).astype(np.float32)
    cfg_kw = dict(expert_capacity_factor=0.1)
    cap = moe.expert_capacity(TC.with_(**cfg_kw), n)
    assert cap == jmoe.expert_capacity(JC.with_(**cfg_kw), n)
    mask = (np.arange(n) >= n - cap)[None]  # the pads come first
    want, got, r = _both(lp, cfg_kw, x, mask)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert r.keep[:, n - cap:].all() and not r.keep[:, : n - cap].any()
    assert not got[0, : n - cap].any()


def test_router_tie_goes_to_the_lower_expert():
    # experts 1 and 2 tie for first place on every token; with capacity
    # binding, which one is slot 0 decides which tokens each keeps
    x = np.random.RandomState(4).randn(1, 64, JC.hidden_size).astype(np.float32)
    lp = _layer()
    lp["router"][:, 2] = lp["router"][:, 1] = 0.0
    lp["router"][0, 1] = lp["router"][0, 2] = 50.0
    x[0, :, 0] = np.abs(x[0, :, 0]) + 1.0
    want, got, r = _both(lp, dict(expert_capacity_factor=0.5), x)
    assert (r.expert[0] == 1).all() and (r.expert[1] == 2).all()
    assert not r.keep.all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert (r.keep.numpy() == _slot_major_keep(r.expert.T.numpy(), r.capacity)).all()


def test_expert_capacity_and_init_shapes():
    for n in (1, 7, 8, 64, 4096, 12345):
        for f in (0.1, 1.0, 1.25):
            assert moe.expert_capacity(TC.with_(expert_capacity_factor=f), n) == \
                jmoe.expert_capacity(JC.with_(expert_capacity_factor=f), n)
    gen = torch.Generator().manual_seed(0)
    lp = moe.init_moe_params(TC, gen, device="cpu", dtype=torch.bfloat16)
    d, f, e = TC.hidden_size, TC.intermediate_size, TC.num_experts
    assert {k: tuple(v.shape) for k, v in lp.items()} == {
        "router": (d, e), "we_gate": (e, d, f), "we_up": (e, d, f), "we_down": (e, f, d)}
    assert all(v.dtype == torch.bfloat16 for v in lp.values())
    # the port never asks for TF32 (routing runs in true float32)
    pat = re.compile(r"allow_tf32|set_float32_matmul_precision")
    for base, _, files in os.walk(os.path.join(ROOT, "dynamo_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                assert not pat.search(open(os.path.join(base, name)).read()), name


# ------------------------------------------------------------ model


def _jax_tree(seed=0):
    return jax.device_get(jllama.init_params(JC, jax.random.PRNGKey(seed), dtype=jnp.float32))


def _slots(pages, n):
    pos = np.arange(n)
    return pages[pos // PAGE] * PAGE + pos % PAGE


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_forward_matches_jax_in_each_attention_mode(kv_quant):
    """A 20-token prefill padded to a 32-row bucket (page-write), one paged
    decode step, then a ragged step of 5 tokens in an 8-column row; JAX's
    gather forward takes the same rows with the same write slots."""
    tree = _jax_tree()
    params = llama.params_from_jax(tree, device="cpu")
    rng = np.random.RandomState(5)
    t, bucket, rag = 20, 32, 8
    toks = rng.randint(1, JC.vocab_size, size=(1, t + 1 + 5)).astype(np.int32)
    pages = np.array([3, 1, 4], np.int32)
    num_slots = 8 * PAGE
    kw = {} if kv_quant is None else dict(kv_quant=kv_quant, page_size=PAGE)
    jkv = jllama.init_kv_cache(JC, num_slots, dtype=jnp.float32, **kw)
    spec = jllama.AttnSpec.gather(jnp.asarray(_slots(pages, 3 * PAGE)[None]),
                                  **({"int4_groups": 1} if kv_quant == "int4" else {}))
    kv = llama.init_kv_cache(TC, num_slots, dtype=torch.float32, device="cpu", **kw)

    def jax_step(tok, pos, wslots):
        nonlocal jkv
        h, jkv = _jforward(tree, JC, jnp.asarray(tok), jnp.asarray(pos), jkv,
                           jnp.asarray(wslots), spec)
        return np.asarray(_jlogits(tree, JC, h))

    def port_step(tok, pos, attn):
        h, _ = llama.forward(params, TC, torch.from_numpy(tok), torch.from_numpy(pos), kv, attn)
        return llama.logits(params, TC, h).numpy()

    # page-write prefill
    tok_b = np.zeros((1, bucket), np.int32)
    tok_b[0, :t] = toks[0, :t]
    pos_b = np.zeros((1, bucket), np.int32)
    pos_b[0, :t] = np.arange(t)
    ws = np.zeros(bucket, np.int32)
    ws[:t] = _slots(pages, t)
    want = jax_step(tok_b, pos_b, ws)[:, :t]
    got = port_step(tok_b, pos_b, llama.AttnSpec.page_write(
        torch.from_numpy(pages[:bucket // PAGE]), torch.from_numpy(pages[None]),
        torch.tensor([0], dtype=torch.int32), torch.tensor([t], dtype=torch.int32), PAGE,
    ))[:, :t]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # paged decode of token t
    want = jax_step(toks[:, t:t + 1], np.array([[t]], np.int32), _slots(pages, t + 1)[t:])
    got = port_step(toks[:, t:t + 1], np.array([[t]], np.int32), llama.AttnSpec.paged_decode(
        torch.from_numpy(pages[None]), torch.tensor([t + 1], dtype=torch.int32), PAGE,
        write_pos=torch.tensor([t], dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # ragged: tokens t+1 .. t+5 in an 8-column row, the last 3 padding
    tok_r = np.zeros((1, rag), np.int32)
    tok_r[0, :5] = toks[0, t + 1:]
    pos_r = np.zeros((1, rag), np.int32)
    pos_r[0, :5] = np.arange(t + 1, t + 6)
    ws = np.zeros(rag, np.int32)
    ws[:5] = _slots(pages, t + 6)[t + 1:]
    want = jax_step(tok_r, pos_r, ws)[:, :5]
    got = port_step(tok_r, pos_r, llama.AttnSpec.ragged(
        torch.from_numpy(pages[None]), torch.tensor([t + 1], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32), torch.from_numpy(ws), PAGE))[:, :5]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if kv_quant is not None:  # the prefill's rows as JAX wrote them, within a code
        jk = kv_cache_from_jax(jkv, JC.num_kv_heads)
        live = torch.from_numpy(_slots(pages, t)).long()
        assert (kv.k[0][live].int() - jk.k[0][live].int()).abs().max() <= 1


def test_params_from_jax_and_w8a8_keep_experts_bf16():
    tree = jax.device_get(jllama.init_params(JC, jax.random.PRNGKey(1), dtype=jnp.bfloat16))
    port = llama.params_from_jax(tree, device="cpu")
    for lp_t, lp_j in zip(port["layers"], tree["layers"]):
        assert set(lp_t) == set(lp_j) and "we_gate" in lp_t and "w_gate" not in lp_t
        for k, v in lp_j.items():
            assert lp_t[k].dtype == torch.bfloat16 and tuple(lp_t[k].shape) == v.shape
            np.testing.assert_array_equal(lp_t[k].float().numpy(), np.asarray(v, np.float32))
    # W8A8: the attention projections quantized, router and experts as they are
    jq = jax.device_get(jquant.quantize_params(tree, JC))
    tq = quant.quantize_params(port, TC)
    for lp_t, lp_j in zip(tq["layers"], jq["layers"]):
        assert set(lp_t) == set(lp_j)
        for k, v in lp_j.items():
            assert quant.is_quantized(lp_t[k]) == jquant.is_quantized(v), k
            if jquant.is_quantized(v):
                assert lp_t[k]["q"].T.contiguous().numpy().tobytes() == np.asarray(v["q"]).tobytes()
            else:
                np.testing.assert_array_equal(lp_t[k].float().numpy(), np.asarray(v, np.float32))
    assert quant.logical_param_count(tq, TC) == jquant.logical_param_count(jq, JC)
    carried = llama.params_from_jax(jq, device="cpu")
    assert all(torch.equal(a["we_down"], b["we_down"]) and
               torch.equal(a["wq"]["q"], b["wq"]["q"])
               for a, b in zip(carried["layers"], tq["layers"]))
    # a seeded MoE init quantized as it goes equals the init quantized after
    a = llama.init_params(TC, 7, device="cpu", dtype=torch.float32, quantize=True)
    b = quant.quantize_params(llama.init_params(TC, 7, device="cpu", dtype=torch.float32), TC)
    assert torch.equal(a["layers"][1]["we_up"], b["layers"][1]["we_up"])
    assert torch.equal(a["layers"][1]["wo"]["q"], b["layers"][1]["wo"]["q"])


def test_w8a8_logits_match_jax_and_path_launches():
    """W8A8 tiny-moe (router and experts unquantized) against JAX's
    quantized tree; the plain versions run as often as
    `chip_smoke.path_launches(moe=True)` says the card launches them."""
    import chip_smoke

    tree = jquant.quantize_params(_jax_tree(), JC)
    params = llama.params_from_jax(jax.device_get(tree), device="cpu")
    from tests.test_torch_model import port_prefill_then_decode

    rng = np.random.RandomState(5)
    t = 20
    toks = rng.randint(1, JC.vocab_size, size=(1, t + 1)).astype(np.int32)
    pages = np.array([3, 1, 4], np.int32)
    jkv = jllama.init_kv_cache(JC, 8 * PAGE, dtype=jnp.float32)
    smat = jnp.asarray(_slots(pages, 3 * PAGE)[None])
    # the JAX prefill at the port's bucket of 32 rows, pads writing slot 0
    tok_b = np.zeros((1, 32), np.int32)
    tok_b[0, :t] = toks[0, :t]
    pos_b = np.zeros((1, 32), np.int32)
    pos_b[0, :t] = np.arange(t)
    ws = np.zeros(32, np.int32)
    ws[:t] = _slots(pages, t)
    jh, jkv = _jforward(tree, JC, jnp.asarray(tok_b), jnp.asarray(pos_b), jkv,
                        jnp.asarray(ws), smat)
    j_pre = np.asarray(_jlogits(tree, JC, jh))[:, :t]
    jh2, _ = _jforward(tree, JC, jnp.asarray(toks[:, t:]), jnp.asarray([[t]]), jkv,
                       jnp.asarray(_slots(pages, t + 1)[t:]), smat)
    j_dec = np.asarray(_jlogits(tree, JC, jh2))
    kv = llama.init_kv_cache(TC, 8 * PAGE, dtype=torch.float32, device="cpu")
    chip_smoke.reset_counts()
    t_pre, t_dec = port_prefill_then_decode(params, TC, kv, toks, t, pages)
    for got, want in ((t_pre, j_pre), (t_dec, j_dec)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    stats = {"prefill_dispatches": 1, "decode_dispatches": 1, "mixed_steps": 0,
             "spec_dispatches": 0}
    want = chip_smoke.path_launches(stats, TC.num_layers, 1, None, w8a8=True, moe=True)
    calls = {name: plain for name, (_, plain) in chip_smoke.read_counts().items()}
    # the fused plain version quantizes through quantize_rows_plain
    calls["quantize_rows"] -= calls["rms_norm_quantize_rows"]
    assert {k: v for k, v in calls.items() if v} == want
    assert want["w8a8_gemm"] == 2 * (4 * TC.num_layers + 1)


# ------------------------------------------------------------ weights


def _mixtral_dir(path, tree, num_experts, drop=None):
    """A Mixtral-style safetensors dir (tests/test_moe.py's layout) of a
    JAX tree; `drop` leaves one tensor name out."""
    from safetensors.torch import save_file

    t = lambda a: torch.from_numpy(np.array(a, order="C"))  # noqa: E731
    sd = {"model.embed_tokens.weight": t(tree["embed"]),
          "model.norm.weight": t(tree["final_norm"])}
    if "lm_head" in tree:
        sd["lm_head.weight"] = t(np.asarray(tree["lm_head"]).T)
    for i, lp in enumerate(tree["layers"]):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = t(lp["attn_norm"])
        sd[pre + "post_attention_layernorm.weight"] = t(lp["mlp_norm"])
        sd[pre + "block_sparse_moe.gate.weight"] = t(np.asarray(lp["router"]).T)
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                         ("wo", "o_proj")):
            sd[pre + f"self_attn.{hf}.weight"] = t(np.asarray(lp[ours]).T)
        for ours, hf in (("we_gate", "w1"), ("we_up", "w3"), ("we_down", "w2")):
            for e in range(num_experts):
                sd[pre + f"block_sparse_moe.experts.{e}.{hf}.weight"] = \
                    t(np.asarray(lp[ours][e]).T)
    sd.pop(drop, None)
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"))
    return str(path)


def test_mixtral_checkpoint_loads_as_the_reference_does(tmp_path):
    from dynamo_tpu.models.weights import load_params as jax_load_params
    from dynamo_tpu_torch.models.weights import load_params

    jc, tc = JC.with_(num_layers=1), TC.with_(num_layers=1)
    tree = jax.device_get(jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32))
    path = _mixtral_dir(tmp_path / "full", tree, JC.num_experts)
    want = jax.device_get(jax_load_params(path, jc, dtype=jnp.float32))
    got = load_params(path, tc, dtype=torch.float32, device="cpu")
    assert set(got["layers"][0]) == set(want["layers"][0])
    for k, v in want["layers"][0].items():
        np.testing.assert_array_equal(got["layers"][0][k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(got["embed"].numpy(), np.asarray(want["embed"]))
    # one expert's w3 missing: both refuse the incomplete group alike
    path = _mixtral_dir(tmp_path / "short", tree, JC.num_experts,
                        drop="model.layers.0.block_sparse_moe.experts.2.w3.weight")
    with pytest.raises(ValueError) as jerr:
        jax_load_params(path, jc, dtype=jnp.float32)
    with pytest.raises(ValueError) as terr:
        load_params(path, tc, dtype=torch.float32, device="cpu")
    assert "incomplete expert groups: ['layers[0].we_up(3/4 experts)']" in str(terr.value)
    assert str(terr.value) == str(jerr.value)
