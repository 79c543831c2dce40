"""The port's model (dynamo_tpu_torch.models) against the JAX package's on
the same weights: parameter carry-over, prefill logits and a decode step in
float32 at the reference's model tolerance (2e-4), and the safetensors
reader against the `safetensors` package."""

from __future__ import annotations

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.weights import load_params as jax_load_params
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import load_params, read_safetensors
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

PAGE = 16
CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tiny-trained-llama")

# tiny, tiny with qwen2-style qkv bias, tiny with gemma-style norms/embeddings/GeGLU
VARIANTS = {
    "tiny": {},
    "qkv_bias": {"attn_bias": True},
    "gemma_style": {
        "norm_weight_offset": 1.0, "scale_embeddings": True,
        "hidden_act": "gelu_pytorch_tanh",
    },
}


def _configs(variant):
    kw = dict(VARIANTS[variant], dtype="float32")
    return jcfg.get_config("tiny").with_(**kw), tcfg.get_config("tiny").with_(**kw)


def _jax_tree(cfg, seed=0):
    tree = jax.device_get(jllama.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    rng = np.random.RandomState(seed)
    for lp in tree["layers"]:
        # non-trivial norms and biases so the offsets and bias adds matter
        for name in ("attn_norm", "mlp_norm"):
            lp[name] = (lp[name] + 0.1 * rng.randn(*lp[name].shape)).astype(np.float32)
        for name in ("bq", "bk", "bv"):
            if name in lp:
                lp[name] = (0.1 * rng.randn(*lp[name].shape)).astype(np.float32)
    return tree


def test_params_from_jax_carries_every_leaf():
    jc, _ = _configs("tiny")
    tree = jax.device_get(jllama.init_params(jc, jax.random.PRNGKey(1), dtype=jnp.bfloat16))
    port = llama.params_from_jax(tree, device="cpu")
    assert set(port) == set(tree)
    assert len(port["layers"]) == len(tree["layers"])
    for lp_t, lp_j in zip(port["layers"], tree["layers"]):
        assert set(lp_t) == set(lp_j)
        for k in lp_j:
            assert lp_t[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                lp_t[k].float().numpy(), np.asarray(lp_j[k], np.float32)
            )
    np.testing.assert_array_equal(
        port["embed"].float().numpy(), np.asarray(tree["embed"], np.float32)
    )


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_then_decode_matches_jax(variant):
    jc, tc = _configs(variant)
    tree = _jax_tree(jc)
    params = llama.params_from_jax(tree, device="cpu")
    rng = np.random.RandomState(5)
    t = 20
    toks = rng.randint(1, jc.vocab_size, size=(1, t + 1)).astype(np.int32)
    pages = np.array([3, 1, 4], np.int32)  # the sequence's pages, out of order
    num_slots = 8 * PAGE

    def slots(n):
        pos = np.arange(n)
        return pages[pos // PAGE] * PAGE + pos % PAGE

    # JAX: gather-oracle prefill of t tokens, then one decode step
    jkv = jllama.init_kv_cache(jc, num_slots, dtype=jnp.float32)
    smat = slots(3 * PAGE)[None]
    jh, jkv = jllama.forward(
        tree, jc, jnp.asarray(toks[:, :t]), jnp.arange(t)[None], jkv,
        jnp.asarray(slots(t)), jnp.asarray(smat),
    )
    j_pre = np.asarray(jllama.logits(tree, jc, jh))
    jh2, _ = jllama.forward(
        tree, jc, jnp.asarray(toks[:, t:]), jnp.asarray([[t]]), jkv,
        jnp.asarray(slots(t + 1)[t:]), jnp.asarray(smat),
    )
    j_dec = np.asarray(jllama.logits(tree, jc, jh2))

    # port: the engine's paths, page-scatter write + flash prefill (one
    # 32-token bucket), then the fused write + decode attention step
    kv = llama.init_kv_cache(tc, num_slots, dtype=torch.float32, device="cpu")
    t_pre, t_dec = port_prefill_then_decode(params, tc, kv, toks, t, pages)
    np.testing.assert_allclose(t_pre, j_pre, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t_dec, j_dec, rtol=2e-4, atol=2e-4)


def port_prefill_then_decode(params, tc, kv, toks, t, pages, prefill=True):
    """The engine's two attention modes on one sequence: a page-write
    prefill of toks[:, :t] padded to a 32-token bucket (skipped when the
    cache already holds it), then one fused decode step of toks[:, t].
    Returns the (prefill, decode) logits."""
    t_pre = None
    if prefill:
        t_pre = _port_prefill(params, tc, kv, toks, t, pages)
    attn = llama.AttnSpec.paged_decode(
        torch.from_numpy(pages[None]), torch.tensor([t + 1], dtype=torch.int32), PAGE,
        write_pos=torch.tensor([t], dtype=torch.int32),
    )
    h2, _ = llama.forward(params, tc, torch.from_numpy(toks[:, t:]), torch.tensor([[t]]), kv, attn)
    return t_pre, llama.logits(params, tc, h2).numpy()


def _port_prefill(params, tc, kv, toks, t, pages):
    bucket = 32
    tok_b = np.zeros((1, bucket), np.int32)
    tok_b[0, :t] = toks[0, :t]
    pos_b = np.zeros((1, bucket), np.int32)
    pos_b[0, :t] = np.arange(t)
    attn = llama.AttnSpec.page_write(
        torch.from_numpy(pages[:-(-bucket // PAGE)]), torch.from_numpy(pages[None]),
        torch.tensor([0], dtype=torch.int32), torch.tensor([t], dtype=torch.int32), PAGE,
    )
    h, _ = llama.forward(params, tc, torch.from_numpy(tok_b), torch.from_numpy(pos_b), kv, attn)
    return llama.logits(params, tc, h)[:, :t].numpy()


@pytest.mark.parametrize(
    "fn", [llama.init_params, llama.init_kv_cache, llama.params_from_jax, load_params],
    ids=lambda f: f.__name__,
)
def test_model_builders_take_an_explicit_device(fn):
    # no silent CPU default: a model built for the engine's forward must be
    # placed where the caller says
    param = inspect.signature(fn).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default is inspect.Parameter.empty


def test_safetensors_reader_matches_package():
    from safetensors.numpy import load_file

    want = load_file(os.path.join(CKPT, "model.safetensors"))
    got = dict(read_safetensors(os.path.join(CKPT, "model.safetensors")))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape
        assert got[name].numpy().tobytes() == arr.tobytes(), name


def test_load_params_matches_jax_loader():
    from dynamo_tpu.models.weights import load_config as jax_load_config
    from dynamo_tpu_torch.models.weights import load_config

    jc, tc = jax_load_config(CKPT), load_config(CKPT)
    assert tc == tcfg.ModelConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    tree = jax.device_get(jax_load_params(CKPT, jc, dtype=jnp.float32))
    port = load_params(CKPT, tc, dtype=torch.float32, device="cpu")
    for lp_t, lp_j in zip(port["layers"], tree["layers"]):
        assert set(lp_t) == set(lp_j)
        for k in lp_j:
            np.testing.assert_array_equal(lp_t[k].numpy(), np.asarray(lp_j[k]))
    np.testing.assert_array_equal(port["embed"].numpy(), np.asarray(tree["embed"]))
    np.testing.assert_array_equal(port["final_norm"].numpy(), np.asarray(tree["final_norm"]))
