"""The port's plain ops against the JAX package's: RMSNorm, RoPE (llama3
scaling included), greedy sampling and the top-k/top-p shortlist."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.ops.norm import rms_norm as jax_rms_norm
from dynamo_tpu.ops.rope import (
    apply_rope as jax_apply_rope,
    rope_cos_sin as jax_rope_cos_sin,
    rope_inv_freq as jax_rope_inv_freq,
)
from dynamo_tpu.ops.sampling import _shortlist_mask, sample_tokens as jax_sample
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops.norm import rms_norm
from dynamo_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from dynamo_tpu_torch.ops.sampling import sample_tokens, shortlist_mask
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    want = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, weight_offset=offset)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, weight_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["llama-3.1-8b", "llama-3.2-1b", "tiny"])
def test_rope_inv_freq(name):
    got = rope_inv_freq(get_config(name))
    want = jax_rope_inv_freq(jax_get_config(name))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_rope_rotation():
    cfg = get_config("llama-3.1-8b")
    inv = rope_inv_freq(cfg)
    rng = np.random.RandomState(1)
    pos = np.array([[0, 1, 7, 4095], [8191, 12000, 3, 500]], np.int32)
    x = rng.randn(2, 4, 8, cfg.head_dim).astype(np.float32)
    jc, js = jax_rope_cos_sin(jnp.asarray(inv), jnp.asarray(pos))
    tc, ts = rope_cos_sin(torch.from_numpy(inv), torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    want = jax_apply_rope(jnp.asarray(x), jc, js)
    got = apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_greedy_sampling_exact():
    import jax

    rng = np.random.RandomState(2)
    logits = rng.randn(6, 300).astype(np.float32)
    logits[1, 17] = logits[1, 250] = logits[1].max() + 1.0  # tie: first index wins
    zeros = np.zeros(6, np.float32)
    want = jax_sample(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(zeros),
        jnp.zeros(6, jnp.int32), jnp.ones(6, jnp.float32),
    )
    for all_greedy in (True, False):
        got = sample_tokens(
            torch.from_numpy(logits), None, torch.from_numpy(zeros),
            torch.zeros(6, dtype=torch.int32), torch.ones(6), all_greedy=all_greedy,
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(want[1]) == 17


def test_shortlist_support_matches():
    rng = np.random.RandomState(3)
    scaled = (rng.randn(5, 500) * 3).astype(np.float32)
    top_k = np.array([0, 1, 10, 40, 200], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.95, 0.3], np.float32)
    j_ids, j_masked = _shortlist_mask(
        jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p)
    )
    t_ids, t_masked = shortlist_mask(
        torch.from_numpy(scaled), torch.from_numpy(top_k), torch.from_numpy(top_p)
    )
    j_keep = np.asarray(j_masked) > -1e29
    t_keep = t_masked.numpy() > -1e29
    for r in range(5):
        assert set(np.asarray(j_ids)[r][j_keep[r]]) == set(t_ids.numpy()[r][t_keep[r]])


def test_sampling_stays_in_support():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(4, 200).astype(np.float32))
    temp = torch.tensor([0.7, 1.0, 1.3, 0.0])
    top_k = torch.tensor([5, 0, 3, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.2, 0.9, 1.0])
    gen = torch.Generator().manual_seed(0)
    _, masked = shortlist_mask(logits / torch.where(temp > 0, temp, 1)[:, None], top_k, top_p)
    ids, _ = shortlist_mask(logits, top_k, top_p)
    for _ in range(20):
        got = sample_tokens(logits, gen, temp, top_k, top_p)
        for r in range(3):
            allowed = set(ids[r][masked[r] > -1e29].tolist())
            assert int(got[r]) in allowed
        assert int(got[3]) == int(torch.argmax(logits[3]))
