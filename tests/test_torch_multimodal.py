"""Multimodal on the port against the JAX package, in float32 on the CPU:
the vision encoder (`dynamo_tpu_torch/models/vision.py`) against
`dynamo_tpu.models.vision.encode`, and prompt embeddings (the LLaVA-style
injection) through TorchEngine on the vendored trained checkpoint.

The engine cases are `tests/test_multimodal.py`'s on the port: embeds that
are the embed-table rows of their own placeholder tokens stream exactly
the plain request's tokens (the oracle), distinct embeds take no prefix hit
past the span, a span across chunk boundaries splits across dispatches,
the text before the span is cached, and bad spans are refused before any
device work. Beside them: greedy streams equal to JaxEngine's with random
embeds, an embed request prefilling beside mixed steps (never inside one)
and across a preemption, and `prefill_only` into `generate_remote`.

One TorchEngine (mixed steps on, a pool of 40 pages of 16 so four long
requests preempt) and one JaxEngine (gather backend) serve every case, on
one event loop the module keeps; each case clears the port's prefix cache
first.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.scheduler import Sequence
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models import vision
from dynamo_tpu_torch.runtime.pipeline.context import Context
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)
from tests.test_torch_engine import CKPT, ENGINE_KW

PORT_KW = dict(ENGINE_KW, num_pages=40, mixed_batching=True, mixed_step_tokens=64)
D = 128  # the checkpoint's hidden size


def _pre(common, tokens, embeds=None, offset=0, max_tokens=6):
    return common.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=common.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=common.SamplingOptions(greedy=True),
        prompt_embeds=embeds,
        embeds_offset=offset,
    )


async def _collect(engine, pre, ctx_cls=Context):
    frames = [f async for f in await engine.generate(ctx_cls(pre.to_dict()))]
    assert frames[-1].get("finish_reason") == "length"
    return [t for f in frames for t in f.get("token_ids") or []], frames


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def engines(loop):
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel
    from dynamo_tpu_torch.models.weights import load_config

    async def build():
        jeng = JaxEngine(JaxConfig(model=LocalModel.prepare(CKPT).model_cfg,
                                   checkpoint_dir=CKPT, dtype="float32",
                                   attn_backend="gather", **ENGINE_KW))
        teng = TorchEngine(EngineConfig(model=load_config(CKPT), checkpoint_dir=CKPT,
                                        dtype="float32", **PORT_KW), device="cpu")
        return jeng, teng

    jeng, teng = loop.run_until_complete(build())
    yield jeng, teng
    for eng in (jeng, teng):
        loop.run_until_complete(eng.close())


@pytest.fixture
def port(engines):
    eng = engines[1]
    eng.allocator.clear_cache()
    return eng


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=60))


def _table(eng):
    return eng.params["embed"].float().numpy()


# ------------------------------------------------------------ the encoder


def test_encoder_matches_jax():
    from dynamo_tpu.models import vision as jvision

    cfg = vision.VisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                              num_heads=4, out_size=96)
    jcfg = jvision.VisionConfig(**{f: getattr(cfg, f) for f in (
        "image_size", "patch_size", "hidden_size", "num_layers", "num_heads", "out_size")})
    tree = jax.device_get(jvision.init_vision_params(jcfg, jax.random.PRNGKey(0)))
    params = vision.vision_params_from_jax(tree, device="cpu")
    rng = np.random.RandomState(1)
    img = rng.uniform(0, 1, size=(2, 32, 32, 3)).astype(np.float32)
    got = vision.encode(params, cfg, torch.from_numpy(img))
    want = np.asarray(jax.jit(lambda p, x: jvision.encode(p, jcfg, x))(tree, img))
    assert got.shape == (2, cfg.num_patches, 96) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # patchify is a pure layout: byte-equal
    assert vision.patchify(cfg, torch.from_numpy(img)).numpy().tobytes() == \
        np.asarray(jvision.patchify(jcfg, img)).tobytes()
    # the port's own seeded init: deterministic, and other images differ
    gen = torch.Generator().manual_seed(0)
    p2 = vision.init_vision_params(cfg, gen)
    assert p2["pos_embed"].shape == (cfg.num_patches, 64) and len(p2["layers"]) == 2
    a = vision.encode(p2, cfg, torch.from_numpy(img))
    assert torch.equal(a, vision.encode(p2, cfg, torch.from_numpy(img)))
    assert not torch.allclose(a, vision.encode(p2, cfg, torch.from_numpy(img[::-1].copy())))


def test_encoder_bf16_weights_f32_images_promote_like_jax():
    """bf16 weights on f32 images: JAX's `images @ patch_proj` promotes to
    f32, so the whole encoder runs in f32 on the weights' bf16 values. The
    port follows that promotion and matches at the f32 tolerance above
    (rtol = atol = 2e-5); computing in bf16 instead misses by ~5e-3
    relative."""
    from dynamo_tpu.models import vision as jvision

    cfg = vision.VisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                              num_heads=4, out_size=96)
    jcfg = jvision.VisionConfig(**{f: getattr(cfg, f) for f in (
        "image_size", "patch_size", "hidden_size", "num_layers", "num_heads", "out_size")})
    tree = jax.device_get(jvision.init_vision_params(jcfg, jax.random.PRNGKey(0),
                                                     dtype=jnp.bfloat16))
    params = vision.vision_params_from_jax(tree, device="cpu")
    assert params["patch_proj"].dtype == torch.bfloat16
    img = np.random.RandomState(3).uniform(0, 1, size=(2, 32, 32, 3)).astype(np.float32)
    got = vision.encode(params, cfg, torch.from_numpy(img))
    want = np.asarray(jax.jit(lambda p, x: jvision.encode(p, jcfg, x))(tree, img))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # bf16 images on bf16 weights stay in bf16
    half = vision.encode(params, cfg, torch.from_numpy(img).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16


# ------------------------------------------------------------ the request


def test_sequence_takes_lists_arrays_and_tensors():
    rng = np.random.RandomState(2)
    e = rng.randn(3, 8).astype(np.float64)
    seqs = [Sequence.from_request(Context({}), _pre(tcommon, range(6), x, offset=2), 4, 64)
            for x in (e.tolist(), e, torch.from_numpy(e))]
    want = np.asarray(e, np.float32).tobytes()
    for s in seqs:
        assert s.prompt_embeds.dtype == torch.float32
        assert s.prompt_embeds.numpy().tobytes() == want
        assert s.no_cache and s.embeds_offset == 2 and s.cacheable_pages(4) == 0
        assert s.embeds_overlap(0, 2) is None and s.embeds_overlap(0, 4) == (2, 4)
        assert s.embeds_overlap(4, 8) == (4, 5)
    plain = Sequence.from_request(Context({}), _pre(tcommon, range(6)), 4, 64)
    assert not plain.no_cache and plain.cacheable_pages(4) is None


def test_bad_embed_spans_rejected(loop, engines):
    for eng, common, ctx in ((engines[0], None, None), (engines[1], tcommon, Context)):
        if common is None:
            from dynamo_tpu.llm.protocols import common
            from dynamo_tpu.runtime.pipeline.context import Context as ctx
        waiting = len(eng.waiting)
        for embeds, off, msg in (([[0.0] * D] * 4, 0, "outside"),   # span overhangs
                                 ([[0.0] * D], 3, "outside"),       # offset at the end
                                 ([[0.0] * 32], 0, "width"),        # wrong width
                                 ([], 0, "empty")):
            with pytest.raises(ValueError, match=msg):
                _run(loop, eng.generate(ctx(_pre(common, [5, 6, 7], embeds, off).to_dict())))
        assert len(eng.waiting) == waiting
    with pytest.raises(ValueError, match="outside"):
        _run(loop, engines[1].prefill_only(_pre(tcommon, [5, 6, 7], [[0.0] * D] * 4)))


# ------------------------------------------------------------ the engine


def test_embeds_equal_to_token_lookups_reproduce_plain_run(loop, port):
    prompt = [5, 17, 42, 9, 38, 3, 14, 21]
    ref, _ = _run(loop, _collect(port, _pre(tcommon, prompt)))
    span = _table(port)[np.asarray(prompt[3:6])]
    for embeds in (span.tolist(), span, torch.from_numpy(span)):
        got, _ = _run(loop, _collect(port, _pre(tcommon, prompt, embeds, offset=3)))
        assert got == ref


def test_distinct_embeds_change_output_and_skip_prefix_cache(loop, port):
    prompt = list(range(2, 2 + 40))
    rng = np.random.RandomState(0)
    e1, e2 = (rng.randn(20, D) * 0.5 for _ in range(2))
    t1, _ = _run(loop, _collect(port, _pre(tcommon, prompt, e1, offset=3)))
    hits = port.allocator.hits
    t2, frames = _run(loop, _collect(port, _pre(tcommon, prompt, e2, offset=3)))
    # the same placeholder tokens, other images: no page past the offset is shared
    assert port.allocator.hits == hits and frames[0]["meta"]["prefix_cached_tokens"] == 0
    assert t1 != t2
    assert port.peek_prefix_tokens(prompt) == 0 and port.peek_prefix_tokens(prompt, 3) == 0


def test_embeds_span_multiple_chunks(loop, port):
    """A span across prefill-chunk boundaries (chunk 32: a span from 10 to
    70 crosses 32 and 64) is split across the dispatches."""
    prompt = [(i * 7) % 60 + 2 for i in range(80)]
    ref, _ = _run(loop, _collect(port, _pre(tcommon, prompt, max_tokens=8)))
    span = _table(port)[np.asarray(prompt[10:70])]
    d0 = port.phase_stats["prefill_dispatches"]
    got, _ = _run(loop, _collect(port, _pre(tcommon, prompt, span, offset=10, max_tokens=8)))
    assert got == ref and port.phase_stats["prefill_dispatches"] - d0 >= 3


def test_text_prefix_before_image_is_cached(loop, port):
    shared = list(range(2, 2 + 48))  # 3 full pages at page_size 16
    prompt = shared + [3, 3, 3, 3]
    rng = np.random.RandomState(1)
    e1, e2 = (rng.randn(4, D) * 0.5 for _ in range(2))
    _, f1 = _run(loop, _collect(port, _pre(tcommon, prompt, e1, offset=48)))
    assert f1[0]["meta"]["prefix_cached_tokens"] == 0
    assert port.peek_prefix_tokens(prompt, max_tokens=48) == 48
    _, f2 = _run(loop, _collect(port, _pre(tcommon, prompt, e2, offset=48)))
    # the 48-token text prefix (3 pages) is reused; the image span is not
    assert f2[0]["meta"]["prefix_cached_tokens"] == 48


def test_random_embeds_stream_as_jax_engine(loop, engines):
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.pipeline.context import Context as JaxContext

    jeng, teng = engines
    teng.allocator.clear_cache()
    rng = np.random.RandomState(3)
    cases = [([5, 17, 42, 9, 38, 3, 14, 21, 30, 11], 2, 5),
             ([(i * 5) % 60 + 2 for i in range(70)], 20, 30)]
    for prompt, off, n in cases:
        e = (rng.randn(n, D) * 0.5).astype(np.float32)
        want, _ = _run(loop, _collect(jeng, _pre(jcommon, prompt, e.tolist(), off, 12),
                                      JaxContext))
        got, _ = _run(loop, _collect(teng, _pre(tcommon, prompt, e.tolist(), off, 12)))
        assert got == want


def test_embed_request_beside_mixed_steps(loop, port):
    """While a stream decodes, a text request and then an embed request
    arrive: mixed steps carry the text chunks; the embed request prefills
    through the normal dispatch (it stops the mixed pick), and the oracle
    still holds."""
    held = [(i * 3) % 60 + 2 for i in range(20)]
    text = [(i * 11) % 60 + 2 for i in range(90)]
    mm = [(i * 13) % 60 + 2 for i in range(90)]
    ref, _ = _run(loop, _collect(port, _pre(tcommon, mm, max_tokens=10)))
    span = _table(port)[np.asarray(mm[20:70])]
    picked = []
    orig = port._select_mixed_prefill

    def spy(leftover):
        out = orig(leftover)
        picked.extend(s.prompt_embeds is not None for s, _ in out)
        return out

    port._select_mixed_prefill = spy
    try:
        async def go():
            first = asyncio.Event()

            async def held_stream():
                toks = []
                async for f in await port.generate(Context(
                        _pre(tcommon, held, max_tokens=60).to_dict())):
                    toks += f.get("token_ids") or []
                    if len(toks) >= 4:
                        first.set()
                return toks

            h = asyncio.ensure_future(held_stream())
            await first.wait()
            m0 = port.phase_stats["mixed_steps"]
            _, got = await asyncio.gather(
                _collect(port, _pre(tcommon, text, max_tokens=10)),
                _collect(port, _pre(tcommon, mm, span, offset=20, max_tokens=10)))
            await h
            return got[0], port.phase_stats["mixed_steps"] - m0

        got, mixed = _run(loop, go())
    finally:
        port._select_mixed_prefill = orig
    assert got == ref
    assert mixed > 0 and picked and not any(picked)


def test_embed_request_across_preemption(loop, port):
    """Four long requests overrun the 39-page pool; the newest, an embed
    request with random embeds, is preempted and re-prefills its span:
    its stream equals its own solo run."""
    rng = np.random.RandomState(4)
    prompts = [[(i * (7 + j)) % 60 + 2 for i in range(100)] for j in range(4)]
    e = (rng.randn(40, D) * 0.5).astype(np.float32)
    solo, _ = _run(loop, _collect(port, _pre(tcommon, prompts[3], e, 30, max_tokens=60)))
    port.allocator.clear_cache()
    p0 = port.phase_stats["preemptions"]

    async def go():
        texts = [asyncio.ensure_future(_collect(port, _pre(tcommon, p, max_tokens=60)))
                 for p in prompts[:3]]
        await asyncio.sleep(0)
        got = await _collect(port, _pre(tcommon, prompts[3], e, 30, max_tokens=60))
        await asyncio.gather(*texts)
        return got[0]

    got = _run(loop, go())
    assert port.phase_stats["preemptions"] > p0
    assert got == solo


def test_prefill_only_into_generate_remote(loop, port):
    prompt = [(i * 9) % 60 + 2 for i in range(50)]
    rng = np.random.RandomState(5)
    e = (rng.randn(12, D) * 0.5).astype(np.float32)
    want, _ = _run(loop, _collect(port, _pre(tcommon, prompt, e, 20, 8)))
    port.allocator.clear_cache()
    pre = _pre(tcommon, prompt, e, 20, 8)
    first, k, v, ks, vs = _run(loop, port.prefill_only(pre))
    assert ks is None and k.shape == (2, 50, 64)
    # only the text pages before the span were registered by the prefill
    assert port.peek_prefix_tokens(prompt) == 16
    port.allocator.clear_cache()

    async def remote():
        frames = [f async for f in await port.generate_remote(
            Context(pre.to_dict()), first, k, v)]
        return [t for f in frames for t in f.get("token_ids") or []], frames

    got, frames = _run(loop, remote())
    assert got == want and frames[0]["meta"]["remote_prefill"]
