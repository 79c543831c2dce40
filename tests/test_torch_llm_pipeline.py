"""The port's preprocessor and backend operators (dynamo_tpu_torch/llm/
preprocessor.py, backend.py) against the JAX package's, on the fixture BPE
model (tests/fixtures.py's, built by tests/torch_fixtures.py; chat template) and the vendored checkpoint (no template: the
"role: content" fallback, WordLevel).

- `PreprocessedRequest` dicts and prompts equal for chat, string
  completion, token-id completion, content parts, `use_raw_prompt` and
  annotations; the context-length rejection raises RequestError on both.
- Backend frames equal over the same scripted engine: the stop-sequence
  jail (released and hit, mid-chunk), `max_tokens`, eos (and
  `ignore_eos`), the flush on the engine's finish, a stream with no finish.
- Whole pipelines (preprocessor -> backend -> the echo engine) stream the
  same chunks apart from `id` and `created`, with annotations, completion
  `echo`, and `n > 1` fanned out."""

from __future__ import annotations

import asyncio
import os

import pytest

from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import engines as jengines
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.protocols import openai as jopenai
from dynamo_tpu.runtime.pipeline import context as jcontext
from dynamo_tpu.runtime.pipeline import engine as jengine
from dynamo_tpu_torch.llm import backend as tbackend
from dynamo_tpu_torch.llm import engines as tengines
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import openai as topenai
from dynamo_tpu_torch.runtime.pipeline import context as tcontext
from dynamo_tpu_torch.runtime.pipeline import engine as tengine

from .torch_fixtures import bpe_model_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "tests", "data", "tiny-trained-llama")


class Side:
    """One package's operators on one model dir."""

    def __init__(self, pkg: str, path: str):
        jax_side = pkg == "jax"
        card_cls = JaxCard if jax_side else ModelDeploymentCard
        self.card = card_cls.from_local_path(path, name="m")
        self.pre_mod = jpre if jax_side else tpre
        self.openai = jopenai if jax_side else topenai
        self.backend_mod = jbackend if jax_side else tbackend
        self.engines = jengines if jax_side else tengines
        self.ctx = jcontext.Context if jax_side else tcontext.Context
        self.link = jengine.link if jax_side else tengine.link
        self.pre = self.pre_mod.OpenAIPreprocessor(self.card)
        self.backend = self.backend_mod.Backend.from_card(self.card)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    bpe = bpe_model_dir(str(tmp_path_factory.mktemp("bpe")))
    return {name: (Side("jax", path), Side("torch", path))
            for name, path in (("bpe", bpe), ("ckpt", CKPT))}


CHATS = [
    [{"role": "user", "content": "hello world"}],
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "the quick fox"},
     {"role": "assistant", "content": "jumps"}, {"role": "user", "content": "the capital of"}],
    [{"role": "user", "content": [{"type": "text", "text": "the capital "},
                                  {"type": "text", "text": "of france is"}, "paris"]}],
    [{"role": "user", "content": None}, {"role": "user", "content": "é ☃ <|eot|> </s>"}],
]


def _body(**kw):
    body = {"model": "m", "max_tokens": 9, "stop": ["ox"], "temperature": 0.5,
            "nvext": {"ignore_eos": True, "top_k": 3, "annotations": ["token_ids"]}}
    body.update(kw)
    return body


@pytest.mark.parametrize("model", ["bpe", "ckpt"])
@pytest.mark.parametrize("i", range(len(CHATS)))
@pytest.mark.parametrize("raw", [False, True])
def test_chat_preprocessing_equal(sides, model, i, raw):
    out = []
    for side in sides[model]:
        body = _body(messages=CHATS[i])
        if raw:
            body["dyn_ext"] = {"use_raw_prompt": True}
        req = side.openai.ChatCompletionRequest.from_body(body)
        pre, prompt = side.pre.preprocess_chat(req)
        out.append((pre.to_dict(), prompt))
    assert out[1] == out[0]


@pytest.mark.parametrize("model", ["bpe", "ckpt"])
@pytest.mark.parametrize("prompt", ["the quick brown fox", "", "<|user|> é", [5, 6, 7]])
def test_completion_preprocessing_equal(sides, model, prompt):
    out = []
    for side in sides[model]:
        req = side.openai.CompletionRequest.from_body(_body(prompt=prompt, echo=True))
        pre, text = side.pre.preprocess_completion(req)
        out.append((pre.to_dict(), text))
    assert out[1] == out[0]


@pytest.mark.parametrize("kind", ["chat", "completion", "ids", "bad_prompt", "bad_part"])
def test_rejections_equal(sides, kind):
    msgs = []
    for side in sides["ckpt"]:  # context length 256
        long = " ".join(["the capital"] * 200)
        if kind == "chat":
            req = side.openai.ChatCompletionRequest.from_body(
                _body(messages=[{"role": "user", "content": long}]))
            call = lambda: side.pre.preprocess_chat(req)  # noqa: E731
        elif kind == "bad_part":
            req = side.openai.ChatCompletionRequest.from_body(
                _body(messages=[{"role": "user", "content": [{"type": "image_url"}]}]))
            call = lambda: side.pre.preprocess_chat(req)  # noqa: E731
        else:
            prompt = {"completion": long, "ids": [5] * 300, "bad_prompt": [5, "x"]}[kind]
            req = side.openai.CompletionRequest.from_body(_body(prompt=prompt))
            call = lambda: side.pre.preprocess_completion(req)  # noqa: E731
        with pytest.raises(side.openai.RequestError) as info:
            call()
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]


class Scripted:
    """An engine that streams fixed EngineOutput dicts."""

    def __init__(self, frames):
        self.frames = frames
        self.stopped = None

    async def generate(self, request):
        async def gen():
            for f in self.frames:
                yield dict(f)
            self.stopped = request.is_stopped()

        return gen()


def _backend_run(side, frames, stop, max_tokens, eos, ignore_eos=False):
    from dynamo_tpu.llm.protocols.common import (PreprocessedRequest, SamplingOptions,
                                                 StopConditions)

    pre = PreprocessedRequest(
        token_ids=[5], eos_token_ids=eos,
        stop_conditions=StopConditions(max_tokens=max_tokens, stop=stop, ignore_eos=ignore_eos),
        sampling_options=SamplingOptions(),
    )
    eng = Scripted(frames)

    async def go():
        stream = await side.link(side.backend, eng).generate(side.ctx(pre.to_dict()))
        return [f async for f in stream]

    return asyncio.run(go()), eng.stopped


def _ids(side, text):
    return side.backend.tokenizer.encode(text)


@pytest.mark.parametrize("case", ["jail_released", "jail_hit_mid_chunk", "max_tokens", "eos",
                                  "ignore_eos", "flush_on_finish", "no_finish", "one_token_a_frame"])
def test_backend_frames_equal(sides, case):
    got = []
    for side in sides["bpe"]:
        fox = _ids(side, " the quick brown fox jumps over")
        lazy = _ids(side, " the lazy dog")
        eos = side.backend.tokenizer.token_to_id("<|eos|>")
        stop, max_tokens, eos_ids, ignore = ["brown f"], None, [eos], False
        if case == "jail_released":
            frames = [{"token_ids": fox[:3]}, {"token_ids": fox[3:]},
                      {"token_ids": [], "finish_reason": "length"}]
            stop = ["brown z"]
        elif case == "jail_hit_mid_chunk":
            frames = [{"token_ids": fox}, {"token_ids": lazy, "finish_reason": "length"}]
        elif case == "max_tokens":
            frames = [{"token_ids": fox + lazy}]
            max_tokens, stop = 5, []
        elif case in ("eos", "ignore_eos"):
            frames = [{"token_ids": lazy[:2] + [eos] + lazy[2:]},
                      {"token_ids": [], "finish_reason": "length"}]
            ignore = case == "ignore_eos"
        elif case == "flush_on_finish":
            frames = [{"token_ids": fox[:4], "finish_reason": "length"}]
            stop = [" brown fox and more"]
        elif case == "no_finish":
            frames = [{"token_ids": fox[:4]}]
            stop = [" brown fox and more"]
        else:  # one token a frame
            frames = [{"token_ids": [t]} for t in fox] + [{"token_ids": [],
                                                           "finish_reason": "stop"}]
        got.append(_backend_run(side, frames, stop, max_tokens, eos_ids, ignore))
    assert got[1] == got[0]
    assert got[0][0], "the backend produced no frame"


def _normalize(chunk: dict) -> dict:
    return {k: v for k, v in chunk.items() if k not in ("id", "created")}


async def _pipeline_stream(side, request):
    pipe = side.link(side.pre, side.backend, side.engines.EchoEngineCore())
    stream = await pipe.generate(side.ctx(request))
    return [_normalize(c) async for c in stream]


@pytest.mark.parametrize("model", ["bpe", "ckpt"])
@pytest.mark.parametrize("kind", ["chat", "completion_echo", "completion_ids", "chat_n2"])
def test_pipeline_streams_equal(sides, model, kind, monkeypatch):
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    got = []
    for side in sides[model]:
        o = side.openai
        ann = {"annotations": ["formatted_prompt", "token_ids"]}
        if kind.startswith("chat"):
            req = o.ChatCompletionRequest.from_body({
                "model": "m", "messages": CHATS[1], "max_tokens": 6, "stop": ["capital"],
                "nvext": ann, "n": 2 if kind == "chat_n2" else 1})
        elif kind == "completion_echo":
            req = o.CompletionRequest.from_body({"model": "m", "prompt": "the quick brown fox",
                                                 "echo": True, "nvext": ann})
        else:
            req = o.CompletionRequest.from_body({"model": "m", "prompt": [5, 6, 7, 8],
                                                 "max_tokens": 3})
        chunks = asyncio.run(_pipeline_stream(side, req))
        if kind == "chat_n2":  # the two choices interleave as their pumps run
            chunks.sort(key=lambda c: (c.get("choices") or [{}])[0].get("index", -1))
        got.append(chunks)
    assert got[1] == got[0]
    assert any(c.get("usage") for c in got[0])
