"""OpenAI-compatible API types, delta generation, and stream aggregation.

Equivalent of the reference's OpenAI protocol layer (reference:
lib/llm/src/protocols/openai.rs + chat_completions/, completions/,
nvext.rs:26-60). Requests are validated loosely (unknown fields ignored) and
carry a `dyn_ext` extension block mirroring the reference's `nvext`
(ignore_eos, top_k, repetition_penalty, greedy sampling, use_raw_prompt,
annotations).

`DeltaGenerator` turns `EngineOutput` steps into chat/completion stream
chunks; `aggregate_chat_stream`/`aggregate_completion_stream` fold a chunk
stream into a full response for non-streaming callers (reference:
chat_completions/aggregator.rs, completions/aggregator.rs).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)


class RequestError(ValueError):
    """Invalid client request → HTTP 400."""


@dataclass
class DynExt:
    """Extension block (reference: nvext.rs:26-60). Accepted under key
    "dyn_ext" or "nvext" for drop-in compatibility."""

    ignore_eos: bool = False
    top_k: Optional[int] = None
    repetition_penalty: Optional[float] = None
    greed_sampling: bool = False
    use_raw_prompt: bool = False
    annotations: list[str] = field(default_factory=list)

    @classmethod
    def from_request(cls, body: dict) -> "DynExt":
        raw = body.get("dyn_ext") or body.get("nvext") or {}
        return cls(
            ignore_eos=bool(raw.get("ignore_eos", False)),
            top_k=raw.get("top_k"),
            repetition_penalty=raw.get("repetition_penalty"),
            greed_sampling=bool(raw.get("greed_sampling", False)),
            use_raw_prompt=bool(raw.get("use_raw_prompt", False)),
            annotations=list(raw.get("annotations") or []),
        )


@dataclass
class ChatCompletionRequest:
    model: str
    messages: list[dict]
    stream: bool = False
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    n: int = 1
    stop: list[str] = field(default_factory=list)
    seed: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    logprobs: bool = False
    top_logprobs: int = 0
    tools: Optional[list[dict]] = None
    tool_choice: Any = None
    ext: DynExt = field(default_factory=DynExt)
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_body(cls, body: dict) -> "ChatCompletionRequest":
        if not isinstance(body.get("model"), str):
            raise RequestError("'model' must be a string")
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise RequestError("'messages' must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m:
                raise RequestError("each message needs a 'role'")
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return cls(
            model=body["model"],
            messages=messages,
            stream=bool(body.get("stream", False)),
            max_tokens=body.get("max_tokens"),
            max_completion_tokens=body.get("max_completion_tokens"),
            temperature=body.get("temperature"),
            top_p=body.get("top_p"),
            n=int(body.get("n", 1)),
            stop=list(stop),
            seed=body.get("seed"),
            frequency_penalty=body.get("frequency_penalty"),
            presence_penalty=body.get("presence_penalty"),
            logprobs=bool(body.get("logprobs", False)),
            top_logprobs=int(body.get("top_logprobs") or 0),
            tools=body.get("tools"),
            tool_choice=body.get("tool_choice"),
            ext=DynExt.from_request(body),
            raw=body,
        )

    def sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            n=self.n,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.ext.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            repetition_penalty=self.ext.repetition_penalty,
            seed=self.seed,
            greedy=self.ext.greed_sampling,
            logprobs=self.logprobs,
            top_logprobs=self.top_logprobs if self.logprobs else 0,
        )

    def stop_conditions(self) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_completion_tokens or self.max_tokens,
            stop=list(self.stop),
            ignore_eos=self.ext.ignore_eos,
        )


@dataclass
class CompletionRequest:
    model: str
    prompt: Any  # str | list[str] | list[int]
    stream: bool = False
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    n: int = 1
    stop: list[str] = field(default_factory=list)
    seed: Optional[int] = None
    echo: bool = False
    # legacy completions logprobs: int (top-k count); we report the
    # sampled token's logprob (top_logprobs alternatives unsupported)
    logprobs: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    ext: DynExt = field(default_factory=DynExt)
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_body(cls, body: dict) -> "CompletionRequest":
        if not isinstance(body.get("model"), str):
            raise RequestError("'model' must be a string")
        if "prompt" not in body:
            raise RequestError("'prompt' is required")
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return cls(
            model=body["model"],
            prompt=body["prompt"],
            stream=bool(body.get("stream", False)),
            max_tokens=body.get("max_tokens"),
            temperature=body.get("temperature"),
            top_p=body.get("top_p"),
            n=int(body.get("n", 1)),
            stop=list(stop),
            seed=body.get("seed"),
            echo=bool(body.get("echo", False)),
            logprobs=body.get("logprobs"),
            frequency_penalty=body.get("frequency_penalty"),
            presence_penalty=body.get("presence_penalty"),
            ext=DynExt.from_request(body),
            raw=body,
        )

    def sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            n=self.n,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.ext.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            repetition_penalty=self.ext.repetition_penalty,
            seed=self.seed,
            greedy=self.ext.greed_sampling,
            # legacy API: logprobs=0 still returns the sampled token's
            # logprob (0 top-alternatives); only absence disables
            logprobs=self.logprobs is not None,
            top_logprobs=int(self.logprobs or 0),
        )

    def stop_conditions(self) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_tokens,
            stop=list(self.stop),
            ignore_eos=self.ext.ignore_eos,
        )


# --------------------------------------------------------------------------
# Delta generation (engine steps → OpenAI stream chunks)
# --------------------------------------------------------------------------


class DeltaGenerator:
    """Builds chat-completion stream chunks (reference: DeltaGeneratorExt /
    chat_completions delta generator)."""

    def __init__(self, model: str, kind: str = "chat"):
        self.id = f"{'chatcmpl' if kind == 'chat' else 'cmpl'}-{uuid.uuid4().hex[:24]}"
        self.model = model
        self.kind = kind
        self.created = int(time.time())
        # choice indices that have already received their `delta.role`
        # (OpenAI's convention is per-choice, not per-stream)
        self._role_sent: set[int] = set()
        self.completion_tokens = 0
        self.prompt_tokens = 0

    def _base(self) -> dict:
        return {
            "id": self.id,
            "object": (
                "chat.completion.chunk" if self.kind == "chat" else "text_completion"
            ),
            "created": self.created,
            "model": self.model,
        }

    def chunk(
        self,
        text: Optional[str],
        finish_reason: Optional[str] = None,
        logprobs: Optional[dict] = None,
        index: int = 0,
    ) -> dict:
        """`logprobs`: chat -> {"content": [{token, logprob}...]};
        completions -> {"tokens": [...], "token_logprobs": [...]}.
        `index`: choice index for n>1 fan-out."""
        out = self._base()
        if self.kind == "chat":
            delta: dict[str, Any] = {}
            if index not in self._role_sent:
                delta["role"] = "assistant"
                self._role_sent.add(index)
            if text:
                delta["content"] = text
            choice = {"index": index, "delta": delta, "finish_reason": finish_reason}
            if logprobs is not None:
                choice["logprobs"] = logprobs
            out["choices"] = [choice]
        else:
            choice = {
                "index": index, "text": text or "", "finish_reason": finish_reason
            }
            if logprobs is not None:
                choice["logprobs"] = logprobs
            out["choices"] = [choice]
        return out

    def usage(self) -> dict:
        return {
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.prompt_tokens + self.completion_tokens,
        }


async def aggregate_chat_stream(chunks: AsyncIterator[dict]) -> dict:
    """Fold stream chunks into a full chat completion, per choice index
    (reference: chat_completions/aggregator.rs)."""
    per: dict[int, dict] = {}
    base: dict = {}
    usage = None
    async for chunk in chunks:
        if not base:
            base = {k: chunk.get(k) for k in ("id", "created", "model")}
        if chunk.get("usage"):
            usage = chunk["usage"]
        for choice in chunk.get("choices", []):
            idx = choice.get("index", 0)
            acc = per.setdefault(
                idx,
                {"text": [], "finish": None, "role": "assistant", "lps": []},
            )
            delta = choice.get("delta", {})
            if delta.get("role"):
                acc["role"] = delta["role"]
            if delta.get("content"):
                acc["text"].append(delta["content"])
            if choice.get("logprobs") and choice["logprobs"].get("content"):
                acc["lps"].extend(choice["logprobs"]["content"])
            if choice.get("finish_reason"):
                acc["finish"] = choice["finish_reason"]
    if not per:  # stream carried no choice entries: one empty choice
        per[0] = {"text": [], "finish": None, "role": "assistant", "lps": []}
    choices = []
    for idx in sorted(per):
        acc = per[idx]
        choice = {
            "index": idx,
            "message": {"role": acc["role"], "content": "".join(acc["text"])},
            "finish_reason": acc["finish"],
        }
        if acc["lps"]:
            choice["logprobs"] = {"content": acc["lps"]}
        choices.append(choice)
    out = {
        "id": base.get("id"),
        "object": "chat.completion",
        "created": base.get("created"),
        "model": base.get("model"),
        "choices": choices,
    }
    if usage:
        out["usage"] = usage
    return out


async def aggregate_completion_stream(chunks: AsyncIterator[dict]) -> dict:
    """reference: completions/aggregator.rs (per choice index)."""
    per: dict[int, dict] = {}
    base: dict = {}
    usage = None
    async for chunk in chunks:
        if not base:
            base = {k: chunk.get(k) for k in ("id", "created", "model")}
        if chunk.get("usage"):
            usage = chunk["usage"]
        for choice in chunk.get("choices", []):
            idx = choice.get("index", 0)
            acc = per.setdefault(
                idx,
                {"text": [], "finish": None, "toks": [], "lps": [], "tops": []},
            )
            if choice.get("text"):
                acc["text"].append(choice["text"])
            lp = choice.get("logprobs")
            if lp:
                acc["toks"].extend(lp.get("tokens") or [])
                acc["lps"].extend(lp.get("token_logprobs") or [])
                acc["tops"].extend(lp.get("top_logprobs") or [])
            if choice.get("finish_reason"):
                acc["finish"] = choice["finish_reason"]
    if not per:
        per[0] = {"text": [], "finish": None, "toks": [], "lps": [], "tops": []}
    choices = []
    for idx in sorted(per):
        acc = per[idx]
        choice = {
            "index": idx,
            "text": "".join(acc["text"]),
            "finish_reason": acc["finish"],
        }
        if acc["toks"] or acc["lps"]:
            choice["logprobs"] = {
                "tokens": acc["toks"], "token_logprobs": acc["lps"]
            }
            if acc["tops"]:
                choice["logprobs"]["top_logprobs"] = acc["tops"]
        choices.append(choice)
    out = {
        "id": base.get("id"),
        "object": "text_completion",
        "created": base.get("created"),
        "model": base.get("model"),
        "choices": choices,
    }
    if usage:
        out["usage"] = usage
    return out
