"""Internal backend IO types.

Equivalent of the reference's common protocol layer (reference:
lib/llm/src/protocols/common/llm_backend.rs:23-80, common.rs:205-290):
`PreprocessedRequest` is what flows from the preprocessor to an engine
(token ids + stop/sampling config); `EngineOutput` is what an engine streams
back (new token ids, optional detokenized text, finish reason).

All types are dataclasses with dict converters — plain dicts are what cross
the data plane (msgpack), so remote and in-process pipelines see identical
payloads.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Optional

FINISH_REASON_EOS = "stop"  # matched eos or stop id/sequence
FINISH_REASON_LENGTH = "length"
FINISH_REASON_STOP = "stop"
FINISH_REASON_CANCELLED = "cancelled"
FINISH_REASON_ERROR = "error"
# end-to-end deadline expired (admission queue or mid-flight); the HTTP
# layer maps a zero-token timeout finish to 429 + Retry-After when the
# response is not yet streaming (docs/robustness.md "Deadlines")
FINISH_REASON_TIMEOUT = "timeout"


class DeadlineExceededError(RuntimeError):
    """Request deadline (x-request-timeout / EngineConfig.request_timeout_s)
    expired before any device work — shed with HTTP 429 + Retry-After
    instead of burning prefill compute on a caller that stopped waiting."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class PoolExhaustedError(RuntimeError):
    """KV page pool could not serve the request within its wait budget —
    a capacity condition (HTTP 503 + Retry-After), not a server bug (500)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class KvQuantMismatchError(ValueError):
    """Two KV planes disagree on kv_quantization (bf16 vs int8 vs int4).

    Quantized KV moves pool-to-pool on the PACKED representation —
    quantize exactly once at KV-write time, never a requantization hop —
    so a cross-tier transfer has no lossless conversion. Raised by the
    device-path transfer (engine/kv_transfer.py), the cross-process wire
    (engine/xproc_kv.py) and wire-payload injection instead of silently
    dequant/requantizing. A ValueError subclass: callers that treated
    the old untyped mismatch as a 400-class error keep working."""


@dataclass
class StopConditions:
    """reference: lib/llm/src/protocols/common.rs:205."""

    max_tokens: Optional[int] = None
    stop: list[str] = field(default_factory=list)  # stop strings (hidden)
    stop_token_ids: list[int] = field(default_factory=list)
    min_tokens: Optional[int] = None
    ignore_eos: bool = False

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict | None) -> "StopConditions":
        return cls(**(d or {}))


@dataclass
class SamplingOptions:
    """reference: lib/llm/src/protocols/common.rs:248."""

    n: int = 1
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    greedy: bool = False
    # report per-token logprobs of the sampled tokens (OpenAI `logprobs`)
    logprobs: bool = False
    # with logprobs: also the top-n alternatives per position (OpenAI
    # `top_logprobs`; engine clamps to 8)
    top_logprobs: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict | None) -> "SamplingOptions":
        d = dict(d or {})
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class PreprocessedRequest:
    """Token-level request from preprocessor to engine
    (reference: llm_backend.rs:23 BackendInput)."""

    token_ids: list[int]
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    eos_token_ids: list[int] = field(default_factory=list)
    annotations: list[str] = field(default_factory=list)
    mdc_sum: Optional[str] = None  # model-deployment-card checksum
    # disaggregation extras (set by the disagg router / prefill path)
    disagg: dict[str, Any] = field(default_factory=dict)
    # multimodal: embeddings replacing token lookups for positions
    # [embeds_offset, embeds_offset + len(prompt_embeds)) — the LLaVA-style
    # image-patch injection (reference: examples/multimodal encode worker
    # -> vLLM prompt-embeds path). Nested lists [T_img, D] on the wire.
    prompt_embeds: Optional[list] = None
    embeds_offset: int = 0

    def to_dict(self) -> dict:
        return {
            "token_ids": self.token_ids,
            "stop_conditions": self.stop_conditions.to_dict(),
            "sampling_options": self.sampling_options.to_dict(),
            "eos_token_ids": self.eos_token_ids,
            "annotations": self.annotations,
            "mdc_sum": self.mdc_sum,
            "disagg": self.disagg,
            "prompt_embeds": self.prompt_embeds,
            "embeds_offset": self.embeds_offset,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d["token_ids"]),
            stop_conditions=StopConditions.from_dict(d.get("stop_conditions")),
            sampling_options=SamplingOptions.from_dict(d.get("sampling_options")),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            annotations=list(d.get("annotations") or []),
            mdc_sum=d.get("mdc_sum"),
            disagg=dict(d.get("disagg") or {}),
            prompt_embeds=d.get("prompt_embeds"),
            embeds_offset=int(d.get("embeds_offset") or 0),
        )


@dataclass
class EngineOutput:
    """One streamed engine step (reference: llm_backend.rs:60
    LLMEngineOutput)."""

    token_ids: list[int] = field(default_factory=list)
    tokens: list[str] = field(default_factory=list)
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    log_probs: Optional[list[float]] = None
    # per emitted token: [[token_id, logprob] x n] alternatives
    top_log_probs: Optional[list] = None
    finish_reason: Optional[str] = None
    # engine-side metadata (kv hit info, worker id, timing) for annotations
    meta: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineOutput":
        return cls(
            token_ids=list(d.get("token_ids") or []),
            tokens=list(d.get("tokens") or []),
            text=d.get("text"),
            cum_log_probs=d.get("cum_log_probs"),
            log_probs=d.get("log_probs"),
            top_log_probs=d.get("top_log_probs"),
            finish_reason=d.get("finish_reason"),
            meta=dict(d.get("meta") or {}),
        )

    @classmethod
    def final(cls, reason: str) -> "EngineOutput":
        return cls(finish_reason=reason)
