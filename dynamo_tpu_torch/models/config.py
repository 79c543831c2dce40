"""Model configurations for the Llama family (Llama 2/3, Mistral, Qwen2,
Gemma): a copy of `dynamo_tpu/models/config.py`, so the port imports
nothing from the JAX package.

Conventions:
- `head_dim` is explicit (Llama3 keeps hidden/heads, but e.g. Qwen2-0.5B
  differs), GQA via `num_kv_heads < num_heads`.
- `rope_scaling` carries the Llama-3.1 long-context NTK scaling dict.
- dtypes: weights/activations bfloat16, float32 for norms/softmax
  accumulation inside the ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = False
    attn_bias: bool = False  # qwen2-style qkv bias
    rope_scaling: Optional[dict[str, Any]] = None
    dtype: str = "bfloat16"
    # gemma-family: GeGLU activation, sqrt(d)-scaled embeddings, and
    # (offset + w) norm-weight convention (gemma: 1.0)
    hidden_act: str = "silu"
    scale_embeddings: bool = False
    norm_weight_offset: float = 0.0
    # sparse MoE (mixtral-style): 0 experts = dense FFN
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    @classmethod
    def from_hf_config(cls, hf: dict, name: str = "hf-model") -> "ModelConfig":
        """Build from a HuggingFace config.json dict (llama/mistral/qwen2)."""
        num_heads = hf["num_attention_heads"]
        head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads
        return cls(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=hf.get("num_key_value_heads", num_heads),
            head_dim=head_dim,
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            # GemmaConfig defaults tie_word_embeddings=True and
            # to_diff_dict drops default values from config.json
            tie_word_embeddings=hf.get(
                "tie_word_embeddings", hf.get("model_type") == "gemma"
            ),
            attn_bias=hf.get("model_type") == "qwen2",
            rope_scaling=hf.get("rope_scaling"),
            # published Gemma configs put "gelu" in hidden_act with the
            # real activation in hidden_activation; HF's GemmaMLP forces
            # gelu_pytorch_tanh when the latter is absent
            hidden_act=(
                hf.get("hidden_activation") or "gelu_pytorch_tanh"
            ) if hf.get("model_type") == "gemma" else "silu",
            scale_embeddings=hf.get("model_type") == "gemma",
            norm_weight_offset=1.0 if hf.get("model_type") == "gemma" else 0.0,
            num_experts=hf.get("num_local_experts", 0),
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        )


_LLAMA31_SCALING = {
    "rope_type": "llama3",
    "factor": 8.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}

PRESETS: dict[str, ModelConfig] = {}


def _preset(cfg: ModelConfig) -> ModelConfig:
    PRESETS[cfg.name] = cfg
    return cfg

# Tiny config for CPU tests: dims respect TPU tiling multiples where cheap.
TINY = _preset(ModelConfig(
    name="tiny",
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    rope_theta=10000.0,
    max_position_embeddings=2048,
    tie_word_embeddings=True,
))

# Llama-3.2 checkpoints were trained with rope factor 32 (not 3.1's 8).
_LLAMA32_SCALING = {**_LLAMA31_SCALING, "factor": 32.0}

# A ~1.2B debug/bench config (fits any single TPU chip in bf16).
_preset(ModelConfig(
    name="llama-3.2-1b",
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    rope_scaling=_LLAMA32_SCALING,
    tie_word_embeddings=True,
))

_preset(ModelConfig(
    name="llama-3.2-3b",
    vocab_size=128256,
    hidden_size=3072,
    intermediate_size=8192,
    num_layers=28,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    rope_scaling=_LLAMA32_SCALING,
    tie_word_embeddings=True,
))

# Flagship (BASELINE.json north star: disagg Llama-3.1-8B on v5e-16).
_preset(ModelConfig(
    name="llama-3.1-8b",
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_scaling=_LLAMA31_SCALING,
))

_preset(ModelConfig(
    name="llama-3.1-70b",
    vocab_size=128256,
    hidden_size=8192,
    intermediate_size=28672,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_scaling=_LLAMA31_SCALING,
))

_preset(ModelConfig(
    name="qwen2.5-0.5b",
    vocab_size=151936,
    hidden_size=896,
    intermediate_size=4864,
    num_layers=24,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    rope_theta=1000000.0,
    rms_norm_eps=1e-6,
    max_position_embeddings=32768,
    tie_word_embeddings=True,
    attn_bias=True,
))

_preset(ModelConfig(
    name="mistral-7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
))

# Sparse MoE family (the reference serves Mixtral/DeepSeek-MoE through
# vLLM's fused-MoE kernels; here models/moe.py with the ep mesh axis).
TINY_MOE = _preset(ModelConfig(
    name="tiny-moe",
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    rope_theta=10000.0,
    max_position_embeddings=2048,
    tie_word_embeddings=True,
    num_experts=4,
    num_experts_per_tok=2,
))

# Gemma-1 family: GeGLU MLP, sqrt(d)-scaled embeddings, (1+w) norms,
# wide head_dim (256) with kv=1 multi-query attention on the 2B.
_preset(ModelConfig(
    name="gemma-2b",
    vocab_size=256000,
    hidden_size=2048,
    intermediate_size=16384,
    num_layers=18,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
    hidden_act="gelu_pytorch_tanh",
    scale_embeddings=True,
    norm_weight_offset=1.0,
))

_preset(ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
    num_experts=8,
    num_experts_per_tok=2,
))


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
