"""LocalModel: resolve a model directory into a card + a TorchEngine.

The port of the JAX package's `llm/local_model.py` (reference:
lib/llm/src/local_model.rs:37-124): it resolves what the user named on the
command line into everything serving needs. Zero-egress: only local
HF-style directories (config.json + tokenizer.json [+ *.safetensors]).
With safetensors the engine reads them with the port's own reader
(`models/weights.load_params`); without, it random-inits from the
engine's seed (benchmark/dev mode, loudly logged), and the config may name
a preset (`"dynamo_tpu_preset"`) instead of HF dimensions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.local_model")


@dataclass
class LocalModel:
    card: ModelDeploymentCard
    model_cfg: ModelConfig
    model_path: str
    has_weights: bool
    extra_engine_args: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def prepare(cls, path: str, name: Optional[str] = None) -> "LocalModel":
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"model path {path!r} is not a directory (zero-egress build: "
                "pass a local HF-style model dir)"
            )
        card = ModelDeploymentCard.from_local_path(path, name=name)
        hf_cfg = card.load_config()
        if hf_cfg.get("hidden_size"):
            model_cfg = ModelConfig.from_hf_config(hf_cfg, name=card.display_name)
        else:
            preset = hf_cfg.get("dynamo_tpu_preset") or "tiny"
            model_cfg = PRESETS[preset]
        has_weights = any(
            f.endswith(".safetensors") for f in os.listdir(path)
        )
        if not has_weights:
            log.warning(
                "model %s has no safetensors — engine will RANDOM-INIT "
                "weights (dev/benchmark mode)", card.display_name,
            )
        return cls(
            card=card,
            model_cfg=model_cfg,
            model_path=path,
            has_weights=has_weights,
        )

    def engine_config(self, **overrides):
        from dynamo_tpu_torch.engine import EngineConfig

        kw: dict[str, Any] = dict(
            model=self.model_cfg,
            checkpoint_dir=self.model_path if self.has_weights else None,
            max_model_len=min(
                self.card.context_length or 2048,
                overrides.pop("max_model_len", 1 << 30),
            ),
        )
        kw.update(self.extra_engine_args)
        kw.update(overrides)
        return EngineConfig(**kw)

    def build_engine(self, device: Optional[str] = None, **overrides):
        """A TorchEngine on `device` (None: the GPU, and with none the
        engine's own error; "cpu" runs the plain PyTorch versions)."""
        from dynamo_tpu_torch.engine import TorchEngine

        return TorchEngine(self.engine_config(**overrides), device=device)
