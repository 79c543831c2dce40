"""The engine: continuous batching over a paged KV cache on one device."""

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine

__all__ = ["EngineConfig", "TorchEngine"]
