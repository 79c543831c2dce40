"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu for one NVIDIA H100.

It mirrors the JAX package's layout (models/, ops/, engine/, llm/,
runtime/) and imports nothing from it. The engine's main path runs on
hand-written CUDA kernels under csrc/, built with nvcc at first use; on the
CPU every kernel wrapper runs its plain PyTorch version instead.
"""

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine

__all__ = ["EngineConfig", "TorchEngine"]
