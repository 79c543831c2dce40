"""RMSNorm with float32 accumulation (Llama-family).

`weight_offset`: Gemma stores norm weights as w with the multiplier
being (1 + w) — pass 1.0 there, 0.0 for Llama/Mistral/Qwen."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float,
    weight_offset: float = 0.0,
) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float() + weight_offset
    return (normed * w).to(x.dtype)
