"""Rotary position embeddings, HF rotate-half convention, Llama-3.1 scaling.

Frequencies are computed in float64 numpy (the llama3 NTK-by-parts bands
need the precision) and cast to float32; the rotation runs in float32
before casting back.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig


def rope_inv_freq(cfg: ModelConfig) -> np.ndarray:
    """Per-pair inverse frequencies [head_dim//2], with optional llama3
    NTK-by-parts scaling (matches HF `Llama3RotaryEmbedding`)."""
    half = cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, half, dtype=np.float64) / half))
    sc = cfg.rope_scaling
    if sc and sc.get("rope_type") in ("llama3",):
        factor = sc["factor"]
        low = sc["low_freq_factor"]
        high = sc["high_freq_factor"]
        orig = sc["original_max_position_embeddings"]
        wavelen = 2 * np.pi / inv
        # long wavelengths scaled by 1/factor, short untouched, a smooth
        # ramp between (the clip collapses it to 1/factor in the long band)
        smooth = np.clip((orig / wavelen - low) / (high - low), 0.0, 1.0)
        inv = np.where(
            wavelen > orig / high,
            (1 - smooth) * inv / factor + smooth * inv,
            inv,
        )
    return inv.astype(np.float32)


def rope_cos_sin(inv_freq: torch.Tensor, positions: torch.Tensor):
    """cos/sin tables for integer positions [...]: returns [..., head_dim]
    (frequencies tiled twice, HF layout)."""
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate `x` [..., H, head_dim] by per-position cos/sin [..., head_dim]
    (broadcast over the head axis)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c1 = cos[..., None, :half]
    c2 = cos[..., None, half:]
    s1 = sin[..., None, :half]
    s2 = sin[..., None, half:]
    out = torch.cat([x1 * c1 - x2 * s1, x2 * c2 + x1 * s2], dim=-1)
    return out.to(x.dtype)
