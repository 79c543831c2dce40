"""Minimal ViT-style vision encoder: images -> LLM-space patch embeddings.

Port of `dynamo_tpu/models/vision.py`, the multimodal encode stage whose
output a request carries as `prompt_embeds` (the LLaVA-style injection the
engine serves): patchify [H, W, 3] -> a linear patch embedding plus learned
positions -> N pre-norm transformer blocks -> a linear projection into the
language model's hidden size. The block is the reference's own: RMSNorm
(eps 1e-5, models' `ops/norm.py`), no biases, no CLS token, a 4 x hidden
MLP with tanh-approximated GELU (`jax.nn.gelu`'s default), the softmax in
f32 and cast back to the activations' dtype before its product with V, and
the score scale hd**-0.5 applied after q.k. Parameters are a plain dict of
tensors at the reference's [in, out] layout, so every matmul is `x @ w`.

The reference computes it without a `pallas_call` (XLA-lowered matmuls and
a softmax), so the port keeps it as torch ops: its matmuls go to cuBLAS on
the card, as the reference's go to XLA on the TPU. Weights are random from
an explicit `torch.Generator` (other values than the reference's from the
same seed); `vision_params_from_jax` carries a reference tree over.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.norm import rms_norm

EPS = 1e-5


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 64
    patch_size: int = 16
    hidden_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    out_size: int = 2048  # language model hidden size

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


def init_vision_params(cfg: VisionConfig, gen: torch.Generator,
                       dtype=torch.float32) -> dict:
    """Random weights on the generator's device: normal, scaled by
    fan_in**-0.5 (positions by num_patches**-0.5), unit norms, as the
    reference draws them."""
    d = cfg.hidden_size

    def dense(shape):
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return w.mul_(shape[0] ** -0.5).to(dtype)

    def ones():
        return torch.ones(d, dtype=dtype, device=gen.device)

    return {
        "patch_proj": dense((cfg.patch_dim, d)),
        "pos_embed": dense((cfg.num_patches, d)),
        "layers": [
            {
                "norm1": ones(),
                "wqkv": dense((d, 3 * d)),
                "wo": dense((d, d)),
                "norm2": ones(),
                "w_up": dense((d, 4 * d)),
                "w_down": dense((4 * d, d)),
            }
            for _ in range(cfg.num_layers)
        ],
        "out_proj": dense((d, cfg.out_size)),
    }


def patchify(cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, num_patches, patch_dim], patches row-major, each
    patch's pixels row-major with their 3 channels innermost."""
    b = images.shape[0]
    p, n = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(b, n, p, n, p, 3)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, n * n, cfg.patch_dim)


def encode(params: dict, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] float in [0, 1] -> [B, num_patches, out_size], in the
    parameters' dtype (the images are cast to it)."""
    dtype = params["patch_proj"].dtype
    x = patchify(cfg, images.to(dtype)) @ params["patch_proj"] + params["pos_embed"]
    h = cfg.num_heads
    hd = cfg.hidden_size // h
    for lp in params["layers"]:
        b, t, d = x.shape
        qkv = rms_norm(x, lp["norm1"], EPS) @ lp["wqkv"]
        q, k, v = qkv.split(d, dim=-1)
        q = q.reshape(b, t, h, hd)
        k = k.reshape(b, t, h, hd)
        v = v.reshape(b, t, h, hd)
        s = torch.einsum("bthd,bshd->bhts", q, k) * hd ** -0.5
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        attn = torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, d)
        x = x + attn @ lp["wo"]
        y = rms_norm(x, lp["norm2"], EPS)
        x = x + F.gelu(y @ lp["w_up"], approximate="tanh") @ lp["w_down"]
    return x @ params["out_proj"]


def vision_params_from_jax(tree: dict, *, device, dtype=None) -> dict:
    """Carry a reference parameter tree (leaves as numpy arrays, e.g. from
    `jax.device_get`) over: the same keys and [in, out] layout. bf16 leaves
    (ml_dtypes) go through float32, which is exact; `dtype` None keeps each
    leaf's own type."""

    def conv(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in tree["layers"]]
    return out
