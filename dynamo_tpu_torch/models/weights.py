"""Weight loading: HF safetensors checkpoints -> the port's param dict.

The reader is written on the file format alone (no `safetensors`
package): an 8-byte little-endian header length, a JSON header mapping
each tensor name to its dtype, shape and [begin, end) byte range in the
data section, then the raw little-endian bytes, viewed with
`torch.frombuffer`.

HF stores linear weights [out, in]; the port keeps the JAX package's
[in, out] (x @ w), the experts stacked [E, in, out].
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Iterator, Optional

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import Params

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) for every tensor of one .safetensors file,
    in header order. Each tensor is a copy, independent of the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        size = os.fstat(f.fileno()).st_size
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                dtype = _DTYPES.get(meta["dtype"])
                if dtype is None:
                    raise ValueError(f"{path}: {name} has unsupported dtype {meta['dtype']}")
                begin, end = meta["data_offsets"]
                shape = list(meta["shape"])
                count = 1
                for s in shape:
                    count *= s
                itemsize = torch.empty((), dtype=dtype).element_size()
                if end - begin != count * itemsize or base + end > size:
                    raise ValueError(f"{path}: {name} byte range does not match its shape")
                if count == 0:
                    yield name, torch.empty(shape, dtype=dtype)
                    continue
                t = torch.frombuffer(mm, dtype=dtype, count=count, offset=base + begin)
                yield name, t.reshape(shape).clone()
                del t


def _iter_safetensors(model_dir: str):
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    for fname in files:
        yield from read_safetensors(os.path.join(model_dir, fname))


def load_config(model_dir: str, name: Optional[str] = None) -> ModelConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return ModelConfig.from_hf_config(hf, name=name or os.path.basename(model_dir))


_HF_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


# Mixtral's expert matrices -> the stacked [E, ...] leaves
_MOE_MAP = {"w1": "we_gate", "w3": "we_up", "w2": "we_down"}


def load_params(model_dir: str, cfg: ModelConfig, *, device,
                dtype=torch.bfloat16) -> Params:
    """Load a Llama-family HF checkpoint dir onto `device`, one tensor at a
    time. A Mixtral checkpoint's `block_sparse_moe.gate.weight` becomes the
    layer's router [D, E], and its `block_sparse_moe.experts.{e}.{w1,w3,w2}`
    matrices are staged on the host per (layer, matrix) until all E have
    arrived, then stacked into we_gate/we_up [E, D, F] and we_down
    [E, F, D] on the device: the host holds at most one group at a time."""

    def convert(t: torch.Tensor, transpose: bool) -> torch.Tensor:
        t = t.to(dtype)
        return (t.T.contiguous() if transpose else t).to(device)

    layers: list[dict] = [dict() for _ in range(cfg.num_layers)]
    params: Params = {"layers": layers}
    moe_stage: dict[tuple[int, str], dict[int, torch.Tensor]] = {}
    for name, tensor in _iter_safetensors(model_dir):
        if name == "model.embed_tokens.weight":
            params["embed"] = convert(tensor, False)
        elif name == "model.norm.weight":
            params["final_norm"] = convert(tensor, False)
        elif name == "lm_head.weight":
            if not cfg.tie_word_embeddings:
                params["lm_head"] = convert(tensor, True)
        elif name.startswith("model.layers."):
            idx_s, _, sub = name[len("model.layers."):].partition(".")
            idx = int(idx_s)
            if sub == "block_sparse_moe.gate.weight":
                layers[idx]["router"] = convert(tensor, True)
                continue
            if sub.startswith("block_sparse_moe.experts."):
                e_s, _, w_name = sub[len("block_sparse_moe.experts."):].partition(".")
                ours = _MOE_MAP.get(w_name.split(".")[0])
                if ours is not None:
                    group = moe_stage.setdefault((idx, ours), {})
                    group[int(e_s)] = tensor.to(dtype).T  # HF stores [out, in]
                    if len(group) == cfg.num_experts:
                        layers[idx][ours] = torch.stack(
                            [group[e] for e in sorted(group)]).to(device)
                        del moe_stage[(idx, ours)]
                continue
            mapped = _HF_LAYER_MAP.get(sub)
            if mapped is None:
                continue  # rotary inv_freq etc.
            ours, transpose = mapped
            layers[idx][ours] = convert(tensor, transpose)
    if moe_stage:
        short = sorted(
            f"layers[{i}].{ours}({len(g)}/{cfg.num_experts} experts)"
            for (i, ours), g in moe_stage.items()
        )
        raise ValueError(f"checkpoint {model_dir} has incomplete expert groups: {short[:5]}")
    required = ["wq"]
    if cfg.num_experts:
        required += ["router", "we_gate", "we_up", "we_down"]
    missing = [k for k in ("embed", "final_norm") if k not in params] + [
        f"layers[{i}].{r}" for i, lp in enumerate(layers) for r in required if r not in lp
    ]
    if missing:
        raise ValueError(f"checkpoint {model_dir} missing tensors: {missing[:5]}")
    return params
