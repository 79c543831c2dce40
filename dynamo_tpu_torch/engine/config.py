"""Engine configuration (the JAX package's `EngineConfig`, without the mesh).

The fields keep their names and meaning. The features the port does not
run yet keep their fields with the "off" value, and setting one raises
`NotImplementedError` at construction: a request for TP overlap must
never be served by a silent approximation. The host offload tier
(`host_kv_pages`, `offload_batch_pages`) and the disaggregated prefill's
page wait (`prefill_wait_s`) are ported. W8A8 weights
(`quantization="int8"`) are ported; any other value raises `ValueError`,
as in the JAX engine. `kv_quantization="int8"` and `"int4"` are ported; int4 with one scale group
per kv head (`kv_quant_group` None or head_dim) only. Speculative decoding
(`spec_decode`) and stall-free mixed prefill+decode steps
(`mixed_batching`) are ported, alone and together, with the step pipeline
(`step_pipeline`, on by default as in the JAX package) and without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from dynamo_tpu_torch.models.config import ModelConfig, get_config

# field -> the value that means "off"; anything else is not ported yet
_UNPORTED = {
    "tp_overlap": False,
}


@dataclass
class EngineConfig:
    model: Union[str, ModelConfig] = "tiny"
    checkpoint_dir: Optional[str] = None  # HF safetensors dir; None = random init
    dtype: str = "bfloat16"               # "bfloat16" or "float32"

    # tokens per KV page; prefill_chunk must be a multiple of it (the
    # page-scatter write lands whole pages)
    page_size: int = 64
    num_pages: Optional[int] = None  # total pages incl. trash page 0; None = auto
    hbm_utilization: float = 0.85    # fraction of free device memory for KV

    max_batch_size: int = 8       # decode slots
    max_model_len: int = 2048     # context limit per sequence
    prefill_chunk: int = 512      # longest single prefill call
    # total tokens (padded rows x bucket) in one batched prefill dispatch
    prefill_group_tokens: int = 32768
    decode_steps: int = 8         # decode steps per dispatch (device-side loop)
    # during a pure admission wave, hold decode until this fraction of
    # slots is decode-ready (never delays running streams); 0 disables
    decode_ready_frac: float = 1.0
    # admission picks the highest priority class first (FIFO within one)
    priority_scheduling: bool = True
    seed: int = 0

    quantization: Optional[str] = None     # None or "int8" (W8A8 weights)
    kv_quantization: Optional[str] = None  # None, "int8" or "int4"
    # int4 scale-group size in features per kv head; None = head_dim (one
    # scale per token and kv head, what the kernels take). Ignored unless
    # kv_quantization == "int4", as in the JAX package.
    kv_quant_group: Optional[int] = None
    # host-RAM offload tier (engine/offload.py): pages a pool of this many
    # page buffers holds after HBM evicts them (0 disables), copied out in
    # background gathers of up to offload_batch_pages pages
    host_kv_pages: int = 0
    offload_batch_pages: int = 16
    # self-speculative decoding (engine/spec.py): n-gram drafts from the
    # sequence's own history, verified in one multi-query step (greedy
    # acceptance is exact match; sampled rows keep the sampler's
    # distribution by rejection sampling)
    spec_decode: bool = False
    spec_k_max: int = 4       # max drafted tokens per verify step
    spec_ngram_max: int = 3   # longest suffix n-gram the proposer matches
    # sliding window (positions) of the per-sequence n-gram index
    spec_index_window: int = 8192
    # stall-free mixed batching: while decode-ready rows and prefill chunks
    # coexist, one token-budgeted step carries both (decode rows at q_len
    # 1, chunks shrunk to the budget's leftover), read through the ragged
    # paged attention (K4)
    mixed_batching: bool = False
    # with spec_decode too: decode rows inside mixed steps carry their
    # drafts as q_len 1 + k verify rows (the budget counts 1 + k)
    mixed_spec: bool = True
    # token budget of one mixed step; non-final chunks round down to a
    # page multiple
    mixed_step_tokens: int = 1024
    # True: every decode row joins and prefill shrinks around them; False:
    # chunks keep their size and decode rows join only if all fit
    mixed_decode_priority: bool = True
    # the step pipeline: decode dispatch N+1 is enqueued behind N through a
    # device-resident carry while N's tokens are fetched, and a prefill's
    # first token is fetched asynchronously; False = the serialized
    # dispatch -> fetch -> sync baseline (same streams, other scheduling)
    step_pipeline: bool = True
    tp_overlap: bool = False
    # default end-to-end deadline per request, seconds (0 = none); a
    # request's own metadata "deadline" takes precedence. Expired requests
    # are shed from the queue or finished mid-flight with "timeout".
    request_timeout_s: float = 0.0
    # disaggregated prefill (`TorchEngine.prefill_only`): how long a prefill
    # waits for KV pages before PoolExhaustedError, capped by the request's
    # own deadline
    prefill_wait_s: float = 60.0

    def __post_init__(self) -> None:
        for name, off in _UNPORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: not ported "
                    "to dynamo_tpu_torch yet (see ROADMAP.md)"
                )
        if self.quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {self.quantization!r}")
        if self.kv_quantization not in (None, "int8", "int4"):
            raise NotImplementedError(
                f"EngineConfig.kv_quantization={self.kv_quantization!r}: only "
                "'int8' and 'int4' are ported to dynamo_tpu_torch (see ROADMAP.md)"
            )
        if self.kv_quantization == "int4" and self.kv_quant_group is not None:
            hd = self.model_config().head_dim
            grp = self.kv_quant_group
            if grp <= 0 or hd % grp:
                raise ValueError(f"kv_quant_group={grp} must divide head_dim={hd}")
            if grp != hd:
                # the JAX package serves finer groups on its gather backend
                # only, which the port does not have
                raise NotImplementedError(
                    f"EngineConfig.kv_quant_group={grp} (< head_dim {hd}): the "
                    "int4 kernels take one scale group per kv head; finer groups "
                    "are not ported to dynamo_tpu_torch yet (see ROADMAP.md)"
                )
        if self.spec_decode and self.spec_k_max < 1:
            raise ValueError("spec_k_max must be >= 1")
        if self.mixed_batching and self.mixed_step_tokens < 1:
            raise ValueError("mixed_step_tokens must be >= 1")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be bfloat16 or float32, got {self.dtype!r}")
        if self.prefill_chunk % self.page_size:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be a multiple of "
                f"page_size ({self.page_size})"
            )

    def model_config(self) -> ModelConfig:
        cfg = get_config(self.model) if isinstance(self.model, str) else self.model
        return cfg if cfg.dtype == self.dtype else cfg.with_(dtype=self.dtype)

    @property
    def max_pages_per_seq(self) -> int:
        return -(-self.max_model_len // self.page_size)

    def prefill_buckets(self) -> list[int]:
        """Power-of-two token buckets for prefill calls, ending at
        prefill_chunk."""
        buckets = []
        b = max(self.page_size, 16)
        while b < self.prefill_chunk:
            buckets.append(b)
            b *= 2
        buckets.append(self.prefill_chunk)
        return buckets
