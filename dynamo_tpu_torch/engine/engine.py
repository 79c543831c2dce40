"""TorchEngine: the continuous-batching execution loop, in PyTorch.

Port of `dynamo_tpu/engine/engine.py::JaxEngine`, main path only:

- admission into fixed decode slots, pages reserved up front and grown
  one at a time during decode (preempting the newest sequence when the
  pool runs dry; it re-prefills on re-admission);
- bucketed chunked prefill: same-bucket chunks of several sequences share
  one [n, bucket] dispatch; each layer writes the chunk's KV pages with
  the page-scatter kernel, then runs flash attention over the pool. With
  `prefill_batch_window_s` fresh first chunks wait while decode is live
  (never behind the pipeline's overshoot dispatch) so paced arrivals
  share one dispatch;
- dense and sparse-MoE models (models/moe.py): an MoE step's padding rows
  take no expert capacity, its genuine tokens read off each step's
  attention spec as the reference reads them off its write slots;
- multi-step decode: `decode_steps` tokens per dispatch in a device-side
  loop (sampled tokens feed the next step without a host sync); each
  layer runs the fused write + decode attention kernel. On a CUDA device
  the dispatch is one replayed CUDA graph (engine/decode_graph.py), the
  counterpart of the reference's jitted scan;
- the step pipeline (`step_pipeline`, the default): decode dispatch N+1
  is enqueued behind N, its input tokens read from a device-resident
  carry vector, while N's tokens copy to the host; block tables and
  sampling parameters live on the device and are scatter-updated only
  for slots whose state changed; a prefill's first token stays on the
  device as the slot's carry and is fetched asynchronously; mixed steps
  launch behind the in-flight dispatch too, their q_len 1 rows reading
  the carry. `step_pipeline=False` is the serialized baseline (dispatch,
  fetch, sync; a prefill's first token emitted at its own dispatch's
  sync): the same streams, other scheduling;
- KV pools in the model's dtype, or int8 with per-token-per-kv-head f32
  scale pools (`kv_quantization="int8"`), or nibble-packed int4 (two codes
  a byte) with the same scale pools (`kv_quantization="int4"`), or with
  head_dim / `kv_quant_group` scale channels a kv head, which the int8,
  int4 and grouped int4 forms of the three kernels read and write;
- prompt embeddings (`prompt_embeds`, `embeds_offset`: the LLaVA-style
  injection of image patches, models/vision.py's output): the span is
  validated before any device work, held on the device from admission in
  the model dtype, and injected by the prefill dispatches whose chunks
  overlap it (a span across chunks splits across them); the prefix cache
  matches and registers only the text pages before the span, and an embed
  sequence prefills through the normal dispatch, never a mixed step;
- W8A8 weights (`quantization="int8"`): every dense projection and the
  vocab head hold int8 codes with per-output-channel scales; a checkpoint
  is quantized layer by layer as it is loaded, a random init as each layer
  is made, and each projection runs the two W8A8 kernels (ops/w8a8.py:
  the input quantized per row once for all projections that read it, then
  the s8 x s8 -> s32 GEMM with its dequantization fused);
- on-device sampling: greedy, temperature, top-k, top-p, and the
  extended sampler (`ops/sampling.py`): frequency, presence and
  repetition penalties over an int8 count row per slot (the prompt
  counted at admission, each sample bumped in the step), per-request
  seeds (a stateless hash of seed, position and rank), and the sampled
  token's logprob with the exact top-N alternatives. Each decode graph is
  keyed on which of these its batch needs; rows that need any of them keep
  the batch off mixed steps and verify dispatches, as in the reference;
- `n > 1` arrives as one stream per choice (the preprocessor forks it);
- `metrics()` (the reference's keys whose planes are ported) and
  `subscribe_requests` (a summary of each finished request);
- stall-free mixed steps (`mixed_batching`): while decode-ready rows and
  prefill chunks coexist, ONE token-budgeted step carries decode rows at
  q_len 1 beside the chunks; its KV lands through the row write and its
  attention through the ragged paged-attention read (K4);
- speculative decoding (`spec_decode`): n-gram drafts from each sequence's
  own history, verified in one multi-query step through the same row write
  and K4 (standalone verify dispatches, or, with `mixed_spec`, verify rows
  of q_len 1 + k inside mixed steps);
- request deadlines (Context metadata "deadline", or the default
  `request_timeout_s`): a request already past its deadline raises
  `DeadlineExceededError` before any device work, a queued one is shed
  and a running one finished, both with finish reason "timeout";
- the prefix cache: admission reuses every cached full page of the
  prompt (the tail prefill starts at the page boundary past them, and at
  least one token is always computed, into a fresh page), full pages are
  registered under their chained block hashes as their KV comes to hold
  emitted tokens only, and the allocator's `stored`/`removed` events go to
  `subscribe_events` subscribers (the KV-aware router's feed);
- the prefix wire: `peek_prefix_tokens`, `export_prefix` (a cached
  prefix's KV rows in the reference's wire format) and `ingest_prefix`
  (whole pages landed through the page-scatter kernel and registered);
- the host offload tier (`host_kv_pages`, engine/offload.py): a hashed
  page whose last reference drops is queued for a write-through copy to a
  host-RAM pool; between prefill waves the loop gathers a batch of them on
  the device and copies it to the pool's buffers (on a CUDA device a
  non-blocking copy on a side stream, put in the pool once its event is
  seen to complete), so a prompt whose pages HBM evicted since restores
  them from the host (a copy to the device, then the page-scatter kernel)
  instead of recomputing them, unless the restore gate's measured rates
  say recomputing is faster;
- the disaggregation entries: `prefill_only` (the prompt's KV and first
  token in the prefix wire's format, its pages left cached) and
  `generate_remote` (decode from such a wire, landed chunk by chunk
  through the page-scatter kernel in place of the prefill); the
  in-process device path between two engines is engine/kv_transfer.py;
- streamed `EngineOutput` frames, finishing on max_tokens or EOS; the
  first frame after an admission carries the prefix hit in its meta;
- the robustness and observability planes: `DYN_FAULTS` points
  (utils/faults.py) at reservation, prefill, mixed and decode dispatch and
  release; the degrade ladder (engine/degrade.py: step_pipeline, spec,
  mixed, decode_scan) walked by the watchdog (`watchdog_dispatch_s`) on a
  stalled dispatch enqueue or fetch, with re-probe; a failed prefill group
  retried row by row and a failed mixed step contained (its rows rolled
  back, the `mixed` rung tripped for good), unless a sticky CUDA error
  poisoned the context; the KV custody ledger (engine/kv_ledger.py) with
  its periodic audit; the flight recorder's per-step digests
  (engine/flight_recorder.py); trace spans and instants (utils/tracing.py,
  host clock only: no hook waits for the device); the profiler's phase
  annotations (engine/profiler.py); compile events and device memory
  (engine/telemetry.py).

The engine runs on a CUDA device unless the caller asks for the CPU, where
every kernel wrapper takes its plain PyTorch version and the decode step
runs eagerly. The host loop is single-threaded asyncio and owns the
allocator, slots and queues; CUDA launches are asynchronous already, so
no worker thread is needed: a fetch is a non-blocking copy into pinned
memory behind a recorded event that the loop polls.

Uniform step invariant (as in the reference): a decoding sequence has KV
for exactly `total_tokens - 1` positions; the newest sampled token is fed
back and its KV written by the next step. Prefill computes KV for every
current token and samples the next, so admission and preemption-resume
are the same path.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import time
from collections import deque
from typing import AsyncIterator, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine import flight_recorder as flightmod
from dynamo_tpu_torch.engine import kv_ledger as kvledgermod
from dynamo_tpu_torch.engine import profiler, telemetry
from dynamo_tpu_torch.engine.allocator import PageAllocator
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.decode_graph import DecodeGraphs
from dynamo_tpu_torch.engine.degrade import DegradeLadder
from dynamo_tpu_torch.engine.offload import HostKvPool
from dynamo_tpu_torch.engine.scheduler import (
    Sequence,
    pick_admission_index,
    pick_preemption_victim,
)
from dynamo_tpu_torch.engine.spec import NgramProposer
from dynamo_tpu_torch.llm.protocols.common import (
    FINISH_REASON_CANCELLED,
    FINISH_REASON_ERROR,
    FINISH_REASON_LENGTH,
    FINISH_REASON_TIMEOUT,
    DeadlineExceededError,
    EngineOutput,
    KvQuantMismatchError,
    PoolExhaustedError,
    PreprocessedRequest,
)
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence, compute_block_hashes
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.moe import expert_capacity
from dynamo_tpu_torch.ops import _cuda, quant
from dynamo_tpu_torch.ops.quant import is_quantized, logical_param_count, quantize_params
from dynamo_tpu_torch.ops.kv_write import paged_kv_write
from dynamo_tpu_torch.ops.rope import rope_inv_freq
from dynamo_tpu_torch.ops.sampling import (
    TOP_LOGPROBS_MAX,
    bump_counts,
    count_tokens,
    sample_tokens,
    verify_draft_tokens,
)
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.utils import artifacts, faults, instance, tracing

log = logging.getLogger("dynamo_tpu_torch.engine")


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _wire_tensor(a) -> torch.Tensor:
    """A wire array as a CPU tensor: tensors pass, numpy arrays (and
    arrays exposing `__array__`) are wrapped (copied when read-only), and
    a bfloat16 array of the ml_dtypes type is read by its bits."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")  # a tensor must not alias read-only memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class _Fetch:
    """Device results on their way to the host. On a CUDA device each
    tensor is copied without blocking into pinned memory behind a recorded
    event, and `get()` polls the event, so the loop serves other work (and
    the device runs the next dispatch) while the copy lands. On the CPU the
    results are already on the host. A None entry (an output the dispatch
    was not asked for) stays None."""

    __slots__ = ("host", "event")

    def __init__(self, tensors):
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = [
                None if t is None else
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in tensors
            ]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def _numpy(self) -> list:
        return [None if h is None else h.numpy() for h in self.host]

    async def get(self) -> list:
        if self.event is not None:
            while not self.event.query():
                await asyncio.sleep(0)
            return self._numpy()
        return await asyncio.to_thread(self._numpy)

    async def tensors(self) -> list:
        """The host tensors, once the copies have landed."""
        if self.event is not None:
            while not self.event.query():
                await asyncio.sleep(0)
        return self.host


class _Dispatch:
    """One in-flight dispatch (decode loop, spec verify, or a pipelined
    mixed step): its fetch and the slot snapshot it was built from."""

    __slots__ = ("out", "snapshot", "steps", "spec", "pos0", "draft_lens", "mixed", "bld")

    def __init__(self, out, snapshot, steps, spec=False, pos0=None, draft_lens=None,
                 mixed=False, bld=None):
        self.out = out                  # _Fetch of [steps + 1, B] tokens (row 0 the input carry)
        self.snapshot = snapshot        # list[(slot_index, Sequence)]
        self.steps = steps
        # speculative verify dispatch: out fetches (tokens [B, T],
        # n_emit [B]); pos0/draft_lens are the positions and draft
        # lengths the build used (the rewind at sync needs them)
        self.spec = spec
        self.pos0 = pos0
        self.draft_lens = draft_lens
        # pipelined mixed step: out fetches its sampled tokens (or (out,
        # n_emit) with spec rows); bld is the host build, landed by
        # _sync_mixed
        self.mixed = mixed
        self.bld = bld


class TorchEngine:
    """Paged continuous-batching engine on one device.

    Conforms to the pipeline engine protocol: `await generate(Context) ->
    AsyncIterator[dict]` streaming EngineOutput dicts (token ids; the
    detokenizing backend sits downstream).
    """

    def __init__(self, config: EngineConfig, params=None, device=None):
        self.config = config
        self.model_cfg = config.model_config()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchEngine runs on a CUDA device and none is available; "
                    "pass device='cpu' to run the plain PyTorch versions"
                )
            device = "cuda"
        self.device = torch.device(device)
        self._dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        if self.device.type == "cuda":
            self._check_kernel_shapes()

        if params is None:
            if config.checkpoint_dir:
                from dynamo_tpu_torch.models.weights import load_params

                params = load_params(
                    config.checkpoint_dir, self.model_cfg, dtype=self._dtype,
                    device=self.device,
                )
                if config.quantization:
                    # layer by layer: each dense layer is freed once its
                    # codes exist
                    params = quantize_params(params, self.model_cfg,
                                             mode=config.quantization, inplace=True)
            else:
                # quantized as each layer is made: the device never holds
                # the whole dense tree
                params = llama.init_params(
                    self.model_cfg, config.seed, dtype=self._dtype, device=self.device,
                    quantize=bool(config.quantization),
                )
        else:
            if config.quantization and not any(
                    is_quantized(lp.get("wq")) for lp in params["layers"]):
                raise ValueError(
                    "quantization set but caller-provided params are unquantized — "
                    "pass ops.quant.quantize_params output")

            def to_dev(w):
                if is_quantized(w):
                    return {"q": w["q"].to(self.device), "s": w["s"].to(self.device)}
                return w.to(self.device)

            params = {
                k: (
                    [{n: to_dev(w) for n, w in lp.items()} for lp in v]
                    if k == "layers" else to_dev(v)
                )
                for k, v in params.items()
            }
        self.params = params
        # logical model size: int8 codes count like their dense originals;
        # scales and a tied model's int8 head are bookkeeping
        self.param_count = logical_param_count(params, self.model_cfg)
        if self.device.type == "cuda" and config.quantization:
            # hand the dense layers' freed blocks back to the device, where
            # the KV auto-sizer's free-memory read sees them
            torch.cuda.empty_cache()

        # int4 scale groups per kv head (head_dim // kv_quant_group), 0 on
        # the other tiers; the KV auto-sizer counts their scales and the
        # device-path transfer compares them
        hd = self.model_cfg.head_dim
        self._kv_int4_groups = (
            hd // (config.kv_quant_group or hd) if config.kv_quantization == "int4" else 0)
        self.page_size = config.page_size
        self.num_pages = config.num_pages or self._auto_num_pages()
        self.kv = llama.init_kv_cache(
            self.model_cfg, self.num_pages * self.page_size, dtype=self._dtype,
            device=self.device, kv_quant=config.kv_quantization, page_size=self.page_size,
            kv_quant_group=config.kv_quant_group if self._kv_int4_groups else None,
        )
        # KV events (stored/removed) feed the KV-aware router
        self._event_seq = 0
        self._event_subscribers: list = []
        # finish summaries (subscribe_requests) feed EngineMetrics/SloTracker
        self._request_observers: list = []
        self.allocator = PageAllocator(
            self.num_pages, self.page_size, on_event=self._emit_event,
            on_cached=self._on_page_cached if config.host_kv_pages else None,
        )
        # the page-custody ledger (engine/kv_ledger.py): every allocator
        # transition stamped, holdings attributed per request and plane, and
        # a periodic loop audit (`kv_audit_s`) running the orphan detector;
        # a violation arms the flight recorder's kv_leak trigger
        self.kv_ledger = kvledgermod.KvLedger(
            allocator=self.allocator, on_leak=self._on_kv_leak)
        self.allocator.ledger = self.kv_ledger
        # the HBM -> host offload tier (engine/offload.py); None when off.
        # `offload_paused` parks it (no new copies are queued or started)
        self.host_pool: Optional[HostKvPool] = None
        self.offload_paused = False
        # sequence hash -> (local hash, parent hash) of cached pages waiting
        # for their copy, oldest first; at most one batch in flight
        self._pending_offload: dict[int, tuple[int, Optional[int]]] = {}
        self._offload_task: Optional[asyncio.Task] = None
        self._offload_stream = None  # the side stream of a CUDA engine's copies
        # the restore gate: EMAs of the measured restore rate (bytes/s,
        # host to pool) and of the prefill rate requests see (tokens/s,
        # admission to first token); a host hit restores only while moving
        # its pages beats recomputing them (unknown rates restore)
        self._ema_restore_bps: Optional[float] = None
        self._ema_prefill_tps: Optional[float] = None
        self.offload_gate_stats = {"restored": 0, "declined": 0, "failed": 0}
        self._bg_tasks: set = set()  # strong refs to the calibration fences
        if config.host_kv_pages:
            m = self.model_cfg
            kw = m.num_kv_heads * m.head_dim
            kv_quant = config.kv_quantization
            self.host_pool = HostKvPool(
                config.host_kv_pages, m.num_layers, self.page_size,
                kw // 2 if kv_quant == "int4" else kw,  # int4 rows: two codes a byte
                dtype=torch.int8 if kv_quant else self._dtype,
                on_event=self._emit_event,
                scale_width=self._kv_scale_channels() if kv_quant else None,
                pin_memory=self.device.type == "cuda",
            )
            self.host_pool.ledger = self.kv_ledger
            self.kv_ledger.host_pool = self.host_pool
        self._inv_freq = torch.from_numpy(rope_inv_freq(self.model_cfg)).to(self.device)

        self.waiting: deque[Sequence] = deque()
        self.slots: list[Optional[Sequence]] = [None] * config.max_batch_size
        self._prefilling: deque[Sequence] = deque()
        self._inflight: Optional[_Dispatch] = None
        # slot -> first-token carry override: (device token vector, row)
        # from a prefill dispatch, or a host int (a sync's newest token)
        self._overrides: dict[int, object] = {}
        # _carry_ok[slot]: the device carry row holds the slot's CURRENT
        # input token (set when a decode dispatch or a mixed step's carry
        # scatter will leave it there) — the step pipeline's license to
        # build the next window from the device carry while host history
        # is stale. Cleared when an override supersedes the carry and on
        # preemption and finish (the slot may be reused).
        self._carry_ok = np.zeros(config.max_batch_size, bool)
        b, w, dev = config.max_batch_size, config.max_pages_per_seq, self.device
        # the device carry: each slot's next input token; row B is the dump
        # row a mixed step scatters its prefill and padding rows into
        self._carry = torch.zeros(b + 1, dtype=torch.int32, device=dev)
        # beside it, the carry token's logprob and top-N alternatives: row 0
        # of a dispatch that reports them (a prefill's first token rides in
        # through the same override as its token)
        self._carry_lps = torch.zeros(b + 1, dtype=torch.float32, device=dev)
        self._carry_tid = torch.zeros((b + 1, TOP_LOGPROBS_MAX), dtype=torch.int32, device=dev)
        self._carry_tlp = torch.zeros((b + 1, TOP_LOGPROBS_MAX), dtype=torch.float32, device=dev)
        # token occurrence counts for the penalties, [B, V] int8, allocated
        # at first use (_ensure_counts)
        self._counts: Optional[torch.Tensor] = None
        # the decode dispatch's one fused upload, [positions, active]
        self._pos_act = torch.zeros((b, 2), dtype=torch.int32, device=dev)
        # device-resident slow-changing inputs: block tables and sampling
        # params (samp_f = [temperature, top_p, frequency_penalty,
        # presence_penalty, repetition_penalty], samp_i = [top_k, seed]),
        # updated from the host mirrors only for the slots marked dirty
        # (admit and page growth); rows of released slots keep garbage
        # (inactive rows are masked and write nothing)
        self._host_tables = np.zeros((b, w), np.int32)
        self._host_samp_f = np.zeros((b, 5), np.float32)
        self._host_samp_f[:, 1] = 1.0
        self._host_samp_f[:, 4] = 1.0
        self._host_samp_i = np.zeros((b, 2), np.int32)
        self._host_samp_i[:, 1] = -1
        self._dev_tables = torch.zeros((b, w), dtype=torch.int32, device=dev)
        self._dev_samp_f = torch.from_numpy(self._host_samp_f.copy()).to(dev)
        self._dev_samp_i = torch.from_numpy(self._host_samp_i.copy()).to(dev)
        self._dirty_slots: set[int] = set()
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed ^ 0x5EED)
        self._graphs = DecodeGraphs(self._decode_step, self.device, self._gen)
        # set once a request carries a deadline: until then no tick reads
        # the clock for the deadline sweeps
        self._has_deadlines = False
        # engine-side phase accounting: host walls of the dispatch calls
        # (with the step pipeline, enqueue time) and of the fetches that
        # land them (`*_sync_s`, or `pipeline_overlap_s` for a fetch that
        # waited while another dispatch was already queued on the device)
        self._phase_stats = {
            "prefill_dispatch_s": 0.0,
            "prefill_tokens": 0,
            "prefill_dispatches": 0,
            "decode_dispatch_s": 0.0,
            "decode_sync_s": 0.0,
            "decode_tokens": 0,
            "decode_dispatches": 0,
            "preemptions": 0,
            # the step pipeline: fetches overlapped with a queued dispatch
            # and their host wait; ticks a serialized engine parked a
            # worthwhile mixed step behind an in-flight dispatch; decode
            # rows a mixed step read from the device carry, and carry rows
            # that shed their drafts (stale host history)
            "pipeline_overlapped": 0,
            "pipeline_overlap_s": 0.0,
            "mixed_holds": 0,
            "mixed_carry_rows": 0,
            "mixed_spec_shed": 0,
            # mixed prefill+decode steps: dispatches, decode rows carried,
            # prefill tokens carried, the largest step's budget tokens
            # (decode rows count 1 + drafts) and its verify rows
            "mixed_dispatch_s": 0.0,
            "mixed_sync_s": 0.0,
            "mixed_steps": 0,
            "mixed_decode_rows": 0,
            "mixed_prefill_tokens": 0,
            "mixed_step_tokens_max": 0,
            "mixed_spec_rows": 0,
            # speculative verify: standalone dispatches, and rows, drafted,
            # accepted and emitted tokens over standalone and mixed verify
            "spec_dispatch_s": 0.0,
            "spec_sync_s": 0.0,
            "spec_dispatches": 0,
            "spec_rows": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "spec_emitted": 0,
            # requests shed past their deadline before admission (at
            # generate or from the queue), and running ones finished by it
            "deadline_shed": 0,
            "deadline_timeouts": 0,
            # prefix cache at admission: hits, hits that recompute at most
            # the last page, tokens reused from HBM and restored from the
            # host tier, and tail tokens still computed
            "prefix_hits": 0,
            "prefix_full_hits": 0,
            "prefix_reused_tokens": 0,
            "prefix_restored_tokens": 0,
            "prefix_tail_tokens": 0,
            # the host tier: pages copied out and restored, and the time of
            # their copies (on a CUDA device between events around them, so
            # work queued before them is not counted; on the CPU the wall),
            # as the restore gate measures it
            "offload_pages": 0,
            "offload_copy_s": 0.0,
            "restore_pages": 0,
            "restore_s": 0.0,
            # 1 once a failed mixed dispatch tripped the permanent degrade
            # to the normal paths; watchdog firings
            "mixed_disabled": 0,
            "watchdog_fired": 0,
        }
        # dispatches made (mixed, decode and verify): the step number of
        # the flight recorder's digests and the profiler's step marker
        self._step_count = 0

        # ---- the robustness and observability planes -------------------
        faults.load_env()  # arm DYN_FAULTS points (a no-op when unset)
        self.worker_label = instance.worker_id()
        tracing.set_process_default(f"worker-{self.worker_label}")
        # the degrade ladder (engine/degrade.py): ordered feature shedding
        # with re-probe recovery. A trip also forgets the restore gate's
        # rates, which were measured on the configuration before it. A
        # failed mixed step trips `mixed` for good (mixed_disabled)
        self._degrade = DegradeLadder(
            reprobe_s=config.degrade_reprobe_s, on_trip=self._reset_offload_ema)
        # the flight recorder: per-step digests sampled at the sites that
        # feed _phase_stats; triggers dump a correlated, rate-limited
        # artifact
        self.flight = flightmod.FlightRecorder(
            context_fn=self._flight_context, directory=config.crash_dir,
        ) if config.flight_recorder else None
        # KV ledger audit cadence: kv_audit_s, else DYN_KV_AUDIT_S, default
        # 5 s; 0 disables. It runs at the top of a loop tick, off the
        # dispatch path
        audit_s = config.kv_audit_s
        if audit_s is None:
            try:
                audit_s = float(os.environ.get("DYN_KV_AUDIT_S", "") or 5.0)
            except ValueError:
                audit_s = 5.0
        self._kv_audit_s = float(audit_s)
        self._kv_audit_next = 0.0
        # the watchdog: in-flight host ops (dispatch enqueues and result
        # fetches) as {token: (label, t_start)}; the monitor task trips the
        # ladder and dumps a crash artifact when one stalls past
        # _watchdog_s. Written from the CPU engine's worker threads too
        # (a dict item set or pop is atomic under the GIL)
        self._watchdog_s = float(config.watchdog_dispatch_s or 0.0)
        self._ops: dict[int, tuple[str, float]] = {}
        self._op_ids = itertools.count(1)
        self._watch_fired: set[int] = set()
        self._watchdog_task: Optional[asyncio.Task] = None
        self.last_crash_artifact: Optional[str] = None

    def _check_kernel_shapes(self) -> None:
        """Refuse at construction what the CUDA kernels do not take, rather
        than failing the first request. The int8 and int4 kernels (K5-K7)
        take the shapes their bf16 counterparts (K1-K3) take: bf16
        activations, these head dims and GQA groups, any page size (K7
        copies a scale tile that is not whole 16-byte vectors in 4-byte
        words)."""
        from dynamo_tpu_torch.ops import decode_attention

        m = self.model_cfg
        if self._dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels take bfloat16, not {self.config.dtype}")
        if m.head_dim not in decode_attention.HEAD_DIMS:
            raise ValueError(
                f"head_dim {m.head_dim} not in {decode_attention.HEAD_DIMS} (CUDA kernels)"
            )
        if m.num_heads // m.num_kv_heads > decode_attention.MAX_GROUP:
            raise ValueError(
                f"{m.num_heads // m.num_kv_heads} query heads per kv head: the CUDA "
                f"decode kernel takes at most {decode_attention.MAX_GROUP}"
            )
        if self.config.quantization:
            # the W8A8 kernels' K: hidden (wq/wk/wv, w_gate/w_up, the
            # head), q_size (wo) and a dense FFN's intermediate (w_down;
            # MoE experts stay bf16)
            ks = [("hidden_size", m.hidden_size), ("q_size", m.q_size)]
            if not m.num_experts:
                ks.append(("intermediate_size", m.intermediate_size))
            for name, k in ks:
                if k % 32:
                    raise ValueError(
                        f"{name} {k}: the W8A8 kernels take K a multiple of 32")

    def _kv_scale_channels(self) -> int:
        """Scale channels a token and layer (S): K on the int8 tier, K *
        groups on the int4 tier, K (unused) otherwise."""
        kh = self.model_cfg.num_kv_heads
        return kh * self._kv_int4_groups if self._kv_int4_groups else kh

    def _auto_num_pages(self) -> int:
        cfg, m = self.config, self.model_cfg
        if cfg.kv_quantization == "int8":
            # 1-byte K and V rows plus one f32 K and V scale per kv head
            token_bytes = 2 * m.num_kv_heads * (m.head_dim + 4)
        elif cfg.kv_quantization == "int4":
            # two codes a byte, plus an f32 K and V scale per channel
            token_bytes = 2 * (m.num_kv_heads * m.head_dim // 2 + 4 * self._kv_scale_channels())
        else:
            token_bytes = (2 * m.num_kv_heads * m.head_dim
                           * torch.empty((), dtype=self._dtype).element_size())
        page_bytes = m.num_layers * cfg.page_size * token_bytes
        fallback = cfg.max_batch_size * cfg.max_pages_per_seq + 17
        if self.device.type != "cuda":
            return fallback
        free, _total = torch.cuda.mem_get_info(self.device)
        if m.num_experts:
            # the weights are resident already; what an MoE step adds is its
            # experts' buffers at the largest step: [E, C] rows of the
            # dispatched input and the output (D wide), gate, up and their
            # product (F wide)
            rows = m.num_experts * expert_capacity(
                m, max(cfg.prefill_group_tokens, cfg.mixed_step_tokens))
            itemsize = torch.empty((), dtype=self._dtype).element_size()
            free -= rows * (2 * m.hidden_size + 3 * m.intermediate_size) * itemsize
        n = int(free * cfg.hbm_utilization // page_bytes)
        return max(n, 2) if n > 0 else fallback

    @property
    def phase_stats(self) -> dict:
        return dict(self._phase_stats)

    def subscribe_events(self, cb) -> None:
        """KV cache events (`stored`/`removed`, each with `event_id` and
        `block_size`) for the KV-aware router."""
        self._event_subscribers.append(cb)

    def subscribe_requests(self, cb) -> None:
        """Per-request finish summaries: {request_id, finish_reason,
        prompt_tokens, tokens, tenant, prefix, queue_wait_s, ttft_s,
        itl_s}, fired once a sequence finishes (`_finish`)."""
        self._request_observers.append(cb)

    # the reference's `metrics()` keys whose plane the port does not have
    # yet: the tp executor attribution (M13). Every other key is served
    # with the reference's meaning, but `compile_events`/`compile_time_s`
    # count decode graph captures and kernel builds (engine/telemetry.py).
    UNPORTED_METRICS = frozenset({"tp_overlap_dispatches", "gspmd_fallback_dispatches"})

    def dump_trace(self, path: str) -> int:
        """Write the process trace ring (utils/tracing.py) as
        Chrome/Perfetto trace-event JSON; returns the event count.
        Recording must be armed (DYN_TRACE=1 or tracing.enable()) for the
        engine's step timeline and request spans to be present."""
        return tracing.dump(path)

    def metrics(self) -> dict:
        """ForwardPassMetrics equivalent (the reference's `metrics()`, less
        `UNPORTED_METRICS`): slots, queue, KV pool and prefix-cache gauges,
        the custody ledger's counts, the host tier's pages and the restore
        gate's decisions, the compile events, the step walls' device/stall
        split, the spec, mixed, pipeline and deadline counters, the degrade
        ladder, the watchdog, the injected faults and the flight recorder.
        On a CUDA device also the memory gauges (`hbm_*`, from the caching
        allocator's statistics); on the CPU they are absent, as the
        reference's are on a backend without memory statistics."""
        active = sum(1 for s in self.slots if s is not None)
        usable = self.num_pages - 1
        ps = self._phase_stats
        alloc = self.allocator
        device_s = (ps["prefill_dispatch_s"] + ps["decode_dispatch_s"]
                    + ps["spec_dispatch_s"] + ps["mixed_dispatch_s"])
        stall_s = ps["decode_sync_s"] + ps["spec_sync_s"] + ps["mixed_sync_s"]
        return {
            "request_active_slots": active,
            "request_total_slots": len(self.slots),
            "kv_active_blocks": int(round(alloc.usage() * usable)),
            "kv_total_blocks": usable,
            "num_requests_waiting": len(self.waiting),
            "gpu_cache_usage_perc": alloc.usage(),
            "prefix_cache_hit_rate": alloc.hit_rate(),
            "prefix_hits": ps["prefix_hits"],
            "prefix_full_hits": ps["prefix_full_hits"],
            "prefix_reused_tokens": ps["prefix_reused_tokens"],
            "prefix_restored_tokens": ps["prefix_restored_tokens"],
            "prefix_tail_tokens": ps["prefix_tail_tokens"],
            "kv_pages_used": alloc.pages_used,
            "kv_pages_cached": alloc.pages_cached,
            "kv_pages_free": alloc.pages_free,
            "kv_pages_peak_used": alloc.peak_used,
            "kv_fragmentation": round(alloc.fragmentation(), 4),
            "kv_ledger_violations": self.kv_ledger.violations_total,
            "kv_ledger_orphan_pages": len(self.kv_ledger.last_orphans),
            "kv_ledger_audits": self.kv_ledger.audits_total,
            "kv_ledger_inflight": len(self.kv_ledger._inflight),
            "slot_occupancy": round(active / len(self.slots), 4) if self.slots else 0.0,
            "offload_host_pages": len(self.host_pool) if self.host_pool is not None else 0,
            "offload_restored": self.offload_gate_stats["restored"],
            "offload_declined": self.offload_gate_stats["declined"],
            "offload_restore_failed": self.offload_gate_stats["failed"],
            **telemetry.compile_stats(),
            **telemetry.device_memory_stats(self.device),
            "step_device_s": round(device_s, 4),
            "step_stall_s": round(stall_s, 4),
            "spec_acceptance_rate": (
                ps["spec_accepted"] / ps["spec_drafted"] if ps["spec_drafted"] else 0.0),
            "spec_tokens_per_step": (
                ps["spec_emitted"] / ps["spec_rows"] if ps["spec_rows"] else 0.0),
            "mixed_steps": ps["mixed_steps"],
            "mixed_decode_rows": ps["mixed_decode_rows"],
            "mixed_prefill_tokens": ps["mixed_prefill_tokens"],
            "mixed_spec_rows": ps["mixed_spec_rows"],
            "mixed_disabled": 1 if self._degrade.tripped("mixed") else 0,
            "pipeline_overlapped": ps["pipeline_overlapped"],
            "pipeline_overlap_s": round(ps["pipeline_overlap_s"], 4),
            "mixed_carry_rows": ps["mixed_carry_rows"],
            **self._degrade.state(),
            "degrades_total": self._degrade.degrades_total,
            "recoveries_total": self._degrade.recoveries_total,
            "watchdog_fired": ps["watchdog_fired"],
            "deadline_shed": ps["deadline_shed"],
            "deadline_timeouts": ps["deadline_timeouts"],
            "faults_injected": faults.fired_total() if faults.active() else 0,
            "flight_digests": self.flight.count if self.flight is not None else 0,
            "flight_dumps": self.flight.dumps_total if self.flight is not None else 0,
            "flight_suppressed": (
                self.flight.suppressed_total if self.flight is not None else 0),
            "step_anomalies": self.flight.anomalies_total if self.flight is not None else 0,
        }

    def _emit_event(self, event: dict) -> None:
        event = {**event, "event_id": self._event_seq, "block_size": self.page_size}
        self._event_seq += 1
        for cb in self._event_subscribers:
            try:
                cb(event)
            except Exception:
                log.exception("kv event subscriber failed")

    # the profiler's phase annotation of each dispatch op, named like its
    # engine.steps span
    _OP_PHASES = {"prefill.dispatch": "prefill", "decode.dispatch": "decode",
                  "spec.dispatch": "spec_verify", "mixed.dispatch": "mixed"}

    def _launch(self, fn, *args, op: str, point: str) -> asyncio.Future:
        """Start a dispatch. On a CUDA device the launches are
        asynchronous already, so `fn` runs inline and the future is done
        (with `fn`'s result or its exception); on the CPU the plain versions
        compute synchronously, so `fn` runs in a worker thread (as the
        reference runs its dispatches) and the loop keeps landing other work
        meanwhile. A dispatch reads only its build and the device state,
        which nothing else touches while it runs.

        The dispatch is the watchdog's op `op` from before its fault point
        `point` (utils/faults.py) until `fn` returns, so an injected delay
        reads as a stalled enqueue. With a fault armed, a CUDA dispatch
        runs as a task behind the point's asynchronous check: a delay
        sleeps without blocking the loop, which runs the watchdog. While a
        profiler capture runs, `fn` runs inside the phase's annotations
        (engine/profiler.py)."""
        wd = self._op_begin(op)
        if self.device.type == "cuda":
            if faults.active():
                return asyncio.ensure_future(self._launch_faulted(wd, op, point, fn, args))
            fut = asyncio.get_running_loop().create_future()
            try:
                fut.set_result(self._annotated(op, fn, args))
            except Exception as exc:  # noqa: BLE001 (raised where it is awaited)
                fut.set_exception(exc)
            finally:
                self._op_end(wd)
            return fut

        def run():
            try:
                faults.fire(point)
                return self._annotated(op, fn, args)
            finally:
                self._op_end(wd)

        return asyncio.ensure_future(asyncio.to_thread(run))

    async def _launch_faulted(self, wd, op: str, point: str, fn, args):
        try:
            await faults.afire(point)
            return self._annotated(op, fn, args)
        finally:
            self._op_end(wd)

    def _annotated(self, op: str, fn, args):
        with profiler.step_annotation(self._step_count), \
                profiler.annotate(self._OP_PHASES[op]):
            return fn(*args)

    # ---- the robustness plane: feature gates, watchdog, forensics -------

    def _pipe_on(self) -> bool:
        """The step pipeline's effective flag: the config and the degrade
        ladder. One predicate for every read site, so a watchdog trip
        serializes all of them at once."""
        return self.config.step_pipeline and not self._degrade.disabled("step_pipeline")

    def _spec_on(self) -> bool:
        return self.config.spec_decode and not self._degrade.disabled("spec")

    def _decode_steps(self) -> int:
        """Steps a decode dispatch runs: `decode_steps`, or one while the
        ladder's last rung (`decode_scan`) is shed. A decode graph's key
        carries its step count, so the rung captures one-step graphs and a
        re-probe returns to the graphs captured before it."""
        return 1 if self._degrade.disabled("decode_scan") else self.config.decode_steps

    def _op_begin(self, label: str) -> Optional[int]:
        """Register a host op the device gates (a dispatch enqueue or a
        result fetch) with the watchdog; returns a token for `_op_end`.
        None when the watchdog is off (no steady-state cost)."""
        if not self._watchdog_s:
            return None
        tok = next(self._op_ids)
        self._ops[tok] = (label, time.perf_counter())
        return tok

    def _op_end(self, tok: Optional[int]) -> None:
        if tok is not None:
            self._ops.pop(tok, None)

    def _ensure_watchdog(self) -> None:
        if self._watchdog_s <= 0:
            return
        if self._watchdog_task is None or self._watchdog_task.done():
            self._watchdog_task = asyncio.get_running_loop().create_task(
                self._watchdog_loop())

    async def _watchdog_loop(self) -> None:
        """Monitor task: notice a dispatch or fetch stalled past
        `watchdog_dispatch_s`, dump a crash artifact and walk the degrade
        ladder. The stalled op cannot be killed (a kernel that never ends
        shows as a stalled `sync.fetch`); the job here is to make the stall
        visible and to shed the most speculative machinery, so the next
        dispatch takes the conservative path."""
        interval = min(max(self._watchdog_s / 4.0, 0.05), 1.0)
        try:
            while not self._closed:
                await asyncio.sleep(interval)
                if not self._ops:
                    self._watch_fired.clear()
                    continue
                now = time.perf_counter()
                for tok, (label, t0) in list(self._ops.items()):
                    stalled = now - t0
                    if stalled <= self._watchdog_s or tok in self._watch_fired:
                        continue
                    self._watch_fired.add(tok)
                    self._watchdog_fire(label, stalled)
                self._watch_fired.intersection_update(self._ops)
        except asyncio.CancelledError:
            return

    def _watchdog_fire(self, label: str, stalled_s: float) -> None:
        self._phase_stats["watchdog_fired"] += 1
        reason = f"watchdog: {label} stalled {stalled_s:.2f}s"
        rung = self._degrade.trip_next(reason)
        path = self._dump_crash_artifact(label, stalled_s, rung)
        log.error(
            "engine watchdog fired: %s has not completed after %.2fs (budget %.2fs); "
            "degrade rung tripped: %s; crash artifact: %s",
            label, stalled_s, self._watchdog_s, rung or "none left", path)
        if tracing.enabled():
            tracing.instant("watchdog.fire", cat="degrade", op=label,
                            stalled_s=round(stalled_s, 3), rung=rung or "")
        if self.flight is not None:
            self.flight.trigger(f"watchdog:{label}")

    def _dump_crash_artifact(self, label: str, stalled_s: float,
                             rung: Optional[str]) -> Optional[str]:
        """Write the trace ring, the digests, the phase stats and a metrics
        snapshot next to the stall, so the postmortem does not depend on
        the process surviving to serve /debug/trace. Best-effort."""
        try:
            artifact = {
                "op": label,
                "stalled_s": round(stalled_s, 3),
                "watchdog_dispatch_s": self._watchdog_s,
                "rung_tripped": rung,
                "degrade_state": self._degrade.state(),
                "phase_stats": self.phase_stats,
                "metrics": self.metrics(),
                "inflight_ops": [
                    {"op": lbl, "age_s": round(time.perf_counter() - t0, 3)}
                    for lbl, t0 in list(self._ops.values())
                ],
                "trace": tracing.export(),
            }
            if self.flight is not None:
                artifact["digest_fields"] = list(flightmod.FIELDS)
                artifact["digests"] = self.flight.snapshot_rows()
        except Exception:  # noqa: BLE001 (the dump is best-effort)
            log.exception("watchdog crash-artifact dump failed")
            return None
        path = artifacts.write_crash_artifact(
            "engine_watchdog", artifact, directory=self.config.crash_dir)
        if path is not None:
            self.last_crash_artifact = path
        return path

    def _flight_context(self) -> dict:
        """Engine snapshot embedded in every flight-recorder artifact:
        metrics, phase stats, in-flight ops and the custody ledger."""
        ops = []
        for _ in range(4):
            try:
                ops = list(self._ops.values())
                break
            except RuntimeError:  # resized by a worker thread mid-copy
                continue
        return {
            "metrics": self.metrics(),
            "phase_stats": self.phase_stats,
            "degrade": self._degrade.state(),
            "waiting": len(self.waiting),
            "inflight_ops": [
                {"op": lbl, "age_s": round(time.perf_counter() - t0, 3)} for lbl, t0 in ops
            ],
            "kv_ledger": self.kv_ledger.snapshot(),
        }

    def _flight_record(self, kind: str, wall_s: float, rows: int = 0, tokens: int = 0,
                       budget: int = 0) -> None:
        """One step digest into the flight recorder, from the sites that
        feed _phase_stats (host walls only: nothing here waits for the
        device). Never takes down the dispatch it observes."""
        fr = self.flight
        if fr is None:
            return
        try:
            fr.record(
                kind, wall_s, rows=rows, tokens=tokens,
                budget_fill=round(tokens / budget, 4) if budget else 0.0,
                queue_depth=len(self.waiting),
                slots_active=sum(1 for s in self.slots if s is not None),
                kv_frac=round(self.allocator.usage(), 4),
                degrade_mask=self._degrade.mask(),
                step=self._step_count,
            )
        except Exception:  # noqa: BLE001 (forensics must not break serving)
            log.exception("flight-recorder digest failed")

    # ---- the KV custody ledger (engine/kv_ledger.py) -------------------

    def _kv_hold(self, page_ids: list[int], owner: str, tenant: str = "") -> None:
        if page_ids:
            self.kv_ledger.hold(page_ids, owner, tenant=tenant)

    def _kv_drop(self, page_ids: list[int], owner: str) -> None:
        if page_ids:
            self.kv_ledger.drop(page_ids, owner)

    def _run_kv_audit(self) -> None:
        """One ledger audit pass; forensics must never break serving."""
        try:
            violations = self.kv_ledger.audit()
        except Exception:  # noqa: BLE001
            log.debug("kv ledger audit failed", exc_info=True)
            return
        if violations and self.flight is not None:
            # one artifact an audit: the flight context carries the whole
            # ledger snapshot, and the cooldown makes a storm one dump
            v = violations[0]
            owner = v.owner if v.owner and not v.owner.startswith("sys:") else None
            try:
                self.flight.trigger(f"kv_leak:{v.kind}", request_id=owner)
            except Exception:  # noqa: BLE001
                log.debug("kv_leak flight trigger failed", exc_info=True)

    def _on_kv_leak(self, violation) -> None:
        """Ledger hook for violations raised outside an audit pass (the
        allocator's release misuse, at the call site); audit violations
        arm the trigger in _run_kv_audit."""
        if self.flight is None or violation.kind not in ("double_release", "unknown_page"):
            return
        try:
            self.flight.trigger(f"kv_leak:{violation.kind}")
        except Exception:  # noqa: BLE001
            log.debug("kv_leak flight trigger failed", exc_info=True)

    def _up(self, arr: np.ndarray, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A host array on the device (into `out` when given). On a CUDA
        device it goes through pinned memory without blocking the host: a
        copy from pageable memory may wait for the stream's queued work."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
            if out is None:
                return t.to(self.device, non_blocking=True)
            return out.copy_(t, non_blocking=True)
        return t if out is None else out.copy_(t)

    # ------------------------------------------------------------------
    # requests

    async def generate(self, request: Context,
                       _preloaded: Optional[tuple] = None) -> AsyncIterator[dict]:
        if self._closed:
            raise RuntimeError("engine is closed")
        payload = request.payload
        pre = (
            PreprocessedRequest.from_dict(payload)
            if isinstance(payload, dict) else payload
        )
        self._refuse_unported(pre, remote=_preloaded is not None)
        if len(pre.token_ids) == 0:
            raise ValueError("empty prompt")
        self._check_embeds(pre)
        if len(pre.token_ids) >= self.config.max_model_len:
            raise ValueError(
                f"prompt of {len(pre.token_ids)} tokens exceeds "
                f"max_model_len={self.config.max_model_len}"
            )
        usable_tokens = (self.num_pages - 1) * self.page_size
        if len(pre.token_ids) + 1 > usable_tokens:
            raise ValueError(
                f"prompt of {len(pre.token_ids)} tokens cannot fit the KV pool "
                f"({self.num_pages - 1} pages x {self.page_size} tokens)"
            )
        seq = Sequence.from_request(
            request, pre, self.page_size, self.config.max_model_len,
            blocks=self._blocks_from_metadata(request, pre),
        )
        seq.t_submit = time.perf_counter()
        if tracing.enabled():
            tracing.instant("seq.submit", cat="lifecycle", req=request.id, ts=seq.t_submit,
                            seq_id=seq.seq_id, prompt_tokens=seq.prompt_len)
        self._take_embeds(seq)
        seq.preloaded = _preloaded
        if not seq.deadline and self.config.request_timeout_s > 0:
            seq.deadline = time.time() + self.config.request_timeout_s
        if seq.deadline:
            self._has_deadlines = True
            if seq.past_deadline():
                # shed before any device work: the caller stopped waiting
                self._phase_stats["deadline_shed"] += 1
                raise DeadlineExceededError(
                    "request deadline expired before admission "
                    f"(deadline={seq.deadline:.3f})"
                )
        self.waiting.append(seq)
        self._ensure_loop()
        self._wake.set()

        async def _gen() -> AsyncIterator[dict]:
            while True:
                item = await seq.out_queue.get()
                yield item
                if item.get("finish_reason"):
                    return

        return _gen()

    def _blocks_from_metadata(self, request: Context, pre):
        """The block-hash chain the KV router computed to score workers,
        carried in Context metadata (`kv_block_size`, `kv_seq_hashes`,
        `kv_local_hashes`): it saves hashing the prompt again. Ignored
        unless the block size is this engine's page size and the chain
        covers exactly the prompt's full pages; `Sequence.from_request`'s
        mismatch guard stays the backstop."""
        md = request.metadata
        if md.get("kv_block_size") != self.page_size:
            return None
        sh, lh = md.get("kv_seq_hashes"), md.get("kv_local_hashes")
        if not sh or not lh:
            return None
        try:
            return TokenBlockSequence.with_hashes(pre.token_ids, self.page_size, sh, lh)
        except (TypeError, ValueError):
            return None

    @staticmethod
    def _refuse_unported(pre: PreprocessedRequest, remote: bool = False) -> None:
        """Refuse what the port does not serve yet: a request asking
        `generate` for disaggregated routing, which the disagg plane
        decides (llm/disagg, waiting for the runtime of M17);
        `generate_remote` (`remote`) takes the plane's requests with their
        extras. Prompt embeddings are served (`_check_embeds`). `n > 1`
        reaches the engine as one stream per choice, each with `n` kept as
        the request set it, as in the reference."""
        if pre.disagg and not remote:
            raise NotImplementedError(
                "request asks for disagg: not ported to dynamo_tpu_torch yet "
                "(see ROADMAP.md)"
            )

    def _check_embeds(self, pre: PreprocessedRequest) -> None:
        """Refuse a prompt-embeds span that does not fit, before any device
        work, with the reference's errors: a silently dropped or misaligned
        span would give plausible but image-blind output."""
        if pre.prompt_embeds is None:
            return
        n_emb = len(pre.prompt_embeds)
        off = pre.embeds_offset
        if n_emb == 0:
            raise ValueError("prompt_embeds is empty")
        if off < 0 or off + n_emb > len(pre.token_ids):
            raise ValueError(
                f"embed span [{off}, {off + n_emb}) outside the "
                f"{len(pre.token_ids)}-token prompt"
            )
        width = len(pre.prompt_embeds[0])
        if width != self.model_cfg.hidden_size:
            raise ValueError(
                f"prompt_embeds width {width} != model hidden size "
                f"{self.model_cfg.hidden_size}"
            )

    def _take_embeds(self, seq: Sequence) -> None:
        """Hold a sequence's prompt embeds on this engine's device in the
        model dtype, rounded once from f32, as the reference's prefill
        buffer rounds them: once, so that every chunk (and a re-prefill
        after a preemption) that overlaps the span copies device rows."""
        if seq.prompt_embeds is not None:
            seq.prompt_embeds = seq.prompt_embeds.to(self.device).to(self._dtype)

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._loop())
        self._ensure_watchdog()

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self.flight is not None:
            # freeze the final context and drop the bound provider: the
            # recorder registry keeps the ring dumpable after close without
            # holding this engine's pools
            self.flight.seal_context()
        if self._watchdog_task is not None and not self._watchdog_task.done():
            self._watchdog_task.cancel()
            try:
                await self._watchdog_task
            except asyncio.CancelledError:
                pass
        if self._loop_task:
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
        if self._offload_task is not None and not self._offload_task.done():
            # its finally returns the buffers and the page pins
            self._offload_task.cancel()
            try:
                await self._offload_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        for seq in list(self.waiting) + [s for s in self.slots if s]:
            if seq.first_task is not None and not seq.first_task.done():
                seq.first_task.cancel()
            seq.out_queue.put_nowait(
                EngineOutput.final(FINISH_REASON_CANCELLED).to_dict()
            )

    # ------------------------------------------------------------------
    # main loop

    async def _loop(self) -> None:
        # the loop task inherits the contextvars of whichever request
        # created it: unbind the request id, so loop logs and spans never
        # join against that request
        tracing.set_request(None)
        try:
            while not self._closed:
                # the custody audit, off the dispatch path (gated on its
                # period: a steady tick pays one clock read)
                if self._kv_audit_s > 0:
                    now = time.monotonic()
                    if now >= self._kv_audit_next:
                        self._kv_audit_next = now + self._kv_audit_s
                        self._run_kv_audit()
                # offload first: queued write-through copies pin their pages
                # before this tick's admission can evict them
                self._maybe_start_offload()
                # queue members past their deadline leave before they can
                # claim a slot or pages
                progressed = self._shed_expired_waiting()
                progressed |= self._admit_new()
                # stall-free mixed step first: when it runs, the normal
                # prefill and decode ticks stand down this tick. With the
                # step pipeline the mixed step launches behind the
                # in-flight dispatch and stays in flight ("pipelined");
                # serialized engines "hold" a tick while one is in flight
                mixed = None
                if self.config.mixed_batching:
                    mixed = await self._mixed_tick()
                    progressed |= mixed in (True, "pipelined")
                if mixed is None:
                    progressed |= await self._prefill_tick()
                # a step_pipeline trip with a dispatch in flight lands it
                # here before the next build: serialized from this tick on
                pipe = self._pipe_on()
                if not pipe and mixed != "pipelined":
                    # serialized: the old dispatch lands BEFORE the next
                    # one is built
                    old, self._inflight = self._inflight, None
                    if old is not None:
                        await self._sync_dispatch(old)
                        progressed = True
                new = None
                bld = self._maybe_dispatch_decode() if mixed is None else None
                if bld == "sync_first":
                    # worthwhile spec drafts behind an in-flight dispatch:
                    # sync it now and build again, so the verify window
                    # dispatches this tick instead of after a dead one
                    old, self._inflight = self._inflight, None
                    if old is not None:
                        await self._sync_dispatch(old)
                        progressed = True
                    bld = self._maybe_dispatch_decode()
                    if bld == "sync_first":  # nothing left in flight
                        bld = None
                if bld is not None:
                    new = self._launch(
                        self._run_decode_dispatch, bld,
                        op="spec.dispatch" if bld["spec"] else "decode.dispatch",
                        point="engine.dispatch")
                    progressed = True
                if pipe and mixed != "pipelined":
                    # pipelined: N+1 is queued on the device; land N while
                    # it runs
                    old, self._inflight = self._inflight, None
                    if old is not None:
                        await self._sync_dispatch(old, overlapped=new is not None)
                        progressed = True
                if new is not None:
                    self._inflight = await new
                if progressed:
                    await asyncio.sleep(0)
                    continue
                self._wake.clear()
                if self._closed:
                    return
                if self._inflight is not None:
                    continue  # the next tick lands it
                if self._kv_audit_s > 0:
                    # idle must not stall the custody audit: a request that
                    # leaked pages at _finish has no successor to wake the
                    # loop, so the sleep ends at the next audit
                    try:
                        await asyncio.wait_for(
                            self._wake.wait(),
                            timeout=max(self._kv_audit_next - time.monotonic(), 0.001))
                    except asyncio.TimeoutError:
                        pass
                else:
                    await self._wake.wait()
        except Exception as exc:
            log.exception("engine loop crashed; failing all requests")
            if self.flight is not None:
                # the black box of the crash: digests, trace and ledger
                self.flight.trigger(f"manual:loop_crash:{type(exc).__name__}", force=True)
            for seq in list(self.waiting) + [s for s in self.slots if s]:
                seq.out_queue.put_nowait(EngineOutput.final(FINISH_REASON_ERROR).to_dict())
            self.waiting.clear()
            self.slots = [None] * len(self.slots)
            self._prefilling.clear()
            self._inflight = None
            raise

    # ---- deadlines ----------------------------------------------------

    def _shed_expired_waiting(self) -> bool:
        """Finish queued requests whose deadline has passed, before they
        touch the device: a zero-token "timeout" finish."""
        if not self._has_deadlines or not self.waiting:
            return False
        now = time.time()
        expired = [s for s in self.waiting if s.past_deadline(now)]
        for seq in expired:
            self.waiting.remove(seq)
            self._phase_stats["deadline_shed"] += 1
            if tracing.enabled():
                tracing.instant(
                    "seq.deadline_shed", cat="lifecycle", req=seq.ctx.id,
                    queued_s=(round(time.perf_counter() - seq.t_submit, 3)
                              if seq.t_submit else 0))
            seq.out_queue.put_nowait(EngineOutput.final(FINISH_REASON_TIMEOUT).to_dict())
        if expired and self.flight is not None:
            # a shed burst (not one straggler) is a forensic trigger
            self.flight.note_shed(len(expired))
        return bool(expired)

    def _sweep_expired(self, seq: Sequence, now: float) -> bool:
        """Finish an admitted sequence whose deadline has passed."""
        if not seq.past_deadline(now):
            return False
        self._phase_stats["deadline_timeouts"] += 1
        if tracing.enabled():
            tracing.instant("seq.deadline_timeout", cat="lifecycle", req=seq.ctx.id,
                            generated=seq.generated)
        self._finish(seq, FINISH_REASON_TIMEOUT)
        return True

    # ---- admission ----------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit_new(self) -> bool:
        """Assign waiting sequences to free slots + pages; prefill compute
        happens chunk by chunk in _prefill_tick."""
        progressed = False
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                break
            idx = (
                pick_admission_index(self.waiting)
                if self.config.priority_scheduling and len(self.waiting) > 1
                else 0
            )
            seq = self.waiting[idx]
            if seq.ctx.is_stopped() or seq.max_new_tokens <= 0:
                del self.waiting[idx]
                reason = (
                    FINISH_REASON_CANCELLED if seq.ctx.is_stopped()
                    else FINISH_REASON_LENGTH
                )
                seq.out_queue.put_nowait(EngineOutput.final(reason).to_dict())
                progressed = True
                continue
            if not self._reserve_pages(seq):
                break  # out of pages; wait for something to finish
            del self.waiting[idx]
            seq.slot = slot
            seq.prefilling = True
            seq.t_admit = time.perf_counter()
            if tracing.enabled():
                tracing.instant("seq.admit", cat="lifecycle", req=seq.ctx.id, ts=seq.t_admit,
                                slot=slot, prefix_cached_tokens=seq.num_cached)
            seq.first_meta = {
                "prefix_cached_tokens": seq.num_cached,
                "prompt_tokens": seq.prompt_len,
            }
            self.slots[slot] = seq
            self._mark_slot_state(seq)
            if self.config.spec_decode and seq.spec is None:
                # seed the n-gram index with the prompt once; it survives
                # preemption (the history it covers does not change)
                seq.spec = NgramProposer(
                    self.config.spec_ngram_max, self.config.spec_index_window)
                seq.spec.extend(seq.tokens)
            if seq.has_penalties:
                self._count_prompt(seq)
            self._prefilling.append(seq)
            progressed = True
        return progressed

    def _ensure_counts(self) -> torch.Tensor:
        if self._counts is None:
            with torch.inference_mode():
                self._counts = torch.zeros(
                    (self.config.max_batch_size, self.model_cfg.vocab_size),
                    dtype=torch.int8, device=self.device)
        return self._counts

    @torch.inference_mode()
    def _count_prompt(self, seq: Sequence) -> None:
        """Reset the slot's count row and count the sequence's tokens, so
        penalties see "the text so far": the prompt, and after a
        preemption what was generated too (token id 0 is not counted). On
        the device it queues behind every dispatch already launched, so an
        earlier tenant's in-flight bumps land before the reset."""
        counts = self._ensure_counts()
        counts[seq.slot].zero_()
        count_tokens(counts, seq.slot, self._up(np.asarray(seq.tokens, np.int32)))

    def _reserve_pages(self, seq: Sequence) -> bool:
        """Match the longest cached prefix of the sequence's full pages in
        HBM, then its continuation in the host tier, and allocate fresh
        pages for the rest of its current tokens; the host run is restored
        into the first fresh pages, unless the restore gate declines or the
        restore fails (then those pages recompute, counted). At least one
        token is always computed (a query position must sample the next
        token): when every page is cached the last match is given back
        (a host page first) and recomputed into a fresh page, so no write
        lands in a page other sequences share. On a miss the matches are
        released."""
        try:
            # an injected failure here reads as an exhausted pool: the
            # caller sees the False the allocator returns out of pages
            faults.fire("engine.reserve")
        except faults.FaultError:
            return False
        ps = self.page_size
        t = seq.total_tokens
        # this reservation's ledger: a preemption-resume must not carry an
        # earlier attempt's decline
        seq.blocks_declined = 0
        seq.gate_reason = ""
        hashes = seq.blocks.sequence_hashes()
        cap = seq.cacheable_pages(ps)
        if cap is not None:
            hashes = hashes[:cap]
        matched = self.allocator.match_prefix(hashes)
        host_run: list[int] = []
        if self.host_pool is not None and hashes:
            host_run = self.host_pool.match_prefix(hashes[len(matched):])
        while (len(matched) + len(host_run)) * ps >= t:
            if host_run:
                host_run.pop()
            else:
                self.allocator.release([matched[-1]])
                matched = matched[:-1]
        need = -(-t // ps) - len(matched)
        fresh = self.allocator.allocate(need) if need else []
        if fresh is None:
            self.allocator.release(matched)
            return False
        if host_run and not self._restore_worthwhile(len(host_run)):
            # the tier must never make TTFT worse: the pages stay on the
            # host for a cheaper future hit
            self.offload_gate_stats["declined"] += 1
            seq.blocks_declined = len(host_run)
            seq.gate_reason = "restore_slower_than_recompute"
            if tracing.enabled():
                tracing.instant("offload.gate", cat="kv", req=seq.ctx.id, decision="declined",
                                blocks=len(host_run), reason=seq.gate_reason)
            host_run = []
        if host_run:
            try:
                self._restore_from_host(seq, fresh[:len(host_run)], len(matched))
            except Exception:
                # a restore is an optimization: recompute, counted as the
                # reference counts it
                log.exception("host-tier restore failed; recomputing")
                self.offload_gate_stats["failed"] += 1
                seq.blocks_declined = len(host_run)
                seq.gate_reason = "restore_failed"
                if tracing.enabled():
                    tracing.instant("offload.gate", cat="kv", req=seq.ctx.id,
                                    decision="failed", blocks=len(host_run),
                                    reason=seq.gate_reason)
                host_run = []
        cached = len(matched) + len(host_run)
        seq.page_ids = matched + fresh
        self._kv_hold(seq.page_ids, seq.ctx.id, tenant=seq.tenant)
        seq.num_cached = cached * ps
        seq.num_computed = seq.num_cached
        seq.registered_pages = cached
        seq.blocks_reused = len(matched)
        seq.blocks_restored = len(host_run)
        if host_run and tracing.enabled():
            tracing.instant("offload.gate", cat="kv", req=seq.ctx.id, decision="restored",
                            blocks=len(host_run))
        if cached:
            tail = t - seq.num_cached
            st = self._phase_stats
            st["prefix_hits"] += 1
            # "full": the cache covered every page but the last
            st["prefix_full_hits"] += tail <= ps
            st["prefix_reused_tokens"] += len(matched) * ps
            st["prefix_restored_tokens"] += len(host_run) * ps
            st["prefix_tail_tokens"] += tail
            if tracing.enabled():
                # one event a hit on the engine.prefix track, so a slow warm
                # serve is attributable in the trace
                tracing.instant(
                    "prefix.hit", cat="kv", req=seq.ctx.id, track="engine.prefix",
                    reused_blocks=len(matched), restored_blocks=len(host_run),
                    tail_tokens=tail, full=tail <= ps)
        return True

    def _mark_slot_state(self, seq: Sequence) -> None:
        """Refresh a slot's device-resident rows (block table and sampling
        params) in the host mirrors and mark the slot dirty: on admit and
        on page growth, the only times a live slot's slow-changing inputs
        change."""
        i = seq.slot
        row = self._host_tables[i]
        row[:] = 0
        n = min(len(seq.page_ids), row.shape[0])
        row[:n] = seq.page_ids[:n]
        self._host_samp_f[i] = (seq.temperature, seq.top_p, seq.frequency_penalty,
                                seq.presence_penalty, seq.repetition_penalty)
        self._host_samp_i[i] = (seq.top_k, seq.seed)
        self._dirty_slots.add(i)

    def _snap_dirty(self):
        """The dirty slots' host rows, snapshotted at a dispatch's build
        (None when nothing changed: steady decode then uploads nothing
        slow-changing)."""
        if not self._dirty_slots:
            return None
        idx = np.asarray(sorted(self._dirty_slots), np.int64)
        self._dirty_slots.clear()
        return (idx, self._host_tables[idx].copy(), self._host_samp_f[idx].copy(),
                self._host_samp_i[idx].copy())

    def _flush_dev_state(self, snap) -> None:
        """Scatter a dirty snapshot into the device-resident rows."""
        if snap is None:
            return
        idx, tb, sf, si = snap
        rows = self._up(idx)
        self._dev_tables.index_copy_(0, rows, self._up(tb))
        self._dev_samp_f.index_copy_(0, rows, self._up(sf))
        self._dev_samp_i.index_copy_(0, rows, self._up(si))

    # ---- prefill ------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.config.prefill_buckets():
            if n <= b:
                return b
        return self.config.prefill_chunk

    async def _prefill_tick(self) -> bool:
        """Dispatch up to `prefill_group_tokens` worth of prefill chunks,
        same-bucket chunks batched into one [n, bucket] model step; one
        group dispatch per bucket per tick, so decode interleaves between
        waves."""
        if not self._prefilling:
            return False
        win = self.config.prefill_batch_window_s
        if win > 0 and len(self._prefilling) < self.config.prefill_batch_min_rows:
            # the batching window for paced arrivals: while decode runs,
            # fresh first chunks wait (up to `win` from the oldest one's
            # admission) so trickling arrivals share one dispatch. A
            # prefix hit's first chunk is fresh too; continuations and
            # remote prefills never wait
            now = time.perf_counter()
            fresh = all(s.num_computed == s.num_cached and s.preloaded is None
                        for s in self._prefilling)
            oldest = min(s.t_admit for s in self._prefilling)
            if fresh and self._any_mid_decode() and now - oldest < win:
                asyncio.get_running_loop().call_later(
                    max(win - (now - oldest), 0.001), self._wake.set)
                return False
        progressed = False
        groups: dict[int, list[Sequence]] = {}

        def padded_cost() -> int:
            return sum(_pow2(len(seqs)) * bucket for bucket, seqs in groups.items())

        budget = self.config.prefill_group_tokens
        for _ in range(len(self._prefilling)):
            seq = self._prefilling.popleft()
            if seq.ctx.is_stopped():
                self._finish(seq, FINISH_REASON_CANCELLED)
                progressed = True
                continue
            if self._has_deadlines and self._sweep_expired(seq, time.time()):
                progressed = True  # expired mid-prefill: no more chunks
                continue
            if seq.preloaded is not None:
                # remotely prefilled: land the next chunk of its wire
                progressed = True
                try:
                    tok = self._inject_chunk(seq)
                except Exception:
                    # a malformed wire fails this request, not the loop
                    log.exception("KV injection of seq %s failed", seq.seq_id)
                    self._finish(seq, FINISH_REASON_ERROR)
                    continue
                if tok is None:
                    self._prefilling.append(seq)
                else:
                    self._mark_decode_ready(seq, ([tok], None, None, None), 0, False)
                    seq.preloaded = None
                continue
            chunk = min(seq.total_tokens - seq.num_computed, self.config.prefill_chunk)
            bucket = self._bucket_for(chunk)
            groups.setdefault(bucket, []).append(seq)
            if padded_cost() > budget:
                groups[bucket].pop()
                if not groups[bucket]:
                    del groups[bucket]
                if groups:
                    self._prefilling.appendleft(seq)  # next tick, same order
                    break
                groups[bucket] = [seq]  # one chunk over budget still runs
                break
        pipe = self._pipe_on()
        for bucket, seqs in groups.items():
            progressed = True
            try:
                res = await self._launch(self._prefill_group_dispatch, seqs, bucket, not pipe,
                                         op="prefill.dispatch", point="engine.prefill")
            except Exception as exc:
                if _cuda.sticky(exc):
                    raise  # a poisoned context serves nothing more
                # contain the failure to the offending request(s): each
                # sequence again in a dispatch of its own, at its own bucket
                log.exception("prefill group of %d seqs failed; retrying singly", len(seqs))
                for seq in seqs:
                    b1 = self._bucket_for(
                        min(seq.total_tokens - seq.num_computed, self.config.prefill_chunk))
                    try:
                        res1 = await self._launch(
                            self._prefill_group_dispatch, [seq], b1, not pipe,
                            op="prefill.dispatch", point="engine.prefill")
                    except Exception as exc1:
                        if _cuda.sticky(exc1):
                            raise
                        log.exception("prefill of seq %s failed", seq.seq_id)
                        self._finish(seq, FINISH_REASON_ERROR)
                        continue
                    self._land_prefill([seq], b1, res1, pipe)
                continue
            self._land_prefill(seqs, bucket, res, pipe)
        await asyncio.sleep(0)
        return progressed

    def _land_prefill(self, seqs: list[Sequence], bucket: int, res, pipe: bool) -> None:
        """Advance the sequences of a landed prefill dispatch: a final
        chunk turns its sequence decode-ready (with the pipeline the sampled
        token stays on the device as the slot's carry override and one fetch
        per group emits it early; serialized engines emit it here), others
        go back to the prefill queue."""
        finals = []
        for j, seq in enumerate(seqs):
            seq.num_computed += min(seq.total_tokens - seq.num_computed, bucket)
            self._register_full_pages(seq)
            if seq.num_computed >= seq.total_tokens:
                self._mark_decode_ready(seq, res, j, pipe)
                if pipe:
                    finals.append((seq, j))
            else:
                self._prefilling.append(seq)
        if finals:
            self._start_first_emit(finals, res)

    def _any_mid_decode(self) -> bool:
        """Is decode running? A live dispatch is in flight, or a stream has
        emitted past its first token (the gap between a sync and the next
        build). A wave's members at their first token do not count alone."""
        if self._inflight_live():
            return True
        return any(s is not None and not s.prefilling and s.generated > 1
                   for s in self.slots)

    def _inflight_live(self) -> bool:
        """Does the in-flight dispatch carry a row whose sequence still holds
        its slot? False for the step pipeline's overshoot dispatch, queued
        behind a wave's last sync after every stream it carries finished."""
        d = self._inflight
        if d is None:
            return False
        if d.mixed:
            return any(self.slots[slot] is seq for _, slot, seq, _ in d.bld["entries"])
        return any(self.slots[i] is s for i, s in d.snapshot)

    @torch.inference_mode()
    def _prefill_group_dispatch(self, seqs: list[Sequence], bucket: int, fetch: bool):
        """One chunk for each sequence in ONE [n, bucket] model step (n
        padded to a power of two; padding rows write the trash page and
        attend nothing). Returns (tokens [n], logprobs [n], top ids [n, 8],
        top logprobs [n, 8]), valid for rows whose chunk was final, the
        last three None unless a row asked for them: numpy arrays when
        `fetch`, else device tensors.

        When any row has penalties or a seed, the group samples on the
        extended path: each row reads its slot's count row, seeded rows
        draw at the position of the chunk's last token, and each final
        row's sample is counted into its slot's row."""
        ps = self.page_size
        n = _pow2(len(seqs))
        tok_arr = np.zeros((n, bucket), np.int32)
        pos_arr = np.zeros((n, bucket), np.int32)
        last_idx = np.zeros(n, np.int64)
        t_valid = np.zeros(n, np.int32)
        temp = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int32)
        topp = np.ones(n, np.float32)
        pen = np.zeros((n, 3), np.float32)
        pen[:, 2] = 1.0
        seeds = np.full(n, -1, np.int32)
        slot_rows = np.zeros(n, np.int64)
        last_pos = np.zeros(n, np.int32)
        finals = []  # rows whose chunk is final: their sample is counted
        wtables = np.zeros((n, -(-bucket // ps)), np.int32)
        # multimodal: only a chunk that overlaps some sequence's embed span
        # pays for the [n, bucket, D] rows and the mask
        spans = [s.embeds_overlap(s.num_computed, min(s.total_tokens - s.num_computed, bucket))
                 for s in seqs]
        emb = emb_mask = None
        if any(spans):
            emb = torch.zeros((n, bucket, self.model_cfg.hidden_size), dtype=self._dtype,
                              device=self.device)
            emb_mask = np.zeros((n, bucket), bool)
        # attention table width: pages actually attended this chunk,
        # bucketed to a power of two
        w_need = max(
            -(-(s.num_computed + min(s.total_tokens - s.num_computed, bucket)) // ps)
            for s in seqs
        )
        w_b = min(_pow2(w_need), self.config.max_pages_per_seq)
        btables = np.zeros((n, w_b), np.int32)
        for j, seq in enumerate(seqs):
            tokens = seq.tokens
            start = seq.num_computed
            chunk = min(len(tokens) - start, bucket)
            tok_arr[j, :chunk] = tokens[start:start + chunk]
            pos_arr[j, :chunk] = np.arange(start, start + chunk)
            pages = np.asarray(seq.page_ids, np.int32)
            # chunk starts are page-aligned (prefill_chunk % page_size == 0)
            n_used = -(-chunk // ps)
            wtables[j, :n_used] = pages[start // ps:start // ps + n_used]
            npg = min(len(pages), w_b)
            btables[j, :npg] = pages[:npg]
            if spans[j]:
                lo, hi = spans[j]
                e0 = seq.embeds_offset
                emb[j, lo - start:hi - start] = seq.prompt_embeds[lo - e0:hi - e0]
                emb_mask[j, lo - start:hi - start] = True
            last_idx[j] = chunk - 1
            t_valid[j] = chunk
            temp[j] = seq.temperature
            topk[j] = seq.top_k
            topp[j] = seq.top_p
            pen[j] = (seq.frequency_penalty, seq.presence_penalty, seq.repetition_penalty)
            seeds[j] = seq.seed
            slot_rows[j] = seq.slot
            last_pos[j] = start + chunk - 1
            if start + chunk >= len(tokens):
                finals.append(j)
        use_ext = any(s.has_penalties or s.seed >= 0 for s in seqs)
        want_lps = any(s.want_logprobs for s in seqs)
        want_tops = any(s.top_logprobs > 0 for s in seqs)
        t0 = time.perf_counter()
        dev = self.device
        pos_t = self._up(pos_arr)
        attn = llama.AttnSpec.page_write(
            self._up(wtables.reshape(-1)), self._up(btables), pos_t[:, 0].contiguous(),
            self._up(t_valid), ps,
        )
        hidden, _ = llama.forward(
            self.params, self.model_cfg, self._up(tok_arr), pos_t,
            self.kv, attn, inv_freq=self._inv_freq, embeds=emb,
            embeds_mask=None if emb_mask is None else self._up(emb_mask),
        )
        last_h = hidden[torch.arange(n, device=dev), self._up(last_idx)]
        lg = llama.logits(self.params, self.model_cfg, last_h)
        ext = {}
        if use_ext:
            counts = self._ensure_counts()
            pen_t = self._up(pen)
            ext = dict(counts=counts[self._up(slot_rows)], freq_pen=pen_t[:, 0],
                       pres_pen=pen_t[:, 1], rep_pen=pen_t[:, 2], seeds=self._up(seeds),
                       positions=self._up(last_pos))
        res = sample_tokens(
            lg, self._gen, self._up(temp), self._up(topk), self._up(topp),
            all_greedy=bool((temp <= 0.0).all()), return_logprobs=want_lps,
            top_n=TOP_LOGPROBS_MAX if want_tops else 0, **ext,
        )
        res = list(res) if want_lps else [res]
        res += [None] * (4 - len(res))
        if use_ext and finals:
            # final rows hold distinct slots: one scatter, no collisions
            rows = self._up(np.asarray(finals, np.int64))
            sl = self._up(slot_rows[finals])
            toks = res[0].index_select(0, rows).long()
            cur = counts[sl, toks].to(torch.int32)
            counts[sl, toks] = torch.clamp(cur + 1, max=127).to(torch.int8)
        if fetch:
            # the dispatch's one device->host sync
            res = [None if t is None else t.cpu().numpy() for t in res]
        now = time.perf_counter()
        n_tok = int(t_valid.sum())
        st = self._phase_stats
        st["prefill_dispatch_s"] += now - t0
        st["prefill_dispatches"] += 1
        st["prefill_tokens"] += n_tok
        self._flight_record("prefill", now - t0, rows=len(seqs), tokens=n_tok)
        if tracing.enabled():
            # the step timeline, at the site that feeds _phase_stats
            tracing.complete("prefill", t0, now, cat="step", track="engine.steps",
                             rows=len(seqs), tokens=n_tok, bucket=bucket)
            for j in finals:
                tracing.instant("seq.first_dispatch", cat="lifecycle", req=seqs[j].ctx.id,
                                ts=now)
        return res

    @staticmethod
    def _lp_tops(seq: Sequence, lps, tid, tlp, at) -> tuple:
        """(logprob, top alternatives) of one emitted token at index `at`
        of host outputs, as `_append_token` takes them; (None, None) for a
        sequence that did not ask."""
        if not seq.want_logprobs or lps is None:
            return None, None
        tops = None
        if tid is not None and seq.top_logprobs:
            tops = [[int(tid[at][j]), float(tlp[at][j])] for j in range(seq.top_logprobs)]
        return float(lps[at]), tops

    def _mark_decode_ready(self, seq: Sequence, res, row: int, pipe: bool) -> None:
        """A final prefill chunk landed: the slot decodes from here. With
        the pipeline the sampled token (and its logprob and tops) stays on
        the device as the slot's carry override, (device outputs, row),
        until a fetch emits it; serialized engines emit it now from the
        host outputs and feed it to the next dispatch as a host int."""
        seq.prefilling = False
        seq.device_pos = seq.num_computed
        # the override supersedes whatever the carry row holds (a previous
        # tenant's token): nothing reads that row until a dispatch re-arms it
        self._carry_ok[seq.slot] = False
        seq.carry_pending = pipe
        if pipe:
            self._overrides[seq.slot] = (res, row)
            return
        tok = int(res[0][row])
        self._overrides[seq.slot] = tok
        self._append_token(seq, tok, *self._lp_tops(seq, *res[1:], row))

    def _start_first_emit(self, finals, res) -> None:
        """One asynchronous fetch per prefill group that emits the group's
        first tokens as soon as the copy lands, instead of parking them
        until the next decode dispatch syncs (whose row 0 would carry
        them). The reference starts it only while no decode stream runs,
        since on its device each fetch is a host round trip that
        serializes against the decode syncs; here it is one small copy
        behind an event, so every group starts one and a wave that
        arrives mid-decode does not wait a whole decode dispatch for its
        first tokens."""
        task = asyncio.get_running_loop().create_task(
            self._emit_first_group(finals, _Fetch(res)))
        for seq, _ in finals:
            seq.first_task = task

    async def _emit_first_group(self, finals, fetch: _Fetch) -> None:
        toks, lps, tid, tlp = await fetch.get()
        me = asyncio.current_task()
        for seq, row in finals:
            if (
                seq.first_task is not me  # preempted and re-prefilled since
                or not seq.carry_pending
                or seq.slot < 0
                or self.slots[seq.slot] is not seq
            ):
                continue  # finished or preempted meanwhile
            seq.carry_pending = False
            seq.num_computed = seq.total_tokens
            self._append_token(seq, int(toks[row]), *self._lp_tops(seq, lps, tid, tlp, row))

    # ---- mixed prefill+decode steps (stall-free batching) -------------

    def _mixed_eligible_decode(self) -> Optional[list]:
        """Decode-ready rows a mixed step can carry (after the cancellation
        and deadline sweep), or None when the whole batch must take the
        normal paths this tick: a row on the extended sampler (penalties,
        seed, logprobs) needs the decode dispatch's, and a row whose first
        token is still on the device with no fetch in flight can only be
        emitted by a decode sync. A row whose fetch is in flight sits this
        step out."""
        rows = []
        for i, s in self._decode_ready_rows():
            if s.needs_ext_sampling:
                return None
            if s.carry_pending:
                if s.first_task is not None and not s.first_task.done():
                    continue
                return None
            rows.append((i, s))
        return rows

    def _select_mixed_prefill(self, leftover: int) -> list:
        """Strict FIFO prefix of the prefill queue fitting `leftover` budget
        tokens, as (seq, chunk) picks; a non-final chunk rounds down to a
        page multiple (the next chunk must start page-aligned). Scanning
        stops at the first sequence that cannot join: skipping it would
        let later arrivals jump the queue. A sequence on the extended
        sampler cannot: its final chunk must sample on the prefill
        dispatch's extended path, nor one whose KV arrives remotely (the
        normal tick injects it), nor one with prompt embeds (the normal
        dispatch injects them), as in the reference."""
        picks = []
        for seq in self._prefilling:
            if leftover < 1 or seq.ctx.is_stopped():
                break  # the normal tick's sweep owns cancellation
            if (seq.needs_ext_sampling or seq.preloaded is not None
                    or seq.prompt_embeds is not None):
                break
            need = seq.total_tokens - seq.num_computed
            chunk = min(need, self.config.prefill_chunk, leftover)
            if chunk < need:
                chunk -= chunk % self.page_size
            if chunk < 1:
                break
            picks.append((seq, chunk))
            leftover -= chunk
        return picks

    async def _mixed_tick(self):
        """One stall-free mixed step when decode-ready rows and pending
        prefill chunks coexist: both advance in one token-budgeted step, so
        an admission wave never parks running streams for longer than one
        step. Decode rows cost 1 budget token each (1 + k with drafts) and
        prefill chunks shrink into the leftover.

        With the step pipeline the step launches BEHIND the in-flight
        dispatch: rows that advanced deterministically in it (a decode
        loop, or a previous mixed step's q_len 1 rows) join at q_len 1
        reading their input token from the device carry (`_carry_ok` is
        the license), and shed their drafts (drafting needs synced host
        history); rows whose in-flight advance depends on the data (verify
        windows) sit the step out. The old dispatch lands while the new
        one runs, and the new step stays in flight.

        Returns True (a serialized step ran and landed), "pipelined" (a
        step was dispatched and left in flight), "hold" (serialized
        engines: worthwhile, but the in-flight dispatch must land first),
        or None (the normal paths run). A step that fails with an exception
        on the host (an injected fault, a launch error that leaves the CUDA
        context usable) is contained (`_mixed_dispatch_failed`): its rows'
        host state rolls back, its chunks re-queue, and the `mixed` rung
        trips for good, so the normal paths serve on. A sticky CUDA error
        (`ops/_cuda.sticky`) poisons the context: it raises, and the loop's
        crash path dumps the flight artifact and fails the requests."""
        if self._closed or self._degrade.disabled("mixed") or not self._prefilling:
            return None
        cfg = self.config
        pipeline = self._pipe_on()
        # classify the in-flight dispatch's rows: deterministic advances
        # can ride the device carry, data-dependent ones wait for the sync
        stale_det: dict[int, Sequence] = {}
        blocked: set[int] = set()
        infl = self._inflight
        if infl is not None and pipeline:
            if infl.spec:
                blocked = {i for i, _ in infl.snapshot}
            elif infl.mixed:
                for kind, slot, seq, chunk in infl.bld["entries"]:
                    if kind != "dec":
                        continue
                    if chunk == 1 and self._carry_ok[slot]:
                        stale_det[slot] = seq
                    else:
                        blocked.add(slot)
            else:
                # a decode loop: every row advances decode_steps and its
                # last sample is already bound for the device carry
                for i, s in infl.snapshot:
                    if self._carry_ok[i]:
                        stale_det[i] = s
                    else:
                        blocked.add(i)
        rows = self._mixed_eligible_decode()
        if rows and blocked and all(i in blocked for i, _ in rows):
            # every decode-ready row waits on an in-flight verify window:
            # land it now and build from fresh history, rather than leave
            # the chunks to a normal prefill dispatch that parks every
            # stream (the reference takes its normal paths here)
            old, self._inflight = self._inflight, None
            await self._sync_dispatch(old)
            rows, stale_det = self._mixed_eligible_decode(), {}
            if not rows:
                return True  # the sync itself made progress
        elif rows:
            rows = [(i, s) for i, s in rows if i not in blocked]
        if not rows:
            return None
        carry_rows = {i for i, s in rows if stale_det.get(i) is s}
        spec = self._spec_on() and cfg.mixed_spec
        if carry_rows and spec and any(
            s.spec is not None and s.spec.gate_open() for i, s in rows if i in carry_rows
        ):
            # a carry row whose acceptance gate is open would draft if its
            # host history were current: land the in-flight dispatch now
            # and build from fresh history (gated-off rows keep the overlap
            # and shed instead)
            old, self._inflight = self._inflight, None
            if old is not None:
                await self._sync_dispatch(old)
            rows = self._mixed_eligible_decode()
            if not rows:
                return True  # the sync itself made progress
            carry_rows = set()
        # spec x mixed: decode rows carry their n-gram drafts as verify
        # rows of q_len 1 + k; drafts trade off against the chunks. Carry
        # rows never draft: their host history is stale until the sync
        drafts: dict[int, list[int]] = {}
        shed = 0
        if spec:
            k_cap = min(cfg.spec_k_max, cfg.prefill_chunk - 1)
            for i, seq in rows:
                if i in carry_rows:
                    if seq.spec is not None:
                        shed += 1
                        # tick the probe countdown as a gated maybe_draft
                        # would, so a shed row's gate can reopen
                        seq.spec.shed_tick()
                    continue
                d = seq.spec.maybe_draft(self._draft_room(seq, k_cap))
                if d:
                    drafts[i] = d
        budget = cfg.mixed_step_tokens
        dec_cost = sum(1 + len(drafts.get(i, ())) for i, _ in rows)

        def shed_drafts_to(room: int) -> int:
            # drafts never abort the step: a decode row is always valid at
            # q_len 1, so shed drafts until both planes fit (a discarded
            # draft never strands a probe: only observe() re-arms it)
            cost = dec_cost
            while cost > room and drafts:
                _, d = drafts.popitem()
                cost -= len(d)
            return cost

        if cfg.mixed_decode_priority:
            # every decode row joins; prefill shrinks into what is left
            dec_cost = shed_drafts_to(budget - 1)
            leftover = budget - dec_cost
            if leftover < 1:
                return None  # the budget cannot fit both planes
            picks = self._select_mixed_prefill(leftover)
        else:
            # chunks keep their size; decode rows join only if all fit
            picks = self._select_mixed_prefill(budget)
            dec_cost = shed_drafts_to(budget - sum(c for _, c in picks))
            if budget - sum(c for _, c in picks) < dec_cost:
                return None
        if not picks:
            return None
        if self._inflight is not None and not pipeline:
            # serialized: host-built windows need synced token history, so
            # both planes park this tick (the stall the pipeline removes)
            self._phase_stats["mixed_holds"] += 1
            return "hold"
        # grow decode rows' pages through the positions this step writes;
        # growth may preempt (a participant too): re-filter both sides
        prep = self._grow_and_collect(
            rows, lambda seq: seq.device_pos + len(drafts.get(seq.slot, ())))
        if prep is None:
            return None
        rows = prep[0]
        picks = [(s, c) for s, c in picks if s.slot >= 0 and self.slots[s.slot] is s]
        if not picks:
            return None
        bld = self._build_mixed(rows, picks, drafts, carry_rows=carry_rows,
                                pipelined=pipeline)
        bld["n_shed"] = shed
        # the picked chunks leave the prefill queue while the step is in
        # flight; the sync re-appends non-final chunks
        for seq, _ in picks:
            self._prefilling.remove(seq)
        task = self._launch(self._run_mixed_dispatch, bld, op="mixed.dispatch",
                            point="engine.mixed")
        if pipeline:
            old, self._inflight = self._inflight, None
            if old is not None:
                # the old dispatch lands while the step queued behind it
                # runs (and before a failure of the step is handled, so the
                # rollback reads current host history)
                await self._sync_dispatch(old, overlapped=True)
            try:
                fetch = await task
            except Exception as exc:
                self._mixed_dispatch_failed(bld, exc)
                return None
            self._inflight = _Dispatch(fetch, [], 1, mixed=True, bld=bld)
            return "pipelined"
        try:
            fetch = await task
            t0 = time.perf_counter()
            wd = self._op_begin("sync.fetch")
            try:
                toks = await fetch.get()
            finally:
                self._op_end(wd)
        except Exception as exc:
            self._mixed_dispatch_failed(bld, exc)
            return None
        now = time.perf_counter()
        self._phase_stats["mixed_sync_s"] += now - t0
        self._flight_record("sync", now - t0, rows=len(bld["entries"]))
        if tracing.enabled():
            tracing.complete("mixed.sync", t0, now, cat="step", track="engine.sync",
                             rows=len(bld["entries"]))
        self._sync_mixed(bld, toks)
        return True

    def _mixed_dispatch_failed(self, bld: dict, exc: BaseException) -> None:
        """Contain a failed mixed step as the reference does: nothing of it
        landed on the host but the build's own bookkeeping, so pipelined
        q_len 1 rows un-advance, every decode row's carry override is
        re-armed from host truth (the in-flight dispatch before the step
        has landed, so `last_token` is current), the prefill picks return
        to the front of the queue in order, and mixed steps are disabled
        for good: retrying a failing dispatch family every tick would wedge
        the loop. Pages the step may have written before it failed are left
        to be overwritten by the retry, which writes the same positions.

        A sticky CUDA error poisons the context: nothing is retried on it.
        The flight artifact is dumped and the error raised, and the loop's
        crash path fails the requests."""
        if _cuda.sticky(exc):
            log.error("mixed step failed with a sticky CUDA error (%s): the CUDA context "
                      "is lost, nothing is retried on it", exc)
            raise exc
        log.error("mixed step of %d rows failed (%s: %s); disabling mixed batching "
                  "(normal prefill/decode paths take over)", len(bld["entries"]),
                  type(exc).__name__, exc)
        pf_restore = []
        for kind, slot, seq, chunk in bld["entries"]:
            if kind == "dec":
                if slot >= 0 and self.slots[slot] is seq:
                    if bld["pipelined"] and chunk == 1:
                        seq.device_pos -= 1
                    self._overrides[slot] = int(seq.last_token)
                    self._carry_ok[slot] = False
            elif (seq.slot >= 0 and self.slots[seq.slot] is seq
                  and seq not in self._prefilling):
                pf_restore.append(seq)
        for seq in reversed(pf_restore):
            self._prefilling.appendleft(seq)
        # permanent: a failed dispatch family must not re-probe (contrast
        # the watchdog's transient trips)
        self._degrade.trip("mixed", "mixed dispatch failed", permanent=True)
        self._phase_stats["mixed_disabled"] = 1

    def _draft_room(self, seq: Sequence, k_cap: int) -> int:
        """Drafts a row may take: never past its emit budget (a verify
        step emits at most drafts + 1 tokens) or the last writable
        position."""
        remaining = seq.max_new_tokens - seq.generated
        room = self.config.max_model_len - 1 - seq.device_pos
        return min(k_cap, remaining - 1, room)

    def _build_mixed(self, rows: list, picks: list, drafts: dict,
                     carry_rows=frozenset(), pipelined: bool = False) -> dict:
        """Host-side inputs of one mixed step: decode rows first (q_len 1,
        their last token, or a verify window [last, d_1..d_k] when spec
        composes), then one chunk per prefill pick. Rows pad to a power of
        two and columns to the chunk's prefill bucket; padding rows have
        q_len 0 and write the trash page, as do padding columns. Block
        tables are cut to the power-of-two bucket of the pages attended.

        Step-pipeline contract: `carry_rows` read their q_len 1 input from
        the device carry (their host token is a stale placeholder here),
        and every decode row's newest sample goes back into the carry.
        When `pipelined`, each q_len 1 decode row's `device_pos` advances
        now, as a decode loop's build does, so the next build can launch
        behind this step before it lands."""
        ps = self.page_size
        use_spec = bool(drafts)
        k_max = self.config.spec_k_max if use_spec else 0
        max_len = self.config.max_model_len
        n = _pow2(len(rows) + len(picks))
        t_b = self._bucket_for(max(max(c for _, c in picks), k_max + 1))
        tok_arr = np.zeros((n, t_b), np.int32)
        pos_arr = np.zeros((n, t_b), np.int32)
        wslots = np.zeros((n, t_b), np.int32)
        last_idx = np.zeros(n, np.int64)
        q_lens = np.zeros(n, np.int32)
        # [slot row, carry mask, decode mask] per row
        meta = np.zeros((n, 3), np.int64)
        temp = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int32)
        topp = np.ones(n, np.float32)
        draft_arr = np.zeros((n, k_max), np.int32)
        dlen_arr = np.zeros(n, np.int32)
        pos0 = np.zeros(n, np.int32)
        entries = []  # (kind, slot, seq, tokens) per built row
        w_need = 1
        n_carry = 0
        j = 0
        for slot, seq in rows:
            d = drafts.get(slot, [])
            kd = len(d)
            pages = np.asarray(seq.page_ids, np.int32)
            idx = seq.device_pos + np.arange(kd + 1)
            tok_arr[j, 0] = seq.last_token
            tok_arr[j, 1:kd + 1] = d
            draft_arr[j, :kd] = d
            dlen_arr[j] = kd
            pos_arr[j, :kd + 1] = idx
            pos0[j] = seq.device_pos
            # past-budget positions write the trash page
            wslots[j, :kd + 1] = np.where(
                idx < max_len, pages[np.minimum(idx, max_len - 1) // ps] * ps + idx % ps, 0)
            last_idx[j] = kd
            meta[j] = (slot, slot in carry_rows, 1)
            n_carry += slot in carry_rows
            # the step's carry scatter leaves this row's newest sample in
            # the device carry: the next pipelined build's license
            self._carry_ok[slot] = True
            if slot not in carry_rows:
                # the host-built window replaces any override (its token is
                # in host history already); a carry row's stale override
                # stays until the in-flight steps' syncs overwrite it
                self._overrides.pop(slot, None)
            if pipelined and kd == 0:
                seq.device_pos += 1  # the deterministic advance, at build
            w_need = max(w_need, (int(pos0[j]) + kd) // ps + 1)
            entries.append(("dec", slot, seq, 1 + kd))
            j += 1
        for seq, chunk in picks:
            start = seq.num_computed
            idx = np.arange(start, start + chunk)
            tok_arr[j, :chunk] = seq.tokens[start:start + chunk]
            pos_arr[j, :chunk] = idx
            pos0[j] = start
            pages = np.asarray(seq.page_ids, np.int32)
            wslots[j, :chunk] = pages[idx // ps] * ps + idx % ps
            last_idx[j] = chunk - 1
            meta[j] = (seq.slot, 0, 0)
            w_need = max(w_need, -(-(start + chunk) // ps))
            entries.append(("pf", seq.slot, seq, chunk))
            j += 1
        w_b = min(_pow2(w_need), self.config.max_pages_per_seq)
        tables = np.zeros((n, w_b), np.int32)
        for j, (_, _, seq, _) in enumerate(entries):
            npg = min(len(seq.page_ids), w_b)
            tables[j, :npg] = seq.page_ids[:npg]
            q_lens[j] = last_idx[j] + 1
            temp[j], topk[j], topp[j] = seq.temperature, seq.top_k, seq.top_p
        return dict(
            tokens=tok_arr, positions=pos_arr, wslots=wslots, tables=tables,
            last_idx=last_idx, q_lens=q_lens, meta=meta, temp=temp, topk=topk, topp=topp,
            spec=use_spec, draft=draft_arr, dlen=dlen_arr, pos0=pos0, entries=entries,
            all_greedy=bool(all(e[2].temperature <= 0.0 for e in entries)),
            pipelined=pipelined, n_carry=n_carry, n_shed=0,
        )

    @torch.inference_mode()
    def _run_mixed_dispatch(self, bld: dict) -> _Fetch:
        """Device half of a mixed step (`_mixed_model_step` of the
        reference): carry rows take their input token from the device
        carry, every row writes its KV through the row write, reads
        through K4 and samples at its last valid column, and each decode
        row's newest token goes back into the carry. Returns the fetch of
        the sampled tokens [n], or of (out [n, k+1], n_emit [n]) when
        verify rows composed in: each row's logits over a (k+1)-wide
        window ending at its last column go through `verify_draft_tokens`
        (prefill rows have no drafts, so window column 0 is their plain
        sample and n_emit 1)."""
        t0 = time.perf_counter()
        dev = self.device
        n = bld["tokens"].shape[0]
        tokens = self._up(bld["tokens"])
        positions = self._up(bld["positions"])
        last_idx = self._up(bld["last_idx"])
        meta = self._up(bld["meta"])
        slot_rows, carry_mask, dec_mask = meta[:, 0], meta[:, 1].bool(), meta[:, 2].bool()
        temp = self._up(bld["temp"])
        topk = self._up(bld["topk"])
        topp = self._up(bld["topp"])
        if bld["n_carry"]:
            tokens[:, 0] = torch.where(carry_mask, self._carry[slot_rows], tokens[:, 0])
        attn = llama.AttnSpec.ragged(
            self._up(bld["tables"]), positions[:, 0].contiguous(),
            self._up(bld["q_lens"]), self._up(bld["wslots"].reshape(-1)), self.page_size,
        )
        hidden, _ = llama.forward(self.params, self.model_cfg, tokens, positions,
                                  self.kv, attn, inv_freq=self._inv_freq)
        if bld["spec"]:
            dlen = self._up(bld["dlen"])
            win = bld["draft"].shape[1] + 1
            offs = torch.clamp(
                (last_idx - dlen)[:, None] + torch.arange(win, device=dev),
                max=hidden.shape[1] - 1)
            win_h = torch.gather(
                hidden, 1, offs[:, :, None].expand(-1, -1, hidden.shape[-1]))
            out, n_emit = verify_draft_tokens(
                llama.logits(self.params, self.model_cfg, win_h),
                self._up(bld["draft"]), dlen, self._gen, temp, topk,
                topp, all_greedy=bld["all_greedy"])
            newest = torch.gather(out, 1, torch.clamp(n_emit - 1, min=0)[:, None].long())[:, 0]
            res = [out, n_emit]
        else:
            last_h = hidden[torch.arange(n, device=dev), last_idx]
            newest = sample_tokens(
                llama.logits(self.params, self.model_cfg, last_h), self._gen, temp,
                topk, topp, all_greedy=bld["all_greedy"])
            res = [newest]
        # every decode row's newest token becomes its next device-side
        # input; prefill and padding rows land in the dump row
        dump = torch.full_like(slot_rows, len(self.slots))
        self._carry.index_copy_(0, torch.where(dec_mask, slot_rows, dump),
                                newest.to(torch.int32))
        fetch = _Fetch(res)
        self._step_count += 1
        t1 = time.perf_counter()
        self._phase_stats["mixed_dispatch_s"] += t1 - t0
        entries = bld["entries"]
        n_tok = sum(e[3] for e in entries)
        self._flight_record("mixed", t1 - t0, rows=len(entries), tokens=n_tok,
                            budget=self.config.mixed_step_tokens)
        if tracing.enabled():
            tracing.complete(
                "mixed", t0, t1, cat="step", track="engine.steps", rows=len(entries),
                decode_rows=sum(1 for e in entries if e[0] == "dec"), tokens=n_tok,
                spec=bld["spec"], pipelined=bld["pipelined"])
        return fetch

    def _sync_mixed(self, bld: dict, toks) -> None:
        """Land a mixed step: decode rows emit their next token (verify
        rows their accepted prefix plus one, rewinding like a standalone
        verify), final chunks their first token; non-final chunks go back
        to the end of the prefill queue. Each surviving row's newest token
        becomes its carry override, so a following decode dispatch starts
        from it."""
        spec_mode = bld["spec"]
        if spec_mode:
            out, n_emit = toks
        else:
            (toks,) = toks
        n_dec = n_dec_tokens = n_pf_tokens = 0
        spec_rows = drafted_total = accepted_total = emitted_total = 0
        for j, (kind, slot, seq, chunk) in enumerate(bld["entries"]):
            if kind == "dec":
                n_dec += 1
                n_dec_tokens += chunk
            else:
                n_pf_tokens += chunk
            if slot < 0 or seq.slot != slot or self.slots[slot] is not seq:
                continue  # finished or preempted while the step ran
            tok = int(out[j, 0]) if spec_mode else int(toks[j])
            if kind == "dec":
                if spec_mode:
                    drafted = int(bld["dlen"][j])
                    emitted, accepted = self._emit_verify_row(
                        slot, seq, out[j], int(n_emit[j]), drafted, int(bld["pos0"][j]),
                        keep_pos=bld["pipelined"] and drafted == 0)
                    spec_rows += 1
                    drafted_total += drafted
                    accepted_total += accepted
                    emitted_total += emitted
                    continue
                if not bld["pipelined"]:
                    # pipelined builds advanced device_pos already
                    seq.device_pos += 1
                seq.num_computed += 1
                self._register_full_pages(seq)
                self._append_token(seq, tok)
                if self.slots[slot] is seq:
                    self._overrides[slot] = tok
                continue
            seq.num_computed += chunk
            self._register_full_pages(seq)
            if seq in self._prefilling:
                self._prefilling.remove(seq)
            if seq.num_computed >= seq.total_tokens:
                # final chunk: the in-step sample is the first token
                seq.prefilling = False
                seq.device_pos = seq.num_computed
                self._append_token(seq, tok)
                if self.slots[slot] is seq:
                    self._overrides[slot] = tok
            else:
                self._prefilling.append(seq)
        st = self._phase_stats
        st["mixed_steps"] += 1
        st["mixed_decode_rows"] += n_dec
        st["mixed_prefill_tokens"] += n_pf_tokens
        st["mixed_step_tokens_max"] = max(
            st["mixed_step_tokens_max"], n_dec_tokens + n_pf_tokens)
        st["mixed_carry_rows"] += bld["n_carry"]
        st["mixed_spec_shed"] += bld["n_shed"]
        if spec_mode:
            st["mixed_spec_rows"] += spec_rows
            st["spec_rows"] += spec_rows
            st["spec_drafted"] += drafted_total
            st["spec_accepted"] += accepted_total
            st["spec_emitted"] += emitted_total

    # ---- decode -------------------------------------------------------

    def _decode_ready_rows(self) -> list:
        """Decode-ready (slot, seq) rows after the cancellation and
        deadline sweep; one collection for the decode build and the mixed
        tick."""
        ready = [
            (i, s) for i, s in enumerate(self.slots)
            if s is not None and not s.prefilling
        ]
        now = time.time() if self._has_deadlines else 0.0
        for _, s in ready:
            if s.ctx.is_stopped():
                self._finish(s, FINISH_REASON_CANCELLED)
            elif now:
                self._sweep_expired(s, now)
        return [(i, s) for i, s in ready if self.slots[i] is s]

    def _maybe_dispatch_decode(self):
        """Host-side build of the next decode dispatch (cancellation sweep,
        page growth, the fused [positions, active] upload, the carry
        overrides and the dirty-slot snapshot): a verify build when drafts
        are worthwhile, else a multi-step decode build; "sync_first" when
        worthwhile drafts wait behind an in-flight dispatch (the loop lands
        it and builds again); None when nothing can dispatch."""
        if self._closed:
            return None
        ready = self._decode_ready_rows()
        if not ready:
            return None
        if (
            self._prefilling
            and len(ready) < self.config.decode_ready_frac * len(self.slots)
            and all(s.generated <= 1 for _, s in ready)
        ):
            # pure admission wave: hold for a fuller batch (never once a
            # stream is mid-decode)
            return None
        if self._inflight is not None and (self._inflight.spec or self._inflight.mixed):
            # a verify window advances data-dependently, and a mixed step
            # re-arms its rows' overrides at its sync: a build from the
            # host state before that sync would replay a stale carry
            return None
        if self._spec_on():
            bld = self._maybe_build_spec(ready)
            if bld == "wait":
                return "sync_first" if self._pipe_on() else None
            if bld is not None:
                return bld
        # the ladder's last rung ("serialized decode") drops the loop to one
        # step a dispatch: still progress, every host sync re-validates
        steps = self._decode_steps()
        prep = self._grow_and_collect(ready, lambda seq: seq.device_pos + steps - 1)
        if prep is None:
            return None
        active, width = prep
        pos_act = np.zeros((width, 2), np.int32)
        for i, seq in active:
            pos_act[i] = (seq.device_pos, 1)
            seq.device_pos += steps
            # the loop ends with this row's newest sample in the carry
            self._carry_ok[i] = True
        overrides = {
            slot: val for slot, val in self._overrides.items()
            if slot < width and pos_act[slot, 1]
        }
        self._overrides.clear()
        # the graph key: which parts of the extended sampler the batch needs
        return dict(
            spec=False, pos_act=pos_act, overrides=overrides, active=active, steps=steps,
            width=width, all_greedy=all(s.temperature <= 0.0 for _, s in active),
            use_ext=any(s.has_penalties or s.seed >= 0 for _, s in active),
            want_lps=any(s.want_logprobs for _, s in active),
            want_tops=any(s.top_logprobs > 0 for _, s in active),
            dirty=self._snap_dirty(),
        )

    def _grow_and_collect(self, ready, upto):
        """Grow each row's pages through `upto(seq)` (clamped to the last
        writable position; may preempt), re-filter the rows that survived
        and bucket the dispatch width to the power-of-two prefix covering
        the highest active slot (at least 8). Returns (active, width), or
        None when nothing stayed decode-ready.

        A growth that preempts its own sequence drops that row only; the
        others dispatch. (The reference gives up the whole dispatch for
        the tick instead, which livelocks once the prefix cache is on: the
        preempted sequence re-admits onto its own cached pages, prefills
        its short tail within the tick, and preempts itself again before
        the other rows ever dispatch.)"""
        max_pos = self.config.max_model_len - 1
        for _, seq in ready:
            if seq.slot < 0 or self.slots[seq.slot] is not seq:
                continue  # preempted by an earlier growth this pass
            self._ensure_pages_through(seq, min(upto(seq), max_pos))
        active = [(i, s) for i, s in ready if self.slots[i] is s and not s.prefilling]
        if not active:
            return None
        return active, min(max(8, _pow2(1 + max(i for i, _ in active))), len(self.slots))

    def _ensure_pages_through(self, seq: Sequence, upto_pos: int) -> bool:
        grew = False
        while upto_pos // self.page_size >= len(seq.page_ids):
            got = self.allocator.allocate(1)
            if got is not None:
                seq.page_ids.extend(got)
                self._kv_hold(got, seq.ctx.id, tenant=seq.tenant)
                grew = True
                continue
            live = [s for s in self.slots if s is not None]
            victim = (
                pick_preemption_victim(live) if self.config.priority_scheduling
                else max(live, key=lambda s: s.seq_id)
            )
            self._preempt(victim)
            if victim is seq:
                return False
        if grew:
            self._mark_slot_state(seq)
        return True

    def _preempt(self, seq: Sequence) -> None:
        """Out of pages: register the sequence's full pages, release them
        and requeue it at the front; re-admission matches its own
        registered pages and re-prefills the rest. The slot's carry license
        and override go with it (the slot may be reused; re-admission
        re-arms through the prefill override)."""
        log.info("preempting seq %s (out of KV pages)", seq.seq_id)
        self._phase_stats["preemptions"] += 1
        self._register_full_pages(seq)
        self._kv_drop(seq.page_ids, seq.ctx.id)
        self.allocator.release(seq.page_ids)
        self.slots[seq.slot] = None
        self._overrides.pop(seq.slot, None)
        self._carry_ok[seq.slot] = False
        if seq in self._prefilling:
            self._prefilling.remove(seq)
        seq.slot = -1
        seq.prefilling = False
        seq.carry_pending = False
        seq.first_task = None
        seq.page_ids = []
        seq.num_cached = 0
        seq.num_computed = 0
        seq.device_pos = 0
        seq.registered_pages = 0
        self.waiting.appendleft(seq)

    def _apply_overrides(self, overrides: dict) -> None:
        """Write carry overrides into the device carry: prefill first
        tokens device to device (with their logprobs and tops, where the
        prefill reported them), grouped by source dispatch, and host ints
        in one upload (a host int was emitted already, so its carry
        logprob is never read)."""
        by_res: dict[int, tuple] = {}
        ints = []
        for slot, val in overrides.items():
            if isinstance(val, tuple):
                res, row = val
                ent = by_res.setdefault(id(res), (res, [], []))
                ent[1].append(slot)
                ent[2].append(row)
            else:
                ints.append((slot, int(val)))
        carries = (self._carry, self._carry_lps, self._carry_tid, self._carry_tlp)
        for res, slots, rows in by_res.values():
            sl = self._up(np.asarray(slots, np.int64))
            rw = self._up(np.asarray(rows, np.int64))
            for dst, src in zip(carries, res):
                if src is not None:
                    dst.index_copy_(0, sl, src.index_select(0, rw))
        if ints:
            arr = np.asarray(ints, np.int64)
            self._carry.index_copy_(0, self._up(arr[:, 0].copy()),
                                    self._up(arr[:, 1].astype(np.int32)))

    @torch.inference_mode()
    def _run_decode_dispatch(self, bld: dict) -> _Dispatch:
        """Enqueue a decode (or verify) dispatch: the dirty rows and carry
        overrides go to the device, then the decode loop runs (a replayed
        CUDA graph on the card) and its tokens start for the host."""
        if bld["spec"]:
            return self._run_spec_dispatch(bld)
        t0 = time.perf_counter()
        self._flush_dev_state(bld["dirty"])
        self._apply_overrides(bld["overrides"])
        w = bld["width"]
        self._up(bld["pos_act"], out=self._pos_act[:w])
        # an extended row's count buffer exists: its final prefill chunk
        # sampled on the extended path (mixed steps never carry one)
        out = self._graphs.run(w, bld["all_greedy"], bld["use_ext"], bld["want_lps"],
                               bld["want_tops"], bld["steps"])
        fetch = _Fetch(list(out))
        self._step_count += 1
        t1 = time.perf_counter()
        rows = len(bld["active"])
        n_tok = rows * bld["steps"]
        st = self._phase_stats
        st["decode_dispatch_s"] += t1 - t0
        st["decode_dispatches"] += 1
        st["decode_tokens"] += n_tok
        self._flight_record("decode", t1 - t0, rows=rows, tokens=n_tok)
        if tracing.enabled():
            tracing.complete("decode", t0, t1, cat="step", track="engine.steps", rows=rows,
                             tokens=n_tok, steps=bld["steps"])
        return _Dispatch(fetch, bld["active"], bld["steps"])

    @torch.inference_mode()
    def _decode_step(self, width: int, all_greedy: bool, use_ext: bool = False,
                     want_lps: bool = False, want_tops: bool = False,
                     steps: Optional[int] = None) -> tuple:
        """The decode loop over the static device buffers (what the CUDA
        graph captures): `steps` (default `decode_steps`) iterations with
        on-device token
        feedback from the carry, tables and sampling params of the first
        `width` slots. Returns (tokens, logprobs, top ids, top logprobs),
        [steps + 1, width] (the tops [steps + 1, width, 8]), row 0 the
        input carry's, the last three None unless asked for; leaves the
        last sample in the carry. Inactive rows attend nothing and write
        nothing (lengths 0, write_pos -1); positions past the model length
        budget (overshoot of finished rows) skip the write too.

        `use_ext`: the extended sampler, reading the penalties, the seeds
        and the count rows, which each step's sample bumps in place. The
        reference also bumps "fresh" carry rows first, tokens injected
        from a remote prefill and never counted; the port has no such
        path: every carry token was counted where it was sampled."""
        pos_act = self._pos_act[:width]
        positions = pos_act[:, 0]
        active = pos_act[:, 1].bool()
        block_tables = self._dev_tables[:width]
        samp_f, samp_i = self._dev_samp_f[:width], self._dev_samp_i[:width]
        temp, topp, topk = samp_f[:, 0], samp_f[:, 1], samp_i[:, 0]
        counts = self._counts[:width] if use_ext else None
        max_len = self.config.max_model_len
        no = torch.full_like(positions, -1)
        tokens = self._carry[:width]
        outs = [[tokens.clone()]]
        if want_lps:
            outs.append([self._carry_lps[:width].clone()])
        if want_tops:
            outs += [[self._carry_tid[:width].clone()], [self._carry_tlp[:width].clone()]]
        top_n = TOP_LOGPROBS_MAX if want_tops else 0
        for _ in range(steps or self.config.decode_steps):
            lengths = torch.where(
                active, torch.clamp(positions + 1, max=max_len), torch.zeros_like(positions)
            ).to(torch.int32)
            write_pos = torch.where(active & (positions < max_len), positions, no).to(torch.int32)
            attn = llama.AttnSpec.paged_decode(
                block_tables, lengths, self.page_size, write_pos=write_pos
            )
            hidden, _ = llama.forward(
                self.params, self.model_cfg, tokens[:, None], positions[:, None],
                self.kv, attn, inv_freq=self._inv_freq,
            )
            lg = llama.logits(self.params, self.model_cfg, hidden[:, 0])
            ext = {}
            if use_ext:
                ext = dict(counts=counts, freq_pen=samp_f[:, 2], pres_pen=samp_f[:, 3],
                           rep_pen=samp_f[:, 4], seeds=samp_i[:, 1], positions=positions)
            res = sample_tokens(lg, self._gen, temp, topk, topp, all_greedy=all_greedy,
                                return_logprobs=want_lps, top_n=top_n, **ext)
            res = res if want_lps else (res,)
            tokens = res[0]
            if use_ext:
                bump_counts(counts, tokens, active)
            for o, r in zip(outs, res):
                o.append(r)
            positions = positions + 1
        out = [torch.stack(o) for o in outs]
        for dst, o in zip((self._carry, self._carry_lps, self._carry_tid, self._carry_tlp), out):
            dst[:width].copy_(o[-1])
        return tuple(out) + (None,) * (4 - len(out))

    async def _sync_dispatch(self, d: _Dispatch, overlapped: bool = False) -> None:
        """Land a dispatch: fetch its tokens and emit them. `overlapped`:
        another dispatch is already queued on the device, so this fetch's
        wait hides behind device work."""
        # first-token fetches for sequences in this dispatch land first:
        # their token precedes these in the stream
        for task in {s.first_task for _, s in d.snapshot if s.first_task}:
            try:
                await task
            except Exception:
                log.exception("first-token emit task failed")
        t0 = time.perf_counter()
        wd = self._op_begin("sync.fetch")
        try:
            arrs = await d.out.get()
        finally:
            self._op_end(wd)
        t1 = time.perf_counter()
        dt = t1 - t0
        st = self._phase_stats
        if overlapped:
            st["pipeline_overlap_s"] += dt
            st["pipeline_overlapped"] += 1
        else:
            st["mixed_sync_s" if d.mixed else "spec_sync_s" if d.spec
               else "decode_sync_s"] += dt
        rows = len(d.bld["entries"]) if d.mixed else len(d.snapshot)
        self._flight_record("overlap" if overlapped else "sync", dt, rows=rows)
        if tracing.enabled():
            # overlapped fetches on their own track: the timeline shows
            # which fetch walls the pipeline hid
            tracing.complete(
                "mixed.sync" if d.mixed else "spec_verify.sync" if d.spec else "decode.sync",
                t0, t1, cat="step", track="engine.overlap" if overlapped else "engine.sync",
                rows=rows)
        if d.mixed:
            self._sync_mixed(d.bld, arrs)
            return
        if d.spec:
            self._sync_spec(d, arrs)
            return
        out, extra = arrs[0], arrs[1:]
        # row 0 is the dispatch's input carry: sequences that entered with
        # their first token still on the device emit it here, before their
        # decode tokens
        for i, seq in d.snapshot:
            if self.slots[i] is seq and seq.carry_pending:
                seq.carry_pending = False
                seq.num_computed = seq.total_tokens
                self._append_token(seq, int(out[0, i]), *self._lp_tops(seq, *extra, (0, i)))
        for step in range(1, out.shape[0]):
            for i, seq in d.snapshot:
                if self.slots[i] is not seq:
                    continue  # finished earlier in this dispatch: overshoot
                seq.num_computed += 1
                self._register_full_pages(seq)
                self._append_token(seq, int(out[step, i]),
                                   *self._lp_tops(seq, *extra, (step, i)))

    # ---- speculative verify --------------------------------------------

    def _maybe_build_spec(self, ready):
        """Host side of a standalone verify dispatch: n-gram drafts for
        every decode-ready row and the [B, k_max + 1] window of each
        (its last token, then its drafts). None when drafts are not
        worthwhile (the batch must average at least one drafted token a
        row, since a verify dispatch is ONE model step for every row and
        rows without drafts fall from decode_steps tokens to one) or a row
        has its first token still on the device; "wait" when they are
        worthwhile but host history is stale until the in-flight dispatch
        lands. A row on the extended sampler keeps the whole batch on the
        decode loop: the verifier samples on the plain path only."""
        for _, s in ready:
            if s.carry_pending or s.needs_ext_sampling:
                return None
        k_max = self.config.spec_k_max
        drafts: dict[int, list[int]] = {}
        for i, seq in ready:
            drafts[i] = seq.spec.maybe_draft(self._draft_room(seq, k_max))
        if sum(len(d) for d in drafts.values()) < max(1, len(ready)):
            return None
        if self._inflight is not None:
            return "wait"
        prep = self._grow_and_collect(
            ready, lambda seq: seq.device_pos + len(drafts.get(seq.slot, ())))
        if prep is None:
            return None
        active, b = prep
        t = k_max + 1
        ps = self.page_size
        # attended pages bucket to a power of two, as for prefill: every
        # attended position <= device_pos + draft_len lies inside w_need
        w_need = max((s.device_pos + len(drafts[i])) // ps + 1 for i, s in active)
        w = min(_pow2(w_need), self.config.max_pages_per_seq)
        tokens = np.zeros((b, t), np.int32)
        positions = np.zeros((b, t), np.int32)
        tables = np.zeros((b, w), np.int32)
        draft = np.zeros((b, k_max), np.int32)
        dlen = np.zeros(b, np.int32)
        pos0 = np.zeros(b, np.int32)
        act = np.zeros(b, bool)
        temp = np.zeros(b, np.float32)
        topk = np.zeros(b, np.int32)
        topp = np.ones(b, np.float32)
        for i, seq in active:
            d = drafts[i]
            act[i] = True
            pos0[i] = seq.device_pos
            tokens[i, 0] = seq.last_token
            tokens[i, 1:1 + len(d)] = d
            draft[i, :len(d)] = d
            dlen[i] = len(d)
            positions[i] = seq.device_pos + np.arange(t, dtype=np.int32)
            npg = min(len(seq.page_ids), w)
            tables[i, :npg] = seq.page_ids[:npg]
            temp[i], topk[i], topp[i] = seq.temperature, seq.top_k, seq.top_p
            # the host window replaces the carry; the verify step never
            # touches the carry vector, so its sync re-arms an override
            self._overrides.pop(i, None)
            self._carry_ok[i] = False
        return dict(spec=True, tokens=tokens, positions=positions, tables=tables,
                    draft=draft, dlen=dlen, pos0=pos0, act=act, temp=temp, topk=topk,
                    topp=topp, active=active, all_greedy=bool((temp[act] <= 0.0).all()))

    def _run_spec_dispatch(self, bld: dict) -> _Dispatch:
        """Enqueue a verify step (`_spec_verify_step`) and start its
        results for the host."""
        t0 = time.perf_counter()
        fetch = _Fetch(list(self._spec_verify_step(bld)))
        self._step_count += 1
        t1 = time.perf_counter()
        st = self._phase_stats
        st["spec_dispatch_s"] += t1 - t0
        st["spec_dispatches"] += 1
        rows = len(bld["active"])
        n_tok = rows + int(np.sum(bld["dlen"]))
        self._flight_record("spec_verify", t1 - t0, rows=rows, tokens=n_tok)
        if tracing.enabled():
            tracing.complete("spec_verify", t0, t1, cat="step", track="engine.steps",
                             rows=rows, tokens=n_tok)
        return _Dispatch(fetch, bld["active"], 1, spec=True, pos0=bld["pos0"],
                         draft_lens=bld["dlen"])

    @torch.inference_mode()
    def _spec_verify_step(self, bld: dict):
        """One verify step: every row carries 1 + draft_len tokens through
        the model in ONE forward (KV written first through the row write,
        so each draft attends its prefix; the read is K4 with q_len =
        draft_len + 1 from a mid-page q_pos0), then `verify_draft_tokens`
        emits the accepted prefix plus one. Rejected drafts leave garbage
        KV in slots past the accepted length: the causal mask hides it and
        the next step rewrites those slots before any query reaches them.
        Returns (out [B, T], n_emit [B]) on the device."""
        s = self.page_size
        dev = self.device
        tables = self._up(bld["tables"])
        positions = self._up(bld["positions"])
        dlen = self._up(bld["dlen"])
        act = self._up(bld["act"])
        w, t = tables.shape[1], positions.shape[1]
        page_idx = torch.clamp(positions // s, max=w - 1).long()
        wslots = torch.gather(tables, 1, page_idx) * s + positions % s
        # rows write [pos0, pos0 + draft_len]; padding columns, idle rows
        # and past-budget positions write the trash page
        col_ok = torch.arange(t, device=dev)[None, :] <= dlen[:, None]
        keep = act[:, None] & col_ok & (positions < self.config.max_model_len)
        wslots = torch.where(keep, wslots, torch.zeros_like(wslots)).to(torch.int32)
        attn = llama.AttnSpec.ragged(
            tables, positions[:, 0].contiguous(),
            torch.where(act, dlen + 1, torch.zeros_like(dlen)).to(torch.int32),
            wslots.reshape(-1), s,
        )
        hidden, _ = llama.forward(
            self.params, self.model_cfg, self._up(bld["tokens"]),
            positions, self.kv, attn, inv_freq=self._inv_freq)
        return verify_draft_tokens(
            llama.logits(self.params, self.model_cfg, hidden),
            self._up(bld["draft"]), dlen, self._gen,
            self._up(bld["temp"]), self._up(bld["topk"]),
            self._up(bld["topp"]), all_greedy=bld["all_greedy"])

    def _sync_spec(self, d: _Dispatch, arrs) -> None:
        """Land a verify dispatch: one `_emit_verify_row` per surviving
        row."""
        out, n_emit = arrs
        st = self._phase_stats
        for i, seq in d.snapshot:
            if self.slots[i] is not seq:
                continue  # finished or preempted meanwhile
            drafted = int(d.draft_lens[i])
            emitted, accepted = self._emit_verify_row(
                i, seq, out[i], int(n_emit[i]), drafted, int(d.pos0[i]))
            st["spec_rows"] += 1
            st["spec_drafted"] += drafted
            st["spec_accepted"] += accepted
            st["spec_emitted"] += emitted

    def _emit_verify_row(self, slot: int, seq: Sequence, out_row, n: int,
                         drafted: int, base: int, keep_pos: bool = False) -> tuple:
        """Land one verify row (standalone or inside a mixed step): emit
        the accepted prefix plus the corrected or bonus token, advancing
        num_computed, and device_pos to just past the emitted tokens, so
        the KV a rejected tail left stays beyond the sequence's length and
        is rewritten before any query attends it. `keep_pos`: a pipelined
        mixed step's q_len 1 row advanced device_pos at build, and a later
        build may have advanced it again: nothing to rewind. The last
        emitted token becomes the slot's carry override (verify windows
        never touch the device carry). Returns (emitted, accepted)."""
        emitted = 0
        for j in range(n):
            if self.slots[slot] is not seq:
                break  # EOS or length mid-window: the tail is discarded
            seq.num_computed += 1
            if not keep_pos:
                seq.device_pos = base + j + 1
            self._register_full_pages(seq)
            self._append_token(seq, int(out_row[j]))
            emitted += 1
        # what landed: a draft that finished the stream discards the tail
        # and the bonus token, which must not count as accepted
        accepted = n - 1 if emitted == n else emitted
        if drafted:
            seq.spec.observe(drafted, accepted)
        if self.slots[slot] is seq:
            self._overrides[slot] = int(out_row[n - 1])
        return emitted, accepted

    # ---- the prefix wire -----------------------------------------------

    def peek_prefix_tokens(self, token_ids: list[int], max_tokens: Optional[int] = None,
                           hashes: Optional[list[int]] = None) -> int:
        """Cached-prefix length of a prompt in tokens across both tiers (HBM,
        then its continuation in the host tier), taking no reference: what
        `_reserve_pages` would reuse, the router's and the prefix pull's
        decision input. Pass `hashes` when the prompt's chained block hashes
        are at hand."""
        if hashes is None:
            hashes = compute_block_hashes(token_ids, self.page_size)
        if max_tokens is not None:
            hashes = hashes[:max_tokens // self.page_size]
        n = self.allocator.peek_prefix_tokens(hashes=hashes) // self.page_size
        if self.host_pool is not None:
            for h in hashes[n:]:
                if h not in self.host_pool:
                    break
                n += 1
        return n * self.page_size

    def export_prefix(self, token_ids: list[int], hashes: Optional[list[int]] = None):
        """This engine's cached KV for a prompt's longest cached prefix, the
        source side of a prefix pull: (n_tokens, k, v, ks, vs) in the
        reference's wire format, as CPU tensors (`.numpy()` gives the
        reference's arrays byte for byte; a bf16 wire's bits through
        `.view(torch.int16)`): k/v [L, T, K*Hd] in the model dtype, or
        int8 rows, or nibble-packed int4 rows [L, T, K*Hd/2], with dense
        f32 scales ks/vs [L, T, S] (S = K, or K * groups for grouped int4;
        None for a model-dtype pool). None when no full page of the prompt
        is cached. The matched pages stay
        pinned for the gather (no eviction can race it) and are released
        after it; they stay cached. Blocking: the rows are copied to the
        host."""
        if hashes is None:
            hashes = compute_block_hashes(token_ids, self.page_size)
        pages = self.allocator.match_prefix(hashes)
        if not pages:
            return None
        self._kv_hold(pages, "sys:export")
        try:
            rows = self._gather_rows(pages, len(pages) * self.page_size)
            rows = [None if x is None else x.cpu() for x in rows]
        finally:
            self._kv_drop(pages, "sys:export")
            self.allocator.release(pages)
        return (len(pages) * self.page_size, *rows)

    @torch.inference_mode()
    def _gather_rows(self, pages: list[int], n_tokens: int) -> list:
        """The first `n_tokens` positions of `pages` in the wire format, on
        the device: [k, v, ks, vs], k/v [L, T, row width] and dense scales
        ks/vs [L, T, S] (None for a model-dtype pool)."""
        ps = self.page_size
        slots = self._up((np.asarray(pages, np.int64)[:, None] * ps
                          + np.arange(ps)).reshape(-1)[:n_tokens])
        kv = self.kv
        out = [torch.stack([x.index_select(0, slots) for x in pools]) for pools in (kv.k, kv.v)]
        if kv.quantized:
            out += [torch.stack([quant.gather_kv_scales(x, slots) for x in pools])
                    for pools in (kv.ks, kv.vs)]
        return out + [None] * (4 - len(out))

    def ingest_prefix(self, token_ids: list[int], k, v, ks=None, vs=None) -> int:
        """Land externally computed KV for a token prefix in the pools and
        the prefix cache: the receiving side of a prefix pull. `k`/`v`
        [L, T, K*Hd] (or nibble-packed [L, T, K*Hd/2]) and `ks`/`vs`
        [L, T, S] as `export_prefix` gives them, as tensors or numpy arrays
        (a bf16 array of the ml_dtypes type is read by its bits). Only
        whole pages are ingested, and the run already cached is skipped;
        returns the tokens now cached. A following `generate` with the
        prompt rides the cache and computes the tail. The rows go through
        `_convert_wire_kv`, then each layer's pages through the page-scatter
        write (K1, or K7 in its int8 or int4 form), which on the card is
        the hand-written kernel; a failed launch raises. The matched pages
        stay pinned until the new pages are registered (the new pages
        chain from them); all pins are released at the end, so the pages
        stay cached."""
        ps = self.page_size
        full_pages = len(token_ids) // ps
        if full_pages == 0:
            return 0
        blocks = TokenBlockSequence(list(token_ids), ps).blocks[:full_pages]
        cached = self.allocator.match_prefix([b.sequence_hash for b in blocks])
        self._kv_hold(cached, "sys:ingest")
        start = len(cached)
        if start == full_pages:
            self._kv_drop(cached, "sys:ingest")
            self.allocator.release(cached)
            return full_pages * ps
        pages = self.allocator.allocate(full_pages - start)
        if pages is None:
            self._kv_drop(cached, "sys:ingest")
            self.allocator.release(cached)
            return start * ps
        self._kv_hold(pages, "sys:ingest")
        try:
            t0, t1 = start * ps, full_pages * ps
            wire = [None if a is None else _wire_tensor(a)[:, t0:t1] for a in (k, v, ks, vs)]
            self._write_wire_pages(pages, *self._convert_wire_kv(*wire))
            self.allocator.register(
                pages, [(b.sequence_hash, b.local_hash) for b in blocks[start:]],
                parent_hash=blocks[start].parent_sequence_hash,
            )
        finally:
            # registered pages stay cached; after a failure the unhashed
            # pages free at once
            self._kv_drop(cached + pages, "sys:ingest")
            self.allocator.release(cached + pages)
        return full_pages * ps

    def _write_wire_pages(self, pages: list[int], nk, nv, nks, nvs) -> None:
        """Land wire rows (on the device, in this pool's format, as
        `_convert_wire_kv` gives them) of whole pages: k/v [L, n*ps, row
        width], dense scales [L, n*ps, S] (None for a model-dtype pool)."""
        n, ps = len(pages), self.page_size
        k = nk.reshape(nk.shape[0], n, ps, -1)
        v = nv.reshape(nv.shape[0], n, ps, -1)
        ks = vs = None
        if nks is not None:
            ks = [quant.scales_to_page_tiles(x, ps) for x in nks]
            vs = [quant.scales_to_page_tiles(x, ps) for x in nvs]
        self._write_pages(pages, k, v, ks, vs)

    @torch.inference_mode()
    def _write_pages(self, pages: list[int], k, v, ks=None, vs=None) -> None:
        """Land whole pages in every layer's pools through the page-scatter
        write (K1, or K7 in its int8 or int4 form; on a CUDA device the
        hand-written kernel, whose failed launch raises): `k[i]`/`v[i]`
        [n, ps, row width] are layer i's pages and, with quantized pools,
        `ks[i]`/`vs[i]` [n, S, ps] their scale tiles."""
        kv, ps = self.kv, self.page_size
        table = self._up(np.asarray(pages, np.int32))
        for i in range(len(kv.k)):
            src = (k[i].contiguous(), v[i].contiguous())
            if kv.quantized:
                src += (kv.ks[i], kv.vs[i], ks[i].contiguous(), vs[i].contiguous())
            paged_kv_write(kv.k[i], kv.v[i], table, *src, page_size=ps, int4=kv.int4,
                           groups=max(1, self._kv_int4_groups))

    def _convert_wire_kv(self, nk, nv, nks, nvs):
        """A wire's rows in this engine's KV format, on the device: a
        model-dtype wire entering an int8 or int4 pool is quantized, a
        quantized wire of the pool's own tier passes byte for byte, an
        int8 wire entering a model-dtype pool is dequantized. Any other
        pair would requantize bytes that were quantized once already, and
        raises `KvQuantMismatchError`, as does an int4 wire whose scale
        channels are not the pool's (K * groups: its kv_quant_group)."""
        m = self.model_cfg
        kh = m.num_kv_heads
        s_ch = self._kv_scale_channels()
        tier = self.config.kv_quantization
        wire = None  # the wire's tier, from its row width
        if nks is not None:
            wire = "int4" if nk.shape[-1] * 2 == kh * m.head_dim else "int8"
        if wire is not None and wire != (tier or "int8"):
            raise KvQuantMismatchError(
                f"wire KV payload is {wire} but this engine's pool tier is "
                f"{tier or self.config.dtype}: cross-tier injection would requantize "
                "already-quantized bytes; both sides need matching kv_quantization"
            )
        if wire is not None and nks.shape[-1] != s_ch:
            raise KvQuantMismatchError(
                f"{wire} wire KV carries {nks.shape[-1]} scale channels but this "
                f"engine's pools use {s_ch} (kv_quant_group mismatch): both sides need "
                "matching kv_quantization grouping"
            )
        dev = self.device
        nk, nv = nk.to(dev), nv.to(dev)
        if tier and nks is None:
            if tier == "int4":
                group = m.head_dim // self._kv_int4_groups
                nk, nks = quant.quantize_kv_rows_int4(nk, kh, group)
                nv, nvs = quant.quantize_kv_rows_int4(nv, kh, group)
            else:
                nk, nks = quant.quantize_kv_rows(nk, kh)
                nv, nvs = quant.quantize_kv_rows(nv, kh)
        elif tier:
            nks, nvs = nks.to(dev, torch.float32), nvs.to(dev, torch.float32)
        elif nks is not None:
            nk = quant.dequantize_kv_rows(nk, nks.to(dev), out_dtype=self._dtype)
            nv = quant.dequantize_kv_rows(nv, nvs.to(dev), out_dtype=self._dtype)
            nks = nvs = None
        else:
            nk, nv = nk.to(self._dtype), nv.to(self._dtype)
        return nk, nv, nks, nvs

    # ---- disaggregation entries ----------------------------------------

    async def generate_remote(self, request: Context, first_token: int, k, v, ks=None,
                              vs=None) -> AsyncIterator[dict]:
        """The decode side of disaggregation: `generate`, with the prompt's
        KV computed elsewhere (by `prefill_only`, here or in JaxEngine)
        landed instead of computed, and `first_token` (sampled there)
        seeding decode. `k`/`v` [L, T, K*Hd] (or nibble-packed int4 rows
        [L, T, K*Hd/2]) and `ks`/`vs` [L, T, S] from a quantized pool, as
        tensors (on the CPU or this device) or numpy arrays; a locally
        cached prefix is reused and only the rest lands, chunk by chunk,
        through `_convert_wire_kv` and the page-scatter write. The first
        frame's meta carries `remote_prefill: True`."""
        payload = request.payload
        pre = (PreprocessedRequest.from_dict(payload)
               if isinstance(payload, dict) else payload)
        m = self.model_cfg
        kw = m.num_kv_heads * m.head_dim
        # a quantized wire may be int4 nibble-packed: half-width rows
        int4_wire = ks is not None and k.shape[-1] * 2 == kw
        want = (m.num_layers, len(pre.token_ids), kw // 2 if int4_wire else kw)
        for name, arr in (("k", k), ("v", v)):
            if tuple(arr.shape) != want:
                raise ValueError(f"remote {name} KV shape {tuple(arr.shape)} != expected {want}")
        if (ks is None) != (vs is None):
            raise ValueError("remote KV scales must come as a k/v pair")
        if ks is not None:
            s_ch = self._kv_scale_channels() if int4_wire else m.num_kv_heads
            want_s = (m.num_layers, len(pre.token_ids), s_ch)
            for name, arr in (("ks", ks), ("vs", vs)):
                if tuple(arr.shape) != want_s:
                    raise ValueError(
                        f"remote {name} scale shape {tuple(arr.shape)} != expected {want_s}")
        return await self.generate(request, _preloaded=(int(first_token), k, v, ks, vs))

    async def prefill_only(self, pre: PreprocessedRequest, ctx: Optional[Context] = None,
                           device_arrays: bool = False) -> tuple:
        """The prefill side of disaggregation: compute the prompt's KV and
        first token, outside the serving loop, and return (first_token, k,
        v, ks, vs) in the prefix wire's format (`export_prefix`): k/v [L, T,
        row width], ks/vs [L, T, S] on a quantized engine, else None; CPU
        tensors, or with `device_arrays` this engine's device tensors (the
        send side of the device path, engine/kv_transfer.py). Pages are
        awaited up to `prefill_wait_s`, capped by the request's deadline,
        then `PoolExhaustedError`; they are released at the end and stay
        cached for later hits."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self._refuse_unported(pre, remote=True)
        if len(pre.token_ids) == 0:
            raise ValueError("empty prompt")
        self._check_embeds(pre)
        ctx = ctx or Context(pre.to_dict())
        usable_tokens = (self.num_pages - 1) * self.page_size
        if len(pre.token_ids) + 1 > usable_tokens:
            raise ValueError(
                f"prompt of {len(pre.token_ids)} tokens cannot fit the KV pool "
                f"({self.num_pages - 1} pages x {self.page_size} tokens)")
        seq = Sequence.from_request(ctx, pre, self.page_size, self.config.max_model_len)
        self._take_embeds(seq)
        if seq.has_penalties:
            # the penalties read a decode slot's count row, and this sequence
            # holds no slot (the reference reads and bumps slot 0's row)
            raise NotImplementedError(
                "sampling penalties on prefill_only: its sequence holds no decode slot "
                "whose token counts they read (see ROADMAP.md)")
        # the page wait fits whatever remains of the request's own budget
        wait_s = float(self.config.prefill_wait_s)
        if seq.deadline:
            wait_s = min(wait_s, max(seq.deadline - time.time(), 0.0))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait_s
        while not self._reserve_pages(seq):
            if loop.time() > deadline:
                raise PoolExhaustedError(f"prefill worker out of KV pages after {wait_s:.1f}s")
            await asyncio.sleep(0.05)
        try:
            while True:
                chunk = min(seq.total_tokens - seq.num_computed, self.config.prefill_chunk)
                res = await self._launch(self._prefill_group_dispatch, [seq],
                                         self._bucket_for(chunk), False,
                                         op="prefill.dispatch", point="engine.prefill")
                seq.num_computed += chunk
                self._register_full_pages(seq)
                if seq.num_computed >= seq.total_tokens:
                    break
            rows = self._gather_rows(seq.page_ids, seq.num_computed)
            fetch = _Fetch(res[:1] + ([] if device_arrays else rows))
            got = await fetch.tensors()
            first_token = int(got[0][0])
            if not device_arrays:
                rows = got[1:]
            return (first_token, *rows)
        finally:
            self._kv_drop(seq.page_ids, seq.ctx.id)
            self.allocator.release(seq.page_ids)

    def _inject_chunk(self, seq: Sequence) -> Optional[int]:
        """Land the next chunk (at most `prefill_chunk` tokens, from the
        sequence's first uncomputed position, page-aligned) of a remotely
        prefilled sequence's wire in its pages; returns the remote first
        token once every position is landed, else None. The chunk's last
        page is padded past its tail (positions not computed yet, which
        the page-scatter write's contract leaves free)."""
        first_token, k, v, ks, vs = seq.preloaded
        t = seq.total_tokens
        start = seq.num_computed  # a locally cached prefix needs no landing
        if start < t:
            ps = self.page_size
            chunk = min(t - start, self.config.prefill_chunk)
            p0, p1 = start // ps, -(-(start + chunk) // ps)
            pad = (p1 - p0) * ps - chunk
            wire = []
            for a, fill in ((k, 0.0), (v, 0.0), (ks, 1.0), (vs, 1.0)):
                if a is not None:
                    a = _wire_tensor(a)[:, start:start + chunk]
                    if pad:
                        a = torch.cat([a, a.new_full((a.shape[0], pad, a.shape[2]), fill)], 1)
                wire.append(a)
            self._write_wire_pages(seq.page_ids[p0:p1], *self._convert_wire_kv(*wire))
            seq.num_computed += chunk
            self._register_full_pages(seq)
        if seq.num_computed >= t:
            seq.first_meta = {**(seq.first_meta or {}), "remote_prefill": True}
            return int(first_token)
        return None

    # ---- the host offload tier -----------------------------------------

    def _on_page_cached(self, pid: int, meta) -> None:
        """Allocator hook: a hashed page's last reference dropped; queue its
        write-through copy to the host tier. The queue is bounded, newest
        wins: under churn an unbounded backlog runs far behind the pages'
        useful life, so old entries are dropped."""
        if self.offload_paused or meta.sequence_hash in self.host_pool:
            return
        cap = max(4 * self.config.offload_batch_pages, 64)
        self._pending_offload.pop(meta.sequence_hash, None)
        while len(self._pending_offload) >= cap:
            self._pending_offload.pop(next(iter(self._pending_offload)))
        self._pending_offload[meta.sequence_hash] = (meta.local_hash, meta.parent_hash)

    def _maybe_start_offload(self) -> None:
        """Start one offload batch when copies are queued and none is in
        flight. Offload yields to prefill work (waiting or prefilling
        sequences): a gather in the middle of an admission wave takes the
        bandwidth the wave needs; decode-only and idle ticks absorb the
        copies. It runs at the top of a loop tick, never inside a decode
        graph's capture."""
        if not self._pending_offload or self.offload_paused:
            return
        if self.waiting or self._prefilling:
            return
        if self._offload_task is not None and not self._offload_task.done():
            return
        batch = []
        # newest first: recently freed pages are the likeliest re-hits
        for sh in reversed(list(self._pending_offload)):
            if len(batch) >= self.config.offload_batch_pages:
                break
            lh, parent = self._pending_offload.pop(sh)
            # pin BEFORE reserving a buffer: reserve() may evict a live host
            # entry, which must not happen for a page HBM no longer holds
            pid = self.allocator.pin(sh)
            if pid is None:
                continue
            self._kv_hold([pid], "sys:offload")
            buf = self.host_pool.reserve()
            if buf is None:
                self._kv_drop([pid], "sys:offload")
                self.allocator.release([pid])
                self._pending_offload[sh] = (lh, parent)
                break
            batch.append((sh, lh, parent, pid, buf))
        if batch:
            self._offload_task = asyncio.get_running_loop().create_task(
                self._offload_batch(batch))

    async def _offload_batch(self, batch) -> None:
        """Copy a batch of pinned pages to their host buffers, then index
        them in the host pool; the pins and any unused buffers go back at
        the end, also when the copy fails or the engine closes."""
        consumed = 0
        try:
            t0 = time.perf_counter()
            events = self._copy_pages_to_host([b[3] for b in batch], [b[4].value for b in batch])
            if events is None:
                dt = time.perf_counter() - t0
            else:
                # polled on the loop thread: an event sync from another
                # thread would invalidate a decode graph's capture
                while not events[1].query():
                    await asyncio.sleep(0.0002)
                dt = events[0].elapsed_time(events[1]) / 1e3
            st = self._phase_stats
            st["offload_copy_s"] += dt
            st["offload_pages"] += len(batch)
            for i, (sh, lh, parent, _pid, buf) in enumerate(batch):
                self.host_pool.put(sh, lh, parent, buf)  # consumes buf
                consumed = i + 1
        except Exception:
            log.exception("offload copy failed; dropping batch")
        finally:
            for *_, buf in batch[consumed:]:
                buf.release()
            pids = [b[3] for b in batch]
            self._kv_drop(pids, "sys:offload")
            self.allocator.release(pids)
            # re-arm the loop: the rest of the queue must go out before
            # admissions can evict those pages
            self._wake.set()

    @torch.inference_mode()
    def _copy_pages_to_host(self, pids: list[int], bufs: list):
        """Gather pages `pids` on the device into [n, 2, L, ps, row width]
        (and [n, 2, L, ps, S] scales), each page one host buffer's layout,
        and copy page j into `bufs[j]`. On a CUDA device the copies run on
        a side stream that first waits for the compute stream (the gather
        and every write before it), without blocking the host; returns
        timing events recorded before the gather and after the copies. On
        the CPU the copies are done on return (None)."""
        kv, ps = self.kv, self.page_size
        start = None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        idx = self._up(np.asarray(pids, np.int64))
        pages = torch.stack([
            torch.stack([x.view(-1, ps, x.shape[1]).index_select(0, idx) for x in pools], 1)
            for pools in (kv.k, kv.v)], 1)
        scales = None
        if kv.quantized:
            scales = torch.stack([
                torch.stack([x.index_select(0, idx).transpose(1, 2) for x in pools], 1)
                for pools in (kv.ks, kv.vs)], 1)

        def copy(non_blocking):
            for j, buf in enumerate(bufs):
                if scales is None:
                    buf.copy_(pages[j], non_blocking=non_blocking)
                else:
                    buf["kv"].copy_(pages[j], non_blocking=non_blocking)
                    buf["scales"].copy_(scales[j], non_blocking=non_blocking)

        if self.device.type != "cuda":
            copy(False)
            return None
        if self._offload_stream is None:
            self._offload_stream = torch.cuda.Stream(self.device)
        side = self._offload_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            copy(True)
        for t in (pages, scales):
            if t is not None:
                t.record_stream(side)
        done = torch.cuda.Event(enable_timing=True)
        done.record(side)
        return start, done

    def _restore_page_bytes(self) -> int:
        """Host bytes a restored page moves (K and V rows and scale tiles
        of every layer): the cost side of the restore gate."""
        return self.host_pool.page_bytes

    def _reset_offload_ema(self, rung: str = "", reason: str = "") -> None:
        """Forget the restore gate's rates (the degrade ladder's trip hook):
        measured on the configuration before the trip (a pipelined engine's
        prefill rate, say), they would misprice restoring against
        recomputing; the next restore and prefill calibrate them again."""
        self._ema_restore_bps = None
        self._ema_prefill_tps = None

    def _restore_worthwhile(self, n_pages: int) -> bool:
        """Restore only when moving the pages beats recomputing their
        tokens at the measured rates; with a rate unknown, restore (the
        restore calibrates it)."""
        if self._ema_restore_bps is None or self._ema_prefill_tps is None:
            return True
        restore_s = n_pages * self._restore_page_bytes() / self._ema_restore_bps
        recompute_s = n_pages * self.page_size / self._ema_prefill_tps
        return restore_s < recompute_s

    def _note_prefill_rate(self, seq: Sequence) -> None:
        """Calibrate the gate's recompute side: the prefill rate a request
        saw, admission to its first token, batching included. Only loaded
        samples count (at least a page computed over at least 50 ms): an
        idle engine's apparent rate would bias the gate into declining
        restores that pay."""
        fresh = seq.prompt_len - seq.num_cached
        span = seq.t_first_emit - seq.t_admit
        if seq.t_admit and fresh >= self.page_size and span > 0.05:
            tps = fresh / span
            self._ema_prefill_tps = (tps if self._ema_prefill_tps is None
                                     else 0.8 * self._ema_prefill_tps + 0.2 * tps)

    def _restore_from_host(self, seq: Sequence, page_ids: list[int], start_block: int) -> None:
        """Land the host copies of the sequence's blocks from `start_block`
        in the fresh pages `page_ids` and index them: each page buffer is
        copied to the device (without blocking, from pinned buffers on a
        CUDA device), reordered into per-layer pages, and written through
        the page-scatter kernel. The gate's rate is calibrated from the
        restore's own time: on a CUDA device between an event recorded
        before the first copy and one after the last write, read once a
        task polling off the admission path sees the second complete (a
        wall until then would also count the prefill enqueued behind the
        restore in the same tick); on the CPU the wall."""
        t0 = time.perf_counter()
        blocks = seq.blocks.blocks[start_block:start_block + len(page_ids)]
        bufs = [self.host_pool.get(b.sequence_hash) for b in blocks]
        quantized = isinstance(bufs[0], dict)
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.inference_mode():
            parts = [[b["kv"] for b in bufs], [b["scales"] for b in bufs]] if quantized \
                else [bufs]
            staged = []
            for host in parts:
                st = torch.empty((len(host), *host[0].shape), dtype=host[0].dtype,
                                 device=self.device)
                for j, h in enumerate(host):
                    st[j].copy_(h, non_blocking=cuda)
                staged.append(st)
            # [n, 2, L, ps, w] -> [2, L, n, ps, w]; scales [n, 2, L, ps, K] -> tiles
            # [2, L, n, K, ps]
            kvp = staged[0].permute(1, 2, 0, 3, 4).contiguous()
            tiles = staged[1].permute(1, 2, 0, 4, 3).contiguous() if quantized else (None, None)
            self._write_pages(page_ids, kvp[0], kvp[1], tiles[0], tiles[1])
        self.allocator.register(
            page_ids, [(b.sequence_hash, b.local_hash) for b in blocks],
            parent_hash=blocks[0].parent_sequence_hash,
        )
        self.offload_gate_stats["restored"] += 1
        n = len(page_ids)

        def calibrate(dt: float) -> None:
            dt = max(dt, 1e-6)
            self._phase_stats["restore_s"] += dt
            self._phase_stats["restore_pages"] += n
            bps = n * self._restore_page_bytes() / dt
            self._ema_restore_bps = (bps if self._ema_restore_bps is None
                                     else 0.5 * self._ema_restore_bps + 0.5 * bps)

        if not cuda:
            calibrate(time.perf_counter() - t0)
            return
        done = torch.cuda.Event(enable_timing=True)
        done.record()

        async def fence() -> None:
            while not done.query():
                await asyncio.sleep(0.0002)
            calibrate(start.elapsed_time(done) / 1e3)

        task = asyncio.get_running_loop().create_task(fence())
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    # ---- bookkeeping --------------------------------------------------

    def _append_token(self, seq: Sequence, token: int, logprob: Optional[float] = None,
                      tops: Optional[list] = None) -> None:
        """Emit one token; the first after an admission carries
        `first_meta`. A sequence that asked for logprobs gets the token's
        logprob, the running sum and, with `top_logprobs`, its
        alternatives as [[id, logprob], ...]."""
        seq.blocks.extend([token])
        if seq.spec is not None:
            seq.spec.extend([token])
        seq.generated += 1
        if seq.generated == 1:
            seq.t_first_emit = time.perf_counter()
            if tracing.enabled():
                tracing.instant("seq.first_token", cat="lifecycle", req=seq.ctx.id,
                                ts=seq.t_first_emit)
            if seq.preloaded is None:
                self._note_prefill_rate(seq)
        frame = EngineOutput(token_ids=[token])
        if seq.want_logprobs:
            if logprob is not None:
                seq.cum_logprob += logprob
            frame.log_probs = [logprob]
            frame.cum_log_probs = seq.cum_logprob
            if tops is not None:
                frame.top_log_probs = [tops]
        if seq.first_meta is not None:
            frame.meta = seq.first_meta
            seq.first_meta = None
        seq.out_queue.put_nowait(frame.to_dict())
        reason = seq.check_finish(token)
        if reason:
            self._finish(seq, reason)

    def _register_full_pages(self, seq: Sequence) -> None:
        """Register the sequence's full pages whose KV is computed under
        their block hashes (emits `stored`). `num_computed` advances only
        past positions holding emitted tokens, so a rejected draft's KV,
        the pipeline's overshoot positions and a partial page are never
        registered."""
        full = seq.num_computed // self.page_size
        cap = seq.cacheable_pages(self.page_size)
        if cap is not None:
            full = min(full, cap)
        start = seq.registered_pages
        if full <= start:
            return
        blocks = seq.blocks.blocks[start:full]
        self.allocator.register(
            seq.page_ids[start:full],
            [(b.sequence_hash, b.local_hash) for b in blocks],
            parent_hash=blocks[0].parent_sequence_hash,
        )
        seq.registered_pages = full

    def _finish(self, seq: Sequence, reason: str) -> None:
        self._register_full_pages(seq)
        try:
            # an injected failure here leaks the pages: the references
            # stay up, the ledger holding stays with the finished request,
            # and the next audit must flag the orphan
            faults.fire("engine.release")
        except faults.FaultError:
            log.warning("fault injected: leaking %d KV page(s) of %s",
                        len(seq.page_ids), seq.ctx.id)
        else:
            self._kv_drop(seq.page_ids, seq.ctx.id)
            self.allocator.release(seq.page_ids)
        seq.page_ids = []
        if seq.slot >= 0:
            self._overrides.pop(seq.slot, None)
            self._carry_ok[seq.slot] = False
            self.slots[seq.slot] = None
            seq.slot = -1
        if seq in self._prefilling:
            self._prefilling.remove(seq)
        seq.prefilling = False
        self._note_finished(seq, reason)
        seq.out_queue.put_nowait(EngineOutput.final(reason).to_dict())
        self._wake.set()

    def _note_finished(self, seq: Sequence, reason: str) -> None:
        """Request-level observability at finish: the request's
        submit-to-finish span, the ledger's orphan watch, and the finish
        summary for `subscribe_requests` observers."""
        now = time.perf_counter()
        # the span before the observers: an observer may dump a forensic
        # artifact for this very request (an SLO breach), whose trace slice
        # must hold it
        if tracing.enabled() and seq.t_submit:
            tracing.complete("request", seq.t_submit, now, cat="request", req=seq.ctx.id,
                             finish_reason=reason, prompt_tokens=seq.prompt_len,
                             tokens=seq.generated)
        # orphan watch: a request still holding pages after its release
        # path ran is flagged by the next audit under its id
        self.kv_ledger.request_finished(seq.ctx.id)
        if not self._request_observers:
            return
        summary = {
            "request_id": seq.ctx.id,
            "finish_reason": reason,
            "prompt_tokens": seq.prompt_len,
            "tokens": seq.generated,
            "tenant": seq.tenant,
            "prefix": {"reused_blocks": seq.blocks_reused,
                       "restored_blocks": seq.blocks_restored,
                       "declined_blocks": seq.blocks_declined,
                       "gate_reason": seq.gate_reason},
            "queue_wait_s": (seq.t_admit - seq.t_submit
                             if seq.t_admit and seq.t_submit else None),
            "ttft_s": (seq.t_first_emit - seq.t_submit
                       if seq.t_first_emit and seq.t_submit else None),
            "itl_s": ((now - seq.t_first_emit) / (seq.generated - 1)
                      if seq.t_first_emit and seq.generated > 1 else None),
        }
        for cb in self._request_observers:
            try:
                cb(summary)
            except Exception:
                log.exception("request observer failed")
