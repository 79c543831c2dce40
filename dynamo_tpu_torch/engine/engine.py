"""TorchEngine: the continuous-batching execution loop, in PyTorch.

Port of `dynamo_tpu/engine/engine.py::JaxEngine`, main path only:

- admission into fixed decode slots, pages reserved up front and grown
  one at a time during decode (preempting the newest sequence when the
  pool runs dry; it re-prefills on re-admission);
- bucketed chunked prefill: same-bucket chunks of several sequences share
  one [n, bucket] dispatch; each layer writes the chunk's KV pages with
  the page-scatter kernel, then runs flash attention over the pool;
- multi-step decode: `decode_steps` tokens per dispatch in a device-side
  loop (sampled tokens feed the next step without a host sync); each
  layer runs the fused write + decode attention kernel;
- KV pools in the model's dtype, or int8 with per-token-per-kv-head f32
  scale pools (`kv_quantization="int8"`), or nibble-packed int4 (two codes
  a byte) with the same scale pools (`kv_quantization="int4"`), which the
  int8 and int4 forms of the three kernels read and write;
- on-device sampling: greedy, temperature, top-k, top-p;
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
- streamed `EngineOutput` frames, finishing on max_tokens or EOS.

The engine runs on a CUDA device unless the caller asks for the CPU, where
every kernel wrapper takes its plain PyTorch version. The host loop is
single-threaded asyncio and owns the allocator, slots and queues. Decode
dispatch and sync are serialized (the step pipeline is later work).

Uniform step invariant (as in the reference): a decoding sequence has KV
for exactly `total_tokens - 1` positions; the newest sampled token is fed
back and its KV written by the next step. Prefill computes KV for every
current token and samples the next, so admission and preemption-resume
are the same path.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import AsyncIterator, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.allocator import PageAllocator
from dynamo_tpu_torch.engine.config import EngineConfig
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
    PreprocessedRequest,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops.rope import rope_inv_freq
from dynamo_tpu_torch.ops.sampling import sample_tokens, verify_draft_tokens
from dynamo_tpu_torch.runtime.pipeline.context import Context

log = logging.getLogger("dynamo_tpu_torch.engine")


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class TorchEngine:
    """Paged continuous-batching engine on one device.

    Conforms to the pipeline engine protocol: `await generate(Context) ->
    AsyncIterator[dict]` streaming EngineOutput dicts (token ids; the
    detokenizing backend sits downstream).
    """

    def __init__(self, config: EngineConfig, params=None, device=None):
        self.config = config
        self.model_cfg = config.model_config()
        if self.model_cfg.num_experts:
            raise NotImplementedError("MoE models are not ported to dynamo_tpu_torch yet")
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
            else:
                params = llama.init_params(
                    self.model_cfg, config.seed, dtype=self._dtype, device=self.device
                )
        else:
            params = {
                k: (
                    [{n: w.to(self.device) for n, w in lp.items()} for lp in v]
                    if k == "layers" else v.to(self.device)
                )
                for k, v in params.items()
            }
        self.params = params
        self.param_count = llama.param_count(params)

        self.page_size = config.page_size
        self.num_pages = config.num_pages or self._auto_num_pages()
        self.kv = llama.init_kv_cache(
            self.model_cfg, self.num_pages * self.page_size, dtype=self._dtype,
            device=self.device, kv_quant=config.kv_quantization, page_size=self.page_size,
        )
        self.allocator = PageAllocator(self.num_pages, self.page_size)
        self._inv_freq = torch.from_numpy(rope_inv_freq(self.model_cfg)).to(self.device)

        self.waiting: deque[Sequence] = deque()
        self.slots: list[Optional[Sequence]] = [None] * config.max_batch_size
        self._prefilling: deque[Sequence] = deque()
        self._host_tables = np.zeros(
            (config.max_batch_size, config.max_pages_per_seq), np.int32
        )
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed ^ 0x5EED)
        # set once a request carries a deadline: until then no tick reads
        # the clock for the deadline sweeps
        self._has_deadlines = False
        # engine-side phase accounting (host walls around dispatch calls
        # that end in a device->host fetch, so they include device time)
        self._phase_stats = {
            "prefill_dispatch_s": 0.0,
            "prefill_tokens": 0,
            "prefill_dispatches": 0,
            "decode_dispatch_s": 0.0,
            "decode_tokens": 0,
            "decode_dispatches": 0,
            "preemptions": 0,
            # mixed prefill+decode steps: dispatches, decode rows carried,
            # prefill tokens carried, the largest step's budget tokens
            # (decode rows count 1 + drafts) and its verify rows
            "mixed_dispatch_s": 0.0,
            "mixed_steps": 0,
            "mixed_decode_rows": 0,
            "mixed_prefill_tokens": 0,
            "mixed_step_tokens_max": 0,
            "mixed_spec_rows": 0,
            # speculative verify: standalone dispatches, and rows, drafted,
            # accepted and emitted tokens over standalone and mixed verify
            "spec_dispatch_s": 0.0,
            "spec_dispatches": 0,
            "spec_rows": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "spec_emitted": 0,
            # requests shed past their deadline before admission (at
            # generate or from the queue), and running ones finished by it
            "deadline_shed": 0,
            "deadline_timeouts": 0,
        }

    def _check_kernel_shapes(self) -> None:
        """Refuse at construction what the CUDA kernels do not take, rather
        than failing the first request. The int8 and int4 kernels (K5-K7)
        take the shapes their bf16 counterparts (K1-K3) take: bf16
        activations, these head dims and GQA groups, any page size."""
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

    def _auto_num_pages(self) -> int:
        cfg, m = self.config, self.model_cfg
        if cfg.kv_quantization == "int8":
            # 1-byte K and V rows plus one f32 K and V scale per kv head
            token_bytes = 2 * m.num_kv_heads * (m.head_dim + 4)
        elif cfg.kv_quantization == "int4":
            # two codes a byte, plus the same scales
            token_bytes = 2 * m.num_kv_heads * (m.head_dim // 2 + 4)
        else:
            token_bytes = (2 * m.num_kv_heads * m.head_dim
                           * torch.empty((), dtype=self._dtype).element_size())
        page_bytes = m.num_layers * cfg.page_size * token_bytes
        fallback = cfg.max_batch_size * cfg.max_pages_per_seq + 17
        if self.device.type != "cuda":
            return fallback
        free, _total = torch.cuda.mem_get_info(self.device)
        n = int(free * cfg.hbm_utilization // page_bytes)
        return max(n, 2) if n > 0 else fallback

    @property
    def phase_stats(self) -> dict:
        return dict(self._phase_stats)

    # ------------------------------------------------------------------
    # requests

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        if self._closed:
            raise RuntimeError("engine is closed")
        payload = request.payload
        pre = (
            PreprocessedRequest.from_dict(payload)
            if isinstance(payload, dict) else payload
        )
        self._refuse_unported(pre)
        if len(pre.token_ids) == 0:
            raise ValueError("empty prompt")
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
        seq = Sequence.from_request(request, pre, self.config.max_model_len)
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

    @staticmethod
    def _refuse_unported(pre: PreprocessedRequest) -> None:
        so = pre.sampling_options
        unported = {
            "n > 1": so.n not in (None, 1),
            "frequency_penalty": bool(so.frequency_penalty),
            "presence_penalty": bool(so.presence_penalty),
            "repetition_penalty": so.repetition_penalty not in (None, 1.0),
            "seed": so.seed is not None,
            "logprobs": bool(so.logprobs) or bool(so.top_logprobs),
            "prompt_embeds": pre.prompt_embeds is not None,
            "disagg": bool(pre.disagg),
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"request asks for {', '.join(asked)}: not ported to "
                "dynamo_tpu_torch yet (see ROADMAP.md)"
            )

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._loop())

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._loop_task:
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
        for seq in list(self.waiting) + [s for s in self.slots if s]:
            seq.out_queue.put_nowait(
                EngineOutput.final(FINISH_REASON_CANCELLED).to_dict()
            )

    # ------------------------------------------------------------------
    # main loop

    async def _loop(self) -> None:
        try:
            while not self._closed:
                # queue members past their deadline leave before they can
                # claim a slot or pages
                progressed = self._shed_expired_waiting()
                progressed |= self._admit_new()
                # stall-free mixed step first: when it runs, the normal
                # prefill and decode ticks stand down this tick
                mixed = self.config.mixed_batching and self._mixed_tick()
                if mixed:
                    progressed = True
                else:
                    progressed |= await self._prefill_tick()
                    bld = self._maybe_dispatch_decode()
                    if bld is not None:
                        run, args = bld
                        run(*args)
                        progressed = True
                if progressed:
                    await asyncio.sleep(0)
                    continue
                self._wake.clear()
                if self._closed:
                    return
                await self._wake.wait()
        except Exception:
            log.exception("engine loop crashed; failing all requests")
            for seq in list(self.waiting) + [s for s in self.slots if s]:
                seq.out_queue.put_nowait(EngineOutput.final(FINISH_REASON_ERROR).to_dict())
            self.waiting.clear()
            self.slots = [None] * len(self.slots)
            self._prefilling.clear()
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
            seq.out_queue.put_nowait(EngineOutput.final(FINISH_REASON_TIMEOUT).to_dict())
        return bool(expired)

    def _sweep_expired(self, seq: Sequence, now: float) -> bool:
        """Finish an admitted sequence whose deadline has passed."""
        if not seq.past_deadline(now):
            return False
        self._phase_stats["deadline_timeouts"] += 1
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
            self.slots[slot] = seq
            self._mark_slot_tables(seq)
            if self.config.spec_decode and seq.spec is None:
                # seed the n-gram index with the prompt once; it survives
                # preemption (the history it covers does not change)
                seq.spec = NgramProposer(
                    self.config.spec_ngram_max, self.config.spec_index_window)
                seq.spec.extend(seq.tokens)
            self._prefilling.append(seq)
            progressed = True
        return progressed

    def _reserve_pages(self, seq: Sequence) -> bool:
        """Allocate pages covering all current tokens (prefix-cache reuse
        is not ported yet: every admission computes its whole prompt)."""
        need = -(-seq.total_tokens // self.page_size)
        fresh = self.allocator.allocate(need)
        if fresh is None:
            return False
        seq.page_ids = fresh
        seq.num_computed = 0
        return True

    def _mark_slot_tables(self, seq: Sequence) -> None:
        row = self._host_tables[seq.slot]
        row[:] = 0
        n = min(len(seq.page_ids), row.shape[0])
        row[:n] = seq.page_ids[:n]

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
        for bucket, seqs in groups.items():
            progressed = True
            toks = self._prefill_group_dispatch(seqs, bucket)
            for j, seq in enumerate(seqs):
                seq.num_computed += min(seq.total_tokens - seq.num_computed, bucket)
                if seq.num_computed >= seq.total_tokens:
                    seq.prefilling = False
                    seq.device_pos = seq.num_computed
                    self._append_token(seq, toks[j])
                else:
                    self._prefilling.append(seq)
        await asyncio.sleep(0)
        return progressed

    @torch.inference_mode()
    def _prefill_group_dispatch(self, seqs: list[Sequence], bucket: int) -> list[int]:
        """One chunk for each sequence in ONE [n, bucket] model step (n
        padded to a power of two; padding rows write the trash page and
        attend nothing). Returns the sampled tokens (valid for rows whose
        chunk was final) on the host."""
        ps = self.page_size
        n = _pow2(len(seqs))
        tok_arr = np.zeros((n, bucket), np.int32)
        pos_arr = np.zeros((n, bucket), np.int32)
        last_idx = np.zeros(n, np.int64)
        t_valid = np.zeros(n, np.int32)
        temp = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int32)
        topp = np.ones(n, np.float32)
        wtables = np.zeros((n, -(-bucket // ps)), np.int32)
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
            last_idx[j] = chunk - 1
            t_valid[j] = chunk
            temp[j] = seq.temperature
            topk[j] = seq.top_k
            topp[j] = seq.top_p
        t0 = time.perf_counter()
        dev = self.device
        pos_t = torch.from_numpy(pos_arr).to(dev)
        attn = llama.AttnSpec.page_write(
            torch.from_numpy(wtables.reshape(-1)).to(dev),
            torch.from_numpy(btables).to(dev), pos_t[:, 0].contiguous(),
            torch.from_numpy(t_valid).to(dev), ps,
        )
        hidden, _ = llama.forward(
            self.params, self.model_cfg, torch.from_numpy(tok_arr).to(dev), pos_t,
            self.kv, attn, inv_freq=self._inv_freq,
        )
        last_h = hidden[torch.arange(n, device=dev), torch.from_numpy(last_idx).to(dev)]
        lg = llama.logits(self.params, self.model_cfg, last_h)
        toks = sample_tokens(
            lg, self._gen, torch.from_numpy(temp).to(dev),
            torch.from_numpy(topk).to(dev), torch.from_numpy(topp).to(dev),
            all_greedy=bool((temp <= 0.0).all()),
        ).tolist()
        st = self._phase_stats
        st["prefill_dispatch_s"] += time.perf_counter() - t0
        st["prefill_dispatches"] += 1
        st["prefill_tokens"] += int(t_valid.sum())
        return toks

    # ---- mixed prefill+decode steps (stall-free batching) -------------

    def _select_mixed_prefill(self, leftover: int) -> list:
        """Strict FIFO prefix of the prefill queue fitting `leftover` budget
        tokens, as (seq, chunk) picks; a non-final chunk rounds down to a
        page multiple (the next chunk must start page-aligned). Scanning
        stops at the first sequence that cannot join: skipping it would
        let later arrivals jump the queue."""
        picks = []
        for seq in self._prefilling:
            if leftover < 1 or seq.ctx.is_stopped():
                break  # the normal tick's sweep owns cancellation
            need = seq.total_tokens - seq.num_computed
            chunk = min(need, self.config.prefill_chunk, leftover)
            if chunk < need:
                chunk -= chunk % self.page_size
            if chunk < 1:
                break
            picks.append((seq, chunk))
            leftover -= chunk
        return picks

    def _mixed_tick(self) -> bool:
        """One stall-free mixed step when decode-ready rows and pending
        prefill chunks coexist: both advance in one token-budgeted step, so
        an admission wave never parks running streams for longer than one
        step. Decode rows cost 1 budget token each (1 + k with drafts) and
        prefill chunks shrink into the leftover. Returns True when a step
        ran (the normal prefill and decode ticks then stand down), False
        when the normal paths should run. A failed step raises: the loop's
        crash path fails the requests, and no quiet retreat to the normal
        paths hides a broken kernel."""
        if self._closed or not self._prefilling:
            return False
        cfg = self.config
        rows = self._decode_ready_rows()
        if not rows:
            return False
        # spec x mixed: decode rows carry their n-gram drafts as verify
        # rows of q_len 1 + k; drafts trade off against the chunks
        drafts: dict[int, list[int]] = {}
        if cfg.spec_decode and cfg.mixed_spec:
            k_cap = min(cfg.spec_k_max, cfg.prefill_chunk - 1)
            for i, seq in rows:
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
                return False  # the budget cannot fit both planes
            picks = self._select_mixed_prefill(leftover)
        else:
            # chunks keep their size; decode rows join only if all fit
            picks = self._select_mixed_prefill(budget)
            dec_cost = shed_drafts_to(budget - sum(c for _, c in picks))
            if budget - sum(c for _, c in picks) < dec_cost:
                return False
        if not picks:
            return False
        # grow decode rows' pages through the positions this step writes;
        # growth may preempt (a participant too): re-filter both sides
        prep = self._grow_and_collect(
            rows, lambda seq: seq.device_pos + len(drafts.get(seq.slot, ())))
        if prep is None:
            return False
        rows = prep[0]
        picks = [(s, c) for s, c in picks if s.slot >= 0 and self.slots[s.slot] is s]
        if not picks:
            return False
        bld = self._build_mixed(rows, picks, drafts)
        for seq, _ in picks:
            self._prefilling.remove(seq)
        self._sync_mixed(bld, self._run_mixed_dispatch(bld))
        return True

    def _draft_room(self, seq: Sequence, k_cap: int) -> int:
        """Drafts a row may take: never past its emit budget (a verify
        step emits at most drafts + 1 tokens) or the last writable
        position."""
        remaining = seq.max_new_tokens - seq.generated
        room = self.config.max_model_len - 1 - seq.device_pos
        return min(k_cap, remaining - 1, room)

    def _build_mixed(self, rows: list, picks: list, drafts: dict) -> dict:
        """Host-side inputs of one mixed step: decode rows first (q_len 1,
        their last token, or a verify window [last, d_1..d_k] when spec
        composes), then one chunk per prefill pick. Rows pad to a power of
        two and columns to the chunk's prefill bucket; padding rows have
        q_len 0 and write the trash page, as do padding columns. Block
        tables are cut to the power-of-two bucket of the pages attended."""
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
        temp = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int32)
        topp = np.ones(n, np.float32)
        draft_arr = np.zeros((n, k_max), np.int32)
        dlen_arr = np.zeros(n, np.int32)
        entries = []  # (kind, slot, seq, tokens) per built row
        w_need = 1
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
            # past-budget positions write the trash page
            wslots[j, :kd + 1] = np.where(
                idx < max_len, pages[np.minimum(idx, max_len - 1) // ps] * ps + idx % ps, 0)
            last_idx[j] = kd
            w_need = max(w_need, (seq.device_pos + kd) // ps + 1)
            entries.append(("dec", slot, seq, 1 + kd))
            j += 1
        for seq, chunk in picks:
            start = seq.num_computed
            idx = np.arange(start, start + chunk)
            tok_arr[j, :chunk] = seq.tokens[start:start + chunk]
            pos_arr[j, :chunk] = idx
            pages = np.asarray(seq.page_ids, np.int32)
            wslots[j, :chunk] = pages[idx // ps] * ps + idx % ps
            last_idx[j] = chunk - 1
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
            last_idx=last_idx, q_lens=q_lens, temp=temp, topk=topk, topp=topp,
            spec=use_spec, draft=draft_arr, dlen=dlen_arr, entries=entries,
            all_greedy=bool(all(e[2].temperature <= 0.0 for e in entries)),
        )

    @torch.inference_mode()
    def _run_mixed_dispatch(self, bld: dict):
        """Device half of a mixed step (`_mixed_model_step` of the
        reference, without the step pipeline's device carry): every row
        writes its KV through the row write, reads through K4 and samples
        at its last valid column. Returns the sampled tokens [n] on the
        host, or (out [n, k+1], n_emit [n]) when verify rows composed in:
        each row's logits over a (k+1)-wide window ending at its last
        column go through `verify_draft_tokens` (prefill rows have no
        drafts, so window column 0 is their plain sample and n_emit 1)."""
        t0 = time.perf_counter()
        dev = self.device
        n = bld["tokens"].shape[0]
        tokens = torch.from_numpy(bld["tokens"]).to(dev)
        positions = torch.from_numpy(bld["positions"]).to(dev)
        last_idx = torch.from_numpy(bld["last_idx"]).to(dev)
        temp = torch.from_numpy(bld["temp"]).to(dev)
        topk = torch.from_numpy(bld["topk"]).to(dev)
        topp = torch.from_numpy(bld["topp"]).to(dev)
        attn = llama.AttnSpec.ragged(
            torch.from_numpy(bld["tables"]).to(dev), positions[:, 0].contiguous(),
            torch.from_numpy(bld["q_lens"]).to(dev),
            torch.from_numpy(bld["wslots"].reshape(-1)).to(dev), self.page_size,
        )
        hidden, _ = llama.forward(self.params, self.model_cfg, tokens, positions,
                                  self.kv, attn, inv_freq=self._inv_freq)
        if bld["spec"]:
            dlen = torch.from_numpy(bld["dlen"]).to(dev)
            win = bld["draft"].shape[1] + 1
            offs = torch.clamp(
                (last_idx - dlen)[:, None] + torch.arange(win, device=dev),
                max=hidden.shape[1] - 1)
            win_h = torch.gather(
                hidden, 1, offs[:, :, None].expand(-1, -1, hidden.shape[-1]))
            out, n_emit = verify_draft_tokens(
                llama.logits(self.params, self.model_cfg, win_h),
                torch.from_numpy(bld["draft"]).to(dev), dlen, self._gen, temp, topk,
                topp, all_greedy=bld["all_greedy"])
            res = (out.cpu().numpy(), n_emit.cpu().numpy())
        else:
            last_h = hidden[torch.arange(n, device=dev), last_idx]
            res = sample_tokens(
                llama.logits(self.params, self.model_cfg, last_h), self._gen, temp,
                topk, topp, all_greedy=bld["all_greedy"]).cpu().numpy()
        self._phase_stats["mixed_dispatch_s"] += time.perf_counter() - t0
        return res

    def _sync_mixed(self, bld: dict, toks) -> None:
        """Land a mixed step: decode rows emit their next token (verify
        rows their accepted prefix plus one, rewinding like a standalone
        verify), final chunks their first token; non-final chunks go back
        to the end of the prefill queue."""
        spec_mode = bld["spec"]
        if spec_mode:
            out, n_emit = toks
        n_dec = n_dec_tokens = n_pf_tokens = 0
        spec_rows = drafted_total = accepted_total = emitted_total = 0
        for j, (kind, slot, seq, chunk) in enumerate(bld["entries"]):
            if kind == "dec":
                n_dec += 1
                n_dec_tokens += chunk
            else:
                n_pf_tokens += chunk
            if slot < 0 or seq.slot != slot or self.slots[slot] is not seq:
                continue  # finished or preempted while the step was built
            tok = int(out[j, 0]) if spec_mode else int(toks[j])
            if kind == "dec":
                if spec_mode:
                    drafted = int(bld["dlen"][j])
                    emitted, accepted = self._emit_verify_row(
                        slot, seq, out[j], int(n_emit[j]), drafted)
                    spec_rows += 1
                    drafted_total += drafted
                    accepted_total += accepted
                    emitted_total += emitted
                    continue
                seq.device_pos += 1
                seq.num_computed += 1
                self._append_token(seq, tok)
                continue
            seq.num_computed += chunk
            if seq.num_computed >= seq.total_tokens:
                # final chunk: the in-step sample is the first token
                seq.prefilling = False
                seq.device_pos = seq.num_computed
                self._append_token(seq, tok)
            else:
                self._prefilling.append(seq)
        st = self._phase_stats
        st["mixed_steps"] += 1
        st["mixed_decode_rows"] += n_dec
        st["mixed_prefill_tokens"] += n_pf_tokens
        st["mixed_step_tokens_max"] = max(
            st["mixed_step_tokens_max"], n_dec_tokens + n_pf_tokens)
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
        page growth, input arrays): (runner, args) of a speculative verify
        dispatch when drafts are worthwhile, else of a multi-step decode
        dispatch; None when nothing is decode-ready."""
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
        if self.config.spec_decode:
            bld = self._maybe_build_spec(ready)
            if bld is not None:
                return self._run_spec, (bld,)
        steps = self.config.decode_steps
        prep = self._grow_and_collect(ready, lambda seq: seq.device_pos + steps - 1)
        if prep is None:
            return None
        active, width = prep
        tokens = np.zeros(width, np.int32)
        pos_act = np.zeros((width, 2), np.int32)
        temp = np.zeros(width, np.float32)
        topk = np.zeros(width, np.int32)
        topp = np.ones(width, np.float32)
        for i, seq in active:
            tokens[i] = seq.last_token
            pos_act[i] = (seq.device_pos, 1)
            temp[i], topk[i], topp[i] = seq.temperature, seq.top_k, seq.top_p
            seq.device_pos += steps
        return self._run_decode, (active, steps, tokens, pos_act, temp, topk, topp)

    def _grow_and_collect(self, ready, upto):
        """Grow each row's pages through `upto(seq)` (clamped to the last
        writable position; may preempt), re-filter the rows that survived
        and bucket the dispatch width to the power-of-two prefix covering
        the highest active slot (at least 8). Returns (active, width), or
        None when a growth preempted its own sequence or nothing stayed
        decode-ready."""
        max_pos = self.config.max_model_len - 1
        for _, seq in ready:
            if seq.slot < 0 or self.slots[seq.slot] is not seq:
                continue  # preempted by an earlier growth this pass
            if not self._ensure_pages_through(seq, min(upto(seq), max_pos)):
                return None
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
            self._mark_slot_tables(seq)
        return True

    def _preempt(self, seq: Sequence) -> None:
        """Out of pages: release the sequence's pages and requeue it at the
        front; re-admission re-prefills prompt + generated tokens."""
        log.info("preempting seq %s (out of KV pages)", seq.seq_id)
        self._phase_stats["preemptions"] += 1
        self.allocator.release(seq.page_ids)
        self.slots[seq.slot] = None
        if seq in self._prefilling:
            self._prefilling.remove(seq)
        seq.slot = -1
        seq.prefilling = False
        seq.page_ids = []
        seq.num_computed = 0
        seq.device_pos = 0
        self.waiting.appendleft(seq)

    @torch.inference_mode()
    def _run_decode(self, active, steps, tokens, pos_act, temp, topk, topp) -> None:
        t0 = time.perf_counter()
        width = tokens.shape[0]
        dev = self.device
        out = self._decode_multi(
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos_act).to(dev),
            torch.from_numpy(self._host_tables[:width]).to(dev),
            torch.from_numpy(temp).to(dev), torch.from_numpy(topk).to(dev),
            torch.from_numpy(topp).to(dev),
            all_greedy=bool(all(s.temperature <= 0.0 for _, s in active)),
            steps=steps,
        ).tolist()  # the dispatch's one device->host sync
        st = self._phase_stats
        st["decode_dispatch_s"] += time.perf_counter() - t0
        st["decode_dispatches"] += 1
        st["decode_tokens"] += len(active) * steps
        for step in range(steps):
            for i, seq in active:
                if self.slots[i] is not seq:
                    continue  # finished earlier in this dispatch: overshoot
                seq.num_computed += 1
                self._append_token(seq, out[step][i])

    def _decode_multi(self, tokens, pos_act, block_tables, temp, topk, topp,
                      all_greedy: bool, steps: int) -> torch.Tensor:
        """`steps` decode iterations with on-device token feedback; returns
        the sampled tokens [steps, B]. Inactive rows attend nothing and
        write nothing (lengths 0, write_pos -1); positions past the model
        length budget (overshoot of finished rows) skip the write too."""
        positions = pos_act[:, 0]
        active = pos_act[:, 1].bool()
        max_len = self.config.max_model_len
        no = torch.full_like(positions, -1)
        outs = []
        for _ in range(steps):
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
            tokens = sample_tokens(lg, self._gen, temp, topk, topp, all_greedy=all_greedy)
            outs.append(tokens)
            positions = positions + 1
        return torch.stack(outs)

    # ---- speculative verify --------------------------------------------

    def _maybe_build_spec(self, ready):
        """Host side of a standalone verify dispatch: n-gram drafts for
        every decode-ready row and the [B, k_max + 1] window of each
        (its last token, then its drafts). None when drafts are not
        worthwhile: the batch must average at least one drafted token a
        row, since a verify dispatch is ONE model step for every row and
        rows without drafts fall from decode_steps tokens to one."""
        k_max = self.config.spec_k_max
        drafts: dict[int, list[int]] = {}
        for i, seq in ready:
            drafts[i] = seq.spec.maybe_draft(self._draft_room(seq, k_max))
        if sum(len(d) for d in drafts.values()) < max(1, len(ready)):
            return None
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
        act = np.zeros(b, bool)
        temp = np.zeros(b, np.float32)
        topk = np.zeros(b, np.int32)
        topp = np.ones(b, np.float32)
        for i, seq in active:
            d = drafts[i]
            act[i] = True
            tokens[i, 0] = seq.last_token
            tokens[i, 1:1 + len(d)] = d
            draft[i, :len(d)] = d
            dlen[i] = len(d)
            positions[i] = seq.device_pos + np.arange(t, dtype=np.int32)
            npg = min(len(seq.page_ids), w)
            tables[i, :npg] = seq.page_ids[:npg]
            temp[i], topk[i], topp[i] = seq.temperature, seq.top_k, seq.top_p
        return dict(tokens=tokens, positions=positions, tables=tables, draft=draft,
                    dlen=dlen, act=act, temp=temp, topk=topk, topp=topp, active=active,
                    all_greedy=bool((temp[act] <= 0.0).all()))

    @torch.inference_mode()
    def _spec_verify_step(self, bld: dict):
        """One verify step: every row carries 1 + draft_len tokens through
        the model in ONE forward (KV written first through the row write,
        so each draft attends its prefix; the read is K4 with q_len =
        draft_len + 1 from a mid-page q_pos0), then `verify_draft_tokens`
        emits the accepted prefix plus one. Rejected drafts leave garbage
        KV in slots past the accepted length: the causal mask hides it and
        the next step rewrites those slots before any query reaches them.
        Returns (out [B, T], n_emit [B]) on the host."""
        s = self.page_size
        dev = self.device
        tables = torch.from_numpy(bld["tables"]).to(dev)
        positions = torch.from_numpy(bld["positions"]).to(dev)
        dlen = torch.from_numpy(bld["dlen"]).to(dev)
        act = torch.from_numpy(bld["act"]).to(dev)
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
            self.params, self.model_cfg, torch.from_numpy(bld["tokens"]).to(dev),
            positions, self.kv, attn, inv_freq=self._inv_freq)
        out, n_emit = verify_draft_tokens(
            llama.logits(self.params, self.model_cfg, hidden),
            torch.from_numpy(bld["draft"]).to(dev), dlen, self._gen,
            torch.from_numpy(bld["temp"]).to(dev), torch.from_numpy(bld["topk"]).to(dev),
            torch.from_numpy(bld["topp"]).to(dev), all_greedy=bld["all_greedy"])
        return out.cpu().numpy(), n_emit.cpu().numpy()

    def _run_spec(self, bld: dict) -> None:
        """Dispatch a verify step and land it (`_sync_spec` of the
        reference): one `_emit_verify_row` per surviving row."""
        t0 = time.perf_counter()
        out, n_emit = self._spec_verify_step(bld)
        st = self._phase_stats
        st["spec_dispatch_s"] += time.perf_counter() - t0
        st["spec_dispatches"] += 1
        for i, seq in bld["active"]:
            if self.slots[i] is not seq:
                continue
            drafted = int(bld["dlen"][i])
            emitted, accepted = self._emit_verify_row(i, seq, out[i], int(n_emit[i]), drafted)
            st["spec_rows"] += 1
            st["spec_drafted"] += drafted
            st["spec_accepted"] += accepted
            st["spec_emitted"] += emitted

    def _emit_verify_row(self, slot: int, seq: Sequence, out_row, n: int,
                         drafted: int) -> tuple:
        """Land one verify row (standalone or inside a mixed step): emit
        the accepted prefix plus the corrected or bonus token, advancing
        num_computed and device_pos only past emitted tokens, so the KV a
        rejected tail left stays beyond the sequence's length and is
        rewritten before any query attends it. Returns (emitted,
        accepted)."""
        emitted = 0
        for j in range(n):
            if self.slots[slot] is not seq:
                break  # EOS or length mid-window: the tail is discarded
            seq.num_computed += 1
            seq.device_pos += 1
            self._append_token(seq, int(out_row[j]))
            emitted += 1
        # what landed: a draft that finished the stream discards the tail
        # and the bonus token, which must not count as accepted
        accepted = n - 1 if emitted == n else emitted
        if drafted:
            seq.spec.observe(drafted, accepted)
        return emitted, accepted

    # ---- bookkeeping --------------------------------------------------

    def _append_token(self, seq: Sequence, token: int) -> None:
        seq.tokens.append(token)
        if seq.spec is not None:
            seq.spec.extend([token])
        seq.generated += 1
        seq.out_queue.put_nowait(EngineOutput(token_ids=[token]).to_dict())
        reason = seq.check_finish(token)
        if reason:
            self._finish(seq, reason)

    def _finish(self, seq: Sequence, reason: str) -> None:
        self.allocator.release(seq.page_ids)
        seq.page_ids = []
        if seq.slot >= 0:
            self.slots[seq.slot] = None
            seq.slot = -1
        if seq in self._prefilling:
            self._prefilling.remove(seq)
        seq.prefilling = False
        seq.out_queue.put_nowait(EngineOutput.final(reason).to_dict())
        self._wake.set()
