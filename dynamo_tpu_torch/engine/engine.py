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
from dynamo_tpu_torch.llm.protocols.common import (
    FINISH_REASON_CANCELLED,
    FINISH_REASON_ERROR,
    FINISH_REASON_LENGTH,
    EngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops.rope import rope_inv_freq
from dynamo_tpu_torch.ops.sampling import sample_tokens
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
                progressed = self._admit_new()
                progressed |= await self._prefill_tick()
                bld = self._maybe_dispatch_decode()
                if bld is not None:
                    self._run_decode(*bld)
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

    # ---- decode -------------------------------------------------------

    def _maybe_dispatch_decode(self):
        """Host-side build of the next decode dispatch (cancellation sweep,
        page growth, input arrays); None when nothing is decode-ready."""
        if self._closed:
            return None
        ready = [
            (i, s) for i, s in enumerate(self.slots)
            if s is not None and not s.prefilling
        ]
        for _, s in ready:
            if s.ctx.is_stopped():
                self._finish(s, FINISH_REASON_CANCELLED)
        ready = [(i, s) for i, s in ready if self.slots[i] is s]
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
        steps = self.config.decode_steps
        max_pos = self.config.max_model_len - 1
        for _, seq in ready:
            if seq.slot < 0 or self.slots[seq.slot] is not seq:
                continue  # preempted by an earlier growth this pass
            if not self._ensure_pages_through(seq, min(seq.device_pos + steps - 1, max_pos)):
                return None
        active = [(i, s) for i, s in ready if self.slots[i] is s and not s.prefilling]
        if not active:
            return None
        width = min(max(8, _pow2(1 + max(i for i, _ in active))), len(self.slots))
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
        return active, steps, tokens, pos_act, temp, topk, topp

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

    # ---- bookkeeping --------------------------------------------------

    def _append_token(self, seq: Sequence, token: int) -> None:
        seq.tokens.append(token)
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
