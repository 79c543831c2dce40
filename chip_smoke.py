"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--pairs N] [--serving N]

Phases, each printed on its own line; any failure exits non-zero and the
final result line is printed only when every phase passed:

1. card and versions (nvidia-smi name and power limit, torch, CUDA);
2. build: the five CUDA sources under dynamo_tpu_torch/csrc (twenty-one
   kernels: K1-K3 for bf16 KV, K5-K7 in their int8, int4 and grouped int4
   forms;
   K4, the ragged read of mixed and verify steps, enters K2/K6 in each KV
   format; the four W8A8 kernels of w8a8.cu, quantize_rows,
   rms_norm_quantize_rows, silu_mul_quantize_rows and w8a8_gemm;
   and in probes.cu the probe kernels K8 page_copy, K9's
   unpack/pack/inject bitcasts and K10 page_gather, beside an empty
   kernel for the launch floor), one nvcc each, all in parallel;
3. each kernel against its plain PyTorch version on the same inputs, at
   Llama-3.1-8B per-layer shapes (K=8, Hd=128, H=32, B=8, chunk 512 over
   ~576 tokens, decode lengths 512-600; page 64, and page 128 for the int8
   and int4 kernels) and on small ragged cases (Hd 32 and 64; 1, 2 and 8
   query heads per kv head): KV writes byte-exact (pools and scale pools),
   attention within one bf16 ulp per element (see ATOL_F32), with
   CUDA-event times (median of 20) for the kernel, the plain version and
   one PyTorch library call computing the same function (each call queued
   behind a device-side spin, so the events time the device's work, not
   the host's launch), and the least time the card could take (bytes over
   memory rate or FLOPs over the bf16 peak). No PyTorch call takes int8 or
   int4 pages with scales, so the quantized kernels' library figure is
   SDPA over the gathered KV dequantized to bf16 beforehand, outside the
   timing. Each attention check shows on its own 8B inputs that plain
   versions gone wrong miss it (a causal edge one key late, a dropped key,
   a stale or bf16 new row, two heads' scales swapped, for int4 a high
   nibble read unsigned or nibbles taken as adjacent pairs, and for K2, K6
   and K4 at every 8B shape the probabilities rounded once to bf16, which
   the tensor-core kernel avoids by splitting them in two bf16 terms).
   K2, K6 and K4 also report their achieved TFLOP/s over the causal FLOPs
   the bound counts, their time over SDPA's, and the registers and spills
   ptxas gave their instantiation. K3 and K5, which split each row's keys
   over blocks and merge the splits inside the launch, are also held at
   the engine's own table width (W 32, most splits past the lengths), on
   one row of 2,000 keys, on rows ending at a split's edge and one past
   it, and at page size 24 (tiles across pages; with time and ptxas report
   beside), and each of their cases is
   launched twice on the same inputs and must give the same bits. K4, in all
   three forms, on three rectangles at 8B shapes, those the main path
   launches it at: a [9, 512] mixed step (four decode rows and two verify
   rows of 1 + 4 queries at mid-page positions, two chunk rows, a q_len 0
   row), a standalone verify dispatch [8, 5] (rows of 1 + k queries
   across page boundaries, idle rows) and a [8, 128] mixed step; and on
   small ragged cases. Its power is shown on the first two by a causal
   edge one key late and by verify rows whose last query lacks its newest
   key; it is timed on the first, beside K3/K5 on the same decode rows.
   The probe kernels, at the probe scripts' shapes (K10 also at
   profile_dma's sweep shapes) and at the 8B shape ([256 pages, 64,
   1024]; for K9 an int8 pool of 16384 x 1024): K8 and
   K9 byte-exact (K8 never writing page 0; K9's inject at byte lanes 0-3
   and the last row), K10 0.0 bit for bit on finite pools at every ring
   depth, NaN when a named page's row 0 holds a NaN or an infinity and
   0.0 when only another row or an unnamed page does; each timed beside
   its bound and one PyTorch call (index_copy_, the view/permute bitcast,
   index_select), and K10's scattered-page rate held under 1.05x the
   card's memory rate. Phase 3 starts with the launch floor: the time
   the same timing reads for an empty kernel, printed beside K9's inject.
   K1 and K7 are also timed flushed (128 MB written over the L2 before
   each call) beside their warm times, launched twice on copies of the
   same pools (the same bytes), and given a table with one id equal to
   num_pages (nothing written for it, the rest as the plain version
   writes it without that entry). Every KV write, attention and ragged
   check also runs at page size 3 with K 2 (an int8/int4 scale tile of 24
   bytes, not whole 16-byte vectors: K7 copies it in 4-byte words), the
   odd page size the engine serves. The W8A8 kernels (check_w8a8):
   quantize_rows at [8 | 64 | 4096] x [4096 | 14336] bf16, codes and
   scales byte-equal to the plain version (a zero row, .5 ties);
   rms_norm_quantize_rows at [8 | 64 | 4096] x 4096 and
   silu_mul_quantize_rows at [8 | 64 | 4096] x 14336, and both at M 1, 9,
   65, 130 by K 32, 4128 in bf16 and f32, with and without y: codes and
   scales byte-equal to quantize_rows_plain of the kernel's own y, the
   norm's y within one bf16 ulp of rms_norm (the count of elements one ulp
   off printed), SiLU x up's y against F.silu(gate) * up (the count that
   differ printed; byte-equal codes to the composition when none do),
   each timed beside its bound, its plain version and the composition it
   replaces (torch ops, then quantize_rows); w8a8_gemm at
   rows 8 and 4096 on the 8B projections (K, N) (4096, 4096), (4096,
   1024), (4096, 14336), (14336, 4096) in bf16 and on the head (4096,
   128256) at 8 rows in f32, byte-equal to the plain version; both on edge
   cases (f32 in and out, M 64 and 65 either side of the GEMM's variants,
   K % 128 in {32, 64, 96}, N 8 and N 1024 at K 14336 for the split-K
   extremes, N 68 and an odd N, rows past M, a 2,048-row mixed rectangle;
   each GEMM launched twice); each timed beside its plain version and
   bound (bytes, or 2MKN over the int8 rate), the GEMM also beside
   torch._int_mm on rows padded to 32 plus the dequantization as torch
   ops, and bf16 torch.matmul, decode rows also with the L2 evicted by a
   128 MB read; the GEMM variants' ptxas report and occupancy, the host
   cost of a call's tensor maps, and the decode chain (8 layers of 8B
   projections at 8 rows, with a layer's two norms and SiLU x up, in one
   CUDA graph: as torch ops then quantize_rows, every output byte-equal to
   the plain versions, and through the fused kernels, every output
   byte-equal to their eager run, whose codes equal quantize_rows_plain of
   their own y; `python -m dynamo_tpu_torch.scripts.trace_w8a8` traces
   it). And the KV quantizer
   (check_kv_division): quantize_kv_rows and quantize_kv_rows_int4 on the
   card byte-equal to the CPU in rows and scales at [2, 8, 1024] and
   [512, 1024], f32 and bf16, on heads whose amax is a division edge
   (f32 0.143 for / 127 and / 7), with the count of scales the parent's
   division by a Python scalar gets wrong on the same inputs;
4. real weights: the vendored trained checkpoint tests/data/tiny-trained-llama
   through the port's safetensors reader in bf16 on the GPU, with bf16,
   int8 and int4 KV; the greedy continuation of "the capital of france is"
   must start with "paris" and agree with the same engine run on the CPU
   in float32; then, in each KV format, three requests at once (one
   prefilling in chunks beside the others' decode rows, repetitive text)
   with mixed steps and speculative decoding on must stream what the
   engine streams with both off, through K4 and the launches the engine's
   dispatch counters imply; int8 KV also at page size 3. And the prefix
   cache: a prompt of 3 pages + 3 tokens served cold, then warm over its
   3 cached pages, must stream the same tokens in each KV format. The
   prompts are encoded by the port's tokenizer. Then the serving entry
   itself: `python -m dynamo_tpu_torch.run in=http out=torch --model-path
   tests/data/tiny-trained-llama` as a subprocess on the card, whose greedy
   streamed completion of the same prompt must equal the engine's text
   (a non-zero exit or a timeout fails). Last, W8A8 weights
   (quantization="int8") in bf16 and int8 KV: the card's greedy stream
   must equal the CPU port's bf16 W8A8 stream, through the W8A8 kernels'
   launches as the dispatch counters imply. Phases 4-8 run
   with the step pipeline on (the default): decode dispatches replay one
   CUDA graph each, N+1 queued behind N;
5. full width: llama-3.1-8b (32 layers, d 4096) in bf16 from seeded random
   weights, eight concurrent requests (ISL 512, OSL 64) through
   TorchEngine.generate, with the step pipeline off, then on. Launch
   counters are zeroed just before and read just after: each kernel of the
   path must have run, the expected number of times (a graph replay counts
   the launches its capture recorded), and no other kernel and no plain
   version may have run. Then the graph check: the last decode dispatch
   run eagerly on cloned pools and replayed on the originals must give the
   same tokens, byte-equal pools and the same launch counts. `[profile]`
   traces one more round and prints its `cudaLaunchKernel` and
   `cudaGraphLaunch` calls, device busy share, decode step ms, TTFT and
   output tokens/s;
6. the same at full width with int8 KV (kv_quantization="int8"), on phase
   5's weights: K5-K7 in their int8 forms run, no other kernel and no
   plain version does;
7. the same with int4 KV (kv_quantization="int4"): K5-K7 in their int4
   forms only;
8. an admission wave at full width on phase 5's weights and engine
   settings: four held requests (ISL 512, OSL 128) stream, and once each
   has 8 tokens four more (ISL 512, OSL 64) arrive. bf16 KV with mixed
   steps and speculative decoding off; then on, with the step pipeline off
   and then on; int8 and int4 KV with all three on. Each run asserts the launches its dispatch counters imply (K4 once a
   layer per mixed step and verify dispatch) and no plain call, and prints
   the wave's TTFT, the held streams' longest silence and tokens/s inside
   the wave, and the mixed and spec counters.
9. the probe path: the three probe scripts (dynamo_tpu_torch/scripts/
   proto_page_write, probe_bitcast, profile_dma) run in process what their
   main() runs on a GPU, with the launch counters zeroed just before and
   read just after; every probe kernel must have launched, and K10's
   rates there stay under 1.05x the card's memory rate;
10. the prefix cache and the prefix wire at full width, on phase 5's
   weights and engine settings with the step pipeline on, in bf16, int8
   and int4 KV: a seeded shared prefix of 448 tokens (7 pages); one request
   of prefix + 64 tokens alone (cold), then eight of prefix + 64 tokens of
   their own at once (ISL 512, OSL 64), each reusing the 7 pages, then the
   first prompt again (all 8 of its pages cached: the last is released and
   recomputed, a full hit at the page boundary). The shared pages' bytes
   (K, V and scales, every layer) must be unchanged by the warm round and
   each prefix hash stored once; `export_prefix` -> `clear_cache` (its
   removed event) -> `ingest_prefix` must land the 448 tokens through
   K1/K7 once a layer with no plain call, a second export must be
   byte-equal to the first, and a request after it must reuse 448 tokens.
   Each serving window launches what the dispatch counters imply. Prints
   cold and warm TTFT, prefill tokens computed, decode step ms, host ms
   hashing a prompt's blocks, and the share of the warm tokens equal to a
   cold serve of the same eight prompts (not gated: at random 8B weights
   the cold and warm prefills run GEMMs of other row counts).
11. the serving entry at full width: a model dir naming the llama-3.1-8b
   preset (seeded random weights, no safetensors) with a synthetic
   WordLevel tokenizer of 128,256 words (three specials, the template's
   words, then one word per id) and a chat template; the server started
   through `dynamo_tpu_torch.run`'s `build_parser` and `serve_http` with
   phase 5's engine flags (bf16 KV, step pipeline on) in this process's
   event loop, driven by the port's raw-socket client: a warm-up round,
   then eight concurrent streamed completions (ISL 512, OSL 64,
   ignore_eos) with the launch counters zeroed just before and read just
   after (K1-K3 as the dispatch counters imply, no plain call), one chat
   request through the template, and the same ids straight through
   `engine.generate`. Gates HTTP 200, SSE that parses and ends with
   [DONE], 64 tokens a stream with finish reason length and every word
   mapping back to an id; prints TTFT through HTTP and direct, host ms to
   render and to tokenize a prompt, us a token to detokenize and frame,
   output tok/s over the wall, the event loop's largest lag and the share
   of HTTP tokens equal to the direct ones (not gated); then the same
   host costs on a synthetic ByteLevel BPE of 128,256 tokens (the path a
   Llama-class tokenizer.json takes), its encode cold and warm.
12. the rest of M4 at full width, on phase 5's weights and engine (bf16
   KV, pipeline on), after phase 10. First the extended sampler on the
   card against its CPU version on the same [8, 128256] f32 logits:
   penalties within one f32 ulp, logprobs and top-8 within 1e-5, the
   seeded hash's uniforms bit for bit, seeded draws and count rows equal,
   and its time beside the plain sampler's. Then rounds of 8 requests (ISL
   512, OSL 64), each served once to run and capture its decode graph and
   once measured: plain greedy; frequency_penalty 2.0 (fewer repeats than
   the plain streams, or none); logprobs with top_logprobs 5 (each
   token's logprob its top-1's, all <= 0, tops sorted, cum_log_probs the
   running sum); 8 seeded sampled rows, which must stream the same served
   again in two other batch compositions; and plain, penalized and
   logprob rows together. Each round asserts the launches its dispatch
   counters imply and no plain call, and prints the graph keys it added
   and its decode step ms against the plain round's; then `graph_check`
   over every greedy graph (count rows and logprob carries restored
   between the eager run and the replay), each graph's device ms a step
   replayed alone (two passes in turns, CUDA events), the number of
   graphs, the graph pool's bytes and the count buffer's.
13. W8A8 weights at full width, after phase 12: phase 5's bf16 weights
   quantized in place layer by layer (each bf16 layer freed once its codes
   exist), then phase 5's traffic (8 x ISL 512 / OSL 64, greedy, pipeline
   on) in bf16 KV and then int8 KV, as phase 5 serves it: the launches
   the dispatch counters imply (per model step of a SiLU model:
   rms_norm_quantize_rows 2 a layer, silu_mul_quantize_rows 1 a layer,
   quantize_rows 1 a layer and 1 for the head, w8a8_gemm 7 a layer and
   1), no plain call, the graph
   check on the W8A8 decode graph and the profile. Prints the weight bytes
   against bf16, the KV pages the auto-sizer would pick with either, and
   the decode step, prefill dispatch, TTFT and peak memory beside phase
   5's (6's for int8 KV), and the share of greedy tokens equal to phase
   5's (not gated).
14. M11's in-process KV movement at full width, after phase 13, on phase
   5's weights (made again from seed 0) and engine with a host pool of 64
   pages (16 a gather), pipeline on, in bf16 KV and then int8 KV
   (`phase_offload`): three rounds of a prompt (a fresh 448-token prefix
   + 64 tokens, OSL 64) served cold, then, once the host pool holds its 8
   pages (a bounded 10 s wait; each host buffer byte-equal to its pool
   page), warm from HBM, then after `clear_cache` restored from the host
   (7 pages; the stream must equal the HBM-warm one); eight requests over
   a restored prefix; `prefill_only(device_arrays=True)` on 4 prompts of
   ISL 512 into `generate_remote` on a second engine on the same weights
   (64 pages), each stream equal to the first engine's own serve;
   `device_transfer_kv` of a prompt's pages, byte-equal. No restore may
   fail, and each window's K1/K7 launches must equal what its prefill
   dispatches, restores, injections and transfers imply, with no plain
   call. Prints the copy-out and copy-in GB/s, the transfer's GB/s
   against the card's memory rate, TTFT p50 cold, HBM-warm and restored,
   peak memory and the pinned bytes.
15. the sparse-MoE family (models/moe.py) at full width, after phase 14's
   engines are collected: Mixtral-8x7B's widths (d 4096, F 14336, 8
   experts, top 2, 32 heads over 8 KV heads of 128) at 16 of its 32 layers
   (the 32 hold 92.9 GB, over the card's 80), bf16 from seeded random
   weights. First one layer at 8 and 4,096 rows: routing (experts and keep
   masks) equal to the f64 CPU computation on the same bf16 inputs but at
   f64 near-ties (MOE_TIE_GAP), the output within MOE_ELEM_RMS of each
   row's RMS and MOE_NORM_REL overall (every row at 8, every 16th at
   4,096), two plain versions gone wrong (slot 1 dropped, weights not
   renormalised) shown to miss it, and each piece's device ms (router +
   top-k + capacity, dispatch, the gate, up and down bmm, SiLU x up,
   combine, the block) beside its bound. Then phase 5's traffic on the
   engine (page 64, 256 pages, prefill_chunk 512, decode_steps 8, batch 8,
   pipeline on) in bf16, int8 and int4 KV, phase 8's wave with mixed steps
   and speculative decoding on in bf16 KV, and the attention projections
   quantized in place (W8A8; router and experts stay bf16) in bf16 KV:
   each run the attention and KV kernels' launches its dispatch counters
   imply and no plain call, the graph check, and decode step ms, TTFT p50
   and max, output tok/s, peak memory and weight bytes.
16. prompt embeddings at full width, after phase 15, on phase 5's engine
   and weights (made again from seed 0): first the vision encoder
   (models/vision.py) at LLaVA-1.5's vision tower widths (CLIP ViT-L/14 at
   336 px: 576 patches, hidden 1024, 24 layers, 16 heads, projected to
   4096; the reference's block), seeded random weights in bf16, against
   the port's f32 encoder on the CPU on the same weights for two images
   (relative error and least patch cosine, VISION_REL_ERR and
   VISION_MIN_COS), and its time for 8 images beside its bound. Then, in
   bf16 and int8 KV: the oracle (a request whose embeds are the embed-table
   rows of its own 576 placeholder tokens streams exactly the plain
   request's 64 tokens, each served alone), 8 requests at once of 64
   shared text tokens + an image of its own + 64 text tokens (ISL 704: the
   span crosses the 512-token chunk boundary), OSL 64, each reusing only
   the shared text page, then 8 text-only prompts of the same ISL; the
   launches the dispatch counters imply and no plain call. Prints the
   encoder's ms, the host ms to take one request's embeds as lists and as
   an array, TTFT p50 beside the text-only prompts', decode step ms and
   output tok/s.
17. int4 KV in scale groups finer than head_dim, after phase 16 on its
   weights: the grouped forms of K7, K6, K5 and K4 against their plain
   versions at groups 8, 16, 32 and 64 (check_groups: K7 byte-exact with its
   S-channel scale tiles, at 8B page 64 and 128, small and page-3 cases;
   K6 at the 8B chunk and small cases, its plain version equal to K2's over
   the pools dequantized beforehand; K5 at 8B page 64 and W 32 and the
   split-edge, page-24 and page-3 cases, pools equal after the write, two
   launches bit-equal; K4 on RAGGED_CASES; attention within one bf16 ulp,
   each check's power shown by the probabilities rounded once to bf16, a
   high nibble scaled by its low nibble's group, one scale a head and, for
   K5, the new row attended in bf16), each timed beside its bound (codes
   plus S scale bytes) and SDPA over the KV dequantized beforehand; then
   phase 5's traffic with int4 KV in groups of 32 (pipeline on: exact
   launches, the graph check; decode step, TTFT p50 and the KV pool's bytes
   beside one-group int4's) and phase 8's wave with mixed steps and
   speculative decoding on in the same format (K4's grouped form).
18. the robustness and observability planes (M12) at the serving preset's
   width (llama-3.1-8b, random bf16 weights, phase 8's engine with the step
   pipeline, mixed steps and speculative decoding on), after phase 17 on its
   weights (`phase_planes`): phase 8's wave and a round of 8 (ISL 512, OSL
   64) at the defaults (flight recorder on, the 5 s KV audit) with tracing
   armed and with `flight_recorder=False, kv_audit_s=0` and tracing off,
   in turns (on, off, off, on):
   wave TTFT, the decode step's host walls and its device ms a token
   between two CUDA events, and the launches the dispatch counters imply
   with every plane on; one custody audit's host ms at the auto-sized pool
   (every page held; and at int4's page count on a host-only ledger); the
   watchdog (armed after the warm-up, 1 s budget) on an injected 4 s
   decode-enqueue stall: fired once, `step_pipeline` tripped, a crash
   artifact with digests and the trace ring, every stream whole, recovered
   after the 6 s re-probe; a failed mixed step contained in the wave
   (`mixed` disabled for good, no request failed); a skipped release found
   by the audit with one kv_leak artifact; and on the vendored checkpoint
   in bf16 the wave's greedy streams equal with and without the failed
   mixed step. Phase 11 ends with the four `/debug/*` routes through its
   server: a 3 s profile while eight streamed requests run (its Chrome
   trace must hold the `prefill`/`decode` annotations and name the KV
   write and the decode attention kernels), then the trace ring, a flight
   recorder snapshot and the KV ledger.
With --pairs N, phases 5, 6 and 7 (each a pipeline off/on pair) and
phase 8's bf16 pipeline off/on pair run N times in turns, to show their
spread. With --serving N only the build and phase 11 run, N times, and
no result line is printed (a measurement, not the smoke).

Then the smoke's wall time, a `kernels` JSON line (twenty-five kernels:
the nine, K4 in three forms, the four W8A8 kernels, the five probe
kernels and the grouped int4 forms of K7, K6, K5 and K4;
and `launch_floor_ms`), the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import glob
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "tests", "data", "tiny-trained-llama")
# Attention tolerance. The plain versions compute in f32 and round each
# output once to bf16. The decode kernels (K3/K5) do the same on the CUDA
# cores. The prefill kernel (K2/K6, and K4 through it) runs both products
# on the tensor cores with bf16 operands that are exact for what they carry
# (q, bf16 K and V rows, int8 and int4 codes), accumulates in f32, and
# feeds the probabilities (times the V scale) to P.V as two bf16 terms, hi
# and lo, which carry each to ~2**-17 of itself. So an element may differ
# by one bf16 ulp of itself where the two f32 results straddle a rounding
# boundary, plus what the summation orders and the split leave in f32
# (well under 2**-16 at these widths). A kernel that drops, adds or
# misplaces one key, or rounds the probabilities once to bf16, moves some
# output by far more; each attention check shows that on its own inputs.
ATOL_F32 = 2.0 ** -16

# published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s
PEAKS = {"SXM": (3.35e12, 989e12), "PCIe": (2.0e12, 756e12), "NVL": (3.9e12, 835e12)}


def log(*a):
    print(*a, flush=True)


def card_peaks(name: str):
    for key in ("NVL", "PCIe"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


# the timing helper of the probe scripts, dynamo_tpu_torch.scripts.time_ms
# (median CUDA-event time of 20 calls, each behind a device-side spin),
# bound by main() once the package is importable
time_ms = None


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x|: 2**(floor(log2|x|) - 7)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def compare_bf16(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Each element of `got` within one bf16 ulp (of the larger of the two
    values) plus ATOL_F32 of `want`. `max_ulps` is the largest error, in
    ulps of its element, over the elements that differ by more than
    ATOL_F32 (a rounding flip reads 1.0)."""
    g, w = got.float().flatten(), want.float().flatten()
    err = (g - w).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), w.abs()))
    off = err > ATOL_F32
    return {
        "ok": bool(torch.all(err <= ulp + ATOL_F32)),  # False on NaN
        "max_abs_err": err.max().item() if err.numel() else 0.0,
        "max_ulps": (err[off] / ulp[off]).max().item() if off.any() else 0.0,
        "n_off": int(off.sum()),
        "n": err.numel(),
        "max_abs_want": w.abs().max().item() if w.numel() else 0.0,
    }


def fmt(c: dict) -> str:
    return (f"max err {c['max_abs_err']:.3e} = {c['max_ulps']:.3f} ulp of its element "
            f"({c['n_off']} of {c['n']} elements differ; max|want| {c['max_abs_want']:.3f})")


def bound_ms(nbytes: float, flops: float, peaks) -> tuple[float, str]:
    bw, fl = peaks
    tb, tf = nbytes / bw * 1e3, flops / fl * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------- phase 3


def _pools(num_pages, page, kw, gen, dev):
    shape = (num_pages * page, kw)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return k, v


def _tables(b, w, num_pages, gen, dev):
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * w] + 1
    return perm.reshape(b, w).to(torch.int32).contiguous()


def _write_repeats(name, label, write, plain, pools, table, srcs, num_pages):
    """K1/K7 beyond the plain version's bytes: two launches on copies of the
    same pools give the same bytes, and a table with one id equal to
    `num_pages` leaves the pools as the plain version leaves them without
    that entry (no byte outside the other named pages changes). Page 0 is
    named once in `table`, so every byte is compared. `write`/`plain` take
    (pools, table, source tensors)."""
    a, b = [x.clone() for x in pools], [x.clone() for x in pools]
    write(a, table, srcs)
    write(b, table, srcs)
    torch.cuda.synchronize()
    assert all(_same_bytes(x, y) for x, y in zip(a, b)), f"{name} {label}: two launches differ"
    j = len(table) // 2
    bad = table.clone()
    bad[j] = num_pages
    keep = torch.cat((torch.arange(j), torch.arange(j + 1, len(table)))).to(table.device)
    got, want = [x.clone() for x in pools], [x.clone() for x in pools]
    write(got, bad, srcs)
    plain(want, table[keep].contiguous(), [x[keep].contiguous() for x in srcs])
    torch.cuda.synchronize()
    assert all(_same_bytes(x, y) for x, y in zip(got, want)), \
        f"{name} {label}: a table with an id equal to num_pages wrote the wrong bytes"


def _write_times(kernel, flush, b_ms):
    """Warm (20 calls on the same pools, inside the L2) and flushed (the L2
    written over before each call) times of one KV write, and the share of
    its bound the flushed time reaches."""
    ms, cold = time_ms(kernel), time_ms(kernel, flush=flush)
    return ms, cold, f"{ms:.4f} ms warm, {cold:.4f} flushed ({100 * b_ms / cold:.0f} % of bound)"


def check_kv_write(peaks, gen, dev):
    from dynamo_tpu_torch.ops import kv_write as m
    from dynamo_tpu_torch.scripts import l2_evict

    def write(p, table, s):
        return m.paged_kv_write(p[0], p[1], table, s[0], s[1], page_size=page)

    def plain(p, table, s):
        return m.paged_kv_write_plain(p[0], p[1], table, s[0], s[1], page_size=page)

    flush = l2_evict(dev)
    for label, (num_pages, page, kw, n) in {
        "8b": (200, 64, 1024, 64), "small": (40, 16, 64, 7), "odd-p3": (40, 3, 64, 7),
    }.items():
        k, v = _pools(num_pages, page, kw, gen, dev)
        table = torch.randperm(num_pages - 1, generator=gen, device=dev)[:n].to(torch.int32) + 1
        table[-1] = 0  # a padding page into the trash page
        nk = torch.randn((n, page, kw), generator=gen, device=dev).to(torch.bfloat16)
        nv = torch.randn((n, page, kw), generator=gen, device=dev).to(torch.bfloat16)
        k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
        rk, _ = m.paged_kv_write(k1, v1, table, nk, nv, page_size=page)
        assert rk is k1
        m.paged_kv_write_plain(k2, v2, table, nk, nv, page_size=page)
        torch.cuda.synchronize()
        # byte-exact, trash page aside (several writers race on it)
        live = torch.ones(num_pages * page, dtype=torch.bool, device=dev)
        live[:page] = False
        same = torch.equal(k1[live].view(torch.int16), k2[live].view(torch.int16)) and torch.equal(
            v1[live].view(torch.int16), v2[live].view(torch.int16))
        assert same, f"kv_write {label}: pools differ from the plain version"
        changed = not torch.equal(k1, k)
        assert changed, f"kv_write {label}: pool not updated in place"
        _write_repeats("kv_write", label, write, plain, (k, v), table, (nk, nv), num_pages)
        if label == "8b":
            nbytes = 2 * 2 * n * page * kw * 2 + n * 4
            b_ms, by = bound_ms(nbytes, 0.0, peaks)
            ms, _, times = _write_times(
                lambda: m.paged_kv_write(k1, v1, table, nk, nv, page_size=page), flush, b_ms)
            plain_ms = time_ms(lambda: m.paged_kv_write_plain(k2, v2, table, nk, nv, page_size=page))
            kp1, vp1 = k1.view(num_pages, -1), v1.view(num_pages, -1)
            idx = table.long()
            fk, fv = nk.view(n, -1), nv.view(n, -1)

            def lib():
                kp1.index_copy_(0, idx, fk)
                vp1.index_copy_(0, idx, fv)

            lib_ms = time_ms(lib)
    log(f"[kernel] kv_write: byte-exact at 8B, small and page-3 shapes, two launches the same "
        f"bytes, "
        f"an id equal to num_pages skipped; {times} "
        f"(plain {plain_ms:.4f}, index_copy_ {lib_ms:.4f}, bound {b_ms:.4f} by {by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


def _sdpa_prefill_inputs(q, k_cache, v_cache, tables, pos0, tlen, page):
    from dynamo_tpu_torch.ops.attention import slots_from_pages

    b, t, h, hd = q.shape
    kh = k_cache.shape[1] // hd
    smat = slots_from_pages(tables, page).long()
    c = smat.shape[1]
    # dense gathered KV with the kv heads repeated for their query heads
    kk = k_cache[smat].reshape(b, c, kh, hd).transpose(1, 2).repeat_interleave(h // kh, 1)
    vv = v_cache[smat].reshape(b, c, kh, hd).transpose(1, 2).repeat_interleave(h // kh, 1)
    qq = q.transpose(1, 2).contiguous()
    q_pos = pos0.long()[:, None] + torch.arange(t, device=q.device)[None]
    mask = torch.arange(c, device=q.device)[None, None] <= q_pos[:, :, None]
    return qq, kk, vv, mask[:, None]


def _p_bf16_once(q, k_cache, v_cache, tables, pos0, tlen, ks=None, vs=None, *, page,
                 int4=False):
    """The plain computation of K2/K6/K4 with one change: the probabilities
    (times the V scale, for int8/int4 pools) rounded once to bf16 before
    the P.V product over the bf16 rows or the codes, as a tensor-core kernel
    without the hi/lo split would feed them. Rows past tlen are 0."""
    from dynamo_tpu_torch.ops.attention import slots_from_pages
    from dynamo_tpu_torch.ops.quant import gather_kv_scales, unpack_int4_kv

    b, t, h, hd = q.shape
    flat = slots_from_pages(tables, page).long().reshape(-1)
    c = flat.shape[0] // b
    if ks is None:
        kh = k_cache.shape[1] // hd
        k, vc = k_cache[flat].float(), v_cache[flat].float()
        vsc = torch.ones((flat.shape[0], kh), device=q.device)
    else:
        kh = ks.shape[1]

        def codes(x):
            return (unpack_int4_kv(x, kh) if int4 else x).float().reshape(-1, kh, hd)

        k = codes(k_cache[flat]) * gather_kv_scales(ks, flat)[..., None]
        vc, vsc = codes(v_cache[flat]), gather_kv_scales(vs, flat)
    k, vc = k.reshape(b, c, kh, hd), vc.reshape(b, c, kh, hd)
    qf = q.float().reshape(b, t, kh, h // kh, hd) * hd ** -0.5
    s = torch.einsum("btkgd,bckd->bkgtc", qf, k)
    tt = torch.arange(t, device=q.device)
    q_pos = pos0.long()[:, None] + tt[None, :]
    valid = (torch.arange(c, device=q.device)[None, None, :] <= q_pos[:, :, None]) & (
        tt[None, :, None] < tlen.long()[:, None, None])
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, -0.7 * torch.finfo(torch.float32).max))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    x = (p * vsc.reshape(b, c, kh).transpose(1, 2)[:, :, None, None, :]).to(torch.bfloat16)
    out = torch.einsum("bkgtc,bckd->btkgd", x.float(), vc) / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, h, hd).to(q.dtype)


def ptxas_report(hd, fmt_index, source="prefill_attention", gp=None):
    """Registers and spills of one instantiation, from this run's ptxas log
    of `source`: flash_prefill_kernel<hd, fmt> of prefill_attention.cu, or
    fused_decode_kernel<hd, fmt, gp> of decode_attention.cu (KvFmt 0 bf16,
    1 int8, 2 int4; gp the head group the kernel is built for, 4 or 8)."""
    from dynamo_tpu_torch.ops import _cuda

    if source == "decode_attention":
        want = re.compile(rf"fused_decode_kernelILi{hd}ELNS_5KvFmtE{fmt_index}ELi{gp}E")
    else:
        want = re.compile(rf"flash_prefill_kernelILi{hd}E.*KvFmtE{fmt_index}E")
    cur, regs, spill = None, None, None
    for line in _cuda.build_logs.get(source, "").splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or not want.search(cur):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = f"{m.group(1)} registers"
    if regs is None:
        return "ptxas: not in this run's build log"
    return f"ptxas: {regs}, {spill or 'spills not reported'}"


def prefill_rates(ms, lib_ms, flops, hd, fmt_index):
    """The achieved rate over the causal FLOPs the bound counts, the time
    over SDPA's, and the instantiation's ptxas report, for a [kernel] line."""
    return (f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s achieved, {ms / lib_ms:.2f}x sdpa's "
            f"time; {ptxas_report(hd, fmt_index)}")


def check_prefill(peaks, gen, dev):
    from dynamo_tpu_torch.ops import prefill_attention as m

    cases = {
        # B, T, H, K, Hd, page, W, pos0, t_valid
        "8b": (8, 512, 32, 8, 128, 64, 9, [64] * 8, [512] * 8),
        "small": (4, 48, 4, 2, 32, 16, 6, [0, 16, 7, 40], [48, 20, 1, 0]),
        "g1": (2, 40, 4, 4, 64, 16, 5, [0, 9], [40, 31]),
        "g8": (2, 24, 16, 2, 64, 16, 4, [8, 0], [24, 5]),
        "p3": (4, 48, 4, 2, 32, 3, 30, [0, 15, 7, 40], [48, 20, 1, 0]),
    }
    errs = {}
    for label, (b, t, h, kh, hd, page, w, pos0, tlen) in cases.items():
        num_pages = b * w + 3
        k, v = _pools(num_pages, page, kh * hd, gen, dev)
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
        got = m.flash_prefill_attention(q, k, v, tables, p0, tl, page_size=page)
        want = m.flash_prefill_attention_plain(q, k, v, tables, p0, tl, page_size=page)
        torch.cuda.synchronize()
        valid = torch.arange(t, device=dev)[None] < tl[:, None]  # [B, T]
        assert torch.all(got[~valid] == 0), f"prefill {label}: rows past t_valid not 0"
        c = compare_bf16(got[valid], want[valid])
        msg = f"[kernel] prefill_attention {label}: {fmt(c)}"
        if label == "8b":
            # the check's power on these inputs: the causal edge one key
            # late, and the probabilities rounded once to bf16
            msg += _check_power(want, valid, "prefill", {
                "causal edge off by one key": m.flash_prefill_attention_plain(
                    q, k, v, tables, p0 + 1, tl, page_size=page),
                "probabilities rounded once to bf16": _p_bf16_once(
                    q, k, v, tables, p0, tl, page=page),
            })
        log(msg)
        assert c["ok"], f"prefill {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = c["max_abs_err"]
        if label == "8b":
            ms = time_ms(lambda: m.flash_prefill_attention(q, k, v, tables, p0, tl, page_size=page))
            plain_ms = time_ms(lambda: m.flash_prefill_attention_plain(
                q, k, v, tables, p0, tl, page_size=page))
            qq, kk, vv, mask = _sdpa_prefill_inputs(q, k, v, tables, p0, tl, page)
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask))
            kv_rows = sum(p + n for p, n in zip(pos0, tlen))
            nbytes = 2 * q.numel() * 2 + 2 * kv_rows * kh * hd * 2 + (tables.numel() + 2 * b) * 4
            flops = sum(
                4 * h * hd * sum(p + j + 1 for j in range(n)) for p, n in zip(pos0, tlen)
            )
            b_ms, by = bound_ms(nbytes, flops, peaks)
    log(f"[kernel] prefill_attention: every case within one bf16 ulp + 2**-16; {ms:.4f} ms "
        f"(plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, bound {b_ms:.4f} by {by}); "
        + prefill_rates(ms, lib_ms, flops, 128, 0))
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


# the decode kernel's extra cases (phase 3), beside each check's own. The
# kernel splits each row's keys over blocks (ops/decode_attention
# split_plan): "8b-w32" is the 8B decode at the engine's own table width
# (max_model_len 2048 at page 64), where most splits of each row are past
# its length; "b1-2000" one long row; "edges" (two splits of 128 keys) rows
# ending at the split's edge and one past it (write_pos 128 then the first
# key of a split), at the edge of a warp's first ring stage (64) and one
# past it, one key, an idle row and a full table; "page24" a page size that
# is neither a power of two nor a multiple of the kernel's 16-key tile, so
# a tile's keys span two pages; "page3" the odd page size the engine serves
# (K 2, so an int8/int4 scale tile is not whole 16-byte vectors).
DECODE_SPLIT_CASES = {
    # B, H, K, Hd, page, W, lengths (write_pos = length - 1; 0 = idle row)
    "8b-w32": (8, 32, 8, 128, 64, 32, [576, 570, 590, 600, 512, 577, 583, 560]),
    "b1-2000": (1, 32, 8, 128, 64, 32, [2000]),
    "edges": (7, 8, 2, 64, 16, 12, [64, 65, 128, 129, 1, 0, 192]),
    "page24": (3, 8, 2, 64, 24, 8, [25, 129, 192]),
    "page3": (4, 4, 2, 32, 3, 20, [37, 0, 1, 58]),
}


def decode_extra(times, m, dev):
    """The [kernel] line's tail for K3/K5: the extra cases' times, the
    split the 8B shape takes, and the repeat check."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    chunk, splits = m.split_plan(8, 8, 10, 64, sms)
    return (f"; W 32 {times['8b-w32']:.4f} ms, B 1 at 2,000 keys {times['b1-2000']:.4f} ms; "
            f"the 8B shape in {splits} splits of {chunk} keys on {sms} SMs; two launches "
            "bit-equal in every case")


def check_decode(peaks, gen, dev):
    from dynamo_tpu_torch.ops import decode_attention as m

    cases = {
        # B, H, K, Hd, page, W, lengths (write_pos = length - 1; 0 = idle row)
        "8b": (8, 32, 8, 128, 64, 10, [576, 570, 590, 600, 512, 577, 583, 560]),
        "small": (4, 4, 2, 32, 16, 6, [37, 0, 1, 80]),
        "g1": (3, 4, 4, 64, 16, 6, [1, 95, 0]),
        "g8": (2, 16, 2, 64, 16, 6, [50, 96]),
        **DECODE_SPLIT_CASES,
    }
    errs, times = {}, {}
    for label, (b, h, kh, hd, page, w, lengths) in cases.items():
        num_pages = b * w + 3
        k, v = _pools(num_pages, page, kh * hd, gen, dev)
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        nk = torch.randn((b, kh * hd), generator=gen, device=dev).to(torch.bfloat16)
        nv = torch.randn((b, kh * hd), generator=gen, device=dev).to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        wpos = torch.tensor([n - 1 if n else -1 for n in lengths], dtype=torch.int32, device=dev)
        k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
        got, rk, _ = m.fused_paged_decode_attention(
            q, nk, nv, k1, v1, tables, lens, wpos, page_size=page)
        assert rk is k1
        want, _, _ = m.fused_paged_decode_attention_plain(
            q, nk, nv, k2, v2, tables, lens, wpos, page_size=page)
        ro = m.paged_decode_attention(q, k1, v1, tables, lens, page_size=page)
        torch.cuda.synchronize()
        assert torch.equal(k1.view(torch.int16), k2.view(torch.int16)) and torch.equal(
            v1.view(torch.int16), v2.view(torch.int16)), f"decode {label}: pools differ after write"
        # a second launch on the same inputs (the row is rewritten in place)
        again = m.fused_paged_decode_attention(
            q, nk, nv, k1, v1, tables, lens, wpos, page_size=page)[0]
        ro2 = m.paged_decode_attention(q, k1, v1, tables, lens, page_size=page)
        assert _same_bytes(again, got) and _same_bytes(ro2, ro), f"decode {label}: launches differ"
        assert not torch.equal(k1, k), f"decode {label}: pool not updated in place"
        idle = lens == 0
        assert torch.all(got[idle] == 0) and torch.all(ro[idle] == 0), f"decode {label}: idle rows not 0"
        c = compare_bf16(got, want)
        c_ro = compare_bf16(ro, want)
        msg = f"[kernel] decode_attention {label}: {fmt(c)}; read-only: {fmt(c_ro)}"
        if label == "8b":
            # the check's power on these inputs: the newest key dropped, and
            # the pool's stale row read in place of the new one
            drop, _, _ = m.fused_paged_decode_attention_plain(
                q, nk, nv, k2.clone(), v2.clone(), tables, lens - 1, wpos.new_full((b,), -1),
                page_size=page)
            stale, _, _ = m.fused_paged_decode_attention_plain(
                q, nk, nv, k.clone(), v.clone(), tables, lens, wpos.new_full((b,), -1),
                page_size=page)
            c_drop, c_stale = compare_bf16(drop, want), compare_bf16(stale, want)
            msg += f"; newest key dropped: {fmt(c_drop)}; stale new row: {fmt(c_stale)}"
            assert not c_drop["ok"] and not c_stale["ok"], "decode: the check cannot see one key"
        log(msg)
        assert c["ok"] and c_ro["ok"], f"decode {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = max(c["max_abs_err"], c_ro["max_abs_err"])
        if label in ("8b-w32", "b1-2000"):
            times[label] = time_ms(lambda: m.fused_paged_decode_attention(
                q, nk, nv, k1, v1, tables, lens, wpos, page_size=page))
        if label == "8b":
            ms = time_ms(lambda: m.fused_paged_decode_attention(
                q, nk, nv, k1, v1, tables, lens, wpos, page_size=page))
            plain_ms = time_ms(lambda: m.fused_paged_decode_attention_plain(
                q, nk, nv, k2, v2, tables, lens, wpos, page_size=page))
            qq, kk, vv, _ = _sdpa_prefill_inputs(
                q[:, None], k1, v1, tables, lens - 1, lens, page)
            mask = (torch.arange(kk.shape[2], device=dev)[None] < lens[:, None].long())[:, None, None]
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask))
            total = sum(lengths)
            nbytes = (2 * q.numel() * 2 + 2 * nk.numel() * 2 * 2
                      + 2 * total * kh * hd * 2 + (tables.numel() + 2 * b) * 4)
            flops = 4 * h * hd * total
            b_ms, by = bound_ms(nbytes, flops, peaks)
    log(f"[kernel] decode_attention: every case within one bf16 ulp + 2**-16, pools equal "
        f"after the write; {ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, "
        f"bound {b_ms:.4f} by {by}; {ms / lib_ms:.2f}x sdpa's time, {b_ms / ms:.1%} of the "
        f"bound)" + decode_extra(times, m, dev)
        + f"; {ptxas_report(128, 0, 'decode_attention', 4)}")
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


# ------------------------------------------------------- phase 3, int8 KV


def _quantize(int4):
    from dynamo_tpu_torch.ops.quant import quantize_kv_rows, quantize_kv_rows_int4

    return quantize_kv_rows_int4 if int4 else quantize_kv_rows


def _q_pools(num_pages, page, kh, hd, gen, dev, int4=False):
    """int8 (or nibble-packed int4) pools and scale pools [P, K, page]
    quantized from random bf16 rows, as the engine fills them."""
    from dynamo_tpu_torch.ops.quant import scales_to_page_tiles

    quantize = _quantize(int4)
    k, v = _pools(num_pages, page, kh * hd, gen, dev)
    (kq, ks), (vq, vs) = quantize(k, kh), quantize(v, kh)
    return kq, vq, scales_to_page_tiles(ks, page), scales_to_page_tiles(vs, page)


def _unpack_wrong(packed, kh, mode):
    """int4 codes [N, K*Hd] as f32, unpacked the wrong way: "unsigned" reads
    the high nibble as 0..15, "interleaved" takes byte j as features 2j
    (low nibble) and 2j + 1 (high), adjacent pairs instead of planes."""
    b = packed.to(torch.int32).reshape(packed.shape[0], kh, -1)
    lo = ((b & 15) ^ 8) - 8
    hi = (b & 255) >> 4 if mode == "unsigned" else b >> 4
    full = torch.stack((lo, hi), -1).flatten(2) if mode == "interleaved" else torch.cat((lo, hi), -1)
    return full.reshape(packed.shape[0], -1).float()


def _dequant_pool(pool, scales, int4=False, wrong=None):
    """A whole int8 or int4 pool dequantized through its scale pool,
    [N, K*Hd] f32 (`wrong`: an int4 unpack mode of `_unpack_wrong`)."""
    from dynamo_tpu_torch.ops.quant import dequantize_kv_rows, dequantize_kv_rows_int4

    # [P, K, S] -> per-slot [P*S, K]
    kh = scales.shape[1]
    dense = scales.transpose(1, 2).reshape(-1, kh)
    if wrong:
        codes = _unpack_wrong(pool, kh, wrong)
        return (codes.reshape(len(codes), kh, -1) * dense[..., None]).reshape(len(codes), -1)
    if int4:
        return dequantize_kv_rows_int4(pool, dense, kh)
    return dequantize_kv_rows(pool, dense)


def _swap_heads(scales):
    """Scale pool with kv heads 0 and 1 swapped: a kernel reading the wrong
    head's scales."""
    out = scales.clone()
    out[:, [0, 1]] = scales[:, [1, 0]]
    return out


def _same_bytes(a, b):
    return torch.equal(a.view(torch.int8), b.view(torch.int8))


def check_kv_write_q(peaks, gen, dev, int4=False):
    from dynamo_tpu_torch.ops import kv_write as m
    from dynamo_tpu_torch.scripts import l2_evict

    name = "kv_write_q4" if int4 else "kv_write_q"
    plain_fn = m.paged_kv_write_q4_plain if int4 else m.paged_kv_write_q_plain

    def write(p, table, s):
        return m.paged_kv_write(p[0], p[1], table, s[0], s[1], p[2], p[3], s[2], s[3],
                                page_size=page, int4=int4)

    def plain(p, table, s):
        return plain_fn(p[0], p[1], table, s[0], s[1], p[2], p[3], s[2], s[3], page_size=page)

    flush = l2_evict(dev)
    times = {}
    for label, (num_pages, page, kh, hd, n) in {
        "8b-p64": (200, 64, 8, 128, 64), "8b-p128": (100, 128, 8, 128, 32),
        "small": (40, 16, 2, 32, 7), "k1-hd32": (12, 16, 1, 32, 5),
        # page 3, K 2: a 24-byte scale tile, copied in 4-byte words
        "odd-p3": (40, 3, 2, 32, 7),
    }.items():
        if label == "k1-hd32" and not int4:
            continue  # an int4 row of 16 bytes: the narrowest the 16-byte copy takes
        k, v, ks, vs = _q_pools(num_pages, page, kh, hd, gen, dev, int4)
        kw = k.shape[1]
        table = torch.randperm(num_pages - 1, generator=gen, device=dev)[:n].to(torch.int32) + 1
        table[-1] = 0  # a padding page into the trash page
        nk, nv, nks, nvs = _q_pools(n, page, kh, hd, gen, dev, int4)
        nk, nv = nk.view(n, page, kw), nv.view(n, page, kw)
        mine = [x.clone() for x in (k, v, ks, vs)]
        plain_p = [x.clone() for x in (k, v, ks, vs)]
        out = write(mine, table, (nk, nv, nks, nvs))
        assert all(a is b for a, b in zip(out, mine))
        plain(plain_p, table, (nk, nv, nks, nvs))
        torch.cuda.synchronize()
        # byte-exact, trash page aside (several writers race on it)
        for x, y, per_page in zip(mine, plain_p, (page, page, 1, 1)):
            assert _same_bytes(x[per_page:], y[per_page:]), f"{name} {label}: differs from plain"
        assert not torch.equal(mine[0], k) and not torch.equal(mine[2], ks), \
            f"{name} {label}: pools not updated in place"
        _write_repeats(name, label, write, plain, (k, v, ks, vs), table, (nk, nv, nks, nvs),
                       num_pages)
        if label.startswith("8b"):
            nbytes = 2 * (2 * n * page * kw + 2 * n * kh * page * 4) + n * 4
            b_ms, by = bound_ms(nbytes, 0.0, peaks)
            times[label] = _write_times(
                lambda: write(mine, table, (nk, nv, nks, nvs)), flush, b_ms) + (b_ms, by)
        if label == "8b-p64":
            plain_ms = time_ms(lambda: plain(plain_p, table, (nk, nv, nks, nvs)))
            idx = table.long()
            dst = [x.view(num_pages, -1) for x in mine]
            src = [nk.view(n, -1), nv.view(n, -1), nks.view(n, -1), nvs.view(n, -1)]

            def lib():
                for d_, s_ in zip(dst, src):
                    d_.index_copy_(0, idx, s_)

            lib_ms = time_ms(lib)
    ms, _, p64, b_ms, by = times["8b-p64"]
    p128 = times["8b-p128"]
    log(f"[kernel] {name}: pools and scale pools byte-exact at 8B page 64/128, small and "
        f"page 3 (K 2: 24-byte scale tiles, in 4-byte words)"
        f"{' (and K=1, Hd=32: 16-byte rows)' if int4 else ''}, two launches the same bytes, "
        f"an id equal to num_pages skipped; page 64: {p64} (plain {plain_ms:.4f}, index_copy_ "
        f"{lib_ms:.4f}, bound {b_ms:.4f} by {by}); page 128: {p128[2]} (bound {p128[3]:.4f})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


def _check_power(want, valid, what, variants):
    """The check's power on these inputs: each variant of the plain version
    (`variants`: label -> output) must miss the check. Returns the text."""
    msg = ""
    for label, got in variants.items():
        c = compare_bf16(got[valid] if valid is not None else got,
                         want[valid] if valid is not None else want)
        msg += f"; {label}: {fmt(c)}"
        assert not c["ok"], f"{what}: the check cannot see {label}"
    return msg


def check_prefill_q(peaks, gen, dev, int4=False):
    from dynamo_tpu_torch.ops import prefill_attention as m

    name = "prefill_attention_q4" if int4 else "prefill_attention_q"
    plain_fn = m.flash_prefill_attention_q4_plain if int4 else m.flash_prefill_attention_q_plain
    cases = {
        # B, T, H, K, Hd, page, W, pos0, t_valid
        "8b-p64": (8, 512, 32, 8, 128, 64, 9, [64] * 8, [512] * 8),
        "8b-p128": (8, 512, 32, 8, 128, 128, 5, [64] * 8, [512] * 8),
        "small": (4, 48, 4, 2, 32, 16, 6, [0, 16, 7, 40], [48, 20, 1, 0]),
        "g1": (2, 40, 4, 4, 64, 16, 5, [0, 9], [40, 31]),
        "g8": (2, 24, 16, 2, 64, 16, 4, [8, 0], [24, 5]),
        "p3": (4, 48, 4, 2, 32, 3, 30, [0, 15, 7, 40], [48, 20, 1, 0]),
    }
    errs = {}
    for label, (b, t, h, kh, hd, page, w, pos0, tlen) in cases.items():
        num_pages = b * w + 3
        k, v, ks, vs = _q_pools(num_pages, page, kh, hd, gen, dev, int4)
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
        got = m.flash_prefill_attention(q, k, v, tables, p0, tl, ks, vs, page_size=page,
                                        int4=int4)
        want = plain_fn(q, k, v, tables, p0, tl, ks, vs, page_size=page)
        torch.cuda.synchronize()
        valid = torch.arange(t, device=dev)[None] < tl[:, None]  # [B, T]
        assert torch.all(got[~valid] == 0), f"{name} {label}: rows past t_valid not 0"
        c = compare_bf16(got[valid], want[valid])
        msg = f"[kernel] {name} {label}: {fmt(c)}"
        if label.startswith("8b"):
            # the check's power on these inputs: the probabilities (times
            # the V scale) rounded once to bf16
            msg += _check_power(want, valid, name, {
                "probabilities rounded once to bf16": _p_bf16_once(
                    q, k, v, tables, p0, tl, ks, vs, page=page, int4=int4)})
        if label == "8b-p64":
            # two heads' scales swapped, and for int4 the codes unpacked
            # with an unsigned high nibble or in adjacent pairs (the plain
            # bf16 version over the pools so dequantized)
            variants = {"heads 0/1 scales swapped": plain_fn(
                q, k, v, tables, p0, tl, _swap_heads(ks), _swap_heads(vs), page_size=page)}
            for mode in ("unsigned", "interleaved") if int4 else ():
                variants[f"{mode} nibbles"] = m.flash_prefill_attention_plain(
                    q, _dequant_pool(k, ks, wrong=mode), _dequant_pool(v, vs, wrong=mode),
                    tables, p0, tl, page_size=page)
            msg += _check_power(want, valid, name, variants)
        log(msg)
        assert c["ok"], f"{name} {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = c["max_abs_err"]
        kernel = lambda: m.flash_prefill_attention(  # noqa: E731
            q, k, v, tables, p0, tl, ks, vs, page_size=page, int4=int4)
        if label == "8b-p128":
            p128_ms = time_ms(kernel)
        if label == "8b-p64":
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: plain_fn(q, k, v, tables, p0, tl, ks, vs, page_size=page))
            kd = _dequant_pool(k, ks, int4).to(torch.bfloat16)
            vd = _dequant_pool(v, vs, int4).to(torch.bfloat16)
            qq, kk, vv, mask = _sdpa_prefill_inputs(q, kd, vd, tables, p0, tl, page)
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask))
            kv_rows = sum(p + n for p, n in zip(pos0, tlen))
            nbytes = (2 * q.numel() * 2 + 2 * kv_rows * kh * (k.shape[1] // kh + 4)
                      + (tables.numel() + 2 * b) * 4)
            flops = sum(
                4 * h * hd * sum(p + j + 1 for j in range(n)) for p, n in zip(pos0, tlen)
            )
            b_ms, by = bound_ms(nbytes, flops, peaks)
    log(f"[kernel] {name}: every case within one bf16 ulp + 2**-16; {ms:.4f} ms "
        f"at page 64 (page 128: {p128_ms:.4f}; plain {plain_ms:.4f}, sdpa over KV dequantized "
        f"to bf16 beforehand {lib_ms:.4f}, bound {b_ms:.4f} by {by}); "
        + prefill_rates(ms, lib_ms, flops, 128, 2 if int4 else 1))
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


def check_decode_q(peaks, gen, dev, int4=False):
    from dynamo_tpu_torch.ops import decode_attention as m

    name = "decode_attention_q4" if int4 else "decode_attention_q"
    plain_fn = (m.fused_paged_decode_attention_q4_plain if int4
                else m.fused_paged_decode_attention_q_plain)
    cases = {
        # B, H, K, Hd, page, W, lengths (write_pos = length - 1; 0 = idle row)
        "8b-p64": (8, 32, 8, 128, 64, 10, [576, 570, 590, 600, 512, 577, 583, 560]),
        "8b-p128": (8, 32, 8, 128, 128, 5, [576, 570, 590, 600, 512, 577, 583, 560]),
        "small": (4, 4, 2, 32, 16, 6, [37, 0, 1, 80]),
        "g1": (3, 4, 4, 64, 16, 6, [1, 95, 0]),
        "g8": (2, 16, 2, 64, 16, 6, [50, 96]),
        **DECODE_SPLIT_CASES,
    }
    errs, times = {}, {}
    for label, (b, h, kh, hd, page, w, lengths) in cases.items():
        num_pages = b * w + 3
        k, v, ks, vs = _q_pools(num_pages, page, kh, hd, gen, dev, int4)
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        nk_bf = torch.randn((b, kh * hd), generator=gen, device=dev).to(torch.bfloat16)
        nv_bf = torch.randn((b, kh * hd), generator=gen, device=dev).to(torch.bfloat16)
        quantize = _quantize(int4)
        (nk, nks), (nv, nvs) = quantize(nk_bf, kh), quantize(nv_bf, kh)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        wpos = torch.tensor([n - 1 if n else -1 for n in lengths], dtype=torch.int32, device=dev)
        mine = [x.clone() for x in (k, v, ks, vs)]
        plain = [x.clone() for x in (k, v, ks, vs)]
        got, *rp = m.fused_paged_decode_attention(
            q, nk, nv, mine[0], mine[1], tables, lens, wpos, mine[2], mine[3], nks, nvs,
            page_size=page, int4=int4)
        assert all(a is b for a, b in zip(rp, mine))
        want = plain_fn(q, nk, nv, plain[0], plain[1], tables, lens, wpos, plain[2], plain[3],
                        nks, nvs, page_size=page)[0]
        ro = m.paged_decode_attention(q, mine[0], mine[1], tables, lens, mine[2], mine[3],
                                      page_size=page, int4=int4)
        torch.cuda.synchronize()
        for x, y in zip(mine, plain):
            assert _same_bytes(x, y), f"{name} {label}: pools differ after the write"
        # a second launch on the same inputs (the row is rewritten in place)
        again = m.fused_paged_decode_attention(
            q, nk, nv, mine[0], mine[1], tables, lens, wpos, mine[2], mine[3], nks, nvs,
            page_size=page, int4=int4)[0]
        ro2 = m.paged_decode_attention(q, mine[0], mine[1], tables, lens, mine[2], mine[3],
                                       page_size=page, int4=int4)
        assert _same_bytes(again, got) and _same_bytes(ro2, ro), f"{name} {label}: launches differ"
        assert not torch.equal(mine[0], k) and not torch.equal(mine[2], ks), \
            f"{name} {label}: pools not updated in place"
        idle = lens == 0
        assert torch.all(got[idle] == 0) and torch.all(ro[idle] == 0), \
            f"{name} {label}: idle rows not 0"
        c, c_ro = compare_bf16(got, want), compare_bf16(ro, want)
        msg = f"[kernel] {name} {label}: {fmt(c)}; read-only: {fmt(c_ro)}"
        if label in ("8b-p64", "small"):
            # the check's power on these inputs: the new token attended
            # through its bf16 row instead of its quantized one (the plain
            # bf16 version over the dequantized pools), two heads' scales
            # swapped, and for int4 (8B only) the written pools unpacked
            # with an unsigned high nibble or in adjacent pairs
            kd, vd = _dequant_pool(plain[0], plain[2], int4), _dequant_pool(plain[1], plain[3], int4)
            no_write = wpos.new_full((b,), -1)
            variants = {
                "new row in bf16": m.fused_paged_decode_attention_plain(
                    q, nk_bf.float(), nv_bf.float(), kd, vd, tables, lens, wpos,
                    page_size=page)[0],
                "heads 0/1 scales swapped": plain_fn(
                    q, nk, nv, plain[0].clone(), plain[1].clone(), tables, lens, no_write,
                    _swap_heads(plain[2]), _swap_heads(plain[3]), nks, nvs, page_size=page)[0],
            }
            for mode in ("unsigned", "interleaved") if int4 and label == "8b-p64" else ():
                variants[f"{mode} nibbles"] = m.fused_paged_decode_attention_plain(
                    q, nk_bf, nv_bf, _dequant_pool(plain[0], plain[2], wrong=mode),
                    _dequant_pool(plain[1], plain[3], wrong=mode), tables, lens, no_write,
                    page_size=page)[0]
            msg += _check_power(want, None, name, variants)
        log(msg)
        assert c["ok"] and c_ro["ok"], f"{name} {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = max(c["max_abs_err"], c_ro["max_abs_err"])
        fused = lambda: m.fused_paged_decode_attention(  # noqa: E731
            q, nk, nv, mine[0], mine[1], tables, lens, wpos, mine[2], mine[3], nks, nvs,
            page_size=page, int4=int4)
        if label == "8b-p128":
            p128_ms = time_ms(fused)
        if label in ("8b-w32", "b1-2000"):
            times[label] = time_ms(fused)
        if label == "8b-p64":
            ms = time_ms(fused)
            plain_ms = time_ms(lambda: plain_fn(
                q, nk, nv, plain[0], plain[1], tables, lens, wpos, plain[2], plain[3], nks, nvs,
                page_size=page))
            kd = _dequant_pool(mine[0], mine[2], int4).to(torch.bfloat16)
            vd = _dequant_pool(mine[1], mine[3], int4).to(torch.bfloat16)
            qq, kk, vv, _ = _sdpa_prefill_inputs(q[:, None], kd, vd, tables, lens - 1, lens, page)
            mask = (torch.arange(kk.shape[2], device=dev)[None] < lens[:, None].long())[:, None, None]
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask))
            total = sum(lengths)
            nbytes = (2 * q.numel() * 2 + 2 * 2 * nk.numel() + 2 * 2 * nks.numel() * 4
                      + 2 * total * kh * (k.shape[1] // kh + 4) + (tables.numel() + 2 * b) * 4)
            flops = 4 * h * hd * total
            b_ms, by = bound_ms(nbytes, flops, peaks)
    log(f"[kernel] {name}: every case within one bf16 ulp + 2**-16, pools and "
        f"scale pools equal after the write; {ms:.4f} ms at page 64 (page 128: {p128_ms:.4f}; "
        f"plain {plain_ms:.4f}, sdpa over KV dequantized to bf16 beforehand {lib_ms:.4f}, "
        f"bound {b_ms:.4f} by {by}; {ms / lib_ms:.2f}x sdpa's time, {b_ms / ms:.1%} of the "
        f"bound)" + decode_extra(times, m, dev)
        + f"; {ptxas_report(128, 2 if int4 else 1, 'decode_attention', 4)}")
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


# ------------------------------------------------------- phase 3, K4


# rows of one ragged rectangle: (q_pos0, q_len). The 8B cases are the main
# path's shapes. "8b" is a mixed step: four decode rows at mid-page
# positions, two verify rows of 1 + 4 queries (the second across the page
# boundary at 576), two chunk rows at page-aligned pos0, and a q_len 0 row.
# "8b-verify" is a standalone verify dispatch ([8, spec_k_max + 1]: T = 5,
# below one query tile): rows of 1 + k queries, mid-page and across page
# boundaries (574, 638, 511), and idle q_len 0 rows. "8b-mixed128" is a
# [8, 128] mixed step: decode and verify rows beside chunk rows, the last a
# final chunk of 77 tokens.
RAGGED_CASES = {
    # H, K, Hd, page, T, W, rows
    "8b": (32, 8, 128, 64, 512, 16,
           [(517, 1), (550, 1), (583, 1), (600, 1), (530, 5), (574, 5), (64, 512),
            (128, 448), (0, 0)]),
    "8b-verify": (32, 8, 128, 64, 5, 16,
                  [(517, 5), (550, 1), (574, 5), (0, 0), (600, 3), (638, 5), (0, 0), (511, 2)]),
    "8b-mixed128": (32, 8, 128, 64, 128, 16,
                    [(521, 5), (566, 1), (590, 3), (603, 1), (384, 128), (448, 128), (512, 77),
                     (0, 0)]),
    "hd32-g2": (4, 2, 32, 16, 32, 6, [(37, 1), (14, 5), (32, 32), (0, 0), (60, 1), (45, 3)]),
    "hd64-g1": (4, 4, 64, 16, 32, 6, [(14, 5), (37, 1), (0, 0), (16, 24), (47, 2)]),
    "hd64-g8": (16, 2, 64, 16, 32, 6, [(30, 3), (0, 0), (37, 1), (9, 32), (62, 5)]),
    # the odd page size the engine serves (K 2 at page 3)
    "hd32-p3": (4, 2, 32, 3, 32, 30, [(37, 1), (14, 5), (33, 32), (0, 0), (60, 1), (45, 3)]),
}
RAGGED_NAMES = {"bf16": "ragged_attention", "int8": "ragged_attention_q",
                "int4": "ragged_attention_q4"}


def check_ragged(peaks, gen, dev, form="bf16"):
    """K4 in one form against its plain version on ragged rectangles (each
    element within one bf16 ulp plus ATOL_F32, rows past q_len exactly 0),
    with the check's power shown on the 8B mixed and verify rectangles, and
    the times on the 8B mixed rectangle of the kernel, its plain version,
    SDPA with the ragged causal mask, K3/K5 on the rectangle's decode rows
    and K4 on those rows alone."""
    from dynamo_tpu_torch.ops import decode_attention as m

    int4, quant = form == "int4", form != "bf16"
    name = RAGGED_NAMES[form]
    plain_fn = {"bf16": m.ragged_paged_attention_plain, "int8": m.ragged_paged_attention_q_plain,
                "int4": m.ragged_paged_attention_q4_plain}[form]
    errs = {}
    for label, (h, kh, hd, page, t, w, rows) in RAGGED_CASES.items():
        b = len(rows)
        num_pages = b * w + 3
        if quant:
            k, v, ks, vs = _q_pools(num_pages, page, kh, hd, gen, dev, int4)
            scales = (ks, vs)
        else:
            k, v = _pools(num_pages, page, kh * hd, gen, dev)
            scales = ()
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        p0 = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)

        def kernel(q=q, tables=tables, p0=p0, ql=ql):
            return m.ragged_paged_attention(q, k, v, tables, p0, ql, *scales, page_size=page,
                                            int4=int4)

        def plain(p0=p0):
            return plain_fn(q, k, v, tables, p0, ql, *scales, page_size=page)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        valid = torch.arange(t, device=dev)[None] < ql[:, None]  # [B, T]
        assert torch.all(got[~valid] == 0), f"{name} {label}: rows past q_len not 0"
        c = compare_bf16(got[valid], want[valid])
        msg = f"[kernel] {name} {label}: {fmt(c)}"
        if label in ("8b", "8b-verify"):
            # the check's power on these inputs: every row's causal edge one
            # key late, and the verify rows' last query without its own
            # newest key (its causal limit one key early, the rest intact)
            late = plain(p0 + 1)
            early = plain(p0 - 1)
            dropped = want.clone()
            for r, (_, n) in enumerate(rows):
                if n == 5:
                    dropped[r, n - 1] = early[r, n - 1]
            msg += _check_power(want, valid, name, {
                "causal edge one key late": late,
                "verify row's last query without its newest key": dropped,
            })
        if label.startswith("8b"):
            msg += _check_power(want, valid, name, {
                "probabilities rounded once to bf16": _p_bf16_once(
                    q, k, v, tables, p0, ql, *scales, page=page, int4=int4)})
        log(msg)
        assert c["ok"], f"{name} {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = c["max_abs_err"]
        if label != "8b":
            continue
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        kd, vd = k, v
        if quant:
            kd = _dequant_pool(k, ks, int4).to(torch.bfloat16)
            vd = _dequant_pool(v, vs, int4).to(torch.bfloat16)
        qq, kk, vv, mask = _sdpa_prefill_inputs(q, kd, vd, tables, p0, ql, page)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask))
        # what a decode row costs when read through K4 (its padded query
        # tiles) against K3/K5 reading the same rows, each on inputs
        # gathered beforehand
        dec = (ql == 1).nonzero().flatten()
        qd, td, pd, ld = (x[dec].contiguous() for x in (q, tables, p0, ql))
        k4_dec_ms = time_ms(lambda: kernel(qd, td, pd, ld))
        q1, l1 = qd[:, 0].contiguous(), (pd + 1).contiguous()
        k3_ms = time_ms(lambda: m.paged_decode_attention(q1, k, v, td, l1, *scales,
                                                         page_size=page, int4=int4))
        # a kv head's row in bytes, plus its one f32 scale when quantized
        row_bytes = k.shape[1] * k.element_size() // kh + (4 if quant else 0)
        kv_rows = sum(p + n for p, n in rows if n)
        n_q = sum(n for _, n in rows)
        nbytes = (n_q * h * hd * 2 + q.numel() * 2 + 2 * kv_rows * kh * row_bytes
                  + (tables.numel() + 2 * b) * 4)
        flops = sum(4 * h * hd * sum(p + j + 1 for j in range(n)) for p, n in rows)
        b_ms, by = bound_ms(nbytes, flops, peaks)
    log(f"[kernel] {name}: every case within one bf16 ulp + 2**-16, rows past q_len 0; "
        f"{ms:.4f} ms on the 8B rectangle (plain {plain_ms:.4f}, sdpa{' over KV dequantized to '
        'bf16 beforehand' if quant else ''} {lib_ms:.4f}, bound {b_ms:.4f} by {by}); its 4 "
        f"decode rows alone: K4 {k4_dec_ms:.4f} ms, {'K5' if quant else 'K3'} {k3_ms:.4f} ms; "
        + prefill_rates(ms, lib_ms, flops, 128, {"bf16": 0, "int8": 1, "int4": 2}[form]))
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by, k4_decode_rows_ms=k4_dec_ms,
                decode_kernel_ms=k3_ms)


# ---------------------------------------------------------------- phase 3: the probe kernels


def check_page_copy(peaks, gen, dev):
    """K8 against its plain version, byte-exact: at the probe's shapes (512
    pages [64, 512] bf16 into 657, both pools) and at the 8B shape (64 of
    256 pages [64, 1024], one id 0 that must be skipped: page 0 is never
    written); timed at the probe's shapes, its main path, against two
    `index_copy_` calls."""
    from dynamo_tpu_torch.scripts import proto_page_write as m

    for label in ("probe", "8b"):
        if label == "probe":
            num_pages, page, kw = m.NUM_PAGES, m.PAGE, m.KW
            tables = m.probe_tables(dev)
        else:
            num_pages, page, kw = 256, 64, 1024
            tables = (torch.randperm(num_pages - 1, generator=gen, device=dev)[:64] + 1).to(
                torch.int32)
            tables[7] = 0
        n = tables.numel()
        k, v = _pools(num_pages, page, kw, gen, dev)
        nk = torch.randn((n, page, kw), generator=gen, device=dev).to(torch.bfloat16)
        nv = torch.randn((n, page, kw), generator=gen, device=dev).to(torch.bfloat16)
        k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
        rk, rv = m.page_copy(k1, v1, tables, nk, nv)
        assert rk is k1 and rv is v1, "page_copy: pools not returned in place"
        m.page_copy_plain(k2, v2, tables, nk, nv)
        torch.cuda.synchronize()
        assert _same_bytes(k1, k2) and _same_bytes(v1, v2), \
            f"page_copy {label}: pools differ from the plain version"
        assert _same_bytes(k1[:page], k[:page]) and _same_bytes(v1[:page], v[:page]), \
            f"page_copy {label}: page 0 written"
        assert not _same_bytes(k1, k), f"page_copy {label}: pool not updated in place"
        if label != "probe":
            continue
        ms = time_ms(lambda: m.page_copy(k1, v1, tables, nk, nv))
        plain_ms = time_ms(lambda: m.page_copy_plain(k2, v2, tables, nk, nv))
        kp, vp, idx = k1.view(num_pages, -1), v1.view(num_pages, -1), tables.long()
        fk, fv = nk.view(n, -1), nv.view(n, -1)

        def lib():
            kp.index_copy_(0, idx, fk)
            vp.index_copy_(0, idx, fv)

        lib_ms = time_ms(lib)
        nbytes = 2 * 2 * n * page * kw * 2 + n * 4
        b_ms, by = bound_ms(nbytes, 0.0, peaks)
        n_probe = n
    log(f"[kernel] page_copy: byte-exact at the probe's and the 8B shapes, page 0 never "
        f"written; {ms:.4f} ms for {n_probe} pages x 2 pools at the probe's shapes (plain "
        f"{plain_ms:.4f}, index_copy_ x2 {lib_ms:.4f}, bound {b_ms:.4f} by {by}; "
        f"{nbytes / ms / 1e6:.0f} GB/s moved)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


def check_bitcast(peaks, gen, dev):
    """K9's three kernels against their plain versions, byte-exact, at the
    probe's shape (int8 [32, 128], packed [8, 128]) and the 8B shape (an
    int8 pool of 16384 rows x 1024, packed [4096, 1024]); pack and unpack
    also against the view/permute bitcast, and each other's inverse; the
    inject at byte lanes 0-3 and the last row, leaving every other int8 row
    as it was. Timed at the 8B shape, each against one PyTorch call: the
    view/permute bitcast, and a byte-view slice assignment for the inject."""
    from dynamo_tpu_torch.scripts import probe_bitcast as m

    def lib_unpack(p):
        t, c = p.shape
        return p.view(torch.int8).view(t, c, 4).permute(0, 2, 1).reshape(4 * t, c)

    def lib_pack(r):
        t4, c = r.shape
        return r.view(t4 // 4, 4, c).permute(0, 2, 1).contiguous().view(torch.int32).view(
            t4 // 4, c)

    def lib_inject(p, row, off):
        t, c = p.shape
        p.view(torch.int8).view(t, c, 4)[off // 4, :, off % 4] = row
        return p

    for label, t4, c in (("probe", 32, 128), ("8b", 16384, 1024)):
        rows = torch.randint(-128, 128, (t4, c), generator=gen, device=dev, dtype=torch.int8)
        packed = m.pack_int8_rows(rows)
        want = m.pack_int8_rows_plain(rows)
        torch.cuda.synchronize()
        assert torch.equal(packed, want) and torch.equal(packed, lib_pack(rows)), \
            f"bitcast pack {label}: differs from the plain version"
        back = m.unpack_int8_rows(packed)
        assert torch.equal(back, m.unpack_int8_rows_plain(packed)) and torch.equal(back, rows) \
            and torch.equal(back, lib_unpack(packed)), f"bitcast unpack {label}: differs"
        row = torch.randint(-128, 128, (c,), generator=gen, device=dev, dtype=torch.int8)
        base = 4 * (t4 // 8)
        for off in (base, base + 1, base + 2, base + 3, t4 - 1):
            got = m.inject_int8_row(packed.clone(), row, off)
            want = m.inject_int8_row_plain(packed.clone(), row, off)
            rows_want = rows.clone()
            rows_want[off] = row
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"bitcast inject {label} at row {off}: differs"
            assert torch.equal(m.unpack_int8_rows_plain(got), rows_want), \
                f"bitcast inject {label} at row {off}: other rows changed"
    # times at the 8B shape
    t = packed.shape[0]
    res = {}
    for name, kern, plain, libf, nbytes in (
        ("bitcast_unpack", lambda: m.unpack_int8_rows(packed),
         lambda: m.unpack_int8_rows_plain(packed), lambda: lib_unpack(packed), 2 * packed.numel() * 4),
        ("bitcast_pack", lambda: m.pack_int8_rows(rows), lambda: m.pack_int8_rows_plain(rows),
         lambda: lib_pack(rows), 2 * rows.numel()),
        ("bitcast_inject", lambda: m.inject_int8_row(packed, row, t4 - 1),
         lambda: m.inject_int8_row_plain(packed, row, t4 - 1),
         lambda: lib_inject(packed, row, t4 - 1), 2 * c * 4 + c),
    ):
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(libf)
        b_ms, by = bound_ms(nbytes, 0.0, peaks)
        log(f"[kernel] {name}: byte-exact at the probe's and the 8B shapes; {ms:.4f} ms at the "
            f"8B shape (packed [{t}, {c}]) (plain {plain_ms:.4f}, view/permute {lib_ms:.4f}, "
            f"bound {b_ms:.4f} by {by})")
        res[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=by)
    return res


# label: (dtype, pages in the pool, page rows, row width, pages named, nbufs)
GATHER_CASES = {
    # the probe's three page types; only int8 at the probe's pool size
    # (phase 9's probe_bitcast times all three there)
    "probe-int8": (torch.int8, 16384, 128, 1024, 8192, (8,)),
    "probe-int32": (torch.int32, 1024, 32, 1024, 512, (8,)),
    "probe-bf16": (torch.bfloat16, 1024, 64, 1024, 512, (8,)),
    # 16 KB pages: the bytes of one kv head's share of a 64-row decode page
    # at the 8B shape
    "16KB-pages": (torch.bfloat16, 65536, 16, 512, 32768, (2, 8)),
    "8b": (torch.bfloat16, 256, 64, 1024, 128, (2, 4, 8, 16)),
    # profile_dma's sweep: 64-row pages, and 256-row pages (256 KB, more
    # than one ring stage at every depth)
    "sweep-64": (torch.bfloat16, 4096, 64, 512, 1024, (2, 4, 8, 16)),
    "sweep-256": (torch.bfloat16, 4096, 256, 512, 256, (2, 16)),
    "few-pages": (torch.bfloat16, 64, 16, 512, 5, (2, 16)),
}


def _bits(x):
    return x.view(torch.int32).item()


def check_page_gather(peaks, gen, dev):
    """K10 against its plain version: 0.0 (bit for bit) on finite pools at
    the probe's three page types, the 8B shape and profile_dma's sweep
    shapes at their ring depths, and fewer pages than SMs; on bf16 pools
    NaN when row 0 of a named page holds a NaN or an infinity, 0.0 when
    only row 1 of a named page or row 0 of an unnamed one does. Timed on
    the probe's int8 pages (1.07 GB of a 2.1 GB pool, past the 50 MB L2)
    against `index_select` of the same pages; its rate there and on 16 KB
    pages (512 MB of a 1 GB pool) must stay under 1.05x the card's memory
    rate."""
    from dynamo_tpu_torch.scripts import profile_dma as m

    rates = {}
    for label, (dtype, total, page, kw, n, nbufs) in GATHER_CASES.items():
        if dtype == torch.bfloat16:
            pool = torch.randn((total, page, kw), generator=gen, device=dev, dtype=dtype)
        else:
            info = torch.iinfo(dtype)
            pool = torch.randint(info.min, info.max, (total, page, kw), generator=gen,
                                 device=dev, dtype=dtype)
        tables = torch.randperm(total, generator=gen, device=dev)[:n].to(torch.int32)
        for nbuf in nbufs:
            got, want = m.page_gather(pool, tables, nbuf), m.page_gather_plain(pool, tables)
            assert _bits(got) == _bits(want) == 0, \
                f"page_gather {label} nbuf {nbuf}: {got.item()} (plain {want.item()})"
        if dtype == torch.bfloat16:
            listed = set(tables.tolist())
            named = int(tables[n // 2])
            unnamed = next(i for i in range(total) if i not in listed)
            for what, pg, r, val, poisoned in (
                ("named row 0 NaN", named, 0, float("nan"), True),
                ("named row 0 inf", named, 0, float("inf"), True),
                ("named row 1 NaN", named, 1, float("nan"), False),
                ("unnamed row 0 NaN", unnamed, 0, float("nan"), False),
            ):
                keep = pool[pg, r, 5].clone()
                pool[pg, r, 5] = val
                for nbuf in nbufs:
                    got = m.page_gather(pool, tables, nbuf)
                    want = m.page_gather_plain(pool, tables)
                    if poisoned:
                        assert got.isnan().item() and want.isnan().item(), \
                            f"page_gather {label} {what} nbuf {nbuf}: {got.item()}"
                    else:
                        assert _bits(got) == _bits(want) == 0, \
                            f"page_gather {label} {what} nbuf {nbuf}: {got.item()}"
                pool[pg, r, 5] = keep
        if label in ("probe-int8", "16KB-pages"):
            page_bytes = page * kw * pool.element_size()
            nbytes = n * page_bytes + n * 4 + 4
            ms = time_ms(lambda: m.page_gather(pool, tables, 8))
            rates[label] = n * page_bytes / ms / 1e6  # GB/s
            if label == "probe-int8":
                plain_ms = time_ms(lambda: m.page_gather_plain(pool, tables))
                idx = tables.long()
                lib_ms = time_ms(lambda: torch.index_select(pool, 0, idx))
                b_ms, by = bound_ms(nbytes, 0.0, peaks)
                k10 = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=by)
        del pool
    peak_tb = peaks[0] / 1e12
    log(f"[kernel] page_gather: 0.0 bit for bit on finite pools, NaN exactly when a named "
        f"page's row 0 holds one; {k10['ms']:.4f} ms for 8192 int8 pages [128, 1024] (plain "
        f"{k10['plain_ms']:.4f}, index_select {k10['library_ms']:.4f}, bound "
        f"{k10['bound_ms']:.4f} by {k10['bound_by']}); scattered-page rate at nbuf 8: "
        + ", ".join(f"{k} {r / 1e3:.3f} TB/s" for k, r in rates.items())
        + f" (data sheet {peak_tb:.2f} TB/s)")
    for k, r in rates.items():
        assert r < 1.05 * peaks[0] / 1e9, \
            f"page_gather {k}: {r / 1e3:.3f} TB/s is above 1.05x the card's memory rate"
    return k10


# ---------------------------------------------------------------- phase 3: W8A8

# Llama-3.1-8B's projection shapes (K, N): wq/wo, wk/wv, w_gate/w_up,
# w_down; the head (4096, 128256) at decode rows only. Rows: a decode
# step's 8 and a prefill of 8 x 512. Edge cases (M, K, N), each checked in
# f32 and bf16: a K % 128 == 96 tail in one k tile, one row, K 160 (two k
# tiles split across blocks, a 32-byte tail), 100 rows over a split "tiles"
# launch, N 8 at K 32; M 64 and 65, either side of the variants'
# threshold; K % 128 in {32, 64, 96}, the TMA box's tail past K; the
# split-K extremes, N 8 at K 4096 (one column tile, K split 32 ways) and N
# 1024 at K 14336; an odd N (single-element stores); and a mixed step's
# 2,048-row rectangle (a "tiles" launch split in two). The checkpoint's
# head is 68 wide.
W8A8_ROWS = (8, 4096)
W8A8_QUANT_K = (4096, 14336)
W8A8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
W8A8_HEAD = (4096, 128256)
W8A8_EDGES = ((17, 96, 68), (1, 128, 68), (40, 160, 200), (100, 4096, 68), (3, 32, 8),
              (64, 4096, 1024), (65, 4096, 1024),
              (8, 4128, 512), (8, 4160, 300), (130, 4192, 520), (65, 4128, 68),
              (8, 4096, 8), (8, 14336, 1024), (64, 14336, 1024),
              (9, 256, 33), (130, 256, 33),
              (2048, 4096, 1024))
# the row quantizations' rows (decode, a verify-sized batch at the variants'
# threshold, a prefill), and the fused kernels' K at the 8B shapes (the
# norms' d 4096, SiLU x up's 14336), plus their edge shapes (one row, rows
# either side of the cluster plan's threshold; K of one vector a warp and
# a slice that does not split evenly), each in bf16 and f32
W8A8_QUANT_ROWS = (8, 64, 4096)
W8A8_FUSED_K = {"rms_norm_quantize_rows": 4096, "silu_mul_quantize_rows": 14336}
W8A8_FUSED_EDGES = tuple((m, k) for m in (1, 9, 65, 130) for k in (32, 4128))
W8A8_KERNELS = ("quantize_rows", "rms_norm_quantize_rows", "silu_mul_quantize_rows", "w8a8_gemm")
# the shapes the `kernels` line reports: decode rows (into w_gate/w_up for
# the GEMM, w_down's input for SiLU x up)
W8A8_REPORT = {"quantize_rows": (8, 4096), "rms_norm_quantize_rows": (8, 4096),
               "silu_mul_quantize_rows": (8, 14336), "w8a8_gemm": (8, 4096, 14336)}


def _int8_peaks(peaks):
    """(memory bytes/s, int8 OP/s): the H100 data sheets' int8 dense rate
    is twice the bf16 one (1,979 TOP/s on the SXM part)."""
    return peaks[0], 2 * peaks[1]


def _w8a8_x(m, k, gen, dev, dtype=torch.bfloat16):
    """Rows of several magnitudes; row m // 2 all zeros (a padding row:
    scale 1.0, codes 0); row 0 holding amax 127 (scale 1.0) and the .5
    ties 2.5, -3.5, 0.5, -0.5, 126.5, which round half to even."""
    x = torch.randn((m, k), generator=gen, device=dev)
    x *= torch.rand((m, 1), generator=gen, device=dev) * 8 + 0.01
    x[m // 2] = 0.0
    x[0] = torch.randn((k,), generator=gen, device=dev)
    x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 126.5], device=dev)
    return x.to(dtype)


def _int_mm_lib(xq, xs, wq, ws, out_dtype):
    """`torch._int_mm` (cuBLASLt s8 x s8 -> s32; CUDA refuses 16 rows or
    fewer) on the rows padded to 32, then the dequantization as torch ops:
    the library yardstick of the W8A8 GEMM, never the port's path."""
    m = xq.shape[0]
    pad = torch.zeros((max(m, 32), xq.shape[1]), dtype=torch.int8, device=xq.device)
    pad[:m] = xq
    wt = wq.t()
    return lambda: (torch._int_mm(pad, wt)[:m].float() * xs[:, None] * ws).to(out_dtype)


def _fused_inputs(name, m, k, gen, dev, dtype, w_off=0.0):
    """The fused kernel's arguments and the composition it replaces (the
    torch ops, for the rows it quantizes): for the norm x (`_w8a8_x`: a
    zero row, rows of several magnitudes) and weights in [0.25, 1.75), eps
    1e-5; for SiLU x up a gate of `_w8a8_x` (its row 0 reaching 127) and
    an up of N(0, 2)."""
    from dynamo_tpu_torch.ops.norm import rms_norm

    x = _w8a8_x(m, k, gen, dev, dtype)
    if name == "rms_norm_quantize_rows":
        w = (torch.rand((k,), generator=gen, device=dev) * 1.5 + 0.25).to(dtype)
        return (x, w, 1e-5, w_off), lambda: rms_norm(x, w, 1e-5, w_off)
    up = (torch.randn((m, k), generator=gen, device=dev) * 2).to(dtype)
    return (x, up), lambda: torch.nn.functional.silu(x) * up


def check_fused(name, args, rows, what):
    """One fused kernel on `args` against its contract, launched with y
    (`trace_w8a8.fused_rows`: codes and scales equal to quantize_rows_plain
    of the kernel's y) and without (the same bytes); the norm's y within
    one bf16 ulp of rms_norm's; SiLU x up's y equal to torch's in every
    element, so its codes and scales byte-equal to the composition's.
    Returns (elements of y off torch's rows, the largest ulp step,
    elements)."""
    from dynamo_tpu_torch.ops import w8a8
    from dynamo_tpu_torch.scripts.trace_w8a8 import fused_rows

    fused = getattr(w8a8, name)
    q, s = fused(*args)
    qy, sy, steps = fused_rows(fused, lambda *_: rows(), *args)
    cq, cs = getattr(w8a8, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert _same_bytes(q, qy) and _same_bytes(s, sy), f"{what}: y changes the codes"
    off, top = int((steps > 0).sum()), int(steps.max())
    if name == "silu_mul_quantize_rows":
        assert off == 0, f"{what}: {off} elements of the rows differ from F.silu(gate) * up's"
    else:
        # one bf16 ulp: 2**16 steps of an f32
        limit = 1 if args[0].dtype == torch.bfloat16 else 1 << 16
        assert top <= limit, f"{what}: the normed rows are off rms_norm's by {top} ulps"
    if off == 0:
        assert _same_bytes(q, cq) and _same_bytes(s, cs.contiguous()), \
            f"{what}: rows equal to torch's, codes not equal to the composition's"
    return off, top, steps.numel()


# the decode chain (dynamo_tpu_torch/scripts/trace_w8a8.py `Chain`):
# W8A8_CHAIN_LAYERS layers of an 8B decode step's W8A8 work (the two norms,
# SiLU x up, the row quantizations and the seven projections at 8 rows, as
# torch ops then quantize_rows or through the fused kernels), each layer on its own
# weights (218 MB a layer, so the L2 holds none of the weights a GEMM
# reads), replayed as one CUDA graph
W8A8_CHAIN_LAYERS = 8


def w8a8_chain(gen, dev):
    """Device ms a layer of the decode chain in each composition (torch ops
    then quantize_rows, and the fused kernels), the median of 20 replays of
    each graph, in turns; raises unless every output of every layer equals
    the plain versions' run eagerly (the fused chain: its own eager run,
    checked kernel by kernel). Also returns the fused rows' elements off
    torch's."""
    from dynamo_tpu_torch.scripts.trace_w8a8 import Chain

    chain = Chain(gen, dev, W8A8_CHAIN_LAYERS)
    graphs = {mode: chain.capture(mode) for mode in chain.modes}
    times = {key: [] for key in graphs}
    for _ in range(2):
        for key, graph in graphs.items():
            times[key].append(chain.replay_ms(graph, replays=10))
    return {**{key: statistics.median(t) for key, t in times.items()},
            "rows_off": chain.rows_off}


def w8a8_ptxas():
    """Registers, spills and shared memory of each w8a8.cu kernel, from
    this run's ptxas log, the GEMM variants' dynamic shared memory beside
    (the ring, its barriers and 1 KB of alignment), and any ptxas warning
    about wgmma."""
    from dynamo_tpu_torch.ops import _cuda, w8a8

    lines, cur = [], None
    for line in _cuda.build_logs.get("w8a8", "").splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            cur = m.group(1)
            continue
        if "wgmma" in line.lower() or "warning" in line.lower():
            lines.append(f"[ptxas] w8a8: {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            lines.append(f"[ptxas] {cur}: {m.group(1)} B spill stores, {m.group(2)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            sm = re.search(r"(\d+) bytes smem", line)
            lines.append(f"[ptxas] {cur}: {m.group(1)} registers, "
                         f"{sm.group(1) if sm else 0} B static smem")
    for name, (vid, cons, bn, stages, resident) in w8a8.GEMM_VARIANTS.items():
        staging = 2 * cons * 8192 if cons == 2 else 0  # the bf16 TMA-store chunks
        smem = 1024 + stages * (64 * cons + bn) * w8a8.K_TILE + staging + 16 * stages + 16
        fit = w8a8._launcher().w8a8_occupancy(vid)
        lines.append(f"[ptxas] w8a8_gemm variant {name} (id {vid}): block {64 * cons} x {bn}, "
                     f"{stages} stages, {128 * cons + (128 if cons == 2 else 32)} threads, "
                     f"{smem} B dynamic smem; {fit} block(s) fit an SM, the plan assumes "
                     f"{resident}")
        assert fit >= resident, f"w8a8_gemm variant {name}: {fit} blocks fit an SM, not {resident}"
    return lines


def check_w8a8(peaks, gen, dev):
    """The W8A8 kernels against their plain versions, byte for byte:
    `quantize_rows` at [8 | 64 | 4096] x [4096 | 14336] bf16 (codes and
    scales); `rms_norm_quantize_rows` at [8 | 64 | 4096] x 4096 and
    `silu_mul_quantize_rows` at [8 | 64 | 4096] x 14336 bf16 and on
    W8A8_FUSED_EDGES in f32 and bf16, against their contract
    (`check_fused`), each 8B shape timed beside its bound, its plain
    version and the composition it replaces (torch ops then
    `quantize_rows`);
    `w8a8_gemm` at rows 8 and 4096 on the 8B projection shapes (bf16 out)
    and the head at 8 rows (f32 out), and both on the edge cases above (f32
    and bf16). Each 8B shape timed beside its plain version, its bound
    (bytes over the memory rate or 2MKN over the int8 rate) and, for the
    GEMM, two library calls: `torch._int_mm` on rows padded to 32 plus the
    dequantization as torch ops, and bf16 `torch.matmul` at the same shape;
    decode rows also flushed (128 MB read before each call: the L2 holds
    clean lines of another buffer and none of the weights, as behind the
    previous projection on the engine's path); then the decode chain
    (`w8a8_chain`) in CUDA graphs. Prints
    the plan of each shape, the host's cost of encoding a call's two tensor
    maps, and the ptxas report. The `kernels` line carries the decode
    shapes: quantize_rows and rms_norm_quantize_rows [8, 4096],
    silu_mul_quantize_rows [8, 14336], w8a8_gemm 8 x 4096 x 14336."""
    from dynamo_tpu_torch.ops import _cuda, w8a8
    from dynamo_tpu_torch.scripts.profile_dma import l2_flush

    for line in w8a8_ptxas():
        log(line)
    i8 = _int8_peaks(peaks)
    sms = _cuda.sm_count(dev)
    out = {}
    for m in W8A8_QUANT_ROWS:
        for k in W8A8_QUANT_K:
            x = _w8a8_x(m, k, gen, dev)
            q, s = w8a8.quantize_rows(x)
            pq, ps = w8a8.quantize_rows_plain(x)
            torch.cuda.synchronize()
            assert _same_bytes(q, pq) and _same_bytes(s, ps.contiguous()), \
                f"quantize_rows [{m}, {k}]: codes or scales differ from the plain version"
            assert q[0, :6].tolist() == [127, 2, -4, 0, 0, 126] and s[m // 2].item() == 1.0
            ms = time_ms(lambda: w8a8.quantize_rows(x))
            plain_ms = time_ms(lambda: w8a8.quantize_rows_plain(x))
            b_ms, by = bound_ms(m * k * 2 + m * k + 4 * m, 0.0, peaks)
            log(f"[kernel] quantize_rows [{m}, {k}] bf16 ({w8a8.quant_plan(m, k, sms)}): codes "
                f"and scales byte-equal; {ms:.4f} ms (plain {plain_ms:.4f}, bound {b_ms:.4f} by "
                f"{by}, {100 * b_ms / ms:.0f}% of it)")
            if (m, k) == W8A8_REPORT["quantize_rows"]:
                out["quantize_rows"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                            library_ms=None, bound_ms=b_ms, bound_by=by)
    for name, k in W8A8_FUSED_K.items():
        fused, plain = getattr(w8a8, name), getattr(w8a8, name + "_plain")
        for m in W8A8_QUANT_ROWS:
            args, rows = _fused_inputs(name, m, k, gen, dev, torch.bfloat16)
            off, top, n = check_fused(name, args, rows, f"{name} [{m}, {k}] bf16")
            ms = time_ms(lambda: fused(*args))
            plain_ms = time_ms(lambda: plain(*args))
            comp_ms = time_ms(lambda: w8a8.quantize_rows(rows()))
            reads = (2 if name == "silu_mul_quantize_rows" else 1) * m * k * 2
            b_ms, by = bound_ms(reads + (2 * k if name == "rms_norm_quantize_rows" else 0)
                                + m * k + 4 * m, 0.0, peaks)
            plan = w8a8.quant_plan(m, k, sms, 2, w8a8.DECODE_CLUSTER[name])
            log(f"[kernel] {name} [{m}, {k}] bf16 ({plan}): codes and "
                f"scales byte-equal to quantize_rows_plain of its own rows, with y and without; "
                f"its rows against torch's: {off} of {n} elements differ, by at most {top} "
                f"ulp; {ms:.4f} ms (plain {plain_ms:.4f}, torch ops then quantize_rows "
                f"{comp_ms:.4f}, bound {b_ms:.4f} by {by}, {100 * b_ms / ms:.0f}% of it)")
            if (m, k) == W8A8_REPORT[name]:
                out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                                 bound_ms=b_ms, bound_by=by)
        edges = []
        for m, k in W8A8_FUSED_EDGES:
            for dtype in (torch.float32, torch.bfloat16):
                args, rows = _fused_inputs(name, m, k, gen, dev, dtype, w_off=float(m % 2))
                off, top, n = check_fused(name, args, rows, f"{name} [{m}, {k}] {dtype}")
                edges.append(f"[{m}, {k}] {str(dtype)[6:]} {off}/{n} off by <= {top}")
        offsets = " (weight offset 1.0 at odd M)" if name == "rms_norm_quantize_rows" else ""
        log(f"[kernel] {name} edge cases{offsets}: codes and scales "
            f"byte-equal to quantize_rows_plain of its own rows; rows against torch's: "
            + "; ".join(edges))
    for m, k, n in W8A8_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            x = _w8a8_x(m, k, gen, dev, dtype)
            q, s = w8a8.quantize_rows(x)
            pq, ps = w8a8.quantize_rows_plain(x)
            wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
            ws = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-4
            got = w8a8.w8a8_gemm(q, s, wq, ws, dtype)
            again = w8a8.w8a8_gemm(q, s, wq, ws, dtype)
            want = w8a8.w8a8_gemm_plain(pq, ps.contiguous(), wq, ws, dtype)
            torch.cuda.synchronize()
            assert _same_bytes(q, pq) and _same_bytes(s, ps.contiguous()), \
                f"quantize_rows [{m}, {k}] {dtype}: differs from the plain version"
            plan = w8a8.gemm_plan(m, n, k, sms)
            assert _same_bytes(got, want) and _same_bytes(again, want), \
                f"w8a8_gemm {m} x {k} x {n} ({dtype}, {plan.variant}, {plan.splits} splits) differs"
    log(f"[kernel] W8A8 edge cases byte-equal (f32 and bf16 in and out, each GEMM launched "
        f"twice): (M, K, N, variant, splits) in "
        + str([(m, k, n, (p := w8a8.gemm_plan(m, n, k, sms)).variant, p.splits)
               for m, k, n in W8A8_EDGES]))
    try:
        torch._int_mm(torch.zeros((8, 4096), dtype=torch.int8, device=dev),
                      torch.zeros((4096, 4096), dtype=torch.int8, device=dev).t())
        log("[kernel] torch._int_mm takes 8 rows on this card")
    except RuntimeError as e:
        log(f"[kernel] torch._int_mm refuses 8 rows on this card: {str(e).splitlines()[0]}")
    flush = l2_flush(dev)
    cases = [(m, k, n, torch.bfloat16) for m in W8A8_ROWS for k, n in W8A8_SHAPES]
    cases.append((8, *W8A8_HEAD, torch.float32))
    for m, k, n, od in cases:
        xq, xs = w8a8.quantize_rows(_w8a8_x(m, k, gen, dev))
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-4
        got = w8a8.w8a8_gemm(xq, xs, wq, ws, od)
        want = w8a8.w8a8_gemm_plain(xq, xs, wq, ws, od)
        torch.cuda.synchronize()
        assert _same_bytes(got, want), f"w8a8_gemm {m} x {k} x {n}: differs from the plain version"
        plan = w8a8.gemm_plan(m, n, k, sms)
        ms = time_ms(lambda: w8a8.w8a8_gemm(xq, xs, wq, ws, od))
        plain_ms = time_ms(lambda: w8a8.w8a8_gemm_plain(xq, xs, wq, ws, od))
        int_mm = _int_mm_lib(xq, xs, wq, ws, od)
        try:
            lib = int_mm()
        except RuntimeError as e:  # the yardstick only: the port never calls it
            log(f"[kernel] torch._int_mm refuses {m} x {k} x {n}: {str(e).splitlines()[0]}")
            lib_ms = None
        else:
            torch.cuda.synchronize()
            assert _same_bytes(lib, want), f"_int_mm + dequant {m} x {k} x {n}: differs"
            lib_ms = time_ms(int_mm)
            del lib
        xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        wb = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        bf16_ms = time_ms(lambda: torch.matmul(xb, wb))
        del xb, wb
        nbytes = m * k + n * k + 4 * (m + n) + m * n * got.element_size()
        b_ms, by = bound_ms(nbytes, 2.0 * m * n * k, i8)
        cold = ""
        if m <= w8a8.ROWS_MAX:
            c_ms = time_ms(lambda: w8a8.w8a8_gemm(xq, xs, wq, ws, od), flush=flush)
            cold = f"; flushed {c_ms:.4f}, {100 * b_ms / c_ms:.0f}% of the bound"
        log(f"[kernel] w8a8_gemm {m} x {k} x {n} ({str(od)[6:]} out, {plan.variant}, "
            f"{plan.splits} split(s), {plan.blocks} blocks): byte-equal; {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, _int_mm + dequant {lib_ms}, bf16 matmul {bf16_ms:.4f}, bound "
            f"{b_ms:.4f} by {by}, {100 * b_ms / ms:.0f}% of it; {2e-9 * m * n * k / ms:.0f} "
            f"TOP/s{cold})")
        if (m, k, n) == W8A8_REPORT["w8a8_gemm"]:
            out["w8a8_gemm"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                    bound_ms=b_ms, bound_by=by)
        del xq, xs, wq, ws, got, want
    ms = w8a8_chain(gen, dev)
    log(f"[kernel] W8A8 decode chain ({W8A8_CHAIN_LAYERS} layers of 8B projections at 8 rows, "
        f"2 norms, SiLU x up, 4 row quantizations and 7 GEMMs a layer, one CUDA graph, weights "
        f"past the L2): torch ops then quantize_rows {ms['composed'] * 1e3:.1f} us a layer "
        f"(every output byte-equal to the plain versions'), the fused kernels "
        f"{ms['fused'] * 1e3:.1f} us (every output byte-equal to their eager run, whose codes "
        f"equal quantize_rows_plain of their rows; those rows against torch's: "
        f"{ms['rows_off']}; the most blocks a decode row is split across, by kernel: "
        f"{w8a8.DECODE_CLUSTER})")
    xq = torch.zeros((4096, 4096), dtype=torch.int8, device=dev)
    enc = w8a8._launcher().w8a8_encode_us(xq.data_ptr(), xq.data_ptr(), 4096, 4096, 4096, 1000)
    assert enc >= 0, "the GEMM's tensor maps do not encode"
    log(f"[kernel] w8a8_gemm host cost of a call's two tensor maps (cuTensorMapEncodeTiled, "
        f"mean of 1000): {enc:.3f} us")
    return out


# ------------------------------------------------------- phase 3: the KV quantizer's division

# f32 amax values at which amax / d and amax * (1 / d) differ in f32, for
# d = 127 (int8 KV) and d = 7 (int4 KV): 0.143 is one for both
KV_DIV_EDGES = (0.143, 0.141011, 0.141, 0.00878906)


def _kv_quant_parent(rows, kh, int4):
    """The KV quantizer's scales as the parent commit computed them (a
    tensor divided by a Python scalar): on CUDA, the reciprocal's product."""
    hd = rows.shape[-1] // kh
    d = 7.0 if int4 else 127.0
    amax = rows.float().reshape(*rows.shape[:-1], kh, hd).abs().amax(dim=-1)
    return torch.where(amax > 0, amax / d, 1.0)


def check_kv_division(dev):
    """`quantize_kv_rows` and `quantize_kv_rows_int4` on the card against
    the same calls on the CPU (which divides truly), byte for byte in rows
    and scales, at the 8B decode shape [2, 8, K * Hd] and a prefill shape
    [512, K * Hd] (K 8, Hd 128), f32 and bf16, on inputs whose heads have
    the amax values of KV_DIV_EDGES; prints how many scales the parent's
    division gets wrong on the same inputs."""
    from dynamo_tpu_torch.ops import quant

    kh, hd = 8, 128
    rng = np.random.RandomState(5)
    for shape in ((2, 8, kh * hd), (512, kh * hd)):
        x = rng.uniform(-1, 1, size=shape).astype(np.float32)
        heads = x.reshape(-1, kh, hd)
        heads *= rng.uniform(0.005, 0.2, size=heads.shape[:2] + (1,)).astype(np.float32)
        edges = np.array(KV_DIV_EDGES, dtype=np.float32)
        flat = heads.reshape(-1, hd)
        for i in range(len(flat)):  # every other head takes an edge amax, at a varying feature
            if i % 2 == 0:
                flat[i] *= 0.99 * edges[(i // 2) % len(edges)] / np.abs(flat[i]).max()
                flat[i, (i * 7) % hd] = edges[(i // 2) % len(edges)] * (1 if i % 4 else -1)
        for dtype in (torch.float32, torch.bfloat16):
            rows_cpu = torch.from_numpy(x).to(dtype)
            rows_dev = rows_cpu.to(dev)
            for int4 in (False, True):
                fn = quant.quantize_kv_rows_int4 if int4 else quant.quantize_kv_rows
                gq, gs = fn(rows_dev, kh)
                wq, wsc = fn(rows_cpu, kh)
                torch.cuda.synchronize()
                assert _same_bytes(gq.cpu(), wq) and _same_bytes(gs.cpu(), wsc), \
                    f"KV quantizer {'int4' if int4 else 'int8'} {shape} {dtype}: the card's " \
                    "rows or scales differ from the CPU's"
                par = _kv_quant_parent(rows_dev, kh, int4).cpu()
                bad = int((par.view(torch.int32) != wsc.view(torch.int32)).sum())
                log(f"[kernel] KV quantizer {'int4' if int4 else 'int8'} {list(shape)} "
                    f"{str(dtype)[6:]}: card == CPU in rows and scales ({gs.numel()} scales); "
                    f"the parent's division by a Python scalar gets {bad} scales wrong here")


# ---------------------------------------------------------------- phases 4-7


BF16_KERNELS = ("kv_write", "prefill_attention", "decode_attention")
INT8_KERNELS = ("kv_write_q", "prefill_attention_q", "decode_attention_q")
INT4_KERNELS = ("kv_write_q4", "prefill_attention_q4", "decode_attention_q4")
PATH_KERNELS = {None: BF16_KERNELS, "int8": INT8_KERNELS, "int4": INT4_KERNELS}
# int4 with scale groups finer than head_dim (phase 17): the grouped forms
INT4G_KERNELS = ("kv_write_q4g", "prefill_attention_q4g", "decode_attention_q4g")
LAUNCH_KERNELS = {**PATH_KERNELS, "int4g": INT4G_KERNELS}
# K4, the ragged read of mixed and verify steps, in each KV format
RAGGED_KERNEL = {None: "ragged_attention", "int8": "ragged_attention_q",
                 "int4": "ragged_attention_q4", "int4g": "ragged_attention_q4g"}


def kv_fmt(conf) -> str:
    """An engine config's KV format as the launch tables name it: None,
    "int8", "int4", or "int4g" for int4 with scale groups finer than
    head_dim."""
    q = conf.kv_quantization
    if q == "int4" and conf.kv_quant_group and conf.kv_quant_group < conf.model_config().head_dim:
        return "int4g"
    return q


def counters():
    """kernel name -> (wrapper, its launch counter, the plain version)."""
    from dynamo_tpu_torch.ops import decode_attention as d
    from dynamo_tpu_torch.ops import kv_write as w
    from dynamo_tpu_torch.ops import prefill_attention as p
    from dynamo_tpu_torch.ops import w8a8 as q
    from dynamo_tpu_torch.scripts import probe_bitcast as pb
    from dynamo_tpu_torch.scripts import profile_dma as pd
    from dynamo_tpu_torch.scripts import proto_page_write as pw

    return {
        "kv_write": (w.paged_kv_write, "launches", w.paged_kv_write_plain),
        "prefill_attention": (p.flash_prefill_attention, "launches",
                              p.flash_prefill_attention_plain),
        "decode_attention": (d.fused_paged_decode_attention, "launches",
                             d.fused_paged_decode_attention_plain),
        "kv_write_q": (w.paged_kv_write, "launches_q", w.paged_kv_write_q_plain),
        "prefill_attention_q": (p.flash_prefill_attention, "launches_q",
                                p.flash_prefill_attention_q_plain),
        "decode_attention_q": (d.fused_paged_decode_attention, "launches_q",
                               d.fused_paged_decode_attention_q_plain),
        "kv_write_q4": (w.paged_kv_write, "launches_q4", w.paged_kv_write_q4_plain),
        "prefill_attention_q4": (p.flash_prefill_attention, "launches_q4",
                                 p.flash_prefill_attention_q4_plain),
        "decode_attention_q4": (d.fused_paged_decode_attention, "launches_q4",
                                d.fused_paged_decode_attention_q4_plain),
        "ragged_attention": (d.ragged_paged_attention, "launches",
                             d.ragged_paged_attention_plain),
        "ragged_attention_q": (d.ragged_paged_attention, "launches_q",
                               d.ragged_paged_attention_q_plain),
        "ragged_attention_q4": (d.ragged_paged_attention, "launches_q4",
                                d.ragged_paged_attention_q4_plain),
        "kv_write_q4g": (w.paged_kv_write, "launches_q4g", w.paged_kv_write_q4g_plain),
        "prefill_attention_q4g": (p.flash_prefill_attention, "launches_q4g",
                                  p.flash_prefill_attention_q4g_plain),
        "decode_attention_q4g": (d.fused_paged_decode_attention, "launches_q4g",
                                 d.fused_paged_decode_attention_q4g_plain),
        "ragged_attention_q4g": (d.ragged_paged_attention, "launches_q4g",
                                 d.ragged_paged_attention_q4g_plain),
        "page_copy": (pw.page_copy, "launches", pw.page_copy_plain),
        "bitcast_unpack": (pb.unpack_int8_rows, "launches", pb.unpack_int8_rows_plain),
        "bitcast_pack": (pb.pack_int8_rows, "launches", pb.pack_int8_rows_plain),
        "bitcast_inject": (pb.inject_int8_row, "launches", pb.inject_int8_row_plain),
        "page_gather": (pd.page_gather, "launches", pd.page_gather_plain),
        "quantize_rows": (q.quantize_rows, "launches", q.quantize_rows_plain),
        "rms_norm_quantize_rows": (q.rms_norm_quantize_rows, "launches",
                                   q.rms_norm_quantize_rows_plain),
        "silu_mul_quantize_rows": (q.silu_mul_quantize_rows, "launches",
                                   q.silu_mul_quantize_rows_plain),
        "w8a8_gemm": (q.w8a8_gemm, "launches", q.w8a8_gemm_plain),
    }


def reset_counts():
    for kern, attr, plain in counters().values():
        setattr(kern, attr, 0)
        plain.calls = 0


def read_counts():
    return {n: (getattr(k, attr), p.calls) for n, (k, attr, p) in counters().items()}


def path_launches(stats, layers, decode_steps, kv_quant, w8a8=False, act="silu", moe=False):
    """The launches the engine's own dispatch counters (`phase_stats`
    deltas) imply: K1/K2 (or their quantized forms) once a layer per
    standalone prefill dispatch, K3/K5 once a layer per decode step, K4
    once a layer per mixed step and per standalone verify dispatch. With
    W8A8 weights every model step (each of those, one forward and one
    head each) quantizes 4 inputs a layer and the head's: the two norms'
    outputs by rms_norm_quantize_rows, a SiLU model's SiLU x up by
    silu_mul_quantize_rows (another activation's by quantize_rows), the
    attention output and the head's input by quantize_rows; and runs 7
    GEMMs a layer and the head's. An MoE layer (`moe`) launches the same
    attention and KV kernels; under W8A8 its router and experts stay bf16,
    so a step quantizes the attention norm's output (rms_norm_quantize_rows)
    and the attention output a layer and the head's input, and runs 4
    GEMMs a layer and the head's."""
    write, prefill, decode = LAUNCH_KERNELS[kv_quant]
    want = {
        write: layers * stats["prefill_dispatches"],
        prefill: layers * stats["prefill_dispatches"],
        decode: layers * stats["decode_dispatches"] * decode_steps,
        RAGGED_KERNEL[kv_quant]: layers * (stats["mixed_steps"] + stats["spec_dispatches"]),
    }
    if w8a8:
        steps = (stats["prefill_dispatches"] + stats["decode_dispatches"] * decode_steps
                 + stats["mixed_steps"] + stats["spec_dispatches"])
        silu = act == "silu"
        if moe:
            want["rms_norm_quantize_rows"] = layers * steps
            want["quantize_rows"] = (layers + 1) * steps
            want["w8a8_gemm"] = (4 * layers + 1) * steps
        else:
            want["rms_norm_quantize_rows"] = 2 * layers * steps
            want["silu_mul_quantize_rows"] = layers * steps if silu else 0
            want["quantize_rows"] = ((1 if silu else 2) * layers + 1) * steps
            want["w8a8_gemm"] = (7 * layers + 1) * steps
    return {k: n for k, n in want.items() if n}


def check_counts(counts, want, what):
    """Every kernel in `want` launched exactly that often (and at least
    once), every other kernel never, and no plain version at all."""
    for name, (launches, plain) in counts.items():
        n = want.get(name, 0)
        assert launches == n and (n > 0 or name not in want), \
            f"{what}: {name} launched {launches} times, expected {n}"
        assert plain == 0, f"{what}: the plain version of {name} ran {plain} times"


async def run_requests(engine, prompts, osl, metas=None, embeds=None):
    """Serve `prompts` at once (greedy, `osl` tokens each). Returns each
    request's (tokens, TTFT s, finish reason, end time) and the wall;
    `metas`, when given, receives each request's first-frame meta, in
    prompt order; `embeds`, when given, each prompt's (prompt_embeds,
    embeds_offset) or None (phase 16)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    async def one(ids, emb):
        pre = PreprocessedRequest(
            token_ids=list(ids),
            stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
            sampling_options=SamplingOptions(greedy=True),
            prompt_embeds=None if emb is None else emb[0],
            embeds_offset=0 if emb is None else emb[1],
        )
        t0 = time.perf_counter()
        toks, t_first, reason, meta = [], None, None, None
        async for f in await engine.generate(Context(pre.to_dict())):
            if f.get("token_ids") and t_first is None:
                t_first = time.perf_counter()
                meta = f.get("meta")
            toks.extend(f.get("token_ids") or [])
            reason = f.get("finish_reason") or reason
        return toks, t_first - t0, reason, time.perf_counter(), meta

    t0 = time.perf_counter()
    res = await asyncio.gather(*[one(p, e) for p, e in zip(prompts, embeds or [None] * len(prompts))])
    if metas is not None:
        metas.extend(r[4] for r in res)
    return [r[:4] for r in res], time.perf_counter() - t0


def phase_real_weights(dev):
    from dynamo_tpu_torch import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.tokenizer import HuggingFaceTokenizer
    from dynamo_tpu_torch.models.weights import load_config

    tok = HuggingFaceTokenizer.from_file(CKPT)
    encode = tok.encode
    prompt = "the capital of france is"
    ids = encode(prompt)
    n = 16
    texts = {}

    def engine(device, dtype, kv_quant, **kw):
        cfg = dict(page_size=16, num_pages=64, prefill_chunk=32)
        if kw.get("page_size", 16) != 16:
            cfg["num_pages"] = 64 * 16 // kw["page_size"]
        cfg.update(kw)
        return TorchEngine(EngineConfig(
            model=load_config(CKPT), checkpoint_dir=CKPT, dtype=dtype, max_batch_size=4,
            max_model_len=256, decode_steps=4, kv_quantization=kv_quant, **cfg,
        ), device=device)

    def run(device, dtype, kv_quant, **kw):
        eng = engine(device, dtype, kv_quant, **kw)

        async def go():
            (res,), _ = await run_requests(eng, [ids], n)
            await eng.close()
            return res[0]

        return asyncio.run(go())

    # each KV format at page 16, and int8 KV at page 3 (K 2: scale tiles of
    # 24 bytes, which K7 copies in 4-byte words)
    for kv_quant, page in [(q, 16) for q in PATH_KERNELS] + [("int8", 3)]:
        names = PATH_KERNELS[kv_quant]
        odd = dict(page_size=page, prefill_chunk=48) if page != 16 else {}
        ref = run("cpu", "float32", kv_quant, **odd)
        reset_counts()
        got = run(dev, "bfloat16", kv_quant, **odd)
        counts = read_counts()
        text = tok.decode(got)
        texts[(kv_quant, page)] = text
        kv = (kv_quant or "bf16") + (f" (page {page})" if odd else "")
        log(f"[real] tiny-trained-llama bf16, {kv} KV on {dev}: {prompt!r} -> {text!r}; cpu f32 "
            f"reference agrees on {sum(a == b for a, b in zip(got, ref))}/{n}; launches {counts}")
        assert len(got) == n, f"expected {n} tokens, got {len(got)}"
        assert text.startswith("paris"), f"real checkpoint ({kv} KV) answered {text!r}"
        assert got[:8] == ref[:8], f"GPU bf16 {got} vs CPU f32 {ref} ({kv} KV)"
        for name, (launches, plain) in counts.items():
            assert (launches > 0) == (name in names) and plain == 0, \
                f"real-weights path, {kv} KV: {name} launches {launches}, plain {plain}"

    # mixed steps and speculative decoding on the same checkpoint: three
    # requests at once, a 144-token prompt prefilling in chunks beside the
    # others' decode rows; the text repeats, so the proposer drafts
    line = encode(" ".join(["the capital of germany is berlin . berlin is the capital "
                            "of germany ."] * 6))
    traffic = [(line[:30], 24), (line + line[:60], 12), (ids, 12)]

    def serve(kv_quant, **kw):
        eng = engine(dev, "bfloat16", kv_quant, **kw)

        async def go():
            outs = await asyncio.gather(*[run_requests(eng, [p], n) for p, n in traffic])
            await eng.close()
            return [r[0][0][0] for r in outs]

        return asyncio.run(go()), eng

    # the prefix cache on the checkpoint: a prompt of 3 pages + 3 tokens
    # served cold, then warm over its 3 cached pages (the tail prefill
    # starts at the page boundary, K2/K6 reading the reused pages), must
    # stream the same tokens in each KV format
    prompt = line[:3 * 16 + 3]
    for kv_quant in PATH_KERNELS:
        kv = kv_quant or "bf16"
        eng = engine(dev, "bfloat16", kv_quant)

        async def go():
            metas = []
            (cold,), _ = await run_requests(eng, [prompt], n, metas)
            (warm,), _ = await run_requests(eng, [prompt], n, metas)
            await eng.close()
            return cold[0], warm[0], [m["prefix_cached_tokens"] for m in metas]

        reset_counts()
        cold, warm, cached = asyncio.run(go())
        counts = read_counts()
        st = eng.phase_stats
        log(f"[real] prefix cache, {kv} KV: cold then warm over {cached[1]} cached tokens, "
            f"streams equal: {warm == cold}; prefix_hits {st['prefix_hits']}, prefill tokens "
            f"{st['prefill_tokens']}")
        assert cached == [0, 3 * 16], f"prefix cache, {kv} KV: cached tokens {cached}"
        assert warm == cold, f"prefix cache, {kv} KV: warm {warm} vs cold {cold}"
        check_counts(counts, path_launches(st, eng.model_cfg.num_layers, 4, kv_quant),
                     f"real weights, prefix cache, {kv} KV")

    for kv_quant in PATH_KERNELS:
        kv = kv_quant or "bf16"
        want, _ = serve(kv_quant)
        reset_counts()
        got, eng = serve(kv_quant, mixed_batching=True, mixed_step_tokens=64, spec_decode=True)
        counts = read_counts()
        st = eng.phase_stats
        log(f"[real] mixed + spec, {kv} KV, 3 requests at once: streams equal to both off: "
            f"{got == want}; " + json.dumps({k: st[k] for k in MIXED_STATS})
            + f"; launches {json.dumps({k: v[0] for k, v in counts.items() if v[0]})}")
        assert got == want, f"mixed + spec streams differ from both off ({kv} KV): {got} vs {want}"
        assert st["mixed_steps"] > 0 and st["spec_rows"] > 0, f"no mixed or verify rows ({kv} KV)"
        check_counts(counts, path_launches(st, eng.model_cfg.num_layers, 4, kv_quant),
                     f"real weights, mixed + spec, {kv} KV")
        assert counts[RAGGED_KERNEL[kv_quant]][0] > 0

    # W8A8 weights on the checkpoint (the head is N = 68 wide: a ragged
    # edge tile), in bf16 and int8 KV: the card's stream must equal the CPU
    # port's W8A8 stream in bf16 (the row quantization and the GEMMs are
    # exact, byte-equal to their plain versions), through the launches the
    # dispatch counters imply and no plain call
    for kv_quant in (None, "int8"):
        kv = kv_quant or "bf16"
        ref = run("cpu", "bfloat16", kv_quant, quantization="int8")
        ref32 = run("cpu", "float32", kv_quant, quantization="int8")
        eng = engine(dev, "bfloat16", kv_quant, quantization="int8")

        async def go():
            (res,), _ = await run_requests(eng, [ids], n)
            await eng.close()
            return res[0]

        reset_counts()
        got = asyncio.run(go())
        counts = read_counts()
        text = tok.decode(got)
        log(f"[real] W8A8 weights, {kv} KV on {dev}: {tok.decode(ids)!r} -> {text!r}; equal to "
            f"the CPU port's bf16 W8A8 stream: {got == ref}; its f32 W8A8 stream agrees on "
            f"{sum(a == b for a, b in zip(got, ref32))}/{n}; launches "
            f"{json.dumps({k: v[0] for k, v in counts.items() if v[0]})}")
        assert got == ref, f"W8A8 ({kv} KV): card {got} vs CPU {ref}"
        assert text.startswith("paris"), f"W8A8 ({kv} KV) answered {text!r}"
        check_counts(counts, path_launches(eng.phase_stats, eng.model_cfg.num_layers, 4, kv_quant,
                                           w8a8=True, act=eng.model_cfg.hidden_act),
                     f"real weights, W8A8, {kv} KV")
    return texts[(None, 16)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_real_http(want: str, timeout_s: float = 300.0, extra=()) -> None:
    """Phase 4 through the serving entry: `python -m dynamo_tpu_torch.run
    in=http out=torch` on the vendored checkpoint as a subprocess on the
    card (its default flags: bf16, page 16, the step pipeline on), whose
    greedy streamed completion of "the capital of france is" must equal
    the text the engine streamed in phase 4 (`want`). A non-zero exit or a
    timeout fails; the server is stopped in every case."""
    from dynamo_tpu_torch.llm.http import client

    port = free_port()
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http", "out=torch",
           "--model-path", os.path.relpath(CKPT, ROOT), "--http-host", "127.0.0.1",
           "--http-port", str(port), "--num-pages", "256", *extra]
    t0 = time.perf_counter()
    out = tempfile.TemporaryFile("w+")  # a file, not a pipe nobody drains
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, text=True)

    async def go():
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the server exited with {proc.returncode}")
            try:
                reply = await client.request("127.0.0.1", port, "GET", "/health")
                health = await reply.json()
                if reply.status == 200:
                    break
            except OSError:
                pass
            await asyncio.sleep(0.5)
        up = time.perf_counter() - t0
        reply = await client.request("127.0.0.1", port, "POST", "/v1/completions", {
            "model": health["models"][0], "prompt": "the capital of france is",
            "max_tokens": 16, "temperature": 0, "stream": True})
        assert reply.status == 200, f"HTTP {reply.status}"
        msgs = [m async for _, m in reply.sse()]
        assert msgs and msgs[-1].done, "the SSE stream did not end with [DONE]"
        chunks = [m.json() for m in msgs if m.data is not None]
        text = "".join(c["text"] for ch in chunks for c in ch["choices"])
        usage = [ch["usage"] for ch in chunks if ch.get("usage")]
        return up, text, usage

    try:
        up, text, usage = asyncio.run(asyncio.wait_for(go(), timeout_s))
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        out.seek(0)
        log("[real-http] server output (tail):\n" + "\n".join(out.read().splitlines()[-30:]))
        raise
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        out.close()
    log(f"[real-http] {' '.join(cmd[1:])}: up in {up:.1f} s; greedy completion {text!r}, "
        f"usage {usage}; equal to the engine's stream in phase 4: {text == want}")
    assert usage and usage[-1]["completion_tokens"] == 16, usage
    assert text == want, f"HTTP completion {text!r} vs the engine's {want!r}"


MIXED_STATS = ("mixed_steps", "mixed_decode_rows", "mixed_prefill_tokens",
               "mixed_step_tokens_max", "mixed_spec_rows", "spec_dispatches", "spec_rows",
               "spec_drafted", "spec_accepted", "spec_emitted", "prefill_dispatches",
               "decode_dispatches")


# the host calls that launch one eager kernel: cudaLaunchKernel* (the
# port's kernels and torch's; ExC for the W8A8 GEMM's programmatic
# dependent launches) and cuLaunchKernel* (cuBLAS's GEMMs)
EAGER_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                  "cuLaunchKernelEx")


async def profile_round(engine, prompts):
    """Device busy share, the kernels that take the device time and the
    host ops that take the host's (self CPU time, with the calls that wait
    for the device), over one round of requests traced by torch.profiler
    (after the measured run, so the trace costs the measurement nothing)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        await run_requests(engine, prompts, 16)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.self_cpu_time_total, e.key, e.count))
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {
        # host launch calls in the round: one per eager kernel, one
        # cudaGraphLaunch per replayed decode dispatch
        "launch_calls": {k: n for _, k, n in host if k in EAGER_LAUNCHES + ("cudaGraphLaunch",)},
        "window_ms": window_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / window_us,
        "top": [
            {"name": k[:80], "ms": us / 1e3, "share": us / busy, "calls": n}
            for us, k, n in rows[:12]
        ],
        "host_top": [
            {"name": k[:60], "self_ms": us / 1e3, "calls": n}
            for us, k, n in sorted(host, reverse=True)[:12]
        ],
        "host_waits": {
            k: n for _, k, n in host
            if any(w in k for w in ("Synchronize", "Memcpy", "local_scalar", "aten::item"))
        },
    }


class GcPauses:
    """The garbage collector's pauses inside a window (`gc.callbacks`):
    a pause inside a dispatch's host enqueue delays that dispatch, so
    TTFT outliers are read beside these."""

    def __init__(self):
        self.pauses, self._t0 = [], 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"], 1e3 * (time.perf_counter() - self._t0)))

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self, prefix="gc") -> dict:
        ms = [p for _, p in self.pauses]
        return {f"{prefix}_collections": len(ms), f"{prefix}_gen2": sum(g == 2 for g, _ in self.pauses),
                f"{prefix}_ms_total": sum(ms), f"{prefix}_ms_max": max(ms, default=0.0)}


def _clone_outs(outs):
    return [None if o is None else o.clone() for o in outs]


@torch.inference_mode()
def graph_check(eng, tag):
    """Each captured decode graph against an eager run of the same
    dispatch: the eager run on clones of the pools (and of the carries and
    the penalty count rows), the replay on the originals, from the same
    inputs (the last dispatch's). The outputs (tokens, and the logprobs and
    tops where the key reports them) must be equal, the pools and count
    rows byte-equal, and the launches one replay counts equal to the eager
    run's. Greedy graphs only (a sampled dispatch draws from the
    generator, which the two runs advance)."""
    from dynamo_tpu_torch.engine import decode_graph

    graphs = eng._graphs
    assert graphs.captured(), f"{tag}: no decode graph was captured"
    kv = eng.kv
    carries = (eng._carry, eng._carry_lps, eng._carry_tid, eng._carry_tlp)
    checked = []
    for key in graphs.captured():
        width, greedy = key[:2]
        if not greedy:
            continue
        clone = kv._replace(**{f: tuple(x.clone() for x in getattr(kv, f))
                               for f in ("k", "v", "ks", "vs") if getattr(kv, f) is not None})
        saved = _clone_outs(carries)
        counts = None if eng._counts is None else eng._counts.clone()
        eng.kv = clone
        c0 = decode_graph._read_counts()
        eager = _clone_outs(eng._decode_step(*key))
        c_eager = [b - a for a, b in zip(c0, decode_graph._read_counts())]
        counts_eager = None if counts is None else eng._counts.clone()
        eng.kv = kv
        for dst, src in zip(carries, saved):
            dst.copy_(src)
        if counts is not None:
            eng._counts.copy_(counts)
        c0 = decode_graph._read_counts()
        replay = _clone_outs(graphs.replay(*key))
        c_graph = [b - a for a, b in zip(c0, decode_graph._read_counts())]
        torch.cuda.synchronize()
        for e, r in zip(eager, replay):
            assert (e is None) == (r is None), f"{tag}: graph outputs differ in kind ({key})"
            assert e is None or torch.equal(e, r), f"{tag}: graph replay differs from eager ({key})"
        for f in ("k", "v", "ks", "vs"):
            for a, b in zip(getattr(clone, f) or (), getattr(kv, f) or ()):
                assert _same_bytes(a, b), f"{tag}: pools differ after replay and eager ({f})"
        if counts is not None:
            assert torch.equal(counts_eager, eng._counts), f"{tag}: count rows differ ({key})"
        assert c_graph == c_eager and sum(c_graph) > 0, \
            f"{tag}: a replay counts {c_graph}, the eager run {c_eager}"
        checked.append(f"{key}: {sum(c_graph)} launches a replay")
    assert checked, f"{tag}: no greedy graph to check"
    return "; ".join(checked)


def decode_step_ms(d, steps):
    """Host wall a decode step takes: the dispatch walls (enqueue, with
    the graph a replay) plus the waits that land them, whether alone
    (`decode_sync_s`) or behind the next dispatch (`pipeline_overlap_s`),
    over the steps dispatched."""
    wall = d["decode_dispatch_s"] + d["decode_sync_s"] + d["pipeline_overlap_s"]
    return 1e3 * wall / max(d["decode_dispatches"] * steps, 1)


async def profile_prefill(engine, prompts):
    """One prefill dispatch alone (each prompt asks for one token) traced
    by torch.profiler. Its kernels are the eagerly launched ones: a decode
    dispatch the step pipeline starts behind it is one cudaGraphLaunch,
    and its kernels are told apart by their launch's correlation id.
    Returns the dispatch's host time as the engine's phase stats count it
    (its enqueue, under the profiler's cost), the host's span from the
    first eager launch to the last, their kernels' device busy time and
    span (busy below span: the device waited for the host), and the
    kernels that take the most of that busy time."""
    from torch.profiler import ProfilerActivity, profile

    s0 = engine.phase_stats
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        await run_requests(engine, prompts, 1)
        torch.cuda.synchronize()
    s1 = engine.phase_stats
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prefill.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in EAGER_LAUNCHES and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launches]
    by_name = {}
    for e in kernels:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"]
    host = [e["ts"] for e in launches.values()]
    busy = sum(e["dur"] for e in kernels)
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
            if kernels else 0.0)
    return {
        "prefill_dispatch_ms": 1e3 * (s1["prefill_dispatch_s"] - s0["prefill_dispatch_s"]),
        "prefill_dispatches": s1["prefill_dispatches"] - s0["prefill_dispatches"],
        "decode_dispatches": s1["decode_dispatches"] - s0["decode_dispatches"],
        "eager_launches": len(launches),
        "host_launch_span_ms": (max(host) - min(host)) / 1e3 if host else 0.0,
        "device_busy_ms": busy / 1e3,
        "device_span_ms": span / 1e3,
        "top": [{"name": k, "ms": v / 1e3} for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:6]],
    }


def phase_full_width(dev, kv_quant=None, params=None, pipe=True, quantization=None,
                     streams=None, model="llama-3.1-8b", label="8b", kv_quant_group=None):
    """Serve eight requests at full width, with the step pipeline on or
    off; returns the main path's launch counts, the metrics and the
    engine's parameters (for the next phase). `quantization="int8"` takes
    W8A8 params (phase 13); `streams`, when given, receives the measured
    round's token lists. `model` is a preset name or a ModelConfig (phase
    15's Mixtral at 16 layers), `label` its tag in the log;
    `kv_quant_group` int4's scale group (phase 17)."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine

    isl, osl, nreq = 512, 64, 8
    cfg = EngineConfig(
        model=model, dtype="bfloat16", page_size=64, num_pages=256,
        max_batch_size=8, max_model_len=2048, prefill_chunk=512, decode_steps=8, seed=0,
        kv_quantization=kv_quant, step_pipeline=pipe, quantization=quantization,
        kv_quant_group=kv_quant_group,
    )
    group = f" group {kv_quant_group}" if kv_fmt(cfg) == "int4g" else ""
    tag = (f"[{label} {'W8A8, ' if quantization else ''}{kv_quant or 'bf16'}{group} KV, "
           f"pipeline {'on' if pipe else 'off'}]")
    t0 = time.perf_counter()
    eng = TorchEngine(cfg, params=params, device=dev)
    torch.cuda.synchronize()
    kv = eng.kv
    kv_bytes = sum(x.numel() * x.element_size()
                   for pools in (kv.k, kv.v, kv.ks or (), kv.vs or ()) for x in pools)
    mc = eng.model_cfg
    log(f"{tag} {mc.name} ({mc.num_layers} layers) random init (seed 0): "
        f"{eng.param_count / 1e9:.3f} B params, {weight_bytes(eng.params) / 1e9:.3f} GB of "
        f"weights, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, KV pools "
        f"{kv_bytes / 1e9:.3f} GB ({eng.num_pages} pages of {eng.page_size}), "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    vocab = eng.model_cfg.vocab_size
    prompts = [rng.randint(0, vocab, size=isl).tolist() for _ in range(nreq)]
    warm = [rng.randint(0, vocab, size=isl).tolist() for _ in range(nreq)]
    prof_prompts = [rng.randint(0, vocab, size=isl).tolist() for _ in range(nreq)]
    prefill_prompts = [rng.randint(0, vocab, size=isl).tolist() for _ in range(nreq)]

    async def go():
        # warm-up: cuBLAS handles, the allocator, and the decode graph (one
        # eager dispatch, then its capture)
        await run_requests(eng, warm, 24)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0 = eng.phase_stats
        reset_counts()
        with GcPauses() as gcp:
            res, wall = await run_requests(eng, prompts, osl)
        counts = read_counts()
        s1 = eng.phase_stats
        prof = await profile_round(eng, prof_prompts)
        prefill = await profile_prefill(eng, prefill_prompts)
        await eng.close()
        return res, wall, counts, s0, s1, prof, prefill, gcp

    res, wall, counts, s0, s1, prof, prefill, gcp = asyncio.run(go())
    graphs = graph_check(eng, tag)
    d = {k: s1[k] - s0[k] for k in s1}
    layers = eng.model_cfg.num_layers
    for toks, _, reason, _ in res:
        assert len(toks) == osl and reason == "length", f"stream of {len(toks)} tokens ({reason})"
        assert all(0 <= t < vocab for t in toks)
    if streams is not None:
        streams.extend(r[0] for r in res)
    want = path_launches(d, layers, cfg.decode_steps, kv_fmt(cfg), w8a8=bool(quantization),
                         act=eng.model_cfg.hidden_act, moe=bool(eng.model_cfg.num_experts))
    check_counts(counts, want, tag)
    ttft = sorted(r[1] for r in res)
    first_done = min(r[1] for r in res)
    decode_window = wall - first_done
    step_ms = decode_step_ms(d, cfg.decode_steps)
    m = {
        "ttft_p50_s": statistics.median(ttft),
        "ttft_max_s": ttft[-1],
        "decode_tok_s": 1e3 * nreq / step_ms,
        "wall_s": wall,
        "output_tok_s_wall": nreq * osl / wall,
        "prefill_step_ms": 1e3 * d["prefill_dispatch_s"] / d["prefill_dispatches"],
        "prefill_dispatches": d["prefill_dispatches"],
        "decode_step_ms": step_ms,
        "decode_enqueue_ms": 1e3 * d["decode_dispatch_s"] / d["decode_dispatches"],
        "decode_dispatches": d["decode_dispatches"],
        "pipeline_overlapped": d["pipeline_overlapped"],
        "decode_window_s": decode_window,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kv_pool_gb": kv_bytes / 1e9,
        "preemptions": d["preemptions"],
        **gcp.summary(),
        "traced_prefill": prefill,
    }
    log(f"{tag} {nreq} x (ISL {isl}, OSL {osl}) through TorchEngine.generate: " + json.dumps(m))
    ptag = tag[4:-1]
    log(f"[profile] {ptag}, one more round "
        f"({nreq} x ISL {isl}, OSL 16) under torch.profiler: " + json.dumps(prof))
    log(f"[profile] {ptag}, one prefill dispatch alone ({nreq} x ISL {isl}, OSL 1) under "
        "torch.profiler: " + json.dumps(prefill))
    log(f"[profile] {ptag}, summary: "
        + json.dumps({
            "launch_calls": prof["launch_calls"], "decode_step_ms": m["decode_step_ms"],
            "ttft_p50_s": m["ttft_p50_s"], "ttft_max_s": m["ttft_max_s"],
            "output_tok_s_wall": m["output_tok_s_wall"],
            "device_busy_share": prof["device_busy_share"]}))
    log(f"{tag} graph check (eager on cloned pools, replay on the originals): tokens equal, "
        f"pools byte-equal, launches equal; {graphs}")
    log(f"{tag} launches on the main path: {json.dumps({k: v[0] for k, v in counts.items()})}; "
        f"plain calls: {json.dumps({k: v[1] for k, v in counts.items()})}")
    params = eng.params
    del eng
    return {k: v[0] for k, v in counts.items()}, m, params


# ---------------------------------------------------------------- phase 8

# phase 5's engine, with mixed steps and speculative decoding switched by
# the run; `phase_wave(cfg=...)` swaps in a small model for a CPU rehearsal
WAVE_CFG = dict(model="llama-3.1-8b", dtype="bfloat16", page_size=64, num_pages=256,
                max_batch_size=8, max_model_len=2048, prefill_chunk=512, decode_steps=8,
                seed=0, mixed_step_tokens=1024)
WAVE_TRAFFIC = dict(held=4, held_isl=512, held_osl=128, wave=4, wave_isl=512, wave_osl=64,
                    held_before=8)


async def wave_requests(engine, held, wave, held_osl, wave_osl, held_before):
    """Start the held requests; once each has streamed `held_before`
    tokens, start the wave. Returns each request's (tokens, arrival times)
    and the wave's start."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    ready = asyncio.Event()
    n_ready = [0]

    async def one(ids, osl, signal):
        pre = PreprocessedRequest(
            token_ids=list(ids), stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
            sampling_options=SamplingOptions(greedy=True))
        t0 = time.perf_counter()
        toks, times = [], []
        async for f in await engine.generate(Context(pre.to_dict())):
            for tk in f.get("token_ids") or []:
                toks.append(tk)
                times.append(time.perf_counter())
                if signal and len(toks) == held_before:
                    n_ready[0] += 1
                    if n_ready[0] == len(held):
                        ready.set()
        assert len(toks) == osl and f.get("finish_reason") == "length", \
            f"stream of {len(toks)} tokens ({f.get('finish_reason')})"
        return toks, times, t0

    t_start = time.perf_counter()
    held_tasks = [asyncio.create_task(one(p, held_osl, True)) for p in held]
    await ready.wait()
    t_wave = time.perf_counter()
    wave_res = await asyncio.gather(*[one(p, wave_osl, False) for p in wave])
    held_res = await asyncio.gather(*held_tasks)
    return held_res, wave_res, t_start, t_wave


def phase_wave(dev, params, kv_quant=None, on=True, cfg=None, traffic=None, ref_held=None,
               pipe=True):
    """Phase 8: an admission wave arriving while held streams decode, with
    mixed steps and speculative decoding on or off, and the step pipeline
    on or off. Asserts the launches the engine's dispatch counters imply,
    and no plain call. Returns the launches, the metrics, the held streams'
    tokens and the weights."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine

    tr = dict(WAVE_TRAFFIC, **(traffic or {}))
    conf = EngineConfig(**dict(WAVE_CFG, **(cfg or {})), kv_quantization=kv_quant,
                        mixed_batching=on, spec_decode=on, step_pipeline=pipe)
    group = f" group {conf.kv_quant_group}" if kv_fmt(conf) == "int4g" else ""
    tag = (f"[wave {getattr(conf.model, 'name', conf.model)} {kv_quant or 'bf16'}{group} KV, "
           f"mixed + spec {'on' if on else 'off'}, "
           f"pipeline {'on' if pipe else 'off'}]")
    eng = TorchEngine(conf, params=params, device=dev)
    rng = np.random.RandomState(1)
    vocab = eng.model_cfg.vocab_size
    held = [rng.randint(0, vocab, size=tr["held_isl"]).tolist() for _ in range(tr["held"])]
    wave = [rng.randint(0, vocab, size=tr["wave_isl"]).tolist() for _ in range(tr["wave"])]
    warm = [rng.randint(0, vocab, size=tr["wave_isl"]).tolist() for _ in range(tr["wave"])]

    async def go():
        # warm-up (cuBLAS handles, the allocator): a smaller wave behind
        # held streams of a few tokens, so the mixed path warms too
        await wave_requests(eng, warm, warm, 16, 8, 4)
        torch.cuda.synchronize()
        s0 = eng.phase_stats
        reset_counts()
        res = await wave_requests(eng, held, wave, tr["held_osl"], tr["wave_osl"],
                                  tr["held_before"])
        counts = read_counts()
        s1 = eng.phase_stats
        await eng.close()
        return res, counts, s0, s1

    (held_res, wave_res, t_start, t_wave), counts, s0, s1 = asyncio.run(go())
    d = {k: s1[k] - s0[k] for k in s1}
    d["mixed_step_tokens_max"] = s1["mixed_step_tokens_max"]
    layers = eng.model_cfg.num_layers
    check_counts(counts, path_launches(d, layers, conf.decode_steps, kv_fmt(conf),
                                       moe=bool(eng.model_cfg.num_experts)), tag)
    if on:
        assert d["mixed_steps"] > 0, f"{tag}: no mixed step ran"
    t_end = max(times[-1] for _, times, _ in wave_res)
    ttft = sorted(times[0] - t0 for _, times, t0 in wave_res)
    gaps, n_win = [], 0
    for _, times, _ in held_res:
        before = [x for x in times if x <= t_wave]
        inside = [x for x in times if t_wave < x <= t_end]
        n_win += len(inside)
        marks = before[-1:] + inside
        gaps += [b - a for a, b in zip(marks, marks[1:])]
    held_toks = [toks for toks, _, _ in held_res]
    m = {
        "wave_ttft_p50_s": statistics.median(ttft),
        "wave_ttft_max_s": ttft[-1],
        "held_max_gap_in_wave_s": max(gaps) if gaps else None,
        "held_tok_s_in_wave": n_win / (t_end - t_wave),
        "wave_window_s": t_end - t_wave,
        "wall_s": max(times[-1] for _, times, _ in held_res + wave_res) - t_start,
        **{k: d[k] for k in MIXED_STATS},
        "mixed_dispatch_ms": 1e3 * d["mixed_dispatch_s"] / max(d["mixed_steps"], 1),
        "prefill_dispatch_ms": 1e3 * d["prefill_dispatch_s"] / max(d["prefill_dispatches"], 1),
        "decode_step_ms": decode_step_ms(d, conf.decode_steps),
        **{k: d[k] for k in ("pipeline_overlapped", "mixed_carry_rows", "mixed_holds",
                             "mixed_spec_shed")},
        "spec_dispatch_ms": 1e3 * d["spec_dispatch_s"] / max(d["spec_dispatches"], 1),
    }
    if ref_held is not None:
        same = sum(a == b for x, y in zip(held_toks, ref_held) for a, b in zip(x, y))
        m["held_tokens_equal_to_off_share"] = same / sum(len(x) for x in ref_held)
    log(f"{tag} {tr['held']} held (ISL {tr['held_isl']}, OSL {tr['held_osl']}) + a wave of "
        f"{tr['wave']} (ISL {tr['wave_isl']}, OSL {tr['wave_osl']}) after {tr['held_before']} "
        f"held tokens each: " + json.dumps(m))
    log(f"{tag} launches: {json.dumps({k: v[0] for k, v in counts.items() if v[0]})}; "
        f"plain calls: {sum(v[1] for v in counts.values())}")
    params = eng.params
    del eng
    return {k: v[0] for k, v in counts.items()}, m, held_toks, params


# ---------------------------------------------------------------- phase 9

PROBE_KERNELS = ("page_copy", "bitcast_unpack", "bitcast_pack", "bitcast_inject", "page_gather")


def phase_probes(peaks, dev):
    """Phase 9, the probe path: the three probe scripts' run(dev), what
    `python -m dynamo_tpu_torch.scripts.<name>` runs once main() has found
    the GPU, in process. The launch counters are zeroed just before and
    read just after: every probe kernel must have launched. Each run checks
    its kernels against their plain versions on the card (so plain calls
    are expected here) and times K1 beside K8. K10's rates there, on the
    probe's three page types and over profile_dma's sweep, must stay under
    1.05x the card's memory rate."""
    from dynamo_tpu_torch.scripts import probe_bitcast, profile_dma, proto_page_write

    reset_counts()
    out = {}
    for mod in (proto_page_write, probe_bitcast, profile_dma):
        log(f"[probe] {mod.__name__}.run")
        out[mod] = mod.run(dev)
    counts = read_counts()
    for name in PROBE_KERNELS:
        assert counts[name][0] > 0, f"probe path: {name} never launched"
    log(f"[probe] launches on the probe path: "
        f"{json.dumps({k: v[0] for k, v in counts.items() if v[0]})}; plain calls: "
        f"{json.dumps({k: v[1] for k, v in counts.items() if v[1]})}")
    rates = {f"probe_bitcast {k}": gbs for k, gbs in out[probe_bitcast].items()}
    rates.update({f"profile_dma page {r['page']} nbuf {r['nbuf']}": r["bytes"] / r["ms"] / 1e6
                  for r in out[profile_dma]})
    for k, r in rates.items():
        assert r < 1.05 * peaks[0] / 1e9, \
            f"page_gather {k}: {r / 1e3:.3f} TB/s is above 1.05x the card's memory rate"
    return {name: counts[name][0] for name in PROBE_KERNELS}


# ---------------------------------------------------------------- phase 10

# phase 5's engine; `phase_prefix(cfg=..., traffic=...)` swaps in a small
# model and shorter prompts for a CPU rehearsal
PREFIX_CFG = dict(model="llama-3.1-8b", dtype="bfloat16", page_size=64, num_pages=256,
                  max_batch_size=8, max_model_len=2048, prefill_chunk=512, decode_steps=8,
                  seed=0)
PREFIX_TRAFFIC = dict(prefix=448, tail=64, osl=64, wave=8)


def _pool_pages(kv, pids, page):
    """Copies of pages `pids` in every pool of every layer (K, V and, with
    quantized KV, the scale pools)."""
    idx = torch.tensor(pids, device=kv.k[0].device)
    rows = (idx[:, None] * page + torch.arange(page, device=idx.device)).reshape(-1)
    out = [x.index_select(0, rows) for x in kv.k + kv.v]
    return out + [x.index_select(0, idx) for x in (kv.ks or ()) + (kv.vs or ())]


async def idle(eng):
    """Wait until the engine has landed its in-flight dispatch (with the
    step pipeline, the overshoot queued behind a round's last sync) and
    the device has drained, so the next round's TTFT does not include
    the last one's tail."""
    while eng._inflight is not None:
        await asyncio.sleep(0.001)
    torch.cuda.synchronize()


def phase_prefix(dev, params, kv_quant=None, smi="", cfg=None, traffic=None):
    """Phase 10: the prefix cache and the prefix wire at full width, with
    the step pipeline on. A seeded shared prefix of `prefix` tokens; one
    request of prefix + `tail` tokens alone (cold), then `wave` requests
    of prefix + their own tails at once (each must reuse the prefix's
    pages), then the first prompt again (all its pages cached: the last is
    released and recomputed, a full hit at the page boundary). Asserts the
    shared pages' bytes unchanged across the warm round, each prefix hash
    stored once, `export_prefix` -> `clear_cache` (its removed event) ->
    `ingest_prefix` landing the prefix through K1/K7 once a layer with no
    plain call, a byte-equal second export and a request riding the
    ingested pages, and in every serving window the launches the dispatch
    counters imply. Then a cold serve of the same `wave` prompts, whose
    tokens the warm ones are compared with (reported, not gated: at
    random 8B weights the cold and warm prefills run GEMMs of other row
    counts). Returns the metrics and the weights."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence, compute_block_hashes

    tr = dict(PREFIX_TRAFFIC, **(traffic or {}))
    conf = EngineConfig(**dict(PREFIX_CFG, **(cfg or {})), kv_quantization=kv_quant)
    tag = f"[prefix {conf.model} {kv_quant or 'bf16'} KV, pipeline on]"
    eng = TorchEngine(conf, params=params, device=dev)
    events = []
    eng.subscribe_events(events.append)
    page, layers = eng.page_size, eng.model_cfg.num_layers
    write = PATH_KERNELS[kv_quant][0]
    rng = np.random.RandomState(2)
    vocab = eng.model_cfg.vocab_size
    isl = tr["prefix"] + tr["tail"]
    prefix = rng.randint(0, vocab, size=tr["prefix"]).tolist()
    first = prefix + rng.randint(0, vocab, size=tr["tail"]).tolist()
    wave = [prefix + rng.randint(0, vocab, size=tr["tail"]).tolist() for _ in range(tr["wave"])]
    after = prefix + rng.randint(0, vocab, size=tr["tail"]).tolist()
    warmup = [rng.randint(0, vocab, size=isl).tolist() for _ in range(tr["wave"])]
    hashes = compute_block_hashes(prefix, page)
    n_pref = len(hashes) * page
    t0 = time.perf_counter()
    for p in wave:
        TokenBlockSequence(p, page)
    hash_ms = 1e3 * (time.perf_counter() - t0) / len(wave)

    def window(counts, s0, s1, what):
        d = {k: s1[k] - s0[k] for k in s1}
        check_counts(counts, path_launches(d, layers, conf.decode_steps, kv_quant),
                     f"{tag} {what}")
        return d

    async def go():
        # warm-up (cuBLAS handles, the decode graph), then an empty cache;
        # each round starts on an idle engine and device
        await run_requests(eng, warmup, 24)
        eng.allocator.clear_cache()
        await idle(eng)
        m = {"host_hash_ms_per_request": hash_ms}
        s0, metas = eng.phase_stats, []
        reset_counts()
        (cold1,), _ = await run_requests(eng, [first], tr["osl"], metas)
        pids = [eng.allocator._by_hash[h] for h in hashes]
        before = [x.clone() for x in _pool_pages(eng.kv, pids, page)]
        await idle(eng)
        p0 = eng.phase_stats["prefill_dispatch_s"]
        with GcPauses() as gc_warm:
            warm, _ = await run_requests(eng, wave, tr["osl"], metas)
        warm_enqueue_ms = 1e3 * (eng.phase_stats["prefill_dispatch_s"] - p0)
        await idle(eng)
        after_warm = _pool_pages(eng.kv, pids, page)
        assert all(_same_bytes(a, b) for a, b in zip(before, after_warm)), \
            f"{tag}: a shared prefix page changed during the warm round"
        assert eng.peek_prefix_tokens(first) == len(first) // page * page
        (full,), _ = await run_requests(eng, [first], tr["osl"], metas)
        await idle(eng)
        d = window(read_counts(), s0, eng.phase_stats, "cold, warm and full-hit serves")
        cached = [mt["prefix_cached_tokens"] for mt in metas]
        assert cached == [0] + [n_pref] * (tr["wave"] + 1), f"{tag}: cached tokens {cached}"
        hits = tr["wave"] + 1
        assert (d["prefix_hits"], d["prefix_reused_tokens"]) == (hits, hits * n_pref), d
        assert d["prefix_full_hits"] == hits and d["prefix_restored_tokens"] == 0, d
        stored = [b["block_hash"] for e in events if e["type"] == "stored" for b in e["blocks"]]
        assert all(stored.count(h) == 1 for h in hashes), f"{tag}: a prefix hash stored twice"
        m.update({
            "cold_ttft_s": cold1[1], "warm_ttft_p50_s": statistics.median(r[1] for r in warm),
            "full_hit_ttft_s": full[1], "prefill_tokens": d["prefill_tokens"],
            "prefill_tokens_cold_equivalent": (hits + 1) * isl,
            "prefix_reused_tokens": d["prefix_reused_tokens"],
            "decode_step_ms": decode_step_ms(d, conf.decode_steps),
            "warm_prefill_enqueue_ms": warm_enqueue_ms, **gc_warm.summary("warm_gc"),
        })

        # the prefix wire: export, drop the cache, ingest, export again
        wire = eng.export_prefix(prefix)
        assert wire[0] == n_pref, f"{tag}: export_prefix gave {wire[0]} tokens"
        n_ev = len(events)
        eng.allocator.clear_cache()
        removed = {h for e in events[n_ev:] if e["type"] == "removed" for h in e["block_hashes"]}
        assert set(hashes) <= removed and eng.peek_prefix_tokens(prefix) == 0
        reset_counts()
        t0 = time.perf_counter()
        n = eng.ingest_prefix(prefix, *wire[1:])
        torch.cuda.synchronize()
        m["ingest_ms"] = 1e3 * (time.perf_counter() - t0)
        check_counts(read_counts(), {write: layers}, f"{tag} ingest_prefix")
        again = eng.export_prefix(prefix)
        assert n == n_pref and again[0] == n_pref, f"{tag}: ingest {n}, export {again[0]}"
        assert all(a is b or _same_bytes(a, b) for a, b in zip(wire[1:], again[1:])), \
            f"{tag}: the exported prefix differs after export -> ingest"
        s0, metas = eng.phase_stats, []
        reset_counts()
        (rode,), _ = await run_requests(eng, [after], tr["osl"], metas)
        await idle(eng)
        window(read_counts(), s0, eng.phase_stats, "serve after ingest")
        assert metas[0]["prefix_cached_tokens"] == n_pref, metas

        # the same wave cold, for TTFT and the warm tokens' agreement
        eng.allocator.clear_cache()
        s0, metas = eng.phase_stats, []
        reset_counts()
        with GcPauses() as gc_cold:
            cold, _ = await run_requests(eng, wave, tr["osl"], metas)
        await idle(eng)
        d = window(read_counts(), s0, eng.phase_stats, "cold wave")
        assert [mt["prefix_cached_tokens"] for mt in metas] == [0] * tr["wave"]
        same = sum(a == b for x, y in zip(warm, cold) for a, b in zip(x[0], y[0]))
        m.update({
            "cold_wave_ttft_p50_s": statistics.median(r[1] for r in cold),
            "cold_wave_prefill_tokens": d["prefill_tokens"],
            "cold_wave_prefill_enqueue_ms": 1e3 * d["prefill_dispatch_s"],
            **gc_cold.summary("cold_gc"),
            "warm_tokens_equal_to_cold_share": same / sum(len(r[0]) for r in cold),
        })
        for toks, _, reason, _ in warm + cold + [cold1, full, rode]:
            assert len(toks) == tr["osl"] and reason == "length", (len(toks), reason)
        await eng.close()
        return m

    m = asyncio.run(go())
    log(f"{tag} shared prefix {tr['prefix']} tokens ({len(hashes)} pages); 1 cold request, then "
        f"{tr['wave']} at once (ISL {isl}, OSL {tr['osl']}), then the first again: shared pages "
        f"byte-unchanged, each prefix hash stored once; export -> clear -> ingest "
        f"({layers} {write} launches, no plain call) -> byte-equal export; {smi}: "
        + json.dumps(m))
    params = eng.params
    del eng
    return m, params



# ---------------------------------------------------------------- phase 11

# phase 5's engine settings as `dynamo_tpu_torch.run` flags;
# `phase_serving(flags=..., traffic=...)` swaps in a small model and
# shorter prompts for a CPU rehearsal
SERVE_PRESET = "llama-3.1-8b"
SERVE_FLAGS = ["--page-size", "64", "--num-pages", "256", "--max-batch-size", "8",
               "--max-model-len", "2048", "--prefill-chunk", "512", "--decode-steps", "8"]
SERVE_TRAFFIC = dict(n=8, isl=512, osl=64, chat_osl=16)
# the synthetic tokenizer's words: three specials, the chat template's
# words, then one word per remaining id, so that every id decodes to one
# word and every word maps back to its id
SERVE_WORDS = ["<unk>", "<s>", "</s>", "user", "assistant", "system", ":"]
SERVE_TEMPLATE = (
    "{% for m in messages %}<s>{{ m['role'] }} : {{ m['content'] | trim }}</s>\n{% endfor %}"
    "{% if add_generation_prompt %}<s>assistant :{% endif %}"
)


def serving_model_dir(path: str, preset: str, vocab: int) -> None:
    """A model dir the entry serves from seeded random weights: config.json
    naming the preset (no safetensors), a WordLevel tokenizer.json of
    `vocab` words and a tokenizer_config.json with a chat template and
    an eos token."""
    words = SERVE_WORDS + [f"w{i}" for i in range(len(SERVE_WORDS), vocab)]
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"dynamo_tpu_preset": preset, "max_position_embeddings": 2048}, f)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump({
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": w, "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False, "special": True}
                             for i, w in enumerate(words[:3])],
            "normalizer": {"type": "Lowercase"}, "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": {w: i for i, w in enumerate(words)},
                      "unk_token": "<unk>"},
        }, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "chat_template": SERVE_TEMPLATE}, f)


# English letter frequencies (a-z, per cent) and word lengths (1-12
# letters, per cent of running words) for the synthetic BPE's language
BPE_LETTERS = [8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.77, 4.0, 2.4, 6.7, 7.5,
               1.9, 0.095, 6.0, 6.3, 9.1, 2.8, 0.98, 2.4, 0.15, 2.0, 0.074]
BPE_LENGTHS = [3, 17, 21, 16, 11, 9, 8, 6, 4, 2.5, 1.5, 1]
BPE_VOCAB = 128_256  # Llama-3's


def synthetic_bpe(vocab: int, seed: int = 0):
    """A ByteLevel BPE tokenizer.json (as a dict) of `vocab` tokens and a
    sampler of English-shaped text for it. Word types are drawn from
    English letter and length frequencies and ranked by a Zipf law; each,
    most frequent first, with a leading space ("Ġ") and one in ten also
    bare and capitalised, adds the merges that build it left to right
    from its first byte, until the vocabulary holds `vocab` tokens. So a
    frequent word encodes to one token after one merge a letter, and the
    word's merge loop (`tokenizer._BPE.tokenize`) does the work a trained
    BPE of this size does; rare words stop at shorter pieces."""
    from dynamo_tpu_torch.llm import tokenizer as tk

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    p_let = np.array(BPE_LETTERS) / sum(BPE_LETTERS)
    p_len = np.array(BPE_LENGTHS) / sum(BPE_LENGTHS)
    toks = [tk._BYTE_CHAR[b] for b in range(256)]
    index = {t: i for i, t in enumerate(toks)}
    merges, types, seen = [], [], set()

    def chain(word):
        cur = word[0]
        for ch in word[1:]:
            nxt = cur + ch
            if nxt not in index:
                if len(toks) >= vocab:
                    return False
                index[nxt] = len(toks)
                toks.append(nxt)
                merges.append([cur, ch])
            cur = nxt
        return True

    while len(toks) < vocab:
        w = "".join(rng.choice(letters, size=rng.choice(len(p_len), p=p_len) + 1, p=p_let))
        if w in seen:
            continue
        seen.add(w)
        types.append(w)
        forms = ["\u0120" + w] + (["\u0120" + w.capitalize(), w] if rng.rand() < 0.1 else [])
        for f in forms:
            if not chain(f):
                break
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                          "use_regex": True},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": index, "merges": merges},
    }
    zipf = 1.0 / np.arange(1, len(types) + 1) ** 1.07
    zipf /= zipf.sum()

    def text(words: int, trng) -> str:
        out, cap = [], True
        for i in trng.choice(len(types), size=words, p=zipf):
            w = types[i].capitalize() if cap else types[i]
            cap = trng.rand() < 0.06
            out.append(w + (". " if cap else ", " if trng.rand() < 0.05 else " "))
        return "".join(out).rstrip()

    return spec, text


def detok_frame_us(tok, streams, model_name) -> float:
    """us a token for the backend's incremental decoder and stop jail, the
    delta chunk and its SSE frame, over token streams."""
    from dynamo_tpu_torch.llm.backend import StopSequenceDecoder
    from dynamo_tpu_torch.llm.protocols.openai import DeltaGenerator

    t0, frames, n = time.perf_counter(), [], 0
    for toks in streams:
        dec = StopSequenceDecoder(tok, [], set(), set(), len(toks), ignore_eos=True)
        delta = DeltaGenerator(model_name, kind="completion")
        for t in toks:
            frame = json.dumps(delta.chunk(dec.step(t), dec.finish_reason))
            frames.append(b"data: %s\n\n" % frame.encode())
        n += len(toks)
    return 1e6 * (time.perf_counter() - t0) / n


def bpe_host_cost(vocab: int, n: int, words: int, model_name: str) -> dict:
    """The frontend's host cost on the ByteLevel BPE path, which a
    Llama-class tokenizer.json takes: a `synthetic_bpe` of `vocab` tokens,
    `n` prompts of `words` words each. Encode cold (the word cache
    cleared: every word's merge loop runs) and warm, ms a prompt (median
    over the prompts); us a token to detokenize and frame the prompts'
    ids as streams."""
    from dynamo_tpu_torch.llm.tokenizer import HuggingFaceTokenizer

    t0 = time.perf_counter()
    spec, text = synthetic_bpe(vocab)
    tok = HuggingFaceTokenizer(spec)
    build_s = time.perf_counter() - t0
    trng = np.random.RandomState(4)
    texts = [text(words, trng) for _ in range(n)]
    cold, warm, streams = [], [], []
    for t in texts:
        tok._model._cache.clear()
        t1 = time.perf_counter()
        ids = tok.encode(t)
        t2 = time.perf_counter()
        assert tok.encode(t) == ids
        t3 = time.perf_counter()
        assert tok.decode(ids) == t, "the synthetic BPE does not round-trip"
        cold.append(1e3 * (t2 - t1))
        warm.append(1e3 * (t3 - t2))
        streams.append(ids)
    return {"vocab": tok.vocab_size, "merges": len(spec["model"]["merges"]),
            "build_s": build_s, "prompt_words": words,
            "prompt_tokens_median": statistics.median(map(len, streams)),
            "tokenize_cold_ms": statistics.median(cold),
            "tokenize_cold_ms_max": max(cold), "tokenize_warm_ms": statistics.median(warm),
            "detok_frame_us_per_token": detok_frame_us(tok, streams, model_name)}


class LoopLag:
    """The event loop's lateness: a task that sleeps 1 ms at a time and
    keeps the largest overshoot, what a request's next step waits behind
    (tokenizing, rendering, detokenizing, framing, the engine's host
    work, all on the one loop)."""

    def __init__(self):
        self.max_ms, self._task = 0.0, None

    async def _tick(self):
        while True:
            t = time.perf_counter()
            await asyncio.sleep(0.001)
            self.max_ms = max(self.max_ms, 1e3 * (time.perf_counter() - t) - 1.0)

    def __enter__(self):
        self._task = asyncio.get_running_loop().create_task(self._tick())
        return self

    def __exit__(self, *exc):
        self._task.cancel()


async def sse_completion(port, body, t_send=None):
    """One streamed request through the raw client: (status, its data
    chunks, TTFT s to the first chunk with text, end time)."""
    from dynamo_tpu_torch.llm.http import client

    t0 = t_send or time.perf_counter()
    path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
    reply = await client.request("127.0.0.1", port, "POST", path, body)
    if reply.status != 200:
        return reply.status, [await reply.read()], None, time.perf_counter()
    chunks, ttft, done = [], None, False
    async for t, msg in reply.sse():
        if msg.done:
            done = True
            continue
        if msg.data is None:
            continue
        ch = msg.json()
        chunks.append(ch)
        texts = [c.get("text") or (c.get("delta") or {}).get("content")
                 for c in ch.get("choices") or []]
        if ttft is None and any(texts):
            ttft = t - t0
    assert done, "the SSE stream did not end with data: [DONE]"
    return 200, chunks, ttft, time.perf_counter()


def phase_serving(dev, smi="", preset=SERVE_PRESET, flags=None, traffic=None):
    """Phase 11: the serving entry at full width. A model dir naming the
    preset (random weights, seed 0) with a synthetic WordLevel tokenizer
    of the model's vocabulary size and a chat template; the server started
    through `dynamo_tpu_torch.run`'s `build_parser` and `serve_http` in
    this process's event loop (bf16 KV, step pipeline on); one warm-up
    round, then `n` concurrent streamed completions (ISL `isl` words, OSL
    `osl`, ignore_eos) with the launch counters zeroed just before and read
    just after, one chat request through the template, then the same
    prompts' ids straight through `engine.generate`, the HTTP round again
    and the direct one again; each round from a cold cache on an idle
    engine, with when the requests reached the engine, the prefill's host
    enqueue, the event loop's largest lag and the GC's pauses beside its
    TTFT. Gates: HTTP 200, SSE
    that parses and ends with [DONE], `osl` tokens a stream with finish
    reason length, every word mapping back to an id, the launches the
    dispatch counters imply and no plain call. Prints TTFT through HTTP
    and direct, host ms to render and to tokenize a prompt, us a token to
    detokenize and frame, output tok/s over the wall and the share of HTTP
    tokens equal to the direct ones (reported, not gated); and the
    tokenize and detokenize-and-frame costs again on a ByteLevel BPE of
    Llama-3's vocabulary size (`bpe_host_cost`), the path a Llama-class
    tokenizer.json takes."""
    from dynamo_tpu_torch.llm.local_model import LocalModel
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.run import build_parser, serve_http

    tr = dict(SERVE_TRAFFIC, **(traffic or {}))
    n, isl, osl = tr["n"], tr["isl"], tr["osl"]
    vocab = get_config(preset).vocab_size
    tmp = tempfile.TemporaryDirectory()
    model_dir = os.path.join(tmp.name, preset)
    os.mkdir(model_dir)
    serving_model_dir(model_dir, preset, vocab)
    lm = LocalModel.prepare(model_dir)
    pre = OpenAIPreprocessor(lm.card)
    tok = pre.tokenizer
    args = build_parser().parse_args(
        ["in=http", "out=torch", "--model-path", model_dir, "--http-host", "127.0.0.1",
         "--http-port", "0", "--device", str(dev), *(flags or SERVE_FLAGS)])
    tag = f"[serve {preset} bf16 KV, pipeline on]"
    rng = np.random.RandomState(3)
    first = len(SERVE_WORDS)

    def prompts():
        ids = [rng.randint(first, vocab, size=isl).tolist() for _ in range(n)]
        return ids, [" ".join(f"w{i}" for i in p) for p in ids]

    warm_ids, warm_text = prompts()
    ids, text = prompts()
    messages = [{"role": "system", "content": "w7 w8 w9"}, {"role": "user", "content": text[0]}]

    # host cost of the frontend's steps, timed alone (median of 5)
    def med_ms(fn, k=5):
        ts = []
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    rendered = pre.formatter.render(messages)
    m = {"render_ms": med_ms(lambda: pre.formatter.render(messages)),
         "tokenize_ms": med_ms(lambda: tok.encode(text[0])),
         "chat_prompt_tokens": len(tok.encode(rendered))}
    assert tok.encode(text[0]) == ids[0], "the synthetic tokenizer does not round-trip"
    # the same steps on the ByteLevel BPE path, at Llama-3's vocabulary
    # size (the synthetic language runs about 1.63 tokens a word, so 0.615
    # words a token of ISL)
    m["bpe"] = bpe_host_cost(BPE_VOCAB, n, round(0.615 * isl), lm.card.display_name)

    def body(words):
        return {"model": model_name, "prompt": words, "max_tokens": osl, "temperature": 0,
                "stream": True, "nvext": {"ignore_eos": True}}

    async def go():
        svc, eng = await serve_http(args, "torch")
        try:
            return await serve(svc, eng)
        finally:
            await svc.stop()
            await eng.close()

    async def serve(svc, eng):
        t_up = time.perf_counter() - t_start
        arrivals = []  # when each request reaches engine.generate
        generate = eng.generate

        async def timed_generate(ctx):
            arrivals.append(time.perf_counter())
            return await generate(ctx)

        eng.generate = timed_generate

        async def measured(kind):
            """One round from a cold cache and an idle engine: the eight
            streamed through HTTP, or their ids through engine.generate."""
            eng.allocator.clear_cache()
            await idle(eng)
            arrivals.clear()
            s0 = eng.phase_stats
            t0 = time.perf_counter()
            with GcPauses() as gcp, LoopLag() as lag:
                if kind == "http":
                    res = await asyncio.gather(
                        *[sse_completion(svc.port, body(t), t0) for t in text])
                    ttft = sorted(r[2] for r in res)
                else:
                    res, _ = await run_requests(eng, ids, osl)
                    ttft = sorted(r[1] for r in res)
                wall = time.perf_counter() - t0
            await idle(eng)
            d = {k: eng.phase_stats[k] - s0[k] for k in s0}
            return res, d, {
                "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
                "output_tok_s_wall": n * osl / wall, "wall_s": wall,
                "engine_arrival_first_ms": 1e3 * (arrivals[0] - t0),
                "engine_arrival_last_ms": 1e3 * (arrivals[-1] - t0),
                "prefill_dispatches": d["prefill_dispatches"],
                "prefill_enqueue_ms": 1e3 * d["prefill_dispatch_s"],
                "decode_step_ms": decode_step_ms(d, args.decode_steps),
                "loop_lag_max_ms": lag.max_ms, **gcp.summary(),
            }

        # warm-up: cuBLAS, the allocator, the decode graphs
        await asyncio.gather(*[sse_completion(svc.port, body(t)) for t in warm_text])
        reset_counts()
        res, d, http1 = await measured("http")
        counts = read_counts()
        check_counts(counts, path_launches(d, eng.model_cfg.num_layers, eng.config.decode_steps,
                                           None), f"{tag} HTTP round")
        chat = await sse_completion(svc.port, {
            "model": model_name, "messages": messages, "max_tokens": tr["chat_osl"],
            "stream": True})
        direct, _, direct1 = await measured("direct")
        _, _, http2 = await measured("http")
        _, _, direct2 = await measured("direct")
        await debug_routes(svc, [body(t) for t in warm_text], smi)
        return t_up, res, counts, chat, direct, [http1, http2], [direct1, direct2]

    model_name = lm.card.display_name
    t_start = time.perf_counter()
    t_up, res, counts, chat, direct, http_m, direct_m = asyncio.run(go())
    tmp.cleanup()

    vocab_map = {w: i for i, w in enumerate(SERVE_WORDS)}
    http_ids = []
    for status, chunks, ttft, _ in res:
        assert status == 200, f"{tag}: HTTP {status}: {chunks}"
        text_out = "".join(c["text"] for ch in chunks for c in ch["choices"])
        finish = [c["finish_reason"] for ch in chunks for c in ch["choices"]
                  if c["finish_reason"]]
        usage = [ch["usage"] for ch in chunks if ch.get("usage")]
        assert finish == ["length"], f"{tag}: finish reasons {finish}"
        assert usage and usage[-1]["completion_tokens"] == osl, f"{tag}: usage {usage}"
        words = text_out.split()
        got = [vocab_map[w] if w in vocab_map else int(w[1:]) if w[:1] == "w" and w[1:].isdigit()
               and first <= int(w[1:]) < vocab else None for w in words]
        assert None not in got, f"{tag}: a word maps to no id: {words}"
        http_ids.append(got)
    status, chat_chunks, chat_ttft, _ = chat
    assert status == 200 and chat_chunks, f"{tag}: chat request HTTP {status}"
    chat_text = "".join((c.get("delta") or {}).get("content") or ""
                        for ch in chat_chunks for c in ch["choices"])
    for toks, _, reason, _ in direct:
        assert len(toks) == osl and reason == "length", (len(toks), reason)
    same = sum(a == b for x, (y, *_) in zip(http_ids, direct) for a, b in zip(x, y))

    # detokenize and frame the direct round's tokens again, timed
    detok_us = detok_frame_us(tok, [toks for toks, *_ in direct], model_name)

    m.update({
        "server_up_s": t_up, "detok_frame_us_per_token": detok_us,
        "chat_ttft_s": chat_ttft, "http_tokens_equal_to_direct_share": same / (n * osl),
        "http": http_m, "direct": direct_m,
    })
    log(f"{tag} {n} x (ISL {isl}, OSL {osl}) streamed through python -m dynamo_tpu_torch.run "
        f"in=http out=torch ({' '.join(flags or SERVE_FLAGS)}) and the same ids through "
        f"engine.generate, in turns from a cold cache; a chat through the template -> {chat_text[:60]!r}; {smi}: "
        + json.dumps(m))
    log(f"{tag} launches on the HTTP round: "
        f"{json.dumps({k: v[0] for k, v in counts.items() if v[0]})}; plain calls: "
        f"{sum(v[1] for v in counts.values())}")
    return m, {k: v[0] for k, v in counts.items()}

# kernels a profile of serving traffic must name: the decode attention
# (K3, inside the decode graphs' replays) and the KV write (K1, in the eager
# prefill); the prefill attention (K2) when replays list only their launch
PROFILE_DECODE = "fused_decode_kernel"
PROFILE_KV_WRITE = "paged_kv_write_kernel"
PROFILE_PREFILL = "flash_prefill_kernel"


async def debug_routes(svc, bodies, smi=""):
    """Phase 11's server, tracing armed: `POST /debug/profile` (3 s) while
    the streamed requests `bodies` run, then `GET /debug/trace`,
    `/debug/snapshot` and `/debug/kv`. Each must answer 200 with the JAX
    service's keys; the profile's Chrome trace must hold the dispatch
    phases' annotations and name the KV write kernel and the decode
    attention kernel (kernels a graph replay launched), or, where replays
    list only their `cudaGraphLaunch`, the prefill's kernels, as logged."""
    from dynamo_tpu_torch.llm.http import client
    from dynamo_tpu_torch.utils import tracing

    prof_dir = tempfile.TemporaryDirectory()
    old = os.environ.get("DYN_PROFILE_DIR")
    os.environ["DYN_PROFILE_DIR"] = prof_dir.name
    tracing.clear()
    tracing.enable()

    async def call(method, path):
        reply = await client.request("127.0.0.1", svc.port, method, path,
                                     {} if method == "POST" else None)
        return reply.status, json.loads(await reply.read())

    async def traffic():
        await asyncio.sleep(0.3)  # inside the capture
        return await asyncio.gather(*[sse_completion(svc.port, b) for b in bodies])

    try:
        t0 = time.perf_counter()
        (pst, pinfo), res = await asyncio.gather(call("POST", "/debug/profile?duration_ms=3000"),
                                                 traffic())
        t_prof = time.perf_counter() - t0
        routes = {"/debug/profile": (pst, pinfo)}
        for path in ("/debug/trace?limit=2000", "/debug/snapshot", "/debug/kv?top=3"):
            routes[path] = await call("GET", path)
    finally:
        tracing.disable()
        tracing.clear()
        if old is None:
            os.environ.pop("DYN_PROFILE_DIR", None)
        else:
            os.environ["DYN_PROFILE_DIR"] = old
    want = {"/debug/profile": {"dir", "duration_ms"},
            "/debug/trace?limit=2000": {"traceEvents", "displayTimeUnit"},
            "/debug/snapshot": {"recorders", "artifacts"}, "/debug/kv?top=3": {"ledgers", "kv"}}
    for path, (status, body) in routes.items():
        assert status == 200, f"[debug] {path}: HTTP {status} {body}"
        assert want[path] <= set(body), f"[debug] {path}: keys {sorted(body)}"
    for st, *_ in res:
        assert st == 200, f"[debug] a request during the profile: HTTP {st}"
    with open(os.path.join(pinfo["dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    prof_dir.cleanup()
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    graph_launches = sum(1 for e in events if e.get("name") == "cudaGraphLaunch")
    in_replay = any(PROFILE_DECODE in k for k in kernels)
    assert {"prefill", "decode"} <= notes, f"[debug] annotations {sorted(notes)[:20]}"
    assert any(PROFILE_KV_WRITE in k for k in kernels), f"[debug] no {PROFILE_KV_WRITE}"
    if not in_replay:
        log(f"[debug] the profile lists only cudaGraphLaunch ({graph_launches}) for the decode "
            f"graphs' replays, not their kernels; held to the eager prefill's instead")
        assert any(PROFILE_PREFILL in k for k in kernels), f"[debug] no {PROFILE_PREFILL}"
    trace_ev = [e for e in routes["/debug/trace?limit=2000"][1]["traceEvents"] if e["ph"] != "M"]
    summary = {
        "profile_ms": pinfo["duration_ms"], "profile_wall_s": t_prof,
        "kernels_named": sorted(k[:40] for k in kernels
                                if any(w in k for w in (PROFILE_DECODE, PROFILE_KV_WRITE,
                                                        PROFILE_PREFILL))),
        "decode_kernels_inside_replays": in_replay, "graph_launches": graph_launches,
        "annotations": sorted(n for n in notes if not n.startswith("engine.step"))[:8],
        "step_markers": sum(1 for n in notes if n.startswith("engine.step")),
        "trace_events": len(trace_ev),
        "trace_names": sorted({e["name"] for e in trace_ev})[:24],
        "snapshot_recorders": routes["/debug/snapshot"][1]["recorders"],
        "kv_ledgers": routes["/debug/kv?top=3"][1]["ledgers"],
    }
    log("[debug] /debug/profile, /debug/trace, /debug/snapshot and /debug/kv through phase "
        "11's server: " + json.dumps(summary) + f"; {smi}")
    return summary


# ---------------------------------------------------------------- phase 12

# phase 5's engine (bf16 KV, pipeline on) and traffic;
# `phase_ext(cfg=..., traffic=...)` swaps in a small model for a CPU rehearsal
EXT_CFG = dict(PREFIX_CFG)
EXT_TRAFFIC = dict(n=8, isl=512, osl=64)
ATOL_LOGPROB = 1e-5


@torch.inference_mode()
def check_sampler(dev):
    """The extended sampler on the card against its CPU version on the same
    [8, 128256] f32 logits (the 8B decode shape): penalties within one f32
    ulp, logprobs and top-8 within ATOL_LOGPROB (ids equal where
    neighbouring logprobs differ by more), the seeded hash's uniforms bit
    for bit (integer math), seeded draws on the penalized logits the same
    ids, and the count rows byte-equal. Times the sampler's two paths on
    the card."""
    from dynamo_tpu_torch.ops import sampling as s

    g = torch.Generator().manual_seed(12)
    b, v = 8, 128_256
    logits = torch.randn(b, v, generator=g) * 3
    counts = torch.randint(0, 4, (b, v), generator=g).to(torch.int8)
    fp = torch.linspace(0.0, 2.0, b)
    pp = torch.linspace(0.5, 0.0, b)
    rp = torch.linspace(1.0, 2.0, b)
    temp = torch.full((b,), 0.8)
    topk = torch.full((b,), 50, dtype=torch.int32)
    topp = torch.full((b,), 0.95)
    seeds = torch.arange(b, dtype=torch.int32) * 7919 + 5
    pos = torch.arange(b, dtype=torch.int32) + 512
    greedy = (torch.zeros(b), torch.zeros(b, dtype=torch.int32), torch.ones(b))

    def run(d):
        to = [x.to(d) for x in (logits, counts, fp, pp, rp, temp, topk, topp, seeds, pos)]
        lg, cn, f, p_, r, t, k, tp, sd, ps = to
        pen = s.apply_penalties(lg, cn, f, p_, r)
        lps = s.sample_tokens(lg, None, *(x.to(d) for x in greedy), all_greedy=True,
                              return_logprobs=True, top_n=s.TOP_LOGPROBS_MAX)
        u = s.seeded_uniforms(sd, ps, s.CANDIDATES)
        ids = s.sample_tokens(lg, None, t, k, tp, counts=cn, freq_pen=f, pres_pen=p_,
                              rep_pen=r, seeds=sd, positions=ps)
        cnt = cn.clone()
        s.count_tokens(cnt, 3, lg.argmax(-1).to(torch.int32))
        for _ in range(130):
            s.bump_counts(cnt, ids, ps % 2 == 0)
        return [x.cpu() for x in (pen, *lps, u, ids, cnt)]

    cpu, card = run(torch.device("cpu")), run(dev)
    pen_c, pen_d = cpu[0].numpy(), card[0].numpy()
    assert (np.abs(pen_d - pen_c) <= np.spacing(np.abs(pen_c))).all(), "penalties off by > 1 ulp"
    assert torch.equal(cpu[1], card[1]), "greedy ids differ"
    lp_err = max((cpu[2] - card[2]).abs().max().item(), (cpu[4] - card[4]).abs().max().item())
    assert lp_err <= ATOL_LOGPROB, f"logprobs differ by {lp_err}"
    tl = cpu[4].numpy()
    gaps = np.abs(np.diff(tl, axis=1)) > ATOL_LOGPROB
    distinct = np.ones_like(tl, bool)
    distinct[:, :-1] &= gaps
    distinct[:, 1:] &= gaps
    assert (cpu[3].numpy()[distinct] == card[3].numpy()[distinct]).all(), "top ids differ"
    assert torch.equal(cpu[5], card[5]), "the seeded hash's uniforms differ"
    assert torch.equal(cpu[6], card[6]), "seeded draws differ"
    assert torch.equal(cpu[7], card[7]), "count rows differ"
    to = [x.to(dev) for x in (logits, counts, fp, pp, rp, temp, topk, topp, seeds, pos)]
    lg, cn, f, p_, r, t, k, tp, sd, ps = to
    gd = [x.to(dev) for x in greedy]
    plain_ms = time_ms(lambda: s.sample_tokens(lg, None, t, k, tp))
    greedy_ms = time_ms(lambda: s.sample_tokens(lg, None, *gd, all_greedy=True))
    ext_ms = time_ms(lambda: s.sample_tokens(
        lg, None, t, k, tp, counts=cn, freq_pen=f, pres_pen=p_, rep_pen=r, seeds=sd,
        positions=ps, return_logprobs=True, top_n=s.TOP_LOGPROBS_MAX))
    # where the extended call's time goes, piece by piece
    raw = lg.float()
    cnt = cn.clone()
    ids = s.sample_tokens(lg, None, t, k, tp)
    pieces = {
        "apply_penalties": lambda: s.apply_penalties(raw, cn, f, p_, r),
        "bump_counts": lambda: s.bump_counts(cnt, ids, ps >= 0),
        "logsumexp": lambda: torch.logsumexp(raw, dim=-1),
        "topk_8": lambda: torch.topk(raw, s.TOP_LOGPROBS_MAX, dim=-1),
        "shortlist_mask": lambda: s.shortlist_mask(raw / t[:, None], k, tp),
        "seeded_uniforms": lambda: s.seeded_uniforms(sd, ps, s.CANDIDATES),
    }
    res = {"logprob_max_abs_err": lp_err, "greedy_ms": greedy_ms, "sampled_ms": plain_ms,
           "ext_ms": ext_ms, **{f"{k_}_ms": time_ms(fn) for k_, fn in pieces.items()}}
    log(f"[sampler] extended sampler on the card against its CPU version at [8, 128256] f32: "
        f"penalties within 1 ulp, logprobs and top-8 within {ATOL_LOGPROB}, seeded uniforms, "
        f"seeded ids and count rows equal; " + json.dumps(res))
    return res


async def serve_frames(engine, reqs):
    """Serve `reqs` at once, each (ids, osl, sampling options). Returns each
    request's token frames and its TTFT (s)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    async def one(ids, osl, so):
        pre = PreprocessedRequest(
            token_ids=list(ids), stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
            sampling_options=SamplingOptions(**so))
        t0 = time.perf_counter()
        frames, t_first = [], None
        async for f in await engine.generate(Context(pre.to_dict())):
            if f.get("token_ids"):
                t_first = t_first or time.perf_counter()
                frames.append(f)
            elif f.get("finish_reason"):
                assert f["finish_reason"] == "length", f
        assert len(frames) == osl, f"{len(frames)} tokens of {osl}"
        return frames, t_first - t0

    return await asyncio.gather(*[one(*r) for r in reqs])


def _toks(frames):
    return [f["token_ids"][0] for f in frames]


def _graph_pool_bytes(eng):
    pool = eng._graphs._pool
    if pool is None or eng.device.type != "cuda":
        return None
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) == tuple(pool))


def phase_ext(dev, params, smi="", cfg=None, traffic=None):
    """Phase 12: the rest of M4 at full width, on phase 5's weights and
    engine (bf16 KV, pipeline on). Rounds of `n` requests of ISL `isl`, OSL
    `osl`, each served once unmeasured (its decode graph is run eagerly,
    then captured) and then measured from an empty prefix cache with the
    launch counters zeroed around it: plain greedy; greedy with
    frequency_penalty 2.0 (repeats counted against the plain round's);
    greedy with logprobs and top_logprobs 5 (each token's logprob equal to
    its top-1, all <= 0, tops sorted, cum_log_probs the running sum);
    seeded sampled rows, served again in two other batch compositions
    (beside greedy rows of other prompts), which must stream the same;
    and a round mixing plain, penalized and logprob rows. Each round
    checks the launches its dispatch counters imply (no plain call),
    prints the graph keys it added, `graph_check` (every greedy graph
    replayed against an eager run, launches exact) and its decode step
    ms against the plain round's. Returns the metrics and the weights."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine

    tr = dict(EXT_TRAFFIC, **(traffic or {}))
    n, isl, osl = tr["n"], tr["isl"], tr["osl"]
    conf = EngineConfig(**dict(EXT_CFG, **(cfg or {})))
    tag = f"[ext {conf.model} bf16 KV, pipeline on]"
    eng = TorchEngine(conf, params=params, device=dev)
    layers, vocab = eng.model_cfg.num_layers, eng.model_cfg.vocab_size
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, vocab, size=isl).tolist() for _ in range(n)]
    fillers = [rng.randint(0, vocab, size=isl).tolist() for _ in range(n)]
    greedy = dict(greedy=True)
    pen = dict(greedy=True, frequency_penalty=2.0)
    lps = dict(greedy=True, logprobs=True, top_logprobs=5)
    seeded = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1000 + i) for i in range(n)]
    q = max(n // 4, 1)
    rounds = {
        "plain": [greedy] * n,
        "penalty": [pen] * n,
        "logprobs": [lps] * n,
        "seeded": seeded,
        "mixed": [greedy] * (n - 2 * q) + [pen] * q + [lps] * q,
    }

    async def measured(reqs):
        eng.allocator.clear_cache()
        await idle(eng)
        s0 = eng.phase_stats
        reset_counts()
        res = await serve_frames(eng, reqs)
        counts = read_counts()
        await idle(eng)
        d = {k: v - s0[k] for k, v in eng.phase_stats.items()}
        check_counts(counts, path_launches(d, layers, conf.decode_steps, None), tag)
        return res, d, {k: c[0] for k, c in counts.items() if c[0]}

    async def go():
        out = {}
        for name, sos in rounds.items():
            reqs = [(p, osl, so) for p, so in zip(prompts, sos)]
            keys0 = set(eng._graphs.captured())
            await serve_frames(eng, reqs)
            res, d, launched = await measured(reqs)
            out[name] = (res, d, launched, sorted(set(eng._graphs.captured()) - keys0))
            if name == "seeded":
                # the same seeded requests in two other batch compositions,
                # each half beside greedy rows of other prompts
                again = {}
                for half in (range(0, n // 2), range(n // 2, n)):
                    mix = [reqs[i] for i in half] + [(f, osl, greedy) for f in fillers[:n - len(half)]]
                    got, _, _ = await measured(mix)
                    again.update({i: g for i, g in zip(half, got)})
                out["seeded_again"] = [again[i] for i in range(n)]
        await eng.close()
        return out

    out = asyncio.run(go())
    steps = conf.decode_steps
    plain_ms = decode_step_ms(out["plain"][1], steps)
    plain_toks = [_toks(f) for f, _ in out["plain"][0]]
    m = {"plain_decode_step_ms": plain_ms}
    for name in rounds:
        res, d, launched, keys = out[name]
        toks = [_toks(f) for f, _ in res]
        step_ms = decode_step_ms(d, steps)
        r = {"decode_step_ms": step_ms, "over_plain_ms": step_ms - plain_ms,
             "ttft_p50_s": statistics.median(t for _, t in res),
             "decode_dispatches": d["decode_dispatches"],
             "mixed_steps": d["mixed_steps"], "spec_dispatches": d["spec_dispatches"]}
        if name == "penalty":
            reps = [len(t) - len(set(t)) for t in toks]
            plain_reps = [len(t) - len(set(t)) for t in plain_toks]
            r.update(repeats=sum(reps), plain_repeats=sum(plain_reps),
                     equal_to_plain=sum(a == b for a, b in zip(toks, plain_toks)))
            assert sum(reps) <= sum(plain_reps), f"{tag} penalized streams repeat more: {r}"
            assert sum(reps) == 0 or sum(reps) < sum(plain_reps), f"{tag} {r}"
        if name in ("logprobs", "mixed"):
            for (frames, _), so in zip(res, rounds[name]):
                if not so.get("logprobs"):
                    assert all(f.get("log_probs") is None for f in frames)
                    continue
                cum = 0.0
                for f in frames:
                    (lp,), ((tops),) = f["log_probs"], f["top_log_probs"]
                    cum += lp
                    assert lp <= 0 and abs(f["cum_log_probs"] - cum) < 1e-3, (f, cum)
                    # the token is a top-1: at random bf16 weights the best
                    # logits tie exactly, and argmax and topk may name
                    # different ids of the same value
                    assert len(tops) == 5 and abs(tops[0][1] - lp) <= 1e-6, (tops, lp)
                    assert f["token_ids"][0] in [i for i, v in tops if v == tops[0][1]], tops
                    assert all(a[1] >= b[1] for a, b in zip(tops, tops[1:])), tops
            r["tokens_equal_plain_share"] = sum(
                a == b for t, p in zip(toks, plain_toks) for a, b in zip(t, p)) / (n * osl)
        if name == "seeded":
            again = [_toks(f) for f, _ in out["seeded_again"]]
            assert again == toks, f"{tag} seeded streams differ across batch compositions"
            r["distinct_streams"] = len(set(map(tuple, toks)))
        m[name] = r
        log(f"{tag} round {name}: {n} x (ISL {isl}, OSL {osl}); graph keys added "
            f"(width, all_greedy, use_ext, want_lps, want_tops): {keys}; launches "
            f"{json.dumps(launched)}, no plain call; " + json.dumps(r))
    assert m["seeded"]["distinct_streams"] > 1, f"{tag} the seeds drew one stream"
    check = graph_check(eng, tag)
    # each graph's device time a step, replayed back to back on the same
    # inputs (all rows active at the prompts' end; the engine is closed, so
    # nothing reads what the replays write), in two passes in turns
    keys = eng._graphs.captured()
    with torch.inference_mode():
        eng._pos_act[:, 0] = isl
        eng._pos_act[:, 1] = 1
    replay_ms = {k: [] for k in keys}
    for order in (keys, keys[::-1]):
        for k in order:
            replay_ms[k].append(time_ms(lambda k=k: eng._graphs.replay(*k), iters=10,
                                        warmup=2) / conf.decode_steps)
    m["graph_step_ms"] = {str(k): v for k, v in replay_ms.items()}
    log(f"{tag} device ms a decode step, each graph replayed alone (two passes in turns; "
        f"width, all_greedy, use_ext, want_lps, want_tops): " + json.dumps(m["graph_step_ms"]))
    m["graphs"] = len(eng._graphs.captured())
    m["graph_pool_bytes"] = _graph_pool_bytes(eng)
    m["count_buffer_bytes"] = eng._counts.numel() * eng._counts.element_size()
    log(f"{tag} graph check (eager on cloned pools, carries and count rows, replay on the "
        f"originals): outputs equal, pools and count rows byte-equal, launches equal; {check}")
    log(f"{tag} {m['graphs']} decode graphs captured {eng._graphs.captured()}; graph pool "
        f"{m['graph_pool_bytes']} bytes; count buffer {m['count_buffer_bytes']} bytes; {smi}")
    params = eng.params
    del eng
    return m, params


# ---------------------------------------------------------------- phase 13

W8A8_KV = (None, "int8")
W8A8_MODEL = "llama-3.1-8b"  # phase 5's model (a CPU rehearsal swaps in a small one)


def weight_bytes(params) -> int:
    """Bytes of a parameter tree, codes and scales of quantized leaves included."""
    from dynamo_tpu_torch.ops.quant import is_quantized

    def leaf(w):
        if is_quantized(w):
            return leaf(w["q"]) + leaf(w["s"])
        return w.numel() * w.element_size()

    return (sum(leaf(w) for lp in params["layers"] for w in lp.values())
            + sum(leaf(w) for k, w in params.items() if k != "layers"))


def auto_pages(dev, kv_quant):
    """The KV pages TorchEngine's auto-sizer would pick now (phase 5's
    engine settings, `num_pages` None, hbm_utilization 0.85)."""
    from types import SimpleNamespace

    from dynamo_tpu_torch import EngineConfig, TorchEngine

    cfg = EngineConfig(model=W8A8_MODEL, dtype="bfloat16", page_size=64, max_batch_size=8,
                       max_model_len=2048, prefill_chunk=512, kv_quantization=kv_quant)
    return TorchEngine._auto_num_pages(SimpleNamespace(
        config=cfg, model_cfg=cfg.model_config(), _dtype=torch.bfloat16, device=dev))


def phase_w8a8(dev, params, ref, smi=""):
    """Phase 13: W8A8 weights at full width. Phase 5's bf16 weights are
    quantized in place, layer by layer (each bf16 layer freed once its
    codes exist), then phase 5's traffic (8 x ISL 512 / OSL 64, greedy,
    pipeline on) is served with bf16 KV and then int8 KV, through
    `phase_full_width`: the W8A8 kernels' launches as the dispatch counters
    imply, no plain call, the graph check on the W8A8 decode graph, the
    profile. `ref[kv]` is phase 5's (or 6's) pipeline-on (metrics, streams)
    in that KV format. Returns the main path's launch counts of the bf16
    KV run and the quantized params."""
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.ops.quant import quantize_params

    mc = get_config(W8A8_MODEL)
    torch.cuda.empty_cache()
    dense_bytes = weight_bytes(params)
    pages_dense = {kv: auto_pages(dev, kv) for kv in W8A8_KV}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = quantize_params(params, mc, inplace=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    q_bytes = weight_bytes(params)
    pages_q = {kv: auto_pages(dev, kv) for kv in W8A8_KV}
    log(f"[w8a8] {W8A8_MODEL} weights quantized in place, layer by layer, in {quant_s:.2f} s "
        f"(peak {quant_peak:.2f} GB allocated): {q_bytes / 1e9:.3f} GB against "
        f"{dense_bytes / 1e9:.3f} GB in bf16 ({q_bytes / dense_bytes:.3f}x); KV pages the "
        f"auto-sizer would pick (page 64, hbm_utilization 0.85): "
        + ", ".join(f"{kv or 'bf16'} KV {pages_q[kv]} (bf16 weights {pages_dense[kv]})"
                    for kv in W8A8_KV) + f"; {smi}")
    launches = None
    for kv_quant in W8A8_KV:
        torch.cuda.empty_cache()
        streams = []
        counts, m, params = phase_full_width(dev, kv_quant=kv_quant, params=params, pipe=True,
                                             quantization="int8", streams=streams)
        ref_m, ref_streams = ref[kv_quant]
        total = sum(len(r) for r in ref_streams)
        same = sum(a == b for s, r in zip(streams, ref_streams) for a, b in zip(s, r))
        kv = kv_quant or "bf16"
        log(f"[w8a8] {kv} KV, pipeline on: decode step {m['decode_step_ms']:.4f} ms (bf16 "
            f"weights {ref_m['decode_step_ms']:.4f}), prefill dispatch "
            f"{m['prefill_step_ms']:.2f} ms (bf16 weights {ref_m['prefill_step_ms']:.2f}), TTFT "
            f"p50 {m['ttft_p50_s']:.4f} s (bf16 weights {ref_m['ttft_p50_s']:.4f}), peak "
            f"{m['max_memory_allocated_gb']:.2f} GB allocated (bf16 weights "
            f"{ref_m['max_memory_allocated_gb']:.2f}); greedy tokens equal to the bf16 "
            f"weights' streams: {same}/{total} (not gated: int8 weights are another model); "
            f"{smi}")
        tp, rp = m["traced_prefill"], ref_m["traced_prefill"]
        log(f"[w8a8] {kv} KV, one prefill dispatch alone under torch.profiler (8 x ISL 512, "
            f"OSL 1), W8A8 (bf16 weights): host dispatch {tp['prefill_dispatch_ms']:.2f} ms "
            f"({rp['prefill_dispatch_ms']:.2f}), {tp['eager_launches']} eager launches "
            f"({rp['eager_launches']}) over {tp['host_launch_span_ms']:.2f} ms of the host's "
            f"time ({rp['host_launch_span_ms']:.2f}); their kernels busy "
            f"{tp['device_busy_ms']:.2f} ms ({rp['device_busy_ms']:.2f}) of a "
            f"{tp['device_span_ms']:.2f} ms span on the device ({rp['device_span_ms']:.2f}); "
            f"{smi}")
        if launches is None:
            launches = counts
    return launches, params


# ---------------------------------------------------------------- phase 14

# phase 5's engine with the host tier; `phase_offload(cfg=..., traffic=...)`
# swaps in a small model and shorter prompts for a CPU rehearsal
OFFLOAD_CFG = dict(PREFIX_CFG, host_kv_pages=64, offload_batch_pages=16)
OFFLOAD_TRAFFIC = dict(prefix=448, tail=64, osl=64, rounds=3, wave=8, remote=4,
                       remote_pages=64, repeats=3)
OFFLOAD_KV = (None, "int8")


def _host_layout(kv, pid, page):
    """Page `pid` of every layer in a host buffer's layout: [2, L, ps, w]
    K then V (and with scale pools [2, L, ps, K] scales), on the host."""
    rows = torch.stack([torch.stack([x[pid * page:(pid + 1) * page] for x in pools])
                        for pools in (kv.k, kv.v)]).cpu()
    if not kv.quantized:
        return [rows]
    scales = torch.stack([torch.stack([x[pid].transpose(0, 1) for x in pools])
                          for pools in (kv.ks, kv.vs)]).cpu()
    return [rows, scales]


def _buf_parts(buf):
    return [buf["kv"], buf["scales"]] if isinstance(buf, dict) else [buf]


def phase_offload(dev, params, kv_quant=None, smi="", cfg=None, traffic=None):
    """Phase 14: M11's in-process KV movement at full width, pipeline on,
    on phase 5's engine with a host pool of 64 pages (16 a gather). Each of
    `rounds` rounds serves a prompt (a fresh `prefix` + `tail` tokens)
    cold, waits at most 10 s until the host pool holds its pages (each
    host buffer byte-equal to the pool page it copied), serves it warm
    from HBM, clears the HBM cache and serves it again: the host tier must
    restore all but its last page, and the restored stream must equal the
    HBM-warm one token for token. Then `wave` requests of round 0's prefix
    plus tails of their own after another clear (one restore, the rest
    reuse it). Then a second engine on the first's parameter tree
    (`remote_pages` pages, no host tier) decodes `remote` prompts of the
    same length, each alone, from the first engine's `prefill_only`
    (device_arrays=True) wires through `generate_remote`; each stream must
    equal the first engine's own cold serve of the prompt, alone. Last,
    `device_transfer_kv` moves the last prompt's pages to the second
    engine, byte-equal. Every window checks K1/K7 launches equal to what
    its prefill dispatches, restores, injections and transfers imply, the
    other kernels as the dispatch counters imply, no plain call and no
    failed restore. Measures the copies out (the engine's gather and
    copy of a prompt's pages into pinned buffers) and in (the restore
    path's own wall, and a bare copy of the same buffers to the device),
    the transfer's rate against the card's memory rate, TTFT cold,
    HBM-warm and restored, peak memory and the pinned bytes. Returns the
    metrics and the weights."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine
    from dynamo_tpu_torch.engine.kv_transfer import device_transfer_kv
    from dynamo_tpu_torch.engine.offload import HostKvPool
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    tr = dict(OFFLOAD_TRAFFIC, **(traffic or {}))
    conf = EngineConfig(**dict(OFFLOAD_CFG, **(cfg or {})), kv_quantization=kv_quant)
    tag = f"[offload {conf.model} {kv_quant or 'bf16'} KV, pipeline on]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TorchEngine(conf, params=params, device=dev)
    page, layers = eng.page_size, eng.model_cfg.num_layers
    page_bytes = eng.host_pool.page_bytes
    write = PATH_KERNELS[kv_quant][0]
    rng = np.random.RandomState(14)
    vocab = eng.model_cfg.vocab_size
    isl = tr["prefix"] + tr["tail"]

    def rand(n):
        return rng.randint(0, vocab, size=n).tolist()

    prefixes = [rand(tr["prefix"]) for _ in range(tr["rounds"])]
    prompts = [p + rand(tr["tail"]) for p in prefixes]
    wave = [prefixes[0] + rand(tr["tail"]) for _ in range(tr["wave"])]
    remote = [rand(isl) for _ in range(tr["remote"])]
    warmup = [rand(isl) for _ in range(tr["wave"])]
    n_pref = (isl // page - 1) * page  # the restore leaves the last page to compute

    def window(e, s0, g0, what, writes=0):
        """Check the launches since `reset_counts` against engine `e`'s
        dispatch counters, plus one K1/K7 launch a layer for each restore
        and for each of `writes` other page landings."""
        d = {k: v - s0[k] for k, v in e.phase_stats.items()}
        restored = e.offload_gate_stats["restored"] - g0["restored"]
        assert e.offload_gate_stats["failed"] == g0["failed"], f"{tag}: a restore failed"
        want = path_launches(d, layers, conf.decode_steps, kv_quant)
        n = want.get(write, 0) + layers * (restored + writes)
        if n:
            want[write] = n
        check_counts(read_counts(), want, f"{tag} {what}")
        return d, restored

    async def serve_alone(e, prompt, metas=None):
        (res,), _ = await run_requests(e, [prompt], tr["osl"], metas)
        await idle(e)
        await asyncio.sleep(0.01)  # the restore's calibration fence lands
        return res

    async def go():
        m = {"page_mib": page_bytes / 2 ** 20}
        # warm-up (cuBLAS handles, the decode graphs) with the tier parked
        eng.offload_paused = True
        await run_requests(eng, warmup, 24)
        await idle(eng)
        eng.allocator.clear_cache()
        eng.offload_paused = False
        ttft = {"cold": [], "hbm_warm": [], "restored": []}
        waits = []
        for r, prompt in enumerate(prompts):
            hashes = compute_block_hashes(prompt, page)
            s0, g0, metas = eng.phase_stats, dict(eng.offload_gate_stats), []
            reset_counts()
            cold = await serve_alone(eng, prompt, metas)
            t0 = time.perf_counter()
            while not all(h in eng.host_pool for h in hashes):
                held = sum(h in eng.host_pool for h in hashes)
                assert time.perf_counter() - t0 < 10.0, \
                    f"{tag}: the host pool holds {held} of {len(hashes)} pages after 10 s"
                await asyncio.sleep(0.002)
            waits.append(time.perf_counter() - t0)
            pids = [eng.allocator._by_hash[h] for h in hashes]
            for h, pid in zip(hashes, pids):
                host = _buf_parts(eng.host_pool.get(h))
                pool = _host_layout(eng.kv, pid, page)
                assert all(_same_bytes(a, b) for a, b in zip(host, pool)), \
                    f"{tag}: a host buffer differs from the pool page it copied"
            if r == 0:
                # the copy out, measured alone on the same pages into fresh
                # pinned buffers, and a bare copy of those buffers in
                kv = eng.kv
                meas = HostKvPool(len(pids), layers, page, kv.k[0].shape[1], dtype=kv.k[0].dtype,
                                  scale_width=kv.ks[0].shape[1] if kv.quantized else None,
                                  pin_memory=dev.type == "cuda")
                fresh = [meas.reserve().value for _ in pids]
                d2h, d2h_dev, h2d = [], [], []
                for _ in range(tr["repeats"]):
                    t1 = time.perf_counter()
                    events = eng._copy_pages_to_host(pids, fresh)
                    if events is not None:
                        events[1].synchronize()
                        d2h_dev.append(events[0].elapsed_time(events[1]) / 1e3)
                    d2h.append(time.perf_counter() - t1)
                    parts = [_buf_parts(b) for b in fresh]
                    dst = [torch.empty((len(fresh), *p.shape), dtype=p.dtype, device=dev)
                           for p in parts[0]]
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    for j, bp in enumerate(parts):
                        for x, p in zip(dst, bp):
                            x[j].copy_(p, non_blocking=True)
                    torch.cuda.synchronize()
                    h2d.append(time.perf_counter() - t1)
                for j, pid in enumerate(pids):
                    assert all(_same_bytes(a, b) for a, b in zip(
                        _buf_parts(fresh[j]), _host_layout(eng.kv, pid, page)))
                nb = len(pids) * page_bytes
                m["d2h_gb_s"] = nb / statistics.median(d2h) / 1e9
                if d2h_dev:
                    m["d2h_device_gb_s"] = nb / statistics.median(d2h_dev) / 1e9
                m["h2d_bare_gb_s"] = nb / statistics.median(h2d) / 1e9
                m["pinned_bytes_measure_buffers"] = nb
                del fresh, dst, meas
            warm = await serve_alone(eng, prompt, metas)
            eng.allocator.clear_cache()
            assert eng.peek_prefix_tokens(prompt) == len(hashes) * page
            rest = await serve_alone(eng, prompt, metas)
            d, restored = window(eng, s0, g0, f"round {r}: cold, HBM-warm, restored")
            cached = [mt["prefix_cached_tokens"] for mt in metas]
            assert cached == [0, n_pref, n_pref], f"{tag}: cached tokens {cached}"
            assert restored == 1 and d["prefix_restored_tokens"] == n_pref, (restored, d)
            assert rest[0] == warm[0], f"{tag}: the restored stream differs from the HBM-warm one"
            for key, res in (("cold", cold), ("hbm_warm", warm), ("restored", rest)):
                assert len(res[0]) == tr["osl"] and res[2] == "length", res[2]
                ttft[key].append(res[1])
        st = eng.phase_stats
        m.update({
            **{f"ttft_{k}_p50_s": statistics.median(v) for k, v in ttft.items()},
            "host_wait_max_s": max(waits),
            "offload_gb_s": st["offload_pages"] * page_bytes / st["offload_copy_s"] / 1e9,
            "restore_gb_s": st["restore_pages"] * page_bytes / st["restore_s"] / 1e9,
            "restore_ms_per_request": 1e3 * st["restore_s"] / tr["rounds"],
        })

        # a wave over round 0's prefix, from the host tier
        eng.allocator.clear_cache()
        s0, g0, metas = eng.phase_stats, dict(eng.offload_gate_stats), []
        reset_counts()
        res, _ = await run_requests(eng, wave, tr["osl"], metas)
        await idle(eng)
        await asyncio.sleep(0.01)
        d, restored = window(eng, s0, g0, "restored wave")
        assert restored == 1 and all(mt["prefix_cached_tokens"] == n_pref for mt in metas), \
            (restored, [mt["prefix_cached_tokens"] for mt in metas])
        m["wave_ttft_p50_s"] = statistics.median(r[1] for r in res)
        m["host_pages"] = len(eng.host_pool)
        m["pinned_bytes"] = eng.host_pool.buffer_bytes

        # disaggregation inside one process: the first engine prefills, a
        # second one on the same weights decodes
        eng.offload_paused = True
        eng2 = TorchEngine(EngineConfig(**dict(
            OFFLOAD_CFG, **{**(cfg or {}), "host_kv_pages": 0, "num_pages": tr["remote_pages"]}),
            kv_quantization=kv_quant), params=eng.params, device=dev)
        await run_requests(eng2, warmup[:1], 24)  # its decode graph
        await idle(eng2)
        eng2.allocator.clear_cache()
        s0, g0 = eng.phase_stats, dict(eng.offload_gate_stats)
        reset_counts()
        own, wires = [], []
        for p in remote:
            eng.allocator.clear_cache()
            own.append((await serve_alone(eng, p))[0])
        t_po = []
        for p in remote:
            eng.allocator.clear_cache()
            pre = PreprocessedRequest(
                token_ids=list(p), stop_conditions=StopConditions(max_tokens=tr["osl"],
                                                                  ignore_eos=True),
                sampling_options=SamplingOptions(greedy=True))
            t1 = time.perf_counter()
            wires.append(await eng.prefill_only(pre, device_arrays=True))
            t_po.append(time.perf_counter() - t1)
            assert eng.allocator.pages_used == 0
        await idle(eng)
        window(eng, s0, g0, "own serves and prefill_only")
        assert [w[0] for w in wires] == [o[0] for o in own], f"{tag}: prefill_only's first tokens"
        s0, g0 = eng2.phase_stats, dict(eng2.offload_gate_stats)
        reset_counts()
        remote_ttft = []
        for p, (first, *wire) in zip(remote, wires):
            pre = PreprocessedRequest(
                token_ids=list(p), stop_conditions=StopConditions(max_tokens=tr["osl"],
                                                                  ignore_eos=True),
                sampling_options=SamplingOptions(greedy=True))
            t1 = time.perf_counter()
            toks, t_first, meta = [], None, None
            async for f in await eng2.generate_remote(Context(pre.to_dict()), first, *wire):
                if f.get("token_ids") and t_first is None:
                    t_first, meta = time.perf_counter() - t1, f.get("meta")
                toks.extend(f.get("token_ids") or [])
            await idle(eng2)
            assert meta["remote_prefill"] is True
            remote_ttft.append(t_first)
            assert toks == own[len(remote_ttft) - 1], \
                f"{tag}: remote stream {len(remote_ttft) - 1} differs from the own serve"
        chunks = -(-isl // conf.prefill_chunk)
        window(eng2, s0, g0, "generate_remote", writes=chunks * len(remote))
        m.update({"prefill_only_ms_p50": 1e3 * statistics.median(t_po),
                  "remote_ttft_p50_s": statistics.median(remote_ttft)})
        del wires

        # the device path: the last prompt's pages, still cached in the first
        hashes = compute_block_hashes(remote[-1], page)
        src = [eng.allocator._by_hash[h] for h in hashes]
        dst = eng2.allocator.allocate(len(src))
        reset_counts()
        times, dev_times = [], []
        for _ in range(tr["repeats"]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev.type == "cuda" \
                else None
            if ev:
                ev[0].record()
            device_transfer_kv(eng, eng2, src, dst, len(src) * page)
            if ev:
                ev[1].record()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            if ev:
                dev_times.append(ev[0].elapsed_time(ev[1]) / 1e3)
        check_counts(read_counts(), {write: layers * tr["repeats"]}, f"{tag} device_transfer_kv")
        assert all(_same_bytes(a, b) for a, b in zip(_pool_pages(eng.kv, src, page),
                                                      _pool_pages(eng2.kv, dst, page))), \
            f"{tag}: transferred pages differ"
        eng2.allocator.release(dst)
        moved = 2 * len(src) * page_bytes  # each byte read once and written once
        m["transfer_ms"] = 1e3 * statistics.median(times)
        m["transfer_gb_s"] = moved / statistics.median(times) / 1e9
        if dev_times:
            # the stream's span from before the first launch to after the
            # last: the host's enqueue gaps between launches included
            m["transfer_stream_ms"] = 1e3 * statistics.median(dev_times)
        m["transfer_bound_ms"] = 1e3 * moved / PEAKS["SXM"][0]
        m["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        await eng2.close()
        await eng.close()
        return m

    m = asyncio.run(go())
    log(f"{tag} host pool {conf.host_kv_pages} pages ({m['page_mib']:.3f} MiB a page), "
        f"{tr['rounds']} rounds of a cold, an HBM-warm and a restored serve (ISL {isl}, OSL "
        f"{tr['osl']}; restored == HBM-warm streams), a wave of {tr['wave']} over a restored "
        f"prefix, {tr['remote']} prefill_only -> generate_remote streams == own serves, "
        f"device_transfer_kv byte-equal, K1/K7 launches as restores, injections and transfers "
        f"imply, no plain call; {smi}: " + json.dumps(m))
    params = eng.params
    del eng
    return m, params


# ---------------------------------------------------------------- phase 15

# Mixtral-8x7B at full width: a layer holds 2.818 GB of experts, so its 32
# layers (92.9 GB) exceed the card's 80 GB; the card runs 16
MOE_MODEL, MOE_LAYERS = "mixtral-8x7b", 16
MOE_ROWS = (8, 4096)   # a decode step's rows (batch 8) and an 8 x 512 prefill's
MOE_SAMPLE = 256       # rows of the 4,096-row output held against the f64 computation
# the bf16 layer against the f64 computation on the same bf16 inputs: each
# element within 2**-4 of its row's RMS (8-16 bf16 ulps of the RMS) and the
# error's RMS within 2**-6 of the output's. Seven bf16 roundings on the way
# (gate, up, SiLU, SiLU x up, down, the weight and the slot sum), each off
# by about 0.4 * 2**-8 (RMS, relative), put the error's RMS near 2**-8 of
# the output's; a dropped slot or unnormalised weights are off by about
# half the output's RMS
MOE_ELEM_RMS, MOE_NORM_REL = 2.0 ** -4, 2.0 ** -6
# f32 routing may order two experts whose f64 probabilities are this close
# (relative) either way; any other difference fails
MOE_TIE_GAP = 1e-5
# published float32 rates outside the tensor cores (NVIDIA data sheets)
F32_PEAKS = {"SXM": 67e12, "PCIe": 51e12, "NVL": 60e12}


def moe_model():
    from dynamo_tpu_torch.models.config import get_config

    return get_config(MOE_MODEL).with_(num_layers=MOE_LAYERS)


def _moe_f64(lp, cfg, x, rows):
    """The f64 CPU computation of an MoE layer on the card's bf16 inputs x
    [N, D]: the routing of every row (models/moe.py `route` in float64)
    and the outputs of `rows`, each the sum over its kept slots of the
    weight times its expert's SwiGLU, one expert's weights in f64 at a time."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.models import moe

    xc = x.cpu().double()
    r = moe.route({"router": lp["router"].cpu()}, cfg, xc)
    out = torch.zeros(len(rows), xc.shape[1], dtype=torch.float64)
    k = cfg.num_experts_per_tok
    for e in range(cfg.num_experts):
        sel = [(j, s) for j, i in enumerate(rows) for s in range(k)
               if r.keep[s, i] and r.expert[s, i] == e]
        if not sel:
            continue
        w = {n: lp[n][e].cpu().double() for n in ("we_gate", "we_up", "we_down")}
        xs = xc[[rows[j] for j, _ in sel]]
        y = (F.silu(xs @ w["we_gate"]) * (xs @ w["we_up"])) @ w["we_down"]
        for (j, s), yy in zip(sel, y):
            out[j] += r.weight[s, rows[j]] * yy
    return r, out


def _moe_err(got, want):
    """(largest |error| over its row's RMS, the error's RMS over the output's)."""
    got, want = got.double(), want.double()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    err = got - want
    return float((err.abs() / rms).max()), float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def check_moe_layer(peaks, part, dev, smi="", cfg=None, rows=MOE_ROWS, sample=MOE_SAMPLE):
    """One MoE layer on the card at each of `rows` token counts, bf16, on
    seeded random weights and inputs: the routing (experts and keep masks)
    equal to the f64 CPU computation's but at near-ties, the output within
    MOE_ELEM_RMS / MOE_NORM_REL of it (all rows at the small count, every
    16th at the large), and plain versions gone wrong (slot 1 dropped, the
    top-k weights not renormalised) shown to miss it; then each piece's
    device ms (router + top-k + capacity, dispatch, the three bmm, SiLU x
    up, combine, and the whole block) beside its bound."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.models import moe

    cfg = cfg or moe_model()
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: routing must run in f32"
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    lp = moe.init_moe_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    d, f, e, k = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.num_experts_per_tok
    bw, bf16 = peaks
    f32 = F32_PEAKS[part]
    for n in rows:
        x = torch.randn((n, d), generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
        r = moe.route(lp, cfg, x)
        xe = moe.dispatch(x, r, e)
        ye = moe.experts(lp, xe)
        got = moe.combine(ye, r)
        assert torch.equal(got, moe.moe_block(lp, cfg, x[None])[0]), "moe_block != its pieces"
        assert torch.isfinite(got).all()
        picked = list(range(n)) if n <= sample else list(range(0, n, n // sample))
        t0 = time.perf_counter()
        ref, want = _moe_f64(lp, cfg, x, picked)
        ref_s = time.perf_counter() - t0
        # routing: equal experts but where f64 puts two of the k + 1 best
        # within MOE_TIE_GAP of each other; equal keep masks
        probs = torch.softmax(x.cpu().double() @ lp["router"].cpu().double(), dim=-1)
        top = probs.sort(dim=-1, descending=True).values[:, :k + 1]
        near = ((top[:, :-1] - top[:, 1:]) < MOE_TIE_GAP * top[:, 1:]).any(dim=-1)
        differ = (r.expert.cpu() != ref.expert).any(dim=0)
        assert not (differ & ~near).any(), \
            f"MoE n={n}: routing differs from f64 at {int((differ & ~near).sum())} tokens"
        assert torch.equal(r.keep.cpu(), ref.keep), f"MoE n={n}: keep masks differ from f64"
        w_err = float((r.weight.cpu().double() - ref.weight).abs().max())
        ok_rows = [j for j, i in enumerate(picked) if not differ[i]]
        g = got[picked].cpu()[ok_rows]
        elem, norm = _moe_err(g, want[ok_rows])
        assert elem <= MOE_ELEM_RMS and norm <= MOE_NORM_REL, \
            f"MoE n={n}: output off the f64 computation ({elem:.3e} of a row's RMS, " \
            f"{norm:.3e} overall)"
        # the check's power: plain versions gone wrong miss it
        wrong = {}
        rows_idx = torch.where(r.keep, r.expert * r.capacity + r.pos, 0)
        flat = ye.reshape(-1, d)
        w0 = torch.where(r.keep[0], r.weight[0], 0.0).to(ye.dtype)
        wrong["slot 1 dropped"] = flat[rows_idx[0]] * w0[:, None]
        raw = torch.softmax(x.float() @ lp["router"].float(), dim=-1).sort(
            dim=-1, descending=True, stable=True).values[:, :k].T
        wrong["weights not renormalised"] = moe.combine(ye, r._replace(weight=raw))
        for name, bad in wrong.items():
            be, bn = _moe_err(bad[picked].cpu()[ok_rows], want[ok_rows])
            assert be > MOE_ELEM_RMS or bn > MOE_NORM_REL, f"MoE n={n}: {name} passes the check"
            wrong[name] = f"{be:.3f} of a row's RMS, {bn:.4f} overall"
        kept = int(r.keep.sum())
        used = int(torch.zeros(e, dtype=torch.bool, device=dev).index_fill_(
            0, r.expert[r.keep], True).sum())
        cap_rows = e * r.capacity
        log(f"[moe] n={n} ({cfg.name} layer, bf16, capacity {r.capacity} a expert): routing == "
            f"f64 ({int(differ.sum())} tokens at f64 near-ties of {MOE_TIE_GAP:g} ordered "
            f"otherwise; keep masks equal, {kept} of {k * n} slots kept; weights within "
            f"{w_err:.2e}); output vs f64 on {len(ok_rows)} rows: max |err| {elem:.4f} of its "
            f"row's RMS (limit {MOE_ELEM_RMS:g}), error RMS {norm:.5f} of the output's "
            f"(limit {MOE_NORM_REL:g}); gone wrong: " + json.dumps(wrong)
            + f"; f64 CPU computation {ref_s:.1f} s")
        # pieces: device ms beside bounds (each input read once, each output
        # written once; the expert products count the kept rows' work and
        # the weights of the experts that hold any)
        gate = torch.bmm(xe, lp["we_gate"])
        up = torch.bmm(xe, lp["we_up"])
        h = F.silu(gate) * up
        wmat = d * f * 2 * used
        pieces = {
            "route": (lambda: moe.route(lp, cfg, x), n * d * 2 + d * e * 2 + k * n * 21,
                      2 * n * d * e, f32),
            "dispatch": (lambda: moe.dispatch(x, r, e), n * d * 2 + cap_rows * d * 2, 0, bf16),
            "bmm_gate": (lambda: torch.bmm(xe, lp["we_gate"]),
                         wmat + kept * (d + f) * 2, 2 * kept * d * f, bf16),
            "bmm_up": (lambda: torch.bmm(xe, lp["we_up"]),
                       wmat + kept * (d + f) * 2, 2 * kept * d * f, bf16),
            "silu_mul": (lambda: F.silu(gate) * up, 3 * kept * f * 2, 0, bf16),
            "bmm_down": (lambda: torch.bmm(h, lp["we_down"]),
                         wmat + kept * (f + d) * 2, 2 * kept * f * d, bf16),
            "combine": (lambda: moe.combine(ye, r), kept * d * 2 + n * d * 2, 0, bf16),
            "moe_block": (lambda: moe.moe_block(lp, cfg, x[None]),
                          n * d * 4 + 3 * wmat, 6 * kept * d * f, bf16),
        }
        times = {}
        for name, (fn, nbytes, flops, rate) in pieces.items():
            ms = time_ms(fn)
            b, by = bound_ms(nbytes, flops, (bw, rate))
            times[name] = {"ms": ms, "bound_ms": b, "bound_by": by, "x_bound": ms / b}
        cap_bound = bound_ms(3 * wmat + cap_rows * (2 * d + 3 * f) * 2,
                             6 * cap_rows * d * f, (bw, bf16))[0]
        log(f"[moe] n={n} pieces, device ms (CUDA events, median of 20) beside their bounds "
            f"({kept} kept rows of {cap_rows} capacity rows, {used} experts used; the three "
            f"bmm over every capacity row would bound at {cap_bound} ms; {smi}): "
            + json.dumps(times))


def phase_moe(dev, peaks, part, smi="", cfg=None, layer_cfg=None, rows=MOE_ROWS,
              sample=MOE_SAMPLE):
    """Phase 15: the sparse-MoE family at full width, Mixtral-8x7B's widths
    at 16 of its 32 layers from seeded random weights, bf16: first one
    layer against the f64 computation and timed by piece
    (`check_moe_layer`); then phase 5's traffic (8 x ISL 512 / OSL 64,
    greedy, pipeline on) in bf16, int8 and int4 KV through
    `phase_full_width` (the attention and KV kernels' launches the
    dispatch counters imply, no plain call, the graph check); phase 8's
    wave (4 held, a wave of 4) with mixed steps and speculative decoding
    on in bf16 KV; and the attention projections quantized in place
    (W8A8; router and experts stay bf16) served in bf16 KV. Returns the
    launch counts of each run."""
    cfg = cfg or moe_model()
    t0 = time.perf_counter()
    check_moe_layer(peaks, part, dev, smi=smi, cfg=layer_cfg or cfg, rows=rows, sample=sample)
    log(f"[moe] layer check {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    launches, params = {}, None
    for kv_quant in PATH_KERNELS:
        torch.cuda.empty_cache()
        counts, m, params = phase_full_width(dev, kv_quant=kv_quant, params=params, pipe=True,
                                             model=cfg, label="mixtral16")
        launches[kv_quant or "bf16"] = {n: c for n, c in counts.items() if c}
        log(f"[moe] {kv_quant or 'bf16'} KV: decode step {m['decode_step_ms']:.4f} ms, TTFT "
            f"p50 {m['ttft_p50_s']:.4f} s, max {m['ttft_max_s']:.4f} s, output "
            f"{m['output_tok_s_wall']:.1f} tok/s over the wall, peak "
            f"{m['max_memory_allocated_gb']:.2f} GB allocated, weights "
            f"{weight_bytes(params) / 1e9:.3f} GB; {smi}")
    torch.cuda.empty_cache()
    counts, m, _, params = phase_wave(dev, params, on=True, cfg=dict(model=cfg))
    launches["wave"] = {n: c for n, c in counts.items() if c}
    log(f"[moe] wave, mixed + spec on, bf16 KV: " + json.dumps(
        {k: m[k] for k in ("wave_ttft_p50_s", "wave_ttft_max_s", "held_max_gap_in_wave_s",
                           "held_tok_s_in_wave", "mixed_steps", "spec_dispatches")})
        + f"; {smi}")
    from dynamo_tpu_torch.ops.quant import quantize_params

    gc.collect()
    torch.cuda.empty_cache()
    params = quantize_params(params, cfg, inplace=True)
    counts, m, params = phase_full_width(dev, params=params, pipe=True, quantization="int8",
                                         model=cfg, label="mixtral16")
    launches["w8a8"] = {n: c for n, c in counts.items() if c}
    log(f"[moe] W8A8 attention (experts bf16), bf16 KV: decode step "
        f"{m['decode_step_ms']:.4f} ms, TTFT p50 {m['ttft_p50_s']:.4f} s, weights "
        f"{weight_bytes(params) / 1e9:.3f} GB; {smi}")
    log(f"[moe] launches on the main path by run: {json.dumps(launches)}")
    del params
    gc.collect()
    return launches


# ---------------------------------------------------------------- phase 17

# the scale groups phase 17 holds the grouped int4 kernels at (features a
# scale, of the 8B head_dim 128: every group the engine serves there, from
# MIN_KV_QUANT_GROUP up), and the one its traffic serves
GROUPS = (8, 16, 32, 64)
GROUP_MAIN = 32
# a plain version gone wrong for grouped int4: the high nibble of a byte
# (feature j + Hd/2) scaled by its low nibble's group, or every feature by
# its head's first group
G_WRONG = {"high nibble in its low nibble's group": "byte",
           "one scale a head (the first group's)": "first"}


def _q4g_pools(num_pages, page, kh, hd, group, gen, dev):
    """Nibble-packed int4 pools with scale pools [P, K * Hd / group, page]
    quantized from random bf16 rows in groups of `group` features."""
    from dynamo_tpu_torch.ops.quant import quantize_kv_rows_int4, scales_to_page_tiles

    k, v = _pools(num_pages, page, kh * hd, gen, dev)
    (kq, ks), (vq, vs) = (quantize_kv_rows_int4(x, kh, group) for x in (k, v))
    return kq, vq, scales_to_page_tiles(ks, page), scales_to_page_tiles(vs, page)


def _dequant_g(pool, scales, kh, wrong=None):
    """A whole grouped int4 pool as bf16 [N, K*Hd]: each code times its
    group's scale in f32, rounded once (`wrong`: a G_WRONG mapping of
    features to groups instead)."""
    from dynamo_tpu_torch.ops.quant import unpack_int4_kv

    s_ch = scales.shape[1]
    dense = scales.transpose(1, 2).reshape(-1, s_ch)
    codes = unpack_int4_kv(pool, kh).float()
    n, hd = codes.shape[0], codes.shape[1] // kh
    gph = s_ch // kh
    f = torch.arange(hd, device=pool.device)
    if wrong == "byte":
        f = f % (hd // 2)
    grp = f // (hd // gph)
    if wrong == "first":
        grp = torch.zeros_like(grp)
    sc = dense.reshape(n, kh, gph)[:, :, grp]
    return (codes.reshape(n, kh, hd) * sc).to(torch.bfloat16).reshape(n, -1)


def _g_bytes(kh, hd, s_ch):
    """Bytes of one token's K or V row in a grouped int4 pool: the codes
    and the S scales."""
    return kh * hd // 2 + 4 * s_ch


def check_kv_write_q4g(peaks, gen, dev, group):
    """K7's grouped int4 form against its plain version: pools and scale
    pools byte-exact (trash page aside), two launches the same bytes, an id
    equal to num_pages skipped; timed at 8B page 64 beside index_copy_."""
    from dynamo_tpu_torch.ops import kv_write as m
    from dynamo_tpu_torch.scripts import l2_evict

    name = "kv_write_q4g"

    flush = l2_evict(dev)
    times = {}
    for label, (num_pages, page, kh, hd, n, g) in {
        "8b-p64": (200, 64, 8, 128, 64, group), "8b-p128": (100, 128, 8, 128, 32, group),
        "small": (40, 16, 2, 32, 7, 8),
        # K 1 at page 3 in groups of 16: a 24-byte scale tile, in 4-byte words
        "k1-p3": (40, 3, 1, 32, 7, 16),
    }.items():
        groups = hd // g

        def write(p, table, s, page=page, groups=groups):
            return m.paged_kv_write(p[0], p[1], table, s[0], s[1], p[2], p[3], s[2], s[3],
                                    page_size=page, int4=True, groups=groups)

        def plain(p, table, s, page=page):
            return m.paged_kv_write_q4g_plain(p[0], p[1], table, s[0], s[1], p[2], p[3], s[2],
                                              s[3], page_size=page)

        k, v, ks, vs = _q4g_pools(num_pages, page, kh, hd, g, gen, dev)
        kw, s_ch = k.shape[1], ks.shape[1]
        table = torch.randperm(num_pages - 1, generator=gen, device=dev)[:n].to(torch.int32) + 1
        table[-1] = 0  # a padding page into the trash page
        nk, nv, nks, nvs = _q4g_pools(n, page, kh, hd, g, gen, dev)
        nk, nv = nk.view(n, page, kw), nv.view(n, page, kw)
        mine = [x.clone() for x in (k, v, ks, vs)]
        plain_p = [x.clone() for x in (k, v, ks, vs)]
        out = write(mine, table, (nk, nv, nks, nvs))
        assert all(a is b for a, b in zip(out, mine))
        plain(plain_p, table, (nk, nv, nks, nvs))
        torch.cuda.synchronize()
        for x, y, per_page in zip(mine, plain_p, (page, page, 1, 1)):
            assert _same_bytes(x[per_page:], y[per_page:]), f"{name} {label}: differs from plain"
        assert not torch.equal(mine[0], k) and not torch.equal(mine[2], ks), \
            f"{name} {label}: pools not updated in place"
        _write_repeats(name, label, write, plain, (k, v, ks, vs), table, (nk, nv, nks, nvs),
                       num_pages)
        if label.startswith("8b"):
            nbytes = 2 * 2 * n * page * _g_bytes(kh, hd, s_ch) + n * 4
            b_ms, by = bound_ms(nbytes, 0.0, peaks)
            times[label] = _write_times(
                lambda: write(mine, table, (nk, nv, nks, nvs)), flush, b_ms) + (b_ms, by)
        if label == "8b-p64":
            plain_ms = time_ms(lambda: plain(plain_p, table, (nk, nv, nks, nvs)))
            idx = table.long()
            dst = [x.view(num_pages, -1) for x in mine]
            src = [nk.view(n, -1), nv.view(n, -1), nks.view(n, -1), nvs.view(n, -1)]

            def lib():
                for d_, s_ in zip(dst, src):
                    d_.index_copy_(0, idx, s_)

            lib_ms = time_ms(lib)
    ms, _, p64, b_ms, by = times["8b-p64"]
    p128 = times["8b-p128"]
    log(f"[kernel] {name} group {group}: pools and scale pools (S = K * {128 // group}) "
        f"byte-exact at 8B page 64/128, small (group 8) and K 1 at page 3 (group 16: "
        f"24-byte scale tiles, in 4-byte words), two launches the same bytes, an id equal to "
        f"num_pages skipped; page 64: {p64} (plain {plain_ms:.4f}, index_copy_ {lib_ms:.4f}, "
        f"bound {b_ms:.4f} by {by}); page 128: {p128[2]} (bound {p128[3]:.4f})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


def check_prefill_q4g(peaks, gen, dev, group):
    """K6's grouped int4 form against its plain version (and the plain
    version against K2's over the pools dequantized beforehand: the same
    arithmetic), within one bf16 ulp; its power shown by G_WRONG and by the
    probabilities rounded once to bf16; timed at 8B page 64."""
    from dynamo_tpu_torch.ops import prefill_attention as m

    name = "prefill_attention_q4g"
    cases = {
        # B, T, H, K, Hd, page, W, pos0, t_valid, group
        "8b-p64": (8, 512, 32, 8, 128, 64, 9, [64] * 8, [512] * 8, group),
        "8b-p128": (8, 512, 32, 8, 128, 128, 5, [64] * 8, [512] * 8, group),
        "small": (4, 48, 4, 2, 32, 16, 6, [0, 16, 7, 40], [48, 20, 1, 0], 8),
        "g8": (2, 24, 16, 2, 64, 16, 4, [8, 0], [24, 5], 16),
        "p3": (4, 48, 4, 2, 32, 3, 30, [0, 15, 7, 40], [48, 20, 1, 0], 16),
    }
    errs = {}
    for label, (b, t, h, kh, hd, page, w, pos0, tlen, g) in cases.items():
        num_pages = b * w + 3
        k, v, ks, vs = _q4g_pools(num_pages, page, kh, hd, g, gen, dev)
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)

        def kernel(q=q, k=k, v=v, tables=tables, p0=p0, tl=tl, ks=ks, vs=vs, page=page):
            return m.flash_prefill_attention(q, k, v, tables, p0, tl, ks, vs, page_size=page,
                                             int4=True)

        got = kernel()
        want = m.flash_prefill_attention_q4g_plain(q, k, v, tables, p0, tl, ks, vs,
                                                   page_size=page)
        kd, vd = _dequant_g(k, ks, kh), _dequant_g(v, vs, kh)
        same = m.flash_prefill_attention_plain(q, kd, vd, tables, p0, tl, page_size=page)
        torch.cuda.synchronize()
        assert torch.equal(same, want), f"{name} {label}: the plain version is not K2's over " \
            "the pools dequantized beforehand"
        valid = torch.arange(t, device=dev)[None] < tl[:, None]
        assert torch.all(got[~valid] == 0), f"{name} {label}: rows past t_valid not 0"
        c = compare_bf16(got[valid], want[valid])
        msg = f"[kernel] {name} {label} (group {g}): {fmt(c)}"
        if label.startswith("8b"):
            msg += _check_power(want, valid, name, {
                "probabilities rounded once to bf16": _p_bf16_once(
                    q, kd, vd, tables, p0, tl, page=page),
                **{lab: m.flash_prefill_attention_plain(
                    q, _dequant_g(k, ks, kh, mode), _dequant_g(v, vs, kh, mode), tables, p0,
                    tl, page_size=page) for lab, mode in G_WRONG.items()}})
        log(msg)
        assert c["ok"], f"{name} {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = c["max_abs_err"]
        if label == "8b-p128":
            p128_ms = time_ms(kernel)
        if label == "8b-p64":
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: m.flash_prefill_attention_q4g_plain(
                q, k, v, tables, p0, tl, ks, vs, page_size=page))
            qq, kk, vv, mask = _sdpa_prefill_inputs(q, kd, vd, tables, p0, tl, page)
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask))
            kv_rows = sum(p + n for p, n in zip(pos0, tlen))
            nbytes = (2 * q.numel() * 2 + 2 * kv_rows * _g_bytes(kh, hd, ks.shape[1])
                      + (tables.numel() + 2 * b) * 4)
            flops = sum(4 * h * hd * sum(p + j + 1 for j in range(n)) for p, n in zip(pos0, tlen))
            b_ms, by = bound_ms(nbytes, flops, peaks)
    log(f"[kernel] {name} group {group}: every case within one bf16 ulp + 2**-16; {ms:.4f} ms "
        f"at page 64 (page 128: {p128_ms:.4f}; plain {plain_ms:.4f}, sdpa over KV dequantized "
        f"to bf16 beforehand {lib_ms:.4f}, bound {b_ms:.4f} by {by}); "
        + prefill_rates(ms, lib_ms, flops, 128, 3))
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


def check_decode_q4g(peaks, gen, dev, group):
    """K5's grouped int4 form against its plain version: pools and scale
    pools byte-equal after the write, attention within one bf16 ulp, the
    read-only use too, two launches the same bits; its power shown by the
    new row attended in bf16 and by G_WRONG; timed at 8B page 64, at the
    engine's W 32 and beside SDPA over KV dequantized beforehand."""
    from dynamo_tpu_torch.ops import decode_attention as m
    from dynamo_tpu_torch.ops.quant import quantize_kv_rows_int4

    name = "decode_attention_q4g"
    plain_fn = m.fused_paged_decode_attention_q4g_plain
    lens8 = [576, 570, 590, 600, 512, 577, 583, 560]
    cases = {
        # B, H, K, Hd, page, W, lengths (write_pos = length - 1; 0 = idle row), group
        "8b-p64": (8, 32, 8, 128, 64, 10, lens8, group),
        "8b-w32": (8, 32, 8, 128, 64, 32, lens8, group),
        "small": (4, 4, 2, 32, 16, 6, [37, 0, 1, 80], 8),
        "g8": (2, 16, 2, 64, 16, 6, [50, 96], 16),
        "edges": (7, 8, 2, 64, 16, 12, [64, 65, 128, 129, 1, 0, 192], 32),
        "page24": (3, 8, 2, 64, 24, 8, [25, 129, 192], 16),
        "page3": (4, 4, 2, 32, 3, 20, [37, 0, 1, 58], 16),
    }
    errs = {}
    for label, (b, h, kh, hd, page, w, lengths, g) in cases.items():
        num_pages = b * w + 3
        k, v, ks, vs = _q4g_pools(num_pages, page, kh, hd, g, gen, dev)
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        nk_bf = torch.randn((b, kh * hd), generator=gen, device=dev).to(torch.bfloat16)
        nv_bf = torch.randn((b, kh * hd), generator=gen, device=dev).to(torch.bfloat16)
        (nk, nks), (nv, nvs) = (quantize_kv_rows_int4(x, kh, g) for x in (nk_bf, nv_bf))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        wpos = torch.tensor([n - 1 if n else -1 for n in lengths], dtype=torch.int32, device=dev)
        mine = [x.clone() for x in (k, v, ks, vs)]
        plain = [x.clone() for x in (k, v, ks, vs)]

        def fused(q=q, nk=nk, nv=nv, tables=tables, lens=lens, wpos=wpos, nks=nks, nvs=nvs,
                  mine=mine, page=page):
            return m.fused_paged_decode_attention(
                q, nk, nv, mine[0], mine[1], tables, lens, wpos, mine[2], mine[3], nks, nvs,
                page_size=page, int4=True)

        got, *rp = fused()
        assert all(a is b for a, b in zip(rp, mine))
        want = plain_fn(q, nk, nv, plain[0], plain[1], tables, lens, wpos, plain[2], plain[3],
                        nks, nvs, page_size=page)[0]
        ro = m.paged_decode_attention(q, mine[0], mine[1], tables, lens, mine[2], mine[3],
                                      page_size=page, int4=True)
        torch.cuda.synchronize()
        for x, y in zip(mine, plain):
            assert _same_bytes(x, y), f"{name} {label}: pools differ after the write"
        again = fused()[0]
        ro2 = m.paged_decode_attention(q, mine[0], mine[1], tables, lens, mine[2], mine[3],
                                       page_size=page, int4=True)
        assert _same_bytes(again, got) and _same_bytes(ro2, ro), f"{name} {label}: launches differ"
        assert not torch.equal(mine[0], k) and not torch.equal(mine[2], ks), \
            f"{name} {label}: pools not updated in place"
        idle = lens == 0
        assert torch.all(got[idle] == 0) and torch.all(ro[idle] == 0), \
            f"{name} {label}: idle rows not 0"
        c, c_ro = compare_bf16(got, want), compare_bf16(ro, want)
        msg = f"[kernel] {name} {label} (group {g}): {fmt(c)}; read-only: {fmt(c_ro)}"
        if label in ("8b-p64", "small"):
            no_write = wpos.new_full((b,), -1)
            kd, vd = _dequant_g(plain[0], plain[2], kh), _dequant_g(plain[1], plain[3], kh)
            variants = {"new row in bf16": m.fused_paged_decode_attention_plain(
                q, nk_bf, nv_bf, kd.clone(), vd.clone(), tables, lens, wpos, page_size=page)[0]}
            for lab, mode in G_WRONG.items():
                variants[lab] = m.fused_paged_decode_attention_plain(
                    q, nk_bf, nv_bf, _dequant_g(plain[0], plain[2], kh, mode),
                    _dequant_g(plain[1], plain[3], kh, mode), tables, lens, no_write,
                    page_size=page)[0]
            msg += _check_power(want, None, name, variants)
        log(msg)
        assert c["ok"] and c_ro["ok"], f"{name} {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = max(c["max_abs_err"], c_ro["max_abs_err"])
        if label == "8b-w32":
            w32_ms = time_ms(fused)
        if label == "8b-p64":
            ms = time_ms(fused)
            plain_ms = time_ms(lambda: plain_fn(
                q, nk, nv, plain[0], plain[1], tables, lens, wpos, plain[2], plain[3], nks, nvs,
                page_size=page))
            kd, vd = _dequant_g(mine[0], mine[2], kh), _dequant_g(mine[1], mine[3], kh)
            qq, kk, vv, _ = _sdpa_prefill_inputs(q[:, None], kd, vd, tables, lens - 1, lens, page)
            mask = (torch.arange(kk.shape[2], device=dev)[None] < lens[:, None].long())[:, None, None]
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask))
            total = sum(lengths)
            s_ch = ks.shape[1]
            nbytes = (2 * q.numel() * 2 + 2 * 2 * nk.numel() + 2 * 2 * nks.numel() * 4
                      + 2 * total * _g_bytes(kh, hd, s_ch) + (tables.numel() + 2 * b) * 4)
            b_ms, by = bound_ms(nbytes, 4 * h * hd * total, peaks)
    log(f"[kernel] {name} group {group}: every case within one bf16 ulp + 2**-16, pools and "
        f"scale pools equal after the write, two launches bit-equal; {ms:.4f} ms at page 64 "
        f"(W 32: {w32_ms:.4f}; plain {plain_ms:.4f}, sdpa over KV dequantized to bf16 "
        f"beforehand {lib_ms:.4f}, bound {b_ms:.4f} by {by}; {ms / lib_ms:.2f}x sdpa's time, "
        f"{b_ms / ms:.1%} of the bound); {ptxas_report(128, 3, 'decode_attention', 4)}")
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


# K4's grouped form on RAGGED_CASES' rectangles, with the group of each
# small case (the 8B ones take the group checked)
RAGGED_G_GROUPS = {"hd32-g2": 8, "hd64-g1": 16, "hd64-g8": 32, "hd32-p3": 16}


def check_ragged_q4g(peaks, gen, dev, group):
    """K4 over grouped int4 pools (K6's grouped form) against its plain
    version on RAGGED_CASES, within one bf16 ulp, rows past q_len 0; its
    power shown on the 8B mixed and verify rectangles (a causal edge one
    key late, the probabilities rounded once to bf16, G_WRONG); timed on
    the 8B mixed rectangle."""
    from dynamo_tpu_torch.ops import decode_attention as m
    from dynamo_tpu_torch.ops import prefill_attention as p

    name = "ragged_attention_q4g"
    plain_fn = m.ragged_paged_attention_q4g_plain
    errs = {}
    for label, (h, kh, hd, page, t, w, rows) in RAGGED_CASES.items():
        g = group if label.startswith("8b") else RAGGED_G_GROUPS[label]
        b = len(rows)
        num_pages = b * w + 3
        k, v, ks, vs = _q4g_pools(num_pages, page, kh, hd, g, gen, dev)
        tables = _tables(b, w, num_pages, gen, dev)
        q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        p0 = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)

        def kernel(q=q, k=k, v=v, tables=tables, p0=p0, ql=ql, ks=ks, vs=vs, page=page):
            return m.ragged_paged_attention(q, k, v, tables, p0, ql, ks, vs, page_size=page,
                                            int4=True)

        got = kernel()
        want = plain_fn(q, k, v, tables, p0, ql, ks, vs, page_size=page)
        torch.cuda.synchronize()
        valid = torch.arange(t, device=dev)[None] < ql[:, None]
        assert torch.all(got[~valid] == 0), f"{name} {label}: rows past q_len not 0"
        c = compare_bf16(got[valid], want[valid])
        msg = f"[kernel] {name} {label} (group {g}): {fmt(c)}"
        if label in ("8b", "8b-verify"):
            kd, vd = _dequant_g(k, ks, kh), _dequant_g(v, vs, kh)
            msg += _check_power(want, valid, name, {
                "causal edge one key late": plain_fn(q, k, v, tables, p0 + 1, ql, ks, vs,
                                                     page_size=page),
                "probabilities rounded once to bf16": _p_bf16_once(
                    q, kd, vd, tables, p0, ql, page=page),
                **{lab: p.flash_prefill_attention_plain(
                    q, _dequant_g(k, ks, kh, mode), _dequant_g(v, vs, kh, mode), tables, p0,
                    ql, page_size=page) for lab, mode in G_WRONG.items()}})
        log(msg)
        assert c["ok"], f"{name} {label}: outside one bf16 ulp + {ATOL_F32}"
        errs[label] = c["max_abs_err"]
        if label != "8b":
            continue
        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: plain_fn(q, k, v, tables, p0, ql, ks, vs, page_size=page))
        kd, vd = _dequant_g(k, ks, kh), _dequant_g(v, vs, kh)
        qq, kk, vv, mask = _sdpa_prefill_inputs(q, kd, vd, tables, p0, ql, page)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask))
        kv_rows = sum(p_ + n for p_, n in rows if n)
        n_q = sum(n for _, n in rows)
        nbytes = (n_q * h * hd * 2 + q.numel() * 2 + 2 * kv_rows * _g_bytes(kh, hd, ks.shape[1])
                  + (tables.numel() + 2 * b) * 4)
        flops = sum(4 * h * hd * sum(p_ + j + 1 for j in range(n)) for p_, n in rows)
        b_ms, by = bound_ms(nbytes, flops, peaks)
    log(f"[kernel] {name} group {group}: every case within one bf16 ulp + 2**-16, rows past "
        f"q_len 0; {ms:.4f} ms on the 8B rectangle (plain {plain_ms:.4f}, sdpa over KV "
        f"dequantized to bf16 beforehand {lib_ms:.4f}, bound {b_ms:.4f} by {by}); "
        + prefill_rates(ms, lib_ms, flops, 128, 3))
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by)


GROUP_CHECKS = {"kv_write_q4g": check_kv_write_q4g, "prefill_attention_q4g": check_prefill_q4g,
                "decode_attention_q4g": check_decode_q4g, "ragged_attention_q4g": check_ragged_q4g}


def check_groups(peaks, gen, dev, groups=GROUPS):
    """Phase 17's kernel checks: each grouped form at each group; returns
    GROUP_MAIN's results for the kernels line."""
    out = {}
    for g in groups:
        for name, check in GROUP_CHECKS.items():
            r = check(peaks, gen, dev, g)
            if g == GROUP_MAIN:
                out[name] = r
    return out


# ---------------------------------------------------------------- phase 16

# LLaVA-1.5's vision tower at its widths: CLIP ViT-L/14 at 336 px (576
# patches, hidden 1024, 24 layers, 16 heads, MLP 4 x 1024), projected into
# Llama-3.1-8B's hidden 4096. Only the widths are CLIP's: the block is the
# reference's own (RMSNorm, no biases, no CLS token).
VISION_CFG = dict(image_size=336, patch_size=14, hidden_size=1024, num_layers=24,
                  num_heads=16, out_size=4096)
# 8 requests of 64 text tokens (the same for all: one page), an image's 576
# positions and 64 text tokens of their own (ISL 704: the span crosses the
# 512-token chunk boundary), OSL 64, greedy
VISION_TRAFFIC = dict(n=8, text=64, tail=64, osl=64)
VISION_KV = (None, "int8")
# phase 5's engine
VISION_ENGINE = dict(model="llama-3.1-8b", dtype="bfloat16", page_size=64, num_pages=256,
                     max_batch_size=8, max_model_len=2048, prefill_chunk=512, decode_steps=8,
                     seed=0)
# the card's bf16 encoder against the port's f32 encoder on the CPU (the
# same weights, their bf16 values, and the same images): the output's
# relative Frobenius error, and the least cosine similarity of one patch's
# embedding. bf16 keeps 8 bits of each product and of the residual stream
# after every one of the 24 blocks, so a few 2**-8 add up; a wrong layout,
# a missing block or an f32-vs-bf16 softmax slip moves whole patches
VISION_REL_ERR = 0.05
VISION_MIN_COS = 0.995
VISION_CPU_IMAGES = 2


def check_vision(dev, peaks, vcfg, images):
    """The encoder on the card in bf16 against the port's encoder in f32 on
    the CPU for VISION_CPU_IMAGES images; its time for all of `images`.
    Returns the card's embeddings [n, patches, out] (bf16) and a summary."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.models import vision

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = vision.init_vision_params(vcfg, gen, dtype=torch.bfloat16)
    out = vision.encode(params, vcfg, images)
    torch.cuda.synchronize()
    n_cpu = VISION_CPU_IMAGES

    def f32_cpu(x):
        return [f32_cpu(y) for y in x] if isinstance(x, list) else (
            {k: f32_cpu(v) for k, v in x.items()} if isinstance(x, dict) else x.float().cpu())

    t0 = time.perf_counter()
    want = vision.encode(f32_cpu(params), vcfg, images[:n_cpu].float().cpu())
    cpu_s = time.perf_counter() - t0
    got = out[:n_cpu].float().cpu()
    d = vcfg.out_size
    assert out.shape == (len(images), vcfg.num_patches, d) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all()), "vision: non-finite embeddings"
    rel = ((got - want).norm() / want.norm()).item()
    cos = F.cosine_similarity(got.reshape(-1, d), want.reshape(-1, d), dim=-1).min().item()
    ms = time_ms(lambda: vision.encode(params, vcfg, images))
    t, dh = vcfg.num_patches, vcfg.hidden_size
    per_image = (2 * t * vcfg.patch_dim * dh + 2 * t * dh * d + vcfg.num_layers * (
        2 * t * dh * 3 * dh + 4 * t * t * dh + 2 * t * dh * dh + 2 * 2 * t * dh * 4 * dh))
    n_par = sum(x.numel() for x in [params["patch_proj"], params["pos_embed"], params["out_proj"]]
                ) + sum(x.numel() for lp in params["layers"] for x in lp.values())
    b_ms, by = bound_ms(2 * n_par + images.numel() * 4 + out.numel() * 2,
                        len(images) * per_image, peaks)
    summary = dict(rel_err=rel, min_cos=cos, encode_ms=ms, bound_ms=b_ms, bound_by=by,
                   images=len(images), params_b=n_par / 1e9, cpu_f32_s=cpu_s)
    log(f"[vision] encoder {vcfg} ({n_par / 1e9:.3f} B params, bf16) on the card against the "
        f"port's f32 encoder on the CPU for {n_cpu} images: relative error {rel:.3e} (gate "
        f"{VISION_REL_ERR}), least patch cosine {cos:.6f} (gate {VISION_MIN_COS}); "
        f"{len(images)} images in {ms:.4f} ms (bound {b_ms:.4f} by {by}, "
        f"{len(images) * per_image / (ms * 1e-3) / 1e12:.1f} TFLOP/s)")
    assert rel <= VISION_REL_ERR and cos >= VISION_MIN_COS, \
        f"vision: the card's encoder is off the CPU's (rel {rel:.3e}, cos {cos:.6f})"
    del params
    return out, summary


def _embeds_host_ms(eng, embeds, offset, n_tokens):
    """Host ms to take one request's embeds (Sequence.from_request, then
    the engine's device copy in the model dtype, synchronized): given as
    nested lists and as a numpy array."""
    from dynamo_tpu_torch.engine.scheduler import Sequence
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    host = embeds.float().cpu().numpy()
    out = {}
    for label, e in (("lists", host.tolist()), ("array", host)):
        pre = PreprocessedRequest(token_ids=list(range(n_tokens)), prompt_embeds=e,
                                  embeds_offset=offset)
        t0 = time.perf_counter()
        seq = Sequence.from_request(Context({}), pre, eng.page_size, eng.config.max_model_len)
        eng._take_embeds(seq)
        torch.cuda.synchronize()
        out[label] = 1e3 * (time.perf_counter() - t0)
        assert torch.equal(seq.prompt_embeds, embeds.to(eng._dtype))
    return out


def phase_vision(dev, params, peaks, smi="", cfg=None, vcfg=None, traffic=None):
    """Phase 16: the vision encoder at LLaVA-1.5's widths (check_vision),
    then image requests through TorchEngine on phase 5's engine in bf16 and
    int8 KV: the lookup oracle (a request whose embeds are the embed-table
    rows of its own placeholder tokens streams exactly the plain request's
    tokens), eight image requests at once (each reusing only the shared
    64-token text page), text-only prompts of the same ISL beside them, the
    launches the dispatch counters imply and no plain call. Returns the
    weights."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import vision

    vc = vision.VisionConfig(**dict(VISION_CFG, **(vcfg or {})))
    tr = dict(VISION_TRAFFIC, **(traffic or {}))
    n, text, tail, osl, p = tr["n"], tr["text"], tr["tail"], tr["osl"], vc.num_patches
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    images = torch.rand((n, vc.image_size, vc.image_size, 3), generator=gen, device=dev)
    embeds, vsum = check_vision(dev, peaks, vc, images)
    for kv_quant in VISION_KV:
        torch.cuda.empty_cache()
        conf = EngineConfig(**dict(VISION_ENGINE, **(cfg or {})), kv_quantization=kv_quant)
        tag = f"[vision {kv_quant or 'bf16'} KV]"
        eng = TorchEngine(conf, params=params, device=dev)
        assert eng.model_cfg.hidden_size == vc.out_size
        rng = np.random.RandomState(7)
        vocab = eng.model_cfg.vocab_size
        shared = rng.randint(0, vocab, size=text).tolist()

        def prompt():
            return (shared + rng.randint(0, vocab, size=p).tolist()
                    + rng.randint(0, vocab, size=tail).tolist())

        warm, first, oracle = prompt(), prompt(), prompt()
        prompts = [prompt() for _ in range(n)]
        plain_prompts = [rng.randint(0, vocab, size=text + p + tail).tolist() for _ in range(n)]
        spans = [(embeds[i], text) for i in range(n)]
        lookup = eng.params["embed"][torch.tensor(oracle[text:text + p], device=dev)]
        host_ms = _embeds_host_ms(eng, embeds[0], text, text + p + tail)

        async def go():
            # warm-up: the embed path, a chunk across the span, the graphs
            await run_requests(eng, [warm] * 2, 16, embeds=spans[:2])
            await run_requests(eng, plain_prompts[:2], 16)
            # the oracle, each request alone (the same dispatch shapes)
            eng.allocator.clear_cache()
            ref, _ = await run_requests(eng, [oracle], osl)
            eng.allocator.clear_cache()
            got, _ = await run_requests(eng, [oracle], osl, embeds=[(lookup, text)])
            assert got[0][0] == ref[0][0] and got[0][2] == "length", \
                f"{tag} the lookup embeds' stream differs from the plain request's"
            # one image request registers the shared text page; then eight
            # distinct images at once each reuse exactly that page
            eng.allocator.clear_cache()
            await run_requests(eng, [first], 4, embeds=spans[:1])
            torch.cuda.synchronize()
            s0 = eng.phase_stats
            reset_counts()
            metas = []
            with GcPauses() as gcp:
                res, wall = await run_requests(eng, prompts, osl, metas, embeds=spans)
            counts = read_counts()
            s1 = eng.phase_stats
            # the text-only round starts as the image round did: nothing
            # queued on the device (the pipeline's overshoot dispatch done)
            eng.allocator.clear_cache()
            torch.cuda.synchronize()
            res_t, wall_t = await run_requests(eng, plain_prompts, osl)
            await eng.close()
            return res, wall, metas, counts, s0, s1, res_t, wall_t, gcp

        res, wall, metas, counts, s0, s1, res_t, wall_t, gcp = asyncio.run(go())
        d = {k: s1[k] - s0[k] for k in s1}
        cached = [m_["prefix_cached_tokens"] for m_ in metas]
        assert cached == [text] * n, f"{tag} prefix hits {cached}: each should reuse only the " \
            f"shared {text}-token text page"
        for toks, _, reason, _ in res + res_t:
            assert len(toks) == osl and reason == "length"
            assert all(0 <= t < vocab for t in toks)
        check_counts(counts, path_launches(d, eng.model_cfg.num_layers, conf.decode_steps,
                                           kv_fmt(conf)), tag)
        step_ms = decode_step_ms(d, conf.decode_steps)
        m = {
            "encode_ms_8_images": vsum["encode_ms"],
            "embeds_host_ms": host_ms,
            "ttft_p50_s": statistics.median(r[1] for r in res),
            "ttft_p50_text_only_s": statistics.median(r[1] for r in res_t),
            "ttft_max_s": max(r[1] for r in res),
            "decode_step_ms": step_ms,
            "output_tok_s_wall": n * osl / wall,
            "output_tok_s_wall_text_only": n * osl / wall_t,
            "prefill_dispatches": d["prefill_dispatches"],
            "prefix_cached_tokens": cached[0],
            **gcp.summary(),
        }
        log(f"{tag} oracle: the lookup embeds stream the plain request's {osl} tokens; "
            f"{n} x (text {text} + image {p} + text {tail}, OSL {osl}), each reusing only the "
            f"shared text page: " + json.dumps(m) + f"; {smi}")
        log(f"{tag} launches: {json.dumps({k: v[0] for k, v in counts.items() if v[0]})}; "
            f"plain calls: {sum(v[1] for v in counts.values())}")
        params = eng.params
        del eng
    return params


# ---------------------------------------------------------------- phase 17, serving


def phase_groups(dev, params, peaks, smi="", cfg=None, groups=GROUPS):
    """Phase 17: the grouped int4 kernels against their plain versions at
    each of `groups` (check_groups), then phase 5's traffic with int4 KV in
    groups of GROUP_MAIN (pipeline on; decode step, TTFT and the KV pool's
    bytes beside one-group int4's on the same pages) and phase 8's wave with
    mixed steps and speculative decoding on (K4's grouped form). Returns
    GROUP_MAIN's kernel results, the main path's launches and the weights."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = check_groups(peaks, gen, dev, groups)
    torch.cuda.empty_cache()
    counts, m, params = phase_full_width(dev, kv_quant="int4", kv_quant_group=GROUP_MAIN,
                                         params=params, pipe=True, **(cfg or {}))
    launches = {k: counts[k] for k in INT4G_KERNELS}
    from dynamo_tpu_torch.models.config import get_config

    mc = get_config((cfg or {}).get("model", "llama-3.1-8b"))
    one_group = 2 * mc.num_layers * 256 * 64 * (mc.kv_size // 2 + 4 * mc.num_kv_heads)
    log(f"[groups] int4 in groups of {GROUP_MAIN}: decode step {m['decode_step_ms']:.4f} ms, TTFT "
        f"p50 {m['ttft_p50_s']:.4f} s, KV pools {m['kv_pool_gb']:.3f} GB against one-group "
        f"int4's {one_group / 1e9:.3f} GB on the same 256 pages "
        f"({2 * 4 * (mc.head_dim // GROUP_MAIN - 1) * mc.num_kv_heads} B a token and layer more "
        f"scales); {smi}")
    torch.cuda.empty_cache()
    counts, mw, _, params = phase_wave(dev, params, kv_quant="int4",
                                       cfg=dict(kv_quant_group=GROUP_MAIN, **(cfg or {})))
    launches["ragged_attention_q4g"] = counts["ragged_attention_q4g"]
    log(f"[groups] wave, mixed + spec on, int4 in groups of {GROUP_MAIN}: " + json.dumps(
        {k: mw[k] for k in ("wave_ttft_p50_s", "held_max_gap_in_wave_s", "held_tok_s_in_wave",
                            "mixed_steps", "spec_dispatches", "decode_step_ms")}) + f"; {smi}")
    return results, launches, params


# ---------------------------------------------------------------- phase 18

# the robustness and observability planes at the serving preset's width:
# phase 8's engine (8B, page 64, 256 pages, batch 8, pipeline on) with mixed
# steps and speculative decoding on; `phase_planes(cfg=..., traffic=...)`
# swaps in a small model for a CPU rehearsal
PLANES_CFG = dict(WAVE_CFG, model=SERVE_PRESET, mixed_batching=True, spec_decode=True)
PLANES_TRAFFIC = dict(WAVE_TRAFFIC, n=8, isl=512, osl=64)
PLANES_WATCHDOG_S = 1.0   # the budget, armed once the warm-up captured its graphs
PLANES_STALL_S = 4.0      # the injected stall: four budgets
PLANES_REPROBE_S = 6.0    # outlasts the stalled round, so the trip is read after it
PLANES_AUDIT_S = 0.1      # the leak check's audit period
# the vendored checkpoint's wave (tests/test_torch_step_pipeline.py's):
# a held stream, then three 45-token prompts once it has 9 tokens
CKPT_WAVE = dict(page_size=16, num_pages=64, max_batch_size=4, max_model_len=256,
                 prefill_chunk=32, decode_steps=4, seed=0, mixed_batching=True,
                 mixed_step_tokens=64)


async def events_round(engine, prompts, osl, steps):
    """Serve `prompts` at once (greedy, `osl` tokens each) and time decode
    on the device's clock: a CUDA event recorded on the compute stream
    when every stream has its first token, another when the slowest one
    reaches `osl - steps` tokens (before the last dispatches, so both sit
    one queued dispatch behind the host, as in steady state). Returns
    (device ms a token between them, each stream's tokens, TTFTs)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    n = len(prompts)
    toks = [[] for _ in range(n)]
    ttft = [None] * n
    ev = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
    at = [None, None]  # tokens a stream had at each event (the slowest's)
    t0 = time.perf_counter()

    def mark(k):
        if at[k] is None:
            ev[k].record()
            at[k] = min(len(t) for t in toks)

    async def one(i, ids):
        pre = PreprocessedRequest(
            token_ids=list(ids), stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
            sampling_options=SamplingOptions(greedy=True))
        async for f in await engine.generate(Context(pre.to_dict())):
            got = f.get("token_ids") or []
            if got and ttft[i] is None:
                ttft[i] = time.perf_counter() - t0
            toks[i].extend(got)
            if all(toks):
                mark(0)
            if min(len(t) for t in toks) >= osl - steps:
                mark(1)
            if f.get("finish_reason"):
                assert f["finish_reason"] == "length" and len(toks[i]) == osl, \
                    f"stream of {len(toks[i])} tokens ({f['finish_reason']})"

    await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    per_tok = ev[0].elapsed_time(ev[1]) / max(at[1] - at[0], 1)
    return per_tok, toks, ttft


def _audit_ms(ledger, reps=5):
    """Median host ms of one audit pass (the second and later passes see
    the suspects of the one before, as steady audits do)."""
    ledger.audit()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ledger.audit()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def _fill_pool(alloc, ledger, owners=64):
    """Hold every free page of the pool for `owners` request-shaped owners,
    a registered hash on every other page (a pool at its fullest: every
    page active, the audit's holdings walk at its longest). Returns the
    holds, for `_drain_pool`."""
    pages = alloc.allocate(alloc.pages_free)
    holds = {}
    for i, pid in enumerate(pages):
        holds.setdefault(f"req-{i % owners}", []).append(pid)
    for owner, pids in holds.items():
        ledger.hold(pids, owner)
    half = pages[::2]
    alloc.register(half, [(10_000_000 + p, 10_000_000 + p) for p in half], None)
    return holds


def _drain_pool(alloc, ledger, holds):
    for owner, pids in holds.items():
        ledger.drop(pids, owner)
        alloc.release(pids)
    alloc.clear_cache()


def planes_audit(eng, smi):
    """The custody audit's host ms at an auto-sized pool: idle, and with
    every page held; then on a host-only allocator and ledger of the page
    count int4 KV's auto-sizer would give (the same bytes, four times the
    pages), held the same way."""
    from dynamo_tpu_torch.engine.allocator import PageAllocator
    from dynamo_tpu_torch.engine.kv_ledger import KvLedger

    alloc, ledger = eng.allocator, eng.kv_ledger
    idle_ms = _audit_ms(ledger)
    holds = _fill_pool(alloc, ledger)
    full_ms = _audit_ms(ledger)
    _drain_pool(alloc, ledger, holds)
    m = eng.model_cfg
    bf16_token = 2 * m.num_kv_heads * m.head_dim * 2
    int4_token = 2 * (m.num_kv_heads * m.head_dim // 2 + 4 * m.num_kv_heads)
    int4_pages = int(eng.num_pages * bf16_token // int4_token)
    led4 = KvLedger()
    alloc4 = PageAllocator(int4_pages, eng.page_size, ledger=led4)
    led4.allocator = alloc4
    holds4 = _fill_pool(alloc4, led4)
    int4_ms = _audit_ms(led4)
    out = {"auto_pages": eng.num_pages, "page_mb": m.num_layers * eng.page_size * bf16_token / 2**20,
           "audit_idle_ms": idle_ms, "audit_full_ms": full_ms,
           "int4_auto_pages": int4_pages, "audit_full_int4_ms": int4_ms}
    _drain_pool(alloc4, led4, holds4)
    log(f"[planes] KV custody audit on the loop thread at the auto-sized pool "
        f"(hbm_utilization {eng.config.hbm_utilization}, bf16 KV): " + json.dumps(out)
        + f"; {smi}")
    return out


def phase_planes(dev, params, smi="", cfg=None, traffic=None):
    """Phase 18: the robustness and observability planes at the serving
    preset's width (random bf16 weights, seed 0), pipeline, mixed steps and
    speculative decoding on.

    1. Their cost: phase 8's wave and a round of `n` requests (ISL `isl`,
       OSL `osl`) on an engine at the defaults (flight recorder on, the
       5 s audit) with tracing armed, and on one with `flight_recorder=
       False, kv_audit_s=0` and tracing off, in turns (on, off, off, on),
       each after its own warm-up:
       wave TTFT p50, the decode step's host walls (as phase 5 reads them)
       and its device ms a token between two CUDA events
       (`events_round`), the launches the dispatch counters imply with
       every plane on, and one audit pass's host ms at the auto-sized
       pool (`planes_audit`).
    2. The watchdog: `engine.dispatch.delay` of four budgets, once, on a
       warmed engine: it fires once and trips `step_pipeline`, the crash
       artifact holds the digests and the trace ring, every request
       streams its full count, and after `degrade_reprobe_s` the rung
       recovers (`recoveries_total` 1); trip-to-recovery seconds printed.
    3. A failed mixed step (`engine.mixed.fail@1x1`) in the wave: the
       `mixed` rung trips for good and no request fails; on the vendored
       checkpoint (bf16) the greedy streams equal the no-fault run's.
    4. A skipped release (`engine.release.failx1`): the audit names the
       orphan pages under the request's id and one kv_leak artifact is
       written.
    Returns the cost figures and the weights."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine
    from dynamo_tpu_torch.utils import faults, tracing

    tr = dict(PLANES_TRAFFIC, **(traffic or {}))
    base = dict(PLANES_CFG, **(cfg or {}))
    rng = np.random.RandomState(5)
    tmp = tempfile.TemporaryDirectory()
    out = {}

    def engine(params, **kw):
        eng = TorchEngine(EngineConfig(**dict(base, **kw)), params=params, device=dev)
        return eng, eng.params

    def prompts(n, isl):
        return [rng.randint(0, vocab, size=isl).tolist() for _ in range(n)]

    # 1. the cost of the defaults, against every plane off
    from dynamo_tpu_torch.models.config import get_config

    mc0 = base["model"] if not isinstance(base["model"], str) else get_config(base["model"])
    vocab = mc0.vocab_size
    held, wave = prompts(tr["held"], tr["held_isl"]), prompts(tr["wave"], tr["wave_isl"])
    warm = prompts(tr["wave"], tr["wave_isl"])
    round_p = prompts(tr["n"], tr["isl"])
    defaults = ("defaults", {}, True)
    off = ("planes off", dict(flight_recorder=False, kv_audit_s=0.0), False)
    for i, (label, kw, trace) in enumerate((defaults, off, off, defaults)):  # in turns
        torch.cuda.empty_cache()
        eng, params = engine(params, **kw)
        tag = f"[planes {label}]"

        async def go(eng=eng):
            await wave_requests(eng, warm, warm, 16, 8, 4)
            await events_round(eng, round_p, 16, eng.config.decode_steps)
            await idle(eng)
            if trace:
                tracing.clear()
                tracing.enable()
            try:
                s0 = eng.phase_stats
                reset_counts()
                res = await wave_requests(eng, held, wave, tr["held_osl"], tr["wave_osl"],
                                          tr["held_before"])
                await idle(eng)
                counts = read_counts()
                s1 = eng.phase_stats
                tok_ms, _, ttft = await events_round(eng, round_p, tr["osl"],
                                                     eng.config.decode_steps)
                s2 = eng.phase_stats
                n_ev = sum(1 for e in tracing.export()["traceEvents"] if e["ph"] != "M")
            finally:
                tracing.disable()
                tracing.clear()
            m = eng.metrics()
            await eng.close()
            return res, counts, s0, s1, s2, tok_ms, ttft, n_ev, m

        (held_res, wave_res, _, t_wave), counts, s0, s1, s2, tok_ms, ttft, n_ev, m = \
            asyncio.run(go())
        d = {k: s1[k] - s0[k] for k in s1}
        d2 = {k: s2[k] - s1[k] for k in s2}
        check_counts(counts, path_launches(d, eng.model_cfg.num_layers, eng.config.decode_steps,
                                           None), f"{tag} wave")
        assert d["mixed_steps"] > 0, f"{tag}: no mixed step ran"
        wttft = sorted(times[0] - t0 for _, times, t0 in wave_res)
        out.setdefault(label, []).append({
            "wave_ttft_p50_s": statistics.median(wttft), "wave_ttft_max_s": wttft[-1],
            "round_ttft_p50_s": statistics.median(ttft),
            "decode_step_ms_host": decode_step_ms(d2, eng.config.decode_steps),
            "decode_ms_a_token_events": tok_ms,
            "flight_digests": m["flight_digests"], "kv_ledger_audits": m["kv_ledger_audits"],
            "trace_events": n_ev, "compile_events": m["compile_events"],
            "compile_time_s": m["compile_time_s"],
        })
        log(f"{tag} run {i + 1} of 4: wave ({tr['held']} held + {tr['wave']}) and a round of "
            f"{tr['n']} x (ISL {tr['isl']}, OSL {tr['osl']}); launches as the dispatch counters "
            f"imply, no plain call: " + json.dumps(out[label][-1]) + f"; {smi}")
        del eng
        gc.collect()
    log("[planes] the planes' cost, in turns (defaults with tracing / every plane off): "
        + json.dumps({k: {label: [r[k] for r in out[label]] for label in ("defaults", "planes off")}
                      for k in ("wave_ttft_p50_s", "round_ttft_p50_s", "decode_step_ms_host",
                                "decode_ms_a_token_events")}) + f"; {smi}")
    torch.cuda.empty_cache()
    eng, params = engine(params, num_pages=None)
    out["audit"] = planes_audit(eng, smi)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the watchdog: a stalled decode enqueue, then the re-probe
    crash = os.path.join(tmp.name, "watchdog")
    eng, params = engine(params, degrade_reprobe_s=PLANES_REPROBE_S, crash_dir=crash)
    tag = "[planes watchdog]"

    async def watchdog(eng=eng):
        await run_requests(eng, warm, 16)  # captures this width's graphs
        m0 = eng.metrics()
        eng._watchdog_s = PLANES_WATCHDOG_S
        eng._ensure_watchdog()
        tracing.clear()
        tracing.enable()
        faults.configure(f"engine.dispatch.delay={PLANES_STALL_S}@1x1")
        try:
            await idle(eng)
            s0 = eng.phase_stats
            reset_counts()
            res, _ = await run_requests(eng, round_p, tr["osl"])
            await idle(eng)
            counts = read_counts()
            s1 = eng.phase_stats
        finally:
            faults.reset()
            tracing.disable()
        m1 = eng.metrics()
        t_fire = os.path.getmtime(eng.last_crash_artifact)
        while eng._degrade.tripped("step_pipeline"):
            await run_requests(eng, round_p[:1], 2)
            await asyncio.sleep(0.05)
        t_rec = time.time()
        m2 = eng.metrics()
        await eng.close()
        return m0, m1, m2, res, counts, s0, s1, t_rec - t_fire

    m0, m1, m2, res, counts, s0, s1, trip_to_recovery = asyncio.run(watchdog())
    tracing.clear()
    d = {k: s1[k] - s0[k] for k in s1}
    check_counts(counts, path_launches(d, eng.model_cfg.num_layers, eng.config.decode_steps,
                                       None), tag)
    for toks, _, reason, _ in res:
        assert len(toks) == tr["osl"] and reason == "length", f"{tag}: {len(toks)} ({reason})"
    assert m1["watchdog_fired"] - m0["watchdog_fired"] == 1, f"{tag}: {m1['watchdog_fired']}"
    assert m1["degraded_step_pipeline"] == 1 and m1["degrades_total"] == 1, m1
    assert m2["recoveries_total"] == 1 and m2["degraded_step_pipeline"] == 0, m2
    art = json.load(open(eng.last_crash_artifact))
    assert art["op"] in ("decode.dispatch", "spec.dispatch"), art["op"]
    assert art["rung_tripped"] == "step_pipeline", art["rung_tripped"]
    assert art["digests"] and art["digest_fields"], f"{tag}: no digests in the artifact"
    n_trace = sum(1 for e in art["trace"]["traceEvents"] if e["ph"] != "M")
    assert n_trace > 0, f"{tag}: the artifact's trace ring is empty"
    out["watchdog"] = {"stalled_s": art["stalled_s"], "trip_to_recovery_s": trip_to_recovery,
                       "artifact_digests": len(art["digests"]), "artifact_trace_events": n_trace,
                       "budget_s": PLANES_WATCHDOG_S, "reprobe_s": PLANES_REPROBE_S,
                       "compile_events": m2["compile_events"],
                       "compile_time_s": m2["compile_time_s"]}
    log(f"{tag} engine.dispatch.delay={PLANES_STALL_S} once: fired once, step_pipeline tripped, "
        f"every stream whole, recovered after the re-probe: " + json.dumps(out["watchdog"])
        + f"; {smi}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # 3 and 4. a failed mixed step, then a skipped release
    crash = os.path.join(tmp.name, "leak")
    eng, params = engine(params, kv_audit_s=PLANES_AUDIT_S, crash_dir=crash)
    eng.flight.cooldown_s = 0.0
    tag = "[planes mixed failure]"

    async def contained(eng=eng):
        await wave_requests(eng, warm, warm, 16, 8, 4)
        await idle(eng)
        s0 = eng.phase_stats
        reset_counts()
        faults.configure("engine.mixed.fail@1x1")
        try:
            await wave_requests(eng, held, wave, tr["held_osl"], tr["wave_osl"],
                                tr["held_before"])
            await idle(eng)
            fired = faults.stats()["engine.mixed"]["fired"]
        finally:
            faults.reset()
        counts = read_counts()
        s1 = eng.phase_stats
        m = eng.metrics()
        # the leak: one request whose release is skipped
        from dynamo_tpu_torch.llm.protocols.common import (
            PreprocessedRequest, SamplingOptions, StopConditions)
        from dynamo_tpu_torch.runtime.pipeline.context import Context

        pre = PreprocessedRequest(token_ids=round_p[0], sampling_options=SamplingOptions(
            greedy=True), stop_conditions=StopConditions(max_tokens=8, ignore_eos=True))
        ctx = Context(pre.to_dict())
        faults.configure("engine.release.failx1")
        try:
            async for _ in await eng.generate(ctx):
                pass
        finally:
            faults.reset()
        t0 = time.perf_counter()
        while not eng.kv_ledger.violations_total and time.perf_counter() - t0 < 10.0:
            await asyncio.sleep(0.02)
        found = time.perf_counter() - t0
        await asyncio.sleep(0.3)
        await eng.close()
        return fired, counts, s0, s1, m, ctx.id, found

    fired, counts, s0, s1, m, rid, found_s = asyncio.run(contained())
    d = {k: s1[k] - s0[k] for k in s1}
    check_counts(counts, path_launches(d, eng.model_cfg.num_layers, eng.config.decode_steps,
                                       None), tag)
    assert fired == 1 and m["mixed_disabled"] == 1 and m["degraded_mixed"] == 1, m
    assert eng._degrade.disabled("mixed"), f"{tag}: the mixed trip is not permanent"
    log(f"{tag} engine.mixed.fail@1x1 in phase 8's wave: contained (every stream whole), "
        f"mixed disabled for good; mixed steps landed {d['mixed_steps']}, "
        f"prefill dispatches {d['prefill_dispatches']}, decode {d['decode_dispatches']}")
    viol = list(eng.kv_ledger.violations_log)
    assert viol and viol[0].kind == "orphan_page" and viol[0].owner == rid, viol[:1]
    leaks = [json.load(open(p)) for p in glob.glob(os.path.join(crash, "flight_recorder_*.json"))]
    leaks = [a for a in leaks if a["reason"].startswith("kv_leak")]
    assert len(leaks) == 1 and leaks[0]["request_id"] == rid, [a["reason"] for a in leaks]
    assert leaks[0]["context"]["kv_ledger"]["orphan_pages"] == viol[0].page_ids
    log(f"[planes leak] engine.release.failx1: the audit ({PLANES_AUDIT_S} s) named "
        f"{len(viol[0].page_ids)} orphan pages of {rid} after {found_s:.3f} s; one kv_leak "
        f"artifact")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    streams = planes_ckpt_streams(dev)
    tmp.cleanup()
    out["checkpoint_streams_equal"] = streams
    return out, params


def planes_ckpt_streams(dev):
    """The vendored checkpoint in bf16 on the card: the wave with mixed
    steps served without a fault, then with `engine.mixed.fail@1x1`; the
    greedy streams must be equal and the second run's mixed steps
    disabled. Returns the number of tokens compared."""
    from dynamo_tpu_torch import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.models.weights import load_config
    from dynamo_tpu_torch.runtime.pipeline.context import Context
    from dynamo_tpu_torch.utils import faults

    rng = np.random.RandomState(0)
    wave = [rng.randint(3, 60, size=45).tolist() for _ in range(3)]  # vocab 68
    held = [5, 17, 42, 9] * 6

    async def serve(spec):
        eng = TorchEngine(EngineConfig(model=load_config(CKPT), checkpoint_dir=CKPT,
                                       dtype="bfloat16", **CKPT_WAVE), device=dev)
        go = asyncio.Event()

        async def one(ids, n, signal=False):
            pre = PreprocessedRequest(
                token_ids=list(ids), stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
                sampling_options=SamplingOptions(greedy=True))
            toks = []
            async for f in await eng.generate(Context(pre.to_dict())):
                toks.extend(f.get("token_ids") or [])
                if signal and len(toks) >= 9:
                    go.set()
            assert len(toks) == n, f"stream of {len(toks)} tokens"
            return toks

        async def arrivals():
            await go.wait()
            return await asyncio.gather(*[one(p, 10) for p in wave])

        faults.configure(spec)
        try:
            h, w = await asyncio.gather(one(held, 48, True), arrivals())
            m = eng.metrics()  # faults_injected reads the armed registry
        finally:
            faults.reset()
        await eng.close()
        return [h, *w], m

    ref, m_ref = asyncio.run(serve(None))
    got, m_got = asyncio.run(serve("engine.mixed.fail@1x1"))
    assert m_ref["mixed_steps"] > 0, "the checkpoint's wave took no mixed step"
    assert m_got["mixed_disabled"] == 1 and m_got["faults_injected"] == 1, m_got
    assert got == ref, "a contained mixed failure changed a greedy stream"
    n = sum(len(x) for x in ref)
    log(f"[planes checkpoint] tiny-trained-llama bf16, the wave with mixed steps "
        f"({m_ref['mixed_steps']} in the clean run): {n} greedy tokens equal with "
        f"engine.mixed.fail@1x1 (contained, mixed disabled) and without")
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1,
                    help="pipeline off/on pairs of phases 5, 6 and 7, and of phase 8's "
                         "bf16 wave, in turns (default 1)")
    ap.add_argument("--serving", type=int, default=0, metavar="N",
                    help="measurement: build the kernels, run phase 11 alone N times and "
                         "exit, without the result lines")
    args = ap.parse_args()
    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import dynamo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from dynamo_tpu_torch.ops import _cuda

    global time_ms
    from dynamo_tpu_torch.scripts import time_ms

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    part, peaks = card_peaks(name)
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; peaks used for bounds: H100 {part} "
        f"{peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} bf16 TFLOP/s")

    t0 = time.perf_counter()
    _cuda.build()
    log(f"[build] {len(_cuda.SOURCES)} sources (twenty-one kernels: twelve on the serving "
        f"path, the grouped int4 forms of K5-K7 among them, K4 entering K2/K6, the four W8A8 "
        f"kernels, the five probe kernels K8-K10, and an empty one) built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_cuda.NVCC_FLAGS[:2])})")
    for n, text in _cuda.build_logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[ptxas] {n}: {line.strip()}")

    if args.serving:
        for _ in range(args.serving):
            torch.cuda.empty_cache()
            phase_serving(dev, smi=smi)
        return 0

    from dynamo_tpu_torch.scripts import empty_launch

    floor_ms = time_ms(lambda: empty_launch(dev))
    log(f"[kernel] launch_floor: {floor_ms:.4f} ms (an empty kernel, one block of one warp, "
        f"timed as every row below)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {
        "kv_write": check_kv_write(peaks, gen, dev),
        "prefill_attention": check_prefill(peaks, gen, dev),
        "decode_attention": check_decode(peaks, gen, dev),
        "kv_write_q": check_kv_write_q(peaks, gen, dev),
        "prefill_attention_q": check_prefill_q(peaks, gen, dev),
        "decode_attention_q": check_decode_q(peaks, gen, dev),
        "kv_write_q4": check_kv_write_q(peaks, gen, dev, int4=True),
        "prefill_attention_q4": check_prefill_q(peaks, gen, dev, int4=True),
        "decode_attention_q4": check_decode_q(peaks, gen, dev, int4=True),
        "ragged_attention": check_ragged(peaks, gen, dev, "bf16"),
        "ragged_attention_q": check_ragged(peaks, gen, dev, "int8"),
        "ragged_attention_q4": check_ragged(peaks, gen, dev, "int4"),
        "page_copy": check_page_copy(peaks, gen, dev),
        **check_bitcast(peaks, gen, dev),
        "page_gather": check_page_gather(peaks, gen, dev),
        **check_w8a8(peaks, gen, dev),
    }
    check_kv_division(dev)
    inject_ms = results["bitcast_inject"]["ms"]
    log(f"[kernel] bitcast_inject against the launch floor: {inject_ms:.4f} ms, floor "
        f"{floor_ms:.4f}, {1e3 * (inject_ms - floor_ms):.2f} us above it")
    phase_real_http(phase_real_weights(dev))
    # phases 5, 6 and 7 (bf16, int8 and int4 KV) on one set of weights,
    # each with the step pipeline off then on; --pairs repeats the pairs in
    # turns, for their spread
    launches, params, dense = {}, None, {}
    for i in range(args.pairs):
        for kv_quant, names in PATH_KERNELS.items():
            for pipe in (False, True):
                torch.cuda.empty_cache()
                streams = []
                counts, m, params = phase_full_width(dev, kv_quant=kv_quant, params=params,
                                                     pipe=pipe, streams=streams)
                if i == 0 and pipe:
                    launches.update({k: counts[k] for k in names})
                    dense[kv_quant] = (m, streams)
    # phase 8: the admission wave in bf16 KV with mixed steps and spec off
    # (the held streams' reference), then on with the step pipeline off and
    # on (--pairs times, in turns), then int8 and int4 KV with all three on
    torch.cuda.empty_cache()
    _, _, ref_held, params = phase_wave(dev, params, on=False)
    for i in range(args.pairs):
        for pipe in (False, True):
            torch.cuda.empty_cache()
            counts, _, _, params = phase_wave(dev, params, on=True, ref_held=ref_held, pipe=pipe)
            if i == 0 and pipe:
                launches["ragged_attention"] = counts["ragged_attention"]
    for kv_quant in ("int8", "int4"):
        torch.cuda.empty_cache()
        counts, _, _, params = phase_wave(dev, params, kv_quant=kv_quant, on=True)
        launches[RAGGED_KERNEL[kv_quant]] = counts[RAGGED_KERNEL[kv_quant]]
    # phase 9: the probe path
    torch.cuda.empty_cache()
    launches.update(phase_probes(peaks, dev))
    # phase 10: the prefix cache and the prefix wire, on phase 5's weights
    for kv_quant in PATH_KERNELS:
        torch.cuda.empty_cache()
        _, params = phase_prefix(dev, params, kv_quant=kv_quant, smi=smi)
    # phase 12: the extended sampler, then penalties, logprobs, seeds and
    # a mixed round through the decode graphs, on phase 5's weights
    torch.cuda.empty_cache()
    check_sampler(dev)
    _, params = phase_ext(dev, params, smi=smi)
    # phase 13: W8A8 weights, phase 5's quantized in place, bf16 and int8 KV
    counts, params = phase_w8a8(dev, params, dense, smi=smi)
    launches.update({k: counts[k] for k in W8A8_KERNELS})
    del params
    # phase 14: the host offload tier, prefill_only -> generate_remote and
    # the device-path transfer, bf16 then int8 KV, on phase 5's weights
    # (made again from seed 0: phase 13 quantized phase 5's in place). An
    # engine's decode graphs hold it in a reference cycle: collect phase
    # 13's engines first, or their W8A8 weights stay counted in the peak
    gc.collect()
    params = None
    for kv_quant in OFFLOAD_KV:
        torch.cuda.empty_cache()
        _, params = phase_offload(dev, params, kv_quant=kv_quant, smi=smi)
    del params
    # phase 15: the sparse-MoE family, Mixtral-8x7B's widths at 16 layers;
    # phase 14's engines collected first (their weights leave the card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe(dev, peaks, part, smi=smi)
    # phase 16: the vision encoder at LLaVA-1.5's widths and image requests
    # on phase 5's engine and weights (made again from seed 0), bf16 then
    # int8 KV; phase 17: the grouped int4 kernels, then int4 KV in groups of
    # 32 on the same weights
    gc.collect()
    torch.cuda.empty_cache()
    params = phase_vision(dev, None, peaks, smi=smi)
    g_results, g_launches, params = phase_groups(dev, params, peaks, smi=smi)
    results.update(g_results)
    launches.update(g_launches)
    # phase 18: the robustness and observability planes at the serving
    # preset's width, on the same weights
    gc.collect()
    torch.cuda.empty_cache()
    _, params = phase_planes(dev, params, smi=smi)
    del params
    gc.collect()
    # phase 11: the serving entry at full width (its own engine, seed 0)
    torch.cuda.empty_cache()
    phase_serving(dev, smi=smi)

    meta = {
        "kv_write": ("dynamo_tpu_torch/csrc/kv_write.cu", "dynamo_tpu/ops/pallas_kv_write.py:60"),
        "prefill_attention": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                              "dynamo_tpu/ops/pallas_prefill.py:224"),
        "decode_attention": ("dynamo_tpu_torch/csrc/decode_attention.cu",
                             "dynamo_tpu/ops/pallas_attention.py:622"),
        "kv_write_q": ("dynamo_tpu_torch/csrc/kv_write.cu", "dynamo_tpu/ops/pallas_kv_write.py:45"),
        "prefill_attention_q": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                                "dynamo_tpu/ops/pallas_prefill.py:152"),
        "decode_attention_q": ("dynamo_tpu_torch/csrc/decode_attention.cu",
                               "dynamo_tpu/ops/pallas_attention.py:244"),
        "kv_write_q4": ("dynamo_tpu_torch/csrc/kv_write.cu", "dynamo_tpu/ops/pallas_kv_write.py:45"),
        "prefill_attention_q4": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                                 "dynamo_tpu/ops/pallas_prefill.py:136"),
        "decode_attention_q4": ("dynamo_tpu_torch/csrc/decode_attention.cu",
                                "dynamo_tpu/ops/pallas_attention.py:333"),
        "ragged_attention": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                             "dynamo_tpu/ops/pallas_attention.py:951"),
        "ragged_attention_q": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                               "dynamo_tpu/ops/pallas_attention.py:951"),
        "ragged_attention_q4": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                                "dynamo_tpu/ops/pallas_attention.py:951"),
        "page_copy": ("dynamo_tpu_torch/csrc/probes.cu", "scripts/proto_page_write.py:38"),
        "bitcast_unpack": ("dynamo_tpu_torch/csrc/probes.cu", "scripts/probe_bitcast.py:28"),
        "bitcast_pack": ("dynamo_tpu_torch/csrc/probes.cu", "scripts/probe_bitcast.py:60"),
        "bitcast_inject": ("dynamo_tpu_torch/csrc/probes.cu", "scripts/probe_bitcast.py:83"),
        "page_gather": ("dynamo_tpu_torch/csrc/probes.cu", "scripts/profile_dma.py:19"),
        # XLA ops, no pallas_call: the two halves of quant_matmul, the
        # quantization also fused with the norm (ops/norm.py:12) and with
        # SiLU x up (models/llama.py's MLP) that feed it
        "quantize_rows": ("dynamo_tpu_torch/csrc/w8a8.cu", "dynamo_tpu/ops/quant.py:60"),
        "rms_norm_quantize_rows": ("dynamo_tpu_torch/csrc/w8a8.cu",
                                   "dynamo_tpu/ops/quant.py:60"),
        "silu_mul_quantize_rows": ("dynamo_tpu_torch/csrc/w8a8.cu",
                                   "dynamo_tpu/ops/quant.py:60"),
        "w8a8_gemm": ("dynamo_tpu_torch/csrc/w8a8.cu", "dynamo_tpu/ops/quant.py:60"),
        # int4 in scale groups finer than head_dim: the reference serves it
        # on its gather backend, XLA ops and no pallas_call (the row write
        # of models/llama.py, the dequantizing gather attention)
        "kv_write_q4g": ("dynamo_tpu_torch/csrc/kv_write.cu", "dynamo_tpu/models/llama.py:316"),
        "prefill_attention_q4g": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                                  "dynamo_tpu/ops/attention.py:75"),
        "decode_attention_q4g": ("dynamo_tpu_torch/csrc/decode_attention.cu",
                                 "dynamo_tpu/ops/attention.py:75"),
        "ragged_attention_q4g": ("dynamo_tpu_torch/csrc/prefill_attention.cu",
                                 "dynamo_tpu/ops/attention.py:75"),
    }
    log(f"[smoke] phases 1-18 took {time.perf_counter() - t_smoke:.1f} s of wall time, build "
        f"included")
    kernels = []
    for k, r in results.items():
        src, rep = meta[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor_ms}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
