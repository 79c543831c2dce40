"""The decode dispatch as one CUDA graph.

The port's counterpart of the JAX package's jitted decode scan
(`dynamo_tpu/engine/engine.py::_decode_fn`): a decode dispatch runs
`decode_steps` model steps, each a few hundred kernel launches, and eager
PyTorch pays the host's launch cost for every one of them. Here the whole
loop is captured once for each key met, after one eager run at that key,
and every later dispatch of that key is one `cudaGraphLaunch`. A key is
(dispatch width, all_greedy, use_ext, want_lps, want_tops, steps): the
middle three say which parts of the extended sampler the batch needs
(penalties and seeds, logprobs, top-N alternatives), so a batch that needs
none replays the same graph it would without them; `steps` is the loop's
length, `decode_steps`, or 1 while the degrade ladder sheds the multi-step
loop (engine/degrade.py `decode_scan`), whose re-probe returns to the
graphs captured before it. Each capture counts as a compile event
(engine/telemetry.py).

What makes the loop capturable:
- it reads only static device buffers that the engine writes before each
  replay (the token carry and its logprob and tops, the fused [positions,
  active] upload, the block tables and the sampling parameters) and writes
  its outputs into buffers the graph owns, and the new carry and the
  penalty count rows in place;
- the kernels launch on `torch.cuda.current_stream`, the capture stream
  while capturing; their host plans (`split_plan`, `copy_plan`) read
  shapes only;
- the split kernels' partials and tickets (K3/K5 and the W8A8 GEMM, all
  in `ops/_cuda.scratch`) are grown by the eager run before the capture,
  and each graph keeps the buffers it captured alive (a later, larger call
  may replace them in the registry); the kernels leave their tickets at 0
  themselves;
- the sampler's generator is registered with each graph, so every replay
  draws fresh Gumbel noise; seeded rows draw from a stateless hash of
  their seed and position, which has no state to register;
- the kernel wrappers' launch counters count in Python, so they move while
  capturing and not on replay: each graph records its counts at capture,
  takes them back, and adds them on every replay, so the counts stay exact;
- the W8A8 weights (`quantization="int8"`) are static, so a W8A8 dispatch
  replays one graph per key as a bf16 one does; the activation codes and
  scales are allocations of the graph's pool;
- nothing frees a CUDA graph while one is being captured: destroying a
  graph (`CUDAGraph.reset`) is not permitted during a capture and
  invalidates it, and a dead engine's graphs sit in reference cycles that
  any collection may free. `torch.cuda.graph` no longer collects first
  (unless `torch.compiler.config.force_cudagraph_gc`), so the capture
  collects before it begins and keeps the collector off until it ends.

A capture or replay that fails raises: there is no eager fallback. On the
CPU the same function runs eagerly every time.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from dynamo_tpu_torch.engine import telemetry
from dynamo_tpu_torch.ops import _cuda, decode_attention, kv_write, prefill_attention, w8a8


def launch_counters() -> list:
    """(wrapper, counter attribute) of every serving-path kernel."""
    wrappers = (kv_write.paged_kv_write, prefill_attention.flash_prefill_attention,
                decode_attention.fused_paged_decode_attention,
                decode_attention.ragged_paged_attention)
    return ([(w, a) for w in wrappers
             for a in ("launches", "launches_q", "launches_q4", "launches_q4g")]
            + [(w, "launches") for w in (w8a8.quantize_rows, w8a8.rms_norm_quantize_rows,
                                         w8a8.silu_mul_quantize_rows, w8a8.w8a8_gemm)])


def _read_counts() -> list:
    return [getattr(w, a) for w, a in launch_counters()]


def _add_counts(deltas: list, sign: int = 1) -> None:
    for (w, a), d in zip(launch_counters(), deltas):
        if d:
            setattr(w, a, getattr(w, a) + sign * d)


class _Captured:
    __slots__ = ("graph", "out", "counts", "keep")

    def __init__(self, graph, out, counts, keep):
        self.graph = graph
        self.out = out          # the graph's output buffers (tokens [steps + 1, width], ...)
        self.counts = counts    # launches one replay makes, per counter
        self.keep = keep        # buffers the graph reads that nothing else holds


class DecodeGraphs:
    """Runs `step(*key) -> outputs` eagerly the first time at a key
    (width, all_greedy, use_ext, want_lps, want_tops, steps) and as a replayed
    CUDA graph after that; on a non-CUDA device, always eagerly."""

    def __init__(self, step: Callable, device: torch.device, generator: torch.Generator):
        self._step = step
        self.device = device
        self._gen = generator
        self._graphs: dict = {}
        self._warm: set = set()
        self._pool = None

    def run(self, *key) -> tuple:
        if self.device.type != "cuda":
            return self._step(*key)
        cap = self._graphs.get(key)
        if cap is None:
            if key not in self._warm:
                # the eager warm-up: real work, and it grows the kernels'
                # scratch to this width (and the sampler's buffers to this
                # key) before anything is captured
                self._warm.add(key)
                return self._step(*key)
            cap = self._graphs[key] = self._capture(*key)
        return self.replay(*key)

    def replay(self, *key) -> tuple:
        """Replay the captured graph of this key; returns its output buffers."""
        cap = self._graphs[key]
        cap.graph.replay()
        _add_counts(cap.counts)
        return cap.out

    def captured(self) -> list:
        return sorted(self._graphs)

    def _capture(self, *key) -> _Captured:
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                f"torch {torch.__version__} cannot register the sampler's generator "
                "with a CUDA graph (CUDAGraph.register_generator_state): the decode "
                "graph needs it")
        register(self._gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        before = _read_counts()
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self._step(*key)
        finally:
            if gc_on:
                gc.enable()
        counts = [b - a for a, b in zip(before, _read_counts())]
        _add_counts(counts, -1)  # capture launches nothing; replays count
        keep = list(_cuda.scratch_bufs.values())
        telemetry.note_compile("cuda_graph", time.perf_counter() - t0, key=list(key))
        return _Captured(graph, out, counts, keep)
