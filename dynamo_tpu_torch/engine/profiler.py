"""On-device profiling: phase annotations + on-demand capture (the JAX
package's `engine/profiler.py`, on `torch.profiler`).

The trace ring (utils/tracing.py) stops at the dispatch call: a slow
``decode`` rectangle says *that* the device was busy, never *where the
device time went*. This module crosses that boundary two ways:

- **Phase annotations.** Every engine dispatch runs inside a
  `torch.profiler.record_function` named EXACTLY like its `engine.steps`
  span (``prefill`` / ``decode`` / ``spec_verify`` / ``mixed``), nested in
  one carrying the engine step number (``engine.step#step_num=N#``, the
  encoding of the reference's step marker), so a capture and the Perfetto
  ring export join on the same names. The annotations are entered only
  while a capture runs: outside one they are a shared no-op context
  manager, and a dispatch pays one module-global read.
- **On-demand capture.** ``POST /debug/profile?duration_ms=`` on a live
  engine runs a `torch.profiler.profile` (CPU and, on a CUDA machine, CUDA
  activities) for the requested window and writes its Chrome trace as
  ``trace.json`` in a fresh directory under ``DYN_PROFILE_DIR``. A
  **single-capture-in-flight gate** rejects concurrent captures; the busy
  caller gets a typed `ProfilerBusy` (HTTP 409). Kernels launched by a
  replayed CUDA graph are listed by CUPTI as the graph's own.

``DYN_PROFILE=0`` disables capture (`ProfilerUnavailable`, HTTP 501).
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import tempfile
import threading
import time
from typing import Optional

from dynamo_tpu_torch.utils import counters
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.profiler")

# zero-series at import (rendered from the first scrape through
# utils/counters.PromCounters)
counters.declare("profiler_captures_total")
counters.declare("profiler_busy_total")

TRACE_FILE = "trace.json"

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_active_dir: Optional[str] = None
_prof = None
_t_start = 0.0


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (the single-capture gate)."""


class ProfilerUnavailable(RuntimeError):
    """torch.profiler is missing, failed to start, or is disabled
    (``DYN_PROFILE=0``)."""


def _torch_profiler():
    try:
        from torch import profiler as tprof
    except Exception:  # noqa: BLE001 (profiling is optional everywhere)
        return None
    return tprof


def available() -> bool:
    if os.environ.get("DYN_PROFILE", "") == "0":
        return False
    return _torch_profiler() is not None


def annotate(name: str):
    """Context manager naming a dispatch phase in a capture; the name must
    match the phase's ``engine.steps`` span so the two traces join. A no-op
    while no capture runs."""
    if _active_dir is None:
        return _NOOP
    return _torch_profiler().record_function(name)


def step_annotation(step_num: int):
    """Step marker carrying the engine step number; a no-op while no
    capture runs."""
    if _active_dir is None:
        return _NOOP
    return _torch_profiler().record_function(f"engine.step#step_num={step_num}#")


def profile_dir(override: Optional[str] = None) -> str:
    """Capture output dir: explicit override > ``DYN_PROFILE_DIR`` > a
    tmpdir subdirectory."""
    return (
        override
        or os.environ.get("DYN_PROFILE_DIR")
        or os.path.join(tempfile.gettempdir(), "dynamo_tpu_torch_profile")
    )


def active() -> Optional[str]:
    """The in-flight capture's directory, or None."""
    return _active_dir


def start(logdir: Optional[str] = None) -> str:
    """Begin a capture; returns its directory. Raises `ProfilerBusy` when
    one is already in flight and `ProfilerUnavailable` when torch.profiler
    cannot capture here."""
    global _active_dir, _prof, _t_start
    if not available():
        raise ProfilerUnavailable("torch.profiler unavailable or disabled (DYN_PROFILE=0)")
    tprof = _torch_profiler()
    with _lock:
        if _active_dir is not None:
            counters.inc("profiler_busy_total")
            raise ProfilerBusy(f"capture already in flight -> {_active_dir}")
        d = os.path.join(profile_dir(logdir), time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(d, exist_ok=True)
        import torch

        acts = [tprof.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tprof.ProfilerActivity.CUDA)
        kw = {}
        try:
            # record the CPU engine's dispatches too, which run in worker
            # threads (a CUDA engine enqueues on the loop thread)
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except Exception:  # noqa: BLE001 (a torch without the option)
            pass
        try:
            prof = tprof.profile(activities=acts, **kw)
            prof.start()
        except Exception as exc:  # noqa: BLE001 (platform-dependent)
            raise ProfilerUnavailable(f"torch.profiler failed to start: {exc}") from exc
        _prof = prof
        _active_dir = d
        _t_start = time.perf_counter()
        return d


def stop() -> dict:
    """End the in-flight capture and write its Chrome trace; returns
    ``{dir, duration_ms}`` (the trace is ``<dir>/trace.json``)."""
    global _active_dir, _prof
    with _lock:
        if _active_dir is None:
            raise ProfilerUnavailable("no capture in flight")
        d, prof = _active_dir, _prof
        _active_dir, _prof = None, None
        duration_ms = round((time.perf_counter() - _t_start) * 1e3, 1)
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(d, TRACE_FILE))
        except Exception as exc:  # noqa: BLE001
            raise ProfilerUnavailable(f"torch.profiler failed to stop: {exc}") from exc
    counters.inc("profiler_captures_total")
    return {"dir": d, "duration_ms": duration_ms}


async def capture(duration_ms: float, logdir: Optional[str] = None) -> dict:
    """One bounded capture window (the ``POST /debug/profile`` body):
    start, serve traffic for `duration_ms`, stop. The gate in `start`
    makes concurrent calls fail fast instead of corrupting each other."""
    start(logdir)
    try:
        await asyncio.sleep(max(duration_ms, 1.0) / 1000.0)
    finally:
        info = stop()
    return info
