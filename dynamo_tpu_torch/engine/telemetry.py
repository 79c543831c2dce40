"""Engine-side device telemetry: device memory and compile events (the
JAX package's `engine/telemetry.py`, on torch).

- **`device_memory_stats(device)`** reads the caching allocator's
  statistics into flat gauges (``hbm_bytes_in_use`` / ``hbm_bytes_limit``
  / ``hbm_utilization`` / ``hbm_peak_bytes_in_use``). A CPU device has no
  such statistics: the dict is empty there and `metrics()` omits the
  series, as the reference's does on a backend without memory stats.
- **Compile events.** The port compiles no XLA program; what stalls a
  step the way a jit cache miss does is (a) the capture of a decode CUDA
  graph (engine/decode_graph.py, one for each key met, after an eager
  run) and (b) the build of the kernels' libraries by `nvcc` at first use
  (ops/_cuda.py `build`). Each is counted here (`note_compile`) with its
  host wall, and, while tracing is armed, recorded as an
  ``engine.compile`` complete event on its own track, so the gap in a step
  timeline carries a name. Counts are process-wide, as compilation is (one
  build directory, however many engines).
"""

from __future__ import annotations

import threading
import time

from dynamo_tpu_torch.utils import tracing

_lock = threading.Lock()
_compile_events = 0
_compile_time_s = 0.0


def note_compile(kind: str, duration_s: float, **args) -> None:
    """Count one compile event (`kind` "cuda_graph" or "kernel_build")
    that ended now and took `duration_s` of the host's wall."""
    global _compile_events, _compile_time_s
    with _lock:
        _compile_events += 1
        _compile_time_s += duration_s
    if tracing.enabled():
        t1 = time.perf_counter()
        tracing.complete(
            "engine.compile", t1 - duration_s, t1, cat="compile",
            track="engine.compile", kind=kind, duration_s=round(duration_s, 4), **args,
        )


def compile_stats() -> dict:
    """Cumulative compile gauges for `TorchEngine.metrics()`."""
    with _lock:
        return {
            "compile_events": _compile_events,
            "compile_time_s": round(_compile_time_s, 4),
        }


def device_memory_stats(device) -> dict:
    """Flat device-memory gauges of a CUDA device (allocated bytes, the
    card's total, their ratio and the peak since the last reset); empty on
    any other device or when the read fails (a scrape must never 500 on
    telemetry)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {}
    try:
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
    except Exception:  # noqa: BLE001
        return {}
    in_use = stats.get("allocated_bytes.all.current", 0)
    return {
        "hbm_bytes_in_use": int(in_use),
        "hbm_bytes_limit": int(limit),
        "hbm_utilization": round(in_use / limit, 4),
        "hbm_peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
    }
