"""The probe scripts of the port: one per probe script of the JAX package,
under the same name, each holding its probe kernel's wrapper beside the
kernel's plain PyTorch version and a `main()` that measures on the card
what the JAX script measured on the TPU:

- `proto_page_write` (K8, `page_copy`): the page-scatter write prototype;
- `probe_bitcast` (K9, `unpack_int8_rows`, `pack_int8_rows`,
  `inject_int8_row`; K10's rate for three page types): the packed int8
  pool layout;
- `profile_dma` (K10, `page_gather`): scattered-page streaming rate over
  page sizes and ring depths.

The kernels are in `csrc/probes.cu`. Run on a GPU:

    python -m dynamo_tpu_torch.scripts.<name>

Each `main()` returns 2, and measures nothing, when no CUDA device is
visible. The helpers here are what the three share; `chip_smoke.py` times
every kernel with `time_ms` too.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from dynamo_tpu_torch.ops import _cuda

# ~1 ms of device-side spin (at the H100's ~2 GHz) queued before each timed
# call, so the host has launched the call before the device reaches it
SPIN_CYCLES = 2_000_000


def gpu_or_none(script: str):
    """The first CUDA device, after printing the card's name and power
    limit; None, with a message on stderr, when there is none."""
    if not torch.cuda.is_available():
        print(f"{script}: no CUDA device visible; this probe measures the GPU and "
              "does not run on the CPU", file=sys.stderr)
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"{script}: {smi[0] if smi else torch.cuda.get_device_name(0)}", flush=True)
    return torch.device("cuda", 0)


def time_ms(fn, iters=20, warmup=3, flush=None) -> float:
    """Median CUDA-event time of one call of fn. Each call is queued behind
    a device-side spin, so the events bracket the device's work and not the
    host time a wrapper takes to launch it (a call that syncs with the host,
    as some plain versions do, still includes its host time). `flush`, when
    given, runs before the spin and outside the events (to evict the L2
    cache)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probes_lib() -> ctypes.CDLL:
    """`csrc/probes.cu`, built on first use, with its launchers typed."""
    lib = _cuda.load("probes")
    if lib.page_copy_launch.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name, args in {
            "page_copy_launch": [p] * 5 + [i64] * 3 + [p],
            "unpack_int8_rows_launch": [p, p, i64, i64, p],
            "pack_int8_rows_launch": [p, p, i64, i64, p],
            "inject_int8_row_launch": [p, p, i64, i64, p],
            "page_gather_launch": [p, p, i64, i64, i32, i32, i32, i32, p, p],
            "noop_launch": [p],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def empty_launch(dev) -> None:
    """Launch the empty kernel of `csrc/probes.cu` on dev's current stream:
    timed with `time_ms`, the launch floor under every single-launch time."""
    _cuda.check(probes_lib().noop_launch(_cuda.stream_ptr(dev)), "noop")


def l2_evict(dev, nbytes: int = 128 << 20):
    """A callable that writes `nbytes` (more than the H100's 50 MB L2), so
    a kernel timed after it finds none of its own data in the L2, and the
    L2 full of another buffer's dirty lines, as a kernel finds it behind
    the projections on the engine's path."""
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return lambda: buf.fill_(1)
