"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`; nothing includes
PyTorch's headers, so a build takes seconds. Libraries land in
`dynamo_tpu_torch/_build/` (listed in .gitignore), named by a hash of their
source and flags, so an edited source is never served by a stale library.
`build()` starts one `nvcc` per source at once and waits for all of them.
Nothing is built or loaded at import time: the CPU tests import every
module of the package on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("kv_write", "prefill_attention", "decode_attention", "probes", "w8a8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build, for chip_smoke.py
build_logs: dict[str, str] = {}


def nvcc() -> str:
    cand = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from dynamo_tpu_torch/csrc at first use"
    )


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> dict[str, str]:
    """Compile every named source whose library is missing, all `nvcc`s in
    parallel; returns {name: library path}. Raises with the compiler's
    output if any build fails."""
    names = list(names or SOURCES)
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    if procs:
        # a build at first use stalls the step that needs it, as a jit
        # compile does: one compile event (engine/telemetry.py)
        from dynamo_tpu_torch.engine import telemetry

        telemetry.note_compile("kernel_build", time.perf_counter() - t0, sources=sorted(procs))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib


# cudaError_t codes after which the CUDA context is unusable (every later
# call fails too): illegal address, device assert, hardware stack error,
# illegal instruction, misaligned address, invalid address space, invalid
# PC, launch failure, cooperative launch too large
STICKY_ERRORS = frozenset({700, 710, 714, 715, 716, 717, 718, 719, 720})
# how torch words the same errors
_STICKY_WORDS = ("illegal memory access", "device-side assert", "hardware stack error",
                 "illegal instruction", "misaligned address", "invalid address space",
                 "invalid program counter", "unspecified launch failure")


class CudaLaunchError(RuntimeError):
    """A launcher returned a non-zero cudaError_t (`code`); `sticky` when
    the context cannot serve any more work after it."""

    def __init__(self, what: str, code: int):
        super().__init__(f"{what}: CUDA launch failed with cudaError {code}")
        self.code = code
        self.sticky = code in STICKY_ERRORS


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise CudaLaunchError(what, err)


def sticky(exc: BaseException) -> bool:
    """Did `exc` leave the CUDA context unusable? A launcher's sticky code,
    or torch's error for one; an exception raised on the host (an injected
    fault, a refused shape, a launch error such as too many resources)
    leaves it usable."""
    if isinstance(exc, CudaLaunchError):
        return exc.sticky
    text = str(exc).lower()
    return "cuda" in text and any(w in text for w in _STICKY_WORDS)


def stream_ptr(device) -> int:
    """The raw pointer of `device`'s current CUDA stream (the capture
    stream while a graph is captured), for a launcher. It is read through
    `torch._C._cuda_getCurrentRawStream`, the call torch's own generated
    kernels make: `torch.cuda.current_stream(device).cuda_stream` builds a
    Stream object each time, several microseconds of the host's time a
    launch (`scripts/trace_w8a8.py` prints both)."""
    import torch

    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


_sm_counts: dict = {}


def sm_count(device) -> int:
    """The device's SM count, read once (the kernels' host-side plans)."""
    n = _sm_counts.get(device)
    if n is None:
        import torch

        n = _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


# the split kernels' partials and tickets, by (wrapper, device): a decode
# graph keeps the buffers it captured alive (engine/decode_graph.py)
scratch_bufs: dict = {}


def scratch(key: str, device, n_part: int, part_dtype, n_tickets: int):
    """A split kernel's partials (`n_part` of `part_dtype`) and int32
    tickets: one pair of buffers for each (key, device), allocated when a
    call first needs more, so a call launches nothing but its kernel.
    Tickets start at 0 and each launch leaves them 0. Launches that share a
    device run on one stream (the engine's), so they never use the buffers
    at once."""
    import torch

    part, tickets = scratch_bufs.get((key, device), (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=part_dtype, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    scratch_bufs[(key, device)] = (part, tickets)
    return part, tickets


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
