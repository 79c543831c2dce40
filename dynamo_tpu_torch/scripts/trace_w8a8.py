"""The W8A8 decode chain traced on the card, and the W8A8 wrappers' host cost.

    python -m dynamo_tpu_torch.scripts.trace_w8a8 [--layers 8] [--replays 5]

The decode chain is what one 8B decode step asks of the W8A8 kernels in
each layer, at 8 rows: the attention norm and its row quantization, then
wq, wk and wv; a row quantization and wo; the MLP norm and its row
quantization, w_gate and w_up; SiLU x up and its row quantization, and
w_down (wq's output stands in for the attention's, wo's for the residual
stream the MLP norm reads). It runs in two compositions: `composed`, the
norms and SiLU x up as torch ops (ops/norm.py `rms_norm`, `F.silu(gate) *
up`) then `quantize_rows`, as the model ran before the fusion; and
`fused`, `rms_norm_quantize_rows` and `silu_mul_quantize_rows` (a package
without them runs `composed` alone). Each layer has weights of its own
(218 MB a layer, so the L2 holds none of what a GEMM reads), and each
composition is captured as one CUDA graph. With the W8A8 kernels'
programmatic dependent launch on and then off (`ops/w8a8.PDL`; a package
without that switch is traced as it launches), the script times the
graphs by CUDA events, traces replays with torch.profiler, and prints for
each of a layer's 11 W8A8 launches, as medians over layers and replays:
- `dur`: the kernel's span from start to end (under PDL a kernel starts
  early, and its span includes its wait for the kernel before it);
- `gap`: its start less the end of the W8A8 kernel before it (negative:
  the two overlapped; in `composed` it holds the torch ops between them);
- `step`: its end less the end of the W8A8 kernel before it, the time the
  chain moves on by for this launch and what precedes it; a layer's steps
  sum to its time.
Then the host time of one call as the eager prefill pays it: quantize_rows,
the two fused row quantizations, w8a8_gemm, the model's `mm` on a
quantized activation and bf16 `torch.matmul` at the 8B prefill shape 4096
x 4096 -> 1024, and the launchers' read of the current stream, each the
median of three passes of 100 calls queued behind a device-side spin.

The script uses only `dynamo_tpu_torch.ops.w8a8`'s wrappers, `ops.quant`'s
`mm`, `ops.norm`'s `rms_norm` and `ops._cuda.stream_ptr`, so a copy of it
in another checkout of the package traces that checkout's kernels. It
prints the card's name and power limit first and one JSON object last; it
returns 2, and measures nothing, when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.nn.functional as tF

from dynamo_tpu_torch.ops import _cuda, quant, w8a8
from dynamo_tpu_torch.ops.norm import rms_norm
from dynamo_tpu_torch.scripts import gpu_or_none

D, F, KV = 4096, 14336, 1024
EPS = 1e-5  # Llama-3.1's rms_norm_eps
# the 8B projections, [out, in]
SHAPES = {"wq": (D, D), "wk": (KV, D), "wv": (KV, D), "wo": (D, D), "w_gate": (F, D),
          "w_up": (F, D), "w_down": (D, F)}
# a layer's W8A8 launches in the order the chain makes them
ROLES = ("quant_in", "wq", "wk", "wv", "quant_attn", "wo", "quant_mlp", "w_gate", "w_up",
         "quant_down", "w_down")


def rows_x(m, k, gen, dev, dtype=torch.bfloat16):
    """Rows of several magnitudes; row m // 2 all zeros (a padding row:
    scale 1.0, codes 0); row 0 holding amax 127 (scale 1.0) and the .5
    ties 2.5, -3.5, 0.5, -0.5, 126.5, which round half to even."""
    x = torch.randn((m, k), generator=gen, device=dev)
    x *= torch.rand((m, 1), generator=gen, device=dev) * 8 + 0.01
    x[m // 2] = 0.0
    x[0] = torch.randn((k,), generator=gen, device=dev)
    x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 126.5], device=dev)
    return x.to(dtype)


def same_bytes(a, b) -> bool:
    return torch.equal(a.view(torch.int8), b.view(torch.int8))


def ulp_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per element, the representable values of the (bf16 or f32) dtype
    from want to got: 0 equal, 1 a rounding flip."""
    bits = 16 if got.dtype == torch.bfloat16 else 32
    itype = torch.int16 if bits == 16 else torch.int32

    def ordered(t):
        i = t.contiguous().view(itype).long()
        return torch.where(i < 0, -(i & ((1 << (bits - 1)) - 1)), i)

    return (ordered(got) - ordered(want)).abs()


def fused_rows(fused, plain_rows, *args):
    """A fused row quantization run with y: its codes and scales, held to
    quantize_rows_plain of its own rows y, and y's ulp steps from torch's
    rows (`plain_rows(*args)`)."""
    y = torch.empty_like(args[0])
    q, s = fused(*args, y=y)
    pq, ps = w8a8.quantize_rows_plain(y)
    assert same_bytes(q, pq) and same_bytes(s, ps.contiguous()), \
        f"{fused.__name__}: codes differ from quantize_rows_plain of its own rows"
    return q, s, ulp_steps(y, plain_rows(*args))


def _counted(off, fused, plain_rows, *args):
    """fused_rows, adding y's [elements off torch's, elements, largest ulp
    step] to `off`."""
    q, s, steps = fused_rows(fused, plain_rows, *args)
    off[0] += int((steps > 0).sum())
    off[1] += steps.numel()
    off[2] = max(off[2], int(steps.max()))
    return q, s


class Chain:
    """`layers` layers of the decode chain on random codes (weight scales
    that keep each output about its input's size, so the activations
    neither overflow nor vanish over the layers; norm weights in [0.5,
    1.5)), and the outputs each composition must give: `composed` by the
    plain versions, run eagerly; `fused` by an eager run of the fused
    kernels with y, each held to quantize_rows_plain of its own rows, and
    the plain GEMMs. Those rows against torch's are counted in `rows_off`:
    the norm's within one ulp, SiLU x up's equal, or the reference
    raises."""

    def __init__(self, gen, dev, layers):
        self.layers = layers
        self.weights = [
            {name: (torch.randint(-127, 128, nk, generator=gen, device=dev, dtype=torch.int8),
                    (torch.rand((nk[0],), generator=gen, device=dev) + 0.5)
                    * (0.013 / nk[1] ** 0.5))
             for name, nk in SHAPES.items()}
            for _ in range(layers)]
        for w in self.weights:
            for norm in ("attn_norm", "mlp_norm"):
                w[norm] = (torch.rand((D,), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        self.x0 = rows_x(8, D, gen, dev)
        self.captured = []  # each graph's outputs, alive as long as the chain
        self.modes = (("composed", "fused") if hasattr(w8a8, "rms_norm_quantize_rows")
                      else ("composed",))
        self.rows_off = {}
        self.want = {mode: self.step(mode, plain=True) for mode in self.modes}
        assert all(bool(torch.isfinite(o).all()) for o in self.want["composed"]), \
            "the decode chain overflowed"

    def step(self, mode, plain=False):
        """One pass of the chain in `mode`, through the kernels, or (`plain`)
        as the reference for that mode."""
        quantize, gemm = ((w8a8.quantize_rows_plain, w8a8.w8a8_gemm_plain) if plain
                          else (w8a8.quantize_rows, w8a8.w8a8_gemm))

        def silu_mul(g, u):
            return tF.silu(g) * u

        if mode == "composed":
            def norm_q(x, w):
                return quantize(rms_norm(x, w, EPS))

            def silu_q(g, u):
                return quantize(silu_mul(g, u))
        elif plain:
            off = {k: [0, 0, 0] for k in ("rms_norm", "silu_mul")}
            self.rows_off = off

            def norm_q(x, w):
                return _counted(off["rms_norm"], w8a8.rms_norm_quantize_rows, rms_norm, x, w, EPS)

            def silu_q(g, u):
                return _counted(off["silu_mul"], w8a8.silu_mul_quantize_rows, silu_mul, g, u)
        else:
            def norm_q(x, w):
                return w8a8.rms_norm_quantize_rows(x, w, EPS)

            silu_q = w8a8.silu_mul_quantize_rows
        x, outs = self.x0, []
        for w in self.weights:
            q, s = norm_q(x, w["attn_norm"])
            outs += [gemm(q, s, *w[name], torch.bfloat16) for name in ("wq", "wk", "wv")]
            q, s = quantize(outs[-3])
            outs.append(gemm(q, s, *w["wo"], torch.bfloat16))
            q, s = norm_q(outs[-1], w["mlp_norm"])
            outs += [gemm(q, s, *w[name], torch.bfloat16) for name in ("w_gate", "w_up")]
            q, s = silu_q(outs[-2], outs[-1])
            x = gemm(q, s, *w["w_down"], torch.bfloat16)
            outs.append(x)
        if mode == "fused" and plain:
            assert self.rows_off["rms_norm"][2] <= 1, \
                f"the fused norm's rows are off rms_norm's by {self.rows_off['rms_norm'][2]} ulps"
            assert self.rows_off["silu_mul"][0] == 0, \
                f"SiLU x up's rows differ from torch's in {self.rows_off['silu_mul'][0]} elements"
        return outs

    def capture(self, mode="composed") -> torch.cuda.CUDAGraph:
        """The chain in `mode` through the kernels as one CUDA graph,
        captured after one eager run (which grows the split workspace);
        raises unless a replay's every output equals the mode's
        reference."""
        self.step(mode)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = self.step(mode)
        graph.replay()
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(outs, self.want[mode])) if not same_bytes(a, b)]
        assert not bad, f"the {mode} decode chain differs from its reference at outputs {bad}"
        self.captured.append(outs)
        return graph

    def replay_ms(self, graph, replays=10) -> float:
        """Median CUDA-event ms a layer over `replays` replays."""
        times = []
        for _ in range(replays):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / self.layers)
        return statistics.median(times)


def chain_kernels(trace_events, layers):
    """The chain's kernels from a chrome trace's events, one list a replay
    of (role, start us, end us); raises unless each replay holds a whole
    number of layers' launches in order."""
    ks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in trace_events
                if e.get("cat") == "kernel"
                and ("quantize_rows" in e["name"] or "w8a8_gemm" in e["name"]))
    per = len(ROLES) * layers
    assert ks and len(ks) % per == 0, f"{len(ks)} chain kernels traced, not a multiple of {per}"
    replays = []
    for r in range(0, len(ks), per):
        rep = []
        for i, (t0, t1, name) in enumerate(ks[r:r + per]):
            role = ROLES[i % len(ROLES)]
            assert ("quantize_rows" in name) == role.startswith("quant"), \
                f"launch {i} of a replay is {name}, not {role}"
            rep.append((role, t0, t1))
        replays.append(rep)
    return replays


def launch_stats(replays) -> dict:
    """{role: {dur, gap, step}} in us, medians over every launch of that
    role that has a kernel before it in its replay."""
    acc = {role: {"dur": [], "gap": [], "step": []} for role in ROLES}
    for rep in replays:
        prev_end = None
        for role, t0, t1 in rep:
            if prev_end is not None:
                acc[role]["dur"].append(t1 - t0)
                acc[role]["gap"].append(t0 - prev_end)
                acc[role]["step"].append(t1 - prev_end)
            prev_end = t1 if prev_end is None else max(prev_end, t1)
    return {role: {k: statistics.median(v) for k, v in d.items()} for role, d in acc.items()}


def trace_chain(chain, graph, replays, path):
    """Launch stats of `replays` replays of the chain's graph, traced by
    torch.profiler (chrome trace written to `path`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return launch_stats(chain_kernels(events, chain.layers))


def host_us(fn, calls=100) -> float:
    """Mean host microseconds of one call of fn over `calls` calls queued
    behind ~0.1 s of device-side spin, so the loop never waits for the
    device (100 launches stay inside the launch queue)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def host_costs(gen, dev) -> dict:
    """Host us a call of each W8A8 wrapper (the fused ones where the
    package has them), the model's `mm` on a quantized activation, bf16
    `torch.matmul`, and the two ways to read the current stream (the
    launchers' `_cuda.stream_ptr`, and the Stream object's `cuda_stream`),
    each the median of three passes."""
    m, k, n = 4096, D, KV
    x = rows_x(m, k, gen, dev)
    xa = quant.quantize_act(x)
    w = {"q": torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8),
         "s": torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-4}
    wb = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    cases = {
        "quantize_rows": lambda: w8a8.quantize_rows(x),
        "rms_norm_quantize_rows": lambda: w8a8.rms_norm_quantize_rows(x, x[0], EPS),
        "silu_mul_quantize_rows": lambda: w8a8.silu_mul_quantize_rows(x, x),
        "w8a8_gemm": lambda: w8a8.w8a8_gemm(xa.q, xa.s, w["q"], w["s"], torch.bfloat16),
        "mm_quantized": lambda: quant.mm(xa, w),
        "matmul_bf16": lambda: torch.matmul(x, wb),
        "stream_ptr": lambda: _cuda.stream_ptr(dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    if not hasattr(w8a8, "rms_norm_quantize_rows"):
        del cases["rms_norm_quantize_rows"], cases["silu_mul_quantize_rows"]
    return {name: statistics.median(host_us(fn) for _ in range(3)) for name, fn in cases.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--replays", type=int, default=5, help="replays traced in each mode")
    ap.add_argument("--out", default="", help="directory for the chrome traces "
                    "(default: a temporary one, removed)")
    args = ap.parse_args(argv)
    dev = gpu_or_none("trace_w8a8")
    if dev is None:
        return 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    chain = Chain(gen, dev, args.layers)
    has_pdl = hasattr(w8a8, "PDL")
    pdls = (True, False) if has_pdl else (None,)
    result = {"package": os.path.dirname(os.path.dirname(os.path.abspath(w8a8.__file__))),
              "layers": args.layers, "chain": {}}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        graphs = {}
        for mode in chain.modes:
            for pdl in pdls:
                if has_pdl:
                    w8a8.PDL = pdl
                graphs[mode, pdl] = chain.capture(mode)
        if has_pdl:
            w8a8.PDL = True
        # two passes in turns, so a drift of the card's clock touches all
        times = {key: [] for key in graphs}
        for _ in range(2):
            for key, graph in graphs.items():
                times[key].append(chain.replay_ms(graph))
        for (mode, pdl), graph in graphs.items():
            name = {True: "PDL on", False: "PDL off", None: "as it launches"}[pdl]
            tag = f"{mode}_" + {True: "pdl_on", False: "pdl_off", None: "as_launched"}[pdl]
            stats = trace_chain(chain, graph, args.replays,
                                os.path.join(out_dir, f"trace_w8a8_{tag}.json"))
            ms = statistics.median(times[mode, pdl])
            result["chain"][tag] = {"us_a_layer": 1e3 * ms, "launches": stats}
            print(f"[trace_w8a8] decode chain, {mode}, {name}: {1e3 * ms:.1f} us a layer (CUDA "
                  "events); a launch's dur / gap / step in us: "
                  + "; ".join(f"{r} {s['dur']:.1f} / {s['gap']:.1f} / {s['step']:.1f}"
                              for r, s in stats.items())
                  + f"; steps sum to {sum(s['step'] for s in stats.values()):.1f}", flush=True)
    if "fused" in chain.modes:
        result["rows_off"] = chain.rows_off
        print("[trace_w8a8] the fused kernels' rows against torch's (elements off, elements, "
              f"largest ulp step): {chain.rows_off}", flush=True)
    result["host_us"] = host_costs(gen, dev)
    print("[trace_w8a8] host us a call at 4096 x 4096 -> 1024: "
          + ", ".join(f"{k} {v:.1f}" for k, v in result["host_us"].items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
