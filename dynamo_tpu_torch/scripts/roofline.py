"""Roofline ledger: flight-recorder digests against the card's peaks.

The JAX package's `scripts/roofline.py` on the port. It joins the
engine's flight-recorder digests (engine/flight_recorder.py: per-step
kind/rows/tokens/wall sampled at the engine's `_phase_stats` sites) with
the model's FLOP and byte counts into one achieved-vs-peak table per
dispatch kind (prefill/decode/mixed/spec_verify): steps, tokens, wall,
modeled dense-projection FLOP/s against the bf16 peak, modeled weight and
KV-write HBM traffic against the memory rate. The FLOPs and bytes are
MODELED from the model config (2 FLOPs per matmul param per token;
weights streamed once per dispatch; KV write bytes per token); attention
scores and decode KV reads are excluded — the ledger says what a phase
*at least* did, not a profiler truth. The arithmetic is the reference's.

Where the port differs:

- **The wall.** A CUDA engine's dispatch returns once its kernels are
  queued, so a digest's host wall is the enqueue. Such an engine also
  times each dispatch's device span with CUDA events (`{kind}_device_s`
  and `{kind}_device_n` in its `phase_stats`); the ledger then reads the
  mean device span a dispatch of that kind times the digests' steps. On
  the CPU, where the host wall is the work, it reads the digests' walls,
  as the reference does.
- **The peaks** are the H100's (NVIDIA data sheets, dense): SXM 989 bf16
  TFLOP/s and 3.35 TB/s by default, or the PCIe or NVL part's when the
  card's name says so (`card_peaks`, the port's copy of chip_smoke.py's).
  One card has no interconnect: its ICI peak reads 0 and so do the
  collective columns; collectives wait for the parallel plane (M13).

Input modes:

    python -m dynamo_tpu_torch.scripts.roofline [--device cpu] [--model P]
        self-contained demo: one engine serves a few greedy streams, then
        the ledger runs on its own digests (on the GPU by default, with
        llama-3.2-1b: the CUDA kernels do not take tiny's head_dim 16;
        tiny in f32 on the CPU). The kernels are built before the engine;
        its first decode dispatches still hold the graph captures, so the
        demo's rates are illustrative, as the reference's are
    python -m dynamo_tpu_torch.scripts.roofline --artifact X.json --model P
        a flight-recorder artifact (watchdog/SLO dump or GET
        /debug/snapshot); digests and context.phase_stats come from the
        file, --model names the preset
    ... --json   the machine-readable ledger on stdout (either mode)

The reference's tensor-parallel demo (tp=8 with measured collective
bytes) waits for M13.
"""

from __future__ import annotations

import argparse
import json
import sys

DISPATCH_KINDS = ("prefill", "decode", "mixed", "spec_verify")

# published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s
H100_PEAKS = {"SXM": (3.35e12, 989e12), "PCIe": (2.0e12, 756e12), "NVL": (3.9e12, 835e12)}
PEAK_HBM, PEAK_FLOPS = H100_PEAKS["SXM"]
PEAK_ICI = 0.0  # one card: no interconnect in the ledger (M13)

NOTE = (
    "FLOPs/HBM are modeled floors (dense projections; weights "
    "once per dispatch; KV writes) — attention scores and "
    "decode KV reads excluded; collective bytes are measured"
)


def card_peaks(name: str) -> tuple[str, tuple[float, float]]:
    """(part, (memory bytes/s, bf16 FLOP/s)) of an H100 by its name."""
    for key in ("NVL", "PCIe"):
        if key in name:
            return key, H100_PEAKS[key]
    return "SXM", H100_PEAKS["SXM"]


def matmul_params(cfg) -> tuple[int, int]:
    """(per-layer-stack matmul params, vocab-head params) of the dense
    architecture — the 2-FLOPs-per-param-per-token roofline numerator."""
    per_layer = (
        cfg.hidden_size * cfg.q_size          # wq
        + 2 * cfg.hidden_size * cfg.kv_size   # wk, wv
        + cfg.q_size * cfg.hidden_size        # wo
        + 3 * cfg.hidden_size * cfg.intermediate_size  # gate/up/down
    )
    return cfg.num_layers * per_layer, cfg.hidden_size * cfg.vocab_size


def kv_write_bytes_per_token(
    cfg, itemsize: int = 2, kv_quant: str | None = None,
    kv_quant_group: int | None = None,
) -> int:
    """Per-token KV-write HBM bytes for the pool tier actually served.

    The quantized tiers write int8 bytes (one per element) or int4
    nibbles (half) plus the f32 scale channels (one per kv head for
    int8; head_dim/kv_quant_group per head for int4 — ops/quant.py), so
    a quantized dispatch must NOT be read against the bf16 byte floor:
    at 8B dims the int8 tier's floor is ~0.53x bf16's and int4's ~0.28x
    — accounting them at bf16 bytes would overstate achieved HBM by 2-4x
    on exactly the legs the packed-KV kernels serve."""
    k_and_v = 2 * cfg.kv_size * cfg.num_layers
    if kv_quant == "int8":
        scale_ch = cfg.num_kv_heads
        return k_and_v + 2 * scale_ch * 4 * cfg.num_layers
    if kv_quant == "int4":
        groups = cfg.head_dim // (kv_quant_group or cfg.head_dim)
        scale_ch = cfg.num_kv_heads * groups
        return k_and_v // 2 + 2 * scale_ch * 4 * cfg.num_layers
    if kv_quant is not None:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r}; expected 'int8' or 'int4'"
        )
    return k_and_v * itemsize


def _pct(x: float, peak: float) -> float:
    return round(100 * x / peak, 4) if peak else 0.0


def build_ledger(
    digests: list,
    fields: list,
    kinds: list,
    phase_stats: dict,
    cfg,
    itemsize: int = 2,
    peak_flops: float = PEAK_FLOPS,
    peak_hbm: float = PEAK_HBM,
    peak_ici: float = PEAK_ICI,
    kv_quant: str | None = None,
    kv_quant_group: int | None = None,
) -> dict:
    """The join: digest rows keyed by kind x the per-kind counters,
    normalized into achieved-vs-peak rates."""
    col = {f: i for i, f in enumerate(fields)}
    kind_name = {i: k for i, k in enumerate(kinds)}
    stack_params, _head_params = matmul_params(cfg)
    flops_per_tok = 2 * stack_params
    weight_bytes = stack_params * itemsize
    kv_write_per_tok = kv_write_bytes_per_token(
        cfg, itemsize, kv_quant, kv_quant_group
    )

    ledger = {}
    device_walls = False
    for kind in DISPATCH_KINDS:
        rows = [
            d for d in digests
            if kind_name.get(int(d[col["kind"]])) == kind
        ]
        if not rows:
            continue
        steps = len(rows)
        tokens = int(sum(d[col["tokens"]] for d in rows))
        wall = float(sum(d[col["wall_s"]] for d in rows))
        timed = int(phase_stats.get(f"{kind}_device_n", 0))
        if timed:
            # asynchronous dispatches: the mean device span a dispatch
            # over the steps the digests hold (the ring may have wrapped)
            wall = float(phase_stats[f"{kind}_device_s"]) / timed * steps
            device_walls = True
        flops = tokens * flops_per_tok
        # HBM floor: weights streamed once per dispatch + KV writes
        hbm = steps * weight_bytes + tokens * kv_write_per_tok
        coll = int(phase_stats.get(f"{kind}_collective_bytes", 0))
        entry = {
            "steps": steps,
            "tokens": tokens,
            "wall_s": round(wall, 6),
            "model_flops": flops,
            "model_hbm_bytes": hbm,
            "collective_bytes": coll,
        }
        if wall > 0:
            entry.update({
                "achieved_tflops": round(flops / wall / 1e12, 6),
                "pct_peak_flops": _pct(flops / wall, peak_flops),
                "achieved_hbm_gbps": round(hbm / wall / 1e9, 6),
                "pct_peak_hbm": _pct(hbm / wall, peak_hbm),
                "collective_gbps": round(coll / wall / 1e9, 6),
                "pct_peak_ici": _pct(coll / wall, peak_ici),
                # bytes per FLOP the phase actually ran at — compare
                # against peak_flops/peak_hbm to see which roof binds
                "arithmetic_intensity": round(flops / max(hbm, 1), 3),
            })
        ledger[kind] = entry

    total_coll = sum(
        int(v) for k, v in phase_stats.items()
        if k.endswith("_collective_bytes")
    )
    note = NOTE
    if device_walls:
        note += ("; walls are the dispatches' device spans (CUDA events), "
                 "not their host enqueue")
    if not peak_ici:
        note += "; one card: no interconnect, collectives wait for M13"
    return {
        "model": cfg.name,
        "itemsize": itemsize,
        "kv_quant": kv_quant,
        "kv_write_bytes_per_token": kv_write_per_tok,
        "flops_per_token": flops_per_tok,
        "weight_stream_bytes": weight_bytes,
        "peaks": {"flops": peak_flops, "hbm": peak_hbm, "ici": peak_ici},
        "kinds": ledger,
        "collective": {
            "total_bytes": total_coll,
            "wall_s_est": round(
                float(phase_stats.get("collective_wall_s", 0.0)), 6
            ),
        },
        "note": note,
    }


def engine_ledger(engine, **peaks) -> dict:
    """The ledger of a live (or just quiesced) TorchEngine's own digests,
    at its dtype and KV tier."""
    from dynamo_tpu_torch.engine.flight_recorder import FIELDS, KINDS

    conf = engine.config
    return build_ledger(
        engine.flight.snapshot_rows(), list(FIELDS), list(KINDS), engine.phase_stats,
        engine.model_cfg, itemsize=2 if conf.dtype == "bfloat16" else 4,
        kv_quant=conf.kv_quantization,
        kv_quant_group=conf.kv_quant_group if conf.kv_quantization == "int4" else None,
        **peaks,
    )


def _demo(device: str | None, model: str) -> tuple:
    """Self-contained source: one engine serves a few greedy streams; its
    own digests feed the ledger (the same join a production artifact
    gets). Returns (digests, fields, kinds, phase_stats, cfg, itemsize)."""
    import asyncio

    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.engine.flight_recorder import FIELDS, KINDS
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    dtype = "float32" if device == "cpu" else "bfloat16"
    if device != "cpu":
        from dynamo_tpu_torch.ops import _cuda

        _cuda.build()  # nvcc outside the first dispatch's device span

    async def serve():
        engine = TorchEngine(EngineConfig(
            model=model, dtype=dtype, page_size=16, num_pages=96, max_batch_size=4,
            max_model_len=128, prefill_chunk=32, seed=0,
        ), device=device)

        async def one(prompt):
            pre = PreprocessedRequest(
                token_ids=list(prompt),
                stop_conditions=StopConditions(max_tokens=12),
                sampling_options=SamplingOptions(greedy=True),
            )
            return [f async for f in await engine.generate(Context(pre.to_dict()))]

        await asyncio.gather(*(one(p) for p in (
            [5, 17, 42, 9, 88, 3], [11, 3, 7, 29, 31],
        )))
        out = (engine.flight.snapshot_rows(), engine.phase_stats, engine.model_cfg)
        await engine.close()
        return out

    digests, stats, cfg = asyncio.run(serve())
    return digests, list(FIELDS), list(KINDS), stats, cfg, 2 if dtype == "bfloat16" else 4


def _render(ledger: dict) -> str:
    lines = [
        "roofline ledger — model=%s (modeled floors vs per-card peaks)" % ledger["model"],
        "%-12s %6s %8s %10s %10s %8s %10s %8s" % (
            "kind", "steps", "tokens", "wall_s", "TFLOP/s", "%peak", "HBM GB/s", "%peak",
        ),
    ]
    for kind, e in ledger["kinds"].items():
        lines.append(
            "%-12s %6d %8d %10.4f %10.4f %8.3f %10.4f %8.3f" % (
                kind, e["steps"], e["tokens"], e["wall_s"],
                e.get("achieved_tflops", 0.0), e.get("pct_peak_flops", 0.0),
                e.get("achieved_hbm_gbps", 0.0), e.get("pct_peak_hbm", 0.0),
            )
        )
    lines.append(ledger["note"])
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--artifact",
        help="flight-recorder artifact JSON (digests + context.phase_stats); "
             "default: run the self-contained demo engine",
    )
    ap.add_argument(
        "--model", default=None,
        help="model preset the artifact's engine served (default tiny), or the "
             "demo's (default llama-3.2-1b on the GPU, tiny on the CPU)",
    )
    ap.add_argument("--device", default=None,
                    help="the demo engine's torch device (default: the GPU; cpu runs "
                         "the kernels' plain versions in float32)")
    ap.add_argument(
        "--itemsize", type=int, default=None,
        help="weight/KV element bytes (default 2 = bf16; the CPU demo 4)",
    )
    ap.add_argument(
        "--kv-quant", choices=("int8", "int4"), default=None,
        help="KV pool tier the engine served: int8/int4 write quantized "
             "bytes + f32 scale tiles, not --itemsize bytes",
    )
    ap.add_argument(
        "--kv-quant-group", type=int, default=None,
        help="int4 scale-group width in features (default head_dim: one "
             "scale group per kv head)",
    )
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="default: the card's bf16 peak by its name (H100 SXM 989e12 "
                         "without a card)")
    ap.add_argument("--peak-hbm", type=float, default=None,
                    help="default: the card's memory rate by its name (3.35e12)")
    ap.add_argument("--peak-ici", type=float, default=PEAK_ICI)
    ap.add_argument(
        "--json", action="store_true",
        help="machine-readable ledger on stdout instead of the table",
    )
    args = ap.parse_args(argv)

    import torch

    part, (hbm, flops) = (card_peaks(torch.cuda.get_device_name(0))
                          if torch.cuda.is_available() else ("SXM", H100_PEAKS["SXM"]))
    if args.artifact:
        with open(args.artifact) as f:
            art = json.load(f)
        from dynamo_tpu_torch.models.config import get_config

        digests = art["digests"]
        fields = art["digest_fields"]
        kinds = art["digest_kinds"]
        stats = (art.get("context") or {}).get("phase_stats") or {}
        cfg = get_config(args.model or "tiny")
        itemsize = 2
    else:
        model = args.model or ("tiny" if args.device == "cpu" else "llama-3.2-1b")
        digests, fields, kinds, stats, cfg, itemsize = _demo(args.device, model)

    ledger = build_ledger(
        digests, fields, kinds, stats, cfg,
        itemsize=args.itemsize or itemsize,
        peak_flops=args.peak_flops or flops, peak_hbm=args.peak_hbm or hbm,
        peak_ici=args.peak_ici, kv_quant=args.kv_quant,
        kv_quant_group=args.kv_quant_group,
    )
    if args.json:
        print(json.dumps(ledger, indent=2))
    else:
        print(f"peaks: H100 {part}")
        print(_render(ledger))
    return 0


if __name__ == "__main__":
    sys.exit(main())
