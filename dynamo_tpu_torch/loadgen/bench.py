"""Scenario suite runner — the ``scenarios`` section.

The JAX package's `loadgen/bench.py`; ``dynamo_tpu_torch/scripts/
run_scenarios.py`` is its CLI. Configuration rides the reference's
``LOADGEN_*`` env vars, plus the port's device and MoE depth:

    LOADGEN_SCENARIOS   csv of names, "default" (the 8 workload
                        scenarios), or "all" (+ the fleet-proof
                        adapters, which raise: M17) — default "default"
    LOADGEN_SCALE       tiny | real (default tiny: CPU-runnable; real
                        sizes traces/engines for an on-card run)
    LOADGEN_MODEL       model preset for real-scale scenario engines
                        (default llama-3.2-1b)
    LOADGEN_MOE_MODEL   the moe scenario's preset (default tiny-moe)
    LOADGEN_MOE_LAYERS  cut the moe scenario's model to so many layers
    LOADGEN_SEED        trace seed (default 0; same seed = byte-
                        identical trace files)
    LOADGEN_N           requests per scenario trace (scale override)
    LOADGEN_RATE        base offered rate, req/s (scale override)
    LOADGEN_TRACE_DIR   dump each scenario's trace JSONL here
    LOADGEN_DEVICE      the engines' torch device (default: the GPU;
                        "cpu" runs the kernels' plain versions)

Each scenario runs in its own event loop; one failing scenario records
an ``error`` entry instead of killing the suite. Between scenarios the
suite collects the closed engine (its decode graphs hold it in a
reference cycle) and returns its memory to the device, so successive
full-width engines do not pile up on the card.
"""

from __future__ import annotations

import asyncio
import gc
import os
import sys
import time
from typing import Optional

from dynamo_tpu_torch.loadgen.scenarios import (
    SCENARIOS,
    Scale,
    real_scale,
    tiny_scale,
)

# the 8 workload scenarios every run covers; the fleet adapters join
# under "all"
DEFAULT_SET = (
    "chat", "rag", "shared_prefix", "bursty",
    "long_context", "moe", "vision", "structured",
)
FLEET_SET = ("prefix_fleet", "control_chaos", "failover")


def scale_from_env() -> Scale:
    name = os.environ.get("LOADGEN_SCALE", "tiny")
    over: dict = {}
    if os.environ.get("LOADGEN_SEED"):
        over["seed"] = int(os.environ["LOADGEN_SEED"])
    if os.environ.get("LOADGEN_N"):
        over["n"] = int(os.environ["LOADGEN_N"])
    if os.environ.get("LOADGEN_RATE"):
        over["rate_rps"] = float(os.environ["LOADGEN_RATE"])
    if os.environ.get("LOADGEN_TRACE_DIR"):
        over["trace_dir"] = os.environ["LOADGEN_TRACE_DIR"]
    if os.environ.get("LOADGEN_DEVICE"):
        over["device"] = os.environ["LOADGEN_DEVICE"]
    if name == "real":
        return real_scale(**over)
    if name == "tiny":
        return tiny_scale(**over)
    raise ValueError(f"unknown LOADGEN_SCALE {name!r} (want tiny|real)")


def names_from_env() -> list[str]:
    raw = os.environ.get("LOADGEN_SCENARIOS", "default").strip()
    if raw in ("", "default"):
        return list(DEFAULT_SET)
    if raw == "all":
        return list(DEFAULT_SET) + list(FLEET_SET)
    names = [n.strip() for n in raw.split(",") if n.strip()]
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise ValueError(
            f"unknown scenario(s) {unknown}; have {sorted(SCENARIOS)}"
        )
    return names


def _release_device_memory() -> None:
    gc.collect()
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def run_suite(
    names: Optional[list[str]] = None,
    scale: Optional[Scale] = None,
) -> dict:
    """Run the selected scenarios sequentially (each in a fresh event
    loop) and return the ``scenarios`` section dict.

    Every scenario entry carries a ``compile`` census — the delta of the
    process-global compile counters (engine/telemetry.py: decode graph
    captures and kernel builds) across the scenario. The census is the
    variant-explosion tripwire: a change that mints a new graph key per
    shape shows up as a step change here long before it shows up as a
    latency regression."""
    from dynamo_tpu_torch.engine import telemetry

    names = names if names is not None else names_from_env()
    scale = scale or scale_from_env()
    results: dict[str, dict] = {}
    for name in names:
        spec = SCENARIOS[name]
        t0 = time.perf_counter()
        c0 = telemetry.compile_stats()
        print(f"scenario {name} [{spec.workload}] ...", file=sys.stderr)
        try:
            out = asyncio.run(spec.fn(scale))
        except Exception as exc:  # noqa: BLE001 — one broken scenario
            # must not hide the other seven's numbers
            out = {
                "scenario": name,
                "workload": spec.workload,
                "error": f"{type(exc).__name__}: {exc}",
            }
        # the closed engine leaves the card before the next one is built
        _release_device_memory()
        c1 = telemetry.compile_stats()
        out["compile"] = {
            "events": c1["compile_events"] - c0["compile_events"],
            "time_s": round(
                c1["compile_time_s"] - c0["compile_time_s"], 4
            ),
        }
        out["scenario_wall_s"] = round(time.perf_counter() - t0, 2)
        results[name] = out
        if "error" in out:
            line = f"ERROR {out['error']}"
        elif out.get("kind") == "fleet_adapter":
            line = f"fleet proof ok ({len(out.get('fleet') or {})} keys)"
        else:
            line = (
                f"goodput={(out.get('goodput') or {}).get('goodput_toks_per_sec')} tok/s "
                f"ttft_p50={((out.get('ttft') or {}).get('p50_s'))}s"
            )
        print(
            f"scenario {name}: {line} [{out['scenario_wall_s']}s]",
            file=sys.stderr,
        )
    total = telemetry.compile_stats()
    return {
        "scale": scale.to_dict(),
        "results": results,
        # suite-level census: cumulative process counters plus the
        # per-scenario deltas in one place
        "compile_census": {
            "per_scenario": {
                n: (r.get("compile") or {}).get("events")
                for n, r in results.items()
            },
            "total_events": total["compile_events"],
            "total_compile_time_s": total["compile_time_s"],
        },
    }
