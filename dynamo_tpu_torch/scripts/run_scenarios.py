"""One entrypoint for every scenario of the port's loadgen.

    python -m dynamo_tpu_torch.scripts.run_scenarios [--scenarios chat,bursty|all]
        [--out path.json] [--scale tiny|real] [--device cpu]

The JAX package's `scripts/run_scenarios.py` on the port: runs the loadgen
scenario registry (dynamo_tpu_torch/loadgen/scenarios.py), validates every
emitted section against the scenarios contract (SLO-gated goodput +
TTFT/ITL percentiles + throughput present, no errors, a compile census
within budget), prints the JSON, and exits non-zero on a malformed or
failed scenario (the fleet adapters raise: M17). The engines run on the
GPU unless `--device cpu` (or LOADGEN_DEVICE) asks for the CPU, where the
kernels' plain versions run: `--scale tiny --device cpu` is the CPU check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Compile-census flat budget (compile events per scenario: on the port,
# decode graph captures and kernel builds, engine/telemetry.py). Each
# scenario's engine captures one graph per decode key it meets (width,
# sampling path, step count), and the first scenario of a process pays
# the kernel build; a change that mints a new key family per shape
# multiplies them and trips this long before it reads as a latency
# regression.
COMPILE_EVENTS_BUDGET = int(
    os.environ.get("LOADGEN_COMPILE_BUDGET", "150")
)


def check_section(name: str, out: dict) -> list[str]:
    """Contract violations for one scenario section ([] = well-formed)."""
    bad = []
    if "error" in out:
        return [f"{name}: scenario errored: {out['error']}"]
    if out.get("kind") == "fleet_adapter":
        if not isinstance(out.get("fleet"), dict) or not out["fleet"]:
            bad.append(f"{name}: fleet adapter carried no payload")
        return bad
    gp = out.get("goodput") or {}
    if gp.get("goodput_toks_per_sec") is None:
        bad.append(f"{name}: missing goodput_toks_per_sec")
    elif gp["goodput_toks_per_sec"] <= 0:
        bad.append(f"{name}: zero goodput ({gp})")
    if gp.get("attained_frac") is None:
        bad.append(f"{name}: missing SLO attained_frac")
    for metric in ("ttft", "itl"):
        for q in ("p50_s", "p99_s"):
            if (out.get(metric) or {}).get(q) is None:
                bad.append(f"{name}: missing {metric}.{q}")
    if out.get("throughput_toks_per_sec") is None:
        bad.append(f"{name}: missing throughput")
    reqs = out.get("requests") or {}
    if reqs.get("errors"):
        bad.append(f"{name}: {reqs['errors']} request errors")
    if (out.get("trace") or {}).get("sha256") is None:
        bad.append(f"{name}: missing trace identity")
    comp = out.get("compile") or {}
    if comp.get("events") is None:
        bad.append(f"{name}: missing compile census")
    elif comp["events"] > COMPILE_EVENTS_BUDGET:
        bad.append(
            f"{name}: compile census blew the flat budget — "
            f"{comp['events']} compile events in one scenario "
            f"(budget {COMPILE_EVENTS_BUDGET}); a new variant family "
            "is being minted per shape"
        )
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenarios", default=None,
                    help="csv of scenario names, 'default' or 'all' "
                         "(default: LOADGEN_SCENARIOS env or 'default')")
    ap.add_argument("--scale", default=None, choices=["tiny", "real"],
                    help="default: LOADGEN_SCALE env or tiny")
    ap.add_argument("--device", default=None,
                    help="the engines' torch device (default: LOADGEN_DEVICE env or "
                         "the GPU; cpu runs the kernels' plain versions)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    if args.scenarios is not None:
        os.environ["LOADGEN_SCENARIOS"] = args.scenarios
    if args.scale is not None:
        os.environ["LOADGEN_SCALE"] = args.scale
    if args.device is not None:
        os.environ["LOADGEN_DEVICE"] = args.device

    from dynamo_tpu_torch.loadgen import bench as loadgen_bench
    from dynamo_tpu_torch.loadgen.scenarios import SCENARIOS

    if args.list:
        for name, spec in SCENARIOS.items():
            kind = " [fleet]" if spec.fleet else ""
            print(f"{name}{kind}: {spec.description}")
        return 0

    section = loadgen_bench.run_suite()
    print(json.dumps(section, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(section, f, indent=2)
            f.write("\n")

    problems = []
    failing = []
    for name, out in section["results"].items():
        bad = check_section(name, out)
        problems.extend(bad)
        if bad:
            failing.append(name)
    if problems:
        for p in problems:
            print(f"MALFORMED: {p}", file=sys.stderr)
        # forensics: dump every registered flight-recorder ring (the
        # scenario engines register theirs at init and the registry keeps
        # a closed engine's ring) next to the replayable traces
        from dynamo_tpu_torch.engine import flight_recorder

        art_dir = os.environ.get("LOADGEN_TRACE_DIR") or None
        for path in flight_recorder.dump_all(
            "scenario:" + ",".join(sorted(failing)), directory=art_dir
        ):
            print(f"flight-recorder artifact: {path}", file=sys.stderr)
        return 1
    print(
        f"{len(section['results'])} scenario(s) well-formed "
        f"(scale={section['scale']['name']})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
