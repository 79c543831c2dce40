"""The port's flight recorder (`dynamo_tpu_torch/engine/flight_recorder.py`)
and the SLO tracker's breach hook (`llm/http/metrics.py`) against the JAX
package's, fed the same inputs on an injected clock:

- one seeded digest sequence (a steady regime, then a spike, then a
  sustained shift) gives the same outliers, baselines, anomaly counts,
  sustained-anomaly triggers, rate-limited dumps and suppressions, and
  artifacts with the same keys and digest rows;
- deadline-shed bursts trigger alike;
- the digest rows round-trip through `digest_to_dict`; a sealed recorder
  keeps its last context; `dump_all` dumps every registered recorder;
- an SLO breach calls `on_breach` with the request id, and wired to the
  recorder dumps one artifact naming it;
- the Prometheus families render alike, zero-series first."""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from dynamo_tpu.engine import flight_recorder as jfr
from dynamo_tpu.llm.http import metrics as jmetrics
from dynamo_tpu.utils import tracing as jtr
from dynamo_tpu_torch.engine import flight_recorder as pfr
from dynamo_tpu_torch.llm.http import metrics as pmetrics
from dynamo_tpu_torch.utils import tracing as ptr

IMPLS = {"jax": (jfr, jmetrics, jtr), "torch": (pfr, pmetrics, ptr)}


def _walls(seed: int) -> list:
    """(kind, wall) a step: a steady regime, one spike, then a regime shift
    that sustains."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(80):
        kind = ("decode", "prefill", "decode", "mixed")[i % 4]
        out.append((kind, float(0.004 + 0.0005 * rng.rand())))
    out.append(("decode", 0.2))
    out += [("decode", float(0.004 + 0.0005 * rng.rand())) for _ in range(5)]
    out += [("decode", 0.5 + 0.01 * i) for i in range(6)]
    out += [("sync", 0.001), ("overlap", 0.002)]
    return out


def _drive(fr, tmp, seed):
    t = [0.0]
    rec = fr.FlightRecorder(capacity=64, cooldown_s=10.0, sustain=3, shed_burst=4,
                            context_fn=lambda: {"engine": "stub"}, directory=str(tmp),
                            clock=lambda: t[0])
    out = []
    for i, (kind, wall) in enumerate(_walls(seed)):
        t[0] += 0.5
        out.append(rec.record(kind, wall, rows=8, tokens=64, budget_fill=0.5,
                              queue_depth=i % 3, slots_active=8, kv_frac=0.25,
                              degrade_mask=i % 2, step=i))
    t[0] += 20.0
    rec.note_shed(2)
    rec.note_shed(3)  # a burst of 5 >= 4 in the window: a dump
    paths = [rec.trigger("manual", request_id="req-1")]  # inside the cooldown
    paths.append(rec.trigger("manual", force=True))
    arts = sorted(glob.glob(os.path.join(str(tmp), "flight_recorder_*.json")))
    docs = [json.load(open(p)) for p in arts]
    baselines = {p: (b.n, round(b.p50, 9), round(b.p99, 9)) for p, b in rec._baselines.items()}
    return {
        "outliers": out, "baselines": baselines,
        "totals": (rec.anomalies_total, rec.dumps_total, rec.suppressed_total, rec.count),
        "suppressed_paths": [p is None for p in paths],
        "reasons": sorted(d["reason"] for d in docs),
        "keys": sorted(sorted(d) for d in docs),
        "rows": [[r[1:] for r in d["digests"]] for d in docs],  # less the wall-clock stamp
        "prom": list(rec.render_prom()),
    }


def test_digests_anomalies_and_triggers_equal(tmp_path):
    got = {impl: _drive(fr, tmp_path / impl, 3) for impl, (fr, _, _) in IMPLS.items()}
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert sum(g["outliers"]) >= 4
    assert "anomaly:decode" in g["reasons"] and "deadline_shed_burst:5" in g["reasons"]
    assert g["suppressed_paths"] == [True, False]
    assert g["keys"][0] == sorted(["kind", "reason", "trigger", "request_id", "ts",
                                   "digest_fields", "digest_kinds", "digests",
                                   "anomaly_baselines", "context", "trace"])


def test_digest_rows_round_trip_and_seal(tmp_path):
    got = {}
    for impl, (fr, _, _) in IMPLS.items():
        ctx = {"n": 0}
        rec = fr.FlightRecorder(capacity=8, context_fn=lambda: dict(ctx),
                                directory=str(tmp_path / impl))
        for i in range(11):
            rec.record("prefill" if i % 2 else "sync", 0.01 * i, rows=i, step=i)
        rows = rec.snapshot_rows()
        dicts = [{k: v for k, v in d.items() if k != "ts_unix"} for d in rec.snapshot(last=3)]
        ctx["n"] = 5
        rec.seal_context()
        ctx["n"] = 9  # no longer read
        art = rec.build_artifact("manual")
        got[impl] = ([r[1:] for r in rows], dicts, art["context"], rec.count)
        assert rec in fr.registered()
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == {"n": 5} and got["torch"][3] == 8
    assert [d["step"] for d in got["torch"][1]] == [8, 9, 10]


def test_dump_all_and_trace_slice(tmp_path):
    got = {}
    for impl, (fr, _, tr) in IMPLS.items():
        tr.clear()
        tr.enable()
        try:
            rec = fr.FlightRecorder(directory=str(tmp_path / impl))
            tr.instant("seq.submit", cat="lifecycle", req="rid-3")
            tr.instant("seq.submit", cat="lifecycle", req="rid-4")
            path = rec.trigger("watchdog:decode.dispatch", request_id="rid-3", force=True)
            doc = json.load(open(path))
            paths = fr.dump_all("scenario:x", directory=str(tmp_path / impl / "all"))
        finally:
            tr.disable()
            tr.clear()
        evs = [e for e in doc["trace"]["traceEvents"] if e["ph"] != "M"]
        got[impl] = (doc["trigger"], [e["args"]["request_id"] for e in evs], len(paths) >= 1,
                     rec.dumps.render() is not None)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == ("watchdog", ["rid-3"])


def test_slo_breach_dumps_one_artifact(tmp_path):
    got = {}
    for impl, (fr, met, _) in IMPLS.items():
        rec = fr.FlightRecorder(directory=str(tmp_path / impl))
        slo = met.SloTracker({"gold": {"ttft_s": 0.5}, "default": {"ttft_s": 10.0}})
        calls = []

        def hook(*a, rec=rec, calls=calls):
            calls.append(a)
            rec.on_slo_breach(*a)

        slo.on_breach = hook
        for i, (tenant, ttft) in enumerate([("gold", 0.2), ("gold", 0.9), ("x", 3.0),
                                            ("gold", 1.2)]):
            slo.observe({"request_id": f"r{i}", "tenant": tenant, "ttft_s": ttft})
        arts = glob.glob(str(tmp_path / impl / "flight_recorder_*.json"))
        doc = json.load(open(arts[0]))
        got[impl] = (calls, len(arts), doc["reason"], doc["request_id"],
                     rec.suppressed_total, slo.snapshot())
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == ([("gold", "ttft", 0.9, 0.5, "r1"), ("gold", "ttft", 1.2, 0.5, "r3")],
                                1, "slo_breach:gold/ttft", "r1")


def test_prom_zero_series_equal():
    got = {impl: list(fr.FlightRecorder().render_prom()) for impl, (fr, _, _) in IMPLS.items()}
    assert got["torch"] == got["jax"]
    text = "\n".join(got["torch"])
    for trig in pfr.TRIGGERS:
        assert f'trigger="{trig}"' in text
    for ph in pfr.ANOMALY_PHASES:
        assert f'phase="{ph}"' in text


def test_baseline_threshold_rule_equal():
    """A wall exactly at the threshold is not an outlier; one above is."""
    got = {}
    for impl, (fr, _, _) in IMPLS.items():
        out = []
        for factor in (1.0, 1.01):
            b = fr.PhaseBaseline(warmup=4)
            for _ in range(4):
                b.observe(0.01)
            out.append((b.threshold(), b.observe(b.threshold() * factor)))
        got[impl] = out
    assert got["torch"] == got["jax"]
    assert [o for _, o in got["torch"]] == [False, True]
