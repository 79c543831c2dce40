"""The port's trace ring (`dynamo_tpu_torch/utils/tracing.py`), its
request-id log join (`utils/logging.py`), compile telemetry
(`engine/telemetry.py`) and profiler (`engine/profiler.py`), against the
JAX package's where it has a counterpart:

- the same span, instant, complete and track calls give the same export
  (times, durations and the process label left out), with the request,
  track and newest-N filters; the process label's first claim wins;
- disarmed, nothing records and `span` is the shared no-op;
- a JSONL log record emitted inside a request scope carries its id in both
  packages;
- a compile event counts and, armed, lands on the ``engine.compile`` track;
  a CPU device has no memory gauges;
- the profiler's annotations are no-ops outside a capture, a capture on
  the CPU writes a Chrome trace holding them, a second capture is refused
  while one runs, and ``DYN_PROFILE=0`` refuses."""

from __future__ import annotations

import json
import logging
import os
import time

import pytest

from dynamo_tpu.utils import tracing as jtr
from dynamo_tpu_torch.utils import tracing as ptr

PAIR = {"jax": jtr, "torch": ptr}


@pytest.fixture(autouse=True)
def _clean():
    for t in PAIR.values():
        t.clear()
        t.enable()
    yield
    for t in PAIR.values():
        t.disable()
        t.clear()


def _record(t):
    """One scripted sequence of calls on a tracing module: the stamped
    events lie seconds after the ones stamped now, so the order is fixed."""
    t0 = time.perf_counter()
    with t.request_scope("req-a"):
        with t.span("preprocess", cat="preprocess", kind="chat") as sp:
            if sp is not None:  # None while disarmed
                sp.set(prompt_tokens=12)
        t.instant("seq.submit", cat="lifecycle", ts=t0 + 1.0, seq_id=3)
    t.complete("prefill", t0 + 10.0, t0 + 10.01, cat="step", track="engine.steps", rows=2)
    t.complete("decode", t0 + 30.0, t0 + 30.02, cat="step", track="engine.steps", steps=8)
    t.instant("prefix.hit", cat="kv", req="req-b", track="engine.prefix", full=True)
    t.instant("seq.first_token", cat="lifecycle", req="req-b", ts=t0 + 60.0)
    try:
        with t.span("http.request", cat="http", req="req-c"):
            raise KeyError("x")
    except KeyError:
        pass


def _strip(trace):
    """Events without their clock-dependent fields and the process label,
    each row's numeric tid (a process-wide counter) replaced by its name."""
    names = {(e["pid"], e["tid"]): e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "thread_name"}
    out = []
    for e in trace["traceEvents"]:
        if e["name"] == "process_name":
            continue
        row = names.get((e["pid"], e["tid"]), "?")
        out.append({**{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")},
                    "row": row})
    return out, {k: v for k, v in trace.items() if k != "traceEvents"}


def test_export_equal():
    got = {}
    for impl, t in PAIR.items():
        _record(t)
        got[impl] = [_strip(t.export()), _strip(t.export(request_id="req-b")),
                     _strip(t.export(track="engine.steps")), _strip(t.export(max_events=3))]
    assert got["torch"] == got["jax"]
    events = got["torch"][0][0]
    names = [e["name"] for e in events if e["ph"] != "M"]
    assert names[0] == "preprocess" and "http.request" in names
    assert [e for e in events if e["name"] == "http.request"][0]["args"]["error"] == "KeyError"
    assert got["torch"][3][1] == {"displayTimeUnit": "ms", "truncatedEvents": 4}


def test_timestamps_sorted_and_durations_kept():
    _record(ptr)
    evs = [e for e in ptr.export()["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
    durs = {e["name"]: e["dur"] for e in evs if e["ph"] == "X"}
    assert durs["prefill"] == pytest.approx(1e4, abs=0.2)
    assert durs["decode"] == pytest.approx(2e4, abs=0.2)


def test_process_label_first_wins(monkeypatch):
    """The frontend's or an engine's claim on the process label, an
    explicit label before it winning, as in the JAX package."""
    got = {}
    for impl, t in PAIR.items():
        monkeypatch.setattr(t, "_process", None)
        t.set_process_default("frontend")
        t.set_process_default("worker-x")  # the first claim stays
        first = t.process_label()
        t.set_process("explicit")
        t.set_process_default("worker-y")
        meta = [e for e in t.export()["traceEvents"] if e["name"] == "process_name"]
        got[impl] = (first, t.process_label(), meta)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == ("frontend", "explicit")


def test_disarmed_records_nothing(tmp_path):
    for t in PAIR.values():
        t.disable()
        assert t.span("x") is t._NOOP_CM
        _record(t)
        assert [e for e in t.export()["traceEvents"] if e["ph"] != "M"] == []
    ptr.enable()
    _record(ptr)
    path = str(tmp_path / "trace.json")
    assert ptr.dump(path) == 7
    assert len(json.load(open(path))["traceEvents"]) > 7


def test_log_record_joins_the_request_id():
    """The port's JSONL formatter stamps the bound request id as the JAX
    package's does; outside a request there is none."""
    from dynamo_tpu.utils.logging import JsonlFormatter as JaxJsonl
    from dynamo_tpu_torch.utils.logging import JsonlFormatter

    rec = logging.LogRecord("dynamo_tpu_torch.engine", logging.INFO, __file__, 1,
                            "hello %s", ("there",), None)
    got = {}
    for impl, (fmt, t) in {"jax": (JaxJsonl(), jtr), "torch": (JsonlFormatter(), ptr)}.items():
        outside = json.loads(fmt.format(rec))
        with t.request_scope("rid-7"):
            inside = json.loads(fmt.format(rec))
        got[impl] = (outside.get("request_id"), inside.get("request_id"), inside["message"])
    assert got["torch"] == got["jax"] == (None, "rid-7", "hello there")


def test_compile_events_and_memory_gauges(monkeypatch):
    import torch

    from dynamo_tpu_torch.engine import telemetry

    monkeypatch.setattr(telemetry, "_compile_events", 0)
    monkeypatch.setattr(telemetry, "_compile_time_s", 0.0)
    telemetry.note_compile("cuda_graph", 0.25, key=[8, True, False, False, False, 8])
    telemetry.note_compile("kernel_build", 1.5, sources=["kv_write"])
    assert telemetry.compile_stats() == {"compile_events": 2, "compile_time_s": 1.75}
    evs = ptr.export(track="engine.compile")["traceEvents"]
    got = [(e["name"], e["args"]["kind"], e["dur"]) for e in evs if e["ph"] == "X"]
    # sorted by start: the build began 1.5 s before its end
    assert got == [("engine.compile", "kernel_build", 1500000.0),
                   ("engine.compile", "cuda_graph", 250000.0)]
    assert telemetry.device_memory_stats(torch.device("cpu")) == {}


def test_profiler_capture_on_cpu(monkeypatch, tmp_path):
    import asyncio

    import torch

    from dynamo_tpu_torch.engine import profiler

    monkeypatch.setenv("DYN_PROFILE_DIR", str(tmp_path))
    assert profiler.annotate("decode") is profiler._NOOP
    assert profiler.step_annotation(3) is profiler._NOOP

    async def capture():
        task = asyncio.ensure_future(profiler.capture(50.0))
        await asyncio.sleep(0.01)
        with pytest.raises(profiler.ProfilerBusy):
            profiler.start()
        with profiler.step_annotation(3), profiler.annotate("decode"):
            torch.ones(4) + 1
        return await task

    info = asyncio.run(capture())
    assert set(info) == {"dir", "duration_ms"} and info["duration_ms"] >= 50.0
    names = {e.get("name") for e in json.load(
        open(os.path.join(info["dir"], profiler.TRACE_FILE)))["traceEvents"]}
    assert {"decode", "engine.step#step_num=3#"} <= names
    assert profiler.active() is None
    monkeypatch.setenv("DYN_PROFILE", "0")
    assert not profiler.available()
    with pytest.raises(profiler.ProfilerUnavailable):
        profiler.start()
