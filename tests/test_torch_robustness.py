"""M12's planes in TorchEngine against JaxEngine (gather attention, step
pipeline and mixed steps on) on the vendored trained checkpoint, in
float32 on the CPU, under the same `DYN_FAULTS` specs:

- `metrics()` serves JaxEngine's keys less exactly the two tp executor
  keys (`TorchEngine.UNPORTED_METRICS`);
- a request's lifecycle instants, request span and step spans carry the
  same names in both traces;
- a failed mixed step (``engine.mixed.fail@1x1``) is contained in both:
  every stream equals the no-fault run's, the `mixed` rung trips for good,
  and the ladder, watchdog and fault counters are equal;
- a prefill stalled past the watchdog's budget (``engine.prefill.delay``,
  several budgets long) fires the watchdog once in each, trips
  `step_pipeline`, writes a crash artifact with the digests and the trace
  ring, and the rung re-probes after `degrade_reprobe_s`; the port's
  watchdog also sees a stalled decode enqueue (``engine.dispatch.delay``,
  its op window covering the fault point, ROADMAP Queue 3);
- a skipped release (``engine.release.failx1``) is found by both ledgers'
  audits, attributed to the request, with one kv_leak artifact each;
- the `decode_scan` rung drops the port's decode dispatches to one-step
  graph keys, and its recovery returns to `decode_steps`;
- a sticky CUDA error is never contained; other errors are;
- the four `/debug/*` routes answer with the JAX service's schemas and
  status codes, and a profile taken while a request runs names its
  dispatch phases.

One engine per implementation serves every case, in file order, on one
event loop that the module keeps; the watchdog's budget is set on the
running engines once their warm-up is over (a first JAX compile is slower
than the budget)."""

from __future__ import annotations

import asyncio
import glob
import json
import os

import pytest

from dynamo_tpu.utils import faults as jfaults
from dynamo_tpu.utils import tracing as jtr
from dynamo_tpu_torch.engine import TorchEngine
from dynamo_tpu_torch.utils import faults as pfaults
from dynamo_tpu_torch.utils import tracing as ptr
from tests.test_torch_engine import CKPT, ENGINE_KW, _greedy, _port_engine
from tests.test_torch_step_pipeline import _classes, _wave
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

MIXED = dict(mixed_batching=True, mixed_step_tokens=64)
# the re-probe outlasts a stalled request, so the trip is still seen after it
PLANES = dict(degrade_reprobe_s=3.0, kv_audit_s=0.05)
WATCHDOG_S = 0.5
STALL_S = 2.0  # four budgets: the watchdog fires on it, never on a slow step
PROMPT = [5, 7, 6, 35, 4]  # "the capital of france is"
LADDER = ("mixed_disabled", "degraded_step_pipeline", "degraded_spec", "degraded_mixed",
          "degraded_decode_scan", "degrades_total", "recoveries_total", "watchdog_fired",
          "faults_injected")
FAULTS = {"jax": jfaults, "torch": pfaults}


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


def _run(loop, coro, timeout=120):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module")
def pair(loop, tmp_path_factory):
    from dynamo_tpu.engine import EngineConfig as JaxConfig, JaxEngine
    from dynamo_tpu.llm.local_model import LocalModel

    for f in FAULTS.values():
        f.reset()
    crash = tmp_path_factory.mktemp("crash")
    jeng = JaxEngine(JaxConfig(
        model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT, dtype="float32",
        attn_backend="gather", step_pipeline=True, crash_dir=str(crash / "jax"),
        **ENGINE_KW, **MIXED, **PLANES))
    peng = _port_engine(crash_dir=str(crash / "torch"), **MIXED, **PLANES)
    for eng in (jeng, peng):
        eng.flight.cooldown_s = 0.0  # every trigger of these cases writes
    out = {"jax": jeng, "torch": peng}
    yield out
    for f in FAULTS.values():
        f.reset()
    for eng in out.values():
        _run(loop, eng.close())


def _greedy_of(impl, eng, ids, n):
    return _greedy(eng, ids, n, *_classes(impl == "jax"))


def _ladder(eng):
    m = eng.metrics()
    return {k: m[k] for k in LADDER}


def _arm(loop, pair):
    """The watchdog's budget, on the running engines (after the warm-up)."""
    async def go():
        for eng in pair.values():
            eng._watchdog_s = WATCHDOG_S
            eng._ensure_watchdog()
    _run(loop, go())


def test_metrics_keys_equal(pair):
    jm, tm = pair["jax"].metrics(), pair["torch"].metrics()
    assert TorchEngine.UNPORTED_METRICS == {"tp_overlap_dispatches", "gspmd_fallback_dispatches"}
    assert set(jm) - set(tm) == TorchEngine.UNPORTED_METRICS
    assert set(tm) <= set(jm)
    assert _ladder(pair["torch"]) == _ladder(pair["jax"]) == dict.fromkeys(LADDER, 0)


def test_trace_names_equal(loop, pair):
    got = {}
    for impl, tr in (("jax", jtr), ("torch", ptr)):
        tr.clear()
        tr.enable()
        try:
            _run(loop, _greedy_of(impl, pair[impl], PROMPT, 6))
            trace = tr.export()
        finally:
            tr.disable()
            tr.clear()
        rows = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
                if e["name"] == "thread_name"}
        evs = [e for e in trace["traceEvents"] if e["ph"] != "M"]
        req = {e["name"] for e in evs if "request_id" in e["args"]}
        steps = {e["name"] for e in evs if rows.get(e["tid"]) == "engine.steps"}
        got[impl] = (req, steps)
    assert got["torch"] == got["jax"]
    assert {"seq.submit", "seq.admit", "seq.first_dispatch", "seq.first_token",
            "request"} <= got["torch"][0]
    assert {"prefill", "decode"} <= got["torch"][1]


def test_failed_mixed_step_contained(loop, pair):
    ref, got, stats = {}, {}, {}
    for impl, eng in pair.items():
        s0 = eng.phase_stats["mixed_steps"]
        ref[impl] = _run(loop, _wave(eng, jax=impl == "jax"))
        assert eng.phase_stats["mixed_steps"] > s0, f"{impl}: the wave took no mixed step"
    for impl, eng in pair.items():
        FAULTS[impl].configure("engine.mixed.fail@1x1")
        try:
            got[impl] = _run(loop, _wave(eng, jax=impl == "jax"))
        finally:
            stats[impl] = FAULTS[impl].stats()
            FAULTS[impl].reset()
    assert got["torch"] == got["jax"] == ref["torch"] == ref["jax"]
    held, wave = got["torch"]
    assert len(held) == 48 and all(len(w) == 10 for w in wave)
    assert stats["torch"] == stats["jax"] and stats["torch"]["engine.mixed"]["fired"] == 1
    want = dict.fromkeys(LADDER, 0)
    want.update(mixed_disabled=1, degraded_mixed=1, degrades_total=1)
    assert _ladder(pair["torch"]) == _ladder(pair["jax"]) == want
    assert all(e._degrade.disabled("mixed") for e in pair.values())  # for good


def test_watchdog_trips_and_recovers(loop, pair):
    want = {impl: _run(loop, _greedy_of(impl, eng, PROMPT, 12)) for impl, eng in pair.items()}
    _arm(loop, pair)
    got, before, tripped = {}, {impl: _ladder(eng) for impl, eng in pair.items()}, {}
    for impl, eng in pair.items():
        FAULTS[impl].configure(f"engine.prefill.delay={STALL_S}@1x1")
        try:
            got[impl] = _run(loop, _greedy_of(impl, eng, PROMPT, 12))
        finally:
            FAULTS[impl].reset()
        tripped[impl] = _ladder(eng)  # before the re-probe timer runs out
    assert got["torch"] == got["jax"] == want["torch"] == want["jax"]
    for impl in pair:
        d = {k: tripped[impl][k] - before[impl][k] for k in LADDER}
        assert d == dict.fromkeys(LADDER, 0) | dict(
            watchdog_fired=1, degraded_step_pipeline=1, degrades_total=1), impl
    arts = {}
    for impl, eng in pair.items():
        art = json.load(open(eng.last_crash_artifact))
        arts[impl] = (art["op"], art["rung_tripped"], sorted(art))
        assert art["stalled_s"] >= WATCHDOG_S and art["digests"]
    assert arts["torch"] == arts["jax"]
    assert arts["torch"][:2] == ("prefill.dispatch", "step_pipeline")
    _run(loop, asyncio.sleep(PLANES["degrade_reprobe_s"]))
    for impl, eng in pair.items():
        assert _run(loop, _greedy_of(impl, eng, PROMPT, 12)) == want[impl]
        m = _ladder(eng)
        assert m["recoveries_total"] == before[impl]["recoveries_total"] + 1, impl
        assert m["degraded_step_pipeline"] == 0


def test_release_leak_found_by_both_ledgers(loop, pair):
    found = {}
    for impl, eng in pair.items():
        ctx_cls, pre_cls, stop_cls, samp_cls = _classes(impl == "jax")
        pre = pre_cls(token_ids=[9, 8, 7, 6, 5, 4, 3] * 5,
                      stop_conditions=stop_cls(max_tokens=4, ignore_eos=True),
                      sampling_options=samp_cls(greedy=True))
        ctx = ctx_cls(pre.to_dict())

        async def serve(eng=eng, ctx=ctx):
            async for _ in await eng.generate(ctx):
                pass
            for _ in range(200):
                if eng.kv_ledger.violations_total:
                    break
                await asyncio.sleep(0.02)

        FAULTS[impl].configure("engine.release.failx1")
        try:
            _run(loop, serve())
        finally:
            FAULTS[impl].reset()
        log = list(eng.kv_ledger.violations_log)
        assert log and log[0].kind == "orphan_page" and log[0].owner == ctx.id, impl
        arts = [json.load(open(p)) for p in glob.glob(
            os.path.join(eng.config.crash_dir, "flight_recorder_*.json"))]
        leaks = [a for a in arts if a["reason"].startswith("kv_leak")]
        assert len(leaks) == 1 and leaks[0]["request_id"] == ctx.id, impl
        m = eng.metrics()
        found[impl] = (len(log), log[0].kind, len(log[0].page_ids), leaks[0]["reason"],
                       m["kv_ledger_violations"], m["kv_ledger_orphan_pages"],
                       leaks[0]["context"]["kv_ledger"]["orphan_pages"] == log[0].page_ids)
    assert found["torch"] == found["jax"]
    assert found["torch"][2] == 3 and found["torch"][-1]


def test_port_watchdog_sees_a_stalled_decode_enqueue(loop, pair):
    eng = pair["torch"]
    m0 = _ladder(eng)
    pfaults.configure(f"engine.dispatch.delay={STALL_S}@1x1")
    try:
        toks = _run(loop, _greedy_of("torch", eng, PROMPT, 12))
    finally:
        pfaults.reset()
    assert len(toks) == 12
    m = _ladder(eng)
    assert m["watchdog_fired"] == m0["watchdog_fired"] + 1
    assert m["degraded_step_pipeline"] == 1
    art = json.load(open(eng.last_crash_artifact))
    assert art["op"] == "decode.dispatch" and art["rung_tripped"] == "step_pipeline"
    assert art["trace"]["traceEvents"] is not None and art["digest_fields"]


def test_decode_scan_rung_takes_one_step_keys(loop, pair, monkeypatch):
    """The port's greedy stream is the same at one step a dispatch. (The
    JAX engine's pipelined one-step dispatches change its stream on this
    prompt: ROADMAP Queue 3.)"""
    eng = pair["torch"]
    keys = []
    run = eng._graphs.run
    monkeypatch.setattr(eng._graphs, "run", lambda *k: keys.append(k) or run(*k))
    want = _run(loop, _greedy_of("jax", pair["jax"], PROMPT, 12))
    eng._degrade.trip("decode_scan", "test", permanent=True)
    try:
        assert _run(loop, _greedy_of("torch", eng, PROMPT, 12)) == want
        assert keys and {k[-1] for k in keys} == {1}
        assert eng.metrics()["degraded_decode_scan"] == 1
    finally:
        eng._degrade._tripped.pop("decode_scan", None)
    keys.clear()
    assert _run(loop, _greedy_of("torch", eng, PROMPT, 12)) == want
    assert {k[-1] for k in keys} == {ENGINE_KW["decode_steps"]}


def test_sticky_cuda_error_not_contained(pair):
    from dynamo_tpu_torch.ops import _cuda

    assert _cuda.sticky(_cuda.CudaLaunchError("fused_decode", 700))
    assert _cuda.sticky(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not _cuda.sticky(_cuda.CudaLaunchError("w8a8_gemm", 1))
    assert not _cuda.sticky(pfaults.FaultError("injected failure at engine.mixed"))
    eng = pair["torch"]
    before = (eng.metrics()["degrades_total"], dict(eng._overrides), list(eng._prefilling))
    with pytest.raises(_cuda.CudaLaunchError):
        eng._mixed_dispatch_failed({"entries": [], "pipelined": True},
                                   _cuda.CudaLaunchError("ragged", 719))
    assert (eng.metrics()["degrades_total"], dict(eng._overrides),
            list(eng._prefilling)) == before


def test_debug_routes(loop, pair, monkeypatch, tmp_path):
    from dynamo_tpu.llm.http.service import HttpService as JaxService
    from dynamo_tpu_torch.llm.http import client
    from dynamo_tpu_torch.llm.http.service import HttpService

    monkeypatch.setenv("DYN_PROFILE_DIR", str(tmp_path))
    eng = pair["torch"]

    async def go():
        svcs = {"jax": JaxService(), "torch": HttpService()}
        for svc in svcs.values():
            await svc.start("127.0.0.1", 0)
        out = {}
        try:
            for impl, svc in svcs.items():
                async def call(method, path, svc=svc):
                    reply = await client.request("127.0.0.1", svc.port, method, path,
                                                 {} if method == "POST" else None)
                    return reply.status, json.loads(await reply.read())

                res = {}
                for method, path in (("GET", "/debug/trace?limit=5"),
                                     ("GET", "/debug/trace?limit=x"),
                                     ("GET", "/debug/snapshot"), ("GET", "/debug/kv?top=3"),
                                     ("GET", "/debug/kv?top=x"),
                                     ("POST", "/debug/profile?duration_ms=abc")):
                    res[path] = await call(method, path)
                if impl == "torch":
                    # a profile while a request runs through the engine
                    async def later():
                        await asyncio.sleep(0.15)  # inside the capture
                        return await _greedy_of("torch", eng, PROMPT, 12)

                    prof, toks = await asyncio.gather(
                        call("POST", "/debug/profile?duration_ms=600"), later())
                else:
                    prof = await call("POST", "/debug/profile?duration_ms=50")
                res["/debug/profile"] = prof
                out[impl] = res
        finally:
            for svc in svcs.values():
                await svc.stop()
        return out

    got = _run(loop, go())

    def schema(res):
        out = {}
        for path, (status, body) in res.items():
            keys = sorted(body)
            if path == "/debug/snapshot":
                keys.append(sorted({k for a in body["artifacts"] for k in a}))
            if path == "/debug/kv?top=3":
                keys.append(sorted({k for led in body["kv"] for k in led}))
            out[path] = (status, keys)
        return out

    assert schema(got["torch"]) == schema(got["jax"])
    status, info = got["torch"]["/debug/profile"]
    assert status == 200
    names = {e.get("name") for e in json.load(
        open(os.path.join(info["dir"], "trace.json")))["traceEvents"]}
    assert {"prefill", "decode"} <= names
    assert any(str(n).startswith("engine.step#step_num=") for n in names)
    assert got["torch"]["/debug/kv?top=3"][1]["ledgers"] >= 1
