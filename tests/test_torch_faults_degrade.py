"""The port's fault registry (`dynamo_tpu_torch/utils/faults.py`), degrade
ladder (`engine/degrade.py`) and health counters (`utils/counters.py`)
against the JAX package's, side by side on the same inputs:

- every `DYN_FAULTS` spec parses to the same points, and a bad one raises
  the same way;
- the same spec and seed fire at the same arrivals (probabilistic specs
  draw from the same seeded `random.Random`), with the same per-point
  stats and `faults_injected_total`;
- the delay, fail and drop actions, sync and async, and the env loading;
- the ladder walked on an injected clock: trips, re-probes, permanent
  trips, state, mask and the trip hook;
- the five robustness fields of `EngineConfig` take the JAX package's
  defaults, and `tp_overlap` is still refused.

No engine runs here (tests/test_torch_robustness.py drives the engines)."""

from __future__ import annotations

import asyncio
import dataclasses

import pytest

from dynamo_tpu.engine import degrade as jdeg
from dynamo_tpu.utils import counters as jcounters
from dynamo_tpu.utils import faults as jfaults
from dynamo_tpu_torch.engine import degrade as pdeg
from dynamo_tpu_torch.utils import counters as pcounters
from dynamo_tpu_torch.utils import faults as pfaults

PAIR = {"jax": (jfaults, jcounters, jdeg), "torch": (pfaults, pcounters, pdeg)}

SPECS = (
    "engine.dispatch.delay=0.5",
    "hub.send.drop@3",
    "kv_transfer.fail",
    "engine.mixed.fail@2x1",
    "engine.release.failx3",
    "engine.prefill.delay=0.25@4x2~0.5",
    "a.b.c.drop~0.125",
    "engine.dispatch.delay=0.5,engine.dispatch.fail@3,engine.reserve.failx1",
)
BAD = ("", "engine.dispatch.explode", ".fail", "x.fail~1.5", "x.fail@0")


@pytest.fixture(autouse=True)
def _clean():
    # the counter registries are process-global: what other tests in this
    # process declared or counted comes back after each case
    saved = [(c, dict(c._values), set(c._declared)) for _, c, _ in PAIR.values()]
    for f, c, _ in PAIR.values():
        f.reset()
        c.reset()
    yield
    for f, _, _ in PAIR.values():
        f.reset()
    for c, values, declared in saved:
        c.reset()
        c._values.update(values)
        c._declared.update(declared)


def _points(mod):
    return {name: [dataclasses.asdict(p) for p in pts] for name, pts in mod._points.items()}


def test_specs_parse_alike():
    for spec in SPECS:
        got = {}
        for impl, (f, _, _) in PAIR.items():
            n = f.configure(spec)
            got[impl] = (n, _points(f), f.active())
        assert got["torch"] == got["jax"], spec
        assert got["torch"][0] == len(spec.split(","))


def test_bad_specs_raise_alike():
    for spec in BAD:
        errs = {}
        for impl, (f, _, _) in PAIR.items():
            try:
                f._parse_entry(spec)
                errs[impl] = None
            except ValueError as exc:
                errs[impl] = str(exc)
        assert errs["torch"] == errs["jax"] and errs["torch"] is not None, spec


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_firing_equal(seed):
    """Arrivals at three points under counted, armed-late and
    probabilistic specs: the same arrivals fire in both registries."""
    spec = "p.one.fail@3x2,p.two.drop~0.3,p.three.fail@2x4~0.6"
    names = ["p.one", "p.two", "p.three", "p.none"]
    got = {}
    for impl, (f, c, _) in PAIR.items():
        f.configure(spec, seed=seed)
        fired = []
        for i in range(60):
            name = names[i % len(names)]
            try:
                f.fire(name)
                fired.append(None)
            except (f.FaultError, ConnectionError) as exc:
                fired.append(type(exc).__name__)
        got[impl] = (fired, f.stats(), f.fired_total(), c.get("faults_injected_total"))
    assert got["torch"] == got["jax"]
    assert got["torch"][2] > 0 and got["torch"][3] == got["torch"][2]


def test_actions_sync_and_async():
    got = {}
    for impl, (f, _, _) in PAIR.items():
        f.configure("s.delay=0.01x1,s.fail@2x1,d.drop")
        out = []
        f.fire("s")  # the delay sleeps and returns
        for name in ("s", "d", "s"):
            try:
                f.fire(name)
                out.append("ok")
            except f.FaultError:
                out.append("fail")
            except ConnectionError:
                out.append("drop")

        async def go():
            res = []
            for name in ("d", "s"):
                try:
                    await f.afire(name)
                    res.append("ok")
                except ConnectionError:
                    res.append("drop")
            return res

        out += asyncio.run(go())
        f.install(f.FaultPoint(name="late", action="fail"))
        with pytest.raises(f.FaultError):
            f.fire("late")
        got[impl] = (out, f.stats())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["fail", "drop", "ok", "drop", "ok"]


def test_load_env_once(monkeypatch):
    monkeypatch.setenv("DYN_FAULTS", "e.fail@2,f.delay=0")
    monkeypatch.setenv("DYN_FAULTS_SEED", "3")
    got = {}
    for impl, (f, _, _) in PAIR.items():
        monkeypatch.setattr(f, "_env_loaded", False)
        n1 = f.load_env()
        f.fire("e")
        n2 = f.load_env()  # a second engine must not zero the hit counts
        got[impl] = (n1, n2, f.stats(), f._rng.random())
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (2, 0, {"e": {"hits": 1, "fired": 0},
                                       "f": {"hits": 0, "fired": 0}})


def _ladder_walk(deg):
    t = [0.0]
    trips = []
    lad = deg.DegradeLadder(reprobe_s=10.0, clock=lambda: t[0],
                            on_trip=lambda r, why: trips.append((r, why)))
    log = []

    def snap(tag):
        log.append((tag, lad.state(), lad.mask(), lad.any_tripped(),
                    lad.degrades_total, lad.recoveries_total))

    snap("start")
    for i in range(5):
        log.append(("walk", lad.trip_next(f"stall {i}")))
        t[0] += 2.0
    snap("walked")
    lad.trip("spec", "again")  # a re-trip extends the timer, no new degrade
    snap("retrip")
    t[0] = 19.0
    log.append(("probe", [lad.disabled(r) for r in deg.RUNGS]))
    snap("probed")
    lad.trip("mixed", "failed", permanent=True)
    t[0] = 100.0
    log.append(("late", [lad.disabled(r) for r in deg.RUNGS], lad.tripped("mixed")))
    lad.recover_all()
    snap("recovered")
    with pytest.raises(ValueError):
        lad.trip("bogus", "x")
    return log, trips


def test_ladder_walk_equal():
    got = {impl: _ladder_walk(d) for impl, (_, _, d) in PAIR.items()}
    assert got["torch"] == got["jax"]
    log, trips = got["torch"]
    assert [x[1] for x in log if x[0] == "walk"] == [*pdeg.RUNGS, None]
    assert [r for r, _ in trips] == [*pdeg.RUNGS, "mixed"]
    assert pdeg.RUNGS == ("step_pipeline", "spec", "mixed", "decode_scan")


def test_counters_registry_and_prom_equal():
    got = {}
    for impl, (_, c, _) in PAIR.items():
        c.declare("custom_total")
        c.inc("faults_injected_total", 2)
        c.inc("other_total")
        got[impl] = (c.snapshot(), c.get("other_total"), list(c.PromCounters().render()))
    assert got["torch"] == got["jax"]


def test_engine_config_robustness_fields():
    """The five fields exist with the JAX package's defaults, take other
    values, and `tp_overlap` is still refused by name."""
    from dynamo_tpu.engine.config import EngineConfig as JaxConfig
    from dynamo_tpu_torch.engine.config import EngineConfig

    fields = ("watchdog_dispatch_s", "degrade_reprobe_s", "crash_dir", "flight_recorder",
              "kv_audit_s")
    jd = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pd = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert {k: pd[k] for k in fields} == {k: jd[k] for k in fields}
    assert {k: pd[k] for k in fields} == {
        "watchdog_dispatch_s": 0.0, "degrade_reprobe_s": 30.0, "crash_dir": None,
        "flight_recorder": True, "kv_audit_s": None}
    cfg = EngineConfig(watchdog_dispatch_s=2.5, degrade_reprobe_s=1.0, crash_dir="/x",
                       flight_recorder=False, kv_audit_s=0.0)
    assert (cfg.watchdog_dispatch_s, cfg.flight_recorder, cfg.kv_audit_s) == (2.5, False, 0.0)
    with pytest.raises(NotImplementedError, match="tp_overlap"):
        EngineConfig(tp_overlap=True)
