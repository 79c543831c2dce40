"""The port's front-door admission gate (`dynamo_tpu_torch/llm/http/
admission.py`, its wiring in `HttpService` and `run.py --admission`)
against the JAX package's:

- the controller's verdicts (state, shed class, status, `Retry-After`,
  message) and its rendered series equal to the reference's on one
  scripted sequence of queue depths, attainments, tenants and clock
  readings (both modules' clock replaced by the same scripted one, so the
  signal cache behaves the same), a failing signal failing open;
- the HTTP gate: the port's `HttpService` and the reference's on echo
  engines, their gates driven through ok, overload and critical; statuses,
  `Retry-After` and bodies equal, the admitted requests' Context metadata
  carrying the same priority class, and the gate's series on `/metrics`;
- `run.py --admission` (and DYN_ADMISSION=1) builds the reference's gate
  from the same targets, and `serve_http` binds it to the CPU engine's
  waiting depth and the SLO tracker.
"""

from __future__ import annotations

import asyncio
import json
import os

from dynamo_tpu.llm.http import admission as jadm
from dynamo_tpu_torch.llm.http import admission as adm
from dynamo_tpu_torch.llm.http import client
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "tests", "data", "tiny-trained-llama")
TARGETS = {
    "default": {"ttft_s": 2.0, "priority": 0},
    "gold": {"ttft_s": 1.0, "priority": 2},
    "silver": {"ttft_s": 2.0, "priority": 1},
    "bronze": {"ttft_s": 4.0},
}

# (clock advance s, queue depth, worst attainment, tenant); a queue of
# None raises inside the signal (fail open)
SCRIPT = [
    (0.0, 0.0, None, "gold"), (0.3, 9.0, 0.5, "bronze"), (0.1, 30.0, 0.2, "bronze"),
    (0.3, 9.0, 0.5, "bronze"), (0.0, 9.0, 0.5, "silver"), (0.0, 9.0, 0.5, "stranger"),
    (0.3, 17.0, 0.98, "silver"), (0.0, 17.0, 0.98, "gold"), (0.3, 17.0, 0.999, "bronze"),
    (0.3, None, 0.1, "bronze"), (0.3, 3.0, 0.1, "default"), (0.3, 16.5, 0.5, "default"),
    (0.05, 50.0, 0.5, "silver"), (0.3, 8.0, 0.0, "silver"),
]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _play(mod, clock):
    sig = {"q": 0.0, "a": None}

    def queue():
        if sig["q"] is None:
            raise RuntimeError("metrics hiccup")
        return sig["q"]

    ctl = mod.AdmissionController(
        priorities=mod.priorities_from_targets(TARGETS),
        cfg=mod.AdmissionConfig(queue_high_watermark=8.0, retry_after_s=3),
    ).bind(queue_depth_fn=queue, attainment_fn=lambda: sig["a"])
    out = []
    for dt, q, a, tenant in SCRIPT:
        clock.t += dt
        sig["q"], sig["a"] = q, a
        v = ctl.check(tenant)
        out.append((ctl.state, ctl.priority_of(tenant), ctl._row(tenant),
                    None if v is None else (v.status, v.retry_after_s, v.message)))
    return out, list(ctl.render())


def test_controller_verdicts_equal_to_reference(monkeypatch):
    clocks = {m: _Clock() for m in (adm, jadm)}
    for m, c in clocks.items():
        monkeypatch.setattr(m, "time", c)
    got, got_series = _play(adm, clocks[adm])
    want, want_series = _play(jadm, clocks[jadm])
    assert got == want
    assert got_series == want_series
    states = {s for s, *_ in got}
    assert states == {"ok", "overload", "critical"}
    assert {v[0] for *_, v in got if v} == {429, 503}
    assert adm.priorities_from_targets({"x": {"priority": "bad"}, "y": None}) == \
        jadm.priorities_from_targets({"x": {"priority": "bad"}, "y": None}) == {"x": 0, "y": 0}


class _Recorder:
    """An echo engine that keeps each admitted request's metadata."""

    def __init__(self, echo):
        self.echo = echo
        self.metadata = []

    async def generate(self, ctx):
        self.metadata.append(dict(ctx.metadata))
        return await self.echo.generate(ctx)


async def test_http_gate_statuses_and_bodies_equal():
    from dynamo_tpu.llm.engines import EchoEngineFull as JaxEcho
    from dynamo_tpu.llm.http.service import HttpService as JaxService
    from dynamo_tpu_torch.llm.engines import EchoEngineFull
    from dynamo_tpu_torch.llm.http.service import HttpService

    sig = {"q": 0.0, "a": None}
    services = {}
    for name, mod, svc_cls, echo in (("port", adm, HttpService, EchoEngineFull()),
                                      ("jax", jadm, JaxService, JaxEcho())):
        ctl = mod.AdmissionController(
            priorities=mod.priorities_from_targets(TARGETS),
            cfg=mod.AdmissionConfig(eval_interval_s=0.0),
            queue_depth_fn=lambda: sig["q"], attainment_fn=lambda: sig["a"])
        svc = svc_cls(admission=ctl)
        rec = _Recorder(echo)
        svc.manager.add_completion_model("echo", rec)
        await svc.start("127.0.0.1", 0)
        services[name] = (svc, rec)
    try:
        seen = {}
        for state, q, a in (("ok", 0.0, None), ("overload", 9.0, 0.5),
                            ("critical", 20.0, 0.5)):
            sig.update(q=q, a=a)
            for tenant in ("gold", "silver", "bronze", None):
                for name, (svc, _) in services.items():
                    headers = {"x-tenant-id": tenant} if tenant else {}
                    r = await client.request(
                        "127.0.0.1", svc.port, "POST", "/v1/completions",
                        {"model": "echo", "prompt": "a b c", "max_tokens": 4}, headers=headers)
                    body = json.loads(await r.read())
                    if r.status == 200:
                        body = [c["text"] for c in body["choices"]]
                    seen[name, state, tenant] = (r.status, r.headers.get("retry-after"), body)
        port = {k[1:]: v for k, v in seen.items() if k[0] == "port"}
        assert port == {k[1:]: v for k, v in seen.items() if k[0] == "jax"}
        assert port["critical", "silver"][:2] == (503, "1")
        assert port["overload", "bronze"][:2] == (429, "1")
        assert port["overload", "silver"][0] == port["critical", "gold"][0] == 200
        assert services["port"][1].metadata == services["jax"][1].metadata
        assert {m.get("priority") for m in services["port"][1].metadata} == {0, 1, 2}
        r = await client.request("127.0.0.1", services["port"][0].port, "GET", "/metrics")
        text = (await r.read()).decode()
        assert "dynamo_tpu_admission_state 2.0" in text
        assert 'dynamo_tpu_admission_shed_total{level="critical",tenant="default"} 1.0' in text
    finally:
        for svc, _ in services.values():
            await svc.stop()


async def test_run_admission_builds_the_gate(tmp_path, monkeypatch):
    from dynamo_tpu.run import build_admission as jax_build
    from dynamo_tpu.run import build_parser as jax_parser
    from dynamo_tpu_torch.run import build_admission, build_parser, serve_http

    path = tmp_path / "slo.json"
    path.write_text(json.dumps(TARGETS))
    monkeypatch.delenv("DYN_ADMISSION", raising=False)
    monkeypatch.delenv("DYN_SLO_TARGETS", raising=False)
    common = ["in=http", "out=torch", "--model-path", CKPT, "--slo-targets", str(path)]
    assert build_admission(build_parser().parse_args(common)) is None
    monkeypatch.setenv("DYN_ADMISSION_QUEUE_HIGH", "3.5")
    for extra, env in ((["--admission"], None), ([], "1")):
        if env:
            monkeypatch.setenv("DYN_ADMISSION", env)
        got = build_admission(build_parser().parse_args(common + extra))
        want = jax_build(jax_parser().parse_args(common + extra))
        assert got.priorities == want.priorities == {"default": 0, "gold": 2, "silver": 1,
                                                     "bronze": 0}
        assert vars(got.cfg) == vars(want.cfg) and got.cfg.queue_high_watermark == 3.5

    monkeypatch.delenv("DYN_ADMISSION")
    args = build_parser().parse_args(common + [
        "--admission", "--device", "cpu", "--num-pages", "32", "--http-host", "127.0.0.1",
        "--http-port", "0"])
    svc, eng = await serve_http(args, "torch")
    try:
        gate = svc.admission
        assert gate is not None and gate._queue_depth_fn() == 0.0
        assert gate._attainment_fn() is None  # no finished request yet
        r = await client.request("127.0.0.1", svc.port, "POST", "/v1/completions", {
            "model": "tiny-trained-llama", "prompt": "the capital of france is",
            "max_tokens": 3}, headers={"x-tenant-id": "gold"})
        assert r.status == 200 and (await r.json())["choices"][0]["text"]
        await asyncio.sleep(0)
        assert gate._attainment_fn() is not None
        r = await client.request("127.0.0.1", svc.port, "GET", "/metrics")
        text = (await r.read()).decode()
        assert "dynamo_tpu_admission_state 0.0" in text
    finally:
        await svc.stop()
        await eng.close()

