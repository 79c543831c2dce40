"""The port's serving entry over HTTP against the JAX package's, on the
vendored checkpoint: `dynamo_tpu_torch.run.serve_http` (the port's asyncio
server, preprocessor, backend and TorchEngine(device="cpu")) beside the
JAX `HttpService` over `dynamo_tpu.run.build_output`'s JaxEngine (gather
attention), both float32 and greedy.

- Streamed chat and completion: the SSE events equal one for one (the
  `: ready` comment, annotations, data chunks, `[DONE]`) apart from `id`
  and `created`; non-streamed bodies equal likewise.
- The same for a scripted engine ("counting", `CountingEngine` behind each
  package's preprocessor and backend).
- Status codes and error bodies equal on bad JSON, an unknown model, an
  invalid and a zero `x-request-timeout`, a prompt over the context
  length, and an engine that raises (`AlwaysFailEngine`).
- `x-request-id` echo, `/v1/models`, `/health` and the `/metrics` series:
  both sides wire `EngineMetrics`, an `SloTracker` from `--slo-targets`
  (its breach hook on the flight recorder) and the process-global health
  counters as their run entries do, and the series equal apart from the
  JAX engine's gauges whose planes the port lacks
  (`TorchEngine.UNPORTED_METRICS`); of the process-global counters both
  render the known ones (what else a registry holds depends on the tests
  run before in the process); a tenant whose TTFT target is 0 s shows the
  same breach.
- A client that disconnects mid-stream frees its engine slot, and one
  that leaves a non-streamed request stops its generation.
- The port is driven by aiohttp and by its own raw-socket client
  (`dynamo_tpu_torch/llm/http/client.py`, what chip_smoke.py uses), with
  `Expect: 100-continue` and keep-alive.

One engine per implementation serves every case, on one event loop that
the module keeps."""

from __future__ import annotations

import asyncio
import json
import os

import aiohttp
import pytest

from dynamo_tpu_torch.llm.http import client
from dynamo_tpu_torch.llm.protocols.codec import decode_sse_lines
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "tests", "data", "tiny-trained-llama")
MODEL = "tiny-trained-llama"
COMMON = ["--model-path", CKPT, "--dtype", "float32", "--num-pages", "64"]


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=60))


_KNOWN_COUNTERS = ("hub_reconnects_total", "lease_expired_total", "client_retries_total",
                   "breaker_open_total", "router_workers_excluded_total",
                   "faults_injected_total")
SLO_TARGETS = {"default": {"ttft_s": 60.0, "itl_s": 10.0, "queue_wait_s": 60.0},
               "gold": {"ttft_s": 0.0}}


@pytest.fixture(scope="module")
def services(loop, tmp_path_factory):
    from dynamo_tpu.llm.http.metrics import EngineMetrics as JaxEngineMetrics
    from dynamo_tpu.llm.http.service import HttpService as JaxService
    from dynamo_tpu.run import build_output as jax_build_output
    from dynamo_tpu.run import build_parser as jax_parser
    from dynamo_tpu.run import build_slo_tracker as jax_slo_tracker
    from dynamo_tpu.utils import instance as jax_instance
    from dynamo_tpu.utils.counters import PromCounters as JaxPromCounters
    from dynamo_tpu_torch.run import build_parser, serve_http

    slo = tmp_path_factory.mktemp("slo") / "targets.json"
    slo.write_text(json.dumps(SLO_TARGETS))

    async def start():
        args = build_parser().parse_args(
            ["in=http", "out=torch", "--device", "cpu", "--http-host", "127.0.0.1",
             "--http-port", "0", "--slo-targets", str(slo), *COMMON])
        svc, eng = await serve_http(args, "torch")
        jargs = jax_parser().parse_args(["in=http", "out=jax", "--attn-backend", "gather",
                                         "--slo-targets", str(slo), *COMMON])
        pipe, card, jeng = await jax_build_output(jargs, "jax")
        jsvc = JaxService()
        # as the JAX run entry wires them (dynamo_tpu/run.py)
        jsvc.metrics.extra.append(JaxPromCounters())
        jslo = jax_slo_tracker(jargs)
        jslo.on_breach = jeng.flight.on_slo_breach
        jsvc.metrics.extra.append(JaxEngineMetrics(
            jeng, slo=jslo, worker_id=jax_instance.worker_id()))
        jsvc.manager.add_chat_model(card.display_name, pipe)
        jsvc.manager.add_completion_model(card.display_name, pipe)
        for pkg, service in (("dynamo_tpu", jsvc), ("dynamo_tpu_torch", svc)):
            _add_fixture_models(pkg, service)
        await jsvc.start("127.0.0.1", 0)
        return {"torch": (svc, eng), "jax": (jsvc, jeng)}

    out = _run(loop, start())
    yield out
    for svc, eng in out.values():
        _run(loop, svc.stop())
        _run(loop, eng.close())


def _add_fixture_models(pkg: str, svc) -> None:
    """The engines.py fixtures behind each package's own preprocessor and
    backend: "counting" streams token ids 0..4 and stops, "broken" raises
    on generate."""
    import importlib

    mods = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "llm.engines", "llm.model_card", "llm.preprocessor", "llm.backend",
        "runtime.pipeline.engine")}
    card = mods["llm.model_card"].ModelDeploymentCard.from_local_path(CKPT)
    counting = mods["runtime.pipeline.engine"].link(
        mods["llm.preprocessor"].OpenAIPreprocessor(card),
        mods["llm.backend"].Backend.from_card(card),
        mods["llm.engines"].CountingEngine(5))
    svc.manager.add_completion_model("counting", counting)
    svc.manager.add_chat_model("broken", mods["llm.engines"].AlwaysFailEngine())


def _url(services, impl):
    return f"http://127.0.0.1:{services[impl][0].port}"


async def _post(base, path, body=None, headers=None, data=None):
    async with aiohttp.ClientSession(base) as s:
        r = await s.post(path, json=body, data=data, headers=headers)
        return r.status, dict(r.headers), await r.read()


async def _get(base, path):
    async with aiohttp.ClientSession(base) as s:
        r = await s.get(path)
        return r.status, dict(r.headers), await r.read()


def _strip_ids(obj):
    if isinstance(obj, dict):
        return {k: _strip_ids(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip_ids(v) for v in obj]
    return obj


def _events(raw: bytes) -> list:
    """SSE events as (event, data, comments, has id); data JSON without
    ids and timestamps."""
    out = []
    for m in decode_sse_lines(raw.decode().split("\n")):
        data = _strip_ids(m.json()) if m.data is not None else None
        out.append((m.event, data, m.comments, m.done, m.id is not None))
    return out


CHAT = {"model": MODEL, "messages": [{"role": "user", "content": "the capital of france is"}],
        "max_tokens": 12}
COMPLETION = {"model": MODEL, "prompt": "the capital of germany is", "max_tokens": 12,
              "nvext": {"annotations": ["formatted_prompt", "token_ids"]}}


COUNTING = {"model": "counting", "prompt": "the", "max_tokens": 12}


@pytest.mark.parametrize("path, body", [("/v1/chat/completions", CHAT),
                                        ("/v1/completions", COMPLETION),
                                        ("/v1/completions", COUNTING)],
                         ids=["chat", "completion", "counting"])
@pytest.mark.parametrize("stream", [True, False])
def test_responses_equal(loop, services, path, body, stream):
    got = {}
    for impl in ("jax", "torch"):
        status, headers, raw = _run(loop, _post(_url(services, impl), path,
                                                dict(body, stream=stream)))
        assert status == 200, raw
        got[impl] = _events(raw) if stream else _strip_ids(json.loads(raw))
    assert got["torch"] == got["jax"]
    if stream:
        ev = got["torch"]
        assert ev[0][2] == ["ready"] and ev[-1][3] and all(e[4] for e in ev)
        assert any(isinstance(e[1], dict) and e[1].get("usage") for e in ev)
    else:
        assert got["torch"]["usage"]["completion_tokens"] == (5 if body is COUNTING else 12)


def test_raw_client_and_continue(loop, services):
    """The port through its own raw-socket client, with Expect:
    100-continue: the same SSE events as aiohttp reads, then the same
    body again on one kept-alive aiohttp connection."""
    port = services["torch"][0].port
    body = dict(CHAT, stream=True)

    async def go():
        reply = await client.request("127.0.0.1", port, "POST", "/v1/chat/completions",
                                     body, headers={"Expect": "100-continue",
                                                    "x-request-id": "raw-1"})
        assert reply.status == 200 and reply.headers["x-request-id"] == "raw-1"
        msgs = [m async for _, m in reply.sse()]
        async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
            raws = []
            for _ in range(2):  # one connection, kept alive
                r = await s.post("/v1/chat/completions", json=body)
                raws.append(await r.read())
        return msgs, raws

    msgs, raws = _run(loop, go())
    assert msgs[-1].done
    want = _events(raws[0])
    assert [(m.event, _strip_ids(m.json()) if m.data else None, m.comments, m.done)
            for m in msgs] == [e[:4] for e in want]
    assert _events(raws[1]) == want


@pytest.mark.parametrize("case", ["bad_json", "unknown_model", "bad_timeout", "zero_timeout",
                                  "over_context", "bad_request", "engine_fails"])
def test_status_codes_equal(loop, services, case):
    got = {}
    for impl in ("jax", "torch"):
        base = _url(services, impl)
        if case == "bad_json":
            coro = _post(base, "/v1/chat/completions", data=b"{not json",
                         headers={"Content-Type": "application/json"})
        elif case == "unknown_model":
            coro = _post(base, "/v1/chat/completions", dict(CHAT, model="nope"))
        elif case in ("bad_timeout", "zero_timeout"):
            coro = _post(base, "/v1/completions", COMPLETION,
                         headers={"x-request-timeout": "abc" if case == "bad_timeout" else "0"})
        elif case == "over_context":
            coro = _post(base, "/v1/completions",
                         dict(COMPLETION, prompt=" ".join(["the capital"] * 200)))
        elif case == "engine_fails":
            coro = _post(base, "/v1/chat/completions", dict(CHAT, model="broken"))
        else:
            coro = _post(base, "/v1/chat/completions", {"model": MODEL, "messages": []})
        status, headers, raw = _run(loop, coro)
        got[impl] = (status, json.loads(raw), headers.get("Retry-After"))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == {"bad_json": 400, "unknown_model": 404, "bad_timeout": 400,
                               "zero_timeout": 429, "over_context": 400,
                               "bad_request": 400, "engine_fails": 502}[case]


def test_request_id_models_health_metrics(loop, services):
    got = {}
    for impl in ("jax", "torch"):
        base = _url(services, impl)
        _, headers, _ = _run(loop, _post(base, "/v1/completions", COMPLETION,
                                         headers={"x-request-id": "rid-42"}))
        _, sheaders, _ = _run(loop, _post(base, "/v1/completions", dict(COMPLETION, stream=True),
                                          headers={"x-request-id": "rid-43"}))
        models = json.loads(_run(loop, _get(base, "/v1/models"))[2])
        health = [json.loads(_run(loop, _get(base, p))[2]) for p in ("/health", "/live")]
        metrics = _run(loop, _get(base, "/metrics"))[2].decode()
        series = sorted(line.split()[2] for line in metrics.splitlines()
                        if line.startswith("# TYPE"))
        got[impl] = (headers.get("X-Request-Id"), sheaders.get("X-Request-Id"), models,
                     health, series)
    jax_only = _jax_only_series()
    process = _process_counter_series()
    for impl in got:
        # the process-global health counters render on both sides
        assert {f"dynamo_tpu_{n}" for n in _KNOWN_COUNTERS} <= set(got[impl][4]), impl
        got[impl] = got[impl][:4] + ([n for n in got[impl][4]
                                      if n not in jax_only and n not in process],)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == ("rid-42", "rid-43")
    for name in ("dynamo_tpu_http_service_requests_total", "dynamo_tpu_engine_ttft_seconds",
                 "dynamo_tpu_engine_kv_pages_used", "dynamo_tpu_slo_attainment"):
        assert name in got["torch"][4]


def _jax_only_series() -> set:
    """The JAX side's series the port does not render: the engine gauges
    of unported planes."""
    from dynamo_tpu_torch.engine import TorchEngine

    return {f"dynamo_tpu_engine_{k}" for k in TorchEngine.UNPORTED_METRICS}


def _process_counter_series() -> set:
    """The series of both packages' process-global counter registries
    (utils/counters.py): beyond the known ones they hold what this
    process's other tests declared or counted (the JAX failover's, the
    profiler's), so they are compared by their known names alone."""
    from dynamo_tpu.utils import counters as jax_counters
    from dynamo_tpu_torch.utils import counters as port_counters

    names = set()
    for reg in (jax_counters, port_counters):
        names |= set(reg.PromCounters.KNOWN) | reg._declared | set(reg.snapshot())
    return {f"dynamo_tpu_{n}" for n in names}


def test_engine_metrics_and_slo_on_metrics(loop, services):
    """A request of the tenant "gold" (TTFT target 0 s) is a breach on both
    sides, its TTFT lands in the engine's histogram, and the engine gauges
    that do not depend on timing read the same."""
    def lines(text, prefix):
        return sorted(line for line in text.splitlines() if line.startswith(prefix))

    got = {}
    for impl in ("jax", "torch"):
        base = _url(services, impl)
        before = _run(loop, _get(base, "/metrics"))[2].decode()
        status, _, _ = _run(loop, _post(base, "/v1/completions", COMPLETION,
                                        headers={"x-tenant-id": "gold"}))
        assert status == 200
        after = _run(loop, _get(base, "/metrics"))[2].decode()
        count = [float(x.split()[-1]) for x in lines(
            after, "dynamo_tpu_engine_tokens_per_request_count")]
        count0 = [float(x.split()[-1]) for x in lines(
            before, "dynamo_tpu_engine_tokens_per_request_count")]
        got[impl] = (
            lines(after, 'dynamo_tpu_slo_breaches_total{metric="ttft",tenant="gold"}'),
            lines(after, 'dynamo_tpu_slo_attainment{metric="ttft",tenant="gold"}'),
            [c - c0 for c, c0 in zip(count, count0)],
            # each package labels its gauges with its own instance id
            [x.split()[-1] for x in lines(after, "dynamo_tpu_engine_kv_total_blocks")],
            [x.split()[-1] for x in lines(after, "dynamo_tpu_engine_request_total_slots")],
        )
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ['dynamo_tpu_slo_breaches_total{metric="ttft",tenant="gold"} 1.0']
    assert got["torch"][1] == ['dynamo_tpu_slo_attainment{metric="ttft",tenant="gold"} 0.0']
    assert got["torch"][2] == [1.0]


def test_disconnect_frees_the_engine_slot(loop, services):
    svc, eng = services["torch"]

    async def go():
        reply = await client.request(
            "127.0.0.1", svc.port, "POST", "/v1/completions",
            dict(COMPLETION, stream=True, max_tokens=200, nvext={"ignore_eos": True}))
        n = 0
        async for _, msg in reply.sse():
            n += 1
            if n == 4:
                break
        busy = sum(s is not None for s in eng.slots)
        reply.close()
        for _ in range(500):
            if not any(eng.slots) and not eng.waiting:
                return busy, True
            await asyncio.sleep(0.01)
        return busy, False

    busy, freed = _run(loop, go())
    assert busy == 1, "the stream was not running when the client left"
    assert freed, "the engine slot stayed taken after the client disconnected"

    async def quiet():
        """A non-streamed request writes nothing until it ends: only the
        server's watch on the socket sees the client leave."""
        t0 = eng.phase_stats["decode_tokens"]
        data = json.dumps(dict(COMPLETION, max_tokens=240, nvext={"ignore_eos": True}))
        _, writer = await asyncio.open_connection("127.0.0.1", svc.port)
        writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n%s"
                     % (len(data), data.encode()))
        await writer.drain()
        for _ in range(500):
            if any(eng.slots):
                break
            await asyncio.sleep(0.002)
        taken = any(eng.slots)
        writer.close()
        for _ in range(500):
            if not any(eng.slots) and not eng.waiting:
                break
            await asyncio.sleep(0.01)
        return taken, eng.phase_stats["decode_tokens"] - t0

    taken, made = _run(loop, quiet())
    assert taken, "the request never reached the engine"
    assert made < 200, f"{made} tokens decoded for a client that left"
    # and the engine serves the next request
    status, _, raw = _run(loop, _post(_url(services, "torch"), "/v1/chat/completions", CHAT))
    assert status == 200 and json.loads(raw)["choices"][0]["finish_reason"] == "length"
