"""The port's loadgen scenarios end to end at tiny scale on the CPU
(`dynamo_tpu_torch/loadgen/scenarios.py`, each scenario building its own
tiny TorchEngine with `device="cpu"`):

- `shared_prefix` at `tiny_scale(n=6)` through `run_suite`: the port's
  `check_section` passes, every request is `ok`, warm serves reuse pages,
  the dumped trace round-trips; against the reference's section from the
  same scale (one JaxEngine, the JAX scenario): the trace sha256, the
  section's key set and each request's prompt_tokens, tokens and status
  are equal (timing fields are not compared);
- `chat` over the port's live HTTP surface (SSE over a socket, the port's
  raw-socket client), well-formed;
- `long_context` at `sp == 1`, the one-device fallback, well-formed.
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.loadgen import scenarios
from dynamo_tpu_torch.loadgen.bench import run_suite
from dynamo_tpu_torch.loadgen.trace import Trace
from dynamo_tpu_torch.scripts.run_scenarios import check_section
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)


def _suite(name, scale):
    """run_suite on one scenario; returns its section and per-request
    results (subscribe_results)."""
    seen = {}
    unsubscribe = scenarios.subscribe_results(
        lambda n, results, engine: seen.setdefault(n, results))
    try:
        out = run_suite([name], scale)["results"][name]
    finally:
        unsubscribe()
    return out, seen.get(name)


def _per_request(results):
    return [(r.request_id, r.prompt_tokens, r.tokens, r.status) for r in results]


def test_shared_prefix_matches_the_reference(tmp_path, monkeypatch):
    from dynamo_tpu.loadgen import scenarios as jscenarios

    scale = scenarios.tiny_scale(n=6, trace_dir=str(tmp_path), device="cpu")
    out, results = _suite("shared_prefix", scale)
    assert check_section("shared_prefix", out) == []
    assert out["requests"] == {"total": 9, "ok": 9, "shed": 0, "errors": 0}
    assert out["reuse"]["requests_with_reuse"] > 0 and out["warm_reuse_frac"] > 0
    assert out["kv_census"]["ok"] and out["kv_census"]["orphan_pages"] == []
    dumped = Trace.load(str(tmp_path / "shared_prefix.jsonl"))
    assert dumped.summary()["sha256"] == out["trace"]["sha256"]

    # the reference's section and per-request results from the same scale
    seen = []
    real_score = jscenarios.score_results

    def spy(results, *a, **kw):
        seen.append(results)
        return real_score(results, *a, **kw)

    monkeypatch.setattr(jscenarios, "score_results", spy)
    want = asyncio.run(jscenarios.SCENARIOS["shared_prefix"].fn(
        jscenarios.tiny_scale(n=6)))
    assert out["trace"] == want["trace"]
    assert set(out) == set(want) | {"compile", "scenario_wall_s"}
    assert out["requests"] == want["requests"]
    assert _per_request(results) == _per_request(seen[0])


def test_chat_over_http_is_wellformed():
    out, results = _suite("chat", scenarios.tiny_scale(device="cpu"))
    assert check_section("chat", out) == []
    assert out["surface"] == "http"
    assert out["requests"] == {"total": 12, "ok": 12, "shed": 0, "errors": 0}
    assert {r.http_status for r in results} == {200}
    # ignore_eos: every stream ran to its max_tokens (chat doubles the OSL)
    assert {r.tokens for r in results} == {20}
    assert all(r.itl_s is not None and r.ttft_s > 0 for r in results)
    assert out["reuse"]["joined"] == 12 and out["kv_census"]["ok"]


def test_long_context_runs_at_sp1():
    out, results = _suite("long_context", scenarios.tiny_scale(device="cpu"))
    assert check_section("long_context", out) == []
    assert out["sp"] == 1
    assert out["requests"] == {"total": 6, "ok": 6, "shed": 0, "errors": 0}
    assert {r.prompt_tokens for r in results} == {192}
    assert out["kv_census"]["ok"]
