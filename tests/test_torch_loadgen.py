"""The port's loadgen (`dynamo_tpu_torch/loadgen/`) against the JAX
package's (`dynamo_tpu/loadgen/`), on the CPU and without an engine:

- the three trace generators' canonical JSONL and sha256 byte-equal to the
  reference's at a few seeds, fixed and ranged ISL/OSL, tenant weights,
  sampling dicts and priorities;
- `PromptFactory` token lists equal, with each package's dumped trace
  loaded by the other;
- `score_results` equal on the same synthetic results (mixed outcomes with
  an SLO on ITL and a KV census, all shed, empty);
- `replay` open-loop: a submitter that blocks for the whole trace delays
  no later arrival;
- the registry covers the eight workloads, and each fleet adapter raises
  naming M17.
"""

from __future__ import annotations

import asyncio

import pytest

from dynamo_tpu.loadgen import driver as jdriver
from dynamo_tpu.loadgen import prompts as jprompts
from dynamo_tpu.loadgen import score as jscore
from dynamo_tpu.loadgen import trace as jtrace
from dynamo_tpu_torch.loadgen import driver, prompts, score, trace
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

TRACE_CASES = {
    "poisson-fixed": ("poisson_trace", dict(n=24, rate_rps=12.0, seed=0, isl=64, osl=16)),
    "poisson-ranged": ("poisson_trace", dict(
        n=32, rate_rps=20.0, seed=7, isl=(16, 64), osl=(4, 12),
        tenants=(("a", 1, 2.0), ("b", 0)), sampling={"temperature": 0.7, "seed": 9})),
    "bursty": ("bursty_trace", dict(n=48, base_rps=4.0, peak_rps=48.0, period_s=8.0, seed=1,
                                     tenants=(("interactive", 2, 2.0), ("batch", 0, 1.0)))),
    "bursty-ranged": ("bursty_trace", dict(n=64, base_rps=2.0, peak_rps=30.0, period_s=4.0,
                                            seed=3, isl=(32, 512), osl=(8, 64))),
    "shared_prefix": ("shared_prefix_trace", dict(tenants=3, per_tenant=5, rate_rps=6.0,
                                                   seed=2, isl=512, osl=64)),
    "shared_prefix-ranged": ("shared_prefix_trace", dict(
        tenants=4, per_tenant=3, rate_rps=10.0, seed=5, isl=(33, 97), osl=(4, 9),
        priority_of={"tenant0": 2, "tenant3": 1})),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_traces_byte_equal_to_reference(case):
    fn, kw = TRACE_CASES[case]
    got, want = getattr(trace, fn)(**kw), getattr(jtrace, fn)(**kw)
    assert got.dumps() == want.dumps()
    assert got.sha256() == want.sha256()
    assert got.summary() == want.summary()
    # each package loads the other's file to the same bytes
    assert trace.Trace.loads(want.dumps()).dumps() == want.dumps()
    assert jtrace.Trace.loads(got.dumps()).dumps() == got.dumps()


def test_prompt_factory_tokens_equal_across_packages(tmp_path):
    """Traces dumped by one package and loaded by the other give the same
    prompts from either factory, page-aligned group prefixes included."""
    shared = jtrace.shared_prefix_trace(tenants=3, per_tenant=4, rate_rps=10.0, seed=4,
                                        isl=(40, 90), osl=8)
    plain = trace.poisson_trace(n=10, rate_rps=10.0, seed=6, isl=(8, 40), osl=4)
    (tmp_path / "shared.jsonl").write_text(shared.dumps())
    plain.dump(str(tmp_path / "plain.jsonl"))
    port_shared = trace.Trace.load(str(tmp_path / "shared.jsonl"))
    ref_plain = jtrace.Trace.load(str(tmp_path / "plain.jsonl"))
    for vocab, seed, page in ((256, 0, 8), (128256, 3, 64), (1000, 5, None)):
        fp = prompts.PromptFactory(vocab, seed=seed, page_size=page)
        fj = jprompts.PromptFactory(vocab, seed=seed, page_size=page)
        for tr_port, tr_ref in ((port_shared, shared), (plain, ref_plain)):
            for i, (rp, rj) in enumerate(zip(tr_port.records, tr_ref.records)):
                assert fp.prefix_len(rp) == fj.prefix_len(rj)
                assert fp.tokens_for(rp, i) == fj.tokens_for(rj, i)
    assert fp.prefix_tokens("group1", 24) == fj.prefix_tokens("group1", 24)


def _results(mod, spec):
    return [
        mod.RequestResult(
            index=i, request_id=f"r{i}", tenant=t, scheduled_s=float(i) * 0.1,
            launched_s=float(i) * 0.1 + lag, status=st, ttft_s=ttft, itl_s=itl,
            tokens=tok, prompt_tokens=64, queue_wait_s=qw, prefix=dict(pre))
        for i, (t, st, ttft, itl, tok, lag, qw, pre) in enumerate(spec)
    ]


SCORE_CASES = {
    "mixed": (
        [("a", "ok", 0.5, 0.01, 10, 0.001, 0.02, {"reused_blocks": 2}),
         ("a", "ok", 1.0, 0.03, 12, 0.004, 0.1, {}),
         ("b", "ok", 3.0, 0.01, 10, 0.0, None, {"restored_blocks": 1, "reused_blocks": 0}),
         ("b", "ok", 2.0, 0.2, 9, 0.002, 0.3, {}),
         ("b", "shed", None, None, 0, 0.001, None, {}),
         ("a", "error", None, None, 0, 0.003, None, {})],
        dict(wall_s=10.0, slo_ttft_s=2.0, slo_itl_s=0.05,
             kv_census={"engines": 1, "ok": True, "orphan_pages": []})),
    "all_shed": ([("b", "shed", None, None, 0, 0.0, None, {})] * 3, dict(wall_s=1.0)),
    "empty": ([], dict(wall_s=0.0)),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_results_equal_to_reference(case):
    spec, kw = SCORE_CASES[case]
    got = score.score_results(_results(driver, spec), **kw)
    want = jscore.score_results(_results(jdriver, spec), **kw)
    assert got == want
    assert got["requests"]["total"] == len(spec)


async def test_replay_is_open_loop():
    """A submitter that BLOCKS for the whole trace must not delay later
    arrivals: launch lag stays tiny while completions are all pending; an
    escaping exception marks its request an error."""
    tr = trace.poisson_trace(n=10, rate_rps=100.0, seed=0, isl=8, osl=4)
    launched: list[float] = []
    release = asyncio.Event()

    async def submit(rec, res):
        launched.append(asyncio.get_running_loop().time())
        await release.wait()   # nothing completes until every arrival fired
        if res.index == 3:
            raise RuntimeError("boom")
        res.ttft_s = 0.01
        res.tokens = rec.osl

    async def releaser():
        await asyncio.sleep(tr.duration_s + 0.2)
        release.set()

    rel = asyncio.create_task(releaser())
    results, wall = await driver.replay(tr, submit)
    await rel
    assert len(launched) == 10 and wall >= tr.duration_s
    assert max(r.launch_lag_s for r in results) < 0.15
    assert [r.status for r in results] == ["ok"] * 3 + ["error"] + ["ok"] * 6
    assert "boom" in results[3].error
    assert [r.request_id for r in results] == [f"lg-{i:05d}" for i in range(10)]


async def test_registry_covers_the_workloads_and_fleet_adapters_raise():
    from dynamo_tpu.loadgen import bench as jbench
    from dynamo_tpu.loadgen.scenarios import SCENARIOS as JSCENARIOS
    from dynamo_tpu_torch.loadgen import bench
    from dynamo_tpu_torch.loadgen.scenarios import SCENARIOS, tiny_scale

    assert bench.DEFAULT_SET == jbench.DEFAULT_SET
    assert bench.FLEET_SET == jbench.FLEET_SET
    assert sorted(SCENARIOS) == sorted(JSCENARIOS)
    for name, spec in SCENARIOS.items():
        assert (spec.workload, spec.fleet) == (JSCENARIOS[name].workload,
                                               JSCENARIOS[name].fleet)
    assert {SCENARIOS[n].workload for n in bench.DEFAULT_SET} == {
        "chat", "rag", "shared_prefix", "bursty_diurnal", "long_context", "moe",
        "vision", "structured_sampling"}
    for name in bench.FLEET_SET:
        with pytest.raises(NotImplementedError, match="M17"):
            await SCENARIOS[name].fn(tiny_scale(device="cpu"))
