"""Scenario registry: one trace-driven scenario per workload the engine
claims to support.

Every scenario builds its own engine (tiny presets on the CPU, real
presets via ``LOADGEN_SCALE=real``), generates a SEEDED trace, replays it
with the open-loop driver, and scores the results with the SLO-gated
goodput machinery — so each entry in the ``scenarios`` section reports the
same contract: trace identity, TTFT/ITL p50/p99, throughput, goodput,
shed/error accounting, the joined reuse ledger and the KV custody census.

The JAX package's `loadgen/scenarios.py` on TorchEngine, with the same
names, scales, traces and sections. Where the port differs:

- ``Scale.device`` picks the engine's torch device (None: the engine's
  default, the GPU, with no fallback; ``"cpu"`` runs the kernels' plain
  versions).
- ``long_context`` runs at ``sp=1``, which the reference falls back to on
  one device: the port has no mesh yet (ROADMAP M13). Its prefill chunk is
  the reference's ``max_model_len`` rounded up to a whole page.
- ``moe`` takes ``LOADGEN_MOE_MODEL`` (default ``tiny-moe``, as in the
  reference) and, when ``LOADGEN_MOE_LAYERS`` is set, cuts that model's
  depth to so many layers (recorded as ``layers``): the CUDA kernels take
  head_dim 32, 64 or 128, so on the card the scenario serves a wider MoE
  model, and Mixtral-8x7B's 32 layers do not fit one card.
- ``vision`` builds the port's tower from a torch generator seeded
  ``seed`` and draws each image from one seeded ``seed * 100003 + index``:
  the reference's seeds, not its pixels (JAX and torch generators differ).
- The fleet adapters (``prefix_fleet``, ``control_chaos``, ``failover``)
  are registered and raise: they need the runtime and the hub (M17).
- ``subscribe_results(cb)`` lets a harness see each engine-backed
  scenario's per-request results and its engine, `cb(name, results,
  engine)`, before the engine closes (the scenario sections keep the
  reference's keys); a callback must not keep the engine.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import os
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

import numpy as np

from dynamo_tpu_torch.engine.kv_ledger import quiesce_census
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.loadgen.driver import LedgerJoin, engine_submitter, replay
from dynamo_tpu_torch.loadgen.http import engine_http_service, http_submitter
from dynamo_tpu_torch.loadgen.prompts import PromptFactory
from dynamo_tpu_torch.loadgen.score import score_results
from dynamo_tpu_torch.loadgen.trace import (
    Trace,
    bursty_trace,
    poisson_trace,
    shared_prefix_trace,
)
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.loadgen")


# ------------------------------------------------------------------ scale

@dataclass
class Scale:
    """Scenario sizing knobs. ``tiny`` finishes the full default suite
    in a couple of CPU minutes; ``real`` is the on-card configuration
    (LOADGEN_MODEL picks the preset — default the llama-1b class)."""

    name: str = "tiny"
    n: int = 12                  # requests per scenario trace
    rate_rps: float = 24.0       # base offered rate
    isl: int = 32
    osl: int = 10
    model: str = "tiny"
    dtype: str = "float32"
    page_size: int = 8
    max_batch: int = 4
    num_pages: Optional[int] = 512
    slo_ttft_s: float = 2.0
    slo_itl_s: Optional[float] = None
    seed: int = 0
    trace_dir: Optional[str] = None
    device: Optional[str] = None  # torch device of the engines; None = the GPU

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def tiny_scale(**over) -> Scale:
    return Scale(**over)


def real_scale(**over) -> Scale:
    kw = dict(
        name="real", n=96, rate_rps=12.0, isl=512, osl=64,
        model=os.environ.get("LOADGEN_MODEL", "llama-3.2-1b"),
        dtype="bfloat16", page_size=64, max_batch=32, num_pages=None,
        slo_ttft_s=2.0,
    )
    kw.update(over)
    return Scale(**kw)


# --------------------------------------------------------------- registry

@dataclass
class ScenarioSpec:
    name: str
    workload: str
    description: str
    fn: Callable[[Scale], Awaitable[dict]]
    fleet: bool = False  # adapter over a standalone fleet proof


SCENARIOS: dict[str, ScenarioSpec] = {}

_result_observers: list = []


def scenario(name: str, workload: str, description: str, fleet: bool = False):
    def wrap(fn):
        SCENARIOS[name] = ScenarioSpec(
            name=name, workload=workload, description=description,
            fn=fn, fleet=fleet,
        )
        return fn
    return wrap


def subscribe_results(cb) -> Callable[[], None]:
    """`cb(name, results, engine)` after each engine-backed scenario's
    replay, before its engine closes; returns the unsubscribe."""
    _result_observers.append(cb)
    return lambda: _result_observers.remove(cb)


# ---------------------------------------------------------------- helpers

def _engine(scale: Scale, model=None, *,
            isl: Optional[int] = None, osl: Optional[int] = None, **over):
    """Engine sized for the scenario's ISL/OSL (defaults from scale);
    `model` is a preset name or a ModelConfig."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import config as cfgmod

    model = model or scale.model
    cfg = cfgmod.get_config(model) if isinstance(model, str) else model
    isl = isl or scale.isl
    osl = osl or scale.osl
    kw = dict(
        model=cfg, dtype=scale.dtype, page_size=scale.page_size,
        num_pages=scale.num_pages, max_batch_size=scale.max_batch,
        max_model_len=isl + osl + 32, prefill_chunk=isl, seed=0,
    )
    kw.update(over)
    return TorchEngine(EngineConfig(**kw), device=scale.device), cfg


async def _serve_direct(engine, tokens, osl: int,
                        sampling: Optional[SamplingOptions] = None,
                        **pre_kw) -> list[int]:
    pre = PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
        sampling_options=sampling or SamplingOptions(greedy=True),
        **pre_kw,
    )
    out = []
    async for frame in await engine.generate(Context(pre.to_dict())):
        out.extend(frame.get("token_ids") or [])
    return out


def _isl_reps(trace: Trace) -> list[int]:
    """One representative ISL per pow2 prefill bucket present in the
    trace — ranged-ISL traces (rag's (lo, hi)) span several prefill
    buckets, and warming only one length would leave the others' first
    dispatches INSIDE the measured replay."""
    reps: dict[int, int] = {}
    for r in trace.records:
        bucket = 1 << max(0, r.isl - 1).bit_length()
        reps[bucket] = max(reps.get(bucket, 0), r.isl)
    return sorted(reps.values())


async def _warmup(engine, vocab: int, isls, continuation: bool = False):
    """Pay the first-use costs before the measured replay: two distinct
    prompts per ISL bucket (prefill + decode shapes, the decode graphs'
    captures); `continuation` re-serves one so the cached-prefix tail path
    runs too (prefix scenarios). `isls` is an int or a list of lengths."""
    rng = np.random.RandomState(987654321)
    for isl in ([isls] if isinstance(isls, int) else isls):
        for i in range(2):
            p = rng.randint(1, vocab, size=isl).tolist()
            await _serve_direct(engine, p, 4)
            if continuation and i == 0:
                await _serve_direct(engine, p, 4)


def _maybe_dump(trace: Trace, scale: Scale, name: str) -> None:
    if scale.trace_dir:
        os.makedirs(scale.trace_dir, exist_ok=True)
        trace.dump(os.path.join(scale.trace_dir, f"{name}.jsonl"))


def _section(spec_name: str, trace: Trace, score: dict, **extra) -> dict:
    spec = SCENARIOS[spec_name]
    return {
        "scenario": spec_name,
        "workload": spec.workload,
        "trace": trace.summary(),
        **score,
        **extra,
    }


async def _replay_and_score(
    name: str, scale: Scale, trace: Trace, engine, cfg, make_submit,
    warm_continuation: bool = False, **extra,
) -> tuple[dict, list]:
    """ONE body for every engine-backed scenario: dump the trace, warm
    the first-use paths, open-loop replay through whatever target
    `make_submit` yields (an async CM: PromptFactory -> Submit), join the
    ledger, score. Returns (section, results) so callers can derive
    per-tenant splits; the engine is closed on the way out."""
    _maybe_dump(trace, scale, name)
    ledger = LedgerJoin(engine)
    factory = PromptFactory(
        cfg.vocab_size, seed=scale.seed, page_size=scale.page_size
    )
    try:
        await _warmup(engine, cfg.vocab_size, _isl_reps(trace),
                      continuation=warm_continuation)
        async with make_submit(factory) as submit:
            results, wall = await replay(trace, submit)
        # drain the last finish summaries (the engine fires them from
        # its loop; one tick is enough in-process)
        await asyncio.sleep(0)
        ledger.apply(results)
        # custody census before the engine goes away: every
        # engine-backed scenario section carries a zero-orphan proof
        census = await asyncio.to_thread(quiesce_census, [engine], 5.0)
        score = score_results(
            results, wall, slo_ttft_s=scale.slo_ttft_s,
            slo_itl_s=scale.slo_itl_s, kv_census=census,
        )
        for cb in list(_result_observers):
            cb(name, results, engine)
        return _section(name, trace, score, **extra), results
    finally:
        await engine.close()


async def _run_http_scenario(
    name: str, scale: Scale, trace: Trace, engine, cfg,
    admission=None, **extra,
) -> tuple[dict, list]:
    """Scenario over the LIVE HttpService: SSE replay over a real
    socket (the admission gate sits on the real front door)."""

    @contextlib.asynccontextmanager
    async def target(factory):
        async with engine_http_service(
            engine, vocab_size=cfg.vocab_size, admission=admission,
        ) as svc:
            yield http_submitter(("127.0.0.1", svc.port), factory)

    return await _replay_and_score(
        name, scale, trace, engine, cfg, target, surface="http", **extra,
    )


async def _run_engine_scenario(
    name: str, scale: Scale, trace: Trace, engine, cfg,
    decorate=None, warm_continuation: bool = False, **extra,
) -> dict:
    """Scenario direct against the engine (token-level submits)."""

    @contextlib.asynccontextmanager
    async def target(factory):
        yield engine_submitter(engine, factory, decorate=decorate)

    section, _ = await _replay_and_score(
        name, scale, trace, engine, cfg, target,
        warm_continuation=warm_continuation, **extra,
    )
    return section


# -------------------------------------------------------------- scenarios

@scenario(
    "chat", "chat",
    "short-ISL/long-OSL interactive chat served over the LIVE OpenAI "
    "HTTP surface (SSE streaming), Poisson open-loop arrivals",
)
async def chat_scenario(scale: Scale) -> dict:
    osl = scale.osl * 2
    trace = poisson_trace(
        n=scale.n, rate_rps=scale.rate_rps, seed=scale.seed,
        isl=scale.isl, osl=osl, workload="chat",
    )
    engine, cfg = _engine(scale, osl=osl)
    section, _ = await _run_http_scenario("chat", scale, trace, engine, cfg)
    return section


@scenario(
    "rag", "rag",
    "RAG/summarize shape: long-ISL/short-OSL (prefill-dominated), "
    "Poisson open-loop arrivals direct against the engine",
)
async def rag_scenario(scale: Scale) -> dict:
    isl = scale.isl * 4
    osl = max(4, scale.osl // 2)
    trace = poisson_trace(
        n=scale.n, rate_rps=scale.rate_rps / 2, seed=scale.seed,
        isl=(isl // 2, isl), osl=osl, workload="rag",
    )
    engine, cfg = _engine(scale, isl=isl, osl=osl)
    return await _run_engine_scenario("rag", scale, trace, engine, cfg)


@scenario(
    "shared_prefix", "shared_prefix",
    "multi-tenant shared-prefix mix (system-prompt shape): page-aligned "
    "group prefixes make warm serves ride the prefix cache; scored with "
    "the joined reuse ledger",
)
async def shared_prefix_scenario(scale: Scale) -> dict:
    tenants = 3
    per_tenant = max(3, scale.n // tenants)
    trace = shared_prefix_trace(
        tenants=tenants, per_tenant=per_tenant,
        rate_rps=scale.rate_rps / 2, seed=scale.seed,
        isl=scale.isl, osl=scale.osl,
    )
    engine, cfg = _engine(scale)
    out = await _run_engine_scenario(
        "shared_prefix", scale, trace, engine, cfg, warm_continuation=True,
    )
    reuse = out["reuse"]
    n = out["requests"]["total"]
    # cold misses: the first serve of each group can't reuse anything
    out["warm_reuse_frac"] = round(
        reuse["requests_with_reuse"] / max(1, n - tenants), 3
    )
    return out


@scenario(
    "bursty", "bursty_diurnal",
    "bursty/diurnal arrivals with the admission ladder + tenant "
    "priorities ACTIVE: the batch tier sheds under the crest, the "
    "interactive tier's goodput is defended",
)
async def bursty_scenario(scale: Scale) -> dict:
    from dynamo_tpu_torch.llm.http.admission import (
        AdmissionConfig,
        AdmissionController,
        priorities_from_targets,
    )
    from dynamo_tpu_torch.llm.http.metrics import SloTracker

    targets = {
        "default": {"ttft_s": scale.slo_ttft_s, "priority": 0},
        "interactive": {"ttft_s": scale.slo_ttft_s, "priority": 2},
        "batch": {"ttft_s": scale.slo_ttft_s, "priority": 0},
    }
    trace = bursty_trace(
        n=scale.n * 2,
        base_rps=scale.rate_rps / 3,
        peak_rps=scale.rate_rps * 4,
        period_s=max(2.0, scale.n / scale.rate_rps),
        seed=scale.seed,
        isl=scale.isl, osl=scale.osl,
        tenants=(("interactive", 2, 2.0), ("batch", 0, 1.0)),
    )
    engine, cfg = _engine(scale)
    slo = SloTracker(targets, window_s=60.0)
    engine.subscribe_requests(slo.observe)
    admission = AdmissionController(
        priorities=priorities_from_targets(targets),
        cfg=AdmissionConfig(
            # tiny pools overload at single-digit queue depths; the
            # crest must actually trip the ladder for the scenario to
            # prove anything
            queue_high_watermark=max(2.0, scale.max_batch / 2),
            eval_interval_s=0.05,
        ),
    )

    def _worst_attain():
        snap = slo.snapshot()
        return min(snap.values()) if snap else None

    admission.bind(
        queue_depth_fn=lambda: float(
            engine.metrics().get("num_requests_waiting", 0)
        ),
        attainment_fn=_worst_attain,
    )

    # sample the ladder's PEAK state while the replay runs — the state
    # decays back to "ok" as the crest drains, so a post-hoc read would
    # always report "ok" even when the gate tripped mid-replay.
    # admission.state is refreshed by the request traffic itself.
    levels = {"ok": 0, "overload": 1, "critical": 2}
    peak = {"level": 0}

    async def sample_peak():
        while True:
            peak["level"] = max(peak["level"], levels[admission.state])
            await asyncio.sleep(0.05)

    sampler = asyncio.create_task(sample_peak())
    try:
        section, results = await _run_http_scenario(
            "bursty", scale, trace, engine, cfg, admission=admission,
        )
    finally:
        sampler.cancel()
    by_tenant = {}
    for r in results:
        t = by_tenant.setdefault(
            r.tenant, {"total": 0, "ok": 0, "shed": 0}
        )
        t["total"] += 1
        if r.status == "ok":
            t["ok"] += 1
        elif r.status == "shed":
            t["shed"] += 1
    section["admission"] = {
        "peak_state": [s for s, v in levels.items()
                       if v == peak["level"]][0],
        "by_tenant": by_tenant,
    }
    return section


@scenario(
    "long_context", "long_context",
    "long-context prefill via ring attention over the sp mesh axis "
    "(ops/ring_attention.py); falls back to sp=1 on a single device",
)
async def long_context_scenario(scale: Scale) -> dict:
    # the port has no mesh (ROADMAP M13): sp=1, the reference's
    # single-device fallback
    sp = 1
    isl = scale.isl * 6
    osl = max(4, scale.osl // 2)
    trace = poisson_trace(
        n=max(4, scale.n // 2), rate_rps=scale.rate_rps / 4,
        seed=scale.seed, isl=isl, osl=osl, workload="long_context",
    )
    # the reference prefills the whole context in one chunk (ring prefill
    # at sp>1 requires prefill_chunk >= max_model_len); the port's chunk
    # is a whole number of pages
    max_len = isl + osl + 32
    chunk = -(-max_len // scale.page_size) * scale.page_size
    engine, cfg = _engine(
        scale, isl=isl, osl=osl, prefill_chunk=chunk,
        max_model_len=max_len,
    )
    return await _run_engine_scenario(
        "long_context", scale, trace, engine, cfg, sp=sp,
    )


@scenario(
    "moe", "moe",
    "sparse mixture-of-experts serving (models/moe.py capacity-routed "
    "experts), Poisson open-loop arrivals",
)
async def moe_scenario(scale: Scale) -> dict:
    from dynamo_tpu_torch.models import config as cfgmod

    model = os.environ.get("LOADGEN_MOE_MODEL", "tiny-moe")
    mcfg = cfgmod.get_config(model)
    extra = {}
    if os.environ.get("LOADGEN_MOE_LAYERS"):
        mcfg = mcfg.with_(num_layers=int(os.environ["LOADGEN_MOE_LAYERS"]))
        extra["layers"] = mcfg.num_layers
    trace = poisson_trace(
        n=scale.n, rate_rps=scale.rate_rps, seed=scale.seed,
        isl=scale.isl, osl=scale.osl, workload="moe",
    )
    engine, cfg = _engine(scale, model=mcfg)
    return await _run_engine_scenario(
        "moe", scale, trace, engine, cfg, model=model, **extra,
    )


@scenario(
    "vision", "vision",
    "multimodal vision workload: per-request image patch embeddings "
    "(models/vision.py) injected via prompt_embeds (LLaVA shape)",
)
async def vision_scenario(scale: Scale) -> dict:
    import torch

    from dynamo_tpu_torch.models.vision import (
        VisionConfig,
        encode,
        init_vision_params,
    )

    engine, cfg = _engine(scale)
    dev = engine.device
    vcfg = VisionConfig(
        image_size=32, patch_size=16, hidden_size=32, num_layers=1,
        num_heads=2, out_size=cfg.hidden_size,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(scale.seed)
    vparams = init_vision_params(vcfg, gen)
    n_patches = vcfg.num_patches
    offset = 2
    trace = poisson_trace(
        n=scale.n, rate_rps=scale.rate_rps, seed=scale.seed,
        isl=max(scale.isl, offset + n_patches + 4), osl=scale.osl,
        workload="vision",
    )

    def embeds_for(index: int) -> list:
        # a distinct deterministic image per request: its patch
        # embeddings replace `n_patches` token positions at `offset`
        g = torch.Generator(device=dev)
        g.manual_seed(scale.seed * 100003 + index)
        img = torch.rand((1, vcfg.image_size, vcfg.image_size, 3), generator=g,
                         device=dev)
        with torch.inference_mode():
            out = encode(vparams, vcfg, img)[0]
        return out.float().cpu().numpy().tolist()

    def decorate(rec, res, pre: PreprocessedRequest) -> None:
        pre.prompt_embeds = embeds_for(res.index)
        pre.embeds_offset = offset

    # the engine's embeds-prefill path runs its own first use — pay it
    # before the measured replay (the shared token-only warmup in
    # _run_engine_scenario covers only plain prompts)
    warm_prompt = np.random.RandomState(192837465).randint(
        1, cfg.vocab_size, size=trace.records[0].isl
    ).tolist()
    await _serve_direct(
        engine, warm_prompt, 4,
        prompt_embeds=embeds_for(-1), embeds_offset=offset,
    )

    return await _run_engine_scenario(
        "vision", scale, trace, engine, cfg, decorate=decorate,
        patches_per_request=n_patches,
    )


# cycled per request index: greedy, seeded temperature+top_k, seeded
# nucleus, seeded repetition-penalty, greedy+logprobs — heterogeneous
# sampling configs coexisting in one batch is the workload
_SAMPLING_CYCLE = (
    {},
    {"temperature": 0.8, "top_k": 8, "seed": 11},
    {"temperature": 1.0, "top_p": 0.9, "seed": 12},
    {"temperature": 0.9, "repetition_penalty": 1.3, "seed": 13},
    {"greedy": True, "logprobs": True, "top_logprobs": 2},
)


@scenario(
    "structured", "structured_sampling",
    "structured/constrained sampling plane: heterogeneous per-request "
    "sampling (seeded temperature/top-k/top-p, penalties, logprobs) "
    "mixed with greedy rows in the same batch",
)
async def structured_scenario(scale: Scale) -> dict:
    trace = poisson_trace(
        n=scale.n, rate_rps=scale.rate_rps, seed=scale.seed,
        isl=scale.isl, osl=scale.osl, workload="structured",
    )
    trace.records = [
        dataclasses.replace(
            r, sampling=dict(_SAMPLING_CYCLE[i % len(_SAMPLING_CYCLE)])
        )
        for i, r in enumerate(trace.records)
    ]
    trace.meta["sampling_cycle"] = len(_SAMPLING_CYCLE)
    engine, cfg = _engine(scale)
    # each sampling variant takes its own path (seeded sampling,
    # penalties, logprob gathers; its own decode graph key on the card) —
    # pay them before the measured replay like every other scenario's
    # warmup does
    rng = np.random.RandomState(192837465)
    for s in _SAMPLING_CYCLE:
        await _serve_direct(
            engine,
            rng.randint(1, cfg.vocab_size, size=scale.isl).tolist(),
            4,
            sampling=SamplingOptions.from_dict(dict(s))
            if s else SamplingOptions(greedy=True),
        )
    return await _run_engine_scenario(
        "structured", scale, trace, engine, cfg,
        sampling_cycle=len(_SAMPLING_CYCLE),
    )


# --------------------------------------------------- fleet-proof adapters

def _fleet_unported(name: str, script: str):
    raise NotImplementedError(
        f"scenario {name!r}: the fleet proof ({script}) runs on the hub, the "
        "distributed runtime and real workers, which are not ported to "
        "dynamo_tpu_torch yet (ROADMAP M17)"
    )


@scenario(
    "prefix_fleet", "shared_prefix_fleet",
    "FLEET shared-prefix proof: hub + two real workers + the KV-aware "
    "router with live events, cross-worker prefix pulls "
    "(scripts/prefix_fleet.py, thin adapter)",
    fleet=True,
)
async def prefix_fleet_scenario(scale: Scale) -> dict:
    _fleet_unported("prefix_fleet", "scripts/prefix_fleet.py")


@scenario(
    "control_chaos", "control",
    "FLEET control-loop proof: supervisor-spawned workers, load spike + "
    "injected worker death, SLO-attainment-fed planner recovery "
    "(scripts/control_chaos.py, thin adapter)",
    fleet=True,
)
async def control_chaos_scenario(scale: Scale) -> dict:
    _fleet_unported("control_chaos", "scripts/control_chaos.py")


@scenario(
    "failover", "request_failover",
    "FLEET request-failover proof: hub + real workers + the journaled "
    "replay plane; worker.die severs the serving data plane mid-stream "
    "and every greedy SSE stream must complete byte-identical "
    "(scripts/failover_chaos.py, thin adapter)",
    fleet=True,
)
async def failover_scenario(scale: Scale) -> dict:
    _fleet_unported("failover", "scripts/failover_chaos.py")
