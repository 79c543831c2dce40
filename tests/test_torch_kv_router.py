"""The port's KV-aware router (`dynamo_tpu_torch/llm/kv_router`) and model
discovery (`llm/http/discovery.py`) against the JAX package's.

- `RadixTree` on one seeded random event stream (device and host tiers,
  removals, a worker removed) against the reference's tree: the same
  `find_matches` for every query and the same nodes;
- `DefaultWorkerSelector` against the reference's, each with a
  `random.Random` of the same seed: the same decisions, ties included;
- the aggregator's stale horizon and the router's health filter;
- the e2e of tests/test_kv_router.py on two CPU `TorchEngine` workers on
  the vendored trained checkpoint: the second request routes to the holder
  with 2 overlap blocks and 16 cached tokens and an unchanged stream; the
  reference's `KvIndexer`, subscribed to the port's hub, builds the tree
  the port's indexer builds from the port publisher's events; when the
  holder dies its blocks are purged;
- `ModelWatcher` in kv mode behind the port's `HttpService`: the second
  request rides the first's cache;
- the slice as a whole: one traffic of prefix-sharing requests through
  the port's fleet (port hub, `KvPushRouter`, `TorchEngine` workers) and
  the reference's (JAX hub, `KvPushRouter`, `JaxEngine` workers on
  gather attention), f32: the same worker (by registration order), the
  same overlap blocks and the same greedy stream for every request.

Routing decisions, trees and greedy streams are exact. One engine pair per
package serves the module's cases on one event loop the module keeps; each
case clears the caches first and registers the engines on a hub of its own.
"""

from __future__ import annotations

import asyncio
import random
import time

import pytest

from dynamo_tpu.llm import kv_router as ref
from dynamo_tpu.llm.kv_router import indexer as ref_indexer
from dynamo_tpu.llm.kv_router import protocols as ref_protocols
from dynamo_tpu_torch.llm import kv_router as port
from dynamo_tpu_torch.llm.kv_router import indexer as port_indexer
from dynamo_tpu_torch.llm.kv_router import protocols as port_protocols
from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvMetricsAggregator
from tests.test_torch_engine import CKPT
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

PAGE = 8
ENGINE_KW = dict(page_size=PAGE, num_pages=64, max_batch_size=2, max_model_len=128,
                 prefill_chunk=32, decode_steps=4, seed=0, step_pipeline=False)
WAIT = 10.0
# the fleets' selector seed: its first two tie-breaks pick different workers,
# so the two prompt groups of `_traffic` land on different workers
SELECTOR_SEED = 4


# ------------------------------------------------------------ tree, selector


def _events(protocols, rng_seed=3, n=400):
    """A seeded stream of stored/removed events over 3 workers and 2 tiers:
    chains of 1-6 blocks drawn from 40 hashes, about a third removals."""
    rng = random.Random(rng_seed)
    out = []
    for i in range(n):
        worker = rng.choice([0x1000, 0x1001, 0x1002])
        tier = rng.choice(["device", "device", "host"])
        if rng.random() < 0.35:
            ev = protocols.KvCacheEvent(type="removed", event_id=i, tier=tier,
                                        block_hashes=rng.sample(range(40), rng.randint(1, 4)))
        else:
            chain = rng.sample(range(40), rng.randint(1, 6))
            ev = protocols.KvCacheEvent(
                type="stored", event_id=i, tier=tier, block_size=PAGE,
                parent_hash=rng.choice([None, rng.randrange(40)]),
                blocks=[protocols.StoredBlock(block_hash=h, tokens_hash=h ^ 1) for h in chain])
        out.append(protocols.RouterEvent(worker_id=worker, event=ev))
    return out


def _nodes(tree):
    return ({h: ({w: sorted(t) for w, t in n.workers.items()}, n.parent)
             for h, n in tree._nodes.items()},
            {w: sorted(b) for w, b in tree._worker_blocks.items() if b})


def test_radix_tree_matches_the_reference_on_a_random_stream():
    ours, theirs = port_indexer.RadixTree(), ref_indexer.RadixTree()
    rng = random.Random(5)
    queries = [rng.sample(range(40), rng.randint(1, 8)) for _ in range(60)]
    for k, (a, b) in enumerate(zip(_events(port_protocols), _events(ref_protocols))):
        assert a.to_dict() == b.to_dict()
        ours.apply_event(port_protocols.RouterEvent.from_dict(b.to_dict()))
        theirs.apply_event(b)
        if k == 250:
            ours.remove_worker(0x1001)
            theirs.remove_worker(0x1001)
        if k % 25 == 0:
            for q in queries:
                assert ours.find_matches(q).__dict__ == theirs.find_matches(q).__dict__
    assert _nodes(ours) == _nodes(theirs) and ours.num_blocks > 0
    assert ours.workers() == theirs.workers() and ours.event_count == theirs.event_count


def test_selector_decisions_match_the_reference():
    rng = random.Random(9)
    for weight in (0.5, 0.0, 1.0):
        ours = port.DefaultWorkerSelector(rng=random.Random(1), host_tier_weight=weight)
        theirs = ref.DefaultWorkerSelector(rng=random.Random(1), host_tier_weight=weight)
        for _ in range(300):
            ids = rng.sample(range(0x1000, 0x1008), rng.randint(1, 5))
            metrics = [dict(request_active_slots=rng.choice([0, 0, 1, 2, 4]),
                            request_total_slots=4,
                            gpu_cache_usage_perc=rng.choice([0.0, 0.0, 0.25, 0.5, 0.9]))
                       for _ in ids]
            scores = {w: rng.choice([0, 1, 2, 3]) for w in ids}
            host = {w: rng.randint(0, s) for w, s in scores.items() if rng.random() < 0.3}
            args = []
            for mod in (port, ref):
                ov = mod.OverlapScores(scores=dict(scores), host_scores=dict(host))
                args.append(({w: mod.ForwardPassMetrics(**m) for w, m in zip(ids, metrics)},
                             ov, rng.choice([16, 24, 32, 40])))
            isl = args[1][2]
            a = ours.select(args[0][0], args[0][1], isl, PAGE)
            b = theirs.select(args[1][0], args[1][1], isl, PAGE)
            assert a.__dict__ == b.__dict__


def test_aggregator_stale_horizon_and_the_health_filter():
    agg = KvMetricsAggregator(client=None, poll_interval=1.0)
    assert agg.stale_after == 3.0
    assert agg.stale_workers([1, 2]) == set() and set(agg.last_seen) == {1, 2}
    agg.last_seen[1] = time.monotonic() - 10.0
    agg.last_seen[2] = time.monotonic()
    assert agg.stale_workers([1, 2]) == {1}
    agg.mark_gone(1)
    assert agg.stale_workers([1]) == set()

    class Client:
        open: set = set()

        def instance_ids(self):
            return [1, 2, 3]

        def breaker_open(self, wid):
            return wid in self.open

    router = port.KvRouter(component=None, client=Client(), block_size=4)
    assert router._healthy_candidates([1, 2, 3]) == [1, 2, 3]
    now = time.monotonic()
    router.aggregator.last_seen.update({1: now - 99.0, 2: now, 3: now})
    assert router._healthy_candidates([1, 2, 3]) == [2, 3]
    router.client.open = {2}
    assert router._healthy_candidates([1, 2, 3]) == [3]
    router.client.open = {2, 3}
    assert router._healthy_candidates([1, 2, 3]) == [1, 2, 3]
    with pytest.raises(NotImplementedError, match="pull.py"):
        port.KvRouter(component=None, client=Client(), pull_threshold_tokens=64)


# ------------------------------------------------------------------ fleets


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, 120))


class Pkg:
    """One package's fleet classes and two engines on the checkpoint."""

    def __init__(self, jax: bool):
        if jax:
            from dynamo_tpu.engine import EngineConfig, JaxEngine
            from dynamo_tpu.llm.local_model import LocalModel
            from dynamo_tpu.llm.protocols import common
            from dynamo_tpu.runtime.distributed import DistributedRuntime
            from dynamo_tpu.runtime.hub.server import HubServer

            self.engines = [JaxEngine(EngineConfig(
                model=LocalModel.prepare(CKPT).model_cfg, checkpoint_dir=CKPT,
                dtype="float32", attn_backend="gather", **ENGINE_KW)) for _ in range(2)]
            self.kv = ref
        else:
            from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
            from dynamo_tpu_torch.llm.protocols import common
            from dynamo_tpu_torch.models.weights import load_config
            from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
            from dynamo_tpu_torch.runtime.hub.server import HubServer

            self.engines = [TorchEngine(EngineConfig(
                model=load_config(CKPT), checkpoint_dir=CKPT, dtype="float32", **ENGINE_KW),
                device="cpu") for _ in range(2)]
            self.kv = port
        self.common, self.DRT, self.HubServer = common, DistributedRuntime, HubServer
        self.emitted = [[], []]
        for eng, log in zip(self.engines, self.emitted):
            eng.subscribe_events(log.append)

    def request(self, ids, n=4):
        c = self.common
        return c.PreprocessedRequest(
            token_ids=list(ids), stop_conditions=c.StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=c.SamplingOptions(greedy=True)).to_dict()


class Fleet:
    """A hub, the package's two engines registered as workers (publisher
    attached first, stats handler), and a frontend runtime with a client
    and a KvPushRouter (seeded selector, no polling after the first scrape,
    so decisions depend on the overlaps alone)."""

    def __init__(self, pkg: Pkg):
        self.pkg = pkg

    async def start(self, hub_addr=None, register=None):
        pkg = self.pkg
        for eng in pkg.engines:
            eng.allocator.clear_cache()
        for log in pkg.emitted:
            log.clear()
        self.server = None
        if hub_addr is None:
            self.server = pkg.HubServer()
            await self.server.start("127.0.0.1", 0)
            hub_addr = f"127.0.0.1:{self.server.port}"
        self.hub_addr = hub_addr
        self.workers, self.publishers = [], []
        for eng in pkg.engines:
            drt = await pkg.DRT.from_settings(hub_addr=hub_addr)
            ep = drt.namespace("demo").component("backend").endpoint("generate")
            pub = pkg.kv.KvEventPublisher(ep.component, drt.primary_lease.lease_id).attach(eng)
            pub.start()
            stats = pkg.kv.KvMetricsPublisher.for_engine(eng).stats_handler
            if register is not None:
                await register(drt, eng, stats)
            else:
                await ep.serve_engine(eng, stats_handler=stats)
            self.workers.append(drt)
            self.publishers.append(pub)
        self.ids = [d.primary_lease.lease_id for d in self.workers]
        self.frontend = await pkg.DRT.from_settings(hub_addr=hub_addr)
        ep = self.frontend.namespace("demo").component("backend").endpoint("generate")
        self.client = await ep.client()
        for _ in range(200):
            if len(self.client.instances) == 2:
                break
            await asyncio.sleep(0.01)
        router = pkg.kv.KvRouter(
            ep.component, self.client, block_size=PAGE, poll_interval=3600.0,
            selector=pkg.kv.DefaultWorkerSelector(rng=random.Random(SELECTOR_SEED)))
        await router.start()
        self.decisions, schedule = [], router.schedule

        async def recorded(*args, **kw):
            self.decisions.append(await schedule(*args, **kw))
            return self.decisions[-1]

        router.schedule = recorded
        self.router = pkg.kv.KvPushRouter(self.client, router)
        return self

    async def settle(self, indexers=()):
        """Wait until every event both engines emitted was applied."""
        for _ in range(int(WAIT / 0.01)):
            n = sum(len(log) for log in self.pkg.emitted)
            if all(ix.tree.event_count >= n for ix in (self.router.router.indexer, *indexers)):
                return
            await asyncio.sleep(0.01)
        raise AssertionError("KV events did not reach the indexer")

    async def serve(self, ids, n=4):
        toks, meta = [], None
        async for f in await self.router.generate(self.pkg.request(ids, n)):
            toks.extend(f.get("token_ids") or [])
            if meta is None and f.get("meta"):
                meta = f["meta"]
        await self.settle()
        return toks, meta, self.decisions[-1]

    async def stop(self):
        for eng, pub in zip(self.pkg.engines, self.publishers):
            eng._event_subscribers.remove(pub.on_event)
            await pub.close()
        await self.router.router.close()
        await self.client.close()
        for drt in [self.frontend, *self.workers]:
            try:
                await drt.shutdown()
            except Exception:  # noqa: BLE001 — a worker the case already shut down
                pass
        if self.server is not None:
            await self.server.stop()


@pytest.fixture(scope="module")
def pkgs(loop):
    made = {}

    def get(jax: bool) -> Pkg:
        if jax not in made:
            async def build():
                return Pkg(jax)

            made[jax] = loop.run_until_complete(build())
        return made[jax]

    yield get
    for pkg in made.values():
        for eng in pkg.engines:
            loop.run_until_complete(eng.close())


def test_e2e_two_workers_route_to_the_holder(loop, pkgs):
    pkg = pkgs(False)

    async def go():
        fleet = await Fleet(pkg).start()
        ref_drt = await ref_drt_on(fleet.hub_addr)
        theirs = ref_indexer.KvIndexer(
            ref_drt.namespace("demo").component("backend"), PAGE)
        await theirs.start()
        try:
            prompt = list(range(10, 30))  # 2 full pages + a tail
            toks1, meta1, _ = await fleet.serve(prompt)
            assert meta1["prefix_cached_tokens"] == 0 and len(toks1) == 4
            decision = await fleet.router.router.schedule(prompt)
            assert decision.overlap_blocks == 2
            toks2, meta2, _ = await fleet.serve(prompt)
            assert meta2["prefix_cached_tokens"] == 16 and toks2 == toks1
            await fleet.settle([theirs])
            assert _nodes(theirs.tree) == _nodes(fleet.router.router.indexer.tree)
            assert fleet.router.router.indexer.tree.num_blocks >= 2
            # each publisher stamped every event its engine emitted, in order
            for pub, log in zip(fleet.publishers, pkg.emitted):
                assert [i for i, _ in pub.stored_at] == [e["event_id"] for e in log]
                assert all(a[1] <= b[1] for a, b in zip(pub.stored_at, list(pub.stored_at)[1:]))
            # the holder dies: its blocks are purged, routing goes on
            holder = decision.worker_id
            await fleet.workers[fleet.ids.index(holder)].shutdown()
            for _ in range(int(WAIT / 0.02)):
                if holder not in fleet.router.router.indexer.tree.workers():
                    break
                await asyncio.sleep(0.02)
            assert holder not in fleet.router.router.indexer.tree.workers()
            decision2 = await fleet.router.router.schedule(prompt)
            assert decision2.worker_id != holder and decision2.overlap_blocks == 0
        finally:
            await theirs.close()
            await ref_drt.shutdown()
            await fleet.stop()

    _run(loop, go())


async def ref_drt_on(hub_addr):
    from dynamo_tpu.runtime.distributed import DistributedRuntime

    return await DistributedRuntime.from_settings(hub_addr=hub_addr)


def test_model_watcher_kv_mode_behind_the_http_service(loop, pkgs):
    from dynamo_tpu_torch.llm.http import client as http
    from dynamo_tpu_torch.llm.http.discovery import ModelWatcher, register_llm
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    pkg = pkgs(False)

    async def go():
        card = ModelDeploymentCard.from_local_path(CKPT, name="tiny-fleet")
        card.kv_cache_block_size = PAGE

        async def register(drt, eng, stats):
            await register_llm(drt, eng, card, "dyn://demo.backend.generate",
                               stats_handler=stats)

        fleet = await Fleet(pkg).start(register=register)
        svc = HttpService()
        watcher = ModelWatcher(fleet.frontend, svc.manager, router_mode="kv")
        try:
            await watcher.start()
            await svc.start("127.0.0.1", 0)
            for _ in range(int(WAIT / 0.05)):
                if svc.manager.get_chat("tiny-fleet"):
                    break
                await asyncio.sleep(0.05)
            body = {"model": "tiny-fleet", "max_tokens": 6, "temperature": 0,
                    "messages": [{"role": "user", "content": "the capital of france is"}]}
            out = []
            for _ in range(2):
                reply = await http.request("127.0.0.1", svc.port, "POST",
                                           "/v1/chat/completions", body)
                assert reply.status == 200
                out.append((await reply.json())["choices"][0]["message"]["content"])
                await fleet.settle([watcher._kv_routers["tiny-fleet"].router.indexer])
            assert out[0] == out[1] and out[0]
            assert watcher._kv_routers["tiny-fleet"].router.indexer.tree.num_blocks > 0
            assert sum(e.metrics()["prefix_reused_tokens"] for e in fleet.pkg.engines) > 0
        finally:
            await watcher.stop()
            await svc.stop()
            await fleet.stop()

    _run(loop, go())


def _traffic():
    """Two groups of three prompts; each group shares a 3-page prefix,
    every prompt has a tail of its own (seeded)."""
    rng = random.Random(4)
    out = []
    for _ in range(2):
        prefix = [rng.randrange(3, 68) for _ in range(3 * PAGE)]
        out += [prefix + [rng.randrange(3, 68) for _ in range(rng.randint(3, 12))]
                for _ in range(3)]
    return [out[0], out[3], out[1], out[4], out[2], out[5]]


def test_the_fleet_routes_and_streams_as_the_reference_fleet(loop, pkgs):
    async def one(pkg):
        fleet = await Fleet(pkg).start()
        try:
            got = []
            for ids in _traffic():
                toks, meta, d = await fleet.serve(ids, n=6)
                got.append((fleet.ids.index(d.worker_id), d.overlap_blocks,
                            meta["prefix_cached_tokens"], toks))
            return got
        finally:
            await fleet.stop()

    ours = _run(loop, one(pkgs(False)))
    theirs = _run(loop, one(pkgs(True)))
    assert ours == theirs
    assert [g[1] for g in ours] == [0, 0, 3, 3, 3, 3]
    assert [g[0] for g in ours] == [0, 1, 0, 1, 0, 1]
    assert [g[2] for g in ours] == [0, 0, 24, 24, 24, 24]
