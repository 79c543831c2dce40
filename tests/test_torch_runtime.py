"""The port's distributed runtime (`dynamo_tpu_torch/runtime`: the data
plane, components, clients, the distributed runtime and its resilience
primitives) against the JAX package's: the cases of tests/test_runtime.py
on the port (serve, discover and generate; round robin and direct; lease
expiry removing an instance and firing the instance-down hook;
cancellation reaching the server; the missing-endpoint prologue error;
engine exceptions as stream errors; the stats scrape), `Backoff` and
`CircuitBreaker` against the reference's under one seeded
`random.Random` and a fake clock, the addressing and instance records
byte-equal, and a JAX client streaming from a port endpoint and a port
client from a JAX endpoint with the same frames, byte for byte. Exact:
everything compares with `==`. Lease TTLs are at most 1 s and every socket
wait is bounded."""

from __future__ import annotations

import asyncio
import contextlib
import random

import pytest

from dynamo_tpu.runtime import resilience as ref_resilience
from dynamo_tpu.runtime.component import EndpointId as RefEndpointId
from dynamo_tpu.runtime.component import InstanceInfo as RefInstanceInfo
from dynamo_tpu.runtime.distributed import DistributedRuntime as RefDRT
from dynamo_tpu.runtime.hub.server import HubServer as RefHubServer
from dynamo_tpu.runtime.pipeline.engine import LambdaEngine as RefLambdaEngine
from dynamo_tpu_torch.runtime import resilience
from dynamo_tpu_torch.runtime.client import NoInstancesError
from dynamo_tpu_torch.runtime.component import EndpointId, InstanceInfo, pack_payload
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import HubServer
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.runtime.pipeline.engine import LambdaEngine
from dynamo_tpu_torch.runtime.runtime import CancellationToken
from dynamo_tpu_torch.utils import counters
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

WAIT = 5.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


@contextlib.asynccontextmanager
async def hub(server_cls=HubServer):
    server = server_cls()
    await server.start("127.0.0.1", 0)
    try:
        yield f"127.0.0.1:{server.port}"
    finally:
        await server.stop()


@contextlib.asynccontextmanager
async def drt_on(addr, drt_cls=DistributedRuntime):
    drt = await asyncio.wait_for(drt_cls.from_settings(hub_addr=addr), WAIT)
    try:
        yield drt
    finally:
        await drt.shutdown()


def echo_engine(engine_cls=LambdaEngine):
    async def _gen(ctx):
        for tok in ctx.payload["text"].split():
            yield {"token": tok, "request_id": ctx.id}

    return engine_cls(_gen)


async def client_of(drt, ns, comp, n=1):
    client = await drt.namespace(ns).component(comp).endpoint("generate").client()
    await client.wait_for_instances(timeout=WAIT)
    for _ in range(100):  # the watch may deliver a second instance later
        if len(client.instances) >= n:
            break
        await asyncio.sleep(0.02)
    assert len(client.instances) == n
    return client


def test_serve_discover_generate_round_robin_and_direct():
    async def go():
        async with hub() as addr, drt_on(addr) as w1, drt_on(addr) as w2, drt_on(addr) as fe:
            served = await w1.namespace("test").component("backend").endpoint(
                "generate").serve_engine(echo_engine())
            client = await client_of(fe, "test", "backend")
            ctx = Context({"text": "hello port world"})
            out = [i async for i in await client.generate(ctx.payload, context=ctx)]
            assert [o["token"] for o in out] == ["hello", "port", "world"]
            assert all(o["request_id"] == ctx.id for o in out)
            assert ctx.metadata["served_by"] == served.instance.worker_id
            await served.shutdown()
            await client.close()

            def tagged(tag):
                async def _gen(ctx):
                    yield {"worker": tag}

                return LambdaEngine(_gen)

            for drt, tag in ((w1, "a"), (w2, "b")):
                await drt.namespace("t").component("c").endpoint("generate").serve_engine(
                    tagged(tag))
            client = await client_of(fe, "t", "c", n=2)
            seen = [[i async for i in await client.round_robin({})][0]["worker"]
                    for _ in range(4)]
            assert sorted(set(seen)) == ["a", "b"] and seen[0] != seen[1]
            for wid in client.instance_ids():
                out = [i async for i in await client.direct({}, instance_id=wid)]
                assert out == [{"worker": "a" if wid == w1.worker_id else "b"}]
            await client.close()

    run(go())


def test_lease_expiry_removes_instance_and_fires_the_hook():
    async def go():
        async with hub() as addr, drt_on(addr) as worker, drt_on(addr) as fe:
            down = []
            fe.on_instance_down(lambda eid, wid: down.append((eid.subject, wid)))
            ep = worker.namespace("t").component("dying").endpoint("generate")
            lease = await worker.hub.lease_grant(ttl=0.5, keepalive=False)
            await ep.endpoint_builder().engine(echo_engine()).lease(lease).start()
            client = await client_of(fe, "t", "dying")
            for _ in range(40):
                if not client.instances:
                    break
                await asyncio.sleep(0.1)
            assert client.instances == {}
            assert down == [("t.dying.generate", lease.lease_id)]
            with pytest.raises(NoInstancesError):
                await client.generate({"text": "x"})
            await client.close()

    run(go())


def test_cancellation_reaches_the_server():
    async def go():
        async with hub() as addr, drt_on(addr) as worker, drt_on(addr) as fe:
            saw_stop = asyncio.Event()

            async def _slow(ctx):
                for i in range(1000):
                    if ctx.is_stopped():
                        saw_stop.set()
                        return
                    yield {"i": i}
                    await asyncio.sleep(0.01)

            await worker.namespace("t").component("slow").endpoint("generate").serve_engine(
                LambdaEngine(_slow))
            client = await client_of(fe, "t", "slow")
            ctx = Context({})
            got = 0
            async for _ in await client.generate({}, context=ctx):
                got += 1
                if got == 3:
                    ctx.stop_generating()
                    break
            await asyncio.wait_for(saw_stop.wait(), WAIT)
            await client.close()

    run(go())


def test_prologue_error_stream_error_and_stats_scrape():
    async def go():
        async with hub() as addr, drt_on(addr) as worker, drt_on(addr) as fe:
            async def _fail(ctx):
                yield {"ok": 1}
                raise ValueError("engine exploded")

            await (worker.namespace("t").component("real").endpoint("generate")
                   .endpoint_builder().engine(LambdaEngine(_fail))
                   .stats_handler(lambda: {"kv_active_blocks": 7}).start())
            client = await client_of(fe, "t", "real")
            info = next(iter(client.instances.values()))
            with pytest.raises(RuntimeError, match="no endpoint"):
                await fe.data_plane_client.request(info.address, "t.bogus.generate", b"\xc0")
            items = []
            with pytest.raises(RuntimeError, match="engine exploded"):
                async for item in await client.generate({}):
                    items.append(item)
            assert items == [{"ok": 1}]
            assert await client.scrape_stats() == {info.worker_id: {"kv_active_blocks": 7}}
            await client.close()

    run(go())


def test_backoff_matches_the_reference():
    for kw in (dict(), dict(base=0.05, cap=1.0), dict(base=1.0, cap=10.0, factor=3.0)):
        ours = resilience.Backoff(rng=random.Random(7), **kw)
        theirs = ref_resilience.Backoff(rng=random.Random(7), **kw)
        for attempt in range(10):
            assert ours.delay(attempt) == theirs.delay(attempt)
        now = 1000.0
        for hint, deadline in ((None, None), (2.0, None), (5.0, now + 1.0), (0.5, now + 10.0),
                               (None, now - 1.0)):
            assert (ours.delay_hinted(1, hint, deadline, now)
                    == theirs.delay_hinted(1, hint, deadline, now))


def test_circuit_breaker_matches_the_reference():
    t = [0.0]
    opened = {"ours": 0, "theirs": 0}
    ours = resilience.CircuitBreaker(threshold=3, cooldown_s=5.0, clock=lambda: t[0],
                                     on_open=lambda: opened.__setitem__("ours", opened["ours"] + 1))
    theirs = ref_resilience.CircuitBreaker(
        threshold=3, cooldown_s=5.0, clock=lambda: t[0],
        on_open=lambda: opened.__setitem__("theirs", opened["theirs"] + 1))
    rng = random.Random(11)
    counters.reset()
    for _ in range(400):
        op = rng.choice(("fail", "fail", "ok", "allow", "tick"))
        if op == "tick":
            t[0] += rng.choice((0.5, 2.0, 5.0))
            got = want = None
        elif op == "allow":
            got, want = ours.allow(), theirs.allow()
        else:
            for br in (ours, theirs):
                br.record_failure() if op == "fail" else br.record_success()
            got = want = None
        assert got == want and ours.state == theirs.state
    assert opened["ours"] == opened["theirs"] > 0
    counters.reset()


def test_addressing_tokens_and_records_match_the_reference():
    for path in ("dyn://demo.backend.generate", "demo.backend", "ns.c.ep"):
        ours, theirs = EndpointId.parse(path), RefEndpointId.parse(path)
        assert (ours.subject, ours.instance_root, str(ours)) == (
            theirs.subject, theirs.instance_root, str(theirs))
    for bad in ("a", "a.b.c.d"):
        with pytest.raises(ValueError):
            EndpointId.parse(bad)
    kw = dict(endpoint="ns.c.ep", address="127.0.0.1:5", worker_id=0x1234, lease_id=0x1234,
              metadata={"instance": "w-1", "n": [1, 2.5, None]})
    assert InstanceInfo(**kw).pack() == RefInstanceInfo(**kw).pack()
    assert InstanceInfo.unpack(RefInstanceInfo(**kw).pack()) == InstanceInfo(**kw)
    root = CancellationToken()
    child = root.child_token()
    grand = child.child_token()
    child.detach()
    root.cancel()
    assert root.is_cancelled() and not child.is_cancelled()
    child.cancel()
    assert grand.is_cancelled() and CancellationToken(child).is_cancelled()


async def _frames(addr, client_drt_cls, endpoint="x.y.generate"):
    """The raw payload frames of one stream, through the data plane."""
    async with drt_on(addr, client_drt_cls) as fe:
        client = await client_of(fe, "x", "y")
        info = next(iter(client.instances.values()))
        handle = await fe.data_plane_client.request(
            info.address, endpoint, pack_payload({"text": "a bb ccc " + "é" * 40}),
            request_id="req-1", metadata={"kv_seq_hashes": [2**64 - 1, 7]})
        raw = [r async for r in handle]
        typed = [i async for i in await client.generate({"text": "one two"},
                                                         context=Context({"text": "one two"}))]
        await client.close()
        return raw, [{k: v for k, v in i.items() if k != "request_id"} for i in typed]


def test_streams_cross_the_packages_with_the_same_frames():
    async def one(server_cls, worker_drt_cls, engine_cls, client_drt_cls):
        async with hub(server_cls) as addr, drt_on(addr, worker_drt_cls) as worker:
            await worker.namespace("x").component("y").endpoint("generate").serve_engine(
                echo_engine(engine_cls))
            return await _frames(addr, client_drt_cls)

    async def go():
        port = (HubServer, DistributedRuntime, LambdaEngine)
        ref = (RefHubServer, RefDRT, RefLambdaEngine)
        return {
            "port->port": await one(*port, DistributedRuntime),
            "jax client, port worker": await one(*port, RefDRT),
            "port client, jax worker": await one(*ref, DistributedRuntime),
            "jax->jax": await one(*ref, RefDRT),
        }

    got = run(go())
    want = got["jax->jax"]
    assert want[1] == [{"token": "one"}, {"token": "two"}] and len(want[0]) == 4
    for key, frames in got.items():
        assert frames == want, key
