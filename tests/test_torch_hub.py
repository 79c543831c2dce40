"""The port's hub (`dynamo_tpu_torch/runtime/hub`) against the JAX
package's: the cases of tests/test_hub.py on the port's server and client
(KV with revisions, create-if-absent, prefix watches, lease expiry at a
short TTL and the threaded keepalive through a stalled loop, pub/sub with
wildcards, FIFO queues with blocking pops, the object store), and one
script of operations run across the packages: the port's client on the JAX
server and the JAX client on the port's server give the results each
package gives alone. Exact: every result compares with `==`."""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time

from dynamo_tpu.runtime.hub.client import HubClient as RefHubClient
from dynamo_tpu.runtime.hub.server import HubServer as RefHubServer
from dynamo_tpu.runtime.hub.server import subject_matches as ref_subject_matches
from dynamo_tpu_torch.runtime.hub import HubClient, HubServer
from dynamo_tpu_torch.runtime.hub.server import subject_matches
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

WAIT = 3.0  # every socket wait is bounded


@contextlib.asynccontextmanager
async def hub_pair(server_cls=HubServer, client_cls=HubClient):
    server = server_cls()
    await server.start("127.0.0.1", 0)
    client = await asyncio.wait_for(client_cls.connect(f"127.0.0.1:{server.port}"), WAIT)
    try:
        yield server, client
    finally:
        await client.close()
        await server.stop()


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def test_kv_put_get_del_and_create():
    async def go():
        async with hub_pair() as (_, c):
            rev1 = await c.kv_put("/a/b", b"one")
            rev2 = await c.kv_put("/a/c", b"two")
            assert rev2 > rev1
            assert (await c.kv_get("/a/b"))["value"] == b"one"
            assert {i["key"] for i in await c.kv_get_prefix("/a/")} == {"/a/b", "/a/c"}
            assert await c.kv_del("/a/b") == 1
            assert await c.kv_get("/a/b") is None
            assert await c.kv_del("/a/", prefix=True) == 1
            assert await c.kv_create("/x", b"1") is True
            assert await c.kv_create("/x", b"2") is False
            assert (await c.kv_get("/x"))["value"] == b"1"
            assert await c.kv_create_or_validate("/x", b"1") is True
            assert await c.kv_create_or_validate("/x", b"9") is False
            assert await c.ping() == "pong"

    run(go())


def test_watch_prefix_events_and_racing_puts():
    async def go():
        async with hub_pair() as (_, c):
            await c.kv_put("/svc/a", b"A")
            watch = await c.watch_prefix("/svc/")
            assert [e["key"] for e in watch.snapshot] == ["/svc/a"]
            await c.kv_put("/svc/b", b"B")
            ev = await watch.next(timeout=WAIT)
            assert ev["type"] == "put" and ev["key"] == "/svc/b" and ev["value"] == b"B"
            await c.kv_del("/svc/a")
            ev = await watch.next(timeout=WAIT)
            assert ev["type"] == "delete" and ev["key"] == "/svc/a"
            await watch.cancel()
            await c.kv_put("/svc/c", b"C")
            assert await watch.next(timeout=0.2) is None
            # a put right after the watch reply is delivered (the queue is
            # registered before the request goes out)
            for i in range(10):
                w = await c.watch_prefix(f"/race{i}/")
                await c.kv_put(f"/race{i}/k", b"v")
                ev = await w.next(timeout=WAIT)
                assert ev is not None and ev["key"] == f"/race{i}/k"
                await w.cancel()
            assert not c._pushes

    run(go())


def test_lease_expiry_deletes_keys_and_fires_watch():
    async def go():
        async with hub_pair() as (server, c1):
            c2 = await HubClient.connect(f"127.0.0.1:{server.port}")
            try:
                watch = await c2.watch_prefix("/ep/")
                lease = await c1.lease_grant(ttl=0.5, keepalive=False)
                await c1.kv_put("/ep/worker1", b"addr", lease=lease)
                ev = await watch.next(timeout=WAIT)
                assert ev["type"] == "put" and ev["key"] == "/ep/worker1"
                ev = await watch.next(timeout=WAIT)  # no keepalive: ~0.5 s + a tick
                assert ev["type"] == "delete" and ev["key"] == "/ep/worker1"
                assert await c2.kv_get("/ep/worker1") is None
                assert await lease.is_valid() is False
                # a kept-alive lease outlives several TTLs, then revokes
                kept = await c1.lease_grant(ttl=0.4)
                await c1.kv_put("/ka/k", b"v", lease=kept)
                await asyncio.sleep(1.0)
                assert (await c1.kv_get("/ka/k"))["value"] == b"v"
                await kept.revoke()
                assert await c1.kv_get("/ka/k") is None
            finally:
                await c2.close()

    run(go())


def test_threaded_keepalive_survives_a_stalled_loop():
    """The hub serves from a thread of its own; the client's loop blocks
    for three TTLs: the lease kept alive by the keepalive thread survives,
    one kept alive on the stalled loop expires."""
    server, ready, loop = HubServer(), threading.Event(), asyncio.new_event_loop()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start("127.0.0.1", 0))
        ready.set()
        loop.run_forever()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    assert ready.wait(WAIT)

    async def go():
        client = await HubClient.connect(f"127.0.0.1:{server.port}")
        try:
            lease = await client.lease_grant(ttl=0.5, keepalive="thread")
            await client.kv_put("/stall/key", b"x", lease=lease)
            time.sleep(1.5)  # a synchronous stall of three TTLs
            assert await lease.is_valid()
            assert await client.kv_get("/stall/key") is not None
            on_loop = await client.lease_grant(ttl=0.5, keepalive=True)
            time.sleep(1.5)
            assert not await on_loop.is_valid()
        finally:
            await client.close()

    try:
        run(go())
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(WAIT)
        loop.call_soon_threadsafe(loop.stop)
        t.join(WAIT)
        loop.close()


def test_pubsub_with_wildcards():
    for pattern, subject in [("a.b", "a.b"), ("a.b", "a.b.c"), ("a.>", "a.b.c"), ("a.>", "a"),
                             ("a.>", "ab.c"), ("ns.comp.>", "ns.comp.kv_events"), (">", "x")]:
        assert subject_matches(pattern, subject) == ref_subject_matches(pattern, subject)

    async def go():
        async with hub_pair() as (server, pub):
            sub_c = await HubClient.connect(f"127.0.0.1:{server.port}")
            try:
                exact = await sub_c.subscribe("ns.comp.kv_events")
                wild = await sub_c.subscribe("ns.>")
                assert await pub.publish("ns.comp.kv_events", b"ev1") == 2
                e1 = await exact.next(timeout=WAIT)
                assert e1 == {"subject": "ns.comp.kv_events", "data": b"ev1"}
                assert (await wild.next(timeout=WAIT))["data"] == b"ev1"
                await exact.unsubscribe()
                assert await pub.publish("ns.comp.kv_events", b"ev2") == 1
                assert await pub.publish("other.subject", b"ev3") == 0
            finally:
                await sub_c.close()

    run(go())


def test_queues_fifo_blocking_pop_and_dead_consumer():
    async def go():
        async with hub_pair() as (server, c1):
            c2 = await HubClient.connect(f"127.0.0.1:{server.port}")
            try:
                assert await c1.q_pop("prefill") is None
                await c1.q_push("prefill", b"r1")
                await c1.q_push("prefill", b"r2")
                assert await c1.q_len("prefill") == 2
                assert await c2.q_pop("prefill") == b"r1"
                assert await c2.q_pop("prefill") == b"r2"
                pop = asyncio.create_task(c2.q_pop("prefill", block=True, timeout=WAIT))
                await asyncio.sleep(0.05)
                await c1.q_push("prefill", b"r3")
                assert await pop == b"r3"
                assert await c2.q_pop("prefill", block=True, timeout=0.1) is None
                # a waiter whose connection died must not swallow an item
                dead = await HubClient.connect(f"127.0.0.1:{server.port}")
                task = asyncio.create_task(dead.q_pop("jobs", block=True, timeout=30))
                await asyncio.sleep(0.1)
                await dead.close()
                task.cancel()
                await asyncio.sleep(0.1)
                await c1.q_push("jobs", b"job1")
                assert await c2.q_pop("jobs", block=True, timeout=WAIT) == b"job1"
            finally:
                await c2.close()

    run(go())


def test_object_store():
    async def go():
        async with hub_pair() as (_, c):
            blob = bytes(range(256)) * 100
            await c.obj_put("mdc", "tokenizer.json", blob)
            assert await c.obj_get("mdc", "tokenizer.json") == blob
            assert await c.obj_list("mdc") == ["tokenizer.json"]
            assert await c.obj_del("mdc", "tokenizer.json") is True
            assert await c.obj_get("mdc", "tokenizer.json") is None

    run(go())


async def _script(server_cls, client_cls) -> list:
    """One fixed sequence of every op kind, its results in order (lease
    ids and revisions are deterministic on a fresh server)."""
    out = []
    async with hub_pair(server_cls, client_cls) as (server, c):
        other = await client_cls.connect(f"127.0.0.1:{server.port}")
        try:
            watch = await other.watch_prefix("/w/")
            sub = await other.subscribe("ns.>")
            out.append(await c.kv_put("/w/a", b"\x00\x01" * 40))
            out.append(await c.kv_put("/w/b", "é".encode() * 40))
            out.append(await c.kv_get("/w/a"))
            out.append(await c.kv_get_prefix("/w/"))
            out.append(await c.kv_create("/w/a", b"no"))
            out.append(await c.kv_create_or_validate("/w/c", b"c"))
            lease = await c.lease_grant(ttl=0.3, keepalive=False)
            out.append((lease.lease_id, lease.ttl))
            out.append(await c.kv_create("/w/leased", b"L", lease=lease))
            out.append(await c.publish("ns.comp.kv_events", b"\xff" * 300))
            out.append(await c.publish("nope", b"x"))
            out.append(await c.q_push("q", b"1"))
            out.append(await c.q_push("q", b"2"))
            out.append(await c.q_pop("q"))
            out.append(await c.q_len("q"))
            out.append(await c.obj_put("mdc", "t.json", b"{}" * 1000))
            out.append(await c.obj_list("mdc"))
            out.append(await c.kv_del("/w/", prefix=True))
            out.append(await sub.next(timeout=WAIT))
            await asyncio.sleep(0.8)  # the lease expires: its key is gone already
            out.append(await lease.is_valid())
            out.append(await c.stats())
            events = []
            while (ev := await watch.next(timeout=0.3)) is not None:
                events.append(ev)
            out.append(events)
        finally:
            await other.close()
    return out


def test_script_gives_the_same_results_across_the_packages():
    async def go():
        return {(s.__module__.split(".")[0], c.__module__.split(".")[0]): await _script(s, c)
                for s in (HubServer, RefHubServer) for c in (HubClient, RefHubClient)}

    got = run(go())
    want = got[("dynamo_tpu", "dynamo_tpu")]
    assert want[-1] and want[2]["value"] == b"\x00\x01" * 40
    for key, results in got.items():
        assert results == want, key
