"""Hub client: async API over the hub wire protocol.

Plays the role of the reference's etcd::Client + nats::Client pair
(reference: lib/runtime/src/transports/etcd.rs:41-80, nats.rs:50-121):
request/reply with correlation ids, pushed watch/subscription events routed to
per-watch queues, and a `Lease` handle with an automatic keepalive task.
"""

from __future__ import annotations

import asyncio
import itertools
import os
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.runtime.hub import codec
from dynamo_tpu_torch.utils import counters, faults
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.hub.client")

DEFAULT_HUB_ADDR = "127.0.0.1:2379"


def hub_addr_from_env() -> str:
    return os.environ.get("DYN_HUB_ADDR", DEFAULT_HUB_ADDR)


class HubError(RuntimeError):
    pass


class KeepaliveThread:
    """Secondary runtime for lease liveness.

    The reference runs etcd/NATS background tasks on a second tokio runtime
    precisely so foreground work cannot starve them (reference:
    lib/runtime/src/runtime.rs:39-121 RuntimeType::secondary). The asyncio
    equivalent failure is real: a decode-graph capture or a prefill's host
    enqueue blocks a worker's loop, and one longer than the lease TTL would
    have the hub declare the worker dead. Keepalives therefore run on a dedicated daemon thread with its
    own event loop and its own hub connection (leases are hub-global, so a
    second connection may refresh them).
    """

    def __init__(self, addr: str):
        import threading

        self.addr = addr
        self._leases: dict[int, float] = {}  # lease_id -> ttl
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hub-keepalive"
        )
        self._thread.start()
        if not self._ready.wait(10) or self._error is not None:
            raise ConnectionError(
                f"keepalive thread failed to connect to hub {addr}: {self._error}"
            )

    def add(self, lease_id: int, ttl: float) -> None:
        with self._lock:
            self._leases[lease_id] = ttl

    def remove(self, lease_id: int) -> None:
        with self._lock:
            self._leases.pop(lease_id, None)

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._main())
        finally:
            loop.close()

    async def _main(self) -> None:
        try:
            client = await HubClient.connect(self.addr)
        except BaseException as e:  # noqa: BLE001 — surfaced to the ctor
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        try:
            while not self._stop.is_set():
                with self._lock:
                    leases = dict(self._leases)
                # idle tick 0.25s, NOT 1.0: a lease add() can land just
                # after the empty-leases read, and a short-TTL lease must
                # not wait out a whole idle second before its first
                # refresh (a ttl<=1s lease would expire unrefreshed)
                tick = min([ttl / 3.0 for ttl in leases.values()] or [0.25])
                for lease_id in leases:
                    try:
                        ok = await client.request(
                            "lease_keepalive", lease_id=lease_id
                        )
                        if not ok:
                            log.warning("lease %#x no longer valid", lease_id)
                            counters.inc("lease_expired_total")
                            self.remove(lease_id)
                    except HubError:
                        log.warning("keepalive for %#x rejected", lease_id)
                    except Exception:  # noqa: BLE001 — ANY transport-level
                        # failure must reconnect, never kill this thread:
                        # dead keepalives silently expire healthy workers
                        log.exception("keepalive connection failed; reconnecting")
                        await client.close()
                        client = await self._reconnect()
                        break
                await asyncio.sleep(tick)
        except BaseException:
            log.exception("keepalive thread died — worker leases WILL expire")
            raise
        finally:
            await client.close()

    async def _reconnect(self) -> "HubClient":
        import random

        delay = 0.2
        while not self._stop.is_set():
            try:
                client = await HubClient.connect(self.addr)
                log.info("keepalive connection re-established to %s", self.addr)
                counters.inc("hub_reconnects_total")
                return client
            except (ConnectionError, OSError):
                # full jitter: a hub restart must not see every worker's
                # keepalive thread reconnect in lockstep (thundering
                # herd) — same policy as runtime/resilience.Backoff
                await asyncio.sleep(delay * random.uniform(0.5, 1.5))
                delay = min(delay * 2, 2.0)
        raise ConnectionError("keepalive thread stopped during reconnect")


class Lease:
    """A granted lease with background keepalive.

    Keepalives are sent at ttl/3 — either as a task on the caller's loop or
    (preferred for workers doing device work) on the client's shared
    `KeepaliveThread`; `revoke()` (or hub-side expiry after the process
    dies) deletes every key attached to the lease — this is the liveness
    primitive for service discovery (reference:
    lib/runtime/src/transports/etcd.rs lease keep-alive; lease.rs).
    """

    def __init__(self, client: "HubClient", lease_id: int, ttl: float):
        self.client = client
        self.lease_id = lease_id
        self.ttl = ttl
        self._task: Optional[asyncio.Task] = None
        self._threaded = False
        self._revoked = False

    def start_keepalive(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._keepalive_loop())

    def start_keepalive_threaded(self) -> None:
        """Refresh this lease from the client's keepalive thread, immune to
        event-loop stalls (graph captures, device syncs)."""
        self.client.keepalive_thread().add(self.lease_id, self.ttl)
        self._threaded = True

    async def _keepalive_loop(self) -> None:
        try:
            while not self._revoked:
                await asyncio.sleep(self.ttl / 3.0)
                ok = await self.client.request("lease_keepalive", lease_id=self.lease_id)
                if not ok:
                    log.warning("lease %#x no longer valid", self.lease_id)
                    counters.inc("lease_expired_total")
                    return
        except (asyncio.CancelledError, ConnectionError):
            pass

    async def is_valid(self) -> bool:
        if self._revoked:
            return False
        return bool(await self.client.request("lease_is_valid", lease_id=self.lease_id))

    async def revoke(self) -> None:
        if self._revoked:
            return
        self._revoked = True
        if self._task:
            self._task.cancel()
            self._task = None
        if self._threaded and self.client._keepalive_thread is not None:
            # existing thread only: after close() the lazy getter would spawn
            # a fresh thread+connection just to forget a dead lease
            self.client._keepalive_thread.remove(self.lease_id)
        try:
            await self.client.request("lease_revoke", lease_id=self.lease_id)
        except (ConnectionError, HubError):
            pass


class PrefixWatch:
    """Snapshot + live put/delete events for a key prefix."""

    def __init__(self, client: "HubClient", watch_id: int, snapshot: list[dict]):
        self.client = client
        self.watch_id = watch_id
        self.snapshot = snapshot
        self.events: asyncio.Queue[dict] = asyncio.Queue()

    async def next(self, timeout: float | None = None) -> dict | None:
        try:
            return await asyncio.wait_for(self.events.get(), timeout)
        except asyncio.TimeoutError:
            return None

    def __aiter__(self) -> AsyncIterator[dict]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[dict]:
        while True:
            ev = await self.events.get()
            if ev is None:  # closed
                return
            yield ev

    async def cancel(self) -> None:
        self.client._pushes.pop(self.watch_id, None)
        try:
            await self.client.request("watch_cancel", watch_id=self.watch_id)
        except (ConnectionError, HubError):
            pass
        self.events.put_nowait(None)


class Subscription:
    """A pub/sub subscription delivering `{subject, data}` events."""

    def __init__(self, client: "HubClient", sub_id: int):
        self.client = client
        self.sub_id = sub_id
        self.events: asyncio.Queue[dict] = asyncio.Queue()

    async def next(self, timeout: float | None = None) -> dict | None:
        try:
            return await asyncio.wait_for(self.events.get(), timeout)
        except asyncio.TimeoutError:
            return None

    def __aiter__(self) -> AsyncIterator[dict]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[dict]:
        while True:
            ev = await self.events.get()
            if ev is None:
                return
            yield ev

    async def unsubscribe(self) -> None:
        self.client._pushes.pop(self.sub_id, None)
        try:
            await self.client.request("unsubscribe", sub_id=self.sub_id)
        except (ConnectionError, HubError):
            pass
        self.events.put_nowait(None)


class HubClient:
    def __init__(self) -> None:
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._req_ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        # Client-chosen push ids (shared counter for watches and subs); the
        # delivery queue is registered *before* the watch/subscribe request is
        # sent, so a push can never race the registration.
        self._push_ids = itertools.count(1)
        self._pushes: dict[int, asyncio.Queue] = {}
        self._recv_task: Optional[asyncio.Task] = None
        self._closed = False
        self._keepalive_thread: Optional[KeepaliveThread] = None
        self.addr = ""

    # ------------------------------------------------------------- lifecycle

    @classmethod
    async def connect(cls, addr: str | None = None) -> "HubClient":
        faults.load_env()  # arm DYN_FAULTS points (no-op when unset)
        self = cls()
        self.addr = addr or hub_addr_from_env()
        host, port = self.addr.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._recv_task = asyncio.create_task(self._recv_loop())
        return self

    def keepalive_thread(self) -> KeepaliveThread:
        """Shared secondary-runtime keepalive (created on first use)."""
        if self._keepalive_thread is None:
            self._keepalive_thread = KeepaliveThread(self.addr)
        return self._keepalive_thread

    async def close(self) -> None:
        self._closed = True
        if self._keepalive_thread is not None:
            self._keepalive_thread.stop()
            self._keepalive_thread = None
        if self._recv_task:
            self._recv_task.cancel()
            self._recv_task = None
        if self._writer:
            self._writer.close()
            self._writer = None
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("hub client closed"))
        self._pending.clear()

    async def _recv_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                msg = await codec.read_frame(self._reader)
                if msg is None:
                    break
                if faults.active():
                    # chaos hook: a 'drop' here kills the recv loop the
                    # way a severed TCP connection would — every pending
                    # future fails with ConnectionError (see finally)
                    await faults.afire("hub.recv")
                if "push" in msg:
                    self._route_push(msg["push"], msg["ev"])
                    continue
                fut = self._pending.pop(msg.get("i"), None)
                if fut is None or fut.done():
                    continue
                if msg.get("ok"):
                    fut.set_result(msg.get("r"))
                else:
                    fut.set_exception(HubError(msg.get("e", "hub error")))
        except asyncio.CancelledError:
            return
        finally:
            if not self._closed:
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(ConnectionError("hub connection lost"))
                self._pending.clear()
                for q in self._pushes.values():
                    q.put_nowait(None)

    def _route_push(self, push_id: int, ev: dict) -> None:
        q = self._pushes.get(push_id)
        if q is not None:
            q.put_nowait(ev)

    async def request(self, op: str, **args: Any) -> Any:
        if faults.active():
            # chaos hook: 'drop' raises ConnectionError exactly like a
            # peer vanishing mid-conversation; 'delay' models a slow hub
            await faults.afire("hub.send")
        if self._writer is None:
            raise ConnectionError("hub client not connected")
        req_id = next(self._req_ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        codec.write_frame(self._writer, {"i": req_id, "op": op, **args})
        await self._writer.drain()
        return await fut

    # -------------------------------------------------------------------- kv

    async def kv_put(self, key: str, value: bytes, lease: Lease | int | None = None) -> int:
        lease_id = lease.lease_id if isinstance(lease, Lease) else (lease or 0)
        return await self.request("kv_put", key=key, value=value, lease=lease_id)

    async def kv_get(self, key: str) -> Optional[dict]:
        return await self.request("kv_get", key=key)

    async def kv_get_prefix(self, prefix: str) -> list[dict]:
        return await self.request("kv_get_prefix", prefix=prefix)

    async def kv_del(self, key: str, prefix: bool = False) -> int:
        return await self.request("kv_del", key=key, prefix=prefix)

    async def kv_create(self, key: str, value: bytes, lease: Lease | int | None = None) -> bool:
        lease_id = lease.lease_id if isinstance(lease, Lease) else (lease or 0)
        return await self.request("kv_create", key=key, value=value, lease=lease_id)

    async def kv_create_or_validate(self, key: str, value: bytes) -> bool:
        return await self.request("kv_create_or_validate", key=key, value=value)

    async def watch_prefix(self, prefix: str) -> PrefixWatch:
        wid = next(self._push_ids)
        watch = PrefixWatch(self, wid, [])
        self._pushes[wid] = watch.events
        try:
            r = await self.request("watch_prefix", prefix=prefix, watch_id=wid)
        except BaseException:
            self._pushes.pop(wid, None)
            raise
        watch.snapshot = r["snapshot"]
        return watch

    # ---------------------------------------------------------------- leases

    async def lease_grant(
        self, ttl: float = 10.0, keepalive: bool | str = True
    ) -> Lease:
        """keepalive: True = task on this loop; "thread" = secondary
        keepalive runtime (survives event-loop stalls: graph captures,
        device syncs);
        False = caller manages."""
        r = await self.request("lease_grant", ttl=ttl)
        lease = Lease(self, r["lease_id"], r["ttl"])
        if keepalive == "thread":
            lease.start_keepalive_threaded()
        elif keepalive:
            lease.start_keepalive()
        return lease

    # --------------------------------------------------------------- pub/sub

    async def publish(self, subject: str, data: bytes) -> int:
        return await self.request("publish", subject=subject, data=data)

    async def subscribe(self, subject: str) -> Subscription:
        sid = next(self._push_ids)
        sub = Subscription(self, sid)
        self._pushes[sid] = sub.events
        try:
            await self.request("subscribe", subject=subject, sub_id=sid)
        except BaseException:
            self._pushes.pop(sid, None)
            raise
        return sub

    # ---------------------------------------------------------------- queues

    async def q_push(self, name: str, data: bytes) -> int:
        return await self.request("q_push", name=name, data=data)

    async def q_pop(
        self, name: str, block: bool = False, timeout: float | None = None
    ) -> Optional[bytes]:
        return await self.request("q_pop", name=name, block=block, timeout=timeout)

    async def q_len(self, name: str) -> int:
        return await self.request("q_len", name=name)

    # ------------------------------------------------------------ object store

    async def obj_put(self, bucket: str, name: str, data: bytes) -> bool:
        return await self.request("obj_put", bucket=bucket, name=name, data=data)

    async def obj_get(self, bucket: str, name: str) -> Optional[bytes]:
        return await self.request("obj_get", bucket=bucket, name=name)

    async def obj_del(self, bucket: str, name: str) -> bool:
        return await self.request("obj_del", bucket=bucket, name=name)

    async def obj_list(self, bucket: str) -> list[str]:
        return await self.request("obj_list", bucket=bucket)

    # ------------------------------------------------------------------ misc

    async def ping(self) -> str:
        return await self.request("ping")

    async def stats(self) -> dict:
        return await self.request("stats")
