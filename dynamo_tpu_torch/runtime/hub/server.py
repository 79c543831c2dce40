"""Hub server: lease-based KV + watch, pub/sub, queues, object store.

Semantics mirror the reference's use of etcd and NATS
(reference: lib/runtime/src/transports/etcd.rs:41-540, nats.rs:50-214):

- `kv_put/kv_get/kv_del/kv_get_prefix` with monotonically increasing
  revisions; values are opaque bytes.
- `kv_create` — create-if-absent transaction (etcd.rs `kv_create`),
  `kv_create_or_validate` — create or succeed iff identical value.
- `lease_grant(ttl)` / `lease_keepalive` / `lease_revoke`; expiry deletes all
  keys attached to the lease and fires watch delete events — this is the
  liveness mechanism: a dead worker stops sending keepalives, its endpoint
  keys vanish, routers stop sending to it (etcd.rs lease keep-alive loop).
- `watch_prefix` — snapshot + pushed put/delete events (etcd.rs
  `kv_get_and_watch_prefix` → PrefixWatcher).
- `publish/subscribe` on dotted subjects with trailing `.>` wildcard
  (NATS-style, used for KV events / hit-rate events).
- `q_push/q_pop/q_len` — FIFO queues with competing blocking consumers
  (JetStream prefill-queue equivalent, reference:
  examples/llm/utils/nats_queue.py).
- `obj_put/obj_get/obj_del` — object store buckets (NATS object store used
  for model-card artifacts, nats.rs:123-212).

Single asyncio loop ⇒ every op is atomic with respect to every other; a
per-connection outbound queue decouples slow subscribers from publishers.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.runtime.hub import codec
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.hub")

LEASE_TICK_S = 0.25


@dataclass
class _LeaseState:
    lease_id: int
    ttl: float
    deadline: float
    keys: set[str] = field(default_factory=set)


@dataclass
class _Conn:
    conn_id: int
    writer: asyncio.StreamWriter
    outbox: asyncio.Queue
    watches: set[int] = field(default_factory=set)
    subs: set[int] = field(default_factory=set)
    leases: set[int] = field(default_factory=set)
    # in-flight async ops (blocking q_pops) and their waiter futures, so a
    # dropped connection cancels them instead of stealing queue items
    op_tasks: set = field(default_factory=set)
    pop_waiters: set = field(default_factory=set)


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style match: exact, or prefix with trailing '>' token."""
    if pattern == subject:
        return True
    if pattern.endswith(".>"):
        return subject.startswith(pattern[:-1]) or subject == pattern[:-2]
    return False


class HubServer:
    def __init__(self) -> None:
        self._kv: dict[str, tuple[bytes, int, int]] = {}  # key -> (value, rev, lease)
        self._revision = 0
        self._leases: dict[int, _LeaseState] = {}
        self._lease_ids = itertools.count(0x1000)
        self._conn_ids = itertools.count(1)
        self._conns: dict[int, _Conn] = {}
        # (conn_id, client-chosen watch_id) -> prefix. Clients pick their own
        # ids and register the delivery queue *before* sending the request, so
        # no pushed event can race the registration.
        self._watches: dict[tuple[int, int], str] = {}
        # (conn_id, client-chosen sub_id) -> subject pattern
        self._subs: dict[tuple[int, int], str] = {}
        self._queues: dict[str, list[bytes]] = {}
        self._q_waiters: dict[str, list[asyncio.Future]] = {}
        self._objects: dict[str, dict[str, bytes]] = {}
        self._server: Optional[asyncio.Server] = None
        self._expiry_task: Optional[asyncio.Task] = None
        self.port: int = 0

    # ------------------------------------------------------------- lifecycle

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._handle_conn, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._expiry_task = asyncio.create_task(self._expiry_loop())
        log.info("hub listening on %s:%d", host, self.port)

    async def stop(self) -> None:
        if self._expiry_task:
            self._expiry_task.cancel()
            self._expiry_task = None
        if self._server:
            self._server.close()
            # Close live connections BEFORE wait_closed(): since 3.12
            # wait_closed() also waits for all connection handlers, which
            # would deadlock while peers keep their connections open.
            for conn in list(self._conns.values()):
                conn.writer.close()
            await self._server.wait_closed()
            self._server = None
        self._conns.clear()

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------ connection

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = _Conn(next(self._conn_ids), writer, asyncio.Queue())
        self._conns[conn.conn_id] = conn
        sender = asyncio.create_task(self._sender_loop(conn))
        try:
            while True:
                try:
                    msg = await codec.read_frame(reader)
                except ValueError as exc:  # malformed/oversized frame
                    log.warning("dropping conn %d: %s", conn.conn_id, exc)
                    break
                if msg is None:
                    break
                try:
                    result = self._dispatch(conn, msg)
                except Exception as exc:  # noqa: BLE001 — error goes to caller
                    self._reply(conn, msg, err=exc)
                    continue
                if asyncio.iscoroutine(result):
                    # Blocking ops (q_pop) run as tasks so they never
                    # head-of-line-block other ops — in particular lease
                    # keepalives — multiplexed on the same connection.
                    task = asyncio.create_task(self._run_async_op(conn, msg, result))
                    conn.op_tasks.add(task)
                    task.add_done_callback(conn.op_tasks.discard)
                else:
                    self._reply(conn, msg, result=result)
        finally:
            sender.cancel()
            self._drop_conn(conn)
            writer.close()

    def _reply(self, conn: _Conn, msg: dict, result: Any = None, err=None) -> None:
        if msg.get("i") is None:
            return
        if err is not None:
            conn.outbox.put_nowait({"i": msg["i"], "ok": False, "e": str(err)})
        else:
            conn.outbox.put_nowait({"i": msg["i"], "ok": True, "r": result})

    async def _run_async_op(self, conn: _Conn, msg: dict, coro) -> None:
        try:
            result = await coro
        except asyncio.CancelledError:
            return
        except Exception as exc:  # noqa: BLE001 — error goes to caller
            self._reply(conn, msg, err=exc)
            return
        self._reply(conn, msg, result=result)

    async def _sender_loop(self, conn: _Conn) -> None:
        try:
            while True:
                msg = await conn.outbox.get()
                codec.write_frame(conn.writer, msg)
                if conn.outbox.empty():
                    await conn.writer.drain()
        except (asyncio.CancelledError, ConnectionError):
            pass

    def _drop_conn(self, conn: _Conn) -> None:
        self._conns.pop(conn.conn_id, None)
        for wid in list(conn.watches):
            self._watches.pop((conn.conn_id, wid), None)
        for sid in list(conn.subs):
            self._subs.pop((conn.conn_id, sid), None)
        for fut in list(conn.pop_waiters):
            if not fut.done():
                fut.cancel()
        for task in list(conn.op_tasks):
            task.cancel()
        # Leases are NOT revoked on disconnect: keepalives stop and the lease
        # expires after its TTL — matching etcd semantics and giving workers a
        # reconnect window.

    def _push(self, conn_id: int, msg: dict[str, Any]) -> None:
        conn = self._conns.get(conn_id)
        if conn is not None:
            conn.outbox.put_nowait(msg)

    # -------------------------------------------------------------- dispatch

    def _dispatch(self, conn: _Conn, msg: dict[str, Any]):
        op = msg.get("op")
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ValueError(f"unknown op {op!r}")
        return handler(conn, msg)

    # ------------------------------------------------------------------- kv

    def _notify_watchers(self, ev_type: str, key: str, value: bytes | None, rev: int):
        for (conn_id, wid), prefix in self._watches.items():
            if key.startswith(prefix):
                self._push(
                    conn_id,
                    {
                        "push": wid,
                        "ev": {"type": ev_type, "key": key, "value": value, "rev": rev},
                    },
                )

    def _kv_set(self, key: str, value: bytes, lease_id: int) -> int:
        if lease_id:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise ValueError(f"lease {lease_id:#x} not found")
            lease.keys.add(key)
        old = self._kv.get(key)
        if old is not None and old[2] and old[2] != lease_id:
            old_lease = self._leases.get(old[2])
            if old_lease:
                old_lease.keys.discard(key)
        self._revision += 1
        self._kv[key] = (value, self._revision, lease_id)
        self._notify_watchers("put", key, value, self._revision)
        return self._revision

    def _kv_delete(self, key: str) -> bool:
        entry = self._kv.pop(key, None)
        if entry is None:
            return False
        if entry[2]:
            lease = self._leases.get(entry[2])
            if lease:
                lease.keys.discard(key)
        self._revision += 1
        self._notify_watchers("delete", key, None, self._revision)
        return True

    def _op_kv_put(self, conn, m):
        return self._kv_set(m["key"], m["value"], m.get("lease", 0))

    def _op_kv_get(self, conn, m):
        entry = self._kv.get(m["key"])
        if entry is None:
            return None
        return {"value": entry[0], "rev": entry[1], "lease": entry[2]}

    def _op_kv_get_prefix(self, conn, m):
        prefix = m["prefix"]
        return [
            {"key": k, "value": v[0], "rev": v[1], "lease": v[2]}
            for k, v in self._kv.items()
            if k.startswith(prefix)
        ]

    def _op_kv_del(self, conn, m):
        key = m["key"]
        if m.get("prefix"):
            keys = [k for k in self._kv if k.startswith(key)]
            return sum(self._kv_delete(k) for k in keys)
        return int(self._kv_delete(key))

    def _op_kv_create(self, conn, m):
        """Create-if-absent; returns True iff created."""
        if m["key"] in self._kv:
            return False
        self._kv_set(m["key"], m["value"], m.get("lease", 0))
        return True

    def _op_kv_create_or_validate(self, conn, m):
        entry = self._kv.get(m["key"])
        if entry is None:
            self._kv_set(m["key"], m["value"], m.get("lease", 0))
            return True
        return entry[0] == m["value"]

    def _op_watch_prefix(self, conn, m):
        wid = m["watch_id"]  # client-chosen; unique per connection
        self._watches[(conn.conn_id, wid)] = m["prefix"]
        conn.watches.add(wid)
        snapshot = self._op_kv_get_prefix(conn, {"prefix": m["prefix"]})
        return {"watch_id": wid, "snapshot": snapshot, "rev": self._revision}

    def _op_watch_cancel(self, conn, m):
        wid = m["watch_id"]
        self._watches.pop((conn.conn_id, wid), None)
        conn.watches.discard(wid)
        return True

    # --------------------------------------------------------------- leases

    def _op_lease_grant(self, conn, m):
        ttl = float(m.get("ttl", 10.0))
        lease_id = next(self._lease_ids)
        self._leases[lease_id] = _LeaseState(lease_id, ttl, time.monotonic() + ttl)
        conn.leases.add(lease_id)
        return {"lease_id": lease_id, "ttl": ttl}

    def _op_lease_keepalive(self, conn, m):
        lease = self._leases.get(m["lease_id"])
        if lease is None:
            return False
        lease.deadline = time.monotonic() + lease.ttl
        return True

    def _op_lease_revoke(self, conn, m):
        return self._revoke_lease(m["lease_id"])

    def _op_lease_is_valid(self, conn, m):
        return m["lease_id"] in self._leases

    def _revoke_lease(self, lease_id: int) -> bool:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return False
        for key in list(lease.keys):
            self._kv_delete(key)
        return True

    async def _expiry_loop(self) -> None:
        while True:
            await asyncio.sleep(LEASE_TICK_S)
            now = time.monotonic()
            expired = [lid for lid, l in self._leases.items() if l.deadline < now]
            for lid in expired:
                log.info("lease %#x expired; revoking", lid)
                self._revoke_lease(lid)

    # -------------------------------------------------------------- pub/sub

    def _op_subscribe(self, conn, m):
        sid = m["sub_id"]  # client-chosen; unique per connection
        self._subs[(conn.conn_id, sid)] = m["subject"]
        conn.subs.add(sid)
        return {"sub_id": sid}

    def _op_unsubscribe(self, conn, m):
        sid = m["sub_id"]
        self._subs.pop((conn.conn_id, sid), None)
        conn.subs.discard(sid)
        return True

    def _op_publish(self, conn, m):
        subject, data = m["subject"], m["data"]
        n = 0
        for (conn_id, sid), pattern in self._subs.items():
            if subject_matches(pattern, subject):
                self._push(conn_id, {"push": sid, "ev": {"subject": subject, "data": data}})
                n += 1
        return n

    # --------------------------------------------------------------- queues

    def _op_q_push(self, conn, m):
        name = m["name"]
        waiters = self._q_waiters.get(name)
        while waiters:
            fut = waiters.pop(0)
            if not fut.done():
                fut.set_result(m["data"])
                return 0
        self._queues.setdefault(name, []).append(m["data"])
        return len(self._queues[name])

    async def _op_q_pop(self, conn, m):
        name = m["name"]
        q = self._queues.get(name)
        if q:
            return q.pop(0)
        if not m.get("block", False):
            return None
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._q_waiters.setdefault(name, []).append(fut)
        conn.pop_waiters.add(fut)
        timeout = m.get("timeout")
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None
        finally:
            conn.pop_waiters.discard(fut)
            waiters = self._q_waiters.get(name)
            if waiters and fut in waiters:
                waiters.remove(fut)

    def _op_q_len(self, conn, m):
        return len(self._queues.get(m["name"], []))

    # ----------------------------------------------------------- object store

    def _op_obj_put(self, conn, m):
        self._objects.setdefault(m["bucket"], {})[m["name"]] = m["data"]
        return True

    def _op_obj_get(self, conn, m):
        return self._objects.get(m["bucket"], {}).get(m["name"])

    def _op_obj_del(self, conn, m):
        bucket = self._objects.get(m["bucket"], {})
        return bucket.pop(m["name"], None) is not None

    def _op_obj_list(self, conn, m):
        return sorted(self._objects.get(m["bucket"], {}).keys())

    # ------------------------------------------------------------------ misc

    def _op_ping(self, conn, m):
        return "pong"

    def _op_stats(self, conn, m):
        return {
            "keys": len(self._kv),
            "leases": len(self._leases),
            "conns": len(self._conns),
            "watches": len(self._watches),
            "subs": len(self._subs),
            "queues": {k: len(v) for k, v in self._queues.items()},
            "revision": self._revision,
        }
