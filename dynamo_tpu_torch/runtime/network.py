"""Data plane: direct worker-to-worker request/streaming-response over TCP.

The reference splits its wire into a NATS request plane plus a call-home TCP
response plane (reference: lib/runtime/src/pipeline/network/egress/
addressed_router.rs:59-178, ingress/push_endpoint.rs:26-110, tcp/server.rs).
Since our router always picks the target instance client-side anyway
(PushRouter), the runtime uses one direct, multiplexed TCP connection per
(client, worker) pair: requests and streamed responses share the connection,
correlated by stream id. This removes a broker hop from the per-token hot
path: every streamed token crosses it as one frame, so fewer hops
directly cut inter-token latency.

Frames (msgpack, length-prefixed — `hub.codec`):
  client → server:
    {"i": sid, "k": "req", "ep": endpoint, "id": request_id, "md": {...}, "p": bytes}
    {"i": sid, "k": "stop"}   — graceful stop (context.stop_generating)
    {"i": sid, "k": "kill"}   — hard kill
  server → client:
    {"i": sid, "k": "pro", "e": err|None}  — prologue (handler found / failed)
    {"i": sid, "k": "data", "p": bytes}
    {"i": sid, "k": "err", "e": str}
    {"i": sid, "k": "end"}

Graceful drain mirrors push_endpoint.rs:99-108: on shutdown the server stops
accepting, signals stop on in-flight contexts, and waits for them to finish.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
from typing import AsyncIterator, Awaitable, Callable, Optional

from dynamo_tpu_torch.runtime.hub import codec
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.utils import faults
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.network")

# A raw-bytes streaming handler: Context[bytes] -> async iterator of bytes.
BytesHandler = Callable[[Context], Awaitable[AsyncIterator[bytes]]]


class DataPlaneServer:
    """Serves all endpoints of one worker process on a single TCP port."""

    def __init__(self, host: str = "0.0.0.0", advertise_host: str = "127.0.0.1"):
        faults.load_env()  # arms the dataplane.die chaos point when set
        self._host = host
        self.advertise_host = advertise_host
        self.port: int = 0
        self._handlers: dict[str, BytesHandler] = {}
        self._server: Optional[asyncio.Server] = None
        self._inflight: dict[tuple[int, int], Context] = {}  # (conn, sid) -> ctx
        self._conns: dict[asyncio.StreamWriter, asyncio.Queue] = {}  # writer -> outbox
        self._conn_ids = itertools.count(1)
        self._drained = asyncio.Event()
        self._drained.set()
        self._closing = False

    @property
    def address(self) -> str:
        return f"{self.advertise_host}:{self.port}"

    def register(self, endpoint: str, handler: BytesHandler) -> None:
        self._handlers[endpoint] = handler

    def unregister(self, endpoint: str) -> None:
        self._handlers.pop(endpoint, None)

    async def start(self, port: int = 0) -> None:
        self._server = await asyncio.start_server(self._handle_conn, self._host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("data plane listening on %s:%d", self._host, self.port)

    async def stop(self, drain_timeout: float = 10.0) -> None:
        self._closing = True
        if self._server:
            self._server.close()
        for ctx in self._inflight.values():
            ctx.stop_generating()
        try:
            await asyncio.wait_for(self._drained.wait(), drain_timeout)
        except asyncio.TimeoutError:
            log.warning("drain timeout with %d streams in flight", len(self._inflight))
            for ctx in self._inflight.values():
                ctx.kill()
        # Let per-connection sender loops flush queued response frames (the
        # drained streams' final data/end frames may still sit in outboxes).
        flush_deadline = asyncio.get_running_loop().time() + 5.0
        while any(not q.empty() for q in self._conns.values()):
            if asyncio.get_running_loop().time() > flush_deadline:
                log.warning("outbox flush timeout on shutdown")
                break
            await asyncio.sleep(0.01)
        # Close live peer connections BEFORE wait_closed(): since 3.12 it
        # waits for all connection handlers, which would deadlock while
        # clients keep pooled connections open.
        for writer in list(self._conns):
            writer.close()
        if self._server:
            await self._server.wait_closed()
            self._server = None

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn_id = next(self._conn_ids)
        outbox: asyncio.Queue = asyncio.Queue()
        self._conns[writer] = outbox
        sender = asyncio.create_task(self._sender_loop(writer, outbox))
        tasks: dict[int, asyncio.Task] = {}
        try:
            while True:
                try:
                    msg = await codec.read_frame(reader)
                except ValueError as exc:  # malformed/oversized frame
                    log.warning("dropping data-plane conn %d: %s", conn_id, exc)
                    break
                if msg is None:
                    break
                sid, kind = msg.get("i"), msg.get("k")
                if kind == "req":
                    task = asyncio.create_task(
                        self._serve_stream(conn_id, sid, msg, outbox)
                    )
                    tasks[sid] = task
                    task.add_done_callback(lambda _t, s=sid: tasks.pop(s, None))
                elif kind == "stop":
                    ctx = self._inflight.get((conn_id, sid))
                    if ctx:
                        ctx.stop_generating()
                elif kind == "kill":
                    ctx = self._inflight.get((conn_id, sid))
                    if ctx:
                        ctx.kill()
        finally:
            for t in tasks.values():
                t.cancel()
            # peer gone: kill any of this connection's contexts so engines
            # stop wasting compute on a vanished caller
            for (cid, sid), ctx in list(self._inflight.items()):
                if cid == conn_id:
                    ctx.kill()
            sender.cancel()
            self._conns.pop(writer, None)
            writer.close()

    async def _sender_loop(self, writer: asyncio.StreamWriter, outbox: asyncio.Queue):
        try:
            while True:
                msg = await outbox.get()
                codec.write_frame(writer, msg)
                if outbox.empty():
                    await writer.drain()
        except (asyncio.CancelledError, ConnectionError):
            pass

    def _die_abruptly(self) -> None:
        """Injected worker death (`dataplane.die` fault point): sever every
        live connection WITHOUT end/err frames and stop accepting — on
        the wire this is indistinguishable from the process being
        SIGKILLed, which is exactly what the failover chaos proof needs
        (docs/robustness.md "Request failover"). The read-loop EOF path
        kills the in-flight contexts, like a real death would."""
        log.warning("injected worker death: aborting %d data-plane conns",
                    len(self._conns))
        self._closing = True
        if self._server:
            self._server.close()
        for writer in list(self._conns):
            with contextlib.suppress(Exception):
                writer.transport.abort()

    async def _serve_stream(
        self, conn_id: int, sid: int, msg: dict, outbox: asyncio.Queue
    ) -> None:
        handler = self._handlers.get(msg["ep"])
        if handler is None or self._closing:
            err = "shutting down" if self._closing else f"no endpoint {msg['ep']!r}"
            outbox.put_nowait({"i": sid, "k": "pro", "e": err})
            return
        ctx = Context(
            payload=msg.get("p", b""),
            request_id=msg.get("id"),
            metadata=msg.get("md") or {},
        )
        key = (conn_id, sid)
        self._inflight[key] = ctx
        self._drained.clear()
        try:
            stream = await handler(ctx)
            outbox.put_nowait({"i": sid, "k": "pro", "e": None})
            async for item in stream:
                if ctx.is_killed():
                    break
                # chaos: a fired `dataplane.die` kills the whole data
                # plane mid-stream (FaultError -> abrupt abort below).
                # Distinct from the `worker.die` point control_worker-
                # style victims consult per REQUEST: this one counts
                # streamed FRAMES and is process-agnostic, so arming it
                # fleet-wide would kill every worker -- scenarios arm it
                # one-shot (x1) or target a victim directly.
                faults.fire("dataplane.die")
                outbox.put_nowait({"i": sid, "k": "data", "p": item})
            outbox.put_nowait({"i": sid, "k": "end"})
        except asyncio.CancelledError:
            raise
        except faults.FaultError:
            self._die_abruptly()
        except Exception as exc:  # noqa: BLE001 — propagated to the caller
            log.error("stream handler error on %s", msg["ep"], exc_info=exc)
            outbox.put_nowait({"i": sid, "k": "err", "e": str(exc)})
        finally:
            self._inflight.pop(key, None)
            if not self._inflight:
                self._drained.set()


class ResponseStreamHandle:
    """Client-side view of one in-flight stream."""

    def __init__(self, conn: "_DataConn", sid: int):
        self._conn = conn
        self._sid = sid
        self.queue: asyncio.Queue = asyncio.Queue()
        self.prologue: asyncio.Future = asyncio.get_running_loop().create_future()

    async def stop(self) -> None:
        await self._conn.send({"i": self._sid, "k": "stop"})

    async def kill(self) -> None:
        await self._conn.send({"i": self._sid, "k": "kill"})

    def __aiter__(self) -> AsyncIterator[bytes]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[bytes]:
        while True:
            msg = await self.queue.get()
            kind = msg.get("k")
            if kind == "data":
                yield msg["p"]
            elif kind == "end":
                return
            elif kind == "err":
                raise RuntimeError(msg.get("e", "remote stream error"))
            elif kind == "gone":
                raise ConnectionError("data plane connection lost")


class _DataConn:
    """One multiplexed connection to a worker's data plane server."""

    def __init__(self, addr: str):
        self.addr = addr
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._sids = itertools.count(1)
        self._streams: dict[int, ResponseStreamHandle] = {}
        self._recv_task: Optional[asyncio.Task] = None
        self.alive = False

    async def connect(self) -> None:
        host, port = self.addr.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._recv_task = asyncio.create_task(self._recv_loop())
        self.alive = True

    async def close(self) -> None:
        self.alive = False
        if self._recv_task:
            self._recv_task.cancel()
            self._recv_task = None
        if self._writer:
            self._writer.close()
            self._writer = None
        self._fail_all()

    def _fail_all(self) -> None:
        for handle in self._streams.values():
            if not handle.prologue.done():
                handle.prologue.set_exception(ConnectionError("connection lost"))
            handle.queue.put_nowait({"k": "gone"})
        self._streams.clear()

    async def send(self, msg: dict) -> None:
        if self._writer is None:
            raise ConnectionError("not connected")
        codec.write_frame(self._writer, msg)
        await self._writer.drain()

    async def _recv_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                msg = await codec.read_frame(self._reader)
                if msg is None:
                    break
                handle = self._streams.get(msg.get("i"))
                if handle is None:
                    continue
                if msg.get("k") == "pro":
                    if msg.get("e"):
                        handle.prologue.set_exception(RuntimeError(msg["e"]))
                        self._streams.pop(msg.get("i"), None)
                    else:
                        handle.prologue.set_result(True)
                    continue
                handle.queue.put_nowait(msg)
                if msg.get("k") in ("end", "err"):
                    self._streams.pop(msg.get("i"), None)
        except asyncio.CancelledError:
            return
        finally:
            self.alive = False
            self._fail_all()

    async def request(
        self,
        endpoint: str,
        payload: bytes,
        request_id: str | None = None,
        metadata: dict | None = None,
    ) -> ResponseStreamHandle:
        sid = next(self._sids)
        handle = ResponseStreamHandle(self, sid)
        self._streams[sid] = handle
        await self.send(
            {"i": sid, "k": "req", "ep": endpoint, "id": request_id, "md": metadata, "p": payload}
        )
        await handle.prologue  # raises if endpoint missing / draining
        return handle


class DataPlaneClient:
    """Connection pool over worker addresses; one multiplexed conn per addr."""

    def __init__(self) -> None:
        self._conns: dict[str, _DataConn] = {}
        self._locks: dict[str, asyncio.Lock] = {}

    async def _get_conn(self, addr: str) -> _DataConn:
        conn = self._conns.get(addr)
        if conn is not None and conn.alive:
            return conn
        lock = self._locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self._conns.get(addr)
            if conn is not None and conn.alive:
                return conn
            conn = _DataConn(addr)
            await conn.connect()
            self._conns[addr] = conn
            return conn

    async def request(
        self,
        addr: str,
        endpoint: str,
        payload: bytes,
        request_id: str | None = None,
        metadata: dict | None = None,
    ) -> ResponseStreamHandle:
        conn = await self._get_conn(addr)
        return await conn.request(endpoint, payload, request_id, metadata)

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
