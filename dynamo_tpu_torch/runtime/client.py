"""Client: live instance discovery + routed streaming requests.

Combines the reference's `Client` (etcd prefix watch → live endpoint set,
reference: lib/runtime/src/component/client.rs:52-190) and `PushRouter`
(random / round-robin / direct / KV-aware instance selection, reference:
lib/runtime/src/pipeline/network/egress/push_router.rs:35-191). Requests go
straight over the data plane to the chosen instance; the response is a
deserialized async stream. Caller-side cancellation propagates as stop/kill
frames.
"""

from __future__ import annotations

import asyncio
import contextlib
import random as _random
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.runtime.component import (
    EndpointId,
    InstanceInfo,
    pack_payload,
    unpack_payload,
)
from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.runtime.resilience import (
    TRANSIENT_ERRORS,
    Backoff,
    CircuitBreaker,
    StreamBrokenError,
)
from dynamo_tpu_torch.utils import counters, tracing
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.client")


class NoInstancesError(RuntimeError):
    pass


class Client:
    """Tracks live instances of one endpoint via a hub prefix watch.

    Transport resilience (docs/robustness.md): establishing a request
    handle is idempotent (no engine work happens until the worker pops
    the frame), so transient connection failures retry against a
    DIFFERENT instance with jittered backoff, and every instance carries
    a `CircuitBreaker` — `threshold` consecutive transport failures take
    it out of the routing pick for `cooldown_s`, then one half-open
    probe decides. Mid-stream failures are NOT retried (not idempotent);
    they surface to the caller and count against the breaker."""

    # transport-retry policy for handle establishment (idempotent)
    max_attempts = 3

    def __init__(self, drt, endpoint_id: EndpointId):
        self._drt = drt
        self.endpoint_id = endpoint_id
        self.instances: dict[int, InstanceInfo] = {}
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None
        self._changed = asyncio.Event()
        self._rr_index = 0
        self._breakers: dict[int, CircuitBreaker] = {}
        self._backoff = Backoff(base=0.05, cap=1.0)

    @classmethod
    async def new_dynamic(cls, drt, endpoint_id: EndpointId) -> "Client":
        self = cls(drt, endpoint_id)
        self._watch = await drt.hub.watch_prefix(endpoint_id.instance_root)
        for item in self._watch.snapshot:
            info = InstanceInfo.unpack(item["value"])
            self.instances[info.worker_id] = info
        self._watch_task = asyncio.create_task(self._watch_loop())
        return self

    async def _watch_loop(self) -> None:
        async for ev in self._watch:
            worker_hex = ev["key"].rsplit("/", 1)[-1]
            try:
                worker_id = int(worker_hex, 16)
            except ValueError:
                continue
            if ev["type"] == "put":
                info = InstanceInfo.unpack(ev["value"])
                self.instances[info.worker_id] = info
                log.debug("instance up: %s %x", info.endpoint, info.worker_id)
            else:
                self.instances.pop(worker_id, None)
                log.debug("instance down: %s %x", self.endpoint_id.subject, worker_id)
                self._drt.notify_instance_down(self.endpoint_id, worker_id)
            self._changed.set()
            self._changed = asyncio.Event()

    def instance_ids(self) -> list[int]:
        return sorted(self.instances.keys())

    async def wait_for_instances(self, timeout: float = 30.0) -> list[int]:
        """Block until ≥1 instance is live (reference: client.rs
        wait_for_endpoints)."""
        deadline = asyncio.get_running_loop().time() + timeout
        while not self.instances:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"no instances of {self.endpoint_id.subject} within {timeout}s"
                )
            event = self._changed
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(event.wait(), remaining)
        return self.instance_ids()

    async def close(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
            self._watch_task = None
        if self._watch:
            await self._watch.cancel()

    # ------------------------------------------------------------- routing

    def breaker(self, worker_id: int) -> CircuitBreaker:
        """Per-instance circuit breaker (created on first use)."""
        br = self._breakers.get(worker_id)
        if br is None:
            br = self._breakers[worker_id] = CircuitBreaker(
                name=f"{self.endpoint_id.subject}/{worker_id:x}")
        return br

    def breaker_open(self, worker_id: int) -> bool:
        """Non-mutating health read for routers: True while the breaker
        is in cooldown (half-open probes are the data plane's business,
        not the KV router's)."""
        br = self._breakers.get(worker_id)
        return br is not None and br.state != "closed"

    def _pick(
        self, mode: str, instance_id: Optional[int],
        exclude: Optional[set] = None,
    ) -> InstanceInfo:
        if not self.instances:
            raise NoInstancesError(f"no live instances of {self.endpoint_id.subject}")
        if mode == "direct":
            if instance_id is None:
                raise ValueError("direct routing requires instance_id")
            info = self.instances.get(instance_id)
            if info is None:
                raise NoInstancesError(
                    f"instance {instance_id:x} of {self.endpoint_id.subject} not found"
                )
            return info
        ids = sorted(self.instances.keys())
        if exclude:
            ids = [i for i in ids if i not in exclude] or ids
        # skip instances whose breaker is OPEN — a NON-mutating state
        # read: allow() claims the single half-open probe slot, so it
        # must run only for the instance actually chosen, never as a
        # filter over the whole pool (that would burn every half-open
        # worker's probe and strand them excluded). If every breaker is
        # open, fall through with the full set — availability beats a
        # wrongly-pessimistic breaker.
        cand = [i for i in ids if self.breaker(i).state != "open"] or ids
        while True:
            if mode == "round_robin":
                self._rr_index = (self._rr_index + 1) % len(cand)
                chosen = cand[self._rr_index]
            else:
                chosen = _random.choice(cand)  # "random"
            if self.breaker(chosen).allow() or len(cand) == 1:
                # half-open refusal (another probe in flight): re-pick
                # among the rest; a last candidate routes regardless
                return self.instances[chosen]
            cand = [i for i in cand if i != chosen]

    async def generate(
        self,
        payload: Any,
        context: Optional[Context] = None,
        mode: str = "random",
        instance_id: Optional[int] = None,
    ) -> AsyncIterator[Any]:
        """Route one request; returns a typed async response stream.

        Handle establishment retries transient transport failures
        against other instances (capped, jittered); see class docs."""
        ctx = context or Context(payload)
        # distributed tracing: the traceparent (request id + a fresh
        # parent span id for THIS hop) rides Context metadata across the
        # data plane; the worker's Ingress binds it so its spans join
        # the same request id on the merged trace (docs/observability.md
        # "Fleet plane"). Stamped even with local recording off — the
        # receiving worker may be the one tracing.
        tp = ctx.metadata.setdefault(
            "traceparent", tracing.make_traceparent(ctx.id)
        )
        tried: set[int] = set()
        attempt = 0
        while True:
            info = self._pick(mode, instance_id, exclude=tried)
            br = self.breaker(info.worker_id)
            try:
                handle = await self._drt.data_plane_client.request(
                    info.address,
                    self.endpoint_id.subject,
                    pack_payload(payload),
                    request_id=ctx.id,
                    metadata=ctx.metadata,
                )
            except TRANSIENT_ERRORS as exc:
                br.record_failure()
                tried.add(info.worker_id)
                attempt += 1
                if mode == "direct" or attempt >= self.max_attempts:
                    raise
                counters.inc("client_retries_total")
                # a shedding peer's Retry-After hint floors the jittered
                # delay; the request deadline caps it (None = the retry
                # cannot finish in budget — surface the failure now)
                delay = self._backoff.delay_hinted(
                    attempt - 1,
                    retry_after_s=getattr(exc, "retry_after_s", None),
                    deadline_epoch=ctx.metadata.get("deadline"),
                )
                if delay is None:
                    raise
                log.warning(
                    "request to %s %x failed (%s); retrying elsewhere "
                    "in %.3fs", self.endpoint_id.subject, info.worker_id,
                    exc, delay,
                )
                await asyncio.sleep(delay)
                continue
            br.record_success()
            # which instance serves this stream: the JAX package's failover
            # plane (not ported, ROADMAP M17) keys
            # lease-expiry/breaker break-detection AND replay exclusion
            # off this (it also survives into trace attrs via rpc.send)
            ctx.metadata["served_by"] = info.worker_id
            if tracing.enabled():
                tracing.instant(
                    "rpc.send", cat="rpc", req=ctx.id,
                    endpoint=self.endpoint_id.subject,
                    worker=f"{info.worker_id:x}", traceparent=tp,
                )
            break

        worker_id = info.worker_id

        async def _stream() -> AsyncIterator[Any]:
            monitor = asyncio.create_task(_propagate_cancel(ctx, handle))
            done = False
            try:
                try:
                    async for raw in handle:
                        yield unpack_payload(raw)
                    done = True
                except ConnectionError as exc:
                    # mid-stream transport break: NOT retried here (the
                    # handle is not idempotent once the worker started
                    # generating) — surface a TYPED error carrying the
                    # serving instance so the failover plane can journal-
                    # replay it, and teach the breaker (a dead worker
                    # stops being picked before its lease expires)
                    self.breaker(worker_id).record_failure()
                    counters.inc("client_stream_broken_total")
                    raise StreamBrokenError(
                        f"stream from {self.endpoint_id.subject} "
                        f"{worker_id:x} broke mid-flight: {exc}",
                        instance_id=worker_id,
                    ) from exc
            finally:
                monitor.cancel()
                if not done:
                    # abandoned early (failover gave up on this attempt,
                    # or the consumer closed the generator): stop the
                    # worker-side sequence so it does not generate for a
                    # stream nobody is draining
                    with contextlib.suppress(Exception):
                        await handle.kill()

        return _stream()

    async def random(self, payload: Any, **kw) -> AsyncIterator[Any]:
        return await self.generate(payload, mode="random", **kw)

    async def round_robin(self, payload: Any, **kw) -> AsyncIterator[Any]:
        return await self.generate(payload, mode="round_robin", **kw)

    async def direct(self, payload: Any, instance_id: int, **kw) -> AsyncIterator[Any]:
        return await self.generate(payload, mode="direct", instance_id=instance_id, **kw)

    async def scrape_stats(self, timeout: float = 2.0) -> dict[int, dict]:
        """Poll every live instance's stats handler (reference: NATS
        $SRV.STATS scrape, lib/runtime/src/transports/nats.rs:109-121)."""
        results: dict[int, dict] = {}

        async def _one(worker_id: int, info: InstanceInfo) -> None:
            try:
                handle = await self._drt.data_plane_client.request(
                    info.address, f"{self.endpoint_id.subject}/stats", b"\xc0"
                )
                async for raw in handle:
                    results[worker_id] = unpack_payload(raw)
                self.breaker(worker_id).record_success()
            except TRANSIENT_ERRORS:
                # a dead worker just drops out of the snapshot — but its
                # breaker learns, so routing stops picking it before the
                # hub lease expires
                self.breaker(worker_id).record_failure()
            except Exception:  # noqa: BLE001 — malformed stats, etc.
                pass

        tasks = [
            asyncio.create_task(_one(wid, info)) for wid, info in self.instances.items()
        ]
        if tasks:
            await asyncio.wait(tasks, timeout=timeout)
            for t in tasks:
                t.cancel()
        return results


async def _propagate_cancel(ctx: Context, handle) -> None:
    with contextlib.suppress(asyncio.CancelledError, ConnectionError):
        await ctx.controller.stopped()
        if ctx.is_killed():
            await handle.kill()
        else:
            await handle.stop()


class PushRouter:
    """Mode-carrying wrapper over Client, mirroring the reference API
    (push_router.rs:35-70). KV-aware mode lives in
    `dynamo_tpu_torch.kv_router.KvPushRouter` which subclasses this."""

    def __init__(self, client: Client, mode: str = "random"):
        self.client = client
        self.mode = mode

    @classmethod
    async def from_client(cls, client: Client, mode: str = "random") -> "PushRouter":
        return cls(client, mode)

    async def generate(
        self, payload: Any, context: Optional[Context] = None
    ) -> AsyncIterator[Any]:
        return await self.client.generate(payload, context=context, mode=self.mode)
