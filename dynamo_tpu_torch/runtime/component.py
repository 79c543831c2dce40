"""Namespace / Component / Endpoint addressing and endpoint hosting.

Three-level addressing mirroring the reference (reference:
lib/runtime/src/component.rs:112-317):

- hub KV path for instances:  ``/{ns}/components/{comp}/endpoints/{ep}/{worker_id:x}``
- data-plane endpoint name:   ``{ns}.{comp}.{ep}``
- event subjects:             ``{ns}.{comp}.{subject}``
- endpoint URI form:          ``dyn://{ns}.{comp}.{ep}``

Hosting an endpoint (reference: lib/runtime/src/component/endpoint.rs:57-142)
registers a handler on the worker's data-plane server and writes an
`InstanceInfo` record to the hub under the worker's lease, so liveness is
lease-driven: when the process dies, keepalives stop, the key expires, and
routers drop the instance.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.utils import msgpack

from dynamo_tpu_torch.runtime.pipeline.context import Context
from dynamo_tpu_torch.runtime.pipeline.engine import AsyncEngine
from dynamo_tpu_torch.utils import tracing
from dynamo_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.client import Client
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

log = get_logger("dynamo_tpu_torch.component")

_NAME_RE = re.compile(r"^[a-zA-Z0-9_-]+$")


def _check_name(kind: str, name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid {kind} name {name!r}")
    return name


@dataclass(frozen=True)
class EndpointId:
    """Parsed ``dyn://ns.comp.ep`` identifier (reference:
    lib/runtime/src/protocols.rs Endpoint id parsing)."""

    namespace: str
    component: str
    name: str

    @classmethod
    def parse(cls, path: str) -> "EndpointId":
        if path.startswith("dyn://"):
            path = path[len("dyn://") :]
        parts = path.split(".")
        if len(parts) == 2:
            parts = [parts[0], parts[1], "generate"]
        if len(parts) != 3:
            raise ValueError(f"endpoint path must be ns.component.endpoint: {path!r}")
        return cls(*parts)

    @property
    def subject(self) -> str:
        return f"{self.namespace}.{self.component}.{self.name}"

    @property
    def instance_root(self) -> str:
        return (
            f"/{self.namespace}/components/{self.component}/endpoints/{self.name}/"
        )

    def __str__(self) -> str:
        return f"dyn://{self.subject}"


@dataclass
class InstanceInfo:
    """One live endpoint instance (reference: component.rs:92-100
    ComponentEndpointInfo)."""

    endpoint: str  # data-plane endpoint name ns.comp.ep
    address: str  # host:port of the worker's data plane server
    worker_id: int
    lease_id: int
    transport: str = "tcp"
    metadata: dict[str, Any] = field(default_factory=dict)

    def pack(self) -> bytes:
        return msgpack.packb(self.__dict__)

    @classmethod
    def unpack(cls, raw: bytes) -> "InstanceInfo":
        return cls(**msgpack.unpackb(raw))


class Namespace:
    def __init__(self, drt: "DistributedRuntime", name: str):
        self._drt = drt
        self.name = _check_name("namespace", name)

    def component(self, name: str) -> "Component":
        return Component(self._drt, self, _check_name("component", name))


class Component:
    def __init__(self, drt: "DistributedRuntime", namespace: Namespace, name: str):
        self._drt = drt
        self.namespace = namespace
        self.name = name

    @property
    def path(self) -> str:
        return f"/{self.namespace.name}/components/{self.name}"

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._drt, self, _check_name("endpoint", name))

    # -- events plane
    def subject(self, suffix: str) -> str:
        return f"{self.namespace.name}.{self.name}.{suffix}"

    async def publish(self, suffix: str, data: bytes) -> int:
        return await self._drt.hub.publish(self.subject(suffix), data)

    async def subscribe(self, suffix: str):
        return await self._drt.hub.subscribe(self.subject(suffix))


class Endpoint:
    def __init__(self, drt: "DistributedRuntime", component: Component, name: str):
        self._drt = drt
        self.component = component
        self.name = name

    @property
    def id(self) -> EndpointId:
        return EndpointId(self.component.namespace.name, self.component.name, self.name)

    @property
    def subject(self) -> str:
        return self.id.subject

    @property
    def instance_root(self) -> str:
        return self.id.instance_root

    def instance_key(self, worker_id: int) -> str:
        return f"{self.instance_root}{worker_id:x}"

    async def client(self) -> "Client":
        from dynamo_tpu_torch.runtime.client import Client

        return await Client.new_dynamic(self._drt, self.id)

    def endpoint_builder(self) -> "EndpointConfigBuilder":
        return EndpointConfigBuilder(self)

    async def serve_engine(
        self,
        engine: AsyncEngine,
        lease=None,
        metadata: dict[str, Any] | None = None,
        stats_handler: Callable[[], dict] | None = None,
    ) -> "ServedEndpoint":
        """Shorthand: host `engine` on this endpoint (typed payloads are
        msgpack-framed automatically)."""
        builder = self.endpoint_builder().engine(engine)
        if lease is not None:
            builder = builder.lease(lease)
        if metadata:
            builder = builder.metadata(metadata)
        if stats_handler:
            builder = builder.stats_handler(stats_handler)
        return await builder.start()


def pack_payload(obj: Any) -> bytes:
    return msgpack.packb(obj)


def unpack_payload(raw: bytes) -> Any:
    return msgpack.unpackb(raw)


class Ingress:
    """Adapts a typed engine into the data plane's bytes handler
    (reference: lib/runtime/src/pipeline/network.rs:279 `Ingress`).

    Trace plane: the caller's traceparent (stamped into Context metadata
    by `runtime/client.py`) is bound here — the request id joins this
    process's contextvar so worker-side spans and JSONL logs carry the
    SAME id as the frontend's, and an `rpc.recv` instant marks the hop
    on the merged timeline (docs/observability.md "Fleet plane")."""

    def __init__(self, engine: AsyncEngine):
        self._engine = engine

    async def __call__(self, ctx: Context) -> AsyncIterator[bytes]:
        tracing.set_request(ctx.id)
        if tracing.enabled():
            parent = None
            tp = (ctx.metadata or {}).get("traceparent")
            if isinstance(tp, str):
                _, parent = tracing.parse_traceparent(tp)
            tracing.instant(
                "rpc.recv", cat="rpc", req=ctx.id,
                parent_span=parent or "",
            )
        typed = ctx.map(unpack_payload(ctx.payload))
        stream = await self._engine.generate(typed)

        async def _encode() -> AsyncIterator[bytes]:
            async for item in stream:
                yield pack_payload(item)

        return _encode()


class ServedEndpoint:
    def __init__(self, endpoint: Endpoint, instance: InstanceInfo, lease):
        self.endpoint = endpoint
        self.instance = instance
        self.lease = lease
        self._drt = endpoint._drt

    async def shutdown(self) -> None:
        """Deregister (revoke lease if dedicated) and remove the handlers."""
        drt = self._drt
        drt.data_plane.unregister(self.endpoint.subject)
        drt.data_plane.unregister(f"{self.endpoint.subject}/stats")
        if self.lease is not drt.primary_lease:
            await self.lease.revoke()
        else:
            await drt.hub.kv_del(self.endpoint.instance_key(self.instance.worker_id))


class EndpointConfigBuilder:
    """Fluent endpoint hosting (reference: component/endpoint.rs
    EndpointConfigBuilder::start)."""

    def __init__(self, endpoint: Endpoint):
        self._endpoint = endpoint
        self._engine: Optional[AsyncEngine] = None
        self._lease = None
        self._metadata: dict[str, Any] = {}
        self._stats_handler: Optional[Callable[[], dict]] = None

    def engine(self, engine: AsyncEngine) -> "EndpointConfigBuilder":
        self._engine = engine
        return self

    def lease(self, lease) -> "EndpointConfigBuilder":
        self._lease = lease
        return self

    def metadata(self, md: dict[str, Any]) -> "EndpointConfigBuilder":
        self._metadata.update(md)
        return self

    def stats_handler(self, fn: Callable[[], dict]) -> "EndpointConfigBuilder":
        """Per-instance load/stats snapshot, scraped by metrics aggregators
        (reference: NATS $SRV.STATS handlers, nats.rs:109-121)."""
        self._stats_handler = fn
        return self

    async def start(self) -> ServedEndpoint:
        ep = self._endpoint
        drt = ep._drt
        if self._engine is None:
            raise ValueError("engine() required")
        handler = Ingress(self._engine)

        await drt.ensure_data_plane()
        drt.data_plane.register(ep.subject, handler)

        lease = self._lease or drt.primary_lease
        worker_id = lease.lease_id  # instance identity == lease identity
        info = InstanceInfo(
            endpoint=ep.subject,
            address=drt.data_plane.address,
            worker_id=worker_id,
            lease_id=lease.lease_id,
            metadata=self._metadata,
        )
        if self._stats_handler is not None:
            drt.register_stats_handler(ep.subject, worker_id, self._stats_handler)
        created = await drt.hub.kv_create(
            ep.instance_key(worker_id), info.pack(), lease=lease
        )
        if not created:
            raise RuntimeError(f"instance {ep.instance_key(worker_id)} already registered")
        log.info("serving %s as instance %x at %s", ep.subject, worker_id, info.address)
        return ServedEndpoint(ep, info, lease)
