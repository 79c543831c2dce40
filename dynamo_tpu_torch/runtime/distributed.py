"""DistributedRuntime: the per-process handle to the distributed system.

Equivalent of the reference's DistributedRuntime
(reference: lib/runtime/src/distributed.rs:32-187): wraps a `Runtime` with a
hub connection (discovery + events + queues), a primary lease whose expiry is
the process's liveness signal, and a lazily-started data-plane server for
hosted endpoints. `is_static` mode skips the hub entirely for fixed-topology
deployments.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from dynamo_tpu_torch.runtime.component import Namespace, pack_payload
from dynamo_tpu_torch.runtime.hub.client import HubClient, Lease
from dynamo_tpu_torch.runtime.network import DataPlaneClient, DataPlaneServer
from dynamo_tpu_torch.runtime.runtime import Runtime
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.distributed")

DEFAULT_LEASE_TTL_S = 5.0


class DistributedRuntime:
    def __init__(self, runtime: Runtime):
        self.runtime = runtime
        self.hub: Optional[HubClient] = None
        self.primary_lease: Optional[Lease] = None
        self.data_plane = DataPlaneServer()
        self.data_plane_client = DataPlaneClient()
        self.is_static = False
        self._data_plane_started = False
        self._instance_down_hooks: list[Callable] = []

    @classmethod
    async def from_settings(
        cls,
        runtime: Optional[Runtime] = None,
        hub_addr: Optional[str] = None,
        lease_ttl: float = DEFAULT_LEASE_TTL_S,
    ) -> "DistributedRuntime":
        self = cls(runtime or Runtime())
        self.hub = await HubClient.connect(hub_addr)
        # threaded keepalive: a graph capture or a device sync blocking
        # this loop for longer than the TTL must not kill the worker's
        # liveness
        self.primary_lease = await self.hub.lease_grant(
            ttl=lease_ttl, keepalive="thread"
        )
        log.info(
            "distributed runtime up: hub=%s primary_lease=%#x",
            self.hub.addr,
            self.primary_lease.lease_id,
        )
        return self

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    @property
    def worker_id(self) -> int:
        if self.primary_lease is not None:
            return self.primary_lease.lease_id
        return self.runtime.worker_id

    async def ensure_data_plane(self) -> None:
        if not self._data_plane_started:
            await self.data_plane.start()
            self._data_plane_started = True

    def register_stats_handler(
        self, subject: str, worker_id: int, fn: Callable[[], dict]
    ) -> None:
        """Expose a stats snapshot at `{subject}/stats` on the data plane
        (reference: NATS service stats handlers, component/endpoint.rs)."""

        async def _handler(ctx):
            async def _one():
                yield pack_payload(fn())

            return _one()

        self.data_plane.register(f"{subject}/stats", _handler)

    def notify_instance_down(self, endpoint_id, worker_id: int) -> None:
        for hook in self._instance_down_hooks:
            try:
                hook(endpoint_id, worker_id)
            except Exception:  # noqa: BLE001
                log.exception("instance-down hook failed")

    def on_instance_down(self, hook: Callable) -> None:
        self._instance_down_hooks.append(hook)

    async def shutdown(self) -> None:
        self.runtime.shutdown()
        await self.data_plane.stop()
        await self.data_plane_client.close()
        if self.primary_lease is not None:
            await self.primary_lease.revoke()
        if self.hub is not None:
            await self.hub.close()
        await self.runtime.drain_background()
