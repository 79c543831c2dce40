"""Request context: id, payload, metadata, cancellation controller.

Equivalent of the reference's `Context<T>` + `AsyncEngineContext`
(reference: lib/runtime/src/pipeline/context.rs:33-95, engine.rs:46-86).
A Context wraps a request payload with a stable request id, a typed-ish
metadata map that survives process hops (serialized alongside the payload on
the data plane), and a two-level cancellation controller:

- ``stop_generating()`` — graceful: the engine should finish the current
  token and emit a final response with finish_reason=cancelled;
- ``kill()`` — hard: stop emitting immediately.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, Generic, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class StreamController:
    def __init__(self) -> None:
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()

    def stop_generating(self) -> None:
        self._stopped.set()

    def kill(self) -> None:
        self._stopped.set()
        self._killed.set()

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def stopped(self) -> None:
        await self._stopped.wait()


class LinkedController(StreamController):
    """Child controller that also observes its parent: a parent
    stop/kill applies to every fork, a child's stop stays local (n>1
    fan-out — one finished choice must not cancel its siblings)."""

    def __init__(self, parent: StreamController) -> None:
        super().__init__()
        self._parent = parent

    def is_stopped(self) -> bool:
        return super().is_stopped() or self._parent.is_stopped()

    def is_killed(self) -> bool:
        return super().is_killed() or self._parent.is_killed()

    async def stopped(self) -> None:
        own = asyncio.ensure_future(self._stopped.wait())
        par = asyncio.ensure_future(self._parent.stopped())
        try:
            await asyncio.wait({own, par}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            own.cancel()
            par.cancel()


class Context(Generic[T]):
    __slots__ = ("payload", "id", "metadata", "controller")

    def __init__(
        self,
        payload: T,
        request_id: Optional[str] = None,
        metadata: Optional[dict[str, Any]] = None,
        controller: Optional[StreamController] = None,
    ):
        self.payload = payload
        self.id = request_id or uuid.uuid4().hex
        self.metadata = metadata if metadata is not None else {}
        self.controller = controller or StreamController()

    def map(self, payload: U) -> "Context[U]":
        """New payload, same id/metadata/controller (forward-edge transform)."""
        ctx: Context[U] = Context.__new__(Context)
        ctx.payload = payload
        ctx.id = self.id
        ctx.metadata = self.metadata
        ctx.controller = self.controller
        return ctx

    def fork(self, payload: U, suffix: str) -> "Context[U]":
        """Child context with its own stop control (linked to this one):
        used by n>1 fan-out so one choice's finish doesn't cancel its
        siblings while a client disconnect still cancels all."""
        ctx: Context[U] = Context.__new__(Context)
        ctx.payload = payload
        ctx.id = f"{self.id}-{suffix}"
        ctx.metadata = self.metadata
        ctx.controller = LinkedController(self.controller)
        return ctx

    # controller passthroughs
    def stop_generating(self) -> None:
        self.controller.stop_generating()

    def kill(self) -> None:
        self.controller.kill()

    def is_stopped(self) -> bool:
        return self.controller.is_stopped()

    def is_killed(self) -> bool:
        return self.controller.is_killed()

    def __repr__(self) -> str:
        return f"Context(id={self.id!r}, payload={type(self.payload).__name__})"
