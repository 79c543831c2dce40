"""Process runtime: event loop ownership, cancellation, worker bootstrap.

Equivalent of the reference's Runtime + Worker pair
(reference: lib/runtime/src/runtime.rs:39-121, worker.rs:60-211). Where the
reference manages two tokio runtimes, here a single asyncio loop carries both
foreground work and background hub tasks, and the lease keepalive runs on a
thread of its own (`hub.client.KeepaliveThread`): a CUDA engine enqueues its
dispatches inline on this loop (`dynamo_tpu_torch.engine`).
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
import uuid
from typing import Awaitable, Callable, Optional

from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("dynamo_tpu_torch.runtime")


class CancellationToken:
    """Hierarchical cancellation: cancelling a parent cancels all children.

    Mirrors tokio's CancellationToken used as the runtime's root token
    (reference: lib/runtime/src/runtime.rs primary token).
    """

    def __init__(self, parent: Optional["CancellationToken"] = None):
        self._event = asyncio.Event()
        self._children: list[CancellationToken] = []
        self._parent = parent
        if parent is not None:
            parent._children.append(self)
            if parent.is_cancelled():
                self._event.set()

    def child_token(self) -> "CancellationToken":
        return CancellationToken(self)

    def cancel(self) -> None:
        if self._event.is_set():
            return
        self._event.set()
        for child in self._children:
            child.cancel()

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    async def cancelled(self) -> None:
        await self._event.wait()

    def detach(self) -> None:
        if self._parent is not None:
            with contextlib.suppress(ValueError):
                self._parent._children.remove(self)
            self._parent = None


class Runtime:
    """Owns the process's worker identity and root cancellation token."""

    def __init__(self) -> None:
        configure_logging()
        self.worker_id: int = uuid.uuid4().int & 0x7FFF_FFFF_FFFF_FFFF
        self._root = CancellationToken()
        self._background: set[asyncio.Task] = set()

    def primary_token(self) -> CancellationToken:
        return self._root

    def child_token(self) -> CancellationToken:
        return self._root.child_token()

    def shutdown(self) -> None:
        log.info("runtime shutdown requested")
        self._root.cancel()

    def is_shutdown(self) -> bool:
        return self._root.is_cancelled()

    def spawn(self, coro: Awaitable) -> asyncio.Task:
        """Track a background task; exceptions are logged, not dropped."""
        task = asyncio.ensure_future(coro)
        self._background.add(task)

        def _done(t: asyncio.Task) -> None:
            self._background.discard(t)
            if not t.cancelled() and t.exception() is not None:
                log.error("background task failed", exc_info=t.exception())

        task.add_done_callback(_done)
        return task

    async def drain_background(self) -> None:
        for task in list(self._background):
            task.cancel()
        if self._background:
            await asyncio.gather(*self._background, return_exceptions=True)


class Worker:
    """Process entrypoint wrapper: builds a Runtime, runs the async main under
    signal handling, cancels the root token on SIGINT/SIGTERM and waits for
    graceful drain (reference: lib/runtime/src/worker.rs:60-211).
    """

    def __init__(self) -> None:
        self.runtime = Runtime()

    def execute(self, main: Callable[[Runtime], Awaitable[None]]) -> None:
        asyncio.run(self._run(main))

    async def _run(self, main: Callable[[Runtime], Awaitable[None]]) -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, self.runtime.shutdown)
        try:
            await main(self.runtime)
        finally:
            self.runtime.shutdown()
            await self.runtime.drain_background()
