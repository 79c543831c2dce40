"""RAII object pool.

Equivalent of the reference's pool utility (reference: lib/runtime/src/utils/pool.rs:23-250):
items are checked out of a pool and automatically returned when released; a
shared (ref-counted) wrapper allows multiple holders. It holds the host
offload tier's page buffers (`dynamo_tpu_torch.engine.offload`).

Python adaptation: instead of Drop we use explicit ``release()`` plus context
managers; `SharedPoolItem` refcounts and returns on last release.
"""

from __future__ import annotations

import asyncio
import collections
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class PoolItem(Generic[T]):
    """A uniquely-held pool item; returns to its pool on release."""

    __slots__ = ("_value", "_pool", "_released")

    def __init__(self, value: T, pool: "Pool[T]"):
        self._value = value
        self._pool = pool
        self._released = False

    @property
    def value(self) -> T:
        if self._released:
            raise RuntimeError("pool item already released")
        return self._value

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._pool._return(self._value)

    def take(self) -> T:
        """Detach the value from the pool permanently."""
        if self._released:
            raise RuntimeError("pool item already released")
        self._released = True
        self._pool._on_take()
        return self._value

    def share(self) -> "SharedPoolItem[T]":
        if self._released:
            raise RuntimeError("pool item already released")
        self._released = True
        return SharedPoolItem(self._value, self._pool)

    def __enter__(self) -> T:
        return self.value

    def __exit__(self, *exc) -> None:
        self.release()


class SharedPoolItem(Generic[T]):
    """Ref-counted pool item; returns to pool when the last clone is released."""

    __slots__ = ("_value", "_pool", "_count")

    def __init__(self, value: T, pool: "Pool[T]"):
        self._value = value
        self._pool = pool
        self._count = [1]

    @property
    def value(self) -> T:
        return self._value

    def clone(self) -> "SharedPoolItem[T]":
        other = SharedPoolItem.__new__(SharedPoolItem)
        other._value = self._value
        other._pool = self._pool
        other._count = self._count
        self._count[0] += 1
        return other

    def release(self) -> None:
        self._count[0] -= 1
        if self._count[0] == 0:
            self._pool._return(self._value)


class Pool(Generic[T]):
    """Async-aware FIFO pool with optional capacity and factory.

    ``acquire()`` returns an existing item or creates one via the factory if
    under capacity; otherwise it waits until an item is returned.
    """

    def __init__(
        self,
        factory: Optional[Callable[[], T]] = None,
        capacity: Optional[int] = None,
        initial: Optional[list[T]] = None,
    ):
        self._factory = factory
        self._capacity = capacity
        self._free: collections.deque[T] = collections.deque(initial or [])
        self._created = len(self._free)
        self._waiters: collections.deque[asyncio.Future] = collections.deque()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def total(self) -> int:
        return self._created

    def try_acquire(self) -> Optional[PoolItem[T]]:
        if self._free:
            return PoolItem(self._free.popleft(), self)
        if self._factory is not None and (
            self._capacity is None or self._created < self._capacity
        ):
            self._created += 1
            return PoolItem(self._factory(), self)
        return None

    async def acquire(self) -> PoolItem[T]:
        item = self.try_acquire()
        if item is not None:
            return item
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        value = await fut
        return PoolItem(value, self)

    def _return(self, value: T) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(value)
                return
        self._free.append(value)

    def _on_take(self) -> None:
        self._created -= 1
