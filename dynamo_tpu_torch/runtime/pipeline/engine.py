"""AsyncEngine protocol and operator composition.

The reference models its pipeline as a typed bidirectional graph with
forward/backward edges (reference: lib/runtime/src/pipeline/nodes.rs:70-139,
engine.rs:103-110). The Python-idiomatic equivalent used here:

- an **engine** is anything with ``generate(Context[In]) -> AsyncIterator[Out]``;
- an **operator** is middleware: ``generate(Context[In], next_engine)`` that
  transforms the request (forward edge), invokes the downstream engine, and
  transforms the response stream (backward edge);
- ``link(op1, op2, ..., engine)`` folds operators around the terminal engine
  and returns a plain engine (reference `link()` chaining, pipeline.rs).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, AsyncIterator, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.pipeline.context import Context


@runtime_checkable
class AsyncEngine(Protocol):
    async def generate(self, request: Context) -> AsyncIterator[Any]: ...


class Operator(ABC):
    """Request/response-stream transforming middleware."""

    @abstractmethod
    async def generate(
        self, request: Context, next_engine: AsyncEngine
    ) -> AsyncIterator[Any]: ...


class _Linked:
    __slots__ = ("_operator", "_next")

    def __init__(self, operator: Operator, next_engine: AsyncEngine):
        self._operator = operator
        self._next = next_engine

    async def generate(self, request: Context) -> AsyncIterator[Any]:
        return await self._operator.generate(request, self._next)


def link(*stages: Operator | AsyncEngine) -> AsyncEngine:
    """Compose operators around a terminal engine: link(a, b, engine)."""
    if not stages:
        raise ValueError("link() needs at least a terminal engine")
    engine = stages[-1]
    if isinstance(engine, Operator):
        raise TypeError("last stage must be an engine, not an Operator")
    for stage in reversed(stages[:-1]):
        if not isinstance(stage, Operator):
            raise TypeError(f"intermediate stage {stage!r} must be an Operator")
        engine = _Linked(stage, engine)
    return engine


class LambdaEngine:
    """Wrap an async-generator function as an engine (test/echo backends;
    reference: lib/runtime/tests/common/engines.rs LlmdbaEngine)."""

    def __init__(self, fn):
        self._fn = fn

    async def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._fn(request)
