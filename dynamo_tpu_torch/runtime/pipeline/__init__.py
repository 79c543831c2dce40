"""Typed streaming pipeline: the request Context, AsyncEngine, Operators."""

from dynamo_tpu_torch.runtime.pipeline.context import Context, StreamController
from dynamo_tpu_torch.runtime.pipeline.engine import AsyncEngine, Operator, link

__all__ = ["Context", "StreamController", "AsyncEngine", "Operator", "link"]
