"""Typed streaming pipeline: the request Context."""

from dynamo_tpu_torch.runtime.pipeline.context import Context, StreamController
