"""Distributed component runtime: the port of the JAX package's
`dynamo_tpu/runtime` (reference: lib/runtime/src/lib.rs).

Runtime/DistributedRuntime, Namespace/Component/Endpoint addressing,
lease-based discovery through the built-in hub (`runtime.hub`, in place of
external etcd/NATS), the TCP data plane (`runtime.network`), discovery
clients with transport resilience (`runtime.client`, `runtime.resilience`)
and the typed streaming pipeline (`runtime.pipeline`). Every frame is
msgpack on the port's own `utils/msgpack.py`, byte-compatible with the JAX
package's wire.
"""

__all__ = [
    "Runtime",
    "Worker",
    "DistributedRuntime",
    "Namespace",
    "Component",
    "Endpoint",
]


def __getattr__(name):  # lazy to keep `import dynamo_tpu_torch.runtime.hub` light
    if name in ("Runtime", "Worker"):
        from dynamo_tpu_torch.runtime import runtime as _m

        return getattr(_m, name)
    if name in ("DistributedRuntime",):
        from dynamo_tpu_torch.runtime import distributed as _m

        return getattr(_m, name)
    if name in ("Namespace", "Component", "Endpoint"):
        from dynamo_tpu_torch.runtime import component as _m

        return getattr(_m, name)
    raise AttributeError(name)
