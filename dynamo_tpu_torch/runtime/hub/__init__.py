"""The hub: the port's built-in control plane (the JAX package's
`dynamo_tpu/runtime/hub`, ported: the same wire, byte for byte, so a port
client works against the JAX package's server and the reverse).

One lightweight asyncio TCP service providing everything the reference gets
from external etcd + NATS processes (reference: lib/runtime/src/transports/
{etcd.rs,nats.rs}):

- lease-based key-value store with prefix watch (discovery / liveness),
- create-if-absent transactions,
- pub/sub subjects (events plane, e.g. KV-cache events),
- durable FIFO queues with competing consumers (prefill queue),
- an object store (model deployment card artifacts).

Wire format is 4-byte length-prefixed msgpack frames (`codec.py`, on the
port's plain-Python `utils/msgpack.py`). The hub is intentionally a
single-process, single-loop service: control traffic is orders of magnitude
below its capacity, and a single loop gives linearizable semantics for free.
"""

from dynamo_tpu_torch.runtime.hub.server import HubServer
from dynamo_tpu_torch.runtime.hub.client import HubClient, Lease, PrefixWatch, Subscription

__all__ = ["HubServer", "HubClient", "Lease", "PrefixWatch", "Subscription"]
