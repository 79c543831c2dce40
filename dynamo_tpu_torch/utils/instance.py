"""Stable per-process instance identity.

Multi-worker observability needs ONE id that joins everything a process
emits: JSONL log records, Prometheus series, hub instance registration
metadata, and the merged trace's process tracks. This module mints it —
once, lazily — as ``<hostname>-<pid hex>-<4 random hex>`` (override with
``DYN_WORKER_ID`` for deployments that already name their pods), and
every layer reads it from here instead of inventing its own.

Distinct from the hub's numeric lease-derived ``worker_id`` (an
InstanceInfo field that only exists once a lease is granted): this label
exists from engine start, survives hub reconnects, and is printable in a
Prometheus label. The hub registration *echoes* it in InstanceInfo
metadata so fleet tooling can join the two.
"""

from __future__ import annotations

import os
import socket
import uuid
from typing import Optional

_worker_id: Optional[str] = None


def worker_id() -> str:
    """The process's stable instance label (minted on first call)."""
    global _worker_id
    if _worker_id is None:
        _worker_id = os.environ.get("DYN_WORKER_ID") or (
            f"{socket.gethostname()}-{os.getpid():x}-{uuid.uuid4().hex[:4]}"
        )
    return _worker_id


def set_worker_id(value: Optional[str]) -> None:
    """Override the label (tests; None re-arms lazy minting)."""
    global _worker_id
    _worker_id = value
