"""The port's KV custody ledger (`dynamo_tpu_torch/engine/kv_ledger.py`) on
the port's allocator and host pool, against the JAX package's ledger on
its own, fed the same operations (after `tests/test_kv_ledger.py`):

- a seeded fuzz of allocations, registrations, pins, releases (legitimate
  and misused: double releases, unknown ids), cache clears, forgotten
  drops and finished owners, audited as it goes: both ledgers raise the
  same violations and give the same snapshots, summaries and counters;
- the host tier's custody stamps through each package's `HostKvPool`, and
  a host index that loses an entry behind the ledger's back;
- in-flight windows past their deadline, audited on an injected clock;
- the quiesce census over stand-in engines;
- the Prometheus families, zero-series first.

The engine's holds and drops are driven in tests/test_torch_robustness.py
(the release-fault leak) and by every engine test (the audit runs at its
default period)."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_ledger as jled
from dynamo_tpu.engine.allocator import PageAllocator as JaxAllocator
from dynamo_tpu.engine.offload import HostKvPool as JaxHostPool
from dynamo_tpu_torch.engine import kv_ledger as pled
from dynamo_tpu_torch.engine.allocator import PageAllocator
from dynamo_tpu_torch.engine.offload import HostKvPool

PAGE = 4
IMPLS = {"jax": (jled, JaxAllocator), "torch": (pled, PageAllocator)}


def _snap(ledger) -> dict:
    """A snapshot without wall-clock fields."""
    snap = ledger.snapshot(top_n=50)
    for v in snap["violations"]:
        v.pop("ts_unix")
    for w in snap["inflight"]:
        w.pop("age_s")
    return snap


def _fuzz(mod, alloc_cls, seed: int, steps: int = 600):
    rng = random.Random(seed)
    ledger = mod.KvLedger()
    alloc = alloc_cls(24, PAGE, ledger=ledger)
    refs: list[tuple[int, str]] = []
    next_hash = 1000
    trace = []
    for step in range(steps):
        op = rng.random()
        owner = f"req-{rng.randrange(5)}"
        if op < 0.28:
            got = alloc.allocate(rng.randrange(1, 5))
            if got is not None:
                refs.extend((pid, owner) for pid in got)
                ledger.hold(got, owner, tenant=f"t{len(owner) % 2}")
            trace.append(("alloc", got))
        elif op < 0.42:
            cands = sorted(p for p, m in alloc._meta.items()
                           if m.refs > 0 and m.sequence_hash is None)
            if cands:
                pid = rng.choice(cands)
                next_hash += 1
                alloc.register([pid], [(next_hash, next_hash)], None)
        elif op < 0.55:
            hashes = sorted(alloc._by_hash) if hasattr(alloc, "_by_hash") else []
            if hashes:
                pid = alloc.pin(rng.choice(hashes))
                if pid is not None:
                    refs.append((pid, owner))
                    ledger.hold([pid], owner)
                trace.append(("pin", pid))
        elif op < 0.80:
            if refs:
                pid, who = refs.pop(rng.randrange(len(refs)))
                alloc.release([pid])
                if rng.random() < 0.05:
                    trace.append(("forgot", pid))  # a drop the holder never made
                else:
                    ledger.drop([pid], who)
        elif op < 0.84:
            alloc.clear_cache()
        elif op < 0.88:
            # misuse: an unknown id, or a page already back to zero refs
            free = sorted(alloc._free)
            alloc.release([rng.choice(free) if free and rng.random() < 0.5 else 999])
        elif op < 0.93:
            ledger.request_finished(owner)
        else:
            trace.append(("audit", [(v.kind, v.owner, v.page_ids, v.detail)
                                    for v in ledger.audit()]))
    return trace, _snap(ledger), ledger.summary_counts(), list(ledger.render_prom())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_against_jax_ledger(seed):
    got = {impl: _fuzz(mod, cls, seed) for impl, (mod, cls) in IMPLS.items()}
    assert got["torch"] == got["jax"]
    trace, snap, summary, _ = got["torch"]
    assert summary["audits"] > 0 and snap["churn"]["alloc"] > 0


def _host_run(mod, alloc_cls, pool_cls, **pool_kw):
    ledger = mod.KvLedger()
    alloc = alloc_cls(8, PAGE, ledger=ledger)
    pool = pool_cls(3, 2, PAGE, 8, **pool_kw)
    pool.ledger = ledger
    ledger.host_pool = pool
    out = []
    for h in range(1, 6):  # five puts into three buffers: two LRU evictions
        buf = pool.reserve()
        pool.put(h, h, h - 1 or None, buf)
    out.append([(v.kind, v.detail) for v in ledger.audit()])
    # an index entry lost behind the ledger's back: suspect once, then flagged
    pool._entries.popitem(last=False)
    out.append([(v.kind, v.detail) for v in ledger.audit()])
    out.append([(v.kind, v.detail) for v in ledger.audit()])
    return out, _snap(ledger)


def test_host_custody_equal():
    jax_out = _host_run(jled, JaxAllocator, JaxHostPool, dtype=np.float32)
    port_out = _host_run(pled, PageAllocator, HostKvPool, dtype=torch.float32)
    assert port_out == jax_out
    audits = port_out[0]
    assert audits[0] == [] and audits[1] == []
    assert audits[2] == [("host_orphan", "custody-not-indexed=1 indexed-not-custody=0")]
    assert port_out[1]["tiers"]["host"] == {"indexed": 2, "custody": 3}
    assert port_out[1]["churn"]["host_store"] == 5 and port_out[1]["churn"]["host_evict"] == 2


def test_inflight_deadline_equal():
    got = {}
    for impl, (mod, cls) in IMPLS.items():
        ledger = mod.KvLedger(inflight_deadline_s=5.0)
        ledger.inflight_begin("pull-1", owner="req-9", plane="export")
        ledger.inflight_begin("pull-2", owner="req-8", plane="ingest", deadline_s=100.0)
        t0 = ledger._inflight["pull-1"]["t0"]
        early = ledger.audit(now=t0 + 1.0)
        late = ledger.audit(now=t0 + 6.0)
        again = ledger.audit(now=t0 + 7.0)  # one incident, one violation
        ledger.inflight_end("pull-1")
        got[impl] = ([v.kind for v in early], [(v.kind, v.owner) for v in late],
                     len(again), ledger.summary_counts())
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == [("inflight_expired", "req-9")]


class _Stub:
    """An engine as the census reads it: its ledger, queues and slots."""

    def __init__(self, mod, cls, leak: bool):
        self.kv_ledger = mod.KvLedger()
        alloc = cls(8, PAGE, ledger=self.kv_ledger)
        self.kv_ledger.allocator = alloc
        self.waiting, self.slots, self._prefilling, self._closed = [], [None], [], False
        pages = alloc.allocate(2)
        self.kv_ledger.hold(pages, "req-x")
        if not leak:
            alloc.release(pages)
            self.kv_ledger.drop(pages, "req-x")
        self.kv_ledger.request_finished("req-x")


def test_quiesce_census_equal():
    got = {}
    for impl, (mod, cls) in IMPLS.items():
        engines = [_Stub(mod, cls, leak=False), _Stub(mod, cls, leak=True)]
        census = mod.quiesce_census(engines, wait_s=0.0)
        for e in census["per_engine"]:
            for v in e["violations"]:
                v.pop("ts_unix")
        got[impl] = census
    assert got["torch"] == got["jax"]
    assert got["torch"]["ok"] is False and got["torch"]["orphan_pages"] == [1, 2]


def test_prom_families_and_zero_series_equal():
    got = {impl: list(mod.KvLedger().render_prom()) for impl, (mod, _) in IMPLS.items()}
    assert got["torch"] == got["jax"]
    text = "\n".join(got["torch"])
    for kind in pled.VIOLATION_KINDS:
        assert f'kind="{kind}"' in text
    for ev in pled.TRANSITION_EVENTS:
        assert f'event="{ev}"' in text
