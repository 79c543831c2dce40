"""Trace schema + seeded deterministic arrival-process generators.

A trace is an ordered list of request records — ``{arrival_ts, tenant,
priority, isl, osl, workload, prefix_group, sampling}`` — serialized as
JSONL with a leading meta line. Generators are DETERMINISTIC: the same
seed and parameters produce a byte-identical trace file (the
reproducibility contract Mooncake/Sarathi-style trace evaluation rests
on), so a scenario run can always be replayed from the dumped file.

Arrival processes:

- :func:`poisson_trace` — constant-rate open-loop Poisson arrivals
  (exponential inter-arrival gaps);
- :func:`bursty_trace` — nonhomogeneous Poisson via thinning: the
  offered rate swings sinusoidally between ``base_rps`` and
  ``peak_rps`` with period ``period_s`` (a compressed diurnal curve);
- :func:`shared_prefix_trace` — multi-tenant mix where every tenant's
  requests share a per-tenant prefix group (system prompt / few-shot
  template shape; same trace shape ``scripts/prefix_fleet.py`` replays
  at fleet scale).

ISL/OSL may be a fixed int or an inclusive ``(lo, hi)`` range sampled
per request from the seeded stream.

The JAX package's `loadgen/trace.py`, copied so the port stands alone: the
same seed and parameters give the reference's bytes and sha256.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

Lengths = Union[int, tuple]

# float fields are rounded before serialization so a record's JSON is a
# pure function of the generator inputs (repr drift would break the
# byte-identity contract)
_TS_DECIMALS = 6


@dataclass(frozen=True)
class TraceRecord:
    """One request arrival. ``arrival_ts`` is seconds since trace start;
    the driver replays it open-loop (sleep-until, never completion-gated)."""

    arrival_ts: float
    tenant: str = "default"
    priority: int = 0
    isl: int = 64
    osl: int = 16
    workload: str = "chat"
    prefix_group: Optional[str] = None
    sampling: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["arrival_ts"] = round(float(d["arrival_ts"]), _TS_DECIMALS)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRecord":
        return cls(
            arrival_ts=float(d["arrival_ts"]),
            tenant=d.get("tenant", "default"),
            priority=int(d.get("priority", 0)),
            isl=int(d["isl"]),
            osl=int(d["osl"]),
            workload=d.get("workload", "chat"),
            prefix_group=d.get("prefix_group"),
            sampling=dict(d.get("sampling") or {}),
        )


@dataclass
class Trace:
    """Ordered records + generator metadata (seed, params — enough to
    regenerate the identical trace without the file)."""

    records: list[TraceRecord] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def duration_s(self) -> float:
        return self.records[-1].arrival_ts if self.records else 0.0

    def dumps(self) -> str:
        """Canonical JSONL text: meta line then one record per line.
        Same trace -> same bytes (sorted keys, fixed float rounding)."""
        lines = [json.dumps({"trace_meta": self.meta}, sort_keys=True,
                            separators=(",", ":"))]
        lines.extend(
            json.dumps(r.to_dict(), sort_keys=True, separators=(",", ":"))
            for r in self.records
        )
        return "\n".join(lines) + "\n"

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def loads(cls, text: str) -> "Trace":
        meta: dict = {}
        records = []
        for line in text.splitlines():
            if not line.strip():
                continue
            d = json.loads(line)
            if "trace_meta" in d:
                meta = d["trace_meta"]
                continue
            records.append(TraceRecord.from_dict(d))
        return cls(records=records, meta=meta)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.loads(f.read())

    def sha256(self) -> str:
        """Content hash of the canonical serialization — the identity a
        scenario result reports so reruns are provably the same load."""
        return hashlib.sha256(self.dumps().encode()).hexdigest()[:16]

    def summary(self) -> dict:
        """Compact description for a scenario's result section. Meta
        keys come first so the computed fields always win a name
        collision (shared_prefix meta carries a `tenants` COUNT that
        must not clobber the computed tenant-name list)."""
        return {
            **{k: v for k, v in self.meta.items() if k != "params"},
            "n": len(self.records),
            "duration_s": round(self.duration_s, 4),
            "tenants": sorted({r.tenant for r in self.records}),
            "isl_mean": round(
                float(np.mean([r.isl for r in self.records])), 1
            ) if self.records else None,
            "osl_mean": round(
                float(np.mean([r.osl for r in self.records])), 1
            ) if self.records else None,
            "sha256": self.sha256(),
        }


def _seed32(*parts) -> int:
    """Stable 32-bit seed from arbitrary parts (hash() is salted per
    process — useless for reproducibility)."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:4], "big")


def _pick_len(rng: np.random.RandomState, spec: Lengths) -> int:
    if isinstance(spec, (tuple, list)):
        lo, hi = int(spec[0]), int(spec[1])
        return int(rng.randint(lo, hi + 1))
    return int(spec)


def _pick_tenant(
    rng: np.random.RandomState, tenants: Sequence
) -> tuple[str, int]:
    """tenants: sequence of "name" or (name, priority [, weight])."""
    names, prios, weights = [], [], []
    for t in tenants:
        if isinstance(t, str):
            names.append(t); prios.append(0); weights.append(1.0)
        else:
            names.append(t[0])
            prios.append(int(t[1]) if len(t) > 1 else 0)
            weights.append(float(t[2]) if len(t) > 2 else 1.0)
    p = np.asarray(weights) / sum(weights)
    i = int(rng.choice(len(names), p=p))
    return names[i], prios[i]


def poisson_trace(
    n: int,
    rate_rps: float,
    seed: int = 0,
    isl: Lengths = 64,
    osl: Lengths = 16,
    tenants: Sequence = ("default",),
    workload: str = "chat",
    sampling: Optional[dict] = None,
) -> Trace:
    """Constant-rate Poisson arrivals: n requests at `rate_rps`."""
    rng = np.random.RandomState(_seed32("poisson", seed))
    t = 0.0
    records = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate_rps))
        tenant, prio = _pick_tenant(rng, tenants)
        records.append(TraceRecord(
            arrival_ts=round(t, _TS_DECIMALS),
            tenant=tenant, priority=prio,
            isl=_pick_len(rng, isl), osl=_pick_len(rng, osl),
            workload=workload, sampling=dict(sampling or {}),
        ))
    return Trace(records=records, meta={
        "arrival": "poisson", "seed": seed, "rate_rps": rate_rps,
        "workload": workload,
    })


def bursty_trace(
    n: int,
    base_rps: float,
    peak_rps: float,
    period_s: float,
    seed: int = 0,
    isl: Lengths = 64,
    osl: Lengths = 16,
    tenants: Sequence = ("default",),
    workload: str = "bursty",
    sampling: Optional[dict] = None,
) -> Trace:
    """Modulated-rate (compressed-diurnal) arrivals via Poisson thinning:
    candidates arrive at `peak_rps`, each kept with probability
    rate(t)/peak where rate(t) swings sinusoidally base..peak. The first
    burst crest lands at t=period/2, so a short trace still contains one
    full trough->crest->trough swing."""
    if peak_rps < base_rps:
        raise ValueError("peak_rps must be >= base_rps")
    rng = np.random.RandomState(_seed32("bursty", seed))
    t = 0.0
    records = []
    while len(records) < n:
        t += float(rng.exponential(1.0 / peak_rps))
        rate = base_rps + (peak_rps - base_rps) * (
            0.5 - 0.5 * math.cos(2.0 * math.pi * t / period_s)
        )
        if float(rng.uniform()) >= rate / peak_rps:
            continue
        tenant, prio = _pick_tenant(rng, tenants)
        records.append(TraceRecord(
            arrival_ts=round(t, _TS_DECIMALS),
            tenant=tenant, priority=prio,
            isl=_pick_len(rng, isl), osl=_pick_len(rng, osl),
            workload=workload, sampling=dict(sampling or {}),
        ))
    return Trace(records=records, meta={
        "arrival": "bursty", "seed": seed, "base_rps": base_rps,
        "peak_rps": peak_rps, "period_s": period_s, "workload": workload,
    })


def shared_prefix_trace(
    tenants: int,
    per_tenant: int,
    rate_rps: float,
    seed: int = 0,
    isl: Lengths = 64,
    osl: Lengths = 16,
    workload: str = "shared_prefix",
    priority_of: Optional[dict] = None,
) -> Trace:
    """Multi-tenant shared-prefix mix: `tenants` groups, each with its
    own prefix_group (`PromptFactory` derives identical prefix tokens
    for every request in a group), Poisson arrivals with the tenant
    sequence shuffled so groups interleave — the first serve of each
    group is its cold miss, later ones are warm."""
    rng = np.random.RandomState(_seed32("shared_prefix", seed))
    order = [t for t in range(tenants) for _ in range(per_tenant)]
    rng.shuffle(order)
    t = 0.0
    records = []
    for tenant_i in order:
        t += float(rng.exponential(1.0 / rate_rps))
        name = f"tenant{tenant_i}"
        records.append(TraceRecord(
            arrival_ts=round(t, _TS_DECIMALS),
            tenant=name,
            priority=int((priority_of or {}).get(name, 0)),
            isl=_pick_len(rng, isl), osl=_pick_len(rng, osl),
            workload=workload, prefix_group=f"group{tenant_i}",
        ))
    return Trace(records=records, meta={
        "arrival": "shared_prefix", "seed": seed, "rate_rps": rate_rps,
        "tenants": tenants, "per_tenant": per_tenant, "workload": workload,
    })
