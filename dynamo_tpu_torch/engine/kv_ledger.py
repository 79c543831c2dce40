"""KV page-lifecycle ledger: event-sourced custody + the zero-orphan census
(a copy of the JAX package's `engine/kv_ledger.py`; the port stamps the
device allocator, the host offload tier, the prefix wire and the
device-path transfer).

Every KV page moves through six planes — the device allocator, the host
offload tier, cross-worker export/ingest pulls, the disagg handoff, the
failover replay, and the packed int8/int4 pools — but until now
accounting was derived gauges plus one test-time pool-identity check.
This module makes page custody a first-class audited ledger:

- **Transitions.** The `PageAllocator` stamps every lifecycle edge
  (alloc / evict / pin / register / cache / free / clear) into the
  ledger at O(1) per transition; the host pool stamps store/evict; the
  transfer planes stamp xfer counters. Each page keeps a bounded trail
  of its last transitions for forensics.
- **Holdings.** Every party that holds page references — a request
  (`_reserve_pages` .. `_finish`), or a system plane (`sys:offload`,
  `sys:ingest`, `sys:export`) — records the hold and the drop, with
  owner attribution (request id, tenant, plane). Holdings mirror the
  allocator's refcounts; the audit cross-checks them.
- **In-flight windows.** Cross-plane transfers that can strand custody
  (an export stream abandoned mid-frame, a disagg handoff that never
  lands) open a deadline-stamped in-flight window; a window past its
  deadline is a violation.
- **Audit.** A periodic engine-loop audit (``DYN_KV_AUDIT_S``) checks
  the accounting identities continuously (free + cached + used ==
  num_pages − 1; per-page holdings sum to meta refcounts; host custody
  matches the host index) and runs the orphan detector: pages whose
  owning request already finished, host blocks with no index entry,
  in-flight windows past deadline. A violation ticks
  ``kv_ledger_violations_total{kind}``, stamps a ``kv.leak`` trace
  instant, and (via the engine) arms the flight-recorder ``kv_leak``
  trigger so ONE correlated artifact names the orphaned pages and
  their last custody transitions.
- **Census.** `quiesce_census()` is the reusable teardown scorer: wait
  for system holds and in-flight windows to drain, audit twice, and
  assert zero pages held — the chaos scripts (prefix_fleet,
  failover_chaos, control_chaos) all gate on it.

Threading: request-owner holdings mutate only on the engine loop
thread, so orphan detection is race-free and immediate. System planes
(ingest/export run in worker threads) can interleave with an audit, so
the identity / holdings / host checks require a suspect to persist
across **two consecutive audits** before they fire — a transient
mid-operation snapshot never raises a violation.

Module registry: engines register their ledger at init (bounded, weak
refs, unlike the JAX package's strong ones: a ledger reaches its engine
through the allocator's event hook, so a strong entry would keep a dropped
engine's pools on the card) so ``GET /debug/kv`` and the census can reach
every live ledger without holding engine references.
"""

from __future__ import annotations

import os
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dynamo_tpu_torch.llm.http.metrics import Counter
from dynamo_tpu_torch.utils import tracing
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.kv_ledger")

# violation taxonomy — the {kind} label on kv_ledger_violations_total.
# All kinds are declared as zero-series so dashboards can alert on rate().
VIOLATION_KINDS = (
    "double_release",     # allocator.release on a page whose refs are already 0
    "unknown_page",       # allocator.release on a page id with no meta entry
    "identity",           # free + cached + used != num_pages - 1 (or index skew)
    "holdings_mismatch",  # ledger holdings for a page != allocator refcount
    "orphan_page",        # owning request finished but still holds pages
    "host_orphan",        # host custody set disagrees with the host-pool index
    "inflight_expired",   # an in-flight transfer window outlived its deadline
)

# transition taxonomy — the {event} label on kv_ledger_transitions_total
TRANSITION_EVENTS = (
    "alloc", "evict", "pin", "register", "cache", "free", "clear",
    "host_store", "host_evict", "xfer_out", "xfer_in",
)

_TRAIL_LEN = 8          # per-page transition trail depth
_VIOLATION_LOG = 64     # bounded violation log for /debug/kv
_FINISHED_WATCH = 512   # finished-request watch ring


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class Violation:
    kind: str
    owner: str = ""
    page_ids: List[int] = field(default_factory=list)
    detail: str = ""
    ts_unix: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "owner": self.owner,
            "page_ids": list(self.page_ids),
            "detail": self.detail,
            "ts_unix": self.ts_unix,
        }


class KvLedger:
    """Event-sourced custody ledger for one engine's paged KV pool."""

    def __init__(
        self,
        allocator=None,
        host_pool=None,
        prefix: str = "dynamo_tpu",
        inflight_deadline_s: Optional[float] = None,
        on_leak=None,
    ) -> None:
        self.allocator = allocator
        self.host_pool = host_pool
        # page custody: pid -> {owner: count}; owner "sys:*" is a plane
        self._holds: Dict[int, Dict[str, int]] = {}
        self._owner_pages: Dict[str, Set[int]] = {}
        self._owner_tenant: Dict[str, str] = {}
        self._trails: Dict[int, deque] = {}
        self._host_custody: Set = set()  # sequence hashes we believe the host holds
        self._inflight: Dict[str, dict] = {}
        # finished requests that may still hold pages (the orphan watch)
        self._finished: "OrderedDict[str, float]" = OrderedDict()
        # violation dedup: one incident -> one violation
        self._flagged: Set = set()
        # confirm-twice carryover for racy checks (worker-thread planes)
        self._suspects: Dict = {}
        self.violations_log: deque = deque(maxlen=_VIOLATION_LOG)
        self.transition_counts: Dict[str, int] = {ev: 0 for ev in TRANSITION_EVENTS}
        self.audits_total = 0
        self.violations_total = 0
        self.last_orphans: List[int] = []
        self.inflight_deadline_s = (
            inflight_deadline_s
            if inflight_deadline_s is not None
            else _env_float("DYN_KV_INFLIGHT_S", 30.0)
        )
        self.on_leak = on_leak  # callable(Violation) -> None
        self.transitions = Counter(
            f"{prefix}_kv_ledger_transitions_total",
            "KV page lifecycle transitions stamped into the custody ledger",
        )
        for ev in TRANSITION_EVENTS:
            self.transitions.declare(event=ev)
        self.violations = Counter(
            f"{prefix}_kv_ledger_violations_total",
            "KV custody violations by kind (see docs/observability.md)",
        )
        for kind in VIOLATION_KINDS:
            self.violations.declare(kind=kind)
        self.audits = Counter(
            f"{prefix}_kv_ledger_audits_total",
            "completed KV ledger audit passes",
        )
        self.audits.declare()
        register(self)

    # ------------------------------------------------------------------
    # O(1) transition stamps (called from the allocator / host pool)
    # ------------------------------------------------------------------

    def page_event(self, pid: int, event: str, owner: str = "") -> None:
        """Stamp one lifecycle transition for one page. O(1)."""
        self.transition_counts[event] = self.transition_counts.get(event, 0) + 1
        self.transitions.inc(event=event)
        trail = self._trails.get(pid)
        if trail is None:
            trail = self._trails[pid] = deque(maxlen=_TRAIL_LEN)
        trail.append((event, owner))

    def note_transfer(self, event: str, amount: int = 1) -> None:
        """Count pages moved by a cross-engine / cross-process transfer."""
        self.transition_counts[event] = self.transition_counts.get(event, 0) + int(amount)
        self.transitions.inc(amount=float(amount), event=event)

    def host_stored(self, sequence_hash) -> None:
        self._host_custody.add(sequence_hash)
        self.page_event(-1, "host_store")

    def host_removed(self, sequence_hash) -> None:
        self._host_custody.discard(sequence_hash)
        self.page_event(-1, "host_evict")

    # ------------------------------------------------------------------
    # Holdings (owner attribution)
    # ------------------------------------------------------------------

    def hold(
        self,
        page_ids: Sequence[int],
        owner: str,
        tenant: str = "",
        plane: str = "engine",
    ) -> None:
        """Record that `owner` acquired one reference on each page."""
        if not page_ids:
            return
        pages = self._owner_pages.setdefault(owner, set())
        if tenant:
            self._owner_tenant[owner] = tenant
        for pid in page_ids:
            holders = self._holds.get(pid)
            if holders is None:
                holders = self._holds[pid] = {}
            holders[owner] = holders.get(owner, 0) + 1
            pages.add(pid)
        # a re-acquired owner is live again (failover re-admission)
        self._finished.pop(owner, None)

    def drop(self, page_ids: Sequence[int], owner: str) -> None:
        """Record that `owner` released one reference on each page."""
        if not page_ids:
            return
        pages = self._owner_pages.get(owner)
        for pid in page_ids:
            holders = self._holds.get(pid)
            if holders is None:
                continue
            n = holders.get(owner, 0) - 1
            if n > 0:
                holders[owner] = n
                continue
            holders.pop(owner, None)
            if not holders:
                del self._holds[pid]
            if pages is not None:
                pages.discard(pid)
        if pages is not None and not pages:
            self._owner_pages.pop(owner, None)
            self._owner_tenant.pop(owner, None)

    def request_finished(self, owner: str) -> None:
        """Watch a finished request: if it still holds pages, the next
        audit flags them as orphans with this owner's attribution."""
        if owner in self._owner_pages:
            self._finished[owner] = time.monotonic()
            while len(self._finished) > _FINISHED_WATCH:
                self._finished.popitem(last=False)

    def system_held_pages(self) -> int:
        """Pages currently held by sys:* planes (offload/ingest/export)."""
        n = 0
        for owner, pages in self._owner_pages.items():
            if owner.startswith("sys:"):
                n += len(pages)
        return n

    # ------------------------------------------------------------------
    # In-flight transfer windows
    # ------------------------------------------------------------------

    def inflight_begin(
        self,
        key: str,
        owner: str = "",
        plane: str = "",
        deadline_s: Optional[float] = None,
    ) -> None:
        self._inflight[key] = {
            "owner": owner,
            "plane": plane,
            "t0": time.monotonic(),
            "deadline": time.monotonic()
            + (deadline_s if deadline_s is not None else self.inflight_deadline_s),
        }

    def inflight_end(self, key: str) -> None:
        self._inflight.pop(key, None)
        self._flagged.discard(("inflight", key))

    # ------------------------------------------------------------------
    # Violations
    # ------------------------------------------------------------------

    def violation(
        self,
        kind: str,
        owner: str = "",
        page_ids: Sequence[int] = (),
        detail: str = "",
    ) -> Violation:
        v = Violation(kind=kind, owner=owner, page_ids=list(page_ids), detail=detail)
        self.violations_log.append(v)
        self.violations_total += 1
        self.violations.inc(kind=kind)
        tracing.instant(
            "kv.leak", cat="kv",
            req=owner if owner and not owner.startswith("sys:") else None,
            kind=kind, pages=len(v.page_ids), detail=detail,
        )
        log.warning(
            "kv ledger violation kind=%s owner=%s pages=%s detail=%s",
            kind, owner or "-", v.page_ids[:8], detail,
        )
        self._leak_hook(v)
        return v

    def _leak_hook(self, v: "Violation") -> None:
        if self.on_leak is not None:
            try:
                self.on_leak(v)
            except Exception:  # forensics must never break serving
                log.debug("kv ledger on_leak hook failed", exc_info=True)

    # ------------------------------------------------------------------
    # Audit
    # ------------------------------------------------------------------

    def audit(self, now: Optional[float] = None) -> List[Violation]:
        """One audit pass. Returns violations newly raised by this pass.

        Immediate checks (loop-thread-consistent state): orphaned
        request holdings, expired in-flight windows. Confirm-twice
        checks (state that worker threads can be mid-mutation on):
        allocator identity, holdings-vs-refcounts, host custody.
        """
        now = time.monotonic() if now is None else now
        out: List[Violation] = []
        suspects: Dict = {}

        # -- expired in-flight windows (immediate; deadline already padded)
        for key, ent in list(self._inflight.items()):
            if now <= ent["deadline"]:
                continue
            fkey = ("inflight", key)
            if fkey in self._flagged:
                continue
            self._flagged.add(fkey)
            out.append(self.violation(
                "inflight_expired",
                owner=ent["owner"],
                detail=f"key={key} plane={ent['plane']} "
                       f"age_s={now - ent['t0']:.1f}",
            ))

        # -- orphaned holdings of finished requests (immediate: request
        #    holdings only mutate on the loop thread)
        for owner in list(self._finished.keys()):
            pages = self._owner_pages.get(owner)
            if not pages:
                self._finished.pop(owner, None)
                continue
            fkey = ("orphan", owner)
            if fkey in self._flagged:
                continue
            self._flagged.add(fkey)
            pids = sorted(pages)
            self.last_orphans = pids
            out.append(self.violation(
                "orphan_page",
                owner=owner,
                page_ids=pids,
                detail=f"request finished but still holds {len(pids)} page(s)",
            ))

        alloc = self.allocator
        if alloc is not None:
            # -- accounting identity: free + cached + used == num_pages - 1
            free = len(alloc._free)
            meta = len(alloc._meta)
            cached = len(alloc._lru)
            used = meta - cached
            skew = []
            if free + cached + used != alloc.num_pages - 1:
                skew.append(
                    f"free={free}+cached={cached}+used={used}"
                    f"!=num_pages-1={alloc.num_pages - 1}"
                )
            for sh, pid in alloc._lru.items():
                if pid not in alloc._meta:
                    skew.append(f"lru page {pid} missing meta")
                    break
            if skew:
                suspects[("identity", tuple(skew))] = Violation(
                    "identity", detail="; ".join(skew))
            # -- holdings vs refcounts per active page
            for pid, m in list(alloc._meta.items()):
                if m.refs <= 0:
                    continue
                held = sum(self._holds.get(pid, {}).values())
                if held != m.refs:
                    suspects[("holdings", pid, m.refs, held)] = Violation(
                        "holdings_mismatch",
                        owner=",".join(sorted(self._holds.get(pid, {}))),
                        page_ids=[pid],
                        detail=f"refs={m.refs} held={held}",
                    )
            # -- the inverse: the ledger holds pages the allocator no
            #    longer counts as referenced (a release that outran its
            #    holder, or a hold on a freed page)
            for pid, holders in list(self._holds.items()):
                if not holders:
                    continue
                m = alloc._meta.get(pid)
                if m is None or m.refs <= 0:
                    held = sum(holders.values())
                    suspects[("holdings", pid, 0, held)] = Violation(
                        "holdings_mismatch",
                        owner=",".join(sorted(holders)),
                        page_ids=[pid],
                        detail=f"refs=0 held={held} (page not active)",
                    )

        # -- host custody vs host-pool index
        if self.host_pool is not None:
            index = set(self.host_pool._entries.keys())
            missing = self._host_custody - index
            untracked = index - self._host_custody
            if missing or untracked:
                suspects[("host", len(missing), len(untracked))] = Violation(
                    "host_orphan",
                    detail=f"custody-not-indexed={len(missing)} "
                           f"indexed-not-custody={len(untracked)}",
                )

        # confirm-twice: a suspect fires only if the same key was
        # suspect on the previous audit too
        for key, v in suspects.items():
            if key in self._suspects and key not in self._flagged:
                self._flagged.add(key)
                self.violations_log.append(v)
                self.violations_total += 1
                self.violations.inc(kind=v.kind)
                tracing.instant("kv.leak", cat="kv", kind=v.kind, detail=v.detail)
                log.warning("kv ledger violation kind=%s detail=%s", v.kind, v.detail)
                self._leak_hook(v)
                out.append(v)
        # resolved suspects un-flag so a regression re-fires
        for key in list(self._flagged):
            if key and key[0] in ("identity", "holdings", "host") and key not in suspects:
                self._flagged.discard(key)
        self._suspects = suspects

        self.audits_total += 1
        self.audits.inc()
        return out

    # ------------------------------------------------------------------
    # Surfaces
    # ------------------------------------------------------------------

    def summary_counts(self) -> dict:
        """Small numeric summary — rides engine.metrics() and the
        ForwardPassMetrics stats plane."""
        return {
            "violations": self.violations_total,
            "orphan_pages": len(self.last_orphans),
            "audits": self.audits_total,
            "inflight": len(self._inflight),
            "system_held": self.system_held_pages(),
            "holders": len(self._owner_pages),
        }

    def snapshot(self, top_n: int = 10) -> dict:
        """Full custody snapshot for GET /debug/kv and flight artifacts."""
        alloc = self.allocator
        tiers: dict = {}
        if alloc is not None:
            tiers["device"] = {
                "num_pages": alloc.num_pages,
                "free": alloc.pages_free,
                "cached": alloc.pages_cached,
                "used": alloc.pages_used,
                "peak_used": alloc.peak_used,
            }
        if self.host_pool is not None:
            tiers["host"] = {
                "indexed": len(self.host_pool),
                "custody": len(self._host_custody),
            }
        tenants: Dict[str, int] = {}
        holders = []
        for owner, pages in self._owner_pages.items():
            tenant = self._owner_tenant.get(owner, "")
            if tenant:
                tenants[tenant] = tenants.get(tenant, 0) + len(pages)
            holders.append({
                "owner": owner,
                "tenant": tenant,
                "pages": len(pages),
                "system": owner.startswith("sys:"),
            })
        holders.sort(key=lambda h: -h["pages"])
        orphan_trails = {
            str(pid): list(self._trails.get(pid, ()))
            for pid in self.last_orphans[:top_n]
        }
        return {
            "tiers": tiers,
            "tenants": tenants,
            "top_holders": holders[:top_n],
            "churn": dict(self.transition_counts),
            "inflight": [
                {"key": k, "owner": e["owner"], "plane": e["plane"],
                 "age_s": round(time.monotonic() - e["t0"], 3)}
                for k, e in list(self._inflight.items())
            ],
            "violations": [v.to_dict() for v in self.violations_log],
            "orphan_pages": list(self.last_orphans),
            "orphan_trails": orphan_trails,
            "summary": self.summary_counts(),
        }

    def render_prom(self) -> Iterable[str]:
        yield from self.transitions.render()
        yield from self.violations.render()
        yield from self.audits.render()


# ----------------------------------------------------------------------
# Module registry: /debug/kv and the census reach every live ledger without
# engine references. Unlike the flight recorder's it holds its ledgers
# weakly: a ledger's allocator calls back into its engine (KV events), so a
# strong entry would pin a dropped engine's KV pools and weights; a ledger
# leaves the registry with its engine.
# ----------------------------------------------------------------------

_registry: deque = deque(maxlen=8)


def register(ledger: KvLedger) -> None:
    _registry.append(weakref.ref(ledger))


def registered() -> Tuple[KvLedger, ...]:
    return tuple(led for led in (r() for r in list(_registry)) if led is not None)


# ----------------------------------------------------------------------
# The quiesce census — the zero-orphan teardown gate
# ----------------------------------------------------------------------

def quiesce_census(engines, wait_s: float = 10.0, poll_s: float = 0.05) -> dict:
    """Assert zero orphaned pages across a fleet at quiesce.

    Waits up to `wait_s` for transient custody (sys:* holds, in-flight
    windows, live sequences) to drain, then audits each engine's ledger
    twice (so confirm-twice checks get their confirmation) and scores:

    - ``ok`` — no engine holds pages, no audit violations fired during
      the census, and every in-flight window drained.
    - per-engine breakdown with pages_used / holders / violations.

    Engines already closed (a chaos-killed worker) are skipped: their
    pool died with them, and custody accounting applies to live pools.
    Call with an empty list for planes with no in-process paged KV
    (e.g. subprocess Sim workers) — the degenerate census is honest:
    zero engines, zero orphans.

    Synchronous — call from async scripts via ``asyncio.to_thread`` so
    the engine loops keep draining while the census polls.
    """
    live = [
        e for e in engines
        if getattr(e, "kv_ledger", None) is not None
        and not getattr(e, "_closed", False)
    ]
    deadline = time.monotonic() + max(0.0, wait_s)

    def transient(e) -> bool:
        led = e.kv_ledger
        if led.system_held_pages() or led._inflight:
            return True
        if getattr(e, "waiting", None):
            return True
        slots = getattr(e, "slots", None)
        if slots is not None and any(s is not None for s in slots):
            return True
        if getattr(e, "_prefilling", None):
            return True
        return False

    while time.monotonic() < deadline and any(transient(e) for e in live):
        time.sleep(poll_s)

    per_engine = []
    total_orphans: List[int] = []
    total_violations: Dict[str, int] = {}
    ok = True
    for i, e in enumerate(live):
        led = e.kv_ledger
        fired: List[Violation] = []
        fired += led.audit()
        fired += led.audit()  # second pass confirms racy suspects
        alloc = led.allocator
        pages_used = alloc.pages_used if alloc is not None else 0
        held = sum(len(p) for p in led._owner_pages.values())
        stranded = len(led._inflight)
        engine_ok = (
            pages_used == 0 and held == 0 and stranded == 0 and not fired
        )
        ok = ok and engine_ok
        orphans = sorted({pid for v in fired for pid in v.page_ids})
        total_orphans.extend(orphans)
        for v in fired:
            total_violations[v.kind] = total_violations.get(v.kind, 0) + 1
        per_engine.append({
            "engine": i,
            "ok": engine_ok,
            "pages_used": pages_used,
            "pages_held": held,
            "inflight": stranded,
            "violations": [v.to_dict() for v in fired],
        })
    return {
        "engines": len(live),
        "ok": ok,
        "orphan_pages": total_orphans,
        "violations": total_violations,
        "per_engine": per_engine,
    }
