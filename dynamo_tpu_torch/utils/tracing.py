"""Request-scoped tracing: spans, lifecycle events, Perfetto export (a copy
of the JAX package's `utils/tracing.py`; spans stamp the host's
`perf_counter`, never the device's clock, so recording one adds no
synchronisation).

The reference treats observability as a first-class plane — tracing init
(reference: lib/runtime/src/logging.rs:62-130 layers a tracing subscriber
under every component) and per-request distributed context. This module is
the port's equivalent: a dependency-free span recorder that answers
"what happened to THIS request" and "what ran in THIS engine step", the two
questions the cumulative counters (`Engine.metrics()`, `phase_stats`,
`ServiceMetrics`) cannot.

Design:

- **Off by default, near-zero when off.** `DYN_TRACE=1` (or a runtime
  `enable()`) arms recording; every public helper first checks one module
  bool, and `span()` returns a shared no-op context manager when disarmed,
  so the hot paths pay a single attribute load + compare per call site.
- **Ring-buffered.** Completed events land in a bounded deque
  (`DYN_TRACE_BUFFER` events, default 65536, newest win) — tracing a
  long-running server can never grow without limit. `deque.append` is
  atomic, so worker threads (prefill/decode dispatch threads) record
  without a lock on the hot path.
- **Contextvar request propagation.** The HTTP frontend binds the request
  id (`set_request`) for the duration of the handler; spans recorded
  downstream in the same task tree (preprocessor, router) inherit it, and
  `utils.logging.JsonlFormatter` stamps it on every log record so JSONL
  logs join against spans. The engine loop is a *separate* task — engine
  call sites pass the id explicitly (`req=seq.ctx.id`).
- **Chrome trace-event export.** `export()` returns the
  ``{"traceEvents": [...]}`` JSON object chrome://tracing and
  https://ui.perfetto.dev load directly: spans are complete ``"X"`` events
  (matched by construction — no dangling B/E), point events are instants
  (``"i"``), and per-track ``"M"`` thread_name metadata names the rows.
  Events are sorted so ``ts`` is monotonic. Tracks: one row per request id
  plus named engine rows (e.g. ``engine.steps`` for the dispatch
  timeline).
- **Process label.** `set_process_default` names this process in the
  export's metadata (the serving entry claims ``frontend``, an engine
  ``worker-<id>``).
- **Traceparents.** `make_traceparent`/`parse_traceparent` carry a
  request id and the caller's hop id across the fleet's data plane
  (runtime/client.py stamps it, runtime/component.py `Ingress` binds it).
  The JAX package's cross-process merge (wire events, ingest, span sinks,
  the trace plane) is not ported yet (ROADMAP M17) and is left out.

docs/observability.md describes the trace model, with a Perfetto walkthrough.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Iterator, Optional

__all__ = [
    "enabled",
    "enable",
    "disable",
    "clear",
    "set_request",
    "reset_request",
    "current_request",
    "request_scope",
    "set_process",
    "set_process_default",
    "process_label",
    "make_traceparent",
    "parse_traceparent",
    "span",
    "instant",
    "complete",
    "export",
    "dump",
]

_DEFAULT_BUFFER = 65536

_enabled: bool = os.environ.get("DYN_TRACE", "") not in ("", "0")
_events: deque = deque(
    maxlen=int(os.environ.get("DYN_TRACE_BUFFER", str(_DEFAULT_BUFFER)))
)
# perf_counter epoch: every ts is microseconds since module import, so
# exported timestamps are small, positive and comparable across threads.
_T0 = time.perf_counter()

# active request id for this task tree (None outside a request)
_request_var: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "dyn_trace_request", default=None
)

# track name -> tid; Perfetto renders one row per (pid, tid). BOUNDED like
# the event ring: a long-running server sees a new request id per request,
# and an ever-growing name map would leak RSS and bloat every export's
# metadata block long after the ring evicted the events. Past the cap the
# oldest name is dropped (its ring events keep their numeric tid, they
# just lose the pretty row label); tids come from a counter so a reused
# name can never collide with a live one. Names registered via an
# explicit `track=` (the handful of static engine rows) are PINNED —
# insertion-order eviction would otherwise throw out exactly those
# oldest-registered hot rows first and fragment the step timeline across
# fresh tids every _TRACKS_MAX requests.
_TRACKS_MAX = 4096
_tracks: dict[str, int] = {}
_pinned: set = set()
_next_tid = 0
_tracks_lock = threading.Lock()

# the local process label (None until set; resolved lazily so an engine or
# run mode can claim it first)
_process: Optional[str] = os.environ.get("DYN_TRACE_PROCESS") or None

_NOOP_CM = contextlib.nullcontext()


def enabled() -> bool:
    return _enabled


def enable(buffer: Optional[int] = None) -> None:
    """Arm recording (idempotent). `buffer` resizes the ring (and clears
    it — a resize cannot preserve a deque's maxlen)."""
    global _enabled, _events
    if buffer is not None and buffer != _events.maxlen:
        _events = deque(maxlen=buffer)
    _enabled = True


def disable() -> None:
    """Disarm recording; the buffer keeps already-recorded events."""
    global _enabled
    _enabled = False


def clear() -> None:
    _events.clear()
    with _tracks_lock:
        _tracks.clear()
        _pinned.clear()


# ------------------------------------------------------------------ context


def set_request(request_id: Optional[str]):
    """Bind the active request id for this task tree; returns a token for
    `reset_request`. Cheap enough to run unconditionally (the JSONL log
    join uses it even when span recording is off)."""
    return _request_var.set(request_id)


def reset_request(token) -> None:
    _request_var.reset(token)


def current_request() -> Optional[str]:
    return _request_var.get()


@contextlib.contextmanager
def request_scope(request_id: Optional[str]) -> Iterator[None]:
    token = _request_var.set(request_id)
    try:
        yield
    finally:
        _request_var.reset(token)


# ------------------------------------------------------- process identity


def set_process(name: Optional[str]) -> None:
    """Label THIS process for merged exports (worker id, "frontend", …).
    Unconditional; pass None to unset (tests). Run modes and engines
    should use `set_process_default` so an explicit label — including
    ``DYN_TRACE_PROCESS`` — is never clobbered."""
    global _process
    _process = name


def set_process_default(name: str) -> None:
    """Claim the process label only if nothing has set one yet (env var
    or an earlier caller wins) — the first-wins entry point for run
    modes and engine init."""
    global _process
    if _process is None:
        _process = name


def process_label() -> str:
    """The local process label, defaulting to ``proc-<pid>``."""
    return _process or f"proc-{os.getpid()}"


def make_traceparent(request_id: str) -> str:
    """A traceparent for an outbound hop, W3C-shaped:
    ``00-<request_id>-<parent_span_hex16>-01``. The request id doubles as
    the trace id; the span id names this hop."""
    return f"00-{request_id}-{uuid.uuid4().hex[:16]}-01"


def parse_traceparent(tp: str) -> tuple[Optional[str], Optional[str]]:
    """(request_id, parent_span_id) of a traceparent; (None, None) when
    malformed. Request ids may hold dashes (forked contexts), so the span
    id is taken from the fixed tail."""
    parts = tp.split("-")
    if len(parts) < 4:
        return None, None
    return "-".join(parts[1:-2]) or None, parts[-2] or None


# ---------------------------------------------------------------- recording


def _track_name(track: Optional[str], req: Optional[str]) -> str:
    return track or req or _request_var.get() or "main"


def _tid_for(name: str, pin: bool) -> int:
    global _next_tid
    tid = _tracks.get(name)
    if tid is None:
        with _tracks_lock:
            tid = _tracks.get(name)
            if tid is None:
                while len(_tracks) >= _TRACKS_MAX:
                    victim = next(
                        (n for n in _tracks if n not in _pinned), None
                    )
                    if victim is None:
                        break  # everything pinned; let the map grow
                    _tracks.pop(victim)
                _next_tid += 1
                tid = _tracks[name] = _next_tid
                if pin:
                    _pinned.add(name)
    return tid


def _tid(track: Optional[str], req: Optional[str]) -> int:
    return _tid_for(_track_name(track, req), track is not None)


def _us(t: float) -> float:
    return round((t - _T0) * 1e6, 1)


def complete(
    name: str,
    t0: float,
    t1: float,
    cat: str = "",
    req: Optional[str] = None,
    track: Optional[str] = None,
    **args,
) -> None:
    """Record a complete ("X") event from two `time.perf_counter` stamps —
    the shape the engine's dispatch sites use (they already hold t0/t1 for
    the phase counters)."""
    if not _enabled:
        return
    if req is None and track is None:
        req = _request_var.get()
    if req is not None:
        args.setdefault("request_id", req)
    tname = _track_name(track, req)
    ev = {
        "name": name,
        "ph": "X",
        "ts": _us(t0),
        "dur": max(round((t1 - t0) * 1e6, 1), 0.0),
        "pid": 0,
        "tid": _tid_for(tname, track is not None),
        "cat": cat or "span",
        "args": args,
    }
    _events.append(ev)


def instant(
    name: str,
    cat: str = "",
    req: Optional[str] = None,
    track: Optional[str] = None,
    ts: Optional[float] = None,
    **args,
) -> None:
    """Record a point-in-time ("i") event, e.g. a sequence lifecycle edge.
    `ts` is an optional perf_counter stamp (default: now)."""
    if not _enabled:
        return
    if req is None and track is None:
        req = _request_var.get()
    if req is not None:
        args.setdefault("request_id", req)
    tname = _track_name(track, req)
    ev = {
        "name": name,
        "ph": "i",
        "s": "t",
        "ts": _us(ts if ts is not None else time.perf_counter()),
        "pid": 0,
        "tid": _tid_for(tname, track is not None),
        "cat": cat or "event",
        "args": args,
    }
    _events.append(ev)


def span(
    name: str,
    cat: str = "",
    req: Optional[str] = None,
    track: Optional[str] = None,
    **args,
):
    """Context manager recording a complete event around its body. When
    recording is off this returns a shared no-op context manager (no
    allocation, no perf_counter call)."""
    if not _enabled:
        return _NOOP_CM
    return _Span(name, cat, req, track, args)


class _Span:
    __slots__ = ("_name", "_cat", "_req", "_track", "_args", "_t0")

    def __init__(self, name, cat, req, track, args):
        self._name = name
        self._cat = cat
        self._req = req
        self._track = track
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def set(self, **args) -> None:
        """Attach result args discovered inside the span body."""
        self._args.update(args)

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self._args.setdefault("error", exc_type.__name__)
        complete(
            self._name,
            self._t0,
            time.perf_counter(),
            cat=self._cat,
            req=self._req,
            track=self._track,
            **self._args,
        )


# ------------------------------------------------------------------- export


def export(
    request_id: Optional[str] = None,
    track: Optional[str] = None,
    max_events: Optional[int] = None,
) -> dict:
    """Snapshot the ring as a Chrome trace-event JSON object: events
    sorted by ts (monotonic), one thread_name metadata record per track
    and the process label. `request_id` filters the export (metadata
    records for the surviving tracks are kept) — the /debug/trace
    per-request view. `track` filters to one named track (request rows
    are named by their request id). `max_events` keeps only the NEWEST N
    non-metadata events — the response-size cap of an HTTP scrape; the
    count dropped is reported as ``truncatedEvents`` (Perfetto ignores
    unknown top-level keys)."""
    # copy() is a single C call that never runs Python code mid-loop, so
    # it cannot observe a concurrent worker-thread append mid-iteration —
    # sorting the live deque directly could raise "mutated during
    # iteration" under a /debug/trace scrape during serving
    local = list(_events.copy())
    if request_id is not None:
        local = [
            e for e in local if e["args"].get("request_id") == request_id
        ]
    with _tracks_lock:
        tracks = dict(_tracks)
    if track is not None:
        names = {tid: name for name, tid in tracks.items()}
        local = [e for e in local if names.get(e["tid"]) == track]
    events = sorted(local, key=lambda e: e["ts"])
    truncated = 0
    if max_events is not None and len(events) > max_events:
        # newest win, like the ring itself: the tail of the timeline is
        # the part a latency postmortem reads first
        truncated = len(events) - max_events
        events = events[truncated:]
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": process_label()},
        }
    ]
    meta += [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": 0,
            "tid": tid,
            "args": {"name": name},
        }
        for name, tid in sorted(tracks.items(), key=lambda kv: kv[1])
    ]
    out = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if truncated:
        out["truncatedEvents"] = truncated
    return out


def dump(path: str) -> int:
    """Write the Perfetto-loadable JSON to `path`; returns the number of
    non-metadata events written."""
    trace = export()
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return sum(1 for e in trace["traceEvents"] if e["ph"] != "M")
