"""paddle_tpu_torch.trace — propagated span/trace-context tracing (a copy
of ``paddle_tpu/trace``: the same span names, attributes, parentage,
flight recorder and exporters).

* a **trace** is one request's whole story: a tree of spans sharing a
  ``trace_id``. ``ServingEngine.submit`` mints a trace per request.
* a **span** has a name, a parent, structured attributes (bucket,
  program serial, outcome, attempt #), a monotonic duration AND a
  wall-clock epoch anchor.
* **context propagation** is explicit where threads change hands (the
  serving dispatch thread adopts the submit thread's context via
  :func:`attach` / a carried :class:`Span`) and ambient (thread-local)
  within a thread, so executor/retry spans nest under whatever request
  is in flight with no plumbing through call signatures.
* the **flight recorder** keeps the last N finished spans in a ring; on
  a ``WatchdogTimeout`` or ``BatchFailed`` the failure path calls
  :func:`record_incident` and the diagnosis ships WITH the request's span
  chain (``incidents()`` / the watchdog's stderr dump).

Overhead contract: tracing is OFF by default (``FLAGS_trace``); when off, :func:`span`
returns a module-level no-op singleton — no allocation, no lock, no
clock read on the hot path. Exporters: Chrome trace-event JSON
(mergeable with profiler host events) and JSONL.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .. import flags as _flags
from ..monitor.lockwitness import make_lock

__all__ = [
    "Span", "SpanContext", "enabled", "span", "root_span", "start_span",
    "current_span", "current_context", "attach", "get_collector",
    "SpanCollector", "spans", "clear", "to_chrome_events", "export_chrome",
    "export_jsonl", "record_incident", "incidents", "clear_incidents",
    "flight_recorder_spans", "trace_tree",
]

logger = logging.getLogger("paddle_tpu_torch.trace")

# session prefix keeps ids unique across processes
_SESSION = f"{os.getpid() & 0xFFFF:04x}{int(time.time()) & 0xFFFF:04x}"
_ids = itertools.count(1)


def _new_id() -> str:
    return f"{_SESSION}{next(_ids):08x}"


_enabled_cached: Optional[bool] = None
_enabled_epoch = -1


def enabled() -> bool:
    """``FLAGS_trace`` (default off — tracing is opt-in; the monitor
    registry stays the always-on layer). Memoized against the flags
    ``set_flags`` epoch so the disabled hot path costs an int compare,
    not an env read."""
    global _enabled_cached, _enabled_epoch
    if _flags._set_epoch != _enabled_epoch:
        _enabled_cached = bool(_flags.flag("trace"))
        _enabled_epoch = _flags._set_epoch
    return _enabled_cached


class SpanContext:
    """The propagatable identity of a span: ``(trace_id, span_id)``.
    Hand this (or the :class:`Span` itself) across threads/queues and
    open children with ``span(name, parent=ctx)``. For crossing a
    PROCESS boundary (the fleet tier's HTTP wire) use
    :meth:`to_wire`/:meth:`from_wire` — ids are plain strings, so a
    request admitted on a remote replica joins the caller's trace and
    the flight recorder on either side names the same ``trace_id``."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_wire(self) -> str:
        """``"<trace_id>/<span_id>"`` — the reference's wire form."""
        return f"{self.trace_id}/{self.span_id}"

    @staticmethod
    def from_wire(value: Optional[str]) -> Optional["SpanContext"]:
        """Parse :meth:`to_wire` output; None/empty/malformed values
        return None (an untraced caller costs nothing)."""
        if not value or "/" not in value:
            return None
        tid, sid = value.split("/", 1)
        if not tid:
            return None
        return SpanContext(tid, sid)

    def __repr__(self):
        return f"SpanContext(trace={self.trace_id}, span={self.span_id})"


class Span:
    """One named, timed, attributed interval in a trace. Context manager
    (closes on exit, recording the error type as ``status=error``) or
    closed explicitly with :meth:`end` — the serving engine carries
    request root spans across threads and settles them with the typed
    terminal outcome."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t0_mono", "t0_epoch", "duration_s", "status", "error",
                 "thread", "thread_name", "_ended", "_token")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        # monotonic for durations, epoch for the shared wall-clock anchor
        self.t0_mono = time.perf_counter()
        self.t0_epoch = time.time()
        self.duration_s: Optional[float] = None
        self.status = "open"
        self.error: Optional[str] = None
        t = threading.current_thread()
        self.thread = t.ident or 0
        self.thread_name = t.name
        self._ended = False
        self._token = None          # ambient-stack entry while current

    # -- identity ---------------------------------------------------------
    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    # -- mutation ---------------------------------------------------------
    def set_attribute(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def set_attributes(self, **kwargs) -> "Span":
        self.attrs.update(kwargs)
        return self

    def end(self, status: str = "ok",
            error: Optional[BaseException] = None) -> None:
        """Close the span exactly once (later calls no-op: a request span
        settled by the dispatch thread must not be re-closed by a racing
        sweep). Closed spans land in the collector and flight recorder."""
        if self._ended:
            return
        self._ended = True
        self.duration_s = time.perf_counter() - self.t0_mono
        if error is not None:
            self.status = "error"
            self.error = f"{type(error).__name__}: {error}"
        else:
            self.status = status
        _collector.record(self)

    # -- context manager / ambient stack ----------------------------------
    def __enter__(self) -> "Span":
        _push(self)
        self._token = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token:
            _pop(self)
            self._token = None
        self.end(error=exc if isinstance(exc, BaseException) else None)
        return False

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t0_epoch": self.t0_epoch, "duration_s": self.duration_s,
                "status": self.status, "error": self.error,
                "thread": self.thread, "thread_name": self.thread_name,
                "attrs": dict(self.attrs)}

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"status={self.status}, attrs={self.attrs})")


class _NoopSpan:
    """The disabled-path singleton: every operation is a no-op; entering
    it allocates nothing and touches no lock — the ``FLAGS_trace=0``
    hot-path cost is one flag read and one identity return."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    attrs: Dict[str, Any] = {}
    duration_s = None
    status = "noop"
    error = None
    t0_epoch = 0.0

    @property
    def context(self):
        return _NOOP_CONTEXT

    def set_attribute(self, key, value):
        return self

    def set_attributes(self, **kwargs):
        return self

    def end(self, status="ok", error=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def to_dict(self):
        return {}

    def __bool__(self):
        # `if request.span:` reads naturally at wiring sites
        return False


NOOP_SPAN = _NoopSpan()
_NOOP_CONTEXT = SpanContext("", "")


# ---------------------------------------------------------------------------
# ambient (thread-local) context
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack() -> List[Span]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _push(s: Span) -> None:
    _stack().append(s)


def _pop(s: Span) -> None:
    st = _stack()
    if st and st[-1] is s:
        st.pop()
    elif s in st:       # mis-nested exit: drop it wherever it sits
        st.remove(s)


def current_span() -> Optional[Span]:
    """The innermost open span on THIS thread (ambient context), or an
    attached foreign parent, or None."""
    st = _stack()
    if st:
        return st[-1]
    return getattr(_tls, "attached", None)


def current_context() -> Optional[SpanContext]:
    cur = current_span()
    if cur is None:
        return None
    return cur if isinstance(cur, SpanContext) else cur.context


@contextlib.contextmanager
def attach(parent):
    """Adopt ``parent`` (a :class:`Span` or :class:`SpanContext` carried
    from another thread) as this thread's ambient context for the block —
    the cross-thread propagation primitive: the serving dispatch thread
    attaches each request's root span while running its batch, so
    executor/retry spans parent correctly."""
    if not enabled() or parent is None or parent is NOOP_SPAN:
        yield
        return
    old = getattr(_tls, "attached", None)
    # only meaningful when the thread has no open span of its own
    _tls.attached = parent
    try:
        yield
    finally:
        _tls.attached = old


def start_span(name: str, parent=None, **attrs) -> Span:
    """Open (and return) a span WITHOUT entering it as ambient context —
    for spans whose lifetime crosses threads (the serving request root).
    ``parent``: a Span/SpanContext, or None to parent under the ambient
    current span; pass ``parent=False`` to force a new root trace."""
    if not enabled():
        return NOOP_SPAN
    return _make_span(name, parent, attrs)


def span(name: str, parent=None, **attrs) -> "Span":
    """Context-manager form: ``with trace.span("executor.step", ...)``.
    No-op singleton when tracing is off."""
    if not enabled():
        return NOOP_SPAN
    return _make_span(name, parent, attrs)


def root_span(name: str, **attrs) -> Span:
    """Open a new root span minting a fresh ``trace_id`` (ignores any
    ambient context — the serving/trainer trace entry points)."""
    if not enabled():
        return NOOP_SPAN
    return _make_span(name, False, attrs)


def _make_span(name, parent, attrs) -> Span:
    if parent is False:
        return Span(name, _new_id(), None, attrs)
    if parent is None:
        parent = current_span()
    if parent is None or parent is NOOP_SPAN:
        return Span(name, _new_id(), None, attrs)
    if isinstance(parent, Span):
        return Span(name, parent.trace_id, parent.span_id, attrs)
    if isinstance(parent, SpanContext):
        if not parent.trace_id:
            return Span(name, _new_id(), None, attrs)
        return Span(name, parent.trace_id, parent.span_id, attrs)
    raise TypeError(f"span parent must be a Span/SpanContext/None/False, "
                    f"got {type(parent).__name__}")


# ---------------------------------------------------------------------------
# collector + flight recorder
# ---------------------------------------------------------------------------

class SpanCollector:
    """Bounded store of finished spans (``FLAGS_trace_buffer_size``) plus
    the flight-recorder ring (``FLAGS_flight_recorder_size``) and the
    incident list. One module-level instance; thread-safe."""

    def __init__(self):
        self._lock = make_lock("SpanCollector._lock")
        self._spans: Optional[deque] = None
        self._flight: Optional[deque] = None
        self._incidents: deque = deque(maxlen=32)

    def _ensure(self) -> None:
        if self._spans is None:
            from ..flags import flag

            self._spans = deque(maxlen=max(64,
                                           int(flag("trace_buffer_size"))))
            n = int(flag("flight_recorder_size"))
            self._flight = deque(maxlen=max(1, n)) if n > 0 else None

    def record(self, s: Span) -> None:
        with self._lock:
            self._ensure()
            self._spans.append(s)
            if self._flight is not None:
                self._flight.append(s)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans or ())

    def flight_spans(self) -> List[Span]:
        with self._lock:
            return list(self._flight or ())

    def record_incident(self, kind: str, error: Optional[BaseException]
                        = None, context=None, detail: str = "") -> dict:
        """Snapshot the flight recorder into one incident record: the
        last N finished spans, every still-open span on the calling
        thread, and (when ``context`` names a trace) that trace's full
        chain pulled from the ring. Returns the incident dict (also kept
        in :func:`incidents` and logged)."""
        trace_id = ""
        if context is not None:
            trace_id = getattr(context, "trace_id", "") or ""
        open_spans = [s.to_dict() for s in _stack()]
        with self._lock:
            ring = list(self._flight or ())
        recent = [s.to_dict() for s in ring]
        chain = [d for d in recent if trace_id and d["trace_id"] == trace_id]
        incident = {
            "kind": kind, "time_epoch": time.time(),
            "error": f"{type(error).__name__}: {error}" if error else "",
            "detail": detail, "trace_id": trace_id,
            "trace_chain": chain, "open_spans": open_spans,
            "recent_spans": recent,
            "flight_recorder_enabled": self._flight is not None,
        }
        with self._lock:
            self._incidents.append(incident)
        logger.error(
            "flight recorder: incident '%s'%s — %d recent span(s), "
            "%d in the failing trace%s", kind,
            f" ({incident['error']})" if incident["error"] else "",
            len(recent), len(chain),
            "" if self._flight is not None else
            " [flight recorder DISABLED — span context lost]")
        return incident

    def incidents(self) -> List[dict]:
        with self._lock:
            return list(self._incidents)

    def clear(self) -> None:
        with self._lock:
            if self._spans is not None:
                self._spans.clear()
            if self._flight is not None:
                self._flight.clear()

    def reset(self) -> None:
        """Drop spans, incidents AND the flag-derived sizing (test
        isolation: a test flipping FLAGS_flight_recorder_size gets a
        fresh ring)."""
        with self._lock:
            self._spans = None
            self._flight = None
            self._incidents.clear()


_collector = SpanCollector()


def get_collector() -> SpanCollector:
    return _collector


def spans() -> List[Span]:
    """Every finished span still in the bounded buffer (oldest first)."""
    return _collector.spans()


def clear() -> None:
    _collector.clear()


def flight_recorder_spans() -> List[Span]:
    return _collector.flight_spans()


def record_incident(kind: str, error: Optional[BaseException] = None,
                    context=None, detail: str = "") -> dict:
    """Dump the flight recorder for a failure (see module docstring for
    the trigger list). Safe to call with tracing off — the incident then
    records ``flight_recorder_enabled: False`` and no spans."""
    return _collector.record_incident(kind, error=error, context=context,
                                      detail=detail)


def incidents() -> List[dict]:
    return _collector.incidents()


def clear_incidents() -> None:
    with _collector._lock:
        _collector._incidents.clear()


def trace_tree(trace_id: str) -> List[Span]:
    """Finished spans of one trace, parents before children (stable
    within one parent by start time)."""
    members = [s for s in _collector.spans() if s.trace_id == trace_id]
    by_parent: Dict[Optional[str], List[Span]] = {}
    for s in members:
        by_parent.setdefault(s.parent_id, []).append(s)
    ids = {s.span_id for s in members}
    out: List[Span] = []

    def walk(pid):
        for s in sorted(by_parent.get(pid, ()), key=lambda x: x.t0_epoch):
            out.append(s)
            walk(s.span_id)

    # roots: no parent, or parent not in the buffer (evicted)
    walk(None)
    for s in sorted(members, key=lambda x: x.t0_epoch):
        if s.parent_id and s.parent_id not in ids and s not in out:
            out.append(s)
            walk(s.span_id)
    return out


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def to_chrome_events(span_list: Optional[List[Span]] = None,
                     pid: int = 1) -> List[dict]:
    """Chrome trace-event dicts (``ph: X``) with ``ts`` on the EPOCH
    wall clock in microseconds (the reference's event schema)."""
    out = []
    for s in (span_list if span_list is not None else spans()):
        if s.duration_s is None:
            continue
        args = {"trace_id": s.trace_id, "span_id": s.span_id,
                "status": s.status}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        if s.error:
            args["error"] = s.error
        args.update({k: _jsonable(v) for k, v in s.attrs.items()})
        out.append({"name": s.name, "ph": "X",
                    "ts": s.t0_epoch * 1e6,
                    "dur": s.duration_s * 1e6,
                    "pid": pid, "tid": s.thread,
                    "cat": "trace", "args": args})
    return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def export_chrome(path: str,
                  span_list: Optional[List[Span]] = None) -> int:
    """Write a self-contained Chrome trace (open in Perfetto /
    chrome://tracing). Returns the event count."""
    events = to_chrome_events(span_list)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def export_jsonl(path: str,
                 span_list: Optional[List[Span]] = None) -> int:
    """One JSON object per line per finished span (ingestion-friendly).
    Returns the span count."""
    sl = span_list if span_list is not None else spans()
    with open(path, "w") as f:
        for s in sl:
            f.write(json.dumps(s.to_dict()) + "\n")
    return len(sl)
