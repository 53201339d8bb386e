"""Runtime lock witness (a copy of ``paddle_tpu/monitor/lockwitness.py``).

Locks created through the factories here are plain ``threading``
primitives when ``FLAGS_lock_witness`` is off (the default — zero
overhead, identical types), and instrumented wrappers when it is on:

* a per-thread held-lock stack records every acquisition **order** edge
  (each lock currently held -> the lock being acquired);
* wait time (acquire call -> acquired) and hold time (acquired ->
  released) feed per-lock histograms, published as
  ``lock_wait_seconds{lock=}`` / ``lock_hold_seconds{lock=}`` /
  ``lock_acquisitions_total{lock=}`` / ``lock_order_edges_total{src,dst}``
  on the monitor registry when ``FLAGS_monitor`` is on;
* :func:`witness_report` returns the observed edges, any runtime
  lock-order **cycles**, and the wait/hold stats.

The lock *names* are the reference's: the factories take a string
literal (``make_lock("ServingEngine._lock")``), the lock's canonical id
in the edge set.  The witness's own bookkeeping uses a private
un-instrumented lock and never acquires a witnessed lock, so it can
never itself deadlock or pollute the edge set.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .registry import Histogram

__all__ = [
    "make_lock", "make_rlock", "make_condition", "witness_enabled",
    "witness_report", "reset_witness", "witness_edges", "witness_cycles",
]

# fine-grained buckets: lock waits/holds live in the microsecond band
_LOCK_BUCKETS = (1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2,
                 0.1, 0.5, 1.0, 5.0)


def witness_enabled() -> bool:
    """``FLAGS_lock_witness`` (default off)."""
    from ..flags import flag

    return bool(flag("lock_witness"))


class _LockStats:
    __slots__ = ("wait", "hold", "acquisitions")

    def __init__(self):
        lk = threading.RLock()
        self.wait = Histogram(lk, buckets=_LOCK_BUCKETS)
        self.hold = Histogram(lk, buckets=_LOCK_BUCKETS)
        self.acquisitions = 0


class _WitnessState:
    """Process-wide witness store.  Guarded by a plain (un-witnessed)
    lock; recording never acquires a witnessed lock, so the witness can
    neither deadlock nor add edges of its own."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tls = threading.local()
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.stats: Dict[str, _LockStats] = {}

    def held(self) -> list:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = []
            self.tls.held = h
        return h


_state = _WitnessState()


def _record_acquired(w: "_WitnessLock", wait_s: float) -> None:
    held = _state.held()
    thread = threading.current_thread().name
    with _state.lock:
        st = _state.stats.get(w.name)
        if st is None:
            st = _state.stats[w.name] = _LockStats()
        st.acquisitions += 1
        st.wait.observe(wait_s)
        for prev, _t in held:
            if prev is w:
                continue           # reentrant re-acquire: not an edge
            key = (prev.name, w.name)
            e = _state.edges.get(key)
            if e is None:
                _state.edges[key] = {"count": 1, "thread": thread}
            else:
                e["count"] += 1
    held.append((w, time.perf_counter()))
    _publish(w.name, "lock_wait_seconds", wait_s)


def _record_released(w: "_WitnessLock") -> None:
    held = _state.held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is w:
            _, t_acq = held.pop(i)
            hold_s = time.perf_counter() - t_acq
            with _state.lock:
                st = _state.stats.get(w.name)
                if st is not None:
                    st.hold.observe(hold_s)
            _publish(w.name, "lock_hold_seconds", hold_s)
            return


def _publish(name: str, metric: str, v: float) -> None:
    """Mirror into the monitor registry (the CI metrics artifact)."""
    from . import enabled, histogram

    if enabled():
        histogram(metric, "lock witness timing (FLAGS_lock_witness)",
                  buckets=_LOCK_BUCKETS).labels(lock=name).observe(v)


class _WitnessLock:
    """Instrumented Lock/RLock with the duck-type surface
    ``threading.Condition`` needs (``_is_owned`` / ``_release_save`` /
    ``_acquire_restore``), so conditions built over witnessed locks keep
    working — and their release/re-acquire around ``wait()`` is recorded
    like any other."""

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    # -- lock protocol ---------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _record_acquired(self, time.perf_counter() - t0)
        return got

    def release(self):
        _record_released(self)
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        if self.reentrant:
            # RLock has no .locked() before 3.12; probe instead
            if self._inner.acquire(blocking=False):
                self._inner.release()
                return False
            return True
        return self._inner.locked()

    # -- Condition duck-type --------------------------------------------
    def _is_owned(self):
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        return any(w is self for w, _ in _state.held())

    def _release_save(self):
        """Full release for Condition.wait: pop our bookkeeping (the lock
        really is free while waiting) and save the inner state."""
        popped = 0
        held = _state.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                _record_released(self)
                popped += 1
        inner_save = getattr(self._inner, "_release_save", None)
        if inner_save is not None:
            return (inner_save(), popped)
        self._inner.release()
        return (None, popped)

    def _acquire_restore(self, saved):
        state, popped = saved
        t0 = time.perf_counter()
        inner_restore = getattr(self._inner, "_acquire_restore", None)
        if inner_restore is not None:
            inner_restore(state)
        else:
            self._inner.acquire()
        # the wake-up re-acquire: record wait + re-push (no new edges —
        # the order was established at the original acquire)
        wait_s = time.perf_counter() - t0
        held = _state.held()
        with _state.lock:
            st = _state.stats.get(self.name)
            if st is None:
                st = _state.stats[self.name] = _LockStats()
            st.acquisitions += 1
            st.wait.observe(wait_s)
        for _ in range(max(1, popped)):
            held.append((self, time.perf_counter()))
        _publish(self.name, "lock_wait_seconds", wait_s)

    def __repr__(self):
        return f"<WitnessLock {self.name} reentrant={self.reentrant}>"


# --------------------------------------------------------------------------
# factories (the only public construction surface)
# --------------------------------------------------------------------------

def make_lock(name: str):
    """A named non-reentrant lock; plain ``threading.Lock()`` unless
    ``FLAGS_lock_witness`` is on."""
    if not witness_enabled():
        return threading.Lock()
    return _WitnessLock(name, reentrant=False)


def make_rlock(name: str):
    """A named reentrant lock; plain ``threading.RLock()`` unless
    ``FLAGS_lock_witness`` is on."""
    if not witness_enabled():
        return threading.RLock()
    return _WitnessLock(name, reentrant=True)


def make_condition(name: str, lock=None):
    """A condition variable over ``lock`` (or its own named RLock).
    Acquiring the condition acquires the underlying lock, so witnessed
    conditions contribute edges under the *lock's* name — exactly how
    the static analyzer aliases ``Condition(lock)`` onto its lock."""
    if lock is None:
        lock = make_rlock(name)
    return threading.Condition(lock)


# --------------------------------------------------------------------------
# reporting
# --------------------------------------------------------------------------

def witness_edges() -> Set[Tuple[str, str]]:
    with _state.lock:
        return set(_state.edges)


def witness_cycles() -> List[List[str]]:
    """Cycles in the observed runtime edge set (empty = no deadlock
    potential was exercised)."""
    with _state.lock:
        edges = set(_state.edges)
    nodes = {a for a, _ in edges} | {b for _, b in edges}
    return _find_cycles(nodes, edges)


def _find_cycles(nodes: Set[str], edges: Set[Tuple[str, str]]) -> \
        List[List[str]]:
    """SCCs with more than one node, plus self-loops (Tarjan; a copy of
    ``paddle_tpu/analysis/concurrency.py``'s)."""
    adj: Dict[str, List[str]] = {n: [] for n in nodes}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    out: List[List[str]] = []

    def strongconnect(v):
        # iterative Tarjan to stay clear of recursion limits
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succ = adj.get(node, [])
            for i in range(pi, len(succ)):
                w = succ[i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1 or (node, node) in edges:
                    out.append(sorted(scc))
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for n in sorted(adj):
        if n not in index:
            strongconnect(n)
    return out


def witness_report() -> dict:
    """Everything observed since the last :func:`reset_witness`."""
    with _state.lock:
        edges = [{"src": a, "dst": b, "count": e["count"],
                  "first_thread": e["thread"]}
                 for (a, b), e in sorted(_state.edges.items())]
        locks = {}
        for name, st in sorted(_state.stats.items()):
            locks[name] = {
                "acquisitions": st.acquisitions,
                "wait": _hist_dict(st.wait),
                "hold": _hist_dict(st.hold),
            }
    return {
        "enabled": witness_enabled(),
        "locks": locks,
        "edges": edges,
        "cycles": witness_cycles(),
    }


def _hist_dict(h: Histogram) -> dict:
    return {
        "count": h.count,
        "sum": round(h.sum, 9),
        "max": h._max,
        "p50": h.quantile(0.5),
        "p99": h.quantile(0.99),
    }


def reset_witness() -> None:
    """Drop observed edges/stats (held stacks of live threads persist —
    they reflect reality)."""
    with _state.lock:
        _state.edges.clear()
        _state.stats.clear()
