"""Profiler of the PyTorch port: the fluid.profiler API over
``torch.profiler`` (counterpart of ``paddle_tpu/profiler.py``).

Reference: python/paddle/fluid/profiler.py (:225 profiler context manager,
:127 start_profiler, :168 stop_profiler) and the C++ RecordEvent/CUPTI
tracer (platform/profiler.h, device_tracer.h). Here the device side is
``torch.profiler`` (CUPTI on the card): ``stop_profiler`` exports its
Chrome trace to ``<profile_path>/torch_trace.json``.
``RecordEvent`` is ``torch.profiler.record_function`` (a range in that
trace, on the thread that opened the window: ``torch.profiler`` records
that thread's host ranges, while CUPTI records every kernel and copy on
the card whichever thread issued it) plus the host aggregates, as in the
JAX package: every event, from any thread, counts into the host table
whether or not a window is open, and inside a window its span is kept
for ``<profile_path>/host_events.json``, in the JAX package's format, so
``tools/timeline.py`` reads the port's dump as it is. The data path
marks its reads and stagings (``dataloader::*``) and ``contrib.Trainer``
its reads and feeds (``trainer::*``); the executor marks nothing (a
range would add a user-annotation row to the CUDA rows of every profile
of a step).

The window's edges: a ``torch.profiler`` window opened right before a
burst of kernels, or closed right after one, can miss the first kernels
of the burst in its CUDA activity rows (on the H100, a few in a hundred
windows). A profile that counts kernels pads its window with idle card
on each side (synchronize, then sleep some tens of ms, after opening and
before closing).

Thread-safety: all host-side state (event aggregates, span list, tid map)
is guarded by one module lock — RecordEvent is used from DataLoader worker
threads while ``stop_profiler`` snapshots and clears from the main thread.

``stop_profiler`` returns the host report as a structure (and logs it via
``logging``) so test suites and servers can consume it; the printed table
remains for CLI compatibility with the reference.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Optional

import torch

from .monitor.lockwitness import make_lock

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "RecordEvent", "cuda_profiler", "npu_profiler"]

log = logging.getLogger("paddle_tpu_torch.profiler")

TRACE_NAME = "torch_trace.json"

# one lock for every piece of host-side profiling state: RecordEvent
# exits on worker threads race stop_profiler's snapshot-and-clear
_lock = make_lock("profiler._lock")
_trace_dir: Optional[str] = None
_prof = None          # the open torch.profiler.profile
_host_events = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]
# (name, t0_s, t1_s, small_tid, epoch0_s) while profiling: t0/t1 are
# perf_counter (durations), epoch0 is time.time() at __enter__ — the
# shared wall-clock anchor that lets tools/timeline.py merge these host
# events with trace spans on one Chrome timeline
_host_spans = []
_tid_map = {}     # thread ident -> stable small timeline row id


def _default_path() -> str:
    return os.path.join(tempfile.gettempdir(), "profile")


def _activities(state: str):
    from torch.profiler import ProfilerActivity

    state = (state or "All").upper()
    if state not in ("ALL", "CPU", "GPU"):
        raise ValueError(f"profiler state must be 'CPU', 'GPU' or 'All', "
                         f"got {state!r}")
    acts = []
    if state in ("ALL", "CPU"):
        acts.append(ProfilerActivity.CPU)
    if state in ("ALL", "GPU") and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if not acts:
        acts.append(ProfilerActivity.CPU)
    return acts


def start_profiler(state="All", tracer_option=None, profile_path=None):
    """Open the window: ``state`` 'CPU' (host ranges), 'GPU' (CUDA
    activity) or 'All'; the dumps go under ``profile_path`` (default
    ``$TMPDIR/profile``). ``tracer_option`` is accepted as the reference
    takes it and not used."""
    global _trace_dir, _prof
    from torch.profiler import profile

    p = profile(activities=_activities(state))
    p.__enter__()
    with _lock:
        _trace_dir = profile_path or _default_path()
        _prof = p


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop tracing; aggregate and emit the host-side event report.

    Returns ``{"events": [{"name", "calls", "total_s", "avg_s"}, ...],
    "sorted_by": key, "spans_path": path-or-None}`` — the structure a test
    suite or server asserts on, as in the JAX package. The same table is
    logged at INFO on the ``paddle_tpu_torch.profiler`` logger and
    printed (reference CLI behaviour). The torch.profiler Chrome trace
    lands beside the span dump as ``torch_trace.json``."""
    global _trace_dir, _prof
    with _lock:
        p, _prof = _prof, None
        trace_dir, _trace_dir = _trace_dir, None
        spans = list(_host_spans)
        _host_spans.clear()
        events = {name: (cnt, tot)
                  for name, (cnt, tot) in _host_events.items()}
    if p is not None:
        p.__exit__(None, None, None)
    report = _host_report(events, sorted_key)
    table = _format_host_report(report)
    if table:
        log.info("host event report (sorted by %s):\n%s",
                 report["sorted_by"], table)
        print(table)
    # span dump consumed by tools/timeline.py (the reference writes
    # profiler.proto consumed by its timeline.py; here it is JSON)
    trace_dir = trace_dir or profile_path
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "host_events.json")
        with open(path, "w") as f:
            json.dump([{"name": n, "t0": a, "t1": b, "tid": t,
                        "epoch": e}
                       for n, a, b, t, e in spans], f)
        report["spans_path"] = path
        if p is not None:
            p.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))
    return report


def reset_profiler():
    with _lock:
        _host_events.clear()
        _host_spans.clear()


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option=None):
    start_profiler(state, tracer_option, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class RecordEvent:
    """Host-side RAII marker (reference platform/profiler.h:81); shows up
    in the torch.profiler trace as a ``record_function`` range and in the
    host-side table."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        # wall-clock anchor at open: perf_counter deltas alone cannot be
        # merged with trace spans or other processes' dumps
        self._epoch0 = time.time()
        # the trace range only while a torch.profiler window is open (the
        # range costs about 10 us on the host; the check a tenth of one)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        t1 = time.perf_counter()
        ident = threading.get_ident()
        with _lock:
            rec = _host_events[self.name]
            rec[0] += 1
            rec[1] += t1 - self._t0
            if _trace_dir is not None:
                tid = _tid_map.setdefault(ident, len(_tid_map))
                _host_spans.append((self.name, self._t0, t1, tid,
                                    self._epoch0))
        return False


def _host_report(events, sorted_key=None) -> dict:
    rows = [{"name": name, "calls": cnt, "total_s": tot,
             "avg_s": tot / cnt}
            for name, (cnt, tot) in events.items()]
    sorted_by = sorted_key or "total"
    if sorted_by == "total":
        rows.sort(key=lambda r: -r["total_s"])
    elif sorted_by == "calls":
        rows.sort(key=lambda r: -r["calls"])
    elif sorted_by == "ave":
        rows.sort(key=lambda r: -r["avg_s"])
    return {"events": rows, "sorted_by": sorted_by, "spans_path": None}


def _format_host_report(report: dict) -> str:
    if not report["events"]:
        return ""
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(s)':>12}{'Avg(s)':>12}"]
    for r in report["events"]:
        lines.append(f"{r['name']:<40}{r['calls']:>8}"
                     f"{r['total_s']:>12.6f}{r['avg_s']:>12.6f}")
    return "\n".join(lines)


@contextlib.contextmanager
def cuda_profiler(*a, **k):
    """Compat no-op (reference profiler.py:39, nvprof's capture range), as
    in the JAX package."""
    yield


npu_profiler = cuda_profiler
