"""The step watchdog (``FLAGS_step_timeout_s``): the watchdog part of
``paddle_tpu/resilience/distributed.py``, copied. The sharded
checkpoints and cross-replica checks of that module wait for the port's
multi-device slice.

A daemon thread watches the sections armed by :func:`watchdog_section`
(the executor arms its compile and step sections). On expiry it dumps
every thread's stack, the armed program serial, the last recompile
diagnosis and the flight recorder, then interrupts the hung thread so
the section raises :class:`WatchdogTimeout` instead of hanging forever.
The interrupt is a Python exception: it is delivered at the thread's
next bytecode, so it breaks Python-level stalls (the injected ``hang``
fault) but not a thread blocked inside a CUDA call; such a section still
armed one more timeout later hard-exits 124
(``FLAGS_watchdog_hard_exit``) with the diagnosis already on stderr.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import sys
import threading
import time
import traceback
from typing import Dict, Optional

from ..monitor.lockwitness import make_lock

__all__ = ["WatchdogTimeout", "watchdog_section"]

logger = logging.getLogger("paddle_tpu_torch.resilience")


class _WatchdogInterrupt(BaseException):
    """Async exception the watchdog raises INSIDE a hung non-main thread
    (``PyThreadState_SetAsyncExc``) — the cross-thread analogue of the
    ``interrupt_main``/KeyboardInterrupt path the main thread gets. A
    ``BaseException`` so broad ``except Exception`` handlers inside the
    hung section cannot swallow it; ``watchdog_section`` converts it to
    :class:`WatchdogTimeout` before callers see it. Serving's dispatch
    thread is the reason this exists: a slow-batch hang there must die
    diagnosed and typed, not ride straight to the hard-exit escalation."""


def _interrupt_thread(thread_id: int) -> bool:
    """Raise :class:`_WatchdogInterrupt` asynchronously in ``thread_id``.
    Delivery happens at the thread's next bytecode boundary — enough for
    Python-level stalls (the ``hang`` fault action sleeps in 20 ms slices);
    a thread inside a CUDA call or a kernel wait stays for the hard-exit
    escalation."""
    import ctypes

    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(_WatchdogInterrupt))
    if res > 1:
        # "affected more than one thread" — undo per CPython docs
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_id), None)
        return False
    return res == 1


class WatchdogTimeout(RuntimeError):
    """An armed compile/step/collective section exceeded
    ``FLAGS_step_timeout_s``. The full diagnosis (all thread stacks, the
    active program serial, the last recompile diagnosis) was already
    dumped to the resilience logger and stderr when the deadline fired.
    ``transient = False``: a hang is never retried."""

    transient = False

    def __init__(self, section: str, seconds: float, detail: str = ""):
        self.section = section
        self.seconds = seconds
        self.detail = detail
        super().__init__(
            f"watchdog: section '{section}' exceeded "
            f"FLAGS_step_timeout_s={seconds:g}s"
            f"{' (' + detail + ')' if detail else ''} — thread stacks and "
            f"the last recompile diagnosis were dumped at expiry")


@dataclasses.dataclass
class _Section:
    token: int
    section: str
    detail: str
    timeout: float
    deadline: float
    thread_id: int
    expired: bool = False
    hard_deadline: Optional[float] = None


_wd_lock = make_lock("resilience.distributed._wd_lock")
_wd_armed: Dict[int, _Section] = {}
_wd_tokens = itertools.count(1)
_wd_thread: Optional[threading.Thread] = None


def _dump_section(s: _Section) -> str:
    lines = [
        f"watchdog: section '{s.section}' exceeded {s.timeout:g}s "
        f"({s.detail or 'no detail'})",
    ]
    try:
        from .. import monitor as _monitor

        evs = _monitor.get_tracker().events(recompiles_only=False)
        if evs:
            e = evs[-1]
            lines.append(
                f"  last compile: path={e.path} program_serial="
                f"{e.program_serial} recompile={e.recompile} "
                f"changed={list(e.changed)} at {e.build_site}")
        else:
            lines.append("  last compile: <none recorded>")
    except Exception:
        lines.append("  last compile: <monitor unavailable>")
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    for tid, frame in frames.items():
        t = by_id.get(tid)
        name = t.name if t else "?"
        mark = " [hung section]" if tid == s.thread_id else ""
        lines.append(f"-- thread '{name}' ({tid}){mark} --")
        lines.append("".join(traceback.format_stack(frame)).rstrip())
    # flight recorder: the hang's diagnosis ships with the last N trace
    # spans (the hung request/step's chain among them) — incidents() /
    # the ci_trace_report artifact carry the structured form
    try:
        from .. import trace as _trace

        incident = _trace.record_incident(
            "watchdog_timeout",
            detail=f"section '{s.section}' ({s.detail or 'no detail'}) "
                   f"exceeded {s.timeout:g}s")
        if incident["recent_spans"]:
            lines.append(f"-- flight recorder: last "
                         f"{len(incident['recent_spans'])} span(s) --")
            for d in incident["recent_spans"][-12:]:
                lines.append(
                    f"  {d['name']} trace={d['trace_id']} "
                    f"status={d['status']} "
                    f"dur={d['duration_s'] if d['duration_s'] is not None else '?'} "
                    f"attrs={d['attrs']}")
        elif not incident["flight_recorder_enabled"]:
            lines.append("-- flight recorder: disabled (FLAGS_trace / "
                         "FLAGS_flight_recorder_size) — no span context --")
    except Exception:
        logger.exception("flight-recorder dump failed (diagnosis "
                         "continues without span context)")
    text = "\n".join(lines)
    logger.error("%s", text)
    print(text, file=sys.stderr, flush=True)
    return text


def _wd_loop() -> None:
    import _thread

    while True:
        now = time.monotonic()
        with _wd_lock:
            sections = list(_wd_armed.values())
        for s in sections:
            if not s.expired and now >= s.deadline:
                s.expired = True
                s.hard_deadline = now + max(s.timeout, 1.0)
                try:
                    _dump_section(s)
                except Exception:   # the dump must never kill the dog
                    logger.exception("watchdog diagnosis dump failed")
                try:
                    from .. import monitor as _monitor

                    _monitor.record_watchdog_timeout(s.section)
                except Exception:
                    pass
                with _wd_lock:
                    still = s.token in _wd_armed
                if still:
                    if s.thread_id == threading.main_thread().ident:
                        _thread.interrupt_main()
                    else:
                        # non-main thread (e.g. the serving dispatcher):
                        # deliver the typed interrupt directly into it
                        _interrupt_thread(s.thread_id)
            elif s.expired and s.hard_deadline is not None \
                    and now >= s.hard_deadline:
                with _wd_lock:
                    still = s.token in _wd_armed
                if not still:
                    continue   # disarmed between snapshot and deadline
                from ..flags import flag

                if flag("watchdog_hard_exit"):
                    print(f"watchdog: section '{s.section}' still hung "
                          f"{max(s.timeout, 1.0):g}s after the diagnosis "
                          f"dump (uninterruptible native code?) — "
                          f"os._exit(124)", file=sys.stderr, flush=True)
                    os._exit(124)
                s.hard_deadline = None   # dump once, then leave it be
        time.sleep(0.05 if sections else 0.2)


def _ensure_wd_thread() -> None:
    global _wd_thread
    if _wd_thread is None or not _wd_thread.is_alive():
        _wd_thread = threading.Thread(target=_wd_loop,
                                      name="paddle_tpu_torch-watchdog",
                                      daemon=True)
        _wd_thread.start()


@contextlib.contextmanager
def watchdog_section(section: str, detail: str = "", timeout=None,
                     program=None):
    """Arm the watchdog around a compile/step/collective region.

    ``timeout`` defaults to ``FLAGS_step_timeout_s``; 0/None disarms (the
    default — the context manager is then a no-op). When the deadline
    fires the watchdog dumps the diagnosis and interrupts the hung
    thread — ``interrupt_main`` for the main thread, an async
    :class:`_WatchdogInterrupt` (``PyThreadState_SetAsyncExc``) for any
    other thread, e.g. the serving dispatcher. Either pending interrupt
    is converted to :class:`WatchdogTimeout` here, so callers see one
    typed, documented failure instead of a hang; a section stuck in
    uninterruptible native code still escalates to the hard exit."""
    if timeout is None:
        from ..flags import flag

        timeout = float(flag("step_timeout_s"))
    if not timeout or timeout <= 0:
        yield None
        return
    if program is not None and not detail:
        detail = f"program serial {getattr(program, '_serial', '?')}"
    s = _Section(token=next(_wd_tokens), section=section, detail=detail,
                 timeout=float(timeout),
                 deadline=time.monotonic() + float(timeout),
                 thread_id=threading.get_ident())
    from .. import monitor as _monitor

    if _monitor.enabled():
        _monitor.counter(
            "watchdog_sections_armed_total",
            "watchdog-armed executor sections").labels(
            section=section).inc()
    with _wd_lock:
        _wd_armed[s.token] = s
    _ensure_wd_thread()
    converted = False
    try:
        yield s
    except KeyboardInterrupt:
        if s.expired:
            converted = True
            raise WatchdogTimeout(section, s.timeout, s.detail) from None
        raise
    except _WatchdogInterrupt:
        # the cross-thread delivery path (non-main sections): always ours
        # — nothing else raises this type
        converted = True
        raise WatchdogTimeout(section, s.timeout, s.detail) from None
    finally:
        with _wd_lock:
            _wd_armed.pop(s.token, None)
        if s.expired and not converted:
            # the section finished in the race window between expiry and
            # interrupt delivery: absorb the in-flight interrupt here (it
            # was aimed at this section) instead of letting it detonate in
            # whatever innocent code runs next. The watchdog polls every
            # 0.05s, so a few short sleeps cover the window.
            try:
                for _ in range(4):
                    time.sleep(0.02)
            except (KeyboardInterrupt, _WatchdogInterrupt):
                logger.warning(
                    "watchdog: absorbed a late interrupt for section "
                    "'%s' that completed at its deadline", section)
