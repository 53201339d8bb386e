"""Graceful preemption shutdown: SIGTERM -> finish the step -> checkpoint
-> exit 0 (counterpart of ``paddle_tpu/resilience/graceful.py``, with its
names and metric).

Cloud GPU fleets announce most evictions (maintenance drains, spot
preemption notices) as a SIGTERM seconds-to-minutes before the SIGKILL.
This module turns the notice into a CLEAN exit: one process-wide shutdown
:class:`threading.Event` that signal handlers set, consumers poll, and
sleepers wake on.

Consumers:

* a training loop installs the handlers for its duration, checks
  :func:`shutdown_requested` between steps, and (through
  :func:`on_shutdown`) writes a final verified checkpoint, so the NEXT
  incarnation resumes where the notice landed.
* ``serving.ServingEngine.install_preemption_handler()`` registers a
  drain-stop: on the signal the engine stops admitting, finishes every
  queued request (each still reaches exactly one terminal outcome) and
  ``ready()`` flips false so the load balancer routes away.
* ``resilience.retry`` backoff sleeps wait on this event (plus a
  per-thread stop event) instead of ``time.sleep`` — a shutdown or an
  engine ``stop()`` is never blocked behind a multi-second backoff.

The handler itself only sets the event and spawns a daemon thread for
the registered callbacks — nothing checkpoint-sized runs in signal
context.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..monitor.lockwitness import make_lock

__all__ = ["shutdown_event", "shutdown_requested", "request_shutdown",
           "on_shutdown", "install_signal_handlers",
           "uninstall_signal_handlers", "reset_shutdown_state"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

_lock = make_lock("resilience.graceful._lock")
_event = threading.Event()
_reason: Optional[str] = None
_callbacks: List[Callable[[], None]] = []
# signum -> (previous handler, refcount). Refcounted because several
# scoped owners share one process-wide handler (a training loop AND a
# ServingEngine's preemption registration): the previous handler is
# restored only when the LAST owner uninstalls — a trainer exiting must
# not tear down the engine's preemption route.
_installed: Dict[int, list] = {}


def shutdown_event() -> threading.Event:
    """The process-wide shutdown event (wait on it to sleep
    interruptibly; see ``resilience.retry``)."""
    return _event


def shutdown_requested() -> bool:
    return _event.is_set()


def shutdown_reason() -> Optional[str]:
    return _reason


_finished = False


def request_shutdown(reason: str = "request") -> None:
    """Flip the shutdown event (idempotent) and run the registered
    callbacks in a daemon thread. SIGNAL-SAFE: handlers run on the main
    thread between bytecodes, possibly while that very thread holds
    ``_lock`` (or the logging lock) — so this function takes NO lock and
    does NO logging itself; everything blocking is deferred to the
    spawned thread, with a lock-guarded once-flag absorbing the
    double-spawn race."""
    global _reason
    if _event.is_set():
        return
    _reason = reason
    _event.set()
    threading.Thread(target=_finish_shutdown, args=(reason,),
                     name="paddle_tpu_torch-graceful-shutdown",
                     daemon=True).start()


def _finish_shutdown(reason: str) -> None:
    global _finished
    with _lock:
        if _finished:
            return
        _finished = True
        callbacks = list(_callbacks)
    logger.warning("graceful shutdown requested (%s): finishing in-flight "
                   "work, then checkpoint/drain and exit", reason)
    try:
        from .. import monitor as _monitor

        if _monitor.enabled():
            _monitor.counter(
                "graceful_shutdown_requests_total",
                "graceful shutdowns initiated (signal or explicit)"
            ).labels(reason=reason).inc()
    except Exception:
        pass
    _run_callbacks(callbacks)


def _run_callbacks(callbacks) -> None:
    for cb in callbacks:
        try:
            cb()
        except Exception:
            logger.exception("graceful shutdown callback %r failed", cb)


def on_shutdown(callback: Callable[[], None]) -> Callable[[], None]:
    """Register ``callback`` to run (in a daemon thread) when shutdown is
    requested; returns an unregister function. If shutdown was ALREADY
    requested the callback is dispatched immediately — still on a daemon
    thread, so a late-starting engine drains without blocking the
    registering caller."""
    with _lock:
        already = _event.is_set()
        if not already:
            _callbacks.append(callback)

    def unregister() -> None:
        with _lock:
            try:
                _callbacks.remove(callback)
            except ValueError:
                pass

    if already:
        threading.Thread(target=_run_callbacks, args=([callback],),
                         name="paddle_tpu_torch-graceful-shutdown",
                         daemon=True).start()
    return unregister


def install_signal_handlers(
        signals: Tuple[int, ...] = (signal.SIGTERM,)) -> bool:
    """Route ``signals`` into :func:`request_shutdown`. Idempotent; only
    the main thread may install (CPython restriction) — other threads
    get ``False`` and the caller falls back to polling the event.
    Previously-installed handlers are remembered for
    :func:`uninstall_signal_handlers`."""
    if threading.current_thread() is not threading.main_thread():
        return False

    def _handler(signum, frame):
        request_shutdown(f"signal_{signum}")

    installed = False
    for signum in signals:
        with _lock:
            entry = _installed.get(signum)
            if entry is not None:
                entry[1] += 1
                installed = True
                continue
        try:
            prev = signal.signal(signum, _handler)
        except (ValueError, OSError):   # non-main thread race / bad signum
            continue
        with _lock:
            _installed[signum] = [prev, 1]
        installed = True
    return installed


def uninstall_signal_handlers(
        signals: Tuple[int, ...] = (signal.SIGTERM,)) -> None:
    """Release one owner's hold on the handlers (scoped use: a training
    loop installs for its duration only). The previous
    handler is restored only when no other owner — e.g. a ServingEngine
    preemption registration — still holds one."""
    restore = []
    with _lock:
        for signum in signals:
            entry = _installed.get(signum)
            if entry is None:
                continue
            entry[1] -= 1
            if entry[1] <= 0:
                restore.append((signum, entry[0]))
                del _installed[signum]
    for signum, prev in restore:
        try:
            signal.signal(signum, prev)
        except (ValueError, TypeError, OSError):
            pass


def reset_shutdown_state() -> None:
    """Test hook: clear the event, reason and callback list (handlers
    stay as they are — tests that installed them restore explicitly)."""
    global _reason, _finished
    with _lock:
        _event.clear()
        _reason = None
        _finished = False
        _callbacks.clear()
