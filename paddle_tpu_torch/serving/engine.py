"""ServingEngine base: admission, futures, the dispatcher thread and exact
request accounting.

Counterpart of ``paddle_tpu/serving/engine.py``, the part the generative
engine (``serving/generate.py``) stands on:

* callers ``submit()`` from any thread; admission answers at once
  (accept, or a TYPED rejection, never a silent drop) against a bounded
  queue;
* one dispatcher thread drains the queue and runs the executor while
  callers wait on :class:`ServingFuture` objects, which also stream
  partial results;
* every admitted request reaches EXACTLY ONE terminal outcome, and
  ``accounting()`` exposes the exact counts (``"exact"``).

The breaker, SLO burn, tenant fair share, poison bisection, preemption
handler, monitor metrics, trace spans and fault points of the JAX
package's engine wait for a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from ..executor import Executor, Scope
from ..framework import Variable
from ..resilience.deadline import Deadline, DeadlineExceeded

__all__ = ["ServingConfig", "ServingEngine", "ServingFuture",
           "ServingError", "Overloaded", "BatchFailed", "EngineStopped",
           "DeadlineExceeded", "Deadline"]

logger = logging.getLogger("paddle_tpu_torch.serving")


class ServingError(RuntimeError):
    """Base of every typed serving rejection/failure (never transient)."""

    transient = False


class Overloaded(ServingError):
    """Admission control shed this request; ``reason`` names the bound."""

    def __init__(self, msg: str, reason: str = "queue_full"):
        self.reason = reason
        super().__init__(msg)


class BatchFailed(ServingError):
    """The dispatch this request was part of failed; ``__cause__`` is the
    underlying error."""


class EngineStopped(ServingError):
    """The engine is not running (never started, or stopped without
    drain while this request was queued)."""


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs; ``None`` resolves from the ``FLAGS_serving_*``
    flags."""

    queue_depth: Optional[int] = None
    deadline_s: Optional[float] = None          # 0 = no default deadline

    def resolve(self) -> "ServingConfig":
        from ..flags import flag

        r = ServingConfig(
            queue_depth=int(flag("serving_queue_depth")
                            if self.queue_depth is None else self.queue_depth),
            deadline_s=float(flag("serving_deadline_s")
                             if self.deadline_s is None else self.deadline_s))
        if r.queue_depth < 1:
            raise ValueError(f"serving: queue_depth must be >= 1, got "
                             f"{r.queue_depth}")
        return r


class ServingFuture:
    """One request's pending terminal outcome, settled exactly once by the
    engine. Generative requests also STREAM tokens (``tokens()`` /
    ``stream()``): partial results, not outcomes."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None
        self._tokens: List[Any] = []
        self._stream_cond = threading.Condition(self._lock)

    def done(self) -> bool:
        return self._event.is_set()

    def tokens(self) -> List[Any]:
        """Snapshot of the tokens streamed so far."""
        with self._lock:
            return list(self._tokens)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as the engine emits them; raises the typed terminal
        error after the tokens emitted before it. ``timeout`` bounds each
        wait for the next token (``TimeoutError``, request not
        cancelled)."""
        i = 0
        while True:
            with self._stream_cond:
                while i >= len(self._tokens) and not self._event.is_set():
                    if not self._stream_cond.wait(timeout):
                        raise TimeoutError(
                            "serving: stream() wait for the next token "
                            "timed out; the request is still pending")
                batch = self._tokens[i:]
                settled = self._event.is_set()
            yield from batch
            i += len(batch)
            if settled and i >= len(self.tokens()):
                if self._error is not None:
                    raise self._error
                return

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if not self._event.wait(timeout):
            raise TimeoutError("serving: result() wait timed out; the "
                               "request is still pending (not cancelled)")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving: exception() wait timed out")
        return self._error

    def _emit_tokens(self, toks: Sequence[Any]) -> None:
        with self._stream_cond:
            if self._event.is_set():
                raise RuntimeError(
                    "serving internal error: token emitted after the "
                    "request's terminal outcome")
            self._tokens.extend(toks)
            self._stream_cond.notify_all()

    def _settle(self, result=None, error=None) -> None:
        with self._stream_cond:
            if self._event.is_set():
                raise RuntimeError(
                    "serving internal error: second terminal outcome for "
                    "one request (exactly-once accounting violated)")
            self._result, self._error = result, error
            self._event.set()
            self._stream_cond.notify_all()


@dataclasses.dataclass
class _Request:
    seq: int
    priority: int
    deadline: Optional[Deadline]
    submitted: float
    future: ServingFuture


class ServingEngine:
    """Construction wires program/scope/executor; ``start()`` spawns the
    dispatcher thread; ``submit()`` is thread-safe. Subclasses implement
    ``_dispatch_forever``."""

    _seq = itertools.count()

    def __init__(self, program, fetch_list, scope: Optional[Scope] = None,
                 place=None, executor: Optional[Executor] = None,
                 config: Optional[ServingConfig] = None):
        self._program = program
        self._fetch_names = [f.name if isinstance(f, Variable) else f
                             for f in (fetch_list or [])]
        self._scope = scope if scope is not None else Scope()
        self._exe = executor or Executor(place)
        self.config = (config or ServingConfig()).resolve()
        self._now = time.monotonic
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        self._running = False
        self._stopped = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        # taken off the queue but not yet settled (accounting's pending)
        self._dispatched = 0
        # what the crash guard settles if the dispatcher dies
        self._current_batch: List[_Request] = []
        self._acct = {"submitted": 0, "completed": 0, "failed": 0,
                      "shed": 0, "deadline_exceeded": 0,
                      "rejected_stopped": 0}

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._lock:
            if self._stopped:
                raise EngineStopped("serving: engine was stopped; build a "
                                    "fresh engine")
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="paddle_tpu_torch-dispatch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop serving: ``drain=True`` finishes every queued request
        first, ``drain=False`` settles them typed ``EngineStopped``."""
        with self._lock:
            self._running = False
            self._stopped = True
            self._drain = drain
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.error("serving: dispatch thread did not exit within "
                             "%gs at stop()", timeout)

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop(drain=True)
        return False

    # -- admission -------------------------------------------------------
    def _admit_and_enqueue(self, req: _Request) -> ServingFuture:
        with self._lock:
            self._acct["submitted"] += 1
            if not self._running:
                self._acct["rejected_stopped"] += 1
                raise EngineStopped("serving: engine not running")
            if len(self._queue) >= self.config.queue_depth:
                self._acct["shed"] += 1
                raise Overloaded(
                    f"serving: queue full ({len(self._queue)} >= "
                    f"{self.config.queue_depth} queued requests)",
                    reason="queue_full")
            self._queue.append(req)
            self._work.notify()
        return req.future

    def _deadline(self, deadline_s, what: str) -> Optional[Deadline]:
        budget = self.config.deadline_s if deadline_s is None else deadline_s
        return Deadline(budget, what=what) if budget and budget > 0 else None

    # -- dispatcher ------------------------------------------------------
    def _dispatch_loop(self) -> None:
        """Crash guard: whatever kills the loop, every taken and queued
        request still gets a typed outcome and admission closes."""
        try:
            self._dispatch_forever()
        except BaseException as e:
            logger.exception("serving: dispatch thread DIED (%s) — failing "
                             "queued and in-flight requests typed",
                             type(e).__name__)
            with self._lock:
                self._running = False
                self._stopped = True
                leftovers, self._queue = self._queue, []
            for r in self._current_batch:
                if not r.future.done():
                    self._settle_error(
                        r, "rejected_stopped",
                        EngineStopped(f"serving: dispatch thread crashed "
                                      f"mid-batch: {type(e).__name__}: {e}"),
                        dispatched=True)
            for r in leftovers:
                self._settle_error(
                    r, "rejected_stopped",
                    EngineStopped(f"serving: dispatch thread crashed: "
                                  f"{type(e).__name__}: {e}"))

    def _dispatch_forever(self) -> None:
        raise NotImplementedError

    def _sweep_expired_locked(self) -> None:
        """Expired queued requests settle typed before taking a slot."""
        live = []
        for r in self._queue:
            if r.deadline is not None and r.deadline.expired:
                self._settle_expired(r, locked=True)
            else:
                live.append(r)
        self._queue[:] = live

    def _settle_expired(self, r: _Request, locked: bool = False,
                        dispatched: bool = False) -> None:
        self._settle_error(
            r, "deadline_exceeded",
            DeadlineExceeded(r.deadline.what, r.deadline.budget_s,
                             r.deadline.elapsed()),
            locked=locked, dispatched=dispatched)

    def _settle_error(self, r: _Request, key: str, err: BaseException,
                      locked: bool = False, dispatched: bool = False) -> None:
        """``dispatched``: the request had left the queue, so the
        in-flight count drops with it."""
        if locked:
            self._acct[key] += 1
            self._dispatched -= int(dispatched)
        else:
            with self._lock:
                self._acct[key] += 1
                self._dispatched -= int(dispatched)
        r.future._settle(error=err)

    def _settle_completed(self, r: _Request, result) -> None:
        with self._lock:
            self._acct["completed"] += 1
            self._dispatched -= 1
        r.future._settle(result=result)

    def accounting(self) -> dict:
        """Exact request accounting: ``submitted`` equals the sum of all
        terminal outcomes plus ``pending`` (queued + in flight)."""
        with self._lock:
            acct = dict(self._acct)
            acct["pending"] = len(self._queue) + self._dispatched
        terminal = sum(v for k, v in acct.items()
                       if k not in ("submitted", "pending"))
        acct["accounted"] = terminal + acct["pending"]
        acct["exact"] = acct["accounted"] == acct["submitted"]
        return acct
