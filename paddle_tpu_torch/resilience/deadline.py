"""One deadline implementation for every wall-clock budget: a monotonic
start time plus a budget. A copy of ``paddle_tpu/resilience/deadline.py``;
the serving engine attaches one to every admitted request.

:class:`DeadlineExceeded` subclasses ``TimeoutError`` but pins
``transient = False``: retrying an expired budget only makes it later.
"""
from __future__ import annotations

import time
from typing import Optional

__all__ = ["Deadline", "DeadlineExceeded"]


class DeadlineExceeded(TimeoutError):
    """A wall-clock budget ran out. ``transient = False``: a retry must
    never absorb an expired deadline (a TimeoutError is otherwise
    retryable)."""

    transient = False
    trace_id = ""

    def __init__(self, what: str, budget_s: float, elapsed_s: float):
        self.what = what
        self.budget_s = float(budget_s)
        self.elapsed_s = float(elapsed_s)
        super().__init__(
            f"deadline exceeded: {what or 'operation'} ran "
            f"{elapsed_s:.3f}s against a {budget_s:g}s budget")


class Deadline:
    """A monotonic wall-clock budget.

    ``Deadline(0.5, what="request 17")`` starts the clock at construction;
    ``None``/``0``/negative budgets mean *unbounded* (every query says
    there is time left — callers need no special case). Usable three ways:

    * polling: ``if dl.expired: shed(...)`` / ``dl.remaining()``
    * asserting: ``dl.check()`` raises :class:`DeadlineExceeded`
    * bracketing: ``with Deadline(2.0, what="compile"): ...`` re-checks on
      clean exit, so a body that silently overran raises instead of
      pretending it met its budget (an in-flight exception wins — the
      deadline never masks the real failure).
    """

    __slots__ = ("budget_s", "what", "_t0")

    def __init__(self, budget_s: Optional[float], what: str = ""):
        b = float(budget_s) if budget_s else 0.0
        self.budget_s = b if b > 0 else None   # None = unbounded
        self.what = what
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self) -> Optional[float]:
        """Seconds left (may be negative once expired); None = unbounded."""
        if self.budget_s is None:
            return None
        return self.budget_s - self.elapsed()

    @property
    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0

    def check(self, what: Optional[str] = None) -> None:
        if self.expired:
            raise DeadlineExceeded(what or self.what, self.budget_s,
                                   self.elapsed())

    def __enter__(self) -> "Deadline":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.check()
        return False

    def __repr__(self) -> str:
        if self.budget_s is None:
            return f"Deadline(unbounded, what={self.what!r})"
        return (f"Deadline({self.budget_s:g}s, remaining="
                f"{self.remaining():.3f}s, what={self.what!r})")
