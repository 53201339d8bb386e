"""Per-bucket circuit breaker for the serving engine (a copy of
``paddle_tpu/serving/breaker.py``).

One breaker guards one (feed signature, padded batch) shape bucket — the
unit that maps 1:1 onto one executor key. A bucket whose batches keep
failing must stop eating every request routed to it: the breaker OPENs
after ``FLAGS_serving_breaker_threshold`` consecutive batch failures and
the engine rejects that bucket's requests with typed
:class:`~paddle_tpu_torch.serving.CircuitOpen` instead of queueing them
into a known-broken bucket.

The open->half-open cooldown reuses the retry subsystem's backoff
schedule (:class:`resilience.retry.RetryPolicy` — doubling, capped,
seeded jitter) keyed by how many times this bucket has re-opened: a
bucket that keeps failing its probe batches backs off exactly like a
transient site that keeps failing its retries, one implementation for
both. A successful probe CLOSEs the breaker and resets the schedule.

Thread model: ``allow``/``record_*`` are only called from the engine's
single dispatch thread; ``state``/``snapshot`` may be read from any
thread (health probes) and only read immutable-enough scalars.
"""
from __future__ import annotations

import random
import time
import zlib
from typing import Optional

from ..resilience.retry import RetryPolicy

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, threshold: int, cooldown_s: float,
                 name: str = "", seed: int = 0,
                 emit_transitions: bool = True):
        """``emit_transitions=False`` suppresses the
        ``serving_breaker_transitions_total`` emission — for reusers of
        the state machine that own their OWN transition metric (the
        serving metric must keep meaning 'bucket breakers')."""
        self.name = name
        self.emit_transitions = emit_transitions
        self.threshold = max(1, int(threshold))
        # the cooldown ladder IS a retry backoff: attempt k of the policy
        # = the k-th consecutive re-open of this bucket
        self._policy = RetryPolicy(max_attempts=1_000_000,
                                   base_delay=float(cooldown_s),
                                   max_delay=max(float(cooldown_s) * 16, 1e-3),
                                   multiplier=2.0, jitter=0.25,
                                   timeout=None)
        self._rng = random.Random((int(seed) << 16)
                                  ^ zlib.crc32(name.encode() or b"bucket"))
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_streak = 0          # consecutive opens without a close
        self._opened_at: Optional[float] = None
        self._cooldown: float = 0.0
        self.transitions = 0

    @property
    def state(self) -> str:
        return self._state

    def allow(self, now: Optional[float] = None) -> str:
        """Admission verdict for one batch: ``"yes"`` (closed),
        ``"probe"`` (open long enough — let exactly one batch test the
        bucket, moving to half-open) or ``"no"`` (still cooling down)."""
        if self._state == CLOSED:
            return "yes"
        now = time.monotonic() if now is None else now
        if self._state == OPEN and now - self._opened_at >= self._cooldown:
            self._transition(HALF_OPEN)
            return "probe"
        # HALF_OPEN between allow() and its record_* resolution never
        # admits a second batch; the dispatcher is single-threaded so
        # this is only reachable if a caller skipped record_*
        return "no"

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self._open_streak = 0
        if self._state != CLOSED:
            self._transition(CLOSED)

    def record_failure(self, now: Optional[float] = None) -> None:
        self._consecutive_failures += 1
        tripped = (self._state == HALF_OPEN        # failed probe: re-open
                   or self._consecutive_failures >= self.threshold)
        if tripped and self._state != OPEN:
            self._open_streak += 1
            self._opened_at = time.monotonic() if now is None else now
            self._cooldown = self._policy.delay(self._open_streak, self._rng)
            self._transition(OPEN)

    def _transition(self, to: str) -> None:
        from .. import monitor as _monitor

        self._state = to
        self.transitions += 1
        if self.emit_transitions and _monitor.enabled():
            _monitor.counter(
                "serving_breaker_transitions_total",
                "circuit-breaker state changes by target state").labels(
                to=to).inc()

    def snapshot(self) -> dict:
        return {"name": self.name, "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "open_streak": self._open_streak,
                "cooldown_s": round(self._cooldown, 4),
                "transitions": self.transitions}
