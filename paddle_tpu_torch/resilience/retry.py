"""Retry with exponential backoff + jitter for transient executor sites
(a copy of ``paddle_tpu/resilience/retry.py``: the same policy, schedule,
classification and metrics).

The executor's compile event and its host->device feed copies are wrapped
in a bounded, seeded, metric-emitting retry loop; the serving breaker's
cooldown schedule is a :class:`RetryPolicy`. Non-transient errors (shape/dtype mistakes,
``FloatingPointError`` from the nan sanitizer, PT* verifier findings) are
*never* retried: retrying a deterministic bug just triples its latency.

Classification is by exception type: ``RuntimeError`` / ``OSError`` /
``TimeoutError`` / ``ConnectionError`` are transient, everything else
(``TypeError``, ``ValueError`` — including ``ProgramVerificationError`` —
``FloatingPointError``, ...) is permanent and re-raised immediately.

Metrics: ``resilience_retries_total{site}`` on each
retried attempt, ``resilience_giveups_total{site}`` when the budget is
exhausted (the caller then sees :class:`RetryExhaustedError` chained onto
the final cause).
"""
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Optional

from .deadline import Deadline

__all__ = ["RetryPolicy", "RetryExhaustedError", "call_with_retry",
           "is_transient", "policy_for", "retrying",
           "set_thread_stop_event"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

# order matters: a FloatingPointError is not an OSError etc., but keep the
# permanent list explicit so subclass surprises (ProgramVerificationError is
# a ValueError) stay non-retryable by construction
_TRANSIENT = (RuntimeError, OSError, TimeoutError, ConnectionError)
_PERMANENT = (TypeError, ValueError, KeyError, IndexError, AttributeError,
              NotImplementedError, FloatingPointError, MemoryError,
              RecursionError, AssertionError)


def is_transient(exc: BaseException) -> bool:
    # classes can opt out of retry explicitly (WatchdogTimeout,
    # ReplicaDivergenceError, DeviceLostError: RuntimeErrors by type,
    # but retrying a hang, a determinism bug or a DEAD CHIP only delays
    # the diagnosis/rescale)
    if getattr(exc, "transient", None) is False:
        return False
    if not isinstance(exc, _TRANSIENT) or isinstance(exc, _PERMANENT):
        return False
    # a transient-typed wrapper chained onto a permanent cause is a
    # deterministic bug in disguise (e.g. lowering's _OpLoweringError, a
    # RuntimeError raised `from` the op's AttributeError/TypeError):
    # retrying it just triples the latency of the real diagnostic
    cause = exc.__cause__
    if cause is not None and not is_transient(cause):
        return False
    return True


@dataclasses.dataclass
class RetryPolicy:
    """max_attempts counts the first try: 3 means 1 try + 2 retries.
    ``timeout`` is the per-site wall-clock budget across all attempts; once
    it is spent the next failure gives up even with attempts remaining."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25        # delay *= 1 + jitter * U[0,1)
    timeout: Optional[float] = 30.0

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        return d * (1.0 + self.jitter * rng.random())


# backoff sleeps are INTERRUPTIBLE: they wake when the process-wide
# graceful-shutdown event (resilience.graceful) or a stop event the
# calling thread registered (the serving dispatch thread registers its
# engine's) fires — a shutdown or engine.stop() must never sit behind a
# multi-second backoff in progress.
_local = threading.local()


def set_thread_stop_event(event: Optional[threading.Event]) -> None:
    """Bind ``event`` to the CALLING thread: any backoff sleep this
    thread enters wakes (and aborts the retry, typed) when it fires.
    Pass ``None`` to unbind."""
    _local.stop_event = event


def _wait_backoff(delay: float) -> Optional[str]:
    """Sleep ``delay`` seconds; returns the interruption reason
    (``"shutdown"``/``"stop"``) when a stop event fired early, else
    ``None`` after the full sleep."""
    from .graceful import shutdown_event

    events = [("shutdown", shutdown_event())]
    thread_ev = getattr(_local, "stop_event", None)
    if thread_ev is not None:
        events.append(("stop", thread_ev))
    deadline = time.monotonic() + delay
    while True:
        for name, ev in events:
            if ev.is_set():
                return name
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        # with one event a plain wait() suffices; with two, short slices
        # keep both responsive (50 ms is noise against backoff scales)
        events[0][1].wait(remaining if len(events) == 1
                          else min(remaining, 0.05))


class RetryExhaustedError(RuntimeError):
    """Raised after the retry budget for a site is spent; ``last_error`` is
    the final underlying failure (also chained as ``__cause__``)."""

    def __init__(self, site: str, attempts: int, last_error: BaseException):
        self.site = site
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(
            f"resilience: site '{site}' still failing after {attempts} "
            f"attempt(s); giving up. Last error: "
            f"{type(last_error).__name__}: {last_error}")


def policy_for(site: str) -> RetryPolicy:
    """The FLAGS-configured policy (same knobs for every site; pass an
    explicit :class:`RetryPolicy` to ``call_with_retry`` to specialize)."""
    from ..flags import flag

    return RetryPolicy(max_attempts=max(1, int(flag("retry_max_attempts"))),
                       base_delay=float(flag("retry_base_delay")),
                       max_delay=float(flag("retry_max_delay")),
                       timeout=float(flag("retry_timeout")) or None)


def call_with_retry(site: str, fn: Callable, *args,
                    policy: Optional[RetryPolicy] = None, **kwargs):
    """Run ``fn`` under the site's retry policy. Transient failures are
    retried with exponential backoff + seeded jitter; permanent ones are
    re-raised untouched on the first occurrence. The happy path costs one
    ``try`` — policy/flag resolution is deferred to the first failure, so
    wrapping a hot site (per-feed device_put) is free; the ``timeout``
    budget is therefore measured from the first failure, not the call."""
    from .. import monitor as _monitor

    from .. import trace as _trace

    pol = policy
    rng = deadline = None
    attempt = 0
    traced = _trace.enabled()
    while True:
        attempt += 1
        try:
            if traced:
                # one span per attempt: a request trace shows each retry
                # as its own interval with the attempt number and outcome
                with _trace.span("retry." + site, site=site,
                                 attempt=attempt):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        except Exception as e:
            if not is_transient(e):
                raise
            if pol is None:
                pol = policy_for(site)
            if rng is None:
                import zlib

                from ..flags import flag

                # crc32, not hash(): str hashes are salted per process, and
                # the documented contract is that the same plan+seed
                # replays identically across runs
                rng = random.Random((int(flag("fault_seed")) << 16)
                                    ^ zlib.crc32(site.encode()))
                # the per-site budget is one Deadline (shared with the
                # serving request deadlines — resilience.deadline), started
                # at the first failure so the happy path stays free
                deadline = Deadline(pol.timeout, what=f"retry site '{site}'")
            out_of_time = deadline.expired
            if attempt >= pol.max_attempts or out_of_time:
                if _monitor.enabled():
                    _monitor.counter(
                        "resilience_giveups_total",
                        "transient-site retry budgets exhausted").labels(
                        site=site).inc()
                logger.error(
                    "resilience: site '%s' gave up after %d attempt(s)%s: %s",
                    site, attempt,
                    " (timeout)" if out_of_time else "", e)
                raise RetryExhaustedError(site, attempt, e) from e
            if _monitor.enabled():
                _monitor.counter(
                    "resilience_retries_total",
                    "transient-site failures absorbed by retry").labels(
                    site=site).inc()
            d = pol.delay(attempt, rng)
            logger.warning(
                "resilience: transient %s at site '%s' (attempt %d/%d), "
                "retrying in %.3fs: %s", type(e).__name__, site, attempt,
                pol.max_attempts, d, e)
            if d > 0:
                interrupted = _wait_backoff(d)
                if interrupted is not None:
                    # a graceful shutdown / engine stop fired mid-backoff:
                    # abort the retry loop typed instead of finishing the
                    # sleep — the caller's teardown is waiting on us.
                    # Counted apart from giveups: 'budget exhausted' and
                    # 'teardown requested' must stay distinguishable
                    if _monitor.enabled():
                        _monitor.counter(
                            "resilience_retry_aborts_total",
                            "retry loops aborted mid-backoff by a "
                            "shutdown/stop event (not a budget "
                            "exhaustion)").labels(
                            site=site, reason=interrupted).inc()
                    logger.warning(
                        "resilience: backoff at site '%s' interrupted by "
                        "%s after attempt %d — aborting retries", site,
                        interrupted, attempt)
                    raise RetryExhaustedError(site, attempt, e) from e



def retrying(site: str, policy: Optional[RetryPolicy] = None):
    """Decorator form: ``@retrying("device_put")`` wraps a callable in
    :func:`call_with_retry` for that site."""
    def deco(fn: Callable):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(site, fn, *args, policy=policy, **kwargs)
        return wrapped
    return deco
