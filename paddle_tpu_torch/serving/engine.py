"""ServingEngine: continuous batching over one inference program.

Counterpart of ``paddle_tpu/serving/engine.py``, with its public names,
config, metrics, span names and fault sites. One engine owns one
inference program + one scope of loaded parameters (tensors on the
executor's device, never copied per batch) + one
:class:`~paddle_tpu_torch.executor.Executor`, and turns concurrent
traffic into a small set of padded shape buckets:

* callers ``submit()`` single requests from any thread — admission
  control answers immediately (accept, or a TYPED rejection; never a
  silent drop);
* a dedicated dispatch thread drains the queue, groups requests by feed
  signature, pads the concatenated batch up to the next power-of-two
  bucket, and runs the executor on the default stream while callers
  wait on futures;
* every admitted request reaches EXACTLY ONE terminal outcome: a
  response, :class:`DeadlineExceeded`, :class:`Overloaded`,
  :class:`CircuitOpen`, :class:`BatchFailed` or :class:`EngineStopped`;
  ``accounting()`` exposes the exact ints.

Robustness surface: per-request deadlines swept before they waste a
batch slot; admission control on queue depth and oldest-request age;
a circuit breaker per shape bucket (``serving.breaker``) cooling down
through the ``resilience.retry`` schedule; graceful degradation (the
batch ceiling halves and sub-priority requests are shed under sustained
pressure, both restored when it clears); SLO burn tracking
(``serving.slo``); per-tenant queue quotas and weighted fair share; fault
isolation — a failing batch (an injected fault, a kernel error, a
watchdog timeout on a hung step) fails only that batch's requests, typed
``BatchFailed`` with the cause chained, and the engine keeps serving.
The engine never moves work to the CPU or to a plain version.

Fault sites: ``enqueue`` (submission), ``overload`` (forced shed),
``batch_dispatch`` (batch failure) + the executor's own
``compile``/``step``/``hang``/``device_put``. Metrics land on
``paddle_tpu_torch.monitor``: request latency histogram with p50/p99,
queue depth, batch occupancy, shed/deadline/breaker counters.

Poison-request bisection: with ``FLAGS_serving_bisect_depth > 0`` a
failed batch whose error is state-safe is re-dispatched as bisected
halves (bounded depth, per-member deadlines still enforced) until the
culprit is isolated: innocents complete, the culprit settles typed
:class:`PoisonRequest` and its feed fingerprint enters a bounded
quarantine that sheds repeat offenders at admission. Failures that may
have corrupted device state (a watchdog timeout, an error naming
consumed or deleted buffers) still fail the whole batch. Graceful
preemption: ``install_preemption_handler()`` routes SIGTERM
(``resilience.graceful``) into a drain-stop.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import monitor as _monitor
from .. import trace as _trace
from ..executor import Executor, Scope
from ..framework import Variable
from ..resilience import faults as _faults
from ..resilience.deadline import Deadline, DeadlineExceeded
from .breaker import CircuitBreaker
from .slo import SloBurnTracker, parse_latency_targets

__all__ = ["ServingConfig", "ServingEngine", "ServingFuture",
           "ServingError", "Overloaded", "CircuitOpen", "BatchFailed",
           "PoisonRequest", "EngineStopped", "DeadlineExceeded", "Deadline",
           "HEALTH_SCHEMA_VERSION", "HEALTH_SCHEMA_KEYS",
           "DEFAULT_TENANT", "parse_tenant_weights"]

logger = logging.getLogger("paddle_tpu_torch.serving")

OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

# The health()/ready() payload is the reference's versioned schema: the
# same keys, so a router reading one reads the other.
HEALTH_SCHEMA_VERSION = 1
HEALTH_SCHEMA_KEYS = frozenset({
    "schema_version", "status", "ready", "queue_depth", "queue_limit",
    "degraded", "current_max_batch", "open_buckets", "accounting",
    # the engine's multi-window SLO burn state — ok | warning | burning
    # per priority class
    "slo",
})

# requests that arrive without a tenant id are accounted under this name,
# so the per-tenant ledger still sums exactly to the engine's
DEFAULT_TENANT = "anonymous"


# ---------------------------------------------------------------------------
# typed terminal outcomes
# ---------------------------------------------------------------------------

class ServingError(RuntimeError):
    """Base of every typed serving rejection/failure. ``transient =
    False``: the retry classifier must never absorb one — each is a
    deliberate terminal outcome, not an infrastructure hiccup.
    ``trace_id`` names the request's trace when ``FLAGS_trace`` is on
    (every typed outcome is attributable to one specific request —
    ``accounting()['recent_outcomes']`` carries the same ids)."""

    transient = False
    trace_id = ""


class Overloaded(ServingError):
    """Admission control shed this request (queue depth/age bound,
    degraded-mode priority shed, or injected overload pressure).
    ``reason`` names which bound tripped."""

    def __init__(self, msg: str, reason: str = "queue_full"):
        self.reason = reason
        super().__init__(msg)


class CircuitOpen(ServingError):
    """The request's shape bucket is quarantined by its circuit breaker
    (repeated batch failures); retry after the cooldown."""

    def __init__(self, msg: str, bucket: str = ""):
        self.bucket = bucket
        super().__init__(msg)


class BatchFailed(ServingError):
    """The batch this request was dispatched in failed; ``__cause__`` is
    the underlying error (injected fault, a ``KernelError``, a CUDA
    error, a watchdog timeout). Only this batch failed — the engine keeps
    serving."""


class PoisonRequest(BatchFailed):
    """Bisection isolated THIS request as the culprit of its batch's
    failure (``FLAGS_serving_bisect_depth``): re-dispatched alone (or as
    the sole survivor of bisected halves) it still failed, while its
    former batch mates completed. ``__cause__`` is the underlying error;
    ``fingerprint`` names the quarantined feed — repeat submissions of
    the same feed are shed at admission (``Overloaded``,
    ``reason="poison_quarantine"``) instead of failing another batch."""

    def __init__(self, msg: str, fingerprint: str = ""):
        self.fingerprint = fingerprint
        super().__init__(msg)


class EngineStopped(ServingError):
    """The engine is not running (never started, or stopped without
    drain while this request was queued)."""


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _flag_default(value, name):
    from ..flags import flag

    return flag(name) if value is None else value


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs. ``None`` fields resolve from the ``FLAGS_serving_*``
    family at engine construction, so a deployment can be tuned entirely
    through flags while tests pass explicit values."""

    max_batch: Optional[int] = None
    queue_depth: Optional[int] = None
    queue_age_s: Optional[float] = None
    deadline_s: Optional[float] = None          # 0 = no default deadline
    batch_window_s: Optional[float] = None
    breaker_threshold: Optional[int] = None
    breaker_cooldown_s: Optional[float] = None
    degrade_after_s: Optional[float] = None
    recover_after_s: Optional[float] = None
    degraded_min_priority: Optional[int] = None
    bisect_depth: Optional[int] = None          # 0 = no poison bisection
    bisect_quarantine: Optional[int] = None
    # SLO objectives ('class:seconds,...' latency targets + the error
    # budget and burn windows; serving/slo.py)
    slo_latency: Optional[str] = None
    slo_error_budget: Optional[float] = None
    slo_fast_window_s: Optional[float] = None
    slo_slow_window_s: Optional[float] = None
    # per-tenant quotas + weighted fair share: off by default
    tenant_fair_share: Optional[bool] = None
    tenant_weights: Optional[str] = None        # 'tenant:weight,...'
    tenant_quota_frac: Optional[float] = None

    def resolve(self) -> "ServingConfig":
        r = ServingConfig(
            max_batch=int(_flag_default(self.max_batch,
                                        "serving_max_batch")),
            queue_depth=int(_flag_default(self.queue_depth,
                                          "serving_queue_depth")),
            queue_age_s=float(_flag_default(self.queue_age_s,
                                            "serving_queue_age_s")),
            deadline_s=float(_flag_default(self.deadline_s,
                                           "serving_deadline_s")),
            batch_window_s=float(_flag_default(self.batch_window_s,
                                               "serving_batch_window_s")),
            breaker_threshold=int(_flag_default(
                self.breaker_threshold, "serving_breaker_threshold")),
            breaker_cooldown_s=float(_flag_default(
                self.breaker_cooldown_s, "serving_breaker_cooldown_s")),
            degrade_after_s=float(_flag_default(
                self.degrade_after_s, "serving_degrade_after_s")),
            recover_after_s=float(_flag_default(
                self.recover_after_s, "serving_recover_after_s")),
            degraded_min_priority=int(_flag_default(
                self.degraded_min_priority, "serving_degraded_min_priority")),
            bisect_depth=int(_flag_default(self.bisect_depth,
                                           "serving_bisect_depth")),
            bisect_quarantine=int(_flag_default(
                self.bisect_quarantine, "serving_bisect_quarantine")),
            slo_latency=str(_flag_default(self.slo_latency,
                                          "serving_slo_latency_s")),
            slo_error_budget=float(_flag_default(
                self.slo_error_budget, "serving_slo_error_budget")),
            slo_fast_window_s=float(_flag_default(
                self.slo_fast_window_s, "serving_slo_fast_window_s")),
            slo_slow_window_s=float(_flag_default(
                self.slo_slow_window_s, "serving_slo_slow_window_s")),
            tenant_fair_share=bool(_flag_default(
                self.tenant_fair_share, "serving_tenant_fair_share")),
            tenant_weights=str(_flag_default(
                self.tenant_weights, "serving_tenant_weights")),
            tenant_quota_frac=float(_flag_default(
                self.tenant_quota_frac, "serving_tenant_quota_frac")),
        )
        if r.max_batch < 1:
            raise ValueError(f"serving: max_batch must be >= 1, got "
                             f"{r.max_batch}")
        if r.queue_depth < 1:
            raise ValueError(f"serving: queue_depth must be >= 1, got "
                             f"{r.queue_depth}")
        if not 0.0 < r.tenant_quota_frac <= 1.0:
            raise ValueError(f"serving: tenant_quota_frac must be in "
                             f"(0, 1], got {r.tenant_quota_frac}")
        parse_tenant_weights(r.tenant_weights)  # validate the spec early
        return r


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """Parse a ``'tenant:weight,...'`` fair-share spec (the
    ``FLAGS_serving_tenant_weights`` format) into a dict. Unlisted
    tenants weigh 1. Malformed entries raise ``ValueError`` at config
    resolve time — never mid-admission."""
    weights: Dict[str, float] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, raw = entry.rpartition(":")
        if not sep or not name:
            raise ValueError(f"serving: bad tenant weight entry "
                             f"{entry!r} (want 'tenant:weight')")
        try:
            w = float(raw)
        except ValueError:
            raise ValueError(f"serving: bad tenant weight {raw!r} "
                             f"for tenant {name!r}") from None
        if w <= 0:
            raise ValueError(f"serving: tenant weight must be > 0, "
                             f"got {w} for tenant {name!r}")
        weights[name.strip()] = w
    return weights


# ---------------------------------------------------------------------------
# request + future
# ---------------------------------------------------------------------------

class ServingFuture:
    """One request's pending terminal outcome. Settled exactly once by
    the engine; a second settle attempt is an engine bug and raises.
    ``trace_id`` (non-empty under ``FLAGS_trace``) names the request's
    trace — the handle for pulling its span chain from the collector.

    Generative requests additionally STREAM: the engine emits tokens as
    decode chunks finish (``tokens()``/``stream()``). Intermediate tokens
    are *partial results*, not outcomes — the exactly-one-terminal-outcome
    accounting invariant is untouched: however many tokens streamed, the
    request still settles exactly once (a completed result carrying the
    full token array, or a typed error such as a mid-stream
    ``DeadlineExceeded``, after which no further token can be emitted)."""

    trace_id = ""

    def __init__(self):
        self._event = threading.Event()
        self._lock = _monitor.make_lock("ServingFuture._lock")
        self._result: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None
        # streamed partial results (generative requests): guarded by
        # _lock, waiters ride the shared-lock condition
        self._tokens: List[Any] = []
        self._stream_cond = _monitor.make_condition(
            "ServingFuture._stream_cond", self._lock)

    def done(self) -> bool:
        return self._event.is_set()

    # -- streaming (generative requests) ---------------------------------
    def tokens(self) -> List[Any]:
        """Snapshot of the tokens streamed so far (partial results; also
        the salvage after a mid-stream typed failure)."""
        with self._lock:
            return list(self._tokens)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as the engine emits them. Ends with normal
        iterator exhaustion on a completed request; raises the typed
        terminal error after yielding every token emitted before it (a
        mid-stream ``DeadlineExceeded`` surfaces here, with the partial
        tokens already delivered). ``timeout`` bounds each wait for the
        NEXT token — expiry raises ``TimeoutError`` without cancelling
        the request."""
        i = 0
        while True:
            with self._stream_cond:
                while i >= len(self._tokens) and not self._event.is_set():
                    if not self._stream_cond.wait(timeout):
                        raise TimeoutError(
                            "serving: stream() wait for the next token "
                            "timed out; the request is still pending "
                            "(not cancelled)")
                batch = self._tokens[i:]
                settled = self._event.is_set()
            for t in batch:
                yield t
            i += len(batch)
            if settled and i >= len(self.tokens()):
                if self._error is not None:
                    raise self._error
                return

    def _emit_tokens(self, toks: Sequence[Any]) -> None:
        """Engine side: append partial results and wake stream waiters.
        Emitting after the terminal outcome is an engine bug — the
        settle is the LAST word on a request."""
        with self._stream_cond:
            if self._event.is_set():
                raise RuntimeError(
                    "serving internal error: token emitted after the "
                    "request's terminal outcome")
            self._tokens.extend(toks)
            self._stream_cond.notify_all()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        """The fetch arrays (rows of this request only), or raises the
        typed terminal error. ``timeout`` is a local wait bound — it does
        NOT cancel the request (the engine still settles it)."""
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

    # -- engine side -----------------------------------------------------
    def _settle(self, result=None, error=None) -> None:
        with self._lock:
            if self._event.is_set():
                raise RuntimeError(
                    "serving internal error: second terminal outcome for "
                    "one request (exactly-once accounting violated)")
            self._result, self._error = result, error
            self._event.set()
            # stream() waiters must observe the terminal outcome too
            self._stream_cond.notify_all()


@dataclasses.dataclass
class _Request:
    seq: int
    feed: Dict[str, np.ndarray]
    nrows: int
    sig: tuple
    priority: int
    deadline: Optional[Deadline]
    submitted: float
    future: ServingFuture
    # accounting tenant (wire schema v1 optional field; DEFAULT_TENANT
    # when the caller sent none)
    tenant: str = DEFAULT_TENANT
    # root span of this request's trace (trace.NOOP_SPAN when off) and
    # the in-flight dispatch child opened by the dispatch thread
    span: Any = _trace.NOOP_SPAN
    dispatch_span: Any = _trace.NOOP_SPAN
    # sha256 feed fingerprint (computed only when poison bisection is on:
    # the quarantine's key, stable across resubmissions of one feed)
    fp: str = ""


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class ServingEngine:
    """See module docstring. Construction wires program/scope/executor;
    ``start()`` spawns the dispatch thread; ``submit()`` is thread-safe.

    The program must be an inference program (e.g. ``clone(for_test=True)``)
    whose parameters are already in ``scope`` — the engine never mutates
    the program; each (feed signature, bucket) is one executor key."""

    _seq = itertools.count()

    def __init__(self, program, feed_names: Sequence[str], fetch_list,
                 scope: Optional[Scope] = None, place=None,
                 executor: Optional[Executor] = None,
                 config: Optional[ServingConfig] = None):
        self._program = program
        self._feed_names = [f.name if isinstance(f, Variable) else f
                            for f in feed_names]
        self._fetch_names = [f.name if isinstance(f, Variable) else f
                             for f in (fetch_list or [])]
        self._scope = scope if scope is not None else Scope()
        self._exe = executor or Executor(place)
        self.config = (config or ServingConfig()).resolve()
        # injectable monotonic clock: every pressure/degradation window
        # reads THIS, so
        # tests drive the sustain windows deterministically instead of
        # racing wall-clock sleeps against the dispatch thread
        self._now = time.monotonic

        self._lock = _monitor.make_lock("ServingEngine._lock")
        self._work = _monitor.make_condition("ServingEngine._work",
                                             self._lock)
        self._queue: List[_Request] = []
        self._running = False
        self._stopped = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        # wakes the dispatch thread's retry-backoff sleeps at stop():
        # a multi-second compile backoff must never block teardown
        # (resilience.retry.set_thread_stop_event)
        self._stop_ev = threading.Event()
        # graceful-preemption wiring (install_preemption_handler)
        self._preempt_unregister: Optional[Callable[[], None]] = None
        self._preempt_signals_held = False

        # degradation state (guarded by _lock)
        self._degraded = False
        self._cur_max_batch = self.config.max_batch
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None

        # per-bucket breakers; inserted by the dispatch thread under
        # _lock so health probes can snapshot the dict from any thread
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        # requests taken off the queue but not yet settled (their batch
        # is executing): part of accounting()'s pending count
        self._dispatched = 0
        # the batch currently executing (dispatch thread only; read by
        # the crash guard to settle in-flight requests typed)
        self._current_batch: List[_Request] = []

        # bounded poison quarantine (guarded by _lock): feed fingerprint
        # -> times shed at admission since isolation; oldest evicted at
        # config.bisect_quarantine entries
        from collections import OrderedDict

        self._quarantine: "OrderedDict[str, int]" = OrderedDict()

        # exact request accounting (guarded by _lock): submitted == sum(all
        # other keys) + pending queue
        self._acct = {"submitted": 0, "completed": 0, "failed": 0,
                      "poisoned": 0, "shed": 0, "deadline_exceeded": 0,
                      "circuit_open": 0, "rejected_fault": 0,
                      "rejected_stopped": 0}
        # last N terminal outcomes with their trace ids (accounting())
        self._recent_outcomes: deque = deque(maxlen=64)

        # SLO burn-rate tracker (serving/slo.py): fed one observation per
        # terminal outcome from _finish_request, serialized into the
        # health payload's "slo" key. Leaf-locked — it never acquires the
        # engine lock, so feeding it under _lock cannot deadlock.
        self._slo = SloBurnTracker(
            parse_latency_targets(self.config.slo_latency),
            error_budget=self.config.slo_error_budget,
            fast_window_s=self.config.slo_fast_window_s,
            slow_window_s=self.config.slo_slow_window_s)
        # per-tenant terminal-outcome ledger (tenant_accounting()): its
        # own leaf lock for the same reason — _finish_request runs both
        # with and without the engine lock held
        self._tenant_lock = _monitor.make_lock("ServingEngine._tenant_lock")
        self._tenant_ledger: Dict[str, dict] = {}

        # weighted fair share (guarded by _lock): parsed weight table plus the stride-scheduler
        # pass values — a tenant's pass advances by rows/weight on every
        # dispatch, and the anchor request of the next batch comes from
        # the queued tenant with the smallest pass. Only consulted when
        # config.tenant_fair_share is on; the table is bounded by
        # eviction of tenants with nothing queued.
        self._tenant_weights = parse_tenant_weights(
            self.config.tenant_weights)
        self._tenant_pass: Dict[str, float] = {}

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._lock:
            if self._stopped:
                raise EngineStopped("serving: engine was stopped; build a "
                                    "fresh ServingEngine")
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="paddle_tpu-serving-dispatch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop serving. ``drain=True`` lets the dispatcher finish every
        queued request first; ``drain=False`` fails queued requests with
        typed :class:`EngineStopped`. Either way each queued request
        still reaches exactly one terminal outcome. A retry backoff in
        progress on the dispatch thread is woken immediately (its batch
        fails typed) — stop() never waits out an exponential backoff."""
        with self._lock:
            self._running = False
            self._stopped = True
            self._drain = drain
            self._work.notify_all()
        self._stop_ev.set()
        # take-and-clear under the lock: a preemption callback thread and
        # the owner's stop() can race here, and a double release would
        # decrement the shared signal-handler refcount twice (tearing
        # down another owner's graceful route)
        with self._lock:
            unregister, self._preempt_unregister = \
                self._preempt_unregister, None
            held, self._preempt_signals_held = \
                self._preempt_signals_held, False
        if unregister is not None:
            unregister()
        if held:
            # release this engine's refcounted hold on the SIGTERM
            # handler (another owner's hold keeps it installed; from a
            # non-main thread the restore is a no-op and the harmless
            # event-setting handler simply stays)
            from ..resilience import graceful as _graceful

            _graceful.uninstall_signal_handlers()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.error("serving: dispatch thread did not exit within "
                             "%gs at stop()", timeout)

    def install_preemption_handler(self) -> bool:
        """Graceful preemption (resilience.graceful): route SIGTERM into
        a drain-stop of this engine — admission closes, every queued
        request still reaches its typed terminal outcome, ``ready()``
        flips false so the balancer routes away, and the process can
        exit 0. Returns whether a signal handler could be installed
        (main thread only); the shutdown-event registration happens
        either way, so an externally-raised ``request_shutdown()``
        drains the engine too."""
        from ..resilience import graceful as _graceful

        # under the engine lock: stop() swaps these same fields from the
        # preemption-callback thread, and an unlocked install racing it
        # would leak a callback + signal-handler hold on a dead engine.
        # (Lock order is engine -> graceful only; the late-registration
        # path dispatches callbacks on a fresh thread, never inline.)
        with self._lock:
            if self._stopped:
                return False
            if self._preempt_unregister is None:
                self._preempt_unregister = _graceful.on_shutdown(
                    lambda: self.stop(drain=True))
            if not self._preempt_signals_held:
                self._preempt_signals_held = \
                    _graceful.install_signal_handlers()
            return self._preempt_signals_held

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop(drain=True)
        return False

    # -- submission ------------------------------------------------------
    def submit(self, feed: Dict[str, Any], *, priority: int = 0,
               deadline_s: Optional[float] = None,
               trace_parent=None,
               tenant: Optional[str] = None) -> ServingFuture:
        """Admit one request (any thread). ``feed`` maps every declared
        feed name to an array with a leading batch dim (usually 1).
        Raises a typed :class:`ServingError` subclass when rejected —
        that raise IS the request's terminal outcome. ``trace_parent``
        (a ``trace.Span``/``SpanContext``, e.g. reconstructed from the
        reference's wire form) parents the request's root span so one
        trace id follows the request across processes. ``tenant``
        attributes the request in the per-tenant ledger
        (``tenant_accounting()`` and the ``fleet_tenant_*`` metrics);
        absent means :data:`DEFAULT_TENANT`."""
        # validation first: a malformed feed (ValueError) is a caller bug,
        # not a submitted request — it never enters the accounting
        req = self._build_request(feed, priority, deadline_s, trace_parent,
                                  tenant)
        # admission runs as a child span of the request root, so a typed
        # rejection still ships a complete (if short) trace
        sub = _trace.start_span("serving.submit", parent=req.span,
                                priority=req.priority, rows=req.nrows)
        return self._admit_and_enqueue(req, sub)

    def _admit_and_enqueue(self, req: _Request, sub) -> ServingFuture:
        """The admission sequence shared by every submit flavour
        (request/response and generative): accounting, the enqueue fault
        point, the stopped check, admission control, the enqueue span and
        the dispatcher wake. Every rejection is a typed terminal
        outcome."""
        with self._lock:
            self._acct["submitted"] += 1
        try:
            # injected submission failure: typed outcome at the caller
            _faults.fault_point("enqueue")
        except _faults.InjectedFault as e:
            sub.end(error=e)
            self._account("rejected_fault")
            self._finish_request(req, "rejected_fault", e)
            raise
        now = self._now()
        with self._lock:
            if not self._running:
                self._acct["rejected_stopped"] += 1
                self._record_outcome("rejected_stopped")
                err = EngineStopped("serving: engine not running")
                sub.end(error=err)
                self._finish_request(req, "rejected_stopped", err)
                raise err
            try:
                self._admit_locked(req, now)   # raises Overloaded on shed
            except Overloaded as e:
                sub.end(error=e)
                self._finish_request(req, "shed", e)
                raise
            sub.end()
            _trace.start_span("serving.enqueue", parent=req.span,
                              queue_depth=len(self._queue)).end()
            self._queue.append(req)
            self._gauge_depth_locked()
            self._work.notify()
        return req.future

    def _build_request(self, feed, priority, deadline_s,
                       trace_parent=None, tenant=None) -> _Request:
        vals = {}
        nrows = None
        for n in self._feed_names:
            if n not in feed:
                raise ValueError(f"serving: feed missing declared input "
                                 f"'{n}' (need {self._feed_names})")
            a = np.asarray(feed[n])
            if a.ndim == 0:
                raise ValueError(f"serving: feed '{n}' must have a leading "
                                 f"batch dim")
            if nrows is None:
                nrows = int(a.shape[0])
            elif int(a.shape[0]) != nrows:
                raise ValueError(
                    f"serving: inconsistent batch dims in one request: "
                    f"'{n}' has {a.shape[0]}, expected {nrows}")
            vals[n] = a
        if not vals:
            raise ValueError("serving: empty feed")
        if nrows > self.config.max_batch:
            raise ValueError(
                f"serving: request rows {nrows} exceed max_batch "
                f"{self.config.max_batch}; split the request")
        sig = tuple((n, tuple(vals[n].shape[1:]), str(vals[n].dtype))
                    for n in self._feed_names)
        budget = self.config.deadline_s if deadline_s is None else deadline_s
        seq = next(ServingEngine._seq)
        dl = Deadline(budget, what=f"serving request #{seq}") \
            if budget and budget > 0 else None
        tenant = str(tenant).strip() if tenant is not None else ""
        req = _Request(seq=seq, feed=vals, nrows=nrows, sig=sig,
                       priority=int(priority), deadline=dl,
                       submitted=self._now(), future=ServingFuture(),
                       tenant=tenant or DEFAULT_TENANT)
        if self.config.bisect_depth > 0 and self._quarantine:
            # the fingerprint is only needed eagerly for the admission
            # quarantine lookup; with an empty quarantine the submit hot
            # path skips the hash (the poison-settle path computes it
            # lazily when a culprit is isolated)
            req.fp = self._feed_fingerprint(vals)
        # one trace per request, minted at submit: the root span stays
        # open across the queue + the dispatch thread and is settled with
        # the typed terminal outcome (exactly once, like the accounting).
        # A trace_parent keeps the CALLER's trace id instead of minting a
        # fresh one
        req.span = self._request_root(trace_parent, seq=seq, rows=nrows,
                                      priority=int(priority))
        req.future.trace_id = req.span.trace_id
        return req

    @staticmethod
    def _request_root(trace_parent, **attrs):
        if trace_parent is not None:
            return _trace.start_span("serving.request",
                                     parent=trace_parent, **attrs)
        return _trace.root_span("serving.request", **attrs)

    def _admit_locked(self, req: _Request, now: float) -> None:
        """Admission control under ``_lock``: raises typed Overloaded on
        any shed. Every rejection is accounted before it raises."""
        try:
            _faults.fault_point("overload")
        except _faults.InjectedFault as e:
            self._shed_locked("injected", now)
            raise Overloaded("serving: injected overload pressure "
                             "(FLAGS_fault_plan)", reason="injected") from e
        if self._quarantine and not req.fp \
                and self.config.bisect_depth > 0:
            # the lazy build-time hash saw an empty quarantine, but one
            # filled up since (e.g. this very feed's first copy was just
            # isolated on the dispatch thread): close the race under the
            # lock so a known-poison feed can never slip past admission
            req.fp = self._feed_fingerprint(req.feed)
        if req.fp and req.fp in self._quarantine:
            # an isolated poison feed resubmitted: shed it at admission
            # instead of letting it fail (and bisect) another batch
            self._quarantine[req.fp] += 1
            self._quarantine.move_to_end(req.fp)
            repeats = self._quarantine[req.fp]
            self._shed_locked("poison_quarantine", now)
            if _monitor.enabled():
                _monitor.counter(
                    "serving_bisect_quarantine_sheds_total",
                    "quarantined poison feeds shed at admission").inc()
            raise Overloaded(
                f"serving: feed fingerprint {req.fp} is quarantined "
                f"(isolated as a poison request; shed {repeats} time(s) "
                f"since)", reason="poison_quarantine")
        if self.config.tenant_fair_share:
            # per-tenant queue quota BEFORE the global depth bound: a hot
            # tenant is shed typed tenant_quota while the queue still has
            # room for everyone else — the under-share tenants keep their
            # SLO. The queued count is an O(queue) scan, deliberately:
            # there is no per-tenant counter to drift out of sync with
            # the queue across shed/sweep/crash-guard mutations, and the
            # queue is bounded by config.queue_depth.
            quota = self._tenant_quota(req.tenant)
            queued = sum(1 for r in self._queue if r.tenant == req.tenant)
            if queued >= quota:
                self._shed_locked("tenant_quota", now)
                # attribute the quota shed in the tenant ledger; lock
                # order engine _lock -> _tenant_lock matches the settle
                # paths
                with self._tenant_lock:
                    t = self._tenant_ledger.setdefault(
                        req.tenant, {"outcomes": {}, "occupancy_s": 0.0})
                    t["quota_sheds"] = t.get("quota_sheds", 0) + 1
                if _monitor.enabled():
                    _monitor.counter(
                        "serving_tenant_quota_sheds_total",
                        "admissions shed by per-tenant queue quota"
                    ).labels(tenant=req.tenant).inc()
                raise Overloaded(
                    f"serving: tenant '{req.tenant}' is over its "
                    f"fair-share queue quota ({queued} >= {quota} of "
                    f"{self.config.queue_depth} slots)",
                    reason="tenant_quota")
        if len(self._queue) >= self.config.queue_depth:
            self._shed_locked("queue_full", now)
            raise Overloaded(
                f"serving: queue full ({len(self._queue)} >= "
                f"{self.config.queue_depth} queued requests)",
                reason="queue_full")
        if self.config.queue_age_s > 0 and self._queue:
            oldest = now - self._queue[0].submitted
            if oldest > self.config.queue_age_s:
                self._shed_locked("queue_age", now)
                raise Overloaded(
                    f"serving: oldest queued request is {oldest:.2f}s old "
                    f"(bound {self.config.queue_age_s:g}s) — the device is "
                    f"not keeping up", reason="queue_age")
        if self._degraded \
                and req.priority < self.config.degraded_min_priority:
            self._shed_locked("priority", now)
            raise Overloaded(
                f"serving: degraded mode sheds priority {req.priority} < "
                f"{self.config.degraded_min_priority}", reason="priority")
        self._update_pressure_locked(now)

    def _shed_locked(self, reason: str, now: float) -> None:
        self._acct["shed"] += 1
        self._record_outcome("shed")
        if _monitor.enabled():
            _monitor.counter(
                "serving_shed_total",
                "requests shed by admission control, by reason").labels(
                reason=reason).inc()
        # a shed IS pressure: it feeds the degradation clock
        self._pressure_since = self._pressure_since or now
        self._calm_since = None
        self._update_pressure_locked(now)

    # -- degradation -----------------------------------------------------
    def _update_pressure_locked(self, now: float) -> None:
        depth = len(self._queue)
        pressured = depth >= max(1, (3 * self.config.queue_depth) // 4)
        if not pressured and self.config.queue_age_s > 0 and self._queue:
            pressured = (now - self._queue[0].submitted
                         > self.config.queue_age_s / 2)
        if pressured:
            self._pressure_since = self._pressure_since or now
            self._calm_since = None
        elif self._pressure_since is not None or self._degraded:
            self._calm_since = self._calm_since or now
            self._pressure_since = None
        if (not self._degraded and self._pressure_since is not None
                and now - self._pressure_since
                >= self.config.degrade_after_s):
            self._degraded = True
            self._cur_max_batch = max(1, self.config.max_batch // 2)
            logger.warning(
                "serving: sustained overload for %.2fs — DEGRADED mode "
                "(max batch %d -> %d; shedding priority < %d)",
                now - self._pressure_since, self.config.max_batch,
                self._cur_max_batch, self.config.degraded_min_priority)
            if _monitor.enabled():
                _monitor.counter("serving_degradations_total",
                                 "entries into degraded mode").inc()
                _monitor.gauge("serving_degraded",
                               "1 while degraded (shrunk batch + priority "
                               "shedding)").set(1)
        elif (self._degraded and self._calm_since is not None
                and now - self._calm_since >= self.config.recover_after_s):
            self._degraded = False
            self._cur_max_batch = self.config.max_batch
            self._calm_since = None
            logger.warning("serving: pressure cleared — restored full "
                           "batch ceiling %d", self.config.max_batch)
            if _monitor.enabled():
                _monitor.gauge("serving_degraded",
                               "1 while degraded (shrunk batch + priority "
                               "shedding)").set(0)

    # -- dispatch thread -------------------------------------------------
    def _dispatch_loop(self) -> None:
        """Crash-guarded shell: whatever kills the inner loop (a bug in
        result slicing, a monitor conflict, the future's double-settle
        guard) must NOT strand callers blocked on futures — every taken
        and queued request still gets a typed terminal outcome, and the
        engine stops admitting instead of queueing into a dead thread."""
        from ..resilience.retry import set_thread_stop_event

        # any retry backoff THIS thread enters wakes when stop() fires
        set_thread_stop_event(self._stop_ev)
        try:
            self._dispatch_forever()
        except BaseException as e:
            logger.exception(
                "serving: dispatch thread DIED (%s) — failing queued and "
                "in-flight requests typed, engine stops admitting",
                type(e).__name__)
            with self._lock:
                self._running = False
                self._stopped = True
                leftovers, self._queue = self._queue, []
                self._gauge_depth_locked()
            for r in (self._current_batch or []):
                if not r.future.done():
                    self._settle_error(
                        r, "rejected_stopped",
                        EngineStopped(f"serving: dispatch thread crashed "
                                      f"mid-batch: {type(e).__name__}: {e}"),
                        dispatched=True)
            for r in leftovers:
                if not r.future.done():
                    self._settle_error(
                        r, "rejected_stopped",
                        EngineStopped(f"serving: dispatch thread crashed: "
                                      f"{type(e).__name__}: {e}"))

    def _dispatch_forever(self) -> None:
        self._current_batch: List[_Request] = []
        while True:
            with self._lock:
                while self._running and not self._queue:
                    # periodic wake even when idle: deadline sweeps and
                    # degradation recovery must not wait for traffic
                    self._work.wait(timeout=0.05)
                    self._sweep_expired_locked(self._now())
                    self._update_pressure_locked(self._now())
                if not self._running and (not self._queue or not self._drain):
                    leftovers, self._queue = self._queue, []
                    self._gauge_depth_locked()
                else:
                    leftovers = None
                    now = self._now()
                    self._sweep_expired_locked(now)
                    self._update_pressure_locked(now)
                    batch = self._take_batch_locked(now)
                    self._dispatched += len(batch)
            if leftovers is not None:
                for r in leftovers:
                    self._settle_error(
                        r, "rejected_stopped",
                        EngineStopped("serving: engine stopped without "
                                      "draining the queue"))
                return
            if batch:
                self._current_batch = batch
                try:
                    self._run_batch(batch)
                finally:
                    self._current_batch = []

    def _sweep_expired_locked(self, now: float) -> None:
        """Expired deadlines get their typed outcome BEFORE wasting a
        batch slot."""
        live = []
        for r in self._queue:
            if r.deadline is not None and r.deadline.expired:
                self._settle_error(
                    r, "deadline_exceeded",
                    DeadlineExceeded(r.deadline.what, r.deadline.budget_s,
                                     r.deadline.elapsed()),
                    locked=True)
            else:
                live.append(r)
        if len(live) != len(self._queue):
            self._queue[:] = live
            self._gauge_depth_locked()

    def _take_batch_locked(self, now: float) -> List[_Request]:
        if not self._queue:
            return []
        # fair share picks the batch ANCHOR (the request guaranteed a
        # slot): the head of the queue normally, the first queued request
        # of the lowest-pass tenant under weighted fair queueing. The
        # rest of the batch still coalesces same-signature requests in
        # FIFO order — fairness decides whose turn it is, not the
        # bucketing.
        anchor = (self._fair_anchor_locked()
                  if self.config.tenant_fair_share else self._queue[0])
        sig = anchor.sig
        cap = self._cur_max_batch
        # the anchor rides even when degradation shrank the ceiling below
        # its row count: dispatched ALONE at its natural bucket — the
        # degraded cap bounds coalescing, it must never strand an
        # admitted request without a terminal outcome
        batch, rows, rest = [anchor], anchor.nrows, []
        for r in self._queue:
            if r is anchor:
                continue
            if r.sig == sig and rows + r.nrows <= cap:
                batch.append(r)
                rows += r.nrows
            else:
                rest.append(r)
        if (rows < cap and self.config.batch_window_s > 0
                and not getattr(self, "_windowed", False)):
            # give the batch exactly one window to fill (the flag stays
            # set through the re-take so it cannot wait twice). Submits
            # notify the condition, so wait in a loop until the window
            # expires or the bucket is full — an early wake must not
            # dispatch a half-filled batch
            self._windowed = True
            try:
                until = now + self.config.batch_window_s
                while True:
                    left = until - self._now()
                    if left <= 0:
                        break
                    self._work.wait(timeout=left)
                    if sum(r.nrows for r in self._queue
                           if r.sig == sig) >= cap:
                        break
                self._sweep_expired_locked(self._now())
                return self._take_batch_locked(self._now())
            finally:
                self._windowed = False
        self._queue[:] = rest
        self._gauge_depth_locked()
        if self.config.tenant_fair_share:
            self._fair_charge_locked(batch)
        return batch

    # -- weighted fair share -------------------------------------------
    def _tenant_weight(self, tenant: str) -> float:
        return self._tenant_weights.get(tenant, 1.0)

    def _tenant_quota(self, tenant: str) -> int:
        """Queue slots tenant may hold: ``depth * quota_frac * weight``,
        at least 1, at most the whole queue."""
        depth = self.config.queue_depth
        quota = int(depth * self.config.tenant_quota_frac
                    * self._tenant_weight(tenant))
        return max(1, min(depth, quota))

    def _fair_anchor_locked(self) -> "_Request":
        """Stride scheduling (DWRR-equivalent): the next batch is
        anchored on the first queued request of the tenant with the
        smallest pass value. Passes advance by ``rows / weight`` at
        dispatch, so over time each tenant's dispatched rows converge to
        its weight share; a tenant with nothing queued is dropped from
        the table and re-enters at the current minimum pass (no banked
        credit, no starvation)."""
        first: Dict[str, _Request] = {}
        for r in self._queue:
            if r.tenant not in first:
                first[r.tenant] = r
        if len(first) <= 1:
            return self._queue[0]
        for t in list(self._tenant_pass):
            if t not in first:
                del self._tenant_pass[t]
        floor = min(self._tenant_pass.values()) if self._tenant_pass \
            else 0.0
        for t in first:
            self._tenant_pass.setdefault(t, floor)
        best = min(first, key=lambda t: (self._tenant_pass[t],
                                         first[t].seq))
        return first[best]

    def _fair_charge_locked(self, batch: List["_Request"]) -> None:
        for r in batch:
            self._tenant_pass[r.tenant] = (
                self._tenant_pass.get(r.tenant, 0.0)
                + r.nrows / self._tenant_weight(r.tenant))

    def _run_batch(self, batch: List[_Request], depth: int = 0,
                   ctx: Optional[dict] = None) -> None:
        """Execute one coalesced batch. ``depth > 0`` is a bisection
        re-dispatch (``_resolve_failed_batch``): the breaker, the
        ``batch_dispatch`` fault probe and the flight-recorder incident
        belong to the ORIGINAL depth-0 dispatch only — a re-dispatched
        half is already inside one failure's blast-radius accounting.
        ``ctx`` is the depth-0 resolution's shared bisection context
        (poison candidates are deferred into it)."""
        rows = sum(r.nrows for r in batch)
        padded = self._bucket_size(rows)
        sig = batch[0].sig
        bucket = (sig, padded)
        br = None
        if depth == 0:
            br = self._breakers.get(bucket)
            if br is None:
                br = CircuitBreaker(self.config.breaker_threshold,
                                    self.config.breaker_cooldown_s,
                                    name=self._bucket_label(bucket))
                with self._lock:   # health() snapshots the dict concurrently
                    self._breakers[bucket] = br
            verdict = br.allow()
            if verdict == "no":
                for r in batch:
                    self._settle_error(
                        r, "circuit_open",
                        CircuitOpen(
                            f"serving: bucket {br.name} quarantined "
                            f"(state={br.state}, "
                            f"{br.snapshot()['consecutive_failures']} "
                            f"consecutive failures)", bucket=br.name),
                        dispatched=True)
                self._gauge_open_buckets()
                return
        # one batch span (its own trace) linking the member request
        # traces; each request gets a 'serving.dispatch' child under ITS
        # root carrying the batch ids — submit-thread -> dispatch-thread
        # parentage without N-parent spans
        label = self._bucket_label(bucket)
        batch_span = _trace.NOOP_SPAN
        if _trace.enabled():
            batch_span = _trace.root_span(
                "serving.batch", bucket=label, rows=rows, padded=padded,
                requests=len(batch), bisect_depth=depth,
                request_traces=",".join(r.span.trace_id for r in batch))
            for r in batch:
                r.dispatch_span = _trace.start_span(
                    "serving.dispatch", parent=r.span, bucket=label,
                    bisect_depth=depth,
                    batch_trace=batch_span.trace_id,
                    batch_span=batch_span.span_id)
        try:
            if depth == 0:
                _faults.fault_point("batch_dispatch")
            feed = self._pad_feed(batch, rows, padded)
            t0 = time.perf_counter()
            # executor/compile/retry spans nest under the batch span
            with _trace.attach(batch_span):
                outs = self._exe.run(self._program, feed=feed,
                                     fetch_list=self._fetch_names,
                                     scope=self._scope)
            batch_s = time.perf_counter() - t0
        except Exception as e:   # typed per-batch isolation; engine lives
            if br is not None:
                br.record_failure()
                self._gauge_open_buckets()
            if _monitor.enabled():
                _monitor.counter(
                    "serving_batches_total",
                    "dispatched batches by result").labels(
                    result="failed").inc()
            logger.warning(
                "serving: batch of %d request(s) on bucket %s failed at "
                "bisect depth %d (%s: %s)",
                len(batch), label, depth, type(e).__name__, e)
            batch_span.set_attribute("outcome", "failed")
            batch_span.end(error=e)
            self._resolve_failed_batch(batch, e, depth, label, ctx)
            if br is not None and any(m.future.done()
                                      and m.future._error is None
                                      for m in batch):
                # bisection COMPLETED some member on this same bucket:
                # the bucket is demonstrably healthy (one request was
                # poison), so the failure recorded above must not climb
                # the consecutive-failure ladder toward CircuitOpen
                br.record_success()
                self._gauge_open_buckets()
            return
        if br is not None:
            br.record_success()
            self._gauge_open_buckets()
        batch_span.set_attribute("outcome", "ok")
        batch_span.end()
        _monitor.observe_serving_cost(self._program, padded, batch_s,
                                      label)
        if _monitor.enabled():
            _monitor.counter("serving_batches_total",
                             "dispatched batches by result").labels(
                result="ok").inc()
            _monitor.histogram(
                "serving_batch_occupancy",
                "real rows / padded bucket rows per dispatched batch",
                buckets=OCCUPANCY_BUCKETS).observe(rows / padded)
            _monitor.histogram(
                "serving_batch_seconds",
                "wall time of one dispatched serving batch").observe(
                batch_s)
        self._distribute(batch, outs, padded)

    def _resolve_failed_batch(self, batch: List[_Request],
                              cause: BaseException, depth: int,
                              label: str,
                              ctx: Optional[dict] = None) -> None:
        """Blast-radius resolution for one failed batch: bisect when the
        failure is state-safe and the depth budget allows (innocents
        complete, the isolated culprit settles typed
        :class:`PoisonRequest` and is quarantined), otherwise fail every
        member typed :class:`BatchFailed`. Every member reaches exactly
        one terminal outcome on every path; per-member deadlines stay
        enforced (an expired member settles ``DeadlineExceeded`` instead
        of riding a re-dispatch).

        Poison candidates are DEFERRED into the depth-0 resolution
        context and finalized only once the whole bisection completed:
        the poison classification requires a completed batch-mate
        witness (or a mate-less singleton batch) — when EVERY member of
        a batch fails, the bucket is broken, not the requests, and
        quarantining innocent feeds would shed legitimate resubmissions
        at admission."""
        top = ctx is None
        if top:
            ctx = {"poison": []}
        live: List[_Request] = []
        for r in batch:
            if r.deadline is not None and r.deadline.expired:
                self._settle_error(
                    r, "deadline_exceeded",
                    DeadlineExceeded(r.deadline.what, r.deadline.budget_s,
                                     r.deadline.elapsed()),
                    dispatched=True)
            else:
                live.append(r)
        max_depth = self.config.bisect_depth
        bisectable = max_depth > 0 and self._bisect_safe(cause)
        if live and bisectable and len(live) == 1 and depth > 0:
            # re-dispatched without batch mates and still failing: a
            # culprit CANDIDATE — classified at the top of the recursion
            ctx["poison"].append((live[0], cause))
        elif live and bisectable and depth < max_depth:
            # a singleton at depth 0 re-dispatches SOLO once (absorbing a
            # transient and confirming a culprit); larger batches split
            mid = max(1, (len(live) + 1) // 2)
            halves = [live[:mid], live[mid:]]
            if _monitor.enabled():
                _monitor.counter(
                    "serving_bisect_splits_total",
                    "failed batches re-dispatched as bisected halves"
                ).inc()
            logger.warning(
                "serving: bisecting failed batch of %d request(s) on "
                "bucket %s (depth %d -> %d): %s: %s",
                len(live), label, depth, depth + 1,
                type(cause).__name__, cause)
            for r in live:
                # the old dispatch child closes here; the re-dispatch
                # opens a fresh one under the same request root
                if r.dispatch_span:
                    r.dispatch_span.set_attribute("outcome", "bisect")
                    r.dispatch_span.end()
                    r.dispatch_span = _trace.NOOP_SPAN
            for half in halves:
                if half:
                    self._run_batch(half, depth=depth + 1, ctx=ctx)
        elif live:
            self._fail_members(live, cause, label, depth)
        if top and ctx["poison"]:
            self._finalize_poison(batch, ctx["poison"], label)

    def _finalize_poison(self, batch: List[_Request], candidates,
                         label: str) -> None:
        """Classify the deferred culprit candidates of one depth-0
        resolution. A candidate is poison only with a completed-mate
        WITNESS (some other member of the original batch succeeded once
        the candidate was out) or when the original batch was a
        mate-less singleton; with no witness, every member failed — a
        broken bucket, settled :class:`BatchFailed` (and counted by the
        breaker's consecutive-failure ladder), never a quarantined
        innocent."""
        witness = any(r.future.done() and r.future._error is None
                      for r in batch)
        if witness or len(batch) == 1:
            for r, cause in candidates:
                self._settle_poison(r, cause, label)
            return
        logger.warning(
            "serving: refusing poison classification on bucket %s — all "
            "%d member(s) failed (no completed-mate witness); the bucket "
            "is broken, not one request", label, len(batch))
        self._fail_members([r for r, _ in candidates],
                           candidates[0][1], label, depth=0)

    def _fail_members(self, live: List[_Request], cause: BaseException,
                      label: str, depth: int) -> None:
        for r in live:
            # one instance per future: concurrent result() raises would
            # otherwise interleave __traceback__ on a shared exception
            err = BatchFailed(
                f"serving: batch failed on bucket {label}: "
                f"{type(cause).__name__}: {cause}")
            err.__cause__ = cause
            self._settle_error(r, "failed", err, dispatched=True)
        if live:
            # flight recorder: the incident ships with the failed
            # requests' full span chains (settled above, so the terminal
            # outcomes are already in the ring). Recorded at ANY depth —
            # this is the terminal resolution of these requests, and a
            # sub-batch that dies mid-bisection must not lose its dump
            _trace.record_incident(
                "batch_failed", error=cause, context=live[0].span,
                detail=f"bucket {label}, {len(live)} request(s), "
                       f"bisect depth {depth}")

    def _settle_poison(self, r: _Request, cause: BaseException,
                       label: str) -> None:
        fp = r.fp or self._feed_fingerprint(r.feed)
        err = PoisonRequest(
            f"serving: request #{r.seq} isolated by bisection as the "
            f"poison member of a failing batch on bucket {label} "
            f"({type(cause).__name__}: {cause}); feed fingerprint {fp} "
            f"quarantined", fingerprint=fp)
        err.__cause__ = cause
        with self._lock:
            self._quarantine[fp] = self._quarantine.get(fp, 0)
            self._quarantine.move_to_end(fp)
            while len(self._quarantine) > max(1,
                                              self.config.bisect_quarantine):
                self._quarantine.popitem(last=False)
            qsize = len(self._quarantine)
        logger.warning("serving: POISON request #%d isolated on bucket "
                       "%s — fingerprint %s quarantined (%s: %s)",
                       r.seq, label, fp, type(cause).__name__, cause)
        if _monitor.enabled():
            _monitor.counter(
                "serving_bisect_poison_total",
                "poison requests isolated by batch bisection").inc()
            _monitor.gauge(
                "serving_bisect_quarantine_size",
                "poison feed fingerprints currently quarantined").set(qsize)
        self._settle_error(r, "poisoned", err, dispatched=True)
        _trace.record_incident(
            "poison_request", error=err, context=r.span,
            detail=f"bucket {label}, fingerprint {fp}")

    @staticmethod
    def _bisect_safe(e: BaseException) -> bool:
        """May a failed batch be re-dispatched in halves? NO when the
        failure may have corrupted device state: a watchdog-broken hang
        or a lost device leaves the executor in an unknown state, and an
        error naming consumed/deleted buffers means re-running would
        read through freed storage — those fail the WHOLE batch
        (the pre-bisection contract). Walks the cause chain."""
        from ..resilience.distributed import WatchdogTimeout
        from ..resilience.elastic import DeviceLostError

        seen = set()
        cur: Optional[BaseException] = e
        while cur is not None and id(cur) not in seen:
            seen.add(id(cur))
            if isinstance(cur, (WatchdogTimeout, DeviceLostError)):
                return False
            msg = str(cur).lower()
            if "donated" in msg or "deleted" in msg:
                return False
            cur = cur.__cause__ or cur.__context__
        return True

    @staticmethod
    def _feed_fingerprint(feed: Dict[str, np.ndarray]) -> str:
        """Content hash of one request's feed — the quarantine key. Bit
        sensitivity is deliberate: the SAME poison bytes are shed, a
        perturbed resubmission gets a fresh chance."""
        import hashlib

        h = hashlib.sha256()
        for n in sorted(feed):
            a = np.ascontiguousarray(feed[n])
            h.update(n.encode("utf-8"))
            h.update(str(a.dtype).encode("ascii"))
            h.update(repr(a.shape).encode("ascii"))
            h.update(a.tobytes())
        return h.hexdigest()[:32]

    def _distribute(self, batch, outs, padded) -> None:
        now = self._now()
        offset = 0
        for r in batch:
            res = []
            for o in outs:
                a = np.asarray(o)
                if a.ndim and a.shape[0] == padded:
                    res.append(a[offset:offset + r.nrows])
                else:
                    # batch-invariant fetch (scalar/aggregate): every
                    # request gets the full value
                    res.append(a)
            offset += r.nrows
            if r.deadline is not None and r.deadline.expired:
                # the batch outran the request's budget (e.g. a cold
                # bucket compile): the documented contract is a typed
                # DeadlineExceeded, never a stale late response
                self._settle_error(
                    r, "deadline_exceeded",
                    DeadlineExceeded(r.deadline.what, r.deadline.budget_s,
                                     r.deadline.elapsed()),
                    dispatched=True)
                continue
            latency = now - r.submitted
            with self._lock:
                self._acct["completed"] += 1
                self._dispatched -= 1
            self._record_outcome("completed")
            self._finish_request(r, "completed")
            if _monitor.enabled():
                _monitor.histogram(
                    "serving_request_latency_seconds",
                    "submit-to-response latency of completed requests "
                    "(p50/p99 in the snapshot)").observe(latency)
            r.future._settle(result=res)

    # -- helpers ---------------------------------------------------------
    def _bucket_size(self, rows: int) -> int:
        p = 1
        while p < rows:
            p <<= 1
        return min(p, self.config.max_batch)

    @staticmethod
    def _bucket_label(bucket) -> str:
        sig, padded = bucket
        shapes = ",".join(f"{n}[{'x'.join(map(str, s))}:{d}]"
                          for n, s, d in sig)
        return f"b{padded}({shapes})"

    def _pad_feed(self, batch, rows, padded) -> Dict[str, np.ndarray]:
        feed = {}
        for n in self._feed_names:
            parts = [r.feed[n] for r in batch]
            if padded > rows:
                pad = np.zeros((padded - rows,) + parts[0].shape[1:],
                               dtype=parts[0].dtype)
                parts = parts + [pad]
            feed[n] = np.concatenate(parts, axis=0) if len(parts) > 1 \
                else parts[0]
        return feed

    def _finish_request(self, r: _Request, outcome: str,
                        err: Optional[BaseException] = None) -> None:
        """Terminal-outcome bookkeeping shared by every settle path:
        close the dispatch child (if one is open) and the request root
        span with the typed outcome, stamp the trace id onto the error
        and the accounting's recent-outcomes ring. Idempotent on the
        span side (``Span.end`` closes once)."""
        if err is not None and isinstance(err, (ServingError,
                                                DeadlineExceeded)):
            err.trace_id = r.span.trace_id
        if r.dispatch_span:
            r.dispatch_span.end(error=err)
        if r.span:
            r.span.set_attribute("outcome", outcome)
            r.span.end(status="ok" if err is None else "error", error=err)
        # bounded deque append is GIL-atomic; callers may or may not hold
        # the engine lock
        self._recent_outcomes.append(
            {"seq": r.seq, "outcome": outcome,
             "trace_id": r.span.trace_id})
        # SLO + tenant accounting, once per terminal outcome (this method
        # is the single chokepoint every settle path funnels through).
        # Both stores are leaf-locked, never the engine lock.
        elapsed = self._now() - r.submitted
        completed = outcome == "completed"
        self._slo.observe(r.priority, elapsed if completed else None,
                          error=not completed)
        with self._tenant_lock:
            t = self._tenant_ledger.get(r.tenant)
            if t is None:
                t = self._tenant_ledger[r.tenant] = {"outcomes": {},
                                                     "occupancy_s": 0.0}
            t["outcomes"][outcome] = t["outcomes"].get(outcome, 0) + 1
            t["occupancy_s"] += elapsed
        if _monitor.enabled():
            _monitor.counter(
                "fleet_tenant_requests_total",
                "request terminal outcomes by accounting tenant "
                "(sums exactly to serving_requests_total)").labels(
                tenant=r.tenant, outcome=outcome).inc()
            _monitor.counter(
                "fleet_tenant_occupancy_seconds",
                "summed submit-to-settle seconds by tenant (time each "
                "tenant's requests occupied the engine)").labels(
                tenant=r.tenant).inc(elapsed)

    def _settle_error(self, r: _Request, key: str, err: BaseException,
                      locked: bool = False, dispatched: bool = False) -> None:
        """``dispatched``: the request had been taken off the queue (its
        batch executed), so the in-flight count must drop with it."""
        if locked:
            self._acct[key] += 1
            if dispatched:
                self._dispatched -= 1
        else:
            with self._lock:
                self._acct[key] += 1
                if dispatched:
                    self._dispatched -= 1
        self._record_outcome(key)
        self._finish_request(r, key, err)
        r.future._settle(error=err)

    def _account(self, key: str) -> None:
        with self._lock:
            self._acct[key] += 1
        self._record_outcome(key)

    @staticmethod
    def _record_outcome(outcome: str) -> None:
        if _monitor.enabled():
            _monitor.counter(
                "serving_requests_total",
                "request terminal outcomes (exactly one per submitted "
                "request)").labels(outcome=outcome).inc()
            if outcome == "deadline_exceeded":
                _monitor.counter(
                    "serving_deadline_exceeded_total",
                    "requests that expired before a response").inc()

    def _gauge_depth_locked(self) -> None:
        if _monitor.enabled():
            _monitor.gauge("serving_queue_depth",
                           "requests waiting for dispatch").set(
                len(self._queue))

    def _gauge_open_buckets(self) -> None:
        if _monitor.enabled():
            with self._lock:
                breakers = list(self._breakers.values())
            _monitor.gauge(
                "serving_breaker_open_buckets",
                "shape buckets currently quarantined").set(
                sum(1 for b in breakers if b.state != "closed"))

    # -- observability ---------------------------------------------------
    def warm_up(self, batch_sizes: Optional[Sequence[int]] = None) -> int:
        """Run every power-of-two bucket once with zero feeds built from
        the program's declared var shapes, so first real traffic never
        pays a bucket's compile event (nor, under
        ``FLAGS_epilogue_fusion``, the fusion pass and its witness).
        Returns the number of buckets run."""
        from ..core.types import np_dtype

        if batch_sizes is None:
            batch_sizes, b = [], 1
            while b < self.config.max_batch:
                batch_sizes.append(b)
                b <<= 1
            # max_batch itself is always a reachable bucket (_bucket_size
            # caps there), even when it is not a power of two
            batch_sizes.append(self.config.max_batch)
        blk = self._program.global_block
        for b in batch_sizes:
            feed = {}
            for n in self._feed_names:
                v = blk.var(n)
                tail = tuple(int(d) for d in v.shape[1:])
                feed[n] = np.zeros((int(b),) + tail, dtype=np_dtype(v.dtype))
            self._exe.run(self._program, feed=feed,
                          fetch_list=self._fetch_names, scope=self._scope)
        return len(batch_sizes)

    def accounting(self) -> dict:
        """Exact request accounting: ``submitted`` equals the sum of all
        terminal outcomes plus ``pending``. The load gate's invariant."""
        with self._lock:
            acct = dict(self._acct)
            # pending = queued + taken-but-unsettled (a batch mid-flight):
            # the invariant must hold at ANY instant, not just at idle
            acct["pending"] = len(self._queue) + self._dispatched
        terminal = sum(v for k, v in acct.items()
                       if k not in ("submitted", "pending"))
        acct["accounted"] = terminal + acct["pending"]
        acct["exact"] = acct["accounted"] == acct["submitted"]
        # the last N terminal outcomes with their trace ids (FLAGS_trace
        # off => ids "")
        acct["recent_outcomes"] = list(self._recent_outcomes)
        return acct

    def tenant_accounting(self) -> dict:
        """Per-tenant terminal-outcome ledger: ``{tenant: {"outcomes":
        {outcome: n}, "occupancy_s": float}}``. At quiescence the outcome
        counts sum exactly to ``accounting()``'s terminal counts."""
        with self._tenant_lock:
            out = {t: {"outcomes": dict(v["outcomes"]),
                       "occupancy_s": v["occupancy_s"],
                       "quota_sheds": v.get("quota_sheds", 0)}
                   for t, v in self._tenant_ledger.items()}
        if self.config.tenant_fair_share:
            # additive keys (documented minor change): the tenant's
            # configured share so the shed counts are auditable against
            # the policy that produced them
            for t, rec in out.items():
                rec["weight"] = self._tenant_weight(t)
                rec["quota"] = self._tenant_quota(t)
        return out

    def slo_state(self) -> dict:
        """The SLO burn tracker's serialized state (the health payload's
        ``"slo"`` value); refreshes the ``slo_burn_*`` gauges."""
        return self._slo.state()

    def health(self) -> dict:
        """Liveness/pressure snapshot; the key set is the reference's
        versioned :data:`HEALTH_SCHEMA_KEYS`."""
        with self._lock:
            depth = len(self._queue)
            degraded = self._degraded
            running = self._running
            cur_max = self._cur_max_batch
            breakers = list(self._breakers.values())
        open_buckets = [b.snapshot() for b in breakers
                        if b.state != "closed"]
        status = ("stopped" if not running
                  else "degraded" if degraded or open_buckets else "ok")
        return {"schema_version": HEALTH_SCHEMA_VERSION,
                "status": status, "ready": self.ready(),
                "queue_depth": depth,
                "queue_limit": self.config.queue_depth,
                "degraded": degraded, "current_max_batch": cur_max,
                "open_buckets": open_buckets,
                "accounting": self.accounting(),
                "slo": self._slo.state()}

    def ready(self) -> bool:
        """Readiness probe: accepting traffic and the dispatcher is
        alive."""
        with self._lock:
            running = self._running
        return bool(running and self._thread is not None
                    and self._thread.is_alive())
