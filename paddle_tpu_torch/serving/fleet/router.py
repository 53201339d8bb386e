"""Load-aware replica router: dispatch over N fleet front-ends.

The fleet's brain (docs/SERVING.md "Fleet tier — routing policy"): a
:class:`FleetRouter` owns a set of replica addresses (each a
``ServingFrontend`` over its own engine process), keeps a **pressure
snapshot** per replica by polling ``/healthz`` (queue depth, breaker
state, degradation, readiness — the engine's frozen health schema), and
routes each request to the least-loaded READY replica.

The contract extends the engine's exactly-one-outcome invariant
fleet-wide:

* **drain honor** — a preempted replica (SIGTERM -> drain) flips
  ``ready()`` false; the router stops routing to it while its admitted
  requests finish. Nothing a replica admitted is ever shed by routing.
* **unadmitted retry, exactly once** — a dispatch the replica provably
  did NOT admit (connection refused before the request was sent, or a
  429 shed / 410 stopped rejection whose error body does not claim
  admission — :func:`~.wire.response_is_unadmitted`: the front-end's
  explicit ``admitted`` flag is authoritative, so an ADMITTED request
  that settled ``EngineStopped`` also travels as 410 but is never
  redispatched) is retried on ONE sibling. Anything possibly admitted
  is never retried: a connection that dies after the request went out
  settles as typed :class:`~.wire.ReplicaLost` — retrying it could
  give one request two outcomes.
* **capability-aware generate** — ``generate()`` routes only to
  replicas whose health advertises the generative capability (mixed
  fleets: a request/response replica answers /v1/generate with a 400
  caller bug, so the router never sends one there).
* **no hangs** — zero ready replicas is a typed
  :class:`~paddle_tpu_torch.serving.Overloaded` (``reason="no_ready_replica"``)
  at submit, never a wait.
* **per-replica transport breaker** — consecutive transport failures
  (connect refused, connection died, request timeout, corrupt wire
  payload) eject a replica from routing (``serving.breaker`` reused per
  replica), so a stalling-but-listening replica stops eating
  ``request_timeout_s`` per request. Half-open probes ride the
  ``/healthz`` poll after the (doubling) cooldown; request traffic is
  never the probe. A corrupt 200 body or stream chunk is a typed
  :class:`~.wire.ReplicaLost`, never a silent empty/truncated result.
* **dynamic membership** — ``add_replica``/``remove_replica``/
  ``reassign_replica`` let the supervisor register a freshly (re)started
  replica (same id, new port) as fresh capacity within one poll.
* **trace propagation** — every dispatch carries the router's span
  context in ``X-PT-Trace``; the replica's request root joins it, so one
  trace id follows the request router -> frontend -> engine -> flight
  recorder and ``accounting()['recent_outcomes']`` on either side names
  the same id.

``accounting()`` is the fleet-wide ledger; metrics land on ``router_*``
(docs/OBSERVABILITY.md). Counterpart of
``paddle_tpu/serving/fleet/router.py``: the same policy, picks and
ledger.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import socket
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ... import monitor as _monitor
from ... import trace as _trace
from ...resilience import faults as _faults
from ...resilience.deadline import DeadlineExceeded
from ..breaker import CLOSED, CircuitBreaker
from ..engine import Overloaded
from . import wire
from .wire import ReplicaLost

__all__ = ["FleetRouter", "Replica", "RouterConfig"]

logger = logging.getLogger("paddle_tpu_torch.serving.fleet")


@dataclasses.dataclass
class RouterConfig:
    """Routing knobs. ``honor_drain``/``retry_unadmitted`` exist so the
    CI gate's negative control can prove the gate detects a router
    without them — production routers keep both on."""

    poll_interval_s: float = 0.2
    connect_timeout_s: float = 5.0
    request_timeout_s: float = 120.0
    honor_drain: bool = True
    retry_unadmitted: bool = True
    # pressure score weights: being degraded or holding open breakers
    # outweighs a handful of queued requests
    degraded_penalty: int = 16
    open_bucket_penalty: int = 8
    # per-replica circuit breaker (serving.breaker reused): this many
    # CONSECUTIVE transport failures (connect refused, connection died,
    # request timeout, corrupt wire payload) eject the replica from
    # routing — a stalling-but-listening replica must not eat
    # request_timeout_s per request. Half-open probes ride the /healthz
    # poll after the cooldown (doubling backoff per re-open).
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 1.0


class Replica:
    """One replica address + its last pressure snapshot."""

    def __init__(self, replica_id: str, host: str, port: int):
        self.replica_id = replica_id
        self.host = host
        self.port = int(port)
        self._lock = _monitor.make_lock("Replica._lock")
        # per-replica transport circuit breaker; attached/reset by the
        # router (its config carries the thresholds)
        self.breaker: Optional[CircuitBreaker] = None
        self._snap: Dict[str, Any] = self._fresh_snap()

    @staticmethod
    def _fresh_snap() -> Dict[str, Any]:
        return {"ok": False, "ready": False, "queue_depth": 0,
                "degraded": False, "open_buckets": 0, "generative": False,
                "status": "unknown", "slo_state": "unknown",
                "polled_at": 0.0}

    @property
    def address(self) -> str:
        host, port = self.endpoint()
        return f"{host}:{port}"

    def endpoint(self):
        """Atomic ``(host, port)`` snapshot — dispatch/poll must never
        observe a torn old-host/new-port pair across a ``reassign``."""
        with self._lock:
            return self.host, self.port

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._snap)

    def _update(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            self._snap = snap

    def reassign(self, host: str, port: int) -> None:
        """Point this replica entry at a fresh process (same id, new
        port) — the supervisor's restart path. The stale pressure
        snapshot is dropped so the next poll decides readiness."""
        with self._lock:
            self.host = host
            self.port = int(port)
            self._snap = self._fresh_snap()

    def __repr__(self):
        return f"Replica({self.replica_id}@{self.address})"


_TERMINAL_KEYS = ("completed", "shed", "deadline_exceeded", "failed",
                  "circuit_open", "stopped", "replica_lost", "other_error")


class FleetRouter:
    """See module docstring. ``replicas``: ``Replica`` objects or
    ``(replica_id, host, port)`` tuples. ``start()`` begins background
    polling; ``submit``/``generate`` are thread-safe and blocking (run
    them from your own worker threads for concurrency, exactly like
    ``ServingEngine.submit`` callers)."""

    def __init__(self, replicas: Sequence = (),
                 config: Optional[RouterConfig] = None):
        self.config = config or RouterConfig()
        # an EMPTY fleet is legal since the supervisor era (replicas
        # register as they come ready); submits shed typed meanwhile
        self.replicas: List[Replica] = []
        self._lock = _monitor.make_lock("FleetRouter._lock")
        self._breaker_lock = _monitor.make_lock("FleetRouter._breaker_lock")
        for r in replicas:
            self.add_replica(r)
        self._rr = 0
        self._poll_thread: Optional[threading.Thread] = None
        # in-flight /healthz poll connections: stop() closes them when a
        # hung poll would otherwise outlive the join bound
        self._poll_conns: set = set()
        self._stop_ev = threading.Event()
        self._acct: Dict[str, int] = {"submitted": 0, "retries": 0}
        self._acct.update({k: 0 for k in _TERMINAL_KEYS})
        self._pending = 0

    # -- fleet membership (the supervisor's registration surface) --------
    def _new_breaker(self, replica_id: str) -> CircuitBreaker:
        # emit_transitions=False: the router owns its own
        # router_breaker_transitions_total; the serving metric must keep
        # meaning BUCKET breakers
        return CircuitBreaker(self.config.breaker_threshold,
                              self.config.breaker_cooldown_s,
                              name=replica_id, emit_transitions=False)

    def add_replica(self, replica) -> Replica:
        """Register one replica (``Replica`` or ``(id, host, port)``).
        Thread-safe; a duplicate id is a caller bug."""
        r = replica if isinstance(replica, Replica) else Replica(*replica)
        r.breaker = self._new_breaker(r.replica_id)
        with self._lock:
            if any(x.replica_id == r.replica_id for x in self.replicas):
                raise ValueError(f"fleet router: replica id "
                                 f"'{r.replica_id}' already registered")
            # replace the list wholesale: _pick/poll iterate without the
            # lock and must never see a half-mutated list
            self.replicas = self.replicas + [r]
        return r

    def remove_replica(self, replica_id: str) -> Optional[Replica]:
        """Deregister (a retired/drained replica). Returns the removed
        entry, or ``None`` when unknown."""
        with self._lock:
            found = next((r for r in self.replicas
                          if r.replica_id == replica_id), None)
            if found is not None:
                self.replicas = [r for r in self.replicas
                                 if r is not found]
        return found

    def get_replica(self, replica_id: str) -> Optional[Replica]:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        return None

    def reassign_replica(self, replica_id: str, host: str,
                         port: int) -> Replica:
        """A restarted replica (same id, NEW port) re-enters as fresh
        capacity: snapshot dropped, transport breaker reset — the next
        poll (the supervisor triggers one) makes it routable."""
        r = self.get_replica(replica_id)
        if r is None:
            return self.add_replica(Replica(replica_id, host, port))
        r.reassign(host, port)
        with self._breaker_lock:
            r.breaker = self._new_breaker(r.replica_id)
        return r

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._poll_thread is not None:
            return self
        self.poll_now()
        self._stop_ev.clear()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="paddle_tpu_torch-fleet-router-poll",
            daemon=True)
        self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        t, self._poll_thread = self._poll_thread, None
        if t is not None:
            # bound teardown even when an in-flight /healthz poll is hung
            # on a stalled replica: give it one connect budget, then
            # close the socket under the read and join again
            t.join(self.config.connect_timeout_s)
            if t.is_alive():
                with self._lock:
                    conns = list(self._poll_conns)
                logger.warning(
                    "fleet router: poll thread still in a /healthz read "
                    "at stop() — closing %d in-flight poll socket(s)",
                    len(conns))
                for c in conns:
                    try:
                        c.close()   # closes the underlying socket too
                    except Exception:
                        pass
                t.join(2.0)
                if t.is_alive():
                    logger.error("fleet router: poll thread did not exit "
                                 "after its socket was closed")

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- polling ---------------------------------------------------------
    def _poll_loop(self) -> None:
        while not self._stop_ev.wait(self.config.poll_interval_s):
            self.poll_now()

    def poll_now(self) -> None:
        """One synchronous poll of every replica's ``/healthz``. A
        healthy poll is also the transport breaker's HALF-OPEN probe: an
        ejected replica whose cooldown elapsed and whose health answers
        ready is readmitted here — no request traffic is risked on it."""
        ready = 0
        for r in self.replicas:
            snap = self._poll_one(r)
            r._update(snap)
            self._breaker_probe(r, bool(snap["ok"] and snap["ready"]))
            ready += bool(snap["ok"] and snap["ready"])
            if _monitor.enabled():
                _monitor.counter(
                    "router_polls_total",
                    "replica health polls by result").labels(
                    replica=r.replica_id,
                    result="ok" if snap["ok"] else "error").inc()
        if _monitor.enabled():
            _monitor.gauge(
                "router_replicas_ready",
                "replicas currently ready for routing").set(ready)

    def _poll_one(self, r: Replica) -> Dict[str, Any]:
        host, port = r.endpoint()
        try:
            conn = http.client.HTTPConnection(
                host, port, timeout=self.config.connect_timeout_s)
            with self._lock:
                self._poll_conns.add(conn)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                raw = resp.read()
            finally:
                with self._lock:
                    self._poll_conns.discard(conn)
                conn.close()
            # the /healthz body is the engine's FROZEN health schema —
            # its schema_version field is HEALTH_SCHEMA_VERSION, NOT the
            # request wire schema, so it must not go through
            # wire.loads()'s version gate: the router reads documented
            # keys and tolerates a replica speaking a newer health schema
            try:
                body = json.loads(raw.decode("utf-8"))
            except Exception:
                body = {}
            if not isinstance(body, dict):
                body = {}
            slo = body.get("slo") if isinstance(body.get("slo"),
                                               dict) else {}
            return {"ok": resp.status == 200,
                    "ready": bool(body.get("ready")),
                    "queue_depth": int(body.get("queue_depth", 0)),
                    "degraded": bool(body.get("degraded")),
                    "open_buckets": len(body.get("open_buckets") or ()),
                    "generative": bool(body.get("generative")),
                    "status": str(body.get("status", "unknown")),
                    "slo_state": str(slo.get("state", "unknown")),
                    "polled_at": time.monotonic()}
        except Exception as e:
            return {"ok": False, "ready": False, "queue_depth": 0,
                    "degraded": False, "open_buckets": 0,
                    "generative": False,
                    "status": f"unreachable:{type(e).__name__}",
                    "slo_state": "unknown",
                    "polled_at": time.monotonic()}

    # -- per-replica transport breaker -----------------------------------
    # serving.breaker.CircuitBreaker documents single-thread allow/record;
    # router dispatches run from arbitrary caller threads plus the poll
    # thread, so every breaker touch goes through _breaker_lock.

    def _breaker_note(self, r: Replica, before: str) -> None:
        after = r.breaker.state
        if after == before:
            return
        logger.warning("fleet router: replica %s transport breaker %s -> "
                       "%s", r.replica_id, before, after)
        if _monitor.enabled():
            _monitor.counter(
                "router_breaker_transitions_total",
                "per-replica transport breaker state changes").labels(
                replica=r.replica_id, to=after).inc()
            _monitor.gauge(
                "router_breaker_open_replicas",
                "replicas currently ejected by their transport breaker"
            ).set(sum(1 for x in self.replicas
                      if x.breaker is not None
                      and x.breaker.state != CLOSED))

    def _breaker_failure(self, r: Replica,
                         br: Optional[CircuitBreaker] = None) -> None:
        """``br`` (captured when the dispatch STARTED) pins the record
        to one incarnation: a straggler failing against a replica that
        was reassigned mid-flight must not eject the fresh restart."""
        with self._breaker_lock:
            if br is not None and r.breaker is not br:
                return
            before = r.breaker.state
            r.breaker.record_failure()
            self._breaker_note(r, before)

    def _breaker_success(self, r: Replica,
                         br: Optional[CircuitBreaker] = None) -> None:
        with self._breaker_lock:
            if br is not None and r.breaker is not br:
                return
            before = r.breaker.state
            r.breaker.record_success()
            self._breaker_note(r, before)

    def _breaker_admits(self, r: Replica) -> bool:
        """Routing admission: only a CLOSED breaker routes. Open and
        half-open replicas wait for the /healthz poll probe — request
        traffic is never the probe."""
        with self._breaker_lock:
            return r.breaker is None or r.breaker.state == CLOSED

    def _breaker_probe(self, r: Replica, healthy: bool) -> None:
        """The half-open probe riding one /healthz poll result: after
        the cooldown a healthy poll closes the breaker (fresh capacity),
        an unhealthy one re-opens it onto the next backoff rung."""
        if r.breaker is None or r.breaker.state == CLOSED:
            return
        with self._breaker_lock:
            before = r.breaker.state
            verdict = r.breaker.allow()
            # both legs are noted separately: a failed probe's
            # open -> half_open -> open pair would otherwise compare
            # equal and leave re-opens (and the doubling cooldown
            # ladder) invisible in logs and the transition counter
            self._breaker_note(r, before)
            if verdict != "probe":
                return
            before = r.breaker.state
            if healthy:
                r.breaker.record_success()
            else:
                r.breaker.record_failure()
            self._breaker_note(r, before)

    # -- routing policy --------------------------------------------------
    def _score(self, snap: Dict[str, Any]) -> int:
        return (int(snap["queue_depth"])
                + self.config.degraded_penalty * bool(snap["degraded"])
                + self.config.open_bucket_penalty
                * int(snap["open_buckets"]))

    def _pick(self, exclude: Sequence[Replica] = (),
              require_generative: bool = False) -> Optional[Replica]:
        """Least-loaded routable replica (drain-aware unless the negative
        control disabled it), round-robin among score ties. With
        ``require_generative`` only replicas whose health advertises the
        generative capability are candidates."""
        # ONE snapshot per replica: filters and score must read the same
        # poll (a concurrent poll-thread update between reads could pass
        # a replica no single poll considered routable)
        cands = [(r, r.snapshot()) for r in self.replicas
                 if r not in exclude and self._breaker_admits(r)]
        if require_generative:
            cands = [(r, s) for r, s in cands if s.get("generative")]
        if self.config.honor_drain:
            cands = [(r, s) for r, s in cands if s["ok"] and s["ready"]]
        if not cands:
            return None
        with self._lock:
            self._rr += 1
            rot = self._rr
        scored = sorted(
            ((self._score(s), (i + rot) % len(cands), r)
             for i, (r, s) in enumerate(cands)), key=lambda t: t[:2])
        return scored[0][2]

    # -- accounting ------------------------------------------------------
    def _note_submitted(self) -> None:
        with self._lock:
            self._acct["submitted"] += 1
            self._pending += 1

    def _note_outcome(self, key: str, replica: str = "") -> None:
        with self._lock:
            self._acct[key] += 1
            self._pending -= 1
        if _monitor.enabled():
            _monitor.counter(
                "router_dispatch_total",
                "fleet-wide request terminal outcomes by replica (the "
                "replica that produced the outcome; 'none' when no "
                "replica was reachable)").labels(
                replica=replica or "none", outcome=key).inc()

    def _note_retry(self, reason: str) -> None:
        with self._lock:
            self._acct["retries"] += 1
        if _monitor.enabled():
            _monitor.counter(
                "router_retries_total",
                "unadmitted dispatches retried on a sibling, by reason"
            ).labels(reason=reason).inc()

    def accounting(self) -> dict:
        """The fleet-wide ledger: ``submitted`` equals the sum of all
        terminal outcomes plus ``pending`` (requests currently inside a
        ``submit``/``generate`` call): the fleet's
        invariant. ``retries`` counts sibling redispatches — a retried
        request still reaches exactly ONE outcome."""
        with self._lock:
            acct = dict(self._acct)
            acct["pending"] = self._pending
        terminal = sum(acct[k] for k in _TERMINAL_KEYS)
        acct["accounted"] = terminal + acct["pending"]
        acct["exact"] = acct["accounted"] == acct["submitted"]
        return acct

    @staticmethod
    def _outcome_key(e: BaseException) -> str:
        if isinstance(e, Overloaded):
            return "shed"
        if isinstance(e, DeadlineExceeded):
            return "deadline_exceeded"
        if isinstance(e, ReplicaLost):
            return "replica_lost"
        from ..engine import BatchFailed, CircuitOpen, EngineStopped

        if isinstance(e, BatchFailed):
            return "failed"
        if isinstance(e, CircuitOpen):
            return "circuit_open"
        if isinstance(e, EngineStopped):
            return "stopped"
        return "other_error"

    # -- submit ----------------------------------------------------------
    def submit(self, feed: Dict[str, Any], *, priority: Optional[int] = None,
               slo_class: Optional[str] = None,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None) -> List[np.ndarray]:
        """Route one request/response inference call. Returns the fetch
        rows, or raises the SAME typed outcome classes the in-process
        engine raises (reconstructed from the wire), plus
        :class:`ReplicaLost` for a replica that died holding an admitted
        request. Blocking; thread-safe."""
        body = {"schema_version": wire.WIRE_SCHEMA_VERSION,
                "feed": wire.encode_feed(feed)}
        if priority is not None:
            body["priority"] = int(priority)
        if slo_class is not None:
            body["slo_class"] = slo_class
        if deadline_s is not None:
            body["deadline_s"] = float(deadline_s)
        if tenant is not None:
            body["tenant"] = str(tenant)
        span = _trace.root_span("router.request", route="submit")
        self._note_submitted()
        t0 = time.monotonic()
        try:
            status, resp_body, replica = self._dispatch(
                "/v1/submit", body, span)
            if status == 200:
                try:
                    outs = wire.decode_outputs(resp_body)
                except wire.WireError as we:
                    # parseable JSON whose arrays don't decode is the
                    # same wire-integrity class as an unparseable body
                    raise ReplicaLost(
                        f"fleet: replica {replica} answered 200 with "
                        f"undecodable output arrays (wire corruption; "
                        f"request may have been admitted — not retried): "
                        f"{we}", replica=replica) from we
                span.set_attribute("outcome", "completed")
                span.set_attribute("replica", replica)
                span.end()
                self._note_outcome("completed", replica)
                if _monitor.enabled():
                    _monitor.histogram(
                        "router_request_seconds",
                        "end-to-end fleet request latency through the "
                        "router (completed requests; p50/p99 in the "
                        "snapshot)").observe(time.monotonic() - t0)
                return outs
            err = wire.error_from_body(resp_body,
                                       f"replica {replica} status {status}")
            err.replica = replica   # outcome attribution in the ledger
            raise err
        except BaseException as e:
            self._note_outcome(self._outcome_key(e),
                               getattr(e, "replica", ""))
            span.end(error=e)
            raise

    def _route_with_retry(self, attempt, *, generative: bool = False):
        """The unadmitted-retry policy, shared by ``submit`` and
        ``generate`` dispatch. ``attempt(replica)`` runs ONE dispatch
        attempt and classifies it:

        * ``("final", value)``          — terminal: ``value()`` is
          returned (or raises the typed outcome it closes over).
        * ``("reject", status, value)`` — the replica answered with a
          rejection :func:`wire.response_is_unadmitted` classified
          retryable (the front-end's explicit ``admitted`` flag is
          authoritative over the status map, so an ADMITTED request
          that settled ``EngineStopped`` — also a 410 — is never
          redispatched). Retried once, else ``value()``.
        * ``("unadmitted", exc)``       — provably never received
          (connection refused before any bytes moved). Retried once,
          else typed :class:`ReplicaLost`.
        * ``("lost", exc)``             — sent, then the connection
          died: possibly admitted, NEVER retried —
          :class:`ReplicaLost`.
        """
        tried: List[Replica] = []
        while True:
            r = self._pick(exclude=tried, require_generative=generative)
            if r is None:
                if tried:
                    # the retry also found nobody: surface the original
                    # rejection class as a shed (still typed)
                    raise Overloaded(
                        "fleet: no sibling available for unadmitted "
                        "retry", reason="no_ready_replica")
                if generative and self._pick() is not None:
                    raise Overloaded(
                        "fleet: no generative replica (the ready "
                        "replicas serve request/response only)",
                        reason="no_generative_replica")
                raise Overloaded(
                    "fleet: no ready replica (all draining, dead or "
                    "unreachable)", reason="no_ready_replica")
            outcome = attempt(r)
            kind = outcome[0]
            if kind == "final":
                return outcome[1]()
            if kind == "reject":
                _, status, value = outcome
                if self.config.retry_unadmitted and not tried:
                    tried.append(r)
                    self._note_retry(f"status_{status}")
                    continue
                return value()
            if kind == "unadmitted":
                _, exc = outcome
                if self.config.retry_unadmitted and not tried:
                    tried.append(r)
                    self._note_retry("connect_error")
                    continue
                raise ReplicaLost(
                    f"fleet: replica {r.replica_id} unreachable and "
                    f"retry exhausted: {exc}", replica=r.replica_id)
            if kind == "corrupt":
                # an undecodable body on a 200 (the request may have
                # been admitted AND completed replica-side) or on a
                # status whose authoritative admitted flag is unreadable:
                # never retried, never a silent empty result
                _, exc, status = outcome
                raise ReplicaLost(
                    f"fleet: replica {r.replica_id} answered {status} "
                    f"with an undecodable body (wire corruption; request "
                    f"may have been admitted — not retried): {exc}",
                    replica=r.replica_id)
            # kind == "lost": possibly admitted — never retried
            _, exc = outcome
            raise ReplicaLost(
                f"fleet: replica {r.replica_id} connection died after "
                f"the request was sent (request may have been admitted; "
                f"not retried): {exc}", replica=r.replica_id)

    def _dispatch(self, path: str, body: dict,
                  span) -> Tuple[int, dict, str]:
        """POST with the unadmitted-retry policy. Returns
        ``(status, body, replica_id)``; raises typed on transport-level
        outcomes (no replica / replica lost)."""
        def attempt(r: Replica):
            outcome = self._post_once(r, path, body, span)
            if outcome[0] != "response":
                return outcome
            _, status, resp_body = outcome
            value = lambda: (status, resp_body, r.replica_id)
            if wire.response_is_unadmitted(status, resp_body):
                return ("reject", status, value)
            return ("final", value)

        return self._route_with_retry(attempt)

    def _connect_and_post(self, r: Replica, path: str, body: dict, span):
        """Connect + POST one attempt, stopping at response HEADERS.
        Returns ``("conn", conn, resp)`` on any HTTP response (the
        caller owns and closes ``conn``), else the transport
        classification of :meth:`_route_with_retry`:
        ``("unadmitted", exc)`` — provably never received it;
        ``("lost", exc)``       — sent, then the connection died.
        Both transport failures feed the replica's circuit breaker.

        Chaos: the ``wire_connect`` fault site fires HERE, before any
        request bytes move — ``drop`` severs the dial (unadmitted, so
        the sibling retry must absorb it), ``stall`` delays the dial,
        ``corrupt`` mangles the request payload (the replica answers a
        400 the retry policy classifies unadmitted)."""
        payload = wire.dumps(body)
        br0 = r.breaker          # this dispatch's incarnation
        host, port = r.endpoint()    # atomic across a reassign
        conn = http.client.HTTPConnection(
            host, port, timeout=self.config.request_timeout_s)
        try:
            act = _faults.fault_action("wire_connect")
            if act == "drop":
                raise ConnectionRefusedError(
                    "[resilience] injected wire_connect drop")
            if act == "stall":
                _faults.stall()
            elif act == "corrupt":
                payload = b"\xff\x00corrupt" + payload[9:]
            # explicit connect with its own (short) timeout so a dead
            # replica is classified BEFORE any request bytes move
            conn.sock = socket.create_connection(
                (host, port), timeout=self.config.connect_timeout_s)
            conn.sock.settimeout(self.config.request_timeout_s)
        except OSError as e:
            conn.close()
            self._breaker_failure(r, br0)
            return ("unadmitted", e)
        headers = {"Content-Type": "application/json"}
        if span and span.trace_id:
            headers[wire.TRACE_HEADER] = span.context.to_wire()
        try:
            conn.request("POST", path, body=payload, headers=headers)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            self._breaker_failure(r, br0)
            return ("lost", e)
        return ("conn", conn, resp)

    def _post_once(self, r: Replica, path: str, body: dict, span):
        """One POST attempt, read to the end of the body, classified:
        ``("response", status, body)`` — the replica answered;
        ``("corrupt", exc)`` — the replica answered 200 with an
        undecodable body (a wire-integrity failure: the request may have
        been admitted AND completed replica-side, so it is surfaced as a
        typed :class:`ReplicaLost`, never a silent empty result); else
        the transport classifications of :meth:`_connect_and_post`.
        The ``wire_response`` fault site fires around the body read."""
        br0 = r.breaker          # this dispatch's incarnation
        out = self._connect_and_post(r, path, body, span)
        if out[0] != "conn":
            return out
        _, conn, resp = out
        try:
            act = _faults.fault_action("wire_response")
            if act == "drop":
                self._breaker_failure(r, br0)
                return ("lost", ConnectionResetError(
                    "[resilience] injected wire_response drop"))
            if act == "stall":
                _faults.stall()
            try:
                raw = resp.read()
            except (OSError, http.client.HTTPException) as e:
                self._breaker_failure(r, br0)
                return ("lost", e)
            if act == "corrupt" and raw:
                raw = b"\xff" + raw[1:]
            try:
                parsed = wire.loads(raw) if raw else {}
            except wire.WireError as we:
                # an undecodable body is a wire-integrity failure. For a
                # 200, or for a status the retry policy would redispatch
                # (the body's AUTHORITATIVE admitted flag is unreadable —
                # an admitted EngineStopped travels as 410 too), guessing
                # could give one request two outcomes: typed ReplicaLost,
                # never retried. Other statuses are final either way and
                # degrade to the status map.
                self._breaker_failure(r, br0)
                if resp.status == 200 \
                        or resp.status in wire.UNADMITTED_STATUSES:
                    return ("corrupt", we, resp.status)
                return ("response", resp.status, {})
            self._breaker_success(r, br0)
            return ("response", resp.status, parsed)
        finally:
            conn.close()

    # -- generate (streaming) --------------------------------------------
    def generate(self, prompt, *, max_new_tokens: Optional[int] = None,
                 priority: Optional[int] = None,
                 slo_class: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 tenant: Optional[str] = None) -> Iterator[int]:
        """Route one generation request and stream its tokens. The
        returned iterator yields ints as the replica emits them and ends
        with normal exhaustion on completion — or raises the typed
        terminal outcome AFTER the partial tokens (a replica that drains
        or dies mid-stream delivers what it produced, then the typed
        error; :class:`ReplicaLost` when the connection died). Dispatch
        and the unadmitted-retry decision happen eagerly in this call;
        consume the iterator to completion for exact accounting."""
        body: Dict[str, Any] = {
            "schema_version": wire.WIRE_SCHEMA_VERSION,
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
        }
        if max_new_tokens is not None:
            body["max_new_tokens"] = int(max_new_tokens)
        if priority is not None:
            body["priority"] = int(priority)
        if slo_class is not None:
            body["slo_class"] = slo_class
        if deadline_s is not None:
            body["deadline_s"] = float(deadline_s)
        if tenant is not None:
            body["tenant"] = str(tenant)
        span = _trace.root_span("router.request", route="generate")
        self._note_submitted()
        t0 = time.monotonic()
        try:
            conn, resp, replica = self._open_stream(body, span)
        except BaseException as e:
            self._note_outcome(self._outcome_key(e),
                               getattr(e, "replica", ""))
            span.end(error=e)
            raise
        return self._stream_tokens(conn, resp, replica, span, t0)

    def _open_stream(self, body, span):
        """Dispatch /v1/generate with the same unadmitted-retry policy
        as submit, stopping at response HEADERS (the body streams).
        Routed only to replicas advertising the generative capability."""
        def attempt(r: Replica):
            br0 = r.breaker      # this dispatch's incarnation
            out = self._connect_and_post(r, "/v1/generate", body, span)
            if out[0] != "conn":
                return out
            _, conn, resp = out
            if resp.status == 200:
                return ("final", lambda: (conn, resp, r))
            try:
                raw = resp.read()
            except (OSError, http.client.HTTPException):
                raw = b""
            conn.close()
            try:
                parsed = wire.loads(raw) if raw else {}
            except wire.WireError as we:
                # same wire-integrity rule as _post_once: a corrupt body
                # on a status the retry policy would redispatch hides
                # the authoritative admitted flag — never guess
                if resp.status in wire.UNADMITTED_STATUSES:
                    self._breaker_failure(r, br0)
                    return ("corrupt", we, resp.status)
                parsed = {}

            def raise_typed(parsed=parsed, status=resp.status):
                raise wire.error_from_body(
                    parsed, f"replica {r.replica_id} status {status}")

            if wire.response_is_unadmitted(resp.status, parsed):
                return ("reject", resp.status, raise_typed)
            return ("final", raise_typed)

        return self._route_with_retry(attempt, generative=True)

    def _stream_tokens(self, conn, resp, replica: Replica,
                       span, t0: float) -> Iterator[int]:
        streamed = 0
        br0 = replica.breaker    # this stream's incarnation
        outcome_err: Optional[BaseException] = None
        done = False
        try:
            while True:
                # the wire_stream fault site fires once per chunk read:
                # drop severs the stream, stall delays it, corrupt
                # mangles the chunk (hardened below into a typed loss)
                act = _faults.fault_action("wire_stream")
                if act == "drop":
                    self._breaker_failure(replica, br0)
                    outcome_err = ReplicaLost(
                        f"fleet: replica {replica.replica_id} stream "
                        f"dropped (injected) after {streamed} token(s)",
                        replica=replica.replica_id)
                    break
                if act == "stall":
                    _faults.stall()
                try:
                    line = resp.readline()
                except (OSError, http.client.HTTPException) as e:
                    self._breaker_failure(replica, br0)
                    outcome_err = ReplicaLost(
                        f"fleet: replica {replica.replica_id} died "
                        f"mid-stream after {streamed} token(s): {e}",
                        replica=replica.replica_id)
                    break
                if act == "corrupt":
                    # BEFORE the EOF check: a fired corrupt action must
                    # perform even when it lands on the terminating read
                    # (fired == performed, the audit-trail contract)
                    line = b"\xff" + line[1:]
                if not line:
                    if not done:
                        self._breaker_failure(replica, br0)
                        outcome_err = ReplicaLost(
                            f"fleet: replica {replica.replica_id} closed "
                            f"the stream without a terminal chunk "
                            f"({streamed} token(s) delivered)",
                            replica=replica.replica_id)
                    break
                try:
                    obj = wire.loads(line)
                except wire.WireError as we:
                    # an unparseable chunk is wire corruption, not noise:
                    # skipping it would silently lose tokens. Partials
                    # already yielded stand; the stream dies typed.
                    self._breaker_failure(replica, br0)
                    outcome_err = ReplicaLost(
                        f"fleet: replica {replica.replica_id} sent a "
                        f"corrupt stream chunk after {streamed} "
                        f"token(s) (not retried): {we}",
                        replica=replica.replica_id)
                    break
                if obj.get("done"):
                    done = True
                    if obj.get("error"):
                        outcome_err = wire.error_from_body(obj)
                    break
                for t in obj.get("tokens", ()):
                    streamed += 1
                    yield int(t)
        finally:
            conn.close()
            if outcome_err is None and not done:
                # generator closed early by the caller: the replica-side
                # outcome still lands; fleet-wide this call is abandoned
                outcome_err = ReplicaLost(
                    f"fleet: generate stream abandoned by the caller "
                    f"after {streamed} token(s)",
                    replica=replica.replica_id)
            if outcome_err is not None:
                self._note_outcome(self._outcome_key(outcome_err),
                                   replica.replica_id)
                span.end(error=outcome_err)
            else:
                self._breaker_success(replica, br0)
                span.set_attribute("outcome", "completed")
                span.set_attribute("replica", replica.replica_id)
                span.end()
                self._note_outcome("completed", replica.replica_id)
                if _monitor.enabled():
                    _monitor.histogram(
                        "router_request_seconds",
                        "end-to-end fleet request latency through the "
                        "router (completed requests; p50/p99 in the "
                        "snapshot)").observe(time.monotonic() - t0)
            if _monitor.enabled() and streamed:
                _monitor.counter(
                    "fleet_stream_tokens_total",
                    "tokens delivered over streaming fleet responses"
                ).inc(streamed)
        if outcome_err is not None:
            raise outcome_err
