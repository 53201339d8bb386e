"""Fleet front-end: the stdlib HTTP/JSON server over one serving engine.

One ``ServingFrontend`` wraps one
:class:`~paddle_tpu_torch.serving.ServingEngine`
(or :class:`GenerativeEngine`) and exposes it on the network — the layer
the ROADMAP's "millions of users" shape needs above the in-process engine
(reference: the gRPC/BRPC distributed runtime + serving fleet of
``paddle/fluid/operators/distributed/``). Stdlib only
(``http.server.ThreadingHTTPServer``): no new dependencies, one handler
thread per connection, the engine's own dispatch thread does the real
work.

Routes (wire schema: ``fleet.wire``, docs/SERVING.md "Fleet tier"):

* ``POST /v1/submit``   — request/response inference. Body carries the
  encoded feed, priority / SLO class and deadline; the response is the
  request's rows or a typed error with a DISTINCT status per outcome.
* ``POST /v1/generate`` — token streaming for a ``GenerativeEngine``:
  newline-delimited JSON chunks, one ``{"tokens": [...]}`` per emitted
  token, closed by a terminal ``{"done": true, ...}`` chunk carrying the
  typed outcome — a stream whose replica fails mid-generation delivers
  its partial tokens AND a typed terminal error, exactly like the
  in-process ``ServingFuture.stream()`` contract.
* ``GET /healthz``      — the engine's frozen ``health()`` payload
  (schema-versioned wire contract) plus replica identity and startup
  info (time-to-ready, warm-start cache stats).
* ``GET /readyz``       — 200/503 on ``ready()`` — the router's and any
  load balancer's routing signal; a draining replica flips 503 here
  while ``/healthz`` keeps answering.
* ``GET /metrics``      — the replica's monitor registry, Prometheus
  text exposition format 0.0.4; ``/metrics.json`` (or ``?format=json``)
  is the schema-versioned JSON form (``telemetry.metrics_json``) that
  additionally carries histogram trace exemplars, the SLO burn state
  and the per-tenant ledger. A probe route like ``/healthz``: the
  ``wire_response`` fault sites never fire here, so the telemetry plane
  stays observable while the request plane is under chaos.

Trace propagation: the ``X-PT-Trace`` request header carries the
caller's ``SpanContext`` across the wire; the front-end opens a
``fleet.request`` span under it and submits with ``trace_parent=`` so
the engine's request root — and every typed outcome and flight-recorder
incident — shares the caller's trace id across processes.

Metrics (docs/OBSERVABILITY.md): ``fleet_requests_total{route,outcome}``,
``fleet_request_seconds{route}``, ``fleet_stream_tokens_total``.
"""
from __future__ import annotations

import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ... import monitor as _monitor
from ... import trace as _trace
from ...resilience import faults as _faults
from ...resilience.deadline import DeadlineExceeded
from ..engine import ServingError
from ..generate import GenerativeEngine
from . import wire

__all__ = ["ServingFrontend", "FrontendConfig"]

logger = logging.getLogger("paddle_tpu_torch.serving.fleet")


class FrontendConfig:
    """Front-end knobs (plain defaults; the engine's own admission
    control is the load-shedding layer — the front-end only bounds how
    long a handler thread waits on a settled outcome)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 120.0):
        self.host = host
        self.port = int(port)
        self.request_timeout_s = float(request_timeout_s)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    frontend: "ServingFrontend" = None  # set by ServingFrontend.start

    def handle_error(self, request, client_address):
        # a client dropping its keep-alive connection is normal churn,
        # not a stack trace on stderr; real handler errors still answer
        # structured 500s in the handler itself
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            TimeoutError)):
            logger.debug("fleet frontend: client %s dropped (%s)",
                         client_address, type(exc).__name__)
            return
        super().handle_error(request, client_address)


class ServingFrontend:
    """See module docstring. ``extra_health`` is merged into the
    ``/healthz`` body next to the engine payload (the replica worker
    reports startup timing + warm-start cache stats through it)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 replica_id: str = "",
                 request_timeout_s: float = 120.0,
                 extra_health: Optional[Dict[str, Any]] = None):
        self.engine = engine
        self.config = FrontendConfig(host, port, request_timeout_s)
        self.replica_id = replica_id
        self.extra_health = dict(extra_health or {})
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._inflight_lock = _monitor.make_lock(
            "ServingFrontend._inflight_lock")

    # -- lifecycle -------------------------------------------------------
    def start(self) -> int:
        """Bind + serve on a daemon thread. Returns the bound port
        (``port=0`` picks a free one)."""
        if self._server is not None:
            return self.port
        srv = _Server((self.config.host, self.config.port), _Handler)
        srv.frontend = self
        self._server = srv
        self._thread = threading.Thread(
            target=srv.serve_forever,
            name=f"paddle_tpu_torch-fleet-frontend-{self.replica_id or 'r'}",
            daemon=True)
        self._thread.start()
        logger.info("fleet frontend %s serving on %s:%d",
                    self.replica_id or "(unnamed)", self.host, self.port)
        return self.port

    def stop(self, wait_inflight_s: float = 10.0) -> None:
        """Stop accepting connections; give in-flight handlers (e.g.
        responses for requests a draining engine just settled) a bounded
        window to finish writing."""
        srv, self._server = self._server, None
        if srv is None:
            return
        deadline = time.monotonic() + wait_inflight_s
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        srv.shutdown()
        srv.server_close()
        if self._thread is not None:
            self._thread.join(5.0)

    @property
    def host(self) -> str:
        return (self._server.server_address[0] if self._server
                else self.config.host)

    @property
    def port(self) -> int:
        return (self._server.server_address[1] if self._server
                else self.config.port)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def __enter__(self) -> "ServingFrontend":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- health bodies ---------------------------------------------------
    def health_body(self) -> dict:
        body = self.engine.health()          # the frozen wire contract
        body["replica_id"] = self.replica_id
        # capability flag for the router's mixed-fleet dispatch: only a
        # GenerativeEngine replica serves /v1/generate (and its feed-less
        # engine serves no /v1/submit)
        body["generative"] = isinstance(self.engine, GenerativeEngine)
        if self.extra_health:
            body["startup"] = self.extra_health
        return body

    # -- metrics ---------------------------------------------------------
    @staticmethod
    def _count(route: str, outcome: str) -> None:
        if _monitor.enabled():
            _monitor.counter(
                "fleet_requests_total",
                "front-end HTTP requests by route and typed outcome"
            ).labels(route=route, outcome=outcome).inc()

    @staticmethod
    def _observe_latency(seconds: float, route: str,
                         trace_id: str = "") -> None:
        if _monitor.enabled():
            # exemplar: the request's trace id rides the bucket this
            # observation lands in (telemetry plane only — no exemplar
            # storage is ever allocated while the plane is off)
            ex = trace_id if _monitor.telemetry_enabled() else ""
            _monitor.histogram(
                "fleet_request_seconds",
                "front-end request wall time by route, admission to "
                "response written (p50/p99 in the snapshot)").labels(
                route=route).observe(seconds, exemplar=ex or None)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # -- plumbing --------------------------------------------------------
    @property
    def fe(self) -> ServingFrontend:
        return self.server.frontend

    def log_message(self, fmt, *args):   # stdlib default spams stderr
        logger.debug("fleet http %s", fmt % args)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(n) if n else b""

    def _send_json(self, status: int, obj: dict,
                   corrupt: bool = False) -> None:
        raw = wire.dumps(obj)
        if corrupt and raw:
            # the wire_response 'corrupt' action: same length, mangled
            # bytes — the router must classify this typed, never return
            # a silent empty result
            raw = b"\xff" + raw[1:]
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _trace_parent(self):
        return _trace.SpanContext.from_wire(
            self.headers.get(wire.TRACE_HEADER))

    # -- routes ----------------------------------------------------------
    def do_GET(self):
        with self._track():
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                self._send_json(200, self.fe.health_body())
            elif path == "/readyz":
                ready = bool(self.fe.engine.ready())
                self._send_json(200 if ready else 503,
                                {"schema_version": wire.WIRE_SCHEMA_VERSION,
                                 "ready": ready,
                                 "replica_id": self.fe.replica_id})
            elif path in ("/metrics", "/metrics.json"):
                self._metrics(path, query)
            else:
                self._send_json(404, {"error": {"type": "NotFound",
                                                "message": self.path}})

    def do_POST(self):
        with self._track():
            if self.path == "/v1/submit":
                self._submit()
            elif self.path == "/v1/generate":
                self._generate()
            else:
                self._send_json(404, {"error": {"type": "NotFound",
                                                "message": self.path}})

    def _metrics(self, path: str, query: str) -> None:
        """``GET /metrics`` — Prometheus text exposition (0.0.4) of the
        replica's registry; ``/metrics.json`` / ``?format=json`` is the
        schema-versioned JSON form with exemplars, SLO state and the
        tenant ledger. Refreshing ``engine.slo_state()`` first keeps the
        ``slo_burn_*`` gauges current in BOTH forms. No fault injection
        fires here (probe route — see ``_respond_best_effort``)."""
        from urllib.parse import parse_qs

        from . import telemetry

        fe = self.fe
        # getattr-guarded: a bare engine double (tests) without the SLO
        # tracker or tenant ledger still serves its registry
        slo = tenants = None
        slo_fn = getattr(fe.engine, "slo_state", None)
        if callable(slo_fn):
            slo = slo_fn()    # side effect: refreshes slo_burn_* gauges
        ten_fn = getattr(fe.engine, "tenant_accounting", None)
        if callable(ten_fn):
            tenants = ten_fn()
        fmt = (parse_qs(query).get("format") or [""])[0]
        if path.endswith(".json") or fmt == "json":
            body = telemetry.metrics_json(
                replica_id=fe.replica_id, slo=slo, tenants=tenants)
            self._send_raw(200, "application/json", wire.dumps(body))
        else:
            text = _monitor.get_registry().to_prometheus()
            self._send_raw(200, "text/plain; version=0.0.4; charset=utf-8",
                           text.encode("utf-8"))

    def _send_raw(self, status: int, content_type: str,
                  raw: bytes) -> None:
        try:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)
        except (BrokenPipeError, ConnectionResetError, TimeoutError,
                OSError):
            logger.debug("fleet frontend: scraper gone before the "
                         "metrics body was written")

    def _track(self):
        fe = self.fe

        class _T:
            def __enter__(self_t):
                with fe._inflight_lock:
                    fe._inflight += 1

            def __exit__(self_t, *exc):
                with fe._inflight_lock:
                    fe._inflight -= 1
                return False

        return _T()

    # -- submit ----------------------------------------------------------
    def _submit(self) -> None:
        fe = self.fe
        t0 = time.monotonic()
        span = _trace.start_span("fleet.request", parent=self._trace_parent(),
                                 route="submit", replica=fe.replica_id)
        try:
            body = wire.loads(self._body())
            feed = wire.decode_feed(body.get("feed"))
            priority = wire.resolve_priority(body)
            deadline_s = body.get("deadline_s")
            fut = fe.engine.submit(
                feed, priority=priority,
                deadline_s=float(deadline_s)
                if deadline_s is not None else None,
                trace_parent=span if span else self._trace_parent(),
                tenant=wire.resolve_tenant(body))
        except Exception as e:
            # NOTHING was admitted (validation bug or a submit-time
            # typed rejection): the router may safely redispatch
            self._send_error("submit", span, e, admitted=False)
            return
        try:
            outs = fut.result(timeout=fe.config.request_timeout_s)
        except Exception as e:
            # the request WAS admitted; this typed outcome is final —
            # the admitted flag forbids a router retry even for
            # EngineStopped (stop-without-drain / dispatcher crash),
            # which at submit time would have been retryable
            self._send_error("submit", span, e, admitted=True)
            return
        # the engine-side outcome is settled: count/span close first so
        # a caller that hung up cannot double-count the request through
        # the error path — a failed WRITE is not a serving outcome
        span.set_attribute("outcome", "completed")
        span.end()
        fe._count("submit", "completed")
        fe._observe_latency(time.monotonic() - t0, "submit",
                            fut.trace_id)
        self._respond_best_effort(200,
                                  wire.encode_outputs(outs, fut.trace_id))

    def _respond_best_effort(self, status: int, obj: dict) -> None:
        """Write a response to a caller that may already be gone; a dead
        connection is logged, never re-routed into the error path (the
        engine-side outcome already holds). The ``wire_response`` fault
        site fires HERE (request responses only — the health probes stay
        clean, which is exactly what makes a stalling-but-listening
        replica the breaker's hard case): ``drop`` severs the connection
        before any byte, ``stall`` sleeps ``FLAGS_fault_stall_s`` first
        (the router times out and must eject this replica), ``corrupt``
        mangles the body bytes."""
        try:
            act = _faults.fault_action("wire_response")
            if act == "drop":
                logger.warning("fleet frontend: injected wire_response "
                               "drop — severing the connection")
                self.close_connection = True
                self.connection.close()
                return
            if act == "stall":
                _faults.stall()
            self._send_json(status, obj, corrupt=(act == "corrupt"))
        except (BrokenPipeError, ConnectionResetError, TimeoutError,
                OSError):
            logger.debug("fleet frontend: client gone before the "
                         "response was written")

    def _send_error(self, route: str, span, e: BaseException,
                    admitted: Optional[bool] = None) -> None:
        fe = self.fe
        span.end(error=e)
        outcome = type(e).__name__
        fe._count(route, outcome)
        if not isinstance(e, (ServingError, DeadlineExceeded, ValueError,
                              TimeoutError)):
            # engine bugs still answer structured (500) — but loudly
            logger.exception("fleet frontend: unexpected %s on /%s",
                             outcome, route)
        self._respond_best_effort(wire.status_for(e),
                                  wire.error_body(e, admitted=admitted))

    # -- generate (streaming) --------------------------------------------
    def _generate(self) -> None:
        fe = self.fe
        t0 = time.monotonic()
        span = _trace.start_span("fleet.request", parent=self._trace_parent(),
                                 route="generate", replica=fe.replica_id)
        if not isinstance(fe.engine, GenerativeEngine):
            err = wire.WireError("this replica serves request/response "
                                 "inference only (no /v1/generate)")
            self._send_error("generate", span, err)
            return
        try:
            body = wire.loads(self._body())
            prompt = body.get("prompt")
            if not isinstance(prompt, list) or not prompt:
                raise wire.WireError("generate body needs a non-empty "
                                     "'prompt' token list")
            deadline_s = body.get("deadline_s")
            fut = fe.engine.submit(
                [int(t) for t in prompt],
                max_new_tokens=body.get("max_new_tokens"),
                priority=wire.resolve_priority(body),
                deadline_s=float(deadline_s)
                if deadline_s is not None else None,
                trace_parent=span if span else self._trace_parent(),
                tenant=wire.resolve_tenant(body))
        except Exception as e:
            # nothing streamed yet: a plain typed error response, so the
            # router can still classify admitted vs unadmitted by status
            self._send_error("generate", span, e)
            return
        # admitted: from here the response is a 200 ND-JSON stream and
        # the typed outcome travels in the TERMINAL chunk
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header(wire.TRACE_HEADER,
                         f"{fut.trace_id}/" if fut.trace_id else "")
        self.end_headers()
        streamed = 0
        outcome: Optional[BaseException] = None
        try:
            for tok in fut.stream(timeout=fe.config.request_timeout_s):
                self._chunk({"tokens": [int(tok)]})
                streamed += 1
        except (ServingError, DeadlineExceeded) as e:
            outcome = e
        except (BrokenPipeError, ConnectionResetError):
            # caller hung up mid-stream; the engine still settles the
            # request exactly once — nothing more to write
            span.end(error=ConnectionError("client disconnected"))
            fe._count("generate", "client_disconnected")
            return
        except TimeoutError as e:
            outcome = e
        try:
            if outcome is None:
                self._chunk({"done": True, "outcome": "completed",
                             "tokens_streamed": streamed,
                             "trace_id": fut.trace_id})
                span.set_attribute("outcome", "completed")
                span.end()
                fe._count("generate", "completed")
            else:
                body = wire.error_body(outcome)
                body.update(done=True, tokens_streamed=streamed)
                self._chunk(body)
                span.end(error=outcome)
                fe._count("generate", type(outcome).__name__)
            self._chunk(None)   # chunked-encoding terminator
            fe._observe_latency(time.monotonic() - t0, "generate",
                                fut.trace_id)
            if _monitor.enabled() and streamed:
                _monitor.counter(
                    "fleet_stream_tokens_total",
                    "tokens delivered over streaming fleet responses"
                ).inc(streamed)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _chunk(self, obj: Optional[dict]) -> None:
        """One chunked-transfer frame (None = final empty chunk). The
        ``wire_stream`` fault site fires per frame: ``drop`` severs the
        stream mid-generation (the router delivers the partials, then a
        typed terminal), ``stall`` delays the frame, ``corrupt`` mangles
        it (the router classifies it typed instead of losing tokens)."""
        if obj is None:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
            return
        act = _faults.fault_action("wire_stream")
        if act == "drop":
            logger.warning("fleet frontend: injected wire_stream drop — "
                           "severing the stream")
            self.close_connection = True
            self.connection.close()
            raise BrokenPipeError("[resilience] injected wire_stream drop")
        if act == "stall":
            _faults.stall()
        line = wire.dumps(obj) + b"\n"
        if act == "corrupt":
            line = b"\xff" + line[1:]
        self.wfile.write(f"{len(line):x}\r\n".encode("ascii") + line
                         + b"\r\n")
        self.wfile.flush()
