"""The PyTorch port's fleet tier (``paddle_tpu_torch.serving.fleet``)
against the JAX package's, on the CPU: the wire schema (byte-identical
bodies, each package decoding the other's), the frozen health schema, the
HTTP front-end, the load-aware router (the same picks, retries and
refusals over canned replicas; a port router over a JAX front-end and a
JAX router over a port front-end), streaming generation, the wire fault
sites, the replica supervisor (the same crash classification) and the
replica process (``--device cpu``). Host code: every comparison is exact
unless a tolerance is stated.

``COUNTERPARTS`` maps every test of the JAX package's fleet, fleet-chaos,
autoscaler, telemetry and tenant fair-share files to the port test that
holds the same scenario, or says why it has none; a test here checks the
map is whole. Every HTTP server binds port 0, every wait is bounded."""
from __future__ import annotations

import ast
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import serving as jserving
from paddle_tpu import trace as jtrace
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience.deadline import DeadlineExceeded as JDeadline
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving.fleet import wire as jwire

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience.deadline import DeadlineExceeded
from paddle_tpu_torch.serving import fleet as tfleet
from paddle_tpu_torch.serving.fleet import (FleetRouter, Replica,
                                            ReplicaCrashLoop, ReplicaLost,
                                            ReplicaSupervisor, RouterConfig,
                                            ServingFrontend,
                                            SupervisorConfig, WireError,
                                            wire)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60


@pytest.fixture(autouse=True)
def _flags_and_plans_reset():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    snaps = [(m, dict(m._overrides)) for m in (jflags, tflags)]
    yield
    for m, snap in snaps:
        m._overrides.clear()
        m._overrides.update(snap)
        m._set_epoch += 1
    jfaults.clear_plan()
    tfaults.clear_plan()


class Pkg:
    """One package's handles, so a scenario runs unchanged in both."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.fluid = jfluid if jax_side else tfluid
        self.un = jun if jax_side else tun
        self.serving = jserving if jax_side else tserving
        self.fleet = jfleet if jax_side else tfleet
        self.wire = jwire if jax_side else wire
        self.trace = jtrace if jax_side else ttrace
        self.faults = jfaults if jax_side else tfaults
        self.Deadline = JDeadline if jax_side else DeadlineExceeded


JAX, TORCH = Pkg("jax"), Pkg("torch")
PKGS = (JAX, TORCH)


def _build_infer(pkg, hidden=4, in_dim=13):
    fl = pkg.fluid
    with pkg.un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[in_dim], dtype="float32")
            pred = fl.layers.fc(x, hidden, act="softmax")
        infer = main.clone(for_test=True)
    return infer, startup, pred.name


_PARAMS = {}


def _params():
    """The JAX package's initialised weights (made once per process), so
    both packages' engines hold the same parameters."""
    if not _PARAMS:
        infer, startup, _ = _build_infer(JAX)
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        exe.run(startup, scope=scope)
        _PARAMS.update({n: scope.numpy(n)
                        for n in startup.global_block.vars})
    return _PARAMS


def make_engine(pkg=TORCH, **cfg_kw):
    infer, _, pred = _build_infer(pkg)
    fl = pkg.fluid
    exe = fl.Executor(fl.CPUPlace())
    if pkg.name == "jax":
        scope = fl.Scope()
        for n, a in _params().items():
            scope.set_var(n, a)
    else:
        scope = scope_from_numpy(_params(), fl.Scope(), fl.CPUPlace())
    cfg = pkg.serving.ServingConfig(max_batch=cfg_kw.pop("max_batch", 4),
                                    **cfg_kw)
    return pkg.serving.ServingEngine(infer, feed_names=["x"],
                                     fetch_list=[pred], scope=scope,
                                     executor=exe, config=cfg)


def feed(rows=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(rows, 13).astype(np.float32)}


def serve(pkg=TORCH, replica_id="t0", **cfg_kw):
    """A started engine behind a started front-end."""
    cfg_kw.setdefault("batch_window_s", 0.005)
    eng = make_engine(pkg, **cfg_kw)
    eng.warm_up()
    eng.start()
    fe = pkg.fleet.ServingFrontend(eng, replica_id=replica_id)
    fe.start()
    return eng, fe


def close(eng, fe):
    fe.stop(wait_inflight_s=2.0)
    if not eng._stopped:
        eng.stop(drain=False)


def post(port, path, body, headers=None, timeout=WAIT):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=wire.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, wire.loads(resp.read())
    finally:
        conn.close()


def get(port, path, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class CannedReplica:
    """A fake front-end answering canned responses (the JAX package's
    ``tests/test_fleet.py`` idiom): routing-policy tests that need
    wire-level control a real engine cannot give deterministically."""

    def __init__(self, responses=(), queue_depth=0, generative=False):
        self.requests = 0
        self.responses = list(responses)
        self.health = {"schema_version": 1, "status": "ok", "ready": True,
                       "queue_depth": queue_depth, "degraded": False,
                       "open_buckets": [], "generative": generative}
        outer = self

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status, obj):
                raw = wire.dumps(obj)
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                self._json(200, outer.health)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                self.rfile.read(n)
                outer.requests += 1
                if outer.responses:
                    status, body = outer.responses.pop(0)
                else:
                    status, body = 200, wire.encode_outputs(
                        [np.zeros((1, 4), np.float32)])
                self._json(status, body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        threading.Thread(target=self.server.serve_forever, args=(0.05,),
                         daemon=True).start()
        self.port = self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


# ---------------------------------------------------------------------------
# wire schema: byte-identical bodies, each package decodes the other's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "int64", "bool"])
def test_wire_arrays_encode_to_identical_bytes(dtype):
    a = (np.random.RandomState(0).rand(3, 5) * 100).astype(dtype)
    tb, jb = wire.dumps(wire.encode_array(a)), \
        jwire.dumps(jwire.encode_array(a))
    assert tb == jb
    for dec in (wire.decode_array, jwire.decode_array):
        b = dec(json.loads(tb))
        assert b.dtype == a.dtype and np.array_equal(a, b)
        b[0] = 0      # decoded arrays are writable
    outs = [a, a[:1]]
    assert wire.dumps(wire.encode_outputs(outs, "t1")) \
        == jwire.dumps(jwire.encode_outputs(outs, "t1"))
    assert wire.dumps(wire.encode_feed({"x": a})) \
        == jwire.dumps(jwire.encode_feed({"x": a}))


def test_wire_bfloat16_tensor_bytes_equal_the_jax_packages():
    """A bf16 tensor travels as the JAX package's bfloat16 array of the
    same values (``ml_dtypes``), byte for byte, and decodes back."""
    import ml_dtypes
    import torch

    t = torch.from_numpy(np.random.RandomState(1).rand(3, 5).astype(
        np.float32)).bfloat16()
    a = t.float().numpy().astype(ml_dtypes.bfloat16)
    tb = wire.dumps(wire.encode_array(t))
    assert tb == jwire.dumps(jwire.encode_array(a))
    back = wire.decode_array(json.loads(tb))
    assert np.array_equal(np.asarray(back).view(np.int16),
                          a.view(np.int16))


def _outcomes(pkg):
    s = pkg.serving
    return [s.Overloaded("x", reason="queue_age"),
            s.CircuitOpen("x", bucket="b4(x)"), s.EngineStopped("x"),
            pkg.Deadline("req #7", 0.5, 0.8), s.BatchFailed("x"),
            s.PoisonRequest("x", fingerprint="abcd1234"),
            pkg.wire.WireError("x"), pkg.wire.ReplicaLost("x", "r3"),
            ValueError("bad feed"), RuntimeError("bug")]


def test_wire_status_per_typed_outcome_equals_jax():
    got = [wire.status_for(e) for e in _outcomes(TORCH)]
    assert got == [jwire.status_for(e) for e in _outcomes(JAX)]
    assert got[:5] + [got[6]] == [429, 503, 410, 504, 500, 400]
    assert set(wire.UNADMITTED_STATUSES) == set(jwire.UNADMITTED_STATUSES)
    assert wire.SLO_CLASSES == jwire.SLO_CLASSES
    assert (wire.WIRE_SCHEMA_VERSION, wire.TRACE_HEADER) \
        == (jwire.WIRE_SCHEMA_VERSION, jwire.TRACE_HEADER)


@pytest.mark.parametrize("admitted", [None, True, False])
def test_wire_error_bodies_identical_and_cross_decoded(admitted):
    for te, je in zip(_outcomes(TORCH), _outcomes(JAX)):
        te.trace_id = je.trace_id = "abc123"
        tb = wire.dumps(wire.error_body(te, admitted=admitted))
        assert tb == jwire.dumps(jwire.error_body(je, admitted=admitted))
        # each package rebuilds the other's body into its own classes
        tback = wire.error_from_body(jwire.loads(tb))
        jback = jwire.error_from_body(wire.loads(tb))
        assert type(tback).__name__ == type(jback).__name__
        assert str(tback) == str(jback)
        for k in ("reason", "bucket", "budget_s", "elapsed_s",
                  "fingerprint", "replica", "trace_id", "transient"):
            assert getattr(tback, k, None) == getattr(jback, k, None), k
        assert wire.response_is_unadmitted(410, json.loads(tb)) \
            == jwire.response_is_unadmitted(410, json.loads(tb))


def test_wire_refuses_newer_schema_and_malformed_bodies():
    for bad in (b'{"schema_version": 99}', b'{"schema_version": "x"}',
                b'{"schema_version": null}', b"not json", b"[1, 2]"):
        with pytest.raises(WireError):
            wire.loads(bad)
        with pytest.raises(jwire.WireError):
            jwire.loads(bad)
    with pytest.raises(WireError):
        wire.decode_feed("nope")
    with pytest.raises(WireError):
        wire.decode_array({"dtype": "float32", "shape": [2], "b64": "!"})


def test_wire_priority_and_tenant_resolution_equal_jax():
    bodies = [{}, {"slo_class": "interactive"}, {"slo_class": "batch"},
              {"priority": 7, "slo_class": "batch"},
              {"tenant": " team-a "}, {"tenant": ""}, {"tenant": None}]
    for b in bodies:
        assert wire.resolve_priority(b) == jwire.resolve_priority(b)
        assert wire.resolve_tenant(b) == jwire.resolve_tenant(b)
    for bad in ({"slo_class": "platinum"}, ):
        with pytest.raises(WireError):
            wire.resolve_priority(bad)
    for bad in ({"tenant": 5}, {"tenant": "x" * 65}, {"tenant": "a b"},
                {"tenant": "a\nb"}):
        with pytest.raises(WireError):
            wire.resolve_tenant(bad)
        with pytest.raises(jwire.WireError):
            jwire.resolve_tenant(bad)


def test_wire_admitted_flag_overrides_status_classification():
    stopped = tserving.EngineStopped("stopped mid-flight")
    assert wire.response_is_unadmitted(
        410, wire.error_body(stopped, admitted=True)) is False
    assert wire.response_is_unadmitted(
        410, wire.error_body(stopped, admitted=False)) is True
    assert wire.response_is_unadmitted(410, {}) is True
    assert wire.response_is_unadmitted(429, None) is True
    assert wire.response_is_unadmitted(500, {}) is False


def test_span_context_wire_crosses_packages():
    ctx = ttrace.SpanContext("tid123", "sid456")
    back = jtrace.SpanContext.from_wire(ctx.to_wire())
    assert (back.trace_id, back.span_id) == ("tid123", "sid456")
    back = ttrace.SpanContext.from_wire(
        jtrace.SpanContext("t9", "s9").to_wire())
    assert (back.trace_id, back.span_id) == ("t9", "s9")
    for v in (None, "", "no-separator"):
        assert ttrace.SpanContext.from_wire(v) is None


# ---------------------------------------------------------------------------
# the frozen health schema
# ---------------------------------------------------------------------------

def test_health_schema_equals_jax_frozen_one():
    assert set(tserving.HEALTH_SCHEMA_KEYS) \
        == set(jserving.HEALTH_SCHEMA_KEYS)
    assert tserving.HEALTH_SCHEMA_VERSION == jserving.HEALTH_SCHEMA_VERSION
    bodies = {}
    for pkg in PKGS:
        eng, fe = serve(pkg)
        try:
            status, raw = get(fe.port, "/healthz")
            assert status == 200
            bodies[pkg.name] = json.loads(raw)
        finally:
            close(eng, fe)
    assert set(bodies["torch"]) == set(bodies["jax"])
    assert set(tserving.HEALTH_SCHEMA_KEYS) <= set(bodies["torch"])
    for k in ("replica_id", "generative", "ready", "status",
              "schema_version", "queue_depth", "open_buckets"):
        assert bodies["torch"][k] == bodies["jax"][k], k
    assert set(bodies["torch"]["accounting"]) \
        == set(bodies["jax"]["accounting"])


def test_health_schema_same_before_start_and_after_stop():
    eng = make_engine()
    assert set(eng.health()) == set(tserving.HEALTH_SCHEMA_KEYS)
    eng.start()
    try:
        assert eng.health()["ready"] is True
    finally:
        eng.stop()
    h = eng.health()
    assert h["status"] == "stopped" and h["ready"] is False
    assert set(h) == set(tserving.HEALTH_SCHEMA_KEYS)


def test_submit_trace_parent_joins_caller_trace():
    tfluid.set_flags({"FLAGS_trace": 1})
    eng = make_engine()
    eng.warm_up()
    with eng:
        ctx = ttrace.SpanContext("feedf00d00000001", "feedf00d00000002")
        fut = eng.submit(feed(), trace_parent=ctx)
        fut.result(timeout=WAIT)
    assert fut.trace_id == "feedf00d00000001"
    assert eng.accounting()["recent_outcomes"][-1]["trace_id"] \
        == "feedf00d00000001"


# ---------------------------------------------------------------------------
# the front-end over HTTP (the port's engine on the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture()
def frontend():
    eng, fe = serve()
    yield fe
    close(eng, fe)


def test_frontend_submit_roundtrip_bit_exact(frontend):
    status, body = post(frontend.port, "/v1/submit",
                        {"schema_version": wire.WIRE_SCHEMA_VERSION,
                         "feed": wire.encode_feed(feed(seed=3))})
    assert status == 200
    direct = frontend.engine.submit(feed(seed=3)).result(timeout=WAIT)
    assert np.array_equal(wire.decode_outputs(body)[0], direct[0])


def test_frontend_validation_is_400_not_an_outcome(frontend):
    eng = frontend.engine
    before = eng.accounting()["submitted"]
    status, body = post(frontend.port, "/v1/submit", {"feed": {
        "wrong_name": wire.encode_array(np.zeros((1, 13), np.float32))}})
    assert status == 400 and body["error"]["type"] == "ValueError"
    assert eng.accounting()["submitted"] == before
    assert post(frontend.port, "/v1/submit", {"feed": "garbage"})[0] == 400
    # generate on a request/response replica is a caller bug too
    assert post(frontend.port, "/v1/generate", {"prompt": [1]})[0] == 400


def test_frontend_stopped_engine_maps_to_410(frontend):
    frontend.engine.stop(drain=False)
    status, body = post(frontend.port, "/v1/submit",
                        {"feed": wire.encode_feed(feed())})
    assert status == 410 and body["error"]["type"] == "EngineStopped"
    assert body["error"]["admitted"] is False


def test_frontend_unknown_route_404(frontend):
    assert post(frontend.port, "/v1/nope", {})[0] == 404
    assert get(frontend.port, "/nope")[0] == 404


def test_frontend_healthz_readyz(frontend):
    status, raw = get(frontend.port, "/healthz")
    h = json.loads(raw)
    assert status == 200 and h["replica_id"] == "t0"
    assert h["generative"] is False
    status, raw = get(frontend.port, "/readyz")
    assert status == 200 and json.loads(raw)["ready"] is True
    frontend.engine.stop(drain=True)
    status, raw = get(frontend.port, "/readyz")
    assert status == 503 and json.loads(raw)["ready"] is False
    status, raw = get(frontend.port, "/healthz")
    h = json.loads(raw)
    assert status == 200 and h["ready"] is False
    assert h["status"] == "stopped"


def test_frontend_trace_header_propagates(frontend):
    tfluid.set_flags({"FLAGS_trace": 1})
    ctx = ttrace.SpanContext("cafecafe00000001", "cafecafe00000002")
    status, body = post(frontend.port, "/v1/submit",
                        {"feed": wire.encode_feed(feed())},
                        headers={wire.TRACE_HEADER: ctx.to_wire()})
    assert status == 200 and body["trace_id"] == "cafecafe00000001"
    assert frontend.engine.accounting()["recent_outcomes"][-1][
        "trace_id"] == "cafecafe00000001"


# ---------------------------------------------------------------------------
# the router over real port engines
# ---------------------------------------------------------------------------

@pytest.fixture()
def fleet2():
    """Two in-process replicas behind a router (no poll thread: tests
    drive poll_now() for determinism)."""
    pairs = [serve(replica_id=f"r{i}") for i in range(2)]
    router = FleetRouter([Replica(f"r{i}", "127.0.0.1", fe.port)
                          for i, (_, fe) in enumerate(pairs)])
    router.poll_now()
    yield router, [e for e, _ in pairs], [f for _, f in pairs]
    router.stop()
    for eng, fe in pairs:
        close(eng, fe)


def test_router_submit_completes_with_exact_accounting(fleet2):
    router, engines, _ = fleet2
    for i in range(6):
        direct = engines[0].submit(feed(seed=i)).result(timeout=WAIT)
        assert np.array_equal(router.submit(feed(seed=i))[0], direct[0])
    acct = router.accounting()
    assert acct["exact"] and acct["completed"] == 6
    assert acct["submitted"] == 6 and acct["pending"] == 0


def test_router_honors_drain(fleet2):
    router, engines, _ = fleet2
    engines[0].stop(drain=True)
    router.poll_now()
    before = engines[1].accounting()["submitted"]
    for i in range(5):
        router.submit(feed(seed=i))
    assert engines[1].accounting()["submitted"] - before == 5
    acct = router.accounting()
    assert acct["completed"] == 5 and acct["exact"]
    assert acct["stopped"] == 0 and acct["replica_lost"] == 0


def test_router_all_draining_is_typed_overloaded_not_a_hang(fleet2):
    router, engines, _ = fleet2
    for eng in engines:
        eng.stop(drain=True)
    router.poll_now()
    t0 = time.monotonic()
    with pytest.raises(tserving.Overloaded) as ei:
        router.submit(feed())
    assert ei.value.reason == "no_ready_replica"
    assert time.monotonic() - t0 < 5.0
    acct = router.accounting()
    assert acct["shed"] == 1 and acct["exact"]


def test_router_dead_replica_between_poll_and_dispatch_retries(fleet2):
    router, engines, fronts = fleet2
    fronts[0].stop(wait_inflight_s=0.5)
    engines[0].stop(drain=False)
    for i in range(6):
        router.submit(feed(seed=i))
    acct = router.accounting()
    assert acct["completed"] == 6 and acct["exact"]
    assert acct["retries"] >= 1 and acct["replica_lost"] == 0


def test_router_retry_is_exactly_once_then_typed(fleet2):
    router, engines, fronts = fleet2
    for fe in fronts:
        fe.stop(wait_inflight_s=0.5)
    for eng in engines:
        eng.stop(drain=False)
    t0 = time.monotonic()
    with pytest.raises((ReplicaLost, tserving.Overloaded)):
        router.submit(feed())
    assert time.monotonic() - t0 < 20.0
    acct = router.accounting()
    assert acct["retries"] == 1 and acct["exact"]


def test_router_negative_control_ignores_drain(fleet2):
    _, engines, fronts = fleet2
    nc = FleetRouter([Replica(f"r{i}", "127.0.0.1", fe.port)
                      for i, fe in enumerate(fronts)],
                     config=RouterConfig(honor_drain=False,
                                         retry_unadmitted=False))
    nc.poll_now()
    engines[0].stop(drain=True)
    nc.poll_now()
    stopped = 0
    for i in range(8):
        try:
            nc.submit(feed(seed=i))
        except tserving.EngineStopped:
            stopped += 1
    assert stopped >= 1 and nc.accounting()["exact"]


def test_router_generate_requires_generative_capability(fleet2):
    router, engines, _ = fleet2
    with pytest.raises(tserving.Overloaded) as ei:
        router.generate([1, 2, 3], max_new_tokens=2)
    assert ei.value.reason == "no_generative_replica"
    assert all(e.accounting()["submitted"] == 0 for e in engines)
    acct = router.accounting()
    assert acct["shed"] == 1 and acct["exact"]


@pytest.mark.parametrize("router_pkg", ["torch", "jax"])
def test_cross_package_router_over_the_other_frontend(router_pkg):
    """A port router over a JAX front-end and a JAX router over a port
    front-end: the same rows as each engine answers directly (the two
    engines hold the same weights; f32 rtol 1e-5 across packages, exact
    against the serving engine's own direct answer)."""
    rp = TORCH if router_pkg == "torch" else JAX
    sp = JAX if router_pkg == "torch" else TORCH
    eng, fe = serve(sp, replica_id="x0")
    try:
        router = rp.fleet.FleetRouter(
            [rp.fleet.Replica("x0", "127.0.0.1", fe.port)])
        router.poll_now()
        other = make_engine(rp)
        other.warm_up()
        with other:
            for i in range(4):
                got = router.submit(feed(seed=i))[0]
                direct = eng.submit(feed(seed=i)).result(timeout=WAIT)[0]
                assert np.array_equal(got, direct)
                mine = other.submit(feed(seed=i)).result(timeout=WAIT)[0]
                np.testing.assert_allclose(got, mine, rtol=1e-5,
                                           atol=1e-6)
        # a typed refusal crosses too
        eng.stop(drain=True)
        router.poll_now()
        with pytest.raises(rp.serving.Overloaded):
            router.submit(feed())
        acct = router.accounting()
        assert acct["completed"] == 4 and acct["shed"] == 1
        assert acct["exact"]
    finally:
        close(eng, fe)


# ---------------------------------------------------------------------------
# routing policy over canned replicas: the same picks as the JAX router
# ---------------------------------------------------------------------------

_SNAP = {"ok": True, "ready": True, "degraded": False, "open_buckets": 0,
         "status": "ok", "polled_at": 0.0, "generative": False,
         "slo_state": "unknown", "queue_depth": 0}

# per step: the three replicas' snapshot overrides
PICK_TRACE = [
    [{}, {}, {}],
    [{}, {}, {}],
    [{}, {}, {}],
    [{"queue_depth": 9}, {"queue_depth": 2}, {"queue_depth": 5}],
    [{"queue_depth": 3, "degraded": True}, {"queue_depth": 8}, {}],
    [{"open_buckets": 2}, {"queue_depth": 5}, {"queue_depth": 5}],
    [{"ready": False}, {"queue_depth": 1}, {"queue_depth": 1}],
    [{"ok": False}, {"ok": False}, {"queue_depth": 40}],
    [{"ready": False}, {"ready": False}, {"ready": False}],
    [{"generative": True}, {}, {"generative": True, "queue_depth": 1}],
    [{}, {"queue_depth": 1}, {"queue_depth": 1}],
]


def _pick_sequence(pkg, honor_drain=True):
    router = pkg.fleet.FleetRouter(
        [(f"p{i}", "127.0.0.1", 1 + i) for i in range(3)],
        pkg.fleet.RouterConfig(honor_drain=honor_drain))
    seq = []
    for step, overrides in enumerate(PICK_TRACE):
        for r, o in zip(router.replicas, overrides):
            r._update({**_SNAP, **o})
        for exclude in ((), (router.replicas[1],)):
            for gen in (False, True):
                r = router._pick(exclude=exclude, require_generative=gen)
                seq.append((step, len(exclude), gen,
                            r.replica_id if r is not None else None))
    return seq


@pytest.mark.parametrize("honor_drain", [True, False])
def test_router_pick_sequence_equals_jax(honor_drain):
    seq = _pick_sequence(TORCH, honor_drain)
    assert seq == _pick_sequence(JAX, honor_drain)
    assert len({p for *_, p in seq}) >= 3     # the trace exercises picks


def _retry_scenarios(pkg):
    """Canned two-replica scenarios: (victim responses, sibling
    responses); the victim is pinned first by the sibling's queue."""
    s = pkg.serving
    stopped = s.EngineStopped("engine stopped holding the request")
    shed = s.Overloaded("queue full", reason="queue_full")
    ok = (200, pkg.wire.encode_outputs([np.ones((1, 4), np.float32)]))
    return [
        ([(410, pkg.wire.error_body(stopped, admitted=True))], [ok]),
        ([(410, pkg.wire.error_body(stopped, admitted=False))], [ok]),
        ([(429, pkg.wire.error_body(shed, admitted=False))], [ok]),
        ([(429, pkg.wire.error_body(shed, admitted=False))],
         [(429, pkg.wire.error_body(shed, admitted=False))]),
        ([(504, pkg.wire.error_body(pkg.Deadline("r", 0.1, 0.2),
                                    admitted=True))], [ok]),
        ([(500, pkg.wire.error_body(s.BatchFailed("boom"),
                                    admitted=True))], [ok]),
        ([(400, pkg.wire.error_body(ValueError("bad"), admitted=False))],
         [ok]),
        ([ok], [ok]),
    ]


def _run_retry_scenarios(pkg):
    out = []
    for victim_rs, sibling_rs in _retry_scenarios(pkg):
        victim = CannedReplica(victim_rs)
        sibling = CannedReplica(sibling_rs, queue_depth=50)
        try:
            router = pkg.fleet.FleetRouter(
                [pkg.fleet.Replica("v", "127.0.0.1", victim.port),
                 pkg.fleet.Replica("s", "127.0.0.1", sibling.port)])
            router.poll_now()
            try:
                outs = router.submit(feed())
                result = ("ok", outs[0].tolist())
            except Exception as e:
                result = (type(e).__name__, getattr(e, "reason", None))
            acct = router.accounting()
            out.append((result, victim.requests, sibling.requests,
                        {k: acct[k] for k in ("retries", "completed",
                                              "shed", "stopped", "failed",
                                              "deadline_exceeded",
                                              "other_error", "exact")}))
        finally:
            victim.close()
            sibling.close()
    return out


def test_router_retries_and_refusals_equal_jax():
    got = _run_retry_scenarios(TORCH)
    assert got == _run_retry_scenarios(JAX)
    # the admitted 410 is never redispatched; the unadmitted one is
    assert got[0][0][0] == "EngineStopped" and got[0][2] == 0
    assert got[1][0][0] == "ok" and got[1][3]["retries"] == 1


def test_router_poll_tolerates_future_health_schema():
    rep = CannedReplica(queue_depth=3)
    try:
        rep.health.update(schema_version=99)
        r = Replica("h0", "127.0.0.1", rep.port)
        FleetRouter([r]).poll_now()
        snap = r.snapshot()
        assert snap["ok"] and snap["ready"] and snap["queue_depth"] == 3
    finally:
        rep.close()


# ---------------------------------------------------------------------------
# transport breaker, corrupt hardening, bounded stop, membership
# ---------------------------------------------------------------------------

@pytest.fixture
def fleet1():
    eng, fe = serve(replica_id="good")
    router = FleetRouter(
        [Replica("good", "127.0.0.1", fe.port)],
        RouterConfig(poll_interval_s=0.05, connect_timeout_s=2.0,
                     request_timeout_s=5.0, breaker_threshold=2,
                     breaker_cooldown_s=0.2))
    router.poll_now()
    yield router, eng, fe
    router.stop()
    close(eng, fe)


def test_router_breaker_ejects_dead_replica_after_threshold(fleet1):
    router, _, _ = fleet1
    dead = router.add_replica(Replica("dead", "127.0.0.1", free_port()))
    router.config.honor_drain = False
    for i in range(8):
        assert router.submit(feed(seed=i))[0].shape == (1, 4)
    assert dead.breaker.state == "open"
    retries_at_open = router.accounting()["retries"]
    for i in range(4):
        router.submit(feed(seed=10 + i))
    assert router.accounting()["retries"] == retries_at_open
    acct = router.accounting()
    assert acct["exact"] and acct["completed"] == 12


def test_router_breaker_probe_rides_healthz_poll(fleet1):
    router, _, _ = fleet1
    good = router.get_replica("good")
    router._breaker_failure(good)
    router._breaker_failure(good)
    assert good.breaker.state == "open" and router._pick() is None
    deadline = time.monotonic() + 5.0
    while good.breaker.state != "closed" and time.monotonic() < deadline:
        router.poll_now()
        time.sleep(0.05)
    assert good.breaker.state == "closed" and router._pick() is good
    assert router.submit(feed())[0].shape == (1, 4)


def test_router_corrupt_200_is_typed_replica_lost(fleet1):
    router, _, _ = fleet1
    with tfaults.fault_plan_guard("wire_response:@1:corrupt"):
        with pytest.raises(ReplicaLost, match="undecodable"):
            router.submit(feed())
    assert router.submit(feed())[0].shape == (1, 4)
    acct = router.accounting()
    assert acct["exact"] and acct["replica_lost"] == 1


def test_router_corrupt_retryable_status_never_redispatches():
    class _H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            raw = wire.dumps({"schema_version": 1, "status": "ok",
                              "ready": True, "queue_depth": 0,
                              "degraded": False, "open_buckets": []})
            self.send_response(200)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
            raw = b"\xffgarbage-not-json"
            self.send_response(410)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        router = FleetRouter(
            [Replica("c410", "127.0.0.1", srv.server_address[1])],
            RouterConfig(poll_interval_s=10.0, honor_drain=False))
        with pytest.raises(ReplicaLost, match="undecodable"):
            router.submit(feed())
        acct = router.accounting()
        assert acct["exact"] and acct["retries"] == 0 \
            and acct["replica_lost"] == 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_router_wire_connect_drop_retried_on_sibling(fleet1):
    router, _, fe = fleet1
    router.add_replica(Replica("good2", "127.0.0.1", fe.port))
    router.poll_now()
    with tfaults.fault_plan_guard("wire_connect:@1:drop") as plan:
        assert router.submit(feed())[0].shape == (1, 4)
        assert ("wire_connect", 1, "drop") in plan.fired
    acct = router.accounting()
    assert acct["retries"] == 1 and acct["completed"] == 1 and acct["exact"]


def test_frontend_metrics_probe_routes_immune_to_wire_faults(frontend):
    """The ``wire_response`` site fires on request responses only: the
    health and metrics probes stay clean under a drop-everything plan."""
    with tfaults.fault_plan_guard("wire_response:1:drop"):
        assert get(frontend.port, "/healthz")[0] == 200
        assert get(frontend.port, "/metrics")[0] == 200
        assert get(frontend.port, "/metrics.json")[0] == 200


def test_router_stop_bounded_with_hung_healthz_poll():
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)      # accepts connections, never answers
    try:
        router = FleetRouter(
            [Replica("hung", "127.0.0.1", srv.getsockname()[1])],
            RouterConfig(poll_interval_s=0.05, connect_timeout_s=2.0))
        router.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        router.stop()
        assert time.monotonic() - t0 < 3.9    # not 2 x 2 s of timeouts
    finally:
        srv.close()


def test_router_membership_add_remove_reassign():
    router = FleetRouter([])
    with pytest.raises(tserving.Overloaded):
        router.submit(feed())
    r = router.add_replica(("a", "127.0.0.1", 1234))
    assert router.get_replica("a") is r and r.breaker is not None
    with pytest.raises(ValueError):
        router.add_replica(("a", "127.0.0.1", 99))
    old = r.breaker
    router._breaker_failure(r)
    router.reassign_replica("a", "127.0.0.1", 4321)
    assert r.port == 4321 and r.breaker is not old
    assert router.remove_replica("a") is r
    assert router.get_replica("a") is None
    assert router.remove_replica("a") is None


# ---------------------------------------------------------------------------
# streaming generation through the fleet (a gpt_tiny port replica)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpt_fleet():
    from paddle_tpu_torch.serving.fleet.replica import build_probe

    cfg = tserving.ServingConfig(max_batch=4, queue_depth=64)
    eng, _ = build_probe("gpt_tiny", cfg, "cpu")
    eng.warm_up()
    eng.start()
    fe = ServingFrontend(eng, replica_id="g0")
    fe.start()
    router = FleetRouter([Replica("g0", "127.0.0.1", fe.port)])
    router.poll_now()
    yield router, eng, fe
    router.stop()
    fe.stop(wait_inflight_s=2.0)
    if not eng._stopped:
        eng.stop(drain=False)


def test_router_generate_streams_the_engines_tokens(gpt_fleet):
    """One request in flight at a time: the routed stream equals the
    engine's own answer to the same prompt, token for token."""
    router, eng, _ = gpt_fleet
    for prompt in ([5, 3, 1], [7, 7, 2, 9, 4]):
        toks = list(router.generate(prompt, max_new_tokens=6))
        direct = eng.submit(prompt, max_new_tokens=6).result(timeout=WAIT)
        assert toks == [int(t) for t in direct[0]]
        assert len(toks) == 6 and all(isinstance(t, int) for t in toks)
    acct = router.accounting()
    assert acct["exact"] and acct["completed"] >= 2


def test_router_generate_mid_drain_partials_then_typed(gpt_fleet):
    router, eng, _ = gpt_fleet
    gen = router.generate([2, 2, 2], max_new_tokens=24)
    got = []
    with pytest.raises((tserving.EngineStopped, tserving.BatchFailed,
                        ReplicaLost)):
        for i, t in enumerate(gen):
            got.append(t)
            if i == 1:
                eng.stop(drain=False)
    assert 2 <= len(got) < 24
    assert router.accounting()["exact"]


class CorruptStreamReplica:
    """A generative-looking front-end that streams two token chunks and
    then a corrupt chunk (``corrupt``) or severs the stream (``drop``)."""

    def __init__(self, mode):
        outer = self
        self.mode = mode

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                raw = wire.dumps({"schema_version": 1, "status": "ok",
                                  "ready": True, "queue_depth": 0,
                                  "degraded": False, "open_buckets": [],
                                  "generative": True})
                self.send_response(200)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)
                                    or 0))
                self.send_response(200)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(b):
                    self.wfile.write(f"{len(b):x}\r\n".encode() + b
                                     + b"\r\n")
                    self.wfile.flush()

                chunk(wire.dumps({"tokens": [1]}) + b"\n")
                chunk(wire.dumps({"tokens": [2]}) + b"\n")
                if outer.mode == "corrupt":
                    chunk(b"\xffgarbage\n")
                    chunk(b"x")
                else:
                    self.close_connection = True

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        threading.Thread(target=self.server.serve_forever, args=(0.05,),
                         daemon=True).start()
        self.port = self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("mode", ["corrupt", "drop"])
@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_stream_corruption_and_drop_surface_typed_after_partials(mode, pkg):
    rep = CorruptStreamReplica(mode)
    try:
        router = pkg.fleet.FleetRouter(
            [pkg.fleet.Replica("g", "127.0.0.1", rep.port)],
            pkg.fleet.RouterConfig(poll_interval_s=10.0,
                                   request_timeout_s=10.0))
        router.poll_now()
        got = []
        with pytest.raises(pkg.wire.ReplicaLost):
            for t in router.generate([1, 2, 3], max_new_tokens=8):
                got.append(t)
        assert got == [1, 2]
        acct = router.accounting()
        assert acct["exact"] and acct["replica_lost"] == 1
    finally:
        rep.close()


# ---------------------------------------------------------------------------
# the wire fault sites of resilience.faults
# ---------------------------------------------------------------------------

def test_wire_fault_sites_and_actions_equal_jax():
    assert set(tfaults.WIRE_SITES) == set(jfaults.WIRE_SITES)
    assert {"wire_connect", "wire_response", "wire_stream"} \
        <= set(tfaults.SITES)
    tfaults.FaultPlan("wire_connect:1:drop,wire_response:@2:corrupt,"
                      "wire_stream:p0.5:stall")
    with pytest.raises(ValueError, match="data-plane wire action"):
        tfaults.FaultPlan("step:1:drop")
    with pytest.raises(ValueError, match="unknown action"):
        tfaults.FaultPlan("wire_connect:1:mangle")

    def pattern(mod, seed):
        p = mod.FaultPlan("wire_response:p0.4:drop", seed=seed)
        return [p.action("wire_response") for _ in range(32)]

    assert pattern(tfaults, 11) == pattern(jfaults, 11)
    assert pattern(tfaults, 11) != pattern(tfaults, 12)
    p = tfaults.FaultPlan("wire_connect:@2:drop,wire_stream:1:corrupt")
    assert p.action("wire_stream") == "corrupt"
    assert p.action("wire_connect") is None
    assert p.action("wire_connect") == "drop"
    assert sorted(p.fired) == [("wire_connect", 2, "drop"),
                               ("wire_stream", 1, "corrupt")]
    with tfaults.fault_plan_guard("wire_connect:1:ConnectionError"):
        with pytest.raises(ConnectionError):
            tfaults.fault_action("wire_connect")
    with tfaults.fault_plan_guard("wire_connect:1:drop"):
        tfaults.fault_point("wire_connect")
    tfluid.set_flags({"FLAGS_fault_stall_s": 0.08})
    t0 = time.monotonic()
    tfaults.stall()
    assert 0.06 <= time.monotonic() - t0 < 1.0


# ---------------------------------------------------------------------------
# the supervisor: stub processes, and the classification against the JAX one
# ---------------------------------------------------------------------------

_STUB = r"""
import json, os, signal, sys, time
mode = sys.argv[1]
if mode == "neverready":
    time.sleep(600)
print(json.dumps({"event": "ready", "replica_id": "s", "port": 18999,
                  "time_to_ready_s": 0.01}), flush=True)
if mode == "crash":
    time.sleep(0.1)
    print(json.dumps({"event": "exit", "replica_id": "s",
                      "reason": "crash", "error": "boom"}), flush=True)
    sys.exit(21)
if mode == "crash_once":
    marker = sys.argv[2]
    if not os.path.exists(marker):
        open(marker, "w").close()
        time.sleep(0.1)
        print(json.dumps({"event": "exit", "replica_id": "s",
                          "reason": "crash", "error": "boom"}), flush=True)
        sys.exit(21)
def term(*a):
    print(json.dumps({"event": "exit", "replica_id": "s",
                      "reason": "drain", "accounting": {}}), flush=True)
    sys.exit(0)
signal.signal(signal.SIGTERM, term)
while True:
    time.sleep(0.05)
"""


@pytest.fixture
def stub(tmp_path):
    path = tmp_path / "stub_replica.py"
    path.write_text(_STUB)

    def cmd(mode, *extra):
        return lambda h: [sys.executable, str(path), mode,
                          *[str(e) for e in extra]]

    return cmd, tmp_path


def sup_cfg(**kw):
    kw.setdefault("max_restarts", 2)
    kw.setdefault("restart_window_s", 30.0)
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_max_s", 0.2)
    kw.setdefault("ready_timeout_s", 15.0)
    kw.setdefault("exit_grace_s", 5.0)
    return SupervisorConfig(**kw)


def test_supervisor_registers_ready_replica_with_router(stub):
    cmd, tmp = stub
    router = FleetRouter([])
    sup = ReplicaSupervisor(router, sup_cfg(), log_dir=str(tmp),
                            spawn_command=cmd("ok"))
    try:
        h = sup.add_replica("s0")
        assert h.wait_ready(15)["port"] == 18999
        assert router.get_replica("s0").port == 18999
        assert h.state == "ready"
    finally:
        sup.stop()


def test_supervisor_graceful_drain_never_restarts(stub):
    cmd, tmp = stub
    sup = ReplicaSupervisor(None, sup_cfg(), log_dir=str(tmp),
                            spawn_command=cmd("ok"))
    try:
        h = sup.add_replica("s0")
        h.wait_ready(15)
        sup.drain("s0")
        h.thread.join(15)
        assert h.state == "stopped" and h.restarts == 0
        assert h.last_exit["reason"] == "drain"
    finally:
        sup.stop()


def test_supervisor_restarts_crashed_replica_with_backoff(stub):
    cmd, tmp = stub
    sup = ReplicaSupervisor(FleetRouter([]), sup_cfg(), log_dir=str(tmp),
                            spawn_command=cmd("crash_once",
                                              tmp / "crashed_once"))
    try:
        h = sup.add_replica("s0")
        h.wait_ready(15)
        deadline = time.monotonic() + 20
        while (h.restarts < 1 or h.state != "ready") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert h.restarts == 1 and h.state == "ready", h.status()
        assert h.last_exit["reason"] == "crash" and h.error is None
        assert any(k == "restart" for _, k, _d in h.events)
    finally:
        sup.stop()


def test_supervisor_crash_loop_retires_typed(stub):
    cmd, tmp = stub
    router = FleetRouter([])
    sup = ReplicaSupervisor(router, sup_cfg(), log_dir=str(tmp),
                            spawn_command=cmd("crash"))
    try:
        h = sup.add_replica("s0")
        assert h.wait_retired(30), h.status()
        assert h.state == "retired"
        assert isinstance(h.error, ReplicaCrashLoop)
        assert h.error.replica == "s0"
        assert h.restarts == sup.config.max_restarts
        assert h.spawns == sup.config.max_restarts + 1
        assert router.get_replica("s0") is None
        with pytest.raises(ReplicaCrashLoop):
            sup.check()
        with pytest.raises(ReplicaCrashLoop):
            h.wait_ready(5)
    finally:
        sup.stop()


def test_supervisor_negative_control_spawn_once(stub):
    cmd, tmp = stub
    sup = ReplicaSupervisor(None, sup_cfg(restart=False),
                            log_dir=str(tmp), spawn_command=cmd("crash"))
    try:
        h = sup.add_replica("s0")
        h.thread.join(20)
        assert h.state == "down" and h.restarts == 0 and h.spawns == 1
        with pytest.raises(RuntimeError, match="will not become ready"):
            h.wait_ready()
    finally:
        sup.stop()


def test_supervisor_kill_classification(stub):
    cmd, tmp = stub
    sup = ReplicaSupervisor(None, sup_cfg(max_restarts=5),
                            log_dir=str(tmp), spawn_command=cmd("ok"))
    try:
        h = sup.add_replica("s0")
        h.wait_ready(15)
        sup.kill("s0")
        deadline = time.monotonic() + 20
        while h.restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert h.restarts == 1, h.status()
        assert h.last_exit["reason"] == "kill"
    finally:
        sup.stop()


class _Proc:
    def __init__(self, rc):
        self.returncode = rc


# (exit event or None, return code) -> the classification
EXIT_CASES = [
    ({"reason": "drain"}, 0), ({"reason": "drain"}, 1),
    ({"reason": "crash"}, 21), ({"reason": "crash"}, 0), (None, -9),
    (None, 137), (None, 124), (None, 0), (None, 1), (None, 21),
    ({"reason": "other"}, 0), ({}, -15), (None, None),
]


def test_supervisor_exit_classification_equals_jax():
    from paddle_tpu.serving.fleet.supervisor import \
        ReplicaSupervisor as JSup

    def classify(cls, ev, rc):
        h = type("H", (), {})()
        h.exit_info = ev
        return cls._classify_exit(h, _Proc(rc))

    got = [classify(ReplicaSupervisor, ev, rc) for ev, rc in EXIT_CASES]
    assert got == [classify(JSup, ev, rc) for ev, rc in EXIT_CASES]
    assert set(got) == {"drain", "crash", "kill"}


def test_supervisor_default_command_spawns_the_port_replica():
    sup = ReplicaSupervisor(None, SupervisorConfig(
        shared_flags={"FLAGS_autotune": "use"}))
    h = tfleet.SupervisedReplica("r7", "gpt_tiny", "/tmp/aot", ["--x"],
                                 ["--first"], "127.0.0.1")
    cmd = sup._default_command(h)
    assert cmd[1:3] == ["-m", "paddle_tpu_torch.serving.fleet.replica"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[cmd.index("--aot-cache") + 1] == "/tmp/aot"
    assert cmd[-2:] == ["--x", "--first"]
    assert "FLAGS_autotune=use" in cmd
    sup.config.device = "cpu"
    assert sup._default_command(h)[cmd.index("--device") + 1] == "cpu"


# ---------------------------------------------------------------------------
# the replica process
# ---------------------------------------------------------------------------

def test_replica_crash_path_emits_exit_event(monkeypatch, capsys):
    from paddle_tpu_torch.serving.fleet import replica as replica_mod

    def boom(name, config, device):
        raise RuntimeError("probe exploded")

    monkeypatch.setattr(replica_mod, "build_probe", boom)
    rc = replica_mod.main(["--model", "mlp_tiny", "--replica-id", "rc1",
                           "--device", "cpu"])
    assert rc == 21
    events = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines() if line]
    exits = [e for e in events if e.get("event") == "exit"]
    assert exits and exits[-1]["reason"] == "crash"
    assert "probe exploded" in exits[-1]["error"]
    assert exits[-1]["replica_id"] == "rc1"


def _read_event(proc, kind, timeout):
    """The next ``kind`` JSON event on the replica's stdout (bounded)."""
    got = {}

    def reader():
        for line in proc.stdout:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if obj.get("event") == kind:
                got["event"] = obj
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    return got.get("event")


def test_replica_process_on_the_cpu_ready_serves_and_drains(tmp_path):
    """``python -m paddle_tpu_torch.serving.fleet.replica --device cpu``
    announces ``ready`` with the JAX package's event schema, serves a
    routed request, and drains on SIGTERM with the ``exit`` event and
    exit code 0."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.fleet.replica",
         "--model", "mlp_tiny", "--replica-id", "cpu0", "--device", "cpu",
         "--linger-s", "0.2", "--aot-cache", str(tmp_path / "aot")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=REPO)
    try:
        ready = _read_event(proc, "ready", 60)
        assert ready is not None, "no ready event"
        assert set(ready) == {"event", "replica_id", "model", "port",
                              "warm_up_s", "buckets", "aot_cache",
                              "autotune", "time_to_ready_s"}
        assert set(ready["aot_cache"]) == {"hits", "misses", "saves",
                                           "errors"}
        assert ready["aot_cache"]["saves"] >= 1
        router = FleetRouter([Replica("cpu0", "127.0.0.1",
                                      ready["port"])])
        router.poll_now()
        rng = np.random.RandomState(0)
        outs = router.submit({"img": rng.rand(1, 784).astype(np.float32),
                              "label": np.zeros((1, 1), np.int64)})
        assert outs[0].shape == (1, 10)
        proc.send_signal(signal.SIGTERM)
        ex = _read_event(proc, "exit", 30)
        assert proc.wait(30) == 0
        assert ex is not None and ex["reason"] == "drain"
        assert ex["accounting"]["exact"]
        assert ex["accounting"]["completed"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


# ---------------------------------------------------------------------------
# coverage of the JAX package's fleet tests
# ---------------------------------------------------------------------------

_F, _S, _B = "test_torch_fleet.py", "test_torch_serving_batch.py", \
    "test_torch_fleet_telemetry.py"
_A, _C = "test_torch_autoscaler.py", "test_torch_aot_cache.py"
_NO_TOOL = ("tools/fleet_top.py is not ported: its port waits with "
            "tools/load_check.py --fleet (ROADMAP Queue A)")

# JAX test (file::name) -> port test (file::name) or "why: ..."
COUNTERPARTS = {
    # tests/test_fleet.py
    "test_fleet.py::test_wire_array_roundtrip_bit_exact":
        f"{_F}::test_wire_arrays_encode_to_identical_bytes",
    "test_fleet.py::test_wire_status_distinct_per_typed_outcome":
        f"{_F}::test_wire_status_per_typed_outcome_equals_jax",
    "test_fleet.py::test_wire_error_body_roundtrips_typed_exceptions":
        f"{_F}::test_wire_error_bodies_identical_and_cross_decoded",
    "test_fleet.py::test_wire_refuses_newer_schema_and_malformed_bodies":
        f"{_F}::test_wire_refuses_newer_schema_and_malformed_bodies",
    "test_fleet.py::test_wire_slo_class_resolution":
        f"{_F}::test_wire_priority_and_tenant_resolution_equal_jax",
    "test_fleet.py::test_wire_admitted_flag_overrides_status_"
    "classification":
        f"{_F}::test_wire_admitted_flag_overrides_status_classification",
    "test_fleet.py::test_span_context_wire_roundtrip":
        f"{_F}::test_span_context_wire_crosses_packages",
    "test_fleet.py::test_health_schema_frozen":
        f"{_F}::test_health_schema_equals_jax_frozen_one",
    "test_fleet.py::test_health_schema_same_for_generative_engine":
        f"{_F}::test_health_schema_same_before_start_and_after_stop",
    "test_fleet.py::test_submit_trace_parent_joins_caller_trace":
        f"{_F}::test_submit_trace_parent_joins_caller_trace",
    "test_fleet.py::test_frontend_submit_roundtrip_bit_exact":
        f"{_F}::test_frontend_submit_roundtrip_bit_exact",
    "test_fleet.py::test_frontend_validation_is_400_not_an_outcome":
        f"{_F}::test_frontend_validation_is_400_not_an_outcome",
    "test_fleet.py::test_frontend_stopped_engine_maps_to_410":
        f"{_F}::test_frontend_stopped_engine_maps_to_410",
    "test_fleet.py::test_frontend_unknown_route_404":
        f"{_F}::test_frontend_unknown_route_404",
    "test_fleet.py::test_frontend_healthz_readyz":
        f"{_F}::test_frontend_healthz_readyz",
    "test_fleet.py::test_frontend_trace_header_propagates":
        f"{_F}::test_frontend_trace_header_propagates",
    "test_fleet.py::test_router_submit_completes_with_exact_accounting":
        f"{_F}::test_router_submit_completes_with_exact_accounting",
    "test_fleet.py::test_router_honors_drain":
        f"{_F}::test_router_honors_drain",
    "test_fleet.py::test_router_all_draining_is_typed_overloaded_not_a_"
    "hang":
        f"{_F}::test_router_all_draining_is_typed_overloaded_not_a_hang",
    "test_fleet.py::test_router_dead_replica_between_poll_and_dispatch_"
    "retries":
        f"{_F}::test_router_dead_replica_between_poll_and_dispatch_"
        "retries",
    "test_fleet.py::test_router_retry_is_exactly_once_then_typed":
        f"{_F}::test_router_retry_is_exactly_once_then_typed",
    "test_fleet.py::test_router_load_aware_pick_prefers_lower_pressure":
        f"{_F}::test_router_pick_sequence_equals_jax",
    "test_fleet.py::test_router_negative_control_ignores_drain":
        f"{_F}::test_router_negative_control_ignores_drain",
    "test_fleet.py::test_router_never_retries_an_admitted_410":
        f"{_F}::test_router_retries_and_refusals_equal_jax",
    "test_fleet.py::test_router_retries_unadmitted_410_on_a_sibling":
        f"{_F}::test_router_retries_and_refusals_equal_jax",
    "test_fleet.py::test_router_poll_tolerates_future_health_schema":
        f"{_F}::test_router_poll_tolerates_future_health_schema",
    "test_fleet.py::test_router_generate_requires_generative_capability":
        f"{_F}::test_router_generate_requires_generative_capability",
    "test_fleet.py::test_router_generate_streams_exact_token_count":
        f"{_F}::test_router_generate_streams_the_engines_tokens",
    "test_fleet.py::test_router_generate_mid_drain_partials_then_typed":
        f"{_F}::test_router_generate_mid_drain_partials_then_typed",
    "test_fleet.py::test_aot_cache_roundtrip_fresh_executor_bit_exact":
        f"{_C}::test_warm_executor_runs_bit_identical_to_cold",
    "test_fleet.py::test_aot_cache_serves_run_chained":
        f"{_C}::test_warm_executor_runs_bit_identical_to_cold",
    "test_fleet.py::test_aot_cache_key_changes_with_config_and_shape":
        f"{_C}::test_key_changes_with_config_and_shape",
    "test_fleet.py::test_aot_cache_corrupt_and_stale_entries_degrade":
        f"{_C}::test_corrupt_and_stale_entries_degrade_and_are_counted",
    "test_fleet.py::test_aot_cache_off_by_default":
        f"{_C}::test_off_by_default",
    # tests/test_fleet_chaos.py
    "test_fleet_chaos.py::test_wire_sites_registered_and_data_actions_"
    "validated": f"{_F}::test_wire_fault_sites_and_actions_equal_jax",
    "test_fleet_chaos.py::test_wire_probability_rules_seeded_"
    "deterministic": f"{_F}::test_wire_fault_sites_and_actions_equal_jax",
    "test_fleet_chaos.py::test_wire_fired_audit_trail_records_hits":
        f"{_F}::test_wire_fault_sites_and_actions_equal_jax",
    "test_fleet_chaos.py::test_fault_action_still_raises_exception_"
    "actions": f"{_F}::test_wire_fault_sites_and_actions_equal_jax",
    "test_fleet_chaos.py::test_stall_duration_flag":
        f"{_F}::test_wire_fault_sites_and_actions_equal_jax",
    "test_fleet_chaos.py::test_poison_isolated_innocents_bit_exact":
        f"{_S}::test_poison_isolated_innocents_match_same_bucket_"
        "baselines",
    "test_fleet_chaos.py::test_quarantine_sheds_repeat_offender_typed":
        f"{_S}::test_quarantine_sheds_repeat_offender_typed",
    "test_fleet_chaos.py::test_quarantine_is_bounded":
        f"{_S}::test_quarantine_is_bounded",
    "test_fleet_chaos.py::test_transient_batch_fault_absorbed_by_"
    "bisection": f"{_S}::test_transient_batch_fault_absorbed_by_bisection",
    "test_fleet_chaos.py::test_bisected_poisons_do_not_open_the_bucket_"
    "breaker": f"{_S}::test_bisected_poisons_do_not_open_the_bucket_"
               "breaker",
    "test_fleet_chaos.py::test_broken_bucket_never_quarantines_"
    "innocents": f"{_S}::test_broken_bucket_never_quarantines_innocents",
    "test_fleet_chaos.py::test_bisect_off_keeps_whole_batch_failure":
        f"{_S}::test_bisect_off_keeps_whole_batch_failure",
    "test_fleet_chaos.py::test_bisect_safety_classification":
        f"{_S}::test_bisect_safety_classification",
    "test_fleet_chaos.py::test_unsafe_error_fails_whole_batch_despite_"
    "bisection": f"{_S}::test_unsafe_error_fails_whole_batch_despite_"
                 "bisection",
    "test_fleet_chaos.py::test_expired_member_settles_deadline_not_"
    "redispatch": f"{_S}::test_expired_member_settles_deadline_not_"
                  "redispatch",
    "test_fleet_chaos.py::test_poison_request_wire_roundtrip":
        f"{_F}::test_wire_error_bodies_identical_and_cross_decoded",
    "test_fleet_chaos.py::test_router_breaker_ejects_dead_replica_after_"
    "threshold": f"{_F}::test_router_breaker_ejects_dead_replica_after_"
                 "threshold",
    "test_fleet_chaos.py::test_router_breaker_probe_rides_healthz_poll":
        f"{_F}::test_router_breaker_probe_rides_healthz_poll",
    "test_fleet_chaos.py::test_router_corrupt_200_is_typed_replica_lost":
        f"{_F}::test_router_corrupt_200_is_typed_replica_lost",
    "test_fleet_chaos.py::test_router_corrupt_retryable_status_never_"
    "redispatches": f"{_F}::test_router_corrupt_retryable_status_never_"
                    "redispatches",
    "test_fleet_chaos.py::test_router_wire_connect_drop_retried_on_"
    "sibling": f"{_F}::test_router_wire_connect_drop_retried_on_sibling",
    "test_fleet_chaos.py::test_router_stop_bounded_with_hung_healthz_"
    "poll": f"{_F}::test_router_stop_bounded_with_hung_healthz_poll",
    "test_fleet_chaos.py::test_router_membership_add_remove_reassign":
        f"{_F}::test_router_membership_add_remove_reassign",
    "test_fleet_chaos.py::test_stream_corruption_and_drop_surface_typed_"
    "after_partials": f"{_F}::test_stream_corruption_and_drop_surface_"
                      "typed_after_partials",
    "test_fleet_chaos.py::test_supervisor_registers_ready_replica_with_"
    "router": f"{_F}::test_supervisor_registers_ready_replica_with_router",
    "test_fleet_chaos.py::test_supervisor_graceful_drain_never_restarts":
        f"{_F}::test_supervisor_graceful_drain_never_restarts",
    "test_fleet_chaos.py::test_supervisor_restarts_crashed_replica_with_"
    "backoff": f"{_F}::test_supervisor_restarts_crashed_replica_with_"
               "backoff",
    "test_fleet_chaos.py::test_supervisor_crash_loop_retires_typed":
        f"{_F}::test_supervisor_crash_loop_retires_typed",
    "test_fleet_chaos.py::test_supervisor_negative_control_spawn_once":
        f"{_F}::test_supervisor_negative_control_spawn_once",
    "test_fleet_chaos.py::test_supervisor_kill_classification":
        f"{_F}::test_supervisor_kill_classification",
    "test_fleet_chaos.py::test_replica_crash_path_emits_exit_event":
        f"{_F}::test_replica_crash_path_emits_exit_event",
    # tests/test_autoscaler.py
    **{f"test_autoscaler.py::{n}": f"{_A}::test_decisions_equal_jax"
       for n in (
           "test_scale_out_needs_sustained_pressure_not_one_bad_tick",
           "test_pressure_blip_resets_the_sustain_clock",
           "test_oscillating_signal_never_scales",
           "test_slo_burn_is_a_scale_out_signal",
           "test_degraded_and_open_buckets_are_pressure",
           "test_refuse_at_max_replicas_typed_and_metered",
           "test_refuse_spawn_budget_spent_while_spawn_in_flight",
           "test_refuse_cooldown_after_scale_out",
           "test_refuse_at_min_replicas_on_calm_floor",
           "test_scale_in_drains_the_lifo_autoscaler_spawn",
           "test_drain_in_flight_refuses_concurrent_scale_out")},
    "test_autoscaler.py::test_audit_coalesces_repeated_refusals":
        f"{_A}::test_audit_coalesces_repeated_refusals",
    "test_autoscaler.py::test_status_carries_sense_and_last_decision":
        f"{_A}::test_status_carries_sense_and_last_decision",
    "test_autoscaler.py::test_config_validation_is_typed":
        f"{_A}::test_config_validation_is_typed",
    "test_autoscaler.py::test_config_resolves_from_flags":
        f"{_A}::test_config_resolves_from_flags",
    "test_autoscaler.py::test_worst_state_merge_order":
        f"{_A}::test_worst_state_merge_order",
    "test_autoscaler.py::test_fleet_top_renders_autoscaler_and_tenant_"
    "table": f"why: {_NO_TOOL}",
    "test_autoscaler.py::test_scale_in_mid_burst_drains_clean_and_"
    "refuses_concurrent_scale_out":
        f"{_A}::test_scale_in_mid_burst_drains_clean_and_refuses_"
        "concurrent_scale_out",
    # tests/test_telemetry.py
    "test_telemetry.py::test_metrics_route_serves_prometheus_text":
        f"{_B}::test_metrics_route_serves_prometheus_text",
    "test_telemetry.py::test_metrics_json_route_schema_frozen":
        f"{_B}::test_metrics_json_equals_jax",
    "test_telemetry.py::test_metrics_probe_route_immune_to_wire_faults":
        f"{_F}::test_frontend_metrics_probe_routes_immune_to_wire_faults",
    "test_telemetry.py::test_fleet_request_seconds_labeled_by_route":
        f"{_B}::test_fleet_request_seconds_labeled_by_route",
    "test_telemetry.py::test_prom_text_roundtrips_hostile_label_values":
        "test_torch_monitor.py::test_registry_values_and_prometheus_text_"
        "match",
    "test_telemetry.py::test_prom_text_type_lines_for_labeled_gauges":
        "test_torch_monitor.py::test_registry_values_and_prometheus_text_"
        "match",
    "test_telemetry.py::test_prom_histogram_roundtrips_through_scrape_"
    "parser": f"{_B}::test_aggregator_scrapes_live_frontend_both_modes",
    "test_telemetry.py::test_prom_parser_refuses_garbage":
        f"{_B}::test_prom_parser_refuses_garbage",
    "test_telemetry.py::test_histogram_merge_equals_union_stream":
        f"{_B}::test_histogram_merge_and_quantile_equal_jax",
    "test_telemetry.py::test_histogram_merge_refuses_mismatched_buckets":
        f"{_B}::test_histogram_merge_refuses_mismatched_buckets",
    "test_telemetry.py::test_slo_tracker_multiwindow_state_machine":
        f"{_S}::test_slo_tracker_multiwindow_state_machine",
    "test_telemetry.py::test_slo_state_rides_health_payload":
        f"{_S}::test_slo_state_rides_health_payload",
    "test_telemetry.py::test_wire_tenant_field_validation":
        f"{_F}::test_wire_priority_and_tenant_resolution_equal_jax",
    "test_telemetry.py::test_tenant_ledger_sums_exactly_to_accounting":
        f"{_B}::test_tenant_ledger_sums_exactly_to_accounting",
    "test_telemetry.py::test_exemplars_recorded_when_plane_enabled":
        f"{_B}::test_exemplars_recorded_when_plane_enabled",
    "test_telemetry.py::test_exemplars_disabled_path_never_allocates":
        f"{_B}::test_exemplars_disabled_path_never_allocates",
    "test_telemetry.py::test_aggregator_disabled_start_is_noop":
        f"{_B}::test_aggregator_disabled_start_is_noop",
    "test_telemetry.py::test_aggregator_scrapes_live_frontend_both_modes":
        f"{_B}::test_aggregator_scrapes_live_frontend_both_modes",
    "test_telemetry.py::test_aggregator_typed_connect_failure_degrades_"
    "stale": f"{_B}::test_aggregator_snapshots_equal_jax",
    "test_telemetry.py::test_aggregator_corrupt_body_keeps_last_good_"
    "snapshot": f"{_B}::test_aggregator_snapshots_equal_jax",
    "test_telemetry.py::test_aggregator_refuses_newer_schema_as_corrupt":
        f"{_B}::test_aggregator_snapshots_equal_jax",
    "test_telemetry.py::test_aggregator_counter_reset_clamps_rate":
        f"{_B}::test_aggregator_snapshots_equal_jax",
    "test_telemetry.py::test_aggregator_fleet_rollup_sums_and_worst_slo":
        f"{_B}::test_aggregator_snapshots_equal_jax",
    # tests/test_tenant_fairshare.py
    "test_tenant_fairshare.py::test_parse_tenant_weights":
        f"{_S}::test_parse_tenant_weights_and_config_validation",
    "test_tenant_fairshare.py::test_weights_validated_at_config_resolve_"
    "not_mid_admission":
        f"{_S}::test_parse_tenant_weights_and_config_validation",
    "test_tenant_fairshare.py::test_config_resolves_from_flags":
        f"{_S}::test_parse_tenant_weights_and_config_validation",
    "test_tenant_fairshare.py::test_hot_tenant_shed_typed_tenant_quota_"
    "while_others_admit": f"{_S}::test_tenant_quota_sheds_the_hot_"
                          "tenant_only",
    "test_tenant_fairshare.py::test_weighted_tenant_gets_a_larger_quota":
        f"{_S}::test_tenant_quota_sheds_the_hot_tenant_only",
    "test_tenant_fairshare.py::test_fair_share_off_is_the_pre_tenant_"
    "engine": f"{_S}::test_fair_share_off_keeps_the_fifo_engine",
    "test_tenant_fairshare.py::test_tenant_quota_reason_travels_the_wire":
        f"{_F}::test_wire_error_bodies_identical_and_cross_decoded",
    "test_tenant_fairshare.py::test_dispatch_interleaves_tenants_instead_"
    "of_fifo": f"{_S}::test_stride_scheduling_dispatch_order",
    "test_tenant_fairshare.py::test_weights_bias_the_dispatch_share":
        f"{_S}::test_stride_scheduling_dispatch_order",
    "test_tenant_fairshare.py::test_fair_share_does_not_break_exact_"
    "accounting_or_coalescing":
        f"{_S}::test_clean_traffic_has_a_clean_ledger",
}

JAX_FILES = ("test_fleet.py", "test_fleet_chaos.py", "test_autoscaler.py",
             "test_telemetry.py", "test_tenant_fairshare.py")


def _test_names(path):
    tree = ast.parse(open(path).read())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


def test_every_jax_fleet_test_has_a_counterpart_or_a_reason():
    here = os.path.dirname(os.path.abspath(__file__))
    want = {f"{f}::{n}" for f in JAX_FILES
            for n in _test_names(os.path.join(here, f))}
    assert want == set(COUNTERPARTS), (sorted(want - set(COUNTERPARTS)),
                                       sorted(set(COUNTERPARTS) - want))
    for jax_test, port in COUNTERPARTS.items():
        if port.startswith("why: "):
            continue
        f, name = port.split("::")
        assert name in _test_names(os.path.join(here, f)), (jax_test, port)
