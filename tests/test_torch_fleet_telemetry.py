"""The port's fleet telemetry plane against the JAX package's, on the CPU:
histogram snapshots, their exact merge and ``snapshot_quantile`` (equal
dicts and values, mismatched bucket layouts refused in both), the
schema-versioned ``/metrics.json`` document (``metrics_json`` of the same
observations equal in both packages), trace exemplars and their
disabled path, and the ``FleetAggregator`` (the same scraped bodies,
under the same injected clock, give the same snapshot in both packages;
scrape failures degrade typed). Host code: every comparison is exact."""
import json
import socket
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from paddle_tpu import monitor as jmonitor
from paddle_tpu.monitor.registry import MetricsRegistry as JRegistry
from paddle_tpu.serving.fleet import telemetry as jtel

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.monitor.registry import MetricsRegistry as TRegistry
from paddle_tpu_torch.serving.engine import DEFAULT_TENANT
from paddle_tpu_torch.serving.fleet import (AggregatorConfig,
                                            FleetAggregator, telemetry)

from test_torch_fleet import feed, get, make_engine, post, serve, close
from paddle_tpu_torch.serving.fleet import wire


@pytest.fixture(autouse=True)
def _flags_reset():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    snaps = [(m, dict(m._overrides)) for m in (jflags, tflags)]
    yield
    for m, snap in snaps:
        m._overrides.clear()
        m._overrides.update(snap)
        m._set_epoch += 1


@pytest.fixture()
def frontend():
    eng, fe = serve()
    yield fe
    close(eng, fe)


def _stub_server(holder):
    """Answers every GET with ``holder['body']`` / ``holder['status']``
    (the aggregator's hostile-peer stand-in)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = holder["body"]
            self.send_response(holder.get("status", 200))
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


# ---------------------------------------------------------------------------
# histogram snapshots, merge, quantile
# ---------------------------------------------------------------------------

BUCKETS = (0.25, 0.5, 1.0, 2.0)


def _streams(seed=7):
    rng = np.random.RandomState(seed)
    return ([int(x) / 64.0 for x in rng.randint(1, 160, size=57)],
            [int(x) / 64.0 for x in rng.randint(1, 160, size=43)])


def _snaps(Registry, streams, buckets=BUCKETS):
    reg = Registry()
    out = []
    for i, s in enumerate(streams):
        h = reg.histogram(f"h{i}", "", buckets=buckets)
        for v in s:
            h.observe(v)
        out.append(reg.get(f"h{i}")._children[()].snapshot())
    return out


def test_histogram_merge_and_quantile_equal_jax():
    a, b = _streams()
    tsnaps = _snaps(TRegistry, [a, b, a + b])
    jsnaps = _snaps(JRegistry, [a, b, a + b])
    assert tsnaps == jsnaps
    tm = tmonitor.merge_histogram_snapshots(tsnaps[:2])
    assert tm == jmonitor.merge_histogram_snapshots(jsnaps[:2])
    union = tsnaps[2]
    for k in ("count", "buckets", "min", "max"):
        assert tm[k] == union[k], k
    assert tm["sum"] == pytest.approx(union["sum"])
    assert tm["p50"] == pytest.approx(union["p50"])
    assert tm["p99"] == pytest.approx(union["p99"])
    qs = (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)
    for snap in tsnaps + [tm]:
        assert [tmonitor.snapshot_quantile(snap, q) for q in qs] \
            == [jmonitor.snapshot_quantile(snap, q) for q in qs]
    assert tmonitor.snapshot_quantile({"count": 0, "buckets": {}},
                                      0.5) is None
    for bad_q in (0.0, 1.5):
        with pytest.raises(ValueError):
            tmonitor.snapshot_quantile(tm, bad_q)
    with pytest.raises(ValueError):
        tmonitor.merge_histogram_snapshots([])


def test_histogram_merge_refuses_mismatched_buckets():
    t1, = _snaps(TRegistry, [[0.3]], (0.5, 1.0))
    t2, = _snaps(TRegistry, [[0.3]], (0.25, 1.0))
    with pytest.raises(ValueError, match="mismatch"):
        tmonitor.merge_histogram_snapshots([t1, t2])
    j1, = _snaps(JRegistry, [[0.3]], (0.5, 1.0))
    j2, = _snaps(JRegistry, [[0.3]], (0.25, 1.0))
    with pytest.raises(ValueError, match="mismatch"):
        jmonitor.merge_histogram_snapshots([j1, j2])


# ---------------------------------------------------------------------------
# the JSON metrics document
# ---------------------------------------------------------------------------

def _fill(reg):
    c = reg.counter("serving_requests_total", "outcomes")
    c.labels(outcome="completed").inc(5)
    c.labels(outcome="shed").inc(2)
    reg.gauge("serving_queue_depth", "depth").set(3)
    h = reg.histogram("serving_request_latency_seconds", "latency")
    for i, v in enumerate((0.003, 0.02, 0.2, 0.02, 4.0)):
        h.observe(v, exemplar=f"trace{i}" if i % 2 == 0 else None)
    reg.histogram("fleet_request_seconds", "by route").labels(
        route="submit").observe(0.01)


def test_metrics_json_equals_jax():
    treg, jreg = TRegistry(), JRegistry()
    _fill(treg)
    _fill(jreg)
    slo = {"state": "warning", "classes": {}}
    tenants = {"acme": {"outcomes": {"completed": 5}, "occupancy_s": 0.5}}
    tdoc = telemetry.metrics_json(registry=treg, replica_id="r1", slo=slo,
                                  tenants=tenants)
    jdoc = jtel.metrics_json(registry=jreg, replica_id="r1", slo=slo,
                             tenants=tenants)
    assert json.dumps(tdoc, sort_keys=True) \
        == json.dumps(jdoc, sort_keys=True)
    assert set(tdoc) == set(telemetry.METRICS_SCHEMA_KEYS) \
        == set(jtel.METRICS_SCHEMA_KEYS)
    assert telemetry.METRICS_SCHEMA_VERSION == jtel.METRICS_SCHEMA_VERSION
    assert "serving_request_latency_seconds" in tdoc["exemplars"]


def test_metrics_json_route_schema_frozen(frontend):
    frontend.engine.submit(feed()).result(timeout=60)
    for path in ("/metrics.json", "/metrics?format=json"):
        status, raw = get(frontend.port, path)
        assert status == 200
        doc = json.loads(raw)
        assert set(doc) == set(jtel.METRICS_SCHEMA_KEYS)
        assert doc["replica_id"] == "t0"
        assert "serving_requests_total" in doc["families"]
        assert doc["slo"]["state"] in ("ok", "warning", "burning")
        assert isinstance(doc["tenants"], dict)


def test_metrics_route_serves_prometheus_text(frontend):
    frontend.engine.submit(feed()).result(timeout=60)
    status, raw = get(frontend.port, "/metrics")
    assert status == 200
    parsed = tmonitor.parse_prometheus_text(raw)
    assert parsed["serving_requests_total"].kind == "counter"
    assert "serving_request_latency_seconds" in parsed


def test_fleet_request_seconds_labeled_by_route(frontend):
    status, _ = post(frontend.port, "/v1/submit",
                     {"feed": wire.encode_feed(feed())})
    assert status == 200
    fam = tmonitor.get_registry().get("fleet_request_seconds")
    assert fam is not None and fam.kind == "histogram"
    label_sets = [labels for labels, _ in fam.children()]
    assert {"route": "submit"} in label_sets
    assert all("route" in labels for labels in label_sets)
    assert tmonitor.metric_value("fleet_request_seconds",
                                 route="submit")["count"] >= 1


def test_prom_parser_refuses_garbage():
    with pytest.raises(tmonitor.PromParseError):
        tmonitor.parse_prometheus_text(b"\x00\xffdefinitely{not metrics")


def test_tenant_ledger_sums_exactly_to_accounting():
    eng = make_engine(batch_window_s=0.005)
    eng.warm_up()
    eng.start()
    try:
        futs = [eng.submit(feed(seed=i), tenant="acme") for i in range(3)]
        futs += [eng.submit(feed(seed=9), tenant="globex")]
        futs += [eng.submit(feed(seed=10))]
        for f in futs:
            f.result(timeout=60)
        ledger = eng.tenant_accounting()
        assert ledger["acme"]["outcomes"]["completed"] == 3
        assert ledger["globex"]["outcomes"]["completed"] == 1
        assert ledger[DEFAULT_TENANT]["outcomes"]["completed"] >= 1
        sums = {}
        for t in ledger.values():
            for o, n in t["outcomes"].items():
                sums[o] = sums.get(o, 0) + n
        assert sums == {"completed": eng.accounting()["completed"]}
    finally:
        eng.stop(drain=False)


# ---------------------------------------------------------------------------
# trace exemplars
# ---------------------------------------------------------------------------

def test_exemplars_recorded_when_plane_enabled():
    tfluid.set_flags({"FLAGS_fleet_telemetry": 1, "FLAGS_trace": 1})
    tmonitor.reset()
    eng = make_engine(batch_window_s=0.005)
    eng.warm_up()
    eng.start()
    try:
        fut = eng.submit(feed())
        fut.result(timeout=60)
        fam = tmonitor.get_registry().get("serving_request_latency_seconds")
        (_, child), = fam.children()
        rings = [e for ring in child.exemplars().values() for e in ring]
        assert any(e["trace_id"] == fut.trace_id for e in rings)
        doc = telemetry.metrics_json(replica_id="x")
        assert "serving_request_latency_seconds" in doc["exemplars"]
        assert "exemplar" not in tmonitor.get_registry().to_prometheus()
    finally:
        eng.stop(drain=False)


def test_exemplars_disabled_path_never_allocates():
    tmonitor.reset()
    eng = make_engine(batch_window_s=0.005)
    eng.warm_up()
    eng.start()
    try:
        eng.submit(feed()).result(timeout=60)
        fam = tmonitor.get_registry().get("serving_request_latency_seconds")
        (_, child), = fam.children()
        assert child._exemplars is None and child.exemplars() == {}
        assert telemetry.metrics_json(replica_id="x")["exemplars"] == {}
    finally:
        eng.stop(drain=False)


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

def test_aggregator_disabled_start_is_noop():
    agg = FleetAggregator([("r0", "127.0.0.1:1")])
    assert agg.start() is agg and agg._thread is None
    agg.stop()


def test_aggregator_scrapes_live_frontend_both_modes(frontend):
    tfluid.set_flags({"FLAGS_fleet_telemetry": 1})
    for _ in range(3):
        frontend.engine.submit(feed()).result(timeout=60)
    for mode in ("json", "prom"):
        agg = FleetAggregator(
            [("t0", f"127.0.0.1:{frontend.port}")],
            AggregatorConfig(scrape_interval_s=60.0, scrape_timeout_s=10.0,
                             mode=mode))
        agg.poll_now()
        snap = agg.snapshot()
        rec = snap["replicas"]["t0"]
        assert rec["up"] and not rec["stale"]
        assert rec["outcomes"]["completed"] >= 3
        assert snap["fleet"]["p50"] is not None
        assert snap["fleet"]["latency"]["count"] >= 3
        assert tmonitor.metric_value("fleet_agg_up", replica="t0") == 1.0
    rec = agg.snapshot()["replicas"]["t0"]
    agg = FleetAggregator([("t0", f"127.0.0.1:{frontend.port}")],
                          AggregatorConfig(scrape_interval_s=60.0,
                                           scrape_timeout_s=10.0))
    agg.poll_now()
    rec = agg.snapshot()["replicas"]["t0"]
    assert rec["slo"]["state"] in ("ok", "warning", "burning")
    assert rec["tenants"] is not None


def _doc(Registry, tel, replica_id, completed, latencies, slo=None):
    reg = Registry()
    reg.counter(tel.OUTCOME_COUNTER, "").labels(
        outcome="completed").inc(completed)
    reg.gauge(tel.QUEUE_DEPTH_GAUGE, "").set(completed % 5)
    h = reg.histogram(tel.REQUEST_LATENCY_METRIC, "lat")
    for v in latencies:
        h.observe(v)
    return json.dumps(tel.metrics_json(
        registry=reg, replica_id=replica_id, slo=slo,
        tenants={"acme": {"outcomes": {"completed": completed},
                          "occupancy_s": completed / 8,
                          "quota_sheds": 1}})).encode("utf-8")


# one list of scripted scrapes per step: (status, body builder) for the
# replicas "a" and "b"; a dead port stands for "gone"
def _script(Registry, tel):
    d = lambda *a, **k: _doc(Registry, tel, *a, **k)  # noqa: E731
    return [
        [(200, d("a", 10, (0.01, 0.02, 0.3))),
         (200, d("b", 4, (0.05,), slo={"state": "ok", "classes": {}}))],
        [(200, d("a", 25, (0.01, 0.02, 0.3, 0.3, 1.5))),
         (200, b"\x00\xffnot a metrics body")],
        [(200, d("a", 3, (0.01,))),
         (200, json.dumps({"schema_version": 99,
                           "families": {}}).encode())],
        [(500, b"{}"),
         (200, d("b", 9, (0.05, 0.07),
                 slo={"state": "burning", "classes": {}}))],
        [(200, d("a", 8, (0.01, 0.4), slo={"state": "warning",
                                           "classes": {}})),
         (200, d("b", 12, (0.05, 0.07, 2.5)))],
    ]


def _run_aggregator(tel_mod, Registry, monkeypatch, dead_port):
    clock = [100.0]
    monkeypatch.setattr(tel_mod, "time",
                        types.SimpleNamespace(monotonic=lambda: clock[0]))
    holders = {"a": {"body": b""}, "b": {"body": b""}}
    servers = {k: _stub_server(h) for k, h in holders.items()}
    try:
        agg = tel_mod.FleetAggregator(
            [("a", f"127.0.0.1:{servers['a'][1]}"),
             ("b", f"127.0.0.1:{servers['b'][1]}"),
             ("gone", f"127.0.0.1:{dead_port}")],
            tel_mod.AggregatorConfig(scrape_interval_s=60.0,
                                     scrape_timeout_s=5.0))
        out = []
        for step in _script(Registry, tel_mod):
            for key, (status, body) in zip(("a", "b"), step):
                holders[key].update(status=status, body=body)
            clock[0] += 2.5
            agg.poll_now()
            clock[0] += 0.5
            out.append(agg.snapshot())
        return out
    finally:
        for srv, _ in servers.values():
            srv.shutdown()
            srv.server_close()


def test_aggregator_snapshots_equal_jax(monkeypatch):
    """Good scrapes, a corrupt body (the last good snapshot survives,
    stale), a newer schema (corrupt), an HTTP 500, a dead replica
    (connect), a counter reset (the rate clamps to the new absolute),
    exact latency merge and the worst SLO state: the same snapshots,
    step by step, in both packages."""
    tfluid.set_flags({"FLAGS_fleet_telemetry": 1})
    import paddle_tpu as jfluid

    jfluid.set_flags({"FLAGS_fleet_telemetry": 1})
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    got = _run_aggregator(telemetry, TRegistry, monkeypatch, dead)
    want = _run_aggregator(jtel, JRegistry, monkeypatch, dead)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    first, second, third, fourth, last = got
    assert second["replicas"]["b"]["error"] == "corrupt"
    assert second["replicas"]["b"]["stale"] is True
    assert second["replicas"]["b"]["latency"]["count"] == 1
    assert third["replicas"]["b"]["consecutive_failures"] == 2
    assert third["replicas"]["a"]["rates"]["serving_requests_total"][
        "outcome=completed"] == 3 / 3.0      # reset: 25 -> 3 clamps to 3
    assert fourth["replicas"]["a"]["error"] == "http_500"
    assert all(r["replicas"]["gone"]["error"] == "connect" for r in got)
    assert last["replicas"]["gone"]["consecutive_failures"] == 5
    fleet = last["fleet"]
    assert fleet["outcomes"]["completed"] == 8 + 12
    assert fleet["latency"]["count"] == 5
    assert fleet["latency"] == tmonitor.merge_histogram_snapshots(
        [last["replicas"]["a"]["latency"], last["replicas"]["b"]["latency"]])
    assert fourth["fleet"]["slo_state"] == "burning"
    assert last["fleet"]["slo_state"] == "warning"
    assert fleet["tenants"]["acme"]["quota_sheds"] == 2
    assert tmonitor.metric_value("fleet_scrape_failures_total", default=0,
                                 replica="gone", kind="connect") >= 5
