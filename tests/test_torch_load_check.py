"""The port's serving/fleet load gate (``tools/torch_load_check.py``) and
fleet viewer (``tools/torch_fleet_top.py``) on the CPU (``--device
cpu``): the ``--ci`` serving and generative legs pass and their negative
control fails, one multi-process fleet leg passes and its negative
control fails, the lock-witness gate flags an edge the static graph does
not predict, and the viewer renders the same text as
``tools/fleet_top.py`` for one snapshot and autoscaler status of each
package. The legs' own checks are the gate; the tests read the verdict
and the artifact."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.serving import fleet as jfleet

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor
from paddle_tpu_torch.serving import fleet as tfleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_load_check.py")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LC = _load("torch_load_check")


@pytest.fixture(autouse=True)
def _restore_flags_and_device():
    from paddle_tpu_torch import flags

    snap = dict(flags._overrides)
    yield
    flags._overrides.clear()
    flags._overrides.update(snap)
    flags._set_epoch += 1
    LC.set_device("cuda")


@pytest.fixture(scope="module")
def serving_runs(tmp_path_factory):
    """The serving gate and its negative control, as two processes run
    at once: {name: (returncode, stdout, stderr, report)}."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FLAGS_fault")}
    runs = {"gate": ["--decode", "--lock-witness"],
            "negative": ["--decode", "--negative-control"]}
    procs = {}
    for name, args in runs.items():
        out = tmp_path_factory.mktemp(name) / "report.json"
        procs[name] = (out, subprocess.Popen(
            [sys.executable, TOOL, "--ci", "--device", "cpu", "--json",
             str(out)] + args, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    done = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        rep = json.loads(out.read_text()) if out.exists() else None
        done[name] = (proc.returncode, stdout, stderr, rep)
    return done


def test_serving_and_decode_legs_pass_under_the_lock_witness(serving_runs):
    rc, stdout, stderr, rep = serving_runs["gate"]
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    assert "serving gate" in stdout and "-> ok" in stdout
    legs = {l["name"]: l for l in rep["legs"]}
    assert set(legs) == {"steady_resnet", "steady_bert", "chaos_resnet",
                         "decode_gpt", "decode_gpt_chaos",
                         "decode_gpt_prefix", "decode_gpt_spec"}
    assert all(l["ok"] for l in legs.values())
    chaos = legs["chaos_resnet"]
    assert chaos["engine_accounting"]["shed"] > 0
    assert chaos["watchdog_timeouts"] >= 1 and chaos["compile_retries"] >= 2
    assert rep["device"] == "cpu"
    assert rep["latency_histogram"]["count"] > 0
    w = rep["lock_witness"]
    assert w["ok"] and w["enabled"] and w["runtime_cycles"] == []
    assert w["edges_not_in_static_graph"] == []
    assert {"ServingEngine._lock", "Executor._lock",
            "_CompiledStep._aot_lock"} <= set(w["locks"])
    # the compile faults were retried under the per-step lock: an edge
    # the static graph predicts through call_with_retry's callable
    assert ["_CompiledStep._aot_lock", "FaultPlan._lock"] in \
        w["runtime_edges"]


def test_serving_negative_control_fails(serving_runs):
    rc, stdout, stderr, rep = serving_runs["negative"]
    assert rc == 1, stderr[-3000:]
    assert "-> FAIL" in stdout
    legs = {l["name"]: l for l in rep["legs"]}
    assert not legs["chaos_resnet_no_shedding"]["checks"][
        "overload_was_shed"]
    assert not legs["decode_gpt_prefix_off"]["ok"]
    assert not legs["decode_gpt_spec_off"]["checks"][
        "acceptance_histogram_present"]
    assert rep["check"] == {"status": "fail", "negative_control": True}


@pytest.mark.parametrize("negative", [False, True])
def test_fleet_kill_leg_over_replica_processes(tmp_path, negative):
    """Two replica processes on the CPU behind the router, one SIGTERMed
    mid-burst: the leg passes, and with drain honoring and the
    unadmitted retry off (the negative control) it fails."""
    LC.set_device("cpu")
    monitor.reset()
    if negative:
        leg = LC.leg_fleet_negative("fleet_no_drain_honor", True,
                                    str(tmp_path))
        assert not leg["ok"]
        assert not leg["checks"]["nothing_admitted_lost"]
        assert leg["checks"]["exact_fleet_accounting"]
        return
    leg = LC.leg_fleet("fleet_kill_one_replica", True, str(tmp_path))
    assert leg["ok"], {k: v for k, v in leg["checks"].items() if not v}
    ws = leg["warmstart"]
    assert ws["warm"]["aot_cache"]["hits"] >= 1
    assert ws["cold"]["aot_cache"]["saves"] >= 1
    assert leg["victim_accounting"]["exact"]


def test_replica_env_strips_fault_plans_and_pins_the_device(monkeypatch):
    monkeypatch.setenv("FLAGS_fault_plan", "compile:1:RuntimeError")
    monkeypatch.setenv("FLAGS_step_timeout_s", "2")
    monkeypatch.setenv("FLAGS_aot_cache_dir", "/elsewhere")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    LC.set_device("cpu")
    env = LC._replica_env()
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert not {"FLAGS_fault_plan", "FLAGS_step_timeout_s",
                "FLAGS_aot_cache_dir"} & set(env)
    LC.set_device("cuda")
    assert "CUDA_VISIBLE_DEVICES" not in LC._replica_env()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert LC._replica_env()["CUDA_VISIBLE_DEVICES"] == "0"
    with pytest.raises(ValueError):
        LC.set_device("tpu")


def test_witness_gate_flags_an_unpredicted_edge_and_a_cycle():
    """The gate's own negative control: framework-named locks taken in
    an order the static graph does not hold, then the reverse order."""
    from paddle_tpu_torch.analysis.concurrency import analyze_package

    static = analyze_package()
    fluid.set_flags({"FLAGS_lock_witness": 1})
    monitor.reset_witness()
    try:
        supervisor = monitor.make_lock("ReplicaSupervisor._lock")
        engine = monitor.make_lock("ServingEngine._lock")
        with supervisor:
            with engine:
                pass
        section, ok = LC._witness_gate(static)
        assert not ok
        assert section["edges_not_in_static_graph"] == [
            ["ReplicaSupervisor._lock", "ServingEngine._lock"]]
        with engine:
            with supervisor:
                pass
        section, ok = LC._witness_gate(static)
        assert not ok and section["runtime_cycles"]
    finally:
        monitor.reset_witness()
        fluid.set_flags({"FLAGS_lock_witness": 0})
    section, ok = LC._witness_gate(static)
    assert not ok and section["enabled"] is False


_SNAPSHOT = {
    "replicas": {
        "r0": {"up": True, "stale": False, "scrape_age_s": 0.1,
               "queue_depth": 2, "latency": {"p50": 0.01, "p99": 0.02},
               "slo": {"state": "ok",
                       "classes": {"interactive": {"state": "burning"},
                                   "batch": {"state": "ok"}}},
               "rates": {"serving_requests_total":
                         {"outcome=completed": 12.5}},
               "error": None},
        "rbad": {"up": False, "stale": True, "scrape_age_s": 4.0,
                 "queue_depth": None, "latency": None, "slo": None,
                 "rates": {}, "error": "corrupt"}},
    "fleet": {"p50": 0.01, "p99": 0.02, "slo_state": "burning",
              "outcomes": {"completed": 10},
              "tenants": {"acme": {"outcomes": {"completed": 7, "shed": 3},
                                   "quota_sheds": 3, "occupancy_s": 1.5},
                          "globex": {"outcomes": {"completed": 2},
                                     "quota_sheds": 0,
                                     "occupancy_s": 0.25}}},
}


class _Sup:
    def __init__(self):
        self.states = {"r0": "ready"}

    def status(self):
        return {rid: {"state": s} for rid, s in self.states.items()}

    def add_replica(self, replica_id, **kw):
        self.states[replica_id] = "spawning"

    def drain(self, replica_id):
        pass


class _Sensor:
    replica_id = "r0"

    def snapshot(self):
        return {"ok": True, "ready": True, "queue_depth": 9,
                "degraded": False, "open_buckets": 0, "slo_state": "ok"}


class _Router:
    replicas = [_Sensor()]


def _autoscaler_status(fleet_mod):
    clk = [0.0]
    auto = fleet_mod.FleetAutoscaler(
        _Sup(), router=_Router(),
        config=fleet_mod.AutoscalerConfig(
            min_replicas=1, max_replicas=3, interval_s=0.01,
            cooldown_s=10.0, hot_sustain_s=2.0, calm_sustain_s=5.0,
            max_inflight_spawns=1, queue_high=4),
        _now=lambda: clk[0])
    for t in (0.0, 1.0, 2.5):
        clk[0] = t
        auto.tick()
    return auto.status()


def test_fleet_top_renders_the_jax_tools_text():
    jtop, ttop = _load("fleet_top"), _load("torch_fleet_top")
    jstat, tstat = _autoscaler_status(jfleet), _autoscaler_status(tfleet)
    assert tstat["last_decision"]["action"] == "scale_out"
    text = ttop.render(_SNAPSHOT, "12:00:00", autoscaler=tstat)
    assert text == jtop.render(_SNAPSHOT, "12:00:00", autoscaler=jstat)
    assert "interactive=burning" in text
    assert "autoscaler: replicas" in text and "scale_out" in text
    assert "QUOTA_SHED" in text and "acme" in text
    assert "corrupt" in text
    assert ttop.render(_SNAPSHOT, "t") == jtop.render(_SNAPSHOT, "t")
    assert ttop.parse_targets(["r0=127.0.0.1:1"]) == [("r0", "127.0.0.1:1")]


def test_fleet_top_over_a_live_port_replica():
    """The viewer's path end to end: a port engine behind its front-end
    on the CPU, scraped by the port's aggregator, rendered by both
    viewers to the same text."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    jtop, ttop = _load("fleet_top"), _load("torch_fleet_top")
    fluid.set_flags({"FLAGS_fleet_telemetry": 1})
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[13], dtype="float32")
        pred = fluid.layers.fc(x, 4, act="softmax")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    eng = ServingEngine(main.clone(for_test=True), feed_names=["x"],
                        fetch_list=[pred.name], scope=scope, executor=exe,
                        config=ServingConfig(max_batch=4))
    eng.warm_up()
    eng.start()
    fe = tfleet.ServingFrontend(eng, replica_id="v0")
    fe.start()
    try:
        for i in range(3):
            eng.submit({"x": np.full((1, 13), i, np.float32)}).result(60)
        agg = tfleet.FleetAggregator(
            ttop.parse_targets([f"v0=127.0.0.1:{fe.port}"]),
            tfleet.AggregatorConfig(scrape_interval_s=60.0,
                                    scrape_timeout_s=10.0))
        agg.poll_now()
        snap = agg.snapshot()
    finally:
        fe.stop(wait_inflight_s=2.0)
        eng.stop(drain=True)
    assert snap["replicas"]["v0"]["up"]
    text = ttop.render(snap, "12:00:00")
    assert text == jtop.render(snap, "12:00:00")
    assert text.splitlines()[0] == \
        "fleet view @ 12:00:00 — 1 replicas, 1 up"
    assert "completed 3" in text


AUTOSCALER_EDGES = {("FleetAutoscaler._tick_lock", "ReplicaSupervisor._lock"),
                    ("FleetAutoscaler._tick_lock", "Replica._lock")}


class _Report:
    """A static report with some edges taken out (the gate's control)."""

    def __init__(self, rep, drop):
        self.locks = rep.locks
        self._edges = rep.edge_set() - set(drop)

    def edge_set(self):
        return set(self._edges)


def test_witness_gate_over_a_live_autoscaler_and_supervisor(tmp_path):
    """The autoscaler's tick into a ReplicaSupervisor and its router under
    the lock witness (the probe the load check runs before its witness
    gate): both edges into the supervisor's and the router replica's
    locks are taken, the static graph predicts them, the gate passes; with
    either edge taken out of the static set it fails naming the edge."""
    from paddle_tpu_torch.analysis.concurrency import analyze_package

    static = analyze_package()
    assert AUTOSCALER_EDGES <= static.edge_set()
    LC.set_device("cpu")
    fluid.set_flags({"FLAGS_lock_witness": 1})
    monitor.reset_witness()
    try:
        assert LC._autoscaler_witness_probe(str(tmp_path)) == ["hold",
                                                              "hold"]
        assert AUTOSCALER_EDGES <= monitor.witness_edges()
        section, ok = LC._witness_gate(static)
        assert ok and section["edges_not_in_static_graph"] == []
        for edge in sorted(AUTOSCALER_EDGES):
            section, ok = LC._witness_gate(_Report(static, [edge]))
            assert not ok
            assert section["edges_not_in_static_graph"] == [list(edge)]
    finally:
        monitor.reset_witness()
        fluid.set_flags({"FLAGS_lock_witness": 0})
