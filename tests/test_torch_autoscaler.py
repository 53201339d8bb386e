"""The port's ``FleetAutoscaler`` against the JAX package's, on the CPU:
the same signal traces under an injected clock, against the same fake
sensors and fake actuator, give the same decisions (action, typed reason,
detail, replica) and the same acts in both packages, and each scenario's
own contract holds on the port (the cases of ``tests/test_autoscaler.py``).
The scale-in race runs against two real port engines behind a real port
router. Host code: every comparison is exact."""
import threading
import time

import pytest

from paddle_tpu import monitor as jmonitor
from paddle_tpu.serving.fleet import autoscaler as jauto

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving.fleet import (AutoscalerConfig,
                                            FleetAutoscaler, FleetRouter,
                                            Replica)
from paddle_tpu_torch.serving.fleet import autoscaler as tauto
from paddle_tpu_torch.serving.fleet.autoscaler import _worst

from test_torch_fleet import close, feed, serve


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


class FakeSupervisor:
    """Duck-typed actuator: records every act; scenarios move states."""

    def __init__(self, **states):
        self.states = dict(states)
        self.added = []
        self.drained = []
        self.router = None

    def status(self):
        return {rid: {"state": s} for rid, s in self.states.items()}

    def add_replica(self, replica_id, model="mlp_tiny", aot_dir="",
                    extra_args=()):
        self.added.append(replica_id)
        self.states[replica_id] = "spawning"

    def drain(self, replica_id):
        self.drained.append(replica_id)


class FakeReplicaSensor:
    def __init__(self, replica_id, **snap):
        self.replica_id = replica_id
        self.snap = {"ok": True, "ready": True, "queue_depth": 0,
                     "degraded": False, "open_buckets": 0,
                     "slo_state": "ok", **snap}

    def snapshot(self):
        return dict(self.snap)


class FakeRouter:
    def __init__(self, *sensors):
        self.replicas = list(sensors)


def _cfg(mod, **kw):
    base = dict(min_replicas=1, max_replicas=3, interval_s=0.01,
                cooldown_s=10.0, hot_sustain_s=2.0, calm_sustain_s=5.0,
                max_inflight_spawns=1, queue_high=4)
    base.update(kw)
    return mod.AutoscalerConfig(**base)


class Loop:
    """One package's autoscaler over one ready replica, with a trace of
    every decision."""

    def __init__(self, mod, **kw):
        self.clk = [0.0]
        self.sup = FakeSupervisor(r0="ready")
        self.sensor = FakeReplicaSensor("r0")
        self.auto = mod.FleetAutoscaler(
            self.sup, router=FakeRouter(self.sensor),
            config=_cfg(mod, **kw), _now=lambda: self.clk[0])
        self.trace = []

    def at(self, t, **snap):
        self.clk[0] = t
        self.sensor.snap.update(snap)
        d = self.auto.tick()
        self.trace.append({k: d.get(k) for k in ("action", "reason",
                                                 "detail", "replica")})
        return d

    def result(self):
        return {"decisions": self.trace, "added": self.sup.added,
                "drained": self.sup.drained,
                "audit": [{k: e[k] for k in ("action", "reason", "count")}
                          for e in self.auto.status()["audit"]]}


def _sustained_pressure(lp):
    lp.at(0.0, queue_depth=9)
    lp.at(1.0)
    lp.at(2.5)


def _blip(lp):
    lp.at(0.0, queue_depth=9)
    lp.at(1.5, queue_depth=0)
    lp.at(3.0, queue_depth=9)
    lp.at(4.9)


def _oscillating(lp):
    for i in range(40):
        lp.at(i * 0.5, queue_depth=9 if i % 2 else 0)


def _slo_burn(lp):
    lp.at(0.0, slo_state="burning")
    lp.at(2.5)


def _degraded(lp):
    lp.at(0.0, degraded=True)
    lp.at(2.5)


def _open_buckets(lp):
    lp.at(0.0, open_buckets=2)
    lp.at(2.5)


def _at_max(lp):
    lp.at(0.0, queue_depth=9)
    lp.at(2.5)


def _spawn_budget(lp):
    lp.at(0.0, queue_depth=9)
    lp.at(2.5)
    lp.at(10.0)
    lp.sup.states["as1"] = "ready"
    lp.at(12.0)


def _cooldown(lp):
    lp.at(0.0, queue_depth=9)
    lp.at(2.5)
    lp.sup.states["as1"] = "ready"
    lp.at(5.0)
    lp.at(13.0)


def _min_floor(lp):
    lp.at(0.0)
    lp.at(6.0)


def _scale_in_lifo(lp):
    lp.at(0.0, queue_depth=9)
    lp.at(2.5)
    lp.sup.states["as1"] = "ready"
    lp.at(20.0, queue_depth=0)
    lp.at(26.0)


def _drain_race(lp):
    _scale_in_lifo(lp)
    lp.at(27.0, queue_depth=9)
    lp.at(30.0)
    lp.sup.states["as1"] = "retired"
    lp.at(31.0)


def _coalesce(lp):
    lp.at(0.0, queue_depth=9)
    for i in range(20):
        lp.at(3.0 + i * 0.1)


# scenario -> (driver, config overrides, the port's expected acts)
SCENARIOS = {
    "sustained_pressure": (_sustained_pressure, {}, (["as1"], [])),
    "blip": (_blip, {}, ([], [])),
    "oscillating": (_oscillating, {}, ([], [])),
    "slo_burn": (_slo_burn, {}, (["as1"], [])),
    "degraded": (_degraded, {}, (["as1"], [])),
    "open_buckets": (_open_buckets, {}, (["as1"], [])),
    "at_max": (_at_max, {"max_replicas": 1}, ([], [])),
    "spawn_budget": (_spawn_budget, {"cooldown_s": 1.0},
                     (["as1", "as2"], [])),
    "cooldown": (_cooldown, {}, (["as1", "as2"], [])),
    "min_floor": (_min_floor, {}, ([], [])),
    "scale_in_lifo": (_scale_in_lifo, {}, (["as1"], ["as1"])),
    "drain_race": (_drain_race, {"cooldown_s": 1.0},
                   (["as1", "as2"], ["as1"])),
    "coalesce": (_coalesce, {"max_replicas": 1}, ([], [])),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_jax(name):
    drive, kw, (added, drained) = SCENARIOS[name]
    got = {}
    for pkg, mod in (("jax", jauto), ("torch", tauto)):
        lp = Loop(mod, **kw)
        drive(lp)
        got[pkg] = lp.result()
    assert got["torch"] == got["jax"]
    res = got["torch"]
    assert (res["added"], res["drained"]) == (added, drained)
    acts = [d["action"] for d in res["decisions"]]
    if name in ("blip", "oscillating"):
        assert set(acts) == {"hold"}
    if name == "slo_burn":
        assert res["decisions"][-1]["reason"] == "slo_burn"
    if name == "sustained_pressure":
        assert acts == ["hold", "hold", "scale_out"]
        assert "pressure" in res["decisions"][-1]["reason"]
    if name == "at_max":
        assert res["decisions"][-1]["reason"] == "at_max_replicas"
    if name == "spawn_budget":
        assert res["decisions"][2]["reason"] == "spawn_budget_spent"
    if name == "cooldown":
        assert res["decisions"][2]["reason"] == "cooldown"
    if name == "min_floor":
        assert res["decisions"][-1]["reason"] == "at_min_replicas"
    if name == "drain_race":
        refused = res["decisions"][-2]
        assert (refused["action"], refused["reason"]) == (
            "refuse_scale_out", "cooldown")
        assert "drain" in refused["detail"]
    if name == "coalesce":
        refusals = [e for e in res["audit"]
                    if e["action"] == "refuse_scale_out"]
        assert len(refusals) == 1 and refusals[0]["count"] == 20


def test_refusals_are_metered_like_jax():
    def metered(mod, monitor):
        lp = Loop(mod, max_replicas=1)
        before = monitor.metric_value("autoscaler_decisions_total", 0.0,
                                      action="refuse_scale_out",
                                      reason="at_max_replicas")
        _at_max(lp)
        return monitor.metric_value("autoscaler_decisions_total", 0.0,
                                    action="refuse_scale_out",
                                    reason="at_max_replicas") - before

    assert metered(tauto, tmonitor) == metered(jauto, jmonitor) == 1


def test_audit_coalesces_repeated_refusals():
    lp = Loop(tauto, max_replicas=1)
    _coalesce(lp)
    refusals = [e for e in lp.auto.status()["audit"]
                if e["action"] == "refuse_scale_out"]
    assert len(refusals) == 1 and refusals[0]["count"] == 20


def test_status_carries_sense_and_last_decision():
    lp = Loop(tauto)
    _sustained_pressure(lp)
    st = lp.auto.status()
    assert st["sense"]["hot"] and st["sense"]["replicas"] == 1
    assert st["last_decision"]["action"] == "scale_out"
    assert st["spawned"] == ["as1"]
    jl = Loop(jauto)
    _sustained_pressure(jl)
    assert st["config"] == jl.auto.status()["config"]
    assert set(st) == set(jl.auto.status())


def test_config_validation_is_typed():
    with pytest.raises(ValueError):
        AutoscalerConfig(min_replicas=2, max_replicas=1).resolve()
    with pytest.raises(ValueError):
        _cfg(tauto, max_inflight_spawns=0).resolve()
    with pytest.raises(ValueError):
        AutoscalerConfig(min_replicas=-1).resolve()


def test_config_resolves_from_flags():
    assert AutoscalerConfig().resolve() == tauto.AutoscalerConfig(
        **vars(jauto.AutoscalerConfig().resolve()))
    tfluid.set_flags({"FLAGS_serving_autoscale_max_replicas": 7,
                      "FLAGS_serving_autoscale_cooldown_s": 3.5})
    c = AutoscalerConfig().resolve()
    assert c.max_replicas == 7 and c.cooldown_s == 3.5


def test_worst_state_merge_order():
    pairs = [("ok", "burning"), ("warning", "ok"), (None, "ok"),
             (None, None), ("unknown", "warning"), ("burning", None)]
    assert [_worst(a, b) for a, b in pairs] \
        == [jauto._worst(a, b) for a, b in pairs]
    assert _worst("ok", "burning") == "burning"
    assert _worst(None, None) == "unknown"


class EngineDrainSupervisor:
    """Supervisor shim over in-process engines: drain() is the engine's
    graceful drain-stop, on its own thread like the real SIGTERM. The
    victim is reported retired only once ``exit_ev`` is set, as a real
    replica is live until its process exits: the test holds the drain
    in flight while it checks the decisions made meanwhile."""

    def __init__(self, engines):
        self.engines = dict(engines)
        self.states = {rid: "ready" for rid in self.engines}
        self.added = []
        self.threads = []
        self.exit_ev = threading.Event()

    def status(self):
        return {rid: {"state": s} for rid, s in self.states.items()}

    def add_replica(self, replica_id, **kw):
        self.added.append(replica_id)
        self.states[replica_id] = "spawning"

    def drain(self, replica_id):
        def _drain():
            self.engines[replica_id].stop(drain=True)
            self.exit_ev.wait(60.0)
            self.states[replica_id] = "retired"

        t = threading.Thread(target=_drain, daemon=True)
        t.start()
        self.threads.append(t)


def test_scale_in_mid_burst_drains_clean_and_refuses_concurrent_scale_out():
    pairs = [serve(replica_id=f"r{i}", queue_depth=64) for i in range(2)]
    engines = [e for e, _ in pairs]
    router = FleetRouter([Replica(f"r{i}", "127.0.0.1", fe.port)
                          for i, (_, fe) in enumerate(pairs)])
    router.poll_now()
    try:
        sup = EngineDrainSupervisor({"r0": engines[0], "r1": engines[1]})
        clk = [0.0]
        auto = FleetAutoscaler(
            sup, router=router,
            config=_cfg(tauto, min_replicas=1, calm_sustain_s=1.0,
                        cooldown_s=0.5),
            _now=lambda: clk[0])
        stop_burst = threading.Event()
        errors = []

        def _burst(seed):
            i = 0
            while not stop_burst.is_set():
                try:
                    router.submit(feed(seed=seed * 1000 + i))
                except tserving.ServingError:
                    pass          # typed sheds are legal under burst
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                i += 1

        threads = [threading.Thread(target=_burst, args=(s,), daemon=True)
                   for s in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        auto.tick()
        clk[0] = 1.5
        d = auto.tick()
        assert d["action"] == "scale_in" and d["replica"] == "r1"
        clk[0] = 4.0
        for rep in router.replicas:
            if rep.replica_id == "r0":
                rep._update({**rep.snapshot(), "queue_depth": 99})
        auto.tick()
        clk[0] = 7.0
        d = auto.tick()
        assert d["action"] == "refuse_scale_out"
        assert d["reason"] == "cooldown" and "drain" in d["detail"]
        assert sup.added == []
        sup.exit_ev.set()
        for t in sup.threads:
            t.join(30.0)
        assert sup.states["r1"] == "retired"
        stop_burst.set()
        for t in threads:
            t.join(10.0)
        assert not errors
        victim = engines[1].accounting()
        assert victim["exact"] and victim["pending"] == 0
        assert victim["completed"] > 0 and victim["failed"] == 0
        router.poll_now()
        before = engines[1].accounting()["submitted"]
        for i in range(5):
            router.submit(feed(seed=9000 + i))
        assert engines[1].accounting()["submitted"] == before
        acct = router.accounting()
        assert acct["exact"] and acct["replica_lost"] == 0
        for rep in router.replicas:
            if rep.replica_id == "r0":
                rep._update({**rep.snapshot(), "queue_depth": 99})
        clk[0] = 8.0
        decisions = [auto.tick()]
        clk[0] = 11.0
        decisions.append(auto.tick())
        assert any(d["action"] == "scale_out" for d in decisions)
        assert sup.added == ["as1"]
    finally:
        router.stop()
        for eng, fe in pairs:
            close(eng, fe)
