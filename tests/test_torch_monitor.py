"""The PyTorch port's ``monitor`` against the JAX package's, on the CPU:
the same observations give the same metric values and the same
Prometheus text (which parses back with the port's own parser), hooks
fire with equal record fields, the same sequence of ``Executor.run``
calls gives equal compile / recompile / cache-lookup counts naming the
same changed key component, the pass and fusion metrics land under the
reference's names, and the lock factories are plain by default while
the witness finds a planted cycle. Values are compared exactly: both
registries do the same float arithmetic on the same inputs."""
import dataclasses
import threading

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import monitor as jmonitor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.interop import scope_from_numpy


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


def _fill(mon):
    reg = mon.MetricsRegistry()
    c = reg.counter("requests_total", 'hostile "help"\nwith a newline \\')
    c.labels(outcome="ok").inc()
    c.labels(outcome="ok").inc(2)
    c.labels(outcome='sh"ed\n').inc(0.5)
    g = reg.gauge("queue_depth", "queued")
    g.set(7)
    g.dec(2)
    h = reg.histogram("latency_seconds", "lat")
    rng = np.random.RandomState(5)
    for v in rng.exponential(0.02, 200):
        h.labels(path="run").observe(float(v))
    reg.histogram("occ", "occupancy", buckets=(0.25, 0.5, 1.0)).observe(0.75)
    return reg


def test_registry_values_and_prometheus_text_match():
    jreg, treg = _fill(jmonitor), _fill(tmonitor)
    assert treg.to_dict() == jreg.to_dict()
    text = treg.to_prometheus()
    assert text == jreg.to_prometheus()
    snap = treg.get("latency_seconds").labels(path="run").snapshot()
    want = jreg.get("latency_seconds").labels(path="run").snapshot()
    assert snap == want and snap["p50"] is not None and snap["p99"]
    assert tmonitor.DEFAULT_TIME_BUCKETS == jmonitor.DEFAULT_TIME_BUCKETS
    fams = tmonitor.parse_prometheus_text(text)
    assert set(fams) == {"requests_total", "queue_depth",
                         "latency_seconds", "occ"}
    assert fams["requests_total"].value(outcome="ok") == 3.0
    assert fams["requests_total"].value(outcome='sh"ed\n') == 0.5
    assert fams["queue_depth"].value() == 5.0
    back = tmonitor.histogram_snapshot_from_samples(fams["occ"])
    jback = jmonitor.histogram_snapshot_from_samples(
        jmonitor.parse_prometheus_text(text)["occ"])
    assert back == jback and back["count"] == 1


def _net(pkg):
    fl, un = (jfluid, jun) if pkg == "jax" else (tfluid, tun)
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[13], dtype="float32")
            pred = fl.layers.fc(x, 4, act="relu")
        infer = main.clone(for_test=True)
    return fl, infer, startup, pred.name


def _run_sequence(pkg, params):
    """A new program, a repeat, a new feed shape, a new fetch list, then
    a repeat; returns the counters, the compile events and the hooks'
    step records."""
    fl, infer, startup, pred = _net(pkg)
    mon = jmonitor if pkg == "jax" else tmonitor
    exe = fl.Executor(fl.CPUPlace())
    if pkg == "jax":
        scope = fl.Scope()
        for n, a in params.items():
            scope.set_var(n, a)
    else:
        scope = scope_from_numpy(params, fl.Scope(), fl.CPUPlace())
    mon.reset()
    steps, compiles = [], []
    hook = mon.add_hook(on_step_end=steps.append,
                        on_compile=compiles.append)
    x_name = infer.global_block.ops[0].input("X")[0]
    try:
        for rows, fetch in ((2, [pred]), (2, [pred]), (3, [pred]),
                            (3, [pred, x_name]), (2, [pred])):
            feed = {"x": np.ones((rows, 13), np.float32)}
            exe.run(infer, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        mon.remove_hook(hook)

    def cnt(name, **lab):
        return mon.metric_value(name, 0.0, **lab)

    counters = {
        "miss": cnt("executor_cache_lookups_total", path="run",
                    result="miss"),
        "hit": cnt("executor_cache_lookups_total", path="run",
                   result="hit"),
        "compiles": cnt("executor_compiles_total", path="run"),
        "recompiles": cnt("executor_recompiles_total", path="run"),
        "steps": cnt("executor_steps_total", path="run"),
        "recompile_count": mon.recompile_count(),
    }
    events = [(e.path, e.recompile, e.changed, e.n_compiles)
              for e in mon.recompile_events(recompiles_only=False)]
    return counters, events, steps, compiles


def test_executor_compile_and_recompile_events_match():
    jfl, jinfer, jstart, _ = _net("jax")
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(jstart, scope=scope)
    params = {n: scope.numpy(n) for n in jstart.global_block.vars}
    jc, je, jsteps, jcomp = _run_sequence("jax", params)
    tc, te, tsteps, tcomp = _run_sequence("torch", params)
    assert tc == jc
    assert tc == {"miss": 3.0, "hit": 2.0, "compiles": 3.0,
                  "recompiles": 2.0, "steps": 5.0, "recompile_count": 2}
    assert te == je
    assert [e[2] for e in te] == [(), ("feed_signature",), ("fetch_list",)]
    # hooks: the same step and compile records, field by field
    skip = {"program_serial", "step_index", "duration_s", "donated_bytes"}
    assert len(tsteps) == len(jsteps) == 5
    for a, b in zip(jsteps, tsteps):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert {k: v for k, v in db.items() if k not in skip} == \
            {k: v for k, v in da.items() if k not in skip}
    assert [(c.path, c.recompile, c.changed, c.n_compiles) for c in tcomp] \
        == [(c.path, c.recompile, c.changed, c.n_compiles) for c in jcomp]
    # the port has no compiler: the compile stage is 0
    assert all(c.compile_s == 0.0 for c in tcomp)


def test_chained_path_counts_iterations_like_the_reference():
    out = {}
    for pkg in ("jax", "torch"):
        fl, infer, startup, pred = _net(pkg)
        mon = jmonitor if pkg == "jax" else tmonitor
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        mon.reset()
        feed = {"x": np.ones((2, 13), np.float32)}
        for _ in range(2):
            exe.run_chained(infer, feed=feed, fetch_list=[pred], steps=3,
                            scope=scope)
        out[pkg] = (
            mon.metric_value("executor_chained_iterations_total", 0.0),
            mon.metric_value("executor_steps_total", 0.0, path="chained"),
            mon.metric_value("executor_cache_lookups_total", 0.0,
                             path="chained", result="miss"),
            mon.metric_value("executor_cache_lookups_total", 0.0,
                             path="chained", result="hit"))
    assert out["torch"] == out["jax"] == (6.0, 2.0, 1.0, 1.0)


def test_monitor_off_records_nothing():
    tfluid.set_flags({"FLAGS_monitor": False})
    _, infer, startup, pred = _net("torch")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    tmonitor.reset()
    exe.run(infer, feed={"x": np.ones((1, 13), np.float32)},
            fetch_list=[pred], scope=scope)
    assert tmonitor.snapshot()["metrics"] == {}
    assert tmonitor.recompile_events(recompiles_only=False) == []


def test_fusion_and_pass_metrics_use_the_reference_names():
    """FLAGS_epilogue_fusion on the fc program: one fusion decision, its
    chain by epilogue kind, and the pass run, counted as the reference
    counts them."""
    out = {}
    for pkg in ("jax", "torch"):
        fl, infer, startup, pred = _net(pkg)
        mon = jmonitor if pkg == "jax" else tmonitor
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        mon.reset()
        fl.set_flags({"FLAGS_epilogue_fusion": True})
        try:
            for rows in (4, 4, 8):
                exe.run(infer, feed={"x": np.ones((rows, 13), np.float32)},
                        fetch_list=[pred], scope=scope)
        finally:
            fl.set_flags({"FLAGS_epilogue_fusion": False})
        out[pkg] = (
            mon.metric_value("fusion_programs_total", 0.0,
                             outcome="applied"),
            mon.metric_value("fusion_ops_fused_total", 0.0,
                             epilogue="bias+relu"),
            mon.metric_value("pass_runs_total", 0.0,
                             **{"pass": "epilogue_fusion",
                                "kind": "transform", "result": "run"}))
    assert out["torch"] == out["jax"] == (1.0, 1.0, 1.0)


def test_lock_factories_plain_by_default_and_witness_finds_a_cycle():
    lk = tmonitor.make_lock("t.a")
    assert type(lk) is type(threading.Lock())
    assert type(tmonitor.make_rlock("t.r")) is type(threading.RLock())
    cond = tmonitor.make_condition("t.c", lk)
    assert isinstance(cond, threading.Condition)
    tfluid.set_flags({"FLAGS_lock_witness": True})
    tmonitor.reset_witness()
    try:
        a, b = tmonitor.make_lock("t.A"), tmonitor.make_lock("t.B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert tmonitor.witness_cycles() == [["t.A", "t.B"]]
        rep = tmonitor.witness_report()
        assert {(e["src"], e["dst"]) for e in rep["edges"]} == {
            ("t.A", "t.B"), ("t.B", "t.A")}
        assert rep["locks"]["t.A"]["acquisitions"] == 2
    finally:
        tmonitor.reset_witness()
    from paddle_tpu.analysis.concurrency import _find_cycles
    from paddle_tpu_torch.monitor.lockwitness import \
        _find_cycles as t_find_cycles

    edges = {("a", "b"), ("b", "c"), ("c", "a"), ("d", "d"), ("e", "f")}
    nodes = {n for e in edges for n in e}
    assert t_find_cycles(nodes, edges) == _find_cycles(nodes, edges)
