"""The port's PT800 concurrency analysis (``paddle_tpu_torch.analysis.
concurrency``), its CI gate (``tools/torch_lint_concurrency.py``) and the
runtime lock witness, against the JAX package's on the CPU.

The JAX package's cases in the port: the fixtures under
``tests/fixtures/concurrency`` (they import only ``threading`` and
``time``, so both analyzers read them unchanged) trip PT800/PT801/PT802,
the clean fixture is clean, the port's own source has no PT800 and every
finding is allowlisted with a reason, and the runtime witness sees only
lock-order edges the static graph predicts, on an executor path and on a
``ServingEngine`` behind a ``FleetRouter``. The two analyzers give the
same codes, keys, locks and edges on the shared fixtures."""
import json
import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu.analysis import concurrency as jconc

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor
from paddle_tpu_torch.analysis.concurrency import (analyze_package,
                                                   analyze_paths,
                                                   static_edge_set)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "concurrency")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))


def _fixture_report(name):
    return analyze_paths([os.path.join(FIXTURES, name)], root=FIXTURES)


# -- static analysis: positive controls ------------------------------------

def test_ab_ba_deadlock_fixture_trips_pt800():
    rep = _fixture_report("deadlock_ab.py")
    pt800 = [d for d in rep.diagnostics if d.code == "PT800"]
    assert pt800, "AB/BA lock order must be reported as a cycle"
    assert pt800[0].severity == "error"
    assert "Worker._a" in pt800[0].op_type
    assert "Worker._b" in pt800[0].op_type
    edges = rep.edge_set()
    a = next(e for e in edges if e[0].endswith("Worker._a"))
    assert (a[1], a[0]) in edges


def test_sleep_under_lock_fixture_trips_pt801_direct_and_transitive():
    rep = _fixture_report("sleep_under_lock.py")
    keys = {d.op_type for d in rep.diagnostics if d.code == "PT801"}
    assert any(k.endswith("CompileCache.get+time.sleep") for k in keys)
    assert any(k.endswith("CompileCache.warm+time.sleep") for k in keys)


def test_unguarded_attr_fixture_trips_pt802():
    rep = _fixture_report("unguarded_attr.py")
    pt802 = [d for d in rep.diagnostics if d.code == "PT802"]
    assert [d.op_type for d in pt802] == ["Stats.count"]
    assert "_loop" in pt802[0].message


_DEVICE_WAITS = '''
import threading
import torch


class Runner:
    def __init__(self):
        self._lock = threading.Lock()
        self._ev = torch.cuda.Event()
        self._stream = torch.cuda.Stream()

    def sync_all(self):
        with self._lock:
            torch.cuda.synchronize()

    def sync_event(self):
        with self._lock:
            self._ev.synchronize()

    def sync_stream(self):
        with self._lock:
            torch.cuda.current_stream().synchronize()

    def wait_event(self):
        with self._lock:
            self._ev.wait()

    def host_read(self, t):
        with self._lock:
            return t.item(), t.cpu()


_locks = {}
_table = threading.Lock()


def build(name):
    with _table:
        one = _locks.setdefault(name, threading.Lock())
    with one:
        import subprocess
        subprocess.run(["true"])
'''


def test_device_waits_and_keyed_locks(tmp_path):
    """The port's additions: ``torch.cuda.synchronize`` and a CUDA
    stream's or event's ``synchronize()`` under a lock are PT801 (an
    event's ``wait()`` enqueues a device-side wait and a host read waits
    only for its own value: neither is); a lock kept per key in a dict is
    one node that the build under it holds."""
    (tmp_path / "dev").mkdir()
    path = tmp_path / "dev" / "runner.py"
    path.write_text(_DEVICE_WAITS)
    rep = analyze_paths([str(path)], root=str(tmp_path / "dev"))
    keys = sorted(d.op_type for d in rep.diagnostics if d.code == "PT801")
    assert keys == ["dev.runner.Runner.sync_all+torch.cuda.synchronize",
                    "dev.runner.Runner.sync_event+cudaevent.synchronize",
                    "dev.runner.Runner.sync_stream+cudastream.synchronize",
                    "dev.runner.build+subprocess.run"]
    assert rep.locks["dev.runner._locks[]"].kind == "lock"
    assert ("dev.runner._table", "dev.runner._locks[]") \
        not in rep.edge_set()
    assert [d.code for d in rep.diagnostics].count("PT800") == 0


# -- static analysis: negative controls ------------------------------------

def test_clean_fixture_produces_no_findings():
    rep = _fixture_report("clean.py")
    assert rep.diagnostics == [], (
        "; ".join(f"{d.code} {d.op_type}" for d in rep.diagnostics))


def test_clean_fixture_still_sees_the_locks_and_edges():
    rep = _fixture_report("clean.py")
    kinds = {d.kind for d in rep.locks.values()}
    assert {"lock", "condition", "event"} <= kinds
    assert any(e[0].endswith("Pipeline._a") and e[1].endswith("Pipeline._b")
               for e in rep.edge_set())


@pytest.mark.parametrize("name", FIXTURE_FILES + ["all"])
def test_both_analyzers_agree_on_the_shared_fixtures(name):
    paths = [os.path.join(FIXTURES, f) for f in
             (FIXTURE_FILES if name == "all" else [name])]
    j = jconc.analyze_paths(paths, root=FIXTURES)
    t = analyze_paths(paths, root=FIXTURES)
    assert sorted((d.code, d.op_type, d.site) for d in t.diagnostics) == \
        sorted((d.code, d.op_type, d.site) for d in j.diagnostics)
    assert {k: (v.kind, v.reentrant, v.alias_of)
            for k, v in t.locks.items()} == \
        {k: (v.kind, v.reentrant, v.alias_of) for k, v in j.locks.items()}
    assert t.edge_set() == j.edge_set()
    assert t.functions == j.functions and t.modules == j.modules


# -- the package gate ------------------------------------------------------

@pytest.fixture(scope="module")
def package_report():
    return analyze_package()


def test_package_scans_the_port_alone(package_report):
    assert package_report.modules
    assert all(m == "paddle_tpu_torch" or m.startswith("paddle_tpu_torch.")
               for m in package_report.modules)
    assert "paddle_tpu_torch.serving.fleet.autoscaler" in \
        package_report.modules


def test_package_has_no_lock_order_cycles(package_report):
    assert not [d for d in package_report.diagnostics
                if d.code == "PT800"], "a PT800 in the package is a deadlock"


def test_package_findings_are_all_allowlisted(package_report):
    from tools.torch_lint_concurrency import ALLOWLIST, GATING_CODES

    unlisted = [d for d in package_report.diagnostics
                if d.code in GATING_CODES
                and (d.code, d.op_type) not in ALLOWLIST]
    assert unlisted == [], (
        "fix it or allowlist it with a reason: "
        + "; ".join(f"{d.code} {d.op_type} at {d.site}" for d in unlisted))
    live = {(d.code, d.op_type) for d in package_report.diagnostics}
    stale = [k for k in ALLOWLIST if k not in live]
    assert stale == [], f"stale allowlist entries: {stale}"
    assert all(reason.strip() for reason in ALLOWLIST.values())
    # the nvcc build under the per-kernel lock is one of them
    assert ("PT801", "paddle_tpu_torch.kernels._build.load+subprocess.run") \
        in live


def test_package_inventories_the_named_framework_locks(package_report):
    for name in ("ServingEngine._lock", "FleetRouter._lock",
                 "ReplicaSupervisor._lock", "Executor._lock", "Scope._lock",
                 "_CompiledStep._aot_lock", "aot_cache._warned_lock",
                 "FleetAutoscaler._tick_lock"):
        assert name in package_report.locks, name
    work = package_report.locks[
        "paddle_tpu_torch.serving.engine.ServingEngine._work"]
    assert work.kind == "condition" and work.node == "ServingEngine._lock"
    # the plain locks the JAX package lacks
    for name in ("paddle_tpu_torch.kernels._build._lock",
                 "paddle_tpu_torch.kernels._build._name_locks[]",
                 "paddle_tpu_torch.kernels._build._count_lock",
                 "paddle_tpu_torch.ops.common._CUDNN_LOCK",
                 "paddle_tpu_torch.native._lock"):
        assert name in package_report.locks, name
    assert package_report.locks[
        "paddle_tpu_torch.ops.common._CUDNN_LOCK"].reentrant


def test_lint_cli_gate_is_clean(tmp_path, capsys):
    from tools.torch_lint_concurrency import main

    out = tmp_path / "report.json"
    assert main(["--json", str(out)]) == 0
    assert "[ok] paddle_tpu_torch" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert rep["status"] == "ok"
    assert rep["targets"][0]["gating"] == []
    assert all(e["reason"] for e in rep["allowlist"])


def test_lint_cli_negative_control_fails(capsys):
    from tools.torch_lint_concurrency import main

    assert main(["--negative-control"]) == 1
    captured = capsys.readouterr().out
    assert "-> FAIL" in captured
    for code in ("PT800", "PT801", "PT802"):
        assert code in captured


# -- runtime witness -------------------------------------------------------

@pytest.fixture()
def witness_on():
    fluid.set_flags({"FLAGS_lock_witness": 1})
    monitor.reset_witness()
    yield
    monitor.reset_witness()
    fluid.set_flags({"FLAGS_lock_witness": 0})


def test_witness_disabled_returns_plain_primitives():
    fluid.set_flags({"FLAGS_lock_witness": 0})
    assert isinstance(monitor.make_lock("t.plain"), type(threading.Lock()))
    assert isinstance(monitor.make_rlock("t.plain_r"),
                      type(threading.RLock()))
    assert isinstance(monitor.make_condition("t.plain_c"),
                      threading.Condition)
    assert monitor.witness_report()["enabled"] is False


def test_witness_records_nested_acquisition_edge(witness_on):
    outer = monitor.make_lock("t.outer")
    inner = monitor.make_lock("t.inner")
    with outer:
        with inner:
            pass
    assert ("t.outer", "t.inner") in monitor.witness_edges()
    assert ("t.inner", "t.outer") not in monitor.witness_edges()
    rep = monitor.witness_report()
    assert rep["enabled"] is True
    assert rep["locks"]["t.outer"]["acquisitions"] == 1
    assert rep["locks"]["t.inner"]["hold"]["count"] == 1
    assert rep["cycles"] == []


def test_witness_observes_runtime_ab_ba_cycle(witness_on):
    a = monitor.make_lock("t.a")
    b = monitor.make_lock("t.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    cycles = monitor.witness_cycles()
    assert cycles and set(cycles[0]) == {"t.a", "t.b"}


def test_witness_reentrant_rlock_adds_no_self_edge(witness_on):
    r = monitor.make_rlock("t.re")
    with r:
        with r:
            pass
    assert monitor.witness_edges() == set()
    assert monitor.witness_cycles() == []


def test_witness_condition_wait_releases_the_lock(witness_on):
    lock = monitor.make_lock("t.cond_lock")
    cond = monitor.make_condition("t.cond", lock)
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=1.0)
            hits.append("woken")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append("notified")
        cond.notify()
    t.join(timeout=2.0)
    assert not t.is_alive()
    assert hits == ["notified", "woken"]
    assert monitor.witness_report()["locks"]["t.cond_lock"][
        "acquisitions"] >= 3
    assert monitor.witness_edges() == set()


def test_witness_wait_hold_histograms_accumulate(witness_on):
    lock = monitor.make_lock("t.held")
    with lock:
        time.sleep(0.02)
    stats = monitor.witness_report()["locks"]["t.held"]
    assert stats["hold"]["count"] == 1
    assert stats["hold"]["max"] >= 0.015
    assert stats["wait"]["count"] == 1


def _framework_edges(report):
    static = static_edge_set(report)
    names = {n for e in static for n in e} | set(report.locks)
    runtime = {e for e in monitor.witness_edges()
               if e[0] in names and e[1] in names}
    return runtime, static


def test_runtime_edges_are_a_subset_of_the_static_graph(witness_on,
                                                        package_report):
    """An executor path on the CPU with the witness on, the compile fault
    site retried once under the per-step lock: every runtime edge between
    framework-named locks is predicted by the static graph."""
    from paddle_tpu_torch.resilience import fault_plan_guard

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        pred = fluid.layers.fc(x, 1)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with fault_plan_guard("compile:1:RuntimeError"):
        exe.run(main, feed={"x": np.zeros((2, 4), np.float32)},
                fetch_list=[pred.name], scope=scope)
    runtime, static = _framework_edges(package_report)
    assert ("_CompiledStep._aot_lock", "FaultPlan._lock") in runtime
    assert runtime - static == set(), sorted(runtime - static)
    assert monitor.witness_cycles() == []


def test_serving_engine_behind_a_router_stays_in_the_static_graph(
        witness_on, package_report):
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving.fleet import (FleetRouter, Replica,
                                                ServingFrontend)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[13], dtype="float32")
        pred = fluid.layers.fc(x, 4, act="softmax")
    infer = main.clone(for_test=True)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    eng = ServingEngine(infer, feed_names=["x"], fetch_list=[pred.name],
                        scope=scope, executor=exe,
                        config=ServingConfig(max_batch=4,
                                             batch_window_s=0.005))
    eng.warm_up()
    eng.start()
    fe = ServingFrontend(eng, replica_id="w0")
    fe.start()
    router = FleetRouter([Replica("w0", "127.0.0.1", fe.port)])
    try:
        router.poll_now()
        rng = np.random.RandomState(0)
        feeds = [{"x": rng.rand(1, 13).astype(np.float32)}
                 for _ in range(8)]
        threads = [threading.Thread(target=router.submit, args=(f,))
                   for f in feeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        acct, racct = eng.accounting(), router.accounting()
    finally:
        fe.stop(wait_inflight_s=2.0)
        eng.stop(drain=True)
    assert acct["exact"] and racct["exact"] and racct["completed"] == 8
    witnessed = set(monitor.witness_report()["locks"])
    assert {"ServingEngine._lock", "Executor._lock", "FleetRouter._lock",
            "ServingFuture._lock"} <= witnessed
    runtime, static = _framework_edges(package_report)
    assert runtime - static == set(), sorted(runtime - static)
    assert monitor.witness_cycles() == []


# -- constructor parameters typed from their callers ------------------------

AUTOSCALER_EDGES = {("FleetAutoscaler._tick_lock", "ReplicaSupervisor._lock"),
                    ("FleetAutoscaler._tick_lock", "Replica._lock")}


def test_package_graph_holds_the_autoscaler_edges(package_report):
    """The tick reaches the supervisor (its annotated constructor
    parameter) and the router's replicas (the router falls back to the
    supervisor's, typed through ``getattr(supervisor, "router")``) under
    the tick lock."""
    assert AUTOSCALER_EDGES <= package_report.edge_set()


_HOLDER = '''import threading


class Sink:
    def __init__(self):
        self._lock = threading.Lock()

    def put(self):
        with self._lock:
            pass


class Cache:
    def __init__(self):
        self._lock = threading.Lock()

    def put(self):
        with self._lock:
            pass


class Owner:
    def __init__(self, cache: Cache):
        self.cache = cache


class Holder:
    def __init__(self, sink, owner: Owner, fallback=None):
        self._lock = threading.Lock()
        self.sink = sink
        self.fallback = fallback if fallback is not None \\
            else getattr(owner, "cache", None)

    def flush(self):
        with self._lock:
            self.sink.put()

    def spill(self):
        with self._lock:
            self.fallback.put()
'''
SINK = ("dev.holder.Holder._lock", "dev.holder.Sink._lock")
CACHE = ("dev.holder.Holder._lock", "dev.holder.Cache._lock")


def _holder_report(tmp_path, caller, holder=_HOLDER):
    pkg = tmp_path / "dev"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "holder.py").write_text(holder)
    (pkg / "use.py").write_text(caller)
    return analyze_paths([str(p) for p in sorted(pkg.glob("*.py"))],
                         root=str(pkg))


def test_unannotated_ctor_param_is_typed_from_its_callers(tmp_path):
    """``self.sink = sink`` with no annotation: the one class the
    package's callers pass there types it (here a local assigned a
    constructor call); ``x if x is not None else getattr(owner, "cache",
    None)`` is typed from the annotated ``owner``'s class. Without a
    caller the sink stays unresolved."""
    rep = _holder_report(tmp_path / "a", (
        "from .holder import Cache, Holder, Owner, Sink\n\n\n"
        "def make():\n"
        "    sink = Sink()\n"
        "    return Holder(sink, Owner(Cache()))\n"))
    assert {SINK, CACHE} <= rep.edge_set()
    bare = _holder_report(tmp_path / "b", (
        "from .holder import Holder\n\n\n"
        "def make(x):\n"
        "    return Holder(x, None)\n"))
    assert CACHE in bare.edge_set() and SINK not in bare.edge_set()


def test_both_resolutions_are_needed_for_their_edges(tmp_path):
    """Negative control: with no caller and the owner unannotated, the
    analysis resolves neither call, and both edges are missing."""
    rep = _holder_report(tmp_path, "", _HOLDER.replace("owner: Owner",
                                                        "owner"))
    assert not {SINK, CACHE} & rep.edge_set()


def test_autoscaler_edges_need_the_resolution(tmp_path):
    """Negative control: a copy of the package whose autoscaler leaves
    ``supervisor`` unannotated loses both edges, so the witness gate over
    the live autoscaler would fail on them."""
    import shutil

    from paddle_tpu_torch.analysis.concurrency import package_source_files

    src_root = os.path.dirname(os.path.dirname(os.path.abspath(
        analyze_package.__code__.co_filename)))
    root = tmp_path / "paddle_tpu_torch"
    for path in package_source_files(src_root):
        dst = root / os.path.relpath(path, src_root)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, dst)
    auto = root / "serving" / "fleet" / "autoscaler.py"
    text = auto.read_text()
    assert "supervisor: ReplicaSupervisor" in text
    auto.write_text(text.replace("supervisor: ReplicaSupervisor",
                                 "supervisor"))
    rep = analyze_package(str(root))
    assert not AUTOSCALER_EDGES & rep.edge_set()
