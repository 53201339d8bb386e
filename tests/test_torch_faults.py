"""The PyTorch port's fault injection, retry and watchdog against the JAX
package's, on the CPU: the same ``FaultPlan`` spec fires at the same
sites in the same order through the executor and the serving engine,
``RetryPolicy`` and the breaker's cooldown ladder give the same backoff
schedules, an injected ``hang`` under ``FLAGS_step_timeout_s`` dies as a
typed ``WatchdogTimeout`` while the engine keeps serving, and a batch that
fails for a real reason keeps that error as the cause of its
``BatchFailed``. Schedules are compared exactly (same seeded arithmetic)."""
import random
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import monitor as jmonitor
from paddle_tpu import serving as jserving
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import retry as jretry
from paddle_tpu.serving.breaker import CircuitBreaker as JBreaker

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.resilience import distributed as tdist
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import retry as tretry
from paddle_tpu_torch.serving.breaker import CircuitBreaker as TBreaker

SIDES = {"jax": (jfluid, jun, jserving, jmonitor, jfaults),
         "torch": (tfluid, tun, tserving, tmonitor, tfaults)}


@pytest.fixture(autouse=True)
def _reset():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    snaps = [(m, dict(m._overrides)) for m in (jflags, tflags)]
    yield
    for m, snap in snaps:
        m._overrides.clear()
        m._overrides.update(snap)
    jfaults.clear_plan()
    tfaults.clear_plan()


_PARAMS = {}


def _net(side):
    fl, un = SIDES[side][:2]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[13], dtype="float32")
            y = fl.layers.data("y", shape=[4], dtype="float32")
            pred = fl.layers.fc(x, 4, act="softmax")
            out = fl.layers.elementwise_add(pred, y)
        infer = main.clone(for_test=True)
    return infer, startup, out.name


def _scope(side):
    """A scope holding the JAX package's initialised weights (made once)."""
    if not _PARAMS:
        _, startup, _ = _net("jax")
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        exe.run(startup, scope=scope)
        _PARAMS.update({n: scope.numpy(n)
                        for n in startup.global_block.vars})
    fl = SIDES[side][0]
    if side == "jax":
        scope = fl.Scope()
        for n, a in _PARAMS.items():
            scope.set_var(n, a)
        return scope
    return scope_from_numpy(_PARAMS, fl.Scope(), fl.CPUPlace())


def _feed(rows=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(rows, 13).astype(np.float32),
            "y": rng.rand(rows, 4).astype(np.float32)}


SPEC = ("device_put:@3:RuntimeError,step:@2:OSError,"
        "compile:@2:TimeoutError,step:p0.3:RuntimeError,"
        "batch_dispatch:@2:RuntimeError,enqueue:@4:RuntimeError,"
        "overload:@5:RuntimeError")


def _drive(side):
    """Executor runs (two feed shapes, repeats) then engine traffic under
    SPEC; returns the plan's audit trail and hit counts plus the
    outcome of every call."""
    fl, _, srv, _, fa = SIDES[side]
    infer, _, out = _net(side)
    exe = fl.Executor(fl.CPUPlace())
    scope = _scope(side)
    outcomes = []
    with fa.fault_plan_guard(SPEC, seed=7) as plan:
        for rows in (1, 1, 2, 2, 1, 2):
            try:
                exe.run(infer, feed=_feed(rows), fetch_list=[out],
                        scope=scope)
                outcomes.append("ok")
            except Exception as e:
                outcomes.append(type(e).__name__)
        eng = srv.ServingEngine(infer, feed_names=["x", "y"],
                                fetch_list=[out], scope=scope, executor=exe,
                                config=srv.ServingConfig(
                                    max_batch=2, breaker_threshold=10))
        with eng:
            for i in range(6):
                try:
                    err = eng.submit(_feed(seed=i)).exception(timeout=60)
                    outcomes.append(type(err).__name__ if err else "ok")
                except Exception as e:
                    outcomes.append(type(e).__name__)
        acct = eng.accounting()
        acct.pop("recent_outcomes")
    return list(plan.fired), dict(plan.hits), outcomes, acct


def test_same_plan_fires_at_the_same_sites_in_the_same_order():
    jf, jh, jo, ja = _drive("jax")
    tf, th, to, ta = _drive("torch")
    assert tf == jf
    assert th == jh
    assert to == jo
    assert ta == ja and ta["exact"]
    fired_sites = [f[0] for f in tf]
    assert {"device_put", "step", "compile", "batch_dispatch", "enqueue",
            "overload"} <= set(fired_sites)
    assert tmonitor.metric_value("resilience_faults_injected_total", 0.0,
                                 site="compile",
                                 action="TimeoutError") == 1.0


def test_plan_grammar_is_the_reference_grammar():
    assert tfaults.SITES == jfaults.SITES
    for bad in ("nosuch:1:RuntimeError", "step:x:RuntimeError",
                "step:1:NoSuchError", "step:1:drop"):
        with pytest.raises(ValueError):
            tfaults.FaultPlan(bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlan(bad)
    p = tfaults.FaultPlan("step:p0.5:RuntimeError", seed=3)
    q = jfaults.FaultPlan("step:p0.5:RuntimeError", seed=3)
    got = []
    for plan in (p, q):
        trail = []
        for _ in range(40):
            try:
                plan.hit("step")
                trail.append(0)
            except Exception:
                trail.append(1)
        got.append(trail)
    assert got[0] == got[1] and 0 < sum(got[0]) < 40


def test_retry_policy_schedules_match():
    for pol_kw in ({}, {"base_delay": 0.2, "max_delay": 1.0,
                        "multiplier": 3.0, "jitter": 0.5}):
        a, b = tretry.RetryPolicy(**pol_kw), jretry.RetryPolicy(**pol_kw)
        assert a == tretry.RetryPolicy(**pol_kw)
        ra, rb = random.Random(11), random.Random(11)
        assert [a.delay(k, ra) for k in range(1, 12)] == \
            [b.delay(k, rb) for k in range(1, 12)]
    tfluid.set_flags({"FLAGS_retry_max_attempts": 5,
                      "FLAGS_retry_base_delay": 0.01})
    jfluid.set_flags({"FLAGS_retry_max_attempts": 5,
                      "FLAGS_retry_base_delay": 0.01})
    assert vars(tretry.policy_for("compile")) == \
        vars(jretry.policy_for("compile"))
    for exc in (RuntimeError("x"), OSError("x"), ValueError("x"),
                tdist.WatchdogTimeout("step", 1.0)):
        assert tretry.is_transient(exc) == jretry.is_transient(exc)
    # the same failing site retried: the same attempts, retries, giveup
    for mod, mon in ((tretry, tmonitor), (jretry, jmonitor)):
        mon.reset()
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return "done"
        pol = mod.RetryPolicy(max_attempts=4, base_delay=0.001,
                              max_delay=0.002)
        assert mod.call_with_retry("device_put", flaky, policy=pol) == "done"
        assert len(calls) == 3
        assert mon.metric_value("resilience_retries_total", 0.0,
                                site="device_put") == 2.0
        def down():
            raise OSError("down")
        with pytest.raises(mod.RetryExhaustedError):
            mod.call_with_retry("compile", down, policy=pol)
        assert mon.metric_value("resilience_giveups_total", 0.0,
                                site="compile") == 1.0


def test_breaker_cooldown_ladder_matches():
    snaps = []
    for cls in (JBreaker, TBreaker):
        br = cls(2, 0.1, name="b1(x[13]:float32)", seed=3)
        trail, now = [], 100.0
        for _ in range(4):
            br.record_failure(now=now)
            br.record_failure(now=now)
            trail.append(br.snapshot())
            now += 10.0
            trail.append(br.allow(now=now))
        br.record_success()
        trail.append(br.snapshot())
        snaps.append(trail)
    assert snaps[1] == snaps[0]
    assert snaps[1][-1]["state"] == "closed"


def test_injected_hang_dies_typed_and_the_engine_keeps_serving():
    tfluid.set_flags({"FLAGS_step_timeout_s": 1.0,
                      "FLAGS_watchdog_hard_exit": 0})
    infer, _, out = _net("torch")
    eng = tserving.ServingEngine(
        infer, feed_names=["x", "y"], fetch_list=[out],
        scope=_scope("torch"), executor=tfluid.Executor(tfluid.CPUPlace()),
        config=tserving.ServingConfig(max_batch=2, breaker_threshold=10))
    eng.warm_up()
    tmonitor.reset()
    with eng, tfaults.fault_plan_guard("hang:@1:hang"):
        t0 = time.monotonic()
        fut = eng.submit(_feed())
        err = fut.exception(timeout=60)
        took = time.monotonic() - t0
        assert isinstance(err, tserving.BatchFailed)
        assert isinstance(err.__cause__, tdist.WatchdogTimeout)
        assert took < 30
        assert eng.submit(_feed(seed=1)).result(timeout=60)[0].shape == \
            (1, 4)
    acct = eng.accounting()
    assert acct["exact"] and acct["failed"] == 1 and acct["completed"] == 1
    assert tmonitor.metric_value("watchdog_timeouts_total", 0.0,
                                 section="step") == 1.0


def test_watchdog_breaks_a_plain_worker_thread():
    tfluid.set_flags({"FLAGS_watchdog_hard_exit": 0})
    got = {}

    def body():
        try:
            with tdist.watchdog_section("step", timeout=0.3):
                while True:
                    time.sleep(0.02)
        except BaseException as e:
            got["err"] = e

    t = threading.Thread(target=body)
    t.start()
    t.join(30)
    assert not t.is_alive()
    assert isinstance(got.get("err"), tdist.WatchdogTimeout)


def test_a_real_batch_error_stays_the_cause_of_batch_failed():
    """No fallback hides a fault: a kernel error raised inside a batch
    reaches the caller as the cause of its typed BatchFailed, and the
    batch is not re-run anywhere else."""
    from paddle_tpu_torch.kernels._build import KernelError

    infer, _, out = _net("torch")
    eng = tserving.ServingEngine(
        infer, feed_names=["x", "y"], fetch_list=[out],
        scope=_scope("torch"), executor=tfluid.Executor(tfluid.CPUPlace()),
        config=tserving.ServingConfig(max_batch=2))
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise KernelError("fused_gemm: launch failed (injected by the test)")
    eng._exe.run = broken
    with eng:
        err = eng.submit(_feed()).exception(timeout=60)
    assert isinstance(err, tserving.BatchFailed)
    assert isinstance(err.__cause__, KernelError)
    assert calls == [1]
    assert eng.accounting()["failed"] == 1
