"""The PyTorch port's batching ``ServingEngine`` against the JAX package's,
on the CPU: the scenarios of ``tests/test_serving.py`` and
``tests/test_tenant_fairshare.py`` plus the two single-engine SLO cases of
``tests/test_telemetry.py``, each run on the reference's tiny fc program
in BOTH engines (same ``unique_name.guard()``, weights carried across with
``interop.scope_from_numpy``, requests from a numpy seed). Per request the
outcome type must be equal, ``accounting()`` equal (its ``recent_outcomes``
ring holds per-process sequence numbers and is compared by outcome), and
results within f32 rtol 1e-5 (atol 1e-6: softmax outputs near 0).

The dispatcher is parked by gating ``_take_batch_locked`` (the
reference's degradation-harness idiom) wherever a scenario needs queued
requests to stay queued; sustain windows read the engine's injectable
clock. Every wait is bounded."""
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import monitor as jmonitor
from paddle_tpu import serving as jserving
from paddle_tpu.resilience import faults as jfaults

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving.engine import parse_tenant_weights
from paddle_tpu_torch.serving.slo import SloBurnTracker

RTOL, ATOL = 1e-5, 1e-6
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
        self.monitor = jmonitor if jax_side else tmonitor
        self.faults = jfaults if jax_side else tfaults


PKGS = (Pkg("jax"), Pkg("torch"))


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
    """The JAX package's initialised weights (made once per process)."""
    if not _PARAMS:
        infer, startup, _ = _build_infer(PKGS[0])
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        exe.run(startup, scope=scope)
        _PARAMS.update({n: scope.numpy(n)
                        for n in startup.global_block.vars})
    return _PARAMS


def _engine(pkg, **cfg_kw):
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


def _feed(rows=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(rows, 13).astype(np.float32)}


def _park(eng):
    """Park the dispatcher (queued requests stay queued) and drive the
    engine's clock; returns ``(advance, release)``."""
    off, hold = [0.0], [True]
    eng._now = lambda: time.monotonic() + off[0]
    orig = eng._take_batch_locked
    eng._take_batch_locked = \
        lambda now: [] if hold[0] and eng._running else orig(now)

    def advance(seconds):
        off[0] += seconds

    def release():
        hold[0] = False

    return advance, release


def _wait_for(cond, timeout=10.0, what="condition"):
    until = time.monotonic() + timeout
    while time.monotonic() < until:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"{what} never held")


def _wait_health(eng, key, want, timeout=10.0):
    _wait_for(lambda: eng.health()[key] == want, timeout,
              f"health[{key!r}] == {want!r}")


def _outcome(fut):
    """(outcome class name, reason/bucket detail, result arrays)."""
    err = fut.exception(timeout=WAIT)
    if err is None:
        return ("ok", "", fut.result(timeout=WAIT))
    return (type(err).__name__, getattr(err, "reason", ""), None)


def _settle_all(futs):
    return [_outcome(f) for f in futs]


def _try_submit(eng, feed, **kw):
    """submit(); a typed rejection at admission is the outcome."""
    try:
        return eng.submit(feed, **kw)
    except Exception as e:          # the raise IS the terminal outcome
        return e


def _norm(items):
    out = []
    for it in items:
        if isinstance(it, BaseException):
            out.append((type(it).__name__, getattr(it, "reason", ""), None))
        else:
            out.append(_outcome(it))
    return out


def _acct(eng):
    acct = eng.accounting()
    acct["recent_outcomes"] = sorted(
        r["outcome"] for r in acct["recent_outcomes"])
    return acct


def _compare(run):
    """Run ``run(pkg)`` -> (outcomes, accounting, extra) in both packages
    and hold them equal (results within RTOL/ATOL)."""
    res = {p.name: run(p) for p in PKGS}
    (jo, ja, jx), (to, ta, tx) = res["jax"], res["torch"]
    assert [o[:2] for o in to] == [o[:2] for o in jo]
    for a, b in zip(jo, to):
        if a[2] is not None:
            assert len(a[2]) == len(b[2])
            for x, y in zip(a[2], b[2]):
                assert x.shape == y.shape
                np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)
    assert ta == ja
    assert tx == jx
    assert ta["exact"]
    return res


# ---------------------------------------------------------------------------
# batching into buckets
# ---------------------------------------------------------------------------

def test_coalescing_into_one_padded_bucket():
    def run(pkg):
        pkg.monitor.reset()
        eng = _engine(pkg, max_batch=4)
        eng.warm_up()
        _, release = _park(eng)
        with eng:
            futs = [eng.submit(_feed(seed=i)) for i in range(3)]
            release()
            outs = _settle_all(futs)
        m = pkg.monitor
        occ = m.metric_value("serving_batch_occupancy")
        extra = (m.metric_value("serving_batches_total", 0.0, result="ok"),
                 occ["count"], occ["max"])
        return outs, _acct(eng), extra

    res = _compare(run)
    assert res["torch"][2] == (1.0, 1, 0.75)      # one batch, 3 rows / 4


def test_batched_results_match_direct_execution():
    def run(pkg):
        eng = _engine(pkg, max_batch=8)
        _, release = _park(eng)
        feeds = [_feed(rows=r, seed=i) for i, r in enumerate((1, 2, 1))]
        with eng:
            futs = [eng.submit(f) for f in feeds]
            release()
            outs = _settle_all(futs)
        for f, o in zip(feeds, outs):
            direct = eng._exe.run(eng._program, feed=f,
                                  fetch_list=eng._fetch_names,
                                  scope=eng._scope)
            np.testing.assert_allclose(o[2][0], direct[0], rtol=RTOL,
                                       atol=ATOL)
        return outs, _acct(eng), None

    _compare(run)


def test_distinct_shapes_land_in_distinct_buckets():
    def run(pkg):
        eng = _engine(pkg, max_batch=4)
        with eng:
            futs = [eng.submit(_feed(rows=1, seed=3)),
                    eng.submit(_feed(rows=2, seed=4)),
                    eng.submit(_feed(rows=3, seed=5))]
            outs = _settle_all(futs)
        return outs, _acct(eng), [o[2][0].shape for o in outs]

    _compare(run)


def test_warm_up_runs_every_bucket():
    def run(pkg):
        eng = _engine(pkg, max_batch=4)
        m = pkg.monitor

        def misses():
            return m.metric_value("executor_cache_lookups_total", 0.0,
                                  path="run", result="miss")
        m0 = misses()
        n = eng.warm_up()
        m1 = misses()
        with eng:
            outs = _settle_all([eng.submit(_feed())])
        return outs, _acct(eng), (n, m1 - m0, misses() - m1)

    res = _compare(run)
    assert res["torch"][2] == (3, 3, 0)     # buckets 1, 2, 4; then a hit


# ---------------------------------------------------------------------------
# deadlines and admission control
# ---------------------------------------------------------------------------

def test_queued_deadline_is_swept_typed():
    def run(pkg):
        eng = _engine(pkg, max_batch=4)
        eng.warm_up()
        _, release = _park(eng)
        with eng:
            f_dead = eng.submit(_feed(), deadline_s=0.05)
            f_live = eng.submit(_feed(seed=1))
            err = f_dead.exception(timeout=WAIT)     # swept while parked
            release()
            outs = [("DeadlineExceeded", "", None)
                    if isinstance(err, pkg.serving.DeadlineExceeded)
                    else ("?", "", None)] + _settle_all([f_live])
        return outs, _acct(eng), None

    res = _compare(run)
    assert res["torch"][1]["deadline_exceeded"] == 1


def test_queue_full_and_queue_age_shed_typed():
    def run(pkg):
        items = []
        for depth, n in ((2, 2), (8, 1)):
            eng = _engine(pkg, max_batch=1, queue_depth=depth,
                          queue_age_s=5.0)
            eng.warm_up()
            advance, release = _park(eng)
            with eng:
                items += [eng.submit(_feed(seed=i)) for i in range(n)]
                if depth == 8:
                    advance(6.0)         # the oldest queued is now 6 s old
                items.append(_try_submit(eng, _feed()))
                release()
                outs = _norm(items)
        m = pkg.monitor
        extra = tuple(m.metric_value("serving_shed_total", 0.0, reason=r)
                      for r in ("queue_full", "queue_age"))
        return outs, _acct(eng), extra

    res = _compare(run)
    outs = res["torch"][0]
    assert [o[:2] for o in outs if o[0] != "ok"] == [
        ("Overloaded", "queue_full"), ("Overloaded", "queue_age")]


def test_injected_overload_and_enqueue_faults():
    def run(pkg):
        eng = _engine(pkg, max_batch=4)
        items = []
        with eng:
            with pkg.faults.fault_plan_guard("overload:1:RuntimeError"):
                items.append(_try_submit(eng, _feed()))
                items.append(_try_submit(eng, _feed(seed=1)))
            with pkg.faults.fault_plan_guard("enqueue:1:RuntimeError"):
                items.append(_try_submit(eng, _feed(seed=2)))
                items.append(_try_submit(eng, _feed(seed=3)))
            outs = _norm(items)
        return outs, _acct(eng), None

    res = _compare(run)
    outs = res["torch"][0]
    assert outs[0][:2] == ("Overloaded", "injected")
    assert outs[2][0] == "InjectedRuntimeError"
    assert res["torch"][1]["rejected_fault"] == 1


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_open_halfopen_close_cycle():
    def run(pkg):
        eng = _engine(pkg, max_batch=4, breaker_threshold=2,
                      breaker_cooldown_s=0.05)
        eng.warm_up()
        outs, states = [], []
        with eng:
            with pkg.faults.fault_plan_guard(
                    "batch_dispatch:2:RuntimeError"):
                outs += _settle_all([eng.submit(_feed(seed=i))
                                     for i in range(1)])
                outs += _settle_all([eng.submit(_feed(seed=1))])
            outs += _settle_all([eng.submit(_feed(seed=2))])    # open
            h = eng.health()
            states.append((h["status"],
                           [b["state"] for b in h["open_buckets"]]))
            time.sleep(0.15)             # past the cooldown: half-open
            outs += _settle_all([eng.submit(_feed(seed=3))])   # probe ok
            h = eng.health()
            states.append((h["status"],
                           [b["state"] for b in h["open_buckets"]]))
        return outs, _acct(eng), states

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == [
        "BatchFailed", "BatchFailed", "CircuitOpen", "ok"]
    assert res["torch"][2] == [("degraded", ["open"]), ("ok", [])]
    assert tmonitor.metric_value("serving_breaker_transitions_total", 0.0,
                                 to="closed") >= 1


def test_breaker_isolation_other_bucket_keeps_serving():
    def run(pkg):
        eng = _engine(pkg, max_batch=4, breaker_threshold=1,
                      breaker_cooldown_s=30.0)
        eng.warm_up()
        with eng:
            with pkg.faults.fault_plan_guard(
                    "batch_dispatch:1:RuntimeError"):
                outs = _settle_all([eng.submit(_feed(rows=1))])
            outs += _settle_all([eng.submit(_feed(rows=1, seed=1))])
            outs += _settle_all([eng.submit(_feed(rows=2, seed=2))])
        return outs, _acct(eng), None

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == ["BatchFailed", "CircuitOpen",
                                               "ok"]


# ---------------------------------------------------------------------------
# degradation + recovery, lifecycle
# ---------------------------------------------------------------------------

def test_degradation_sheds_priority_and_recovers():
    def run(pkg):
        eng = _engine(pkg, max_batch=4, queue_depth=3, degrade_after_s=5.0,
                      recover_after_s=5.0, degraded_min_priority=1,
                      queue_age_s=0.0)
        eng.warm_up()
        advance, release = _park(eng)
        trail = []
        with eng:
            items = [eng.submit(_feed(seed=1), priority=5),
                     eng.submit(_feed(seed=2), priority=5)]
            trail.append(eng.health()["degraded"])
            _wait_for(lambda: eng._pressure_since is not None)
            advance(6.0)
            _wait_health(eng, "degraded", True)
            trail.append(eng.health()["current_max_batch"])
            items.append(_try_submit(eng, _feed(seed=3), priority=0))
            items.append(eng.submit(_feed(seed=4), priority=3))
            release()
            outs = _norm(items)
            advance(6.0)
            _wait_health(eng, "degraded", False)
            trail.append(eng.health()["current_max_batch"])
            outs += _settle_all([eng.submit(_feed(seed=5), priority=0)])
        return outs, _acct(eng), trail

    res = _compare(run)
    assert res["torch"][2] == [False, 2, 4]
    assert res["torch"][0][2][:2] == ("Overloaded", "priority")


def test_stop_without_drain_settles_queued_typed():
    def run(pkg):
        eng = _engine(pkg, max_batch=1)
        eng.warm_up()
        _park(eng)
        eng.start()
        futs = [eng.submit(_feed(seed=i)) for i in range(2)]
        eng.stop(drain=False, timeout=WAIT)
        outs = _settle_all(futs)
        outs += _norm([_try_submit(eng, _feed())])
        return outs, _acct(eng), eng.ready()

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == ["EngineStopped"] * 3


def test_submit_before_start_and_malformed_feeds():
    def run(pkg):
        eng = _engine(pkg, max_batch=4)
        items = [_try_submit(eng, _feed())]
        errs = []
        with eng:
            for bad in ({}, {"wrong": np.zeros((1, 13), np.float32)},
                        {"x": np.zeros((99, 13), np.float32)}):
                errs.append(type(_try_submit(eng, bad)).__name__)
        return _norm(items), _acct(eng), errs

    res = _compare(run)
    assert res["torch"][2] == ["ValueError"] * 3
    assert res["torch"][1]["submitted"] == 1


def test_clean_traffic_has_a_clean_ledger():
    def run(pkg):
        eng = _engine(pkg, max_batch=4)
        eng.warm_up()
        with eng:
            outs = _settle_all([eng.submit(_feed(seed=i))
                                for i in range(12)])
        h = eng.health()
        return outs, _acct(eng), (h["open_buckets"], h["degraded"])

    res = _compare(run)
    acct = res["torch"][1]
    assert acct["completed"] == 12 and acct["pending"] == 0
    assert acct["recent_outcomes"] == ["completed"] * 12


# ---------------------------------------------------------------------------
# tenant quotas and weighted fair share
# ---------------------------------------------------------------------------

def test_parse_tenant_weights_and_config_validation():
    from paddle_tpu.serving.engine import \
        parse_tenant_weights as j_parse

    for spec in ("", "acme:3,globex:1.5", " acme : 2 ,"):
        assert parse_tenant_weights(spec) == j_parse(spec)
    for bad in ("acme", "acme:zero", "acme:0", ":-1", "acme:-2"):
        with pytest.raises(ValueError):
            parse_tenant_weights(bad)
    with pytest.raises(ValueError):
        tserving.ServingConfig(tenant_weights="oops").resolve()
    with pytest.raises(ValueError):
        tserving.ServingConfig(tenant_quota_frac=0.0).resolve()
    tfluid.set_flags({"FLAGS_serving_tenant_fair_share": 1,
                      "FLAGS_serving_tenant_weights": "acme:2",
                      "FLAGS_serving_tenant_quota_frac": 0.25})
    c = tserving.ServingConfig().resolve()
    assert (c.tenant_fair_share, c.tenant_weights,
            c.tenant_quota_frac) == (True, "acme:2", 0.25)


@pytest.mark.parametrize("weights,hot,n_ok", [("", "hog", 2),
                                              ("vip:2", "vip", 4)])
def test_tenant_quota_sheds_the_hot_tenant_only(weights, hot, n_ok):
    def run(pkg):
        eng = _engine(pkg, max_batch=1, queue_depth=8, batch_window_s=0.0,
                      tenant_fair_share=True, tenant_quota_frac=0.25,
                      tenant_weights=weights)
        eng.warm_up()
        _, release = _park(eng)
        with eng:
            items = [eng.submit(_feed(seed=i), tenant=hot)
                     for i in range(n_ok)]
            items.append(_try_submit(eng, _feed(), tenant=hot))
            items.append(eng.submit(_feed(seed=9), tenant="small"))
            release()
            outs = _norm(items)
        ten = eng.tenant_accounting()
        for t in ten.values():
            t.pop("occupancy_s")
        return outs, _acct(eng), ten

    res = _compare(run)
    outs, ten = res["torch"][0], res["torch"][2]
    assert outs[n_ok][:2] == ("Overloaded", "tenant_quota")
    assert ten[hot]["quota_sheds"] == 1 and ten[hot]["quota"] == n_ok


def test_fair_share_off_keeps_the_fifo_engine():
    def run(pkg):
        eng = _engine(pkg, max_batch=1, queue_depth=2, batch_window_s=0.0)
        eng.warm_up()
        _, release = _park(eng)
        with eng:
            items = [eng.submit(_feed(seed=i), tenant="hog")
                     for i in range(2)]
            items.append(_try_submit(eng, _feed(), tenant="hog"))
            release()
            outs = _norm(items)
        return outs, _acct(eng), eng.config.tenant_fair_share

    res = _compare(run)
    assert res["torch"][0][2][:2] == ("Overloaded", "queue_full")


def _dispatch_order(pkg, weights, groups):
    """Queue ``groups`` [(tenant, n)] behind a parked dispatcher, release
    it, and return the tenants in completion order."""
    eng = _engine(pkg, max_batch=1, queue_depth=32, batch_window_s=0.0,
                  tenant_fair_share=True, tenant_weights=weights)
    eng.warm_up()
    _, release = _park(eng)
    tenant_of = {}
    with eng:
        futs = []
        for tenant, n in groups:
            for i in range(n):
                futs.append(eng.submit(_feed(seed=i), tenant=tenant))
        release()
        outs = _settle_all(futs)
    acct = eng.accounting()
    seqs = sorted(r["seq"] for r in acct["recent_outcomes"])
    k = 0
    for tenant, n in groups:
        for s in seqs[k:k + n]:
            tenant_of[s] = tenant
        k += n
    order = [tenant_of[r["seq"]] for r in acct["recent_outcomes"]]
    return outs, _acct(eng), order


@pytest.mark.parametrize("weights,groups", [
    ("", [("hog", 6), ("small", 2)]),
    ("vip:2", [("vip", 6), ("std", 3)])])
def test_stride_scheduling_dispatch_order(weights, groups):
    res = _compare(lambda pkg: _dispatch_order(pkg, weights, groups))
    order = res["torch"][2]
    if weights:
        assert order[:6].count("vip") == 4
    else:
        assert max(i for i, t in enumerate(order) if t == "small") < \
            max(i for i, t in enumerate(order) if t == "hog")


# ---------------------------------------------------------------------------
# SLO burn (the tracker takes an injected clock)
# ---------------------------------------------------------------------------

def test_slo_tracker_multiwindow_state_machine():
    from paddle_tpu.serving.slo import SloBurnTracker as JTracker

    states = []
    for cls in (JTracker, SloBurnTracker):
        t = [1000.0]
        tr = cls({"standard": 0.5}, error_budget=0.1, fast_window_s=10.0,
                 slow_window_s=60.0, _now=lambda: t[0])
        trail = []
        for _ in range(20):
            tr.observe(1, 0.1, error=False)
        trail.append(tr.state())
        for _ in range(3):
            tr.observe(1, None, error=True)
        tr.observe(1, 0.9, error=False)
        trail.append(tr.state())
        t[0] += 15.0
        trail.append(tr.state())
        t[0] += 60.0
        trail.append(tr.state())
        states.append(trail)
    assert states[1] == states[0]
    assert [s["state"] for s in states[1]] == ["ok", "burning", "warning",
                                               "ok"]
    assert states[1][1]["classes"]["standard"]["bad"] == 4


def test_slo_state_rides_health_payload():
    got = {}
    for pkg in PKGS:
        eng = _engine(pkg)
        try:
            h = eng.health()
            got[pkg.name] = (sorted(h), h["slo"])
        finally:
            eng.stop(drain=False)
    assert got["torch"] == got["jax"]
    assert "slo" in tserving.HEALTH_SCHEMA_KEYS
    assert got["torch"][1]["state"] == "ok"
    assert set(got["torch"][1]["classes"]) == {"batch", "standard",
                                               "interactive"}


def test_refused_knobs_name_their_missing_module():
    # the fleet tier is ported: FLAGS_fleet_telemetry, the last knob the
    # port refused, is accepted now
    from paddle_tpu_torch import monitor as tmonitor

    tfluid.set_flags({"FLAGS_fleet_telemetry": 1})
    try:
        assert tmonitor.telemetry_enabled()
    finally:
        tfluid.set_flags({"FLAGS_fleet_telemetry": 0})
    assert not tmonitor.telemetry_enabled()


# ---------------------------------------------------------------------------
# poison-request bisection (the engine cases of tests/test_fleet_chaos.py)
# ---------------------------------------------------------------------------

def _poison(seed=999):
    f = _feed(seed=seed)
    f["x"][0, :5] = np.nan
    return f


def _bisect_engine(pkg, **kw):
    pkg.fluid.set_flags({"FLAGS_check_nan_inf": 1})
    kw.setdefault("bisect_depth", 3)
    eng = _engine(pkg, **kw)
    eng.warm_up()
    return eng


def _gate(eng):
    """Hold the dispatcher while ``hold[0]`` is true, so the requests
    submitted meanwhile coalesce into one batch when it is cleared."""
    hold = [True]
    orig = eng._take_batch_locked
    eng._take_batch_locked = \
        lambda now: [] if hold[0] and eng._running else orig(now)
    return hold


def _batch_of(eng, hold, feeds):
    """Submit ``feeds`` while the dispatcher is held; they go out as one
    batch. Returns their futures, settled."""
    hold[0] = True
    futs = [eng.submit(f) for f in feeds]
    hold[0] = False
    for f in futs:
        f.exception(timeout=WAIT)
    return futs


def test_poison_isolated_innocents_match_same_bucket_baselines():
    """[i1, i2, i3, poison] go out as one batch; bisection splits
    [i1,i2] | [i3,p], then [i3] | [p]. Each innocent equals its clean
    baseline at the bucket bisection re-dispatches it at (i1+i2 at bucket
    2, i3 alone at bucket 1), and the culprit settles PoisonRequest with
    the nan check's FloatingPointError as its cause."""
    def run(pkg):
        eng = _bisect_engine(pkg)
        hold = _gate(eng)
        eng.start()
        try:
            i1, i2, i3 = (_feed(seed=i) for i in range(3))
            base = [f.result(timeout=WAIT)
                    for f in _batch_of(eng, hold, [i1, i2])]
            base += [f.result(timeout=WAIT)
                     for f in _batch_of(eng, hold, [i3])]
            futs = _batch_of(eng, hold, [i1, i2, i3, _poison()])
            perr = futs[3].exception(timeout=WAIT)
            assert isinstance(perr, pkg.serving.PoisonRequest)
            assert perr.fingerprint
            assert isinstance(perr.__cause__, FloatingPointError)
            for f, b in zip(futs[:3], base):
                assert np.array_equal(f.result(timeout=WAIT)[0], b[0])
            acct = eng.accounting()
            assert acct["poisoned"] == 1 and acct["failed"] == 0
            return _settle_all(futs), _acct(eng), perr.fingerprint
        finally:
            eng.stop()

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == ["ok"] * 3 + \
        ["PoisonRequest"]


def test_quarantine_sheds_repeat_offender_typed():
    def run(pkg):
        eng = _bisect_engine(pkg, batch_window_s=0.2)
        eng.start()
        try:
            poison = _poison()
            outs = _settle_all([eng.submit(poison)])
            outs += _norm([_try_submit(eng, poison)])
            # a DIFFERENT feed is untouched by the quarantine
            outs += _settle_all([eng.submit(_feed(seed=5))])
            return outs, _acct(eng), len(eng._quarantine)
        finally:
            eng.stop()

    res = _compare(run)
    assert [o[:2] for o in res["torch"][0]] == [
        ("PoisonRequest", ""), ("Overloaded", "poison_quarantine"),
        ("ok", "")]
    assert res["torch"][1]["shed"] == 1


def test_quarantine_is_bounded():
    def run(pkg):
        eng = _bisect_engine(pkg, bisect_quarantine=2, batch_window_s=0.2)
        eng.start()
        try:
            outs = []
            for s in (101, 102, 103):
                f = _feed(seed=s)
                f["x"][0, 0] = np.nan
                outs += _settle_all([eng.submit(f)])
            return outs, _acct(eng), len(eng._quarantine)
        finally:
            eng.stop()

    res = _compare(run)
    assert res["torch"][2] == 2            # oldest evicted
    assert [o[0] for o in res["torch"][0]] == ["PoisonRequest"] * 3


def test_transient_batch_fault_absorbed_by_bisection():
    """An injected depth-0 batch failure whose re-dispatch succeeds:
    every member completes."""
    def run(pkg):
        eng = _bisect_engine(pkg)
        hold = _gate(eng)
        eng.start()
        try:
            with pkg.faults.fault_plan_guard(
                    "batch_dispatch:@1:RuntimeError"):
                futs = _batch_of(eng, hold,
                                 [_feed(seed=i) for i in range(4)])
            return _settle_all(futs), _acct(eng), None
        finally:
            eng.stop()

    res = _compare(run)
    acct = res["torch"][1]
    assert acct["failed"] == 0 and acct["poisoned"] == 0 \
        and acct["completed"] == 4


def test_bisected_poisons_do_not_open_the_bucket_breaker():
    """Distinct poison feeds round after round on one bucket: each
    bisection proves the bucket healthy (the co-batched innocent
    completes), so the bucket never reaches CircuitOpen."""
    def run(pkg):
        eng = _bisect_engine(pkg, breaker_threshold=2)
        hold = _gate(eng)
        eng.start()
        try:
            outs = []
            for j in range(4):   # 2x the threshold
                poison = _feed(seed=300 + j)
                poison["x"][0, 0] = np.nan
                outs += _settle_all(_batch_of(
                    eng, hold, [poison, _feed(seed=400 + j)]))
            states = sorted(b.state for b in eng._breakers.values())
            return outs, _acct(eng), states
        finally:
            eng.stop()

    res = _compare(run)
    assert set(res["torch"][2]) == {"closed"}
    assert res["torch"][1]["circuit_open"] == 0
    assert [o[0] for o in res["torch"][0]] == ["PoisonRequest", "ok"] * 4


def test_broken_bucket_never_quarantines_innocents():
    """When EVERY member of a batch fails there is no completed-mate
    witness: members settle BatchFailed, nothing is quarantined, and the
    same feeds complete once the bucket heals."""
    def run(pkg):
        eng = _bisect_engine(pkg)
        hold = _gate(eng)
        eng.start()
        try:
            def broken(*a, **k):
                raise RuntimeError("bucket broken (state-safe)")

            real_run = eng._exe.run
            eng._exe.run = broken
            outs = _settle_all(_batch_of(
                eng, hold, [_feed(seed=i) for i in range(2)]))
            quarantined = len(eng._quarantine)
            eng._exe.run = real_run
            outs += _settle_all(_batch_of(
                eng, hold, [_feed(seed=i) for i in range(2)]))
            return outs, _acct(eng), quarantined
        finally:
            eng.stop()

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == ["BatchFailed"] * 2 + \
        ["ok"] * 2
    assert res["torch"][2] == 0
    acct = res["torch"][1]
    assert acct["poisoned"] == 0 and acct["shed"] == 0 \
        and acct["failed"] == 2


def test_bisect_off_keeps_whole_batch_failure():
    """bisect_depth=0: a batch with a nan trip fails every member typed
    BatchFailed."""
    def run(pkg):
        pkg.fluid.set_flags({"FLAGS_check_nan_inf": 1})
        eng = _engine(pkg)
        eng.warm_up()
        hold = _gate(eng)
        eng.start()
        try:
            futs = _batch_of(eng, hold, [_feed(seed=0), _feed(seed=1),
                                         _poison()])
            return _settle_all(futs), _acct(eng), None
        finally:
            eng.stop()

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == ["BatchFailed"] * 3
    assert res["torch"][1]["failed"] == 3


def test_bisect_safety_classification():
    """Device-state-corrupting failures never bisect; the classification
    walks the cause chain. Each package's own ``DeviceLostError``
    (``resilience/elastic.py``)."""
    from paddle_tpu.resilience.distributed import \
        WatchdogTimeout as JWatchdog
    from paddle_tpu.resilience.elastic import DeviceLostError as JLost
    from paddle_tpu_torch.resilience.distributed import \
        WatchdogTimeout as TWatchdog
    from paddle_tpu_torch.resilience.elastic import DeviceLostError as TLost

    def verdicts(safe, watchdog, lost):
        wrapped = RuntimeError("batch failed")
        wrapped.__cause__ = watchdog("step", 2.0)
        return [safe(FloatingPointError("Nan found in output")),
                safe(RuntimeError("injected transient")),
                safe(watchdog("step", 2.0)), safe(lost("chip preempted")),
                safe(RuntimeError("Array has been deleted or donated")),
                safe(wrapped)]

    want = verdicts(jserving.ServingEngine._bisect_safe, JWatchdog, JLost)
    got = verdicts(tserving.ServingEngine._bisect_safe, TWatchdog, TLost)
    assert got == want == [True, True, False, False, False, False]


def test_unsafe_error_fails_whole_batch_despite_bisection(monkeypatch):
    def run(pkg):
        eng = _bisect_engine(pkg)
        monkeypatch.setattr(pkg.serving.ServingEngine, "_bisect_safe",
                            staticmethod(lambda e: False))
        hold = _gate(eng)
        eng.start()
        try:
            with pkg.faults.fault_plan_guard(
                    "batch_dispatch:@1:RuntimeError"):
                futs = _batch_of(eng, hold,
                                 [_feed(seed=i) for i in range(3)])
            return _settle_all(futs), _acct(eng), None
        finally:
            eng.stop()

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == ["BatchFailed"] * 3
    assert res["torch"][1]["failed"] == 3


def test_expired_member_settles_deadline_not_redispatch(monkeypatch):
    """A member whose deadline expired by resolution time settles typed
    DeadlineExceeded instead of riding a bisected re-dispatch."""
    def run(pkg):
        eng = _bisect_engine(pkg)
        cls = pkg.serving.ServingEngine
        real_resolve = cls._resolve_failed_batch

        def slow_resolve(self, batch, cause, depth, label, ctx=None):
            if depth == 0:
                time.sleep(0.3)   # outlive the batch's deadlines
            return real_resolve(self, batch, cause, depth, label, ctx)

        monkeypatch.setattr(cls, "_resolve_failed_batch", slow_resolve)
        hold = _gate(eng)
        eng.start()
        try:
            hold[0] = True
            futs = [eng.submit(_feed(seed=i), deadline_s=0.25)
                    for i in range(2)]
            futs.append(eng.submit(_poison(), deadline_s=0.25))
            hold[0] = False
            return _settle_all(futs), _acct(eng), None
        finally:
            eng.stop()

    res = _compare(run)
    assert [o[0] for o in res["torch"][0]] == ["DeadlineExceeded"] * 3
    assert res["torch"][1]["deadline_exceeded"] == 3
