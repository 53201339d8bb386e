"""The PyTorch port's FLAGS_check_nan_inf protocol, FLAGS_nan_inf_policy
rollback and the numerics witness, against the JAX package on the CPU.

Each scenario builds the same program in both packages (one shared build
function under ``unique_name.guard()``, so op names and build sites are
equal), carries the JAX package's initial weights across, and runs the
same feeds. Compared exactly: the error messages and labels, the nan-check
labels of a whole step, the skip counter, ``first_offender`` and the set
of witnessed vars; the scope after a tripped step is compared bit for bit
with its pre-step image. Witness ranges are compared at f32 rtol 1e-5 /
atol 1e-6 (two packages' float32 products)."""
import logging

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import monitor as jmonitor
from paddle_tpu.monitor import numwitness as jnw

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.monitor import numwitness as tnw

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _reset():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import clip as tclip
    from paddle_tpu_torch import flags as tflags

    snaps = [(m, dict(m._overrides)) for m in (jflags, tflags)]
    tclip._clip_attr["__global__"] = None
    jnw.reset_numerics_witness()
    tnw.reset_numerics_witness()
    # the incident logs are bounded rings (32): ones left by earlier tests
    # in this process would push this file's incidents' count off
    jfluid.trace.clear_incidents()
    tfluid.trace.clear_incidents()
    yield
    for m, snap in snaps:
        m._overrides.clear()
        m._overrides.update(snap)
    tclip._clip_attr["__global__"] = None
    jnw.reset_numerics_witness()
    tnw.reset_numerics_witness()


class Pkg:
    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.fluid = jfluid if jax_side else tfluid
        self.un = jun if jax_side else tun
        self.monitor = jmonitor if jax_side else tmonitor
        self.nw = jnw if jax_side else tnw


JAX, TORCH = Pkg("jax"), Pkg("torch")
PKGS = (JAX, TORCH)


def _regression(fl, optimizer=None):
    x = fl.layers.data("x", shape=[4], dtype="float32")
    y = fl.layers.data("y", shape=[1], dtype="float32")
    pred = fl.layers.fc(x, 1)
    d = fl.layers.elementwise_sub(pred, y)
    loss = fl.layers.mean(fl.layers.elementwise_mul(d, d))
    (optimizer or fl.optimizer.SGD(learning_rate=0.1)).minimize(loss)
    return loss


def _feed(batch=8, nan=False):
    rng = np.random.RandomState(0)
    x = rng.rand(batch, 4).astype(np.float32)
    if nan:
        x = np.full_like(x, np.nan)
    return {"x": x, "y": rng.rand(batch, 1).astype(np.float32)}


class Session:
    """One package's program, executor and scope, the scope holding the
    JAX package's initial weights."""

    _init = {}

    def __init__(self, pkg, build=_regression):
        fl = pkg.fluid
        self.pkg = pkg
        with pkg.un.guard():
            self.main, self.startup = fl.Program(), fl.Program()
            with fl.program_guard(self.main, self.startup):
                self.loss = build(fl)
        self.exe = fl.Executor(fl.CPUPlace())
        key = build.__name__
        if key not in Session._init:
            with jun.guard():
                jm, js = jfluid.Program(), jfluid.Program()
                with jfluid.program_guard(jm, js):
                    build(jfluid)
            jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), \
                jfluid.Scope()
            jexe.run(js, scope=jscope)
            Session._init[key] = {n: np.asarray(jscope.find_var(n))
                                  for n in jscope.vars}
        init = Session._init[key]
        if pkg.name == "jax":
            self.scope = fl.Scope()
            for n, a in init.items():
                self.scope.set_var(n, a)
        else:
            self.scope = scope_from_numpy(init, fl.Scope(), fl.CPUPlace())

    def run(self, feed, fetch=None):
        return self.exe.run(self.main, feed=feed,
                            fetch_list=fetch or [self.loss],
                            scope=self.scope)

    def chained(self, feed, steps):
        return self.exe.run_chained(self.main, feed=feed,
                                    fetch_list=[self.loss], steps=steps,
                                    scope=self.scope)

    def image(self):
        return {n: np.array(self.scope.numpy(n) if self.pkg.name == "torch"
                            else np.asarray(self.scope.find_var(n)))
                for n in self.scope.vars}


def _same(a, b):
    return set(a) == set(b) and all(
        np.array_equal(a[n], b[n], equal_nan=True) for n in a)


def _skips(pkg, path, policy):
    return pkg.monitor.metric_value("steps_skipped_nonfinite_total",
                                    default=0.0, path=path, policy=policy)


def _set(pkg, **flags):
    pkg.fluid.set_flags({f"FLAGS_{k}": v for k, v in flags.items()})


# ---------------------------------------------------------------------------
# the check protocol and the policies
# ---------------------------------------------------------------------------

def test_raise_names_the_op_and_restores_the_scope():
    msgs = {}
    for pkg in PKGS:
        s = Session(pkg)
        s.run(_feed())
        _set(pkg, check_nan_inf=1)
        before = s.image()
        with pytest.raises(FloatingPointError) as ei:
            s.run(_feed(nan=True))
        msgs[pkg.name] = str(ei.value)
        assert _same(before, s.image())
        # the session still trains
        s.run(_feed())
        assert not _same(before, s.image())
    assert msgs["torch"] == msgs["jax"]
    assert "op 'mul' output 'fc_0.tmp_0'" in msgs["torch"]
    assert "scope restored to pre-step values" in msgs["torch"]


@pytest.mark.parametrize("path", ["run", "chained"])
def test_skip_drops_the_step_bit_exactly(path):
    """Policy skip on both paths: the step is dropped, every persistable
    keeps its pre-step bits, the counter counts it once, and a clean
    step afterwards trains."""
    got = {}
    for pkg in PKGS:
        s = Session(pkg)
        s.run(_feed())
        _set(pkg, check_nan_inf=1, nan_inf_policy="skip")
        before = s.image()
        n0 = _skips(pkg, path, "skip")
        if path == "run":
            out = s.run(_feed(nan=True))
            assert not np.isfinite(np.asarray(out[0])).all()
        else:
            out = s.chained(_feed(nan=True), 3)
            assert np.asarray(out[0]).shape[0] == 3
        assert _same(before, s.image())
        assert _skips(pkg, path, "skip") == n0 + 1
        s.run(_feed())
        assert not _same(before, s.image())
        got[pkg.name] = s.image()
    for n, v in got["jax"].items():
        np.testing.assert_allclose(got["torch"][n], v, rtol=RTOL,
                                   atol=ATOL)


def test_chained_raise_message_matches():
    msgs = {}
    for pkg in PKGS:
        s = Session(pkg)
        _set(pkg, check_nan_inf=1)
        before = s.image()
        with pytest.raises(FloatingPointError) as ei:
            s.chained(_feed(nan=True), 2)
        msgs[pkg.name] = str(ei.value)
        assert _same(before, s.image())
    assert msgs["torch"] == msgs["jax"]
    assert "after 2 scanned iteration(s)" in msgs["torch"]


def test_skip_escalates_after_consecutive_trips():
    msgs = {}
    for pkg in PKGS:
        s = Session(pkg)
        s.run(_feed())
        _set(pkg, check_nan_inf=1, nan_inf_policy="skip",
             nan_inf_max_consecutive_skips=2)
        before = s.image()
        s.run(_feed(nan=True))                  # skip #1
        with pytest.raises(FloatingPointError, match="escalated") as ei:
            s.run(_feed(nan=True))              # skip #2 == limit
        msgs[pkg.name] = str(ei.value)
        assert _same(before, s.image())
        s.run(_feed())                          # resets the counter
        s.run(_feed(nan=True))                  # skip, no raise
    assert msgs["torch"] == msgs["jax"]


def test_zero_grad_never_escalates():
    for pkg in PKGS:
        s = Session(pkg)
        s.run(_feed())
        _set(pkg, check_nan_inf=1, nan_inf_policy="zero_grad",
             nan_inf_max_consecutive_skips=1)
        before = s.image()
        n0 = _skips(pkg, "run", "zero_grad")
        for _ in range(3):
            s.run(_feed(nan=True))
        assert _same(before, s.image())
        assert _skips(pkg, "run", "zero_grad") == n0 + 3


def test_unknown_policy_is_rejected_before_the_step():
    msgs = {}
    for pkg in PKGS:
        s = Session(pkg)
        _set(pkg, check_nan_inf=1, nan_inf_policy="shrug")
        before = s.image()
        with pytest.raises(ValueError, match="nan_inf_policy") as ei:
            s.run(_feed())
        msgs[pkg.name] = str(ei.value)
        assert _same(before, s.image())
    assert msgs["torch"] == msgs["jax"]


def _step_labels(pkg, s, feed):
    """The nan-check labels of one step, in order."""
    if pkg.name == "jax":
        s.run(feed)
        (step,) = [st for st in s.exe._cache.values()
                   if st.nan_check_meta is not None]
        return list(step.nan_check_meta)
    seen = []
    real = s.exe._check_step

    def capture(checks, scope, rollback, path):
        seen.append([label for label, _ in checks])
        return real(checks, scope, rollback, path)

    s.exe._check_step = capture
    s.run(feed)
    return seen[-1]


def _recompute(fl):
    x = fl.layers.data("x", shape=[4], dtype="float32")
    y = fl.layers.data("y", shape=[1], dtype="float32")
    h = fl.layers.fc(x, 8, act="relu")
    pred = fl.layers.fc(h, 1)
    d = fl.layers.elementwise_sub(pred, y)
    loss = fl.layers.mean(fl.layers.elementwise_mul(d, d))
    opt = fl.optimizer.RecomputeOptimizer(fl.optimizer.SGD(0.1))
    opt._set_checkpoints([h])
    opt.minimize(loss)
    return loss


@pytest.mark.parametrize("build", [_regression, _recompute],
                         ids=["plain", "recompute"])
def test_step_labels_equal_the_jax_package(build):
    """One label per float op output, letter for letter, in program
    order; a recompute segment's replay appends none (the segment's own
    outputs are checked at the outer level)."""
    labels = {}
    for pkg in PKGS:
        s = Session(pkg, build)
        _set(pkg, check_nan_inf=1)
        labels[pkg.name] = _step_labels(pkg, s, _feed())
    assert labels["torch"] == labels["jax"]
    assert labels["torch"]


def test_check_off_runs_no_check():
    """Flag off (the default): no check runs and a nan step goes
    through."""
    s = Session(TORCH)
    calls = []
    real = torch.aminmax

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    torch.aminmax = counting
    try:
        (v,) = s.run(_feed(nan=True))
        assert not calls and np.isnan(v).all()
        _set(TORCH, check_nan_inf=1, nan_inf_policy="zero_grad")
        s.run(_feed(nan=True))
        assert calls
    finally:
        torch.aminmax = real


def test_in_place_state_is_restored_bit_exactly():
    """A KV cache written in place by kv_cache_append: the rollback image
    clones it, so a tripped step leaves the cache's bits as they were."""
    fl = tfluid
    with tun.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            cache = main.global_block.create_var(
                name="cache_k", shape=(2, 1, 8, 4), dtype="float32",
                persistable=True, stop_gradient=True)
            new = fl.layers.data("new", shape=[1, 2, 4], dtype="float32")
            pos = fl.layers.data("pos", shape=[1], dtype="int64")
            out = fl.layers.kv_cache_append(cache, new, pos)
            loss = fl.layers.mean(out)
    exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
    rng = np.random.RandomState(0)
    scope.set_var("cache_k", torch.from_numpy(
        rng.rand(2, 1, 8, 4).astype(np.float32)))
    before = scope.numpy("cache_k").copy()
    bad = {"new": np.full((2, 1, 2, 4), np.nan, np.float32),
           "pos": np.zeros((2, 1), np.int64)}
    fl.set_flags({"FLAGS_check_nan_inf": 1})
    with pytest.raises(FloatingPointError, match="kv_cache_append"):
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    assert np.array_equal(scope.numpy("cache_k"), before)
    good = dict(bad, new=rng.rand(2, 1, 2, 4).astype(np.float32))
    exe.run(main, feed=good, fetch_list=[loss], scope=scope)
    assert not np.array_equal(scope.numpy("cache_k"), before)


# ---------------------------------------------------------------------------
# the numerics witness
# ---------------------------------------------------------------------------

def _bounded(fl):
    x = fl.layers.data("x", shape=[8], dtype="float32")
    h = fl.layers.fc(x, 8, act="relu")
    return fl.layers.mean(fl.layers.scale(h, scale=2.0))


def _nan_net(fl):
    """The first non-finite producer in program order is the sqrt of a
    negative constant."""
    c = fl.layers.fill_constant(shape=[4], dtype="float32", value=-1.0)
    bad = fl.layers.sqrt(c)
    x = fl.layers.data("x", shape=[4], dtype="float32")
    return fl.layers.mean(fl.layers.elementwise_add(x, bad))


def test_witness_store_equals_the_jax_package():
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(4, 8).astype(np.float32)} for _ in range(2)]
    got = {}
    for pkg in PKGS:
        s = Session(pkg, _bounded)
        _set(pkg, numerics_witness=1)
        for f in feeds:
            s.run(f)
        got[pkg.name] = pkg.nw.numerics_witness_vars()
        rep = pkg.nw.numerics_witness_report()
        assert rep["enabled"] and rep["nonfinite_total"] == 0
        assert pkg.nw.first_offender() is None
    assert set(got["torch"]) == set(got["jax"]) and got["torch"]
    for n, j in got["jax"].items():
        t = got["torch"][n]
        assert (t["nonfinite"], t["steps"]) == (j["nonfinite"], j["steps"])
        for k in ("absmax", "min", "max"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, atol=ATOL)


def test_witness_off_records_nothing_and_flips_are_compile_events():
    s = Session(TORCH, _bounded)
    feed = {"x": np.zeros((4, 8), np.float32)}
    s.run(feed)
    assert tnw.numerics_witness_vars() == {}
    _set(TORCH, numerics_witness=1)
    s.run(feed)
    assert tnw.numerics_witness_vars()
    flags = [dict(k[-1]) for k in s.exe._cache]
    assert sorted(f["numerics_witness"] for f in flags) == [False, True]
    events = [e for e in tmonitor.recompile_events(recompiles_only=False)
              if e.program_serial == s.main._serial]
    assert len(events) == 2 and events[1].recompile
    assert events[1].changed == ("flags",)


def test_escalation_names_the_first_offender(caplog):
    msgs, incidents = {}, {}
    for pkg in PKGS:
        s = Session(pkg, _nan_net)
        _set(pkg, numerics_witness=1, check_nan_inf=1,
             nan_inf_policy="skip", nan_inf_max_consecutive_skips=2)
        n0 = len([i for i in pkg.fluid.trace.incidents()
                  if i.get("kind") == "nonfinite_step"])
        feed = {"x": np.zeros((1, 4), np.float32)}
        with caplog.at_level(logging.WARNING):
            s.run(feed)                                  # skip #1
            with pytest.raises(FloatingPointError) as ei:
                s.run(feed)                              # escalates
        msgs[pkg.name] = str(ei.value)
        assert pkg.nw.first_offender() == "sqrt_0.tmp_0"
        inc = [i for i in pkg.fluid.trace.incidents()
               if i.get("kind") == "nonfinite_step"]
        assert len(inc) == n0 + 2
        incidents[pkg.name] = [i.get("detail") for i in inc[-2:]]
    assert msgs["torch"] == msgs["jax"]
    assert "first non-finite var this step was 'sqrt_0.tmp_0'" \
        in msgs["torch"]
    assert incidents["torch"] == incidents["jax"]


def test_attribution_is_empty_without_the_witness():
    from paddle_tpu_torch.resilience.nonfinite import witness_attribution

    s = Session(TORCH, _nan_net)
    _set(TORCH, check_nan_inf=1, nan_inf_policy="skip",
         nan_inf_max_consecutive_skips=0)
    s.run({"x": np.zeros((1, 4), np.float32)})
    assert witness_attribution() == ""


def test_containment_violations_equal_the_jax_package():
    observed = {"a": {"absmax": 2.0, "min": -2.0, "max": 1.5,
                      "nonfinite": 0, "steps": 1},
                "b": {"absmax": 0.0, "min": None, "max": None,
                      "nonfinite": 4, "steps": 1},
                "c": {"absmax": 3.0, "min": 0.0, "max": 3.0,
                      "nonfinite": 0, "steps": 1}}
    static = {"a": (-1.0, 1.0), "b": (0.0, 1.0), "c": (0.0, 3.0),
              "d": (0.0, 1.0)}
    got = tnw.containment_violations(static, observed)
    assert got == jnw.containment_violations(static, observed)
    assert [(v["var"], v["bound"]) for v in got] == [("a", "lo"),
                                                     ("a", "hi")]
    for pkg in PKGS:
        pkg.nw.record_step(["a", "b", "c"], [[1, 0, 1, 0], [0, 0, 0, 2],
                                             [0, 0, 0, 0]])
    assert tnw.first_offender() == jnw.first_offender() == "b"
    assert tnw.numerics_witness_vars() == jnw.numerics_witness_vars()
