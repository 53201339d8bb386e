"""The averagers and Lookahead of the port against the JAX package's on
the CPU: the port's counterparts of ``tests/test_round2_fixes.py``'s
DecayedAdagrad and ModelAverage cases, ``ExponentialMovingAverage``'s
``apply``/restore and ``LookaheadOptimizer``'s sync every k steps, each
from the JAX package's initial scope, float32 rtol 1e-5."""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
RTOL, ATOL = 1e-5, 1e-6
X = np.ones((4, 2), np.float32)


def _norm(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def test_decayed_adagrad_differs_from_adagrad():
    """The decayed rule keeps every moment below the largest grad^2 (the
    bias gradient is exactly 1), where adagrad's sum would reach ~40."""
    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[2], dtype="float32")
            loss = tfluid.layers.mean(tfluid.layers.fc(x, 1, name="da_fc"))
            tfluid.optimizer.DecayedAdagrad(learning_rate=0.1,
                                            decay=0.5).minimize(loss)
    assert any(op.type == "decayed_adagrad" for op in main.global_block.ops)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(40):
        exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    m_names = [n for n in scope.vars if n.startswith("moment_")]
    assert m_names
    for n in m_names:
        assert 0.0 < scope.numpy(n).max() <= 1.0 + 1e-5, n


def _sgd_model(pkg, extra=None):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[2], dtype="float32")
            y = fl.layers.fc(x, 1, name="ma_fc", bias_attr=False)
            loss = fl.layers.mean(y)
            fl.optimizer.SGD(0.1).minimize(loss)
            made = extra(fl) if extra is not None else None
    return main, startup, loss, made


def _from_jax(jstart, tmain, jscope):
    names = [v.name for v in jstart.global_block.vars.values()]
    tscope = tfluid.Scope()
    scope_from_numpy({n: jscope.numpy(n) for n in names}, tscope,
                     tfluid.CPUPlace(), programs=[tmain])
    return tscope


def test_model_average_true_windowed_mean():
    """A window larger than the run: the applied value is the mean of the
    5 steps' parameters, as the JAX package's; the scope is restored."""
    def ma(fl):
        return fl.optimizer.ModelAverage(average_window_rate=1.0,
                                         min_average_window=100,
                                         max_average_window=100)

    (jm, js, jl, jma), (tm, ts, tl, tma) = (_sgd_model("jax", ma),
                                            _sgd_model("torch", ma))
    assert _norm(tm) == _norm(jm) and _norm(ts) == _norm(js)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    pname = tm.all_parameters()[0].name
    with fluid.scope_guard(jscope):
        jexe.run(js)
        tscope = _from_jax(js, tm, jscope)
        history = []
        for _ in range(5):
            jexe.run(jm, feed={"x": X}, fetch_list=[jl])
            texe.run(tm, feed={"x": X}, fetch_list=[tl], scope=tscope)
            history.append(tscope.numpy(pname).copy())
        final = tscope.numpy(pname).copy()
        with jma.apply(jexe), tma.apply(texe, scope=tscope):
            got = tscope.numpy(pname)
            np.testing.assert_allclose(got, np.mean(history, axis=0),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got, jscope.numpy(pname), rtol=RTOL,
                                       atol=ATOL)
            assert not np.allclose(got, final)
        np.testing.assert_array_equal(tscope.numpy(pname), final)


def test_model_average_raises_without_training():
    _, _, _, ma = _sgd_model(
        "torch", lambda fl: fl.optimizer.ModelAverage(min_average_window=1))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with pytest.raises(RuntimeError, match="never ran|not in"):
        with ma.apply(exe, scope=scope):
            pass


def test_ema_apply_and_restore_match_jax():
    """5 steps with an EMA of decay 0.5: the shadows equal the JAX
    package's, ``apply`` swaps them in, leaving restores the trained
    parameters, ``need_restore=False`` keeps the shadows."""
    def ema(fl):
        return fl.optimizer.ExponentialMovingAverage(0.5)

    (jm, js, jl, jema), (tm, ts, tl, tema) = (_sgd_model("jax", ema),
                                              _sgd_model("torch", ema))
    assert _norm(tm) == _norm(jm) and _norm(ts) == _norm(js)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    pname = tm.all_parameters()[0].name
    with fluid.scope_guard(jscope):
        jexe.run(js)
        tscope = _from_jax(js, tm, jscope)
        for _ in range(5):
            jexe.run(jm, feed={"x": X}, fetch_list=[jl])
            texe.run(tm, feed={"x": X}, fetch_list=[tl], scope=tscope)
        shadow = pname + ".ema"
        np.testing.assert_allclose(tscope.numpy(shadow),
                                   jscope.numpy(shadow), rtol=RTOL,
                                   atol=ATOL)
        final = tscope.numpy(pname).copy()
        with jema.apply(jexe), tema.apply(texe, scope=tscope):
            np.testing.assert_allclose(tscope.numpy(pname),
                                       jscope.numpy(pname), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_array_equal(tscope.numpy(pname),
                                          tscope.numpy(shadow))
        np.testing.assert_array_equal(tscope.numpy(pname), final)
        with tema.apply(texe, need_restore=False, scope=tscope):
            pass
        np.testing.assert_array_equal(tscope.numpy(pname),
                                      tscope.numpy(shadow))


def test_lookahead_syncs_every_k_steps_as_the_jax_package():
    """Lookahead(SGD, alpha 0.5, k 3) over 7 steps: slow weights move only
    at steps 3 and 6, where the fast weights restart from them; every
    persistable equals the JAX package's."""
    def build(pkg):
        fl, un = PKGS[pkg]
        with un.guard():
            main, startup = fl.Program(), fl.Program()
            with fl.program_guard(main, startup):
                x = fl.layers.data("x", shape=[2], dtype="float32")
                loss = fl.layers.mean(fl.layers.fc(x, 1, name="la_fc"))
                fl.optimizer.LookaheadOptimizer(
                    fl.optimizer.SGD(0.1), alpha=0.5, k=3).minimize(loss)
        return main, startup, loss

    (jm, js, jl), (tm, ts, tl) = build("jax"), build("torch")
    assert _norm(tm) == _norm(jm) and _norm(ts) == _norm(js)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = _from_jax(js, tm, jscope)
    pname = "la_fc.w_0"
    slow = [tscope.numpy(pname + ".slow").copy()]
    rng = np.random.RandomState(4)
    for _ in range(7):
        xb = rng.randn(4, 2).astype(np.float32)
        texe.run(tm, feed={"x": xb}, fetch_list=[tl], scope=tscope)
        jexe.run(jm, feed={"x": xb}, fetch_list=[jl], scope=jscope)
        slow.append(tscope.numpy(pname + ".slow").copy())
    moved = [not np.array_equal(a, b) for a, b in zip(slow, slow[1:])]
    assert moved == [False, False, True, False, False, True, False]
    names = [v.name for v in js.global_block.vars.values()]
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
