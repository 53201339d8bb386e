"""The learning-rate schedules and the ``Variable`` operator overloads of
the port against the JAX package's on the CPU: each schedule's program
(``to_dict()``, same ``unique_name.guard()``) and its rate step by step
(float32 rtol 1e-6), the closed forms of ``tests/test_framework_misc.py``,
``clone(for_test=True)`` leaving the counter alone, a schedule driving an
optimizer, and the overloads' programs and values."""
import math

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.layers import learning_rate_scheduler as tlrs

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
STEPS = 8

# name -> (builder over a ``layers`` module, closed form of step s)
SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.1, 10, 0.5),
                    lambda s: 0.1 * 0.5 ** (s / 10)),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 * 0.5 ** (s // 3)),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 3, 0.5),
                    lambda s: 0.1 * math.exp(-0.5 * s / 3)),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 3, 0.5, True),
                     lambda s: 0.1 / (1 + 0.5 * (s // 3))),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 5, 0.01, 2.0),
                   lambda s: (0.1 - 0.01) * (1 - min(s, 5) / 5) ** 2
                   + 0.01),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 3, 0.01, 1.0, cycle=True),
        lambda s: (0.1 - 0.01) * (1 - s / (3 * max(math.ceil(s / 3), 1)))
        + 0.01),
    "piecewise": (lambda L: L.piecewise_decay([2, 4], [0.1, 0.01, 0.001]),
                  lambda s: 0.1 if s < 2 else 0.01 if s < 4 else 0.001),
    "noam": (lambda L: L.noam_decay(512, 4, learning_rate=2.0),
             lambda s: 2.0 * 512 ** -0.5 * min((s + 1) ** -0.5,
                                               (s + 1) * 4 ** -1.5)),
    "cosine": (lambda L: L.cosine_decay(0.1, 2, 10),
               lambda s: 0.5 * 0.1 * (math.cos((s // 2) * math.pi / 10)
                                      + 1)),
    "linear_warmup": (lambda L: L.linear_lr_warmup(0.1, 4, 0.0, 0.1),
                      lambda s: 0.1 * s / 4 if s < 4 else 0.1),
    # the card path's schedule: warmup over 3 steps into linear decay
    "warmup_polynomial": (
        lambda L: L.linear_lr_warmup(L.polynomial_decay(1e-3, 10, 0.0, 1.0),
                                     3, 0.0, 1e-3),
        lambda s: 1e-3 * s / 3 if s < 3 else 1e-3 * (1 - min(s, 10) / 10)),
}


def _build(pkg, builder):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            lr = builder(fl.layers)
    return main, startup, lr


def _norm(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _rates(pkg, main, startup, lr, steps=STEPS):
    fl = PKGS[pkg][0]
    exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
    exe.run(startup, scope=scope)
    return [float(np.ravel(exe.run(main, fetch_list=[lr],
                                   scope=scope)[0])[0])
            for _ in range(steps)]


def test_every_schedule_of_the_jax_package_is_ported():
    from paddle_tpu.layers import learning_rate_scheduler as jlrs

    assert tlrs.__all__ == jlrs.__all__
    assert tlrs.LR_COUNTER_NAME == jlrs.LR_COUNTER_NAME
    for name in jlrs.__all__:
        assert getattr(tfluid.layers, name) is getattr(tlrs, name)
    built = {n for b, _ in SCHEDULES.values()
             for n in jlrs.__all__ if n in b.__code__.co_names}
    assert built == set(jlrs.__all__)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_and_closed_form(name):
    builder, closed = SCHEDULES[name]
    (jm, js, jl), (tm, ts, tl) = _build("jax", builder), _build("torch",
                                                                builder)
    assert _norm(tm) == _norm(jm)
    assert _norm(ts) == _norm(js)
    inc = tm.global_block.ops[0]
    assert inc.type == "increment" and \
        inc.attrs["__op_role__"] == "lr_sched"
    got, want = _rates("torch", tm, ts, tl), _rates("jax", jm, js, jl)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, [closed(s) for s in range(STEPS)],
                               rtol=1e-5, atol=1e-7)


def test_clone_for_test_does_not_advance_the_counter():
    main, startup, lr = _build("torch", SCHEDULES["exponential"][0])
    infer = main.clone(for_test=True)
    assert all(op.type != "increment" for op in infer.global_block.ops)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    counter = tlrs.LR_COUNTER_NAME
    exe.run(main, fetch_list=[lr], scope=scope)
    assert scope.numpy(counter)[0] == 0.0
    for _ in range(3):
        v = exe.run(infer, fetch_list=[lr.name], scope=scope)[0]
    assert scope.numpy(counter)[0] == 0.0 and float(v[0]) == \
        pytest.approx(0.1)
    exe.run(main, fetch_list=[lr], scope=scope)
    assert scope.numpy(counter)[0] == 1.0


def _schedule_trained(pkg):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[4], dtype="float32")
            loss = fl.layers.mean(fl.layers.fc(x, 1))
            lr = fl.layers.exponential_decay(0.1, 5, 0.5)
            fl.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr


def test_schedule_drives_the_optimizer_as_in_the_jax_package():
    from paddle_tpu_torch.interop import scope_from_numpy

    (jm, js, jloss, jlr), (tm, ts, tloss, tlr) = (_schedule_trained("jax"),
                                                  _schedule_trained("torch"))
    assert _norm(tm) == _norm(jm)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = [v.name for v in js.global_block.vars.values()]
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy({n: jscope.numpy(n) for n in names}, tscope,
                     tfluid.CPUPlace(), programs=[tm])
    xb = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    for s in range(4):
        t = texe.run(tm, feed={"x": xb}, fetch_list=[tloss, tlr],
                     scope=tscope)
        j = jexe.run(jm, feed={"x": xb}, fetch_list=[jloss, jlr],
                     scope=jscope)
        assert float(t[1][0]) == pytest.approx(0.1 * 0.5 ** (s / 5),
                                               rel=1e-6)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def _overloads(pkg):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            a = fl.layers.data("a", shape=[3], dtype="float32")
            b = fl.layers.data("b", shape=[3], dtype="float32")
            w = fl.layers.data("w", shape=[3], dtype="float32")
            outs = [a + b, a + 2.0, 2.0 + a, a - b, a - 0.5, 0.5 - a,
                    a * b, a * 3.0, 3.0 * a, a / b, a / 4.0, 4.0 / a,
                    a ** 2.0, a ** b, -a, a @ w]
    return main, outs


def test_variable_operator_overloads_match_jax():
    (jm, jouts), (tm, touts) = _overloads("jax"), _overloads("torch")
    assert _norm(tm) == _norm(jm)
    rng = np.random.RandomState(3)
    feed = {"a": np.abs(rng.randn(2, 3)).astype(np.float32) + 0.5,
            "b": rng.randn(2, 3).astype(np.float32),
            "w": rng.randn(3, 3).astype(np.float32)}
    t = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=feed, fetch_list=[o.name for o in touts],
        scope=tfluid.Scope())
    j = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=[o.name for o in jouts],
        scope=fluid.Scope())
    for o, x, y in zip(touts, t, j):
        np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=o.name)
    np.testing.assert_allclose(t[1], feed["a"] + 2.0, rtol=1e-6)
    np.testing.assert_allclose(t[5], 0.5 - feed["a"], rtol=1e-6)
    np.testing.assert_allclose(t[11], 4.0 / feed["a"], rtol=1e-6)
    np.testing.assert_allclose(t[14], -feed["a"], rtol=1e-6)
