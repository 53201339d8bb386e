"""Every optimizer class of the port against the JAX package's on the CPU:
an MLP built the same way in both packages (same ``unique_name.guard()``)
gives the same ``to_dict()``, and 5 steps from the JAX package's initial
scope (``interop.scope_from_numpy``) leave the same parameters and
accumulators, float32 rtol 1e-5. Also: the AMP decorator over each new
optimizer, the cost model's optimizer FLOPs, ``DGCMomentumOptimizer``'s
refusal and the short aliases."""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
RTOL, ATOL = 1e-5, 1e-6
STEPS = 5

# case -> (class name, kwargs, regularization coefficient or None)
CASES = {
    "SGD": ("SGD", {"learning_rate": 0.05}, None),
    "Momentum": ("Momentum", {"learning_rate": 0.05, "momentum": 0.9,
                              "use_nesterov": True}, None),
    "LarsMomentum": ("LarsMomentum", {"learning_rate": 0.5, "momentum": 0.9,
                                      "lars_coeff": 0.01}, None),
    "Adagrad": ("Adagrad", {"learning_rate": 0.05,
                            "initial_accumulator_value": 0.1}, None),
    "DecayedAdagrad": ("DecayedAdagrad", {"learning_rate": 0.05,
                                          "decay": 0.8}, None),
    "Adam": ("Adam", {"learning_rate": 0.01}, None),
    "AdamW": ("AdamW", {"learning_rate": 0.01, "weight_decay": 0.05,
                        "epsilon": 1e-6}, None),
    "Lamb": ("Lamb", {"learning_rate": 0.01, "lamb_weight_decay": 0.02},
             None),
    "Adamax": ("Adamax", {"learning_rate": 0.01}, None),
    "Adadelta": ("Adadelta", {"learning_rate": 1.0, "rho": 0.9}, None),
    "RMSProp": ("RMSProp", {"learning_rate": 0.01, "momentum": 0.5,
                            "centered": True}, None),
    "Ftrl": ("Ftrl", {"learning_rate": 0.1, "l1": 0.01, "l2": 0.02}, None),
    "Lamb_l2decay": ("Lamb", {"learning_rate": 0.01}, 1e-3),
}


def _mlp(pkg, cls, kwargs, reg, amp=False):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[16], dtype="float32")
            y = fl.layers.data("y", shape=[1], dtype="float32")
            h = fl.layers.fc(x, 32, act="relu")
            pred = fl.layers.fc(h, 1)
            d = fl.layers.elementwise_sub(pred, y)
            loss = fl.layers.mean(fl.layers.elementwise_mul(d, d))
            kw = dict(kwargs)
            if reg is not None:
                kw["regularization"] = fl.regularizer.L2Decay(reg)
            opt = getattr(fl.optimizer, cls)(**kw)
            if amp:
                from importlib import import_module

                mp = import_module(fl.__name__ + ".contrib.mixed_precision")
                opt = mp.decorate(opt)
            opt.minimize(loss)
    return main, startup, loss


def _norm(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    d.pop("amp_policy", None)
    return d


def _train_both(cls, kwargs, reg, amp=False, steps=STEPS):
    (jm, js, jl), (tm, ts, tl) = (_mlp("jax", cls, kwargs, reg, amp),
                                  _mlp("torch", cls, kwargs, reg, amp))
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = [v.name for v in js.global_block.vars.values()]
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy({n: jscope.numpy(n) for n in names}, tscope,
                     tfluid.CPUPlace(), programs=[tm])
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.randn(8, 16).astype(np.float32),
              "y": rng.randn(8, 1).astype(np.float32)} for _ in range(steps)]
    losses = []
    for f in feeds:
        losses.append((
            texe.run(tm, feed=f, fetch_list=[tl], scope=tscope)[0],
            jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope)[0]))
    return (jm, js, jscope), (tm, ts, tscope), names, losses


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(case):
    cls, kwargs, reg = CASES[case]
    (jm, js, jscope), (tm, ts, tscope), names, losses = _train_both(
        cls, kwargs, reg)
    assert _norm(tm) == _norm(jm)
    assert _norm(ts) == _norm(js)
    update = {"SGD": "sgd", "Momentum": "momentum",
              "LarsMomentum": "lars_momentum", "Adagrad": "adagrad",
              "DecayedAdagrad": "decayed_adagrad", "Adam": "adam",
              "AdamW": "adamw", "Lamb": "lamb", "Adamax": "adamax",
              "Adadelta": "adadelta", "RMSProp": "rmsprop",
              "Ftrl": "ftrl"}[cls]
    assert [o.type for o in tm.global_block.ops].count(update) == 4
    for t, j in losses:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    state = [n for n in names if tscope.find_var(n) is not None]
    assert len(state) > 4
    for n in state:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    # the parameters moved
    assert not np.array_equal(tscope.numpy("fc_0.w_0"),
                              js_init(js, "fc_0.w_0"))


def js_init(startup, name):
    """``name`` as the JAX package's startup program initialises it."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return np.asarray(scope.numpy(name))


NEW = ["LarsMomentum", "Adagrad", "DecayedAdagrad", "AdamW", "Lamb",
       "Adamax", "Adadelta", "RMSProp", "Ftrl"]


@pytest.mark.parametrize("case", NEW)
def test_amp_decorate_wraps_each_new_optimizer(case):
    """``decorate`` over each new optimizer: the same program as the JAX
    package's, the state left float32, and with bf16 products on both
    sides the step-1 loss within bf16 rounding (rtol 1e-2) and, after 2
    steps, each state tensor within 5e-2 of the JAX package's in relative
    L2 norm. Element by element the two drift further: bf16 rounding of
    the products' operands moves a small gradient by percents, and an
    adaptive rule turns a flipped sign into a whole step."""
    cls, kwargs, reg = CASES[case]
    # a rate of 1e-3 keeps a whole adaptive step near the atol
    kwargs = dict(kwargs, learning_rate=1e-3)
    (jm, js, jscope), (tm, ts, tscope), names, losses = _train_both(
        cls, kwargs, reg, amp=True, steps=2)
    assert _norm(tm) == _norm(jm)
    assert tm._amp_policy is not None
    np.testing.assert_allclose(losses[0][0], losses[0][1], rtol=1e-2)
    assert all(np.isfinite(t).all() for t, _ in losses)
    for n in names:
        v = tscope.find_var(n)
        if v is not None and v.is_floating_point():
            assert str(v.dtype) == "torch.float32", n
            t, j = tscope.numpy(n), np.asarray(jscope.numpy(n))
            assert np.isfinite(t).all(), n
            rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-12)
            assert rel <= 5e-2, (n, rel)


def test_cost_model_counts_the_new_update_ops_as_the_jax_package():
    from paddle_tpu.analysis.cost_model import estimate_cost as jcost
    from paddle_tpu_torch.analysis.cost_model import estimate_cost as tcost

    for cls in NEW:
        cls_, kwargs, reg = CASES[cls]
        j = jcost(_mlp("jax", cls_, kwargs, reg)[0], batch_size=8)
        t = tcost(_mlp("torch", cls_, kwargs, reg)[0], batch_size=8)
        assert t.flops_optimizer == j.flops_optimizer, cls
        assert t.flops_by_op_type == j.flops_by_op_type, cls
        assert t.unknown_ops == j.unknown_ops, cls


def test_dgc_momentum_refuses():
    for fl in (fluid, tfluid):
        with pytest.raises(NotImplementedError, match="local_sgd|Momentum"):
            fl.optimizer.DGCMomentumOptimizer(
                learning_rate=0.1, momentum=0.9, rampup_begin_step=0)


def test_aliases_and_names_match_the_jax_package():
    assert sorted(tfluid.optimizer.__all__) == sorted(
        fluid.optimizer.__all__)
    for short in ("SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
                  "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl", "Lamb",
                  "LarsMomentum"):
        long = getattr(tfluid.optimizer, {
            "AdamW": "AdamWOptimizer"}.get(short, short + "Optimizer"))
        assert getattr(tfluid.optimizer, short) is long
