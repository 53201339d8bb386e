"""The PyTorch port's MLP train step against the JAX package's, on the CPU.

``models.mlp.build_mnist_mlp`` (fc layers with relu, softmax
cross-entropy, top-1 accuracy) with SGD and with Adam: the same program
in both packages (``to_dict()``), and from the JAX package's initial
scope (carried with ``interop.scope_from_numpy``) the same losses,
accuracies and parameters over ten steps of a synthetic separable task.
Tolerances: float32 with different summation orders, rtol 1e-4 on the
losses and rtol 1e-4 on the parameters with atol 1e-5 after SGD and
1e-4 after Adam (Adam's step m / sqrt(v) does not scale with the
gradient, so where a gradient is near zero a summation-order difference
can move a weight by up to 1 % of the learning rate 0.01); accuracies
are counts over 64 rows and must be equal. The ops alone: ``top_k`` and
``accuracy`` equal the JAX package's; ``uniform_random``,
``gaussian_random`` and the ``Xavier`` default draw from torch
generators, so they are checked by bounds, moments and determinism, not
bits (``ROADMAP.md``, differences by design).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.core import registry as jregistry
from paddle_tpu.models.mlp import build_mnist_mlp as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.lowering import LowerCtx
from paddle_tpu_torch.models.mlp import build_mnist_mlp as t_build

HIDDEN = (64, 32)
STEPS, BATCH = 10, 64


def _normalized(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _nets(optimizer):
    kw = dict(hidden=HIDDEN, lr=0.1 if optimizer == "sgd" else 0.01,
              optimizer=optimizer)
    with jun.guard():
        j = j_build(**kw)
    with tun.guard():
        t = t_build(**kw)
    return j, t


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    proj = rng.randn(784, 10).astype(np.float32)
    out = []
    for _ in range(STEPS):
        xb = rng.randn(BATCH, 784).astype(np.float32)
        yb = np.argmax(xb @ proj, axis=1).astype(np.int64)[:, None]
        out.append({"img": xb, "label": yb})
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("which", ["main", "startup"])
def test_program_dicts_match_jax(which, optimizer):
    j, t = _nets(optimizer)
    assert _normalized(t[which]) == _normalized(j[which])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_steps_match_jax(optimizer):
    j, t = _nets(optimizer)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    names = [v.name for v in j["startup"].global_block.vars.values()]
    state = {n: jscope.numpy(n) for n in names}
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace(),
                              programs=[t["main"]])
    losses = []
    for step, feed in enumerate(_batches()):
        jl, ja = jexe.run(j["main"], feed=feed,
                          fetch_list=[j["loss"], j["acc"]], scope=jscope)
        tl, ta = texe.run(t["main"], feed=feed,
                          fetch_list=[t["loss"], t["acc"]], scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_array_equal(ta, ja, err_msg=f"step {step}")
        losses.append(float(np.ravel(tl)[0]))
    assert losses[-1] < losses[0] * 0.8, losses
    atol = 1e-5 if optimizer == "sgd" else 1e-4
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   atol=atol, rtol=1e-4, err_msg=n)


# -- the ops alone -------------------------------------------------------------

def _run_rule(registry, op_type, ins, attrs, ctx):
    opdef = registry.get_op_def(op_type)
    full = {k: v.default for k, v in opdef.attrs.items()}
    full.update(attrs)
    return opdef.lower(ctx, ins, full)


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_and_accuracy_match_jax(k):
    rng = np.random.RandomState(k)
    scores = rng.randn(50, 10).astype(np.float32)
    label = rng.randint(0, 10, (50, 1)).astype(np.int64)
    jout = _run_rule(jregistry, "top_k", {"X": [scores]}, {"k": k}, None)
    tout = _run_rule(tregistry, "top_k", {"X": [torch.from_numpy(scores)]},
                     {"k": k}, LowerCtx("cpu"))
    np.testing.assert_array_equal(tout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))
    np.testing.assert_array_equal(tout["Indices"][0].numpy(),
                                  np.asarray(jout["Indices"][0]))
    jacc = _run_rule(jregistry, "accuracy", {
        "Out": jout["Out"], "Indices": jout["Indices"], "Label": [label]},
        {}, None)
    tacc = _run_rule(tregistry, "accuracy", {
        "Out": tout["Out"], "Indices": tout["Indices"],
        "Label": [torch.from_numpy(label)]}, {}, LowerCtx("cpu"))
    for slot in ("Accuracy", "Correct", "Total"):
        np.testing.assert_array_equal(tacc[slot][0].numpy(),
                                      np.asarray(jacc[slot][0]), slot)
    assert tacc["Correct"][0].dtype == torch.int32


def _draw(op_type, attrs, seed=0, uid=1):
    ctx = LowerCtx("cpu", seed=seed, uid=uid)
    return _run_rule(tregistry, op_type, {}, attrs, ctx)["Out"][0]


def test_uniform_random_bounds_moments_and_determinism():
    attrs = {"shape": [256, 512], "min": -0.3, "max": 0.7}
    a = _draw("uniform_random", attrs)
    assert a.dtype == torch.float32 and tuple(a.shape) == (256, 512)
    assert float(a.min()) >= -0.3 and float(a.max()) < 0.7
    # U(a, b): mean (a+b)/2, variance (b-a)^2/12; 131072 draws
    assert abs(float(a.mean()) - 0.2) < 0.005
    assert abs(float(a.var()) - 1.0 / 12) < 0.002
    assert torch.equal(a, _draw("uniform_random", attrs))
    assert not torch.equal(a, _draw("uniform_random", attrs, uid=2))
    seeded = dict(attrs, seed=5)
    assert torch.equal(_draw("uniform_random", seeded, uid=1),
                       _draw("uniform_random", seeded, uid=2))


def test_gaussian_random_moments_and_determinism():
    attrs = {"shape": [256, 512], "mean": 1.5, "std": 0.25}
    a = _draw("gaussian_random", attrs)
    assert abs(float(a.mean()) - 1.5) < 0.005
    assert abs(float(a.std()) - 0.25) < 0.005
    assert torch.equal(a, _draw("gaussian_random", attrs))


@pytest.mark.parametrize("uniform", [True, False])
def test_xavier_is_the_default_weight_initializer(uniform):
    """fc with no initializer named gets Xavier (uniform by default), as in
    the JAX package: the same startup op and attrs; the drawn weights keep
    within the Glorot limit (uniform) or have its standard deviation."""
    fan_in, fan_out = 300, 200
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[fan_in])
        attr = None if uniform else tfluid.ParamAttr(
            initializer=tfluid.Xavier(uniform=False))
        tfluid.layers.fc(x, fan_out, param_attr=attr)
    w_op = startup.global_block.ops[0]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    if uniform:
        assert w_op.type == "uniform_random"
        assert (w_op.attrs["min"], w_op.attrs["max"]) == (-limit, limit)
    else:
        assert w_op.type == "gaussian_random"
        assert w_op.attrs["std"] == math.sqrt(2.0 / (fan_in + fan_out))
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        jx = fluid.layers.data("x", shape=[fan_in])
        jattr = None if uniform else fluid.ParamAttr(
            initializer=fluid.initializer.Xavier(uniform=False))
        fluid.layers.fc(jx, fan_out, param_attr=jattr)
        j_op = fluid.default_startup_program().global_block.ops[0]
    assert j_op.type == w_op.type
    assert {k: v for k, v in j_op.attrs.items() if not k.startswith("__")
            and k != "op_callstack"} == {
        k: v for k, v in w_op.attrs.items() if not k.startswith("__")
        and k != "op_callstack"}
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    startup.random_seed = 11
    exe.run(startup, scope=scope)
    w = scope.find_var(w_op.output("Out")[0])
    assert tuple(w.shape) == (fan_in, fan_out)
    if uniform:
        assert float(w.abs().max()) <= limit
        assert abs(float(w.std()) - limit / math.sqrt(3)) < 0.003
    else:
        assert abs(float(w.std()) - math.sqrt(2.0 / (fan_in + fan_out))) \
            < 0.003
    again = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=again)
    assert torch.equal(w, again.find_var(w_op.output("Out")[0]))
