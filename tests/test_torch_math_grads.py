"""The gradient of every op of ``ops/math.py`` that has one, and of
``where``, through ``calc_gradient`` in both packages on the CPU: the
port's generic ``<type>_grad`` (autograd over its rule) against the JAX
package's (``jax.vjp`` over its rule), with a random cotangent. Both
sides compute in float32: rtol 1e-5 / atol 1e-6. Inputs keep clear of the
kinks of the piecewise ops (clip edges, thresholds, 0), where the two
sides may pick different one-sided derivatives."""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
RTOL, ATOL = 1e-5, 1e-6
SHAPE = (3, 4)


def _x(lo=-2.0, hi=2.0, kinks=(), shape=SHAPE, seed=0):
    """Uniform in [lo, hi), nudged 0.05 away from each kink."""
    v = np.random.RandomState(seed).uniform(lo, hi, shape)
    for k in kinks:
        near = np.abs(v - k) < 0.05
        v[near] = k + np.where(v[near] >= k, 0.05, -0.05)
    return v.astype(np.float32)


# op -> (inputs {slot: array}, attrs). Float inputs are differentiated.
UNARY = {
    "sigmoid": (_x(), {}), "exp": (_x(), {}), "log": (_x(0.2, 3.0), {}),
    "square": (_x(), {}), "rsqrt": (_x(0.2, 3.0), {}),
    "reciprocal": (_x(0.2, 3.0), {}), "softplus": (_x(-4, 4), {}),
    "softsign": (_x(kinks=(0,)), {}), "sin": (_x(), {}), "cos": (_x(), {}),
    "logsigmoid": (_x(-4, 4), {}), "erf": (_x(), {}),
    "tan": (_x(-1.0, 1.0), {}), "asin": (_x(-0.9, 0.9), {}),
    "acos": (_x(-0.9, 0.9), {}), "atan": (_x(), {}), "sinh": (_x(), {}),
    "cosh": (_x(), {}), "log1p": (_x(0.2, 3.0), {}), "expm1": (_x(), {}),
    "log2": (_x(0.2, 3.0), {}), "log10": (_x(0.2, 3.0), {}),
    "silu": (_x(-3, 3), {}), "mish": (_x(-3, 3), {}),
    "selu": (_x(kinks=(0,)), {}),
    "stanh": (_x(), {"scale_a": 0.5, "scale_b": 2.0}),
    "brelu": (_x(-3, 3, kinks=(-1.0, 2.0)), {"t_min": -1.0, "t_max": 2.0}),
    "hard_shrink": (_x(kinks=(-0.3, 0.3)), {"threshold": 0.3}),
    "softshrink": (_x(kinks=(-0.3, 0.3)), {"lambda": 0.3}),
    "thresholded_relu": (_x(kinks=(0.5,)), {"threshold": 0.5}),
    "maxout": (_x(shape=(2, 6, 3, 3)), {"groups": 3, "axis": 1}),
    "leaky_relu": (_x(kinks=(0,)), {"alpha": 0.1}),
    "relu6": (_x(-2, 8, kinks=(0, 6)), {}),
    "elu": (_x(kinks=(0,)), {"alpha": 0.7}),
    "hard_sigmoid": (_x(-4, 4, kinks=(-2.5, 2.5)), {}),
    "swish": (_x(), {"beta": 1.5}),
    "hard_swish": (_x(-5, 5, kinks=(-3, 3)), {}),
    "pow": (_x(0.2, 3.0), {"factor": 2.5}),
    "log_softmax": (_x(-3, 3, shape=(3, 5)), {"axis": -1}),
}
BINARY = {
    "elementwise_pow": ({"X": _x(0.2, 3.0), "Y": _x(seed=1)}, {}),
    "elementwise_mod": ({"X": _x(-5, 5), "Y": _x(1.5, 3.0, seed=1)}, {}),
    "elementwise_floordiv": ({"X": _x(-5, 5), "Y": _x(1.5, 3.0, seed=1)},
                             {}),
    "where": ({"Condition": _x(seed=2) > 0, "X": _x(), "Y": _x(seed=1)},
              {}),
}
CASES = {op: ({"X": xv}, attrs) for op, (xv, attrs) in UNARY.items()}
CASES.update(BINARY)


def _program(pkg, op_type, ins, attrs):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            blk = main.global_block
            vars_ = {}
            for slot, a in ins.items():
                v = fl.layers.data(slot.lower(), shape=list(a.shape[1:]),
                                   dtype=str(a.dtype))
                v.stop_gradient = a.dtype != np.float32
                vars_[slot] = v
            out = blk.create_var(name="out", dtype="float32")
            blk.append_op(op_type, inputs=vars_, outputs={"Out": out},
                          attrs=dict(attrs))
            w = fl.layers.data("w", shape=[-1], dtype="float32")
            loss = fl.layers.reduce_sum(fl.layers.elementwise_mul(out, w))
            diff = [v for v in vars_.values() if not v.stop_gradient]
            grads = fl.gradients([loss], diff)
    return main, out, grads


def _norm(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def test_every_differentiable_math_op_has_a_case():
    """Every op of the JAX package's ops/math.py with a gradient (and
    ``where``) is covered; the ones without keep none in the port too."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    math_ops = {t for t, d in jreg._OP_REGISTRY.items()
                if d.lower is not None and d.lower.__module__ in (
                    "paddle_tpu.ops.math", "paddle_tpu.ops.common")}
    new = math_ops - {"relu", "tanh", "sqrt", "abs", "gelu", "softmax",
                      "elementwise_add", "elementwise_sub",
                      "elementwise_mul", "elementwise_div",
                      "elementwise_min", "elementwise_max", "scale",
                      "sum", "cast", "clip", "clip_by_norm",
                      "squared_l2_norm"}
    with_grad = {t for t in new if jreg.get_op_def(t).grad is not None}
    assert with_grad | {"where"} == set(CASES)
    for t in new:
        assert (treg.get_op_def(t).grad is None) == \
            (jreg.get_op_def(t).grad is None), t


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_math_op_grad_matches_jax(op_type):
    ins, attrs = CASES[op_type]
    got, dicts = {}, {}
    for pkg in PKGS:
        fl = PKGS[pkg][0]
        main, out, grads = _program(pkg, op_type, ins, attrs)
        feed = {slot.lower(): a for slot, a in ins.items()}
        out_shape = fl.Executor(fl.CPUPlace()).run(
            main, feed=dict(feed, w=np.zeros(1, np.float32)),
            fetch_list=[out.name], scope=fl.Scope())[0].shape
        feed["w"] = np.random.RandomState(5).randn(
            *out_shape).astype(np.float32)
        got[pkg] = [np.asarray(a) for a in fl.Executor(fl.CPUPlace()).run(
            main, feed=feed, fetch_list=[out.name] + [g.name for g in grads],
            scope=fl.Scope())]
        dicts[pkg] = _norm(main)
    assert dicts["torch"] == dicts["jax"]
    assert len(got["torch"]) == len(got["jax"]) >= 2
    for a, b in zip(got["torch"], got["jax"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
