"""The PyTorch port's conv-net ops against the JAX package's, on the CPU.

Each op rule of the port is held against the JAX package's rule on the
same inputs (numpy, fixed seed): ``conv2d``/``depthwise_conv2d``,
``pool2d`` (every attribute), ``batch_norm`` (training, ``is_test``,
``use_global_stats``; NCHW and NHWC) forward and gradient (the port's
generic grad against ``jax.vjp`` through the JAX rule), the running-stat
update and ``SavedVariance`` against the reference's formulas, the
``momentum`` update (plain, Nesterov, ``l2_decay``), ``L1Decay`` and
``L2Decay`` through Momentum and SGD on an MLP, and
``FLAGS_conv_use_nhwc=always`` against ``never``.

Tolerances: float32 on both sides, differing in summation order only:
atol 1e-5 / rtol 1e-4 on outputs and gradients (the JAX package's own
layout test uses 1e-5 / 1e-5 on a forward), rtol 1e-6 on the
running-stat and ``SavedVariance`` formulas (elementwise on per-channel
vectors), rtol 1e-4 on MLP losses and atol 1e-5 / rtol 1e-4 on its
parameters.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy
from tests.test_torch_train import _jax_grads, _out_shapes, _port_grads

RNG = np.random.RandomState(7)
ATOL, RTOL = 1e-5, 1e-4


def f32(*shape, lo=None):
    a = RNG.randn(*shape).astype(np.float32)
    return a if lo is None else np.abs(a) + lo


@pytest.fixture(autouse=True)
def _flag_reset():
    prev = tfluid.get_flags(["FLAGS_conv_use_nhwc"])
    yield
    tfluid.set_flags(prev)


def _check(op_type, ins, attrs, ct_slots=("Out",), fetch_extra=()):
    """Forward outputs of ``ct_slots`` + ``fetch_extra`` and the gradients
    of every float input, port against the JAX package."""
    ct_slots = list(ct_slots)
    _, _, outs = _out_shapes(op_type, ins, attrs)
    cts = [RNG.randn(*np.shape(outs[s][0])).astype(np.float32)
           for s in ct_slots]
    want = _jax_grads(op_type, ins, attrs, ct_slots, cts)
    fetch = [f"out_{s}" for s in ct_slots + list(fetch_extra)]
    got, fwd = _port_grads(op_type, ins, attrs, ct_slots, cts,
                           fetch_extra=fetch)
    for name, val in zip(fetch, fwd):
        np.testing.assert_allclose(val, np.asarray(outs[name[4:]][0]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    assert set(got) == set(want) and got
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=ATOL, rtol=RTOL,
                                   err_msg=n)
    return outs, fwd


# -- conv2d ------------------------------------------------------------------

CONV_CASES = {
    "plain": ((2, 4, 9, 9), (6, 4, 3, 3), {}),
    "stride_pad": ((2, 4, 9, 9), (6, 4, 3, 3),
                   {"strides": [2, 2], "paddings": [1, 1]}),
    "asym_stride_pad": ((2, 4, 10, 7), (5, 4, 3, 2),
                        {"strides": [2, 1], "paddings": [2, 0]}),
    "dilation": ((2, 4, 11, 11), (6, 4, 3, 3),
                 {"dilations": [2, 2], "paddings": [2, 2]}),
    "groups": ((2, 4, 8, 8), (6, 2, 3, 3), {"groups": 2, "paddings": [1, 1]}),
    "bias": ((2, 4, 8, 8), (6, 4, 1, 1), {"strides": [2, 2]}),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case):
    xs, ws, attrs = CONV_CASES[case]
    ins = {"Input": {"x": f32(*xs)}, "Filter": {"w": f32(*ws)}}
    if case == "bias":
        ins["Bias"] = {"b": f32(ws[0])}
    _check("conv2d", ins, attrs, ct_slots=["Output"])


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d_matches_jax(stride):
    ins = {"Input": {"x": f32(2, 6, 9, 9)}, "Filter": {"w": f32(6, 1, 3, 3)}}
    _check("depthwise_conv2d", ins,
           {"groups": 6, "strides": [stride, stride], "paddings": [1, 1]},
           ct_slots=["Output"])


# -- pool2d ------------------------------------------------------------------

POOL_CASES = {
    "max": ((2, 3, 8, 8), {"ksize": [2, 2], "strides": [2, 2]}),
    "max_3x3_s2_p1": ((2, 3, 9, 9), {"ksize": [3, 3], "strides": [2, 2],
                                     "paddings": [1, 1]}),
    # padding above half the kernel: torch's max_pool2d refuses it
    "max_pad_above_half": ((2, 3, 6, 6), {"ksize": [3, 3], "strides": [2, 2],
                                          "paddings": [2, 2]}),
    "avg": ((2, 3, 8, 8), {"pooling_type": "avg", "ksize": [2, 2],
                           "strides": [2, 2]}),
    "avg_pad_exclusive": ((2, 3, 7, 7), {"pooling_type": "avg",
                                         "ksize": [3, 3], "strides": [2, 2],
                                         "paddings": [1, 1]}),
    "avg_pad_inclusive": ((2, 3, 7, 7), {"pooling_type": "avg",
                                         "ksize": [3, 3], "strides": [2, 2],
                                         "paddings": [1, 1],
                                         "exclusive": False}),
    "global_max": ((2, 3, 5, 7), {"global_pooling": True}),
    "global_avg": ((2, 3, 5, 7), {"pooling_type": "avg",
                                  "global_pooling": True}),
    "adaptive_uniform_max": ((2, 3, 8, 6), {"adaptive": True,
                                            "ksize": [4, 3]}),
    "adaptive_uniform_avg": ((2, 3, 8, 6), {"pooling_type": "avg",
                                            "adaptive": True,
                                            "ksize": [2, 3]}),
    "adaptive_nonuniform_max": ((2, 3, 7, 5), {"adaptive": True,
                                               "ksize": [3, 2]}),
    "adaptive_nonuniform_avg": ((2, 3, 7, 5), {"pooling_type": "avg",
                                               "adaptive": True,
                                               "ksize": [3, 2]}),
    "adaptive_1x1": ((2, 3, 5, 7), {"pooling_type": "avg", "adaptive": True,
                                    "ksize": [1, 1]}),
}
# ceil_mode crossed with exclusive: at 6x6, k 3, s 2 the last window
# takes one column and one row of ceil_mode padding
for _t in ("max", "avg"):
    for _pad in (0, 1):
        for _excl in (True, False):
            POOL_CASES[f"ceil_{_t}_p{_pad}_excl{int(_excl)}"] = (
                (2, 3, 6, 6) if _pad == 0 else (2, 3, 8, 8),
                {"pooling_type": _t, "ksize": [3, 3], "strides": [2, 2],
                 "paddings": [_pad, _pad], "ceil_mode": True,
                 "exclusive": _excl})


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case):
    xs, attrs = POOL_CASES[case]
    outs, _ = _check("pool2d", {"X": {"x": f32(*xs)}}, attrs)
    if attrs.get("ceil_mode"):
        h = xs[2] + 2 * attrs["paddings"][0]
        assert np.shape(outs["Out"][0])[2] == -(-(h - 3) // 2) + 1


# -- batch_norm --------------------------------------------------------------

BN_CASES = [(mode, layout) for mode in ("train", "is_test", "global_stats")
            for layout in ("NCHW", "NHWC")]


@pytest.mark.parametrize("mode,layout", BN_CASES)
def test_batch_norm_matches_jax(mode, layout):
    c = 5
    xs = (4, c, 3, 3) if layout == "NCHW" else (4, 3, 3, c)
    x = f32(*xs) * 2 + 0.5
    mean, var = f32(c), f32(c, lo=0.5)
    ins = {"X": {"x": x}, "Scale": {"s": f32(c)}, "Bias": {"b": f32(c)},
           "Mean": {"m": mean}, "Variance": {"v": var}}
    attrs = {"data_layout": layout, "momentum": 0.8, "epsilon": 1e-3,
             "is_test": mode == "is_test",
             "use_global_stats": mode == "global_stats"}
    extra = ["MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]
    _, fwd = _check("batch_norm", ins, attrs, ct_slots=["Y"],
                    fetch_extra=extra)
    mean_out, var_out, saved_mean, saved_var = fwd[1:]
    if mode == "train":
        axes = (0, 2, 3) if layout == "NCHW" else (0, 1, 2)
        bm = x.astype(np.float64).mean(axes)
        bv = x.astype(np.float64).var(axes)      # biased, as jnp.var
        want = (mean * 0.8 + bm * 0.2, var * 0.8 + bv * 0.2, bm,
                1.0 / np.sqrt(bv + 1e-3))
    else:
        want = (mean, var, np.zeros(c), np.zeros(c))
    for name, g, w in zip(extra, (mean_out, var_out, saved_mean, saved_var),
                          want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)


# -- momentum and weight decay -----------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "nesterov", "l2_decay"])
def test_momentum_update_matches_jax(variant):
    from paddle_tpu.core import registry as jregistry
    from paddle_tpu.lowering import LowerCtx as JLowerCtx
    from paddle_tpu_torch.core import registry as tregistry
    from paddle_tpu_torch.lowering import LowerCtx

    p, g, v = f32(4, 3), f32(4, 3), f32(4, 3)
    lr = np.array([0.05], np.float32)
    attrs = {"mu": 0.9, "use_nesterov": variant == "nesterov",
             "regularization_method": "l2_decay" if variant == "l2_decay"
             else "", "regularization_coeff": 0.01}
    arrays = {"Param": p, "Grad": g, "Velocity": v, "LearningRate": lr}
    jout = jregistry.get_op_def("momentum").lower(
        JLowerCtx(), {k: [a] for k, a in arrays.items()}, attrs)
    tout = tregistry.get_op_def("momentum").lower(
        LowerCtx("cpu"), {k: [torch.from_numpy(a)] for k, a in
                          arrays.items()}, attrs)
    for slot in ("ParamOut", "VelocityOut"):
        np.testing.assert_allclose(tout[slot][0].numpy(),
                                   np.asarray(jout[slot][0]), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


def _normalized(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _mlp(pkg, un, opt_name, reg_name, param_reg=None):
    """A two-layer MLP with ``opt_name`` and weight decay ``reg_name``
    from the optimizer; ``param_reg`` puts another on the first layer's
    weight (it takes precedence)."""
    with un.guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            L = pkg.layers
            x = L.data("x", shape=[6], dtype="float32")
            y = L.data("y", shape=[1], dtype="float32")
            attr = None
            if param_reg is not None:
                attr = pkg.ParamAttr(
                    regularizer=getattr(pkg.regularizer, param_reg)(0.05))
            h = L.fc(x, 8, act="relu", param_attr=attr)
            pred = L.fc(h, 1)
            d = L.elementwise_sub(pred, y)
            loss = L.mean(L.elementwise_mul(d, d))
            reg = getattr(pkg.regularizer, reg_name)(0.1)
            if opt_name == "momentum":
                opt = pkg.optimizer.Momentum(0.05, 0.9, regularization=reg)
            else:
                opt = pkg.optimizer.SGD(0.05, regularization=reg)
            opt.minimize(loss)
    return main, startup, loss


REG_CASES = [("momentum", "L2Decay", None), ("momentum", "L1Decay", None),
             ("sgd", "L2Decay", None), ("sgd", "L1Decay", "L2Decay")]


@pytest.mark.parametrize("opt_name,reg_name,param_reg", REG_CASES)
def test_weight_decay_matches_jax(opt_name, reg_name, param_reg):
    """The decayed MLP's programs equal the JAX package's, and four steps
    from the same weights give the same losses and parameters."""
    jmain, jstart, jloss = _mlp(fluid, jun, opt_name, reg_name, param_reg)
    tmain, tstart, tloss = _mlp(tfluid, tun, opt_name, reg_name, param_reg)
    for t, j in ((tmain, jmain), (tstart, jstart)):
        assert _normalized(t) == _normalized(j)
    # the parameter's own regularizer survives serialization
    assert _normalized(tfluid.Program.from_dict(tmain.to_dict())) == \
        _normalized(tmain)
    ops = [op.type for op in tmain.global_block.ops]
    assert ("abs" in ops) == (reg_name == "L1Decay")
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.global_block.vars.values()]
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = scope_from_numpy({n: jscope.numpy(n) for n in names},
                              tfluid.Scope(), tfluid.CPUPlace(),
                              programs=[tmain])
    rng = np.random.RandomState(3)
    for step in range(4):
        feed = {"x": rng.randn(16, 6).astype(np.float32),
                "y": rng.randn(16, 1).astype(np.float32)}
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        tl, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"step {step}")
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("reg_name,want", [("L2Decay", 0.9),
                                           ("L1Decay", 0.9)])
def test_weight_decay_alone_moves_the_weight(reg_name, want):
    """The JAX package's ``test_l2_regularizer_changes_grad`` in the port:
    with a zero input the gradient is 0, so one SGD step at lr 1 leaves
    w - 0.1 * w (L2) or w - 0.1 * sign(w) (L1) at w = 1."""
    def final_w(reg):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[2], dtype="float32")
            pred = tfluid.layers.fc(x, 1, param_attr=tfluid.ParamAttr(
                name="w"), bias_attr=False)
            loss = tfluid.layers.mean(pred)
            tfluid.optimizer.SGD(1.0, regularization=reg).minimize(loss)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        scope.set_var("w", torch.ones(2, 1))
        exe.run(main, feed={"x": np.zeros((1, 2), np.float32)},
                fetch_list=[], scope=scope)
        return scope.numpy("w")

    np.testing.assert_allclose(final_w(None), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        final_w(getattr(tfluid.regularizer, reg_name)(0.1)), want, atol=1e-6)


# -- FLAGS_conv_use_nhwc -----------------------------------------------------

def test_conv_pool_channels_last_matches_contiguous():
    """``FLAGS_conv_use_nhwc=always`` (channels_last on the CPU too)
    against ``never``: the same forward and parameter updates (the JAX
    package's ``test_conv_pool_nhwc_lowering_matches_nchw``, minus
    conv2d_transpose, which the port has not taken yet)."""
    xb = np.random.RandomState(9).randn(2, 8, 16, 16).astype(np.float32)

    def build_and_run(mode):
        tfluid.set_flags({"FLAGS_conv_use_nhwc": mode})
        with tun.guard():
            main, startup = tfluid.Program(), tfluid.Program()
            with tfluid.program_guard(main, startup):
                L = tfluid.layers
                x = L.data("x", shape=[8, 16, 16], dtype="float32")
                h = L.conv2d(x, 16, 3, padding=1, act="relu")
                h = L.pool2d(h, pool_size=2, pool_type="max", pool_stride=2)
                h = L.conv2d(h, 16, 3, padding=1, groups=16)
                h = L.batch_norm(h)
                h = L.pool2d(h, pool_size=2, pool_type="avg", pool_stride=2)
                flat = L.fc(h, 4)
                loss = L.mean(flat)
                tfluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
        startup.random_seed = 5
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        out, = exe.run(main, feed={"x": xb}, fetch_list=[h.name],
                       scope=scope)
        return out, {n: scope.numpy(n) for n in scope.vars}

    ref, ref_state = build_and_run("never")
    got, got_state = build_and_run("always")
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert set(got_state) == set(ref_state)
    for n in ref_state:
        np.testing.assert_allclose(got_state[n], ref_state[n], atol=1e-5,
                                   rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("mode,want", [("always", torch.channels_last),
                                       ("never", torch.contiguous_format),
                                       ("auto", torch.contiguous_format)])
def test_conv_memory_format_follows_the_flag(mode, want):
    """The memory format of conv2d's output; ``auto`` on a CPU tensor is
    contiguous NCHW (channels_last on a CUDA one)."""
    from paddle_tpu_torch.core import registry as tregistry
    from paddle_tpu_torch.lowering import LowerCtx

    tfluid.set_flags({"FLAGS_conv_use_nhwc": mode})
    opdef = tregistry.get_op_def("conv2d")
    attrs = {k: s.default for k, s in opdef.attrs.items()}
    y = opdef.lower(LowerCtx("cpu"), {
        "Input": [torch.from_numpy(f32(2, 4, 6, 6))],
        "Filter": [torch.from_numpy(f32(8, 4, 3, 3))]}, attrs)["Output"][0]
    assert tuple(y.shape) == (2, 8, 4, 4)
    assert y.is_contiguous(memory_format=want)
