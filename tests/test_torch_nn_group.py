"""The ``nn`` group of the op library in the port (``ops/nn.py``:
``conv2d_transpose``, ``group_norm``, ``instance_norm``,
``l2_normalize``, ``prelu``, ``interpolate_nearest`` and
``bilinear_interp``) against the JAX package's rules, on the CPU.

Each case is a single-op program built the same way in both packages
from numpy inputs made with a seed (``test_torch_sequence_ops.run_op_case``):
the outputs and the gradients of a random cotangent pulled back through
``gradients`` agree within f32 rtol 1e-5, atol 1e-5 (a transposed
convolution sums in another order than XLA's), and so do the build-time
shapes. The resizes run up and down, by integer and by non-integer
factors, with ``align_corners`` either way (the reference ignores it;
so does the port). The layers (``conv2d_transpose`` with the
``Bilinear`` initializer, the upsampling idiom, ``group_norm``,
``instance_norm``, ``prelu``, ``l2_normalize``, ``image_resize``,
``resize_bilinear``, ``resize_nearest``) build the same ``to_dict()``
and compute the same values from the JAX package's initial scope.
"""
import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.interop import scope_from_numpy

from test_torch_lod import build_both, normalized
from test_torch_sequence_ops import assert_case_matches, f32, run_op_case

RTOL, ATOL = 1e-5, 1e-5

X = f32(2, 4, 5, 7, seed=1)

# case id -> (op type, ins, outs, attrs, outputs to differentiate)
CASES = {
    "conv2d_transpose_s2": (
        "conv2d_transpose",
        {"Input": [("x", f32(2, 3, 5, 4, seed=2))],
         "Filter": [("w", f32(3, 2, 3, 3, seed=3))]},
        {"Output": ["o"]},
        {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}, ["o"]),
    "conv2d_transpose_dil_bias": (
        "conv2d_transpose",
        {"Input": [("x", f32(1, 2, 4, 4, seed=4))],
         "Filter": [("w", f32(2, 3, 2, 3, seed=5))],
         "Bias": [("b", f32(3, seed=6))]},
        {"Output": ["o"]},
        {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1]}, ["o"]),
    "group_norm": (
        "group_norm",
        {"X": [("x", X)], "Scale": [("s", f32(4, seed=7))],
         "Bias": [("b", f32(4, seed=8))]},
        {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]},
        {"groups": 2, "epsilon": 1e-5}, ["y"]),
    "group_norm_one_group": (
        "group_norm", {"X": [("x", X)]},
        {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]}, {"groups": 1},
        ["y"]),
    "instance_norm": (
        "instance_norm",
        {"X": [("x", X)], "Scale": [("s", f32(4, seed=9))],
         "Bias": [("b", f32(4, seed=10))]},
        {"Y": ["y"], "SavedMean": ["m"], "SavedVariance": ["v"]},
        {"epsilon": 1e-5}, ["y"]),
    "l2_normalize_last": (
        "l2_normalize", {"X": [("x", X)]}, {"Out": ["o"], "Norm": ["n"]},
        {"axis": -1}, ["o"]),
    "l2_normalize_channel": (
        "l2_normalize", {"X": [("x", X)]}, {"Out": ["o"], "Norm": ["n"]},
        {"axis": 1, "epsilon": 1e-6}, ["o"]),
    "prelu_all": (
        "prelu", {"X": [("x", X)], "Alpha": [("a", f32(1, seed=11))]},
        {"Out": ["o"]}, {"mode": "all"}, ["o"]),
    "prelu_channel": (
        "prelu", {"X": [("x", X)], "Alpha": [("a", f32(4, seed=12))]},
        {"Out": ["o"]}, {"mode": "channel"}, ["o"]),
    "prelu_element": (
        "prelu", {"X": [("x", X)], "Alpha": [("a", f32(4, 5, 7, seed=13))]},
        {"Out": ["o"]}, {"mode": "element"}, ["o"]),
}
# resizes: (out_h, out_w) up by 2, up by a non-integer factor, down by a
# non-integer factor, one dim unchanged; align_corners both ways
for _h, _w in [(10, 14), (8, 11), (3, 4), (5, 9)]:
    for _ac in (False, True):
        for _op in ("interpolate_nearest", "bilinear_interp"):
            CASES[f"{_op}_{_h}x{_w}_ac{int(_ac)}"] = (
                _op, {"X": [("x", X)]}, {"Out": ["o"]},
                {"out_h": _h, "out_w": _w, "align_corners": _ac}, ["o"])

NN_GROUP = {"conv2d_transpose", "group_norm", "instance_norm",
            "l2_normalize", "prelu", "interpolate_nearest",
            "bilinear_interp"}


def test_every_op_type_of_the_group_has_cases():
    from paddle_tpu_torch.core import registry

    assert {c[0] for c in CASES.values()} == NN_GROUP
    assert NN_GROUP <= set(registry.all_ops())


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grad_match_jax(case):
    op, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op, ins, outs, attrs, grad_outs)
    assert_case_matches(got, shapes, RTOL, ATOL)
    assert any(n.startswith("grad:") for n in got["torch"])


def test_resize_align_corners_is_ignored_as_in_the_reference():
    for op in ("interpolate_nearest", "bilinear_interp"):
        a = run_op_case(op, {"X": [("x", X)]}, {"Out": ["o"]},
                        {"out_h": 8, "out_w": 11, "align_corners": False})
        b = run_op_case(op, {"X": [("x", X)]}, {"Out": ["o"]},
                        {"out_h": 8, "out_w": 11, "align_corners": True})
        np.testing.assert_array_equal(a[0]["torch"]["o"],
                                      b[0]["torch"]["o"])


def _run_layers(built, state, feed, fetch):
    jmain, jstart, _ = built["jax"]
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = list(jstart.global_block.vars)
    tmain = built["torch"][0]
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy({n: jscope.numpy(n) for n in names}, tscope,
                     tfluid.CPUPlace(), programs=[tmain])
    jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    tout = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
    return jout, tout


def test_layers_build_the_jax_programs_and_agree():
    """Every layer of the group in one program, with a loss and SGD: the
    main and startup ``to_dict()`` are equal, and from the JAX package's
    initial scope the outputs and the loss after one step agree."""
    def net(fl):
        img = fl.layers.data("img", shape=[4, 5, 7], dtype="float32")
        up = fl.layers.conv2d_transpose(
            img, num_filters=4, filter_size=4, stride=2, padding=1,
            param_attr=fl.ParamAttr(
                initializer=fl.initializer.Bilinear(), trainable=False),
            bias_attr=False)
        g = fl.layers.group_norm(up, groups=2)
        i = fl.layers.instance_norm(g)
        p = fl.layers.prelu(i, mode="channel")
        n = fl.layers.l2_normalize(p, axis=1)
        r1 = fl.layers.resize_bilinear(n, out_shape=[7, 9])
        r2 = fl.layers.resize_nearest(n, out_shape=[13, 17])
        r3 = fl.layers.image_resize(img, out_shape=[8, 11])
        loss = fl.layers.mean(fl.layers.elementwise_add(
            fl.layers.reduce_mean(r1), fl.layers.reduce_mean(r2)))
        fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return [up, g, i, p, n, r1, r2, r3, loss]

    built = build_both(net)
    for k in (0, 1):
        assert normalized(built["torch"][k]) == normalized(built["jax"][k])
    outs = built["torch"][2]
    assert [tuple(v.shape) for v in outs[:3]] == [(-1, 4, 10, 14)] * 3
    feed = {"img": f32(2, 4, 5, 7, seed=21)}
    fetch = [v.name for v in outs]
    jout, tout = _run_layers(built, None, feed, fetch)
    for n, a, b in zip(fetch, tout, jout):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=n)


def test_bilinear_conv2d_transpose_upsamples_as_bilinear():
    """The upsampling idiom: a stride-2 ``conv2d_transpose`` with the
    ``Bilinear`` initializer and kernel 4, padding 1 doubles each
    channel; a constant image stays constant away from the border."""
    def net(fl):
        img = fl.layers.data("img", shape=[3, 6, 6], dtype="float32")
        return [fl.layers.conv2d_transpose(
            img, num_filters=3, filter_size=4, stride=2, padding=1,
            param_attr=fl.ParamAttr(
                initializer=fl.initializer.Bilinear()), bias_attr=False)]

    built = build_both(net)
    w = built["torch"][1].global_block.ops[0].attrs["values"]
    assert w == built["jax"][1].global_block.ops[0].attrs["values"]
    feed = {"img": np.ones((1, 3, 6, 6), np.float32)}
    name = built["torch"][2][0].name
    jout, tout = _run_layers(built, None, feed, [name])
    np.testing.assert_allclose(tout[0], jout[0], rtol=RTOL, atol=ATOL)
    assert tout[0].shape == (1, 3, 12, 12)
    np.testing.assert_allclose(tout[0][:, :, 1:-1, 1:-1], 1.0, rtol=1e-6)
