"""The port's fake-quant ops (``ops/quant_ops.py``) and ``contrib.slim``
(quantization-aware training, pruning, distillation, the SA controller)
against the JAX package's, on the CPU.

Every case of ``tests/test_quant_ops.py``, ``tests/test_quantization.py``
and ``tests/test_slim_prune_distill.py`` runs in both packages on the same
numpy inputs. Programs are built by one function in each package under
``unique_name.guard()`` and the JAX package's startup weights are carried
into the port's scope (``interop.scope_from_numpy``). The quantized
values agree within rtol 1e-6 / atol 1e-7 (the same float32 formula;
the division by qmax is a true division in both), gradients and losses
within rtol 1e-5 / atol 1e-6 (float32, other summation orders); the
passes insert the same ops on the same vars in both packages (ResNet-50:
54 abs-max and 50 moving-average fake-quants), the pruners pick the same
channels and the SA controller, on numpy's generator in both, the same
tokens.
"""
import collections
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.backward import append_backward as j_append_backward
from paddle_tpu.contrib.slim import distillation as jdist
from paddle_tpu.contrib.slim import prune as jprune
from paddle_tpu.contrib.slim import searcher as jsearch
from paddle_tpu.contrib.slim.quantization import quant_aware as j_quant_aware

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.backward import append_backward as t_append_backward
from paddle_tpu_torch.contrib.slim import distillation as tdist
from paddle_tpu_torch.contrib.slim import prune as tprune
from paddle_tpu_torch.contrib.slim import searcher as tsearch
from paddle_tpu_torch.contrib.slim.quantization import (
    QuantizationTransformPass, quant_aware as t_quant_aware)
from paddle_tpu_torch.interop import scope_from_numpy

J = types.SimpleNamespace(name="jax", fl=jfluid, un=jun,
                          append_backward=j_append_backward,
                          quant_aware=j_quant_aware, dist=jdist,
                          prune=jprune, search=jsearch)
T = types.SimpleNamespace(name="port", fl=tfluid, un=tun,
                          append_backward=t_append_backward,
                          quant_aware=t_quant_aware, dist=tdist,
                          prune=tprune, search=tsearch)
Q_RTOL, Q_ATOL = 1e-6, 1e-7
RTOL, ATOL = 1e-5, 1e-6
RNG = np.random.RandomState(11)


def _ref_quant(v, scale, bits=8):
    """ClipAndFakeQuantFunctor: round(clip(v/s, -1, 1) * qmax) / qmax * s."""
    qmax = float(2 ** (bits - 1) - 1)
    s = max(float(scale), 1e-8)
    return (np.round(np.clip(v / s, -1.0, 1.0) * qmax) / qmax * s).astype(
        np.float32)


def _run_op(P, op_type, inputs, attrs, out_names, input_vars=(),
            extra_vars=()):
    """Append one raw quant op and run it, returning the fetches."""
    with P.un.guard():
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup):
            blk = main.global_block
            feed = {}
            for name, val in input_vars:
                P.fl.layers.data(name, shape=list(val.shape[1:]) or [1],
                                 dtype="float32")
                feed[name] = val
            for name, val in extra_vars:
                blk.create_var(name=name, shape=val.shape, dtype="float32",
                               persistable=True)
                feed[name] = val
            for name in out_names:
                blk.create_var(name=name, dtype="float32")
            blk.append_op(op_type, inputs=inputs,
                          outputs=dict(zip(("Out", "OutScale"),
                                           [[n] for n in out_names])),
                          attrs=attrs)
        exe = P.fl.Executor(P.fl.CPUPlace())
        with P.fl.scope_guard(P.fl.Scope()):
            exe.run(startup)
            return [np.asarray(v) for v in exe.run(main, feed=feed,
                                                   fetch_list=out_names)]


def _run_both(*args, **kw):
    t, j = _run_op(T, *args, **kw), _run_op(J, *args, **kw)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.reshape(b.shape), b, rtol=Q_RTOL,
                                   atol=Q_ATOL)
    return t


# ------------------------------------------------------ the quant ops
@pytest.mark.parametrize("bits", [8, 4])
def test_abs_max_forward_matches_reference(bits):
    v = (RNG.randn(4, 6) * 3).astype(np.float32)
    out, out_scale = _run_both(
        "fake_quantize_dequantize_abs_max", inputs={"X": ["x"]},
        attrs={"bit_length": bits}, out_names=["q", "s"],
        input_vars=[("x", v)])
    scale = np.abs(v).max()
    np.testing.assert_allclose(out_scale.reshape(-1), [scale], rtol=1e-6)
    np.testing.assert_allclose(out, _ref_quant(v, scale, bits), rtol=1e-6,
                               atol=1e-7)


def test_abs_max_quantization_error_bounded_by_resolution():
    v = RNG.randn(32, 16).astype(np.float32)
    out, _ = _run_both("fake_quantize_dequantize_abs_max",
                       inputs={"X": ["x"]}, attrs={"bit_length": 8},
                       out_names=["q", "s"], input_vars=[("x", v)])
    scale = np.abs(v).max()
    assert np.abs(out - v).max() <= scale / 127.0 / 2.0 + 1e-6


def test_moving_average_training_updates_the_scale():
    v = (RNG.randn(5, 7) * 2).astype(np.float32)
    in_scale = np.array([0.5], np.float32)
    out, out_scale = _run_both(
        "fake_quantize_dequantize_moving_average_abs_max",
        inputs={"X": ["x"], "InScale": ["scale_in"]},
        attrs={"bit_length": 8, "moving_rate": 0.9, "is_test": False},
        out_names=["q", "s"], input_vars=[("x", v)],
        extra_vars=[("scale_in", in_scale)])
    expect = 0.9 * in_scale[0] + 0.1 * np.abs(v).max()
    np.testing.assert_allclose(out_scale.reshape(-1), [expect], rtol=1e-6)
    np.testing.assert_allclose(out, _ref_quant(v, expect), rtol=1e-5,
                               atol=1e-6)


def test_moving_average_test_mode_freezes_the_scale():
    v = (RNG.randn(5, 7) * 4).astype(np.float32)
    in_scale = np.array([1.25], np.float32)
    out, out_scale = _run_both(
        "fake_quantize_dequantize_moving_average_abs_max",
        inputs={"X": ["x"], "InScale": ["scale_in"]},
        attrs={"bit_length": 8, "moving_rate": 0.9, "is_test": True},
        out_names=["q", "s"], input_vars=[("x", v)],
        extra_vars=[("scale_in", in_scale)])
    np.testing.assert_allclose(out_scale.reshape(-1), in_scale, rtol=1e-6)
    np.testing.assert_allclose(out, _ref_quant(v, in_scale[0]), rtol=1e-6,
                               atol=1e-7)
    assert np.abs(out).max() <= in_scale[0] + 1e-6


def test_fake_quant_abs_max_op_values():
    """The reference OpTest case: Out and OutScale by the formula."""
    v = RNG.randn(4, 6).astype(np.float32)
    scale = np.abs(v).max()
    q = np.round(np.clip(v / scale, -1, 1) * 127) / 127 * scale
    out, out_scale = _run_both("fake_quantize_dequantize_abs_max",
                               inputs={"X": ["x"]}, attrs={},
                               out_names=["q", "s"], input_vars=[("x", v)])
    np.testing.assert_allclose(out, q.astype(np.float32), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(out_scale.reshape(-1), [scale], rtol=1e-6)


def _ste_program(P, op_type, extra_inputs=None):
    main, startup = P.fl.Program(), P.fl.Program()
    with P.fl.program_guard(main, startup):
        x = P.fl.layers.data("x", shape=[6], dtype="float32",
                             stop_gradient=False)
        blk = main.global_block
        blk.create_var(name="q", dtype="float32")
        blk.create_var(name="s", dtype="float32")
        inputs = {"X": ["x"]}
        for slot, (name, val) in (extra_inputs or {}).items():
            blk.create_var(name=name, shape=val.shape, dtype="float32",
                           persistable=True)
            inputs[slot] = [name]
        blk.append_op(op_type, inputs=inputs,
                      outputs={"Out": ["q"], "OutScale": ["s"]}, attrs={})
        loss = P.fl.layers.mean(P.fl.layers.scale(blk.var("q"), scale=3.0))
        P.append_backward(loss)
    return main, startup, x


@pytest.mark.parametrize("op_type,extra", [
    ("fake_quantize_dequantize_abs_max", None),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"InScale": ("scale_in", np.array([1.0], np.float32))}),
])
def test_straight_through_gradient_via_append_backward(op_type, extra):
    """d(mean(3 q))/dx = 3/n exactly: the staircase passes the gradient
    through as identity, in both packages."""
    v = (RNG.randn(4, 6) * 2).astype(np.float32)
    got = {}
    for P in (T, J):
        with P.un.guard():
            main, startup, x = _ste_program(P, op_type, extra)
        gname = f"{x.name}@GRAD"
        assert main.global_block.has_var(gname)
        assert not main.global_block.has_var("s@GRAD")
        feed = {"x": v}
        for _slot, (name, val) in (extra or {}).items():
            feed[name] = val
        exe = P.fl.Executor(P.fl.CPUPlace())
        with P.fl.scope_guard(P.fl.Scope()):
            exe.run(startup)
            (got[P.name],) = exe.run(main, feed=feed, fetch_list=[gname])
    np.testing.assert_allclose(np.asarray(got["port"]),
                               np.full_like(v, 3.0 / v.size), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got["port"]),
                               np.asarray(got["jax"]), rtol=1e-6)


def test_fake_quant_straight_through_gradient_via_gradients():
    v = RNG.randn(3, 5).astype(np.float32)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[5], dtype="float32",
                               stop_gradient=False)
        blk = main.global_block
        blk.create_var(name="q", dtype="float32")
        blk.create_var(name="s", dtype="float32")
        blk.append_op("fake_quantize_dequantize_abs_max",
                      inputs={"X": "x"}, outputs={"Out": "q", "OutScale": "s"})
        loss = tfluid.layers.mean(blk.var("q"))
        (gx,) = tfluid.gradients([loss], [x])
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        (g,) = exe.run(main, feed={"x": v}, fetch_list=[gx.name])
    np.testing.assert_allclose(g, np.full_like(v, 1 / v.size), rtol=1e-6)


# ------------------------------------------------------ the pass
def _qat_mlp(P):
    with P.un.guard():
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup):
            x = P.fl.layers.data("x", shape=[16], dtype="float32")
            y = P.fl.layers.data("y", shape=[1], dtype="int64")
            h = P.fl.layers.fc(x, 32, act="relu")
            logits = P.fl.layers.fc(h, 4)
            test_prog = main.clone(for_test=True)
            P.quant_aware(main, startup)
            loss = P.fl.layers.mean(
                P.fl.layers.softmax_with_cross_entropy(logits, y))
            P.fl.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    main.random_seed = 9
    return main, startup, test_prog, loss, logits


def _ops(prog):
    return [(op.type, {k: list(v) for k, v in sorted(op.inputs.items())},
             {k: list(v) for k, v in sorted(op.outputs.items())})
            for op in prog.global_block.ops]


def test_quant_aware_training():
    """The pass inserts the same ops on the same vars in both packages;
    from the same weights the first 3 QAT losses agree, the port's model
    trains, and its quantized forward differs from float32 within 8-bit
    resolution."""
    jmain, jstart, _, jloss, _ = _qat_mlp(J)
    tmain, tstart, ttest, tloss, tlogits = _qat_mlp(T)
    assert _ops(tmain) == _ops(jmain)
    types_ = [op.type for op in tmain.global_block.ops]
    assert types_.count("fake_quantize_dequantize_abs_max") == 2
    assert types_.count(
        "fake_quantize_dequantize_moving_average_abs_max") >= 2
    rng = np.random.RandomState(0)
    xb = rng.randn(32, 16).astype(np.float32)
    yb = (np.abs(xb[:, :4]).argmax(1)).astype(np.int64).reshape(-1, 1)
    feed = {"x": xb, "y": yb}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        weights = {n: np.asarray(jscope.find_var(n)) for n in jscope.vars}
        jl = [float(np.ravel(jexe.run(jmain, feed=feed,
                                      fetch_list=[jloss.name])[0])[0])
              for _ in range(3)]
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstart, scope=tscope)
    scope_from_numpy(weights, tscope, tfluid.CPUPlace(), [tmain])
    losses = []
    with tfluid.scope_guard(tscope):
        for _ in range(60):
            (lv,) = texe.run(tmain, feed=feed, fetch_list=[tloss.name])
            losses.append(float(np.ravel(lv)[0]))
        (q_logits,) = texe.run(tmain, feed=feed, fetch_list=[tlogits.name])
        (f_logits,) = texe.run(ttest, feed=feed, fetch_list=[tlogits.name])
    np.testing.assert_allclose(losses[:3], jl, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    diff = np.abs(q_logits - f_logits)
    assert 0 < diff.max() < 0.3


def test_skip_pattern_respects_name_scope():
    for P in (T, J):
        with P.un.guard():
            main, startup = P.fl.Program(), P.fl.Program()
            with P.fl.program_guard(main, startup):
                x = P.fl.layers.data("x", shape=[8], dtype="float32")
                h = P.fl.layers.fc(x, 8)
                with P.fl.name_scope("skip_quant"):
                    P.fl.layers.fc(h, 4)
                P.quant_aware(main, startup)
        types_ = [op.type for op in main.global_block.ops]
        assert types_.count("fake_quantize_dequantize_abs_max") == 1, P.name


def test_requantize_after_inplace_rewrite():
    progs = {}
    for P in (T, J):
        with P.un.guard():
            main, startup = P.fl.Program(), P.fl.Program()
            with P.fl.program_guard(main, startup):
                x = P.fl.layers.data("x", shape=[8], dtype="float32")
                h1 = P.fl.layers.fc(x, 8)
                main.global_block.append_op(
                    "scale", inputs={"X": h1}, outputs={"Out": h1},
                    attrs={"scale": 2.0})
                P.fl.layers.fc(h1, 4)
                P.quant_aware(main, startup)
        progs[P.name] = main
    assert _ops(progs["port"]) == _ops(progs["jax"])
    ops = progs["port"].global_block.ops
    scale_idx = [i for i, op in enumerate(ops) if op.type == "scale"][0]
    second_mul = [i for i, op in enumerate(ops)
                  if op.type == "mul" and i > scale_idx][0]
    qname = ops[second_mul].inputs["X"][0]
    assert ".quantized" in qname
    producer = [i for i, op in enumerate(ops)
                if qname in sum(op.outputs.values(), [])][0]
    assert producer > scale_idx


def test_resnet50_gets_the_same_fake_quants_in_both_packages():
    """The chip's ``qat`` phase program: ResNet-50 through the pass, 54
    abs-max (the 53 convolutions' and the fc's weights) and 50
    moving-average fake-quants (the distinct activations they read), the
    same ops on the same vars as the JAX package's pass."""
    from paddle_tpu.models.resnet import build_resnet as j_build
    from paddle_tpu_torch.models.resnet import build_resnet as t_build

    progs = {}
    for P, build in ((T, t_build), (J, j_build)):
        with P.un.guard():
            net = build(50, build_optimizer=False)
            P.quant_aware(net["main"], net["startup"])
        progs[P.name] = net["main"]
    assert _ops(progs["port"]) == _ops(progs["jax"])
    counts = collections.Counter(op.type for op in
                                 progs["port"].global_block.ops
                                 if op.type.startswith("fake_quantize"))
    assert counts == {"fake_quantize_dequantize_abs_max": 54,
                      "fake_quantize_dequantize_moving_average_abs_max": 50}
    import chip_smoke  # noqa: F401  (the phase's expectation agrees)

    assert chip_smoke.QAT_OPS == dict(counts)


def test_the_pass_refuses_a_fused_program():
    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[8], dtype="float32")
            tfluid.layers.fc(x, 8)
    main.global_block.ops[0].type = "fused_gemm_epilogue"
    with pytest.raises(ValueError, match="BEFORE epilogue fusion"):
        QuantizationTransformPass().apply(main, startup)


# ------------------------------------------------------ pruning
def test_structure_pruner_idx_and_tensor():
    w = np.array([[1, 1], [5, 5], [0.1, 0.1], [3, 3]], np.float32)
    for P in (T, J):
        p = P.prune.StructurePruner({"*": 0}, {"*": "l1_norm"})
        idx = p.cal_pruned_idx("w", w, 0.5)
        assert sorted(idx) == [0, 2]
        masked = p.prune_tensor(w, idx, 0, lazy=True)
        assert masked.shape == w.shape and (masked[[0, 2]] == 0).all()
        shrunk = p.prune_tensor(w, idx, 0, lazy=False)
        np.testing.assert_allclose(shrunk, w[[1, 3]])
        l2 = P.prune.StructurePruner({"*": 0}, {"*": "l2_norm"})
        assert sorted(l2.cal_pruned_idx("w", w, 0.25)) == [2]


def _small_convnet(P):
    img = P.fl.layers.data("img", shape=[3, 8, 8], dtype="float32")
    c1 = P.fl.layers.conv2d(img, 8, 3, padding=1, act="relu",
                            param_attr=P.fl.ParamAttr(name="c1w"),
                            bias_attr=P.fl.ParamAttr(name="c1b"))
    c2 = P.fl.layers.conv2d(c1, 4, 3, padding=1,
                            param_attr=P.fl.ParamAttr(name="c2w"))
    pooled = P.fl.layers.pool2d(c2, 8, "avg", 8)
    return P.fl.layers.fc(P.fl.layers.flatten(pooled), 5)


def _convnets():
    """The conv net in both packages from the JAX package's weights."""
    nets = {}
    weights = None
    for P in (J, T):
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup), P.un.guard():
            logits = _small_convnet(P)
        exe, scope = P.fl.Executor(P.fl.CPUPlace()), P.fl.Scope()
        with P.fl.scope_guard(scope):
            exe.run(startup)
        if P is J:
            weights = {n: np.asarray(scope.find_var(n)) for n in scope.vars}
        else:
            scope_from_numpy(weights, scope, tfluid.CPUPlace(), [main])
        nets[P.name] = (main, startup, logits, exe, scope)
    return nets


def test_mask_prune_zeroes_channels_and_still_runs():
    xb = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    outs, pruned = {}, {}
    for P, (main, _, logits, exe, scope) in zip(
            (J, T), _convnets().values()):
        with P.fl.scope_guard(scope):
            pruned[P.name] = P.prune.prune_parameters(
                scope, {"c1w": 0.5}, tied={"c1w": ["c1b"]})
            w = np.asarray(scope.numpy("c1w"))
            assert (w[pruned[P.name]["c1w"]] == 0).all()
            outs[P.name] = np.asarray(exe.run(main, feed={"img": xb},
                                              fetch_list=[logits])[0])
            assert np.isfinite(outs[P.name]).all()
            P.prune.apply_masks(scope, pruned[P.name],
                                tied={"c1w": ["c1b"]})
    assert sorted(pruned["port"]["c1w"]) == sorted(pruned["jax"]["c1w"])
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=RTOL,
                               atol=ATOL)


def test_shrink_model_removes_channels_end_to_end():
    """Shape-shrink: c1's out-channels 8 -> 4, c1's bias and c2's
    in-channels follow; the shrunk program runs and equals the masked
    program's output, and the JAX package's shrunk output."""
    xb = np.random.RandomState(1).rand(2, 3, 8, 8).astype(np.float32)
    shrunk = {}
    for P, (main, startup, logits, exe, scope) in zip(
            (J, T), _convnets().values()):
        with P.fl.scope_guard(scope):
            idx = P.prune.prune_parameters(scope, {"c1w": 0.5},
                                           tied={"c1w": ["c1b"]})
            masked = np.asarray(exe.run(main, feed={"img": xb},
                                        fetch_list=[logits])[0])
            P.prune.shrink_model(main, startup, scope, {"c1w": 0.5},
                                 pruned_idx=idx)
            assert np.asarray(scope.numpy("c1w")).shape == (4, 3, 3, 3)
            assert np.asarray(scope.numpy("c1b")).shape == (4,)
            assert np.asarray(scope.numpy("c2w")).shape == (4, 4, 3, 3)
            shrunk[P.name] = np.asarray(exe.run(main, feed={"img": xb},
                                                fetch_list=[logits])[0])
        np.testing.assert_allclose(shrunk[P.name], masked, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(shrunk["port"], shrunk["jax"], rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------ distillation
def _student_teacher(P):
    img = P.fl.layers.data("img", shape=[4], dtype="float32")
    s_hid = P.fl.layers.fc(img, 6, act="relu",
                           param_attr=P.fl.ParamAttr(name="s_w"))
    s_logits = P.fl.layers.fc(s_hid, 3,
                              param_attr=P.fl.ParamAttr(name="s_head"))
    teacher, t_startup = P.fl.Program(), P.fl.Program()
    with P.fl.program_guard(teacher, t_startup):
        t_img = P.fl.layers.data("img", shape=[4], dtype="float32")
        t_hid = P.fl.layers.fc(t_img, 6, act="relu",
                               param_attr=P.fl.ParamAttr(name="t_w"))
        t_logits = P.fl.layers.fc(t_hid, 3,
                                  param_attr=P.fl.ParamAttr(name="t_head"))
    return s_logits, teacher, t_startup, t_logits


def _distill(P):
    main, startup = P.fl.Program(), P.fl.Program()
    with P.fl.program_guard(main, startup):
        with P.un.guard():
            s_logits, teacher, t_startup, t_logits = _student_teacher(P)
            renames = P.dist.merge_teacher_program(
                main, teacher, feed_map={"img": "img"},
                teacher_startup=t_startup, student_startup=startup)
            soft = P.dist.SoftLabelDistiller(
                s_logits.name, renames[t_logits.name])
            l2 = P.dist.L2Distiller(s_logits.name, renames[t_logits.name],
                                    distillation_loss_weight=0.5)
            loss = P.fl.layers.elementwise_add(soft.distiller_loss(main),
                                               l2.distiller_loss(main))
            P.fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss, renames


def test_distillation_student_learns_teacher():
    """The merged program is the JAX package's (the same ops on the same
    vars); from the same student, teacher and batches the first losses
    agree, the student converges and the teacher never moves."""
    (jmain, jstart, jloss, jren), (tmain, tstart, tloss, tren) = \
        _distill(J), _distill(T)
    assert tren == jren
    assert _ops(tmain) == _ops(jmain)
    rng = np.random.RandomState(0)
    t_w = rng.randn(4, 6).astype(np.float32)
    t_head = rng.randn(6, 3).astype(np.float32)
    batches = [rng.rand(32, 4).astype(np.float32) for _ in range(60)]
    vals = {}
    for P, main, start, loss in ((J, jmain, jstart, jloss),
                                 (T, tmain, tstart, tloss)):
        exe, scope = P.fl.Executor(P.fl.CPUPlace()), P.fl.Scope()
        with P.fl.scope_guard(scope):
            exe.run(start)
            if P is J:
                weights = {n: np.asarray(scope.find_var(n))
                           for n in scope.vars}
            else:
                scope_from_numpy(weights, scope, tfluid.CPUPlace(), [main])
            scope.set_var("teacher_t_w", t_w)
            scope.set_var("teacher_t_head", t_head)
            vals[P.name] = [float(np.ravel(exe.run(
                main, feed={"img": xb}, fetch_list=[loss])[0])[0])
                for xb in (batches if P is T else batches[:3])]
            if P is T:
                np.testing.assert_array_equal(scope.numpy("teacher_t_w"),
                                              t_w)
    np.testing.assert_allclose(vals["port"][:3], vals["jax"], rtol=RTOL,
                               atol=ATOL)
    assert vals["port"][-1] < 0.5 * vals["port"][0]


def test_fsp_distiller_builds_and_decreases():
    progs = {}
    for P in (T, J):
        with P.fl.program_guard(P.fl.Program(), P.fl.Program()):
            with P.un.guard():
                img = P.fl.layers.data("img", shape=[2, 6, 6],
                                       dtype="float32")
                s1 = P.fl.layers.conv2d(img, 4, 3, padding=1, act="relu")
                s2 = P.fl.layers.conv2d(s1, 4, 3, padding=1)
                t1 = P.fl.layers.conv2d(img, 4, 3, padding=1, act="relu")
                t2 = P.fl.layers.conv2d(t1, 4, 3, padding=1)
                main = P.fl.default_main_program()
                fsp = P.dist.FSPDistiller([(s1.name, s2.name)],
                                          [(t1.name, t2.name)])
                loss = fsp.distiller_loss(main)
                P.fl.optimizer.Adam(learning_rate=0.02).minimize(loss)
            progs[P.name] = main
            if P is not T:
                continue
            exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
            xb = np.random.RandomState(2).rand(4, 2, 6, 6).astype(
                np.float32)
            with tfluid.scope_guard(scope):
                exe.run(tfluid.default_startup_program())
                vals = [float(np.ravel(exe.run(
                    main, feed={"img": xb}, fetch_list=[loss])[0])[0])
                    for _ in range(40)]
    assert vals[-1] < 0.5 * vals[0], (vals[0], vals[-1])
    assert _ops(progs["port"]) == _ops(progs["jax"])


# ------------------------------------------------------ search
def test_sa_controller_finds_good_tokens():
    """The same seed gives the JAX package's token sequence exactly (both
    on numpy's generator), finds a good vector, and keeps a constraint."""
    target = [3, 1, 4, 1, 5]

    def reward_of(t):
        return -float(sum((a - b) ** 2 for a, b in zip(t, target)))

    seqs = {}
    for P in (T, J):
        ctrl = P.search.SAController(reduce_rate=0.9, init_temperature=1.0,
                                     seed=0)
        ctrl.reset([8] * 5, [0] * 5)
        seq = []
        for _ in range(300):
            tokens = ctrl.next_tokens()
            ctrl.update(tokens, reward_of(tokens))
            seq.append(tokens)
        seqs[P.name] = (seq, ctrl.max_reward, ctrl.best_tokens)
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][1] > -6
    ctrl2 = tsearch.SAController(seed=1)
    ctrl2.reset([6] * 3, [0, 0, 0],
                constrain_func=lambda t: all(x % 2 == 0 for x in t))
    for _ in range(20):
        t = ctrl2.next_tokens()
        assert all(x % 2 == 0 for x in t), t
        ctrl2.update(t, 0.0)
