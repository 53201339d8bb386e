"""The port's dygraph layer zoo, learning-rate schedulers, eager clipping
and weight decay against the JAX package's, on the CPU.

Every case of ``tests/test_dygraph_zoo.py`` runs in both packages on the
same numpy inputs, from the same ``seed_parameters`` weights: GRUUnit,
NCE, PRelu, BilinearTensorProduct, Conv2DTranspose, GroupNorm,
SpectralNorm, TreeConv, RowConv, SequenceConv, the eight decays and the
global-norm clip, plus the value and norm clips and L1/L2 decay in the
eager update. Outputs, gradients and parameters agree within rtol 1e-5 /
atol 1e-6 (float32, different summation orders; the spectral norm's 30
power iterations within rtol 1e-4 / atol 1e-5, each iteration's
normalisation carrying the last one's rounding on); the schedulers'
rates are Python floats by the same formulas and equal exactly. NCE
draws its negative samples from the port's generator, not jax's
(ROADMAP, differences by design), so its case holds each package to the
reference test's own bar (the cost halves over 120 steps) and compares
the costs' scale, not their bits.
"""
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy

J = types.SimpleNamespace(name="jax", fluid=jfluid, dy=jdy,
                          guard=lambda: jdy.guard())
T = types.SimpleNamespace(name="port", fluid=tfluid, dy=tdy,
                          guard=lambda: tdy.guard(tfluid.CPUPlace()))
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _no_clip_leak():
    from paddle_tpu_torch import clip

    yield
    clip._clip_attr["__global__"] = None
    jfluid.clip.set_gradient_clip(None)


def _both(fn):
    """``fn(P)`` in each package under a guard, from the same weights;
    returns {package name: result}."""
    out = {}
    for P in (T, J):
        with P.guard():
            P.dy.seed_parameters(42)
            out[P.name] = fn(P, np.random.RandomState(42))
    return out


def _close(out, rtol=RTOL, atol=ATOL):
    t, j = out["port"], out["jax"]
    assert set(t) == set(j)
    for k in t:
        if t[k] is None:
            assert j[k] is None, k
            continue
        np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_gru_unit_steps_and_grads():
    def fn(P, rng):
        cell = P.dy.GRUUnit(size=3 * 8)
        x = P.dy.to_variable(rng.randn(4, 24).astype(np.float32))
        h = P.dy.to_variable(np.zeros((4, 8), np.float32))
        gate, reset, hidden = cell(x, h)
        loss = P.dy.ops.reduce_mean(P.dy.ops.square(hidden))
        loss.backward()
        return {"gate": gate.numpy(), "reset": reset.numpy(),
                "hidden": hidden.numpy(), "w_grad": cell.weight.gradient(),
                "b_grad": cell.bias.gradient()}

    out = _both(fn)
    assert out["port"]["hidden"].shape == (4, 8)
    _close(out)


def test_nce_layer_trains():
    def fn(P, _):
        head = P.dy.NCE(num_total_classes=30, dim=16, num_neg_samples=5)
        opt = P.fluid.optimizer.SGD(learning_rate=0.3)
        rng = np.random.RandomState(0)
        W = rng.randn(16, 30)
        vals = []
        for _ in range(120):
            xb = rng.randn(32, 16).astype(np.float32)
            yb = (xb @ W).argmax(1)[:, None].astype(np.int64)
            cost = P.dy.ops.reduce_mean(head(P.dy.to_variable(xb),
                                             P.dy.to_variable(yb)))
            cost.backward()
            opt.minimize(cost, parameter_list=head.parameters())
            head.clear_gradients()
            vals.append(float(np.ravel(cost.numpy())[0]))
        return vals

    out = _both(fn)
    for name, vals in out.items():
        assert vals[-1] < 0.5 * vals[0], (name, vals[0], vals[-1])
    # the same model and data, other negatives: the costs' scale agrees
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0.5)


def test_prelu_modes():
    def fn(P, rng):
        x = P.dy.to_variable(rng.randn(2, 3, 4, 4).astype(np.float32))
        res = {}
        for mode, kw in [("all", {}), ("channel", {"channel": 3}),
                         ("element", {"input_shape": [3, 4, 4]})]:
            layer = P.dy.PRelu(mode=mode, **kw)
            y = layer(x)
            P.dy.ops.reduce_sum(P.dy.ops.square(y)).backward()
            res[mode] = y.numpy()
            res[mode + "_grad"] = layer.weight.gradient()
        res["x"] = x.numpy()
        return res

    out = _both(fn)
    t = out["port"]
    xin = t["x"]
    np.testing.assert_allclose(t["all"][xin > 0], xin[xin > 0], rtol=1e-6)
    np.testing.assert_allclose(t["all"][xin < 0], 0.25 * xin[xin < 0],
                               rtol=1e-5)
    _close(out)


def test_bilinear_tensor_product():
    def fn(P, rng):
        layer = P.dy.BilinearTensorProduct(input1_dim=4, input2_dim=5,
                                           output_dim=3)
        x = P.dy.to_variable(rng.randn(6, 4).astype(np.float32))
        y = P.dy.to_variable(rng.randn(6, 5).astype(np.float32))
        out = layer(x, y)
        return {"out": out.numpy(), "x": x.numpy(), "y": y.numpy(),
                "W": layer.weight.numpy(), "b": layer.bias.numpy()}

    out = _both(fn)
    t = out["port"]
    expect = np.einsum("bi,kij,bj->bk", t["x"], t["W"], t["y"]) + t["b"]
    np.testing.assert_allclose(t["out"], expect, rtol=1e-4, atol=1e-5)
    _close(out)


def test_conv2d_transpose_shape_and_grad():
    def fn(P, rng):
        layer = P.dy.Conv2DTranspose(num_channels=3, num_filters=5,
                                     filter_size=3, stride=2, padding=1)
        x = P.dy.to_variable(rng.randn(2, 3, 8, 8).astype(np.float32))
        y = layer(x)
        P.dy.ops.reduce_mean(P.dy.ops.square(y)).backward()
        return {"y": y.numpy(), "w_grad": layer.weight.gradient(),
                "b_grad": layer.bias.gradient()}

    out = _both(fn)
    assert out["port"]["y"].shape[:2] == (2, 5)
    _close(out)


def test_group_norm_normalizes():
    def fn(P, rng):
        layer = P.dy.GroupNorm(channels=8, groups=2)
        x = P.dy.to_variable(rng.randn(4, 8, 5, 5).astype(np.float32))
        y = layer(x)
        P.dy.ops.reduce_mean(P.dy.ops.square(y)).backward()
        return {"y": y.numpy(), "w_grad": layer.weight.gradient()}

    out = _both(fn)
    g = out["port"]["y"].reshape(4, 2, 4 * 5 * 5)
    np.testing.assert_allclose(g.mean(-1), 0.0, atol=1e-4)
    np.testing.assert_allclose(g.std(-1), 1.0, atol=1e-3)
    _close(out)


def test_spectral_norm_shrinks_sigma():
    def fn(P, rng):
        layer = P.dy.SpectralNorm(weight_shape=[6, 10], power_iters=30)
        y = layer(P.dy.to_variable(rng.randn(6, 10).astype(np.float32)))
        return {"y": y.numpy()}

    out = _both(fn)
    s = np.linalg.svd(out["port"]["y"], compute_uv=False)[0]
    np.testing.assert_allclose(s, 1.0, rtol=1e-2)
    _close(out, rtol=1e-4, atol=1e-5)


def test_tree_conv_matches_reference_patch_semantics():
    """Single tree: 1 -> (2, 3); max_depth=2. Hand-computed patch sums via
    the reference eta formulas (tree2col.h:35-52), and the JAX
    package's output."""
    f, out_sz, k = 2, 3, 1

    def fn(P, rng):
        layer = P.dy.TreeConv(feature_size=f, output_size=out_sz,
                              num_filters=k, max_depth=2, act=None)
        nodes = rng.randn(1, 3, f).astype(np.float32)
        edges = np.array([[[1, 2], [1, 3], [0, 0]]], np.int64)
        y = layer(P.dy.to_variable(nodes), P.dy.to_variable(edges))
        return {"y": y.numpy(), "W": layer.weight.numpy(), "nodes": nodes}

    out = _both(fn)
    t = out["port"]
    y, W, nodes = t["y"], t["W"], t["nodes"]
    assert y.shape == (1, 3, out_sz, k)
    M = 2.0

    def eta(depth, idx, pclen):
        et = (M - depth) / M
        tmp = 0.5 if pclen == 1 else (idx - 1) / (pclen - 1)
        el = (1 - et) * tmp
        er = (1 - et) * (1 - el)
        return el, er, et

    expect = np.zeros((out_sz, k))
    for nid, idx, pclen, d in [(1, 1, 1, 0), (2, 1, 2, 1), (3, 2, 2, 1)]:
        el, er, et = eta(d, idx, pclen)
        expect += np.einsum("f,fok->ok", nodes[0, nid - 1],
                            el * W[:, 0] + er * W[:, 1] + et * W[:, 2])
    np.testing.assert_allclose(y[0, 0], expect, rtol=1e-4, atol=1e-5)
    for nid in (2, 3):
        el, er, et = eta(0, 1, 1)
        exp_leaf = np.einsum("f,fok->ok", nodes[0, nid - 1],
                             el * W[:, 0] + er * W[:, 1] + et * W[:, 2])
        np.testing.assert_allclose(y[0, nid - 1], exp_leaf, rtol=1e-4,
                                   atol=1e-5)
    _close(out)


def test_row_conv_and_sequence_conv():
    def fn(P, rng):
        x = P.dy.to_variable(rng.randn(2, 6, 4).astype(np.float32))
        rc = P.dy.RowConv(future_context_size=2, dim=4)
        sc = P.dy.SequenceConv(dim=4, num_filters=7, filter_size=3)
        lens = P.dy.to_variable(np.array([6, 4], np.int32))
        r, q = rc(x), sc(x, lens)
        P.dy.ops.reduce_sum(P.dy.ops.square(q)).backward()
        return {"row": r.numpy(), "seq": q.numpy(),
                "seq_grad": sc.weight.gradient()}

    out = _both(fn)
    assert out["port"]["row"].shape == (2, 6, 4)
    assert out["port"]["seq"].shape == (2, 6, 7)
    _close(out)


def _schedules(P):
    d = P.dy
    return {
        "exp": d.ExponentialDecay(learning_rate=1.0, decay_steps=10,
                                  decay_rate=0.5, staircase=True),
        "natural": d.NaturalExpDecay(1.0, 5, 0.3),
        "inverse": d.InverseTimeDecay(1.0, 5, 0.5, staircase=True),
        "noam": d.NoamDecay(d_model=64, warmup_steps=10),
        "piecewise": d.PiecewiseDecay([5, 10], [1.0, 0.5, 0.1], begin=0),
        "cosine": d.CosineDecay(1.0, step_each_epoch=2, epochs=4),
        "poly": d.PolynomialDecay(1.0, decay_steps=10,
                                  end_learning_rate=0.1),
        "poly_cycle": d.PolynomialDecay(1.0, decay_steps=4,
                                        end_learning_rate=0.1, power=2.0,
                                        cycle=True),
    }


def test_dygraph_lr_schedulers():
    t = {k: [s() for _ in range(25)] for k, s in _schedules(T).items()}
    j = {k: [s() for _ in range(25)] for k, s in _schedules(J).items()}
    assert t == j
    assert t["exp"][0] == 1.0 and t["exp"][9] == 1.0
    assert t["exp"][10] == 0.5 and t["exp"][20] == 0.25
    assert np.argmax(t["noam"]) == 9
    assert t["piecewise"][0] == 1.0 and t["piecewise"][5] == 0.5 \
        and t["piecewise"][11] == 0.1
    assert abs(t["cosine"][0] - 1.0) < 1e-6
    assert t["poly"][0] == 1.0 and abs(t["poly"][-1] - 0.1) < 1e-6


def test_scheduler_drives_optimizer():
    def fn(P, _):
        fc = P.dy.FC(4, 1)
        sched = P.dy.PiecewiseDecay([2], [0.5, 0.0], begin=0)
        opt = P.fluid.optimizer.SGD(learning_rate=sched)
        x = P.dy.to_variable(np.ones((2, 4), np.float32))
        w_before = fc.weight.numpy().copy()
        for i in range(4):
            loss = P.dy.ops.reduce_mean(fc(x))
            loss.backward()
            opt.minimize(loss, parameter_list=fc.parameters())
            fc.clear_gradients()
            if i == 1:
                w_mid = fc.weight.numpy().copy()
        return {"before": w_before, "mid": w_mid, "end": fc.weight.numpy()}

    out = _both(fn)
    t = out["port"]
    assert np.abs(t["mid"] - t["before"]).max() > 0
    np.testing.assert_array_equal(t["end"], t["mid"])
    _close(out)


@pytest.mark.parametrize("kind", ["global_norm", "norm", "value"])
def test_eager_gradient_clip(kind):
    """``set_gradient_clip`` applies in the eager update as in a program:
    the global-norm bound of the reference case, and each clip's update
    equal to the JAX package's."""
    def make(P):
        c = P.fluid.clip
        return {"global_norm": c.GradientClipByGlobalNorm(clip_norm=1e-3),
                "norm": c.GradientClipByNorm(clip_norm=1e-2),
                "value": c.GradientClipByValue(max=1e-2)}[kind]

    def fn(P, _):
        P.fluid.clip.set_gradient_clip(make(P))
        try:
            fc = P.dy.FC(4, 3)
            opt = P.fluid.optimizer.SGD(learning_rate=1.0)
            x = P.dy.to_variable(100 * np.arange(8, dtype=np.float32)
                                 .reshape(2, 4))
            w0 = fc.weight.numpy().copy()
            loss = P.dy.ops.reduce_mean(P.dy.ops.square(fc(x)))
            loss.backward()
            opt.minimize(loss, parameter_list=fc.parameters())
            return {"w0": w0, "w": fc.weight.numpy(), "b": fc.bias.numpy()}
        finally:
            P.fluid.clip.set_gradient_clip(None)

    out = _both(fn)
    if kind == "global_norm":
        t = out["port"]
        delta = np.sqrt(((t["w"] - t["w0"]) ** 2).sum())
        assert delta <= 1e-3 + 1e-7, delta
    _close(out)


@pytest.mark.parametrize("reg", ["l2", "l1"])
def test_eager_weight_decay(reg):
    def fn(P, _):
        r = P.fluid.regularizer
        decay = r.L2Decay(0.1) if reg == "l2" else r.L1Decay(0.1)
        fc = P.dy.FC(4, 3)
        opt = P.fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                         regularization=decay)
        x = P.dy.to_variable(np.ones((2, 4), np.float32))
        for _ in range(2):
            loss = P.dy.ops.reduce_mean(fc(x))
            loss.backward()
            opt.minimize(loss, parameter_list=fc.parameters())
            fc.clear_gradients()
        return {"w": fc.weight.numpy(), "b": fc.bias.numpy()}

    _close(_both(fn))
