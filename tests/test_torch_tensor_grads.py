"""The gradient of every differentiable op the control-flow slice added
from ``ops/tensor.py`` and ``ops/loss.py``, through ``calc_gradient`` in
both packages on the CPU: the port's rule (its own ``grad_lower`` for
``gather``, ``gather_nd``, ``scatter``, ``scatter_nd_add`` and
``lookup_table_v2``, which sum in a fixed order; the generic autograd
replay otherwise) against the JAX package's ``jax.vjp``, with a random
cotangent on each output of the op's first slot. Repeated indices make the
scatter-adds sum. Both sides compute in float32: rtol 1e-5 / atol 1e-6.
Inputs keep clear of the kinks of the piecewise losses."""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.core import registry as treg

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
RTOL, ATOL = 1e-5, 1e-6
RNG = np.random.RandomState(11)


def f32(*shape, lo=-2.0, hi=2.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def i64(*vals):
    return np.array(vals, np.int64)


_P = RNG.dirichlet(np.ones(5), 4).astype(np.float32)
_BIN = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)

# case -> (op type, inputs {slot: array or [arrays]}, outputs {slot: n},
#          attrs)
CASES = {
    "concat": ("concat", {"X": [f32(2, 3), f32(2, 5)]}, {"Out": 1},
               {"axis": 1}),
    "split": ("split", {"X": f32(2, 9)}, {"Out": 3},
              {"sections": [2, 3, 4], "axis": 1}),
    "squeeze2": ("squeeze2", {"X": f32(2, 1, 3, 1)},
                 {"Out": 1, "XShape": 1}, {"axes": [1]}),
    "stack": ("stack", {"X": [f32(2, 3), f32(2, 3)]}, {"Y": 1},
              {"axis": 2}),
    "unstack": ("unstack", {"X": f32(2, 3, 4)}, {"Y": 3},
                {"axis": 1, "num": 3}),
    "expand": ("expand", {"X": f32(2, 1, 3)}, {"Out": 1},
               {"expand_times": [2, 4, 1]}),
    "gather": ("gather", {"X": f32(6, 3), "Index": i64(5, 0, 5, 2, 5)},
               {"Out": 1}, {}),
    "scatter": ("scatter", {"X": f32(6, 3), "Ids": i64(4, 1),
                            "Updates": f32(2, 3)}, {"Out": 1},
                {"overwrite": True}),
    "scatter:add": ("scatter", {"X": f32(6, 3), "Ids": i64(4, 1, 4),
                                "Updates": f32(3, 3)}, {"Out": 1},
                    {"overwrite": False}),
    "lookup_table_v2": ("lookup_table_v2",
                        {"W": f32(10, 4),
                         "Ids": i64(3, 0, 3, 5, 3, 0).reshape(2, 3)},
                        {"Out": 1}, {"padding_idx": 0}),
    "cumsum": ("cumsum", {"X": f32(3, 5)}, {"Out": 1},
               {"axis": 1, "exclusive": True, "reverse": True}),
    "flatten2": ("flatten2", {"X": f32(2, 3, 4)}, {"Out": 1, "XShape": 1},
                 {"axis": 2}),
    "pad": ("pad", {"X": f32(2, 3)}, {"Out": 1},
            {"paddings": [1, 0, 2, 3], "pad_value": 0.5}),
    "gather_nd": ("gather_nd", {"X": f32(4, 5, 3),
                                "Index": i64(1, 2, 3, 4, 1, 2)
                                .reshape(3, 2)}, {"Out": 1}, {}),
    "scatter_nd_add": ("scatter_nd_add",
                       {"X": f32(4, 5), "Index": i64(1, 2, 3, 4, 1, 2)
                        .reshape(3, 2), "Updates": f32(3)}, {"Out": 1}, {}),
    "reverse": ("reverse", {"X": f32(2, 3, 4)}, {"Out": 1},
                {"axis": [0, 2]}),
    "expand_as": ("expand_as", {"X": f32(2, 3), "target_tensor": f32(4, 6)},
                  {"Out": 1}, {}),
    "pad2d": ("pad2d", {"X": f32(2, 3, 4, 5)}, {"Out": 1},
              {"paddings": [1, 2, 2, 1], "mode": "reflect"}),
    "pad2d:edge": ("pad2d", {"X": f32(2, 4, 5, 3)}, {"Out": 1},
                   {"paddings": [2, 0, 1, 1], "mode": "edge",
                    "data_format": "NHWC"}),
    "roll": ("roll", {"X": f32(3, 4)}, {"Out": 1},
             {"shifts": [1, -2], "axis": [0, 1]}),
    "reduce_mean": ("reduce_mean", {"X": f32(2, 3, 4)}, {"Out": 1},
                    {"dim": [0, -1]}),
    "reduce_max": ("reduce_max", {"X": f32(2, 3, 4)}, {"Out": 1},
                   {"dim": [1], "keep_dim": True}),
    "reduce_max:ties": ("reduce_max",
                        {"X": np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]],
                                       np.float32)}, {"Out": 1},
                        {"dim": [1]}),
    "reduce_min": ("reduce_min", {"X": f32(2, 3, 4)}, {"Out": 1},
                   {"reduce_all": True}),
    "reduce_prod": ("reduce_prod", {"X": f32(2, 3, 4, lo=0.5, hi=1.5)},
                    {"Out": 1}, {"dim": [0, 2]}),
    "cross_entropy": ("cross_entropy",
                      {"X": _P, "Label": i64(1, -100, 4, 0).reshape(4, 1)},
                      {"Y": 1}, {}),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits",
        {"X": f32(4, 3), "Label": np.array([[1, 0, -100], [0, 1, 1],
                                            [1, 1, 0], [0, 0, 1]],
                                           np.float32)},
        {"Out": 1}, {"normalize": True}),
    "square_error_cost": ("square_error_cost",
                          {"X": f32(4, 1), "Y": f32(4, 1)}, {"Out": 1}, {}),
    "huber_loss": ("huber_loss", {"X": np.array([[0.1], [2.0], [-1.5],
                                                 [0.4]], np.float32),
                                  "Y": np.array([[0.3], [0.2], [0.5],
                                                 [-0.9]], np.float32)},
                   {"Out": 1, "Residual": 1}, {"delta": 0.8}),
    "smooth_l1_loss": ("smooth_l1_loss",
                       {"X": f32(3, 4), "Y": f32(3, 4) + 0.07,
                        "InsideWeight": f32(3, 4, lo=0.5, hi=1.5),
                        "OutsideWeight": f32(3, 4, lo=0.5, hi=1.5)},
                       {"Out": 1, "Diff": 1}, {"sigma": 1.5}),
    "log_loss": ("log_loss", {"Predicted": _P[:, :1], "Labels": _BIN},
                 {"Loss": 1}, {}),
    "kldiv_loss": ("kldiv_loss", {"X": np.log(_P),
                                  "Target": np.where(_P > 0.1, _P, 0.0)
                                  .astype(np.float32)},
                   {"Loss": 1}, {"reduction": "none"}),
    "hinge_loss": ("hinge_loss", {"Logits": np.array([[0.3], [-0.4], [1.7],
                                                      [0.6]], np.float32),
                                  "Labels": _BIN}, {"Loss": 1}, {}),
    "margin_rank_loss": ("margin_rank_loss",
                         {"Label": np.array([[1.0], [-1.0], [1.0]],
                                            np.float32),
                          "X1": np.array([[0.5], [0.2], [-0.3]], np.float32),
                          "X2": np.array([[0.1], [0.9], [0.4]],
                                         np.float32)},
                         {"Out": 1, "Activated": 1}, {"margin": 0.1}),
    "rank_loss": ("rank_loss", {"Label": np.array([[1.0], [0.0], [0.5]],
                                                  np.float32),
                                "Left": f32(3, 1), "Right": f32(3, 1)},
                  {"Out": 1}, {}),
    "bpr_loss": ("bpr_loss", {"X": f32(4, 5),
                              "Label": i64(1, 4, 0, 2).reshape(4, 1)},
                 {"Y": 1}, {}),
    "cos_sim": ("cos_sim", {"X": f32(4, 6), "Y": f32(4, 6)},
                {"Out": 1, "XNorm": 1, "YNorm": 1}, {}),
}


def _slot_items(ins):
    for slot, a in ins.items():
        for k, arr in enumerate(a if isinstance(a, list) else [a]):
            yield slot, f"{slot.lower()}{k}", arr


def _program(pkg, op_type, ins, outs, attrs):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            blk = main.global_block
            vars_, diff = {}, []
            for slot, name, arr in _slot_items(ins):
                v = fl.layers.data(name, shape=list(arr.shape),
                                   dtype=str(arr.dtype),
                                   append_batch_size=False)
                spec = treg.get_op_def(op_type).input_spec(slot)
                v.stop_gradient = arr.dtype != np.float32 or spec.no_grad
                if not v.stop_gradient:
                    diff.append(v)
                vars_.setdefault(slot, []).append(v)
            made = {slot: [blk.create_var(name=f"{slot.lower()}_out{k}",
                                          dtype="float32")
                           for k in range(n)] for slot, n in outs.items()}
            blk.append_op(op_type, inputs=vars_, outputs=made,
                          attrs=dict(attrs))
            first = made[next(iter(outs))]
            terms = []
            for k, o in enumerate(first):
                w = fl.layers.data(f"ct{k}", shape=[-1], dtype="float32",
                                   append_batch_size=False)
                terms.append(fl.layers.reduce_sum(
                    fl.layers.elementwise_mul(o, w)))
            loss = terms[0] if len(terms) == 1 else fl.layers.sums(terms)
            grads = fl.gradients([loss], diff)
    return main, [o.name for o in first], grads


def _norm(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def test_every_differentiable_new_op_has_a_case():
    """Every op type of the JAX package's ops/tensor.py and ops/loss.py
    with a gradient that the port registers since the control-flow slice
    is covered, and each has a gradient in the port iff it has one in the
    JAX package."""
    from paddle_tpu.core import registry as jreg

    new = {"fill_constant_batch_size_like", "fill_zeros_like",
           "assign_value", "shape", "concat", "split", "squeeze2", "stack",
           "unstack", "expand", "gather", "scatter", "one_hot",
           "lookup_table_v2", "arg_max", "arg_min", "argsort", "cumsum",
           "range", "flatten2", "pad", "gather_nd", "scatter_nd_add",
           "reverse", "expand_as", "diag", "eye", "pad2d", "roll",
           "shard_index", "uniform_random_batch_size_like",
           "gaussian_random_batch_size_like", "reduce_max", "reduce_min",
           "reduce_mean", "reduce_prod", "reduce_all", "reduce_any",
           "cross_entropy", "sigmoid_cross_entropy_with_logits",
           "square_error_cost", "huber_loss", "smooth_l1_loss", "log_loss",
           "auc", "kldiv_loss", "hinge_loss", "margin_rank_loss",
           "rank_loss", "bpr_loss", "cos_sim", "mean_iou",
           "precision_recall"}
    assert len(new) == 53
    for t in new:
        assert (treg.get_op_def(t).grad is None) == \
            (jreg.get_op_def(t).grad is None), t
    with_grad = {t for t in new if treg.get_op_def(t).grad is not None}
    assert with_grad == {c[0] for c in CASES.values()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_and_loss_grads_match_jax(case):
    op_type, ins, outs, attrs = CASES[case]
    feed = {name: arr for _, name, arr in _slot_items(ins)}
    got, dicts = {}, {}
    for pkg in PKGS:
        fl = PKGS[pkg][0]
        main, out_names, grads = _program(pkg, op_type, ins, outs, attrs)
        zeros = {f"ct{k}": np.zeros(1, np.float32)
                 for k in range(len(out_names))}
        shapes = [a.shape for a in fl.Executor(fl.CPUPlace()).run(
            main, feed=dict(feed, **zeros), fetch_list=out_names,
            scope=fl.Scope())]
        w = {f"ct{k}": np.asarray(np.random.RandomState(5 + k).randn(*s),
                                 np.float32) for k, s in enumerate(shapes)}
        got[pkg] = [np.asarray(a) for a in fl.Executor(fl.CPUPlace()).run(
            main, feed=dict(feed, **w),
            fetch_list=out_names + [g.name for g in grads],
            scope=fl.Scope())]
        dicts[pkg] = _norm(main)
    assert dicts["torch"] == dicts["jax"]
    assert len(got["torch"]) == len(got["jax"]) > next(iter(outs.values()))
    for a, b in zip(got["torch"], got["jax"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _layers_program(fl, L):
    """Each layer function the slice added, once, over three data vars."""
    x = L.data("x", shape=[2, 3, 4], dtype="float32",
               append_batch_size=False)
    p = L.data("p", shape=[4, 5], dtype="float32", append_batch_size=False)
    ids = L.data("ids", shape=[4, 1], dtype="int64", append_batch_size=False)
    flat = L.reshape(x, [6, 4])
    outs = [
        L.concat([x, x], axis=1), *L.split(x, [1, 2], dim=1),
        L.squeeze(L.unsqueeze(x, [0]), [0]), L.stack([x, x], axis=0),
        *L.unstack(x, axis=0), L.expand(x, [1, 2, 1]),
        L.gather(flat, L.reshape(ids, [4])),
        L.scatter(flat, L.assign(np.array([5, 1], np.int64)),
                  L.fill_constant([2, 4], "float32", 2.0)),
        L.shape(x), L.pad(flat, [1, 0, 0, 2], pad_value=1.5),
        L.arg_max(p, axis=1), L.arg_min(p, axis=0),
        *L.argsort(p, axis=1, descending=True), L.cumsum(p, axis=1),
        L.one_hot(ids, 5), L.flatten(x, axis=2), L.reduce_mean(x, dim=[1]),
        L.reduce_max(x), L.reduce_min(x, dim=2, keep_dim=True),
        L.reduce_prod(L.softmax(p), dim=1),
        L.reduce_all(L.greater_than(p, L.fill_constant([1], "float32",
                                                        -9.0)), dim=[0]),
        L.reduce_any(L.less_than(p, L.fill_constant([1], "float32", 0.0))),
        L.cross_entropy(L.softmax(p), ids),
        L.square_error_cost(p, L.scale(p, scale=0.5)),
        L.sigmoid_cross_entropy_with_logits(p, L.ones_like(p)),
        L.huber_loss(p, L.zeros_like(p), 0.5),
        L.smooth_l1(p, L.scale(p, scale=0.0, bias=0.1)),
        L.log_loss(L.sigmoid(p), L.ones_like(p)), L.cos_sim(p, p),
        L.sums([p, p]), L.mul(p, L.transpose(p, [1, 0])),
        L.gather_nd(x, L.assign(np.array([[1, 2], [0, 0]], np.int64))),
        L.scatter_nd_add(flat, L.assign(np.array([[1], [1]], np.int64)),
                         L.ones([2, 4], "float32")),
        L.pad2d(L.reshape(x, [1, 2, 3, 4]), [1, 0, 0, 1]),
        L.shard_index(ids, 10, 2, 1),
        L.rank_loss(L.ones([4, 1], "float32"), L.slice(p, [1], [0], [1]),
                    L.slice(p, [1], [1], [2])),
        L.margin_rank_loss(L.ones([4, 1], "float32"),
                           L.slice(p, [1], [0], [1]),
                           L.slice(p, [1], [1], [2])),
        L.kldiv_loss(L.log_softmax(p), L.softmax(p)),
        L.bpr_loss(p, ids), *L.mean_iou(ids, ids, 5),
        L.fill_constant_batch_size_like(p, [-1, 3], "float32", 0.5),
        L.zeros([2], "int64"), L.tensor.range(0, 5, 2, "int64"),
        L.linspace(0.0, 1.0, 5), L.cast(L.ones([2], "float32"), "int32")]
    acc = L.create_tensor("float32", persistable=True)
    L.assign(np.full([1], 4.0, np.float32), acc)
    g = L.create_global_var([2], 3.0, "float32", persistable=True,
                            name="gvar")
    return outs + [acc, g]


def test_new_layers_build_and_run_the_jax_programs():
    """The layer functions build the JAX package's programs (main and
    startup ``to_dict()`` equal) and compute its values."""
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(2, 3, 4).astype(np.float32),
            "p": rng.randn(4, 5).astype(np.float32),
            "ids": np.array([[3], [0], [4], [1]], np.int64)}
    got, dicts = {}, {}
    for pkg in PKGS:
        fl, un = PKGS[pkg]
        with un.guard():
            main, startup = fl.Program(), fl.Program()
            with fl.program_guard(main, startup):
                outs = _layers_program(fl, fl.layers)
        dicts[pkg] = (_norm(main), _norm(startup))
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        got[pkg] = [np.asarray(a) for a in exe.run(
            main, feed=feed, fetch_list=[o.name for o in outs],
            scope=scope)]
    assert dicts["torch"] == dicts["jax"]
    for a, b in zip(got["torch"], got["jax"]):
        assert a.shape == b.shape
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b.astype(a.dtype))
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
