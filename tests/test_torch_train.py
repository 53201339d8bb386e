"""The PyTorch port's training machinery against the JAX package's, on the
CPU: the generic ``<type>_grad`` of every op on the BERT path against
``jax.vjp`` through the reference's rule, ``append_backward`` + Adam
program parity, and the ``adam`` update against its formula."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.core import registry as jregistry
from paddle_tpu.lowering import LowerCtx as JLowerCtx

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.backward import _make_grad_op
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.framework import Program as TProgram
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.lowering import EMPTY_VAR_NAME

RNG = np.random.RandomState(11)
# float32 on both sides; the two differ in summation order only
ATOL, RTOL = 1e-5, 1e-4


def f32(*shape, lo=None):
    a = RNG.randn(*shape).astype(np.float32)
    return a if lo is None else np.abs(a) + lo


B, H, S, D = 2, 2, 8, 16
ATT_BIAS = np.where(np.arange(S)[None] < [[S], [5]], 0.0,
                    -10000.0).astype(np.float32).reshape(B, 1, 1, S)

# op type -> (inputs {slot: {var: array}}, attrs, output slots given a
# cotangent). Every float input gets a gradient unless its slot is no_grad.
GRAD_CASES = {
    "mean": ({"X": {"x": f32(3, 4)}}, {}, ["Out"]),
    "reduce_sum": ({"X": {"x": f32(2, 3, 4)}},
                   {"dim": [1], "keep_dim": False}, ["Out"]),
    "reduce_sum_all": ({"X": {"x": f32(2, 3, 4)}}, {"reduce_all": True},
                       ["Out"]),
    "softmax_with_cross_entropy": (
        {"Logits": {"lg": f32(2, 5, 7)},
         "Label": {"lb": np.array([[[3], [-100], [0], [6], [1]],
                                   [[2], [2], [-100], [5], [4]]], np.int64)}},
        {"ignore_index": -100}, ["Loss"]),
    "tanh": ({"X": {"x": f32(3, 4)}}, {}, ["Out"]),
    "elementwise_div": ({"X": {"x": f32(2, 3, 4)},
                         "Y": {"y": f32(3, lo=0.5)}}, {"axis": 1}, ["Out"]),
    "elementwise_max": ({"X": {"x": f32(2, 3)}, "Y": {"y": f32(2, 3)}}, {},
                        ["Out"]),
    "sum": ({"X": {"a": f32(3, 4), "b": f32(3, 4), "c": f32(3, 4)}}, {},
            ["Out"]),
    "slice": ({"Input": {"x": f32(2, 5, 4)}},
              {"axes": [1], "starts": [0], "ends": [1]}, ["Out"]),
    "slice_decrease": ({"Input": {"x": f32(2, 5, 4)}},
                       {"axes": [1, 2], "starts": [1, 0], "ends": [4, 1],
                        "decrease_axis": [2]}, ["Out"]),
    "dropout_test": ({"X": {"x": f32(3, 4)}},
                     {"dropout_prob": 0.3, "is_test": True}, ["Out"]),
    "lookup_table": ({"W": {"w": f32(10, 4)},
                      "Ids": {"ids": np.array([[3], [9], [12], [3]],
                                              np.int64)}}, {}, ["Out"]),
    "lookup_table_pad": ({"W": {"w": f32(10, 4)},
                          "Ids": {"ids": np.array([[3], [0], [7], [0]],
                                                  np.int64)}},
                         {"padding_idx": 0}, ["Out"]),
    "layer_norm": ({"X": {"x": f32(2, 5, 8)}, "Scale": {"s": f32(8)},
                    "Bias": {"b": f32(8)}}, {"begin_norm_axis": 2}, ["Y"]),
    "gelu": ({"X": {"x": f32(3, 4) * 2}}, {}, ["Out"]),
    "mul": ({"X": {"x": f32(2, 3, 8)}, "Y": {"y": f32(8, 5)}},
            {"x_num_col_dims": 2}, ["Out"]),
    "matmul": ({"X": {"x": f32(2, 3, 8)}, "Y": {"y": f32(6, 8)}},
               {"transpose_Y": True, "alpha": 0.5}, ["Out"]),
    "transpose2": ({"X": {"x": f32(2, 3, 4, 5)}}, {"axis": [0, 2, 1, 3]},
                   ["Out"]),
    "fused_multihead_attention": (
        {"Q": {"q": f32(B, H, S, D)}, "K": {"k": f32(B, H, S, D)},
         "V": {"v": f32(B, H, S, D)}, "BiasQK": {"bias": ATT_BIAS}},
        {"causal": True}, ["Out"]),
}


def _op_type(case_name):
    for suffix in ("_all", "_decrease", "_test", "_pad"):
        if case_name.endswith(suffix):
            return case_name[: -len(suffix)]
    return case_name


def _out_shapes(op_type, ins, attrs):
    """Forward outputs of the reference rule (their shapes set the
    cotangents' shapes)."""
    opdef = jregistry.get_op_def(op_type)
    full = {a: s.default for a, s in opdef.attrs.items()}
    full.update(attrs)
    vals = {slot: [jnp.asarray(a) for a in vs.values()]
            for slot, vs in ins.items()}
    return opdef, full, opdef.lower(JLowerCtx(), vals, full)


def _jax_grads(op_type, ins, attrs, ct_slots, cts):
    """jax.vjp through the reference's rule."""
    opdef, full, _ = _out_shapes(op_type, ins, attrs)
    diff = [(slot, i) for slot, vs in ins.items()
            if not opdef.input_spec(slot).no_grad
            for i, a in enumerate(vs.values()) if a.dtype.kind == "f"]
    base = {slot: [jnp.asarray(a) for a in vs.values()]
            for slot, vs in ins.items()}

    def f(*d):
        vals = {s: list(v) for s, v in base.items()}
        for (s, i), x in zip(diff, d):
            vals[s][i] = x
        outs = opdef.lower(JLowerCtx(), vals, full)
        return [outs[s][0] for s in ct_slots]

    _, vjp = jax.vjp(f, *[base[s][i] for s, i in diff])
    grads = vjp([jnp.asarray(c) for c in cts])
    return {list(ins[s])[i]: np.asarray(g) for (s, i), g in zip(diff, grads)}


def _port_grads(op_type, ins, attrs, ct_slots, cts, fetch_extra=()):
    """One forward op and its generic grad op in a port program, run on
    the CPU with the cotangents fed."""
    opdef = tregistry.get_op_def(op_type)
    main = TProgram()
    blk = main.global_block
    for vs in ins.values():
        for n, a in vs.items():
            blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                           is_data=True)
    outs = {o.name: [f"out_{o.name}"] for o in opdef.outputs}
    for names in outs.values():
        blk.create_var(name=names[0])
    fwd = blk.append_op(op_type, inputs={s: list(v) for s, v in ins.items()},
                        outputs=outs, attrs=dict(attrs))
    feed = {n: a for vs in ins.values() for n, a in vs.items()}
    out_grad = {}
    for o in opdef.outputs:
        name = f"out_{o.name}@GRAD"
        if o.name in ct_slots:
            blk.create_var(name=name, shape=cts[ct_slots.index(o.name)].shape,
                           is_data=True)
            feed[name] = cts[ct_slots.index(o.name)]
            out_grad[o.name + "@GRAD"] = [name]
        else:
            out_grad[o.name + "@GRAD"] = [EMPTY_VAR_NAME]
    in_grad, wanted = {}, []
    for slot, vs in ins.items():
        if opdef.input_spec(slot).no_grad:
            continue
        in_grad[slot + "@GRAD"] = [n + "@GRAD" for n in vs]
        for n, a in vs.items():
            blk.create_var(name=n + "@GRAD")
            if a.dtype.kind == "f":
                wanted.append(n)
    desc = _make_grad_op(fwd, out_grad, in_grad)
    blk.append_op(desc["type"], inputs=desc["inputs"],
                  outputs=desc["outputs"], attrs=desc["attrs"])
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[n + "@GRAD" for n in wanted]
        + list(fetch_extra), scope=tfluid.Scope())
    return dict(zip(wanted, got[:len(wanted)])), got[len(wanted):]


def test_every_new_op_type_has_a_grad_case():
    new = {"mean", "reduce_sum", "softmax_with_cross_entropy", "tanh",
           "elementwise_div", "elementwise_max", "sum", "slice", "dropout"}
    covered = {_op_type(c) for c in GRAD_CASES}
    assert new <= covered
    assert {"lookup_table", "layer_norm", "gelu", "mul", "matmul",
            "transpose2"} <= covered


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_generic_grad_matches_jax_vjp(case):
    ins, attrs, ct_slots = GRAD_CASES[case]
    op_type = _op_type(case)
    _, _, outs = _out_shapes(op_type, ins, attrs)
    cts = [np.asarray(RNG.randn(*np.shape(outs[s][0])), np.float32)
           for s in ct_slots]
    want = _jax_grads(op_type, ins, attrs, ct_slots, cts)
    got, _ = _port_grads(op_type, ins, attrs, ct_slots, cts)
    assert set(got) == set(want) and got
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=ATOL, rtol=RTOL,
                                   err_msg=n)


def test_dropout_grad_regenerates_the_forward_mask():
    """The grad op recomputes dropout with the forward op's uid, so its
    mask is the one the forward drew: X@GRAD = Out@GRAD * Mask / (1 - p).
    (The bits differ from jax.random's, so this is checked in the port.)"""
    x = f32(64, 32)
    ct = RNG.randn(64, 32).astype(np.float32)
    got, (mask,) = _port_grads(
        "dropout", {"X": {"x": x}},
        {"dropout_prob": 0.25, "dropout_implementation": "upscale_in_train"},
        ["Out"], [ct], fetch_extra=["out_Mask"])
    assert 0.65 < mask.mean() < 0.85
    np.testing.assert_allclose(got["x"], ct * mask / 0.75, atol=1e-6,
                               rtol=1e-6)


def _tiny_net(pkg, un):
    """A tied-weight classifier: the embedding table feeds the lookup and
    the output matmul, so its grad is summed; the label count is fenced
    with stop_gradient."""
    with un.guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            L = pkg.layers
            ids = L.data("ids", shape=[6], dtype="int64")
            lbl = L.data("lbl", shape=[6], dtype="int64")
            emb = L.embedding(ids, (20, 8), param_attr=pkg.ParamAttr(
                name="emb", initializer=pkg.initializer.TruncatedNormal(
                    0.0, 0.02)))
            h = L.fc(emb, 8, num_flatten_dims=2, act="tanh",
                     param_attr=pkg.ParamAttr(
                         name="w1",
                         initializer=pkg.initializer.TruncatedNormal(
                             0.0, 0.1)))
            h = L.dropout(h, 0.0, dropout_implementation="upscale_in_train")
            logits = L.matmul(h, main.global_block.var("emb"),
                              transpose_y=True)
            ce = L.softmax_with_cross_entropy(logits, L.unsqueeze(lbl, [2]),
                                              ignore_index=-100)
            cnt = L.reduce_sum(L.cast(L.not_equal(
                L.unsqueeze(lbl, [2]), L.fill_constant([1], "int64", -100)),
                "float32"))
            cnt.stop_gradient = True
            loss = L.elementwise_div(
                L.reduce_sum(ce), L.elementwise_max(
                    cnt, L.fill_constant([1], "float32", 1.0)))
            cls = L.reshape(L.slice(h, axes=[1], starts=[0], ends=[1]),
                            [0, 8])
            loss = L.elementwise_add(loss, L.mean(cls))
            ops, params_grads = pkg.optimizer.Adam(
                learning_rate=0.01).minimize(loss)
    return main, startup, loss, params_grads


def _normalized(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def test_append_backward_and_adam_program_dicts_match_jax():
    j = _tiny_net(fluid, jun)
    t = _tiny_net(tfluid, tun)
    assert _normalized(t[0]) == _normalized(j[0])
    assert _normalized(t[1]) == _normalized(j[1])
    ops = [o.type for o in t[0].global_block.ops]
    assert "sum" in ops and "lookup_table_grad" in ops
    assert ops.count("adam") == 3
    roles = {o.attrs["__op_role__"] for o in t[0].global_block.ops
             if o.type.endswith("_grad")}
    assert roles == {"backward"}
    assert [p.name for p, _ in t[3]] == [p.name for p, _ in j[3]]


def test_tiny_train_steps_match_jax():
    """Three Adam steps of the tied-weight net from the JAX package's
    initial scope: every persistable (parameters, both moments, the beta
    powers) carried over by name and compared after the steps."""
    (jmain, jstart, jloss, _), (tmain, _, tloss, _) = (
        _tiny_net(fluid, jun), _tiny_net(tfluid, tun))
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.global_block.vars.values()]
    state = {n: jscope.numpy(n) for n in names}
    assert any(n.startswith("moment1_") for n in names)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy(state, tscope, tfluid.CPUPlace(), programs=[tmain])
    feed = {"ids": RNG.randint(0, 20, (3, 6)).astype(np.int64),
            "lbl": np.where(RNG.rand(3, 6) < 0.5, RNG.randint(0, 20, (3, 6)),
                            -100).astype(np.int64)}
    for _ in range(3):
        jl = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)[0]
        tl = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)[0]
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   atol=1e-6, rtol=1e-4, err_msg=n)


def test_grad_vars_can_be_fetched():
    main, startup, loss, params_grads = _tiny_net(tfluid, tun)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"ids": np.arange(12).reshape(2, 6).astype(np.int64),
            "lbl": np.arange(12).reshape(2, 6).astype(np.int64)}
    g = exe.run(main, feed=feed, fetch_list=[params_grads[0][1]],
                scope=scope)[0]
    assert params_grads[0][1].name == "emb@GRAD"
    assert g.shape == (20, 8) and np.abs(g).sum() > 0


def test_adam_op_matches_its_formula():
    """The dense Adam update with bias correction from the current beta
    powers (which then advance), computed in float64 numpy."""
    p, g = f32(4, 3), f32(4, 3)
    m1, m2 = f32(4, 3) * 0.1, np.abs(f32(4, 3)) * 0.01
    b1p, b2p = np.float32([0.9 ** 3]), np.float32([0.999 ** 3])
    lr = np.float32([0.01])
    b1, b2, eps = 0.9, 0.999, 1e-8
    outs = tregistry.get_op_def("adam").lower(
        None, {k: [torch.from_numpy(np.array(v))] for k, v in dict(
            Param=p, Grad=g, LearningRate=lr, Moment1=m1, Moment2=m2,
            Beta1Pow=b1p, Beta2Pow=b2p).items()},
        {"beta1": b1, "beta2": b2, "epsilon": eps})
    m1o = b1 * m1 + (1 - b1) * g.astype(np.float64)
    m2o = b2 * m2 + (1 - b2) * g.astype(np.float64) ** 2
    lr_t = lr[0] * np.sqrt(1 - b2p[0]) / (1 - b1p[0])
    po = p - lr_t * m1o / (np.sqrt(m2o) + eps)
    for slot, want in (("ParamOut", po), ("Moment1Out", m1o),
                       ("Moment2Out", m2o), ("Beta1PowOut", b1p * b1),
                       ("Beta2PowOut", b2p * b2)):
        np.testing.assert_allclose(outs[slot][0].numpy(), want, rtol=1e-5,
                                   atol=1e-7, err_msg=slot)
