"""The PyTorch port's static checks (``analysis/static_checks.py``: PT70x
whole-program dtype/shape replay, PT71x donation/alias races, PT72x dead
code and the ``dce_program`` transform) against the JAX package's, on the
CPU.

Each program of the JAX package's ``tests/test_pass_manager.py`` static-
check section is built in both packages by one shared build function
under ``unique_name.guard()`` (the malformed ones mutated after append the
same way in both), and each registered pass runs through each package's
``PassManager``. Compared exactly: the diagnostics by (code, severity,
block, op index, op type) and their messages, with the dtype words int32
and int64 read as one (the port keeps int64 where the JAX package keeps
int32, by design); the DCE decision and the DCE'd program under
``to_dict()`` (``op_callstack`` dropped, dtypes normalised the same way).
Then each case's own assertion on the port, as the JAX package's test
makes it, and the DCE'd program's fetch equal to the original's on the
port's executor (bit for bit: the same op rules on the same inputs).
"""
import contextlib
import re
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis import default_pass_manager as j_manager
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.analysis import (dce_program,
                                       default_pass_manager as t_manager)
from paddle_tpu_torch.core import registry as treg

JAX = types.SimpleNamespace(name="jax", fl=jfluid, un=jun, pm=j_manager,
                            reg=jreg)
PORT = types.SimpleNamespace(name="port", fl=tfluid, un=tun, pm=t_manager,
                             reg=treg)


def _norm(text):
    return re.sub(r"int32|int64", "int", text)


def _key(d):
    return (d.code, d.severity, d.block_idx, d.op_idx, d.op_type)


def _program(P, build):
    with P.un.guard():
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup):
            handles = build(P, main)
    return main, handles


def _run(P, prog, passes, fetches=(), feeds=(), verify="none"):
    return P.pm().run_pipeline(prog, passes, feed_names=list(feeds),
                               fetch_names=list(fetches), verify=verify)


def both(build, passes, fetch=lambda h: [h.name], feeds=(),
         verify="none"):
    """Build in both packages, run ``passes``, assert equal diagnostics;
    returns the port's (result, program, handles)."""
    got = {}
    for P in (JAX, PORT):
        prog, h = _program(P, build)
        res = _run(P, prog, passes, fetch(h), feeds, verify)
        got[P.name] = (res, prog, h)
    jd, td = got["jax"][0].diagnostics, got["port"][0].diagnostics
    assert sorted(map(_key, td)) == sorted(map(_key, jd))
    assert sorted((_key(d), _norm(d.message)) for d in td) == \
        sorted((_key(d), _norm(d.message)) for d in jd)
    return got["port"]


def codes_of(res):
    return {d.code for d in res.diagnostics}


@contextlib.contextmanager
def _ops(**defs):
    """Register test-only op types in both registries for one test."""
    added = []
    try:
        for P in (JAX, PORT):
            for name, make in defs.items():
                if not P.reg.has_op(name):
                    P.reg._OP_REGISTRY[name] = make(P.reg)
                    added.append((P.reg, name))
        yield
    finally:
        for reg, name in added:
            del reg._OP_REGISTRY[name]


# ---------------------------------------------------------------------------
# programs (the JAX package's, one build function each)
# ---------------------------------------------------------------------------

def _mlp(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    y = P.fl.layers.data("y", shape=[1], dtype="float32")
    h = P.fl.layers.fc(x, 8, act="relu")
    pred = P.fl.layers.fc(h, 1)
    loss = P.fl.layers.mean(P.fl.layers.square(
        P.fl.layers.elementwise_sub(pred, y)))
    P.fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _clean_chain(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    h = P.fl.layers.relu(x)
    out = P.fl.layers.scale(h, scale=2.0)
    return h, out


def _stale(mutate):
    def build(P, main):
        h, out = _clean_chain(P, main)
        mutate(main.global_block.var(h.name))
        return out
    return build


def _conflicting_producers(P, main):
    blk = main.global_block
    blk.create_var(name="v", shape=[2], dtype="float32")
    blk.append_op("fill_constant", outputs={"Out": ["v"]},
                  attrs={"shape": [2], "dtype": "float32", "value": 1.0})
    blk.append_op("fill_constant", outputs={"Out": ["v"]},
                  attrs={"shape": [3], "dtype": "int64", "value": 2.0})
    return P.fl.layers.scale(blk.var("v"), scale=1.0)


def _shapeless(P, main):
    u = main.global_block.create_var(name="u", shape=None, dtype="float32")
    return P.fl.layers.relu(u)


def _donation_race(read_after_write):
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        w = main.global_block.create_parameter("w_state", [4], "float32")
        h = P.fl.layers.elementwise_add(x, w)
        P.fl.layers.assign(h, output=w)
        return P.fl.layers.scale(w if read_after_write else h, scale=1.0)
    return build


def _double_write(read_between):
    def build(P, main):
        blk = main.global_block
        blk.create_var(name="v", shape=[2], dtype="float32")
        blk.append_op("fill_constant", outputs={"Out": ["v"]},
                      attrs={"shape": [2], "dtype": "float32",
                             "value": 1.0})
        mid = P.fl.layers.scale(blk.var("v"), scale=1.0) \
            if read_between else None
        blk.append_op("fill_constant", outputs={"Out": ["v"]},
                      attrs={"shape": [2], "dtype": "float32",
                             "value": 2.0})
        if mid is not None:
            return P.fl.layers.elementwise_add(mid, blk.var("v"))
        return P.fl.layers.scale(blk.var("v"), scale=1.0)
    return build


def _alias_fetch(view_before_update):
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        w = main.global_block.create_parameter("w_al", [4], "float32")
        h = P.fl.layers.elementwise_add(x, w)
        if view_before_update:
            snap = P.fl.layers.assign(w)
            P.fl.layers.assign(h, output=w)
        else:
            P.fl.layers.assign(h, output=w)
            snap = P.fl.layers.assign(w)
        return snap
    return build


def _write_feed(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    main.global_block.append_op("scale", inputs={"X": [x.name]},
                                outputs={"Out": [x.name]},
                                attrs={"scale": 2.0})
    return P.fl.layers.relu(x)


def _dead_chain(P, main):
    """h is live; a=scale(h) is read ONLY by b=scale(a); b is read by
    nobody — a is dead only transitively."""
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    h = P.fl.layers.relu(x)
    a = P.fl.layers.scale(h, scale=2.0)
    b = P.fl.layers.scale(a, scale=3.0)
    out = P.fl.layers.scale(h, scale=4.0)
    return types.SimpleNamespace(name=out.name, a=a, b=b)


def _accuracy(P, main):
    x = P.fl.layers.data("x", shape=[8], dtype="float32")
    label = P.fl.layers.data("label", shape=[1], dtype="int64")
    return P.fl.layers.accuracy(P.fl.layers.fc(x, 4), label)


def _orphan_block(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    out = P.fl.layers.relu(x)
    main._create_block()      # orphan: no op carries sub_block=1
    main._rollback()
    return out


# ---------------------------------------------------------------------------
# PT70x — whole-program dtype/shape replay
# ---------------------------------------------------------------------------

def _strict_infer_def(reg):
    def strict_infer(op, block):
        v = block.var(op.inputs["X"][0])
        if v.shape is not None and tuple(v.shape)[-1] != 4:
            raise ValueError(f"pm_strict_infer wants last dim 4, got "
                             f"{v.shape}")
        block.var(op.outputs["Out"][0]).shape = v.shape

    return reg.OpDef(type="pm_strict_infer", inputs=[reg.IOSpec("X")],
                     outputs=[reg.IOSpec("Out")], infer_shape=strict_infer,
                     lower=lambda ctx, ins, attrs: None)


def test_pt700_infer_failure_under_propagation():
    def build(P, main):
        h, out = _clean_chain(P, main)
        blk = main.global_block
        o = blk.create_var(name="pm_strict_out", shape=[4],
                           dtype="float32")
        blk.append_op("pm_strict_infer", inputs={"X": [h.name]},
                      outputs={"Out": [o.name]})
        return types.SimpleNamespace(name=out.name, h=h)

    def drift(P, main):
        h = build(P, main)
        blk = main.global_block
        blk.var("x").shape = (-1, 9)
        blk.var(h.h.name).shape = (-1, 4)
        return h

    with _ops(pm_strict_infer=_strict_infer_def):
        res, _, _ = both(build, ("dtype_shape_check",))
        assert "PT700" not in codes_of(res)   # consistent metadata
        res, _, _ = both(drift, ("dtype_shape_check",))
        assert "PT700" in codes_of(res)


def test_pt701_shape_mismatch_at_consumer_boundary():
    res, _, _ = both(_stale(lambda v: setattr(v, "shape", (9, 9))),
                     ("dtype_shape_check",))
    found = [d for d in res.diagnostics if d.code == "PT701"]
    assert found and "scale" in found[0].message


def test_pt702_dtype_mismatch_at_consumer_boundary():
    res, _, _ = both(_stale(lambda v: setattr(v, "dtype", "int64")),
                     ("dtype_shape_check",))
    assert "PT702" in codes_of(res)


def test_pt703_conflicting_producers():
    res, _, _ = both(_conflicting_producers, ("dtype_shape_check",))
    assert "PT703" in codes_of(res)


def test_pt704_shapeless_consumer_boundary():
    res, _, _ = both(_shapeless, ("dtype_shape_check",))
    assert "PT704" in codes_of(res)


def test_pt700s_negative_control_clean_program():
    res, main, _ = both(_mlp, ("dtype_shape_check",))
    assert not res.diagnostics, [str(d) for d in res.diagnostics]
    # read-only: metadata restored after the replay
    assert main.global_block.var("x").shape == (-1, 4)


# ---------------------------------------------------------------------------
# PT71x — donation/alias races
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("race", [True, False])
def test_pt710_donated_then_read_race(race):
    res, _, _ = both(_donation_race(race), ("donation_race",), feeds=["x"])
    found = [d for d in res.diagnostics if d.code == "PT710"]
    assert bool(found) == race
    if race:
        assert "w_state" in found[0].message


@pytest.mark.parametrize("read_between", [False, True])
def test_pt711_unordered_double_write(read_between):
    res, _, _ = both(_double_write(read_between), ("donation_race",))
    assert ("PT711" in codes_of(res)) == (not read_between)


@pytest.mark.parametrize("before", [True, False])
def test_pt712_fetch_views_donated_buffer(before):
    res, _, _ = both(_alias_fetch(before), ("donation_race",), feeds=["x"])
    found = [d for d in res.diagnostics if d.code == "PT712"]
    assert bool(found) == before
    if before:
        assert "w_al" in found[0].message


def test_pt713_write_to_feed_var():
    res, _, _ = both(_write_feed, ("donation_race",), feeds=["x"])
    assert "PT713" in codes_of(res)


def test_pt710s_negative_control_clean_training_program():
    res, _, _ = both(_mlp, ("donation_race",), feeds=["x", "y"])
    assert not codes_of(res) & {"PT711", "PT712", "PT713"}


# ---------------------------------------------------------------------------
# PT72x — dead code
# ---------------------------------------------------------------------------

def test_pt720_transitive_dead_chain():
    res, _, _ = both(_dead_chain, ("dead_code", "liveness"))
    assert sum(d.code == "PT720" for d in res.diagnostics) == 2
    pt502 = {d.op_idx for d in res.diagnostics if d.code == "PT502"}
    pt720 = {d.op_idx for d in res.diagnostics if d.code == "PT720"}
    assert pt720 > pt502


def test_pt720_negative_control():
    res, _, _ = both(_mlp, ("dead_code",))
    assert "PT720" not in codes_of(res)


def test_pt721_unused_output_of_live_op():
    res, _, _ = both(_accuracy, ("dead_code",))
    found = [d for d in res.diagnostics if d.code == "PT721"]
    assert found and all(d.op_type == "accuracy" for d in found)
    assert "PT720" not in codes_of(res)


def test_pt722_unreachable_sub_block():
    res, _, _ = both(_orphan_block, ("dead_code",))
    assert "PT722" in codes_of(res)


# ---------------------------------------------------------------------------
# the DCE transform
# ---------------------------------------------------------------------------

def _canon(prog):
    d = prog.to_dict()
    for blk in d["blocks"]:
        for op in blk["ops"]:
            op["attrs"].pop("op_callstack", None)
    return _norm(repr(d))


def test_dce_removes_dead_chain_and_preserves_results():
    res, prog, h = both(_dead_chain, ("dce",), verify="strict")
    dec = res.values["dce"]
    assert dec.applied and dec.removed_ops == 2
    assert {h.a.name, h.b.name} & set(res.program.global_block.vars) == set()
    jprog, jh = _program(JAX, _dead_chain)
    jres = _run(JAX, jprog, ("dce",), [jh.name], verify="strict")
    assert dec.to_dict() == jres.values["dce"].to_dict()
    assert _canon(res.program) == _canon(jres.program)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}
    (want,) = exe.run(prog, feed=feed, fetch_list=[h.name],
                      scope=tfluid.Scope())
    (got,) = exe.run(res.program, feed=feed, fetch_list=[h.name],
                     scope=tfluid.Scope())
    np.testing.assert_array_equal(want, got)


def test_dce_refuses_on_clean_program():
    main, loss = _program(PORT, _mlp)
    dec = dce_program(main, fetch_names=[loss.name])
    assert not dec.applied and dec.program is main
    assert "no dead ops" in dec.reason


def _py_func_def(reg):
    # 'py_func' is a side-effect type of the effect classifier: a stub
    # with the JAX package's attrs gives the test a schema-valid op it pins
    attrs = {k: reg.AttrSpec(k, default=a.default)
             for k, a in jreg.get_op_def("py_func").attrs.items()}
    return reg.OpDef(type="py_func", inputs=[reg.IOSpec("X")],
                     outputs=[reg.IOSpec("Out")], attrs=attrs, grad=None,
                     lower=lambda ctx, ins, attrs: None)


def test_dce_never_removes_effectful_or_fetched_ops():
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        h = P.fl.layers.relu(x)               # fetched
        P.fl.layers.scale(h, scale=2.0)       # dead value op
        blk = main.global_block
        sink = blk.create_var(name="pm_sink", shape=[4], dtype="float32")
        blk.append_op("py_func", inputs={"X": [h.name]},
                      outputs={"Out": [sink.name]})
        return h

    with _ops(py_func=_py_func_def):
        decs = {}
        for P in (JAX, PORT):
            prog, h = _program(P, build)
            mod = (jfluid if P is JAX else tfluid).analysis.static_checks
            decs[P.name] = mod.dce_program(prog, fetch_names=[h.name])
        dec = decs["port"]
        assert dec.applied
        kept = [op.type for op in dec.program.global_block.ops]
        assert "py_func" in kept and "relu" in kept and "scale" not in kept
        assert dec.to_dict() == decs["jax"].to_dict()
        assert _canon(dec.program) == _canon(decs["jax"].program)


def test_dce_result_of_a_model_program_equals_the_jax_package():
    """A BERT-tiny inference clone with a dead branch added after the
    build: the same ops removed in both packages, equal ``to_dict()``."""
    from paddle_tpu.models import bert as jb
    from paddle_tpu_torch.models import bert as tb

    progs = {}
    for P, m in ((JAX, jb), (PORT, tb)):
        with P.un.guard():
            net = m.build_bert_pretrain(m.BertConfig.tiny(), 16,
                                        build_optimizer=False)
            test = net["main"].clone(for_test=True)
            with P.fl.program_guard(test, P.fl.Program()):
                enc = test.global_block.var(net["loss"].name)
                P.fl.layers.scale(P.fl.layers.scale(enc, scale=2.0),
                                  scale=3.0)
        progs[P.name] = (test, net["loss"].name)
    (jp, jf), (tp, tf) = progs["jax"], progs["port"]
    jdec = jfluid.analysis.dce_program(jp, fetch_names=[jf])
    tdec = dce_program(tp, fetch_names=[tf])
    assert tdec.applied and tdec.to_dict() == jdec.to_dict()
    assert _canon(tdec.program) == _canon(jdec.program)
