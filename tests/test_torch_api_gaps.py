"""Public calls of the JAX package that the port used to refuse, made in
both packages with the same arguments: the programs' ``to_dict()`` are
equal (source paths dropped, int32 read as int64), the fetches agree at
float32's rtol 1e-6 / atol 1e-7 (one op order, another library), and the
scopes hold the same names and values.

The calls: ``Executor.run(use_program_cache=...)``,
``append_backward(..., callbacks, checkpoints)`` with
``Optimizer.backward(callbacks=...)`` and ``Optimizer.apply_optimize``,
``fluid.data``/``layers.data(type=...)``, ``Variable(initializer=...)``
and ``Variable.astype``, ``Operator.attr``, ``Block.all_parameters``,
``Scope(parent)`` with ``var``/``new_scope``/``drop_var``/``find_var``
through the parents, and ``LayerHelper.multiple_param_attr`` /
``create_tmp_variable``."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun

TOL = dict(rtol=1e-6, atol=1e-7)
BOTH = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _pkg(name):
    return (jfluid, jun) if name == "jax" else (tfluid, tun)


def _normalized(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(6, 5).astype(np.float32),
            "y": rng.randn(6, 1).astype(np.float32)}


def _build(fluid, un, via="minimize"):
    """A two-layer regression program; ``via`` picks how its backward
    and update are appended."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with un.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[5], dtype="float32", type=None)
        y = fluid.layers.data("y", shape=[1], dtype="float32", type=None)
        h = fluid.layers.fc(x, 4, act="tanh")
        pred = fluid.layers.fc(h.astype("float32"), 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt = fluid.optimizer.SGD(learning_rate=0.1)
        if via == "minimize":
            opt.minimize(loss)
        elif via == "append_backward":
            pg = fluid.backward.append_backward(
                loss, None, None, callbacks=[lambda *a: None],
                checkpoints=[h])
            opt.apply_optimize(loss, startup, pg)
        else:
            pg = opt.backward(loss, startup, None, None,
                              callbacks=[lambda *a: None])
            opt.apply_gradients(pg)
    return main, startup, loss


def _run(name, via, use_program_cache=True, steps=2):
    fluid, un = _pkg(name)
    main, startup, loss = _build(fluid, un, via)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.numpy(n)) for n in sorted(scope.vars)}
    losses = [float(np.asarray(exe.run(
        main, feed=_feed(), fetch_list=[loss], scope=scope,
        use_program_cache=use_program_cache)[0]).reshape(-1)[0])
        for _ in range(steps)]
    return main, init, scope, losses


@pytest.mark.parametrize("via", ["minimize", "append_backward",
                                 "backward_callbacks"])
def test_programs_equal_in_both_packages(via):
    jm, _, _ = _build(jfluid, jun, via)
    tm, _, _ = _build(tfluid, tun, via)
    assert _normalized(jm) == _normalized(tm)
    if via != "minimize":
        assert _normalized(jm) == _normalized(_build(jfluid, jun)[0])


@pytest.mark.parametrize("use_program_cache", [True, False])
@pytest.mark.parametrize("via", ["minimize", "append_backward",
                                 "backward_callbacks"])
def test_fetches_and_scope_equal(via, use_program_cache):
    """The port trains from the JAX package's startup values; the losses
    and the whole scope after two steps agree."""
    from paddle_tpu_torch.interop import scope_from_numpy

    jm, jinit, jscope, jlosses = _run("jax", via, use_program_cache)
    tmain, tstart, tloss = _build(tfluid, tun, via)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    scope_from_numpy(jinit, scope, tfluid.CPUPlace(), programs=[tmain])
    losses = [float(exe.run(tmain, feed=_feed(), fetch_list=[tloss],
                            scope=scope,
                            use_program_cache=use_program_cache)[0]
                    .reshape(-1)[0]) for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    assert sorted(scope.vars) == sorted(jscope.vars)
    for n in jscope.vars:
        np.testing.assert_allclose(scope.numpy(n), np.asarray(
            jscope.numpy(n)), err_msg=n, **TOL)


@BOTH
def test_use_program_cache_false_rebuilds_the_step(pkg):
    """Both packages record a compile event for each uncached run of an
    unchanged key; a cached run records none."""
    fluid, un = _pkg(pkg)
    from importlib import import_module

    monitor = import_module(fluid.__name__ + ".monitor")
    main, startup, loss = _build(fluid, un)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    n0 = len(monitor.recompile_events())
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    n1 = len(monitor.recompile_events())
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope,
            use_program_cache=False)
    n2 = len(monitor.recompile_events())
    assert (n1 - n0, n2 - n1) == (0, 1)


def _scope_walk(fluid):
    parent = fluid.Scope()
    parent.set_var("a", np.float32(1.0))
    parent.set_var("b", np.float32(2.0))
    child = parent.new_scope()
    child.set_var("b", np.float32(3.0))
    grand = fluid.executor.Scope(parent=child)
    out = {
        "child.var(a)": child.var("a"),
        "child.find_var(a)": child.find_var("a"),
        "child.find_var(b)": child.find_var("b"),
        "grand.find_var(b)": grand.find_var("b"),
        "grand.find_var(z)": grand.find_var("z"),
        "child.parent is parent": child.parent is parent,
    }
    child.drop_var("b")
    child.drop_var("never")
    out["after drop: child.var(b)"] = child.var("b")
    out["after drop: child.find_var(b)"] = child.find_var("b")
    out["parent.vars"] = sorted(parent.vars)
    out["child.vars"] = sorted(child.vars)
    return out


def test_scope_parents_equal():
    j, t = _scope_walk(jfluid), _scope_walk(tfluid)
    assert {k: (None if v is None else np.asarray(v).tolist())
            for k, v in j.items()} == \
        {k: (None if v is None else np.asarray(v).tolist())
         for k, v in t.items()}


def test_child_scope_runs_a_program_from_parent_state():
    """A program run in a child scope reads the parent's parameters and
    writes its updates where the reference does (the port starts from
    the JAX package's startup values)."""
    from paddle_tpu_torch.interop import scope_from_numpy

    out, init = {}, None
    for name in ("jax", "torch"):
        fluid, un = _pkg(name)
        main, startup, loss = _build(fluid, un)
        exe = fluid.Executor(fluid.CPUPlace())
        parent = fluid.Scope()
        if init is None:
            exe.run(startup, scope=parent)
            init = {n: np.asarray(parent.numpy(n)) for n in parent.vars}
        else:
            scope_from_numpy(init, parent, fluid.CPUPlace(),
                             programs=[main])
        child = parent.new_scope()
        got = exe.run(main, feed=_feed(), fetch_list=[loss], scope=child)
        out[name] = (float(np.asarray(got[0]).reshape(-1)[0]),
                     sorted(child.vars),
                     {n: np.array_equal(init[n], np.asarray(
                         parent.numpy(n))) for n in init})
    assert out["jax"][1:] == out["torch"][1:]
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], **TOL)


def _introspect(fluid, un):
    main, startup, loss = _build(fluid, un)
    blk = main.global_block
    fc_mul = next(o for o in blk.ops if o.type == "mul")
    v = fluid.framework.Variable(blk, "iv", shape=[2, 3], dtype="float32",
                                 initializer=fluid.initializer.Constant(
                                     1.0))
    with fluid.program_guard(main, startup):
        helper = fluid.layer_helper.LayerHelper(
            "probe", param_attr=fluid.ParamAttr(name="pw"))
        attrs = helper.multiple_param_attr(3)
        tmp = helper.create_tmp_variable("float32")
        cast = v.astype("float64")
    return {
        "op.attr(x_num_col_dims)": fc_mul.attr("x_num_col_dims"),
        "op.attr(missing)": fc_mul.attr("no_such_attr"),
        "block.all_parameters": sorted(p.name for p in
                                       blk.all_parameters()),
        "program.all_parameters": sorted(p.name for p in
                                         main.all_parameters()),
        "var": (v.name, list(v.shape), v.dtype),
        "multiple_param_attr": [a.name for a in attrs],
        "tmp": (tmp.name, tmp.dtype),
        "astype": (cast.dtype, blk.ops[-1].type),
    }


def test_introspection_equal():
    with jun.guard():
        j = _introspect(jfluid, jun)
    with tun.guard():
        t = _introspect(tfluid, tun)
    assert j == t
