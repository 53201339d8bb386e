"""SelectedRows in the port (``core/selected_rows.py``, the sparse
``lookup_table`` grad and every sparse branch of the math, AMP and
update ops, the executor's value model) against the JAX package, on the
CPU, at a tiny size (vocab 50, dim 8, batch 4 x 6 lookups).

* ``merge_rows`` and ``concat_merge`` give the reference's rows, values
  and sentinel tail (rows compared as int64; f32 values rtol 1e-6);
* an ``is_sparse`` table trains as its dense twin, for SGD, Momentum,
  Nesterov, Momentum with L2 decay, Adam and Adagrad, under a global-norm
  clip and under dynamic loss scaling, in ``run_chained``, and with a
  table two lookups share; and each sparse run from the JAX package's
  initial scope (``interop.scope_from_numpy``) gives its losses and
  tables: f32 rtol 1e-5, atol 1e-7 (the dense and sparse grads sum
  duplicate ids in another order; Adam's and the clip's rtol 1e-4,
  atol 1e-6, as the reference's own test holds the loss-scaled run);
* lazy Adam moves only the rows the batch read, ``padding_idx`` rows get
  no update, and a merged sparse grad made dense equals the dense grad;
* the programs' ``to_dict()`` equal the JAX package's (the
  ``is_distributed`` tag on the table and its accumulators included),
  and the tag survives ``clone`` and a JSON round trip;
* a fetched sparse grad is what the reference's fetch returns: a 0-d
  object array holding the SelectedRows (here with numpy rows and
  values), or the SelectedRows itself with ``return_numpy=False``.
"""
import json

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import selected_rows as jsr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.interop import scope_from_numpy

from test_torch_lod import build_both, normalized

VOCAB, DIM, BATCH, SEQ = 50, 8, 4, 6
RTOL, ATOL = 1e-5, 1e-7
# Adam normalises each row's step and the clip divides by a global norm,
# so the summation order of duplicate ids shows more there
LOOSE = (1e-4, 1e-6)
# the loss-scaling decorator computes the fc in bf16 in both packages;
# their bf16 roundings differ (one bf16 ulp is 3.9e-3)
AMP_TOL = (1e-2, 1e-6)


@pytest.fixture(autouse=True)
def _reset_clip():
    from paddle_tpu import clip as jclip
    from paddle_tpu_torch import clip as tclip

    tclip._clip_attr["__global__"] = None
    jclip._clip_attr["__global__"] = None
    yield
    tclip._clip_attr["__global__"] = None
    jclip._clip_attr["__global__"] = None


def _torch(a):
    import torch

    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("ids,height", [
    ([3, 1, 3, 7, 1, 3], 10),               # duplicates
    ([4, 4, 4, 4], 5),                      # one row
    ([0, 9, 5, 2], 10),                     # no duplicates
    ([2, 10, 2, 10, 6], 10),                # ids already at the sentinel
])
def test_merge_rows_matches_the_reference(ids, height):
    import jax.numpy as jnp

    vals = np.random.RandomState(len(ids)).randn(len(ids), 3) \
        .astype(np.float32)
    j = jsr.merge_rows(jnp.array(ids, jnp.int32), jnp.asarray(vals), height)
    t = tsr.merge_rows(_torch(np.array(ids, np.int64)), _torch(vals), height)
    assert t.height == j.height == height
    np.testing.assert_array_equal(t.rows.numpy(),
                                  np.asarray(j.rows).astype(np.int64))
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values),
                               rtol=1e-6, atol=1e-7)
    n_live = len({i for i in ids if i < height})
    assert (t.rows.numpy()[n_live:] == height).all()
    assert (t.values.numpy()[n_live:] == 0).all()
    np.testing.assert_allclose(t.to_dense().numpy(),
                               np.asarray(j.to_dense()), rtol=1e-6)


def test_concat_merge_matches_the_reference():
    import jax.numpy as jnp

    a_ids, b_ids = [1, 2, 2], [2, 4]
    a_v = np.arange(6, dtype=np.float32).reshape(3, 2)
    b_v = np.ones((2, 2), np.float32) * 5
    j = jsr.concat_merge(
        jsr.merge_rows(jnp.array(a_ids), jnp.asarray(a_v), 5),
        jsr.merge_rows(jnp.array(b_ids), jnp.asarray(b_v), 5))
    t = tsr.concat_merge(
        tsr.merge_rows(_torch(np.array(a_ids)), _torch(a_v), 5),
        tsr.merge_rows(_torch(np.array(b_ids)), _torch(b_v), 5))
    np.testing.assert_array_equal(t.rows.numpy(),
                                  np.asarray(j.rows).astype(np.int64))
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values))
    assert not hasattr(t, "dtype") and not hasattr(t, "shape")


def test_set_rows_drops_sentinels_and_writes_each_row_once():
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    rows = _torch(np.array([1, 4, 6, 6]))
    new = _torch(np.full((4, 2), -1.0, np.float32))
    got = tsr.set_rows(_torch(table.copy()), rows, new, 6).numpy()
    want = table.copy()
    want[[1, 4]] = -1.0
    np.testing.assert_array_equal(got, want)
    # every slot a sentinel: the table is unchanged
    got = tsr.set_rows(_torch(table.copy()), _torch(np.array([6, 6])),
                       new[:2], 6).numpy()
    np.testing.assert_array_equal(got, table)


SGD = ("SGD", {"learning_rate": 0.1})
MOMENTUM = ("Momentum", {"learning_rate": 0.1, "momentum": 0.9})
NESTEROV = ("Momentum", {"learning_rate": 0.1, "momentum": 0.9,
                         "use_nesterov": True})
ADAM = ("Adam", {"learning_rate": 0.05})
LAZY_ADAM = ("Adam", {"learning_rate": 0.05, "lazy_mode": True})
ADAGRAD = ("Adagrad", {"learning_rate": 0.1})


def _net(opt, is_sparse, padding_idx=None, shared=False, clip=None,
         loss_scaling=False, l2=None):
    def fn(fl):
        ids = fl.layers.data(name="ids", shape=[SEQ], dtype="int64")
        emb = fl.layers.embedding(
            input=ids, size=[VOCAB, DIM], is_sparse=is_sparse,
            padding_idx=padding_idx, param_attr=fl.ParamAttr(name="emb_w"))
        pooled = fl.layers.reduce_mean(emb, dim=1)
        if shared:
            ids2 = fl.layers.data(name="ids2", shape=[2], dtype="int64")
            emb2 = fl.layers.embedding(
                input=ids2, size=[VOCAB, DIM], is_sparse=is_sparse,
                param_attr=fl.ParamAttr(name="emb_w"))
            pooled = fl.layers.elementwise_add(
                pooled, fl.layers.reduce_sum(emb2, dim=1))
        pred = fl.layers.fc(input=pooled, size=1,
                            param_attr=fl.ParamAttr(name="head_w"))
        loss = fl.layers.mean(fl.layers.elementwise_mul(pred, pred))
        if clip is not None:
            fl.clip.set_gradient_clip(
                fl.clip.GradientClipByGlobalNorm(clip_norm=clip))
        kw = dict(opt[1])
        if l2 is not None:
            kw["regularization"] = fl.regularizer.L2Decay(l2)
        o = getattr(fl.optimizer, opt[0])(**kw)
        if loss_scaling:
            from importlib import import_module

            mp = import_module(fl.__name__ + ".contrib.mixed_precision")
            o = mp.decorate(o, use_dynamic_loss_scaling=True,
                            init_loss_scaling=128.0)
        o.minimize(loss)
        return loss
    return fn


def _feeds(steps, shared=False, seed=0, ids=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        f = {"ids": rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
             if ids is None else ids}
        if shared:
            f["ids2"] = rng.randint(0, VOCAB, (BATCH, 2)).astype(np.int64)
        out.append(f)
    return out


def _train(fn, steps=3, shared=False, chained=False, ids=None):
    """The program pair built in both packages, run ``steps`` steps from
    the JAX package's initial scope: {pkg: (losses, emb_w, main)}."""
    built = build_both(fn)
    jmain, jstart, jloss = built["jax"]
    tmain, _, tloss = built["torch"]
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {n: jscope.numpy(n) for n in jstart.global_block.vars}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy(init, tscope, tfluid.CPUPlace(), programs=[tmain])
    feeds = _feeds(steps, shared, ids=ids)
    res = {}
    for pkg, exe, main, loss, scope in (
            ("jax", jexe, jmain, jloss, jscope),
            ("torch", texe, tmain, tloss, tscope)):
        if chained:
            losses = list(np.asarray(exe.run_chained(
                main, feed=feeds[0], fetch_list=[loss], steps=steps,
                scope=scope)[0]).reshape(-1))
        else:
            losses = [float(np.asarray(exe.run(
                main, feed=f, fetch_list=[loss], scope=scope)[0])
                .reshape(-1)[0]) for f in feeds]
        res[pkg] = (np.array(losses), scope.numpy("emb_w"), main)
    res["init"] = init["emb_w"]
    return res


def _check(sparse, dense, tol=(RTOL, ATOL), cross=None):
    """Sparse against dense in each package within ``tol``; the port's
    sparse run against the JAX package's within ``cross`` (default
    ``tol``)."""
    rtol, atol = tol
    for pkg in ("jax", "torch"):
        np.testing.assert_allclose(sparse[pkg][0], dense[pkg][0], rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(sparse[pkg][1], dense[pkg][1], rtol=rtol,
                                   atol=atol)
    # the port's sparse run against the JAX package's sparse run
    rtol, atol = cross or tol
    np.testing.assert_allclose(sparse["torch"][0], sparse["jax"][0],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(sparse["torch"][1], sparse["jax"][1],
                               rtol=rtol, atol=atol)
    assert not np.array_equal(sparse["torch"][1], sparse["init"])


@pytest.mark.parametrize("opt,l2,tol", [
    (SGD, None, (RTOL, ATOL)), (MOMENTUM, None, (RTOL, ATOL)),
    (NESTEROV, None, (RTOL, ATOL)), (MOMENTUM, 0.01, (RTOL, ATOL)),
    (ADAM, None, LOOSE), (ADAGRAD, None, (RTOL, ATOL))],
    ids=["sgd", "momentum", "nesterov", "momentum_l2", "adam", "adagrad"])
def test_sparse_matches_dense_training(opt, l2, tol):
    sparse = _train(_net(opt, True, l2=l2))
    dense = _train(_net(opt, False, l2=l2))
    _check(sparse, dense, tol)
    ops = [o.type for o in sparse["torch"][2].global_block.ops]
    assert "lookup_table_grad" in ops


def test_programs_match_jax_and_keep_the_table_tag():
    built = build_both(_net(ADAM, True))
    tmain, jmain = built["torch"][0], built["jax"][0]
    assert normalized(tmain) == normalized(jmain)
    assert normalized(built["torch"][1]) == normalized(built["jax"][1])
    tagged = {v["name"] for v in tmain.to_dict()["blocks"][0]["vars"]
              if v.get("is_distributed")}
    assert tagged == {"emb_w", "moment1_emb_w_0", "moment2_emb_w_0"}
    for prog in (tmain.clone(), tmain.clone(for_test=True),
                 type(tmain).from_json(tmain.to_json())):
        assert prog.global_block.var("emb_w").is_distributed
        assert {v["name"] for v in prog.to_dict()["blocks"][0]["vars"]
                if v.get("is_distributed")} >= {"emb_w"}
    # a dense table carries no tag
    dense = build_both(_net(ADAM, False))["torch"][0]
    assert not any(v.get("is_distributed")
                   for v in dense.to_dict()["blocks"][0]["vars"])


def test_lazy_adam_touches_only_grad_rows():
    ids = np.full((BATCH, SEQ), 5, np.int64)
    res = _train(_net(LAZY_ADAM, True), steps=2, ids=ids)
    w0, w1 = res["init"], res["torch"][1]
    untouched = np.ones(VOCAB, bool)
    untouched[5] = False
    np.testing.assert_array_equal(w1[untouched], w0[untouched])
    assert np.abs(w1[5] - w0[5]).max() > 0
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], rtol=RTOL)


def test_sparse_padding_idx_rows_get_no_update():
    sparse = _train(_net(SGD, True, padding_idx=3), steps=2)
    dense = _train(_net(SGD, False, padding_idx=3), steps=2)
    _check(sparse, dense)
    np.testing.assert_array_equal(sparse["torch"][1][3], sparse["init"][3])


def test_sparse_with_global_norm_clip():
    sparse = _train(_net(SGD, True, clip=0.01))
    dense = _train(_net(SGD, False, clip=0.01))
    _check(sparse, dense, LOOSE)


def test_sparse_with_dynamic_loss_scaling():
    sparse = _train(_net(SGD, True, loss_scaling=True))
    dense = _train(_net(SGD, False, loss_scaling=True))
    _check(sparse, dense, LOOSE, cross=AMP_TOL)


def test_table_shared_by_two_lookups():
    sparse = _train(_net(ADAGRAD, True, shared=True), shared=True)
    dense = _train(_net(ADAGRAD, False, shared=True), shared=True)
    _check(sparse, dense)
    ops = [o.type for o in sparse["torch"][2].global_block.ops]
    assert ops.count("lookup_table_grad") == 2 and "sum" in ops


def test_chained_run_with_sparse_grads():
    sparse = _train(_net(SGD, True), chained=True)
    dense = _train(_net(SGD, False), chained=True)
    assert sparse["torch"][0].shape == (3,)
    _check(sparse, dense)


def _grad_program(is_sparse):
    def fn(fl):
        loss = _net(SGD, is_sparse)(fl)
        blk = fl.default_main_program().global_block
        g = blk.var("emb_w@GRAD")
        dense = fl.layers.get_tensor_from_selected_rows(
            fl.layers.merge_selected_rows(g))
        return loss, dense
    return fn


def test_merged_sparse_grad_made_dense_equals_the_dense_grad():
    feed = _feeds(1)[0]
    got = {}
    for is_sparse in (True, False):
        built = build_both(_grad_program(is_sparse))
        for pkg in ("jax", "torch"):
            main, start, (loss, dense) = built[pkg]
            fl = fluid if pkg == "jax" else tfluid
            if pkg == "jax":
                exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
                exe.run(start, scope=scope)
                init = {n: scope.numpy(n) for n in start.global_block.vars}
            else:
                exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
                scope_from_numpy(init, scope, fl.CPUPlace(),
                                 programs=[main])
            got[(pkg, is_sparse)] = exe.run(main, feed=feed,
                                            fetch_list=[dense],
                                            scope=scope)[0]
    for k, v in got.items():
        assert v.shape == (VOCAB, DIM), k
        np.testing.assert_allclose(v, got[("jax", False)], rtol=RTOL,
                                   atol=1e-8, err_msg=str(k))
    assert np.abs(got[("torch", True)]).sum() > 0


def test_fetched_sparse_grad_is_what_the_reference_returns():
    built = build_both(_net(SGD, True))
    tmain, tstart, tloss = built["torch"]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tstart, scope=scope)
    feed = _feeds(1)[0]
    loss, grad = exe.run(tmain, feed=feed, fetch_list=[tloss, "emb_w@GRAD"],
                         scope=scope)
    assert isinstance(grad, np.ndarray) and grad.dtype == object \
        and grad.shape == ()
    sr = grad[()]
    assert tsr.is_selected_rows(sr)
    assert sr.values.shape == (BATCH * SEQ, DIM)
    assert sr.rows.shape == (BATCH * SEQ,) and sr.height == VOCAB
    assert isinstance(sr.rows, np.ndarray)
    assert sorted(set(sr.rows[sr.rows < VOCAB])) == sorted(set(
        feed["ids"].reshape(-1)))
    raw = exe.run(tmain, feed=feed, fetch_list=["emb_w@GRAD"], scope=scope,
                  return_numpy=False)[0]
    assert tsr.is_selected_rows(raw) and raw.values.shape == (24, DIM)
    # the reference's fetch: an object array around its SelectedRows
    jmain, jstart, jloss = built["jax"]
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstart, scope=jscope)
    jgrad = jexe.run(jmain, feed=feed, fetch_list=["emb_w@GRAD"],
                     scope=jscope)[0]
    assert jgrad.dtype == object and jgrad.shape == ()
    assert jsr.is_selected_rows(jgrad[()])
    # run_chained stacks the rows and values along the steps
    ch = exe.run_chained(tmain, feed=feed, fetch_list=["emb_w@GRAD"],
                         steps=2, scope=scope)[0][()]
    assert ch.rows.shape == (2, 24) and ch.values.shape == (2, 24, DIM)


def test_scope_numpy_and_nan_check_pass_a_sparse_value():
    built = build_both(_net(ADAM, True))
    tmain, tstart, tloss = built["torch"]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tstart, scope=scope)
    tfluid.set_flags({"FLAGS_check_nan_inf": True})
    try:
        exe.run(tmain, feed=_feeds(1)[0], fetch_list=[tloss], scope=scope)
    finally:
        tfluid.set_flags({"FLAGS_check_nan_inf": False})
    sr = tsr.merge_rows(_torch(np.array([2, 2, 7])),
                        _torch(np.ones((3, 2), np.float32)), 9)
    scope.set_var("g", sr)
    box = scope.numpy("g")
    assert box.dtype == object
    np.testing.assert_array_equal(box[()].rows, [2, 7, 9])


def test_gradient_merge_with_a_sparse_table_matches_dense():
    def run(is_sparse):
        def fn(fl):
            ids = fl.layers.data(name="ids", shape=[SEQ], dtype="int64")
            emb = fl.layers.embedding(
                input=ids, size=[VOCAB, DIM], is_sparse=is_sparse,
                param_attr=fl.ParamAttr(name="emb_w"))
            pred = fl.layers.fc(fl.layers.reduce_mean(emb, dim=1), 1)
            loss = fl.layers.mean(fl.layers.elementwise_mul(pred, pred))
            fl.optimizer.GradientMergeOptimizer(
                fl.optimizer.SGD(learning_rate=0.1), k_steps=2) \
                .minimize(loss)
            return loss
        built = build_both(fn)
        jstart = built["jax"][1]
        jscope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(jstart, scope=jscope)
        tmain, _, tloss = built["torch"]
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        scope_from_numpy({n: jscope.numpy(n)
                          for n in jstart.global_block.vars}, scope,
                         tfluid.CPUPlace(), programs=[tmain])
        for f in _feeds(2):
            exe.run(tmain, feed=f, fetch_list=[tloss], scope=scope)
        return scope.numpy("emb_w")

    np.testing.assert_allclose(run(True), run(False), rtol=RTOL, atol=ATOL)


def test_memory_plan_charges_the_declared_dense_grad():
    """``memory_plan`` is static and charges ``W@GRAD`` at its declared
    [vocab, dim], as the JAX package's planner does; the sparse value is
    [lookups, dim] (README)."""
    built = build_both(_net(SGD, True))
    tplan = built["torch"][0].memory_plan(["ids"], [], batch_size=BATCH)
    jplan = built["jax"][0].memory_plan(["ids"], [], batch_size=BATCH)
    assert tplan.peak_bytes == jplan.peak_bytes
    assert built["torch"][0].global_block.var("emb_w@GRAD").shape == \
        (VOCAB, DIM)
