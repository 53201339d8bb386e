"""DeepFM in the port (``models/deepfm.py``) against the JAX package's, on
the CPU, at the reference's test sizes (vocab 64, 4 fields, dim 4,
hidden (32, 32); ``tests/dist_runner.py``), batch 16.

* the main and startup programs' ``to_dict()`` are equal (int32 read as
  int64, source paths dropped), the ``is_distributed`` tags of both
  tables and their Adam moments included;
* from the JAX package's initial scope (``interop.scope_from_numpy``),
  three steps give its losses and its tables and MLP weights: f32 rtol
  1e-5, atol 1e-7 (Adam: atol 1e-6), for ``optimizer="adam"`` and
  ``"sgd"``, sparse (``sharded=True``, the default) and dense tables;
* in the port the sparse and the dense run from one scope agree bit
  for bit (the sparse merge sums each id's rows in the dense grad's
  order);
* the inference clone, pruned to ``pred``, fuses its fc chains under
  ``FLAGS_epilogue_fusion`` at the paper's widths (39 fields x 10,
  400-400-400): the two 400 x 400 chains take the kernel route's
  tiling, the first (k = 390) and the last (n = 1) are refused with the
  dimension named, and the fused ``pred`` equals the unfused one.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models.deepfm import build_deepfm as jbuild

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models import build_deepfm as tbuild

from test_torch_lod import normalized

SIZES = dict(vocab=64, num_fields=4, emb_dim=4)
BATCH, STEPS = 16, 3
TOL = {"sgd": (1e-5, 1e-7), "adam": (1e-5, 1e-6)}


def _both(**kw):
    with jun.guard():
        j = jbuild(**SIZES, **kw)
    with tun.guard():
        t = tbuild(**SIZES, **kw)
    return j, t


def _feeds(steps=STEPS, seed=0, vocab=64, fields=4, batch=BATCH):
    rng = np.random.RandomState(seed)
    return [{"feat_ids": rng.randint(0, vocab, (batch, fields))
             .astype(np.int64),
             "label": (rng.rand(batch, 1) < 0.256).astype(np.float32)}
            for _ in range(steps)]


STATE = ("fm_w", "fm_v", "deep_fc0.w_0", "deep_fc1.w_0", "deep_out.w_0")


def _run(net, init, exe_pkg, feeds):
    fl = fluid if exe_pkg == "jax" else tfluid
    exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
    if exe_pkg == "jax":
        exe.run(net["startup"], scope=scope)
    else:
        scope_from_numpy(init, scope, fl.CPUPlace(), programs=[net["main"]])
    losses = [float(np.asarray(exe.run(net["main"], feed=f,
                                       fetch_list=[net["loss"]],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in feeds]
    return np.array(losses), {n: scope.numpy(n) for n in STATE}


@pytest.mark.parametrize("sharded", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_programs_match_jax(opt, sharded):
    j, t = _both(optimizer=opt, sharded=sharded)
    assert normalized(t["main"]) == normalized(j["main"])
    assert normalized(t["startup"]) == normalized(j["startup"])
    assert t["feeds"] == j["feeds"]
    assert (t["loss"].name, t["pred"].name) == (j["loss"].name,
                                                 j["pred"].name)
    tags = {v["name"] for v in t["main"].to_dict()["blocks"][0]["vars"]
            if v.get("is_distributed")}
    want = {"fm_w", "fm_v"} | ({"moment1_fm_w_0", "moment2_fm_w_0",
                                 "moment1_fm_v_0", "moment2_fm_v_0"}
                                if opt == "adam" else set())
    assert tags == (want if sharded else set())


@pytest.mark.parametrize("sharded", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_three_steps_match_jax(opt, sharded):
    j, t = _both(optimizer=opt, sharded=sharded, lr=0.05)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    init = {n: jscope.numpy(n) for n in j["startup"].global_block.vars}
    feeds = _feeds()
    jl, jstate = _run(j, None, "jax", feeds)
    tl, tstate = _run(t, init, "torch", feeds)
    rtol, atol = TOL[opt]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    for n in STATE:
        np.testing.assert_allclose(tstate[n], jstate[n], rtol=rtol,
                                   atol=atol, err_msg=n)
    assert not np.array_equal(tstate["fm_v"], init["fm_v"])


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_sparse_and_dense_tables_train_alike(opt):
    """Non-lazy Adam and SGD update a table with sparse grads as with
    dense ones, bit for bit: the sparse merge sums each id's rows in the
    dense grad's order, and the sparse update rules compute each touched
    row as the dense rules do."""
    with tun.guard():
        sparse = tbuild(**SIZES, optimizer=opt, lr=0.05)
    with tun.guard():
        dense = tbuild(**SIZES, optimizer=opt, lr=0.05, sharded=False)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(sparse["startup"], scope=scope)
    init = {n: scope.numpy(n) for n in sparse["startup"].global_block.vars}
    feeds = _feeds()
    sl, ss = _run(sparse, init, "torch", feeds)
    dl, ds = _run(dense, init, "torch", feeds)
    np.testing.assert_array_equal(sl, dl)
    for n in STATE:
        np.testing.assert_array_equal(ss[n], ds[n], err_msg=n)


def test_inference_fusion_at_the_paper_widths():
    """K = 390 and N = 1 stay dense with the reason on the decision; the
    two 400 x 400 chains pass the kernel's tiling (on the CPU they run
    the dense replay, on the card K5)."""
    with tun.guard():
        net = tbuild(vocab=1000, num_fields=39, emb_dim=10,
                     hidden=(400, 400, 400))
    infer = tio._prune_for_inference(net["main"], ["feat_ids"],
                                     [net["pred"].name])
    assert {"label", "lookup_table_grad", "adam"}.isdisjoint(
        {o.type for o in infer.global_block.ops}
        | set(infer.global_block.vars))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(net["startup"], scope=scope)
    feed = {"feat_ids": _feeds(1, vocab=1000, fields=39, batch=8)[0]
            ["feat_ids"]}
    outs = {}
    for fused in (False, True):
        tfluid.set_flags({"FLAGS_epilogue_fusion": fused})
        try:
            outs[fused] = exe.run(infer, feed=feed,
                                  fetch_list=[net["pred"].name],
                                  scope=scope)[0]
        finally:
            tfluid.set_flags({"FLAGS_epilogue_fusion": False})
    (dec,) = exe._fusion_decisions.values()
    assert dec.applied and dec.n_fused == 4
    by_dims = {(w["n"], w["k"]): w for w in dec.witness}
    assert set(by_dims) == {(400, 390), (400, 400), (1, 400)}
    assert "k=390" in by_dims[(400, 390)]["reason"]
    assert "n=1" in by_dims[(1, 400)]["reason"]
    assert "k=390" not in by_dims[(400, 400)]["reason"]
    np.testing.assert_array_equal(outs[True], outs[False])
    assert outs[True].shape == (8, 1)
