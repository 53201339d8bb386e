"""The port's sparse tables under the parallel step against the JAX
package's, on the CPU (the counterpart of ``tests/test_dist_launch.py``'s
``test_two_process_sharded_deepfm``), with gradient merge under data
parallel (``tests/test_pipeline.py``'s
``test_pipeline_under_data_parallel_mesh``).

Two gloo ranks (``torch_dist_runner``, one launch of two ranks) each feed
half of ``tests/dist_runner.py``'s DeepFM batch (vocab 64, 4 fields x 4,
Adam 0.05, 10 steps) from the JAX package's initial scope:

* vocab 64, which two ranks divide: ``fm_v``/``fm_w`` and their Adam
  moments are held as each rank's 32 rows; the lookup gathers the ids,
  the gradient of a rank's rows is built from the gathered output
  gradient;
* vocab 65, which they do not: the tables stay replicated and their
  SelectedRows gradients are summed over the ranks.

Each against the JAX package's single-process run: the losses at rtol
2e-4 / atol 1e-5 (the JAX test's), the tables after step 10 at rtol 1e-4
/ atol 1e-6. A sharded checkpoint of the row-sharded run after step 2
resumes steps 3-4 bit for bit. A sparse lookup into a ``tp``
vocab-sharded table holds the one-card run (losses rtol 1e-5, the table
after 4 steps rtol 1e-5 / atol 1e-7); gradient merge (2 microbatches) under
``dp`` holds the one-card merged step and the JAX package's (the
parameters after 4 steps, rtol 1e-5 / atol 1e-7). The negative control, a
table gradient from each rank's own batch rows only, misses the gate.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models.deepfm import build_deepfm as j_deepfm

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.analysis.sharding_check import propagate_sharding
from paddle_tpu_torch.models.deepfm import build_deepfm as t_deepfm
from paddle_tpu_torch.parallel import sharding as tsh

import torch_dist_runner as R

LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ONE_CARD_TOL = dict(rtol=1e-5, atol=1e-7)


def _jax_fm(vocab):
    """The JAX package's single-process DeepFM: its initial scope, the
    losses and the tables after the last step."""
    with jun.guard():
        m = j_deepfm(vocab=vocab, **R.FM)
    m["main"].random_seed = 31
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(m["startup"], scope=scope)
    init = {n: np.asarray(scope.numpy(n)) for n in scope.vars}
    feed = R.fm_feeds(vocab)
    losses = [float(np.asarray(exe.run(
        m["main"], feed=feed, fetch_list=[m["loss"].name],
        scope=scope)[0]).reshape(-1)[0]) for _ in range(R.FM_STEPS)]
    return init, {"losses": np.array(losses),
                  "fm_v": np.asarray(scope.numpy("fm_v")),
                  "fm_w": np.asarray(scope.numpy("fm_w"))}


def _one_card_sparse_tp():
    main, startup, loss = R.build_sparse_tp(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = R.sparse_tp_feeds()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(R.SPARSE_TP["steps"])]
    return np.array(losses), scope.numpy("word_embedding")


def _merged(fluid, init=None):
    """One process, gradient merge: the initial scope and the parameters
    after ``MERGE_STEPS`` steps."""
    main, startup, loss = R.build_merge_mlp(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {n: np.asarray(scope.numpy(n)) for n in scope.vars}
    else:
        for n, v in init.items():
            scope.set_var(n, torch.from_numpy(v.copy()))
    for _ in range(R.MERGE_STEPS):
        exe.run(main, feed=R.mlp_feeds(), fetch_list=[loss.name],
                scope=scope)
    return init, {p.name: np.asarray(scope.numpy(p.name))
                  for p in main.all_parameters()}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("tables")
    refs = {}
    for vocab in (64, 65):
        init, refs[vocab] = _jax_fm(vocab)
        np.savez(out / f"init_fm_{vocab}.npz", **init)
    init, refs["merge_jax"] = _merged(jfluid)
    np.savez(out / "init_merge.npz", **init)
    _, refs["merge_one"] = _merged(tfluid, init)
    refs["tp_sparse"] = _one_card_sparse_tp()
    # the negative control patches the plan in its rank processes: last
    rc, logs = R.launch(out, ["fm_rows", "fm_replicated", "fm_ckpt",
                              "tp_sparse", "merge_dp", "fm_rows_own_grad"],
                        nproc=2, timeout=500)
    assert rc == 0, logs
    return R.results(out, 2), refs


def _gate(res, case, ref):
    np.testing.assert_allclose(res[f"{case}/losses"], ref["losses"],
                               **LOSS_TOL)
    for t in ("fm_v", "fm_w"):
        np.testing.assert_allclose(res[f"{case}/{t}"], ref[t], err_msg=t,
                                   **TABLE_TOL)


@pytest.mark.parametrize("case, vocab", [("fm_rows", 64),
                                         ("fm_replicated", 65)])
def test_deepfm_over_two_ranks_matches_the_jax_single_process(
        launched, case, vocab):
    ranks, refs = launched
    for r in ranks:
        _gate(r, case, refs[vocab])
    np.testing.assert_array_equal(ranks[0][f"{case}/losses"],
                                  ranks[1][f"{case}/losses"])
    assert refs[vocab]["losses"][-1] < refs[vocab]["losses"][0]


def test_row_sharded_tables_and_moments_halve(launched):
    """At vocab 64 each rank holds 32 rows of the tables and of their Adam
    moments (the beta powers stay whole); at 65 every rank holds all."""
    ranks, _ = launched
    m = t_deepfm(vocab=64, **R.FM)
    blk = m["main"].global_block
    rows, whole = 0, 0
    for n, v in blk.vars.items():
        if v.persistable and ("fm_v" in n or "fm_w" in n) and "@" not in n:
            size = int(np.prod(v.shape)) * 4
            whole += size
            rows += size if v.shape[0] == 64 else 0
    for r in ranks:
        assert int(r["fm_rows/table_bytes"][0]) == whole - rows // 2
        assert int(r["fm_replicated/table_bytes"][0]) == \
            whole + (rows // 64)      # 65 rows
        assert {"fm_v", "fm_w"} <= set(r["fm_rows/dp_shards"].tolist())
        assert r["fm_replicated/dp_shards"].tolist() == [""]


def test_collectives_by_kind(launched):
    """The row-sharded step gathers the ids and the output gradients and
    sums the looked-up rows; the replicated one gathers the SelectedRows
    gradients' rows and values instead."""
    ranks, _ = launched
    rows = {k.split("/")[-1] for k in ranks[0] if k.startswith(
        "fm_rows/coll/")}
    rep = {k.split("/")[-1] for k in ranks[0] if k.startswith(
        "fm_replicated/coll/")}
    assert {"all_gather", "all_reduce"} <= rows
    assert {"all_gather", "all_reduce"} <= rep
    # per step: the ids of two lookups gathered in the forward and again
    # in the backward with their output gradients, against the
    # SelectedRows rows and values of two tables
    g_rows = ranks[0]["fm_rows/coll/all_gather"]
    g_rep = ranks[0]["fm_replicated/coll/all_gather"]
    assert int(g_rows[0]) == 6 and int(g_rep[0]) == 4


def test_sharded_checkpoint_of_the_row_sharded_table_resumes_exactly(
        launched):
    ranks, _ = launched
    for r in ranks:
        assert int(r["fm_ckpt/meta_step"][0]) == R.FM_SAVE_AFTER
        np.testing.assert_array_equal(r["fm_ckpt/resumed"],
                                      r["fm_ckpt/losses"][R.FM_SAVE_AFTER:])
        np.testing.assert_array_equal(r["fm_ckpt/fm_v_resumed"],
                                      r["fm_ckpt/fm_v"])


def test_sparse_lookup_into_a_tp_sharded_table_matches_one_card(launched):
    ranks, refs = launched
    losses, table = refs["tp_sparse"]
    for r in ranks:
        np.testing.assert_allclose(r["tp_sparse/losses"], losses,
                                   rtol=ONE_CARD_TOL["rtol"])
        np.testing.assert_allclose(r["tp_sparse/table"], table,
                                   **ONE_CARD_TOL)
    # the padding row (id 5) is looked up and never moves
    assert 5 in R.sparse_tp_feeds()["ids"]


def test_gradient_merge_under_data_parallel(launched):
    """The merged dp step against the one-card merged step and the JAX
    package's."""
    ranks, refs = launched
    for ref in (refs["merge_one"], refs["merge_jax"]):
        for n, v in ref.items():
            for r in ranks:
                np.testing.assert_allclose(r[f"merge_dp/param/{n}"], v,
                                           err_msg=n, **ONE_CARD_TOL)


def test_own_rows_table_gradient_fails_the_gate(launched):
    """Negative control: a table gradient from the rank's own batch rows
    only."""
    ranks, refs = launched
    with pytest.raises(AssertionError):
        _gate(ranks[0], "fm_rows_own_grad", refs[64])


def test_analysis_events_of_the_two_layouts():
    """At vocab 64 the lookups' all-reduce over dp (the port's dp-row
    lookup) and no sum of the table gradients; at 65 the table gradients
    summed over dp."""
    for vocab, summed in ((64, False), (65, True)):
        m = t_deepfm(vocab=vocab, **R.FM)
        mesh = {"dp": 2}
        specs, feed_spec = tsh.extract_param_specs(m["main"], mesh)
        assert ("fm_v" in specs) is not summed
        an = propagate_sharding(m["main"], mesh, param_specs=specs,
                                feed_spec=feed_spec,
                                feed_names=m["feeds"],
                                fetch_names=[m["loss"].name], batch_size=8)
        grads = {e.var for e in an.collectives if e.kind == "all_reduce"}
        assert ("fm_v@GRAD" in grads) is summed
        ops = m["main"].global_block.ops
        lookups = {ops[e.op_idx].type for e in an.collectives
                   if e.kind == "all_reduce" and e.axis == "dp"
                   and e.block_idx == 0}
        assert ("lookup_table" in lookups) is not summed
