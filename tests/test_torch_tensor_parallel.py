"""The port's tensor-parallel BERT against the JAX package's sharded step,
on the CPU (the counterpart of ``tests/test_parallel.py``'s dp x tp BERT,
``__graft_entry__.dryrun_multichip``).

BERT-tiny (seq 32, batch 4, dropout 0, Adam) with
``transformer_tp_rules``: the port's ranks are gloo processes
(``torch_dist_runner``, one launch of two ranks for ``{"tp": 2}`` and one
of four for ``{"dp": 2, "tp": 2}``), each planted with its shard of the
JAX package's initial scope (``interop.scope_from_numpy(mesh=, rules=)``)
and fed the rows of its ``dp`` coordinate. The reference is the JAX
package's ``compile_sharded_step`` over the same mesh shape on its CPU
devices. Tolerances, float32:

* the loss and every gradient at step 1, gathered from the shards:
  rtol 1e-5, atol 1e-7 (GSPMD and the port sum the partial products in
  other orders);
* the loss at step 2 at rtol 1e-5, the parameters after it at rtol 1e-4 /
  atol 1e-6 (Adam's normalised step amplifies the last bits of tiny
  gradients).

The sharding analysis' tp events are checked against the JAX one's; the
negative controls (a plan that drops one row-parallel all-reduce, a seed
that folds the whole rank under tp) must fail their gates.
"""
import dataclasses

import jax
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_bert
from paddle_tpu.parallel import sharding as jsh

import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_bert
from paddle_tpu_torch.parallel import sharding as tsh

import torch_dist_runner as R

STEP1 = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_sharded(mesh_shape, init=None):
    """The JAX package's sharded step: step 1's loss and gradients, step
    2's loss, the parameters after it; and the initial scope."""
    with jun.guard():
        jb = j_bert(R.bert_cfg(JBertConfig), seq_len=R.TP_SEQ)
    main, loss = jb["main"], jb["loss"]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(jb["startup"], scope=scope)
    if init is None:
        init = {n: np.asarray(scope.numpy(n)) for n in scope.vars}
    mesh = jsh.make_mesh(mesh_shape)
    rules = jsh.transformer_tp_rules()
    names = R.param_grads(main)
    jitted, io = jsh.compile_sharded_step(main, mesh, jb["feeds"],
                                          [loss.name] + names, rules)
    placed = jsh.place_state({n: init[n] for n in io["donated"] + io["ro"]},
                             mesh, rules)
    feeds = R.tp_feeds()
    vals = [jax.device_put(feeds[n], rules.sharding_for_feed(mesh))
            for n in io["feed_order"]]
    ref, losses = {}, []
    for step in range(R.TP_STEPS):
        fetches, new_state = jitted(vals, [placed[n] for n in io["donated"]],
                                    [placed[n] for n in io["ro"]],
                                    jax.random.key(0))
        placed.update(zip(io["state_out"], new_state))
        losses.append(float(np.asarray(fetches[0]).reshape(-1)[0]))
        if step == 0:
            ref.update({"grad/" + n: np.asarray(v)
                        for n, v in zip(names, fetches[1:])})
    ref["losses"] = np.array(losses)
    for p in main.all_parameters():
        ref["param/" + p.name] = np.asarray(placed[p.name])
    return init, ref


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    init, ref_tp = _jax_sharded({"dp": 1, "tp": 2})
    _, ref_dptp = _jax_sharded({"dp": 2, "tp": 2}, init)
    out2 = tmp_path_factory.mktemp("tp2")
    out4 = tmp_path_factory.mktemp("dptp")
    for out in (out2, out4):
        np.savez(out / "init_tp.npz", **init)
    # the negative controls patch the plan in their rank processes: last
    rc, logs = R.launch(out2, ["tp_bert", "tp_drop_allreduce"], nproc=2,
                        timeout=400)
    assert rc == 0, logs
    rc, logs = R.launch(out4, ["dptp_bert", "dptp_dropout",
                               "dptp_badseed"], nproc=4, timeout=600)
    assert rc == 0, logs
    return ({"tp": R.results(out2, 2), "dptp": R.results(out4, 4)},
            {"tp": ref_tp, "dptp": ref_dptp})


def _gate(res, ref, case):
    """The step-1 loss and gradients, step 2's loss and the parameters
    after it against the reference; raises AssertionError on a miss."""
    np.testing.assert_allclose(res[f"{case}/losses"][0], ref["losses"][0],
                               **STEP1)
    for k in (k for k in ref if k.startswith("grad/")):
        np.testing.assert_allclose(res[f"{case}/{k}"], ref[k], err_msg=k,
                                   **STEP1)
    if f"{case}/param/word_embedding" in res:
        np.testing.assert_allclose(res[f"{case}/losses"], ref["losses"],
                                   rtol=1e-5)
        for k in (k for k in ref if k.startswith("param/")):
            np.testing.assert_allclose(res[f"{case}/{k}"], ref[k],
                                       err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("mesh, case", [("tp", "tp_bert"),
                                        ("dptp", "dptp_bert")])
def test_step_matches_the_jax_sharded_step(launched, mesh, case):
    ranks, refs = launched
    assert len([k for k in refs[mesh] if k.startswith("grad/")]) > 20
    for r in ranks[mesh]:
        _gate(r, refs[mesh], case)


def test_dropped_row_parallel_all_reduce_fails_the_gate(launched):
    """Negative control: one row-parallel partial left unsummed."""
    ranks, refs = launched
    with pytest.raises(AssertionError):
        _gate(ranks["tp"][0], refs["tp"], "tp_drop_allreduce")


def test_state_is_sharded_and_halves(launched):
    """Each tp rank holds half of every sharded param and its moments:
    its param + moment bytes are those of the one-card step less half the
    sharded set's."""
    ranks, _ = launched
    with tun.guard():
        tb = t_bert(R.bert_cfg(TBertConfig), seq_len=R.TP_SEQ)
    main = tb["main"]
    specs, _ = tsh.extract_param_specs(main, {"tp": 2},
                                       rules=tsh.transformer_tp_rules())
    whole = sharded = 0
    for v in main.global_block.vars.values():
        if not v.persistable or not (
                v.name in {p.name for p in main.all_parameters()}
                or v.name.startswith(("moment1_", "moment2_"))):
            continue
        n = int(np.prod(v.shape)) * 4
        whole += n
        sharded += n if v.name in specs else 0
    assert sharded > whole // 2
    for r in ranks["tp"]:
        assert int(r["tp_bert/state_bytes"][0]) == whole - sharded // 2


def test_dp_tp_zero1_replicas_stay_identical(launched):
    """dp2 x tp2, dropout 0.1, ZeRO-1: the replica check runs every step
    and finds nothing (the tp ranks drew the same masks), every rank
    holds the global loss, and dropout is on (the losses differ from the
    no-dropout run's)."""
    ranks, _ = launched
    r4 = ranks["dptp"]
    for r in r4:
        assert str(r["dptp_dropout/diverged"][0]) == ""
    np.testing.assert_array_equal(r4[0]["dptp_dropout/losses"],
                                  r4[1]["dptp_dropout/losses"])
    np.testing.assert_array_equal(r4[0]["dptp_dropout/losses"],
                                  r4[3]["dptp_dropout/losses"])
    assert not np.allclose(r4[0]["dptp_dropout/losses"][:2],
                           r4[0]["dptp_bert/losses"])


def test_whole_rank_seed_fails_the_replica_check(launched):
    """Negative control: folding the whole rank into the seed under tp
    makes the tp replicas part, and the replica check names them."""
    ranks, _ = launched
    msgs = [str(r["dptp_badseed/diverged"][0]) for r in ranks["dptp"]]
    assert all("diverged" in m or "replica" in m.lower() for m in msgs), msgs


def test_collectives_by_kind(launched):
    """A tp step's collectives: all-reduces (the row-parallel partial
    sums, the vocab lookup, the input gradients) and the all-gathers of
    the vocab-sharded logits, forward and backward."""
    ranks, _ = launched
    r = ranks["tp"][0]
    assert r["tp_bert/coll/all_reduce"][0] > 0
    # the logits for the softmax (forward and its grad's rerun) and the
    # fetched gradients of the sharded params
    assert r["tp_bert/coll/all_gather"][0] >= 2


# -- single process: the analysis and the layout ---------------------------

def _analyses(mesh):
    from paddle_tpu.analysis.sharding_check import propagate_sharding as jp

    from paddle_tpu_torch.analysis.sharding_check import \
        propagate_sharding as tp

    with jun.guard():
        j = j_bert(JBertConfig.tiny(), seq_len=32)
    with tun.guard():
        t = t_bert(TBertConfig.tiny(), seq_len=32)
    out = []
    for m, prop, sh in ((j, jp, jsh), (t, tp, tsh)):
        specs, fs = sh.extract_param_specs(m["main"], mesh,
                                           rules=sh.transformer_tp_rules())
        an = prop(m["main"], mesh, param_specs=specs, feed_spec=fs,
                  feed_names=list(m["feeds"]),
                  fetch_names=[m["loss"].name], batch_size=8)
        ops = m["main"].global_block.ops
        out.append({(ops[e.op_idx].type, e.kind, e.axis, e.var)
                    for e in an.collectives})
    return out


def test_tp_events_against_the_jax_analysis():
    """On BERT-tiny at {dp: 2, tp: 2}: every dp event, the vocab-sharded
    lookup's all-reduce and the row-parallel FFN products' all-reduces are
    the JAX analysis' own. Where the port's rules differ (the module
    docstring of ``analysis.sharding_check``), the JAX events it drops
    are the head split's gathers and what they caused, and those it adds
    are the out-projection's partial sums, the column-parallel input
    gradients' and the logits' gathers."""
    j, t = _analyses({"dp": 2, "tp": 2})
    dp = {e for e in j if e[2] == "dp"}
    assert dp - {e for e in j if e[0] in ("adam",)} <= t
    for e in (("lookup_table", "all_reduce", "tp", "embedding_0.tmp_0"),
              ("mul", "all_reduce", "tp", "fc_5.tmp_0"),
              ("mul", "all_reduce", "tp", "fc_11.tmp_0"),
              ("matmul_grad", "all_reduce", "tp",
               "layer_norm_5.tmp_0@GRAD")):
        assert e in j and e in t, e
    dropped = {e for e in j - t if e[2] != "dp"}
    assert {e[0] for e in dropped} <= {"reshape2", "mul", "mul_grad",
                                       "softmax_with_cross_entropy",
                                       "layer_norm_grad"}, dropped
    assert ("reshape2", "all_gather", "tp", "fc_0.tmp_1") in dropped
    added = t - j
    assert ("mul", "all_reduce", "tp", "fc_3.tmp_0") in t
    assert ("softmax_with_cross_entropy", "all_gather", "tp",
            "matmul_0.tmp_0") in added
    assert ("mul_grad", "all_reduce", "tp",
            "dropout_0.tmp_0@GRAD@RENAME@1") in added
    assert {e[0] for e in added} <= {
        "mul_grad", "softmax_with_cross_entropy",
        "softmax_with_cross_entropy_grad"}, added


def test_heads_split_to_local_shapes():
    """The plan's local reshape: split_heads' global head count over tp
    (K1 then runs [B * nh / tp, S, 64]: BERT-base at batch 32 is
    [32 * 6, 128, 64], which K1, K3 and K4 take)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        classify_backward_shapes, classify_shapes)
    from paddle_tpu_torch.parallel import compiled_program as cp

    with tun.guard():
        t = t_bert(R.bert_cfg(TBertConfig), seq_len=32)
    plan = cp._DPPlan(t["main"], tsh.Mesh({"tp": 1}), list(t["feeds"]),
                      [t["loss"].name], 4, False)
    assert not plan.local_ops
    analysis_mesh = tsh.Mesh({"tp": 2})
    from paddle_tpu_torch.analysis.sharding_check import propagate_sharding

    specs, fs = tsh.extract_param_specs(t["main"], analysis_mesh.shape,
                                        rules=tsh.transformer_tp_rules())
    an = propagate_sharding(t["main"], analysis_mesh.shape,
                            param_specs=specs, feed_spec=fs,
                            feed_names=list(t["feeds"]), batch_size=4)
    plan.mesh = analysis_mesh
    for i, op in enumerate(t["main"].global_block.ops):
        plan._localize(i, op, t["main"].global_block, an.var_specs)
    shapes = {tuple(plan.local_ops[i].attrs["shape"])
              for i in plan.local_ops
              if plan.local_ops[i].type == "reshape2"}
    assert shapes == {(0, 32, 1, 64), (0, 32, 64)}
    assert classify_shapes(128, 128, 64)[0] == "prefill"
    assert classify_backward_shapes(128, 128, 64)[0] == "backward"
    assert classify_shapes(128, 128, 60)[0] == "unsupported"


def test_pipeline_axis_is_refused_naming_the_slice():
    """A pp axis alone or beside dp runs; beside tp or sp it is refused,
    naming the slice that composes them."""
    tsh.check_mesh(tsh.Mesh({"dp": 2, "pp": 2}))
    # one process: the mesh passes the axis check, then wants its ranks
    with pytest.raises(ValueError, match="2 ranks but 1 rank"):
        tsh.compile_sharded_step(None, tsh.Mesh({"pp": 2}), [], [])
    with pytest.raises(NotImplementedError, match="slice 28"):
        tsh.check_mesh(tsh.Mesh({"dp": 2, "pp": 2, "tp": 2}))
    with pytest.raises(NotImplementedError, match="slice 28"):
        tsh.compile_sharded_step(None, tsh.Mesh({"pp": 2, "sp": 2}), [], [])


def test_mesh_coordinates_match_make_mesh_layout():
    """Rank r's coordinates are its row-major index, the last axis
    fastest, as the JAX make_mesh lays devices out."""
    m = tsh.Mesh({"dp": 2, "tp": 2})
    jm = jsh.make_mesh({"dp": 2, "tp": 2})
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(4):
        c = m.coords(r)
        assert ids[c["dp"], c["tp"]] == jax.devices()[r].id
    assert m.lines("tp") == [[0, 1], [2, 3]]
    assert m.lines("dp") == [[0, 2], [1, 3]]


def test_place_state_cuts_each_rank_shard():
    rules = tsh.transformer_tp_rules()
    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    m = tsh.Mesh({"tp": 2})
    got = [tsh.shard_of(w, rules.spec_for_param("l_q_w"), m, r)
           for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(got, 1), w)
    got = [tsh.shard_of(w, rules.spec_for_param("l_out_w"), m, r)
           for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(got, 0), w)
    b = w[0]
    assert tsh.place_state({"x_out_b": b}, m, rules)["x_out_b"] is b


def test_scope_from_numpy_cuts_the_shards():
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.interop import scope_from_numpy

    with tun.guard():
        t = t_bert(R.bert_cfg(TBertConfig), seq_len=32)
    main = t["main"]
    arrays = {"layer0_att_q_w": np.ones((128, 128), np.float32),
              "moment1_layer0_att_out_w_0": np.ones((128, 128), np.float32),
              "layer0_att_out_b": np.ones((128,), np.float32)}
    scope = tfluid.Scope()
    scope_from_numpy(arrays, scope, tfluid.CPUPlace(), programs=[main],
                     mesh=tsh.Mesh({"tp": 2}),
                     rules=tsh.transformer_tp_rules(), rank=1)
    assert tuple(scope.find_var("layer0_att_q_w").shape) == (128, 64)
    assert tuple(scope.find_var("moment1_layer0_att_out_w_0").shape) == \
        (64, 128)
    assert tuple(scope.find_var("layer0_att_out_b").shape) == (128,)


def test_dropout_folds_only_the_dp_coordinate():
    from paddle_tpu_torch.parallel import compiled_program as cp

    with tun.guard():
        t = t_bert(dataclasses.replace(TBertConfig.tiny()), seq_len=32)
    plan = cp._DPPlan(t["main"], tsh.Mesh({"tp": 1}), list(t["feeds"]),
                      [t["loss"].name], 4, False)
    seeds = {}
    for rank in range(4):
        plan.mesh = tsh.Mesh({"dp": 2, "tp": 2})
        plan.dp_rank = plan.mesh.coord("dp", rank)
        seeds[rank] = plan.fold_seed(123)
    assert seeds[0] == seeds[1] and seeds[2] == seeds[3]
    assert seeds[0] != seeds[2]


def test_sharded_checkpoint_of_tp_shards_is_refused(tmp_path):
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.resilience.distributed import save_sharded_vars

    scope = tfluid.Scope()
    scope._mesh_shards = {"layer0_att_q_w": (None, "tp")}
    with pytest.raises(NotImplementedError, match="slice 28"):
        save_sharded_vars(str(tmp_path), [], scope, {"dp": 1})
