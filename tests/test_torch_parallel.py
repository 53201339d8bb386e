"""The port's data-parallel step against the JAX package's, on the CPU
(the counterpart of ``tests/test_parallel.py``).

Two gloo ranks (``torch_dist_runner``, one launch for the module) train
from the JAX package's initial scope, each on half of the global batch;
the reference is the JAX package's ``CompiledProgram`` on a 2-device CPU
mesh over the whole batch (GSPMD computes every op over the global batch):

* BERT-tiny at dropout 0 (seq 16, batch 4, Adam), whose two shards hold
  different masked counts (5 and 11 tokens), so the MLM loss's global
  ratio of sums is exercised: the loss and every parameter gradient at
  step 1 at rtol 1e-4 / atol 1e-6 (float32, another summation order), the
  three losses at rtol 1e-4, the parameters after step 3 at rtol 1e-3 /
  atol 1e-5 (Adam's normalised step amplifies the last bits of tiny
  gradients).
* A conv + training-mode batch_norm net (Momentum), whose statistics are
  the global batch's: the same tolerances.
* At dropout 0.1 the two ranks draw different dropout and attention masks
  for the same rows, and a second run repeats bit for bit.

Single-process cases check the sharding metadata, the per-rank memory
plan and the comms estimate against the JAX package's, and the step's
refusals."""
import dataclasses

import jax
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_bert

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_bert
from paddle_tpu_torch.parallel import compiled_program as tcp
from paddle_tpu_torch.parallel import sharding as tsh

import torch_dist_runner as R

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)


def _jax_reference(main, startup, loss, feed, steps):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.numpy(n)) for n in scope.vars}
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=jax.devices()[:2])
    names = R.param_grads(main)
    out = exe.run(prog, feed=feed, fetch_list=[loss.name] + names,
                  scope=scope)
    ref = {"grad/" + n: np.asarray(v) for n, v in zip(names, out[1:])}
    losses = [float(np.asarray(out[0]).reshape(-1)[0])]
    for _ in range(steps - 1):
        losses.append(float(np.asarray(exe.run(
            prog, feed=feed, fetch_list=[loss], scope=scope)[0])
            .reshape(-1)[0]))
    ref["losses"] = np.array(losses)
    for p in main.all_parameters():
        ref["param/" + p.name] = np.asarray(scope.numpy(p.name))
    return init, ref


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    with jun.guard():
        jb = j_bert(R.bert_cfg(JBertConfig), seq_len=R.BERT_SEQ)
    init, bert_ref = _jax_reference(jb["main"], jb["startup"], jb["loss"],
                                    R.bert_feeds(), R.BERT_STEPS)
    np.savez(out / "init_bert.npz", **init)
    main, startup, loss = R.build_bn_net(jfluid)
    init, bn_ref = _jax_reference(main, startup, loss, R.bn_feeds(),
                                  R.BN_STEPS)
    np.savez(out / "init_bn.npz", **init)
    rc, logs = R.launch(out, ["bert", "bn", "dropout", "checks"])
    assert rc == 0, logs
    return R.results(out), {"bert": bert_ref, "bn": bn_ref}


@pytest.mark.parametrize("case", ["bert", "bn"])
def test_loss_and_every_gradient_match_the_jax_mesh(launched, case):
    ranks, refs = launched
    ref = refs[case]
    grads = [k for k in ref if k.startswith("grad/")]
    assert len(grads) > 4
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/losses"], ref["losses"],
                                   rtol=1e-4)
        for k in grads:
            np.testing.assert_allclose(r[f"{case}/{k}"], ref[k],
                                       err_msg=k, **GRAD_TOL)
        for k in (k for k in ref if k.startswith("param/")):
            np.testing.assert_allclose(r[f"{case}/{k}"], ref[k],
                                       err_msg=k, **PARAM_TOL)
    for k in (k for k in ranks[0] if k.startswith(f"{case}/param/")):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_bert_shards_hold_unequal_masked_counts(launched):
    ranks, refs = launched
    counts = [int(r["bert/masked"][0]) for r in ranks]
    assert counts == [5, 11]
    # the per-rank mean of two ratios is another number than the global
    # ratio the reference computes
    assert refs["bert"]["losses"][0] == pytest.approx(
        ranks[0]["bert/losses"][0], rel=1e-4)


def test_ranks_draw_different_masks_and_a_run_repeats(launched):
    ranks, _ = launched
    r = ranks[0]
    for k in ("drop", "attn"):
        half = r[f"dropout/{k}"].shape[0] // 2
        assert not np.array_equal(r[f"dropout/{k}"][:half],
                                  r[f"dropout/{k}"][half:]), k
        np.testing.assert_array_equal(r[f"dropout/{k}"],
                                      r[f"dropout/{k}2"])
        np.testing.assert_array_equal(r[f"dropout/{k}"],
                                      ranks[1][f"dropout/{k}"])
    assert r["dropout/loss"] == r["dropout/loss2"]


def test_executor_checks_hold_on_the_parallel_step(launched):
    """The parallel step is the executor's: the numerics witness records
    the vars a one-card step records, and a NaN fed on one rank trips the
    nan check on both, each scope restored."""
    from paddle_tpu_torch.monitor import numwitness

    ranks, _ = launched
    main, startup, loss = _mlp(tfluid, "sgd")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    numwitness.reset_numerics_witness()
    tfluid.set_flags({"FLAGS_numerics_witness": 1})
    try:
        exe.run(main, feed=R.mlp_feeds(), fetch_list=[loss], scope=scope)
    finally:
        tfluid.set_flags({"FLAGS_numerics_witness": 0})
    one_card = sorted(numwitness.numerics_witness_vars())
    numwitness.reset_numerics_witness()
    assert len(one_card) > 4
    for r in ranks:
        assert r["checks/witnessed"].tolist() == one_card
        assert "FLAGS_check_nan_inf" in str(r["checks/message"][0])
        assert bool(r["checks/restored"][0])


# -- single process -------------------------------------------------------

def _mlp(fluid, opt="adam"):
    return R.build_mlp(fluid, opt)


def test_single_rank_compiled_program_equals_executor_bit_for_bit():
    main, startup, loss = _mlp(tfluid)
    feed = R.mlp_feeds()
    runs = []
    for compiled in (False, True):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name) if compiled else main
        runs.append([exe.run(prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0] for _ in range(3)]
                    + [scope.numpy("d_fc1.w_0")])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_places_mesh_and_rescale_refusals():
    main, startup, loss = _mlp(tfluid)
    with pytest.raises(ValueError, match="distributed.launch"):
        tfluid.CompiledProgram(main).with_data_parallel(
            places=[tfluid.CPUPlace(), tfluid.CPUPlace()])
    with pytest.raises(ValueError, match="launched"):
        tcp.data_parallel_mesh(tsh.make_mesh({"dp": 1, "pp": 2}))
    with pytest.raises(NotImplementedError, match="slice 28"):
        tcp.data_parallel_mesh(tsh.make_mesh({"tp": 2, "pp": 2}))
    with pytest.raises(ValueError, match="launched"):
        tcp.data_parallel_mesh(tsh.make_mesh({"dp": 1, "tp": 2}))
    with pytest.raises(ValueError, match="launched"):
        tcp.data_parallel_mesh(tsh.make_mesh({"dp": 2}))
    cp = tfluid.CompiledProgram(main).with_data_parallel(
        places=tfluid.CPUPlace())
    assert cp._mesh.shape == {"dp": 1}
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(cp, feed=R.mlp_feeds(), fetch_list=[loss], scope=scope)
    keys = len(exe._cache)
    cp._replica_steps = 3
    assert cp.rescale(None) is cp and cp._replica_steps == 0
    # the same world drops the steps: the next one is a new key
    exe.run(cp, feed=R.mlp_feeds(), fetch_list=[loss], scope=scope)
    assert len(exe._cache) == keys + 1
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        cp.rescale(tsh.Mesh({"dp": 4}))


def test_zero1_refuses_whole_parameter_updates_and_unplaced_couplings():
    main, startup = tfluid.Program(), tfluid.Program()
    with tun.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[R.DIM], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 4))
        tfluid.optimizer.Lamb(learning_rate=0.01).minimize(loss)
    with pytest.raises(NotImplementedError, match="lamb"):
        tcp._DPPlan(main, 2, ["x"], [loss.name], 4, zero1=True)
    tcp._DPPlan(main, 2, ["x"], [loss.name], 4, zero1=False)
    main2, startup2 = tfluid.Program(), tfluid.Program()
    with tun.guard(), tfluid.program_guard(main2, startup2):
        x = tfluid.layers.data("x", shape=[R.DIM], dtype="float32")
        h = tfluid.layers.fc(x, 4)
        s = tfluid.layers.reduce_max(h, dim=[0])
        loss = tfluid.layers.mean(s)
        tfluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    with pytest.raises(NotImplementedError, match="reduce_max"):
        tcp._DPPlan(main2, 2, ["x"], [loss.name], 4, zero1=False)


def test_plan_places_the_bert_collectives():
    with tun.guard():
        t = t_bert(R.bert_cfg(TBertConfig), seq_len=R.BERT_SEQ)
    plan = tcp._DPPlan(t["main"], 2, list(t["feeds"]), [t["loss"].name],
                       2, zero1=True)
    ops = t["main"].global_block.ops
    placed = sorted((ops[i].type, k) for i, vs in plan.forward.items()
                    for _, k in vs)
    assert placed == [("mean", "mean"), ("reduce_sum", "sum"),
                      ("reduce_sum", "sum")]
    assert len(plan.grads) == len(t["main"].all_parameters())
    assert plan.zero_state and all(n.startswith("moment")
                                   for n in plan.zero_state)


@pytest.mark.parametrize("zero", [False, True])
def test_sharding_metadata_matches_jax(zero):
    from paddle_tpu.parallel import sharding as jsh

    with jun.guard():
        j = j_bert(JBertConfig.tiny(), seq_len=R.BERT_SEQ)
    with tun.guard():
        t = t_bert(TBertConfig.tiny(), seq_len=R.BERT_SEQ)
    for mesh in ({"dp": 2}, {"dp": 4}):
        js, jf = jsh.extract_param_specs(j["main"], mesh, zero=zero)
        ts, tf = tsh.extract_param_specs(t["main"], mesh, zero=zero)
        assert ts == js and tf == jf
        rules_j = jsh.transformer_tp_rules()
        rules_t = tsh.transformer_tp_rules()
        for p in t["main"].all_parameters():
            assert tuple(rules_t.spec_for_param(p.name)) == tuple(
                rules_j.spec_for_param(p.name)), p.name


@pytest.mark.parametrize("zero", [False, True])
def test_per_rank_memory_plan_and_comms_match_jax(zero):
    from paddle_tpu.analysis.cost_model import estimate_comms as j_comms
    from paddle_tpu.parallel import sharding as jsh

    from paddle_tpu_torch.analysis.cost_model import estimate_comms

    with jun.guard():
        j = j_bert(JBertConfig.tiny(), seq_len=R.BERT_SEQ)
    with tun.guard():
        t = t_bert(TBertConfig.tiny(), seq_len=R.BERT_SEQ)
    mesh = {"dp": 2}
    js, _ = jsh.extract_param_specs(j["main"], mesh, zero=zero)
    ts, _ = tsh.extract_param_specs(t["main"], mesh, zero=zero)
    kw = dict(feed_names=list(t["feeds"]), fetch_names=[t["loss"].name],
              batch_size=8, mesh=mesh)
    jp = j["main"].memory_plan(specs=js, **kw)
    tp = t["main"].memory_plan(specs=ts, **kw)
    td, jd = tp.to_dict(), jp.to_dict()
    for d in (td, jd):           # build sites name each package's file
        d["hot_spots"] = [{k: v for k, v in e.items() if k != "site"}
                          for e in d["hot_spots"]]
    assert td == jd and td["per_chip"]
    assert tp.peak_bytes < t["main"].memory_plan(
        feed_names=kw["feed_names"], fetch_names=kw["fetch_names"],
        batch_size=8).peak_bytes
    assert estimate_comms(tp.sharding).to_dict() == \
        j_comms(jp.sharding).to_dict()


def test_gradient_merge_under_data_parallel_is_refused():
    """No longer refused: a merged program under ``CompiledProgram`` runs
    the executor's microbatch loop inside the parallel step. On one rank
    it equals the merged program on the executor bit for bit (two ranks:
    ``test_torch_sharded_tables.py``)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tun.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[R.DIM], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 4))
        tfluid.optimizer.GradientMergeOptimizer(
            tfluid.optimizer.SGD(learning_rate=0.1), k_steps=2).minimize(loss)
    feed = {"x": np.random.RandomState(0).randn(4, R.DIM).astype(
        np.float32)}
    runs = []
    for compiled in (False, True):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name) if compiled else main
        runs.append([exe.run(prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0] for _ in range(3)]
                    + [scope.numpy(p.name) for p in main.all_parameters()])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
