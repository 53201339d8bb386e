"""Gradient merge (``GradientMergeOptimizer`` / ``PipelineOptimizer``) in
the port against the JAX package's microbatched step, on the CPU: the
port's counterparts of ``tests/test_pipeline.py``'s single-device cases,
BERT-tiny merged against the JAX package's merged step (dropout 0),
carried batch-norm statistics, dropout masks per microbatch, the nan
check's labels, the refused schedule composition and ``run_chained``'s
refusal. The data-parallel case waits for the multi-device slice."""
import dataclasses
import re

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_build

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}


@pytest.fixture(autouse=True)
def _flags():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    snaps = [(m, dict(m._overrides)) for m in (jflags, tflags)]
    yield
    for m, snap in snaps:
        m._overrides.clear()
        m._overrides.update(snap)


def _norm(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _build(pkg="torch", microbatches=None, opt="sgd", avg=True, bn=False):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[16], dtype="float32")
            y = fl.layers.data("y", shape=[1], dtype="float32")
            h = fl.layers.fc(x, 32, act="relu")
            if bn:
                h = fl.layers.batch_norm(h)
            pred = fl.layers.fc(h, 1)
            d = fl.layers.elementwise_sub(pred, y)
            loss = fl.layers.mean(fl.layers.elementwise_mul(d, d))
            o = (fl.optimizer.Lamb(learning_rate=0.01) if opt == "lamb"
                 else fl.optimizer.SGD(learning_rate=0.05))
            if microbatches:
                o = fl.optimizer.GradientMergeOptimizer(
                    o, k_steps=microbatches, avg=avg)
            o.minimize(loss)
    return main, startup, loss


def _data(batch=32, seed=1):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, 16).astype(np.float32),
            "y": rng.randn(batch, 1).astype(np.float32)}


def _train(microbatches=None, steps=6, **kw):
    main, startup, loss = _build("torch", microbatches, **kw)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    startup.random_seed = 23
    exe.run(startup, scope=scope)
    feed = _data()
    losses = [float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for _ in range(steps)]
    params = {n: scope.numpy(n) for n in scope.vars
              if n.endswith(".w_0") or n.endswith(".b_0")}
    return losses, params


def test_merged_training_converges():
    base, _ = _train(None, steps=8)
    merged, _ = _train(4, steps=8)
    assert merged[-1] < merged[0] and base[-1] < base[0]


def test_merged_params_equal_plain():
    """With a mean loss, 4 averaged microbatch gradients are the whole
    batch's: after 6 steps the parameters equal the plain path's."""
    _, plain = _train(None)
    _, merged = _train(4)
    assert plain.keys() == merged.keys() and len(plain) >= 4
    for n in plain:
        np.testing.assert_allclose(merged[n], plain[n], rtol=2e-5,
                                   atol=1e-6, err_msg=n)


def test_merged_sum_is_m_times_the_average():
    """``avg=False`` sums: with SGD one summed step of M microbatches is
    the averaged step at M times the rate."""
    _, summed = _train(4, steps=1, avg=False)
    main, startup, loss = _build("torch", 4)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    startup.random_seed = 23
    exe.run(startup, scope=scope)
    init = {n: scope.numpy(n) for n in summed}
    exe.run(main, feed=_data(), fetch_list=[loss], scope=scope)
    for n in summed:
        avg_step = init[n] - scope.numpy(n)
        np.testing.assert_allclose(init[n] - summed[n], 4 * avg_step,
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_batch_divisibility_error():
    main, startup, loss = _build("torch", 3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(Exception, match="divisible"):
        exe.run(main, feed=_data(32), fetch_list=[loss], scope=scope)


def test_pipeline_optimizer_records_cuts_and_is_gradient_merge():
    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[8], dtype="float32")
            h = tfluid.layers.fc(x, 8, act="relu")
            loss = tfluid.layers.mean(tfluid.layers.fc(h, 1))
            tfluid.optimizer.PipelineOptimizer(
                tfluid.optimizer.SGD(learning_rate=0.1), cut_list=[[h]],
                num_microbatches=2).minimize(loss)
    assert main._pipeline_microbatches == 2
    assert main._pipeline_cut_names == [h.name]
    assert isinstance(tfluid.optimizer.PipelineOptimizer(None),
                      tfluid.optimizer.GradientMergeOptimizer)
    with pytest.raises(ValueError, match="unknown vars"):
        with tun.guard():
            m2, s2 = tfluid.Program(), tfluid.Program()
            with tfluid.program_guard(m2, s2):
                x = tfluid.layers.data("x", shape=[8], dtype="float32")
                loss = tfluid.layers.mean(tfluid.layers.fc(x, 1))
                tfluid.optimizer.PipelineOptimizer(
                    tfluid.optimizer.SGD(learning_rate=0.1),
                    cut_list=["nonexistent_var"]).minimize(loss)


@pytest.mark.parametrize("opt,bn", [("sgd", False), ("lamb", False),
                                    ("sgd", True)])
def test_merged_step_matches_jax(opt, bn):
    """The same merged program in both packages, 3 steps from the JAX
    package's scope: losses (the last microbatch's) and every persistable,
    batch-norm statistics carried across microbatches included."""
    (jm, js, jl), (tm, ts, tl) = (_build("jax", 4, opt=opt, bn=bn),
                                  _build("torch", 4, opt=opt, bn=bn))
    assert _norm(tm) == _norm(jm)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = [v.name for v in js.global_block.vars.values()]
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy({n: jscope.numpy(n) for n in names}, tscope,
                     tfluid.CPUPlace(), programs=[tm])
    for s in range(3):
        feed = _data(seed=s)
        t = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0]
        j = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)[0]
        np.testing.assert_allclose(t, j, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    if bn:
        # the running mean moved off its 0 start in every microbatch
        np.testing.assert_array_less(
            0.0, np.abs(tscope.numpy("batch_norm_0.w_1")).sum())


# -- BERT-tiny ---------------------------------------------------------------

SEQ, BATCH = 32, 8


def _bert_feed(seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    lens = rng.randint(SEQ // 2, SEQ + 1, (batch, 1))
    real = np.arange(SEQ)[None] < lens
    masked = real & (rng.rand(batch, SEQ) < 0.15)
    return {"src_ids": rng.randint(0, 1024, (batch, SEQ)).astype(np.int64),
            "pos_ids": np.tile(np.arange(SEQ), (batch, 1)).astype(np.int64),
            "sent_ids": (np.arange(SEQ)[None] >= lens // 2).astype(np.int64),
            "input_mask": real.astype(np.float32),
            "mask_label": np.where(masked, rng.randint(0, 1024, (batch, SEQ)),
                                   -100).astype(np.int64),
            "next_sent_label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


def _bert(pkg, make_opt, **cfg_kw):
    fl, un = PKGS[pkg]
    cfg_cls, build = ((JBertConfig, j_build) if pkg == "jax"
                      else (TBertConfig, t_build))
    cfg = dataclasses.replace(cfg_cls.tiny(), **cfg_kw)
    with un.guard():
        net = build(cfg, seq_len=SEQ, build_optimizer=False)
        with fl.program_guard(net["main"], net["startup"]):
            make_opt(fl).minimize(net["loss"])
    return net


def _merged_lamb(fl):
    return fl.optimizer.GradientMergeOptimizer(
        fl.optimizer.Lamb(learning_rate=1e-3), k_steps=2)


def test_bert_tiny_merged_matches_jax():
    nets = {p: _bert(p, _merged_lamb, hidden_dropout=0.0,
                     attention_dropout=0.0) for p in PKGS}
    assert _norm(nets["torch"]["main"]) == _norm(nets["jax"]["main"])
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(nets["jax"]["startup"], scope=jscope)
    names = [v.name for v in nets["jax"]["startup"].global_block.vars
             .values()]
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy({n: jscope.numpy(n) for n in names}, tscope,
                     tfluid.CPUPlace(), programs=[nets["torch"]["main"]])
    for s in range(2):
        feed = _bert_feed(s)
        t = texe.run(nets["torch"]["main"], feed=feed,
                     fetch_list=[nets["torch"]["loss"]], scope=tscope)[0]
        j = jexe.run(nets["jax"]["main"], feed=feed,
                     fetch_list=[nets["jax"]["loss"]], scope=jscope)[0]
        np.testing.assert_allclose(t, j, rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   atol=1e-6, rtol=1e-4, err_msg=n)


def _schedule_lamb(fl):
    from importlib import import_module

    mp = import_module(fl.__name__ + ".contrib.mixed_precision")
    L = fl.layers
    lr = L.linear_lr_warmup(L.polynomial_decay(1e-3, 100, 0.0, 1.0), 10,
                            0.0, 1e-3)
    return fl.optimizer.GradientMergeOptimizer(
        mp.decorate(fl.optimizer.Lamb(learning_rate=lr)), k_steps=2)


def test_both_packages_refuse_a_schedule_inside_gradient_merge():
    """The composition the JAX package cannot run (its schedule ops have
    the forward role, so they run inside the microbatch scan and the
    update cannot find the rate): the JAX package fails deep in lowering,
    the port refuses at the first run, naming the var and the cause."""
    nets = {p: _bert(p, _schedule_lamb) for p in PKGS}
    lr_names = {p: next(op.input("LearningRate")[0]
                        for b in nets[p]["main"].blocks for op in b.ops
                        if op.type == "lamb") for p in PKGS}
    assert lr_names["torch"] == lr_names["jax"]
    feed = _bert_feed()
    with pytest.raises(Exception, match=re.escape(lr_names["jax"])
                       + ".*not found"):
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(nets["jax"]["startup"], scope=scope)
        exe.run(nets["jax"]["main"], feed=feed,
                fetch_list=[nets["jax"]["loss"]], scope=scope)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(nets["torch"]["startup"], scope=scope)
    before = {n: scope.numpy(n).copy() for n in scope.vars}
    with pytest.raises(ValueError, match=re.escape(
            f"reads '{lr_names['torch']}'") + ".*learning-rate schedule"):
        exe.run(nets["torch"]["main"], feed=feed,
                fetch_list=[nets["torch"]["loss"]], scope=scope)
    for n, v in before.items():     # refused before anything ran
        np.testing.assert_array_equal(scope.numpy(n), v, err_msg=n)


def test_run_chained_refuses_microbatched_programs():
    main, startup, loss = _build("torch", 2)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="already a scan"):
        exe.run_chained(main, feed=_data(), fetch_list=[loss], steps=2,
                        scope=scope)


def _dropout_net():
    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[64], dtype="float32")
            d = tfluid.layers.dropout(
                x, 0.5, dropout_implementation="upscale_in_train")
            loss = tfluid.layers.reduce_sum(
                tfluid.layers.fc(d, 1, bias_attr=False))
            tfluid.optimizer.GradientMergeOptimizer(
                tfluid.optimizer.SGD(learning_rate=1.0), k_steps=2,
                avg=False).minimize(loss)
    return main, startup


def test_dropout_masks_differ_across_microbatches_and_repeat_across_runs():
    """Two identical rows, one per microbatch: w moves by the sum of the
    two upscaled masks (0, 2 or 4 per element). A 2 shows that the masks
    differ; a fresh executor repeats the whole step bit for bit."""
    main, startup = _dropout_net()
    w = main.all_parameters()[0].name

    def delta():
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        w0 = scope.numpy(w).copy()
        exe.run(main, feed={"x": np.ones((2, 64), np.float32)},
                scope=scope)
        return (w0 - scope.numpy(w)).ravel()

    a, b = delta(), delta()
    np.testing.assert_array_equal(a, b)
    assert set(np.round(a, 5)) <= {0.0, 2.0, 4.0}
    assert (np.round(a, 5) == 2.0).sum() > 10


def test_nan_check_labels_equal_the_jax_packages():
    """``FLAGS_check_nan_inf`` on a merged program with a NaN in one
    microbatch: both packages name the first accumulated gradient with the
    same label, letter for letter, and the port's scope is restored."""
    labels = {}
    for pkg in PKGS:
        fl = PKGS[pkg][0]
        fl.set_flags({"FLAGS_check_nan_inf": True})
        main, startup, loss = _build(pkg, 2)
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        before = {n: np.asarray(scope.numpy(n)).copy() for n in scope.vars}
        feed = _data(8)
        feed["x"][6, 3] = np.nan
        with pytest.raises(FloatingPointError) as e:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        labels[pkg] = re.search(r"non-finite value in (.*? scan\))",
                                str(e.value)).group(1)
        for n, v in before.items():
            np.testing.assert_array_equal(np.asarray(scope.numpy(n)), v)
    assert labels["torch"] == labels["jax"]
    assert labels["torch"].startswith("accumulated gradient '")
    assert labels["torch"].endswith("' (fwd/bwd microbatch scan)")
