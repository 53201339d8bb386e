"""The PyTorch port's static cost model and MFU gauges against the JAX
package's, on the CPU.

* ``analysis.cost_model.estimate_cost`` gives the same report (FLOPs in
  total, by role and by op type, activation and parameter bytes, op count,
  unknown ops) as the JAX package's on the programs of
  ``tests/test_trace.py``'s cost-model cases, on BERT-tiny (``amp=False``
  and ``amp=True``) and on ResNet-18, each built in both packages under
  ``unique_name.guard()``. The JAX package declares int64 vars int32, so
  the port program is costed with the JAX program's declared dtypes (the
  model reads declarations, never values); FLOPs do not depend on them.
* The registered ``cost_model`` pass returns a ``CostReport`` and reports
  no diagnostics.
* The executor's ``executor_mfu`` gauge is its ``executor_achieved_tflops``
  over ``FLAGS_device_peak_tflops``, whose default is the H100 SXM's dense
  bf16 peak (989.4 TFLOP/s); the serving engine sets its bucket gauges.
* The comms half waits for the multi-device slice and raises.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis.cost_model import estimate_cost as j_cost
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_bert
from paddle_tpu.models.resnet import build_resnet as j_resnet

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.analysis import cost_model as tcm
from paddle_tpu_torch.analysis.cost_model import estimate_cost as t_cost
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_bert
from paddle_tpu_torch.models.resnet import build_resnet as t_resnet

H100_BF16_DENSE_TFLOPS = 989.4


def _declare_as(tprog, jprog):
    for tb, jb in zip(tprog.blocks, jprog.blocks):
        for n, v in tb.vars.items():
            jv = jb.vars.get(n)
            if jv is not None and str(jv.dtype) != v.dtype:
                v.dtype = str(jv.dtype)


def _small_mul(fluid, un):
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            fluid.layers.fc(x, size=3, bias_attr=False)   # mul only
    return main, 4


def _conv_sgd(fluid, un):
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
            c = fluid.layers.conv2d(img, 4, 3, padding=1, bias_attr=False)
            loss = fluid.layers.mean(c)
            fluid.optimizer.SGD(0.1).minimize(loss)
    return main, 2


def _fc_bias(fluid, un):
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            fluid.layers.fc(x, size=3)
    return main, 16


def _bert(amp):
    def build(fluid, un):
        cfg, fn = ((JBertConfig, j_bert) if fluid is jfluid
                   else (TBertConfig, t_bert))
        with un.guard():
            return fn(cfg.tiny(), seq_len=32, amp=amp)["main"], 8
    return build


def _resnet18(fluid, un):
    fn = j_resnet if fluid is jfluid else t_resnet
    with un.guard():
        return fn(18, class_num=10, image_shape=(3, 64, 64))["main"], 4


PROGRAMS = {"small_mul": _small_mul, "conv_sgd": _conv_sgd,
            "fc_bias": _fc_bias, "bert_tiny": _bert(False),
            "bert_tiny_amp": _bert(True), "resnet18": _resnet18}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_estimate_cost_matches_jax(name):
    jm, batch = PROGRAMS[name](jfluid, jun)
    tm, _ = PROGRAMS[name](tfluid, tun)
    _declare_as(tm, jm)
    jr, tr = j_cost(jm, batch_size=batch), t_cost(tm, batch_size=batch)
    assert tr.flops_total == jr.flops_total > 0
    assert tr.flops_by_op_type == jr.flops_by_op_type
    assert (tr.flops_forward, tr.flops_backward, tr.flops_optimizer) == \
        (jr.flops_forward, jr.flops_backward, jr.flops_optimizer)
    assert sorted(tr.unknown_ops) == sorted(jr.unknown_ops)
    assert tr.to_dict() == jr.to_dict()


def test_cost_model_exact_small_program():
    main, _ = _small_mul(tfluid, tun)
    rep = t_cost(main, batch_size=4)
    # one mul: 2 * M(4) * K(8) * N(3) = 192 FLOPs
    assert rep.flops_by_op_type["mul"] == 192.0
    assert rep.flops_forward == rep.flops_total
    assert rep.param_bytes == 8 * 3 * 4
    assert rep.batch_size == 4 and rep.flops_per_byte > 0


def test_cost_model_conv_and_grads():
    main, _ = _conv_sgd(tfluid, tun)
    rep = t_cost(main, batch_size=2)
    assert rep.flops_by_op_type["conv2d"] == 2 * (2 * 4 * 8 * 8) * 27
    assert rep.flops_by_op_type["conv2d_grad"] == \
        2 * rep.flops_by_op_type["conv2d"]
    assert rep.flops_backward > 0 and rep.flops_optimizer > 0


def test_cost_model_registered_as_pass():
    from paddle_tpu_torch.analysis import CostReport
    from paddle_tpu_torch.analysis.pass_manager import default_pass_manager

    main, _ = _fc_bias(tfluid, tun)
    out = main.global_block.ops[-1].output_arg_names[0]
    res = default_pass_manager().run_pipeline(
        main, ["cost_model"], fetch_names=[out], batch_size=16)
    rep = res.values["cost_model"]
    assert isinstance(rep, CostReport)
    assert rep.batch_size == 16 and rep.flops_total > 0
    assert res.diagnostics == []


def test_remat_segments_are_costed_as_in_jax():
    """recompute_segment costs 0 and its grad 1 FLOP an element in both
    packages, so a rematerialised program's cost undercounts its
    backward: model FLOPs come from the untransformed program."""
    from paddle_tpu.analysis.remat import auto_recompute_program as jdec
    from paddle_tpu_torch.analysis.remat import \
        auto_recompute_program as tdec

    jm, _ = _bert(True)(jfluid, jun)
    tm, _ = _bert(True)(tfluid, tun)
    _declare_as(tm, jm)
    feeds = ["input_mask", "mask_label", "next_sent_label", "pos_ids",
             "sent_ids", "src_ids"]
    jp, tp = jdec(jm, feeds, [], 8).program, tdec(tm, feeds, [], 8).program
    jr, tr = j_cost(jp, batch_size=8), t_cost(tp, batch_size=8)
    assert tr.to_dict() == jr.to_dict()
    assert tr.flops_by_op_type.get("recompute_segment", 0.0) == 0.0
    assert tr.flops_total < t_cost(tm, batch_size=8).flops_total


def test_device_peak_default_is_the_h100():
    assert tfluid.get_flags("FLAGS_device_peak_tflops") == {
        "FLAGS_device_peak_tflops": H100_BF16_DENSE_TFLOPS}
    rep = t_cost(_small_mul(tfluid, tun)[0], batch_size=4)
    assert rep.mfu(1.0) == pytest.approx(
        rep.flops_total / (H100_BF16_DENSE_TFLOPS * 1e12))


def test_mfu_gauges_from_executor_and_serving():
    tmonitor.reset()
    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[6], dtype="float32")
            y = tfluid.layers.fc(tfluid.layers.fc(x, 8, act="relu"), 3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((4, 6), np.float32)},
            fetch_list=[y], scope=scope)
    labels = dict(path="run", program=str(main._serial), batch="4")
    mfu = tmonitor.metric_value("executor_mfu", None, **labels)
    achieved = tmonitor.metric_value("executor_achieved_tflops", None,
                                     **labels)
    assert mfu is not None and 0 <= mfu < 1
    assert mfu == pytest.approx(achieved / H100_BF16_DENSE_TFLOPS)
    gflops = tmonitor.metric_value("executor_model_gflops_per_step", 0.0,
                                   program=str(main._serial), batch="4")
    assert gflops == pytest.approx(
        t_cost(main, batch_size=4).flops_total / 1e9)
    infer = main.clone(for_test=True)
    eng = tserving.ServingEngine(
        infer, feed_names=["x"], fetch_list=[y.name], scope=scope,
        executor=exe, config=tserving.ServingConfig(max_batch=4))
    with eng:
        eng.submit({"x": np.ones((1, 6), np.float32)}).result(timeout=60)
    snap = tmonitor.get_registry().to_dict()
    assert "serving_bucket_mfu" in snap
    assert "serving_bucket_achieved_tflops" in snap


def test_comms_half_is_refused():
    with pytest.raises(NotImplementedError, match="sharding_check"):
        tcm.estimate_comms(None)
    with pytest.raises(NotImplementedError, match="multi-device"):
        tcm.comms_compute_ratio(None, None)
