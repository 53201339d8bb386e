"""Resuming a learning-rate schedule from a checkpoint: BERT-tiny trained
with ``decorate(Lamb)`` on a warmup/polynomial schedule, saved with
``io.save_checkpoint`` after step 3, loaded into a fresh scope (the port's
and the JAX package's: the file format is the JAX package's) and run for
steps 4-6, ends where the uninterrupted run ends: the schedule's counter,
both moments, the beta powers and the parameters, bit for bit in the
port; the JAX package's resumed run agrees within bf16 rounding. Dropout
is 0 so the JAX package can run the same function."""
import dataclasses

import numpy as np

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.layers.learning_rate_scheduler import LR_COUNTER_NAME
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_build

SEQ, BATCH = 32, 4
PKGS = {"jax": (fluid, jun, JBertConfig, j_build),
        "torch": (tfluid, tun, TBertConfig, t_build)}


def _net(pkg):
    fl, un, cfg_cls, build = PKGS[pkg]
    from importlib import import_module

    mp = import_module(fl.__name__ + ".contrib.mixed_precision")
    cfg = dataclasses.replace(cfg_cls.tiny(), hidden_dropout=0.0,
                              attention_dropout=0.0)
    with un.guard():
        net = build(cfg, seq_len=SEQ, build_optimizer=False)
        with fl.program_guard(net["main"], net["startup"]):
            L = fl.layers
            lr = L.linear_lr_warmup(L.polynomial_decay(1e-3, 10, 0.0, 1.0),
                                    3, 0.0, 1e-3)
            mp.decorate(fl.optimizer.Lamb(learning_rate=lr)).minimize(
                net["loss"])
    net["lr"] = lr
    return net


def _feed(step):
    rng = np.random.RandomState(100 + step)
    lens = rng.randint(SEQ // 2, SEQ + 1, (BATCH, 1))
    real = np.arange(SEQ)[None] < lens
    masked = real & (rng.rand(BATCH, SEQ) < 0.15)
    return {"src_ids": rng.randint(0, 1024, (BATCH, SEQ)).astype(np.int64),
            "pos_ids": np.tile(np.arange(SEQ), (BATCH, 1)).astype(np.int64),
            "sent_ids": (np.arange(SEQ)[None] >= lens // 2).astype(np.int64),
            "input_mask": real.astype(np.float32),
            "mask_label": np.where(masked, rng.randint(0, 1024, (BATCH, SEQ)),
                                   -100).astype(np.int64),
            "next_sent_label": rng.randint(0, 2, (BATCH, 1)).astype(np.int64)}


def _steps(exe, net, scope, steps):
    return [exe.run(net["main"], feed=_feed(s), scope=scope,
                    fetch_list=[net["loss"], net["lr"]]) for s in steps]


def test_schedule_resumes_from_a_checkpoint_in_both_packages(tmp_path):
    jnet, tnet = _net("jax"), _net("torch")
    jexe, jscope0 = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jnet["startup"], scope=jscope0)
    names = [v.name for v in tnet["main"].global_block.vars.values()
             if v.persistable]
    init = {n: jscope0.numpy(n) for n in names}
    assert LR_COUNTER_NAME in init
    assert any(n.startswith("moment1_") for n in init)
    assert any(n.startswith("beta2_pow_acc_") for n in init)

    def fresh():
        return scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace(),
                                programs=[tnet["main"]])

    # the uninterrupted run
    texe = tfluid.Executor(tfluid.CPUPlace())
    full = fresh()
    straight = _steps(texe, tnet, full, range(6))
    # 3 steps, save, load into a fresh scope, 3 more
    first = fresh()
    head = _steps(texe, tnet, first, range(3))
    ckpt = str(tmp_path / "ckpt")
    tfluid.io.save_checkpoint(texe, ckpt, tnet["main"], scope=first,
                              meta={"step": 3})
    resumed = tfluid.Scope()
    texe2 = tfluid.Executor(tfluid.CPUPlace())
    assert tfluid.io.load_checkpoint(texe2, ckpt, tnet["main"],
                                     scope=resumed)["step"] == 3
    assert resumed.numpy(LR_COUNTER_NAME)[0] == 2.0
    tail = _steps(texe2, tnet, resumed, range(3, 6))
    for (a, lr_a), (b, lr_b) in zip(head + tail, straight):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(lr_a, lr_b)
    np.testing.assert_allclose([float(lr[0]) for _, lr in straight],
                               [0.0, 1e-3 / 3, 2e-3 / 3, 7e-4, 6e-4, 5e-4],
                               rtol=1e-6, atol=1e-12)
    for n in names:
        np.testing.assert_array_equal(resumed.numpy(n), full.numpy(n),
                                      err_msg=n)

    # the same file resumes the JAX package's run
    jscope = fluid.Scope()
    assert fluid.io.load_checkpoint(jexe, ckpt, jnet["main"],
                                    scope=jscope)["step"] == 3
    jtail = _steps(jexe, jnet, jscope, range(3, 6))
    for (a, lr_a), (b, lr_b) in zip(jtail, tail):
        np.testing.assert_allclose(a, b, rtol=1e-3)
        np.testing.assert_allclose(lr_a, lr_b, rtol=1e-6)
    assert jscope.numpy(LR_COUNTER_NAME)[0] == 5.0
    # the counter and the beta powers exactly; the rest within bf16
    # rounding of the products' operands, in relative L2 norm (plus 1e-6
    # for the key biases, whose gradient is 0 up to rounding)
    for n in names:
        j, t = np.asarray(jscope.numpy(n)), resumed.numpy(n)
        if n == LR_COUNTER_NAME or "_pow_acc_" in n:
            np.testing.assert_allclose(j, t, rtol=1e-6, err_msg=n)
        else:
            assert np.linalg.norm(j - t) <= 2e-2 * np.linalg.norm(t) + 1e-6, n
