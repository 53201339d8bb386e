"""The PyTorch port's BERT pretraining against the JAX package's, on the
CPU.

``BertConfig.tiny()`` (2 layers, hidden 128, 2 heads, vocab 1024) at
seq_len 32, batch 4. With both dropouts at 0 the two packages compute the
same function: the programs' ``to_dict()`` are equal, and from the JAX
package's initial scope (carried with ``interop.scope_from_numpy``) three
Adam steps give the same losses (rtol 1e-4) and the same parameters, Adam
moments and beta powers (atol 1e-6, rtol 1e-4: float32 with different
summation orders, three steps). With dropout on, the port is checked on
its own: the bits of its masks differ from jax.random's by design.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.contrib import mixed_precision
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_build

SEQ, BATCH = 32, 4
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)


def _cfg(cls, **kw):
    return dataclasses.replace(cls.tiny(), **kw)


def _normalized(prog):
    """to_dict() without source paths, int32 read as int64 (the JAX
    package runs with 64-bit types off; the port keeps int64)."""
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    lens = np.array([[32], [28], [20], [32]])
    return {
        "src_ids": rng.randint(0, 1024, (BATCH, SEQ)).astype(np.int64),
        "pos_ids": np.tile(np.arange(SEQ), (BATCH, 1)).astype(np.int64),
        "sent_ids": (np.arange(SEQ)[None] >= 16).astype(np.int64)
        .repeat(BATCH, 0),
        "input_mask": (np.arange(SEQ)[None] < lens).astype(np.float32),
        "mask_label": np.where(rng.rand(BATCH, SEQ) < 0.15,
                               rng.randint(0, 1024, (BATCH, SEQ)),
                               -100).astype(np.int64),
        "next_sent_label": rng.randint(0, 2, (BATCH, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def nets():
    with jun.guard():
        j = j_build(_cfg(JBertConfig, **NO_DROPOUT), seq_len=SEQ)
    with tun.guard():
        t = t_build(_cfg(TBertConfig, **NO_DROPOUT), seq_len=SEQ)
    return j, t


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("optimizer", [False, True])
def test_program_dicts_match_jax(which, optimizer):
    with jun.guard():
        j = j_build(JBertConfig.tiny(), seq_len=SEQ,
                    build_optimizer=optimizer)
    with tun.guard():
        t = t_build(TBertConfig.tiny(), seq_len=SEQ,
                    build_optimizer=optimizer)
    assert _normalized(t[which]) == _normalized(j[which])


def test_train_steps_match_jax(nets):
    j, t = nets
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    names = [v.name for v in j["startup"].global_block.vars.values()]
    state = {n: jscope.numpy(n) for n in names}
    assert sum(n.startswith(("moment1_", "moment2_", "beta1_pow_acc_",
                             "beta2_pow_acc_")) for n in names) == \
        4 * len(t["main"].all_parameters())
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy(state, tscope, tfluid.CPUPlace(), programs=[t["main"]])
    feed = _feed()
    K.reset_launch_counts()
    losses = []
    for step in range(3):
        jl = jexe.run(j["main"], feed=feed,
                      fetch_list=[j["loss"], j["mlm_loss"], j["nsp_loss"]],
                      scope=jscope)
        tl = texe.run(t["main"], feed=feed,
                      fetch_list=[t["loss"], t["mlm_loss"], t["nsp_loss"]],
                      scope=tscope)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       err_msg=f"step {step}")
        losses.append(float(tl[0][0]))
    assert losses[2] < losses[1] < losses[0]
    for n in names:
        np.testing.assert_allclose(tscope.numpy(n), jscope.numpy(n),
                                   atol=1e-6, rtol=1e-4, err_msg=n)
    assert set(K.launch_counts().values()) == {0}       # CPU: no kernels


def test_dropout_training_is_deterministic_and_learns():
    """Hidden and attention dropout on (0.1, the base config's): two fresh
    executors from the same state give identical losses, and the loss on
    the repeated batch falls."""
    with tun.guard():
        t = t_build(TBertConfig.tiny(), seq_len=SEQ, lr=1e-3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    t["startup"].random_seed = 3
    exe.run(t["startup"], scope=scope)
    state = {n: scope.numpy(n) for n in scope.vars}
    runs = []
    for _ in range(2):
        s = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace(),
                             programs=[t["main"]])
        e = tfluid.Executor(tfluid.CPUPlace())
        runs.append([float(e.run(t["main"], feed=_feed(), fetch_list=[
            t["loss"]], scope=s)[0][0]) for _ in range(4)])
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_amp_is_refused():
    """``amp=True`` was refused until the port had an AMP policy; it now
    builds the decorated program (its checks: ``test_torch_amp.py``), and
    what is refused is a compute type the port does not know."""
    with tun.guard():
        t = t_build(TBertConfig.tiny(), seq_len=SEQ, amp=True)
    assert t["main"]._amp_policy.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="unknown dtype"):
        mixed_precision.decorate_program(t["main"], compute_dtype="fp8")
