"""The PyTorch port's bf16 mixed precision (AMP) against the JAX package's,
on the CPU.

* The JAX package's own ``tests/test_amp.py`` cases, held in the port: a
  two-layer MLP whose every matrix product (forward and generic grads)
  runs on bf16 operands while the scope stays float32; bf16 training
  reaching float32 quality; dynamic loss scaling that grows, shrinks and
  skips the whole update on an overflow step; the eval clone keeping the
  policy; custom lists.
* Parity with the JAX package: the decorated programs' ``to_dict()``
  (policy and loss-scaling sub-block included), BERT-tiny ``amp=True``
  losses over three Adam steps from the same weights (dropout 0), and
  ``fused_multihead_attention`` taking float32 Q/K/V in both packages: the
  q/k/v products run in bf16 and their float32 biases promote them back.
* AMP fused inference on BERT-tiny: the same fusion decisions and fused
  program as the JAX package; the dense replay bit-exact against the
  unfused program; the kernel's plain version (``FLAGS_use_fused_gemm=
  always``) within the witness's bf16 tolerance.

Tolerances: bf16 keeps 8 significant bits (a relative step of 2**-8 =
3.9e-3). XLA and PyTorch sum a bf16 product's k terms in different
orders before rounding, so single products may differ by one bf16 step;
over BERT-tiny's three steps the losses stay within rtol 1e-3 (measured
up to 5.3e-5), and the fused loss within the witness's bf16 (rtol, atol)
of the unfused.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu import layers as jlayers
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.analysis.epilogue_fusion import fuse_epilogues as j_fuse
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.core import registry as jregistry
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.analysis.epilogue_fusion import (WITNESS_TOLERANCES,
                                                       fuse_epilogues)
from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_build
from paddle_tpu_torch.ops import fused_gemm as tfused_gemm

SEQ, BATCH = 32, 4
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
# bf16 losses of the two packages over three steps (module docstring)
BF16_LOSS_RTOL = 1e-3
GEMMS = ("mm", "bmm", "addmm")


@pytest.fixture(autouse=True)
def _flag_reset():
    names = ["FLAGS_epilogue_fusion", "FLAGS_use_fused_gemm"]
    prev = tfluid.get_flags(names)
    yield
    tfluid.set_flags(prev)


def _normalized(prog):
    """to_dict() without source paths, int32 read as int64."""
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


# -- the JAX package's tests/test_amp.py, held in the port --------------------

def _mlp_program(fl, lay, opt_mod, amp_mod, batch=32, use_amp=True,
                 **amp_kw):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        img = lay.data("img", shape=[batch, 64], append_batch_size=False)
        label = lay.data("label", shape=[batch, 1], dtype="int64",
                         append_batch_size=False)
        h = lay.fc(img, 64, act="relu")
        logits = lay.fc(h, 10)
        loss = lay.mean(lay.softmax_with_cross_entropy(logits, label))
        opt = opt_mod.Adam(1e-2)
        if use_amp:
            opt = amp_mod.decorate(opt, **amp_kw)
        opt.minimize(loss)
    return main, startup, loss, opt


def _port_mlp(**kw):
    return _mlp_program(tfluid, tlayers, toptimizer, mp, **kw)


def _batch(rng, batch=32):
    x = rng.rand(batch, 64).astype(np.float32)
    y = ((x.sum(1) > 32).astype(np.int64) % 10).reshape(batch, 1)
    return x, y


class _GemmDtypes(TorchDispatchMode):
    """Records (op type being run, aten GEMM, operand dtypes) of every
    aten.mm/bmm/addmm on real tensors: the port's counterpart of scanning
    a jaxpr's dot_general lines. Shape inference on meta tensors (the
    ``FLAGS_check_program`` verifier's replay before a program's first
    run) computes nothing and is not recorded."""

    def __init__(self):
        super().__init__()
        self.op = None
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in GEMMS and not any(
                isinstance(a, torch.Tensor) and a.is_meta for a in args):
            self.seen.append((self.op, name, tuple(
                a.dtype for a in args if isinstance(a, torch.Tensor))))
        return func(*args, **(kwargs or {}))


def _record_gemms(monkeypatch, run):
    """``run()`` with every GEMM recorded against the op that issued
    it."""
    rec = _GemmDtypes()
    real = texecutor.lower_op

    def tagged(op, env, ctx):
        rec.op = op.type
        real(op, env, ctx)

    monkeypatch.setattr(texecutor, "lower_op", tagged)
    with rec:
        run()
    return rec.seen


def test_bf16_policy_casts_matmuls_keeps_master_weights_fp32(monkeypatch):
    main, startup, loss, _ = _port_mlp()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    seen = _record_gemms(monkeypatch, lambda: exe.run(
        main, feed={"img": np.zeros((32, 64), np.float32),
                    "label": np.zeros((32, 1), np.int64)},
        fetch_list=[loss], scope=scope))
    assert {op for op, _, _ in seen} == {"mul", "mul_grad"}, seen
    # every product, forward and grads, computes in bf16
    assert all(set(dts) == {torch.bfloat16} for _, _, dts in seen), seen
    # master weights and Adam state stay float32 in the scope
    for n, v in scope.vars.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, n


def test_amp_trains_to_fp32_quality():
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(60)]

    def run(use_amp):
        main, startup, loss, _ = _port_mlp(use_amp=use_amp)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        for x, y in batches:
            l = exe.run(main, feed={"img": x, "label": y},
                        fetch_list=[loss], scope=scope)[0]
        return float(l)

    l_fp32, l_bf16 = run(False), run(True)
    assert l_bf16 < 0.9, f"bf16 failed to train: {l_bf16}"   # from ~2.08
    assert abs(l_bf16 - l_fp32) < 0.1, (l_fp32, l_bf16)


def test_dynamic_loss_scaling_grows_and_shrinks():
    main, startup, loss, opt = _port_mlp(
        use_dynamic_loss_scaling=True, init_loss_scaling=1024.0,
        incr_every_n_steps=2, decr_every_n_nan_or_inf=1, incr_ratio=2.0,
        decr_ratio=0.5)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    rng = np.random.RandomState(1)
    scale_var = opt.get_loss_scaling()
    exe.run(startup, scope=scope)
    x, y = _batch(rng)
    for _ in range(2):
        sc = exe.run(main, feed={"img": x, "label": y},
                     fetch_list=[scale_var], scope=scope)[0]
    assert float(sc[0]) == 2048.0, sc              # grew after 2 finite steps
    # poison the batch: inf activations -> non-finite grads -> shrink, and
    # the WHOLE update is skipped (parameters and Adam state untouched)
    before = {n: scope.numpy(n).copy() for n in scope.vars}
    bad = np.full((32, 64), np.float32(3e38))
    sc = exe.run(main, feed={"img": bad, "label": y},
                 fetch_list=[scale_var], scope=scope)[0]
    assert float(sc[0]) == 1024.0, sc
    for n, v in before.items():
        if any(s in n for s in ("loss_scaling", "bad_steps", "good_steps",
                                "learning_rate")):
            continue
        np.testing.assert_array_equal(
            scope.numpy(n), v, err_msg=f"{n} changed on an overflow step")
    l = exe.run(main, feed={"img": x, "label": y}, fetch_list=[loss],
                scope=scope)[0]
    assert np.isfinite(l)


def test_eval_clone_keeps_amp_policy():
    main, _, _, _ = _port_mlp()
    test_prog = main.clone(for_test=True)
    assert test_prog._amp_policy is not None
    assert test_prog._amp_policy.white == main._amp_policy.white


def test_custom_lists():
    lists = mp.AutoMixedPrecisionLists(custom_white_list={"softmax"},
                                       custom_black_list={"mul"})
    assert "softmax" in lists.white_list
    assert "softmax" not in lists.black_list
    assert "mul" in lists.black_list
    with pytest.raises(ValueError, match="both custom lists"):
        mp.AutoMixedPrecisionLists(custom_white_list={"mul"},
                                   custom_black_list={"mul"})


def test_decorate_program_bumps_the_version_and_round_trips():
    main, _, _, _ = _port_mlp(use_amp=False)
    v0 = main._version
    mp.decorate_program(main)
    assert main._version == v0 + 1
    back = tfluid.Program.from_json(main.to_json())
    assert back._amp_policy.compute_dtype == "bfloat16"
    assert back.to_dict() == main.to_dict()


# -- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("scaling", [
    {}, {"use_dynamic_loss_scaling": True, "init_loss_scaling": 1024.0}],
    ids=["no_scaling", "dynamic_scaling"])
@pytest.mark.parametrize("which", ["main", "startup"])
def test_decorated_mlp_program_dicts_match_jax(which, scaling):
    """The policy, the scaled loss, check_finite_and_unscale,
    update_loss_scaling, logical_not and the conditional_block over the
    update sub-block: the same program in both packages."""
    with jun.guard():
        j = _mlp_program(fluid, jlayers, joptimizer, jmp, **scaling)
    with tun.guard():
        t = _port_mlp(**scaling)
    jd, td = _normalized(j[0 if which == "main" else 1]), \
        _normalized(t[0 if which == "main" else 1])
    assert td == jd
    if which == "main":
        assert td["amp_policy"]["compute_dtype"] == "bfloat16"
        assert len(td["blocks"]) == (2 if scaling else 1)


@pytest.mark.parametrize("which", ["main", "startup"])
def test_bert_amp_program_dicts_match_jax(which):
    with jun.guard():
        j = j_build(JBertConfig.tiny(), seq_len=SEQ, amp=True)
    with tun.guard():
        t = t_build(TBertConfig.tiny(), seq_len=SEQ, amp=True)
    assert _normalized(t[which]) == _normalized(j[which])
    if which == "main":
        assert "amp_policy" in t[which].to_dict()


def _bert_feed(seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    lens = rng.randint(SEQ // 2, SEQ + 1, (batch, 1))
    lens[0] = SEQ
    return {
        "src_ids": rng.randint(0, 1024, (batch, SEQ)).astype(np.int64),
        "pos_ids": np.tile(np.arange(SEQ), (batch, 1)).astype(np.int64),
        "sent_ids": (np.arange(SEQ)[None] >= 16).astype(np.int64)
        .repeat(batch, 0),
        "input_mask": (np.arange(SEQ)[None] < lens).astype(np.float32),
        "mask_label": np.where(rng.rand(batch, SEQ) < 0.15,
                               rng.randint(0, 1024, (batch, SEQ)),
                               -100).astype(np.int64),
        "next_sent_label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def amp_nets():
    with jun.guard():
        j = j_build(dataclasses.replace(JBertConfig.tiny(), **NO_DROPOUT),
                    seq_len=SEQ, amp=True)
    with tun.guard():
        t = t_build(dataclasses.replace(TBertConfig.tiny(), **NO_DROPOUT),
                    seq_len=SEQ, amp=True)
    return j, t


def _jax_state(j):
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    names = [v.name for v in j["startup"].global_block.vars.values()]
    return jexe, jscope, {n: jscope.numpy(n) for n in names}


def test_bert_tiny_amp_losses_match_jax(amp_nets):
    j, t = amp_nets
    jexe, jscope, state = _jax_state(j)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace(),
                              programs=[t["main"]])
    feed = _bert_feed()
    fetch = ("loss", "mlm_loss", "nsp_loss")
    losses = []
    for step in range(3):
        jl = jexe.run(j["main"], feed=feed,
                      fetch_list=[j[k] for k in fetch], scope=jscope)
        tl = texe.run(t["main"], feed=feed,
                      fetch_list=[t[k] for k in fetch], scope=tscope)
        for k, a, b in zip(fetch, tl, jl):
            np.testing.assert_allclose(a, b, rtol=BF16_LOSS_RTOL,
                                       err_msg=f"{k}, step {step}")
        losses.append(float(tl[0][0]))
    assert losses[2] < losses[1] < losses[0]
    for n in state:
        v = tscope.find_var(n)
        if v.is_floating_point():
            assert v.dtype == torch.float32, n


def test_bert_tiny_amp_step_runs_every_product_in_bf16(amp_nets,
                                                       monkeypatch):
    """One AMP train step: every GEMM a mul/matmul or its generic grad
    issues takes bf16 operands; attention (the plain version on the CPU)
    stays float32; parameters, their gradients and Adam moments stay
    float32."""
    _, t = amp_nets
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(t["startup"], scope=scope)
    seen = _record_gemms(monkeypatch, lambda: exe.run(
        t["main"], feed=_bert_feed(), fetch_list=[t["loss"]], scope=scope))
    products = [(op, dts) for op, _, dts in seen
                if op in ("mul", "matmul", "mul_grad", "matmul_grad")]
    assert {op for op, _ in products} == {"mul", "matmul", "mul_grad",
                                          "matmul_grad"}
    assert all(set(dts) == {torch.bfloat16} for _, dts in products), \
        products
    attention = [dts for op, _, dts in seen
                 if op.startswith("fused_multihead_attention")]
    assert attention and all(set(d) == {torch.float32} for d in attention)
    assert {op for op, _, _ in seen} <= {
        "mul", "matmul", "mul_grad", "matmul_grad",
        "fused_multihead_attention", "fused_multihead_attention_grad"}
    for n, v in scope.vars.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, n
    # the gradients reaching Adam are f32 too
    params = [p.name for p in t["main"].all_parameters()]
    grads = exe.run(t["main"], feed=_bert_feed(), scope=scope,
                    fetch_list=[n + "@GRAD" for n in params],
                    return_numpy=False)
    assert {g.dtype for g in grads} == {torch.float32}


def _record_attention_dtypes(monkeypatch, registry):
    opdef = registry.get_op_def("fused_multihead_attention")
    real, seen = opdef.lower, []

    def spy(ctx, ins, attrs):
        # shape inference on meta tensors (the FLAGS_check_program
        # verifier's replay) computes nothing: not a call of the step
        if not getattr(ins["Q"][0], "is_meta", False):
            seen.append(tuple(str(ins[s][0].dtype) for s in ("Q", "K", "V")))
        return real(ctx, ins, attrs)

    monkeypatch.setattr(opdef, "lower", spy)
    return seen


def test_attention_takes_f32_qkv_under_amp_in_both_packages(amp_nets,
                                                            monkeypatch):
    """The bias add after each bf16 q/k/v product promotes to float32, so
    the K1/K3/K4 routes that AMP training reaches are the float32 ones:
    in the JAX package (traced by its executor) and in the port."""
    j, t = amp_nets
    jseen = _record_attention_dtypes(monkeypatch, jregistry)
    tseen = _record_attention_dtypes(monkeypatch, tregistry)
    jexe, jscope, state = _jax_state(j)
    jexe.run(j["main"], feed=_bert_feed(), fetch_list=[j["loss"]],
             scope=jscope)
    tscope = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace(),
                              programs=[t["main"]])
    tfluid.Executor(tfluid.CPUPlace()).run(
        t["main"], feed=_bert_feed(), fetch_list=[t["loss"]], scope=tscope)
    assert jseen and set(jseen) == {("float32",) * 3}, jseen
    # forward and the generic grad's rerun, once a layer each
    assert len(tseen) == 2 * TBertConfig.tiny().num_layers
    assert set(tseen) == {("torch.float32",) * 3}, tseen


# -- AMP fused inference -------------------------------------------------------

def _route_as_on_the_card(monkeypatch):
    """CPU tensors take the routes CUDA tensors would: the kernel's plain
    version ('plain') wherever the card would launch K5, the dense replay
    elsewhere (the NSP head, n = 2)."""
    real = tfused_gemm.fused_gemm_route

    def route(*a, **kw):
        kw["on_cuda"] = True
        kind, reason = real(*a, **kw)
        return ("plain" if kind == "cuda" else kind), reason

    monkeypatch.setattr(tfused_gemm, "fused_gemm_route", route)


def test_bert_tiny_amp_inference_fuses_like_jax(monkeypatch):
    """decorate_program on the is_test clone: both packages fuse the same
    15 chains with the same refusals and the same fused program (policy
    included); in the port the dense replay is bit-exact against the
    unfused program, and with the card's routes the kernel's plain
    version (bf16 x and y, float32 accumulator and epilogue) runs 14
    chains within the witness's bf16 tolerance, which the float32 one
    would refuse, and gives the unfused loss within it."""
    with jun.guard():
        j = j_build(JBertConfig.tiny(), seq_len=SEQ, build_optimizer=False)
    with tun.guard():
        t = t_build(TBertConfig.tiny(), seq_len=SEQ, build_optimizer=False)
    jinf = jmp.decorate_program(j["main"].clone(for_test=True))
    tinf = mp.decorate_program(t["main"].clone(for_test=True))
    assert _normalized(tinf) == _normalized(jinf)
    fetch = [t["loss"].name]
    jd, td = [], []
    # batch 8: the JAX package's PT755 also refuses m not a multiple of
    # its 8-row tile, a difference by design (ROADMAP Queue C)
    jdec = j_fuse(jinf, fetch_names=fetch, diags=jd, batch=8)
    tdec = fuse_epilogues(tinf, fetch_names=fetch, diags=td, batch=8)
    assert (tdec.applied, tdec.n_fused, tdec.n_refused, tdec.chains) == (
        jdec.applied, jdec.n_fused, jdec.n_refused, jdec.chains)
    assert sorted(d.code for d in td) == sorted(d.code for d in jd)
    assert tdec.n_fused == 15
    assert _normalized(tdec.program) == _normalized(jdec.program)
    assert tdec.program._amp_policy is not None

    _, _, state = _jax_state(j)
    feed = _bert_feed(1, batch=8)
    runs = {}
    for mode in ("unfused", "dense", "plain"):
        if mode == "plain":
            _route_as_on_the_card(monkeypatch)
        tfluid.set_flags({"FLAGS_epilogue_fusion": mode != "unfused"})
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace(),
                                 programs=[tinf])
        K.reset_launch_counts()
        runs[mode] = exe.run(tinf, feed=feed, fetch_list=fetch,
                             scope=scope)[0]
        assert K.fused_gemm.launches == 0
        if mode == "unfused":
            continue
        (dec,) = exe._fusion_decisions.values()
        assert dec.applied and dec.n_fused == 15
        routes = [w["route"] for w in dec.witness]
        if mode == "plain":
            assert sorted(routes) == ["plain"] * 5 + ["primitive"]
            errs = [w["max_abs_err"] for w in dec.witness
                    if w["route"] == "plain"]
            assert max(errs) > WITNESS_TOLERANCES["float32"][1]
        else:
            assert set(routes) == {"primitive"}
    assert np.array_equal(runs["dense"], runs["unfused"])
    rtol, atol = WITNESS_TOLERANCES["bfloat16"]
    np.testing.assert_allclose(runs["plain"], runs["unfused"], rtol=rtol,
                               atol=atol)
    assert np.isfinite(runs["plain"]).all()
