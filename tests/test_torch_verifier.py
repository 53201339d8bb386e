"""The PyTorch port's static program verifier (``analysis/verifier.py``:
schema, dataflow, lowerability and shape replay, PT100-PT401, with
liveness PT500-PT504), ``check_program`` / ``FLAGS_check_program`` at
levels 1 and 2, ``PassVerificationError`` and the registry audit, against
the JAX package's on the CPU.

The lint zoo is the JAX package's ``tests/test_program_lint.py``: each
broken program is built in both packages by one shared build function
under ``unique_name.guard()`` and broken after append the same way (direct
field writes that bypass ``Operator.set_attr``). The verifier runs in both
and the findings must be equal by (code, severity, block, op index, op
type), and equal in message with the dtype words int32 and int64 read as
one (the port keeps int64 where the JAX package keeps int32, by design).
Then the model programs: GPT-2 small's generative programs, BERT-base
pretraining (f32 and AMP) and its inference clone, ResNet-50 training and
inference, at full width, built and verified (never run) in both packages
with every analysis pass, and their tiny versions run through the port's
executor at ``FLAGS_check_program=2`` with epilogue fusion and auto-remat
inside the strict bracket.
"""
import contextlib
import io
import os
import re
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis import verify_program as j_verify
from paddle_tpu.analysis.pass_manager import \
    ALL_ANALYSIS_PASSES as J_ALL
from paddle_tpu.core import registry as jreg

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import monitor
from paddle_tpu_torch.analysis import (ALL_ANALYSIS_PASSES, CODES,
                                       DEFAULT_PASSES, VERIFY_PASSES,
                                       PassVerificationError,
                                       ProgramVerificationError, Severity,
                                       audit_registry, check_program,
                                       coverage_summary, format_audit,
                                       format_diagnostics, register_pass,
                                       verify_program)
from paddle_tpu_torch.analysis.pass_manager import (TRANSFORM,
                                                    get_pass_registry,
                                                    run_transform_pipeline,
                                                    run_verify_pipeline)
from paddle_tpu_torch.core import registry as treg

JAX = types.SimpleNamespace(name="jax", fl=jfluid, un=jun, verify=j_verify,
                            reg=jreg, passes=J_ALL)
PORT = types.SimpleNamespace(name="port", fl=tfluid, un=tun,
                             verify=verify_program, reg=treg,
                             passes=ALL_ANALYSIS_PASSES)
FLAGS = ["FLAGS_check_program", "FLAGS_epilogue_fusion",
         "FLAGS_auto_recompute", "FLAGS_use_fused_gemm"]


@pytest.fixture(autouse=True)
def _isolation():
    prev = tfluid.get_flags(FLAGS)
    reg = get_pass_registry()
    snap = reg.snapshot()
    yield
    tfluid.set_flags(prev)
    reg.restore(snap)


def _norm(text):
    return re.sub(r"int32|int64", "int", text)


def _key(d):
    return (d.code, d.severity, d.block_idx, d.op_idx, d.op_type)


def _same(jd, td):
    assert sorted(map(_key, td)) == sorted(map(_key, jd)), \
        format_diagnostics(td)
    assert sorted((_key(d), _norm(d.message)) for d in td) == \
        sorted((_key(d), _norm(d.message)) for d in jd)


def codes_of(diags):
    return {d.code for d in diags}


def errors_of(diags):
    return [d for d in diags if d.severity == Severity.ERROR]


def _program(P, build):
    with P.un.guard():
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup):
            h = build(P, main)
    return main, h


def both(build, fetch=lambda h: [], passes=None):
    """The verifier over ``build``'s program in both packages; equal
    findings asserted; returns the port's findings and program."""
    got = {}
    for P in (JAX, PORT):
        prog, h = _program(P, build)
        kw = {} if passes is None else {"passes": passes}
        got[P.name] = (P.verify(prog, fetch_names=fetch(h), **kw), prog, h)
    _same(got["jax"][0], got["port"][0])
    return got["port"]


@contextlib.contextmanager
def _ops(**defs):
    """Register test-only op types in both registries for one test."""
    added = []
    try:
        for P in (JAX, PORT):
            for name, make in defs.items():
                if not P.reg.has_op(name):
                    P.reg._OP_REGISTRY[name] = make(P.reg)
                    added.append((P.reg, name))
        yield
    finally:
        for reg, name in added:
            del reg._OP_REGISTRY[name]


# ---------------------------------------------------------------------------
# the lint zoo (tests/test_program_lint.py), both packages
# ---------------------------------------------------------------------------

def _mlp(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    y = P.fl.layers.data("y", shape=[1], dtype="float32")
    h = P.fl.layers.fc(x, 8, act="relu")
    pred = P.fl.layers.fc(h, 1)
    loss = P.fl.layers.mean(P.fl.layers.square(
        P.fl.layers.elementwise_sub(pred, y)))
    P.fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _relu_op(main):
    return next(o for o in main.global_block.ops if o.type == "relu")


def _tiny(mutate):
    """One relu op on a declared input, broken by ``mutate(op, blk)``."""
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        P.fl.layers.relu(x)
        mutate(_relu_op(main), main.global_block)
    return build


def _set_type(t):
    return lambda op, blk: setattr(op, "type", t)


def _del_slot(where, slot):
    return lambda op, blk: getattr(op, where).pop(slot)


def _add_slot(where, slot, src):
    return lambda op, blk: getattr(op, where).__setitem__(
        slot, list(getattr(op, where)[src]))


ZOO = {
    "PT100": _tiny(_set_type("totally_not_an_op")),
    "PT100_grad": _tiny(_set_type("totally_not_an_op_grad")),
    "PT101": _tiny(_del_slot("inputs", "X")),
    "PT102": _tiny(_add_slot("inputs", "Bogus", "X")),
    "PT103": _tiny(_del_slot("outputs", "Out")),
    "PT104": _tiny(_add_slot("outputs", "Bogus", "Out")),
    "PT106": _tiny(lambda op, blk: op.attrs.__setitem__("mystery_knob", 7)),
    "PT107": _tiny(lambda op, blk: op.inputs.__setitem__(
        "X", [op.inputs["X"][0]] * 2)),
    "PT400": _tiny(lambda op, blk: setattr(
        blk.var(op.outputs["Out"][0]), "shape", (7, 7, 7))),
    "PT401": _tiny(lambda op, blk: setattr(
        blk.var(op.outputs["Out"][0]), "dtype", "int64")),
    "PT503": _tiny(lambda op, blk: blk.create_var(
        name="never_touched", shape=[3], dtype="float32")),
}


@pytest.mark.parametrize("code", sorted(ZOO))
def test_lint_zoo_equals_the_jax_package(code):
    diags, _, _ = both(ZOO[code])
    assert code.split("_")[0] in codes_of(diags)


def test_pt101_names_the_op_and_gates():
    diags, prog, _ = both(ZOO["PT101"])
    d = next(d for d in diags if d.code == "PT101")
    assert d.op_type == "relu" and d.severity == Severity.ERROR
    with pytest.raises(ProgramVerificationError, match="PT101"):
        check_program(prog)


def test_pt105_missing_required_attr():
    def opdef(reg):
        return reg.OpDef(type="pt_lint_reqattr", inputs=[reg.IOSpec("X")],
                         outputs=[reg.IOSpec("Out")],
                         attrs={"k": reg.AttrSpec("k", required=True)},
                         lower=lambda ctx, ins, attrs: {"Out": ins["X"]})

    def build(P, main):
        P.fl.layers.data("x", shape=[4], dtype="float32")
        blk = main.global_block
        blk.append_op("pt_lint_reqattr", inputs={"X": ["x"]},
                      outputs={"Out": ["x2"]}, attrs={"k": 1})
        del blk.ops[-1].attrs["k"]

    with _ops(pt_lint_reqattr=opdef):
        diags, _, _ = both(build)
    assert "PT105" in codes_of(diags)


def test_pt106_unknown_attr_warns_without_gating():
    diags, prog, _ = both(ZOO["PT106"])
    d = next(d for d in diags if d.code == "PT106")
    assert d.severity == Severity.WARNING
    check_program(prog)  # no raise


def test_grad_op_layout_checked():
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        P.fl.layers.relu(x)
        main.global_block.append_op(
            "relu_grad", inputs={"X": [x.name], "NotASlot": [x.name]},
            outputs={"X@GRAD": [x.name + "@GRAD"],
                     "Bogus@GRAD": [x.name + "@GRAD"]},
            attrs={"__fwd_type__": "relu"})

    diags, _, _ = both(build)
    assert {"PT102", "PT104"} <= codes_of(diags)


def _swap_relu_sigmoid(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    h = P.fl.layers.relu(x)
    P.fl.layers.sigmoid(h)
    ops = main.global_block.ops
    i = next(i for i, o in enumerate(ops) if o.type == "relu")
    j = next(i for i, o in enumerate(ops) if o.type == "sigmoid")
    ops[i], ops[j] = ops[j], ops[i]


def _uninitialized_read(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    P.fl.layers.relu(x)
    main.global_block.create_var(name="nowhere", shape=[4],
                                 dtype="float32")
    _relu_op(main).inputs["X"] = ["nowhere"]


def _write_after_write(P, main):
    blk = main.global_block
    blk.create_var(name="t", shape=[2], dtype="float32")
    for val in (0.0, 1.0):
        blk.append_op("fill_constant", outputs={"Out": ["t"]},
                      attrs={"shape": [2], "dtype": "float32",
                             "value": val})


def _dangling(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    return P.fl.layers.relu(x)


def test_pt200_use_before_def_gates():
    diags, prog, _ = both(_swap_relu_sigmoid)
    assert "PT200" in codes_of(diags)
    with pytest.raises(ProgramVerificationError):
        check_program(prog)


def test_pt201_uninitialized_read_is_a_warning():
    diags, _, _ = both(_uninitialized_read)
    assert "PT201" in codes_of(diags)
    assert all(d.severity != Severity.ERROR for d in diags
               if d.code == "PT201")


def test_pt202_write_after_write():
    diags, _, _ = both(_write_after_write)
    assert "PT202" in codes_of(diags)


def test_pt203_dangling_output_is_info():
    diags, prog, out = both(_dangling)
    assert "PT203" in codes_of(diags)
    assert "PT203" not in codes_of(verify_program(prog,
                                                  fetch_names=[out.name]))


def test_pt300_missing_lower_rule():
    def opdef(reg):
        return reg.OpDef(type="pt_lint_nolower", inputs=[reg.IOSpec("X")],
                         outputs=[reg.IOSpec("Out")])

    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        op = main.global_block.append_op(
            "relu", inputs={"X": [x.name]}, outputs={"Out": ["nl_out"]})
        main.global_block.ops[-1].type = "pt_lint_nolower"

    with _ops(pt_lint_nolower=opdef):
        diags, _, _ = both(build)
    assert "PT300" in codes_of(diags)


def test_pt301_grad_of_nondifferentiable():
    """A grad op of a forward that declares grad=None: the fused op (no
    backward, the fusion pass refuses training programs) in the port,
    psroi_pool in the JAX package's own test."""
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4, 4], dtype="float32")
        main.global_block.append_op(
            "relu", inputs={"X": [x.name]},
            outputs={"Out": [x.name + "@GRAD"]})
        op = main.global_block.ops[-1]
        op.type = "fused_gemm_epilogue_grad"
        op.outputs = {"X@GRAD": [x.name + "@GRAD"]}
        op.attrs = {"__fwd_type__": "fused_gemm_epilogue"}

    diags, _, _ = both(build)
    assert "PT301" in codes_of(diags)


def test_pt302_rng_under_deterministic_algorithms():
    """The port's switch is torch's own (the JAX package reads
    FLAGS_cudnn_deterministic): a dropout is flagged only while
    ``torch.use_deterministic_algorithms`` is on."""
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        P.fl.layers.dropout(x, dropout_prob=0.5)

    prog, _ = _program(PORT, build)
    assert "PT302" not in codes_of(verify_program(prog))
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        diags = verify_program(prog)
    finally:
        torch.use_deterministic_algorithms(prev)
    d = next(d for d in diags if d.code == "PT302")
    assert d.op_type == "dropout" and d.severity == Severity.WARNING
    jprog, _ = _program(JAX, build)
    jfluid.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        jd = j_verify(jprog)
    finally:
        jfluid.set_flags({"FLAGS_cudnn_deterministic": False})
    assert [_key(x) for x in jd if x.code == "PT302"] == [_key(d)]


def test_shape_replay_catches_raw_attr_mutation():
    def build(P, main):
        x = P.fl.layers.data("x", shape=[6], dtype="float32")
        P.fl.layers.reshape(x, shape=[-1, 2, 3])
        op = next(o for o in main.global_block.ops if o.type == "reshape2")
        op.attrs["shape"] = [-1, 3, 2]   # raw write: no re-infer

    diags, prog, _ = both(build)
    assert "PT400" in codes_of(diags)


def test_shape_replay_is_read_only():
    diags, prog, _ = both(ZOO["PT400"])
    out = _relu_op(prog).outputs["Out"][0]
    assert prog.global_block.var(out).shape == (7, 7, 7)


def test_pt500_pt504_liveness_through_the_verifier():
    def fetch_param(P, main):
        loss = _mlp(P, main)
        param = next(n for n in main.global_block.vars
                     if n.endswith(".w_0"))
        return [loss.name, param]

    diags, prog, fetch = both(fetch_param, fetch=lambda h: h)
    d = next(d for d in diags if d.code == "PT500")
    assert fetch[1] in d.message and d.severity == Severity.WARNING
    check_program(prog, fetch_names=fetch)

    def rebound(P, main):
        blk = main.global_block
        blk.create_var(name="stat", shape=[1], dtype="float32",
                       persistable=True)
        cv = P.fl.layers.fill_constant([1], "bool", True)
        sub = main._create_block()
        sub.append_op("fill_constant", outputs={"Out": ["stat"]},
                      attrs={"shape": [1], "dtype": "float32",
                             "value": 1.0})
        main._rollback()
        # the owning op does NOT list 'stat' in Out -> the write is lost
        # (the JAX package's test uses a while op, which the port does
        # not register yet)
        blk.append_op("conditional_block",
                      inputs={"Cond": [cv.name], "Input": []},
                      outputs={"Out": []}, attrs={"sub_block": sub.idx})

    diags, prog, _ = both(rebound)
    d = next(d for d in diags if d.code == "PT504")
    assert "stat" in d.message and d.severity == Severity.ERROR


def test_pt501_write_after_fetch():
    def build(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        h = P.fl.layers.relu(x)
        blk = main.global_block
        # an explicit fetch op (the port registers none: a stand-in
        # retyped, as the verifier reads only the type and slots)
        blk.append_op("assign", inputs={"X": [h.name]},
                      outputs={"Out": ["fetched_h"]})
        blk.ops[-1].type, blk.ops[-1].attrs = "fetch", {}
        blk.append_op("scale", inputs={"X": [h.name]},
                      outputs={"Out": [h.name]}, attrs={"scale": 2.0})
        return h

    diags, _, h = both(build, fetch=lambda h: [h.name])
    d = next(d for d in diags if d.code == "PT501")
    assert h.name in d.message and d.severity == Severity.WARNING


def test_clean_programs_have_no_errors():
    diags, prog, loss = both(_mlp, fetch=lambda h: [h.name])
    assert not errors_of(diags), format_diagnostics(diags)


# ---------------------------------------------------------------------------
# the model programs at full width, both packages, built only
# ---------------------------------------------------------------------------

def _models(kind, size):
    """{name: (program, fetch)} per package for one model family."""
    out = {}
    for P in (JAX, PORT):
        mods = __import__(f"paddle_tpu{'' if P is JAX else '_torch'}.models",
                          fromlist=["bert", "gpt", "resnet"])
        progs = {}
        with P.un.guard():
            if kind == "bert":
                cfg = getattr(mods.bert.BertConfig, size)()
                for amp in (False, True):
                    net = mods.bert.build_bert_pretrain(cfg, 512, amp=amp)
                    progs[f"train_amp{int(amp)}"] = (net["main"],
                                                     [net["loss"].name])
                progs["infer"] = (net["main"].clone(for_test=True),
                                  [net["loss"].name])
                progs["startup"] = (net["startup"], [])
            elif kind == "gpt":
                cfg = getattr(mods.gpt.GptConfig, size)()
                big = size == "base"
                net = mods.gpt.build_gpt_generative(
                    cfg, batch_slots=8, max_seq=1024 if big else 64,
                    prompt_buckets=(128, 512) if big else (16,))
                for k in ("decode", "chunk", "verify"):
                    progs[k] = (net[k]["main"], [])
                for b, pre in net["prefill"].items():
                    progs[f"prefill{b}"] = (pre["main"], [])
                progs["startup"] = (net["startup"], [])
            else:
                depth, hw = (50, 224) if size == "base" else (18, 64)
                net = mods.resnet.build_resnet(depth, image_shape=(3, hw, hw),
                                               amp=True)
                progs["train"] = (net["main"], [net["loss"].name])
                progs["infer"] = (net["main"].clone(for_test=True),
                                  [net["loss"].name])
        out[P.name] = progs
    return out


@pytest.mark.parametrize("kind", ["bert", "gpt", "resnet"])
def test_full_width_programs_verify_equal(kind):
    """BERT-base (seq 512, f32 and AMP training, the inference clone),
    GPT-2 small's generative programs (8 slots, 1024-token KV, buckets
    128/512) and ResNet-50 bf16 (training and inference): the full
    analysis suite gives equal findings in both packages, none an error."""
    progs = _models(kind, "base")
    for name, (tp, tf) in progs["port"].items():
        jp, jf = progs["jax"][name]
        td = verify_program(tp, fetch_names=tf, passes=ALL_ANALYSIS_PASSES)
        jd = j_verify(jp, fetch_names=jf, passes=J_ALL)
        _same(jd, td)
        assert not errors_of(td), (name, format_diagnostics(td))


# ---------------------------------------------------------------------------
# the executor hook and the strict bracket
# ---------------------------------------------------------------------------

def _feed(batch=2):
    return {"x": np.zeros((batch, 4), np.float32),
            "y": np.zeros((batch, 1), np.float32)}


def test_executor_hook_rejects_malformed_program():
    main, loss = _program(PORT, _mlp)
    startup = tfluid.Program()
    del _relu_op(main).inputs["X"]
    tfluid.set_flags({"FLAGS_check_program": 1})
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(ProgramVerificationError, match="PT101"):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=tfluid.Scope())
    with pytest.raises(ProgramVerificationError, match="PT101"):
        exe.run_chained(main, feed=_feed(), fetch_list=[loss], steps=2,
                        scope=tfluid.Scope())
    tfluid.set_flags({"FLAGS_check_program": 0})
    with pytest.raises(Exception) as err:   # fails later, unverified
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=tfluid.Scope())
    assert not isinstance(err.value, ProgramVerificationError)


def _built(P, build):
    with P.un.guard():
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup):
            h = build(P, main)
    return main, startup, h


def test_executor_hook_verifies_once_per_version():
    def runs(name):
        return monitor.metric_value(
            "pass_runs_total", 0.0,
            **{"pass": name, "kind": "analysis", "result": "run"})

    main, startup, loss = _built(PORT, _mlp)
    tfluid.set_flags({"FLAGS_check_program": 1})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    before = {n: runs(n) for n in VERIFY_PASSES}
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    n = len(exe._verified)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    exe.run_chained(main, feed=_feed(), fetch_list=[loss], steps=2,
                    scope=scope)
    assert len(exe._verified) == n == 2    # startup and main, once each
    for name in VERIFY_PASSES:
        assert runs(name) >= before[name] + 2, name
    hist = monitor.metric_value("pass_duration_seconds", None,
                                **{"pass": "liveness"})
    assert hist is not None and hist["count"] > 0
    exe.close()
    assert not exe._verified and not exe._cache


def _register_corrupting_pass(name):
    @register_pass(name, kind=TRANSFORM)
    def corrupt(program, ctx):
        p = program.clone()
        del _relu_op(p).inputs["X"]      # PT101: required input absent
        return p

    return name


def test_strict_verify_catches_corrupting_transform():
    main, loss = _program(PORT, _mlp)
    name = _register_corrupting_pass("pm_test_corrupt")
    pm = tfluid.analysis.default_pass_manager()
    with pytest.raises(PassVerificationError) as ei:
        pm.run_pipeline(main, (name,), fetch_names=[loss.name],
                        verify="strict")
    assert ei.value.pass_name == name and "PT101" in str(ei.value)
    assert isinstance(ei.value, ProgramVerificationError)
    res = pm.run_pipeline(main, (name,), fetch_names=[loss.name],
                          verify="none")
    assert res.changed


def test_check_program_level2_gates_transform_pipelines():
    main, loss = _program(PORT, _mlp)
    name = _register_corrupting_pass("pm_test_corrupt2")
    tfluid.set_flags({"FLAGS_check_program": 2})
    with pytest.raises(PassVerificationError):
        run_transform_pipeline(main, (name,), fetch_names=[loss.name])
    tfluid.set_flags({"FLAGS_check_program": 1})
    assert run_transform_pipeline(main, (name,),
                                  fetch_names=[loss.name]).changed


def test_strict_verify_ignores_preexisting_errors():
    main, loss = _program(PORT, _mlp)
    del next(o for o in main.global_block.ops
             if o.type == "mean").inputs["X"]

    @register_pass("pm_test_noop_t", kind=TRANSFORM)
    def noop(program, ctx):
        return program.clone()

    res = tfluid.analysis.default_pass_manager().run_pipeline(
        main, ("pm_test_noop_t",), fetch_names=[loss.name],
        verify="strict")
    assert res.changed


def test_verify_pipeline_matches_check_program():
    main, loss = _program(PORT, _mlp)
    del _relu_op(main).inputs["X"]
    with pytest.raises(ProgramVerificationError) as e1:
        check_program(main, fetch_names=[loss.name])
    with pytest.raises(ProgramVerificationError) as e2:
        run_verify_pipeline(main, fetch_names=[loss.name])
    assert [d.code for d in e1.value.diagnostics] == \
        [d.code for d in e2.value.diagnostics]
    assert tuple(DEFAULT_PASSES) == tuple(VERIFY_PASSES)


def _bert_feed(B, S, vocab=1024, seed=0):
    rng = np.random.RandomState(seed)
    m = rng.rand(B, S) < 0.15
    return {"src_ids": rng.randint(0, vocab, (B, S)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S), (B, 1)).astype(np.int64),
            "sent_ids": np.zeros((B, S), np.int64),
            "input_mask": np.ones((B, S), np.float32),
            "mask_label": np.where(m, rng.randint(0, vocab, (B, S)),
                                   -100).astype(np.int64),
            "next_sent_label": rng.randint(0, 2, (B, 1)).astype(np.int64)}


def test_level2_runs_fusion_and_remat_in_the_strict_bracket():
    """BERT-tiny at FLAGS_check_program=2 through the port's executor:
    the fused inference clone and the auto-remat rebuild each pass the
    bracket (no new error) and run; the verify passes ran on each
    program that ran."""
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    with tun.guard():
        net = build_bert_pretrain(BertConfig.tiny(), 32)
    feed = _bert_feed(4, 32)
    tfluid.set_flags({"FLAGS_check_program": 2,
                      "FLAGS_epilogue_fusion": True})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(net["startup"], scope=scope)
    infer = net["main"].clone(for_test=True)
    (loss,) = exe.run(infer, feed=feed, fetch_list=[net["loss"]],
                      scope=scope)
    assert np.isfinite(loss).all()
    (dec,) = exe._fusion_decisions.values()
    assert dec.applied and dec.n_fused > 0
    assert dec.program in [s.program for s in exe._cache.values()]
    tfluid.set_flags({"FLAGS_epilogue_fusion": False,
                      "FLAGS_auto_recompute": True})
    (loss,) = exe.run(net["main"], feed=feed, fetch_list=[net["loss"]],
                      scope=scope)
    assert np.isfinite(loss).all()
    (rdec,) = exe._remat_decisions.values()
    assert rdec.applied
    assert len(exe._verified) == 3   # startup, fused clone, remat rebuild


# ---------------------------------------------------------------------------
# the code table and the registry audit
# ---------------------------------------------------------------------------

def test_codes_are_the_reference_codes_and_each_is_tested():
    """Every port code is the JAX package's with its severity and text
    (PT906 reworded, PT801 naming the CUDA waits in place of
    block_until_ready), and each code of the verifier, liveness, the
    static checks, the concurrency lint and numerics appears in one of
    the port's test files (the fusion codes, PT75x, are compared with the
    JAX package's per program in ``test_torch_fusion.py``)."""
    from paddle_tpu.analysis import CODES as J_CODES

    for code, (sev, text) in CODES.items():
        assert J_CODES[code][0] == sev, code
        if code not in ("PT906", "PT801"):
            assert J_CODES[code][1] == text or code == "PT755", code
    here = os.path.dirname(os.path.abspath(__file__))
    blob = ""
    for fn in ("test_torch_verifier.py", "test_torch_static_checks.py",
               "test_torch_numerics.py", "test_torch_fusion.py",
               "test_torch_memory_plan.py", "test_torch_remat.py",
               "test_torch_concurrency_lint.py"):
        with io.open(os.path.join(here, fn), encoding="utf-8") as f:
            blob += f.read()
    missing = [c for c in CODES if c not in blob
               and not c.startswith("PT75")]
    assert not missing, missing
    left = sorted(set(J_CODES) - set(CODES))
    assert left == [f"PT7{n}" for n in range(30, 45)]


def test_registry_audit_over_the_port():
    rows = audit_registry()
    assert len(rows) == len(treg.all_ops())
    assert all(r["lower"] for r in rows
               if not r["op"].startswith(("pt_lint_", "pm_")))
    summary = coverage_summary(rows)
    assert summary["differentiable"] > 50 and summary["tested"] is None
    table = format_audit(rows)
    assert "relu" in table and "infer_shape" in table
    here = os.path.dirname(os.path.abspath(__file__))
    tested = {r["op"]: r["tested"] for r in audit_registry(test_dir=here)}
    assert tested["relu"] is True and tested["lamb"] is True
    assert coverage_summary(audit_registry(test_dir=here))["tested"] > 80
    # the op types the reference registers and the port lacks: none
    # since the pipeline op (a program carrying one would be PT100 in the
    # port, never a crash)
    from test_torch_lod import builtin_ops

    lacking = sorted(builtin_ops(jreg, "paddle_tpu")
                     - builtin_ops(treg, "paddle_tpu_torch"))
    assert lacking == []
    assert tested["pipeline"] is True
