"""The PyTorch port's GEMM-epilogue fusion against the JAX package's, on
the CPU.

Each program of the JAX package's ``tests/test_epilogue_fusion.py`` is
built in both packages under the same ``unique_name.guard()``; the port's
``fuse_epilogues`` must give the same decision (applied, fused and refused
counts, chains), the same diagnostic codes and, where it applies, a fused
program whose ``to_dict()`` equals the JAX package's (int32 read as int64,
``op_callstack`` dropped). PT755 is the one code that may differ, and only
by design: the Hopper kernel masks ragged M and N edges and needs only
N, K % 4 where the TPU kernel needs whole (8, 128) tiles (``ROADMAP.md``
Queue C). Then the port alone: fused and unfused runs bit-exact on the
dense route, the plain-version route within ``WITNESS_TOLERANCES``, the
witness's refusals, the executor's cache and device plumbing, and BERT-tiny
inference fused like the JAX package's with the same loss (rtol 1e-4:
float32, different summation orders).
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis.epilogue_fusion import fuse_epilogues as j_fuse
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.initializer as tinit
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.analysis import epilogue_fusion as tef
from paddle_tpu_torch.analysis.epilogue_fusion import (WITNESS_TOLERANCES,
                                                       fuse_epilogues)
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.kernels.fused_gemm import DEFAULT_BLOCKS
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_build
from paddle_tpu_torch.ops.fused_gemm import (fused_gemm_route,
                                             resolve_gemm_blocks)

JAX = types.SimpleNamespace(fl=fluid, un=jun, init=fluid.initializer)
PORT = types.SimpleNamespace(fl=tfluid, un=tun, init=tinit)
FLAGS = ["FLAGS_epilogue_fusion", "FLAGS_use_fused_gemm",
         "FLAGS_fused_gemm_blocks"]


@pytest.fixture(autouse=True)
def _flag_reset():
    prev = tfluid.get_flags(FLAGS)
    yield
    tfluid.set_flags(prev)


def _fc(P, x, size, act=None):
    """fc with a truncated-normal weight: the port ships no Xavier, and
    the initializer does not reach the main program."""
    return P.fl.layers.fc(x, size, act=act, param_attr=P.fl.ParamAttr(
        initializer=P.init.TruncatedNormal(0.0, 0.02)))


def _guarded(P, build):
    with P.un.guard():
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup):
            fetch = build(P)
    return main, startup, fetch


def _x(P, width=128):
    return P.fl.layers.data("x", shape=[width], dtype="float32")


# -- the JAX package's test programs, one build function each -------------

def _mlp(act):
    def build(P):
        h = _fc(P, _x(P), 128, act)
        return [_fc(P, h, 128).name]
    return build


def _n100(P):
    good = _fc(P, _x(P), 128, "relu")
    return [_fc(P, good, 100).name]


def _chain_kinds(P):
    x = _x(P)
    r = P.fl.layers.elementwise_add(_fc(P, x, 128), x)
    ln = P.fl.layers.layer_norm(r, begin_norm_axis=1)
    return [_fc(P, ln, 128, "relu").name]


def _fetched_mid_chain(P):
    h = _fc(P, _x(P), 128, "gelu")
    mul_out = next(op.output("Out")[0] for op in
                   P.fl.default_main_program().global_block.ops
                   if op.type == "mul")
    return [h.name, mul_out]


def _multi_consumer(P):
    h = _fc(P, _x(P), 128)
    a, b = P.fl.layers.gelu(h), P.fl.layers.relu(h)
    return [P.fl.layers.elementwise_add(a, b).name]


def _backward(P):
    x = P.fl.layers.data("x", shape=[64], dtype="float32")
    loss = P.fl.layers.mean(_fc(P, x, 1))
    P.fl.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return [loss.name]


def _consumed_ln_stats(P):
    ln = P.fl.layers.layer_norm(_fc(P, _x(P), 128), begin_norm_axis=1)
    ln_op = next(op for op in P.fl.default_main_program().global_block.ops
                 if op.type == "layer_norm")
    return [ln.name, ln_op.output("Mean")[0]]


def _clobbered_input(P):
    x = _x(P)
    h = _fc(P, x, 128, "relu")
    P.fl.layers.increment(x, in_place=True)
    main = P.fl.default_main_program()
    gb = main.global_block
    gb.ops.insert(1, gb.ops.pop())      # [mul, increment, add, relu]
    main._bump_version()
    return [h.name]


def _clobbered_intermediate(P):
    h = _fc(P, _x(P), 128)
    main = P.fl.default_main_program()
    gb = main.global_block
    mul_idx, mul_out = next((i, op.output("Out")[0])
                            for i, op in enumerate(gb.ops)
                            if op.type == "mul")
    gb.append_op("fill_constant", outputs={"Out": [mul_out]},
                 attrs={"shape": [32, 128], "dtype": "float32",
                        "value": 0.0})
    gb.ops.insert(mul_idx + 1, gb.ops.pop())    # [mul, fill, add]
    main._bump_version()
    return [h.name]


def _residual_between(P):
    x = _x(P)
    h = _fc(P, x, 128)
    r = P.fl.layers.relu(x)
    return [P.fl.layers.elementwise_add(h, r).name]


def _alpha(alpha):
    def build(P):
        L = P.fl.layers
        a, b = (L.data(n, shape=[128, 128], dtype="float32",
                       append_batch_size=False) for n in ("a", "b"))
        c = L.data("c", shape=[128], dtype="float32",
                   append_batch_size=False)
        mm = L.matmul(a, b, alpha=alpha)
        return [L.relu(L.elementwise_add(mm, c)).name]
    return build


def _kind(kind):
    def build(P):
        x = _x(P)
        act = "relu" if "relu" in kind else "gelu" if "gelu" in kind \
            else None
        h = _fc(P, x, 128, act)
        if "residual" in kind:
            h = P.fl.layers.elementwise_add(h, x)
        if "layer_norm" in kind:
            h = P.fl.layers.layer_norm(h, begin_norm_axis=1)
        return [h.name]
    return build


KINDS = ["bias", "bias+relu", "bias+gelu", "bias+residual",
         "bias+residual+layer_norm"]

# name -> (build function, fuse_epilogues keyword args, PT755 only the JAX
# package reports, by design)
PROGRAMS = {
    "mlp_gelu": (_mlp("gelu"), {}, 0),
    "mlp_relu_fed": (_mlp("relu"), {"feed_names": ["x"]}, 0),
    # n = 100: not a multiple of the TPU's 128 lanes; the Hopper kernel
    # takes any N % 4 == 0
    "n100": (_n100, {}, 1),
    "chain_kinds": (_chain_kinds, {}, 0),
    "fetched_mid_chain": (_fetched_mid_chain, {}, 0),
    "multi_consumer": (_multi_consumer, {}, 0),
    "backward": (_backward, {}, 0),
    "consumed_ln_stats": (_consumed_ln_stats, {}, 0),
    "clobbered_input": (_clobbered_input, {}, 0),
    "clobbered_intermediate": (_clobbered_intermediate, {}, 0),
    "residual_between": (_residual_between, {}, 0),
    "alpha2": (_alpha(2.0), {}, 0),
    "alpha1": (_alpha(1.0), {}, 0),
    # m = 250: not whole 128-row TPU blocks; the Hopper kernel masks the
    # ragged edge
    "batch250": (_mlp("relu"), {"batch": 250}, 2),
    # no compiled instantiation in either package
    "blocks_k100": (_mlp("relu"), {"gemm_blocks": (128, 128, 100)}, 0),
}
PROGRAMS.update({f"kind_{k}": (_kind(k), {}, 0) for k in KINDS})


def _normalized(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _codes(diags, drop_pt755=0):
    codes = sorted(d.code for d in diags)
    for _ in range(drop_pt755):
        codes.remove("PT755")
    return codes


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fusion_decisions_match_jax(name):
    build, kw, jax_only_pt755 = PROGRAMS[name]
    jmain, _, jfetch = _guarded(JAX, build)
    tmain, _, tfetch = _guarded(PORT, build)
    assert tfetch == jfetch
    jd, td = [], []
    jdec = j_fuse(jmain, fetch_names=jfetch, diags=jd, **kw)
    tdec = fuse_epilogues(tmain, fetch_names=tfetch, diags=td, **kw)
    assert (tdec.applied, tdec.n_fused, tdec.n_refused, tdec.chains) == (
        jdec.applied, jdec.n_fused, jdec.n_refused, jdec.chains), tdec.reason
    assert _codes(td) == _codes(jd, jax_only_pt755), (
        [str(d) for d in td], [str(d) for d in jd])
    if jdec.applied:
        assert _normalized(tdec.program) == _normalized(jdec.program)
        assert tdec.program._serial != tmain._serial


# -- the port alone ----------------------------------------------------------

def _run(main, startup, fetch, feed, fused, scope=None):
    tfluid.set_flags({"FLAGS_epilogue_fusion": fused})
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = scope or tfluid.Scope()
    exe.run(startup, scope=scope)
    outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return outs[0], exe


def _ran(exe, program):
    """The programs the executor ran for ``program``, by fusion-cache
    key (the startup program has entries of its own)."""
    return {k: p for k, p in exe._fusion_cache.items()
            if k[0][0] == program._serial}


def _feed(batch=32, seed=0):
    return {"x": np.random.RandomState(seed).randn(batch, 128)
            .astype(np.float32)}


@pytest.mark.parametrize("name", ["mlp_gelu", "residual_between",
                                  "clobbered_input", "alpha2"]
                         + [f"kind_{k}" for k in KINDS])
def test_fused_run_is_bit_exact_on_the_dense_route(name):
    """Executor(CPUPlace()), fused against unfused from the same startup
    seed: the dense replay runs the original rules, so the bits agree;
    a refused program (clobbered input) runs untransformed."""
    build, _, _ = PROGRAMS[name]
    main, startup, fetch = _guarded(PORT, build)
    startup.random_seed = 7
    feed = _feed()
    if name == "alpha2":
        rng = np.random.RandomState(0)
        feed = {n: rng.randn(*s).astype(np.float32) for n, s in
                (("a", (128, 128)), ("b", (128, 128)), ("c", (128,)))}
    base, _ = _run(main, startup, fetch, feed, fused=False)
    fused, exe = _run(main, startup, fetch, feed, fused=True)
    assert np.array_equal(base, fused)
    (dec,) = exe._fusion_decisions.values()
    assert dec.applied == (name != "clobbered_input")
    (ran,) = _ran(exe, main).values()
    assert any(op.type == "fused_gemm_epilogue"
               for op in ran.global_block.ops) == dec.applied


def test_run_chained_fused_matches_plain():
    main, startup, fetch = _guarded(PORT, _mlp("relu"))

    def chained(fused):
        tfluid.set_flags({"FLAGS_epilogue_fusion": fused})
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        return exe.run_chained(main, feed=_feed(), fetch_list=fetch,
                               steps=3, scope=scope)[0]

    assert np.array_equal(chained(False), chained(True))


@pytest.mark.parametrize("kind", KINDS)
def test_always_runs_the_plain_version_within_witness_tolerance(kind):
    """FLAGS_use_fused_gemm=always on CPU tensors: the kernel's plain
    version, within the witness's float32 tolerance of the dense run, and
    no launch."""
    main, startup, fetch = _guarded(PORT, _kind(kind))
    base, _ = _run(main, startup, fetch, _feed(), fused=False)
    tfluid.set_flags({"FLAGS_use_fused_gemm": "always"})
    K.reset_launch_counts()
    fused, exe = _run(main, startup, fetch, _feed(), fused=True)
    (dec,) = exe._fusion_decisions.values()
    assert dec.applied and dec.witness[0]["route"] == "plain"
    rtol, atol = WITNESS_TOLERANCES["float32"]
    np.testing.assert_allclose(fused, base, rtol=rtol, atol=atol)
    assert K.fused_gemm.launches == 0


def test_always_raises_on_a_shape_the_kernel_does_not_take():
    tfluid.set_flags({"FLAGS_use_fused_gemm": "always"})
    with pytest.raises(ValueError, match="no kernel tiling"):
        fused_gemm_route(128, 2, 128, layer_norm=False,
                         blocks=DEFAULT_BLOCKS)
    route, reason = fused_gemm_route(128, 128, 128, layer_norm=False,
                                     blocks=DEFAULT_BLOCKS, alpha=2.0)
    assert route == "primitive" and "alpha" in reason
    tfluid.set_flags({"FLAGS_use_fused_gemm": "auto"})
    assert fused_gemm_route(128, 128, 128, layer_norm=False,
                            blocks=DEFAULT_BLOCKS)[0] == "primitive"
    assert fused_gemm_route(128, 128, 128, layer_norm=False,
                            blocks=DEFAULT_BLOCKS, on_cuda=True)[0] == "cuda"
    assert fused_gemm_route(128, 2, 128, layer_norm=False,
                            blocks=DEFAULT_BLOCKS, on_cuda=True)[0] == \
        "primitive"
    # any other triple has no compiled instantiation
    assert fused_gemm_route(128, 128, 128, layer_norm=False,
                            blocks=(128, 128, 16), on_cuda=True)[0] == \
        "primitive"


@pytest.mark.parametrize("raw,route", [("128,256,32", "cuda"),
                                       ("128x256x32", "cuda"),
                                       ("128,128,16", "primitive")])
def test_blocks_flag_takes_the_compiled_triple(raw, route):
    """FLAGS_fused_gemm_blocks names the triple K5 compiles, (128, 256, 32);
    any other sends the chain to the dense replay with that triple named
    in the reason."""
    tfluid.set_flags({"FLAGS_fused_gemm_blocks": raw})
    try:
        blocks = resolve_gemm_blocks()
        got, reason = fused_gemm_route(16384, 768, 768, layer_norm=False,
                                       blocks=blocks, on_cuda=True)
    finally:
        tfluid.set_flags({"FLAGS_fused_gemm_blocks": ""})
    assert got == route
    assert (blocks == DEFAULT_BLOCKS) == (route == "cuda")
    if route == "primitive":
        assert str(DEFAULT_BLOCKS) in reason


def test_witness_refuses_a_wrong_lowering(monkeypatch):
    from paddle_tpu_torch.core import registry

    opdef = registry.get_op_def("fused_gemm_epilogue")
    real = opdef.lower

    def wrong(ctx, ins, attrs):
        out = real(ctx, ins, attrs)
        out["Out"] = [v + 1.0 for v in out["Out"]]
        return out

    monkeypatch.setattr(opdef, "lower", wrong)
    main, _, fetch = _guarded(PORT, _mlp("gelu"))
    diags = []
    dec = fuse_epilogues(main, fetch_names=fetch, diags=diags)
    assert not dec.applied and "witness" in dec.reason
    assert [d.code for d in diags].count("PT754") == 1
    assert dec.program is main


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_a_kernel_fault_raises_through_the_witness(monkeypatch, tmp_path,
                                                   fault):
    """A K5 that does not build or launch raises out of Executor.run,
    twice: the witness does not refuse it with PT754, so no unfused
    program is cached in its place. The fused op's kernel route is forced
    on the CPU by a wrapper that goes straight to ``_build.launch`` on a
    CUDA device, where the nvcc call fails (build) or the entry point
    returns cudaErrorLaunchFailure (launch)."""
    import importlib

    from paddle_tpu_torch.kernels import _build

    # the module (the package re-exports its function under the same name)
    kfg = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "BUILD", str(tmp_path))
    if fault == "build":
        monkeypatch.setattr(_build, "_nvcc", lambda: "false")
        match = "nvcc failed for csrc/fused_gemm.cu"
    else:
        monkeypatch.setattr(_build, "_fns", {"fused_gemm": lambda *a: 719})
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: types.SimpleNamespace(
                                cuda_stream=0))
        match = "CUDA launch failed with cudaError_t 719"

    def kernel_route(x, y, **kw):
        _build.launch("fused_gemm", torch.device("cuda", 0))

    monkeypatch.setattr(kfg, "fused_gemm", kernel_route)
    tfluid.set_flags({"FLAGS_epilogue_fusion": True,
                      "FLAGS_use_fused_gemm": "always"})
    main, startup, fetch = _guarded(PORT, _mlp("gelu"))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        with pytest.raises(Exception) as err:
            exe.run(main, feed=_feed(), fetch_list=fetch, scope=scope)
        e = err.value
        while not isinstance(e, _build.KernelError):
            e = e.__cause__
        assert match in str(e)
    assert not _ran(exe, main) and not exe._fusion_decisions
    assert not tef._device_fault(ValueError("no kernel tiling"))


def test_fused_clone_has_its_own_serial_and_cache_entry():
    main, startup, fetch = _guarded(PORT, _mlp("gelu"))
    a, exe = _run(main, startup, fetch, _feed(), fused=True)
    (fp,) = _ran(exe, main).values()
    assert fp._serial != main._serial
    clone = main.clone()
    assert clone._serial not in (main._serial, fp._serial)
    # a new block triple re-witnesses under its own key
    tfluid.set_flags({"FLAGS_fused_gemm_blocks": "128,128,100"})
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=fetch, scope=scope)
    assert [k[2] for k in _ran(exe, main)] == [None, (128, 128, 100)]
    # and so does a new route mode: 'always' must witness the kernel
    # route the 'auto' decision never checked
    tfluid.set_flags({"FLAGS_fused_gemm_blocks": "",
                      "FLAGS_use_fused_gemm": "always"})
    exe.run(main, feed=_feed(), fetch_list=fetch, scope=scope)
    assert [k[2:] for k in _ran(exe, main)] == [
        (None, "auto"), ((128, 128, 100), "auto"), (None, "always")]
    assert [w["route"] for k, d in exe._fusion_decisions.items()
            if k[3] == "always" for w in d.witness] == ["plain", "plain"]


def test_witness_runs_on_the_executors_device(monkeypatch):
    """The executor hands its device to the pass; the witness runs its
    chains there (on the card: the kernel itself)."""
    seen = []
    real = tef._run_witness

    def spy(program, fused_program, chain, fused_op, device, **kw):
        seen.append(device)
        return real(program, fused_program, chain, fused_op, device, **kw)

    monkeypatch.setattr(tef, "_run_witness", spy)
    main, startup, fetch = _guarded(PORT, _mlp("relu"))
    _, exe = _run(main, startup, fetch, _feed(batch=24), fused=True)
    assert seen and all(d == exe.device for d in seen)
    (dec,) = exe._fusion_decisions.values()
    assert [w["m"] for w in dec.witness] == [24, 24]   # the feed's rows


def test_clone_for_test_prunes_training_ops_and_sets_is_test():
    with tun.guard():
        t = t_build(TBertConfig.tiny(), seq_len=16)
    main = t["main"]
    v0 = main._version
    infer = main.clone(for_test=True)
    assert main._version == v0
    roles = {op.attrs["__op_role__"] for op in infer.global_block.ops}
    assert roles == {"forward"}
    drops = [op for op in infer.global_block.ops if op.type == "dropout"]
    assert drops and all(op.attrs["is_test"] for op in drops)
    assert infer._serial != main._serial
    op = infer.global_block.ops[0]
    v = infer._version
    op.set_attr("is_test", True)
    assert infer._version == v + 1


def test_dropout_is_the_identity_in_test_mode():
    """is_test with upscale_in_train: Out is X itself, as the JAX
    package's rule returns it."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    xv = torch.randn(4, 8)
    out = registry.get_op_def("dropout").lower(
        LowerCtx("cpu", seed=1), {"X": [xv]},
        {"dropout_prob": 0.1, "is_test": True, "seed": 0, "fix_seed": False,
         "dropout_implementation": "upscale_in_train"})
    assert torch.equal(out["Out"][0], xv)


# -- BERT-tiny inference -----------------------------------------------------

SEQ, BATCH = 32, 8


def _bert_feed(seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(SEQ // 2, SEQ + 1, (BATCH, 1))
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


def test_bert_tiny_inference_fuses_like_jax_with_the_same_loss():
    """build_bert_pretrain(build_optimizer=False).clone(for_test=True) at
    seq 32, batch 8: both packages fuse the same 15 chains (12 bias, 2
    bias+gelu, 1 bias+gelu+layer_norm) with one PT755 (the NSP head,
    n = 2); the fused programs agree, and the port's fused run gives the
    JAX package's fused loss from the same weights (rtol 1e-4)."""
    with jun.guard():
        j = j_build(JBertConfig.tiny(), seq_len=SEQ, build_optimizer=False)
    with tun.guard():
        t = t_build(TBertConfig.tiny(), seq_len=SEQ, build_optimizer=False)
    jinf, tinf = j["main"].clone(for_test=True), t["main"].clone(for_test=True)
    assert _normalized(tinf) == _normalized(jinf)
    fetch = [t["loss"].name]
    jd, td = [], []
    jdec = j_fuse(jinf, fetch_names=fetch, diags=jd, batch=BATCH)
    tdec = fuse_epilogues(tinf, fetch_names=fetch, diags=td, batch=BATCH)
    kinds = sorted(c["epilogue"] for c in tdec.chains)
    assert kinds == sorted(["bias"] * 12 + ["bias+gelu"] * 2
                           + ["bias+gelu+layer_norm"])
    assert (tdec.applied, tdec.n_fused, tdec.n_refused, tdec.chains) == (
        jdec.applied, jdec.n_fused, jdec.n_refused, jdec.chains)
    assert _codes(td) == _codes(jd)
    assert [d.code for d in td].count("PT755") == 1
    assert _normalized(tdec.program) == _normalized(jdec.program)

    feed = _bert_feed()
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    state = {v.name: jscope.numpy(v.name)
             for v in j["startup"].global_block.vars.values()}
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    try:
        jloss = jexe.run(jinf, feed=feed, fetch_list=fetch, scope=jscope)[0]
    finally:
        fluid.set_flags({"FLAGS_epilogue_fusion": False})
    assert any(op.type == "fused_gemm_epilogue" for p in
               jexe._fusion_cache.values() for op in p.global_block.ops)
    tscope = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace(),
                              programs=[tinf])
    losses = {}
    for fused in (False, True):
        tfluid.set_flags({"FLAGS_epilogue_fusion": fused})
        exe = tfluid.Executor(tfluid.CPUPlace())
        losses[fused] = exe.run(tinf, feed=feed, fetch_list=fetch,
                                scope=tscope)[0]
    (dec,) = exe._fusion_decisions.values()
    assert dec.applied and dec.n_fused == 15
    assert np.array_equal(losses[True], losses[False])
    np.testing.assert_allclose(losses[True], np.asarray(jloss), rtol=1e-4)
