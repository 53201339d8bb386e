"""Gradient clipping and ``calc_gradient`` in the PyTorch port against the
JAX package, on the CPU.

* The four op types ``clip.py`` appends (``clip``, ``clip_by_norm``,
  ``squared_l2_norm``, ``sqrt``): forward and gradient through
  ``calc_gradient`` in both packages on the same inputs, f32 rtol 1e-5 /
  atol 1e-6; ``clip`` also against numpy (the cases of
  ``tests/test_ops_math.py::test_clip``).
* ``set_gradient_clip(GradientClipByGlobalNorm(1e-3))`` bounds an SGD
  update by lr * clip_norm (``tests/test_framework_misc.py``).
* BERT-tiny (dropout 0) with each of the three clip classes, plain, under
  AMP and under ``FLAGS_auto_recompute``: the program's ``to_dict()``
  equals the JAX package's (int32 read as int64, the call site dropped),
  the remat rebuild keeps the clip ops in both packages, and three Adam
  losses from the JAX package's initial scope are within the BERT tests'
  rtol (f32 1e-4, bf16 1e-3).
* ``calc_gradient`` with and without ``target_gradients`` equals the JAX
  package's program and values; a callable grad maker's descs are
  appended as they come.

The port's clip is process-global: the autouse fixture resets
``paddle_tpu_torch.clip._clip_attr["__global__"]`` around every test (and
the JAX package's, which ``tests/conftest.py`` resets as well)."""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import clip as jclip
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_bert

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_bert

RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = {False: 1e-4, True: 1e-3}
SEQ = 32
PKGS = {"jax": (jfluid, jun, jclip), "torch": (tfluid, tun, tclip)}


@pytest.fixture(autouse=True)
def _reset():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    snaps = [(m, dict(m._overrides)) for m in (jflags, tflags)]
    tclip._clip_attr["__global__"] = None
    jclip._clip_attr["__global__"] = None
    yield
    tclip._clip_attr["__global__"] = None
    jclip._clip_attr["__global__"] = None
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


def _exe(fl):
    return fl.Executor(fl.CPUPlace()), fl.Scope()


# ---------------------------------------------------------------------------
# the four ops
# ---------------------------------------------------------------------------

def _x(shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


OP_CASES = {
    "clip": ("clip", {"min": -1.0, "max": 1.0}, _x((4, 6))),
    "clip_by_norm_scales": ("clip_by_norm", {"max_norm": 1.0}, _x((4, 6))),
    "clip_by_norm_passes": ("clip_by_norm", {"max_norm": 100.0},
                            _x((4, 6))),
    "squared_l2_norm": ("squared_l2_norm", {}, _x((3, 5))),
    "sqrt": ("sqrt", {}, _x((3, 5), 0.5, 3.0)),
}


def _op_program(pkg, op_type, attrs, shape):
    fl, un, _ = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=list(shape[1:]), dtype="float32")
            x.stop_gradient = False
            blk = main.global_block
            out = blk.create_var(name="out", dtype="float32")
            blk.append_op(op_type, inputs={"X": x}, outputs={"Out": out},
                          attrs=dict(attrs))
            # a non-uniform cotangent: d/dx of sum(out * w)
            w = fl.layers.fill_constant(shape=[1], dtype="float32",
                                        value=0.75)
            loss = fl.layers.mean(fl.layers.elementwise_mul(out, w))
            (gx,) = fl.gradients([loss], [x])
    return main, out, gx


# numpy op parity: in case the kinks of clip are hit the rounding differs
# between packages; the inputs stay 0.05 away from them
def _away_from_kinks(x):
    x = x.copy()
    x[np.abs(np.abs(x) - 1.0) < 0.05] = 0.0
    return x


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_clip_ops_and_grads_match_jax(case):
    op_type, attrs, xv = OP_CASES[case]
    xv = _away_from_kinks(xv)
    got = {}
    for pkg in PKGS:
        fl = PKGS[pkg][0]
        main, out, gx = _op_program(pkg, op_type, attrs, xv.shape)
        exe, scope = _exe(fl)
        got[pkg] = [np.asarray(a) for a in exe.run(
            main, feed={"x": xv}, fetch_list=[out.name, gx.name],
            scope=scope)]
        got[pkg + "_dict"] = _norm(main)
    assert got["torch_dict"] == got["jax_dict"]
    for a, b in zip(got["torch"], got["jax"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_clip_matches_numpy_and_its_grad_masks():
    xv = _away_from_kinks(_x((4, 6)))
    main, out, gx = _op_program("torch", "clip", {"min": -1.0, "max": 1.0},
                                xv.shape)
    exe, scope = _exe(tfluid)
    o, g = exe.run(main, feed={"x": xv}, fetch_list=[out.name, gx.name],
                   scope=scope)
    np.testing.assert_array_equal(o, np.clip(xv, -1, 1))
    want = np.where(np.abs(xv) < 1, 0.75 / xv.size, 0.0).astype(np.float32)
    np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-9)


def test_layers_build_the_reference_ops():
    dicts = {}
    for pkg in PKGS:
        fl, un, _ = PKGS[pkg]
        with un.guard():
            main, startup = fl.Program(), fl.Program()
            with fl.program_guard(main, startup):
                x = fl.layers.data("x", shape=[4], dtype="float32")
                a = fl.layers.clip(x, -0.5, 0.5)
                b = fl.layers.clip_by_norm(a, max_norm=2.0)
                fl.layers.sqrt(b)
        dicts[pkg] = _norm(main)
    assert dicts["torch"] == dicts["jax"]


def test_gradient_clip_global_norm_bounds_the_update():
    for pkg in PKGS:
        fl, un, clip_mod = PKGS[pkg]
        with un.guard():
            main, startup = fl.Program(), fl.Program()
            with fl.program_guard(main, startup):
                x = fl.layers.data("x", shape=[4], dtype="float32")
                pred = fl.layers.fc(x, 1, param_attr=fl.ParamAttr(name="w"),
                                    bias_attr=False)
                loss = fl.layers.mean(pred)
                clip_mod.set_gradient_clip(
                    clip_mod.GradientClipByGlobalNorm(1e-3))
                try:
                    fl.optimizer.SGD(1.0).minimize(loss)
                finally:
                    clip_mod.set_gradient_clip(None)
        exe, scope = _exe(fl)
        exe.run(startup, scope=scope)
        w0 = np.array(scope.find_var("w"))
        exe.run(main, feed={"x": np.full((2, 4), 100.0, np.float32)},
                fetch_list=[loss], scope=scope)
        w1 = np.array(scope.find_var("w"))
        # update magnitude bounded by lr * clip_norm
        assert np.abs(w1 - w0).max() <= 1e-3 + 1e-7, pkg


# ---------------------------------------------------------------------------
# BERT-tiny under each clip: plain, AMP, remat
# ---------------------------------------------------------------------------

CLIPS = {
    "global_norm": lambda m: m.GradientClipByGlobalNorm(0.5),
    "norm": lambda m: m.GradientClipByNorm(0.05),
    "value": lambda m: m.GradientClipByValue(0.01),
}


def _bert_feed(batch=4):
    rng = np.random.RandomState(0)
    lens = np.array([[32], [28], [20], [32]])[:batch]
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


def _bert(pkg, clip_name, amp):
    fl, un, clip_mod = PKGS[pkg]
    cfg_cls, build = (JBertConfig, j_bert) if pkg == "jax" else \
        (TBertConfig, t_bert)
    cfg = dataclasses.replace(cfg_cls.tiny(), hidden_dropout=0.0,
                              attention_dropout=0.0)
    clip_mod.set_gradient_clip(CLIPS[clip_name](clip_mod))
    try:
        with un.guard():
            return build(cfg, seq_len=SEQ, amp=amp)
    finally:
        clip_mod.set_gradient_clip(None)


CLIP_OPS = {"global_norm": "squared_l2_norm", "norm": "clip_by_norm",
            "value": "clip"}


@pytest.mark.parametrize("mode", ["plain", "amp", "remat"])
@pytest.mark.parametrize("clip_name", sorted(CLIPS))
def test_bert_tiny_clip_matches_jax(clip_name, mode):
    amp = mode == "amp"
    j, t = _bert("jax", clip_name, amp), _bert("torch", clip_name, amp)
    assert _norm(t["main"]) == _norm(j["main"])
    types = [op.type for b in t["main"].blocks for op in b.ops]
    assert CLIP_OPS[clip_name] in types
    remat = mode == "remat"
    jfluid.set_flags({"FLAGS_auto_recompute": remat})
    tfluid.set_flags({"FLAGS_auto_recompute": remat})
    jexe, jscope = _exe(jfluid)
    jexe.run(j["startup"], scope=jscope)
    names = [v.name for v in j["startup"].global_block.vars.values()]
    state = {n: jscope.numpy(n) for n in names}
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace(),
                              programs=[t["main"]])
    feed = _bert_feed()
    for step in range(3):
        jl = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"]],
                      scope=jscope)
        tl = texe.run(t["main"], feed=feed, fetch_list=[t["loss"]],
                      scope=tscope)
        np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL[amp],
                                   err_msg=f"step {step}")
    if remat:
        jran = next(p for k, p in jexe._remat_cache.items()
                    if k[0][0] == j["main"]._serial)
        tran = next(p for k, p in texe._remat_cache.items()
                    if k[0][0] == t["main"]._serial)
        assert tran is not t["main"]
        for ran in (jran, tran):
            ops = [op.type for b in ran.blocks for op in b.ops]
            assert "recompute_segment" in ops
            assert ops.count(CLIP_OPS[clip_name]) == \
                types.count(CLIP_OPS[clip_name])
        assert [op.type for op in tran.global_block.ops] == \
            [op.type for op in jran.global_block.ops]


# ---------------------------------------------------------------------------
# calc_gradient
# ---------------------------------------------------------------------------

def _calc_program(pkg, seeded):
    fl, un, _ = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[3], dtype="float32")
            x.stop_gradient = False
            h = fl.layers.fc(x, 4, act="relu")
            y = fl.layers.scale(h, scale=3.0)
            z = fl.layers.data("z", shape=[2], dtype="float32")
            z.stop_gradient = False
            # an unseeded target gets fill_constant(1.0), which needs a
            # static shape: the mean; a seeded one takes the batch's
            tg = None
            if seeded:
                tg = fl.layers.data("tg", shape=[4], dtype="float32")
            else:
                y = fl.layers.mean(y)
            gx, gz = fl.calc_gradient([y], [x, z], target_gradients=tg)
    return main, startup, gx, gz


@pytest.mark.parametrize("seeded", [False, True],
                         ids=["ones", "target_gradients"])
def test_calc_gradient_matches_jax(seeded):
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(5, 3).astype(np.float32),
            "z": rng.randn(5, 2).astype(np.float32)}
    if seeded:
        feed["tg"] = rng.randn(5, 4).astype(np.float32)
    progs = {p: _calc_program(p, seeded) for p in PKGS}
    assert _norm(progs["torch"][0]) == _norm(progs["jax"][0])
    # z reaches no target: no gradient in either package
    assert progs["torch"][3] is None and progs["jax"][3] is None
    jmain, jstart, jgx, _ = progs["jax"]
    jexe, jscope = _exe(jfluid)
    jexe.run(jstart, scope=jscope)
    state = {n: jscope.numpy(n) for n in jstart.global_block.vars}
    want = jexe.run(jmain, feed=feed, fetch_list=[jgx.name],
                    scope=jscope)[0]
    tmain, _, tgx, _ = progs["torch"]
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = scope_from_numpy(state, tfluid.Scope(), tfluid.CPUPlace())
    got = texe.run(tmain, feed=feed, fetch_list=[tgx.name], scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    types = [op.type for op in tmain.global_block.ops]
    assert ("assign" in types, "fill_constant" in types) == \
        (seeded, not seeded)


def test_callable_grad_maker_descs_are_appended(monkeypatch):
    """An op whose ``grad`` is a callable maker: its descs are appended
    in order (the generic grad plus whatever the maker adds)."""
    from paddle_tpu_torch.backward import _make_grad_op

    opdef = tregistry.get_op_def("scale")
    calls = []

    def maker(op, block, out_grad, in_grad):
        calls.append(op.type)
        desc = _make_grad_op(op, out_grad, in_grad)
        (gname,) = in_grad["X@GRAD"]
        return [desc, {"type": "scale", "inputs": {"X": [gname]},
                       "outputs": {"Out": [gname]},
                       "attrs": {"scale": 2.0, "bias": 0.0,
                                 "bias_after_scale": True}}]

    monkeypatch.setattr(opdef, "grad", maker)
    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[3], dtype="float32")
            x.stop_gradient = False
            y = tfluid.layers.scale(x, scale=3.0)
            (gx,) = tfluid.gradients(tfluid.layers.mean(y), x)
    assert calls == ["scale"]
    types = [op.type for op in main.global_block.ops]
    assert types[-2:] == ["scale_grad", "scale"]
    exe, scope = _exe(tfluid)
    g = exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[gx.name], scope=scope)[0]
    np.testing.assert_allclose(g, np.full((2, 3), 2 * 3.0 / 6, np.float32),
                               rtol=1e-6)
