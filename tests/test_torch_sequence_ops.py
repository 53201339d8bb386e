"""The sequence ops of the port (``ops/sequence_ops.py``, every op type,
and the three of ``ops/misc2.py``) against the JAX package's, on the
CPU: each case is a single-op program built the same way in both
packages from numpy inputs made with a seed, run on the same feeds.
Lengths include 0, 1 and the full padded length. The outputs must agree
(f32: rtol 1e-5, atol 1e-6; ints exactly), and so must their build-time
shapes. Every differentiable case also pulls a random cotangent back
through ``gradients`` (``append_backward``) in both packages: the port's
generic grad (autograd over its rule) against ``jax.vjp``, at the same
tolerance.

``run_op_case`` is the harness ``test_torch_rnn_ops.py`` and
``test_torch_structured.py`` use too."""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.core import registry as treg

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
RTOL, ATOL = 1e-5, 1e-6

B, T, D = 4, 6, 3
LENS = np.array([0, 1, 6, 3], np.int32)     # empty, one step, full, part


def f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def ints(hi, *shape, seed=0, lo=0):
    return np.random.RandomState(seed).randint(lo, hi, shape) \
        .astype(np.int64)


def _diff_inputs(op_type, ins):
    """(slot, name) of every float32 input the op differentiates."""
    opdef = treg.get_op_def(op_type)
    out = []
    for slot, pairs in ins.items():
        spec = opdef.input_spec(slot)
        if spec is None or spec.no_grad:
            continue
        out += [(slot, n) for n, a in pairs if a.dtype == np.float32]
    return out


def _build(pkg, op_type, ins, outs, attrs, grad_outs):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            blk = main.global_block
            diff = {n for _, n in _diff_inputs(op_type, ins)}
            vars_ = {}
            for slot, pairs in ins.items():
                vars_[slot] = [blk.create_var(
                    name=n, shape=a.shape, dtype=str(a.dtype), is_data=True,
                    stop_gradient=n not in diff) for n, a in pairs]
            for names in outs.values():
                for n in names:
                    blk.create_var(name=n)
            blk.append_op(op_type, inputs=vars_,
                          outputs={s: list(v) for s, v in outs.items()},
                          attrs=dict(attrs))
            grads, cts = [], {}
            if grad_outs and diff:
                terms = []
                for n in grad_outs:
                    shape = blk.var(n).shape
                    ct = blk.create_var(name="ct_" + n, shape=shape,
                                        dtype="float32", is_data=True)
                    cts[ct.name] = shape
                    terms.append(fl.layers.reduce_sum(
                        fl.layers.elementwise_mul(blk.var(n), ct)))
                loss = terms[0] if len(terms) == 1 else fl.layers.sums(terms)
                dvars = [blk.var(n) for s, pairs in ins.items()
                         for n, _ in pairs if n in diff]
                grads = [g.name for g in fl.gradients([loss], dvars)]
    return main, grads, cts


def run_op_case(op_type, ins, outs, attrs=None, grad_outs=(), seed=0):
    """Build and run ``op_type`` in both packages; ``ins`` is {slot:
    [(var, array)]}, ``outs`` {slot: [var]}. With ``grad_outs`` (output
    vars) the float inputs' gradients of sum(out * cotangent) are fetched
    too. Returns {pkg: {name: array}} and the build-time output shapes
    {pkg: {name: shape}}."""
    attrs = attrs or {}
    feed = {n: a for pairs in ins.values() for n, a in pairs}
    fetch = [n for names in outs.values() for n in names]
    got, shapes = {}, {}
    cts = None
    for pkg, (fl, _) in PKGS.items():
        main, grads, ct_shapes = _build(pkg, op_type, ins, outs, attrs,
                                        grad_outs)
        if cts is None:
            rng = np.random.RandomState(seed + 1000)
            cts = {n: np.asarray(rng.randn(*s), np.float32)
                   for n, s in ct_shapes.items()}
        res = fl.Executor(fl.CPUPlace()).run(
            main, feed=dict(feed, **cts), fetch_list=fetch + grads,
            scope=fl.Scope())
        got[pkg] = dict(zip(fetch + [f"grad:{n}" for n in grads],
                            [np.asarray(r) for r in res]))
        shapes[pkg] = {n: main.global_block.var(n).shape for n in fetch}
    return got, shapes


def assert_case_matches(got, shapes, rtol=RTOL, atol=ATOL, skip=()):
    """Every fetched value of the port equals the JAX package's (floats
    within rtol/atol, ints exactly, int32 read as int64); the build-time
    shapes too. Returns the port's values."""
    j, t = got["jax"], got["torch"]
    assert set(j) == set(t)
    for n in j:
        if n in skip:
            continue
        a, b = t[n], j[n]
        assert a.shape == b.shape, (n, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            assert a.dtype == b.dtype, (n, a.dtype, b.dtype)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=n)
    assert shapes["torch"] == shapes["jax"]
    return t


def _lod(name="ln", lens=LENS):
    return [(name, lens)]


POOL_TYPES = ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST")
# integer-valued floats: MAX/MIN meet ties, whose gradient both packages
# split evenly between the tied elements
TIED = np.random.RandomState(5).randint(-2, 3, (B, T, D)).astype(np.float32)

# case id -> (op type, ins, outs, attrs, outputs to differentiate)
CASES = {}
for _t in POOL_TYPES:
    CASES[f"sequence_pool_{_t}"] = (
        "sequence_pool", {"X": [("x", f32(B, T, D))], "SeqLen": _lod()},
        {"Out": ["o"]}, {"pooltype": _t, "pad_value": 0.5}, ["o"])
for _t in ("MAX", "MIN"):
    CASES[f"sequence_pool_{_t}_ties"] = (
        "sequence_pool", {"X": [("x", TIED)], "SeqLen": _lod()},
        {"Out": ["o"]}, {"pooltype": _t, "pad_value": -1.0}, ["o"])
CASES.update({
    "sequence_softmax": (
        "sequence_softmax", {"X": [("x", f32(B, T, scale=3.0))],
                             "SeqLen": _lod()},
        {"Out": ["o"]}, {}, ["o"]),
    "sequence_softmax_3d": (
        "sequence_softmax", {"X": [("x", f32(B, T, 2))], "SeqLen": _lod()},
        {"Out": ["o"]}, {}, ["o"]),
    "sequence_reverse": (
        "sequence_reverse", {"X": [("x", f32(B, T, D))], "SeqLen": _lod()},
        {"Y": ["o"]}, {}, ["o"]),
    "sequence_expand": (
        "sequence_expand", {"X": [("x", f32(B, D))],
                            "Y": [("y", f32(B, T, 2, seed=1))],
                            "SeqLen": _lod()},
        {"Out": ["o"]}, {}, ["o"]),
    "sequence_concat": (
        "sequence_concat",
        {"X": [("a", f32(B, 5, D)), ("b", f32(B, 4, D, seed=1))],
         "SeqLen": [("la", np.array([0, 5, 2, 1], np.int32)),
                    ("lb", np.array([3, 0, 4, 1], np.int32))]},
        {"Out": ["o"], "OutLen": ["ol"]}, {}, ["o"]),
    "sequence_pad": (
        "sequence_pad", {"X": [("x", f32(B, T, D))], "SeqLen": _lod(),
                         "PadValue": [("pv", np.float32([0.25]))]},
        {"Out": ["o"], "Length": ["l"]}, {}, ["o"]),
    "sequence_pad_longer": (
        "sequence_pad", {"X": [("x", f32(B, T, D))], "SeqLen": _lod(),
                         "PadValue": [("pv", np.float32([-1.0]))]},
        {"Out": ["o"], "Length": ["l"]}, {"padded_length": 9}, ["o"]),
    "sequence_pad_shorter": (
        "sequence_pad", {"X": [("x", f32(B, T, D))],
                         "SeqLen": _lod(lens=np.array([0, 1, 4, 3],
                                                      np.int32)),
                         "PadValue": [("pv", np.float32([2.0]))]},
        {"Out": ["o"], "Length": ["l"]}, {"padded_length": 4}, ["o"]),
    "sequence_unpad": (
        "sequence_unpad", {"X": [("x", f32(B, T, D))],
                           "Length": [("l", LENS.astype(np.int64))]},
        {"Out": ["o"], "OutLen": ["ol"]}, {}, ["o"]),
    "sequence_slice": (
        "sequence_slice", {"X": [("x", f32(B, T, D))], "SeqLen": _lod(),
                           "Offset": [("off", np.array([[0], [0], [2], [1]],
                                                       np.int64))],
                           "Length": [("len", np.array([[0], [1], [3], [2]],
                                                       np.int64))]},
        {"Out": ["o"], "OutLen": ["ol"]}, {}, ["o"]),
    "sequence_erase": (
        "sequence_erase", {"X": [("x", ints(6, B, T))], "SeqLen": _lod()},
        {"Out": ["o"], "OutLen": ["ol"]}, {"tokens": [2, 5]}, []),
    "sequence_enumerate": (
        "sequence_enumerate", {"X": [("x", ints(9, B, T))],
                               "SeqLen": _lod()},
        {"Out": ["o"]}, {"win_size": 3, "pad_value": 7}, []),
    "sequence_conv": (
        "sequence_conv", {"X": [("x", f32(B, T, D))],
                          "Filter": [("w", f32(3 * D, 5, seed=1))],
                          "SeqLen": _lod()},
        {"Out": ["o"]}, {"contextLength": 3, "contextStart": -1}, ["o"]),
    "sequence_conv_wide": (
        "sequence_conv", {"X": [("x", f32(B, T, D))],
                          "Filter": [("w", f32(4 * D, 2, seed=1))],
                          "SeqLen": _lod()},
        {"Out": ["o"]}, {"contextLength": 4, "contextStart": -2}, ["o"]),
    "sequence_mask": (
        "sequence_mask", {"X": _lod("x")}, {"Y": ["o"]},
        {"maxlen": 7, "out_dtype": "float32"}, []),
    "sequence_mask_int64": (
        "sequence_mask", {"X": [("x", LENS.astype(np.int64))]},
        {"Y": ["o"]}, {"maxlen": 6, "out_dtype": "int64"}, []),
    "sequence_reshape": (
        "sequence_reshape", {"X": [("x", f32(B, T, 4))], "SeqLen": _lod()},
        {"Out": ["o"], "OutLen": ["ol"]}, {"new_dim": 2}, ["o"]),
    "sequence_expand_as": (
        "sequence_expand_as", {"X": [("x", f32(B, D))],
                               "Y": [("y", f32(B, T, 2, seed=1))],
                               "SeqLen": _lod()},
        {"Out": ["o"]}, {}, ["o"]),
    "sequence_scatter": (
        "sequence_scatter",
        # repeated ids accumulate; 12 lies past the 10 columns and clips
        {"X": [("x", f32(B, 10))],
         "Ids": [("ids", np.array([[1, 1, 2, 3, 4, 5], [9, 9, 9, 0, 0, 0],
                                   [0, 1, 1, 12, 5, 5], [3, 3, 3, 3, 3, 3]],
                                  np.int64))],
         "Updates": [("u", f32(B, T, seed=1))], "SeqLen": _lod()},
        {"Out": ["o"]}, {}, ["o"]),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_op_matches_jax(case):
    op_type, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op_type, ins, outs, attrs, grad_outs)
    t = assert_case_matches(got, shapes)
    if grad_outs:
        assert any(k.startswith("grad:") for k in t), case


def test_every_sequence_op_type_has_a_case():
    from paddle_tpu.core import registry as jreg

    types = {c[0] for c in CASES.values()}

    want = {n for n, d in jreg._OP_REGISTRY.items()
            if d.lower is not None and d.lower.__module__ ==
            "paddle_tpu.ops.sequence_ops"}
    want |= {"sequence_reshape", "sequence_expand_as", "sequence_scatter"}
    assert len(want) == 15 and types == want


def test_padding_is_zero_and_grads_vanish_there():
    """The padded encoding's contract: outputs are 0 past each length and
    the gradient of a padded input position is 0."""
    got, _ = run_op_case(*CASES["sequence_conv"][:4], grad_outs=["o"])
    t = got["torch"]
    past = np.arange(T)[None, :] >= LENS[:, None]
    assert (t["o"][past] == 0).all()
    assert (t["grad:x@GRAD"][past] == 0).all()


def test_max_pool_grad_splits_ties_evenly():
    """amax's gradient splits between tied maxima as jnp.max's does (a
    ``torch.max(dim)`` gradient would go to one index only)."""
    x = np.zeros((1, 4, 1), np.float32)
    x[0, [1, 3], 0] = 2.0
    got, shapes = run_op_case(
        "sequence_pool", {"X": [("x", x)],
                          "SeqLen": [("ln", np.array([4], np.int32))]},
        {"Out": ["o"]}, {"pooltype": "MAX"}, grad_outs=["o"])
    t = assert_case_matches(got, shapes)
    ct = np.random.RandomState(1000).randn(1, 1).astype(np.float32)
    np.testing.assert_allclose(t["grad:x@GRAD"][0, :, 0],
                               [0, ct[0, 0] / 2, 0, ct[0, 0] / 2],
                               rtol=RTOL, atol=ATOL)


def test_fully_padded_softmax_row_is_zero_not_nan():
    got, _ = run_op_case(*CASES["sequence_softmax"][:4], grad_outs=["o"])
    t = got["torch"]
    assert np.isfinite(t["o"]).all() and (t["o"][0] == 0).all()
    assert np.isfinite(t["grad:x@GRAD"]).all()
    np.testing.assert_allclose(t["o"][1:].sum(1), 1.0, rtol=1e-6)


def test_sequence_mask_without_maxlen_is_refused_as_in_jax():
    msgs = []
    for pkg, (fl, un) in PKGS.items():
        with un.guard():
            main = fl.Program()
            with fl.program_guard(main, fl.Program()):
                ln = fl.layers.data("ln", shape=[-1], dtype="int32")
                with pytest.raises(ValueError) as e:
                    fl.layers.sequence_mask(ln)
                msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "static maxlen" in msgs[0]
    # the op itself refuses too, with the JAX package's message
    from paddle_tpu.ops import sequence_ops as jops
    from paddle_tpu_torch.ops import sequence_ops as tops
    import torch
    with pytest.raises(ValueError) as et:
        tops._sequence_mask(None, {"X": [torch.tensor([1, 2])]},
                            {"maxlen": -1, "out_dtype": "float32"})
    with pytest.raises(ValueError) as ej:
        jops._sequence_mask(None, {"X": [np.array([1, 2])]},
                            {"maxlen": -1, "out_dtype": "float32"})
    assert str(et.value) == str(ej.value)
