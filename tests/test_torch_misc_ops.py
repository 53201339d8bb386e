"""The misc group of the op library in the port (``ops/misc.py``, every
op type of it) against the JAX package's rules, on the CPU.

Each case is a single-op program built the same way in both packages
from numpy inputs made with a seed (``test_torch_sequence_ops.run_op_case``):
the outputs and the gradients of a random cotangent pulled back through
``gradients`` agree within f32 rtol 1e-5, atol 1e-5, integer outputs
exactly, and so do the build-time shapes. The traps have cases of their
own: ``unique`` at n = 2000 with many repeats, negative values and a
single value (the port sorts; the reference builds an [n, n] matrix),
``hash`` bit for bit (uint32 arithmetic in int64), ``similarity_focus``
on ties, and the random ops ``random_crop`` and ``sampling_id``, whose
bits differ from ``jax.random``'s: checked by determinism, by content
and by distribution (chi-square).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import Program as TProgram

from test_torch_ops import MISC_OPS
from test_torch_sequence_ops import assert_case_matches, f32, ints, \
    run_op_case

RTOL, ATOL = 1e-5, 1e-5
# the generic grads of the products sum in another order than XLA's
PRODUCT_TOL = (1e-4, 1e-5)


def probs(*shape, seed=0):
    z = np.exp(f32(*shape, seed=seed))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def edges():
    """Two trees as (parent, child) id pairs, 0 padding: a root with three
    children, one with a child of its own; and a chain with an isolated
    node (its patch is empty below the root)."""
    a = [[1, 2], [1, 3], [1, 4], [3, 5], [0, 0]]
    b = [[1, 2], [2, 3], [3, 4], [0, 0], [0, 0]]
    return np.array([a, b], np.int64)


# case id -> (op type, ins, outs, attrs, outputs to differentiate)
CASES = {
    "fill": (
        "fill", {}, {"Out": ["o"]},
        {"value": [1.5, -2.0, 3.0, 0.25, 5.0, 6.0], "shape": [2, 3],
         "dtype": "float32"}, []),
    "fill_int64": (
        "fill", {}, {"Out": ["o"]},
        {"value": [3, -1, 7, 2], "shape": [4], "dtype": "int64"}, []),
    "fill_any_like": (
        "fill_any_like", {"X": [("x", f32(3, 4, seed=1))]}, {"Out": ["o"]},
        {"value": 3.5}, []),
    "fill_any_like_int": (
        "fill_any_like", {"X": [("x", f32(3, 4, seed=1))]}, {"Out": ["o"]},
        {"value": 7.0, "dtype": "int64"}, []),
    "fill_zeros_like2": (
        "fill_zeros_like2", {"X": [("x", f32(3, 4, seed=2))]},
        {"Out": ["o"]}, {}, []),
    "size": (
        "size", {"Input": [("x", f32(3, 4, 5, seed=3))]}, {"Out": ["o"]},
        {}, []),
    "is_empty": (
        "is_empty", {"X": [("x", f32(3, 4, seed=3))]}, {"Out": ["o"]}, {},
        []),
    "one_hot_v2": (
        "one_hot_v2", {"X": [("x", ints(7, 4, 3, seed=4, lo=-1))]},
        {"Out": ["o"]}, {"depth": 5}, []),
    "multiplex": (
        "multiplex", {"Ids": [("ids", ints(3, 6, 1, seed=5))],
                      "X": [(f"x{i}", f32(6, 5, seed=6 + i))
                            for i in range(3)]},
        {"Out": ["o"]}, {}, ["o"]),
    "strided_slice": (
        "strided_slice", {"Input": [("x", f32(5, 6, 7, seed=9))]},
        {"Out": ["o"]},
        {"axes": [0, 1, 2], "starts": [1, -1, 0], "ends": [5, 0, 7],
         "strides": [2, -2, 3]}, ["o"]),
    "strided_slice_decrease": (
        "strided_slice", {"Input": [("x", f32(5, 6, 7, seed=10))]},
        {"Out": ["o"]},
        {"axes": [0, 2], "starts": [2, -5], "ends": [3, 100],
         "strides": [1, 2], "decrease_axis": [0]}, ["o"]),
    "minus": (
        "minus", {"X": [("x", f32(4, 5, seed=12))],
                  "Y": [("y", f32(4, 5, seed=13))]}, {"Out": ["o"]}, {},
        ["o"]),
    "l1_norm": (
        "l1_norm", {"X": [("x", f32(4, 5, seed=14))]}, {"Out": ["o"]}, {},
        ["o"]),
    "norm": (
        "norm", {"X": [("x", f32(3, 4, 5, seed=15))]},
        {"Out": ["o"], "Norm": ["n"]}, {"axis": 1}, ["o"]),
    "norm_last": (
        "norm", {"X": [("x", f32(3, 4, 5, seed=16))]},
        {"Out": ["o"], "Norm": ["n"]}, {"axis": -1, "epsilon": 1e-6},
        ["o", "n"]),
    "squared_l2_distance": (
        "squared_l2_distance", {"X": [("x", f32(4, 3, seed=17))],
                                "Y": [("y", f32(4, 3, seed=18))]},
        {"sub_result": ["s"], "Out": ["o"]}, {}, ["o"]),
    "squared_l2_distance_bcast": (
        "squared_l2_distance", {"X": [("x", f32(4, 2, 3, seed=19))],
                                "Y": [("y", f32(1, 2, 3, seed=20))]},
        {"sub_result": ["s"], "Out": ["o"]}, {}, ["o", "s"]),
    "bilinear_tensor_product": (
        "bilinear_tensor_product",
        {"X": [("x", f32(4, 3, seed=21))], "Y": [("y", f32(4, 5, seed=22))],
         "Weight": [("w", f32(6, 3, 5, seed=23))],
         "Bias": [("b", f32(1, 6, seed=24))]},
        {"Out": ["o"]}, {}, ["o"]),
    "fsp": (
        "fsp", {"X": [("x", f32(2, 3, 4, 5, seed=25))],
                "Y": [("y", f32(2, 6, 4, 5, seed=26))]},
        {"Out": ["o"]}, {}, ["o"]),
    "modified_huber_loss": (
        "modified_huber_loss",
        {"X": [("x", f32(12, 1, seed=27, scale=1.5))],
         "Y": [("y", ints(2, 12, 1, seed=28).astype(np.float32))]},
        {"IntermediateVal": ["i"], "Out": ["o"]}, {}, ["o"]),
    "teacher_student_sigmoid_loss": (
        "teacher_student_sigmoid_loss",
        {"X": [("x", f32(8, 1, seed=29, scale=2.0))],
         "Label": [("l", np.array([[-2], [-1], [0.3], [0.0], [1.5], [1.0],
                                   [2.0], [-2]], np.float32))]},
        {"Y": ["o"]}, {}, ["o"]),
    "cross_entropy2": (
        "cross_entropy2",
        {"X": [("x", probs(6, 5, seed=30))],
         "Label": [("l", np.array([[0], [4], [-100], [2], [1], [3]],
                                  np.int64))]},
        {"Y": ["o"], "XShape": ["xs"], "MatchX": ["m"]}, {}, ["o"]),
    "cross_entropy2_3d": (
        "cross_entropy2",
        {"X": [("x", probs(2, 3, 5, seed=31))],
         "Label": [("l", ints(5, 2, 3, 1, seed=32))]},
        {"Y": ["o"], "XShape": ["xs"], "MatchX": ["m"]},
        {"ignore_index": 3}, ["o"]),
    "label_smooth": (
        "label_smooth", {"X": [("x", probs(4, 5, seed=33))]},
        {"Out": ["o"]}, {"epsilon": 0.1}, ["o"]),
    "label_smooth_prior": (
        "label_smooth", {"X": [("x", probs(2, 3, 5, seed=34))],
                         "PriorDist": [("p", probs(1, 5, seed=35))]},
        {"Out": ["o"]}, {"epsilon": 0.2}, ["o"]),
    "center_loss": (
        "center_loss",
        {"X": [("x", f32(6, 4, seed=36))],
         "Label": [("l", np.array([[0], [2], [0], [1], [2], [0]],
                                  np.int64))],
         "Centers": [("c", f32(3, 4, seed=37))],
         "CenterUpdateRate": [("r", np.array([0.5], np.float32))]},
        {"CentersOut": ["co"], "SampleCenterDiff": ["d"], "Loss": ["o"]},
        {"cluster_num": 3}, ["o", "co"]),
    "center_loss_no_update": (
        "center_loss",
        {"X": [("x", f32(6, 4, seed=38))],
         "Label": [("l", ints(3, 6, 1, seed=39))],
         "Centers": [("c", f32(3, 4, seed=40))],
         "CenterUpdateRate": [("r", np.array([0.5], np.float32))]},
        {"CentersOut": ["co"], "SampleCenterDiff": ["d"], "Loss": ["o"]},
        {"cluster_num": 3, "need_update": False}, ["o"]),
    "add_position_encoding": (
        "add_position_encoding", {"X": [("x", f32(2, 6, 8, seed=41))]},
        {"Out": ["o"]}, {"alpha": 0.7, "beta": 1.3}, ["o"]),
    "row_conv": (
        "row_conv", {"X": [("x", f32(2, 6, 3, seed=42))],
                     "Filter": [("w", f32(3, 3, seed=43))]},
        {"Out": ["o"]}, {}, ["o"]),
    "conv_shift": (
        "conv_shift", {"X": [("x", f32(3, 7, seed=44))],
                       "Y": [("y", f32(3, 3, seed=45))]},
        {"Out": ["o"]}, {}, ["o"]),
    "cvm": (
        "cvm", {"X": [("x", np.abs(f32(4, 6, seed=46)) * 5)],
                "CVM": [("c", np.abs(f32(4, 2, seed=47)))]},
        {"Y": ["o"]}, {"use_cvm": True}, ["o"]),
    "cvm_strip": (
        "cvm", {"X": [("x", f32(4, 6, seed=48))],
                "CVM": [("c", np.abs(f32(4, 2, seed=49)))]},
        {"Y": ["o"]}, {"use_cvm": False}, ["o"]),
    "data_norm": (
        "data_norm",
        {"X": [("x", f32(4, 5, seed=50))],
         "BatchSize": [("n", np.full(5, 1e4, np.float32))],
         "BatchSum": [("s", f32(5, seed=51, scale=100.0))],
         "BatchSquareSum": [("q", np.abs(f32(5, seed=52)) * 1e4 + 1e3)]},
        {"Y": ["o"], "Means": ["m"], "Scales": ["sc"]}, {}, ["o"]),
    "hash": (
        "hash", {"X": [("x", ints(1000, 5, 3, seed=53, lo=-1000))]},
        {"Out": ["o"]}, {"num_hash": 1, "mod_by": 1000}, []),
    "hash_wide": (
        "hash", {"X": [("x", ints(2 ** 31 - 1, 64, 1, seed=54,
                                  lo=-2 ** 31))]},
        {"Out": ["o"]}, {"num_hash": 1}, []),
    "unique": (
        "unique", {"X": [("x", ints(20, 50, seed=55, lo=-10))]},
        {"Out": ["o"], "Index": ["i"]}, {}, []),
    "unique_float": (
        "unique", {"X": [("x", np.round(f32(40, 1, seed=56), 1))]},
        {"Out": ["o"], "Index": ["i"]}, {"dtype": "int64"}, []),
    "unique_with_counts": (
        "unique_with_counts", {"X": [("x", ints(9, 30, seed=57, lo=-4))]},
        {"Out": ["o"], "Index": ["i"], "Count": ["c"]}, {}, []),
    "spectral_norm": (
        "spectral_norm",
        {"Weight": [("w", f32(6, 4, 3, seed=58))],
         "U": [("u", f32(6, seed=59))], "V": [("v", f32(12, seed=60))]},
        {"Out": ["o"]}, {"dim": 0, "power_iters": 2}, ["o"]),
    "spectral_norm_dim1": (
        "spectral_norm",
        {"Weight": [("w", f32(6, 4, 3, seed=61))],
         "U": [("u", f32(4, seed=62))], "V": [("v", f32(18, seed=63))]},
        {"Out": ["o"]}, {"dim": 1, "power_iters": 1}, ["o"]),
    "tree_conv": (
        "tree_conv",
        {"NodesVector": [("f", f32(2, 6, 3, seed=64))],
         "EdgeSet": [("e", edges())],
         "Filter": [("w", f32(3, 3, 2, 2, seed=65))]},
        {"Out": ["o"]}, {"max_depth": 2}, ["o"]),
    "tree_conv_deep": (
        "tree_conv",
        {"NodesVector": [("f", f32(2, 6, 3, seed=66))],
         "EdgeSet": [("e", edges())],
         "Filter": [("w", f32(3, 3, 2, 2, seed=67))]},
        {"Out": ["o"]}, {"max_depth": 3}, ["o"]),
    "similarity_focus_ties": (
        "similarity_focus",
        {"X": [("x", ints(3, 2, 3, 4, 5, seed=68).astype(np.float32))]},
        {"Out": ["o"]}, {"axis": 1, "indexes": [0, 2]}, []),
}
# ops that read a fed tensor on the host (a count or a bound that is a
# shape): the JAX package's jitted executor cannot, so the JAX side is its
# rule called eagerly on the arrays, as its own tests call it
EAGER_CASES = {
    "linspace": (
        "linspace", {"Start": [("a", np.array([0.5], np.float32))],
                     "Stop": [("b", np.array([3.0], np.float32))],
                     "Num": [("n", np.array([7], np.int32))]},
        {"Out": ["o"]}, {"dtype": "float32"}, ()),
    "linspace_int": (
        "linspace", {"Start": [("a", np.array([0.0], np.float32))],
                     "Stop": [("b", np.array([10.0], np.float32))],
                     "Num": [("n", np.array([11], np.int32))]},
        {"Out": ["o"]}, {"dtype": "int32"}, ()),
    "linspace_one": (
        "linspace", {"Start": [("a", np.array([2.0], np.float32))],
                     "Stop": [("b", np.array([5.0], np.float32))],
                     "Num": [("n", np.array([1], np.int32))]},
        {"Out": ["o"]}, {"dtype": "float32"}, ()),
    "strided_slice_tensors": (
        "strided_slice",
        {"Input": [("x", f32(5, 6, 7, seed=11))],
         "StartsTensor": [("st", np.array([4, 1], np.int32))],
         "EndsTensor": [("en", np.array([0, 6], np.int32))],
         "StridesTensor": [("sd", np.array([-1, 2], np.int32))]},
        {"Out": ["o"]}, {"axes": [0, 1]}, ()),
}
TOLS = {"bilinear_tensor_product": PRODUCT_TOL, "fsp": PRODUCT_TOL,
        "tree_conv": PRODUCT_TOL, "tree_conv_deep": PRODUCT_TOL,
        "spectral_norm": PRODUCT_TOL, "spectral_norm_dim1": PRODUCT_TOL}
# checked by the tests below
RANDOM = {"random_crop", "sampling_id"}


def test_every_op_type_of_the_group_has_cases():
    from paddle_tpu_torch.core import registry

    assert {c[0] for c in CASES.values()} | {
        c[0] for c in EAGER_CASES.values()} | RANDOM == MISC_OPS
    assert len(MISC_OPS) == 33 and MISC_OPS <= set(registry.all_ops())


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grad_match_jax(case):
    op, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op, ins, outs, attrs, grad_outs)
    assert_case_matches(got, shapes, *TOLS.get(case, (RTOL, ATOL)))
    if grad_outs:
        assert any(n.startswith("grad:") for n in got["torch"])


def run_eager_case(op, ins, outs, attrs):
    """The port's single-op program against the JAX rule called eagerly
    (``get_op_def(op).lower`` on concrete arrays): {pkg: {name: array}}."""
    import jax.numpy as jnp
    from paddle_tpu.core.registry import get_op_def
    from paddle_tpu.lowering import LowerCtx

    jres = get_op_def(op).lower(LowerCtx(), {
        slot: [jnp.asarray(a) for _, a in pairs]
        for slot, pairs in ins.items()}, dict(attrs))
    main = TProgram()
    blk = main.global_block
    feed = {}
    for pairs in ins.values():
        for n, a in pairs:
            blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                           is_data=True)
            feed[n] = a
    for names in outs.values():
        for n in names:
            blk.create_var(name=n)
    blk.append_op(op, inputs={s: [n for n, _ in p] for s, p in ins.items()},
                  outputs=outs, attrs=dict(attrs))
    fetch = [n for names in outs.values() for n in names]
    tres = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=tfluid.Scope())
    jvals = [np.asarray(v) for slot in outs for v in jres[slot]]
    return {"jax": dict(zip(fetch, jvals)),
            "torch": dict(zip(fetch, [np.asarray(v) for v in tres]))}


@pytest.mark.parametrize("case", sorted(EAGER_CASES))
def test_host_read_op_matches_the_eager_jax_rule(case):
    op, ins, outs, attrs, _ = EAGER_CASES[case]
    got = run_eager_case(op, ins, outs, attrs)
    shapes = {"jax": {}, "torch": {}}
    assert_case_matches(got, shapes)


@pytest.mark.parametrize("values", ["repeats", "negative", "single"])
def test_unique_at_2000_matches_jax_exactly(values):
    """n = 2000: Out (firsts in order of appearance, then the repeated
    elements in index order), Index and Count equal the reference's."""
    rng = np.random.RandomState(70)
    x = {"repeats": rng.randint(0, 37, 2000),
         "negative": rng.randint(-500, 500, 2000),
         "single": np.full(2000, -3)}[values].astype(np.int64)
    got, shapes = run_op_case(
        "unique_with_counts", {"X": [("x", x)]},
        {"Out": ["o"], "Index": ["i"], "Count": ["c"]})
    t = assert_case_matches(got, shapes)
    u = len(np.unique(x))
    assert t["c"][:u].sum() == 2000 and not t["c"][u:].any()


def _np_hash(x, num_hash, mod_by):
    """The reference's formula in numpy uint32, the seed of hash i taken
    mod 2**32."""
    flat = x.reshape(x.shape[0], -1).astype(np.int64).astype(np.uint32)
    outs = []
    for i in range(num_hash):
        h = np.full(flat.shape[0], (0x9E3779B9 + i * 0x85EBCA6B)
                    & 0xFFFFFFFF, np.uint32)
        for j in range(flat.shape[1]):
            h = (h ^ flat[:, j]) * np.uint32(16777619)
        outs.append(h % np.uint32(mod_by))
    return np.stack(outs, 1).astype(np.int64)[..., None]


def test_hash_of_several_seeds_is_the_formula_the_reference_raises_on():
    """num_hash 2: the JAX rule raises (its second seed overflows
    ``jnp.uint32``); the port takes the seed mod 2**32, and hash 0 stays
    the reference's."""
    x = ints(10 ** 6, 9, 2, seed=71, lo=-10 ** 6)
    with pytest.raises(Exception):
        run_op_case("hash", {"X": [("x", x)]}, {"Out": ["o"]},
                    {"num_hash": 2, "mod_by": 10007})
    main = TProgram()
    blk = main.global_block
    blk.create_var(name="x", shape=x.shape, dtype="int64", is_data=True)
    blk.create_var(name="o")
    blk.append_op("hash", inputs={"X": ["x"]}, outputs={"Out": ["o"]},
                  attrs={"num_hash": 2, "mod_by": 10007})
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=["o"], scope=tfluid.Scope())[0]
    np.testing.assert_array_equal(got, _np_hash(x, 2, 10007))
    one = run_op_case("hash", {"X": [("x", x)]}, {"Out": ["o"]},
                      {"num_hash": 1, "mod_by": 10007})[0]
    np.testing.assert_array_equal(got[:, :1], one["jax"]["o"])


def _run_random(op, x, attrs, seed=0, fetch=("o",), extra_outs=None):
    main = TProgram()
    main.random_seed = seed
    blk = main.global_block
    blk.create_var(name="x", shape=x.shape, dtype=str(x.dtype),
                   is_data=True)
    outs = {"Out": ["o"]}
    outs.update(extra_outs or {})
    for names in outs.values():
        for n in names:
            blk.create_var(name=n)
    blk.append_op(op, inputs={"X": ["x"]}, outputs=outs, attrs=attrs)
    return tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=list(fetch), scope=tfluid.Scope())


def _chi2_ok(counts, probs, level=1e-4):
    """Pearson's chi-square of ``counts`` against ``probs`` does not
    reject at ``level``."""
    from scipy import stats

    probs = np.asarray(probs, np.float64)
    exp = probs / probs.sum() * counts.sum()
    return stats.chisquare(counts, exp).pvalue > level


def test_random_crop_content_determinism_and_uniform_offsets():
    x = f32(2, 3, 9, 8, seed=72)
    a = _run_random("random_crop", x, {"shape": [5, 4], "startup_seed": 7},
                    extra_outs={"SeedOut": ["s"]})[0]
    b = _run_random("random_crop", x, {"shape": [5, 4], "startup_seed": 7},
                    extra_outs={"SeedOut": ["s"]})[0]
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 3, 5, 4)
    # the crop is X at one offset
    hits = [(i, j) for i in range(5) for j in range(5)
            if np.array_equal(x[:, :, i:i + 5, j:j + 4], a)]
    assert len(hits) == 1
    # offsets uniform over 0..limit in each dim: 4000 draws, 5 x 5 cells
    from paddle_tpu_torch.lowering import LowerCtx
    from paddle_tpu_torch.ops.misc import _random_crop

    xt = torch.arange(9 * 8, dtype=torch.float32).reshape(1, 9, 8)
    counts = np.zeros((5, 5))
    for uid in range(4000):
        ctx = LowerCtx("cpu", seed=3, uid=uid)
        res = _random_crop(ctx, {"X": [xt]}, {"shape": [5, 4]})["Out"][0]
        off = int(res[0, 0, 0])
        counts[off // 8, off % 8] += 1
    assert _chi2_ok(counts.reshape(-1), np.full(25, 1 / 25))
    # the program's seed picks the offsets when startup_seed is 0
    c = [_run_random("random_crop", x, {"shape": [5, 4]}, seed=s,
                     extra_outs={"SeedOut": ["s"]})[0] for s in (1, 1, 2)]
    np.testing.assert_array_equal(c[0], c[1])


def test_sampling_id_follows_the_rows_probabilities():
    p = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.0, 0.2, 0.1],
                  [0.0, 0.0, 1.0, 0.0]], np.float32)
    x = np.repeat(p, 4000, axis=0)
    a = _run_random("sampling_id", x, {"seed": 5})[0]
    b = _run_random("sampling_id", x, {"seed": 5})[0]
    c = _run_random("sampling_id", x, {"seed": 6})[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (12000,) and a.dtype == np.int64
    for r in range(3):
        counts = np.bincount(a[r * 4000:(r + 1) * 4000], minlength=4)
        live = p[r] > 0
        assert not counts[~live].any()
        if live.sum() > 1:
            assert _chi2_ok(counts[live], p[r][live])
