"""The six op types of ``ops/misc2.py`` this slice ports (the deformable
convolution, the position-sensitive, precise and deformable RoI
poolings, sampled softmax and ``py_func``) and their layers, against the
JAX package's, on the CPU.

* ``deformable_conv`` (v1 and v2, groups and deformable groups over 1,
  stride, padding, dilation), ``psroi_pool``, ``prroi_pool`` (by
  ``BatchRoINums``, a short count included, and by ``RoisBatchIdx``) and
  ``deformable_psroi_pooling`` (with and without Trans): outputs and the
  gradients of a random cotangent within f32 rtol 1e-5, atol 1e-5
  (``test_torch_sequence_ops.run_op_case``); the samplers' gathers sum in
  another order than XLA's, the convolution's contraction too
  (``CONV_TOL``).
* ``sampled_softmax_with_cross_entropy`` draws from the port's own
  generator, so its samples are not the JAX package's: Loss,
  Probabilities and the Logits gradient equal the reference's formula
  evaluated in float64 numpy on the port's own Samples (accidental hits
  masked); the negatives pass a chi-square test against the log-uniform
  law; a non-zero ``seed`` repeats them.
* ``py_func`` runs a callback with several inputs and outputs; a result
  of another dtype or shape than the op declares raises (the JAX
  package's ``pure_callback`` casts a wider float silently).
* every layer builds the JAX package's ``to_dict()``; the refusals raise
  as in the JAX package.
"""
import math

import numpy as np
import pytest

import paddle_tpu_torch as tfluid

from test_torch_lod import PKGS, build_both, carried_scopes, normalized
from test_torch_sequence_ops import assert_case_matches, f32, run_op_case

RTOL, ATOL = 1e-5, 1e-5
CONV_TOL = (1e-4, 1e-5)


def rois(n, seed, h, w, stride=1.0):
    rng = np.random.RandomState(seed)
    x0 = rng.rand(n) * (w - 2)
    y0 = rng.rand(n) * (h - 2)
    x1 = x0 + rng.rand(n) * w * 0.7 + 1.0
    y1 = y0 + rng.rand(n) * h * 0.7 + 1.0
    return (np.stack([x0, y0, x1, y1], 1) * stride).astype(np.float32)


def dcn_case(mask=True, groups=1, dg=1, stride=1, pad=1, dil=1):
    b, c, h, w, o, k = 2, 4, 7, 6, 4, 3
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    ins = {"Input": [("x", f32(b, c, h, w, seed=1))],
           "Offset": [("off", f32(b, 2 * dg * k * k, ho, wo, seed=2,
                                  scale=1.5))],
           "Filter": [("f", f32(o, c // groups, k, k, seed=3))]}
    if mask:
        ins["Mask"] = [("m", np.random.RandomState(4).rand(
            b, dg * k * k, ho, wo).astype(np.float32))]
    return ("deformable_conv", ins, {"Output": ["y"]},
            {"strides": [stride, stride], "paddings": [pad, pad],
             "dilations": [dil, dil], "groups": groups,
             "deformable_groups": dg}, ["y"])


def dpsroi_case(no_trans=False):
    od, g, p = 2, 3, 3
    ins = {"Input": [("x", f32(2, od * g * g, 9, 10, seed=5))],
           "ROIs": [("r", rois(5, 6, 9, 10, stride=2.0))],
           "Trans": [("t", f32(5, 2, p, p, seed=7))],
           "RoisBatchIdx": [("bi", np.array([1, 0, 1, 0, 0], np.int32))]}
    return ("deformable_psroi_pooling", ins,
            {"Output": ["o"], "TopCount": ["c"]},
            {"no_trans": no_trans, "spatial_scale": 0.5, "output_dim": od,
             "group_size": [g, g], "pooled_height": 3, "pooled_width": 3,
             "part_size": [p, p], "sample_per_part": 2, "trans_std": 0.2},
            ["o"])


CASES = {
    "deformable_conv_v2": dcn_case(),
    "deformable_conv_v1": dcn_case(mask=False),
    "deformable_conv_groups": dcn_case(groups=2, dg=2),
    "deformable_conv_stride_dilation": dcn_case(dg=2, stride=2, pad=2,
                                                dil=2),
    "psroi_pool": (
        "psroi_pool", {"X": [("x", f32(2, 2 * 3 * 3, 8, 9, seed=8))],
                       "ROIs": [("r", rois(6, 9, 8, 9, stride=4.0))],
                       "RoisBatchIdx": [("bi", np.array(
                           [0, 1, 1, 0, 1, 0], np.int32))]},
        {"Out": ["o"]}, {"output_channels": 2, "spatial_scale": 0.25,
                         "pooled_height": 3, "pooled_width": 3}, []),
    "prroi_pool_nums": (
        "prroi_pool", {"X": [("x", f32(2, 3, 8, 9, seed=10))],
                       "ROIs": [("r", rois(5, 11, 8, 9, stride=2.0))],
                       "BatchRoINums": [("n", np.array([2, 3], np.int32))]},
        {"Out": ["o"]}, {"spatial_scale": 0.5, "pooled_height": 2,
                         "pooled_width": 3, "sample_num": 3}, ["o"]),
    # counts summing under R: the last RoIs go to the last image
    "prroi_pool_short_nums": (
        "prroi_pool", {"X": [("x", f32(3, 2, 6, 7, seed=12))],
                       "ROIs": [("r", rois(6, 13, 6, 7))],
                       "BatchRoINums": [("n", np.array([0, 2, 1],
                                                       np.int32))]},
        {"Out": ["o"]}, {"pooled_height": 2, "pooled_width": 2}, ["o"]),
    "prroi_pool_idx": (
        "prroi_pool", {"X": [("x", f32(2, 3, 8, 9, seed=14))],
                       "ROIs": [("r", rois(4, 15, 8, 9))],
                       "RoisBatchIdx": [("bi", np.array([1, 1, 0, 1],
                                                        np.int32))]},
        {"Out": ["o"]}, {"pooled_height": 3, "pooled_width": 2}, ["o"]),
    "deformable_psroi_pooling": dpsroi_case(),
    "deformable_psroi_pooling_no_trans": dpsroi_case(no_trans=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_misc2_tail_op_matches_jax(case):
    op_type, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op_type, ins, outs, attrs, grad_outs)
    tol = CONV_TOL if op_type == "deformable_conv" else (RTOL, ATOL)
    assert_case_matches(got, shapes, *tol)


def rule_module_types(registry, module):
    """The op types of ``registry`` whose rule is defined in ``module``.
    Another test file on the same worker may leave a type with no rule at
    all (``lower`` None) in the process-wide registry: it is none of
    them."""
    return {t for t in registry.all_ops()
            if getattr(registry.get_op_def(t).lower, "__module__", "")
            == module}


def test_every_misc2_op_type_is_ported():
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    mod = rule_module_types(jreg, "paddle_tpu.ops.misc2")
    port = rule_module_types(treg, "paddle_tpu_torch.ops.misc2")
    assert mod == port and len(port) == 11
    assert {c[0] for c in CASES.values()} | {
        "sampled_softmax_with_cross_entropy", "py_func"} == port - {
        "sequence_reshape", "sequence_expand_as", "sequence_scatter",
        "merge_selected_rows", "get_tensor_from_selected_rows"}


# ------------------------------------------------------ sampled softmax
B, CLS, NS = 64, 500, 40


def sampled_program(seed, remove=True):
    with tfluid.unique_name.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            blk = main.global_block
            lg = blk.create_var(name="lg", shape=(B, CLS), dtype="float32",
                                is_data=True, stop_gradient=False)
            lb = blk.create_var(name="lb", shape=(B, 1), dtype="int64",
                                is_data=True)
            ct = blk.create_var(name="ct", shape=(B, 1), dtype="float32",
                                is_data=True)
            for n in ("smp", "prob", "loss"):
                blk.create_var(name=n)
            blk.append_op("sampled_softmax_with_cross_entropy",
                          inputs={"Logits": [lg], "Label": [lb]},
                          outputs={"Samples": ["smp"],
                                   "Probabilities": ["prob"],
                                   "Loss": ["loss"]},
                          attrs={"num_samples": NS, "seed": seed,
                                 "remove_accidental_hits": remove})
            loss = tfluid.layers.reduce_sum(tfluid.layers.elementwise_mul(
                blk.var("loss"), ct))
            (g,) = tfluid.gradients([loss], [lg])
    return main, g.name


def sampled_feed(seed=0):
    rng = np.random.RandomState(seed)
    # labels among the frequent classes, so accidental hits happen
    return {"lg": (rng.randn(B, CLS) * 2).astype(np.float32),
            "lb": rng.randint(0, 6, (B, 1)).astype(np.int64),
            "ct": rng.randn(B, 1).astype(np.float32)}


def run_sampled(seed, feed, remove=True):
    main, g = sampled_program(seed, remove)
    return tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=["smp", "prob", "loss", g],
        scope=tfluid.Scope())


def sampled_formula(logits, samples, label, ct, remove=True):
    """The reference's expressions on given samples: (loss,
    probabilities, the Logits gradient of sum(loss * ct)). The sampling
    probability q is float32 as the reference computes it (its ratio
    (k + 2) / (k + 1) near 1 carries float32's rounding into log q); the
    rest is float64."""
    b, c = logits.shape
    s32 = samples.astype(np.float32)
    q = np.log((s32 + np.float32(2)) / (s32 + np.float32(1))) \
        / np.float32(math.log(c + 1.0))
    picked = np.take_along_axis(logits.astype(np.float64), samples, 1) \
        - np.log(q.astype(np.float64))
    if remove:
        picked[:, 1:] += np.where(samples[:, 1:] == label[:, None], -1e20,
                                  0.0)
    m = picked.max(1, keepdims=True)
    lse = m + np.log(np.exp(picked - m).sum(1, keepdims=True))
    prob = np.exp(picked - lse)
    loss = lse[:, 0] - picked[:, 0]
    d = prob.copy()
    d[:, 0] -= 1.0
    grad = np.zeros((b, c))
    rows = np.repeat(np.arange(b)[:, None], samples.shape[1], 1)
    np.add.at(grad, (rows, samples), d * ct)
    return loss[:, None], prob, grad


@pytest.mark.parametrize("remove", [True, False])
def test_sampled_softmax_equals_the_formula_on_its_samples(remove):
    feed = sampled_feed()
    smp, prob, loss, grad = run_sampled(11, feed, remove)
    label = feed["lb"][:, 0]
    assert smp.dtype == np.int64 and smp.shape == (B, 1 + NS)
    np.testing.assert_array_equal(smp[:, 0], label)
    assert (smp >= 0).all() and (smp < CLS).all()
    hits = smp[:, 1:] == label[:, None]
    assert hits.any()               # the masking is exercised
    want = sampled_formula(feed["lg"], smp, label, feed["ct"], remove)
    for got, ref in zip((loss, prob, grad), want):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if remove:
        assert (prob[:, 1:][hits] == 0).all()


def test_sampled_softmax_repeats_under_a_seed_and_differs_across():
    feed = sampled_feed(1)
    a, b, c = run_sampled(5, feed), run_sampled(5, feed), run_sampled(6, feed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_sampled_negatives_follow_the_log_uniform_law():
    from scipy import stats
    feed = sampled_feed(2)
    neg = np.concatenate([run_sampled(s, feed)[0][:, 1:].ravel()
                          for s in range(1, 6)])
    # bins [0], [1], [2, 3], [4, 7], ..., [256, 499]
    edges = [0, 1, 2, 4, 8, 16, 32, 64, 128, 256, CLS]
    counts = np.histogram(neg, bins=edges)[0]
    cdf = np.log(np.array(edges, np.float64) + 1.0) / math.log(CLS + 1.0)
    expected = np.diff(cdf) * neg.size
    assert stats.chisquare(counts, expected).pvalue > 1e-4


# ------------------------------------------------------------- py_func
def py_func_program(fl, fn, out_dtypes=("float32", "int64")):
    L = fl.layers
    xa = L.data("xa", shape=[3, 4], dtype="float32", append_batch_size=False)
    xb = L.data("xb", shape=[4], dtype="float32", append_batch_size=False)
    blk = fl.default_main_program().global_block
    o1 = blk.create_var(name="o1", shape=(3, 4), dtype=out_dtypes[0])
    o2 = blk.create_var(name="o2", shape=(1,), dtype=out_dtypes[1])
    L.py_func(fn, [xa, xb], [o1, o2])
    return o1, o2


def _two_outs(a, b):
    return a * b[None, :] + 1.0, np.array([int((a > 0).sum())], np.int64)


def _run_py_func(fn, out_dtypes=("float32", "int64")):
    with tfluid.unique_name.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            py_func_program(tfluid, fn, out_dtypes)
    feed = {"xa": f32(3, 4, seed=20), "xb": f32(4, seed=21)}
    return feed, tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=["o1", "o2"], scope=tfluid.Scope())


def test_py_func_runs_a_callback_with_several_outputs():
    feed, (o1, o2) = _run_py_func(_two_outs)
    want1, want2 = _two_outs(feed["xa"], feed["xb"])
    np.testing.assert_array_equal(o1, want1)
    assert o2.dtype == np.int64 and o2.tolist() == want2.tolist()


@pytest.mark.parametrize("bad", ["dtype", "shape", "count"])
def test_py_func_holds_results_to_their_declaration(bad):
    def fn(a, b):
        one, n = _two_outs(a, b)
        if bad == "dtype":
            return one.astype(np.float64), n
        if bad == "shape":
            return one[:2], n
        return one
    with pytest.raises(Exception, match=r"(TypeError|ValueError): py_func "
                       r"\d+: the callback returned|result 0 is"):
        _run_py_func(fn)


# -------------------------------------------------------------- layers
def tail_net(fl):
    L = fl.layers
    x = L.data("x", shape=[4, 7, 6], dtype="float32")
    off = L.data("off", shape=[18, 7, 6], dtype="float32")
    msk = L.data("msk", shape=[9, 7, 6], dtype="float32")
    y2 = L.deformable_conv(x, off, msk, num_filters=4, filter_size=3,
                           padding=1)
    y1 = L.deformable_conv(x, off, None, num_filters=2, filter_size=3,
                           padding=1, groups=2, modulated=False,
                           bias_attr=False)
    feat = L.data("feat", shape=[18, 8, 9], dtype="float32")
    r = L.data("r", shape=[4], dtype="float32")
    bi = L.data("bi", shape=[1], dtype="int32")
    tr = L.data("tr", shape=[2, 3, 3], dtype="float32")
    dp = L.deformable_roi_pooling(feat, r, tr, group_size=(3, 3),
                                  pooled_height=3, pooled_width=3,
                                  sample_per_part=2, rois_batch_idx=bi)
    ps = L.psroi_pool(feat, r, 2, 0.25, 3, 3, rois_batch_idx=bi)
    pr = L.prroi_pool(feat, r, spatial_scale=0.5, pooled_height=2,
                      pooled_width=2, rois_batch_idx=bi)
    lg = L.data("lg", shape=[50], dtype="float32")
    lb = L.data("lb", shape=[1], dtype="int64")
    ss = L.sampled_softmax_with_cross_entropy(lg, lb, 7, seed=3)
    return [y2, y1, dp, ps, pr, ss]


def test_tail_layers_build_the_jax_programs():
    b = build_both(tail_net)
    for k in (0, 1):
        assert normalized(b["torch"][k]) == normalized(b["jax"][k])


def test_deformable_conv_layer_computes_the_jax_values():
    """The filter and bias carry across from the JAX package's startup
    (``interop.scope_from_numpy``); both layers agree."""
    def net(fl):
        L = fl.layers
        x = L.data("x", shape=[4, 7, 6], dtype="float32")
        off = L.data("off", shape=[18, 7, 6], dtype="float32")
        msk = L.data("msk", shape=[9, 7, 6], dtype="float32")
        return [L.deformable_conv(x, off, msk, num_filters=4,
                                  filter_size=3, padding=1)]
    b = build_both(net)
    scopes, state = carried_scopes(b)
    assert any(n.startswith("deformable_conv") for n in state)
    feed = {"x": f32(2, 4, 7, 6, seed=30),
            "off": f32(2, 18, 7, 6, seed=31),
            "msk": np.random.RandomState(32).rand(2, 9, 7, 6)
            .astype(np.float32)}
    res = {pkg: scopes[pkg][0].run(b[pkg][0], feed=feed,
                                   fetch_list=[b[pkg][2][0].name],
                                   scope=scopes[pkg][1])[0]
           for pkg in scopes}
    np.testing.assert_allclose(res["torch"], np.asarray(res["jax"]),
                               rtol=CONV_TOL[0], atol=CONV_TOL[1])


def test_py_func_layer_builds_the_jax_program():
    """The program is the JAX package's but for ``func_id``, an index
    into each package's own callback list: it names the same callback in
    each."""
    import paddle_tpu.ops.misc2 as jmisc2
    import paddle_tpu_torch.ops.misc2 as tmisc2

    def fn(a, b):
        return _two_outs(a, b)

    b = build_both(lambda fl: py_func_program(fl, fn, ("float32", "int32")))
    dicts = {pkg: normalized(b[pkg][0]) for pkg in b}
    ids = {}
    for pkg, d in dicts.items():
        (op,) = [o for o in d["blocks"][0]["ops"] if o["type"] == "py_func"]
        ids[pkg] = op["attrs"].pop("func_id")
    assert dicts["torch"] == dicts["jax"]
    assert jmisc2._PY_FUNCS[ids["jax"]] is fn
    assert tmisc2._PY_FUNCS[ids["torch"]] is fn


@pytest.mark.parametrize("refusal", ["roi_pooling_not_ps", "backward_func",
                                     "customized_samples", "nums_and_idx"])
def test_layer_refusals_raise_as_in_jax(refusal):
    def fn(fl):
        L = fl.layers
        feat = L.data("feat", shape=[18, 8, 9], dtype="float32")
        r = L.data("r", shape=[4], dtype="float32")
        if refusal == "roi_pooling_not_ps":
            tr = L.data("tr", shape=[2, 3, 3], dtype="float32")
            L.deformable_roi_pooling(feat, r, tr, position_sensitive=False)
        elif refusal == "backward_func":
            L.py_func(lambda a: a, feat, feat, backward_func=lambda g: g)
        elif refusal == "customized_samples":
            lb = L.data("lb", shape=[1], dtype="int64")
            L.sampled_softmax_with_cross_entropy(
                feat, lb, 5, use_customized_samples=True)
        else:
            n = L.data("n", shape=[1], dtype="int32")
            L.prroi_pool(feat, r, batch_roi_nums=n, rois_batch_idx=n)
    errors = {}
    for pkg in PKGS:
        with pytest.raises((NotImplementedError, ValueError)) as e:
            build_in(pkg, fn)
        # the type and the call refused; the reasons are each package's
        errors[pkg] = (type(e.value), str(e.value).split(":")[0])
    assert errors["torch"] == errors["jax"]


def build_in(pkg, fn):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            fn(fl)


def test_pooling_a_batch_without_batch_indexes_is_refused():
    """Two images and no RoI batch indexes: both packages refuse to pool
    every RoI from image 0 when the program runs."""
    feed = {"feat": f32(2, 18, 8, 9, seed=40), "r": rois(3, 41, 8, 9)}
    for pkg, (fl, un) in PKGS.items():
        with un.guard():
            main, startup = fl.Program(), fl.Program()
            with fl.program_guard(main, startup):
                feat = fl.layers.data("feat", shape=[2, 18, 8, 9],
                                      dtype="float32",
                                      append_batch_size=False)
                r = fl.layers.data("r", shape=[4], dtype="float32")
                o = fl.layers.psroi_pool(feat, r, 2, 0.25, 3, 3)
        with pytest.raises(Exception, match="neither RoisBatchIdx"):
            fl.Executor(fl.CPUPlace()).run(main, feed=feed, fetch_list=[o],
                                           scope=fl.Scope())
