"""The structured ops of the port (``ops/structured.py``:
linear_chain_crf, crf_decoding, nce, hierarchical_sigmoid,
edit_distance, ctc_align, chunk_eval) against the JAX package's on the
CPU, forward and gradients where they exist (``run_op_case``: f32 rtol
1e-5, atol 1e-6; ints exactly), with lengths 0, 1, full and part, and
``crf_decoding`` on planted ties (both argmaxes take the first maximum).
The JAX package's numpy oracles are a second witness. ``nce`` samples its
negatives from the op's generator, so it is held by the reference's cost
formula on the labels it returns, by its gradient against autograd of
that formula on the same labels, and by its sample distribution."""
import math

import numpy as np
import pytest
import torch

from test_structured_ops import (np_crf_nll, np_edit_distance, np_hsigmoid,
                                 np_viterbi)
from test_torch_sequence_ops import (LENS, PKGS, assert_case_matches, f32,
                                     ints, run_op_case)

import paddle_tpu_torch as tfluid

B, T, NT = 4, 6, 5        # batch, time, tags
LENGTH = [("len", LENS)]


def _crf_ins(length=True, seed=0):
    ins = {"Emission": [("em", f32(B, T, NT, seed=seed))],
           "Transition": [("tr", f32(NT + 2, NT, seed=seed + 1, scale=0.3))],
           "Label": [("lbl", ints(NT, B, T, 1, seed=seed + 2))]}
    if length:
        ins["Length"] = LENGTH
    return ins


CRF_OUTS = {"Alpha": ["alpha"], "EmissionExps": ["ee"],
            "TransitionExps": ["te"], "LogLikelihood": ["ll"]}
# planted ties: integer emissions and a zero transition tie many paths
TIE_EM = np.random.RandomState(3).randint(0, 2, (B, T, NT)) \
    .astype(np.float32)
TIE_TR = np.zeros((NT + 2, NT), np.float32)
# IOB tags of 2 chunk types (B-0 0, I-0 1, B-1 2, I-1 3, O 4)
TAGS_INF = np.array([[0, 1, 4, 2, 3, 3, 4, 0], [2, 3, 1, 4, 0, 0, 1, 4],
                     [4, 4, 4, 4, 4, 4, 4, 4], [0, 1, 1, 2, 3, 4, 2, 2]],
                    np.int64)
TAGS_LAB = np.array([[0, 1, 4, 2, 3, 4, 4, 0], [2, 3, 4, 4, 0, 1, 1, 4],
                     [0, 4, 4, 4, 4, 4, 4, 4], [0, 1, 1, 2, 3, 4, 2, 3]],
                    np.int64)
CHUNK_LEN = [("sl", np.array([8, 6, 0, 7], np.int64))]

CASES = {
    "linear_chain_crf": ("linear_chain_crf", _crf_ins(), CRF_OUTS, {},
                         ["ll", "alpha"]),
    "linear_chain_crf_full": ("linear_chain_crf", _crf_ins(False, seed=4),
                              CRF_OUTS, {}, ["ll"]),
    "crf_decoding": ("crf_decoding",
                     {k: v for k, v in _crf_ins().items() if k != "Label"},
                     {"ViterbiPath": ["path"]}, {}, []),
    "crf_decoding_label": ("crf_decoding", _crf_ins(seed=5),
                           {"ViterbiPath": ["path"]}, {}, []),
    "crf_decoding_ties": ("crf_decoding",
                          {"Emission": [("em", TIE_EM)],
                           "Transition": [("tr", TIE_TR)],
                           "Length": LENGTH},
                          {"ViterbiPath": ["path"]}, {}, []),
    "hierarchical_sigmoid": (
        "hierarchical_sigmoid",
        {"X": [("x", f32(B, 6))], "W": [("w", f32(6, 6, seed=1, scale=0.5))],
         "Label": [("lbl", np.array([[0], [3], [6], [5]], np.int64))],
         "Bias": [("b", f32(6, seed=2, scale=0.1))]},
        {"Out": ["o"], "PreOut": ["pre"]}, {"num_classes": 7}, ["o"]),
    "hierarchical_sigmoid_custom": (
        "hierarchical_sigmoid",
        {"X": [("x", f32(B, 6))], "W": [("w", f32(5, 6, seed=1, scale=0.5))],
         "Label": [("lbl", np.array([[0], [1], [2], [3]], np.int64))],
         "PathTable": [("pt", np.array([[0, 1, -1], [0, 2, 4], [3, -1, -1],
                                        [0, 1, 2]], np.int64))],
         "PathCode": [("pc", np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0],
                                       [0, 0, 1]], np.int64))]},
        {"Out": ["o"], "PreOut": ["pre"]}, {"num_classes": 5}, ["o", "pre"]),
    "edit_distance": (
        "edit_distance",
        {"Hyps": [("h", ints(5, B, T, seed=1))],
         "Refs": [("r", ints(5, B, 5, seed=2))],
         "HypsLength": [("hl", np.array([0, 1, 6, 4], np.int64))],
         "RefsLength": [("rl", np.array([3, 0, 5, 4], np.int64))]},
        {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": False}, []),
    "edit_distance_normalized": (
        "edit_distance",
        {"Hyps": [("h", ints(5, B, T, 1, seed=3))],
         "Refs": [("r", ints(5, B, T, 1, seed=4))]},
        {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": True}, []),
    "ctc_align": (
        "ctc_align",
        {"Input": [("x", np.array([[0, 1, 1, 0, 2, 2, 3, 0],
                                   [1, 1, 1, 1, 0, 0, 4, 4],
                                   [0, 0, 0, 0, 0, 0, 0, 0],
                                   [2, 0, 2, 3, 3, 0, 1, 1]], np.int64))],
         "InputLength": [("il", np.array([8, 5, 3, 0], np.int64))]},
        {"Output": ["o"], "OutputLength": ["ol"]},
        {"blank": 0, "merge_repeated": True, "padding_value": -1}, []),
    "ctc_align_keep_repeats": (
        "ctc_align",
        {"Input": [("x", ints(4, B, 8, 1, seed=6))]},
        {"Output": ["o"], "OutputLength": ["ol"]},
        {"blank": 3, "merge_repeated": False}, []),
}
for _scheme, _types in (("IOB", 2), ("IOE", 2), ("IOBES", 1),
                        ("plain", 4)):
    CASES[f"chunk_eval_{_scheme}"] = (
        "chunk_eval",
        {"Inference": [("inf", TAGS_INF)], "Label": [("lab", TAGS_LAB)],
         "SeqLength": CHUNK_LEN},
        {"Precision": ["p"], "Recall": ["r"], "F1-Score": ["f"],
         "NumInferChunks": ["ni"], "NumLabelChunks": ["nl"],
         "NumCorrectChunks": ["nc"]},
        {"num_chunk_types": _types, "chunk_scheme": _scheme}, [])
CASES["chunk_eval_excluded"] = (
    "chunk_eval", {"Inference": [("inf", TAGS_INF[..., None])],
                   "Label": [("lab", TAGS_LAB[..., None])]},
    {"Precision": ["p"], "Recall": ["r"], "F1-Score": ["f"],
     "NumInferChunks": ["ni"], "NumLabelChunks": ["nl"],
     "NumCorrectChunks": ["nc"]},
    {"num_chunk_types": 2, "chunk_scheme": "IOB",
     "excluded_chunk_types": [1]}, [])


@pytest.mark.parametrize("case", sorted(CASES))
def test_structured_op_matches_jax(case):
    op_type, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op_type, ins, outs, attrs, grad_outs)
    t = assert_case_matches(got, shapes)
    if grad_outs:
        grads = [k for k in t if k.startswith("grad:")]
        assert grads and all(np.abs(t[k]).max() > 0 for k in grads), case


def test_every_structured_op_type_has_a_case():
    from paddle_tpu.core import registry as jreg

    want = {n for n, d in jreg._OP_REGISTRY.items()
            if d.lower is not None
            and d.lower.__module__ == "paddle_tpu.ops.structured"}
    assert {c[0] for c in CASES.values()} | {"nce"} == want
    assert len(want) == 7


def test_crf_against_numpy_oracles():
    got, _ = run_op_case(*CASES["linear_chain_crf"][:4])
    ins = CASES["linear_chain_crf"][1]
    em, tr = ins["Emission"][0][1], ins["Transition"][0][1]
    lbl = ins["Label"][0][1][..., 0]
    lens = np.maximum(LENS, 1)         # the oracle needs one step
    keep = LENS > 0
    np.testing.assert_allclose(got["torch"]["ll"][keep],
                               np_crf_nll(em, tr, lbl, lens)[keep],
                               rtol=1e-4, atol=1e-4)
    got, _ = run_op_case(*CASES["crf_decoding"][:4])
    path = np_viterbi(em, tr, lens)
    path[~keep] = 0
    np.testing.assert_array_equal(got["torch"]["path"], path)


def test_crf_decoding_planted_ties_take_the_first_maximum():
    """All-equal scores: every backpointer and the last tag are the first
    index, so a row with no emission preference decodes to all 0."""
    em = np.zeros((2, 5, 4), np.float32)
    em[1, 2, 3] = 1.0
    got, shapes = run_op_case(
        "crf_decoding", {"Emission": [("em", em)],
                         "Transition": [("tr", np.zeros((6, 4), np.float32))]},
        {"ViterbiPath": ["path"]})
    t = assert_case_matches(got, shapes)
    np.testing.assert_array_equal(t["path"], [[0, 0, 0, 0, 0],
                                              [0, 0, 3, 0, 0]])
    assert t["path"].dtype == np.int64


def test_edit_distance_and_hsigmoid_against_numpy_oracles():
    _, ins, outs, attrs, _ = CASES["edit_distance"]
    got, _ = run_op_case("edit_distance", ins, outs, attrs)
    want = np_edit_distance(ins["Hyps"][0][1], ins["HypsLength"][0][1],
                            ins["Refs"][0][1], ins["RefsLength"][0][1])
    np.testing.assert_allclose(got["torch"]["o"], want, rtol=1e-6)
    _, ins, outs, attrs, _ = CASES["hierarchical_sigmoid"]
    got, _ = run_op_case("hierarchical_sigmoid", ins, outs, attrs)
    want = np_hsigmoid(ins["X"][0][1], ins["W"][0][1], ins["Bias"][0][1],
                       ins["Label"][0][1], 7)
    np.testing.assert_allclose(got["torch"]["o"], want, rtol=1e-4,
                               atol=1e-4)


def _nce_run(sampler, seed, k=3, c=12, b=4, d=6):
    """One nce op (and its gradient) in the port: cost, logits, sampled
    labels, the Input and Weight gradients, and the inputs."""
    rng = np.random.RandomState(11)
    xv = rng.randn(b, d).astype(np.float32)
    wv = (0.5 * rng.randn(c, d)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    label = rng.randint(0, c, (b, 1)).astype(np.int64)
    fl, un = PKGS["torch"]
    with un.guard():
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            blk = main.global_block
            vs = {n: blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                                    is_data=True,
                                    stop_gradient=a.dtype != np.float32)
                  for n, a in (("x", xv), ("w", wv), ("bias", bias),
                               ("lbl", label))}
            for n in ("cost", "slog", "sids"):
                blk.create_var(name=n)
            blk.append_op("nce", inputs={"Input": vs["x"], "Label": vs["lbl"],
                                         "Weight": vs["w"],
                                         "Bias": vs["bias"]},
                          outputs={"Cost": "cost", "SampleLogits": "slog",
                                   "SampleLabels": "sids"},
                          attrs={"num_total_classes": c,
                                 "num_neg_samples": k, "sampler": sampler,
                                 "seed": seed})
            loss = fl.layers.reduce_sum(blk.var("cost"))
            gx, gw = fl.gradients([loss], [vs["x"], vs["w"]])
    main.random_seed = 5
    res = fl.Executor(fl.CPUPlace()).run(
        main, feed={"x": xv, "w": wv, "bias": bias, "lbl": label},
        fetch_list=["cost", "slog", "sids", gx.name, gw.name],
        scope=fl.Scope())
    return [np.asarray(r) for r in res] + [xv, wv, bias, k, c]


def _nce_formula(xv, wv, bias, sids, k, c, sampler):
    """The reference's cost (nce_op.h:237-245) on given sampled labels,
    in torch so autograd gives its gradient."""
    x = torch.tensor(xv, dtype=torch.float64, requires_grad=True)
    w = torch.tensor(wv, dtype=torch.float64, requires_grad=True)
    ids = torch.from_numpy(sids)
    s = torch.einsum("bd,bsd->bs", x, w[ids]) + torch.from_numpy(
        bias).double()[ids]
    o = torch.sigmoid(s)
    if sampler == 1:
        q = torch.log((ids + 2.0) / (ids + 1.0)) / math.log(c + 1.0)
    else:
        q = torch.full(ids.shape, 1.0 / c, dtype=torch.float64)
    bq = k * q
    cost = -torch.log(o[:, 0] / (o[:, 0] + bq[:, 0])) - torch.sum(
        torch.log(bq[:, 1:] / (o[:, 1:] + bq[:, 1:])), dim=1)
    cost.sum().backward()
    return cost.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("sampler,seed", [(0, 7), (1, 0)])
def test_nce_cost_and_grad_follow_the_formula_on_its_samples(sampler, seed):
    """The cost is the reference's formula on the op's own SampleLabels
    (rtol 1e-4, as the JAX package's test), and the generic grad's rerun
    drew the same negatives: its gradient equals autograd of the formula
    on those labels."""
    cost, slog, sids, gx, gw, xv, wv, bias, k, c = _nce_run(sampler, seed)
    want, wgx, wgw = _nce_formula(xv, wv, bias, sids, k, c, sampler)
    s = np.einsum("bd,bsd->bs", xv, wv[sids]) + bias[sids]
    np.testing.assert_allclose(slog, 1.0 / (1.0 + np.exp(-s)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cost.reshape(-1), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gx, wgx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gw, wgw, rtol=1e-4, atol=1e-5)
    assert sids.dtype == np.int64 and ((sids >= 0) & (sids < c)).all()
    # an explicit seed gives the same negatives in every run
    if seed:
        assert np.array_equal(_nce_run(sampler, seed)[2], sids)


@pytest.mark.parametrize("sampler", [0, 1])
def test_nce_sample_distribution(sampler):
    """The negatives follow the sampler's distribution: uniform over the
    classes, or log-uniform P(i) = log((i+2)/(i+1)) / log(C+1); a chi-square
    bound at 20 degrees of freedom (p < 1e-4 to fail by chance)."""
    from paddle_tpu_torch.lowering import LowerCtx
    from paddle_tpu_torch.ops.structured import _nce_sample

    c, n = 20, 40000
    gen = LowerCtx("cpu", seed=3, uid=9).generator()
    ids = _nce_sample(gen, sampler, (n,), c, "cpu").numpy()
    counts = np.bincount(ids, minlength=c)
    i = np.arange(c)
    p = (np.full(c, 1.0 / c) if sampler == 0
         else np.log((i + 2.0) / (i + 1.0)) / math.log(c + 1.0))
    p = p / p.sum()
    chi2 = ((counts - n * p) ** 2 / (n * p)).sum()
    assert chi2 < 52.0, (chi2, counts)


def test_registry_defs_match_jax():
    """Each new op type declares the JAX package's slots, no_grad marks,
    optional outputs, attrs with their defaults, grad and rng flags."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    mods = {"paddle_tpu.ops.sequence_ops", "paddle_tpu.ops.rnn_ops",
            "paddle_tpu.ops.structured"}
    names = {n for n, d in jreg._OP_REGISTRY.items()
             if d.lower is not None and d.lower.__module__ in mods}
    names |= {"sequence_reshape", "sequence_expand_as", "sequence_scatter"}
    assert len(names) == 28
    for n in sorted(names):
        jd, td = jreg.get_op_def(n), treg.get_op_def(n)
        for a, b in ((jd.inputs, td.inputs), (jd.outputs, td.outputs)):
            assert [(s.name, s.duplicable, s.optional, s.no_grad)
                    for s in a] == [(s.name, s.duplicable, s.optional,
                                     s.no_grad) for s in b], n
        assert {k: v.default for k, v in jd.attrs.items()} == \
            {k: v.default for k, v in td.attrs.items()}, n
        assert (jd.grad is None) == (td.grad is None), n
        assert jd.needs_rng == td.needs_rng, n
    assert tfluid.layers.hsigmoid and tfluid.layers.ctc_greedy_decoder
