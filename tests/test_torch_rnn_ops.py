"""The recurrent ops of the port (``ops/rnn_ops.py``: lstm, lstmp, gru,
gru_unit, cudnn_lstm, warpctc) against the JAX package's on the CPU,
forward and gradients (``run_op_case``: f32 rtol 1e-5, atol 1e-6), at
hidden 8 over lengths 0, 1, 6 and 3 of 6: both directions, both
``origin_mode`` forms, peepholes on and off, 1 and 2 cudnn_lstm layers,
CTC with repeated labels and an empty label. The numpy oracles of the
JAX package's own tests are a second witness (rtol 1e-4, atol 1e-5, as
they hold the JAX package)."""
import numpy as np
import pytest
import torch

from test_rnn_ops import _np_ctc_loss, _np_gru, _np_lstm
from test_torch_sequence_ops import (LENS, assert_case_matches, f32,
                                     run_op_case)

B, T, H, D = 4, 6, 8, 5
LOD = [("ln", LENS)]


def _lstm_case(peep, reverse, init=False):
    ins = {"Input": [("xg", f32(B, T, 4 * H, scale=0.5))],
           "Weight": [("w", f32(H, 4 * H, seed=1, scale=0.3))],
           "Bias": [("b", f32(1, (7 if peep else 4) * H, seed=2,
                              scale=0.1))],
           "SeqLen": LOD}
    if init:
        ins["H0"] = [("h0", f32(B, H, seed=3, scale=0.5))]
        ins["C0"] = [("c0", f32(B, H, seed=4, scale=0.5))]
    return ("lstm", ins, {"Hidden": ["hid"], "Cell": ["cell"]},
            {"use_peepholes": peep, "is_reverse": reverse},
            ["hid", "cell"])


def _gru_case(reverse, origin, init=True):
    ins = {"Input": [("xg", f32(B, T, 3 * H, scale=0.5))],
           "Weight": [("w", f32(H, 3 * H, seed=1, scale=0.3))],
           "Bias": [("b", f32(1, 3 * H, seed=2, scale=0.1))],
           "SeqLen": LOD}
    if init:
        ins["H0"] = [("h0", f32(B, H, seed=3, scale=0.5))]
    return ("gru", ins, {"Hidden": ["hid"]},
            {"is_reverse": reverse, "origin_mode": origin}, ["hid"])


def _cudnn_w(layers):
    n = sum(4 * H * (D if i == 0 else H) + 4 * H * H + 8 * H
            for i in range(layers))
    return f32(n, seed=5, scale=0.3)


def _cudnn_case(layers):
    return ("cudnn_lstm",
            {"Input": [("x", f32(B, T, D))], "W": [("w", _cudnn_w(layers))],
             "InitH": [("ih", f32(layers, B, H, seed=1, scale=0.5))],
             "InitC": [("ic", f32(layers, B, H, seed=2, scale=0.5))],
             "SeqLen": LOD},
            {"Out": ["o"], "LastH": ["lh"], "LastC": ["lc"]},
            {"hidden_size": H, "num_layers": layers}, ["o", "lh", "lc"])


# repeated labels (2, 2 needs a blank between them), an empty label, and
# a logits length shorter than the padded T
CTC_LABELS = np.array([[2, 2, 3], [1, 4, 0], [3, 0, 0], [4, 1, 1]],
                      np.int64)
CTC_LLEN = np.array([3, 2, 0, 1], np.int64)
CTC_TLEN = np.array([7, 5, 7, 2], np.int64)


def _ctc_case(norm):
    return ("warpctc",
            {"Logits": [("lg", f32(B, 7, 5))],
             "Label": [("lbl", CTC_LABELS)],
             "LogitsLength": [("tl", CTC_TLEN)],
             "LabelLength": [("ll", CTC_LLEN)]},
            {"Loss": ["loss"]}, {"blank": 0, "norm_by_times": norm},
            ["loss"])


CASES = {
    "lstm_peep": _lstm_case(True, False),
    "lstm_peep_reverse": _lstm_case(True, True),
    "lstm_plain": _lstm_case(False, False, init=True),
    "lstm_plain_reverse": _lstm_case(False, True, init=True),
    "lstmp": ("lstmp",
              {"Input": [("xg", f32(B, T, 4 * H, scale=0.5))],
               "Weight": [("w", f32(3, 4 * H, seed=1, scale=0.3))],
               "ProjWeight": [("pw", f32(H, 3, seed=2, scale=0.3))],
               "Bias": [("b", f32(1, 7 * H, seed=3, scale=0.1))],
               "SeqLen": LOD},
              {"Projection": ["proj"], "Cell": ["cell"]},
              {"use_peepholes": True, "cell_clip": 0.8, "proj_clip": 0.5},
              ["proj", "cell"]),
    "lstmp_reverse": ("lstmp",
                      {"Input": [("xg", f32(B, T, 4 * H, scale=0.5))],
                       "Weight": [("w", f32(3, 4 * H, seed=1, scale=0.3))],
                       "ProjWeight": [("pw", f32(H, 3, seed=2, scale=0.3))],
                       "Bias": [("b", f32(1, 4 * H, seed=3, scale=0.1))],
                       "SeqLen": LOD},
                      {"Projection": ["proj"], "Cell": ["cell"]},
                      {"use_peepholes": False, "is_reverse": True},
                      ["proj", "cell"]),
    "gru": _gru_case(False, False),
    "gru_reverse": _gru_case(True, False),
    "gru_origin": _gru_case(False, True),
    "gru_origin_reverse": _gru_case(True, True, init=False),
    "cudnn_lstm_1": _cudnn_case(1),
    "cudnn_lstm_2": _cudnn_case(2),
    "warpctc": _ctc_case(False),
    "warpctc_norm_by_times": _ctc_case(True),
}
for _origin in (False, True):
    CASES[f"gru_unit{'_origin' if _origin else ''}"] = (
        "gru_unit",
        {"Input": [("x", f32(B, 3 * H, scale=0.5))],
         "HiddenPrev": [("hp", f32(B, H, seed=1, scale=0.5))],
         "Weight": [("w", f32(H, 3 * H, seed=2, scale=0.3))],
         "Bias": [("b", f32(1, 3 * H, seed=3, scale=0.1))]},
        {"Gate": ["gate"], "ResetHiddenPrev": ["rh"], "Hidden": ["h"]},
        {"origin_mode": _origin}, ["gate", "rh", "h"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_rnn_op_matches_jax(case):
    op_type, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op_type, ins, outs, attrs, grad_outs)
    t = assert_case_matches(got, shapes)
    grads = [k for k in t if k.startswith("grad:")]
    assert grads and all(np.isfinite(t[k]).all() for k in grads), case
    if op_type in ("lstm", "gru", "lstmp", "cudnn_lstm"):
        out = t[outs["Hidden" if "Hidden" in outs else
                     "Projection" if "Projection" in outs else "Out"][0]]
        past = np.arange(T)[None, :] >= LENS[:, None]
        assert (out[past] == 0).all(), "hidden past a length"


def test_every_rnn_op_type_has_a_case():
    from paddle_tpu.core import registry as jreg

    want = {n for n, d in jreg._OP_REGISTRY.items()
            if d.lower is not None
            and d.lower.__module__ == "paddle_tpu.ops.rnn_ops"}
    assert {c[0] for c in CASES.values()} == want and len(want) == 6


@pytest.mark.parametrize("peep", [True, False])
def test_lstm_against_numpy_oracle(peep):
    op_type, ins, outs, attrs, _ = _lstm_case(peep, False)
    got, _ = run_op_case(op_type, ins, outs, attrs)
    hid, cT = _np_lstm(ins["Input"][0][1], ins["Weight"][0][1],
                       ins["Bias"][0][1], LENS, peep=peep)
    np.testing.assert_allclose(got["torch"]["hid"], hid, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["torch"]["cell"], cT, rtol=1e-4,
                               atol=1e-5)


def test_gru_against_numpy_oracle():
    op_type, ins, outs, attrs, _ = _gru_case(False, False, init=False)
    got, _ = run_op_case(op_type, ins, outs, attrs)
    want = _np_gru(ins["Input"][0][1], ins["Weight"][0][1],
                   ins["Bias"][0][1], LENS)
    np.testing.assert_allclose(got["torch"]["hid"], want, rtol=1e-4,
                               atol=1e-5)


def test_warpctc_against_numpy_oracle():
    op_type, ins, outs, attrs, _ = _ctc_case(False)
    got, _ = run_op_case(op_type, ins, outs, attrs)
    want = _np_ctc_loss(ins["Logits"][0][1], CTC_LABELS, CTC_TLEN, CTC_LLEN)
    np.testing.assert_allclose(got["torch"]["loss"], want, rtol=1e-4,
                               atol=1e-5)


def test_warpctc_gradient_stays_finite_on_impossible_paths():
    """Labels longer than their frames leave only NEG (-1e30) paths: the
    loss is huge but finite, as the JAX package's, and so is its gradient
    (``torch.logaddexp`` of two NEGs is finite in f32). The gradient
    itself differs by design here: at two equal arguments autograd gives
    each 1/2 and ``jnp.logaddexp``'s rule gives each exp(x - out) = 1
    (out rounds back to -1e30), so only its finiteness is held."""
    got, shapes = run_op_case(
        "warpctc", {"Logits": [("lg", f32(2, 3, 5))],
                    "Label": [("lbl", np.array([[1, 2, 3, 4], [1, 1, 1, 1]],
                                               np.int64))],
                    "LogitsLength": [("tl", np.array([3, 2], np.int64))],
                    "LabelLength": [("ll", np.array([4, 4], np.int64))]},
        {"Loss": ["loss"]}, {}, grad_outs=["loss"])
    t = assert_case_matches(got, shapes, skip=("grad:lg@GRAD",))
    assert np.isfinite(t["loss"]).all() and (t["loss"] > 1e29).all()
    assert np.isfinite(t["grad:lg@GRAD"]).all()
    assert np.isfinite(got["jax"]["grad:lg@GRAD"]).all()


def test_cudnn_lstm_dropout_draws_from_the_op_generator():
    """With dropout between layers the masks come from the op's
    generator: the same step seed and uid give the same output (so the
    generic grad's rerun drops the same elements), another seed another
    mask; the first layer sees no dropout, and ``is_test`` turns it
    off."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    rule = registry.get_op_def("cudnn_lstm").lower
    ins = {"Input": [torch.from_numpy(f32(B, T, D))],
           "W": [torch.from_numpy(_cudnn_w(2))],
           "SeqLen": [torch.from_numpy(LENS)]}
    attrs = {"hidden_size": H, "num_layers": 2, "dropout_prob": 0.5,
             "is_test": False}

    def run(seed, uid=3, **kw):
        return rule(LowerCtx("cpu", seed=seed, uid=uid), ins,
                    dict(attrs, **kw))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["Out"][0], b["Out"][0])
    assert not torch.equal(a["Out"][0], c["Out"][0])
    # the first layer never sees dropout; the second's input does
    assert torch.equal(a["LastH"][0][0], c["LastH"][0][0])
    test = run(1, is_test=True)
    plain = rule(LowerCtx("cpu", seed=1, uid=3), ins,
                 dict(attrs, dropout_prob=0.0))
    assert torch.equal(test["Out"][0], plain["Out"][0])
