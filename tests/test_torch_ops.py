"""Every op type of the port's GPT serving, BERT training, MLP, AMP and
ResNet paths, and every op of ``ops/math.py``, ``ops/optimizer_ops.py``
and ``where``, against the JAX package's rule, on the CPU. Each case is a single-op program built
the same way in both packages (data vars, one ``append_op``) and run on
the same numpy feeds; the outputs' build-time shapes must match too.
Random ops are compared by distribution and by determinism, never by
bits."""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.framework import Program as JProgram

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import Program as TProgram

RNG = np.random.RandomState(7)


def f32(*shape):
    return RNG.randn(*shape).astype(np.float32)


def i64(hi, *shape):
    return RNG.randint(0, hi, shape).astype(np.int64)


B, H, S, D = 2, 2, 8, 16
CACHE_K, CACHE_V = f32(B, H, 16, D), f32(B, H, 16, D)

# op type -> (inputs {slot: {var: array}}, outputs {slot: [var]}, attrs,
#             vars to fetch and compare)
CASES = {
    "assign": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]}, {}, ["o"]),
    "cast": ({"X": {"x": f32(3, 4) * 5}}, {"Out": ["o"]},
             {"in_dtype": "float32", "out_dtype": "int64"}, ["o"]),
    "fill_constant": ({}, {"Out": ["o"]},
                      {"shape": [2, 3], "dtype": "int64", "value": 7.0},
                      ["o"]),
    "scale": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]},
              {"scale": 10000.0, "bias": -10000.0}, ["o"]),
    "gelu": ({"X": {"x": f32(3, 4) * 3}}, {"Out": ["o"]}, {}, ["o"]),
    "relu": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]}, {}, ["o"]),
    "increment": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]}, {"step": 2.0},
                  ["o"]),
    # the dense replay of mul -> bias -> gelu -> residual -> layer_norm
    # (both packages on the CPU)
    "fused_gemm_epilogue": (
        {"X": {"x": f32(2, 3, 8)}, "Y": {"y": f32(8, 8)},
         "Bias": {"b": f32(8)}, "Residual": {"r": f32(2, 3, 8)},
         "LnScale": {"s": f32(8)}, "LnBias": {"lb": f32(8)}},
        {"Out": ["o"]},
        {"base_type": "mul", "x_num_col_dims": 2, "bias_axis": 2,
         "activation": "gelu", "layer_norm": True, "begin_norm_axis": 2},
        ["o"]),
    "layer_norm": ({"X": {"x": f32(2, 5, 8)}, "Scale": {"s": f32(8)},
                    "Bias": {"b": f32(8)}},
                   {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]},
                   {"begin_norm_axis": 2}, ["y", "m", "v"]),
    "lookup_table": ({"W": {"w": f32(10, 4)},
                      "Ids": {"ids": np.array([[3], [9], [12]], np.int64)}},
                     {"Out": ["o"]}, {}, ["o"]),
    "elementwise_add": ({"X": {"x": f32(2, 3, 4)}, "Y": {"y": f32(4)}},
                        {"Out": ["o"]}, {"axis": 2}, ["o"]),
    "elementwise_sub": ({"X": {"x": i64(9, 3, 1)}, "Y": {"y": i64(9, 3, 1)}},
                        {"Out": ["o"]}, {}, ["o"]),
    "elementwise_mul": ({"X": {"x": f32(2, 3, 4)}, "Y": {"y": f32(2, 3)}},
                        {"Out": ["o"]}, {"axis": 0}, ["o"]),
    "elementwise_min": ({"X": {"x": i64(50, 4, 1)},
                         "Y": {"y": np.full((4, 1), 20, np.int64)}},
                        {"Out": ["o"]}, {}, ["o"]),
    "mul": ({"X": {"x": f32(2, 3, 8)}, "Y": {"y": f32(8, 5)}},
            {"Out": ["o"]}, {"x_num_col_dims": 2}, ["o"]),
    "matmul": ({"X": {"x": f32(3, 8)}, "Y": {"y": f32(6, 8)}},
               {"Out": ["o"]}, {"transpose_Y": True, "alpha": 0.5}, ["o"]),
    "reshape2": ({"X": {"x": f32(2, 3, 4)}},
                 {"Out": ["o"], "XShape": ["xs"]}, {"shape": [0, -1]},
                 ["o"]),
    "transpose2": ({"X": {"x": f32(2, 3, 4, 5)}},
                   {"Out": ["o"], "XShape": ["xs"]}, {"axis": [0, 2, 1, 3]},
                   ["o"]),
    "unsqueeze2": ({"X": {"x": f32(2, 3)}},
                   {"Out": ["o"], "XShape": ["xs"]}, {"axes": [1, 2]},
                   ["o"]),
    "kv_cache_append": ({"Cache": {"c": CACHE_K.copy()},
                         "New": {"n": f32(B, H, S, D)},
                         "Positions": {"p": np.array([[0], [8]], np.int64)},
                         "SlotMask": {"m": np.array([[1.0], [0.0]],
                                                    np.float32)}},
                        {"Out": ["c"]}, {}, ["c"]),
    "sequence_gather": ({"X": {"x": f32(2, 6, 4)},
                         "Index": {"i": np.array([[5], [9]], np.int64)}},
                        {"Out": ["o"]}, {}, ["o"]),
    "sample_token": ({"Logits": {"lg": f32(4, 16)}}, {"Out": ["o"]},
                     {"strategy": "greedy"}, ["o"]),
    "spec_accept": ({"Sampled": {"s": np.array([[4, 5, 6, 7], [1, 2, 3, 4]],
                                               np.int64)},
                     "Drafts": {"d": np.array([[4, 5, 9], [8, 2, 3]],
                                              np.int64)},
                     "Start": {"st": np.array([[10], [3]], np.int64)}},
                    {"AcceptLen": ["a"], "NewTok": ["t"], "NewPos": ["np"]},
                    {}, ["a", "t", "np"]),
    "fused_multihead_attention": (
        {"Q": {"q": f32(B, H, S, D)}, "K": {"k": f32(B, H, S, D)},
         "V": {"v": f32(B, H, S, D)},
         "BiasQK": {"bias": np.where(np.arange(S)[None] < [[S], [5]], 0.0,
                                     -10000.0).astype(np.float32)
                    .reshape(B, 1, 1, S)}},
        {"Out": ["o"]}, {"causal": True, "is_test": True}, ["o"]),
    "mean": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]}, {}, ["o"]),
    "reduce_sum": ({"X": {"x": f32(2, 3, 4)}}, {"Out": ["o"]},
                   {"dim": [0, 2], "keep_dim": True}, ["o"]),
    "softmax_with_cross_entropy": (
        {"Logits": {"lg": f32(2, 3, 6)},
         "Label": {"lb": np.array([[[1], [-100], [5]], [[0], [2], [3]]],
                                  np.int64)}},
        {"Softmax": ["sm"], "Loss": ["l"]}, {"ignore_index": -100},
        ["sm", "l"]),
    "tanh": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]}, {}, ["o"]),
    "softmax": ({"X": {"x": f32(3, 5) * 4}}, {"Out": ["o"]}, {"axis": -1},
                ["o"]),
    "elementwise_div": ({"X": {"x": f32(2, 3)}, "Y": {"y": f32(1) + 3}},
                        {"Out": ["o"]}, {}, ["o"]),
    "elementwise_max": ({"X": {"x": f32(1)}, "Y": {"y": f32(1)}},
                        {"Out": ["o"]}, {}, ["o"]),
    "sum": ({"X": {"a": f32(3, 4), "b": f32(3, 4)}}, {"Out": ["o"]}, {},
            ["o"]),
    "not_equal": ({"X": {"x": np.array([[[1], [-100]], [[3], [-100]]],
                                       np.int64)},
                   "Y": {"y": np.array([-100], np.int64)}},
                  {"Out": ["o"]}, {}, ["o"]),
    "slice": ({"Input": {"x": f32(2, 5, 4)}}, {"Out": ["o"]},
              {"axes": [1], "starts": [0], "ends": [1]}, ["o"]),
    "adam": ({"Param": {"p": f32(4, 3)}, "Grad": {"g": f32(4, 3)},
              "LearningRate": {"lr": np.float32([0.01])},
              "Moment1": {"m1": f32(4, 3) * 0.1},
              "Moment2": {"m2": np.abs(f32(4, 3)) * 0.01},
              "Beta1Pow": {"b1p": np.float32([0.81])},
              "Beta2Pow": {"b2p": np.float32([0.998])}},
             {"ParamOut": ["po"], "Moment1Out": ["m1o"],
              "Moment2Out": ["m2o"], "Beta1PowOut": ["b1o"],
              "Beta2PowOut": ["b2o"]}, {},
             ["po", "m1o", "m2o", "b1o", "b2o"]),
    "fused_decode_attention": (
        {"Q": {"q": f32(B, H, 3, D)}, "KNew": {"kn": f32(B, H, 3, D)},
         "VNew": {"vn": f32(B, H, 3, D)}, "CacheK": {"ck": CACHE_K.copy()},
         "CacheV": {"cv": CACHE_V.copy()},
         "Positions": {"p": np.array([[4], [14]], np.int64)},
         "SlotMask": {"m": np.array([[1.0], [1.0]], np.float32)}},
        {"Out": ["o"], "CacheKOut": ["ck"], "CacheVOut": ["cv"]},
        {"page_size": 8}, ["o", "ck", "cv"]),
    # the MLP train step
    "sgd": ({"Param": {"p": f32(4, 3)}, "Grad": {"g": f32(4, 3)},
             "LearningRate": {"lr": np.float32([0.1])}},
            {"ParamOut": ["po"]}, {}, ["po"]),
    # the ResNet path (every attribute: tests/test_torch_conv.py)
    "conv2d": ({"Input": {"x": f32(2, 4, 9, 9)},
                "Filter": {"w": f32(6, 4, 3, 3)}}, {"Output": ["o"]},
               {"strides": [2, 2], "paddings": [1, 1]}, ["o"]),
    "depthwise_conv2d": ({"Input": {"x": f32(2, 4, 8, 8)},
                          "Filter": {"w": f32(4, 1, 3, 3)}},
                         {"Output": ["o"]},
                         {"groups": 4, "paddings": [1, 1]}, ["o"]),
    "pool2d": ({"X": {"x": f32(2, 3, 9, 9)}}, {"Out": ["o"]},
               {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
               ["o"]),
    "batch_norm": ({"X": {"x": f32(4, 3, 5, 5)}, "Scale": {"s": f32(3)},
                    "Bias": {"b": f32(3)}, "Mean": {"m": f32(3)},
                    "Variance": {"v": np.abs(f32(3)) + 0.5}},
                   {"Y": ["y"], "MeanOut": ["mo"], "VarianceOut": ["vo"],
                    "SavedMean": ["sm"], "SavedVariance": ["sv"]}, {},
                   ["y", "mo", "vo", "sm", "sv"]),
    "abs": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]}, {}, ["o"]),
    "momentum": ({"Param": {"p": f32(4, 3)}, "Grad": {"g": f32(4, 3)},
                  "Velocity": {"v": f32(4, 3)},
                  "LearningRate": {"lr": np.float32([0.1])}},
                 {"ParamOut": ["po"], "VelocityOut": ["vo"]},
                 {"mu": 0.9, "use_nesterov": True}, ["po", "vo"]),
    "top_k": ({"X": {"x": f32(5, 10)}}, {"Out": ["o"], "Indices": ["i"]},
              {"k": 3}, ["o", "i"]),
    "accuracy": ({"Out": {"o": f32(6, 2)},
                  "Indices": {"i": np.array([[1, 4], [2, 0], [7, 3], [5, 5],
                                             [9, 8], [0, 1]], np.int64)},
                  "Label": {"lb": np.array([[4], [1], [7], [2], [8], [0]],
                                           np.int64)}},
                 {"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]}, {},
                 ["a", "c", "t"]),
    # AMP loss scaling
    "logical_not": ({"X": {"x": np.array([True, False])}}, {"Out": ["o"]},
                    {}, ["o"]),
    "check_finite_and_unscale": (
        {"X": {"g1": f32(3, 4) * 1024, "g2": f32(5) * 1024},
         "Scale": {"s": np.float32([1024.0])}},
        {"Out": ["g1", "g2"], "FoundInfinite": ["f"]}, {},
        ["g1", "g2", "f"]),
    "update_loss_scaling": (
        {"FoundInfinite": {"f": np.array([False])},
         "PrevLossScaling": {"s": np.float32([512.0])},
         "InGoodSteps": {"gs": np.int32([2])},
         "InBadSteps": {"bs": np.int32([1])}},
        {"LossScaling": ["s"], "OutGoodSteps": ["gs"],
         "OutBadSteps": ["bs"]},
        {"incr_every_n_steps": 3}, ["s", "gs", "bs"]),
    "sqrt": ({"X": {"x": np.abs(f32(3, 4)) + 0.1}}, {"Out": ["o"]}, {},
             ["o"]),
    "clip": ({"X": {"x": f32(3, 4) * 2}}, {"Out": ["o"]},
             {"min": -0.5, "max": 0.75}, ["o"]),
    "clip_by_norm": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]},
                     {"max_norm": 1.0}, ["o"]),
    "squared_l2_norm": ({"X": {"x": f32(3, 4)}}, {"Out": ["o"]}, {},
                        ["o"]),
}




def pos(*shape):
    """Positive inputs, away from 0 (log, sqrt, pow ...)."""
    return np.abs(f32(*shape)) + 0.2


def unit(*shape):
    """Inputs inside (-0.9, 0.9) (asin, acos)."""
    return np.clip(f32(*shape) * 0.4, -0.9, 0.9).astype(np.float32)


def _unary(xv, **attrs):
    return ({"X": {"x": xv}}, {"Out": ["o"]}, attrs, ["o"])


def _binary(xv, yv, **attrs):
    return ({"X": {"x": xv}, "Y": {"y": yv}}, {"Out": ["o"]}, attrs, ["o"])


# the rest of ops/math.py: activations and elementwise maths
for _op, _xv in [("sigmoid", f32(3, 4)), ("exp", f32(3, 4)),
                 ("log", pos(3, 4)), ("square", f32(3, 4)),
                 ("rsqrt", pos(3, 4)), ("ceil", f32(3, 4) * 3),
                 ("floor", f32(3, 4) * 3), ("round", f32(3, 4) * 3),
                 ("reciprocal", pos(3, 4)), ("softplus", f32(3, 4) * 3),
                 ("softsign", f32(3, 4)), ("sin", f32(3, 4)),
                 ("cos", f32(3, 4)), ("logsigmoid", f32(3, 4) * 3),
                 ("erf", f32(3, 4)), ("tan", unit(3, 4)),
                 ("asin", unit(3, 4)), ("acos", unit(3, 4)),
                 ("atan", f32(3, 4)), ("sinh", f32(3, 4)),
                 ("cosh", f32(3, 4)), ("log1p", pos(3, 4)),
                 ("expm1", f32(3, 4)), ("log2", pos(3, 4)),
                 ("log10", pos(3, 4)), ("sign", f32(3, 4)),
                 ("silu", f32(3, 4) * 2), ("mish", f32(3, 4) * 2),
                 ("log_softmax", f32(3, 5) * 3)]:
    CASES[_op] = _unary(_xv)
CASES.update({
    "selu": _unary(f32(3, 4) * 2),
    "stanh": _unary(f32(3, 4), scale_a=0.5, scale_b=2.0),
    "brelu": _unary(f32(3, 4) * 4, t_min=-1.0, t_max=2.0),
    "hard_shrink": _unary(f32(3, 4), threshold=0.3),
    "softshrink": _unary(f32(3, 4), **{"lambda": 0.3}),
    "thresholded_relu": _unary(f32(3, 4) * 2, threshold=0.5),
    "maxout": _unary(f32(2, 6, 3, 3), groups=3, axis=1),
    "leaky_relu": _unary(f32(3, 4), alpha=0.1),
    "relu6": _unary(f32(3, 4) * 5),
    "elu": _unary(f32(3, 4) * 2, alpha=0.7),
    "hard_sigmoid": _unary(f32(3, 4) * 4),
    "swish": _unary(f32(3, 4) * 2, beta=1.5),
    "hard_swish": _unary(f32(3, 4) * 4),
    "pow": _unary(pos(3, 4), factor=2.5),
    "elementwise_pow": _binary(pos(2, 3), f32(3)),
    "elementwise_mod": _binary(i64(50, 3, 4) - 25,
                               np.full((4,), 7, np.int64)),
    "elementwise_floordiv": _binary(i64(50, 3, 4) - 25,
                                    np.array([3, -4, 5, 7], np.int64)),
    "isfinite": _unary(np.array([[1.0, np.inf], [0.5, 2.0]], np.float32)),
    "logical_and": _binary(np.array([True, True, False, False]),
                           np.array([True, False, True, False])),
    "logical_or": _binary(np.array([True, True, False, False]),
                          np.array([True, False, True, False])),
    "logical_xor": _binary(np.array([True, True, False, False]),
                           np.array([True, False, True, False])),
    "where": ({"Condition": {"c": f32(3, 4) > 0}, "X": {"x": f32(3, 4)},
               "Y": {"y": f32(3, 4)}}, {"Out": ["o"]}, {}, ["o"]),
})
for _op in ("equal", "less_than", "less_equal", "greater_than",
            "greater_equal"):
    CASES[_op] = _binary(i64(4, 3, 4), i64(4, 4))

# the update rules of ops/optimizer_ops.py
_P, _G = f32(4, 3), f32(4, 3)
_LR = {"LearningRate": {"lr": np.float32([0.01])}}
_POWS = {"Beta1Pow": {"b1p": np.float32([0.81])},
         "Beta2Pow": {"b2p": np.float32([0.998])}}
_ADAM_OUTS = {"ParamOut": ["po"], "Moment1Out": ["m1o"],
              "Moment2Out": ["m2o"], "Beta1PowOut": ["b1o"],
              "Beta2PowOut": ["b2o"]}
_ADAM_INS = {"Param": {"p": _P}, "Grad": {"g": _G}, **_LR,
             "Moment1": {"m1": f32(4, 3) * 0.1},
             "Moment2": {"m2": pos(4, 3) * 0.01}, **_POWS}
CASES.update({
    "lars_momentum": ({"Param": {"p": _P}, "Grad": {"g": _G},
                       "Velocity": {"v": f32(4, 3)}, **_LR},
                      {"ParamOut": ["po"], "VelocityOut": ["vo"]},
                      {"mu": 0.9, "lars_coeff": 0.01,
                       "lars_weight_decay": 0.001}, ["po", "vo"]),
    "adamw": (_ADAM_INS, _ADAM_OUTS, {"weight_decay": 0.05},
              ["po", "m1o", "m2o", "b1o", "b2o"]),
    "lamb": (_ADAM_INS, _ADAM_OUTS, {"weight_decay": 0.05},
             ["po", "m1o", "m2o", "b1o", "b2o"]),
    "adagrad": ({"Param": {"p": _P}, "Grad": {"g": _G},
                 "Moment": {"m": pos(4, 3)}, **_LR},
                {"ParamOut": ["po"], "MomentOut": ["mo"]}, {},
                ["po", "mo"]),
    "decayed_adagrad": ({"Param": {"p": _P}, "Grad": {"g": _G},
                         "Moment": {"m": pos(4, 3)}, **_LR},
                        {"ParamOut": ["po"], "MomentOut": ["mo"]},
                        {"decay": 0.8}, ["po", "mo"]),
    "adadelta": ({"Param": {"p": _P}, "Grad": {"g": _G},
                  "AvgSquaredGrad": {"a": pos(4, 3)},
                  "AvgSquaredUpdate": {"u": pos(4, 3)}},
                 {"ParamOut": ["po"], "AvgSquaredGradOut": ["ao"],
                  "AvgSquaredUpdateOut": ["uo"]}, {"rho": 0.9},
                 ["po", "ao", "uo"]),
    "adamax": ({"Param": {"p": _P}, "Grad": {"g": _G}, **_LR,
                "Moment": {"m": f32(4, 3) * 0.1}, "InfNorm": {"n": pos(4, 3)},
                "Beta1Pow": {"b1p": np.float32([0.81])}},
               {"ParamOut": ["po"], "MomentOut": ["mo"],
                "InfNormOut": ["no"]}, {}, ["po", "mo", "no"]),
    "rmsprop": ({"Param": {"p": _P}, "Grad": {"g": _G},
                 "MeanSquare": {"ms": pos(4, 3)},
                 "MeanGrad": {"mg": f32(4, 3) * 0.1},
                 "Moment": {"mom": f32(4, 3) * 0.1}, **_LR},
                {"ParamOut": ["po"], "MomentOut": ["mo"],
                 "MeanSquareOut": ["mso"], "MeanGradOut": ["mgo"]},
                {"momentum": 0.5, "centered": True},
                ["po", "mo", "mso", "mgo"]),
    "ftrl": ({"Param": {"p": _P}, "SquaredAccumulator": {"sq": pos(4, 3)},
              "LinearAccumulator": {"lin": f32(4, 3)}, "Grad": {"g": _G},
              **_LR},
             {"ParamOut": ["po"], "SquaredAccumOut": ["sqo"],
              "LinearAccumOut": ["lino"]},
             {"l1": 0.1, "l2": 0.2, "lr_power": -0.5},
             ["po", "sqo", "lino"]),
    "average_accumulates": (
        {"Param": {"p": _P}, "InSum1": {"s1": f32(4, 3)},
         "InSum2": {"s2": f32(4, 3)}, "InSum3": {"s3": f32(4, 3)},
         "InNumAccumulates": {"na": np.array([3], np.int64)},
         "InOldNumAccumulates": {"ona": np.array([2], np.int64)},
         "InNumUpdates": {"nu": np.array([9], np.int64)}},
        {"OutSum1": ["s1o"], "OutSum2": ["s2o"], "OutSum3": ["s3o"],
         "OutNumAccumulates": ["nao"], "OutOldNumAccumulates": ["onao"],
         "OutNumUpdates": ["nuo"]},
        {"average_window": 0.5, "min_average_window": 2,
         "max_average_window": 4},
        ["s1o", "s2o", "s3o", "nao", "onao", "nuo"]),
})


# the rest of ops/tensor.py
_IDS = np.array([[3], [0], [3], [5]], np.int64)
CASES.update({
    "fill_constant_batch_size_like": (
        {"Input": {"x": f32(5, 3)}}, {"Out": ["o"]},
        {"shape": [-1, 4], "dtype": "int64", "value": 3.0,
         "input_dim_idx": 0, "output_dim_idx": 0}, ["o"]),
    "fill_zeros_like": _unary(f32(3, 4)),
    "assign_value": ({}, {"Out": ["o"]},
                     {"shape": [2, 3], "dtype": "float32",
                      "values": [0.5, -1.0, 2.0, 3.25, 0.0, 7.0]}, ["o"]),
    "shape": ({"Input": {"x": f32(2, 3, 5)}}, {"Out": ["o"]}, {}, ["o"]),
    "concat": ({"X": {"a": f32(2, 3), "b": f32(2, 5)}}, {"Out": ["o"]},
               {"axis": 1}, ["o"]),
    "split": ({"X": {"x": f32(2, 9)}}, {"Out": ["o1", "o2", "o3"]},
              {"sections": [2, 3, 4], "axis": 1}, ["o1", "o2", "o3"]),
    "squeeze2": ({"X": {"x": f32(2, 1, 3, 1)}},
                 {"Out": ["o"], "XShape": ["xs"]}, {"axes": [1, 2, -1]},
                 ["o"]),
    "stack": ({"X": {"a": f32(2, 3), "b": f32(2, 3)}}, {"Y": ["y"]},
              {"axis": 1}, ["y"]),
    "unstack": ({"X": {"x": f32(2, 3, 4)}}, {"Y": ["y1", "y2", "y3"]},
                {"axis": 1, "num": 3}, ["y1", "y2", "y3"]),
    "expand": _unary(f32(2, 1, 3), expand_times=[1, 4, 2]),
    "gather": ({"X": {"x": f32(6, 3)},
                "Index": {"i": np.array([5, 0, -1, 2, 5], np.int64)}},
               {"Out": ["o"]}, {}, ["o"]),
    "scatter": ({"X": {"x": f32(6, 3)},
                 "Ids": {"i": np.array([4, 1, -1], np.int64)},
                 "Updates": {"u": f32(3, 3)}},
                {"Out": ["o"]}, {"overwrite": True}, ["o"]),
    "one_hot": ({"X": {"x": np.array([[1], [4], [0], [7]], np.int64)}},
                {"Out": ["o"]}, {"depth": 5}, ["o"]),
    "lookup_table_v2": ({"W": {"w": f32(10, 4)}, "Ids": {"ids": _IDS}},
                        {"Out": ["o"]}, {"padding_idx": 0}, ["o"]),
    "arg_max": _unary(f32(3, 5), axis=1),
    "arg_min": _unary(f32(3, 5), axis=0),
    "argsort": ({"X": {"x": np.array([[3.0, 1.0, 3.0, 2.0, 1.0]],
                                     np.float32)}},
                {"Out": ["o"], "Indices": ["i"]}, {"descending": True},
                ["o", "i"]),
    "cumsum": _unary(f32(3, 5), axis=1, exclusive=True, reverse=True),
    "range": ({}, {"Out": ["o"]},
              {"start": 1.0, "end": 9.0, "step": 1.5, "dtype": "float32"},
              ["o"]),
    "flatten2": ({"X": {"x": f32(2, 3, 4)}},
                 {"Out": ["o"], "XShape": ["xs"]}, {"axis": 2}, ["o"]),
    "pad": _unary(f32(2, 3), paddings=[1, 0, 2, 3], pad_value=-1.5),
    "gather_nd": ({"X": {"x": f32(4, 5, 3)},
                   "Index": {"i": np.array([[1, 2], [3, -1], [0, 0]],
                                           np.int64)}},
                  {"Out": ["o"]}, {}, ["o"]),
    "scatter_nd_add": ({"X": {"x": f32(4, 5)},
                        "Index": {"i": np.array([[1, 2], [3, 4], [1, 2]],
                                                np.int64)},
                        "Updates": {"u": f32(3)}},
                       {"Out": ["o"]}, {}, ["o"]),
    "reverse": _unary(f32(2, 3, 4), axis=[0, 2]),
    "expand_as": ({"X": {"x": f32(2, 3)},
                   "target_tensor": {"t": f32(4, 6)}}, {"Out": ["o"]}, {},
                  ["o"]),
    "diag": ({"Diagonal": {"d": f32(4)}}, {"Out": ["o"]}, {}, ["o"]),
    "eye": ({}, {"Out": ["o"]}, {"num_rows": 3, "num_columns": 5}, ["o"]),
    "pad2d": _unary(f32(2, 3, 4, 5), paddings=[1, 2, 2, 1],
                    mode="reflect"),
    "roll": _unary(f32(3, 4), shifts=[1, -2], axis=[0, 1]),
    "shard_index": ({"X": {"x": np.array([[1], [6], [12], [19]],
                                         np.int64)}},
                    {"Out": ["o"]},
                    {"index_num": 20, "nshards": 3, "shard_id": 1},
                    ["o"]),
})

# the rest of ops/loss.py
_PROBS = np.random.RandomState(3).dirichlet(np.ones(5), 4).astype(
    np.float32)
CASES.update({
    "reduce_mean": _unary(f32(2, 3, 4), dim=[0, -1]),
    "reduce_max": _unary(f32(2, 3, 4), dim=[1], keep_dim=True),
    "reduce_min": _unary(f32(2, 3, 4), reduce_all=True),
    "reduce_prod": _unary(pos(2, 3, 4), dim=[0, 2]),
    "reduce_all": _unary(f32(2, 3, 4) > -1.0, dim=[1, 2]),
    "reduce_any": _unary(f32(2, 3, 4) > 1.0, dim=[0]),
    "cross_entropy": ({"X": {"x": _PROBS},
                       "Label": {"lb": np.array([[1], [-100], [4], [0]],
                                                np.int64)}},
                      {"Y": ["y"]}, {}, ["y"]),
    "sigmoid_cross_entropy_with_logits": (
        {"X": {"x": f32(4, 3) * 2},
         "Label": {"lb": np.array([[1, 0, -100], [0, 1, 1], [1, 1, 0],
                                   [0, 0, 1]], np.float32)}},
        {"Out": ["o"]}, {"normalize": True}, ["o"]),
    "square_error_cost": _binary(f32(4, 1), f32(4, 1)),
    "huber_loss": ({"X": {"x": f32(5, 1)}, "Y": {"y": f32(5, 1) * 2}},
                   {"Out": ["o"], "Residual": ["r"]}, {"delta": 0.8},
                   ["o", "r"]),
    "smooth_l1_loss": ({"X": {"x": f32(3, 4)}, "Y": {"y": f32(3, 4)},
                        "InsideWeight": {"iw": pos(3, 4)},
                        "OutsideWeight": {"ow": pos(3, 4)}},
                       {"Out": ["o"], "Diff": ["d"]}, {"sigma": 1.5},
                       ["o", "d"]),
    "log_loss": ({"Predicted": {"p": _PROBS[:, :1]},
                  "Labels": {"lb": np.array([[1.0], [0.0], [1.0], [0.0]],
                                            np.float32)}},
                 {"Loss": ["l"]}, {}, ["l"]),
    "auc": ({"Predict": {"p": np.random.RandomState(4).rand(16, 2)
                         .astype(np.float32)},
             "Label": {"lb": np.random.RandomState(5).randint(0, 2, (16, 1))
                       .astype(np.int64)},
             "StatPos": {"sp": np.zeros((1, 201), np.int64)},
             "StatNeg": {"sn": np.zeros((1, 201), np.int64)}},
            {"AUC": ["a"], "StatPosOut": ["spo"], "StatNegOut": ["sno"]},
            {"num_thresholds": 200}, ["a", "spo", "sno"]),
    "kldiv_loss": ({"X": {"x": np.log(_PROBS)},
                    "Target": {"t": np.where(_PROBS > 0.1, _PROBS, 0.0)
                               .astype(np.float32)}},
                   {"Loss": ["l"]}, {"reduction": "batchmean"}, ["l"]),
    "hinge_loss": ({"Logits": {"x": f32(4, 1)},
                    "Labels": {"lb": np.array([[1.0], [0.0], [1.0], [0.0]],
                                              np.float32)}},
                   {"Loss": ["l"]}, {}, ["l"]),
    "margin_rank_loss": ({"Label": {"lb": np.array([[1.0], [-1.0], [1.0]],
                                                   np.float32)},
                          "X1": {"a": f32(3, 1)}, "X2": {"b": f32(3, 1)}},
                         {"Out": ["o"], "Activated": ["act"]},
                         {"margin": 0.1}, ["o", "act"]),
    "rank_loss": ({"Label": {"lb": np.array([[1.0], [0.0], [0.5]],
                                            np.float32)},
                   "Left": {"a": f32(3, 1)}, "Right": {"b": f32(3, 1)}},
                  {"Out": ["o"]}, {}, ["o"]),
    "bpr_loss": ({"X": {"x": f32(4, 5)},
                  "Label": {"lb": np.array([[1], [4], [0], [2]],
                                           np.int64)}},
                 {"Y": ["y"]}, {}, ["y"]),
    "cos_sim": ({"X": {"x": f32(4, 6)}, "Y": {"y": f32(4, 6)}},
                {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {},
                ["o", "xn", "yn"]),
    "mean_iou": ({"Predictions": {"p": np.array([0, 1, 2, 2, 1, 0, 3],
                                                np.int64)},
                  "Labels": {"lb": np.array([0, 2, 2, 1, 1, 0, 0],
                                            np.int64)}},
                 {"OutMeanIou": ["m"], "OutWrong": ["w"],
                  "OutCorrect": ["c"]}, {"num_classes": 4},
                 ["m", "w", "c"]),
    "precision_recall": (
        {"MaxProbs": {"mp": _PROBS[:, :1]},
         "Indices": {"i": np.array([[0], [2], [1], [2]], np.int64)},
         "Labels": {"lb": np.array([[0], [1], [1], [2]], np.int64)},
         "Weights": {"w": pos(4, 1)},
         "StatesInfo": {"st": pos(3, 4)}},
        {"BatchMetrics": ["bm"], "AccumMetrics": ["am"],
         "AccumStatesInfo": ["ast"]}, {"class_number": 3},
        ["bm", "am", "ast"]),
})


def _build(program_cls, op_type, case):
    ins, outs, attrs, _ = case
    main = program_cls()
    blk = main.global_block
    for slot_vars in ins.values():
        for n, a in slot_vars.items():
            blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                           is_data=True)
    for names in outs.values():
        for n in names:
            if not blk.has_var(n):
                blk.create_var(name=n)
    blk.append_op(op_type,
                  inputs={s: list(v) for s, v in ins.items()},
                  outputs=outs, attrs=dict(attrs))
    return main


def _feed(case):
    return {n: a for slot_vars in case[0].values()
            for n, a in slot_vars.items()}


def _run_both(op_type, case):
    jmain = _build(JProgram, op_type, case)
    tmain = _build(TProgram, op_type, case)
    fetch = case[3]
    jout = fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed=_feed(case), fetch_list=fetch, scope=fluid.Scope())
    tout = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=_feed(case), fetch_list=fetch, scope=tfluid.Scope())
    return jmain, tmain, jout, tout


RANDOM_OPS = {"truncated_gaussian_random", "dropout", "uniform_random",
              "gaussian_random", "uniform_random_batch_size_like",
              "gaussian_random_batch_size_like"}
# ops that run a sub-block: checked by the programs that build them
# (conditional_block: the AMP skip-update, tests/test_torch_amp.py;
# recompute_segment: gradient checkpointing, tests/test_torch_remat.py;
# pipeline: layers.PipelineRegion, tests/test_torch_pipeline.py)
BLOCK_OPS = {"conditional_block", "recompute_segment", "pipeline"}
# while, recurrent, the tensor arrays and beam search: checked by the
# programs of tests/test_torch_control_flow.py and tests/test_torch_seq2seq.py
CONTROL_FLOW_OPS = {"while", "recurrent", "create_array", "write_to_array",
                    "read_from_array", "lod_array_length",
                    "tensor_array_to_tensor", "beam_search",
                    "beam_search_decode"}
# the LoD ops (ops/sequence_ops.py, ops/misc2.py, ops/rnn_ops.py,
# ops/structured.py): checked, forward and gradient, by the cases of
# tests/test_torch_sequence_ops.py, tests/test_torch_rnn_ops.py and
# tests/test_torch_structured.py
LOD_OPS = {"sequence_pool", "sequence_softmax", "sequence_reverse",
           "sequence_expand", "sequence_concat", "sequence_pad",
           "sequence_unpad", "sequence_slice", "sequence_erase",
           "sequence_enumerate", "sequence_conv", "sequence_mask",
           "sequence_reshape", "sequence_expand_as", "sequence_scatter",
           "lstm", "lstmp", "gru", "gru_unit", "cudnn_lstm", "warpctc",
           "linear_chain_crf", "crf_decoding", "nce",
           "hierarchical_sigmoid", "edit_distance", "ctc_align",
           "chunk_eval"}


# the nn group (ops/nn.py): checked, forward and gradient, by the cases
# of tests/test_torch_nn_group.py
NN_GROUP_OPS = {"conv2d_transpose", "group_norm", "instance_norm",
                "l2_normalize", "prelu", "interpolate_nearest",
                "bilinear_interp"}
# the SelectedRows utilities (ops/misc2.py): their input is a sparse
# gradient, checked by the programs of tests/test_torch_selected_rows.py
SPARSE_OPS = {"merge_selected_rows", "get_tensor_from_selected_rows"}
# the misc group (ops/misc.py) and the image group (ops/image.py):
# checked, forward and gradient, by the cases of
# tests/test_torch_misc_ops.py and tests/test_torch_image_ops.py
MISC_OPS = {"linspace", "fill", "fill_any_like", "fill_zeros_like2", "size",
            "is_empty", "one_hot_v2", "multiplex", "strided_slice", "minus",
            "l1_norm", "norm", "squared_l2_distance",
            "bilinear_tensor_product", "fsp", "modified_huber_loss",
            "teacher_student_sigmoid_loss", "cross_entropy2",
            "label_smooth", "center_loss", "add_position_encoding",
            "row_conv", "conv_shift", "cvm", "data_norm", "hash", "unique",
            "unique_with_counts", "spectral_norm", "tree_conv",
            "similarity_focus", "random_crop", "sampling_id"}
IMAGE_OPS = {"pixel_shuffle", "affine_channel", "shuffle_channel",
             "space_to_depth", "temporal_shift", "crop", "crop_tensor",
             "pad_constant_like", "unfold", "im2sequence", "lrn", "spp",
             "max_pool2d_with_index", "unpool", "affine_grid",
             "grid_sampler", "conv3d", "conv3d_transpose", "pool3d",
             "trilinear_interp"}


# the detection ops and the rest of misc2, each against the JAX rule in
# tests/test_torch_detection.py and tests/test_torch_misc2_tail.py
DETECTION_OPS = {"prior_box", "anchor_generator", "iou_similarity",
                 "box_coder", "box_clip", "yolo_box", "multiclass_nms",
                 "roi_align", "roi_pool", "generate_proposals",
                 "distribute_fpn_proposals", "collect_fpn_proposals",
                 "deformable_conv", "deformable_psroi_pooling",
                 "prroi_pool", "psroi_pool", "py_func",
                 "sampled_softmax_with_cross_entropy"}
# the fake-quant ops, each against the JAX rule, forward and gradient, in
# tests/test_torch_slim.py
QUANT_OPS = {"fake_quantize_dequantize_abs_max",
             "fake_quantize_dequantize_moving_average_abs_max"}


def test_every_path_op_has_a_case():
    """Every op type of the port but the random ones (checked by
    distribution: here, in tests/test_torch_train.py and
    tests/test_torch_mlp.py), the sub-block ones, the control-flow ones,
    the LoD ones, the nn group, the SelectedRows utilities, the misc and
    image groups, the detection ops and the fake-quant ops has a case."""
    from paddle_tpu_torch.core import registry
    from test_torch_lod import builtin_ops

    others = (RANDOM_OPS | BLOCK_OPS | CONTROL_FLOW_OPS | LOD_OPS
              | NN_GROUP_OPS | SPARSE_OPS | MISC_OPS | IMAGE_OPS
              | DETECTION_OPS | QUANT_OPS)
    assert len(CASES) == 169 and not others & set(CASES)
    assert set(CASES) | others == builtin_ops(registry, "paddle_tpu_torch")


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax_rule(op_type):
    case = CASES[op_type]
    jmain, tmain, jout, tout = _run_both(op_type, case)
    for n, a, b in zip(case[3], tout, jout):
        assert a.shape == np.asarray(b).shape, n
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype),
                                          err_msg=n)
        else:
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4,
                                       err_msg=n)
        jv, tv = jmain.global_block.var(n), tmain.global_block.var(n)
        assert tv.shape == jv.shape, n


def test_truncated_gaussian_random_distribution_and_seeding():
    """Bits differ from jax.random; the distribution is the same: values
    in mean +- 2 std, moments of the truncated normal, and a fixed seed
    reproduces the draw."""
    def draw(seed):
        main = TProgram()
        main.random_seed = seed
        main.global_block.create_var(name="o")
        main.global_block.append_op(
            "truncated_gaussian_random", outputs={"Out": ["o"]},
            attrs={"shape": [200, 100], "mean": 1.0, "std": 0.5})
        return tfluid.Executor(tfluid.CPUPlace()).run(
            main, fetch_list=["o"], scope=tfluid.Scope())[0]

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == (200, 100) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0.0 and a.max() <= 2.0
    # truncated at +-2 sigma: std is 0.8796 sigma
    assert abs(a.mean() - 1.0) < 0.01
    assert abs(a.std() - 0.5 * 0.8796) < 0.01


def test_sample_token_sample_support_and_determinism():
    logits = f32(4, 16)

    def draws(seed):
        main = TProgram()
        main.random_seed = seed
        blk = main.global_block
        blk.create_var(name="lg", shape=(4, 16), dtype="float32",
                       is_data=True)
        blk.create_var(name="o")
        blk.append_op("sample_token", inputs={"Logits": ["lg"]},
                      outputs={"Out": ["o"]},
                      attrs={"strategy": "sample", "temperature": 0.7,
                             "top_k": 3})
        exe = tfluid.Executor(tfluid.CPUPlace())
        return np.stack([exe.run(main, feed={"lg": logits}, fetch_list=["o"],
                                 scope=tfluid.Scope())[0].ravel()
                         for _ in range(8)])

    a, b = draws(7), draws(7)
    np.testing.assert_array_equal(a, b)
    top3 = np.argsort(logits, -1)[:, -3:]
    for row in a:
        for i in range(4):
            assert row[i] in top3[i]
    assert len({tuple(r) for r in a}) > 1      # steps draw afresh


@pytest.mark.parametrize("op_type,attrs,moments", [
    ("uniform_random_batch_size_like", {"min": -0.5, "max": 1.5},
     (0.5, 2.0 / np.sqrt(12.0))),
    ("gaussian_random_batch_size_like", {"mean": 1.0, "std": 0.5},
     (1.0, 0.5))])
def test_random_batch_size_like_distribution_and_seeding(op_type, attrs,
                                                         moments):
    """The batch dim comes from Input (dim 1 here, into dim 0), the bits
    from the op's generator (they differ from jax.random's): a fixed
    program seed repeats the draw, another seed changes it, and the
    moments are the distribution's."""
    def draw(seed):
        main = TProgram()
        main.random_seed = seed
        blk = main.global_block
        blk.create_var(name="x", shape=(3, 400), dtype="float32",
                       is_data=True)
        blk.create_var(name="o")
        blk.append_op(op_type, inputs={"Input": ["x"]},
                      outputs={"Out": ["o"]},
                      attrs=dict(attrs, shape=[-1, 50], input_dim_idx=1,
                                 output_dim_idx=0))
        return tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed={"x": np.zeros((3, 400), np.float32)},
            fetch_list=["o"], scope=tfluid.Scope())[0]

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == (400, 50) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert abs(a.mean() - moments[0]) < 0.02
    assert abs(a.std() - moments[1]) < 0.02
    if op_type.startswith("uniform"):
        assert a.min() >= -0.5 and a.max() < 1.5


# ------------------------------------------------------ integer inputs
# every ported rule that takes an integer input, on int32: the declared
# output dtype (to_dict(), int32 NOT read as int64 here), the value's
# dtype and the values equal the JAX package's. reduce_mean/mean follow
# jnp.mean's promotion (float32); reduce_sum/reduce_prod/cumsum keep
# int32. argsort's and top_k's int64 indices are the port's by design
# (the reference runs with 64-bit types off): their values are compared
# as int64, their Out as the rest.
INT_X = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
INT_Y = np.arange(2, 14, dtype=np.int32).reshape(3, 4)
INT_CASES = {
    "reduce_mean": lambda L, x, y: [L.reduce_mean(x, dim=1)],
    "reduce_mean_all": lambda L, x, y: [L.reduce_mean(x)],
    "mean": lambda L, x, y: [L.mean(x)],
    "reduce_prod": lambda L, x, y: [L.reduce_prod(x, dim=1)],
    "cumsum": lambda L, x, y: [L.cumsum(x, axis=1)],
    "cumsum_exclusive_reverse": lambda L, x, y: [
        L.cumsum(x, axis=0, exclusive=True, reverse=True)],
    "reduce_sum": lambda L, x, y: [L.reduce_sum(x, dim=[0, 1])],
    "reduce_max": lambda L, x, y: [L.reduce_max(x, dim=0)],
    "reduce_min": lambda L, x, y: [L.reduce_min(x, dim=1, keep_dim=True)],
    "scale": lambda L, x, y: [L.scale(x, scale=2.0, bias=1.0)],
    "elementwise": lambda L, x, y: [
        L.elementwise_add(x, y), L.elementwise_sub(x, y),
        L.elementwise_mul(x, y), L.elementwise_div(x, y),
        L.elementwise_min(x, y), L.elementwise_max(x, y),
        L.elementwise_mod(y, x), L.elementwise_floordiv(y, x)],
    "cast": lambda L, x, y: [L.cast(x, "float32"),
                             L.cast(L.cast(x, "float32"), "int32")],
    "one_hot": lambda L, x, y: [L.one_hot(
        L.reshape(L.elementwise_mod(x, y), [-1, 1]), depth=14)],
    "gather": lambda L, x, y: [L.gather(x, L.reshape(
        L.slice(x, axes=[0, 1], starts=[0, 0], ends=[1, 2]), [2]))],
    "argsort": lambda L, x, y: list(L.argsort(
        L.elementwise_mod(y, x), axis=1)),
    "topk": lambda L, x, y: list(L.topk(L.elementwise_mod(y, x), k=2)),
    "unique": lambda L, x, y: list(L.unique(
        L.reshape(L.elementwise_mod(y, x), [-1]))),
    "unique_with_counts": lambda L, x, y: list(L.unique_with_counts(
        L.reshape(L.elementwise_mod(y, x), [-1]))),
    "hash": lambda L, x, y: [L.hash(x, hash_size=97)],
    "strided_slice": lambda L, x, y: [L.strided_slice(
        x, axes=[1], starts=[3], ends=[0], strides=[-2])],
    "crop": lambda L, x, y: [L.crop(x, shape=[2, 3], offsets=[1, 1])],
    "multiplex": lambda L, x, y: [L.multiplex([x, y], L.slice(
        L.elementwise_mod(y, x), axes=[1], starts=[0], ends=[1]))],
}
# outputs whose int64 dtype is the port's by design
INT64_BY_DESIGN = {("argsort", 1), ("topk", 1), ("hash", 0)}


def _int_program(pkg, case):
    fl = tfluid if pkg == "torch" else fluid
    un = __import__(fl.__name__ + ".unique_name", fromlist=["guard"])
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[3, 4], dtype="int32",
                               append_batch_size=False)
            y = fl.layers.data("y", shape=[3, 4], dtype="int32",
                               append_batch_size=False)
            outs = INT_CASES[case](fl.layers, x, y)
    return main, [o.name for o in outs]


def _raw_dict(prog):
    d = prog.to_dict()
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


@pytest.mark.parametrize("case", sorted(INT_CASES))
def test_int32_input_keeps_the_jax_dtype_and_values(case):
    (jmain, names), (tmain, tnames) = (_int_program("jax", case),
                                       _int_program("torch", case))
    assert names == tnames
    jd, td = _raw_dict(jmain), _raw_dict(tmain)
    by_design = {names[i] for c, i in INT64_BY_DESIGN if c == case}
    for d in (jd, td):
        for v in d["blocks"][0]["vars"]:
            if v["name"] in by_design:
                v["dtype"] = "int64"
    assert td == jd
    feed = {"x": INT_X, "y": INT_Y}
    jout = fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=names, scope=fluid.Scope())
    tout = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=names, scope=tfluid.Scope())
    for i, (n, a, b) in enumerate(zip(names, tout, jout)):
        b = np.asarray(b)
        assert a.shape == b.shape, n
        if (case, i) in INT64_BY_DESIGN:
            assert a.dtype == np.int64, n
            np.testing.assert_array_equal(a, b.astype(np.int64), err_msg=n)
            continue
        assert a.dtype == b.dtype, (n, a.dtype, b.dtype)
        assert str(a.dtype) == tmain.global_block.var(n).dtype, n
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=n)
