"""The image group of the op library in the port (``ops/image.py``, every
op type of it) against the JAX package's rules, on the CPU.

Each case is a single-op program built the same way in both packages
from numpy inputs made with a seed (``test_torch_sequence_ops.run_op_case``):
the outputs and the gradients of a random cotangent pulled back through
``gradients`` agree within f32 rtol 1e-5, atol 1e-5 (the 3-D
convolutions rtol 1e-4: cuDNN's and oneDNN's sums run in another order
than XLA's), integer outputs exactly, and so do the build-time shapes.
The edges have cases of their own: ``grid_sampler`` in both modes, the
three padding modes and ``align_corners`` either way at points off the
integer lattice and off the image; ``max_pool2d_with_index`` and
``pool3d`` on ties and with padding; ``pool3d`` exclusive, ``ceil_mode``
and ``adaptive`` (both ignored by the reference) and global;
``trilinear_interp`` up, down and mixed, with ``align_corners`` either
way. Ops that read a shape from a fed tensor are held against the JAX
rule called eagerly (``test_torch_misc_ops.run_eager_case``).
"""
import numpy as np
import pytest

from test_torch_misc_ops import run_eager_case
from test_torch_ops import IMAGE_OPS
from test_torch_sequence_ops import assert_case_matches, f32, ints, \
    run_op_case

RTOL, ATOL = 1e-5, 1e-5
CONV_TOL = (1e-4, 1e-5)


def tied(*shape, seed=0, hi=3):
    """Small integers as float32: windows with tied maxima."""
    return ints(hi, *shape, seed=seed).astype(np.float32)


def pool_mask(n, c, h, w, seed):
    """A max_pool2d_with_index 2x2/2 mask of an [n, c, 2h, 2w] input:
    one flattened offset of each window, none repeated."""
    rng = np.random.RandomState(seed)
    di, dj = rng.randint(0, 2, (2, n, c, h, w))
    rows = 2 * np.arange(h)[:, None] + di
    cols = 2 * np.arange(w)[None, :] + dj
    return (rows * 2 * w + cols).astype(np.int32)


# case id -> (op type, ins, outs, attrs, outputs to differentiate)
CASES = {
    "pixel_shuffle": (
        "pixel_shuffle", {"X": [("x", f32(2, 8, 3, 4, seed=1))]},
        {"Out": ["o"]}, {"upscale_factor": 2}, ["o"]),
    "affine_channel": (
        "affine_channel", {"X": [("x", f32(2, 3, 4, 5, seed=2))],
                           "Scale": [("s", f32(3, seed=3))],
                           "Bias": [("b", f32(3, seed=4))]},
        {"Out": ["o"]}, {}, ["o"]),
    "affine_channel_nhwc": (
        "affine_channel", {"X": [("x", f32(2, 4, 5, 3, seed=5))],
                           "Scale": [("s", f32(3, seed=6))],
                           "Bias": [("b", f32(3, seed=7))]},
        {"Out": ["o"]}, {"data_layout": "NHWC"}, ["o"]),
    "shuffle_channel": (
        "shuffle_channel", {"X": [("x", f32(2, 6, 3, 4, seed=8))]},
        {"Out": ["o"]}, {"group": 3}, ["o"]),
    "space_to_depth": (
        "space_to_depth", {"X": [("x", f32(2, 3, 4, 6, seed=9))]},
        {"Out": ["o"]}, {"blocksize": 2}, ["o"]),
    "temporal_shift": (
        "temporal_shift", {"X": [("x", f32(6, 8, 3, 3, seed=10))]},
        {"Out": ["o"]}, {"seg_num": 3, "shift_ratio": 0.25}, ["o"]),
    "temporal_shift_odd": (
        "temporal_shift", {"X": [("x", f32(8, 10, 2, 2, seed=11))]},
        {"Out": ["o"]}, {"seg_num": 4, "shift_ratio": 0.2}, ["o"]),
    "crop": (
        "crop", {"X": [("x", f32(4, 5, 6, seed=12))]}, {"Out": ["o"]},
        {"shape": [2, 3, 4], "offsets": [1, 1, 2]}, ["o"]),
    "crop_like_y": (
        "crop", {"X": [("x", f32(4, 5, 6, seed=13))],
                 "Y": [("y", f32(3, 5, 2, seed=14))]}, {"Out": ["o"]},
        {"offsets": [1, 0, 3]}, ["o"]),
    "crop_tensor": (
        "crop_tensor", {"X": [("x", f32(4, 5, 6, seed=15))]},
        {"Out": ["o"]}, {"shape": [3, 2, 6], "offsets": [0, 3, 0]}, ["o"]),
    "pad_constant_like": (
        "pad_constant_like", {"X": [("x", f32(4, 5, 6, seed=16))],
                              "Y": [("y", f32(2, 3, 6, seed=17))]},
        {"Out": ["o"]}, {"pad_value": 1.5}, ["o"]),
    "unfold": (
        "unfold", {"X": [("x", f32(2, 3, 6, 7, seed=18))]}, {"Y": ["o"]},
        {"kernel_sizes": [2, 3], "strides": [2, 1],
         "paddings": [1, 0, 0, 1], "dilations": [1, 2]}, ["o"]),
    "unfold_two_pads": (
        "unfold", {"X": [("x", f32(1, 2, 5, 5, seed=19))]}, {"Y": ["o"]},
        {"kernel_sizes": [3, 3], "strides": [1, 1], "paddings": [1, 1],
         "dilations": [1, 1]}, ["o"]),
    "im2sequence": (
        "im2sequence", {"X": [("x", f32(2, 3, 5, 6, seed=20))]},
        {"Out": ["o"]},
        {"kernels": [2, 2], "strides": [1, 2], "paddings": [0, 1, 1, 0]},
        ["o"]),
    "lrn": (
        "lrn", {"X": [("x", f32(2, 7, 3, 4, seed=21))]},
        {"Out": ["o"], "MidOut": ["m"]},
        {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, ["o"]),
    "lrn_narrow": (
        "lrn", {"X": [("x", f32(1, 3, 2, 2, seed=22))]},
        {"Out": ["o"], "MidOut": ["m"]},
        {"n": 3, "k": 1.0, "alpha": 0.5, "beta": 0.5}, ["o", "m"]),
    "spp_max": (
        "spp", {"X": [("x", f32(2, 3, 7, 9, seed=23))]}, {"Out": ["o"]},
        {"pyramid_height": 3, "pooling_type": "max"}, ["o"]),
    "spp_max_ties": (
        "spp", {"X": [("x", tied(2, 2, 4, 4, seed=24))]}, {"Out": ["o"]},
        {"pyramid_height": 2, "pooling_type": "max"}, ["o"]),
    "spp_avg": (
        "spp", {"X": [("x", f32(2, 3, 7, 9, seed=25))]}, {"Out": ["o"]},
        {"pyramid_height": 3, "pooling_type": "avg"}, ["o"]),
    "max_pool2d_with_index": (
        "max_pool2d_with_index", {"X": [("x", f32(2, 3, 6, 8, seed=26))]},
        {"Out": ["o"], "Mask": ["m"]}, {}, ["o"]),
    "max_pool2d_with_index_ties_pad": (
        "max_pool2d_with_index", {"X": [("x", tied(2, 3, 7, 6, seed=27))]},
        {"Out": ["o"], "Mask": ["m"]},
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, ["o"]),
    "max_pool2d_with_index_negative_pad": (
        "max_pool2d_with_index",
        {"X": [("x", -np.abs(f32(1, 2, 5, 5, seed=28)) - 1.0)]},
        {"Out": ["o"], "Mask": ["m"]},
        {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1]}, ["o"]),
    "max_pool2d_with_index_global": (
        "max_pool2d_with_index", {"X": [("x", tied(2, 2, 3, 4, seed=29))]},
        {"Out": ["o"], "Mask": ["m"]}, {"global_pooling": True}, ["o"]),
    "unpool": (
        "unpool", {"X": [("x", f32(2, 3, 3, 4, seed=30))],
                   "Indices": [("i", pool_mask(2, 3, 3, 4, seed=31))]},
        {"Out": ["o"]}, {"ksize": [2, 2], "strides": [2, 2]}, ["o"]),
    "affine_grid": (
        "affine_grid", {"Theta": [("t", f32(2, 2, 3, seed=32))]},
        {"Output": ["o"]}, {"output_shape": [2, 3, 5, 7]}, ["o"]),
    "affine_grid_half_pixel": (
        "affine_grid", {"Theta": [("t", f32(2, 2, 3, seed=33))]},
        {"Output": ["o"]},
        {"output_shape": [2, 3, 4, 6], "align_corners": False}, ["o"]),
    "conv3d": (
        "conv3d", {"Input": [("x", f32(2, 3, 4, 5, 6, seed=34))],
                   "Filter": [("w", f32(4, 3, 3, 3, 3, seed=35))]},
        {"Output": ["o"]}, {"paddings": [1, 1, 1]}, ["o"]),
    "conv3d_groups_bias": (
        "conv3d", {"Input": [("x", f32(2, 4, 5, 6, 7, seed=36))],
                   "Filter": [("w", f32(6, 2, 3, 3, 2, seed=37))],
                   "Bias": [("b", f32(6, seed=38))]},
        {"Output": ["o"]},
        {"strides": [1, 2, 1], "paddings": [1, 1, 0],
         "dilations": [1, 1, 2], "groups": 2}, ["o"]),
    "conv3d_transpose": (
        "conv3d_transpose", {"Input": [("x", f32(2, 3, 3, 4, 4, seed=39))],
                             "Filter": [("w", f32(3, 4, 2, 2, 2, seed=40))],
                             "Bias": [("b", f32(4, seed=41))]},
        {"Output": ["o"]}, {"strides": [2, 2, 2]}, ["o"]),
    "conv3d_transpose_pad_dil": (
        "conv3d_transpose", {"Input": [("x", f32(1, 2, 3, 4, 3, seed=42))],
                             "Filter": [("w", f32(2, 3, 3, 3, 2, seed=43))]},
        {"Output": ["o"]},
        {"strides": [2, 1, 2], "paddings": [1, 0, 1],
         "dilations": [1, 2, 1]}, ["o"]),
}
for _pad in ("zeros", "border", "reflection"):
    for _mode in ("bilinear", "nearest"):
        for _ac in (True, False):
            CASES[f"grid_sampler_{_mode}_{_pad}_ac{int(_ac)}"] = (
                "grid_sampler",
                {"X": [("x", f32(2, 3, 5, 6, seed=44))],
                 "Grid": [("g", f32(2, 4, 5, 2, seed=45, scale=0.8))]},
                {"Output": ["o"]},
                {"mode": _mode, "padding_mode": _pad, "align_corners": _ac},
                ["o"])
POOL3D = {
    "max": {"pooling_type": "max"},
    "max_ties_pad": {"pooling_type": "max", "ksize": [3, 3, 3],
                     "strides": [2, 2, 2], "paddings": [1, 1, 1]},
    "max_overlap": {"pooling_type": "max", "ksize": [1, 3, 3],
                    "strides": [1, 2, 1]},
    "avg": {"pooling_type": "avg", "ksize": [2, 3, 2],
            "strides": [1, 2, 2]},
    "avg_exclusive_pad": {"pooling_type": "avg", "ksize": [3, 3, 3],
                          "strides": [2, 1, 2], "paddings": [1, 1, 1]},
    "avg_inclusive_pad": {"pooling_type": "avg", "ksize": [3, 3, 3],
                          "strides": [2, 1, 2], "paddings": [1, 1, 1],
                          "exclusive": False},
    "avg_ceil_mode": {"pooling_type": "avg", "ksize": [2, 2, 2],
                      "strides": [2, 2, 2], "ceil_mode": True},
    "max_adaptive": {"pooling_type": "max", "ksize": [2, 2, 2],
                     "adaptive": True},
    "avg_global": {"pooling_type": "avg", "global_pooling": True},
    "max_global": {"pooling_type": "max", "global_pooling": True},
}
for _name, _attrs in POOL3D.items():
    CASES[f"pool3d_{_name}"] = (
        "pool3d", {"X": [("x", tied(2, 2, 5, 6, 7, seed=46, hi=4))]},
        {"Out": ["o"]}, _attrs, ["o"])
# (out_d, out_h, out_w) of a [2, 2, 4, 5, 6] input: up, down, mixed,
# one axis to a single point
for _size in [(8, 10, 12), (2, 3, 4), (6, 5, 3), (1, 7, 6)]:
    for _ac in (True, False):
        CASES[f"trilinear_{'x'.join(map(str, _size))}_ac{int(_ac)}"] = (
            "trilinear_interp", {"X": [("x", f32(2, 2, 4, 5, 6, seed=47))]},
            {"Out": ["o"]},
            {"out_d": _size[0], "out_h": _size[1], "out_w": _size[2],
             "align_corners": _ac}, ["o"])
TOLS = {k: CONV_TOL for k in CASES if k.startswith("conv3d")}

# ops that read a shape or an offset from a fed tensor
EAGER_CASES = {
    "crop_offsets_tensor": (
        "crop", {"X": [("x", f32(4, 5, 6, seed=48))],
                 "Offsets": [("f", np.array([2, 1, 0], np.int32))]},
        {"Out": ["o"]}, {"shape": [2, 4, 5]}),
    "crop_tensor_shape_tensor": (
        "crop_tensor", {"X": [("x", f32(4, 5, 6, seed=49))],
                        "Shape": [("s", np.array([1, 5, 3], np.int32))]},
        {"Out": ["o"]}, {"offsets": [3, 0, 2]}),
    "affine_grid_shape_tensor": (
        "affine_grid", {"Theta": [("t", f32(2, 2, 3, seed=50))],
                        "OutputShape": [("s", np.array([2, 3, 4, 5],
                                                       np.int32))]},
        {"Output": ["o"]}, {"align_corners": True}),
    "trilinear_out_size_tensor": (
        "trilinear_interp", {"X": [("x", f32(1, 2, 3, 4, 5, seed=51))],
                             "OutSize": [("s", np.array([5, 2, 7],
                                                        np.int32))]},
        {"Out": ["o"]}, {"align_corners": False}),
}


def test_every_op_type_of_the_group_has_cases():
    from paddle_tpu_torch.core import registry

    assert {c[0] for c in CASES.values()} == IMAGE_OPS
    assert len(IMAGE_OPS) == 20 and IMAGE_OPS <= set(registry.all_ops())


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grad_match_jax(case):
    op, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op, ins, outs, attrs, grad_outs)
    assert_case_matches(got, shapes, *TOLS.get(case, (RTOL, ATOL)))
    assert any(n.startswith("grad:") for n in got["torch"])


@pytest.mark.parametrize("case", sorted(EAGER_CASES))
def test_host_read_op_matches_the_eager_jax_rule(case):
    got = run_eager_case(*EAGER_CASES[case])
    assert_case_matches(got, {"jax": {}, "torch": {}})


def test_the_mask_is_the_first_maximum_and_never_padding():
    """On ties the mask names the first maximum of the window in
    row-major order; with padding it names an unpadded position; unpool
    scatters the pooled values back there."""
    x = tied(1, 1, 5, 5, seed=52, hi=2)
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1]}
    got, _ = run_op_case("max_pool2d_with_index", {"X": [("x", x)]},
                         {"Out": ["o"], "Mask": ["m"]}, attrs)
    t = got["torch"]
    flat = x.reshape(-1)
    assert (t["m"] >= 0).all() and (t["m"] < 25).all()
    np.testing.assert_array_equal(flat[t["m"]], t["o"])
    for i in range(3):
        for j in range(3):
            rows = [r for r in (2 * i - 1, 2 * i) if 0 <= r < 5]
            cols = [c for c in (2 * j - 1, 2 * j) if 0 <= c < 5]
            cand = [r * 5 + c for r in rows for c in cols]
            best = max(flat[cand])
            assert t["m"][0, 0, i, j] == next(
                p for p in cand if flat[p] == best)
    up, _ = run_op_case("unpool", {"X": [("x", t["o"])],
                                   "Indices": [("i", t["m"])]},
                        {"Out": ["o"]}, {"ksize": [2, 2], "strides": [2, 2],
                                         "paddings": [1, 1]})
    assert up["torch"]["o"].shape == (1, 1, 4, 4)
    np.testing.assert_array_equal(up["torch"]["o"], up["jax"]["o"])
