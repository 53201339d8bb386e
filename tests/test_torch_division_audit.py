"""The division audit of the port's op rules, on the CPU: each rule that
divides by a Python number before a floor, a bin bound or a fractional
coordinate divides by a 0-dim tensor (``ops.common.true_div``), a true
division on the card too (where a division by a Python number is a
product with the reciprocal, up to an ulp off). Here each site's result
is held to exact arithmetic on shapes whose quotients sit on integers or
near them; ``tests/test_torch_cuda.py`` holds the card to the CPU on the
same sites, exactly.

* ``ops/nn.py`` ``_nearest_index`` (``interpolate_nearest``, YOLOv3's
  upsample): floor((i + 0.5) * m / n) for every m, n up to 64;
* ``ops/misc.py`` ``linspace_f32`` with an integer dtype, and through the
  ``linspace`` op: the floor of ``jnp.linspace``'s float32 formula, each
  step correctly rounded;
* ``ops/image.py`` ``trilinear_interp`` with ``align_corners``: taps on
  integer positions give the input's samples exactly;
* ``ops/misc2.py`` ``psroi_pool``: bins of whole pixels average exactly
  the pixels a loop picks (its bin sizes were true divisions already)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.lowering import LowerCtx
from paddle_tpu_torch.ops import common, detection
from paddle_tpu_torch.ops.misc import linspace_f32
from paddle_tpu_torch.ops.nn import _nearest_index

SIZES = range(1, 65)


def _rule(op_type, ins, attrs):
    opdef = registry.get_op_def(op_type)
    attrs = dict({k: a.default for k, a in opdef.attrs.items()}, **attrs)
    return opdef.lower(LowerCtx("cpu", seed=1, uid=1), ins, attrs)


def test_true_div_lives_in_common_and_stays_importable():
    assert detection.true_div is common.true_div
    x = torch.tensor([3.0, 9.0, 15.0])
    assert torch.equal(common.true_div(x, 3), torch.tensor([1.0, 3.0, 5.0]))
    assert common.true_div(x, 3).dtype == torch.float32


@pytest.mark.parametrize("m", [1, 2, 3, 5, 6, 7, 9, 13, 19, 25, 38, 64])
def test_nearest_index_is_the_exact_floor(m):
    for n in SIZES:
        want = [min(((2 * i + 1) * m) // (2 * n), m - 1) for i in range(n)]
        assert _nearest_index(m, n, "cpu").tolist() == want, (m, n)


def test_nearest_resize_picks_the_exact_rows():
    x = torch.arange(6 * 9, dtype=torch.float32).reshape(1, 1, 6, 9)
    (out,) = _rule("interpolate_nearest", {"X": [x]},
                   {"out_h": 3, "out_w": 6})["Out"]
    # (6 -> 3): rows 1, 3, 5; (9 -> 6): columns 0, 2, 3, 5, 6, 8
    assert torch.equal(out[0, 0], x[0, 0][[1, 3, 5]][:, [0, 2, 3, 5, 6, 8]])


LINSPACE = [(0, 12, 4), (3, 33, 7), (-10, 20, 4), (0, 100, 11), (5, 5, 3),
            (0, 6, 7), (-7, 7, 15), (0, 1000, 26), (1, 50, 50), (9, 0, 4)]


def _linspace_f32(start, stop, num):
    """``jnp.linspace``'s float32 values (the JAX package's semantics),
    each operation correctly rounded by numpy: start * (1 - t) + stop * t
    with t = i / (num - 1), the endpoint ``stop``."""
    st, sp = np.float32(start), np.float32(stop)
    t = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    return np.concatenate([st * (np.float32(1) - t) + sp * t, [sp]])


@pytest.mark.parametrize("start,stop,num", LINSPACE)
def test_integer_linspace_is_exact(start, stop, num):
    """The floor of the float32 formula, exactly; where the formula's
    products land on integers (a start of 0 and a stop that the step
    divides) that is the exact integer sequence."""
    want = np.floor(_linspace_f32(start, stop, num)).astype(np.int64)
    if start == 0 and stop % (num - 1) == 0:
        assert want.tolist() == [stop // (num - 1) * i for i in range(num)]
    for dt in (torch.int64, torch.int32):
        got = linspace_f32(start, stop, num, "cpu", dt)
        assert got.dtype == dt and got.tolist() == want.tolist()
    ins = {"Start": [torch.tensor([float(start)])],
           "Stop": [torch.tensor([float(stop)])],
           "Num": [torch.tensor([num], dtype=torch.int32)]}
    (out,) = _rule("linspace", ins, {"dtype": "int64"})["Out"]
    assert out.tolist() == want.tolist()
    np.testing.assert_array_equal(
        linspace_f32(start, stop, num, "cpu").numpy(),
        _linspace_f32(start, stop, num))


def test_trilinear_align_corners_taps_integer_positions_exactly():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 5, 7, 9, generator=g)
    (out,) = _rule("trilinear_interp", {"X": [x]},
                   {"out_d": 3, "out_h": 4, "out_w": 5,
                    "align_corners": True})["Out"]
    assert torch.equal(out, x[:, :, ::2, ::2, ::2])
    # 13 -> 5 steps by 3
    y = torch.randn(1, 1, 13, 4, 4, generator=g)
    (out,) = _rule("trilinear_interp", {"X": [y]},
                   {"out_d": 5, "out_h": 4, "out_w": 4,
                    "align_corners": True})["Out"]
    assert torch.equal(out, y[:, :, ::3])


def psroi_case(seed=0):
    """Integer pixels and RoIs of whole-pixel bins: (inputs, attrs)."""
    rng = np.random.RandomState(seed)
    oc, ph, pw, h, w = 2, 3, 3, 12, 15
    x = rng.randint(0, 64, (2, oc * ph * pw, h, w)).astype(np.float32)
    # width and height (x1 - x0 + 1) multiples of 3: bins of whole pixels
    rois = np.array([[0, 0, 8, 5], [3, 2, 11, 10], [6, 3, 14, 11],
                     [0, 0, 2, 2]], np.float32)
    ins = {"X": [torch.from_numpy(x)], "ROIs": [torch.from_numpy(rois)],
           "RoisBatchIdx": [torch.tensor([0, 1, 1, 0])]}
    return ins, {"output_channels": oc, "spatial_scale": 1.0,
                 "pooled_height": ph, "pooled_width": pw}


def test_psroi_pool_whole_pixel_bins_are_exact():
    ins, attrs = psroi_case()
    (out,) = _rule("psroi_pool", ins, attrs)["Out"]
    x, rois = ins["X"][0].numpy(), ins["ROIs"][0].numpy()
    oc, ph, pw = 2, 3, 3
    bidx = ins["RoisBatchIdx"][0].numpy()
    for r, (x0, y0, x1, y1) in enumerate(rois.astype(int)):
        bh, bw = (y1 - y0 + 1) // ph, (x1 - x0 + 1) // pw
        for o in range(oc):
            for i in range(ph):
                for j in range(pw):
                    c = o * ph * pw + i * pw + j
                    win = x[bidx[r], c, y0 + i * bh:y0 + (i + 1) * bh,
                            x0 + j * bw:x0 + (j + 1) * bw]
                    want = np.float32(win.sum()) / np.float32(win.size)
                    assert out[r, o, i, j].item() == want, (r, o, i, j)
