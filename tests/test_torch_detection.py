"""The detection ops of the port (``ops/detection.py``, every op type of
it) and ``layers/detection.py`` against the JAX package's, on the CPU.

Each case is a single-op program built the same way in both packages
from numpy inputs made with a seed (``test_torch_sequence_ops.run_op_case``):
float outputs agree within rtol 1e-5, atol 1e-5 (the box arithmetic runs
the reference's float32 formulas term for term), and every selection
(NMS, top-k, FPN routing, counts and indexes) exactly: the boxes of
those cases lie on grids whose areas and intersections are exact in
float32, so the IoUs are equal bit for bit and so are the choices made
on them. The ops with a gradient (``box_coder``'s TargetBox,
``box_clip``'s Input, ``roi_align``'s and ``roi_pool``'s X) also pull a
random cotangent back through ``gradients``: the port's generic grad
against ``jax.vjp``, at the same tolerance.

The NMS cases cover ``nms_eta`` 1 and under 1 (the port's fixed point
and its sequential scan), ``background_label`` -1, ``keep_top_k`` -1,
exactly tied scores (stable order: index, then class), and a 64-box
suppression chain that greedy NMS answers with every other box where a
one-pass ("fast") NMS keeps only the first.
"""
import numpy as np
import pytest
import torch

from test_torch_lod import build_both, normalized
from test_torch_sequence_ops import assert_case_matches, f32, run_op_case

RTOL, ATOL = 1e-5, 1e-5


def grid_boxes(n, seed, grid=512, scale=1.0, lo=0.05, hi=0.35):
    """n boxes [x0, y0, x1, y1] with corners on a 1/grid grid (times
    ``scale``): exact areas and intersections in float32."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 0.6
    wh = rng.rand(n, 2) * (hi - lo) + lo
    b = np.round(np.concatenate([xy, xy + wh], 1) * grid) / grid
    return (b * scale).astype(np.float32)


def dyadic_scores(shape, seed, denom=4096.0):
    """Distinct scores k / denom in (0, 1), in a random order."""
    n = int(np.prod(shape))
    k = np.random.RandomState(seed).permutation(n) + 1
    return (k / denom).reshape(shape).astype(np.float32)


def roi_set(n, seed, h, w, stride=1.0):
    """n RoIs inside an h x w map (image coordinates at ``stride``),
    corners on a quarter-pixel grid, a few past the border."""
    rng = np.random.RandomState(seed)
    x0 = rng.rand(n) * (w - 2)
    y0 = rng.rand(n) * (h - 2)
    x1 = x0 + rng.rand(n) * w * 0.8 + 0.5
    y1 = y0 + rng.rand(n) * h * 0.8 + 0.5
    b = np.stack([x0, y0, x1, y1], 1) * stride
    return (np.round(b * 4) / 4).astype(np.float32)


N, C, M = 2, 4, 40
BB = np.stack([grid_boxes(M, s) for s in range(N)])
SC = dyadic_scores((N, C, M), 7, denom=512.0)
# exactly tied scores: eight values repeated across boxes and classes
TIED = (np.random.RandomState(3).randint(1, 9, (N, C, M)) / 8.0) \
    .astype(np.float32)
NMS = {"background_label": 0, "score_threshold": 0.05, "nms_top_k": 12,
       "nms_threshold": 0.5, "nms_eta": 1.0, "keep_top_k": 20,
       "normalized": True}


def nms_case(bb, sc, **attrs):
    return ("multiclass_nms", {"BBoxes": [("b", bb)], "Scores": [("s", sc)]},
            {"Out": ["o"]}, dict(NMS, **attrs), [])


def chain_boxes(n=64):
    """n unit boxes each shifted a quarter from the last: neighbours
    overlap with IoU 0.6, boxes two apart with IoU 1/3."""
    x0 = np.arange(n) * 0.25
    return np.stack([x0, np.zeros(n), x0 + 1, np.ones(n)], 1) \
        .astype(np.float32)


CHAIN_SC = (np.arange(64, 0, -1) / 64.0).astype(np.float32)

# generate_proposals: 3 anchors a cell over a 4 x 5 map, 2 images
A, GH, GW = 3, 4, 5


def anchors():
    cx = np.arange(GW) * 16 + 7.5
    cy = np.arange(GH) * 16 + 7.5
    sizes = np.array([[8, 8], [16, 8], [16, 16]], np.float32)
    a = np.zeros((GH, GW, A, 4), np.float32)
    a[..., 0] = cx[None, :, None] - sizes[:, 0]
    a[..., 1] = cy[:, None, None] - sizes[:, 1]
    a[..., 2] = cx[None, :, None] + sizes[:, 0] - 1
    a[..., 3] = cy[:, None, None] + sizes[:, 1] - 1
    return a


def deltas(seed, exact=True):
    """[2, 4A, H, W] deltas; ``exact``: dx, dy on a 1/16 grid and dw,
    dh zero, so every box, IoU and area is exact in float32."""
    d = f32(2, A, 4, GH, GW, seed=seed, scale=0.2)
    if exact:
        d[:, :, :2] = np.round(d[:, :, :2] * 16) / 16
        d[:, :, 2:] = 0.0
    return d.reshape(2, 4 * A, GH, GW)


IM_INFO = np.array([[64, 80, 1.0], [60, 72, 1.0]], np.float32)


def gp_case(seed=0, **attrs):
    return ("generate_proposals",
            {"Scores": [("sc", dyadic_scores((2, A, GH, GW), seed))],
             "BboxDeltas": [("d", deltas(seed))],
             "ImInfo": [("im", IM_INFO)],
             "Anchors": [("an", anchors())],
             "Variances": [("var", np.ones((GH, GW, A, 4), np.float32))]},
            {"RpnRois": ["r"], "RpnRoiProbs": ["p"], "RpnRoisNum": ["n"]},
            dict({"pre_nms_topN": 40, "post_nms_topN": 16, "nms_thresh": 0.5,
                  "min_size": 2.0, "eta": 1.0}, **attrs), [])


def fpn_rois():
    """8 RoIs an image, two images: areas from 16^2 to 800^2 (levels 2 to
    5 and both clips), the last rows of image 1 padding (-1)."""
    side = np.array([16, 40, 112, 224, 225, 448, 800, 60], np.float32)
    r = np.zeros((16, 4), np.float32)
    r[:, 2] = np.concatenate([side, side[::-1]]) - 1
    r[:, 3] = r[:, 2] * 0.5
    r[:, :2] = 3.0
    r[:, 2:] += 3.0
    r[13:] = -1.0
    return r


CASES = {
    "prior_box": (
        "prior_box", {"Input": [("f", f32(1, 8, 4, 5))],
                      "Image": [("im", f32(1, 3, 64, 80, seed=1))]},
        {"Boxes": ["b"], "Variances": ["v"]},
        {"min_sizes": [20.0, 30.0], "max_sizes": [40.0, 50.0],
         "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True}, []),
    "prior_box_min_max_order_steps": (
        "prior_box", {"Input": [("f", f32(1, 8, 4, 5))],
                      "Image": [("im", f32(1, 3, 64, 80, seed=1))]},
        {"Boxes": ["b"], "Variances": ["v"]},
        {"min_sizes": [20.0], "max_sizes": [40.0], "aspect_ratios": [2.0],
         "flip": False, "clip": False, "step_w": 16.0, "step_h": 15.0,
         "offset": 0.25, "min_max_aspect_ratios_order": True}, []),
    "anchor_generator": (
        "anchor_generator", {"Input": [("f", f32(1, 8, 4, 5))]},
        {"Anchors": ["a"], "Variances": ["v"]},
        {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
         "stride": [16.0, 8.0], "offset": 0.5}, []),
    "iou_similarity": (
        "iou_similarity", {"X": [("x", grid_boxes(5, 1))],
                           "Y": [("y", grid_boxes(7, 2))]},
        {"Out": ["o"]}, {}, []),
    "iou_similarity_pixels": (
        "iou_similarity", {"X": [("x", grid_boxes(5, 1, grid=1, scale=64))],
                           "Y": [("y", grid_boxes(7, 2, grid=1, scale=64))]},
        {"Out": ["o"]}, {"box_normalized": False}, []),
    "box_coder_encode": (
        "box_coder", {"PriorBox": [("p", grid_boxes(6, 3))],
                      "PriorBoxVar": [("pv", np.tile(np.array(
                          [[0.1, 0.1, 0.2, 0.2]], np.float32), (6, 1)))],
                      "TargetBox": [("t", grid_boxes(4, 4))]},
        {"OutputBox": ["o"]}, {"code_type": "encode_center_size"}, ["o"]),
    "box_coder_encode_pixels_no_var": (
        "box_coder", {"PriorBox": [("p", grid_boxes(6, 3, scale=100))],
                      "TargetBox": [("t", grid_boxes(4, 4, scale=100))]},
        {"OutputBox": ["o"]},
        {"code_type": "encode_center_size", "box_normalized": False},
        ["o"]),
    "box_coder_decode_axis0": (
        "box_coder", {"PriorBox": [("p", grid_boxes(6, 3))],
                      "PriorBoxVar": [("pv", np.tile(np.array(
                          [[0.1, 0.1, 0.2, 0.2]], np.float32), (6, 1)))],
                      "TargetBox": [("t", f32(3, 6, 4, seed=5))]},
        {"OutputBox": ["o"]}, {"code_type": "decode_center_size"}, ["o"]),
    "box_coder_decode_axis1": (
        "box_coder", {"PriorBox": [("p", grid_boxes(3, 3, scale=50))],
                      "PriorBoxVar": [("pv", np.tile(np.array(
                          [[0.1, 0.1, 0.2, 0.2]], np.float32), (3, 1)))],
                      "TargetBox": [("t", f32(3, 5, 4, seed=6))]},
        {"OutputBox": ["o"]},
        {"code_type": "decode_center_size", "axis": 1,
         "box_normalized": False}, ["o"]),
    "box_clip": (
        "box_clip", {"Input": [("b", f32(2, 6, 4, seed=7, scale=40.0))],
                     "ImInfo": [("im", np.array([[30, 40, 1.0],
                                                 [50, 20, 2.0]],
                                                np.float32))]},
        {"Output": ["o"]}, {}, ["o"]),
    "yolo_box": (
        "yolo_box", {"X": [("x", f32(2, 3 * 7, 4, 5, seed=8))],
                     "ImgSize": [("sz", np.array([[128, 160], [96, 120]],
                                                 np.int32))]},
        {"Boxes": ["b"], "Scores": ["s"]},
        {"anchors": [10, 13, 16, 30, 33, 23], "class_num": 2,
         "conf_thresh": 0.3, "downsample_ratio": 32}, []),
    "multiclass_nms": nms_case(BB, SC),
    "multiclass_nms_eta": nms_case(BB, SC, nms_eta=0.8, nms_threshold=0.6),
    "multiclass_nms_no_background_keep_all": nms_case(
        BB, SC, background_label=-1, keep_top_k=-1, nms_top_k=-1),
    "multiclass_nms_tied_scores": nms_case(BB, TIED, score_threshold=0.3,
                                           keep_top_k=30),
    "multiclass_nms_tied_eta": nms_case(BB, TIED, score_threshold=0.3,
                                        nms_eta=0.9, nms_threshold=0.7),
    "multiclass_nms_pixels_nothing_above": nms_case(
        np.round(BB * 300), SC, normalized=False, score_threshold=1.0),
    "multiclass_nms_chain": nms_case(
        chain_boxes()[None], CHAIN_SC[None, None], background_label=-1,
        nms_top_k=-1, keep_top_k=-1, score_threshold=0.0),
    "roi_align": (
        "roi_align", {"X": [("x", f32(2, 3, 8, 9, seed=9))],
                      "ROIs": [("r", roi_set(6, 10, 8, 9, stride=2.0))],
                      "RoisBatchIdx": [("bi", np.array([0, 1, 1, 0, 1, 0],
                                                       np.int32))]},
        {"Out": ["o"]}, {"spatial_scale": 0.5, "pooled_height": 3,
                         "pooled_width": 2, "sampling_ratio": 2}, ["o"]),
    "roi_align_adaptive_grid": (
        "roi_align", {"X": [("x", f32(1, 2, 7, 6, seed=11))],
                      "ROIs": [("r", roi_set(4, 12, 7, 6))]},
        {"Out": ["o"]}, {"pooled_height": 2, "pooled_width": 2}, ["o"]),
    # integer-valued features: most bins hold tied maxima, whose
    # gradient both packages split equally between the tied elements
    "roi_pool_ties": (
        "roi_pool", {"X": [("x", np.random.RandomState(13).randint(
                         -2, 3, (2, 3, 9, 10)).astype(np.float32))],
                     "ROIs": [("r", roi_set(7, 14, 9, 10, stride=2.0))],
                     "RoisBatchIdx": [("bi", np.array(
                         [1, 0, 1, 1, 0, 0, 1], np.int32))]},
        {"Out": ["o"]}, {"spatial_scale": 0.5, "pooled_height": 3,
                         "pooled_width": 3}, ["o"]),
    "roi_pool_past_the_map": (
        "roi_pool", {"X": [("x", f32(1, 2, 6, 7, seed=15))],
                     "ROIs": [("r", np.array([[-4, -4, 2, 3], [3, 2, 20, 30],
                                              [5, 5, 5, 5], [0, 0, 6, 6]],
                                             np.float32))]},
        {"Out": ["o"]}, {"pooled_height": 4, "pooled_width": 3}, ["o"]),
    "generate_proposals": gp_case(),
    "generate_proposals_padded": gp_case(1, post_nms_topN=30,
                                         nms_thresh=0.3, min_size=12.0),
    "generate_proposals_eta": gp_case(2, nms_thresh=0.8, eta=0.9),
    "distribute_fpn_proposals": (
        "distribute_fpn_proposals",
        {"FpnRois": [("r", fpn_rois())],
         "RoisNum": [("n", np.array([8, 4], np.int32))]},
        {"MultiFpnRois": ["l2", "l3", "l4", "l5"],
         "MultiLevelRoIsNum": ["n2", "n3", "n4", "n5"],
         "RestoreIndex": ["ri"]},
        {"min_level": 2, "max_level": 5, "refer_level": 4,
         "refer_scale": 224}, []),
    "distribute_fpn_proposals_no_counts": (
        "distribute_fpn_proposals", {"FpnRois": [("r", fpn_rois())]},
        {"MultiFpnRois": ["l3", "l4"], "MultiLevelRoIsNum": ["n3", "n4"],
         "RestoreIndex": ["ri"]},
        {"min_level": 3, "max_level": 4, "refer_level": 4,
         "refer_scale": 224, "pixel_offset": False}, []),
    "collect_fpn_proposals_empty_level": (
        "collect_fpn_proposals",
        {"MultiLevelRois": [("r2", grid_boxes(6, 16, scale=100)),
                            ("r3", -np.ones((4, 4), np.float32)),
                            ("r4", np.concatenate(
                                [grid_boxes(3, 17, scale=100),
                                 -np.ones((2, 4), np.float32)]))],
         "MultiLevelScores": [("s2", dyadic_scores((6, 1), 18)),
                              ("s3", dyadic_scores((4, 1), 19)),
                              ("s4", dyadic_scores((5, 1), 20))]},
        {"FpnRois": ["o"], "RoisNum": ["n"]}, {"post_nms_topN": 9}, []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_detection_op_matches_jax(case):
    op_type, ins, outs, attrs, grad_outs = CASES[case]
    got, shapes = run_op_case(op_type, ins, outs, attrs, grad_outs)
    assert_case_matches(got, shapes, RTOL, ATOL)


def test_every_detection_op_type_has_a_case():
    from paddle_tpu_torch.core import registry
    ported = {t for t in registry.all_ops()
              if getattr(registry.get_op_def(t).lower, "__module__", "")
              == "paddle_tpu_torch.ops.detection"}
    assert len(ported) == 12
    assert ported == {c[0] for c in CASES.values()}


def _nms_rows(case):
    op_type, ins, outs, attrs, _ = CASES[case]
    got, shapes = run_op_case(op_type, ins, outs, attrs)
    return assert_case_matches(got, shapes, 0.0, 0.0)["o"]


def test_nms_selections_are_exact():
    """Rows, labels and scores equal the JAX package's bit for bit."""
    for case in ("multiclass_nms", "multiclass_nms_eta",
                 "multiclass_nms_tied_scores", "multiclass_nms_tied_eta"):
        rows = _nms_rows(case)
        assert (rows[..., 0] >= 0).any(), case


def test_tied_scores_fall_in_index_then_class_order():
    rows = _nms_rows("multiclass_nms_tied_scores")
    for img in range(N):
        r = rows[img][rows[img, :, 0] >= 0]
        # within a score, classes ascend; within a class, the box index
        # (recovered from the coordinates) ascends
        for s in np.unique(r[:, 1]):
            same = r[r[:, 1] == s]
            assert np.all(np.diff(same[:, 0]) >= 0)
            for c in np.unique(same[:, 0]):
                boxes = same[same[:, 0] == c][:, 2:]
                idx = [int(np.flatnonzero((BB[img] == b).all(1))[0])
                       for b in boxes]
                assert idx == sorted(idx)


def test_suppression_chain_keeps_every_other_box():
    rows = _nms_rows("multiclass_nms_chain")[0]
    kept = rows[rows[:, 0] >= 0]
    boxes = chain_boxes()
    idx = [int(np.flatnonzero((boxes == b).all(1))[0]) for b in kept[:, 2:]]
    assert idx == list(range(0, 64, 2))
    # a one-pass ("fast") NMS suppresses by every higher-scored box,
    # kept or not: it keeps the first alone
    from paddle_tpu_torch.ops.detection import iou_matrix
    iou = iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes))
    fast = ~((iou > 0.5) & torch.ones(64, 64, dtype=torch.bool).tril(-1)) \
        .any(1)
    assert fast.nonzero().flatten().tolist() == [0]


def test_nms_counts_its_host_reads():
    """One read of the candidate count, then one a fixed-point check;
    the 64-box chain needs 32 passes, checked after 1, 2, 4, ..., 32."""
    from paddle_tpu_torch.ops import detection as D
    boxes = torch.from_numpy(chain_boxes())[None]
    before = D.nms_sync_count()
    idx, ss, valid = D._candidates(torch.from_numpy(CHAIN_SC)[None], 0.0)
    keep = D._nms_keep(boxes[:, idx[0]], valid, 0.5, 64)
    assert keep[0].nonzero().flatten().tolist() == list(range(0, 64, 2))
    assert D.nms_sync_count() - before == 1 + 7


def test_proposals_pad_and_count():
    op_type, ins, outs, attrs, _ = CASES["generate_proposals_padded"]
    got, shapes = run_op_case(op_type, ins, outs, attrs)
    t = assert_case_matches(got, shapes, 0.0, 0.0)
    counts = t["n"]
    assert (counts < 30).all() and (counts > 0).all()
    for i, c in enumerate(counts):
        assert (t["r"][i, c:] == -1).all() and (t["p"][i, c:] == 0).all()
        assert (t["r"][i, :c] >= 0).all()


def test_restore_index_rebuilds_the_order():
    op_type, ins, outs, attrs, _ = CASES["distribute_fpn_proposals"]
    got, shapes = run_op_case(op_type, ins, outs, attrs)
    t = assert_case_matches(got, shapes, 0.0, 0.0)
    rois = ins["FpnRois"][0][1]
    levels = [t[f"l{k}"][:int(t[f"n{k}"][0])] for k in range(2, 6)]
    cat = np.concatenate(levels)
    ri = t["ri"][:, 0]
    valid = ri >= 0
    assert valid.sum() == len(cat) == 12          # 8 + 4 counted rows
    np.testing.assert_array_equal(cat[ri[valid]], rois[valid])
    assert [len(v) for v in levels] == [5, 3, 2, 2]


# ------------------------------------------------------------- layers
def detection_net(fl):
    L = fl.layers
    D = L.detection
    feat = L.data("feat", shape=[8, 4, 5], dtype="float32")
    img = L.data("img", shape=[3, 64, 80], dtype="float32")
    pb, pv = D.prior_box(feat, img, [20.0], [40.0], aspect_ratios=[2.0],
                         flip=True, clip=True)
    an, av = D.anchor_generator(feat, anchor_sizes=[32.0],
                                aspect_ratios=[1.0, 2.0], stride=[16., 16.])
    gt = L.data("gt", shape=[6, 4], dtype="float32", append_batch_size=False)
    pri = L.reshape(pb, [-1, 4])
    iou = D.iou_similarity(gt, pri)
    enc = D.box_coder(pri, L.reshape(pv, [-1, 4]), gt)
    loc = L.data("loc", shape=[-1, 4], dtype="float32")
    dec = D.box_coder(pri, None, loc, code_type="decode_center_size")
    im = L.data("im", shape=[3], dtype="float32")
    clipped = D.box_clip(dec, im)
    head = L.data("head", shape=[21, 4, 5], dtype="float32")
    size = L.data("size", shape=[2], dtype="int32")
    yb, ys = D.yolo_box(head, size, [10, 13, 16, 30, 33, 23], 2, 0.01, 32)
    sc = L.data("sc", shape=[3, 80], dtype="float32")
    nms = D.multiclass_nms(clipped, sc, 0.05, 40, 10)
    rois = L.data("rois", shape=[4], dtype="float32")
    ra = D.roi_align(feat, rois, 2, 2, 0.25, 2)
    rp = D.roi_pool(feat, rois, 2, 2, 0.25)
    ra2 = L.roi_align(feat, rois, 2, 3, 0.5)
    rp2 = L.roi_pool(feat, rois, 3, 2, 0.5)
    return [pb, pv, an, av, iou, enc, dec, clipped, yb, ys, nms, ra, rp,
            ra2, rp2]


def test_detection_layers_build_the_jax_programs():
    b = build_both(detection_net)
    for k in (0, 1):
        assert normalized(b["torch"][k]) == normalized(b["jax"][k])
    ops = {o.type for o in b["torch"][0].global_block.ops}
    assert ops >= {"prior_box", "anchor_generator", "iou_similarity",
                   "box_coder", "box_clip", "yolo_box", "multiclass_nms",
                   "roi_align", "roi_pool"}
