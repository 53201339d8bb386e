"""The detection ops of the op library (counterpart of
``paddle_tpu/ops/detection.py``, every op type of it): priors and
anchors, IoU, box coding and clipping, the YOLOv3 head decode, greedy
NMS (``multiclass_nms``), RoI align and RoI max pooling, and the RPN/FPN
proposal pipeline.

The encoding is the JAX package's: a variable number of detections or
proposals per image becomes a fixed-size output padded with -1 rows (and
a count vector where the reference has one). Where the JAX package's
rule is shaped for XLA, the port computes the same result another way:

* greedy NMS (``_nms_keep``) visits only the candidates (scores above
  the threshold: the others are never kept and suppress nothing), sorted
  by a stable sort on the negated score as the reference's ``argsort``.
  With a fixed IoU threshold (``nms_eta`` 1, or a threshold at or under
  0.5, which ``nms_eta`` never moves) greedy NMS is the unique fixed
  point of ``keep_i = valid_i and no j < i with keep_j and IoU_ij > t``
  (Cluster-NMS, Zheng et al. 2021), reached from ``keep = valid`` by
  boolean matrix-vector passes; the candidates of every (image, class)
  go through together, in chunks of at most ``NMS_CHUNK_ELEMS`` matrix
  entries. The host reads the candidate count once and checks for the
  fixed point after 1, 2, 4, ... passes (``nms_sync_count`` counts these
  reads). A moving threshold runs the sequential scan, one step a
  candidate for all groups at once.
* ``roi_pool`` takes each bin's maximum over a window the size of the
  largest bin (the host reads that size once), not over a masked copy
  of the whole map for every bin; the maximum is one ``amax`` over the
  flattened window, so tied maxima share the gradient equally as
  ``jnp.max``'s do.
* every gather whose gradient sums into repeated positions is an
  advanced index, whose gradient (an accumulating ``index_put_``) sums
  in a fixed order on the card;
* a division by a Python number that feeds a floor, a bin bound or a
  sample coordinate divides by a 0-dim tensor (``true_div``): the card
  would multiply by the reciprocal, an ulp off the CPU.

References: prior_box_op.h, anchor_generator_op.h, iou_similarity_op.h,
box_coder_op.h, box_clip_op.h, yolo_box_op.h, multiclass_nms_op.cc,
roi_align_op.h, roi_pool_op.h, generate_proposals_op.cc,
distribute_fpn_proposals_op.cc, collect_fpn_proposals_op.cc.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import IOSpec, out, register_op, true_div, x

# entries of the [groups, L, L] suppression matrix built at once
NMS_CHUNK_ELEMS = 1 << 27
# the reference's kBBoxClipDefault, log(1000 / 16), in float32
BBOX_CLIP = float(np.float32(math.log(1000.0 / 16.0)))

_SYNCS = [0]


def nms_sync_count() -> int:
    """Host reads made by the NMS and ``roi_pool`` rules since the
    process started (the candidate counts, the fixed-point checks and
    the window sizes)."""
    return _SYNCS[0]


def _host(t):
    """``t``'s values on the host: one counted read."""
    _SYNCS[0] += 1
    return t.tolist()


def device_const(values, dtype, device):
    """A small constant tensor on ``device``, copied without making the
    host wait (a blocking copy to the card is a host sync)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def _expand_aspect_ratios(ars, flip):
    """prior_box's ExpandAspectRatios: [1] + ars (+ 1/ar if flip)."""
    res = [1.0]
    for ar in ars:
        if any(abs(ar - r) < 1e-6 for r in res):
            continue
        res.append(float(ar))
        if flip:
            res.append(1.0 / float(ar))
    return res


def float_range(n, device, dtype=torch.float32):
    """0, 1, ..., n - 1 as floats on ``device``."""
    return torch.arange(n, dtype=dtype, device=device)


@register_op("prior_box",
             inputs=[IOSpec("Input", no_grad=True),
                     IOSpec("Image", no_grad=True)],
             outputs=["Boxes", "Variances"],
             attrs={"min_sizes": [], "max_sizes": [], "aspect_ratios": [1.0],
                    "variances": [0.1, 0.1, 0.2, 0.2], "flip": False,
                    "clip": False, "step_w": 0.0, "step_h": 0.0,
                    "offset": 0.5, "min_max_aspect_ratios_order": False},
             grad=None)
def _prior_box(ctx, ins, attrs):
    """SSD priors, [H, W, P, 4] normalised corners: the expanded aspect
    ratios then the sqrt(min * max) square for each min size, or with
    ``min_max_aspect_ratios_order`` the min square, the max square, then
    the other ratios."""
    feat, img = x(ins, "Input"), x(ins, "Image")
    dev, dt = feat.device, feat.dtype
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = img.shape[2], img.shape[3]
    step_w = attrs["step_w"] or IW / W
    step_h = attrs["step_h"] or IH / H
    offset = attrs["offset"]
    ars = _expand_aspect_ratios(attrs["aspect_ratios"], attrs["flip"])
    mins, maxs = attrs["min_sizes"], attrs["max_sizes"]
    cx = (float_range(W, dev) + offset) * step_w
    cy = (float_range(H, dev) + offset) * step_h
    whs = []
    for si, mn in enumerate(mins):
        if attrs.get("min_max_aspect_ratios_order"):
            whs.append((mn / 2.0, mn / 2.0))
            if maxs:
                s = np.sqrt(mn * maxs[si]) / 2.0
                whs.append((s, s))
            whs += [(mn * np.sqrt(ar) / 2.0, mn / np.sqrt(ar) / 2.0)
                    for ar in ars if abs(ar - 1.0) >= 1e-6]
        else:
            whs += [(mn * np.sqrt(ar) / 2.0, mn / np.sqrt(ar) / 2.0)
                    for ar in ars]
            if maxs:
                s = np.sqrt(mn * maxs[si]) / 2.0
                whs.append((s, s))
    bw = device_const([float(w) for w, _ in whs], dt, dev)
    bh = device_const([float(h) for _, h in whs], dt, dev)
    cxg = cx[None, :, None].to(dt)
    cyg = cy[:, None, None].to(dt)
    boxes = torch.stack(torch.broadcast_tensors(
        true_div(cxg - bw, IW), true_div(cyg - bh, IH),
        true_div(cxg + bw, IW), true_div(cyg + bh, IH)), dim=-1)                      # [H, W, P, 4]
    if attrs["clip"]:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = device_const([float(v) for v in attrs["variances"]], dt, dev)
    return {"Boxes": [boxes],
            "Variances": [var.expand(boxes.shape).contiguous()]}


@register_op("anchor_generator",
             inputs=[IOSpec("Input", no_grad=True)],
             outputs=["Anchors", "Variances"],
             attrs={"anchor_sizes": [64.0, 128.0, 256.0, 512.0],
                    "aspect_ratios": [0.5, 1.0, 2.0],
                    "variances": [0.1, 0.1, 0.2, 0.2],
                    "stride": [16.0, 16.0], "offset": 0.5},
             grad=None)
def _anchor_generator(ctx, ins, attrs):
    """RPN anchors in pixels, [H, W, A, 4], with the reference's pixel
    conventions: centres at idx * stride + offset * (stride - 1), base
    sizes through round(sqrt(stride area / ar)), corners at the centre
    -/+ 0.5 * (size - 1)."""
    feat = x(ins, "Input")
    dev, dt = feat.device, feat.dtype
    H, W = feat.shape[2], feat.shape[3]
    sw, sh = attrs["stride"]
    offset = attrs["offset"]
    cx = float_range(W, dev) * sw + offset * (sw - 1)
    cy = float_range(H, dev) * sh + offset * (sh - 1)
    whs = []
    for ar in attrs["aspect_ratios"]:
        for size in attrs["anchor_sizes"]:
            base_w = np.round(np.sqrt(sw * sh / ar))
            base_h = np.round(base_w * ar)
            whs.append((0.5 * ((size / sw) * base_w - 1),
                        0.5 * ((size / sh) * base_h - 1)))
    bw = device_const([float(w) for w, _ in whs], dt, dev)
    bh = device_const([float(h) for _, h in whs], dt, dev)
    cxg = cx[None, :, None].to(dt)
    cyg = cy[:, None, None].to(dt)
    anchors = torch.stack(torch.broadcast_tensors(
        cxg - bw, cyg - bh, cxg + bw, cyg + bh), dim=-1)
    var = device_const([float(v) for v in attrs["variances"]], dt, dev)
    return {"Anchors": [anchors],
            "Variances": [var.expand(anchors.shape).contiguous()]}


def iou_matrix(a, b, normalized=True):
    """[..., N, 4] x [..., M, 4] -> [..., N, M], term for term the
    reference's formula (pixel boxes add 1 to each extent)."""
    off = 0.0 if normalized else 1.0

    def area(bx):
        return (torch.clamp(bx[..., 2] - bx[..., 0] + off, min=0)
                * torch.clamp(bx[..., 3] - bx[..., 1] + off, min=0))

    a, b = a[..., :, None, :], b[..., None, :, :]
    ix0 = torch.maximum(a[..., 0], b[..., 0])
    iy0 = torch.maximum(a[..., 1], b[..., 1])
    ix1 = torch.minimum(a[..., 2], b[..., 2])
    iy1 = torch.minimum(a[..., 3], b[..., 3])
    inter = (torch.clamp(ix1 - ix0 + off, min=0)
             * torch.clamp(iy1 - iy0 + off, min=0))
    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       0.0)


@register_op("iou_similarity",
             inputs=[IOSpec("X", no_grad=True), IOSpec("Y", no_grad=True)],
             outputs=["Out"], attrs={"box_normalized": True}, grad=None)
def _iou_similarity(ctx, ins, attrs):
    return out(iou_matrix(x(ins, "X"), x(ins, "Y"),
                          attrs.get("box_normalized", True)))


@register_op("box_coder",
             inputs=[IOSpec("PriorBox", no_grad=True),
                     IOSpec("PriorBoxVar", optional=True, no_grad=True),
                     IOSpec("TargetBox")],
             outputs=["OutputBox"],
             attrs={"code_type": "encode_center_size",
                    "box_normalized": True, "axis": 0})
def _box_coder(ctx, ins, attrs):
    """Centre-size encode ([N, 4] targets against [M, 4] priors ->
    [N, M, 4]) and decode ([N, M, 4] deltas over the priors along
    ``axis``)."""
    prior, pvar = x(ins, "PriorBox"), x(ins, "PriorBoxVar")
    tb = x(ins, "TargetBox")
    off = 0.0 if attrs.get("box_normalized", True) else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if attrs["code_type"].lower().startswith("encode"):
        tw = tb[:, None, 2] - tb[:, None, 0] + off
        th = tb[:, None, 3] - tb[:, None, 1] + off
        tcx = tb[:, None, 0] + tw * 0.5
        tcy = tb[:, None, 1] + th * 0.5
        res = torch.stack([(tcx - pcx[None, :]) / pw[None, :],
                           (tcy - pcy[None, :]) / ph[None, :],
                           torch.log(torch.abs(tw) / pw[None, :]),
                           torch.log(torch.abs(th) / ph[None, :])], -1)
        if pvar is not None:
            res = res / pvar[None, :, :]
        return {"OutputBox": [res]}
    axis = attrs.get("axis", 0)
    pw_, ph_, pcx_, pcy_ = (v[None, :] if axis == 0 else v[:, None]
                            for v in (pw, ph, pcx, pcy))
    d = tb if pvar is None else tb * (pvar[None, :, :] if axis == 0
                                      else pvar[:, None, :])
    dcx = d[..., 0] * pw_ + pcx_
    dcy = d[..., 1] * ph_ + pcy_
    dw = torch.exp(d[..., 2]) * pw_
    dh = torch.exp(d[..., 3]) * ph_
    return {"OutputBox": [torch.stack(
        [dcx - dw * 0.5, dcy - dh * 0.5, dcx + dw * 0.5 - off,
         dcy + dh * 0.5 - off], -1)]}


def _clip(v, lo, hi):
    """``jnp.clip``: maximum then minimum, whose gradients split ties
    at a bound equally (``torch.clamp`` passes them whole)."""
    return torch.minimum(torch.maximum(v, lo), hi)


@register_op("box_clip", inputs=[IOSpec("Input"),
                                 IOSpec("ImInfo", no_grad=True)],
             outputs=["Output"])
def _box_clip(ctx, ins, attrs):
    """Clip boxes to [0, im - 1] of their image; ImInfo [N, 3] is
    (height, width, scale)."""
    boxes, im = x(ins, "Input"), x(ins, "ImInfo")
    h = (im[:, 0] / im[:, 2] - 1).reshape(-1, 1)
    w = (im[:, 1] / im[:, 2] - 1).reshape(-1, 1)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return {"Output": [torch.stack(
        [_clip(boxes[..., 0], zero, w), _clip(boxes[..., 1], zero, h),
         _clip(boxes[..., 2], zero, w), _clip(boxes[..., 3], zero, h)],
        -1)]}


@register_op("yolo_box",
             inputs=[IOSpec("X", no_grad=True),
                     IOSpec("ImgSize", no_grad=True)],
             outputs=["Boxes", "Scores"],
             attrs={"anchors": [], "class_num": 1, "conf_thresh": 0.01,
                    "downsample_ratio": 32}, grad=None)
def _yolo_box(ctx, ins, attrs):
    """The YOLOv3 head decoded to corner boxes in image pixels and
    per-class scores, [N, an*H*W, 4] and [N, an*H*W, class_num]; boxes
    under ``conf_thresh`` are zeroed."""
    xv, imgsize = x(ins, "X"), x(ins, "ImgSize")
    dev, dt = xv.device, xv.dtype
    anchors = attrs["anchors"]
    an = len(anchors) // 2
    cls = attrs["class_num"]
    N, _, H, W = xv.shape
    v = xv.reshape(N, an, 5 + cls, H, W)
    grid_x = float_range(W, dev, dt).reshape(1, 1, 1, W)
    grid_y = float_range(H, dev, dt).reshape(1, 1, H, 1)
    img_h = imgsize[:, 0].reshape(N, 1, 1, 1).to(dt)
    img_w = imgsize[:, 1].reshape(N, 1, 1, 1).to(dt)
    input_size = attrs["downsample_ratio"] * H
    aw = device_const([float(a) for a in anchors[0::2]], dt, dev) \
        .reshape(1, an, 1, 1)
    ah = device_const([float(a) for a in anchors[1::2]], dt, dev) \
        .reshape(1, an, 1, 1)
    bx = true_div((grid_x + torch.sigmoid(v[:, :, 0])) * img_w, W)
    by = true_div((grid_y + torch.sigmoid(v[:, :, 1])) * img_h, H)
    bw = true_div(torch.exp(v[:, :, 2]) * aw * img_w, input_size)
    bh = true_div(torch.exp(v[:, :, 3]) * ah * img_h, input_size)
    conf = torch.sigmoid(v[:, :, 4])
    keep = conf >= attrs["conf_thresh"]
    x0 = torch.clamp(bx - bw / 2, min=0)
    y0 = torch.clamp(by - bh / 2, min=0)
    x1 = torch.minimum(bx + bw / 2, img_w - 1)
    y1 = torch.minimum(by + bh / 2, img_h - 1)
    boxes = torch.stack([x0, y0, x1, y1], -1) * keep[..., None]
    scores = torch.sigmoid(v[:, :, 5:]) * conf[:, :, None] \
        * keep[:, :, None]
    return {"Boxes": [boxes.reshape(N, an * H * W, 4)],
            "Scores": [scores.permute(0, 1, 3, 4, 2)
                       .reshape(N, an * H * W, cls)]}


# ---------------------------------------------------------------------------
# greedy NMS
# ---------------------------------------------------------------------------

def _fixed_point_keep(sup, valid):
    """The unique fixed point of keep = valid & ~(sup @ keep > 0) for a
    strictly lower-triangular ``sup`` [G, L, L], iterated from valid;
    checked after 1, 2, 4, ... passes (each check one host read)."""
    supf = sup.to(torch.float32)
    keep = valid
    passes = 1
    while True:
        for _ in range(passes):
            prev = keep
            hit = torch.matmul(supf, keep.to(torch.float32)[..., None])
            keep = valid & ~(hit[..., 0] > 0)
        _SYNCS[0] += 1
        if torch.equal(keep, prev):
            return keep
        passes *= 2


def _sequential_keep(iou, valid, iou_thresh, eta):
    """Greedy NMS whose threshold shrinks by ``eta`` after each keep
    while it is above 0.5: one step a candidate, every group at once."""
    G, L = valid.shape
    thresh = torch.full((G,), iou_thresh, dtype=iou.dtype,
                        device=iou.device)
    keep = torch.zeros_like(valid)
    for i in range(L):
        sup = ((iou[:, i, :i] > thresh[:, None]) & keep[:, :i]).any(-1)
        ok = valid[:, i] & ~sup
        keep[:, i] = ok
        thresh = torch.where(ok & (thresh > 0.5), thresh * eta, thresh)
    return keep


def _nms_keep(boxes, valid, iou_thresh, top_k, eta=1.0, normalized=True):
    """Greedy NMS over score-sorted candidates: ``boxes`` [G, L, 4],
    ``valid`` [G, L] (a prefix of each row). Returns keep [G, L]: the
    boxes greedy NMS keeps, only the first ``top_k`` of a group."""
    G, L = valid.shape
    if G == 0 or L == 0:
        return valid
    moving = eta < 1.0 and iou_thresh > 0.5
    lower = torch.ones((L, L), dtype=torch.bool,
                       device=boxes.device).tril(-1)
    chunk = max(1, NMS_CHUNK_ELEMS // (L * L))
    keeps = []
    for g0 in range(0, G, chunk):
        bx, vd = boxes[g0:g0 + chunk], valid[g0:g0 + chunk]
        iou = iou_matrix(bx, bx, normalized)
        if moving:
            keeps.append(_sequential_keep(iou, vd, iou_thresh, eta))
        else:
            sup = (iou > iou_thresh) & lower & vd[:, None, :]
            del iou
            keeps.append(_fixed_point_keep(sup, vd))
    keep = torch.cat(keeps)
    return keep & (torch.cumsum(keep, dim=1) <= top_k)


def _candidates(scores, score_thresh):
    """The entries of each row of ``scores`` [G, M] above
    ``score_thresh``, sorted by a stable sort on the negated score (the
    reference's order, ties in index order): (index [G, L], score [G, L],
    valid [G, L]) with L the largest count of a row (one host read);
    rows are padded past their count (valid False, score -inf)."""
    G, M = scores.shape
    above = scores > score_thresh
    counts = above.sum(dim=1, keepdim=True)
    (L,) = _host(counts.max().reshape(1)) if G else (0,)
    if L == 0:
        empty = scores.new_zeros((G, 0))
        return empty.long(), empty, empty.bool()
    pos = torch.cumsum(above, dim=1) - 1
    slot = torch.where(above, pos, L)
    idx = torch.zeros((G, L + 1), dtype=torch.long, device=scores.device)
    idx.scatter_(1, slot, torch.arange(M, device=scores.device)
                 .expand(G, M))
    idx = idx[:, :L]
    valid = torch.arange(L, device=scores.device)[None, :] < counts
    neg = torch.where(valid, -torch.gather(scores, 1, idx),
                      torch.inf)
    key, order = torch.sort(neg, dim=1, stable=True)
    return torch.gather(idx, 1, order), -key, torch.gather(valid, 1, order)


@register_op("multiclass_nms",
             inputs=[IOSpec("BBoxes", no_grad=True),
                     IOSpec("Scores", no_grad=True)],
             outputs=["Out"],
             attrs={"background_label": 0, "score_threshold": 0.0,
                    "nms_top_k": 400, "nms_threshold": 0.3, "nms_eta": 1.0,
                    "keep_top_k": 100, "normalized": True}, grad=None)
def _multiclass_nms(ctx, ins, attrs):
    """Greedy NMS per image and class, then the ``keep_top_k`` best
    detections of an image: [N, K, 6] rows (label, score, x0, y0, x1,
    y1), -1-padded, K = min(keep_top_k, classes * M) (keep_top_k -1:
    classes * M), classes those other than ``background_label``. The
    order is the reference's: score, then class, then the class's sorted
    order."""
    bboxes, scores = x(ins, "BBoxes"), x(ins, "Scores")
    N, C, M = scores.shape
    bg = attrs["background_label"]
    classes = [c for c in range(C) if c != bg]
    cf = len(classes)
    keep_k = attrs["keep_top_k"]
    if keep_k is None or keep_k < 0:
        keep_k = cf * M
    k_out = min(keep_k, cf * M)
    res = torch.full((N, k_out, 6), -1.0, dtype=bboxes.dtype,
                     device=bboxes.device)
    if bboxes.is_meta or k_out == 0:
        return out(res)
    sc = scores if cf == C else torch.cat(
        [scores[:, :bg], scores[:, bg + 1:]], dim=1)
    idx, ss, valid = _candidates(sc.reshape(N * cf, M),
                                 attrs["score_threshold"])
    L = idx.shape[1]
    if L == 0:
        return out(res)
    img = torch.arange(N, device=bboxes.device)[:, None].expand(N, cf)
    sb = bboxes[img.reshape(-1, 1), idx]                   # [G, L, 4]
    top_k = attrs["nms_top_k"]
    k = min(top_k, M) if top_k and top_k > 0 else M
    keep = _nms_keep(sb, valid, attrs["nms_threshold"], k,
                     attrs.get("nms_eta", 1.0),
                     attrs.get("normalized", True))
    # the class-major rows of an image, stable-sorted by negated score
    col = torch.where(keep, ss, -torch.inf).reshape(N, cf * L)
    order = torch.sort(-col, dim=1, stable=True).indices[:, :k_out]
    n_rows = order.shape[1]
    lbl = device_const([float(c) for c in classes], bboxes.dtype,
                       bboxes.device)
    rows = torch.cat([lbl[:, None].expand(cf, L).reshape(1, cf * L, 1)
                      .expand(N, cf * L, 1),
                      ss.reshape(N, cf * L, 1),
                      sb.reshape(N, cf * L, 4)], dim=2)
    picked = torch.gather(rows, 1, order[..., None].expand(N, n_rows, 6))
    live = torch.isfinite(torch.gather(col, 1, order))
    res[:, :n_rows] = torch.where(live[..., None], picked, -1.0)
    return out(res)


# ---------------------------------------------------------------------------
# RoI align and RoI pooling
# ---------------------------------------------------------------------------

def roi_batch(rois, bidx):
    """Each RoI's image index (RoisBatchIdx, or image 0)."""
    if bidx is None:
        return torch.zeros((rois.shape[0],), dtype=torch.long,
                           device=rois.device)
    return bidx.reshape(-1).long()


def channels_last_rows(feat):
    """[B, C, H, W] -> [B * H * W, C], a row per pixel: an advanced
    index into it gathers whole channel vectors."""
    b, c, h, w = feat.shape
    return feat.permute(0, 2, 3, 1).reshape(b * h * w, c)


@register_op("roi_align",
             inputs=[IOSpec("X"), IOSpec("ROIs", no_grad=True),
                     IOSpec("RoisBatchIdx", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"spatial_scale": 1.0, "pooled_height": 1,
                    "pooled_width": 1, "sampling_ratio": -1})
def _roi_align(ctx, ins, attrs):
    """Bilinear RoI align, [R, C, ph, pw]: each bin averages an s x s
    grid of samples (``sampling_ratio`` <= 0: 4 x 4, as the JAX package
    fixes it), coordinates clipped into the map. ROIs [R, 4] are image
    coordinates; RoisBatchIdx [R] names each RoI's image."""
    feat, rois = x(ins, "X"), x(ins, "ROIs")
    bidx = roi_batch(rois, x(ins, "RoisBatchIdx"))
    B, C, H, W = feat.shape
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    scale = attrs["spatial_scale"]
    sr = attrs["sampling_ratio"]
    s = sr if sr > 0 else 4
    dev = feat.device
    r4 = rois[:, :, None, None, None, None]
    x0, y0 = r4[:, 0] * scale, r4[:, 1] * scale
    x1, y1 = r4[:, 2] * scale, r4[:, 3] * scale
    bin_w = true_div(torch.clamp(x1 - x0, min=1.0), pw)
    bin_h = true_div(torch.clamp(y1 - y0, min=1.0), ph)
    iy = float_range(ph, dev).reshape(1, ph, 1, 1, 1)
    ix = float_range(pw, dev).reshape(1, 1, pw, 1, 1)
    sy = float_range(s, dev).reshape(1, 1, 1, s, 1)
    sx = float_range(s, dev).reshape(1, 1, 1, 1, s)
    yy = torch.clamp(y0 + iy * bin_h + true_div((sy + 0.5) * bin_h, s),
                     0.0, H - 1)
    xx = torch.clamp(x0 + ix * bin_w + true_div((sx + 0.5) * bin_w, s),
                     0.0, W - 1)
    y_lo, x_lo = torch.floor(yy).long(), torch.floor(xx).long()
    y_hi = torch.clamp(y_lo + 1, max=H - 1)
    x_hi = torch.clamp(x_lo + 1, max=W - 1)
    ly, lx = yy - y_lo, xx - x_lo
    table = channels_last_rows(feat)
    base = bidx.reshape(-1, 1, 1, 1, 1) * (H * W)

    def gather(yi, xi):
        return table[base + yi * W + xi]           # [R, ph, pw, s, s, C]

    v = gather(y_lo, x_lo) * ((1 - ly) * (1 - lx))[..., None] + \
        gather(y_lo, x_hi) * ((1 - ly) * lx)[..., None] + \
        gather(y_hi, x_lo) * (ly * (1 - lx))[..., None] + \
        gather(y_hi, x_hi) * (ly * lx)[..., None]
    return out(v.mean(dim=(3, 4)).permute(0, 3, 1, 2))


# elements of roi_pool's gathered windows at once
ROI_POOL_CHUNK_ELEMS = 1 << 26


@register_op("roi_pool",
             inputs=[IOSpec("X"), IOSpec("ROIs", no_grad=True),
                     IOSpec("RoisBatchIdx", optional=True, no_grad=True)],
             outputs=["Out", IOSpec("Argmax", optional=True, no_grad=True)],
             attrs={"spatial_scale": 1.0, "pooled_height": 1,
                    "pooled_width": 1})
def _roi_pool(ctx, ins, attrs):
    """Max pooling over quantised bins, [R, C, ph, pw]; an empty bin is
    0. Each bin's maximum is one ``amax`` over a window the size of the
    largest bin (read on the host once), the positions outside the bin
    masked to float32's lowest value as the reference masks them."""
    feat, rois = x(ins, "X"), x(ins, "ROIs")
    bidx = roi_batch(rois, x(ins, "RoisBatchIdx"))
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    scale = attrs["spatial_scale"]
    B, C, H, W = feat.shape
    R = rois.shape[0]
    dev = feat.device
    if feat.is_meta:
        return {"Out": [feat.new_empty((R, C, ph, pw))]}
    q = torch.round(rois * scale).long()
    x0, y0, x1, y1 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    rh = torch.clamp(y1 - y0 + 1, min=1)
    rw = torch.clamp(x1 - x0 + 1, min=1)
    py = torch.arange(ph, device=dev)[None, :]
    px = torch.arange(pw, device=dev)[None, :]
    # the reference's bounds: floor/ceil of an int32 product over the
    # pooled size, in float32
    ys = torch.clamp(y0 + torch.floor(true_div((py * rh).float(), ph))
                     .long(), 0, H)
    ye = torch.clamp(y0 + torch.ceil(true_div(((py + 1) * rh).float(), ph))
                     .long(), 0, H)
    xs = torch.clamp(x0 + torch.floor(true_div((px * rw).float(), pw))
                     .long(), 0, W)
    xe = torch.clamp(x0 + torch.ceil(true_div(((px + 1) * rw).float(), pw))
                     .long(), 0, W)
    if R == 0:
        return {"Out": [feat.new_zeros((0, C, ph, pw))]}
    bh, bw = _host(torch.stack([(ye - ys).max(), (xe - xs).max()]))
    bh, bw = max(bh, 1), max(bw, 1)
    table = channels_last_rows(feat)
    neg = torch.finfo(feat.dtype).min
    per_roi = ph * pw * bh * bw * C
    chunk = max(1, ROI_POOL_CHUNK_ELEMS // per_roi)
    res = []
    for r0 in range(0, R, chunk):
        sl = slice(r0, r0 + chunk)
        wy = ys[sl, :, None] + torch.arange(bh, device=dev)   # [r, ph, bh]
        wx = xs[sl, :, None] + torch.arange(bw, device=dev)   # [r, pw, bw]
        my = wy < ye[sl, :, None]
        mx = wx < xe[sl, :, None]
        wy = torch.clamp(wy, max=H - 1)
        wx = torch.clamp(wx, max=W - 1)
        rows = (bidx[sl].reshape(-1, 1, 1, 1, 1) * (H * W)
                + wy[:, :, None, :, None] * W + wx[:, None, :, None, :])
        m = my[:, :, None, :, None] & mx[:, None, :, None, :]
        vals = torch.where(m[..., None], table[rows], neg)
        top = torch.amax(vals.flatten(3, 4), dim=3)           # [r,ph,pw,C]
        res.append(torch.where(top == neg, 0.0, top))
    return {"Out": [torch.cat(res).permute(0, 3, 1, 2)]}


# ---------------------------------------------------------------------------
# RPN / FPN proposal pipeline
# ---------------------------------------------------------------------------

def _decode_proposals(anchors, deltas, variances):
    """Deltas [..., K, 4] around anchors [K, 4] to pixel boxes, the
    width and height deltas capped at log(1000 / 16) before the exp."""
    wa = anchors[:, 2] - anchors[:, 0] + 1.0
    ha = anchors[:, 3] - anchors[:, 1] + 1.0
    cxa = anchors[:, 0] + 0.5 * wa
    cya = anchors[:, 1] + 0.5 * ha
    dx, dy, dw, dh = deltas.unbind(-1)
    if variances is not None:
        dx = dx * variances[:, 0]
        dy = dy * variances[:, 1]
        dw = dw * variances[:, 2]
        dh = dh * variances[:, 3]
    cx = dx * wa + cxa
    cy = dy * ha + cya
    w = torch.exp(torch.clamp(dw, max=BBOX_CLIP)) * wa
    h = torch.exp(torch.clamp(dh, max=BBOX_CLIP)) * ha
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], dim=-1)


@register_op("generate_proposals",
             inputs=[IOSpec("Scores", no_grad=True),
                     IOSpec("BboxDeltas", no_grad=True),
                     IOSpec("ImInfo", no_grad=True),
                     IOSpec("Anchors", no_grad=True),
                     IOSpec("Variances", optional=True, no_grad=True)],
             outputs=["RpnRois", "RpnRoiProbs", "RpnRoisNum"],
             attrs={"pre_nms_topN": 6000, "post_nms_topN": 1000,
                    "nms_thresh": 0.5, "min_size": 0.1, "eta": 1.0},
             grad=None)
def _generate_proposals(ctx, ins, attrs):
    """RPN proposals: decode the deltas around the anchors, clip to the
    image, drop boxes under ``min_size`` (times the image scale), keep
    the ``pre_nms_topN`` best by score, NMS, keep ``post_nms_topN``:
    RpnRois [N, post, 4] -1-padded, RpnRoiProbs [N, post, 1] (0 past the
    count), RpnRoisNum [N] int32."""
    scores = x(ins, "Scores")            # [N, A, H, W]
    deltas = x(ins, "BboxDeltas")        # [N, 4A, H, W]
    im_info = x(ins, "ImInfo")           # [N, 3] (h, w, scale)
    anchors = x(ins, "Anchors").reshape(-1, 4)
    variances = x(ins, "Variances")
    if variances is not None:
        variances = variances.reshape(-1, 4)
    n, a, h, w = scores.shape
    pre_k = min(int(attrs["pre_nms_topN"]), a * h * w)
    post_k = min(int(attrs["post_nms_topN"]), pre_k)
    dt, dev = scores.dtype, scores.device
    rois = torch.full((n, post_k + 1, 4), -1.0, dtype=dt, device=dev)
    probs = torch.zeros((n, post_k + 1), dtype=dt, device=dev)
    if scores.is_meta:
        return {"RpnRois": [rois[:, :post_k]],
                "RpnRoiProbs": [probs[:, :post_k, None]],
                "RpnRoisNum": [torch.zeros((n,), dtype=torch.int32,
                                           device=dev)]}
    s_flat = scores.permute(0, 2, 3, 1).reshape(n, -1)   # H, W, A order
    d_flat = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    boxes = _decode_proposals(anchors, d_flat, variances)
    img_h = im_info[:, 0:1]
    img_w = im_info[:, 1:2]
    zero = torch.zeros((), dtype=dt, device=dev)
    boxes = torch.stack([_clip(boxes[..., 0], zero, img_w - 1.0),
                         _clip(boxes[..., 1], zero, img_h - 1.0),
                         _clip(boxes[..., 2], zero, img_w - 1.0),
                         _clip(boxes[..., 3], zero, img_h - 1.0)], dim=-1)
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    ms = max(float(attrs["min_size"]), 1.0) * im_info[:, 2:3]
    s_masked = torch.where((ws >= ms) & (hs >= ms), s_flat, -torch.inf)
    top = torch.sort(-s_masked, dim=1, stable=True).indices[:, :pre_k]
    tb = torch.gather(boxes, 1, top[..., None].expand(n, pre_k, 4))
    ts = torch.gather(s_masked, 1, top)
    keep = _nms_keep(tb, ts > -torch.inf, float(attrs["nms_thresh"]),
                     post_k, float(attrs.get("eta", 1.0)),
                     normalized=False)
    rank = torch.where(keep, torch.cumsum(keep, dim=1) - 1, post_k)
    rois.scatter_(1, rank[..., None].expand(n, pre_k, 4), tb)
    probs.scatter_(1, rank, ts)
    count = keep.sum(dim=1).clamp(max=post_k).to(torch.int32)
    return {"RpnRois": [rois[:, :post_k]],
            "RpnRoiProbs": [probs[:, :post_k, None]],
            "RpnRoisNum": [count]}


@register_op("distribute_fpn_proposals",
             inputs=[IOSpec("FpnRois", no_grad=True),
                     IOSpec("RoisNum", optional=True, no_grad=True)],
             outputs=[IOSpec("MultiFpnRois", duplicable=True),
                      IOSpec("MultiLevelRoIsNum", duplicable=True),
                      IOSpec("RestoreIndex")],
             attrs={"min_level": 2, "max_level": 5, "refer_level": 4,
                    "refer_scale": 224, "pixel_offset": True}, grad=None)
def _distribute_fpn_proposals(ctx, ins, attrs):
    """Route each RoI to its FPN level, floor(log2(sqrt(area) /
    refer_scale)) + refer_level clipped to [min, max]. Each level's RoIs
    are front-compacted into an [R, 4] -1-padded tensor with a [1]
    count; RestoreIndex [R, 1] gives each RoI's row in the level-sorted
    concatenation (-1 for padding rows, which reach no level)."""
    rois = x(ins, "FpnRois")
    r = rois.shape[0]
    dev = rois.device
    rois_num = x(ins, "RoisNum")
    pos = torch.arange(r, device=dev)
    valid = rois[:, 2] >= 0
    if rois_num is not None:
        counts = rois_num.reshape(-1)
        n_img = counts.shape[0]
        if r % n_img == 0:
            blk = r // n_img
            valid = valid & ((pos % blk) < counts[pos // blk])
        else:
            valid = valid & (pos < counts.sum())
    off = 1.0 if attrs.get("pixel_offset", True) else 0.0
    ws = rois[:, 2] - rois[:, 0] + off
    hs = rois[:, 3] - rois[:, 1] + off
    lo, hi = int(attrs["min_level"]), int(attrs["max_level"])
    scale = torch.sqrt(torch.clamp(ws * hs, min=1e-6))
    lvl = torch.floor(torch.log2(true_div(scale, float(attrs["refer_scale"]))
                                 + 1e-12)) + int(attrs["refer_level"])
    lvl = torch.clamp(lvl, lo, hi).to(torch.int32)
    lvl = torch.where(valid, lvl, hi + 1)       # padding: no level, last
    order = torch.sort(lvl, stable=True).indices
    restore = torch.empty_like(order)
    restore[order] = pos
    restore = torch.where(valid, restore.to(torch.int32), -1)
    multi_rois, multi_num = [], []
    for level in range(lo, hi + 1):
        is_l = lvl == level
        rank = torch.where(is_l, torch.cumsum(is_l, 0) - 1, r)
        out_l = torch.full((r + 1, 4), -1.0, dtype=rois.dtype, device=dev)
        out_l[rank] = rois
        multi_rois.append(out_l[:r])
        multi_num.append(is_l.sum().to(torch.int32).reshape(1))
    return {"MultiFpnRois": multi_rois, "MultiLevelRoIsNum": multi_num,
            "RestoreIndex": [restore[:, None]]}


@register_op("collect_fpn_proposals",
             inputs=[IOSpec("MultiLevelRois", duplicable=True, no_grad=True),
                     IOSpec("MultiLevelScores", duplicable=True,
                            no_grad=True),
                     IOSpec("MultiLevelRoIsNum", duplicable=True,
                            optional=True, no_grad=True)],
             outputs=["FpnRois", "RoisNum"],
             attrs={"post_nms_topN": 100}, grad=None)
def _collect_fpn_proposals(ctx, ins, attrs):
    """The ``post_nms_topN`` best RoIs of every level by score (a stable
    sort on the negated score), -1-padded, and their count [1]; padding
    rows (negative x1) are absent."""
    all_rois = torch.cat([v for v in ins.get("MultiLevelRois", [])
                          if v is not None], dim=0)
    all_scores = torch.cat([s.reshape(-1) for s in
                            ins.get("MultiLevelScores", []) if s is not None])
    masked = torch.where(all_rois[:, 2] >= 0, all_scores, -torch.inf)
    k = min(int(attrs["post_nms_topN"]), all_rois.shape[0])
    top = torch.sort(-masked, stable=True).indices[:k]
    sel_valid = torch.isfinite(masked[top])
    sel = torch.where(sel_valid[:, None], all_rois[top], -1.0)
    return {"FpnRois": [sel],
            "RoisNum": [sel_valid.sum().to(torch.int32).reshape(1)]}
