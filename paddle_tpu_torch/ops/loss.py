"""Loss, reduction and metric ops (counterpart of
``paddle_tpu/ops/loss.py``, every op type of it)."""
from __future__ import annotations

import torch

from .common import IOSpec, out, register_op, x


def _float_mean(v, *args, **kwargs):
    """``jnp.mean``'s promotion: an integer or bool mean is float32."""
    if not (v.is_floating_point() or v.is_complex()):
        v = v.to(torch.float32)
    return torch.mean(v, *args, **kwargs)


def _int32_kept(v):
    """The ``dtype`` of a sum or product that keeps an int32 input int32,
    as ``jnp``'s does (torch widens every integer to int64)."""
    return torch.int32 if v.dtype == torch.int32 else None


@register_op("mean", inputs=["X"], outputs=["Out"])
def _mean(ctx, ins, attrs):
    return out(_float_mean(x(ins)))


def _over_last(fn):
    """A reduction of one dim applied to several: the reduced dims move
    last and flatten into one (``torch.prod``/``all``/``any`` take a
    single dim)."""
    def reduce(xv, dims, keepdim):
        keep = [d for d in range(xv.dim()) if d not in dims]
        flat = xv.permute(*keep, *dims).reshape(
            [xv.shape[d] for d in keep] + [-1])
        res = fn(flat, dim=-1)
        if keepdim:
            res = res.reshape([1 if d in dims else xv.shape[d]
                               for d in range(xv.dim())])
        return res
    return reduce


def _reduce(reduce):
    """The rule of a ``reduce_*`` op: over ``dim`` (negative counted from
    the end) or every dim (``reduce_all``)."""
    def lower(ctx, ins, attrs):
        xv = x(ins)
        if attrs.get("reduce_all"):
            dims = tuple(range(xv.dim()))
        else:
            dims = tuple(sorted({a if a >= 0 else a + xv.dim()
                                 for a in attrs.get("dim", [0])}))
        return out(reduce(xv, dims, attrs.get("keep_dim", False)))
    return lower


_REDUCE_ATTRS = {"dim": [0], "keep_dim": False, "reduce_all": False}
for _name, _fn in [
    # an int32 sum or product stays int32, an integer mean is float32,
    # as jnp's
    ("reduce_sum", lambda v, d, k: torch.sum(
        v, dim=d, keepdim=k, dtype=_int32_kept(v))),
    ("reduce_mean", lambda v, d, k: _float_mean(v, dim=d, keepdim=k)),
    # amax/amin split the grad evenly between equal maxima, as jnp.max's
    ("reduce_max", lambda v, d, k: torch.amax(v, dim=d, keepdim=k)),
    ("reduce_min", lambda v, d, k: torch.amin(v, dim=d, keepdim=k)),
    ("reduce_prod", _over_last(lambda v, dim: torch.prod(
        v, dim=dim, dtype=_int32_kept(v)))),
]:
    register_op(_name, inputs=["X"], outputs=["Out"],
                attrs=_REDUCE_ATTRS)(_reduce(_fn))
for _name, _fn in [("reduce_all", torch.all), ("reduce_any", torch.any)]:
    register_op(_name, inputs=["X"], outputs=["Out"], attrs=_REDUCE_ATTRS,
                grad=None)(_reduce(_over_last(_fn)))


@register_op("softmax_with_cross_entropy",
             inputs=[IOSpec("Logits"), IOSpec("Label", no_grad=True)],
             outputs=["Softmax", "Loss"],
             attrs={"soft_label": False, "ignore_index": -100, "axis": -1,
                    "numeric_stable_mode": True})
def _softmax_with_cross_entropy(ctx, ins, attrs):
    """Hard labels have size 1 on ``axis`` (or lack the axis); a label
    equal to ``ignore_index`` gives loss 0."""
    logits, label = x(ins, "Logits"), x(ins, "Label")
    axis = attrs.get("axis", -1)
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if attrs.get("soft_label"):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label
        if not (lbl.dim() == logits.dim() and lbl.shape[axis] == 1):
            lbl = lbl.unsqueeze(axis)
        lbl = lbl.long()
        ignored = lbl == attrs.get("ignore_index", -100)
        picked = torch.take_along_dim(
            logp, torch.where(ignored, torch.zeros_like(lbl), lbl), dim=axis)
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    return {"Softmax": [softmax], "Loss": [loss]}


@register_op("accuracy",
             inputs=[IOSpec("Out", no_grad=True),
                     IOSpec("Indices", no_grad=True),
                     IOSpec("Label", no_grad=True)],
             outputs=["Accuracy", "Correct", "Total"], grad=None)
def _accuracy(ctx, ins, attrs):
    """Share of rows whose label is among the top-k ``Indices``; Correct
    and Total are int32 counts."""
    idx, label = x(ins, "Indices"), x(ins, "Label")
    lbl = label.reshape(-1, 1).to(idx.dtype)
    correct = (idx == lbl).any(dim=1).float().sum()
    rows = idx.shape[0]
    return {"Accuracy": [(correct / rows).reshape((1,))],
            "Correct": [correct.to(torch.int32).reshape((1,))],
            "Total": [torch.full((1,), rows, dtype=torch.int32,
                                 device=idx.device)]}


@register_op("cross_entropy",
             inputs=[IOSpec("X"), IOSpec("Label", no_grad=True)],
             outputs=["Y"],
             attrs={"soft_label": False, "ignore_index": -100})
def _cross_entropy(ctx, ins, attrs):
    """-log of the probability X gives the label (X holds
    probabilities; 1e-12 keeps the log finite)."""
    xv, label = x(ins, "X"), x(ins, "Label")
    eps = 1e-12
    if attrs.get("soft_label"):
        y = -torch.sum(label * torch.log(xv + eps), dim=-1, keepdim=True)
    else:
        lbl = (label if label.dim() == xv.dim()
               else label.unsqueeze(-1)).long()
        ignored = lbl == attrs.get("ignore_index", -100)
        picked = torch.take_along_dim(
            xv, torch.where(ignored, torch.zeros_like(lbl), lbl), dim=-1)
        y = torch.where(ignored, torch.zeros_like(picked),
                        -torch.log(picked + eps))
    return {"Y": [y]}


@register_op("sigmoid_cross_entropy_with_logits",
             inputs=[IOSpec("X"), IOSpec("Label", no_grad=True)],
             outputs=["Out"], attrs={"ignore_index": -100,
                                     "normalize": False})
def _sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    xv, lbl = x(ins, "X"), x(ins, "Label")
    loss = torch.clamp(xv, min=0) - xv * lbl + torch.log1p(
        torch.exp(-torch.abs(xv)))
    ignored = lbl == attrs.get("ignore_index", -100)
    loss = torch.where(ignored, torch.zeros_like(loss), loss)
    if attrs.get("normalize"):
        loss = loss / torch.clamp((~ignored).to(loss.dtype).sum(), min=1.0)
    return out(loss)


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def _square_error_cost(ctx, ins, attrs):
    return out(torch.square(x(ins, "X") - x(ins, "Y")))


@register_op("huber_loss", inputs=[IOSpec("X"), IOSpec("Y", no_grad=True)],
             outputs=["Out", "Residual"], attrs={"delta": 1.0})
def _huber_loss(ctx, ins, attrs):
    xv, yv = x(ins, "X"), x(ins, "Y")
    d = attrs["delta"]
    r = yv - xv
    ar = torch.abs(r)
    return {"Out": [torch.where(ar <= d, 0.5 * r * r, d * (ar - 0.5 * d))],
            "Residual": [r]}


@register_op("smooth_l1_loss",
             inputs=[IOSpec("X"), IOSpec("Y", no_grad=True),
                     IOSpec("InsideWeight", optional=True, no_grad=True),
                     IOSpec("OutsideWeight", optional=True, no_grad=True)],
             outputs=["Out", "Diff"], attrs={"sigma": 1.0})
def _smooth_l1_loss(ctx, ins, attrs):
    """Per-row sum of the smooth-L1 of (X - Y) * InsideWeight, times
    OutsideWeight, as a [N, 1] column."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    iw, ow = x(ins, "InsideWeight"), x(ins, "OutsideWeight")
    sigma2 = attrs["sigma"] ** 2
    diff = xv - yv
    if iw is not None:
        diff = diff * iw
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       ad - 0.5 / sigma2)
    if ow is not None:
        loss = loss * ow
    return {"Out": [loss.reshape(xv.shape[0], -1).sum(1, keepdim=True)],
            "Diff": [diff]}


@register_op("log_loss", inputs=[IOSpec("Predicted"),
                                 IOSpec("Labels", no_grad=True)],
             outputs=["Loss"], attrs={"epsilon": 1e-4})
def _log_loss(ctx, ins, attrs):
    p, lbl = x(ins, "Predicted"), x(ins, "Labels")
    eps = attrs["epsilon"]
    return {"Loss": [-lbl * torch.log(p + eps)
                     - (1 - lbl) * torch.log(1 - p + eps)]}


def _bincount_add(n, idx, vals):
    """A length-``n`` vector of ``vals`` summed at ``idx``, in an order
    fixed for the inputs (sorted ``index_put_``, no atomics)."""
    res = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    return res.index_put_((idx.long(),), vals, accumulate=True)


@register_op("auc",
             inputs=[IOSpec("Predict", no_grad=True),
                     IOSpec("Label", no_grad=True),
                     IOSpec("StatPos", no_grad=True),
                     IOSpec("StatNeg", no_grad=True)],
             outputs=["AUC", "StatPosOut", "StatNegOut"],
             attrs={"curve": "ROC", "num_thresholds": 4095}, grad=None)
def _auc(ctx, ins, attrs):
    """ROC AUC over ``num_thresholds + 1`` score bins, accumulated into
    the positive/negative histograms StatPos/StatNeg (trapezoids over the
    thresholds, highest first)."""
    pred, label = x(ins, "Predict"), x(ins, "Label")
    pos_stat, neg_stat = x(ins, "StatPos"), x(ins, "StatNeg")
    nt = attrs["num_thresholds"]
    p1 = pred[:, 1] if pred.dim() == 2 and pred.shape[1] == 2 \
        else pred.reshape(-1)
    lbl = label.reshape(-1).long()
    bins = torch.clamp((p1 * nt).to(torch.int32), 0, nt)
    pos = pos_stat.reshape(-1) + _bincount_add(nt + 1, bins, lbl).to(
        pos_stat.dtype)
    neg = neg_stat.reshape(-1) + _bincount_add(nt + 1, bins, 1 - lbl).to(
        neg_stat.dtype)
    tp = torch.cumsum(torch.flip(pos, (0,)), 0)
    fp = torch.cumsum(torch.flip(neg, (0,)), 0)
    tpr = tp / torch.clamp(tp[-1], min=1)
    fpr = fp / torch.clamp(fp[-1], min=1)
    return {"AUC": [torch.trapezoid(tpr, fpr).reshape((1,))],
            "StatPosOut": [pos.reshape(pos_stat.shape)],
            "StatNegOut": [neg.reshape(neg_stat.shape)]}


@register_op("kldiv_loss", inputs=[IOSpec("X"),
                                   IOSpec("Target", no_grad=True)],
             outputs=["Loss"], attrs={"reduction": "mean"})
def _kldiv_loss(ctx, ins, attrs):
    """X holds log-probabilities, Target probabilities (reference
    kldiv_loss_op.h); a zero target contributes 0."""
    xv, t = x(ins, "X"), x(ins, "Target")
    logt = torch.where(t > 0, torch.log(torch.where(t > 0, t,
                                                    torch.ones_like(t))),
                       torch.zeros_like(t))
    loss = t * (logt - xv)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / xv.shape[0]
    return {"Loss": [loss]}


@register_op("hinge_loss", inputs=[IOSpec("Logits"),
                                   IOSpec("Labels", no_grad=True)],
             outputs=["Loss"])
def _hinge_loss(ctx, ins, attrs):
    """Labels in {0, 1} (reference hinge_loss_op.h)."""
    logits, labels = x(ins, "Logits"), x(ins, "Labels")
    signs = 2.0 * labels.to(logits.dtype) - 1.0
    return {"Loss": [torch.clamp(1.0 - signs * logits, min=0.0)]}


@register_op("margin_rank_loss",
             inputs=[IOSpec("Label", no_grad=True), IOSpec("X1"),
                     IOSpec("X2")],
             outputs=["Out", IOSpec("Activated", no_grad=True)],
             attrs={"margin": 0.0})
def _margin_rank_loss(ctx, ins, attrs):
    lbl, x1, x2 = x(ins, "Label"), x(ins, "X1"), x(ins, "X2")
    raw = -lbl * (x1 - x2) + attrs["margin"]
    return {"Out": [torch.clamp(raw, min=0.0)],
            "Activated": [(raw > 0).to(x1.dtype)]}


@register_op("rank_loss", inputs=[IOSpec("Label", no_grad=True),
                                  IOSpec("Left"), IOSpec("Right")],
             outputs=["Out"])
def _rank_loss(ctx, ins, attrs):
    """RankNet's pairwise loss (reference rank_loss_op.h)."""
    lbl, left, right = x(ins, "Label"), x(ins, "Left"), x(ins, "Right")
    d = left - right
    return out(torch.logaddexp(torch.zeros_like(d), d) - lbl * d)


@register_op("bpr_loss", inputs=[IOSpec("X"), IOSpec("Label", no_grad=True)],
             outputs=["Y"])
def _bpr_loss(ctx, ins, attrs):
    """Bayesian personalised ranking over logits [N, C] with the positive
    item's label [N, 1] (reference bpr_loss_op.h)."""
    xv, lbl = x(ins, "X"), x(ins, "Label")
    n, c = xv.shape
    idx = lbl.reshape(-1, 1).long()
    loss = -torch.log(torch.sigmoid(torch.take_along_dim(xv, idx, 1) - xv)
                      + 1e-8)
    mask = torch.arange(c, device=xv.device)[None, :] != idx
    return {"Y": [(loss * mask.to(xv.dtype)).sum(1, keepdim=True)
                  / (c - 1)]}


@register_op("cos_sim", inputs=[IOSpec("X"), IOSpec("Y")],
             outputs=["Out", IOSpec("XNorm", optional=True, no_grad=True),
                      IOSpec("YNorm", optional=True, no_grad=True)])
def _cos_sim(ctx, ins, attrs):
    xv, yv = x(ins, "X"), x(ins, "Y")
    xn = torch.sqrt((xv * xv).sum(-1, keepdim=True))
    yn = torch.sqrt((yv * yv).sum(-1, keepdim=True))
    return {"Out": [(xv * yv).sum(-1, keepdim=True) / (xn * yn + 1e-12)],
            "XNorm": [xn], "YNorm": [yn]}


@register_op("mean_iou", inputs=[IOSpec("Predictions", no_grad=True),
                                 IOSpec("Labels", no_grad=True)],
             outputs=["OutMeanIou", "OutWrong", "OutCorrect"],
             attrs={"num_classes": 2}, grad=None)
def _mean_iou(ctx, ins, attrs):
    """Mean IoU over the classes present (reference mean_iou_op.h); a
    mismatch counts as wrong for both the predicted and the true class."""
    pred = x(ins, "Predictions").reshape(-1).long()
    lbl = x(ins, "Labels").reshape(-1).long()
    nc = attrs["num_classes"]
    hit = pred == lbl
    inter = _bincount_add(nc, torch.where(hit, pred, nc - 1),
                          hit.to(torch.float32))
    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    union = _bincount_add(nc, pred, ones) + _bincount_add(nc, lbl, ones) \
        - inter
    present = union > 0
    iou = torch.where(present, inter / torch.where(
        present, union, torch.ones_like(union)), torch.zeros_like(union))
    miou = iou.sum() / torch.clamp(present.sum(), min=1)
    miss = (~hit).to(torch.float32)
    wrong = _bincount_add(nc, torch.cat([pred, lbl]), torch.cat([miss, miss]))
    return {"OutMeanIou": [miou], "OutWrong": [wrong.to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


def _pr_metrics(s):
    """(macro precision, recall, F1, micro precision, recall, F1) of
    per-class [TP, FP, TN, FN] rows."""
    tp, fp, fn = s[:, 0], s[:, 1], s[:, 3]
    zero = torch.zeros_like(tp)
    prec = torch.where(tp + fp > 0, tp / (tp + fp + 1e-12), zero)
    rec = torch.where(tp + fn > 0, tp / (tp + fn + 1e-12), zero)
    f1 = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec + 1e-12),
                     zero)
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    z = torch.zeros_like(tps)
    mp = torch.where(tps + fps > 0, tps / (tps + fps + 1e-12), z)
    mr = torch.where(tps + fns > 0, tps / (tps + fns + 1e-12), z)
    mf = torch.where(mp + mr > 0, 2 * mp * mr / (mp + mr + 1e-12), z)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])


@register_op("precision_recall",
             inputs=[IOSpec("MaxProbs", no_grad=True),
                     IOSpec("Indices", no_grad=True),
                     IOSpec("Labels", no_grad=True),
                     IOSpec("Weights", optional=True, no_grad=True),
                     IOSpec("StatesInfo", optional=True, no_grad=True)],
             outputs=["BatchMetrics", "AccumMetrics", "AccumStatesInfo"],
             attrs={"class_number": 2}, grad=None)
def _precision_recall(ctx, ins, attrs):
    """Per-class TP/FP/FN of the batch (weighted), the macro and micro
    precision, recall and F1 of the batch and of the accumulated states
    (reference precision_recall_op.h)."""
    idx = x(ins, "Indices").reshape(-1).long()
    lbl = x(ins, "Labels").reshape(-1).long()
    wts = x(ins, "Weights")
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device) \
        if wts is None else wts.reshape(-1).to(torch.float32)
    nc = attrs["class_number"]
    hit = idx == lbl
    miss = (~hit).to(torch.float32) * w
    tp = _bincount_add(nc, torch.where(hit, idx, 0), hit.to(torch.float32) * w)
    fp = _bincount_add(nc, idx, miss)
    fn = _bincount_add(nc, lbl, miss)
    states = torch.stack([tp, fp, torch.zeros_like(tp), fn], dim=1)
    prev = x(ins, "StatesInfo")
    acc = states if prev is None else states + prev
    return {"BatchMetrics": [_pr_metrics(states)],
            "AccumMetrics": [_pr_metrics(acc)],
            "AccumStatesInfo": [acc]}
