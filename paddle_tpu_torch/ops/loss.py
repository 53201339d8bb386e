"""Loss, reduction and metric ops (counterpart of
``paddle_tpu/ops/loss.py``), the ones BERT pretraining and the MLP run."""
from __future__ import annotations

import torch

from .common import IOSpec, out, register_op, x


@register_op("mean", inputs=["X"], outputs=["Out"])
def _mean(ctx, ins, attrs):
    return out(torch.mean(x(ins)))


@register_op("reduce_sum", inputs=["X"], outputs=["Out"],
             attrs={"dim": [0], "keep_dim": False, "reduce_all": False})
def _reduce_sum(ctx, ins, attrs):
    xv = x(ins)
    if attrs.get("reduce_all"):
        dims = tuple(range(xv.dim()))
    else:
        dims = tuple(a if a >= 0 else a + xv.dim()
                     for a in attrs.get("dim", [0]))
    return out(torch.sum(xv, dim=dims, keepdim=attrs.get("keep_dim", False)))


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
