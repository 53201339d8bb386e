"""Loss-scaling ops of mixed precision (counterpart of
``paddle_tpu/ops/amp_ops.py``): the gradient finiteness check with
unscaling, and the dynamic loss-scale state machine. bf16 training needs
neither (float32's exponent range); they run only when the AMP decorator
is asked for loss scaling."""
from __future__ import annotations

import torch

from ..core.selected_rows import SelectedRows, is_selected_rows
from .common import IOSpec, register_op, x


def _no_infer(op, block):
    """Outputs keep the shapes and types they were created with."""


@register_op("check_finite_and_unscale",
             inputs=[IOSpec("X", duplicable=True), IOSpec("Scale")],
             outputs=[IOSpec("Out", duplicable=True),
                      IOSpec("FoundInfinite")],
             grad=None, infer_shape=_no_infer)
def _check_finite_and_unscale(ctx, ins, attrs):
    """Out_i = X_i / Scale, zeroed when any X_i holds a non-finite
    element; FoundInfinite [1] is that flag. A SelectedRows X is checked
    and unscaled over its values and keeps its rows. Stays on the device:
    no host read."""
    xs = ins.get("X", [])
    scale = x(ins, "Scale").reshape(()).float()
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for v in xs:
        vals = v.values if is_selected_rows(v) else v
        found = found | ~torch.isfinite(vals.float()).all()
    outs = []
    for v in xs:
        vals = v.values if is_selected_rows(v) else v
        unscaled = (vals.float() / scale).to(vals.dtype)
        res = torch.where(found, torch.zeros_like(unscaled), unscaled)
        outs.append(SelectedRows(v.rows, res, v.height)
                    if is_selected_rows(v) else res)
    return {"Out": outs, "FoundInfinite": [found.reshape((1,))]}


@register_op("update_loss_scaling",
             inputs=[IOSpec("FoundInfinite"), IOSpec("PrevLossScaling"),
                     IOSpec("InGoodSteps"), IOSpec("InBadSteps")],
             outputs=["LossScaling", "OutGoodSteps", "OutBadSteps"],
             attrs={"incr_every_n_steps": 1000,
                    "decr_every_n_nan_or_inf": 2,
                    "incr_ratio": 2.0, "decr_ratio": 0.5},
             grad=None, infer_shape=_no_infer)
def _update_loss_scaling(ctx, ins, attrs):
    """Grow the scale by ``incr_ratio`` after ``incr_every_n_steps``
    finite steps in a row; shrink it by ``decr_ratio`` (not below 1) after
    ``decr_every_n_nan_or_inf`` non-finite ones; either resets both
    counters."""
    found = x(ins, "FoundInfinite").reshape(()).bool()
    scale = x(ins, "PrevLossScaling").reshape(()).float()
    good = x(ins, "InGoodSteps").reshape(()).int()
    bad = x(ins, "InBadSteps").reshape(()).int()
    zero = torch.zeros_like(good)
    new_good = torch.where(found, zero, good + 1)
    new_bad = torch.where(found, bad + 1, zero)
    do_incr = new_good >= int(attrs["incr_every_n_steps"])
    do_decr = new_bad >= int(attrs["decr_every_n_nan_or_inf"])
    shrunk = torch.clamp(scale * float(attrs["decr_ratio"]), min=1.0)
    new_scale = torch.where(do_incr, scale * float(attrs["incr_ratio"]),
                            torch.where(do_decr, shrunk, scale))
    new_good = torch.where(do_incr | do_decr, zero, new_good)
    new_bad = torch.where(do_incr | do_decr, zero, new_bad)
    return {"LossScaling": [new_scale.reshape((1,))],
            "OutGoodSteps": [new_good.reshape((1,))],
            "OutBadSteps": [new_bad.reshape((1,))]}
