"""Optimizer update ops (counterpart of
``paddle_tpu/ops/optimizer_ops.py``): ``sgd``, ``momentum`` and ``adam``,
dense gradients (SelectedRows gradients wait with sparse embeddings)."""
from __future__ import annotations

import torch

from .common import register_op, x


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], grad=None)
def _sgd(ctx, ins, attrs):
    p = x(ins, "Param")
    lr = x(ins, "LearningRate").reshape(()).to(p.dtype)
    return {"ParamOut": [p - lr * x(ins, "Grad").to(p.dtype)]}


@register_op("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"],
             attrs={"mu": 0.9, "use_nesterov": False,
                    "regularization_method": "", "regularization_coeff": 0.0},
             grad=None)
def _momentum(ctx, ins, attrs):
    """v' = mu v + g; p' = p - lr v' (Nesterov: p - lr (g + mu v')).
    ``regularization_method="l2_decay"`` folds ``coeff * p`` into g."""
    p, v = x(ins, "Param"), x(ins, "Velocity")
    lr = x(ins, "LearningRate").reshape(())
    mu = attrs["mu"]
    g = x(ins, "Grad").to(p.dtype)
    if attrs.get("regularization_method") == "l2_decay":
        g = g + attrs["regularization_coeff"] * p
    v_out = mu * v + g
    if attrs.get("use_nesterov"):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("adam",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"],
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                    "lazy_mode": False},
             grad=None)
def _adam(ctx, ins, attrs):
    """Bias correction uses the current pow accumulators (beta at step 1),
    which advance afterwards, as the reference's adam_op.h."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    lr = x(ins, "LearningRate").reshape(())
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow").reshape(()), x(ins, "Beta2Pow").reshape(())
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    g = g.to(p.dtype)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [(b1p * b1).reshape((1,))],
            "Beta2PowOut": [(b2p * b2).reshape((1,))]}
