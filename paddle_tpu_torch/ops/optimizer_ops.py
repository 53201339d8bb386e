"""Optimizer update ops (counterpart of
``paddle_tpu/ops/optimizer_ops.py``): ``sgd`` and ``adam``, dense
gradients."""
from __future__ import annotations

import torch

from .common import register_op, x


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], grad=None)
def _sgd(ctx, ins, attrs):
    p = x(ins, "Param")
    lr = x(ins, "LearningRate").reshape(()).to(p.dtype)
    return {"ParamOut": [p - lr * x(ins, "Grad").to(p.dtype)]}


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
