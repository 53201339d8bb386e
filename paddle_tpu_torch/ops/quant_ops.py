"""Fake-quantization ops for quantization-aware training (counterpart of
``paddle_tpu/ops/quant_ops.py``).

Reference: paddle/fluid/operators/fake_quantize_op.{cc,h} —
FakeQuantizeAbsMax / FakeQuantizeDequantizeMovingAverageAbsMax, inserted by
the slim ``QuantizationTransformPass``. The forward simulates int8
rounding; the backward is the straight-through estimator (the gradient
passes unchanged), which falls out of writing the output as
``v + (q - v).detach()``, under the generic grad and under autograd alike.
The division by ``qmax`` is ``common.true_div``: on the card a division
by a Python number is a product with its reciprocal, up to an ulp off, so
the levels would part from the CPU's.
"""
from __future__ import annotations

import torch

from .common import IOSpec, register_op, true_div, x


def _fake_quant(v, scale, bits):
    """round(clip(v / s, -1, 1) * qmax) / qmax * s, with the identity
    gradient."""
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(scale, min=1e-8)
    q = true_div(torch.round(torch.clamp(v / s, -1.0, 1.0) * qmax),
                 qmax) * s
    return v + (q - v).detach()


@register_op("fake_quantize_dequantize_abs_max",
             inputs=[IOSpec("X")],
             outputs=["Out", IOSpec("OutScale", no_grad=True)],
             attrs={"bit_length": 8})
def _fake_quant_abs_max(ctx, ins, attrs):
    """Per-tensor abs-max scale computed on the fly (reference
    fake_quantize_op.h FindAbsMaxFunctor + ClipAndFakeQuantFunctor)."""
    v = x(ins)
    scale = torch.amax(torch.abs(v))
    return {"Out": [_fake_quant(v, scale, attrs["bit_length"])],
            "OutScale": [scale.reshape((1,))]}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             inputs=[IOSpec("X"), IOSpec("InScale", no_grad=True)],
             outputs=["Out", IOSpec("OutScale", no_grad=True)],
             attrs={"bit_length": 8, "moving_rate": 0.9, "is_test": False})
def _fake_quant_moving_avg(ctx, ins, attrs):
    """Activation quantization: the scale is an exponential moving average
    of batch abs-maxes held in a persistable var, which the pass writes in
    place (``OutScale`` is ``InScale``; reference
    FakeQuantizeDequantizeMovingAverageAbsMaxOp state)."""
    v, in_scale = x(ins, "X"), x(ins, "InScale")
    rate = attrs["moving_rate"]
    if attrs.get("is_test"):
        scale = in_scale.reshape(())
    else:
        cur = torch.amax(torch.abs(v))
        scale = rate * in_scale.reshape(()) + (1 - rate) * cur
    return {"Out": [_fake_quant(v, scale, attrs["bit_length"])],
            "OutScale": [scale.reshape((1,))]}
