"""Elementwise, activation, softmax, scale, sum, cast, comparison and
logical ops (counterpart of ``paddle_tpu/ops/math.py``), the ones the GPT,
BERT and MLP paths, the serving engine's fc program, the AMP decorator,
``L1Decay`` and gradient clipping (``clip.py``) run."""
from __future__ import annotations

import torch

from ..core.types import torch_dtype
from .common import IOSpec, broadcast_to_x, out, register_op, x


@register_op("relu", inputs=["X"], outputs=["Out"])
def _relu(ctx, ins, attrs):
    return out(torch.relu(x(ins)))


@register_op("abs", inputs=["X"], outputs=["Out"])
def _abs(ctx, ins, attrs):
    return out(torch.abs(x(ins)))


@register_op("tanh", inputs=["X"], outputs=["Out"])
def _tanh(ctx, ins, attrs):
    return out(torch.tanh(x(ins)))


@register_op("sqrt", inputs=["X"], outputs=["Out"])
def _sqrt(ctx, ins, attrs):
    return out(torch.sqrt(x(ins)))


@register_op("gelu", inputs=["X"], outputs=["Out"],
             attrs={"approximate": False})
def _gelu(ctx, ins, attrs):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return out(torch.nn.functional.gelu(x(ins), approximate=approx))


@register_op("softmax", inputs=["X"], outputs=["Out"], attrs={"axis": -1})
def _softmax(ctx, ins, attrs):
    return out(torch.softmax(x(ins), dim=attrs.get("axis", -1)))


def _ew(fn):
    def lower(ctx, ins, attrs):
        xv, yv = x(ins, "X"), x(ins, "Y")
        return out(fn(xv, broadcast_to_x(xv, yv, attrs.get("axis", -1))))

    return lower


for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_min", torch.minimum),
    ("elementwise_max", torch.maximum),
]:
    register_op(_name, inputs=["X", "Y"], outputs=["Out"],
                attrs={"axis": -1})(_ew(_fn))


@register_op("scale", inputs=["X"], outputs=["Out"],
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True})
def _scale(ctx, ins, attrs):
    v = x(ins)
    if attrs.get("bias_after_scale", True):
        return out(v * attrs["scale"] + attrs["bias"])
    return out((v + attrs["bias"]) * attrs["scale"])


@register_op("cast", inputs=["X"], outputs=["Out"],
             attrs={"in_dtype": None, "out_dtype": "float32"})
def _cast(ctx, ins, attrs):
    return out(x(ins).to(torch_dtype(attrs["out_dtype"])))


@register_op("sum", inputs=[IOSpec("X", duplicable=True)], outputs=["Out"])
def _sum(ctx, ins, attrs):
    """Dense sum of the inputs (backward's grad accumulation)."""
    vals = [v for v in ins.get("X", []) if v is not None]
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return out(acc)


@register_op("clip", inputs=["X"], outputs=["Out"],
             attrs={"min": -1.0, "max": 1.0})
def _clip(ctx, ins, attrs):
    return out(torch.clamp(x(ins), attrs["min"], attrs["max"]))


@register_op("clip_by_norm", inputs=["X"], outputs=["Out"],
             attrs={"max_norm": 1.0})
def _clip_by_norm(ctx, ins, attrs):
    v = x(ins)
    norm = torch.sqrt(torch.sum(torch.square(v)))
    scale = torch.clamp(attrs["max_norm"] / torch.clamp(norm, min=1e-12),
                        max=1.0)
    return out(v * scale)


@register_op("squared_l2_norm", inputs=["X"], outputs=["Out"])
def _squared_l2_norm(ctx, ins, attrs):
    return out(torch.sum(torch.square(x(ins))).reshape((1,)))


@register_op("not_equal", inputs=["X", "Y"], outputs=["Out"], grad=None)
def _not_equal(ctx, ins, attrs):
    return out(torch.ne(x(ins, "X"), x(ins, "Y")))


@register_op("logical_not", inputs=["X"], outputs=["Out"], grad=None)
def _logical_not(ctx, ins, attrs):
    return out(torch.logical_not(x(ins)))
