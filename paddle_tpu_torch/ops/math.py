"""Elementwise, activation, softmax, scale, sum, cast, comparison and
logical ops (counterpart of ``paddle_tpu/ops/math.py``): every op type of
that module, each a plain torch expression of the reference's ``jnp`` one.
Gradients are the generic ``<type>_grad`` (autograd over the rule), none
where the reference registers none (``ceil``, ``floor``, ``round``,
``sign``, the comparisons, the logicals and ``isfinite``). A
SelectedRows gradient passes ``scale``, ``sum``, ``clip``,
``clip_by_norm``, ``squared_l2_norm`` and ``elementwise_mul``/``div`` by
a one-element Y as the reference's sparse branches pass it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.selected_rows import (SelectedRows, concat_merge,
                                   is_selected_rows)
from ..core.types import torch_dtype
from .common import IOSpec, broadcast_to_x, out, register_op, unary, x


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


# -- activations ------------------------------------------------------------
unary("sigmoid", torch.sigmoid)
unary("exp", torch.exp)
unary("log", torch.log)
unary("square", torch.square)
unary("rsqrt", torch.rsqrt)
unary("ceil", torch.ceil, grad=None)
unary("floor", torch.floor, grad=None)
unary("round", torch.round, grad=None)
unary("reciprocal", lambda v: 1.0 / v)
unary("softplus", F.softplus)
unary("softsign", F.softsign)
unary("sin", torch.sin)
unary("cos", torch.cos)
unary("logsigmoid", F.logsigmoid)
unary("erf", torch.erf)
unary("tan", torch.tan)
unary("asin", torch.asin)
unary("acos", torch.acos)
unary("atan", torch.atan)
unary("sinh", torch.sinh)
unary("cosh", torch.cosh)
unary("log1p", torch.log1p)
unary("expm1", torch.expm1)
unary("log2", torch.log2)
unary("log10", torch.log10)
unary("sign", torch.sign, grad=None)
unary("silu", F.silu)
unary("mish", lambda v: v * torch.tanh(F.softplus(v)))


@register_op("selu", inputs=["X"], outputs=["Out"],
             attrs={"scale": 1.0507009873554805, "alpha": 1.6732632423543772})
def _selu(ctx, ins, attrs):
    v = x(ins)
    return out(attrs["scale"] * torch.where(
        v > 0, v, attrs["alpha"] * (torch.exp(v) - 1.0)))


@register_op("stanh", inputs=["X"], outputs=["Out"],
             attrs={"scale_a": 0.67, "scale_b": 1.7159})
def _stanh(ctx, ins, attrs):
    return out(attrs["scale_b"] * torch.tanh(attrs["scale_a"] * x(ins)))


@register_op("brelu", inputs=["X"], outputs=["Out"],
             attrs={"t_min": 0.0, "t_max": 24.0})
def _brelu(ctx, ins, attrs):
    return out(torch.clamp(x(ins), attrs["t_min"], attrs["t_max"]))


@register_op("hard_shrink", inputs=["X"], outputs=["Out"],
             attrs={"threshold": 0.5})
def _hard_shrink(ctx, ins, attrs):
    v = x(ins)
    return out(torch.where(torch.abs(v) > attrs["threshold"], v, 0.0))


@register_op("softshrink", inputs=["X"], outputs=["Out"],
             attrs={"lambda": 0.5})
def _softshrink(ctx, ins, attrs):
    v, lam = x(ins), attrs["lambda"]
    return out(torch.where(v > lam, v - lam,
                           torch.where(v < -lam, v + lam, 0.0)))


@register_op("thresholded_relu", inputs=["X"], outputs=["Out"],
             attrs={"threshold": 1.0})
def _thresholded_relu(ctx, ins, attrs):
    v = x(ins)
    return out(torch.where(v > attrs["threshold"], v, 0.0))


@register_op("maxout", inputs=["X"], outputs=["Out"],
             attrs={"groups": 1, "axis": 1})
def _maxout(ctx, ins, attrs):
    """Channels fold into groups, max within each (reference
    maxout_op.h)."""
    v, g = x(ins), attrs["groups"]
    ax = attrs.get("axis", 1)
    ax = ax if ax >= 0 else ax + v.dim()
    c = v.shape[ax]
    shp = tuple(v.shape[:ax]) + (c // g, g) + tuple(v.shape[ax + 1:])
    return out(v.reshape(shp).amax(dim=ax + 1))


@register_op("leaky_relu", inputs=["X"], outputs=["Out"],
             attrs={"alpha": 0.02})
def _leaky_relu(ctx, ins, attrs):
    return out(F.leaky_relu(x(ins), negative_slope=attrs["alpha"]))


@register_op("relu6", inputs=["X"], outputs=["Out"],
             attrs={"threshold": 6.0})
def _relu6(ctx, ins, attrs):
    return out(torch.clamp(x(ins), 0.0, attrs["threshold"]))


@register_op("elu", inputs=["X"], outputs=["Out"], attrs={"alpha": 1.0})
def _elu(ctx, ins, attrs):
    return out(F.elu(x(ins), alpha=attrs["alpha"]))


@register_op("hard_sigmoid", inputs=["X"], outputs=["Out"],
             attrs={"slope": 0.2, "offset": 0.5})
def _hard_sigmoid(ctx, ins, attrs):
    return out(torch.clamp(attrs["slope"] * x(ins) + attrs["offset"],
                           0.0, 1.0))


@register_op("swish", inputs=["X"], outputs=["Out"], attrs={"beta": 1.0})
def _swish(ctx, ins, attrs):
    v = x(ins)
    return out(v * torch.sigmoid(attrs["beta"] * v))


@register_op("hard_swish", inputs=["X"], outputs=["Out"],
             attrs={"threshold": 6.0, "scale": 6.0, "offset": 3.0})
def _hard_swish(ctx, ins, attrs):
    v = x(ins)
    return out(v * torch.clamp(v + attrs["offset"], 0, attrs["threshold"])
               / attrs["scale"])


@register_op("pow", inputs=["X"], outputs=["Out"], attrs={"factor": 1.0})
def _pow(ctx, ins, attrs):
    return out(torch.pow(x(ins), attrs["factor"]))


@register_op("log_softmax", inputs=["X"], outputs=["Out"],
             attrs={"axis": -1})
def _log_softmax(ctx, ins, attrs):
    return out(torch.log_softmax(x(ins), dim=attrs.get("axis", -1)))


# -- elementwise binary -----------------------------------------------------

def _ew(fn, sparse_ok=False):
    """A SelectedRows X by a one-element Y keeps its structure only for a
    multiplicative op (``sparse_ok``: the untouched rows stay zero under
    * and /: a global-norm clip's scale, a loss-scale unscale); any other
    op on a SelectedRows fails loudly, as the reference's does."""
    def lower(ctx, ins, attrs):
        xv, yv = x(ins, "X"), x(ins, "Y")
        if sparse_ok and is_selected_rows(xv) \
                and not is_selected_rows(yv) and yv.numel() == 1:
            return out(SelectedRows(xv.rows, fn(xv.values, yv.reshape(())),
                                    xv.height))
        return out(fn(xv, broadcast_to_x(xv, yv, attrs.get("axis", -1))))

    return lower


for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_min", torch.minimum),
    ("elementwise_max", torch.maximum),
    ("elementwise_pow", torch.pow),
    ("elementwise_mod", torch.remainder),
    # floor division with a zero gradient (torch.floor_divide has none)
    ("elementwise_floordiv",
     lambda a, b: torch.div(a, b, rounding_mode="floor")),
]:
    register_op(_name, inputs=["X", "Y"], outputs=["Out"],
                attrs={"axis": -1})(_ew(_fn, _name in ("elementwise_mul",
                                                       "elementwise_div")))


@register_op("scale", inputs=["X"], outputs=["Out"],
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True})
def _scale(ctx, ins, attrs):
    v = x(ins)
    if is_selected_rows(v):
        # grad scaling (1/N, a loss scale): a bias on a sparse grad is
        # malformed
        assert attrs.get("bias", 0.0) == 0.0, "scale(SelectedRows) with bias"
        return out(v.scale(attrs["scale"]))
    if attrs.get("bias_after_scale", True):
        return out(v * attrs["scale"] + attrs["bias"])
    return out((v + attrs["bias"]) * attrs["scale"])


@register_op("cast", inputs=["X"], outputs=["Out"],
             attrs={"in_dtype": None, "out_dtype": "float32"})
def _cast(ctx, ins, attrs):
    return out(x(ins).to(torch_dtype(attrs["out_dtype"])))


@register_op("sum", inputs=[IOSpec("X", duplicable=True)], outputs=["Out"])
def _sum(ctx, ins, attrs):
    """Sum of the inputs (backward's grad accumulation), left to right.
    The grads of a table two sparse lookups read are concatenated and
    merged again, so the sum stays sized by the lookups; a mix of dense
    and sparse inputs is densified (reference selected_rows_functor.cc
    Add)."""
    # a recompute segment's gradient of an input several of its ops read
    # adds its pieces one by one, in its place (ops/recompute.py)
    vals = [p for v in ins.get("X", []) if v is not None
            for p in getattr(v, "_grad_pieces", (v,))]
    sparse = [v for v in vals if is_selected_rows(v)]
    if sparse:
        acc = sparse[0]
        for v in sparse[1:]:
            acc = concat_merge(acc, v)
        dense = [v for v in vals if not is_selected_rows(v)]
        if not dense:
            return out(acc)
        d = dense[0]
        for v in dense[1:]:
            d = d + v
        return out(d + acc.to_dense())
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return out(acc)


@register_op("clip", inputs=["X"], outputs=["Out"],
             attrs={"min": -1.0, "max": 1.0})
def _clip(ctx, ins, attrs):
    v = x(ins)
    if is_selected_rows(v):
        return out(SelectedRows(
            v.rows, torch.clamp(v.values, attrs["min"], attrs["max"]),
            v.height))
    return out(torch.clamp(v, attrs["min"], attrs["max"]))


@register_op("clip_by_norm", inputs=["X"], outputs=["Out"],
             attrs={"max_norm": 1.0})
def _clip_by_norm(ctx, ins, attrs):
    """A SelectedRows' rows are duplicate-free, so the norm of its values
    is the grad's norm (reference clip_by_norm_op.h)."""
    v = x(ins)
    vals = v.values if is_selected_rows(v) else v
    norm = torch.sqrt(torch.sum(torch.square(vals)))
    scale = torch.clamp(attrs["max_norm"] / torch.clamp(norm, min=1e-12),
                        max=1.0)
    if is_selected_rows(v):
        return out(SelectedRows(v.rows, vals * scale, v.height))
    return out(v * scale)


@register_op("squared_l2_norm", inputs=["X"], outputs=["Out"])
def _squared_l2_norm(ctx, ins, attrs):
    v = x(ins)
    vals = v.values if is_selected_rows(v) else v
    return out(torch.sum(torch.square(vals)).reshape((1,)))


# -- comparison / logical (non-differentiable) ------------------------------

def _binary(fn):
    def lower(ctx, ins, attrs):
        return out(fn(x(ins, "X"), x(ins, "Y")))

    return lower


for _name, _fn in [
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
    ("logical_and", torch.logical_and),
    ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    register_op(_name, inputs=["X", "Y"], outputs=["Out"],
                grad=None)(_binary(_fn))


@register_op("logical_not", inputs=["X"], outputs=["Out"], grad=None)
def _logical_not(ctx, ins, attrs):
    return out(torch.logical_not(x(ins)))


@register_op("isfinite", inputs=["X"], outputs=["Out"], grad=None)
def _isfinite(ctx, ins, attrs):
    return out(torch.isfinite(x(ins)).all().reshape((1,)))
