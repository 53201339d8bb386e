"""Neural-net ops (counterpart of ``paddle_tpu/ops/nn.py``): mul, matmul,
layer_norm, dropout. Plain GEMMs go to ``torch.matmul``, as the JAX
package leaves them to XLA; in float32 they run in full float32 (no TF32)
unless the caller turned ``torch.backends.cuda.matmul.allow_tf32`` on."""
from __future__ import annotations

import math

import torch

from .common import IOSpec, out, register_op, x


@register_op("mul", inputs=["X", "Y"], outputs=["Out"],
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
def _mul(ctx, ins, attrs):
    """fc's matmul: X flattened to 2-D at x_num_col_dims."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    xnc, ync = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    xs, ys = tuple(xv.shape), tuple(yv.shape)
    x2 = xv.reshape(math.prod(xs[:xnc]), math.prod(xs[xnc:]))
    y2 = yv.reshape(math.prod(ys[:ync]), math.prod(ys[ync:]))
    return out(torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:]))


@register_op("matmul", inputs=["X", "Y"], outputs=["Out"],
             attrs={"transpose_X": False, "transpose_Y": False, "alpha": 1.0})
def _matmul(ctx, ins, attrs):
    xv, yv = x(ins, "X"), x(ins, "Y")
    if attrs["transpose_X"] and xv.dim() > 1:
        xv = xv.transpose(-1, -2)
    if attrs["transpose_Y"] and yv.dim() > 1:
        yv = yv.transpose(-1, -2)
    res = torch.matmul(xv, yv)
    if attrs.get("alpha", 1.0) != 1.0:
        res = res * attrs["alpha"]
    return out(res)


@register_op("layer_norm",
             inputs=[IOSpec("X"), IOSpec("Scale", optional=True),
                     IOSpec("Bias", optional=True)],
             outputs=["Y", "Mean", "Variance"],
             attrs={"epsilon": 1e-5, "begin_norm_axis": 1})
def _layer_norm(ctx, ins, attrs):
    xv = x(ins, "X")
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    bna = attrs["begin_norm_axis"]
    dims = tuple(range(bna, xv.dim()))
    var, mean = torch.var_mean(xv, dim=dims, keepdim=True, correction=0)
    y = (xv - mean) * torch.rsqrt(var + attrs["epsilon"])
    norm_shape = (1,) * bna + tuple(xv.shape[bna:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    lead = math.prod(xv.shape[:bna])
    return {"Y": [y], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"],
             attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0,
                    "fix_seed": False,
                    "dropout_implementation": "downgrade_in_infer"},
             needs_rng=True)
def _dropout(ctx, ins, attrs):
    """The mask comes from the op's own generator, keyed on (step seed,
    op uid): the grad op recomputes this rule with the forward's uid and
    draws the same mask. The bits differ from jax.random's."""
    xv = x(ins)
    p = attrs["dropout_prob"]
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test"):
        y = xv * (1.0 - p) if impl == "downgrade_in_infer" else xv
        return {"Out": [y], "Mask": [torch.ones_like(xv)]}
    gen = ctx.generator()
    if gen is not None and attrs.get("fix_seed"):
        gen.manual_seed(int(attrs["seed"]))
    u = torch.rand(xv.shape, generator=gen, device=xv.device)
    mask = (u >= p).to(xv.dtype)
    y = xv * mask
    if impl == "upscale_in_train" and p < 1.0:
        y = y / (1.0 - p)
    return {"Out": [y], "Mask": [mask]}
