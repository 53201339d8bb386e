"""Neural-net ops (counterpart of ``paddle_tpu/ops/nn.py``): mul, matmul,
conv2d, depthwise_conv2d, pool2d, batch_norm, layer_norm, dropout. Plain
GEMMs go to ``torch.matmul`` and convolutions to ``F.conv2d`` (cuDNN on
the card), as the JAX package leaves both to XLA; in float32 they run in
full float32 (no TF32) unless the caller turned
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` on.

Convolutions and pooling keep the reference's logical NCHW shapes at op
boundaries; ``FLAGS_conv_use_nhwc`` picks the memory format their inputs
are laid out in (``torch.channels_last`` is NHWC in memory), as the JAX
package's flag picks its inner layout. Anything that flattens a conv
output must ``reshape``, never ``view``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _laid_out(t: torch.Tensor, like=None) -> torch.Tensor:
    """``t`` in the memory format ``FLAGS_conv_use_nhwc`` asks for
    ``like`` (default ``t``): auto is channels_last on a CUDA tensor
    (cuDNN's NHWC kernels) and contiguous NCHW elsewhere."""
    from .. import flags

    mode = flags.flag("conv_use_nhwc")
    on_cuda = (t if like is None else like).is_cuda
    nhwc = mode == "always" or (mode == "auto" and on_cuda)
    return t.contiguous(memory_format=torch.channels_last if nhwc
                        else torch.contiguous_format)


@register_op("conv2d", inputs=[IOSpec("Input"), IOSpec("Filter"),
                               IOSpec("Bias", optional=True)],
             outputs=["Output"],
             attrs={"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
                    "groups": 1, "use_cudnn": True, "data_format": "NCHW"})
def _conv2d(ctx, ins, attrs):
    """OIHW filters, symmetric paddings; the optional Bias is per output
    channel."""
    inp = x(ins, "Input")
    return {"Output": [F.conv2d(
        _laid_out(inp), _laid_out(x(ins, "Filter"), like=inp),
        x(ins, "Bias"), stride=list(attrs["strides"]),
        padding=list(attrs["paddings"]), dilation=list(attrs["dilations"]),
        groups=attrs.get("groups", 1))]}


@register_op("depthwise_conv2d", inputs=[IOSpec("Input"), IOSpec("Filter"),
                                         IOSpec("Bias", optional=True)],
             outputs=["Output"],
             attrs={"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
                    "groups": 1, "use_cudnn": False, "data_format": "NCHW"})
def _depthwise_conv2d(ctx, ins, attrs):
    return _conv2d(ctx, ins, attrs)


@register_op("pool2d", inputs=["X"], outputs=["Out"],
             attrs={"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
                    "paddings": [0, 0], "global_pooling": False,
                    "exclusive": True, "adaptive": False, "ceil_mode": False,
                    "use_cudnn": True, "data_format": "NCHW"})
def _pool2d(ctx, ins, attrs):
    """Max or average pooling over windows of ``ksize``, as the reference's
    reduce_window: padding counts as -inf (max) or 0 (average);
    ``ceil_mode`` adds right/bottom padding so the last partial window
    counts; an average divides by the window's real elements when
    ``exclusive`` and there is padding, else by ``prod(ksize)``."""
    xv = _laid_out(x(ins))
    is_max = attrs["pooling_type"] == "max"
    ksize = list(attrs["ksize"])
    strides = list(attrs["strides"])
    pads = list(attrs["paddings"])
    in_hw = list(xv.shape[2:])
    if attrs.get("global_pooling") or (attrs.get("adaptive")
                                       and ksize == [1, 1]):
        ksize, strides, pads = list(in_hw), list(in_hw), [0, 0]
    elif attrs.get("adaptive"):
        if not all(d % o == 0 for d, o in zip(in_hw, ksize)):
            # non-uniform regions [floor(i*D/o), ceil((i+1)*D/o)): torch's
            # adaptive pools use the same bounds
            pool = F.adaptive_max_pool2d if is_max else F.adaptive_avg_pool2d
            return out(pool(xv, ksize))
        # uniform regions: a fixed window of D/o
        strides = [d // o for d, o in zip(in_hw, ksize)]
        ksize, pads = list(strides), [0, 0]
    extra = [0, 0]
    if attrs.get("ceil_mode") and not attrs.get("global_pooling"):
        for i in range(2):
            out_ceil = -(-(in_hw[i] - ksize[i] + 2 * pads[i])
                         // strides[i]) + 1
            extra[i] = max(0, (out_ceil - 1) * strides[i] + ksize[i]
                           - (in_hw[i] + 2 * pads[i]))
    pad4 = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    if is_max:
        if not any(extra) and all(2 * p <= k for p, k in zip(pads, ksize)):
            # torch pads max pooling with -inf itself up to half a window
            return out(F.max_pool2d(xv, ksize, strides, pads))
        return out(F.max_pool2d(F.pad(xv, pad4, value=-math.inf), ksize,
                                strides))
    if not any(pad4):
        return out(F.avg_pool2d(xv, ksize, strides))
    # padded with zeros here, so an unpadded avg_pool2d divides each window
    # by prod(ksize), ceil_mode's windows too
    xp = F.pad(xv, pad4)
    if not attrs.get("exclusive", True):
        return out(F.avg_pool2d(xp, ksize, strides))
    ones = F.pad(torch.ones((1, 1) + tuple(in_hw), dtype=xv.dtype,
                            device=xv.device), pad4)
    return out(F.avg_pool2d(xp, ksize, strides, divisor_override=1)
               / F.avg_pool2d(ones, ksize, strides, divisor_override=1))


def _bn_channel_axes(xv, layout):
    """(channel axis, reduced axes) of batch_norm's statistics."""
    if layout == "NHWC":
        return xv.dim() - 1, tuple(range(xv.dim() - 1))
    if xv.dim() == 4:
        return 1, (0, 2, 3)
    return 1, (0,)


@register_op("batch_norm",
             inputs=[IOSpec("X"), IOSpec("Scale"), IOSpec("Bias"),
                     IOSpec("Mean"), IOSpec("Variance")],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"],
             attrs={"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                    "use_global_stats": False, "data_layout": "NCHW"})
def _batch_norm(ctx, ins, attrs):
    """The reference's batch_norm, statistics computed here rather than
    through ``F.batch_norm``: the batch variance is biased; the running
    stats update as ``old * momentum + batch * (1 - momentum)``;
    ``SavedVariance`` is ``1 / sqrt(var + eps)``. ``MeanOut`` and
    ``VarianceOut`` alias the ``Mean``/``Variance`` persistables, so the
    executor writes the update back to the scope."""
    xv = x(ins, "X")
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    mean, var = x(ins, "Mean"), x(ins, "Variance")
    eps, mom = attrs["epsilon"], attrs["momentum"]
    c_axis, axes = _bn_channel_axes(xv, attrs.get("data_layout", "NCHW"))
    if attrs.get("is_test") or attrs.get("use_global_stats"):
        use_mean, inv = mean, 1.0 / torch.sqrt(var + eps)
        mean_out, var_out = mean, var
        saved_mean, saved_var = torch.zeros_like(mean), torch.zeros_like(var)
    else:
        use_var, use_mean = torch.var_mean(xv, dim=axes, correction=0)
        inv = 1.0 / torch.sqrt(use_var + eps)
        mean_out = mean * mom + use_mean * (1 - mom)
        var_out = var * mom + use_var * (1 - mom)
        saved_mean, saved_var = use_mean, inv
    bshape = [1] * xv.dim()
    bshape[c_axis] = xv.shape[c_axis]
    # y = (x - mean) * inv * scale + bias, folded to one multiply-add
    a = inv * scale
    y = torch.addcmul((bias - use_mean * a).reshape(bshape), xv,
                      a.reshape(bshape))
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [saved_var]}


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
