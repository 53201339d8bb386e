"""Neural-net ops (counterpart of ``paddle_tpu/ops/nn.py``, every op type
of it): mul, matmul, conv2d, depthwise_conv2d, conv2d_transpose, pool2d,
batch_norm, layer_norm, group_norm, instance_norm, dropout,
l2_normalize, prelu, interpolate_nearest and bilinear_interp. Plain
GEMMs go to ``torch.matmul`` and convolutions to ``common.convolution``
(cuDNN on the card), as the JAX package leaves both to XLA. In float32 a
GEMM runs in full float32 (no TF32) unless the caller turned
``torch.backends.cuda.matmul.allow_tf32`` on; a convolution always does,
on cuDNN's deterministic algorithms, whatever ``torch.backends.cudnn``
says.

Convolutions and pooling keep the reference's logical NCHW shapes at op
boundaries; ``FLAGS_conv_use_nhwc`` picks the memory format their inputs
are laid out in (``torch.channels_last`` is NHWC in memory), as the JAX
package's flag picks its inner layout. Anything that flattens a conv
output must ``reshape``, never ``view``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import IOSpec, convolution, out, register_op, true_div, x


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
    return {"Output": [convolution(
        _laid_out(inp), _laid_out(x(ins, "Filter"), like=inp),
        x(ins, "Bias"), stride=attrs["strides"], padding=attrs["paddings"],
        dilation=attrs["dilations"], groups=attrs.get("groups", 1))]}


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
    ``SavedVariance`` is ``1 / sqrt(var + eps)``. In a data-parallel step
    (``ctx.dp``) the statistics are the global batch's. ``MeanOut`` and
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
    elif getattr(ctx, "dp", None) is not None:
        # data parallel: the global batch's statistics, each sum over the
        # ranks (its backward sums the rows' partial cotangents)
        n = (xv.numel() // xv.shape[c_axis]) * ctx.dp.world
        use_mean = ctx.dp.all_reduce_sum(xv.sum(dim=axes)) / n
        cshape = [1] * xv.dim()
        cshape[c_axis] = xv.shape[c_axis]
        d = xv - use_mean.reshape(cshape)
        use_var = ctx.dp.all_reduce_sum((d * d).sum(dim=axes)) / n
        inv = 1.0 / torch.sqrt(use_var + eps)
        mean_out = mean * mom + use_mean * (1 - mom)
        var_out = var * mom + use_var * (1 - mom)
        saved_mean, saved_var = use_mean, inv
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


@register_op("conv2d_transpose", inputs=[IOSpec("Input"), IOSpec("Filter"),
                                         IOSpec("Bias", optional=True)],
             outputs=["Output"],
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1, "output_size": [],
                    "data_format": "NCHW"})
def _conv2d_transpose(ctx, ins, attrs):
    """The reference's transposed conv (its lhs-dilated forward conv with
    the flipped kernel) is a transposed convolution: filters [C_in, C_out,
    kh, kw], output (H - 1) s + (k - 1) d + 1 - 2p. ``output_size`` is
    ignored and groups > 1 refused, as in the reference."""
    if attrs.get("groups", 1) != 1:
        raise NotImplementedError("conv2d_transpose groups>1 not supported")
    inp = x(ins, "Input")
    res = convolution(
        _laid_out(inp), _laid_out(x(ins, "Filter"), like=inp),
        stride=attrs["strides"], padding=attrs["paddings"],
        dilation=attrs["dilations"], transposed=True)
    b = x(ins, "Bias")
    if b is not None:
        res = res + b.reshape((1, -1, 1, 1))
    return {"Output": [res]}


def _affine(y, ins, channels, dim):
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    shape = (1, channels) + (1,) * (dim - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@register_op("group_norm",
             inputs=[IOSpec("X"), IOSpec("Scale", optional=True),
                     IOSpec("Bias", optional=True)],
             outputs=["Y", "Mean", "Variance"],
             attrs={"epsilon": 1e-5, "groups": 1})
def _group_norm(ctx, ins, attrs):
    """Biased statistics over each group of C/groups channels and the
    spatial dims; Mean and Variance are [N, groups]."""
    xv = x(ins, "X")
    n, c, g = xv.shape[0], xv.shape[1], attrs["groups"]
    xg = xv.reshape((n, g, c // g) + tuple(xv.shape[2:]))
    dims = tuple(range(2, xg.dim()))
    var, mean = torch.var_mean(xg, dim=dims, keepdim=True, correction=0)
    y = ((xg - mean) / torch.sqrt(var + attrs["epsilon"])).reshape(xv.shape)
    return {"Y": [_affine(y, ins, c, xv.dim())],
            "Mean": [mean.reshape(n, g)], "Variance": [var.reshape(n, g)]}


@register_op("instance_norm",
             inputs=[IOSpec("X"), IOSpec("Scale", optional=True),
                     IOSpec("Bias", optional=True)],
             outputs=["Y", "SavedMean", "SavedVariance"],
             attrs={"epsilon": 1e-5})
def _instance_norm(ctx, ins, attrs):
    """Biased statistics over each (sample, channel)'s spatial dims;
    SavedVariance holds 1/sqrt(var + eps), as the reference's."""
    xv = x(ins, "X")
    dims = tuple(range(2, xv.dim()))
    var, mean = torch.var_mean(xv, dim=dims, keepdim=True, correction=0)
    y = (xv - mean) / torch.sqrt(var + attrs["epsilon"])
    n, c = xv.shape[0], xv.shape[1]
    return {"Y": [_affine(y, ins, c, xv.dim())],
            "SavedMean": [mean.reshape(n * c)],
            "SavedVariance": [(1.0 / torch.sqrt(var + attrs["epsilon"]))
                              .reshape(n * c)]}


@register_op("l2_normalize", inputs=["X"], outputs=["Out", "Norm"],
             attrs={"axis": -1, "epsilon": 1e-12})
def _l2_normalize(ctx, ins, attrs):
    """x / sqrt(sum(x^2) + eps) along ``axis`` (eps inside the root)."""
    xv = x(ins)
    norm = torch.sqrt(torch.sum(torch.square(xv), dim=attrs["axis"],
                                keepdim=True) + attrs["epsilon"])
    return {"Out": [xv / norm], "Norm": [norm]}


@register_op("prelu", inputs=["X", "Alpha"], outputs=["Out"],
             attrs={"mode": "all"})
def _prelu(ctx, ins, attrs):
    """x where x > 0, alpha x elsewhere; alpha one scalar ("all"), one per
    channel ("channel") or one per element of a sample ("element")."""
    xv, alpha = x(ins, "X"), x(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (xv.dim() - 2))
    elif mode == "element":
        alpha = alpha.reshape((1,) + tuple(xv.shape[1:]))
    elif mode == "all":
        alpha = alpha.reshape(())
    return out(torch.where(xv > 0, xv, alpha * xv))


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """``jax.image.resize``'s nearest source index of each of ``n``
    outputs over ``m`` inputs: floor((i + 0.5) * m / n), in float32 and
    in that order (half-pixel centers, ``align_corners`` ignored), the
    division a true one on the card too (``true_div``)."""
    f = true_div((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
                 * m, n)
    return torch.floor(f).long().clamp(max=m - 1)


def _linear_weights(m: int, n: int, device) -> torch.Tensor:
    """``jax.image.resize``'s [m, n] bilinear weights (``antialias``, its
    default): half-pixel sample points, a triangle kernel widened by
    m / n when downsampling, each column normalised over the inputs it
    reaches, in float32."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    dist = true_div(torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]), kernel_scale)
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@register_op("interpolate_nearest", inputs=["X"], outputs=["Out"],
             attrs={"out_h": 0, "out_w": 0, "align_corners": False})
def _interp_nearest(ctx, ins, attrs):
    """Nearest resize of NCHW to (out_h, out_w), the index arithmetic of
    ``jax.image.resize(method="nearest")`` written out (torch's
    ``interpolate`` rounds its own way); an unchanged dim is left as is."""
    xv = x(ins)
    h, w = xv.shape[2], xv.shape[3]
    oh, ow = int(attrs["out_h"]), int(attrs["out_w"])
    if oh != h:
        xv = xv.index_select(2, _nearest_index(h, oh, xv.device))
    if ow != w:
        xv = xv.index_select(3, _nearest_index(w, ow, xv.device))
    return out(xv)


@register_op("bilinear_interp", inputs=["X"], outputs=["Out"],
             attrs={"out_h": 0, "out_w": 0, "align_corners": True})
def _bilinear_interp(ctx, ins, attrs):
    """Bilinear resize of NCHW to (out_h, out_w) as
    ``jax.image.resize(method="bilinear")`` computes it: two weight
    contractions (``_linear_weights``), antialiased when downsampling,
    ``align_corners`` ignored; an unchanged dim is left as is."""
    xv = x(ins)
    h, w = xv.shape[2], xv.shape[3]
    oh, ow = int(attrs["out_h"]), int(attrs["out_w"])
    if not xv.is_floating_point():
        xv = xv.to(torch.float32)
    if oh != h:
        xv = torch.einsum("nchw,hH->ncHw", xv, _linear_weights(
            h, oh, xv.device).to(xv.dtype))
    if ow != w:
        xv = torch.einsum("nchw,wW->nchW", xv, _linear_weights(
            w, ow, xv.device).to(xv.dtype))
    return out(xv)
