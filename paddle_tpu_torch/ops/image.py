"""The image group of the op library (counterpart of
``paddle_tpu/ops/image.py``, every op type of it): sampling grids,
rearrangements, windows and pools, and the 3-D convolutions, pools and
resize.

The 3-D convolutions are ``common.convolution`` (cuDNN on the card, in
full float32 on its deterministic algorithms whatever the process-wide
cuDNN settings), as the JAX package leaves them to XLA. The rest is the
JAX package's index arithmetic written out, where torch's own function
differs at an edge: ``grid_sampler``'s border and reflection clip the
gathered index, not the coordinate; ``max_pool2d_with_index`` and
``pool3d`` take the first maximum; ``trilinear_interp`` without
``align_corners`` antialiases a shrinking axis as ``jax.image.resize``
does. Every gather whose gradient sums into repeated positions is an
advanced index (its gradient sums in a fixed order on the card).

References: grid_sampler_op.h, affine_grid_op.h, pixel_shuffle_op.h,
affine_channel_op, shuffle_channel_op, space_to_depth_op,
temporal_shift_op.h, unfold_op.h, im2sequence_op.h, lrn_op.h, crop_op,
crop_tensor_op, pad_constant_like_op, spp_op.h, unpool_op.h,
pool_with_index_op, conv3d (conv_op), conv3d_transpose, pool3d
(pool_op), trilinear_interp (interpolate_op).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import IOSpec, convolution, out, register_op, x
from .misc import _host_ints, linspace_f32, take
from .nn import _linear_weights


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@register_op("grid_sampler", inputs=["X", "Grid"], outputs=["Output"],
             attrs={"padding_mode": "zeros", "mode": "bilinear",
                    "align_corners": True})
def _grid_sampler(ctx, ins, attrs):
    """Sample X [N, C, H, W] at the normalised [-1, 1] coordinates of
    Grid [N, Hg, Wg, 2]. ``mode`` bilinear or nearest; ``padding_mode``
    zeros (a tap off the image is 0), border (the tap's index clipped
    into the image) or reflection (the coordinate reflected about
    [0, n - 1], then clipped)."""
    xv, grid = x(ins, "X"), x(ins, "Grid")
    n, _, h, w = xv.shape
    mode = attrs.get("mode", "bilinear")
    pad = attrs.get("padding_mode", "zeros")
    if mode not in ("bilinear", "nearest") or pad not in (
            "zeros", "border", "reflection"):
        raise NotImplementedError(
            f"grid_sampler mode={mode} padding_mode={pad}")
    gx, gy = grid[..., 0], grid[..., 1]
    if attrs.get("align_corners", True):
        fx = (gx + 1.0) * (w - 1) / 2.0
        fy = (gy + 1.0) * (h - 1) / 2.0
    else:
        fx = ((gx + 1.0) * w - 1.0) / 2.0
        fy = ((gy + 1.0) * h - 1.0) / 2.0

    def reflect(f, size):
        if size == 1:
            return torch.zeros_like(f)
        period = 2.0 * (size - 1)
        f = torch.abs(torch.remainder(f, period))
        return torch.where(f > size - 1, period - f, f)

    if pad == "reflection":
        fx, fy = reflect(fx, w), reflect(fy, h)
    batch = torch.arange(n, device=xv.device)[:, None, None]

    def gather(yy, xx):
        xi = torch.clamp(xx, 0, w - 1).long()
        yi = torch.clamp(yy, 0, h - 1).long()
        v = xv[batch, :, yi, xi].permute(0, 3, 1, 2)    # [N, C, Hg, Wg]
        if pad == "zeros":
            inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
            v = torch.where(inside[:, None], v, 0.0)
        return v

    if mode == "nearest":
        return {"Output": [gather(torch.round(fy), torch.round(fx))]}
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    res = (gather(y0, x0) * (1 - wx) * (1 - wy)
           + gather(y0, x0 + 1) * wx * (1 - wy)
           + gather(y0 + 1, x0) * (1 - wx) * wy
           + gather(y0 + 1, x0 + 1) * wx * wy)
    return {"Output": [res]}


@register_op("affine_grid", inputs=[IOSpec("Theta"),
                                    IOSpec("OutputShape", optional=True,
                                           no_grad=True)],
             outputs=["Output"],
             attrs={"use_cudnn": True, "align_corners": True,
                    "output_shape": []})
def _affine_grid(ctx, ins, attrs):
    """Theta [N, 2, 3] -> the sampling grid [N, H, W, 2] of normalised
    coordinates; a shape given as a tensor is read on the host."""
    theta = x(ins, "Theta")
    shape = x(ins, "OutputShape")
    hw = _host_ints(shape) if shape is not None \
        else [int(v) for v in attrs["output_shape"]]
    h, w = hw[-2], hw[-1]
    dev = theta.device
    if attrs.get("align_corners", True):
        xs = linspace_f32(-1.0, 1.0, w, dev)
        ys = linspace_f32(-1.0, 1.0, h, dev)
    else:
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1.0
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return {"Output": [torch.einsum("hwk,nck->nhwc", base.to(theta.dtype),
                                    theta)]}


# ---------------------------------------------------------------------------
# rearrangements
# ---------------------------------------------------------------------------

@register_op("pixel_shuffle", inputs=["X"], outputs=["Out"],
             attrs={"upscale_factor": 1})
def _pixel_shuffle(ctx, ins, attrs):
    """[N, C r^2, H, W] -> [N, C, H r, W r]."""
    xv = x(ins)
    r = int(attrs["upscale_factor"])
    n, c, h, w = xv.shape
    c //= r * r
    v = xv.reshape(n, c, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return out(v.reshape(n, c, h * r, w * r))


@register_op("affine_channel",
             inputs=[IOSpec("X"), IOSpec("Scale"), IOSpec("Bias")],
             outputs=["Out"], attrs={"data_layout": "NCHW"})
def _affine_channel(ctx, ins, attrs):
    xv, s, b = x(ins, "X"), x(ins, "Scale"), x(ins, "Bias")
    if attrs.get("data_layout", "NCHW") == "NCHW":
        shape = (1, -1) + (1,) * (xv.dim() - 2)
    else:
        shape = (1,) * (xv.dim() - 1) + (-1,)
    return out(xv * s.reshape(shape) + b.reshape(shape))


@register_op("shuffle_channel", inputs=["X"], outputs=["Out"],
             attrs={"group": 1})
def _shuffle_channel(ctx, ins, attrs):
    xv = x(ins)
    g = int(attrs["group"])
    n, c, h, w = xv.shape
    return out(xv.reshape(n, g, c // g, h, w).transpose(1, 2)
               .reshape(n, c, h, w))


@register_op("space_to_depth", inputs=["X"], outputs=["Out"],
             attrs={"blocksize": 1})
def _space_to_depth(ctx, ins, attrs):
    """[N, C, H, W] -> [N, b^2 C, H / b, W / b], the block offset the
    outer part of the channel."""
    xv = x(ins)
    b = int(attrs["blocksize"])
    n, c, h, w = xv.shape
    v = xv.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return out(v.reshape(n, c * b * b, h // b, w // b))


@register_op("temporal_shift", inputs=["X"], outputs=["Out"],
             attrs={"seg_num": 1, "shift_ratio": 0.25})
def _temporal_shift(ctx, ins, attrs):
    """The TSM shift of [N T, C, H, W]: the first C * ratio channels
    move one segment back in time, the next C * ratio one forward, the
    rest stay; the vacated segment is 0."""
    xv = x(ins)
    t = int(attrs["seg_num"])
    ratio = float(attrs["shift_ratio"])
    nt, c, h, w = xv.shape
    v = xv.reshape(nt // t, t, c, h, w)
    c1 = int(c * ratio)
    c2 = int(c * 2 * ratio)
    pad = torch.zeros_like(v[:, :1])
    back = torch.cat([v[:, 1:, :c1], pad[:, :, :c1]], dim=1)
    fwd = torch.cat([pad[:, :, c1:c2], v[:, :-1, c1:c2]], dim=1)
    res = torch.cat([back, fwd, v[:, :, c2:]], dim=2)
    return out(res.reshape(nt, c, h, w))


# ---------------------------------------------------------------------------
# windows and pools
# ---------------------------------------------------------------------------

def _unfold(xv, kernels, strides, pads, dilations):
    """im2col: [N, C, H, W] -> [N, C kh kw, L]; ``pads`` two or four
    (top, left, bottom, right)."""
    ph0, pw0, ph1, pw1 = (list(pads) * 2)[:4] if len(pads) == 2 else pads
    xp = F.pad(xv, (pw0, pw1, ph0, ph1))
    return F.unfold(xp, kernel_size=list(kernels),
                    dilation=list(dilations), stride=list(strides))


@register_op("unfold", inputs=["X"], outputs=["Y"],
             attrs={"kernel_sizes": [3, 3], "strides": [1, 1],
                    "paddings": [0, 0, 0, 0], "dilations": [1, 1]})
def _unfold_op(ctx, ins, attrs):
    return {"Y": [_unfold(x(ins), attrs["kernel_sizes"], attrs["strides"],
                          attrs["paddings"], attrs["dilations"])]}


@register_op("im2sequence", inputs=[IOSpec("X"),
                                    IOSpec("Y", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"kernels": [1, 1], "strides": [1, 1],
                    "paddings": [0, 0, 0, 0], "out_stride": [1, 1]})
def _im2sequence(ctx, ins, attrs):
    """The sliding windows as one sequence [N oh ow, C kh kw], batch
    major (Y and ``out_stride`` are ignored, as in the JAX package)."""
    cols = _unfold(x(ins, "X"), attrs["kernels"], attrs["strides"],
                   attrs["paddings"], [1, 1])
    n, ckk, length = cols.shape
    return out(cols.transpose(1, 2).reshape(n * length, ckk))


@register_op("lrn", inputs=["X"], outputs=["Out", "MidOut"],
             attrs={"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75})
def _lrn(ctx, ins, attrs):
    """Local response normalisation across channels: MidOut = k + alpha
    times the sum of squares over the n channels centred on each, Out =
    X / MidOut^beta."""
    xv = x(ins)
    n, k = int(attrs["n"]), attrs["k"]
    half = n // 2
    c = xv.shape[1]
    pad = F.pad(xv * xv, (0, 0, 0, 0, half, half))
    acc = sum(pad[:, i:i + c] for i in range(n))
    mid = k + attrs["alpha"] * acc
    return {"Out": [xv / torch.pow(mid, attrs["beta"])], "MidOut": [mid]}


@register_op("crop", inputs=[IOSpec("X"), IOSpec("Y", optional=True,
                                                 no_grad=True),
                             IOSpec("Offsets", optional=True, no_grad=True)],
             outputs=["Out"], attrs={"offsets": [], "shape": []})
def _crop_op(ctx, ins, attrs):
    """X[offsets : offsets + shape]; the shape is Y's when given, offsets
    given as a tensor are read on the host."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    shape = list(yv.shape) if yv is not None \
        else [int(s) for s in attrs["shape"]]
    offs_in = x(ins, "Offsets")
    offs = _host_ints(offs_in) if offs_in is not None \
        else ([int(v) for v in attrs["offsets"]] or [0] * xv.dim())
    return out(xv[tuple(slice(o, o + s) for o, s in zip(offs, shape))])


@register_op("crop_tensor",
             inputs=[IOSpec("X"),
                     IOSpec("Shape", optional=True, no_grad=True),
                     IOSpec("Offsets", optional=True, no_grad=True)],
             outputs=["Out"], attrs={"offsets": [], "shape": []})
def _crop_tensor(ctx, ins, attrs):
    """``crop`` with the shape from the Shape tensor when given."""
    attrs = dict(attrs)
    if x(ins, "Shape") is not None:
        attrs["shape"] = _host_ints(x(ins, "Shape"))
    return _crop_op(ctx, {"X": ins["X"], "Offsets": ins.get("Offsets")},
                    attrs)


@register_op("pad_constant_like", inputs=[IOSpec("X", no_grad=True),
                                          IOSpec("Y")],
             outputs=["Out"], attrs={"pad_value": 0.0})
def _pad_constant_like(ctx, ins, attrs):
    """Y padded at the end of each dim to X's shape with ``pad_value``."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    pads = []
    for xd, yd in reversed(list(zip(xv.shape, yv.shape))):
        pads += [0, xd - yd]
    return out(F.pad(yv, pads, value=attrs["pad_value"]))


@register_op("spp", inputs=["X"], outputs=["Out"],
             attrs={"pyramid_height": 2, "pooling_type": "max"})
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling -> [N, C sum(4^l)]: level l pools 2^l x 2^l
    bins [floor(i H / b), ceil((i + 1) H / b)) (a max's gradient split
    evenly over ties, as ``jnp.max``'s)."""
    xv = x(ins)
    n = xv.shape[0]
    h, w = xv.shape[2:]
    outs = []
    for level in range(int(attrs["pyramid_height"])):
        bins = 2 ** level
        cells = []
        for i in range(bins):
            h0, h1 = (i * h) // bins, -((-(i + 1) * h) // bins)
            for j in range(bins):
                w0, w1 = (j * w) // bins, -((-(j + 1) * w) // bins)
                reg = xv[:, :, h0:h1, w0:w1]
                cells.append(torch.amax(reg, dim=(2, 3))
                             if attrs["pooling_type"] == "max"
                             else reg.mean(dim=(2, 3)))
        outs.append(torch.stack(cells, dim=-1).reshape(n, -1))
    return out(torch.cat(outs, dim=1))


@register_op("unpool", inputs=[IOSpec("X"), IOSpec("Indices", no_grad=True)],
             outputs=["Out"],
             attrs={"unpooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2], "paddings": [0, 0]})
def _unpool(ctx, ins, attrs):
    """Scatter the pooled values back to the flattened per-channel
    positions of Indices, zero elsewhere; Out is
    (H - 1) s - 2 p + k per spatial dim. A negative index counts from
    the end; one still outside Out is dropped (written to an extra slot
    that is sliced off), as XLA's scatter drops it."""
    xv, idx = x(ins, "X"), x(ins, "Indices")
    n, c, h, w = xv.shape
    s, p, k = attrs["strides"], attrs["paddings"], attrs["ksize"]
    oh = (h - 1) * s[0] - 2 * p[0] + k[0]
    ow = (w - 1) * s[1] - 2 * p[1] + k[1]
    size = oh * ow
    idx = idx.reshape(n, c, -1).long()
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    flat = torch.zeros((n, c, size + 1), dtype=xv.dtype, device=xv.device)
    res = flat.scatter(2, idx, xv.reshape(n, c, -1))[..., :size]
    return out(res.reshape(n, c, oh, ow))


@register_op("max_pool2d_with_index", inputs=["X"], outputs=["Out", "Mask"],
             attrs={"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
                    "global_pooling": False, "adaptive": False})
def _max_pool2d_with_index(ctx, ins, attrs):
    """Max pooling with the argmax of each window as the flattened H W
    offset in the unpadded input (the first maximum, as ``jnp.argmax``
    picks it; never a padded position): the unpool contract. The value's
    gradient is split evenly over ties, as ``jnp.max``'s."""
    xv = x(ins)
    n, c, h, w = xv.shape
    kh, kw = attrs["ksize"]
    sh, sw = attrs["strides"]
    ph, pw = attrs["paddings"]
    if attrs.get("global_pooling"):
        kh, kw, sh, sw, ph, pw = h, w, h, w, 0, 0
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    xp = F.pad(xv, (pw, pw, ph, ph), value=-math.inf)
    pos = F.pad(torch.arange(h * w, device=xv.device).reshape(h, w),
                (pw, pw, ph, ph), value=-1)
    patches, ppos = [], []
    for i in range(kh):
        for j in range(kw):
            patches.append(xp[:, :, i:i + oh * sh:sh, j:j + ow * sw:sw])
            ppos.append(pos[i:i + oh * sh:sh, j:j + ow * sw:sw])
    stack = torch.stack(patches, dim=-1)           # [N, C, oh, ow, k]
    posst = torch.stack(ppos, dim=-1)              # [oh, ow, k]
    amax = torch.argmax(stack, dim=-1)
    mask = torch.take_along_dim(posst.expand(n, c, oh, ow, kh * kw),
                                amax[..., None], dim=-1)[..., 0]
    return {"Out": [torch.amax(stack, dim=-1)],
            "Mask": [mask.to(torch.int32)]}


# ---------------------------------------------------------------------------
# 3-D conv / pool / resize
# ---------------------------------------------------------------------------

@register_op("conv3d", inputs=[IOSpec("Input"), IOSpec("Filter"),
                               IOSpec("Bias", optional=True)],
             outputs=["Output"],
             attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                    "dilations": [1, 1, 1], "groups": 1,
                    "data_format": "NCDHW"})
def _conv3d(ctx, ins, attrs):
    """NCDHW input, OIDHW filters, symmetric paddings; the optional Bias
    is per output channel, added after the convolution."""
    res = convolution(x(ins, "Input"), x(ins, "Filter"),
                      stride=attrs["strides"], padding=attrs["paddings"],
                      dilation=attrs["dilations"],
                      groups=attrs.get("groups", 1))
    b = x(ins, "Bias")
    if b is not None:
        res = res + b.reshape((1, -1, 1, 1, 1))
    return {"Output": [res]}


@register_op("conv3d_transpose", inputs=[IOSpec("Input"), IOSpec("Filter"),
                                         IOSpec("Bias", optional=True)],
             outputs=["Output"],
             attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                    "dilations": [1, 1, 1], "groups": 1})
def _conv3d_transpose(ctx, ins, attrs):
    """The JAX package's lhs-dilated forward conv with the flipped kernel
    is a transposed convolution: filters [C_in, C_out, kd, kh, kw], output
    (D - 1) s + (k - 1) d + 1 - 2 p per dim. ``groups`` is ignored, as in
    the JAX package (its convolution takes no feature groups)."""
    res = convolution(x(ins, "Input"), x(ins, "Filter"),
                      stride=attrs["strides"], padding=attrs["paddings"],
                      dilation=attrs["dilations"], transposed=True)
    b = x(ins, "Bias")
    if b is not None:
        res = res + b.reshape((1, -1, 1, 1, 1))
    return {"Output": [res]}


def max_pool3d_by_index(xv, ksize, strides):
    """Max pooling as a gather at ``F.max_pool3d``'s indices (the first
    maximum of each window). Where windows overlap, ``F.max_pool3d``'s
    own gradient adds into an input with atomics on the card and does
    not repeat; the gather's sums in a fixed order."""
    _, idx = F.max_pool3d(xv, ksize, strides, return_indices=True)
    n, c = xv.shape[:2]
    dev = xv.device
    vals = xv.reshape(n, c, -1)[
        torch.arange(n, device=dev)[:, None, None],
        torch.arange(c, device=dev)[None, :, None], idx.reshape(n, c, -1)]
    return vals.reshape(idx.shape)


@register_op("pool3d", inputs=["X"], outputs=["Out"],
             attrs={"pooling_type": "max", "ksize": [2, 2, 2],
                    "strides": [2, 2, 2], "paddings": [0, 0, 0],
                    "global_pooling": False, "exclusive": True,
                    "adaptive": False, "ceil_mode": False})
def _pool3d(ctx, ins, attrs):
    """Max or average pooling over windows of ``ksize`` as the JAX
    package's reduce_window: padding counts as -inf (max) or 0 (average);
    an average divides by the window's real elements when ``exclusive``
    and there is padding, else by prod(ksize). ``adaptive`` and
    ``ceil_mode`` are ignored, as in the JAX package. Max's gradient goes
    to the first maximum of a window, summed in a fixed order where
    windows overlap."""
    xv = x(ins)
    ksize = [int(k) for k in attrs["ksize"]]
    strides = [int(s) for s in attrs["strides"]]
    pads = [int(p) for p in attrs["paddings"]]
    if attrs.get("global_pooling"):
        ksize = list(xv.shape[2:])
        strides, pads = list(ksize), [0, 0, 0]
    pad6 = [p for p in reversed(pads) for _ in range(2)]
    if attrs["pooling_type"] == "max":
        if any(pads):
            xv = F.pad(xv, pad6, value=-math.inf)
        if all(s >= k for s, k in zip(strides, ksize)):
            # disjoint windows: F.max_pool3d's gradient adds into each
            # input at most once, so it repeats, and forward and backward
            # run 13x faster than the gather's on an H100 at C3D's pool1
            # (tools/torch_pool3d_paths.py)
            return out(F.max_pool3d(xv, ksize, strides))
        return out(max_pool3d_by_index(xv, ksize, strides))
    xp = F.pad(xv, pad6) if any(pads) else xv
    s = F.avg_pool3d(xp, ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True) and any(pads):
        ones = F.pad(torch.ones((1, 1) + tuple(xv.shape[2:]), dtype=xv.dtype,
                                device=xv.device), pad6)
        return out(s / F.avg_pool3d(ones, ksize, strides,
                                    divisor_override=1))
    return out(s / float(math.prod(ksize)))


@register_op("trilinear_interp",
             inputs=[IOSpec("X"), IOSpec("OutSize", optional=True,
                                         no_grad=True)],
             outputs=["Out"],
             attrs={"out_d": -1, "out_h": -1, "out_w": -1,
                    "align_corners": True, "align_mode": 1,
                    "interp_method": "trilinear"})
def _trilinear_interp(ctx, ins, attrs):
    """Trilinear resize of NCDHW to (out_d, out_h, out_w) (OutSize, read
    on the host, when given). ``align_corners``: corners map to corners,
    each axis a two-tap gather at linspace(0, in - 1, out). Otherwise as
    ``jax.image.resize(method="trilinear")``: half-pixel centres and a
    triangle kernel widened by in / out on a shrinking axis (antialiased;
    ``F.interpolate`` is not), one weight contraction per changed axis.
    ``align_mode`` is ignored, as in the JAX package."""
    xv = x(ins, "X")
    size = x(ins, "OutSize")
    if size is not None:
        od, oh, ow = _host_ints(size)
    else:
        od, oh, ow = (int(attrs[k]) for k in ("out_d", "out_h", "out_w"))
    if attrs.get("align_corners", True):
        def lin(v, n_out, axis):
            n_in = v.shape[axis]
            pos = linspace_f32(0.0, n_in - 1, n_out, v.device) \
                if n_out > 1 else torch.zeros(1, device=v.device)
            lo = torch.floor(pos).long()
            hi = torch.clamp(lo + 1, max=n_in - 1)
            wgt = (pos - lo).to(v.dtype).reshape(
                [-1 if i == axis else 1 for i in range(v.dim())])
            return take(v, lo, axis) * (1 - wgt) + take(v, hi, axis) * wgt

        return out(lin(lin(lin(xv, od, 2), oh, 3), ow, 4))
    eqs = {2: "ncdhw,dD->ncDhw", 3: "ncdhw,hH->ncdHw", 4: "ncdhw,wW->ncdhW"}
    for axis, n_out in zip((2, 3, 4), (od, oh, ow)):
        n_in = xv.shape[axis]
        if n_out != n_in:
            xv = torch.einsum(eqs[axis], xv, _linear_weights(
                n_in, n_out, xv.device).to(xv.dtype))
    return out(xv)
