"""Counterpart of ``paddle_tpu/ops/misc2.py``, every op type of it: the
deformable convolution and the position-sensitive, precise and
deformable RoI poolings, sampled softmax, the host callback ``py_func``,
the sequence tail (sequence_reshape, sequence_expand_as and
sequence_scatter on the padded + lengths encoding of
``ops/sequence_ops.py``) and the SelectedRows utilities
(merge_selected_rows, get_tensor_from_selected_rows).

Where the JAX package's rule is shaped for XLA, the port computes the
same result another way:

* the bilinear samplers gather whole channel vectors from a
  channels-last copy of the map by advanced indexing, every tap, bin
  and deformable group at once (the reference loops over taps and
  bins in Python); the gradient of such a gather is an accumulating
  ``index_put_``, which sums in a fixed order on the card;
* ``psroi_pool`` sums each bin as two products with the bin's row and
  column masks, not as a masked sum over the whole map for every bin;
* a division by a Python number that feeds a bin bound or a sample
  coordinate is a true division on the card too (``detection.true_div``);
* ``sampled_softmax_with_cross_entropy`` draws from the op's own
  ``torch.Generator``: the bits differ from ``jax.random``'s, the
  log-uniform law is the same;
* ``py_func`` keeps its own registry of callbacks
  (:func:`register_py_func`); on the card the op copies its inputs to
  the host and the results back, a host sync by design, and holds each
  result to its declared shape and dtype.

References: deformable_conv_op.cu, psroi_pool_op.h, prroi_pool_op.h,
deformable_psroi_pooling_op.cu, sampled_softmax_with_cross_entropy_op.cc,
py_func_op.cc, sequence_reshape_op.h, sequence_expand_as_op.h,
sequence_scatter_op.h, merge_selected_rows_op.cc,
get_tensor_from_selected_rows_op.cc.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.selected_rows import is_selected_rows, merge_rows
from ..core.types import np_dtype, torch_dtype
from .common import IOSpec, out, register_op, x
from .detection import device_const, float_range, true_div
from .sequence_ops import lengths, seq_mask


@register_op("sequence_reshape",
             inputs=[IOSpec("X"), IOSpec("SeqLen", no_grad=True)],
             outputs=["Out", "OutLen"], attrs={"new_dim": 1})
def _sequence_reshape(ctx, ins, attrs):
    """reference sequence_reshape_op.h on the padded encoding: [B, T, D]
    -> [B, T*D/new_dim, new_dim]; lengths scale by D/new_dim."""
    xv = x(ins, "X")
    ln = x(ins, "SeqLen").reshape(-1).to(torch.int32)
    b, t, d = xv.shape
    nd = int(attrs["new_dim"])
    if (t * d) % nd:
        raise ValueError(f"sequence_reshape: T*D={t*d} not divisible by "
                         f"new_dim={nd}")
    return {"Out": [xv.reshape(b, (t * d) // nd, nd)],
            "OutLen": [torch.div(ln * d, nd, rounding_mode="floor")]}


@register_op("sequence_expand_as",
             inputs=[IOSpec("X"), IOSpec("Y", no_grad=True),
                     IOSpec("SeqLen", no_grad=True)],
             outputs=["Out"], attrs={})
def _sequence_expand_as(ctx, ins, attrs):
    """reference sequence_expand_as_op.h: row i of X repeats to fill
    sequence i of Y. Padded encoding: X [B, K] broadcasts over Y's time
    axis, zeroed past each length."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    ln = lengths(x(ins, "SeqLen"))
    t = yv.shape[1]
    if xv.dim() == 1:
        xv = xv[:, None]
    expanded = xv[:, None, :].expand(xv.shape[0], t, xv.shape[-1])
    return out(torch.where(seq_mask(ln, t)[..., None], expanded, 0))


@register_op("sequence_scatter",
             inputs=[IOSpec("X"), IOSpec("Ids", no_grad=True),
                     IOSpec("Updates"), IOSpec("SeqLen", no_grad=True)],
             outputs=["Out"], attrs={})
def _sequence_scatter(ctx, ins, attrs):
    """reference sequence_scatter_op.h on the padded encoding: for each
    batch row b, Out[b, Ids[b, t]] += Updates[b, t] for t < len(b).

    Writes past a length go to one extra column that is sliced off (the
    reference's dropped writes), so no index leaves the tensor; the
    accumulation is ``index_put(accumulate=True)``, deterministic on the
    card."""
    xv, ids, upd = x(ins, "X"), x(ins, "Ids"), x(ins, "Updates")
    ln = lengths(x(ins, "SeqLen"))
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    if upd.dim() == 3 and upd.shape[-1] == 1:
        upd = upd[..., 0]
    b, t = ids.shape
    d = xv.shape[1]
    valid = seq_mask(ln, t)
    tgt = torch.where(valid, ids.long().clamp(0, d - 1), d)
    rows = torch.arange(b, device=xv.device)[:, None].expand(b, t)
    wide = torch.cat([xv, xv.new_zeros((b, 1))], dim=1)
    vals = torch.where(valid, upd, 0).to(xv.dtype)
    return out(wide.index_put((rows.reshape(-1), tgt.reshape(-1)),
                              vals.reshape(-1), accumulate=True)[:, :d])


# -- SelectedRows utilities -------------------------------------------------

@register_op("merge_selected_rows", inputs=["X"], outputs=["Out"],
             grad=None)
def _merge_selected_rows(ctx, ins, attrs):
    """Sum duplicate rows. A SelectedRows is canonical from its creation,
    so this merges it again (the same rows and values); a dense input
    passes through."""
    v = x(ins)
    if is_selected_rows(v):
        return out(merge_rows(v.rows, v.values, v.height))
    return out(v)


@register_op("get_tensor_from_selected_rows", inputs=["X"],
             outputs=["Out"], grad=None)
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    """The dense [height, ...] tensor of a SelectedRows; a dense input
    passes through."""
    v = x(ins)
    return out(v.to_dense() if is_selected_rows(v) else v)


# -- bilinear sampling and the RoI batch --------------------------------------

def bilinear_sample(fetch, yy, xx, h, w):
    """Bilinear samples at float coordinates ``yy``/``xx`` (broadcast
    together), zero outside the [h, w] map (the deformable-conv
    convention): ``fetch(y, x)`` gathers the values at integer
    coordinates with a trailing dim of its own. The four taps add in the
    reference's order."""
    y0, x0 = torch.floor(yy), torch.floor(xx)
    y1, x1 = y0 + 1, x0 + 1
    wy1, wx1 = yy - y0, xx - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def tap(yi, xi, wt):
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        v = fetch(torch.clamp(yi, 0, h - 1).long(),
                  torch.clamp(xi, 0, w - 1).long())
        return v * (wt * inside)[..., None]

    return (tap(y0, x0, wy0 * wx0) + tap(y0, x1, wy0 * wx1)
            + tap(y1, x0, wy1 * wx0) + tap(y1, x1, wy1 * wx1))


def roi_batch_indices(op_type, inp, rois, bidx, nums, layer=None):
    """Each RoI's image index, from RoisBatchIdx [R] or BatchRoINums [B]
    (counts per image; RoIs past their sum go to the last image, as
    ``jnp.repeat``'s ``total_repeat_length`` pads). With neither and a
    batch over 1, refused: every RoI would pool from image 0."""
    r = rois.shape[0]
    if bidx is not None:
        return bidx.reshape(-1).long()
    if nums is not None:
        ends = torch.cumsum(nums.reshape(-1).long(), 0)
        pos = torch.arange(r, device=rois.device)
        return torch.clamp(torch.searchsorted(ends, pos, right=True),
                           max=inp.shape[0] - 1)
    if inp.shape[0] > 1:
        raise NotImplementedError(
            f"{op_type}: X has batch size {inp.shape[0]} but neither "
            f"RoisBatchIdx nor BatchRoINums was given — every ROI would "
            f"pool from image 0; pass rois_batch_idx through the layer "
            f"wrapper (fluid.layers.{layer or op_type})")
    return torch.zeros((r,), dtype=torch.long, device=rois.device)


# -- deformable convolution ---------------------------------------------------

@register_op("deformable_conv",
             inputs=[IOSpec("Input"), IOSpec("Offset"),
                     IOSpec("Mask", optional=True), IOSpec("Filter")],
             outputs=["Output"],
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1,
                    "deformable_groups": 1, "im2col_step": 64})
def _deformable_conv(ctx, ins, attrs):
    """Deformable convolution, v2 (modulated) with a Mask, v1 without:
    each tap samples the input bilinearly at its grid position plus a
    learned offset, then a grouped contraction with the filter.
    ``im2col_step`` is accepted and ignored, as the JAX package does."""
    inp, offset = x(ins, "Input"), x(ins, "Offset")
    mask, filt = x(ins, "Mask"), x(ins, "Filter")
    b, c, h, w = inp.shape
    o, cg, kh, kw = filt.shape
    g = int(attrs.get("groups", 1))
    dg = int(attrs.get("deformable_groups", 1))
    sh, sw = attrs["strides"]
    ph, pw = attrs["paddings"]
    dh, dw = attrs["dilations"]
    ho, wo = offset.shape[2], offset.shape[3]
    taps = kh * kw
    dev = inp.device
    off = offset.reshape(b, dg, taps, 2, ho, wo)
    ti = device_const([(t // kw) * dh for t in range(taps)], torch.long, dev)
    tj = device_const([(t % kw) * dw for t in range(taps)], torch.long, dev)
    oy = torch.arange(ho, device=dev) * sh - ph
    ox = torch.arange(wo, device=dev) * sw - pw
    # [b, dg, taps, ho, wo]: the integer grid position, then the offset
    yy = (oy[:, None] + ti[:, None, None]).float()[None, None] \
        + off[:, :, :, 0]
    xx = (ox[None, :] + tj[:, None, None]).float()[None, None] \
        + off[:, :, :, 1]
    cpg = c // dg
    table = inp.permute(0, 2, 3, 1).reshape(b * h * w, dg, cpg)
    base = torch.arange(b, device=dev).reshape(b, 1, 1, 1, 1) * (h * w)
    grp = torch.arange(dg, device=dev).reshape(1, dg, 1, 1, 1)
    samp = bilinear_sample(lambda yi, xi: table[base + yi * w + xi, grp],
                           yy, xx, h, w)          # [b, dg, taps, ho, wo, cpg]
    if mask is not None:
        samp = samp * mask.reshape(b, dg, taps, ho, wo)[..., None]
    samp = samp.permute(0, 2, 1, 5, 3, 4).reshape(b, taps, g, cg, ho, wo)
    res = torch.einsum("btgchw,goct->bgohw", samp,
                       filt.reshape(g, o // g, cg, taps))
    return {"Output": [res.reshape(b, o, ho, wo)]}


# -- RoI poolings -------------------------------------------------------------

@register_op("psroi_pool",
             inputs=[IOSpec("X"), IOSpec("ROIs", no_grad=True),
                     IOSpec("RoisBatchIdx", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"output_channels": 1, "spatial_scale": 1.0,
                    "pooled_height": 1, "pooled_width": 1}, grad=None)
def _psroi_pool(ctx, ins, attrs):
    """Position-sensitive RoI average pooling, [R, oc, ph, pw]: output
    channel o's bin (i, j) averages input channel o*ph*pw + i*pw + j
    over the bin. Each bin sums as the product with its row mask, then
    with its column mask."""
    inp, rois = x(ins, "X"), x(ins, "ROIs")
    bidx = roi_batch_indices("psroi_pool", inp, rois,
                             x(ins, "RoisBatchIdx"), None)
    oc = int(attrs["output_channels"])
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs["spatial_scale"])
    B, _, hh, ww = inp.shape
    R = rois.shape[0]
    dev = inp.device
    q = torch.round(rois * scale)
    x0, y0 = q[:, 0:1], q[:, 1:2]
    x1, y1 = q[:, 2:3] + 1.0, q[:, 3:4] + 1.0
    rh = true_div(torch.clamp(y1 - y0, min=0.1), ph)
    rw = true_div(torch.clamp(x1 - x0, min=0.1), pw)
    iy, ix = float_range(ph, dev)[None, :], float_range(pw, dev)[None, :]
    hs, he = torch.floor(y0 + iy * rh), torch.ceil(y0 + (iy + 1) * rh)
    ws, we = torch.floor(x0 + ix * rw), torch.ceil(x0 + (ix + 1) * rw)
    ys, xs = float_range(hh, dev), float_range(ww, dev)
    my = ((ys >= hs[..., None]) & (ys < he[..., None])).to(inp.dtype)
    mx = ((xs >= ws[..., None]) & (xs < we[..., None])).to(inp.dtype)
    cnt = torch.clamp(my.sum(-1).long()[:, :, None]
                      * mx.sum(-1).long()[:, None, :], min=1)  # [R, ph, pw]
    v = inp.reshape(B, oc, ph, pw, hh, ww)
    rows = torch.einsum("riy,boijyx->rboijx", my, v)
    sums = torch.einsum("rboijx,rjx->rboij", rows, mx)
    sums = sums[torch.arange(R, device=dev), bidx]
    return out(sums / cnt[:, None])


@register_op("prroi_pool",
             inputs=[IOSpec("X"), IOSpec("ROIs", no_grad=True),
                     IOSpec("BatchRoINums", optional=True, no_grad=True),
                     IOSpec("RoisBatchIdx", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"spatial_scale": 1.0, "pooled_height": 1,
                    "pooled_width": 1, "sample_num": 4})
def _prroi_pool(ctx, ins, attrs):
    """Precise RoI pooling as the JAX package computes it: each bin
    averages a dense sample_num x sample_num bilinear grid (the
    reference integrates in closed form), [R, C, ph, pw]."""
    inp, rois = x(ins, "X"), x(ins, "ROIs")
    bidx = roi_batch_indices("prroi_pool", inp, rois,
                             x(ins, "RoisBatchIdx"), x(ins, "BatchRoINums"))
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs["spatial_scale"])
    s = max(int(attrs.get("sample_num", 4)), 1)
    _, _, h, w = inp.shape
    dev = inp.device
    r4 = rois[:, :, None, None, None, None]
    x0, y0 = r4[:, 0] * scale, r4[:, 1] * scale
    x1, y1 = r4[:, 2] * scale, r4[:, 3] * scale
    bw = true_div(torch.clamp(x1 - x0, min=1e-4), pw)
    bh = true_div(torch.clamp(y1 - y0, min=1e-4), ph)
    iy = float_range(ph, dev).reshape(1, ph, 1, 1, 1)
    ix = float_range(pw, dev).reshape(1, 1, pw, 1, 1)
    sy = true_div(float_range(s, dev) + 0.5, s).reshape(1, 1, 1, s, 1)
    sx = true_div(float_range(s, dev) + 0.5, s).reshape(1, 1, 1, 1, s)
    yy = y0 + (iy + sy) * bh                          # [R, ph, 1, s, 1]
    xx = x0 + (ix + sx) * bw                          # [R, 1, pw, 1, s]
    table = inp.permute(0, 2, 3, 1).reshape(-1, inp.shape[1])
    base = bidx.reshape(-1, 1, 1, 1, 1) * (h * w)
    v = bilinear_sample(lambda yi, xi: table[base + yi * w + xi],
                        yy, xx, h, w)             # [R, ph, pw, s, s, C]
    return out(v.mean(dim=(3, 4)).permute(0, 3, 1, 2))


@register_op("deformable_psroi_pooling",
             inputs=[IOSpec("Input"), IOSpec("ROIs", no_grad=True),
                     IOSpec("Trans"),
                     IOSpec("RoisBatchIdx", optional=True, no_grad=True)],
             outputs=["Output", "TopCount"],
             attrs={"no_trans": False, "spatial_scale": 1.0,
                    "output_dim": 1, "group_size": [1, 1],
                    "pooled_height": 1, "pooled_width": 1,
                    "part_size": [1, 1], "sample_per_part": 4,
                    "trans_std": 0.1})
def _deformable_psroi_pooling(ctx, ins, attrs):
    """Deformable position-sensitive RoI pooling, [R, output_dim, ph,
    pw]: each bin's sample grid moves by its part's Trans offset (times
    ``trans_std`` and the RoI's size) and averages its group's channels
    bilinearly; every bin of every RoI in one gather of channel rows.
    TopCount [R, ph, pw] holds the samples a bin averages."""
    inp, rois = x(ins, "Input"), x(ins, "ROIs")
    trans = x(ins, "Trans")               # [R, 2, part_h, part_w]
    bidx = roi_batch_indices("deformable_psroi_pooling", inp, rois,
                             x(ins, "RoisBatchIdx"), None,
                             layer="deformable_roi_pooling")
    od = int(attrs["output_dim"])
    gh, gw = [int(v) for v in attrs["group_size"]]
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    part_h, part_w = [int(v) for v in attrs["part_size"]]
    spp = int(attrs["sample_per_part"])
    scale = float(attrs["spatial_scale"])
    t_std = float(attrs["trans_std"])
    _, _, h, w = inp.shape
    R = rois.shape[0]
    dev = inp.device
    r3 = rois[:, :, None, None]
    x0 = r3[:, 0] * scale - 0.5                       # [R, 1, 1]
    y0 = r3[:, 1] * scale - 0.5
    x1 = (r3[:, 2] + 1.0) * scale - 0.5
    y1 = (r3[:, 3] + 1.0) * scale - 0.5
    rw = torch.clamp(x1 - x0, min=0.1)
    rh = torch.clamp(y1 - y0, min=0.1)
    bw, bh = true_div(rw, pw), true_div(rh, ph)
    sub_h, sub_w = true_div(bh, spp), true_div(bw, spp)
    iy = float_range(ph, dev)[:, None]                      # [ph, 1]
    ix = float_range(pw, dev)[None, :]                      # [1, pw]
    if attrs.get("no_trans", False):
        dx = dy = 0.0
    else:
        pi = device_const([min(int(i * part_h / ph), part_h - 1)
                           for i in range(ph)], torch.long, dev)
        pj = device_const([min(int(j * part_w / pw), part_w - 1)
                           for j in range(pw)], torch.long, dev)
        sel = trans[:, :, pi[:, None], pj[None, :]]   # [R, 2, ph, pw]
        dx = sel[:, 0] * t_std * rw
        dy = sel[:, 1] * t_std * rh
    k = float_range(spp, dev) + 0.5
    sy = ((y0 + iy * bh + dy)[..., None] + k * sub_h[..., None])
    sx = ((x0 + ix * bw + dx)[..., None] + k * sub_w[..., None])
    yy = sy[..., :, None]                             # [R, ph, pw, spp, 1]
    xx = sx[..., None, :]                             # [R, ph, pw, 1, spp]
    # a row per (image, group, pixel) holding the group's od channels
    # (input channel o * gh * gw + g): a bin's samples gather whole rows
    grp = device_const(
        [[min(int(i * gh / ph), gh - 1) * gw + min(int(j * gw / pw), gw - 1)
          for j in range(pw)] for i in range(ph)], torch.long, dev)
    table = inp.reshape(-1, od, gh * gw, h, w).permute(0, 2, 3, 4, 1) \
        .reshape(-1, od)
    base = ((bidx[:, None, None] * (gh * gw) + grp) * (h * w))[
        ..., None, None]                              # [R, ph, pw, 1, 1]
    v = bilinear_sample(lambda yi, xi: table[base + yi * w + xi],
                        yy, xx, h, w)                 # [R, ph, pw, s, s, od]
    cnt = torch.full((R, ph, pw), float(spp * spp), dtype=inp.dtype,
                     device=dev)
    return {"Output": [v.mean(dim=(3, 4)).permute(0, 3, 1, 2)],
            "TopCount": [cnt]}


# -- sampled softmax ----------------------------------------------------------

@register_op("sampled_softmax_with_cross_entropy",
             inputs=[IOSpec("Logits"), IOSpec("Label", no_grad=True)],
             outputs=["Samples", "Probabilities", "Loss"],
             attrs={"num_samples": 5, "seed": 0, "use_customized_samples":
                    False, "remove_accidental_hits": True},
             needs_rng=True)
def _sampled_softmax_ce(ctx, ins, attrs):
    """Softmax cross-entropy over the true class and ``num_samples``
    log-uniform negatives (P(k) = log((k + 2) / (k + 1)) / log(C + 1)),
    each logit less the log of its class's probability; a negative
    equal to the label is masked out with ``remove_accidental_hits``.
    The negatives come from the op's generator, reseeded from a
    non-zero ``seed``."""
    logits = x(ins, "Logits")
    label = x(ins, "Label").reshape(-1).long()
    b, c = logits.shape
    ns = int(attrs["num_samples"])
    dev = logits.device
    g = None if logits.is_meta else ctx.generator()
    if g is None:
        return {"Samples": [torch.empty((b, 1 + ns), dtype=torch.int64,
                                        device=dev)],
                "Probabilities": [logits.new_empty((b, 1 + ns))],
                "Loss": [logits.new_empty((b, 1))]}
    if attrs.get("seed"):
        g.manual_seed(int(attrs["seed"]))
    u = torch.rand((b, ns), generator=g, device=dev)
    neg = torch.clamp((torch.exp(u * math.log(c + 1.0)) - 1.0)
                      .to(torch.int32), 0, c - 1).long()
    samples = torch.cat([label[:, None], neg], dim=1)
    sf = samples.to(torch.float32)
    q = true_div(torch.log((sf + 2.0) / (sf + 1.0)), math.log(c + 1.0))
    rows = torch.arange(b, device=dev)[:, None]
    picked = logits[rows, samples] - torch.log(q)
    if attrs.get("remove_accidental_hits", True):
        hit = samples[:, 1:] == label[:, None]
        picked = torch.cat([picked[:, :1],
                            picked[:, 1:] + torch.where(hit, -1e20, 0.0)],
                           dim=1)
    lse = torch.logsumexp(picked, dim=1, keepdim=True)
    return {"Samples": [samples],
            "Probabilities": [torch.exp(picked - lse)],
            "Loss": [(lse[:, 0] - picked[:, 0]).reshape(b, 1)]}


# -- host callback ------------------------------------------------------------

_PY_FUNCS = []


def register_py_func(fn) -> int:
    """Add ``fn`` to the port's callbacks; its index is the op's
    ``func_id``."""
    _PY_FUNCS.append(fn)
    return len(_PY_FUNCS) - 1


@register_op("py_func", inputs=[IOSpec("X", duplicable=True)],
             outputs=[IOSpec("Out", duplicable=True)],
             attrs={"func_id": 0, "out_shapes": [], "out_dtypes": []},
             grad=None)
def _py_func(ctx, ins, attrs):
    """A host Python callback inside the program: the inputs go to the
    host as numpy arrays (on the card, a host sync for each), the results
    come back to the op's device. Each
    result must have its declared shape and dtype, or the op raises.
    There is no gradient (the callback is opaque)."""
    shapes = [tuple(int(d) for d in s) for s in attrs["out_shapes"]]
    dtypes = [np_dtype(d) for d in attrs["out_dtypes"]]
    vals = [v for v in ins.get("X", []) if v is not None]
    if ctx.device.type == "meta" or any(v.is_meta for v in vals):
        return {"Out": [torch.empty(s, dtype=torch_dtype(d), device="meta")
                        for s, d in zip(shapes, attrs["out_dtypes"])]}
    fid = int(attrs["func_id"])
    res = _PY_FUNCS[fid](*[v.detach().cpu().numpy() for v in vals])
    if not isinstance(res, (list, tuple)):
        res = (res,)
    if len(res) != len(shapes):
        raise ValueError(f"py_func {fid}: the callback returned "
                         f"{len(res)} results, the op declares "
                         f"{len(shapes)}")
    outs = []
    for i, (r, s, d) in enumerate(zip(res, shapes, dtypes)):
        a = np.asarray(r)
        if a.shape != s or a.dtype != d:
            raise TypeError(f"py_func {fid}: result {i} is {a.dtype}"
                            f"{list(a.shape)}, the op declares "
                            f"{np.dtype(d)}{list(s)}")
        # from pageable memory the copy is staged before it returns: the
        # array may go, and the host does not wait for the card
        outs.append(torch.from_numpy(np.ascontiguousarray(a))
                    .to(ctx.device, non_blocking=True))
    return {"Out": outs}
