"""Sequence (LoD) ops on the padded + lengths encoding (counterpart of
``paddle_tpu/ops/sequence_ops.py``, every op type of it).

Reference: paddle/fluid/operators/sequence_ops/ — the reference stores
variable-length batches packed with offset tables and every kernel walks
the offsets. Here a lod_level-1 tensor is a padded ``[batch, max_len,
...]`` tensor plus an int32 ``[batch]`` lengths tensor in the companion
variable ``<name>@LOD`` (``layers/sequence.py``). Every op takes the
lengths through a ``SeqLen`` input slot, masks with ``arange < len``
instead of walking offsets, and writes zeros at invalid positions so
downstream ops see deterministic padding.

The lengths stay on the device: an op casts them to int64 where it
indexes with them and never reads them on the host (no ``.item()``, no
``.cpu()``), so a step on the card makes no sync here. Gradients come
from the generic grad (``lowering._lower_generic_grad``): masking makes
the padded positions' gradients zero.
"""
from __future__ import annotations

import torch

from .common import IOSpec, out, register_op, x


def lengths(ln):
    """[batch] int64 lengths on the device (an index dtype)."""
    return ln.reshape(-1).long()


def seq_mask(ln, max_len):
    """[batch, max_len] bool validity mask from [batch] lengths."""
    return torch.arange(max_len, device=ln.device)[None, :] < ln[:, None]


def expand_mask(m, ndim):
    """Broadcast a [batch, time] mask over trailing feature dims."""
    return m.reshape(tuple(m.shape) + (1,) * (ndim - 2))


def take_time(xv, idx):
    """``xv[b, idx[b, t], ...]``: a gather along the time axis (dim 1)
    with a [batch, time'] index (batch 1 broadcasts), broadcast over the
    feature dims. Another batch than X's is refused, as
    ``jnp.take_along_axis`` refuses it."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (xv.dim() - 2))
    return torch.gather(xv, 1, idx.expand(
        (xv.shape[0], idx.shape[1]) + tuple(xv.shape[2:])))


def reverse_index(ln, max_len):
    """[batch, max_len] index reversing each sequence's valid prefix;
    padding stays at the tail."""
    t = torch.arange(max_len, device=ln.device)[None, :]
    return torch.where(t < ln[:, None], ln[:, None] - 1 - t, t)


def _dtype_min(dt):
    return torch.finfo(dt).min if dt.is_floating_point \
        else torch.iinfo(dt).min


def _dtype_max(dt):
    return torch.finfo(dt).max if dt.is_floating_point \
        else torch.iinfo(dt).max


@register_op("sequence_pool",
             inputs=[IOSpec("X"), IOSpec("SeqLen", no_grad=True)],
             outputs=["Out", IOSpec("MaxIndex", optional=True)],
             attrs={"pooltype": "AVERAGE", "pad_value": 0.0})
def _sequence_pool(ctx, ins, attrs):
    """reference sequence_pool_op.h: one pooled row per sequence. MAX and
    MIN reduce with ``amax``/``amin``, whose gradient splits evenly
    between tied elements (as ``jnp.max``'s does); an empty sequence gives
    ``pad_value``, and LAST reads row 0."""
    xv, ln = x(ins, "X"), lengths(x(ins, "SeqLen"))
    t = attrs["pooltype"].upper()
    m = expand_mask(seq_mask(ln, xv.shape[1]), xv.dim())
    rows = (-1,) + (1,) * (xv.dim() - 2)
    lnf = ln.clamp(min=1).to(xv.dtype).reshape(rows)
    if t == "SUM":
        res = torch.where(m, xv, 0).sum(dim=1)
    elif t == "AVERAGE":
        res = torch.where(m, xv, 0).sum(dim=1) / lnf
    elif t == "SQRT":
        res = torch.where(m, xv, 0).sum(dim=1) / torch.sqrt(lnf)
    elif t == "MAX":
        res = torch.where(m, xv, _dtype_min(xv.dtype)).amax(dim=1)
        res = torch.where(ln.reshape(rows) > 0, res, attrs["pad_value"])
    elif t == "MIN":
        res = torch.where(m, xv, _dtype_max(xv.dtype)).amin(dim=1)
        res = torch.where(ln.reshape(rows) > 0, res, attrs["pad_value"])
    elif t == "LAST":
        res = take_time(xv, (ln - 1).clamp(min=0)[:, None]).squeeze(1)
    elif t == "FIRST":
        res = xv[:, 0]
    else:
        raise ValueError(f"sequence_pool: unknown pooltype {t}")
    return out(res)


@register_op("sequence_softmax",
             inputs=[IOSpec("X"), IOSpec("SeqLen", no_grad=True)],
             outputs=["Out"], attrs={})
def _sequence_softmax(ctx, ins, attrs):
    """reference sequence_softmax_op.h: softmax within each sequence;
    padded positions get probability 0. The fill is ``finfo.min``, not
    -inf, so a fully padded row gives 0s, not NaNs."""
    xv, ln = x(ins, "X"), lengths(x(ins, "SeqLen"))
    m = expand_mask(seq_mask(ln, xv.shape[1]), xv.dim())
    e = torch.softmax(torch.where(m, xv, torch.finfo(xv.dtype).min), dim=1)
    return out(torch.where(m, e, 0))


@register_op("sequence_reverse",
             inputs=[IOSpec("X"), IOSpec("SeqLen", no_grad=True)],
             outputs=["Y"], attrs={})
def _sequence_reverse(ctx, ins, attrs):
    """reference sequence_reverse_op.h: reverse each sequence's valid
    prefix; padding stays in place."""
    xv, ln = x(ins, "X"), lengths(x(ins, "SeqLen"))
    return {"Y": [take_time(xv, reverse_index(ln, xv.shape[1]))]}


@register_op("sequence_expand",
             inputs=[IOSpec("X"), IOSpec("Y", no_grad=True),
                     IOSpec("SeqLen", no_grad=True)],
             outputs=["Out"], attrs={"ref_level": -1})
def _sequence_expand(ctx, ins, attrs):
    """reference sequence_expand_op.h, padded analogue of the common case:
    X has one row per sequence; each row is broadcast over Y's time steps
    (masked by Y's lengths). An X with its own time axis has no padded
    encoding and is refused."""
    xv, yv, ln = x(ins, "X"), x(ins, "Y"), lengths(x(ins, "SeqLen"))
    if xv.dim() >= yv.dim():
        raise ValueError(
            f"sequence_expand: X (shape {tuple(xv.shape)}) must be one row "
            f"per sequence (rank < Y's rank {tuple(yv.shape)}); expanding "
            f"an X with its own time axis is not supported in the padded "
            f"encoding")
    max_len = yv.shape[1]
    rep = xv[:, None].expand((xv.shape[0], max_len) + tuple(xv.shape[1:]))
    m = expand_mask(seq_mask(ln, max_len), rep.dim())
    return out(torch.where(m, rep, 0))


@register_op("sequence_concat",
             inputs=[IOSpec("X", duplicable=True),
                     IOSpec("SeqLen", duplicable=True, no_grad=True)],
             outputs=["Out", IOSpec("OutLen", no_grad=True)],
             attrs={})
def _sequence_concat(ctx, ins, attrs):
    """reference sequence_concat_op.h: concatenate along time per sequence
    (out length = sum of lengths), not along the padded axis."""
    xs, lns = ins["X"], ins["SeqLen"]
    total = sum(v.shape[1] for v in xs)
    batch = xs[0].shape[0]
    dev = xs[0].device
    t = torch.arange(total, device=dev)[None, :]
    res = torch.zeros((batch, total) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=dev)
    offset = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    for v, ln in zip(xs, lns):
        ln = lengths(ln)
        # positions offset <= t < offset+len come from v[t - offset]
        local = t - offset
        sel = (local >= 0) & (local < ln[:, None])
        gathered = take_time(v, local.clamp(0, v.shape[1] - 1))
        res = torch.where(expand_mask(sel, res.dim()), gathered, res)
        offset = offset + ln[:, None]
    out_len = lns[0]
    for ln in lns[1:]:
        out_len = out_len + ln
    return {"Out": [res], "OutLen": [out_len]}


@register_op("sequence_pad",
             inputs=[IOSpec("X"), IOSpec("SeqLen", no_grad=True),
                     IOSpec("PadValue", no_grad=True)],
             outputs=["Out", IOSpec("Length", no_grad=True)],
             attrs={"padded_length": -1})
def _sequence_pad(ctx, ins, attrs):
    """reference sequence_pad_op.h: emit the padded tensor with the pad
    value written at invalid positions, plus the Length tensor."""
    xv, ln, pv = x(ins, "X"), x(ins, "SeqLen"), x(ins, "PadValue")
    plen = attrs.get("padded_length", -1)
    if plen and plen > 0:
        cur = xv.shape[1]
        if plen < cur:
            xv = xv[:, :plen]
        elif plen > cur:
            xv = torch.cat([xv, xv.new_zeros(
                (xv.shape[0], plen - cur) + tuple(xv.shape[2:]))], dim=1)
    m = expand_mask(seq_mask(lengths(ln), xv.shape[1]), xv.dim())
    fill = pv.reshape((1,) * xv.dim()) if pv is not None else 0.0
    return {"Out": [torch.where(m, xv, fill)], "Length": [ln]}


@register_op("sequence_unpad",
             inputs=[IOSpec("X"), IOSpec("Length", no_grad=True)],
             outputs=["Out", IOSpec("OutLen", no_grad=True)], attrs={})
def _sequence_unpad(ctx, ins, attrs):
    """reference sequence_unpad_op.h: padded + Length -> LoD tensor. In the
    padded encoding this re-associates lengths and zeroes the padding."""
    xv = x(ins, "X")
    ln = x(ins, "Length").reshape(-1).to(torch.int32)
    m = expand_mask(seq_mask(lengths(ln), xv.shape[1]), xv.dim())
    return {"Out": [torch.where(m, xv, 0)], "OutLen": [ln]}


@register_op("sequence_slice",
             inputs=[IOSpec("X"), IOSpec("SeqLen", no_grad=True),
                     IOSpec("Offset", no_grad=True),
                     IOSpec("Length", no_grad=True)],
             outputs=["Out", IOSpec("OutLen", no_grad=True)], attrs={})
def _sequence_slice(ctx, ins, attrs):
    """reference sequence_slice_op.h: per-sequence [offset, offset+length)
    window."""
    xv = x(ins, "X")
    off = lengths(x(ins, "Offset"))
    length = x(ins, "Length").reshape(-1)
    t = torch.arange(xv.shape[1], device=xv.device)[None, :]
    g = take_time(xv, (off[:, None] + t).clamp(0, xv.shape[1] - 1))
    m = expand_mask(t < length.long()[:, None], xv.dim())
    return {"Out": [torch.where(m, g, 0)],
            "OutLen": [length.to(torch.int32)]}


@register_op("sequence_erase",
             inputs=[IOSpec("X", no_grad=True), IOSpec("SeqLen", no_grad=True)],
             outputs=["Out", IOSpec("OutLen", no_grad=True)],
             attrs={"tokens": []})
def _sequence_erase(ctx, ins, attrs):
    """reference sequence_erase_op.h: drop the listed token ids and compact
    each sequence to the front (int ids; not differentiable)."""
    xv, ln = x(ins, "X"), lengths(x(ins, "SeqLen"))
    keep = seq_mask(ln, xv.shape[1])
    for tok in attrs["tokens"]:     # python scalars: no host-to-card copy
        keep = keep & (xv != int(tok))
    # stable compaction: kept positions sort before dropped ones
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    compacted = torch.gather(xv, 1, order)
    new_len = keep.sum(dim=1).to(torch.int32)
    m = seq_mask(lengths(new_len), xv.shape[1])
    return {"Out": [torch.where(m, compacted, 0)], "OutLen": [new_len]}


@register_op("sequence_enumerate",
             inputs=[IOSpec("X", no_grad=True), IOSpec("SeqLen", no_grad=True)],
             outputs=["Out"], attrs={"win_size": 2, "pad_value": 0})
def _sequence_enumerate(ctx, ins, attrs):
    """reference sequence_enumerate_op.h: sliding windows of ids,
    pad_value past each sequence's end."""
    xv, ln = x(ins, "X"), lengths(x(ins, "SeqLen"))
    win, pad = attrs["win_size"], attrs["pad_value"]
    t = torch.arange(xv.shape[1], device=xv.device)[None, :]
    cols = []
    for k in range(win):
        v = take_time(xv, (t + k).clamp(0, xv.shape[1] - 1).expand(
            xv.shape[0], -1))
        cols.append(torch.where(t + k < ln[:, None], v, pad))
    return out(torch.stack(cols, dim=-1))


@register_op("sequence_conv",
             inputs=[IOSpec("X"), IOSpec("Filter"),
                     IOSpec("SeqLen", no_grad=True)],
             outputs=["Out"],
             attrs={"contextLength": 3, "contextStart": -1,
                    "contextStride": 1})
def _sequence_conv(ctx, ins, attrs):
    """reference sequence_conv_op.h: im2col over the time axis within each
    sequence then GEMM — out[t] = concat(x[t+start .. t+start+L-1]) @ W,
    with out-of-sequence context rows zero."""
    xv, w, ln = x(ins, "X"), x(ins, "Filter"), lengths(x(ins, "SeqLen"))
    L, start = attrs["contextLength"], attrs["contextStart"]
    T = xv.shape[1]
    t = torch.arange(T, device=xv.device)[None, :]
    valid = t < ln[:, None]
    frames = []
    for k in range(L):
        idx = t + start + k
        ok = (idx >= 0) & (idx < ln[:, None])
        v = take_time(xv, idx.clamp(0, T - 1).expand(xv.shape[0], -1))
        frames.append(torch.where(ok[..., None], v, 0))
    col = torch.cat(frames, dim=-1)  # [b, T, L*d]
    res = torch.matmul(col, w)
    return out(torch.where(valid[..., None], res, 0))


@register_op("sequence_mask", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Y"], attrs={"maxlen": -1, "out_dtype": "float32"})
def _sequence_mask(ctx, ins, attrs):
    """reference sequence_mask_op.h: lengths -> [.., maxlen] 0/1 mask. The
    maxlen is static: the reference's default (the longest length) would
    read the lengths on the host."""
    from ..core.types import torch_dtype

    ln = x(ins, "X")
    maxlen = attrs["maxlen"]
    if maxlen is None or maxlen <= 0:
        raise ValueError("sequence_mask on TPU needs a static maxlen attr")
    m = torch.arange(maxlen, device=ln.device)[None, :] < ln.reshape(-1, 1)
    m = m.reshape(tuple(ln.shape) + (maxlen,))
    return {"Y": [m.to(torch_dtype(attrs["out_dtype"]))]}
