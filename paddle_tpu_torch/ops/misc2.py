"""Of ``paddle_tpu/ops/misc2.py``: the sequence tail (sequence_reshape,
sequence_expand_as and sequence_scatter on the padded + lengths
encoding of ``ops/sequence_ops.py``) and the SelectedRows utilities
(merge_selected_rows, get_tensor_from_selected_rows). The module's other
op types wait for a later slice of the port.

References: sequence_reshape_op.h, sequence_expand_as_op.h,
sequence_scatter_op.h, merge_selected_rows_op.cc,
get_tensor_from_selected_rows_op.cc.
"""
from __future__ import annotations

import torch

from ..core.selected_rows import is_selected_rows, merge_rows
from .common import IOSpec, out, register_op, x
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
