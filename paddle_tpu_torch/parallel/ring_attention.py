"""Ring attention: sequence (context) parallelism over a mesh axis.

Counterpart of ``paddle_tpu/parallel/ring_attention.py``. The sequence is
split over the ranks of the ``sp`` axis; each rank keeps its query block
and K/V blocks rotate around the ring (``distributed._ring_exchange``,
point to point), so no rank holds the ``[T, T]`` score matrix or the
gathered K and V. Each block product is one call of the port's
``flash_attention_with_lse`` (K1 forward; K3 and K4 through its
backward) with the block's global offsets, ``q_offset = my * T_local``
and ``k_offset = src * T_local``, so causal masking is on global
positions; the blocks combine by their log-sum-exp, a row no key reached
yet (lse = -inf) weighing 0 (the JAX body's ``combine``). The rotation is
a ``torch.autograd.Function`` whose backward rotates the cotangents the
other way, so autograd through the ring is exact.

The port runs one process a rank and its activations outside the op are
replicated over ``sp`` (as under GSPMD with a ``dp``-only feed spec):
:func:`ring_attention` takes this rank's ``[B, T, H, D]`` (its ``dp``
rows, every position), cuts its sequence block, runs the ring and
all-gathers the output along the sequence; the backward of the cut
all-gathers the block gradients, so the value and the gradients on every
rank equal single-device attention.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import distributed as _dist

__all__ = ["ring_attention", "ring_attention_local", "attention_reference"]


class _RingShift(torch.autograd.Function):
    """Send to the next rank of the ring, receive from the previous; the
    backward sends the cotangent back the other way."""

    @staticmethod
    def forward(ctx, t, group, ranks):
        ctx.group, ctx.ranks = group, ranks
        return _dist._ring_exchange(t.contiguous(), group, ranks, 1)

    @staticmethod
    def backward(ctx, g):
        return _dist._ring_exchange(g.contiguous(), ctx.group, ctx.ranks,
                                    -1), None, None


class _SeqShard(torch.autograd.Function):
    """This rank's block of a value replicated over the ring; the
    backward all-gathers the blocks' gradients (each rank computed its
    own block's), so the gradient comes back whole and replicated."""

    @staticmethod
    def forward(ctx, t, dim, group, index, parts):
        ctx.dim, ctx.group = dim, group
        k = t.shape[dim] // parts
        return t.narrow(dim, index * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_dist._all_gather(g.contiguous(), ctx.group, dim=ctx.dim),
                None, None, None, None)


class _SeqGather(torch.autograd.Function):
    """Every rank's block concatenated along ``dim``; the backward keeps
    this rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, t, dim, group, index):
        ctx.dim, ctx.index, ctx.k = dim, index, t.shape[dim]
        return _dist._all_gather(t.contiguous(), group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.k, ctx.k).contiguous(),
                None, None, None)


def _combine(o, lse, o_s, lse_s):
    """Two partials over disjoint key sets: lse = logaddexp, each o
    weighed by exp(its lse - lse); a row neither reached stays (0, -inf).
    Written so no -inf reaches an exp or log that autograd differentiates
    (a masked branch would turn its zero gradient into NaN)."""
    m = torch.maximum(lse, lse_s)
    alive = torch.isfinite(m)
    m0 = torch.where(alive, m, torch.zeros_like(m))
    fa, fb = torch.isfinite(lse), torch.isfinite(lse_s)
    ea = torch.where(fa, torch.exp(torch.where(fa, lse, m0) - m0),
                     torch.zeros_like(m))
    eb = torch.where(fb, torch.exp(torch.where(fb, lse_s, m0) - m0),
                     torch.zeros_like(m))
    tot = ea + eb
    lse_new = torch.where(alive, m0 + torch.log(torch.where(
        alive, tot, torch.ones_like(tot))), torch.full_like(m, -float("inf")))
    safe = torch.where(alive, tot, torch.ones_like(tot))
    o_new = (o.float() * (ea / safe)[..., None]
             + o_s.float() * (eb / safe)[..., None])
    return o_new.to(o.dtype), lse_new


def _block_fn(use_flash: Optional[bool]):
    from ..kernels import flash_attention_reference, flash_attention_with_lse
    from ..ops.fused_attention import plain_requested

    if use_flash is None:
        use_flash = not plain_requested()
    return flash_attention_with_lse if use_flash \
        else flash_attention_reference


def ring_attention_local(q, k, v, axis_name: str, causal: bool = False,
                         scale: Optional[float] = None,
                         use_flash: Optional[bool] = None, mesh=None):
    """The per-rank body: q, k, v are this rank's ``[B, T_local, H, D]``
    blocks of the sequence; returns its ``[B, T_local, H, D]`` block of
    the output. ``axis_name`` is the ring's axis of ``mesh``.
    ``use_flash``: None runs the kernels (the plain versions under
    ``FLAGS_use_flash_attention=never``); a CUDA tensor launches K1 (and
    K3/K4 in the backward), a CPU tensor takes their plain versions."""
    B, Tl, H, D = q.shape
    group, ranks = _dist.axis_group(mesh, axis_name) if mesh is not None \
        else (None, [0])
    me = ranks.index(_dist.get_rank()) if len(ranks) > 1 else 0
    n = len(ranks)
    scale = float(scale if scale is not None else D ** -0.5)
    fn = _block_fn(use_flash)

    def to_bh(t):
        return t.transpose(1, 2).reshape(B * H, Tl, D)

    qh, kb, vb = to_bh(q), to_bh(k), to_bh(v)

    def block(kb, vb, s):
        src = (me - s) % n            # the rank this k/v block came from
        return fn(qh, kb, vb, causal=causal, scale=scale,
                  q_offset=me * Tl, k_offset=src * Tl, num_heads=H)

    o, lse = block(kb, vb, 0)
    for s in range(1, n):             # the last block rotates no further
        kb = _RingShift.apply(kb, group, ranks)
        vb = _RingShift.apply(vb, group, ranks)
        o, lse = _combine(o, lse, *block(kb, vb, s))
    return o.reshape(B, H, Tl, D).transpose(1, 2)


def ring_attention(q, k, v, mesh, seq_axis: str = "sp",
                   causal: bool = False, scale: Optional[float] = None,
                   use_flash: Optional[bool] = None):
    """q, k, v: this rank's ``[B, T, H, D]`` (its ``dp`` rows, the whole
    sequence, replicated over ``seq_axis``); T splits over the ring.
    Returns the whole ``[B, T, H, D]`` output, replicated, whose value and
    gradients equal single-device attention."""
    n = mesh.shape.get(seq_axis, 1)
    if n <= 1:
        return ring_attention_local(q, k, v, seq_axis, causal, scale,
                                    use_flash, mesh)
    T = q.shape[1]
    if T % n:
        raise ValueError(f"ring attention: sequence length {T} does not "
                         f"split over '{seq_axis}' of size {n}")
    group, ranks = _dist.axis_group(mesh, seq_axis)
    me = ranks.index(_dist.get_rank())
    loc = [_SeqShard.apply(t, 1, group, me, n) for t in (q, k, v)]
    o = ring_attention_local(*loc, seq_axis, causal, scale, use_flash,
                             mesh)
    return _SeqGather.apply(o, 1, group, me)


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Dense single-device attention over ``[B, T, H, D]`` (the oracle)."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bqhd,bkhd->bqhk", q * scale, k)
    if causal:
        T = q.shape[1]
        mask = torch.arange(T)[:, None] >= torch.arange(T)[None, :]
        s = s.masked_fill(~mask.to(s.device)[None, :, None, :],
                          torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v)
