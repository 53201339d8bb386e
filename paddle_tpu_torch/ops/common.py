"""Shared helpers for op rules."""
from __future__ import annotations

from ..core.registry import IOSpec, register_op  # re-export for op modules

__all__ = ["register_op", "IOSpec", "x", "out", "broadcast_to_x", "unary"]


def x(ins, slot="X", i=0):
    """The i-th value of a slot (None if absent)."""
    vals = ins.get(slot)
    if not vals:
        return None
    return vals[i] if i < len(vals) else None


def out(val, slot="Out"):
    return {slot: [val]}


def broadcast_to_x(xv, yv, axis: int):
    """Reference elementwise broadcast rule: Y's shape matches a
    contiguous span of X's dims starting at ``axis`` (-1: align trailing
    dims, numpy broadcasting)."""
    if tuple(xv.shape) == tuple(yv.shape) or axis == -1 or axis is None:
        return yv
    pad_right = xv.dim() - axis - yv.dim()
    if pad_right < 0:
        raise ValueError(f"elementwise axis={axis} incompatible: "
                         f"x{tuple(xv.shape)} y{tuple(yv.shape)}")
    return yv.reshape((1,) * axis + tuple(yv.shape) + (1,) * pad_right)


def unary(op_type, fn, **kwargs):
    """Register a single-input single-output elementwise op."""

    @register_op(op_type, inputs=["X"], outputs=["Out"], **kwargs)
    def _lower(ctx, ins, attrs, _fn=fn):
        return out(_fn(x(ins)))

    return _lower
