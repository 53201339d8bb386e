"""Shared helpers for op rules."""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.registry import IOSpec, register_op  # re-export for op modules

__all__ = ["register_op", "IOSpec", "x", "out", "broadcast_to_x", "unary",
           "convolution", "true_div"]


def x(ins, slot="X", i=0):
    """The i-th value of a slot (None if absent)."""
    vals = ins.get(slot)
    if not vals:
        return None
    return vals[i] if i < len(vals) else None


def out(val, slot="Out"):
    return {slot: [val]}


def true_div(x, d):
    """``x / d`` for a Python number ``d``, correctly rounded on every
    device. The card divides a float32 tensor by a Python number as a
    product with its reciprocal, up to an ulp off the CPU's quotient, and
    that ulp moves a floor, a bin bound or the fractional part of a large
    coordinate; a 0-dim tensor divisor is a true division on both."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


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


_CUDNN_LOCK = threading.RLock()


@contextlib.contextmanager
def _exact_cudnn():
    """cuDNN in full float32 (no TF32) on its deterministic algorithms,
    whatever the process-wide settings are; they are restored after. The
    lock keeps another thread's convolution from launching while they
    are set back."""
    cudnn = torch.backends.cudnn
    with _CUDNN_LOCK:
        was = cudnn.deterministic, cudnn.allow_tf32
        cudnn.deterministic, cudnn.allow_tf32 = True, False
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.allow_tf32 = was


class _Convolution(torch.autograd.Function):
    """``aten.convolution`` whose forward and backward both launch under
    :func:`_exact_cudnn` (the backward runs later, outside the rule)."""

    @staticmethod
    def forward(ctx, inp, weight, bias, conf):
        ctx.save_for_backward(inp, weight)
        ctx.conf = conf
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        with _exact_cudnn():
            return torch.ops.aten.convolution(inp, weight, bias, *conf)

    @staticmethod
    def backward(ctx, g):
        inp, weight = ctx.saved_tensors
        mask = [bool(m) for m in ctx.needs_input_grad[:3]]
        with _exact_cudnn():
            gi, gw, gb = torch.ops.aten.convolution_backward(
                g, inp, weight, ctx.bias_sizes, *ctx.conf, mask)
        return gi, gw, gb, None


def convolution(inp, weight, bias=None, stride=None, padding=None,
                dilation=None, groups=1, transposed=False):
    """An N-d convolution (transposed: its gradient with respect to the
    input), forward and backward on cuDNN's deterministic algorithms and
    in full float32 (no TF32), whatever the process-wide cuDNN settings:
    a float32 program computes in float32 and repeats bit for bit.
    ``stride``, ``padding`` and ``dilation`` have one entry a spatial
    dim."""
    nd = inp.dim() - 2
    conf = (list(stride or [1] * nd), list(padding or [0] * nd),
            list(dilation or [1] * nd), transposed, [0] * nd, groups)
    return _Convolution.apply(inp, weight, bias, conf)
