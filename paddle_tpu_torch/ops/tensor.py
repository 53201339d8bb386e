"""Tensor creation / manipulation ops (counterpart of
``paddle_tpu/ops/tensor.py``), the ones the GPT, BERT and MLP paths and
the initializers run. Random ops
draw from the op's own ``torch.Generator`` (``LowerCtx.generator``)."""
from __future__ import annotations

import math

import torch

from ..core.types import is_floating, torch_dtype
from .common import IOSpec, out, register_op, x


@register_op("fill_constant", outputs=["Out"],
             attrs={"shape": [], "value": 0.0, "dtype": "float32",
                    "force_cpu": False})
def _fill_constant(ctx, ins, attrs):
    value = attrs["value"]
    if not is_floating(attrs["dtype"]):
        value = int(value)
    return out(torch.full(tuple(int(s) for s in attrs["shape"]), value,
                          dtype=torch_dtype(attrs["dtype"]),
                          device=ctx.device))


def _random_out(ctx, attrs):
    """An empty float32 tensor of the op's shape, and the op's generator
    (reseeded from a non-zero ``seed`` attr); the generator is None on
    meta tensors, where nothing is drawn."""
    res = torch.empty(tuple(int(s) for s in attrs["shape"]),
                      dtype=torch.float32, device=ctx.device)
    g = None if res.is_meta else ctx.generator()
    if g is not None and attrs.get("seed"):
        g.manual_seed(int(attrs["seed"]))
    return res, g


@register_op("uniform_random", outputs=["Out"],
             attrs={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
                    "dtype": "float32"},
             needs_rng=True, grad=None)
def _uniform_random(ctx, ins, attrs):
    """U[min, max). The bits differ from jax.random.uniform; the
    distribution is the same."""
    res, g = _random_out(ctx, attrs)
    if g is not None:
        res.uniform_(attrs["min"], attrs["max"], generator=g)
    return out(res.to(torch_dtype(attrs["dtype"])))


@register_op("gaussian_random", outputs=["Out"],
             attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                    "dtype": "float32"},
             needs_rng=True, grad=None)
def _gaussian_random(ctx, ins, attrs):
    """Normal(mean, std); bits differ from jax.random.normal."""
    res, g = _random_out(ctx, attrs)
    if g is not None:
        res.normal_(attrs["mean"], attrs["std"], generator=g)
    return out(res.to(torch_dtype(attrs["dtype"])))


@register_op("truncated_gaussian_random", outputs=["Out"],
             attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                    "dtype": "float32"},
             needs_rng=True, grad=None)
def _truncated_gaussian_random(ctx, ins, attrs):
    """Normal(mean, std) truncated to two standard deviations, by inverse
    CDF of a uniform draw restricted to [Phi(-2), Phi(2)]. The bits differ
    from jax.random.truncated_normal; the distribution is the same."""
    dt = torch_dtype(attrs["dtype"])
    res, g = _random_out(ctx, attrs)
    if g is None:
        return out(res.to(dt))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    res.uniform_(lo, 1.0 - lo, generator=g)
    res = torch.erfinv(2.0 * res - 1.0) * math.sqrt(2.0)
    res = res.clamp_(-2.0, 2.0) * attrs["std"] + attrs["mean"]
    return out(res.to(dt))


@register_op("assign", inputs=["X"], outputs=["Out"])
def _assign(ctx, ins, attrs):
    return out(x(ins))


@register_op("increment", inputs=["X"], outputs=["Out"], attrs={"step": 1.0},
             grad=None)
def _increment(ctx, ins, attrs):
    """X + step in X's dtype (an int counter stays an int)."""
    xv = x(ins)
    return out(xv + torch.tensor(attrs["step"], dtype=xv.dtype,
                                 device=xv.device))


def _infer_reshape(op, block):
    xv = block.var(op.input("X")[0])
    shape = list(op.attrs["shape"])
    if xv.shape is not None:
        has_neg = -1 in shape
        for i, s in enumerate(shape):
            if s == 0:
                shape[i] = xv.shape[i]
        concrete = [s for s in shape if s != -1]
        if has_neg and all(d != -1 for d in xv.shape):
            total = math.prod(xv.shape)
            rest = math.prod(concrete) if concrete else 1
            shape[shape.index(-1)] = total // rest
    ov = block.var(op.output("Out")[0])
    ov.shape = tuple(shape)
    ov.dtype = xv.dtype
    if op.output("XShape"):
        xs = block.var(op.output("XShape")[0])
        xs.shape = (0,) + tuple(xv.shape or ())
        xs.dtype = xv.dtype


def _xshape(xv):
    return torch.zeros((0,), dtype=xv.dtype, device=xv.device)


@register_op("reshape2",
             inputs=[IOSpec("X"), IOSpec("Shape", optional=True,
                                         no_grad=True)],
             outputs=["Out", "XShape"], attrs={"shape": []},
             infer_shape=_infer_reshape)
def _reshape2(ctx, ins, attrs):
    xv = x(ins)
    shape = [xv.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": [xv.reshape(shape)], "XShape": [_xshape(xv)]}


@register_op("transpose2", inputs=["X"], outputs=["Out", "XShape"],
             attrs={"axis": []})
def _transpose2(ctx, ins, attrs):
    xv = x(ins)
    return {"Out": [xv.permute(*attrs["axis"])], "XShape": [_xshape(xv)]}


@register_op("unsqueeze2", inputs=["X"], outputs=["Out", "XShape"],
             attrs={"axes": []})
def _unsqueeze2(ctx, ins, attrs):
    xv = x(ins)
    res = xv
    for a in sorted(attrs["axes"]):
        res = res.unsqueeze(a)
    return {"Out": [res], "XShape": [_xshape(xv)]}


@register_op("slice", inputs=["Input"], outputs=["Out"],
             attrs={"axes": [], "starts": [], "ends": [],
                    "decrease_axis": []})
def _slice(ctx, ins, attrs):
    xv = x(ins, "Input")
    idx = [slice(None)] * xv.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    res = xv[tuple(idx)]
    if attrs.get("decrease_axis"):
        res = res.squeeze(tuple(attrs["decrease_axis"]))
    return out(res)


# a table this short is read by many rows per id (BERT's two segment
# types): the sorted accumulation sums each id's rows one after another
# (7.18 ms for 16384 rows on 2 ids on an H100), so its grad is a masked
# sum over the rows per id instead, a reduction in a fixed order that
# stays float32 and off the GEMMs (it holds height + 1 masked copies of
# the output grad)
_MASKED_SUM_MAX_ROWS = 4


def _lookup_table_grad(ctx, ins, attrs):
    """Dense scatter-add of the output grad into the table's rows, as the
    reference's custom grad for a dense table: ids clamped as the forward
    gathers them; padding rows go to a spare row that is dropped. The sum
    runs in an order fixed for the inputs, so runs repeat bit for bit."""
    if attrs.get("is_sparse") or attrs.get("is_distributed"):
        raise NotImplementedError(
            "sparse (SelectedRows) embedding grads wait for a later slice "
            "of the port")
    w, ids, g = x(ins, "W"), x(ins, "Ids"), x(ins, "Out@GRAD")
    height, dim = w.shape[0], w.shape[-1]
    flat = ids.reshape(-1).long().clamp(0, height - 1)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        flat = torch.where(flat == pad, torch.full_like(flat, height), flat)
    g2 = g.reshape(-1, dim).to(w.dtype)
    if height <= _MASKED_SUM_MAX_ROWS:
        rows = torch.arange(height + 1, device=w.device)[:, None] == \
            flat[None, :]
        dense = torch.where(rows[:, :, None], g2[None], 0.0).sum(1)
    else:
        # accumulate=True takes the sort-based path on CUDA (index_add_
        # adds with atomics in a run-dependent order)
        dense = torch.zeros((height + 1, dim), dtype=w.dtype,
                            device=w.device)
        dense.index_put_((flat,), g2, accumulate=True)
    return {"W@GRAD": [dense[:height]]}


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"],
             attrs={"k": 1}, grad=None)
def _top_k(ctx, ins, attrs):
    """The k largest values along the last axis, largest first, and their
    int64 indices."""
    vals, idx = torch.topk(x(ins), int(attrs["k"]), dim=-1)
    return {"Out": [vals], "Indices": [idx]}


@register_op("lookup_table", inputs=[IOSpec("W"), IOSpec("Ids", no_grad=True)],
             outputs=["Out"],
             attrs={"is_sparse": False, "is_distributed": False,
                    "padding_idx": -1, "remote_prefetch": False},
             grad_lower=_lookup_table_grad)
def _lookup_table(ctx, ins, attrs):
    w, ids = x(ins, "W"), x(ins, "Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    # out-of-range ids clamp, as the reference's gather mode="clip"
    emb = w[ids.long().clamp(0, w.shape[0] - 1)]
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        emb = torch.where((ids != pad).unsqueeze(-1), emb,
                          torch.zeros((), dtype=emb.dtype, device=emb.device))
    return out(emb)


@register_op("where", inputs=[IOSpec("Condition", no_grad=True), IOSpec("X"),
                              IOSpec("Y")],
             outputs=["Out"])
def _where(ctx, ins, attrs):
    cond = x(ins, "Condition")
    if cond.dtype != torch.bool:
        cond = cond != 0
    return out(torch.where(cond, x(ins, "X"), x(ins, "Y")))
