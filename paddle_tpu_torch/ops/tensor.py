"""Tensor creation / manipulation ops (counterpart of
``paddle_tpu/ops/tensor.py``, every op type of it). Random ops draw from
the op's own ``torch.Generator`` (``LowerCtx.generator``).

Indexing follows the reference's XLA semantics, never a device assert:
``gather`` fills an out-of-range row with NaN (``jnp.take``'s "fill"),
``gather_nd`` clamps, ``scatter`` and ``scatter_nd_add`` drop an
out-of-range update; negative indices count from the end. The grads of
``gather``, ``gather_nd``, ``scatter``, ``scatter_nd_add`` and
``lookup_table_v2`` are rules of their own that sum in an order fixed for
the inputs (``index_put_(accumulate=True)`` sorts on CUDA, where
``index_add_`` adds with atomics), so a step repeats bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import is_floating, np_dtype, torch_dtype
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


def _random_out(ctx, attrs, shape=None):
    """An empty float32 tensor of the op's shape (``shape`` or the attr),
    and the op's generator (reseeded from a non-zero ``seed`` attr); the
    generator is None on meta tensors, where nothing is drawn."""
    shape = attrs["shape"] if shape is None else shape
    res = torch.empty(tuple(int(s) for s in shape),
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
    xv = block._var_recursive(op.input("X")[0])
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
    """The reference's custom grad. Ids are clamped as the forward gathers
    them and padding rows go to the sentinel ``height``. An ``is_sparse``
    or ``is_distributed`` table gets a SelectedRows sized by the lookups
    (``core.selected_rows.merge_rows``); a dense one a scatter-add of the
    output grad into its rows, the padding rows into a spare row that is
    dropped. Both sum in an order fixed for the inputs, so runs repeat
    bit for bit."""
    w, ids, g = x(ins, "W"), x(ins, "Ids"), x(ins, "Out@GRAD")
    height, dim = w.shape[0], w.shape[-1]
    flat = ids.reshape(-1).long().clamp(0, height - 1)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        flat = torch.where(flat == pad, torch.full_like(flat, height), flat)
    g2 = g.reshape(-1, dim).to(w.dtype)
    if attrs.get("is_sparse") or attrs.get("is_distributed"):
        from ..core.selected_rows import merge_rows

        return {"W@GRAD": [merge_rows(flat, g2, height)]}
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
    int64 indices; equal values keep their order (the lowest index
    first), as ``lax.top_k``'s (``torch.topk`` orders ties its own way)."""
    vals, idx = torch.sort(x(ins), dim=-1, descending=True, stable=True)
    k = int(attrs["k"])
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


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


# ---------------------------------------------------------------------------
# the rest of the JAX package's ops/tensor.py
# ---------------------------------------------------------------------------

def _infer_like_batch(op, block):
    """Out has the ``shape`` attr with dim ``output_dim_idx`` taken from
    Input's dim ``input_dim_idx`` (-1 aware) and the attr's dtype."""
    xv = block._var_recursive(op.input("Input")[0])
    shape = list(op.attrs["shape"])
    idx_in = op.attrs.get("input_dim_idx", 0)
    idx_out = op.attrs.get("output_dim_idx", 0)
    shape[idx_out] = xv.shape[idx_in] if xv.shape else -1
    if block.has_var(op.output("Out")[0]):
        v = block.var(op.output("Out")[0])
        v.shape = tuple(shape)
        v.dtype = op.attrs.get("dtype", "float32")


def _batch_like_shape(ins, attrs):
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        x(ins, "Input").shape[attrs.get("input_dim_idx", 0)]
    return shape


@register_op("fill_constant_batch_size_like", inputs=["Input"],
             outputs=["Out"],
             attrs={"shape": [], "value": 0.0, "dtype": "float32",
                    "input_dim_idx": 0, "output_dim_idx": 0},
             infer_shape=_infer_like_batch, grad=None)
def _fill_constant_batch_size_like(ctx, ins, attrs):
    value = attrs["value"]
    if not is_floating(attrs["dtype"]):
        value = int(value)
    return out(torch.full(tuple(_batch_like_shape(ins, attrs)), value,
                          dtype=torch_dtype(attrs["dtype"]),
                          device=ctx.device))


@register_op("fill_zeros_like", inputs=["X"], outputs=["Out"], grad=None)
def _fill_zeros_like(ctx, ins, attrs):
    return out(torch.zeros_like(x(ins)))


@register_op("assign_value", outputs=["Out"],
             attrs={"shape": [], "dtype": "float32", "values": []}, grad=None)
def _assign_value(ctx, ins, attrs):
    """A host constant: ``values`` (flat) reshaped to ``shape``, copied to
    the device without making the host wait (from pageable memory the
    copy is staged before it returns)."""
    vals = np.asarray(attrs["values"], dtype=np_dtype(attrs["dtype"]))
    return out(torch.as_tensor(vals.reshape(attrs["shape"])).to(
        ctx.device, non_blocking=True))


@register_op("shape", inputs=["Input"], outputs=["Out"], grad=None)
def _shape(ctx, ins, attrs):
    return out(torch.tensor(tuple(x(ins, "Input").shape), dtype=torch.int32,
                            device=ctx.device))


@register_op("concat", inputs=[IOSpec("X", duplicable=True)],
             outputs=["Out"], attrs={"axis": 0})
def _concat(ctx, ins, attrs):
    return out(torch.cat([v for v in ins["X"] if v is not None],
                         dim=attrs["axis"]))


@register_op("split", inputs=["X"], outputs=[IOSpec("Out", duplicable=True)],
             attrs={"num": 0, "sections": [], "axis": 0})
def _split(ctx, ins, attrs):
    xv = x(ins)
    axis = attrs["axis"]
    if attrs.get("sections"):
        sizes = list(attrs["sections"])
    else:
        if xv.shape[axis] % attrs["num"]:
            raise ValueError(f"split: dim {axis} of size {xv.shape[axis]} "
                             f"does not divide into {attrs['num']} parts")
        sizes = xv.shape[axis] // attrs["num"]
    return {"Out": list(torch.split(xv, sizes, dim=axis))}


@register_op("squeeze2", inputs=["X"], outputs=["Out", "XShape"],
             attrs={"axes": []})
def _squeeze2(ctx, ins, attrs):
    """A listed axis is squeezed only where its size is 1 (the
    reference's squeeze_op); no axes squeezes every size-1 dim."""
    xv = x(ins)
    if attrs["axes"]:
        axes = tuple(a % xv.dim() for a in attrs["axes"]
                     if xv.shape[a] == 1)
    else:
        axes = tuple(i for i, d in enumerate(xv.shape) if d == 1)
    return {"Out": [xv.squeeze(axes) if axes else xv],
            "XShape": [_xshape(xv)]}


@register_op("stack", inputs=[IOSpec("X", duplicable=True)], outputs=["Y"],
             attrs={"axis": 0})
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs["axis"])]}


@register_op("unstack", inputs=["X"], outputs=[IOSpec("Y", duplicable=True)],
             attrs={"axis": 0, "num": 0})
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(x(ins), dim=attrs["axis"]))}


@register_op("expand", inputs=["X"], outputs=["Out"],
             attrs={"expand_times": []})
def _expand(ctx, ins, attrs):
    """Tile X ``expand_times`` times along each dim (numpy ``tile``)."""
    return out(torch.tile(x(ins), tuple(attrs["expand_times"])))


def _wrap(idx, n):
    """int64 indices with negative ones counted from the end, and the
    mask of those inside [0, n)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def _fill_value(dtype):
    """``jnp.take``'s fill for an out-of-range index: NaN for a float,
    the most negative value for an integer, False for a bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _gather_grad(ctx, ins, attrs):
    """X@GRAD: the output grad's rows summed into the rows they were
    gathered from, in a fixed order; an out-of-range index (filled in
    the forward) contributes nothing."""
    xv, idx, g = x(ins, "X"), x(ins, "Index"), x(ins, "Out@GRAD")
    n = xv.shape[0]
    idx, ok = _wrap(idx, n)
    rows = torch.where(ok, idx, n).reshape(-1)
    dense = torch.zeros((n + 1,) + tuple(xv.shape[1:]), dtype=xv.dtype,
                        device=xv.device)
    dense.index_put_((rows,), g.to(xv.dtype).reshape(
        (-1,) + tuple(xv.shape[1:])), accumulate=True)
    return {"X@GRAD": [dense[:n]]}


@register_op("gather", inputs=[IOSpec("X"), IOSpec("Index", no_grad=True)],
             outputs=["Out"], grad_lower=_gather_grad)
def _gather(ctx, ins, attrs):
    """Rows of X at Index (any shape): ``jnp.take(X, Index, axis=0)``."""
    xv, idx = x(ins, "X"), x(ins, "Index")
    n = xv.shape[0]
    idx, ok = _wrap(idx, n)
    res = xv[idx.clamp(0, max(n - 1, 0))]
    ok = ok.reshape(tuple(ok.shape) + (1,) * (xv.dim() - 1))
    return out(torch.where(ok, res, torch.full((), _fill_value(xv.dtype),
                                               dtype=xv.dtype,
                                               device=xv.device)))


def _scatter_rows(xv, ids):
    """Row index of each update: a spare row n for an out-of-range one
    (dropped)."""
    n = xv.shape[0]
    ids, ok = _wrap(ids.reshape(-1), n)
    return torch.where(ok, ids, n), n


def _with_spare_row(xv):
    return torch.cat([xv, torch.zeros((1,) + tuple(xv.shape[1:]),
                                      dtype=xv.dtype, device=xv.device)])


def _scatter_grad(ctx, ins, attrs):
    """X@GRAD: the output grad, zero at the overwritten rows (overwrite)
    or whole (add); Updates@GRAD: the output grad's rows at Ids (zero
    for a dropped update). Gathers only: no sum whose order could vary."""
    xv, ids, g = x(ins, "X"), x(ins, "Ids"), x(ins, "Out@GRAD")
    rows, n = _scatter_rows(xv, ids)
    g = g.to(xv.dtype)
    res = {"Updates@GRAD": [_with_spare_row(g)[rows]]}
    if attrs.get("overwrite", True):
        gx = _with_spare_row(g).index_put((rows,), torch.zeros(
            (), dtype=g.dtype, device=g.device))[:n]
    else:
        gx = g
    res["X@GRAD"] = [gx]
    return res


@register_op("scatter", inputs=[IOSpec("X"), IOSpec("Ids", no_grad=True),
                                IOSpec("Updates")],
             outputs=["Out"], attrs={"overwrite": True},
             grad_lower=_scatter_grad)
def _scatter(ctx, ins, attrs):
    """X with the rows at Ids set to (overwrite) or increased by Updates;
    an out-of-range id's update is dropped."""
    xv, ids, upd = x(ins, "X"), x(ins, "Ids"), x(ins, "Updates")
    rows, n = _scatter_rows(xv, ids)
    return out(_with_spare_row(xv).index_put(
        (rows,), upd.to(xv.dtype),
        accumulate=not attrs.get("overwrite", True))[:n])


@register_op("one_hot", inputs=[IOSpec("X", no_grad=True)], outputs=["Out"],
             attrs={"depth": 1, "dtype": "float32"}, grad=None)
def _one_hot(ctx, ins, attrs):
    """An id outside [0, depth) gives a zero row (``jax.nn.one_hot``)."""
    ids = x(ins)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    depth = int(attrs["depth"])
    hot = ids.long().unsqueeze(-1) == torch.arange(depth, device=ids.device)
    return out(hot.to(torch_dtype(attrs["dtype"])))


@register_op("lookup_table_v2",
             inputs=[IOSpec("W"), IOSpec("Ids", no_grad=True)],
             outputs=["Out"], attrs={"is_sparse": False, "padding_idx": -1},
             grad_lower=_lookup_table_grad)
def _lookup_table_v2(ctx, ins, attrs):
    return _lookup_table(ctx, ins, attrs)


@register_op("arg_max", inputs=["X"], outputs=["Out"], attrs={"axis": -1},
             grad=None)
def _arg_max(ctx, ins, attrs):
    """The first maximal index along ``axis``, int64."""
    return out(torch.argmax(x(ins), dim=attrs["axis"]))


@register_op("arg_min", inputs=["X"], outputs=["Out"], attrs={"axis": -1},
             grad=None)
def _arg_min(ctx, ins, attrs):
    return out(torch.argmin(x(ins), dim=attrs["axis"]))


@register_op("argsort", inputs=["X"], outputs=["Out", "Indices"],
             attrs={"axis": -1, "descending": False}, grad=None)
def _argsort(ctx, ins, attrs):
    """A stable sort: equal values keep their order, in either
    direction (``jnp.argsort``)."""
    vals, idx = torch.sort(x(ins), dim=attrs["axis"],
                           descending=bool(attrs.get("descending")),
                           stable=True)
    return {"Out": [vals], "Indices": [idx]}


@register_op("cumsum", inputs=["X"], outputs=["Out"],
             attrs={"axis": -1, "exclusive": False, "reverse": False})
def _cumsum(ctx, ins, attrs):
    xv = x(ins)
    axis = attrs["axis"]
    if attrs.get("reverse"):
        xv = torch.flip(xv, (axis,))
    # an int32 sum stays int32, as jnp.cumsum's (torch widens it)
    res = torch.cumsum(xv, dim=axis,
                       dtype=torch.int32 if xv.dtype == torch.int32 else None)
    if attrs.get("exclusive"):
        res = res - xv
    if attrs.get("reverse"):
        res = torch.flip(res, (axis,))
    return out(res)


@register_op("range",
             inputs=[IOSpec("Start", optional=True, no_grad=True),
                     IOSpec("End", optional=True, no_grad=True),
                     IOSpec("Step", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"start": 0.0, "end": 0.0, "step": 1.0,
                    "dtype": "float32", "use_attrs": True},
             grad=None)
def _range(ctx, ins, attrs):
    """[start, end) by step; tensor bounds are read on the host."""
    if attrs.get("use_attrs", True):
        st, en, sp = attrs["start"], attrs["end"], attrs["step"]
    else:
        st, en, sp = (float(x(ins, s).reshape(-1)[0])
                      for s in ("Start", "End", "Step"))
    dt = torch_dtype(attrs.get("dtype", "float32"))
    if not dt.is_floating_point:
        st, en, sp = int(st), int(en), int(sp)
    return out(torch.arange(st, en, sp, dtype=dt, device=ctx.device))


@register_op("flatten2", inputs=["X"], outputs=["Out", "XShape"],
             attrs={"axis": 1})
def _flatten2(ctx, ins, attrs):
    xv = x(ins)
    ax = attrs["axis"]
    lead = math.prod(xv.shape[:ax]) if ax > 0 else 1
    return {"Out": [xv.reshape(lead, -1)], "XShape": [_xshape(xv)]}


@register_op("pad", inputs=["X"], outputs=["Out"],
             attrs={"paddings": [], "pad_value": 0.0})
def _pad(ctx, ins, attrs):
    """``paddings`` is (before, after) per dim, first dim first."""
    xv = x(ins)
    p = attrs["paddings"]
    widths = []
    for i in reversed(range(xv.dim())):
        widths += [int(p[2 * i]), int(p[2 * i + 1])]
    return out(F.pad(xv, widths, value=attrs["pad_value"]))


def _nd_rows(xv, idx):
    """Linear row of each index tuple (Index's last dim addresses X's
    leading dims), negative entries counted from the end, each clamped
    into range; and whether the tuple was in range."""
    k = idx.shape[-1]
    lead = xv.shape[:k]
    idx = idx.long()
    lin = torch.zeros(idx.shape[:-1], dtype=torch.long, device=idx.device)
    ok = torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    for d in range(k):
        i, okd = _wrap(idx[..., d], lead[d])
        ok = ok & okd
        lin = lin * lead[d] + i.clamp(0, lead[d] - 1)
    return lin, ok, math.prod(lead)


def _gather_nd_grad(ctx, ins, attrs):
    xv, idx, g = x(ins, "X"), x(ins, "Index"), x(ins, "Out@GRAD")
    lin, _, rows = _nd_rows(xv, idx)
    rest = tuple(xv.shape[idx.shape[-1]:])
    dense = torch.zeros((rows,) + rest, dtype=xv.dtype, device=xv.device)
    dense.index_put_((lin.reshape(-1),), g.to(xv.dtype).reshape(
        (-1,) + rest), accumulate=True)
    return {"X@GRAD": [dense.reshape(xv.shape)]}


@register_op("gather_nd", inputs=[IOSpec("X"), IOSpec("Index", no_grad=True)],
             outputs=["Out"], grad_lower=_gather_nd_grad)
def _gather_nd(ctx, ins, attrs):
    """X[Index[..., 0], Index[..., 1], ...] (reference gather_nd_op.h);
    an out-of-range entry clamps, as XLA's gather does."""
    xv, idx = x(ins, "X"), x(ins, "Index")
    lin, _, rows = _nd_rows(xv, idx)
    rest = tuple(xv.shape[idx.shape[-1]:])
    return out(xv.reshape((rows,) + rest)[lin])


def _scatter_nd_rows(xv, idx):
    lin, ok, rows = _nd_rows(xv, idx)
    return torch.where(ok, lin, rows).reshape(-1), rows, \
        tuple(xv.shape[idx.shape[-1]:])


def _scatter_nd_add_grad(ctx, ins, attrs):
    """X@GRAD: the output grad; Updates@GRAD: its rows at Index (zero
    for a dropped update)."""
    xv, idx, upd = x(ins, "X"), x(ins, "Index"), x(ins, "Updates")
    g = x(ins, "Out@GRAD").to(xv.dtype)
    lin, rows, rest = _scatter_nd_rows(xv, idx)
    gu = _with_spare_row(g.reshape((rows,) + rest))[lin]
    return {"X@GRAD": [g], "Updates@GRAD": [gu.reshape(upd.shape)]}


@register_op("scatter_nd_add",
             inputs=[IOSpec("X"), IOSpec("Index", no_grad=True),
                     IOSpec("Updates")],
             outputs=["Out"], grad_lower=_scatter_nd_add_grad)
def _scatter_nd_add(ctx, ins, attrs):
    """X plus Updates summed at Index (an out-of-range entry's update is
    dropped), in an order fixed for the inputs."""
    xv, idx, upd = x(ins, "X"), x(ins, "Index"), x(ins, "Updates")
    lin, rows, rest = _scatter_nd_rows(xv, idx)
    res = _with_spare_row(xv.reshape((rows,) + rest)).index_put(
        (lin,), upd.to(xv.dtype).reshape((-1,) + rest), accumulate=True)
    return out(res[:rows].reshape(xv.shape))


@register_op("reverse", inputs=[IOSpec("X")], outputs=["Out"],
             attrs={"axis": [0]})
def _reverse(ctx, ins, attrs):
    ax = attrs["axis"]
    ax = [ax] if isinstance(ax, int) else list(ax)
    return out(torch.flip(x(ins), tuple(ax)))


@register_op("expand_as", inputs=[IOSpec("X"),
                                  IOSpec("target_tensor", no_grad=True)],
             outputs=["Out"])
def _expand_as(ctx, ins, attrs):
    xv, ref = x(ins, "X"), x(ins, "target_tensor")
    return out(torch.tile(xv, tuple(int(t // s) for s, t in
                                    zip(xv.shape, ref.shape))))


@register_op("diag", inputs=[IOSpec("Diagonal", no_grad=True)],
             outputs=["Out"], grad=None)
def _diag(ctx, ins, attrs):
    return out(torch.diag(x(ins, "Diagonal")))


@register_op("eye", outputs=["Out"],
             attrs={"num_rows": 0, "num_columns": -1, "dtype": "float32"},
             grad=None)
def _eye(ctx, ins, attrs):
    n = attrs["num_rows"]
    m = attrs["num_columns"]
    m = n if m is None or m < 0 else m
    return out(torch.eye(n, m, dtype=torch_dtype(attrs["dtype"]),
                         device=ctx.device))


@register_op("pad2d", inputs=[IOSpec("X")], outputs=["Out"],
             attrs={"paddings": [0, 0, 0, 0], "mode": "constant",
                    "pad_value": 0.0, "data_format": "NCHW"})
def _pad2d(ctx, ins, attrs):
    """Spatial padding [top, bottom, left, right] of NCHW (or NHWC) X,
    constant, reflect or edge (reference pad2d_op.cc)."""
    xv = x(ins)
    t, b, l, r = (int(v) for v in attrs["paddings"])
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        xv = xv.permute(0, 3, 1, 2)
    mode = attrs["mode"]
    if mode == "constant":
        res = F.pad(xv, (l, r, t, b), value=attrs["pad_value"])
    else:
        res = F.pad(xv, (l, r, t, b),
                    mode={"reflect": "reflect", "edge": "replicate"}[mode])
    return out(res.permute(0, 2, 3, 1) if nhwc else res)


@register_op("roll", inputs=[IOSpec("X")], outputs=["Out"],
             attrs={"shifts": [0], "axis": []})
def _roll(ctx, ins, attrs):
    """No ``axis``: roll the flattened X."""
    ax = attrs.get("axis") or None
    shifts = tuple(attrs["shifts"])
    if ax is None:
        xv = x(ins)
        return out(torch.roll(xv.reshape(-1), shifts[0]).reshape(xv.shape))
    return out(torch.roll(x(ins), shifts, dims=tuple(ax)))


@register_op("shard_index", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out"],
             attrs={"index_num": 0, "nshards": 1, "shard_id": 0,
                    "ignore_value": -1}, grad=None)
def _shard_index(ctx, ins, attrs):
    """Global ids to shard-local ids (reference shard_index_op.h)."""
    v = x(ins)
    per = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    sid = attrs["shard_id"]
    ok = torch.div(v, per, rounding_mode="floor") == sid
    return out(torch.where(ok, v - sid * per, torch.full_like(
        v, attrs["ignore_value"])))


@register_op("uniform_random_batch_size_like",
             inputs=[IOSpec("Input", no_grad=True)], outputs=["Out"],
             attrs={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
                    "dtype": "float32", "input_dim_idx": 0,
                    "output_dim_idx": 0},
             needs_rng=True, grad=None)
def _uniform_random_batch_size_like(ctx, ins, attrs):
    """U[min, max) of the ``shape`` attr with one dim taken from Input's
    (reference uniform_random_batch_size_like_op.cc); the bits differ
    from jax.random's, the distribution is the same."""
    res, g = _random_out(ctx, attrs, _batch_like_shape(ins, attrs))
    if g is not None:
        res.uniform_(attrs["min"], attrs["max"], generator=g)
    return out(res.to(torch_dtype(attrs["dtype"])))


@register_op("gaussian_random_batch_size_like",
             inputs=[IOSpec("Input", no_grad=True)], outputs=["Out"],
             attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                    "dtype": "float32", "input_dim_idx": 0,
                    "output_dim_idx": 0},
             needs_rng=True, grad=None)
def _gaussian_random_batch_size_like(ctx, ins, attrs):
    res, g = _random_out(ctx, attrs, _batch_like_shape(ins, attrs))
    if g is not None:
        res.normal_(attrs["mean"], attrs["std"], generator=g)
    return out(res.to(torch_dtype(attrs["dtype"])))
