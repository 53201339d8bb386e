"""The misc group of the op library (counterpart of
``paddle_tpu/ops/misc.py``, every op type of it): tensor utilities,
norms and products, the specialty losses, the CTR helpers and the
conv-ish specials.

Where the JAX package's rule has a trap, the port computes the same
result another way:

* ``unique`` — the reference builds an [n, n] equality matrix; here a
  stable sort finds each value's first occurrence, with no [n, n]
  buffer and no read back to the host (no ``torch.unique``, no
  ``nonzero``).
* ``hash`` — uint32 arithmetic, done in int64 and masked to 32 bits
  after each xor and multiply (the product stays under 2**57). The
  reference's seed of hash i, ``0x9E3779B9 + i * 0x85EBCA6B``, is
  wrapped to 32 bits here; the reference raises on it for i >= 1.
* the random ops (``random_crop``, ``sampling_id``) draw from the op's
  own ``torch.Generator``: the bits differ from ``jax.random``'s, the
  distribution is the same.
* every gather whose gradient sums into repeated positions is an
  advanced index, whose gradient (an accumulating ``index_put_``) sums in
  a fixed order on the card.

References: linspace_op, fill_op, fill_any_like_op, multiplex_op.h,
strided_slice_op, unique_op.h, size_op, is_empty_op, minus_op,
random_crop_op.h, norm_op.h, squared_l2_distance_op,
bilinear_tensor_product_op.h, fsp_op.h, add_position_encoding_op.h,
modified_huber_loss_op.h, teacher_student_sigmoid_loss_op.h,
center_loss_op.h, cvm_op.h, data_norm_op.cc, sampling_id_op.h,
similarity_focus_op.h, hash_op.h, row_conv_op.cc, conv_shift_op.cc,
label_smooth_op, one_hot_v2_op, cross_entropy2_op, spectral_norm_op.h,
tree_conv_op.cc.
"""
from __future__ import annotations

import math

import torch

from ..core.types import torch_dtype
from .common import IOSpec, out, register_op, true_div, x

_U32 = 0xFFFFFFFF


def _host_ints(t):
    """The values of a small integer tensor, read on the host."""
    return [int(v) for v in t.reshape(-1).tolist()]


def _host_scalar(t):
    return t.reshape(-1)[0].item()


def linspace_f32(start, stop, num, device, dtype=torch.float32):
    """``jnp.linspace``'s values: start * (1 - t) + stop * t with
    t = i / (num - 1) in ``dtype`` (float32 unless a wider float is
    asked), the endpoint exactly ``stop``. The division is a true one on
    the card too (``true_div``): an integer ``dtype`` floors the values,
    and ``trilinear_interp`` floors them into its taps."""
    cdt = dtype if dtype.is_floating_point else torch.float32
    st = torch.tensor(start, dtype=cdt, device=device)
    sp = torch.tensor(stop, dtype=cdt, device=device)
    if num > 1:
        div = num - 1
        step = true_div(torch.arange(div, dtype=cdt, device=device), div)
        res = torch.cat([st * (1 - step) + sp * step, sp.reshape(1)])
    elif num == 1:
        res = st.reshape(1)
    else:
        res = torch.empty((0,), dtype=cdt, device=device)
    if not dtype.is_floating_point:
        res = torch.floor(res)
    return res.to(dtype)


def take(v, idx, axis):
    """``v`` indexed by the integer tensor ``idx`` along ``axis`` (an
    advanced index: its gradient sums repeated positions in a fixed
    order on the card, where ``index_select``'s adds with atomics)."""
    return v[(slice(None),) * (axis % v.dim()) + (idx,)]


# ---------------------------------------------------------------------------
# tensor utilities
# ---------------------------------------------------------------------------

@register_op("linspace", inputs=[IOSpec("Start", no_grad=True),
                                 IOSpec("Stop", no_grad=True),
                                 IOSpec("Num", no_grad=True)],
             outputs=["Out"], attrs={"dtype": "float32"}, grad=None)
def _linspace(ctx, ins, attrs):
    """The bounds and the count are read on the host (the count is the
    output's shape)."""
    start = float(_host_scalar(x(ins, "Start")))
    stop = float(_host_scalar(x(ins, "Stop")))
    num = int(_host_scalar(x(ins, "Num")))
    return out(linspace_f32(start, stop, num, ctx.device,
                            torch_dtype(attrs["dtype"])))


@register_op("fill", outputs=["Out"],
             attrs={"value": [], "shape": [], "dtype": "float32",
                    "force_cpu": False}, grad=None)
def _fill(ctx, ins, attrs):
    """Out filled with an explicit value list."""
    vals = torch.tensor(list(attrs["value"]), dtype=torch_dtype(
        attrs["dtype"]), device=ctx.device)
    return out(vals.reshape([int(s) for s in attrs["shape"]]))


@register_op("fill_any_like", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out"], attrs={"value": 0.0, "dtype": -1}, grad=None)
def _fill_any_like(ctx, ins, attrs):
    xv = x(ins)
    dt = xv.dtype if attrs.get("dtype", -1) in (-1, None) \
        else torch_dtype(attrs["dtype"])
    return out(torch.full(tuple(xv.shape), attrs["value"], dtype=dt,
                          device=xv.device))


@register_op("fill_zeros_like2", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out"], attrs={"dtype": -1}, grad=None)
def _fill_zeros_like2(ctx, ins, attrs):
    return out(torch.zeros_like(x(ins)))


@register_op("multiplex", inputs=[IOSpec("Ids", no_grad=True),
                                  IOSpec("X", duplicable=True)],
             outputs=["Out"])
def _multiplex(ctx, ins, attrs):
    """Row r of Out is row r of X[Ids[r]]."""
    ids = x(ins, "Ids").reshape(-1).long()
    stack = torch.stack(ins["X"])                  # [K, N, ...]
    rows = torch.arange(stack.shape[1], device=stack.device)
    return out(stack[ids, rows])


def _strided(v, axis, start, end, step):
    """Python's ``v[start:end:step]`` along ``axis``, negative steps
    included."""
    if step > 0:
        idx = [slice(None)] * v.dim()
        idx[axis] = slice(start, end, step)
        return v[tuple(idx)]
    rows = list(range(*slice(start, end, step).indices(v.shape[axis])))
    return take(v, torch.tensor(rows, dtype=torch.long, device=v.device),
                axis)


@register_op("strided_slice",
             inputs=[IOSpec("Input"),
                     IOSpec("StartsTensor", optional=True, no_grad=True),
                     IOSpec("EndsTensor", optional=True, no_grad=True),
                     IOSpec("StridesTensor", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"axes": [], "starts": [], "ends": [], "strides": [],
                    "infer_flags": [], "decrease_axis": []})
def _strided_slice(ctx, ins, attrs):
    """Python slicing per axis; bounds given as tensors are read on the
    host."""
    xv = x(ins, "Input")

    def grab(name, key):
        t = x(ins, name)
        return _host_ints(t) if t is not None \
            else [int(v) for v in attrs[key]]

    axes = [int(a) for a in attrs["axes"]]
    starts = grab("StartsTensor", "starts")
    ends = grab("EndsTensor", "ends")
    strides = grab("StridesTensor", "strides") or [1] * len(axes)
    res = xv
    for a, s, e, st in zip(axes, starts, ends, strides):
        res = _strided(res, a % xv.dim(), s, e, st)
    for a in sorted([int(d) for d in attrs.get("decrease_axis", [])],
                    reverse=True):
        res = res.squeeze(a)
    return out(res)


def _unique(xv, dtype):
    """(Out, Index) of the reference's ``unique``, by a stable sort: Out holds the values in order of first
    appearance, then the repeated elements in index order (the reference
    pads its static-shape Out so); Index maps each element to its value's
    rank in Out."""
    v = xv.reshape(-1)
    n = v.shape[0]
    pos = torch.arange(n, device=v.device)
    if n == 0:
        return v, pos.to(dtype)
    s = torch.sort(v, stable=True).indices
    vs = v[s]
    new_run = torch.ones(n, dtype=torch.bool, device=v.device)
    new_run[1:] = vs[1:] != vs[:-1]
    # the sorted position where each run starts; a stable sort leaves the
    # first occurrence of the run's value there
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    first = torch.empty_like(s).scatter_(0, s, s[run_start])
    is_first = first == pos
    n_first = torch.cumsum(is_first, 0)
    rank = n_first - 1
    index = rank[first]
    # firsts go to their rank, the rest after them in index order
    dest = torch.where(is_first, rank, n_first[-1] + pos - n_first)
    uniq = torch.empty_like(v).scatter_(0, dest, v)
    return uniq, index.to(dtype)


@register_op("unique", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out", "Index"], attrs={"dtype": "int32"}, grad=None)
def _unique_op(ctx, ins, attrs):
    """First-occurrence order; Out padded to len(X) with the repeated
    elements in index order, as the reference's static shape is."""
    uniq, index = _unique(x(ins), torch_dtype(attrs.get("dtype", "int32")))
    return {"Out": [uniq], "Index": [index]}


@register_op("unique_with_counts", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out", "Index", "Count"], attrs={"dtype": "int32"},
             grad=None)
def _unique_with_counts(ctx, ins, attrs):
    """``unique`` and, at each rank, the number of elements of that value
    (Count has len(X) entries, zero past the uniques)."""
    uniq, index = _unique(x(ins), torch_dtype(attrs.get("dtype", "int32")))
    count = torch.zeros_like(index).scatter_add_(
        0, index.long(), torch.ones_like(index))
    return {"Out": [uniq], "Index": [index], "Count": [count]}


@register_op("size", inputs=[IOSpec("Input", no_grad=True)],
             outputs=["Out"], grad=None)
def _size(ctx, ins, attrs):
    return out(torch.tensor(math.prod(x(ins, "Input").shape),
                            dtype=torch.int64, device=ctx.device))


@register_op("is_empty", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out"], grad=None)
def _is_empty(ctx, ins, attrs):
    return out(torch.tensor(math.prod(x(ins).shape) == 0,
                            device=ctx.device))


@register_op("minus", inputs=["X", "Y"], outputs=["Out"])
def _minus(ctx, ins, attrs):
    return out(x(ins, "X") - x(ins, "Y"))


@register_op("random_crop", inputs=[IOSpec("X", no_grad=True),
                                    IOSpec("Seed", optional=True,
                                           no_grad=True)],
             outputs=["Out", "SeedOut"], attrs={"shape": [], "startup_seed": 0},
             grad=None, needs_rng=True)
def _random_crop(ctx, ins, attrs):
    """Crop the trailing dims to ``shape`` at an offset uniform over
    0..(dim - size) in each, drawn on the host from the op's generator
    (reseeded from a non-zero ``startup_seed``), so the crop is a plain
    slice and nothing is read back from the card."""
    xv = x(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    k = len(shape)
    g = None if xv.is_meta else ctx.generator(device="cpu")
    if g is not None and attrs.get("startup_seed"):
        g.manual_seed(int(attrs["startup_seed"]))
    res = xv
    for i, s in enumerate(shape):
        axis = xv.dim() - k + i
        limit = max(xv.shape[axis] - s, 0)
        start = 0 if g is None else int(torch.randint(
            0, limit + 1, (), generator=g))
        res = res.narrow(axis, start, s)
    return {"Out": [res], "SeedOut": [torch.zeros(
        (1,), dtype=torch.int64, device=xv.device)]}


# ---------------------------------------------------------------------------
# norms & products
# ---------------------------------------------------------------------------

@register_op("l1_norm", inputs=["X"], outputs=["Out"])
def _l1_norm(ctx, ins, attrs):
    return out(torch.sum(torch.abs(x(ins))))


@register_op("norm", inputs=["X"], outputs=["Out", "Norm"],
             attrs={"axis": 1, "epsilon": 1e-10})
def _norm(ctx, ins, attrs):
    """l2-normalise along ``axis``; Norm holds the denominators."""
    xv = x(ins)
    nrm = torch.sqrt(torch.sum(xv * xv, dim=attrs["axis"], keepdim=True)
                     + attrs["epsilon"])
    return {"Out": [xv / nrm], "Norm": [nrm]}


@register_op("squared_l2_distance", inputs=["X", "Y"],
             outputs=["sub_result", "Out"])
def _squared_l2_distance(ctx, ins, attrs):
    xv, yv = x(ins, "X"), x(ins, "Y")
    sub = xv - yv
    dims = tuple(range(1, sub.dim()))
    sq = torch.sum(sub * sub, dim=dims, keepdim=True) if dims \
        else sub * sub
    return {"sub_result": [sub], "Out": [sq.reshape(xv.shape[0], 1)]}


@register_op("bilinear_tensor_product",
             inputs=[IOSpec("X"), IOSpec("Y"), IOSpec("Weight"),
                     IOSpec("Bias", optional=True)],
             outputs=["Out"])
def _bilinear_tensor_product(ctx, ins, attrs):
    """out_k = x W_k y^T + b_k."""
    xv, yv, w = x(ins, "X"), x(ins, "Y"), x(ins, "Weight")
    res = torch.einsum("bi,kij,bj->bk", xv, w, yv)
    b = x(ins, "Bias")
    if b is not None:
        res = res + b.reshape(1, -1)
    return out(res)


@register_op("fsp", inputs=["X", "Y"], outputs=["Out"])
def _fsp(ctx, ins, attrs):
    """The distillation flow matrix: Out[b] = X[b] (C x HW) @ Y[b]^T
    (HW x C') / (H W)."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    b, cx, h, w = xv.shape
    xm = xv.reshape(b, cx, h * w)
    ym = yv.reshape(b, yv.shape[1], h * w)
    return out(torch.einsum("bch,bdh->bcd", xm, ym) / (h * w))


@register_op("add_position_encoding", inputs=["X"], outputs=["Out"],
             attrs={"alpha": 1.0, "beta": 1.0})
def _add_position_encoding(ctx, ins, attrs):
    """alpha X + beta PE for [B, S, D]: sines of pos / 10000^(i / (D/2))
    in the first half of D, cosines in the second."""
    xv = x(ins)
    _, s, d = xv.shape
    half = d // 2
    pos = torch.arange(s, dtype=xv.dtype, device=xv.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, dtype=xv.dtype, device=xv.device),
                    torch.arange(half, dtype=xv.dtype,
                                 device=xv.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return out(attrs["alpha"] * xv + attrs["beta"] * pe[None])


# ---------------------------------------------------------------------------
# specialty losses
# ---------------------------------------------------------------------------

@register_op("modified_huber_loss", inputs=[IOSpec("X"),
                                            IOSpec("Y", no_grad=True)],
             outputs=["IntermediateVal", "Out"])
def _modified_huber_loss(ctx, ins, attrs):
    xv, yv = x(ins, "X"), x(ins, "Y")
    inter = xv * (2.0 * yv - 1.0)
    loss = torch.where(inter < -1.0, -4.0 * inter,
                       torch.where(inter < 1.0, (1.0 - inter) ** 2, 0.0))
    return {"IntermediateVal": [inter], "Out": [loss]}


@register_op("teacher_student_sigmoid_loss",
             inputs=[IOSpec("X"), IOSpec("Label", no_grad=True)],
             outputs=["Y"],
             attrs={"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0})
def _teacher_student_sigmoid_loss(ctx, ins, attrs):
    """The label encodes the click z and the teacher's score z': -2 no z'
    and no click, -1 no z' and a click, [0, 1) z' and no click, [1, 2] z'
    + 1 and a click."""
    xv = x(ins, "X").reshape(-1)
    lbl = x(ins, "Label").reshape(-1).to(xv.dtype)
    base = torch.maximum(xv, torch.zeros_like(xv)) \
        + torch.log1p(torch.exp(-torch.abs(xv)))
    ce0 = base
    ce1 = base - xv
    t0 = base - xv * lbl
    t1 = base - xv * (lbl - 1.0)
    y = torch.where(lbl < -1.0, ce0,
                    torch.where(lbl < 0.0, ce1,
                                torch.where(lbl < 1.0, ce0 + t0, ce1 + t1)))
    return {"Y": [y.reshape(-1, 1)]}


@register_op("center_loss",
             inputs=[IOSpec("X"), IOSpec("Label", no_grad=True),
                     IOSpec("Centers", no_grad=True),
                     IOSpec("CenterUpdateRate", no_grad=True)],
             outputs=["CentersOut", "SampleCenterDiff", "Loss"],
             attrs={"cluster_num": 0, "need_update": True})
def _center_loss(ctx, ins, attrs):
    """loss = |x - c_y|^2 / 2; CentersOut moves each centre by alpha times
    its class's summed difference over (1 + its count). The layer binds
    CentersOut to a temporary, as the JAX package's does, so the centres
    parameter itself never moves."""
    xv = x(ins, "X")
    lbl = x(ins, "Label").reshape(-1).long()
    centers = x(ins, "Centers")
    alpha = x(ins, "CenterUpdateRate").reshape(-1)[0]
    diff = xv - centers[lbl]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if attrs.get("need_update", True):
        acc = torch.zeros_like(centers).index_put(
            (lbl,), diff, accumulate=True)
        cnt = torch.ones(centers.shape[0], dtype=xv.dtype,
                         device=xv.device).index_put(
            (lbl,), torch.ones_like(lbl, dtype=xv.dtype), accumulate=True)
        new_centers = centers + alpha * acc / cnt[:, None]
    else:
        new_centers = centers
    return {"CentersOut": [new_centers], "SampleCenterDiff": [diff],
            "Loss": [loss]}


@register_op("cvm", inputs=[IOSpec("X"), IOSpec("CVM", no_grad=True)],
             outputs=["Y"], attrs={"use_cvm": True})
def _cvm(ctx, ins, attrs):
    """The CTR show/click head columns: log-transformed (``use_cvm``) or
    stripped."""
    xv = x(ins, "X")
    if attrs.get("use_cvm", True):
        c0 = torch.log(xv[:, 0:1] + 1.0)
        c1 = torch.log(xv[:, 1:2] + 1.0) - c0
        return {"Y": [torch.cat([c0, c1, xv[:, 2:]], dim=1)]}
    return {"Y": [xv[:, 2:]]}


@register_op("data_norm", inputs=[IOSpec("X"),
                                  IOSpec("BatchSize", no_grad=True),
                                  IOSpec("BatchSum", no_grad=True),
                                  IOSpec("BatchSquareSum", no_grad=True)],
             outputs=["Y", "Means", "Scales"],
             attrs={"epsilon": 1e-4})
def _data_norm(ctx, ins, attrs):
    """Normalise by the accumulated batch statistics (no gradient reaches
    them, and nothing here updates them)."""
    xv = x(ins, "X")
    n, s, sq = x(ins, "BatchSize"), x(ins, "BatchSum"), \
        x(ins, "BatchSquareSum")
    means = s / n
    scales = torch.sqrt(n / sq)
    return {"Y": [(xv - means) * scales], "Means": [means],
            "Scales": [scales]}


@register_op("sampling_id", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out"], attrs={"min": 0.0, "max": 1.0, "seed": 0},
             grad=None, needs_rng=True)
def _sampling_id(ctx, ins, attrs):
    """A column index per row of a probability matrix, drawn with
    probability proportional to max(p, 1e-20): the argmax of log p minus
    the log of an Exponential(1) draw per entry (the Gumbel-max trick, as
    ``jax.random.categorical`` samples)."""
    xv = x(ins)
    g = None if xv.is_meta else ctx.generator()
    if g is None:
        return out(torch.empty(xv.shape[:1], dtype=torch.int64,
                               device=xv.device))
    if attrs.get("seed"):
        g.manual_seed(int(attrs["seed"]))
    e = torch.empty_like(xv).exponential_(1.0, generator=g)
    logp = torch.log(torch.clamp(xv, min=1e-20))
    return out(torch.argmax(logp - torch.log(e), dim=1))


@register_op("similarity_focus", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out"], attrs={"axis": 1, "indexes": []}, grad=None)
def _similarity_focus(ctx, ins, attrs):
    """For each selected channel, 1 on the row and the column of its
    maximum (the first one, as ``jnp.argmax`` picks it), over every
    channel."""
    xv = x(ins)
    _, _, h, w = xv.shape
    res = torch.zeros_like(xv)
    for idx in attrs["indexes"]:
        ch = xv[:, int(idx)]
        hmax = torch.argmax(torch.amax(ch, dim=2), dim=1)
        wmax = torch.argmax(torch.amax(ch, dim=1), dim=1)
        rows = torch.arange(h, device=xv.device)[None, :] == hmax[:, None]
        cols = torch.arange(w, device=xv.device)[None, :] == wmax[:, None]
        mark = (rows[:, :, None] | cols[:, None, :]).to(xv.dtype)
        res = torch.maximum(res, mark[:, None, :, :])
    return out(res)


@register_op("hash", inputs=[IOSpec("X", no_grad=True)], outputs=["Out"],
             attrs={"num_hash": 1, "mod_by": 100000000}, grad=None)
def _hash(ctx, ins, attrs):
    """The reference's multiplicative mix of each row of int ids, per
    hash seed: h = seed; h = (h ^ x_j) * 16777619 mod 2**32 over the row;
    Out = h mod ``mod_by``. Each id is read as its low 32 bits (a
    negative one as ``astype(uint32)`` reads it). [N, num_hash, 1]
    int64."""
    xv = x(ins)
    flat = (xv.reshape(xv.shape[0], -1).to(torch.int64)) & _U32
    outs = []
    for i in range(int(attrs["num_hash"])):
        h = torch.full((flat.shape[0],), (0x9E3779B9 + i * 0x85EBCA6B) & _U32,
                       dtype=torch.int64, device=xv.device)
        for j in range(flat.shape[1]):
            h = ((h ^ flat[:, j]) * 16777619) & _U32
        outs.append(h % int(attrs["mod_by"]))
    res = torch.stack(outs, dim=1)
    return out(res.reshape(xv.shape[0], int(attrs["num_hash"]), 1))


# ---------------------------------------------------------------------------
# conv-ish specials
# ---------------------------------------------------------------------------

@register_op("row_conv", inputs=[IOSpec("X"), IOSpec("Filter")],
             outputs=["Out"])
def _row_conv(ctx, ins, attrs):
    """The lookahead convolution (DeepSpeech 2) on [B, T, D]:
    out[t] = sum over j < k of x[t + j] * w[j]."""
    xv, w = x(ins, "X"), x(ins, "Filter")
    k = w.shape[0]
    t = xv.shape[1]
    pad = torch.nn.functional.pad(xv, (0, 0, 0, k - 1))
    return out(sum(pad[:, j:j + t] * w[j][None, None, :] for j in range(k)))


@register_op("conv_shift", inputs=["X", "Y"], outputs=["Out"])
def _conv_shift(ctx, ins, attrs):
    """Circular correlation of each row of X [B, M] with the kernel row
    Y [B, N]."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    m, n = xv.shape[1], yv.shape[1]
    half = (n - 1) // 2
    idx = (torch.arange(m, device=xv.device)[:, None]
           + torch.arange(n, device=xv.device)[None, :] - half) % m
    return out(torch.einsum("bmn,bn->bm", xv[:, idx], yv))


@register_op("label_smooth", inputs=[IOSpec("X"),
                                     IOSpec("PriorDist", optional=True,
                                            no_grad=True)],
             outputs=["Out"], attrs={"epsilon": 0.0})
def _label_smooth(ctx, ins, attrs):
    xv = x(ins, "X")
    eps = attrs["epsilon"]
    prior = x(ins, "PriorDist")
    if prior is None:
        return out((1 - eps) * xv + eps / xv.shape[-1])
    return out((1 - eps) * xv + eps * prior.reshape(1, -1))


@register_op("one_hot_v2", inputs=[IOSpec("X", no_grad=True)],
             outputs=["Out"], attrs={"depth": 1, "dtype": "float32"},
             grad=None)
def _one_hot_v2(ctx, ins, attrs):
    """One-hot over a trailing axis of ``depth``; an id outside
    [0, depth) gives a zero row, as ``jax.nn.one_hot``."""
    ids = x(ins).long()
    depth = int(attrs["depth"])
    return out((ids[..., None] == torch.arange(depth, device=ids.device))
               .to(torch_dtype(attrs["dtype"])))


@register_op("cross_entropy2", inputs=[IOSpec("X"),
                                       IOSpec("Label", no_grad=True)],
             outputs=["Y", "XShape", "MatchX"], attrs={"ignore_index": -100})
def _cross_entropy2(ctx, ins, attrs):
    """Hard-label cross entropy that also returns the matched
    probabilities (MatchX); an ignored label gives 0."""
    xv = x(ins, "X")
    lbl = x(ins, "Label").long()
    ignore = attrs.get("ignore_index", -100)
    li = lbl if tuple(lbl.shape[-1:]) == (1,) \
        else lbl.reshape(tuple(lbl.shape[:-1]) + (1,))
    skip = li == ignore
    match = torch.take_along_dim(xv, torch.where(skip, 0, li), dim=-1)
    y = torch.where(skip, 0.0, -torch.log(torch.clamp(match, min=1e-20)))
    return {"Y": [y], "XShape": [torch.tensor(
        list(xv.shape), dtype=torch.int64, device=xv.device)],
        "MatchX": [match]}


@register_op("spectral_norm",
             inputs=[IOSpec("Weight"), IOSpec("U", no_grad=True),
                     IOSpec("V", no_grad=True)],
             outputs=["Out"],
             attrs={"dim": 0, "power_iters": 1, "eps": 1e-12})
def _spectral_norm(ctx, ins, attrs):
    """Weight / sigma_max, sigma estimated by ``power_iters`` power
    iterations from U and V (no gradient through the iterations). Pure,
    as the JAX package's rule: U and V are a warm start and are not
    written back (Fluid's op updates them in place, so its iterations
    accumulate across steps)."""
    w = x(ins, "Weight")
    u = x(ins, "U").reshape(-1).detach()
    v = x(ins, "V").reshape(-1).detach()
    dim = int(attrs.get("dim", 0))
    iters = int(attrs.get("power_iters", 1))
    eps = float(attrs.get("eps", 1e-12))
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    mat = w.permute(perm).reshape(w.shape[dim], -1)     # [h, rest]
    const = mat.detach()

    def norm(a):
        return a / (torch.linalg.vector_norm(a) + eps)

    for _ in range(max(iters, 0)):
        v = norm(const.T @ u)
        u = norm(const @ v)
    sigma = u @ (mat @ v)
    return out(w / sigma)


@register_op("tree_conv",
             inputs=[IOSpec("NodesVector"), IOSpec("EdgeSet", no_grad=True),
                     IOSpec("Filter")],
             outputs=["Out"], attrs={"max_depth": 2})
def _tree_conv(ctx, ins, attrs):
    """Tree-based convolution (TBCNN, Mou et al.) in the JAX package's
    formulation: the patch sum of each root is ``max_depth`` powers of
    the child-adjacency matrix. NodesVector [B, N, F] (node id v is row
    v - 1), EdgeSet [B, E, 2] (parent, child) ids, 0 padding, edge order
    the sibling order; Filter [F, 3, out, k] in (l, r, t) slots. Out
    [B, N, out, k]; a root whose patch is empty gives a zero row."""
    feats = x(ins, "NodesVector")
    edges = x(ins, "EdgeSet").long()
    filt = x(ins, "Filter")
    b, n, f = feats.shape
    e = edges.shape[1]
    m = int(attrs.get("max_depth", 2))
    out_sz, k = filt.shape[2], filt.shape[3]
    w_l = filt[:, 0].reshape(f, -1)
    w_r = filt[:, 1].reshape(f, -1)
    w_t = filt[:, 2].reshape(f, -1)
    dev, dt = feats.device, feats.dtype
    uu, vv = edges[..., 0], edges[..., 1]                  # [B, E]
    live = (uu > 0) & (vv > 0)
    # dead edges write the extra row/column n, sliced off
    rows = torch.where(live, uu - 1, n)
    cols = torch.where(live, vv - 1, n)
    batch = torch.arange(b, device=dev)[:, None].expand(b, e)
    a = torch.zeros((b, n + 1, n + 1), dtype=dt, device=dev)
    a[batch, rows, cols] = 1.0
    a = a[:, :n, :n]
    same_parent = (uu[:, None, :] == uu[:, :, None]) & live[:, None, :] \
        & live[:, :, None]
    earlier = torch.tril(torch.ones((e, e), dtype=torch.bool, device=dev),
                         diagonal=-1)                    # [i, j]: j < i
    sib_idx = torch.ones((b, n + 1), dtype=dt, device=dev)
    sib_idx[batch, cols] = (torch.sum(same_parent & earlier, dim=2)
                            + 1).to(dt)
    pclen = torch.ones((b, n + 1), dtype=dt, device=dev)
    pclen[batch, cols] = torch.sum(same_parent, dim=2).to(dt)
    sib_idx, pclen = sib_idx[:, :n], pclen[:, :n]
    tmp = torch.where(pclen == 1, 0.5,
                      (sib_idx - 1) / torch.clamp(pclen - 1, min=1))
    acc = torch.zeros((b, n, out_sz * k), dtype=dt, device=dev)
    reach = torch.eye(n, dtype=dt, device=dev).expand(b, n, n)
    for d in range(m):
        et = (m - d) / m
        xt = reach @ feats
        xl = reach @ (tmp[..., None] * feats)
        # at d = 0 (the root) eta_l and eta_r carry a factor
        # (1 - eta_t) = 0, so tmp never contributes there
        el_x = (1 - et) * xl
        er_x = (1 - et) * xt - (1 - et) ** 2 * xl
        acc = acc + et * (xt @ w_t) + el_x @ w_l + er_x @ w_r
        reach = reach @ a
    return out(acc.reshape(b, n, out_sz, k))
