"""Optimizer update ops (counterpart of
``paddle_tpu/ops/optimizer_ops.py``): all 13 update rules. Each is the
reference's ``jnp`` update written in torch, with its slots, attrs and
defaults; every rule casts ``Grad`` to the parameter's dtype first, as
``adam`` does (a no-op on the port's paths, whose gradients come back in
their parameters' dtype under AMP too).

A SelectedRows ``Grad`` (an ``is_sparse`` table's) takes the reference's
sparse branch in ``sgd``, ``momentum``, ``adam`` (``adamw`` through it)
and ``adagrad``: the touched rows are gathered, updated and written back
into a copy of the state (``core.selected_rows.set_rows``, which drops
the sentinel slots); state the dense rule decays everywhere (momentum's
velocity, non-lazy Adam's moments) still decays everywhere, so those
rules keep dense semantics without a dense gradient. No host sync."""
from __future__ import annotations

import torch

from ..core.selected_rows import gather_rows, is_selected_rows, set_rows
from .common import register_op, x


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], grad=None)
def _sgd(ctx, ins, attrs):
    p, g = x(ins, "Param"), x(ins, "Grad")
    lr = x(ins, "LearningRate").reshape(()).to(p.dtype)
    if is_selected_rows(g):
        # reference sgd_op.h sparse branch: only the touched rows move
        new = gather_rows(p, g.rows) + (-lr * g.values.to(p.dtype))
        return {"ParamOut": [set_rows(p.clone(), g.rows, new, g.height)]}
    return {"ParamOut": [p - lr * g.to(p.dtype)]}


@register_op("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"],
             attrs={"mu": 0.9, "use_nesterov": False,
                    "regularization_method": "", "regularization_coeff": 0.0},
             grad=None)
def _momentum(ctx, ins, attrs):
    """v' = mu v + g; p' = p - lr v' (Nesterov: p - lr (g + mu v')).
    ``regularization_method="l2_decay"`` folds ``coeff * p`` into g."""
    p, v = x(ins, "Param"), x(ins, "Velocity")
    lr = x(ins, "LearningRate").reshape(())
    mu = attrs["mu"]
    g = x(ins, "Grad")
    if is_selected_rows(g):
        return _sparse_momentum(p, v, lr, mu, g, attrs)
    g = g.to(p.dtype)
    if attrs.get("regularization_method") == "l2_decay":
        g = g + attrs["regularization_coeff"] * p
    v_out = mu * v + g
    if attrs.get("use_nesterov"):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


def _sparse_momentum(p, v, lr, mu, g, attrs):
    """Dense-semantics momentum over a SelectedRows grad (reference
    momentum_op.h DenseMomentumFunctor): a row the batch missed sees
    g = 0, so its velocity still decays and its parameter still moves."""
    rows, height = g.rows, g.height
    gv = g.values.to(p.dtype)
    l2 = attrs.get("regularization_method") == "l2_decay"
    coeff = attrs.get("regularization_coeff", 0.0)
    v_out = mu * v + coeff * p if l2 else mu * v
    set_rows(v_out, rows, gather_rows(v_out, rows) + gv, height)
    if attrs.get("use_nesterov"):
        p_out = (p - lr * (coeff * p + mu * v_out)) if l2 \
            else p - lr * mu * v_out
        set_rows(p_out, rows, gather_rows(p_out, rows) + (-lr * gv), height)
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("lars_momentum",
             inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"],
             attrs={"mu": 0.9, "lars_coeff": 0.001,
                    "lars_weight_decay": 0.0005, "epsilon": 0.0},
             grad=None)
def _lars_momentum(ctx, ins, attrs):
    p = x(ins, "Param")
    g = x(ins, "Grad").to(p.dtype)
    v, lr = x(ins, "Velocity"), x(ins, "LearningRate").reshape(())
    mu, lars, wd = attrs["mu"], attrs["lars_coeff"], attrs["lars_weight_decay"]
    pn = torch.sqrt(torch.sum(torch.square(p)))
    gn = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where(
        (pn > 0) & (gn > 0),
        lr * lars * pn / (gn + wd * pn + attrs.get("epsilon", 0.0)), lr)
    v_out = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register_op("adam",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"],
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                    "lazy_mode": False},
             grad=None)
def _adam(ctx, ins, attrs):
    """Bias correction uses the current pow accumulators (beta at step 1),
    which advance afterwards, as the reference's adam_op.h."""
    p, g = x(ins, "Param"), x(ins, "Grad")
    lr = x(ins, "LearningRate").reshape(())
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow").reshape(()), x(ins, "Beta2Pow").reshape(())
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    pows = {"Beta1PowOut": [(b1p * b1).reshape((1,))],
            "Beta2PowOut": [(b2p * b2).reshape((1,))]}
    if is_selected_rows(g):
        rows, height = g.rows, g.height
        gv = g.values.to(p.dtype)
        if attrs.get("lazy_mode"):
            # reference adam_op.h SparseAdamFunctor lazy_mode: the param
            # and both moments change at the grad's rows only
            m1_r = b1 * gather_rows(m1, rows) + (1 - b1) * gv
            m2_r = b2 * gather_rows(m2, rows) + (1 - b2) * gv * gv
            upd = -lr_t * m1_r / (torch.sqrt(m2_r) + eps)
            return {"ParamOut": [set_rows(p.clone(), rows,
                                          gather_rows(p, rows) + upd,
                                          height)],
                    "Moment1Out": [set_rows(m1.clone(), rows, m1_r,
                                            height)],
                    "Moment2Out": [set_rows(m2.clone(), rows, m2_r,
                                            height)],
                    **pows}
        # non-lazy: a row the batch missed sees g = 0 (its moments decay,
        # its param moves on them); the (1 - beta) terms go in at the
        # grad's rows only
        m1_out = b1 * m1
        set_rows(m1_out, rows, gather_rows(m1_out, rows) + (1 - b1) * gv,
                 height)
        m2_out = b2 * m2
        set_rows(m2_out, rows,
                 gather_rows(m2_out, rows) + (1 - b2) * gv * gv, height)
        p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
        return {"ParamOut": [p_out], "Moment1Out": [m1_out],
                "Moment2Out": [m2_out], **pows}
    g = g.to(p.dtype)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out], **pows}


@register_op("adamw",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"],
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                    "weight_decay": 0.01},
             grad=None)
def _adamw(ctx, ins, attrs):
    """Adam, then decoupled decay of the pre-step parameter:
    ``p' = adam(p) - lr * weight_decay * p``."""
    p = x(ins, "Param")
    lr = x(ins, "LearningRate").reshape(())
    res = _adam(ctx, ins, attrs)
    res["ParamOut"] = [res["ParamOut"][0] - lr * attrs["weight_decay"] * p]
    return res


@register_op("adagrad", inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], attrs={"epsilon": 1e-6},
             grad=None)
def _adagrad(ctx, ins, attrs):
    p, g = x(ins, "Param"), x(ins, "Grad")
    m, lr = x(ins, "Moment"), x(ins, "LearningRate").reshape(())
    if is_selected_rows(g):
        # adagrad with g = 0 is the identity, so the touched-rows update
        # is the dense one (reference adagrad_op.h sparse branch)
        gv = g.values.to(p.dtype)
        m_r = gather_rows(m, g.rows) + gv * gv
        upd = -lr * gv / (torch.sqrt(m_r) + attrs["epsilon"])
        return {"ParamOut": [set_rows(p.clone(), g.rows,
                                      gather_rows(p, g.rows) + upd,
                                      g.height)],
                "MomentOut": [set_rows(m.clone(), g.rows, m_r, g.height)]}
    g = g.to(p.dtype)
    m_out = m + g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + attrs["epsilon"])
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_op("decayed_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"],
             attrs={"decay": 0.95, "epsilon": 1e-6}, grad=None)
def _decayed_adagrad(ctx, ins, attrs):
    """A decayed average of grad^2 (reference decayed_adagrad_op.h), not
    adagrad's monotone sum."""
    p = x(ins, "Param")
    g = x(ins, "Grad").to(p.dtype)
    m, lr = x(ins, "Moment"), x(ins, "LearningRate").reshape(())
    decay = attrs["decay"]
    m_out = decay * m + (1 - decay) * g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + attrs["epsilon"])
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_op("average_accumulates",
             inputs=["Param", "InSum1", "InSum2", "InSum3",
                     "InNumAccumulates", "InOldNumAccumulates",
                     "InNumUpdates"],
             outputs=["OutSum1", "OutSum2", "OutSum3", "OutNumAccumulates",
                      "OutOldNumAccumulates", "OutNumUpdates"],
             attrs={"average_window": 0.15, "min_average_window": 10000,
                    "max_average_window": 10000}, grad=None)
def _average_accumulates(ctx, ins, attrs):
    """The state machine behind ModelAverage (reference
    average_accumulates_op.h): sum_1 accumulates the parameter each step,
    sum_2 takes sum_1 every kMaxNumAccumulates updates (a precision
    guard), and a full window rolls everything into sum_3 and restarts
    the count. The branches are ``torch.where``, as the reference's are
    ``jnp.where``: no host sync."""
    kMaxNumAccumulates = 16384
    p = x(ins, "Param")
    s1, s2, s3 = x(ins, "InSum1"), x(ins, "InSum2"), x(ins, "InSum3")
    num_acc = x(ins, "InNumAccumulates").reshape(())
    old_num = x(ins, "InOldNumAccumulates").reshape(())
    num_upd = x(ins, "InNumUpdates").reshape(())

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p

    archive = (num_upd % kMaxNumAccumulates) == 0
    s2 = torch.where(archive, s2 + s1, s2)
    s1 = torch.where(archive, torch.zeros_like(s1), s1)

    window = torch.minimum(
        torch.tensor(attrs["max_average_window"], dtype=num_acc.dtype,
                     device=num_acc.device),
        (num_upd.to(torch.float32)
         * attrs["average_window"]).to(num_acc.dtype))
    full = (num_acc >= attrs["min_average_window"]) & (num_acc >= window)
    s3 = torch.where(full, s1 + s2, s3)
    s1 = torch.where(full, torch.zeros_like(s1), s1)
    s2 = torch.where(full, torch.zeros_like(s2), s2)
    old_num = torch.where(full, num_acc, old_num)
    num_acc = torch.where(full, torch.zeros_like(num_acc), num_acc)

    return {"OutSum1": [s1], "OutSum2": [s2], "OutSum3": [s3],
            "OutNumAccumulates": [num_acc.reshape((1,))],
            "OutOldNumAccumulates": [old_num.reshape((1,))],
            "OutNumUpdates": [num_upd.reshape((1,))]}


@register_op("adadelta", inputs=["Param", "Grad", "AvgSquaredGrad",
                                 "AvgSquaredUpdate"],
             outputs=["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
             attrs={"rho": 0.95, "epsilon": 1e-6}, grad=None)
def _adadelta(ctx, ins, attrs):
    p = x(ins, "Param")
    g = x(ins, "Grad").to(p.dtype)
    asg, asu = x(ins, "AvgSquaredGrad"), x(ins, "AvgSquaredUpdate")
    rho, eps = attrs["rho"], attrs["epsilon"]
    asg_out = rho * asg + (1 - rho) * g * g
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    asu_out = rho * asu + (1 - rho) * update * update
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register_op("adamax", inputs=["Param", "Grad", "LearningRate", "Moment",
                               "InfNorm", "Beta1Pow"],
             outputs=["ParamOut", "MomentOut", "InfNormOut"],
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             grad=None)
def _adamax(ctx, ins, attrs):
    """``Beta1Pow`` is read, not advanced: ``Adamax._finish_update``
    scales it after every parameter's update."""
    p = x(ins, "Param")
    g = x(ins, "Grad").to(p.dtype)
    lr = x(ins, "LearningRate").reshape(())
    m, inf = x(ins, "Moment"), x(ins, "InfNorm")
    b1p = x(ins, "Beta1Pow").reshape(())
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g) + eps)
    lr_t = lr / (1 - b1p)
    return {"ParamOut": [p - lr_t * m_out / inf_out], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


@register_op("rmsprop", inputs=["Param", "Grad", "MeanSquare", "MeanGrad",
                                "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut", "MeanSquareOut",
                      "MeanGradOut"],
             attrs={"decay": 0.9, "momentum": 0.0, "epsilon": 1e-10,
                    "centered": False},
             grad=None)
def _rmsprop(ctx, ins, attrs):
    p = x(ins, "Param")
    g = x(ins, "Grad").to(p.dtype)
    ms, mg = x(ins, "MeanSquare"), x(ins, "MeanGrad")
    mom, lr = x(ins, "Moment"), x(ins, "LearningRate").reshape(())
    rho, mu, eps = attrs["decay"], attrs["momentum"], attrs["epsilon"]
    ms_out = rho * ms + (1 - rho) * g * g
    if attrs.get("centered"):
        mg_out = rho * mg + (1 - rho) * g
        denom = ms_out - mg_out * mg_out + eps
    else:
        mg_out = mg
        denom = ms_out + eps
    mom_out = mu * mom + lr * g / torch.sqrt(denom)
    return {"ParamOut": [p - mom_out], "MomentOut": [mom_out],
            "MeanSquareOut": [ms_out], "MeanGradOut": [mg_out]}


@register_op("ftrl", inputs=["Param", "SquaredAccumulator",
                             "LinearAccumulator", "Grad", "LearningRate"],
             outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
             attrs={"l1": 0.0, "l2": 0.0, "lr_power": -0.5}, grad=None)
def _ftrl(ctx, ins, attrs):
    p = x(ins, "Param")
    g = x(ins, "Grad").to(p.dtype)
    sq, lin = x(ins, "SquaredAccumulator"), x(ins, "LinearAccumulator")
    lr = x(ins, "LearningRate").reshape(())
    l1, l2, lrp = attrs["l1"], attrs["l2"], attrs["lr_power"]
    new_sq = sq + g * g
    sigma = (torch.pow(new_sq, -lrp) - torch.pow(sq, -lrp)) / lr
    lin_out = lin + g - sigma * p
    quad = torch.pow(new_sq, -lrp) / lr + 2 * l2
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    return {"ParamOut": [pre / quad], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}


@register_op("lamb",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"],
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                    "weight_decay": 0.01},
             grad=None)
def _lamb(ctx, ins, attrs):
    """Adam's bias-corrected direction plus decoupled decay, scaled per
    parameter by the trust ratio ||p|| / ||r|| (1 where either norm is
    0), as the reference's lamb."""
    p = x(ins, "Param")
    g = x(ins, "Grad").to(p.dtype)
    lr = x(ins, "LearningRate").reshape(())
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow").reshape(()), x(ins, "Beta2Pow").reshape(())
    b1, b2, eps, wd = (attrs["beta1"], attrs["beta2"], attrs["epsilon"],
                       attrs["weight_decay"])
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    m1_hat = m1_out / (1 - b1p)
    m2_hat = m2_out / (1 - b2p)
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    w_norm = torch.sqrt(torch.sum(torch.square(p)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
    return {"ParamOut": [p - lr * ratio * r], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [(b1p * b1).reshape((1,))],
            "Beta2PowOut": [(b2p * b2).reshape((1,))]}
