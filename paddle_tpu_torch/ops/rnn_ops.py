"""Recurrent ops: lstm (dynamic_lstm), lstmp, gru (dynamic_gru),
gru_unit, cudnn_lstm, warpctc — on the padded + lengths encoding
(counterpart of ``paddle_tpu/ops/rnn_ops.py``, every op type of it).

Gate layouts follow the reference kernels exactly:

* lstm_op.h + math/detail/lstm_kernel.h — 4H = [c~, i, f, o]; peepholes
  i += prev_c*checkI, f += prev_c*checkF, o += c*checkO from
  ``Bias[4H:7H]``; c = c~*i + prev_c*f; h = o * act(c).
* gru_op.h + math/detail/gru_kernel.h — 3H = [u, r, c~]; Weight [H, 3H]
  splits into W_ur [H, 2H] and W_c [H, H]; the candidate takes
  (r*prev) @ W_c; h = (1-u)*prev + u*c~ (``origin_mode``: u*prev +
  (1-u)*c~). This is not ``torch.nn.GRU``'s candidate, which applies r
  after the product, so no cuDNN RNN can compute it.
* cudnn_lstm_op.cu.cc — a whole multi-layer LSTM in one op; the flat
  weight packs per layer [W_ih (4H,in), W_hh (4H,H), b_ih (4H), b_hh
  (4H)], gate order [c~, i, f, o] (cuDNN's own order differs), run as a
  stack of loops.
* warpctc_op.h — CTC loss as a log-semiring forward DP (``NEG`` = -1e30,
  f32), differentiated by autograd.

Each op is one rule that loops over the padded time axis in Python with
plain torch ops per step, batch-major ``[B, T, ...]``. The loop runs all
``T`` steps: a step past a sequence's length keeps the carry through
``torch.where``, so the final states equal the reference's packed
results and nothing reads the lengths on the host. The generic grad
reruns the loop under autograd.
"""
from __future__ import annotations

import torch

from .common import IOSpec, register_op, x
from .sequence_ops import lengths, reverse_index, seq_mask, take_time

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda v: v}

# the CTC DP's log(0), as the reference's
NEG = -1e30


def run_steps(step, carry, xs, ln):
    """Run ``step(carry, x_t)`` over every time step of batch-major
    ``xs`` [B, T, ...]; a step at t >= len keeps the carry. Returns the
    final carry and the per-step values of ``carry[0]`` (the hidden
    state), stacked [B, T, ...]."""
    T = xs.shape[1]
    live = seq_mask(ln, T).t()[..., None]               # [T, B, 1]
    outs = []
    for t in range(T):
        new = step(carry, xs[:, t])
        carry = tuple(torch.where(live[t], n, o) for n, o in zip(new, carry))
        outs.append(carry[0])
    return carry, torch.stack(outs, dim=1)


def _valid_prefix(seq, ln, reverse):
    """Undo the input's per-sequence reversal, then zero past each
    length."""
    if reverse:
        seq = take_time(seq, reverse_index(ln, seq.shape[1]))
    return torch.where(seq_mask(ln, seq.shape[1])[..., None], seq, 0)


def _lstm_bias(bias, H, use_peepholes):
    """(gate bias [4H] or None, checkI, checkF, checkO): the peepholes
    come from ``Bias[4H:7H]`` when they are on and the bias has 7H
    entries, else they are 0."""
    b = None if bias is None else bias.reshape(-1)
    peep = use_peepholes and b is not None and b.shape[0] >= 7 * H
    gate_b = None if b is None else b[:4 * H]
    if not peep:
        return gate_b, 0.0, 0.0, 0.0
    return gate_b, b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:7 * H]


def _lstm_cell(g, c, H, peep, acts, cell_clip):
    """One LSTM cell from its gate pre-activations ``g`` [B, 4H]."""
    ckI, ckF, ckO = peep
    act_g, act_c, act_cand = acts
    cand = act_cand(g[:, :H])
    i = act_g(g[:, H:2 * H] + c * ckI)
    f = act_g(g[:, 2 * H:3 * H] + c * ckF)
    new_c = cand * i + c * f
    if cell_clip and cell_clip > 0:
        new_c = torch.clamp(new_c, -cell_clip, cell_clip)
    o = act_g(g[:, 3 * H:] + new_c * ckO)
    return o * act_c(new_c), new_c


def _acts(attrs):
    return (_ACT[attrs["gate_activation"]], _ACT[attrs["cell_activation"]],
            _ACT[attrs["candidate_activation"]])


@register_op("lstm",
             inputs=[IOSpec("Input"), IOSpec("Weight"),
                     IOSpec("Bias", optional=True),
                     IOSpec("H0", optional=True), IOSpec("C0", optional=True),
                     IOSpec("SeqLen", no_grad=True)],
             outputs=["Hidden", IOSpec("Cell", optional=True)],
             attrs={"use_peepholes": True, "is_reverse": False,
                    "gate_activation": "sigmoid",
                    "cell_activation": "tanh",
                    "candidate_activation": "tanh", "cell_clip": 0.0})
def _lstm(ctx, ins, attrs):
    """dynamic_lstm: Input [B,T,4H] is the pre-projected x@W_x, Weight
    [H,4H] recurrent. ``Cell`` is the final [B, H] state."""
    xg, w, bias = x(ins, "Input"), x(ins, "Weight"), x(ins, "Bias")
    ln = lengths(x(ins, "SeqLen"))
    B, T, H4 = xg.shape
    H = H4 // 4
    gate_b, *peep = _lstm_bias(bias, H, attrs.get("use_peepholes", False))
    acts = _acts(attrs)
    h0, c0 = x(ins, "H0"), x(ins, "C0")
    h0 = xg.new_zeros((B, H)) if h0 is None else h0
    c0 = xg.new_zeros((B, H)) if c0 is None else c0
    reverse = attrs.get("is_reverse")
    xs = take_time(xg, reverse_index(ln, T)) if reverse else xg
    clip = attrs.get("cell_clip", 0.0)

    def step(carry, xt):
        h, c = carry
        g = torch.addmm(xt, h, w)
        if gate_b is not None:
            g = g + gate_b
        return _lstm_cell(g, c, H, peep, acts, clip)

    (_, cT), hs = run_steps(step, (h0, c0), xs, ln)
    return {"Hidden": [_valid_prefix(hs, ln, reverse)], "Cell": [cT]}


@register_op("lstmp",
             inputs=[IOSpec("Input"), IOSpec("Weight"),
                     IOSpec("ProjWeight"), IOSpec("Bias", optional=True),
                     IOSpec("H0", optional=True), IOSpec("C0", optional=True),
                     IOSpec("SeqLen", no_grad=True)],
             outputs=["Projection", "Cell"],
             attrs={"use_peepholes": True, "is_reverse": False,
                    "gate_activation": "sigmoid", "cell_activation": "tanh",
                    "candidate_activation": "tanh",
                    "proj_activation": "tanh", "cell_clip": 0.0,
                    "proj_clip": 0.0})
def _lstmp(ctx, ins, attrs):
    """LSTM with recurrent projection (reference lstmp_op.h): the [B,P]
    projection r = proj_act(h @ ProjWeight) is what recurs through
    Weight [P,4H]."""
    xg, w, bias = x(ins, "Input"), x(ins, "Weight"), x(ins, "Bias")
    w_proj = x(ins, "ProjWeight")        # [H, P]
    ln = lengths(x(ins, "SeqLen"))
    B, T, H4 = xg.shape
    H = H4 // 4
    P = w_proj.shape[1]
    gate_b, *peep = _lstm_bias(bias, H, attrs.get("use_peepholes", False))
    acts = _acts(attrs)
    act_p = _ACT[attrs["proj_activation"]]
    h0, c0 = x(ins, "H0"), x(ins, "C0")  # H0: [B, P] initial projection
    r0 = xg.new_zeros((B, P)) if h0 is None else h0
    c0 = xg.new_zeros((B, H)) if c0 is None else c0
    reverse = attrs.get("is_reverse")
    xs = take_time(xg, reverse_index(ln, T)) if reverse else xg
    cell_clip = attrs.get("cell_clip", 0.0)
    proj_clip = attrs.get("proj_clip", 0.0)

    def step(carry, xt):
        r, c = carry
        g = torch.addmm(xt, r, w)
        if gate_b is not None:
            g = g + gate_b
        new_h, new_c = _lstm_cell(g, c, H, peep, acts, cell_clip)
        new_r = act_p(new_h @ w_proj)
        if proj_clip and proj_clip > 0:
            new_r = torch.clamp(new_r, -proj_clip, proj_clip)
        return new_r, new_c

    (_, cT), rs = run_steps(step, (r0, c0), xs, ln)
    return {"Projection": [_valid_prefix(rs, ln, reverse)], "Cell": [cT]}


def _gru_step(xt, h_prev, w_ur, w_c, acts, origin_mode):
    """One GRU step from the pre-projected (biased) input ``xt`` [B, 3H]:
    (u, r, candidate, new h)."""
    act_g, act_c = acts
    H = h_prev.shape[-1]
    ur = act_g(torch.addmm(xt[:, :2 * H], h_prev, w_ur))
    u, r = ur[:, :H], ur[:, H:]
    reset_h = r * h_prev
    cand = act_c(torch.addmm(xt[:, 2 * H:], reset_h, w_c))
    if origin_mode:
        h_new = u * h_prev + cand - u * cand
    else:
        h_new = h_prev - u * h_prev + u * cand
    return u, r, reset_h, cand, h_new


@register_op("gru",
             inputs=[IOSpec("Input"), IOSpec("Weight"),
                     IOSpec("Bias", optional=True),
                     IOSpec("H0", optional=True),
                     IOSpec("SeqLen", no_grad=True)],
             outputs=["Hidden"],
             attrs={"is_reverse": False, "origin_mode": False,
                    "gate_activation": "sigmoid", "activation": "tanh"})
def _gru(ctx, ins, attrs):
    """dynamic_gru: Input [B,T,3H] pre-projected, Weight [H,3H]."""
    xg, w, bias = x(ins, "Input"), x(ins, "Weight"), x(ins, "Bias")
    ln = lengths(x(ins, "SeqLen"))
    B, T, H3 = xg.shape
    H = H3 // 3
    acts = (_ACT[attrs["gate_activation"]], _ACT[attrs["activation"]])
    w_ur, w_c = w[:, :2 * H], w[:, 2 * H:]
    h0 = x(ins, "H0")
    h = xg.new_zeros((B, H)) if h0 is None else h0
    xs = xg if bias is None else xg + bias.reshape(-1)
    reverse = attrs.get("is_reverse")
    if reverse:
        xs = take_time(xs, reverse_index(ln, T))
    origin = attrs.get("origin_mode")

    def step(carry, xt):
        return (_gru_step(xt, carry[0], w_ur, w_c, acts, origin)[-1],)

    _, hs = run_steps(step, (h,), xs, ln)
    return {"Hidden": [_valid_prefix(hs, ln, reverse)]}


@register_op("gru_unit",
             inputs=[IOSpec("Input"), IOSpec("HiddenPrev"), IOSpec("Weight"),
                     IOSpec("Bias", optional=True)],
             outputs=["Gate", "ResetHiddenPrev", "Hidden"],
             attrs={"activation": "tanh", "gate_activation": "sigmoid",
                    "origin_mode": False})
def _gru_unit(ctx, ins, attrs):
    """One GRU step (reference gru_unit_op.h), the same math as gru."""
    xt, h_prev, w = x(ins, "Input"), x(ins, "HiddenPrev"), x(ins, "Weight")
    bias = x(ins, "Bias")
    H = h_prev.shape[-1]
    if bias is not None:
        xt = xt + bias.reshape(-1)[None, :]
    u, r, reset_h, cand, h_new = _gru_step(
        xt, h_prev, w[:, :2 * H], w[:, 2 * H:],
        (_ACT[attrs["gate_activation"]], _ACT[attrs["activation"]]),
        attrs.get("origin_mode"))
    return {"Gate": [torch.cat([u, r, cand], dim=1)],
            "ResetHiddenPrev": [reset_h], "Hidden": [h_new]}


@register_op("cudnn_lstm",
             inputs=[IOSpec("Input"), IOSpec("W"),
                     IOSpec("InitH", optional=True),
                     IOSpec("InitC", optional=True),
                     IOSpec("SeqLen", no_grad=True)],
             outputs=["Out", "LastH", "LastC"],
             attrs={"hidden_size": 0, "num_layers": 1,
                    "dropout_prob": 0.0, "is_test": False},
             needs_rng=True)
def _cudnn_lstm(ctx, ins, attrs):
    """Multi-layer LSTM in one op (reference cudnn_lstm_op.cu.cc). Input
    [B,T,D]; the flat W packs per layer [W_ih(4H,in), W_hh(4H,H), b_ih,
    b_hh], gate order [c~, i, f, o] as the lstm op's. Dropout between
    layers draws from the op's generator, so the generic grad's rerun
    drops the same elements."""
    xv, wflat = x(ins, "Input"), x(ins, "W").reshape(-1)
    ln = lengths(x(ins, "SeqLen"))
    B, T, D = xv.shape
    H, L = attrs["hidden_size"], attrs["num_layers"]
    init_h, init_c = x(ins, "InitH"), x(ins, "InitC")
    init_h = xv.new_zeros((L, B, H)) if init_h is None else init_h
    init_c = xv.new_zeros((L, B, H)) if init_c is None else init_c
    rate = attrs.get("dropout_prob", 0.0)
    drop = rate > 0 and not attrs.get("is_test") and L > 1
    gen = ctx.generator() if drop else None
    acts = (torch.sigmoid, torch.tanh, torch.tanh)
    offset, seq, last_h, last_c = 0, xv, [], []
    for layer in range(L):
        in_dim = D if layer == 0 else H
        w_ih = wflat[offset:offset + 4 * H * in_dim].reshape(4 * H, in_dim)
        offset += 4 * H * in_dim
        w_hh = wflat[offset:offset + 4 * H * H].reshape(4 * H, H)
        offset += 4 * H * H
        b = wflat[offset:offset + 4 * H] + wflat[offset + 4 * H:
                                                 offset + 8 * H]
        offset += 8 * H
        gates = torch.matmul(seq, w_ih.t()) + b

        def step(carry, xt, w_hh=w_hh):
            h, c = carry
            return _lstm_cell(torch.addmm(xt, h, w_hh.t()), c, H,
                              (0.0, 0.0, 0.0), acts, 0.0)

        (hT, cT), seq = run_steps(step, (init_h[layer], init_c[layer]),
                                  gates, ln)
        if drop and layer < L - 1:
            keep = 1.0 - rate
            mask = torch.rand(seq.shape, generator=gen,
                              device=seq.device) < keep
            seq = torch.where(mask, seq / keep, 0)
        last_h.append(hT)
        last_c.append(cT)
    return {"Out": [_valid_prefix(seq, ln, False)],
            "LastH": [torch.stack(last_h)], "LastC": [torch.stack(last_c)]}


@register_op("warpctc",
             inputs=[IOSpec("Logits"), IOSpec("Label", no_grad=True),
                     IOSpec("LogitsLength", no_grad=True),
                     IOSpec("LabelLength", no_grad=True)],
             outputs=["Loss"],
             attrs={"blank": 0, "norm_by_times": False})
def _warpctc(ctx, ins, attrs):
    """CTC loss (reference warpctc_op.h binding the warp-ctc library):
    the log-semiring forward DP over the blank-extended label sequence,
    in f32 with ``NEG`` for log(0). Logits [B, T, C] unnormalised; Label
    [B, L] padded (2-D, as the JAX package's); per-sample lengths. ``norm_by_times`` divides the loss
    by the logits' length."""
    logits = x(ins, "Logits")
    labels = x(ins, "Label").long()
    tlen = lengths(x(ins, "LogitsLength"))
    llen = lengths(x(ins, "LabelLength"))
    blank = attrs.get("blank", 0)
    B, T, C = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)

    # extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    ext_valid = seq_mask(2 * llen + 1, S)
    # can-skip: ext[s] != blank and ext[s] != ext[s-2]
    skip_ok = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                         (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])],
                        dim=1)
    neg = torch.full((B, 2), NEG, dtype=logp.dtype, device=dev)
    first = torch.gather(logp[:, 0, :], 1, ext[:, :2])
    alpha = torch.cat([first[:, :1], torch.where(llen[:, None] > 0,
                                                 first[:, 1:], NEG),
                       neg.new_full((B, S - 2), NEG)], dim=1)
    live = seq_mask(tlen, T).t()                                  # [T, B]
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.where(skip_ok, torch.cat([neg, alpha[:, :-2]], dim=1),
                            NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = torch.where(ext_valid,
                          merged + torch.gather(logp[:, t, :], 1, ext), NEG)
        # frames past a sample's length leave alpha unchanged
        alpha = torch.where(live[t][:, None], new, alpha)
    # loss = -log(alpha[2*llen] + alpha[2*llen - 1])
    a_last = torch.gather(alpha, 1, (2 * llen)[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (2 * llen - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(llen > 0, a_prev, NEG)
    loss = -torch.logaddexp(a_last, a_prev)
    if attrs.get("norm_by_times"):
        loss = loss / tlen.clamp(min=1).to(loss.dtype)
    return {"Loss": [loss.reshape(B, 1)]}
