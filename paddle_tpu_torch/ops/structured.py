"""Structured prediction and candidate sampling ops (counterpart of
``paddle_tpu/ops/structured.py``, every op type of it).

* linear_chain_crf / crf_decoding — operators/linear_chain_crf_op.h
  (forward recursion) and crf_decoding_op.h (Viterbi). The forward runs
  in log space (``logsumexp``; the reference's L1 normalisation exists to
  stop underflow in prob space), so ``Alpha`` is log alpha — a documented
  deviation kept from the JAX package — and the backward is the generic
  grad.
* nce — operators/nce_op.h (sampled logistic loss); the negatives come
  from the op's ``torch.Generator`` (or ``seed``), so the generic grad's
  rerun draws the same ones.
* hierarchical_sigmoid — hierarchical_sigmoid_op.h + matrix_bit_code.h
  SimpleCode.
* edit_distance — edit_distance_op.h (Levenshtein DP); the serial
  dependency inside a DP row is a cummin over (candidate[j] - j).
* ctc_align — ctc_align_op.h (merge repeats, drop blanks).
* chunk_eval — chunk_eval_op.h (IOB/IOE/IOBES/plain chunk F1).

Sequence inputs follow the padded + ``@LOD`` lengths encoding
(``layers/sequence.py``): the ops take explicit length tensors, cast
them to int64 on the device and never read them on the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import IOSpec, out, register_op, x
from .sequence_ops import lengths, seq_mask

# ---------------------------------------------------------------------------
# linear-chain CRF
# ---------------------------------------------------------------------------


def _crf_parts(transition):
    # reference layout (linear_chain_crf_op.h:187-189): row 0 start weights,
    # row 1 end weights, rows 2.. the [D, D] transition matrix
    return transition[0], transition[1], transition[2:]


def _canon_label(label):
    if label.dim() >= 3 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return label.long()


def _lengths_or_full(v, b, t, device):
    return (torch.full((b,), t, dtype=torch.long, device=device)
            if v is None else lengths(v))


@register_op("linear_chain_crf",
             inputs=[IOSpec("Emission"), IOSpec("Transition"),
                     IOSpec("Label", no_grad=True),
                     IOSpec("Length", optional=True, no_grad=True)],
             outputs=[IOSpec("Alpha", optional=True),
                      IOSpec("EmissionExps", optional=True),
                      IOSpec("TransitionExps", optional=True),
                      "LogLikelihood"])
def _linear_chain_crf(ctx, ins, attrs):
    """Per-sequence negative log-likelihood (a cost, like the reference:
    ForwardOneSequence returns ``-ll``). Alpha is in LOG space."""
    em, w = x(ins, "Emission"), x(ins, "Transition")
    label = _canon_label(x(ins, "Label"))
    b, t, d = em.shape
    length = _lengths_or_full(x(ins, "Length"), b, t, em.device)
    start, end, trans = _crf_parts(w)
    mask = seq_mask(length, t)

    # numerator: score of the gold path
    em_gold = torch.gather(em, 2, label[..., None])[..., 0]
    gold = torch.sum(em_gold * mask, 1) + start[label[:, 0]]
    if t > 1:
        tr_gold = trans[label[:, :-1], label[:, 1:]]
        gold = gold + torch.sum(tr_gold * mask[:, 1:], 1)
    last = (length - 1).clamp(0, t - 1)
    last_lbl = torch.gather(label, 1, last[:, None])[:, 0]
    gold = gold + end[last_lbl]

    # denominator: log-partition via the alpha recursion
    alpha = start[None, :] + em[:, 0]                           # [B,D]
    alphas = [alpha]
    for s in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + em[:, s]
        alpha = torch.where(mask[:, s, None], nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)
    row_max = torch.amax(em, dim=2, keepdim=True)
    return {"Alpha": [torch.stack(alphas, dim=1)],
            "EmissionExps": [torch.exp(em - row_max)],
            "TransitionExps": [torch.exp(w)],
            "LogLikelihood": [(log_z - gold).reshape(b, 1)]}


@register_op("crf_decoding",
             inputs=[IOSpec("Emission", no_grad=True),
                     IOSpec("Transition", no_grad=True),
                     IOSpec("Label", optional=True, no_grad=True),
                     IOSpec("Length", optional=True, no_grad=True)],
             outputs=["ViterbiPath"], grad=None)
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode (reference crf_decoding_op.h). ``torch.argmax``
    returns the first maximum, as ``jnp.argmax`` does, so ties break
    alike. With Label given the output is the 0/1 per-position
    correctness mask the reference emits."""
    em, w = x(ins, "Emission"), x(ins, "Transition")
    b, t, d = em.shape
    length = _lengths_or_full(x(ins, "Length"), b, t, em.device)
    start, end, trans = _crf_parts(w)
    mask = seq_mask(length, t)
    ident = torch.arange(d, device=em.device)[None, :].expand(b, d)

    delta = start[None, :] + em[:, 0]
    bps = []
    for s in range(1, t):
        scores = delta[:, :, None] + trans[None]                # [B,from,to]
        best = torch.amax(scores, dim=1) + em[:, s]
        # padded steps: identity backpointers, frozen delta
        bps.append(torch.where(mask[:, s, None],
                               torch.argmax(scores, dim=1), ident))
        delta = torch.where(mask[:, s, None], best, delta)
    tag = torch.argmax(delta + end[None, :], dim=1)
    tags = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    path = torch.where(mask, torch.stack(tags[::-1], dim=1), 0)

    label = x(ins, "Label")
    if label is not None:
        return out(torch.where(mask, (path == _canon_label(label)).long(),
                               0), "ViterbiPath")
    return out(path, "ViterbiPath")


# ---------------------------------------------------------------------------
# NCE
# ---------------------------------------------------------------------------


def _log_uniform_probs(ids, vocab):
    ids = ids.float()
    return torch.log((ids + 2.0) / (ids + 1.0)) / math.log(vocab + 1.0)


def _nce_sample(gen, sampler, shape, vocab, device):
    if sampler == 1:  # log_uniform (Zipf), reference sampler.h LogUniform
        u = torch.rand(shape, generator=gen, device=device)
        ids = torch.exp(u * math.log(vocab + 1.0)) - 1.0
        return ids.long().clamp(0, vocab - 1)
    return torch.randint(0, vocab, shape, generator=gen, device=device)


@register_op("nce",
             inputs=[IOSpec("Input"), IOSpec("Label", no_grad=True),
                     IOSpec("Weight"), IOSpec("Bias", optional=True),
                     IOSpec("SampleWeight", optional=True, no_grad=True)],
             outputs=["Cost", "SampleLogits", "SampleLabels"],
             attrs={"num_total_classes": 0, "num_neg_samples": 10,
                    "sampler": 0, "seed": 0, "is_sparse": False,
                    "remote_prefetch": False, "custom_neg_classes": []})
def _nce(ctx, ins, attrs):
    """NCE loss, the reference's math (nce_op.h:237-245): o = sigmoid(s),
    b = k * q(class); cost_true = -log(o / (o + b)), cost_neg =
    -log(b / (o + b)), in stable softplus form. SampleLogits carries
    sigmoid(s) like the reference. An explicit ``seed`` gives the same
    negatives in every run; else the op's generator (step seed, op uid),
    which the generic grad's rerun shares."""
    inp = x(ins, "Input")
    label = x(ins, "Label").long()
    if label.dim() == 1:
        label = label[:, None]
    weight, bias = x(ins, "Weight"), x(ins, "Bias")
    b = inp.shape[0]
    vocab = int(attrs["num_total_classes"])
    k = int(attrs["num_neg_samples"])
    sampler = int(attrs["sampler"])
    if sampler == 2:
        raise NotImplementedError(
            "nce custom_dist sampling: pass sampler=0 (uniform) or 1 "
            "(log_uniform); custom distributions need host-side alias "
            "tables")
    gen = ctx.generator()
    if gen is not None and attrs.get("seed"):
        gen.manual_seed(int(attrs["seed"]))
    neg = _nce_sample(gen, sampler, (b, k), vocab, inp.device)
    num_true = label.shape[1]
    all_ids = torch.cat([label, neg], dim=1)                    # [B, nt+k]
    logits = torch.einsum("bd,bsd->bs", inp, weight[all_ids])
    if bias is not None:
        logits = logits + bias[all_ids]
    if sampler == 1:
        q = _log_uniform_probs(all_ids, vocab)
    else:
        q = torch.full(all_ids.shape, 1.0 / vocab, device=inp.device)
    log_b = torch.log(k * q)
    sp_neg_s = F.softplus(-logits)                  # -log(sigmoid(s))
    cost_true = F.softplus(log_b + sp_neg_s)        # -log(o / (o + b))
    cost_neg = F.softplus(-sp_neg_s - log_b)        # -log(b / (o + b))
    cost = (torch.sum(cost_true[:, :num_true], 1)
            + torch.sum(cost_neg[:, num_true:], 1))
    sw = x(ins, "SampleWeight")
    if sw is not None:
        cost = cost * sw.reshape(-1)
    return {"Cost": [cost.reshape(b, 1)],
            "SampleLogits": [torch.sigmoid(logits)],
            "SampleLabels": [all_ids]}


# ---------------------------------------------------------------------------
# hierarchical sigmoid
# ---------------------------------------------------------------------------


@register_op("hierarchical_sigmoid",
             inputs=[IOSpec("X"), IOSpec("W"), IOSpec("Label", no_grad=True),
                     IOSpec("PathTable", optional=True, no_grad=True),
                     IOSpec("PathCode", optional=True, no_grad=True),
                     IOSpec("Bias", optional=True)],
             outputs=["Out", IOSpec("PreOut", optional=True)],
             attrs={"num_classes": 2, "is_sparse": False,
                    "remote_prefetch": False})
def _hierarchical_sigmoid(ctx, ins, attrs):
    """Complete-binary-tree hsigmoid (reference hierarchical_sigmoid_op.h +
    matrix_bit_code.h SimpleCode): heap code c = label + C, path node
    index(j) = (c >> (j+1)) - 1, target bit(j) = (c >> j) & 1, walked for
    floor(log2(c)) levels. Custom trees come in via PathTable/PathCode
    ([B, L] node ids / bits, -1 padded). Loss is the summed sigmoid
    cross-entropy along the path."""
    inp, w = x(ins, "X"), x(ins, "W")
    label = x(ins, "Label").reshape(-1).long()
    bias = x(ins, "Bias")
    path_table, path_code = x(ins, "PathTable"), x(ins, "PathCode")
    b = inp.shape[0]
    if path_table is not None:
        idx = path_table.long()                                 # [B, L]
        bits = path_code.float()
        valid = idx >= 0
        idx = idx.clamp(min=0)
    else:
        c = label + int(attrs["num_classes"])                   # heap code
        max_len = max(int(math.ceil(math.log2(int(attrs["num_classes"])))), 1)
        j = torch.arange(max_len, device=inp.device)[None, :]
        # code length = floor(log2(c)); bits walked right-to-left
        length = torch.floor(torch.log2(c.float())).long()
        valid = j < length[:, None]
        idx = torch.where(
            valid, torch.bitwise_right_shift(c[:, None], j + 1) - 1, 0)
        bits = torch.bitwise_and(torch.bitwise_right_shift(c[:, None], j),
                                 1).float()
    pre = torch.einsum("bd,bld->bl", inp, w[idx])               # [B, L]
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    # sigmoid CE with logits z vs target t: softplus(z) - z*t
    ce = F.softplus(pre) - pre * bits
    cost = torch.sum(torch.where(valid, ce, 0.0), dim=1)
    return {"Out": [cost.reshape(b, 1)],
            "PreOut": [torch.where(valid, pre, 0.0)]}


# ---------------------------------------------------------------------------
# edit distance
# ---------------------------------------------------------------------------


def _squeeze_ids(v):
    return v.squeeze(-1) if v.dim() == 3 and v.shape[-1] == 1 else v


@register_op("edit_distance",
             inputs=[IOSpec("Hyps", no_grad=True),
                     IOSpec("Refs", no_grad=True),
                     IOSpec("HypsLength", optional=True, no_grad=True),
                     IOSpec("RefsLength", optional=True, no_grad=True)],
             outputs=["Out", "SequenceNum"],
             attrs={"normalized": False}, grad=None)
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance per sequence pair (reference
    edit_distance_op.h). The DP row update's serial dependency through
    new_row[j-1] is a cummin over (candidate[j] - j), so each row is one
    vectorised step."""
    hyp, ref = _squeeze_ids(x(ins, "Hyps")), _squeeze_ids(x(ins, "Refs"))
    b, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device
    hlen = _lengths_or_full(x(ins, "HypsLength"), b, th, dev)
    rlen = _lengths_or_full(x(ins, "RefsLength"), b, tr, dev)
    ref_mask = seq_mask(rlen, tr)
    row = torch.cat([torch.zeros((b, 1), device=dev),
                     ref_mask.float().cumsum(1)], dim=1)
    j = torch.arange(tr + 1, device=dev)[None].float()
    active = seq_mask(hlen, th)
    for s in range(th):
        sub = (hyp[:, s, None] != ref).float()
        cand = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)  # [B, tr]
        m = torch.cat([row[:, :1] + 1.0, cand], dim=1) - j
        new_row = torch.cummin(m, dim=1).values + j
        row = torch.where(active[:, s, None], new_row, row)
    dist = torch.gather(row, 1, rlen[:, None])[:, 0]
    # reference: empty ref -> distance = hyp length
    dist = torch.where(rlen == 0, hlen.to(dist.dtype), dist)
    if attrs.get("normalized"):
        dist = dist / rlen.to(dist.dtype).clamp(min=1.0)
    return {"Out": [dist.reshape(b, 1).float()],
            "SequenceNum": [torch.full((1,), b, dtype=torch.long,
                                       device=dev)]}


# ---------------------------------------------------------------------------
# ctc_align
# ---------------------------------------------------------------------------


@register_op("ctc_align",
             inputs=[IOSpec("Input", no_grad=True),
                     IOSpec("InputLength", optional=True, no_grad=True)],
             outputs=["Output", "OutputLength"],
             attrs={"blank": 0, "merge_repeated": True, "padding_value": 0},
             grad=None)
def _ctc_align(ctx, ins, attrs):
    """CTC alignment (reference ctc_align_op.h): merge repeats, drop
    blanks. Output is padded + per-sequence lengths. Dropped positions
    write to one extra column that is sliced off."""
    inp = _squeeze_ids(x(ins, "Input"))
    b, t = inp.shape
    dev = inp.device
    ilen = _lengths_or_full(x(ins, "InputLength"), b, t, dev)
    blank = int(attrs["blank"])
    pad_val = int(attrs.get("padding_value", 0))
    in_range = seq_mask(ilen, t)
    keep = (inp != blank) & in_range
    if attrs.get("merge_repeated", True):
        prev = torch.cat([torch.full((b, 1), -1, dtype=inp.dtype,
                                     device=dev), inp[:, :-1]], dim=1)
        prev_in = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                         device=dev), in_range[:, :-1]],
                            dim=1)
        keep = keep & ((inp != prev) | ~prev_in)
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t)  # drop -> t
    outp = torch.full((b, t + 1), pad_val, dtype=torch.long, device=dev)
    outp = outp.scatter(1, pos, inp.long())[:, :t]
    return {"Output": [outp],
            "OutputLength": [keep.sum(dim=1).to(torch.int32)]}


# ---------------------------------------------------------------------------
# chunk_eval
# ---------------------------------------------------------------------------

_CHUNK_SCHEMES = {"plain": 0, "IOB": 2, "IOE": 2, "IOBES": 4}


def _shift_right(v, fill):
    """v[:, i-1] at i (``fill`` at 0)."""
    return torch.cat([torch.full_like(v[:, :1], fill), v[:, :-1]], dim=1)


def _shift_left(v, fill):
    """v[:, i+1] at i (``fill`` at the end)."""
    return torch.cat([v[:, 1:], torch.full_like(v[:, :1], fill)], dim=1)


def _chunk_marks(tags, scheme, num_types, valid):
    """(is_begin, is_end, type) per position for a tag sequence under the
    given scheme — vectorised restatement of reference chunk_eval_op.h
    segment extraction (GetSegments)."""
    n_tag = _CHUNK_SCHEMES[scheme]
    if scheme == "plain":
        ctype = tags
        inside = (tags >= 0) & (tags < num_types) & valid
        tag_kind = None
    else:
        ctype = torch.div(tags, n_tag, rounding_mode="floor")
        tag_kind = torch.remainder(tags, n_tag)
        inside = (ctype < num_types) & (tags >= 0) & valid
    same_prev = _shift_right(inside, False) & (_shift_right(ctype, -1)
                                               == ctype)
    same_next = _shift_left(inside, False) & (_shift_left(ctype, -1)
                                              == ctype)
    if scheme == "plain":
        begin = inside & ~same_prev
        end = inside & ~same_next
    elif scheme == "IOB":                     # B=0, I=1
        begin = inside & ((tag_kind == 0) | ~same_prev)
        end = inside & (~same_next | (_shift_left(tag_kind, 0) == 0))
    elif scheme == "IOE":                     # I=0, E=1
        begin = inside & (~same_prev | (_shift_right(tag_kind, 1) == 1))
        end = inside & ((tag_kind == 1) | ~same_next)
    else:                                     # IOBES: B=0,I=1,E=2,S=3
        begin = inside & ((tag_kind == 0) | (tag_kind == 3))
        end = inside & ((tag_kind == 2) | (tag_kind == 3))
    return begin, end, ctype


def _next_end_pos(end, t):
    """pos[i] = index of the first end >= i (t when none)."""
    idx = torch.where(end, torch.arange(t, device=end.device)[None, :], t)
    return torch.flip(torch.cummin(torch.flip(idx, [1]), dim=1).values, [1])


@register_op("chunk_eval",
             inputs=[IOSpec("Inference", no_grad=True),
                     IOSpec("Label", no_grad=True),
                     IOSpec("SeqLength", optional=True, no_grad=True)],
             outputs=["Precision", "Recall", "F1-Score", "NumInferChunks",
                      "NumLabelChunks", "NumCorrectChunks"],
             attrs={"num_chunk_types": 1, "chunk_scheme": "IOB",
                    "excluded_chunk_types": []}, grad=None)
def _chunk_eval(ctx, ins, attrs):
    inf = _squeeze_ids(x(ins, "Inference")).long()
    lab = _squeeze_ids(x(ins, "Label")).long()
    b, t = inf.shape
    dev = inf.device
    slen = _lengths_or_full(x(ins, "SeqLength"), b, t, dev)
    valid = seq_mask(slen, t)
    scheme = attrs.get("chunk_scheme", "IOB")
    num_types = int(attrs["num_chunk_types"])
    excluded = list(attrs.get("excluded_chunk_types") or [])

    ib, ie, it = _chunk_marks(inf, scheme, num_types, valid)
    lb, le, lt = _chunk_marks(lab, scheme, num_types, valid)

    def _not_excluded(ctype):
        ok = torch.ones_like(ctype, dtype=torch.bool)
        for e in excluded:
            ok = ok & (ctype != e)
        return ok

    n_inf = torch.sum(ib & _not_excluded(it))
    n_lab = torch.sum(lb & _not_excluded(lt))
    # a chunk is correct iff both sequences start a chunk at i with the
    # same type and both chunks end at the same position
    correct = (ib & lb & (it == lt) & _not_excluded(it)
               & (_next_end_pos(ie, t) == _next_end_pos(le, t)))
    n_correct = torch.sum(correct)

    prec = torch.where(n_inf > 0, n_correct / n_inf, 0.0).float()
    rec = torch.where(n_lab > 0, n_correct / n_lab, 0.0).float()
    f1 = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec),
                     0.0).float()
    return {"Precision": [prec.reshape(1)], "Recall": [rec.reshape(1)],
            "F1-Score": [f1.reshape(1)],
            "NumInferChunks": [n_inf.reshape(1)],
            "NumLabelChunks": [n_lab.reshape(1)],
            "NumCorrectChunks": [n_correct.reshape(1)]}
