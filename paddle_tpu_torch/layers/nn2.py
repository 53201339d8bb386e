"""Layers of paddle_tpu's layers/nn2.py: the generative-inference ones
(the KV-cache, gather, sampling and speculative-accept ops of
``ops/generation.py``), the one-op wrappers over ``ops/math.py``
(``maxout``, ``selu``, ``stanh``, ``brelu``, ``sign``,
``elementwise_mod``, ``elementwise_floordiv``) and over the rest of
``ops/tensor.py`` and ``ops/loss.py``, the SelectedRows utilities, the
beam-search wrappers and the composites (``dice_loss``, ``mse_loss``,
``npair_loss``, ``rank``, ``sum``, ``scatter_nd``, ``lstm_unit``,
``adaptive_pool2d``, ``autoincreased_step_counter``)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn as _nn

__all__ = ["fused_decode_attention", "kv_cache_append", "sequence_gather",
           "spec_accept", "sample_token", "maxout", "selu", "stanh", "brelu",
           "sign", "elementwise_mod", "elementwise_floordiv", "gather_nd",
           "scatter_nd_add", "pad2d", "shard_index", "rank_loss",
           "margin_rank_loss", "kldiv_loss", "bpr_loss", "mean_iou",
           "uniform_random_batch_size_like",
           "gaussian_random_batch_size_like", "merge_selected_rows",
           "get_tensor_from_selected_rows", "beam_search",
           "beam_search_decode", "dice_loss", "mse_loss", "npair_loss",
           "rank", "size", "sum", "scatter_nd", "lstm_unit", "adaptive_pool2d",
           "autoincreased_step_counter"]


def _outs(op_type, inputs, outs, attrs=None, name=None):
    """One op; ``outs`` maps each output slot to its dtype (None: the
    first input's), the first slot the main output, the rest stop the
    gradient. Returns the output vars in order."""
    helper = LayerHelper(op_type, name=name)
    first = next(iter(inputs.values())).dtype
    made = {}
    for k, (slot, dt) in enumerate(outs.items()):
        made[slot] = helper.create_variable_for_type_inference(
            dt or first, stop_gradient=k > 0)
    helper.append_op(op_type, inputs=inputs, outputs=made,
                     attrs=attrs or {})
    return list(made.values())


def _one(op_type, inputs, attrs=None, name=None):
    """One op, one output ``Out`` of the first input's dtype."""
    return _outs(op_type, inputs, {"Out": None}, attrs, name)[0]


def maxout(x, groups, axis=1, name=None):
    return _one("maxout", {"X": x}, {"groups": groups, "axis": axis},
                name=name)


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _one("selu", {"X": x}, attrs, name=name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _one("stanh", {"X": x}, {"scale_a": scale_a, "scale_b": scale_b},
                name=name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _one("brelu", {"X": x}, {"t_min": t_min, "t_max": t_max},
                name=name)


def sign(x, name=None):
    return _one("sign", {"X": x}, name=name)


def elementwise_mod(x, y, axis=-1, name=None):
    return _one("elementwise_mod", {"X": x, "Y": y}, {"axis": axis},
                name=name)


def elementwise_floordiv(x, y, axis=-1, name=None):
    return _one("elementwise_floordiv", {"X": x, "Y": y}, {"axis": axis},
                name=name)


def fused_decode_attention(q, k_new, v_new, cache_k, cache_v, positions,
                           scale=0.0, page_size=128, slot_mask=None,
                           name=None):
    """One decode/verify chunk with the KV append fused in. q/k_new/v_new
    [B, H, C, D]; cache_k/cache_v persistable paged caches
    [B, H, S_max, D]; positions [B, 1] int, each sequence's length before
    this chunk. The updated caches are written back into the cache vars;
    the attended context [B, H, C, D] is returned."""
    helper = LayerHelper("fused_decode_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": q, "KNew": k_new, "VNew": v_new,
              "CacheK": cache_k, "CacheV": cache_v, "Positions": positions}
    if slot_mask is not None:
        inputs["SlotMask"] = slot_mask
    helper.append_op(
        "fused_decode_attention", inputs=inputs,
        outputs={"Out": out, "CacheKOut": cache_k, "CacheVOut": cache_v},
        attrs={"scale": float(scale), "page_size": int(page_size)})
    return out


def kv_cache_append(cache, new, positions, slot_mask=None, name=None):
    """Bulk KV write of ``new`` [B, H, L, D] at per-sequence ``positions``
    [B, 1]; with ``slot_mask`` [B, 1] only masked sequences' rows change.
    Writes into ``cache`` (returns the same var)."""
    helper = LayerHelper("kv_cache_append", name=name)
    inputs = {"Cache": cache, "New": new, "Positions": positions}
    if slot_mask is not None:
        inputs["SlotMask"] = slot_mask
    helper.append_op("kv_cache_append", inputs=inputs,
                     outputs={"Out": cache})
    return cache


def sequence_gather(x, index, name=None):
    """Out[b] = x[b, index[b]] along axis 1 (index [B, 1], clamped)."""
    helper = LayerHelper("sequence_gather", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_gather", inputs={"X": x, "Index": index},
                     outputs={"Out": out})
    return out


def spec_accept(sampled, drafts, start, name=None):
    """Speculative accept rule: returns (accept_len, new_tok, new_pos),
    each [B, 1] int64."""
    helper = LayerHelper("spec_accept", name=name)
    accept = helper.create_variable_for_type_inference("int64")
    new_tok = helper.create_variable_for_type_inference("int64")
    new_pos = helper.create_variable_for_type_inference("int64")
    helper.append_op("spec_accept",
                     inputs={"Sampled": sampled, "Drafts": drafts,
                             "Start": start},
                     outputs={"AcceptLen": accept, "NewTok": new_tok,
                              "NewPos": new_pos})
    return accept, new_tok, new_pos


def sample_token(logits, strategy="greedy", temperature=1.0, top_k=0,
                 name=None):
    """Next-token selection from [B, V] logits -> [B, 1] int64."""
    helper = LayerHelper("sample_token", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("sample_token", inputs={"Logits": logits},
                     outputs={"Out": out},
                     attrs={"strategy": strategy,
                            "temperature": float(temperature),
                            "top_k": int(top_k)})
    return out


def gather_nd(input, index, name=None):
    return _one("gather_nd", {"X": input, "Index": index}, name=name)


def scatter_nd_add(ref, index, updates, name=None):
    return _one("scatter_nd_add",
                {"X": ref, "Index": index, "Updates": updates}, name=name)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _one("pad2d", {"X": input},
                {"paddings": list(paddings), "mode": mode,
                 "pad_value": float(pad_value), "data_format": data_format},
                name=name)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    return _one("shard_index", {"X": input},
                {"index_num": index_num, "nshards": nshards,
                 "shard_id": shard_id, "ignore_value": ignore_value},
                name=name)


def rank_loss(label, left, right, name=None):
    return _one("rank_loss", {"Label": label, "Left": left, "Right": right},
                name=name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return _outs("margin_rank_loss",
                 {"Label": label, "X1": left, "X2": right},
                 {"Out": None, "Activated": None},
                 {"margin": float(margin)}, name=name)[0]


def kldiv_loss(x, target, reduction="mean", name=None):
    return _outs("kldiv_loss", {"X": x, "Target": target}, {"Loss": None},
                 {"reduction": reduction}, name=name)[0]


def bpr_loss(input, label, name=None):
    return _outs("bpr_loss", {"X": input, "Label": label}, {"Y": None},
                 name=name)[0]


def mean_iou(input, label, num_classes):
    return tuple(_outs("mean_iou", {"Predictions": input, "Labels": label},
                       {"OutMeanIou": "float32", "OutWrong": "int32",
                        "OutCorrect": "int32"},
                       {"num_classes": num_classes}))


def _random_batch_size_like(op_type, input, shape, dtype, attrs,
                            input_dim_idx, output_dim_idx, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    sh = list(shape)
    sh[output_dim_idx] = -1   # batch-sized at run time
    helper.append_op(op_type, inputs={"Input": input}, outputs={"Out": out},
                     attrs=dict(attrs, shape=sh, dtype=dtype,
                                input_dim_idx=input_dim_idx,
                                output_dim_idx=output_dim_idx))
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, seed=0, input_dim_idx=0,
                                   output_dim_idx=0, name=None):
    return _random_batch_size_like(
        "uniform_random_batch_size_like", input, shape, dtype,
        {"min": min, "max": max, "seed": seed}, input_dim_idx,
        output_dim_idx, name)


def gaussian_random_batch_size_like(input, shape, dtype="float32",
                                    mean=0.0, std=1.0, seed=0,
                                    input_dim_idx=0, output_dim_idx=0,
                                    name=None):
    return _random_batch_size_like(
        "gaussian_random_batch_size_like", input, shape, dtype,
        {"mean": mean, "std": std, "seed": seed}, input_dim_idx,
        output_dim_idx, name)


def merge_selected_rows(x, name=None):
    return _one("merge_selected_rows", {"X": x}, name=name)


def get_tensor_from_selected_rows(x, name=None):
    return _one("get_tensor_from_selected_rows", {"X": x}, name=name)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """The beam_search op over one decode step's accumulated scores
    (driven inside a While, as ``models.seq2seq`` drives it)."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(
        pre_scores.dtype)
    parent = helper.create_variable_for_type_inference("int64",
                                                       stop_gradient=True)
    ins = {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}
    if ids is not None:
        ins["ids"] = ids
    helper.append_op("beam_search", inputs=ins,
                     outputs={"selected_ids": sel_ids,
                              "selected_scores": sel_scores,
                              "parent_idx": parent},
                     attrs={"beam_size": beam_size, "end_id": end_id,
                            "level": level,
                            "is_accumulated": is_accumulated})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    """Backtrack the per-step beam arrays into whole sentences."""
    helper = LayerHelper("beam_search_decode", name=name)
    s_ids = helper.create_variable_for_type_inference("int64")
    s_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op("beam_search_decode",
                     inputs={"Ids": ids, "Scores": scores},
                     outputs={"SentenceIds": s_ids,
                              "SentenceScores": s_scores},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return s_ids, s_scores


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2|X*Y| / (|X| + |Y|) over one-hot labels, averaged."""
    label = _nn.one_hot(label, input.shape[-1])
    reduce_dims = list(range(1, len(input.shape)))
    inse = _nn.reduce_sum(_nn.elementwise_mul(input, label),
                          dim=reduce_dims)
    dice_denominator = _nn.elementwise_add(
        _nn.reduce_sum(input, dim=reduce_dims),
        _nn.reduce_sum(label, dim=reduce_dims))
    dice_score = _nn.scale(
        _nn.elementwise_div(
            inse, _nn.scale(dice_denominator, scale=1.0, bias=epsilon)),
        scale=-2.0, bias=1.0)
    return _nn.reduce_mean(dice_score)


def mse_loss(input, label):
    return _nn.reduce_mean(_nn.square_error_cost(input, label))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """The multi-class N-pair loss: softmax cross-entropy of the
    anchor-positive similarities against the same-label targets, plus an
    L2 term on both embeddings."""
    labels = _nn.reshape(_nn.cast(labels, "float32"), [-1, 1])
    same = _nn.cast(_nn.equal(labels, _nn.transpose(labels, [1, 0])),
                    "float32")
    targets = _nn.elementwise_div(
        same, _nn.reduce_sum(same, dim=1, keep_dim=True))
    logits = _nn.matmul(anchor, positive, transpose_y=True)
    softmax_ce = _nn.reduce_mean(_nn.reduce_sum(
        _nn.elementwise_mul(_nn.scale(targets, scale=-1.0),
                            _nn.log_softmax(logits)), dim=1))
    reg = _nn.scale(
        _nn.elementwise_add(_nn.reduce_mean(_nn.reduce_sum(
            _nn.square(anchor), dim=1)),
            _nn.reduce_mean(_nn.reduce_sum(_nn.square(positive), dim=1))),
        scale=float(l2_reg) * 0.25)
    return _nn.elementwise_add(softmax_ce, reg)


def sum(x):
    """The elementwise sum of a var or a list of vars."""
    ins = list(x) if isinstance(x, (list, tuple)) else [x]
    helper = LayerHelper("sum")
    out = helper.create_variable_for_type_inference(ins[0].dtype)
    helper.append_op("sum", inputs={"X": ins}, outputs={"Out": out})
    return out


def rank(input):
    """The static rank, as an int32 [1] constant."""
    from .tensor import fill_constant

    return fill_constant(shape=[1], dtype="int32", value=len(input.shape))


def size(input):
    """The static element count (-1 dims left out), as an int64 [1]
    constant."""
    import math

    from .tensor import fill_constant

    return fill_constant(shape=[1], dtype="int64", value=math.prod(
        d for d in input.shape if d != -1))


def scatter_nd(index, updates, shape, name=None):
    """``scatter_nd_add`` of ``updates`` onto zeros of ``shape``."""
    from .tensor import fill_constant

    zero = fill_constant(shape=list(shape), dtype=updates.dtype, value=0.0)
    return scatter_nd_add(zero, index, updates, name=name)


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM cell step: an fc over [x_t, h_prev] gives the four gates
    (i, f, c~, o); returns (h, c)."""
    concat_in = _nn.concat([x_t, hidden_t_prev], axis=1)
    hidden = hidden_t_prev.shape[-1]
    gates = _nn.fc(concat_in, 4 * hidden, param_attr=param_attr,
                   bias_attr=bias_attr)
    i, f, c_hat, o = _nn.split(gates, 4, dim=-1)
    f_act = _nn.sigmoid(_nn.scale(f, scale=1.0, bias=float(forget_bias)))
    new_cell = _nn.elementwise_add(
        _nn.elementwise_mul(f_act, cell_t_prev),
        _nn.elementwise_mul(_nn.sigmoid(i), _nn.tanh(c_hat)))
    new_hidden = _nn.elementwise_mul(_nn.sigmoid(o), _nn.tanh(new_cell))
    return new_hidden, new_cell


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """pool2d with ``adaptive``: ``pool_size`` is the output size."""
    if require_index:
        raise NotImplementedError(
            "adaptive_pool2d(require_index=True): the pooling index output "
            "is not modelled (the JAX package refuses it too)")
    ps = pool_size if isinstance(pool_size, (list, tuple)) \
        else [pool_size, pool_size]
    return _one("pool2d", {"X": input},
                {"pooling_type": pool_type, "ksize": list(ps),
                 "adaptive": True}, name=name)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter, one per name, advanced by ``step``
    at the head of every run of the main program (first value
    ``begin``)."""
    from ..framework import default_main_program, default_startup_program

    name = counter_name or "@STEP_COUNTER@"
    main = default_main_program().global_block
    startup = default_startup_program().global_block
    if not main.has_var(name):
        main.create_var(name=name, shape=(1,), dtype="int64",
                        persistable=True, stop_gradient=True)
        startup.create_var(name=name, shape=(1,), dtype="int64",
                           persistable=True)
        startup.append_op("fill_constant", outputs={"Out": name},
                          attrs={"shape": [1], "dtype": "int64",
                                 "value": float(begin) - float(step)})
        main.prepend_op("increment", inputs={"X": name},
                        outputs={"Out": name},
                        attrs={"step": float(step),
                               "__op_role__": "lr_sched"})
    return main.var(name)
