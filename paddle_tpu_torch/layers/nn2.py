"""Layers of paddle_tpu's layers/nn2.py: the generative-inference ones
(the KV-cache, gather, sampling and speculative-accept ops of
``ops/generation.py``), the one-op wrappers over ``ops/math.py``
(``maxout``, ``selu``, ``stanh``, ``brelu``, ``sign``,
``elementwise_mod``, ``elementwise_floordiv``) and over the rest of
``ops/tensor.py`` and ``ops/loss.py``, the SelectedRows utilities, the
beam-search wrappers and the composites (``dice_loss``, ``mse_loss``,
``npair_loss``, ``rank``, ``sum``, ``scatter_nd``, ``lstm_unit``,
``adaptive_pool2d``, ``autoincreased_step_counter``), and the layers
over the misc and image groups (``ops/misc.py``, ``ops/image.py``): the
3-D convolutions and pools, the rearrangements, the samplers, the
specialty losses, the CTR layers (``hash``, ``data_norm``,
``continuous_value_model``, ``unique``), ``spectral_norm`` and the
composites ``fsp_matrix``, ``image_resize_short`` and
``adaptive_pool3d``, and the RoI and deformable layers over
``ops/detection.py`` and ``ops/misc2.py`` (``roi_pool``, ``roi_align``,
``deformable_conv``, ``deformable_roi_pooling``, ``psroi_pool``,
``prroi_pool``) with ``sampled_softmax_with_cross_entropy`` and
``py_func``. ``filter_by_instag`` is refused, as in the JAX package, and
so are ``deformable_roi_pooling(position_sensitive=False)``,
``sampled_softmax_with_cross_entropy(use_customized_samples=True)`` and
``py_func(backward_func=...)``."""
from __future__ import annotations

import math

from ..initializer import Constant, Normal, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
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
           "autoincreased_step_counter", "conv3d", "pool3d",
           "conv3d_transpose", "adaptive_pool3d", "lrn", "pad_constant_like",
           "label_smooth", "crop", "crop_tensor", "affine_grid",
           "strided_slice", "space_to_depth", "affine_channel", "hash",
           "grid_sampler", "add_position_encoding", "shuffle_channel",
           "temporal_shift", "pixel_shuffle", "unique", "unique_with_counts",
           "unfold", "random_crop", "similarity_focus", "sampling_id",
           "cross_entropy2", "teacher_student_sigmoid_loss", "center_loss",
           "bilinear_tensor_product", "multiplex", "im2sequence",
           "row_conv", "data_norm", "spectral_norm", "image_resize_short",
           "fsp_matrix", "continuous_value_model", "resize_trilinear",
           "filter_by_instag", "roi_pool", "roi_align", "deformable_conv",
           "deformable_roi_pooling", "psroi_pool", "prroi_pool",
           "sampled_softmax_with_cross_entropy", "py_func"]


def _outs(op_type, inputs, outs, attrs=None, name=None):
    """One op; ``outs`` maps each output slot to its dtype, the first slot
    the main output (None: the dtype of the first input that is one var),
    the rest stop the gradient (None: the main output's dtype). Inputs
    given as None are left out. Returns the output vars in order."""
    helper = LayerHelper(op_type, name=name)
    inputs = {k: v for k, v in inputs.items() if v is not None}
    main = next(iter(outs.values())) or next(
        v for v in inputs.values() if not isinstance(v, (list, tuple))).dtype
    made = {}
    for k, (slot, dt) in enumerate(outs.items()):
        made[slot] = helper.create_variable_for_type_inference(
            dt or main, stop_gradient=k > 0)
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


# -- the misc and image groups (ops/misc.py, ops/image.py) ------------------

def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """3-D convolution of NCDHW ``input``; filters [num_filters,
    C / groups, kd, kh, kw] from Normal(0, sqrt(2 / (k^3 C)))."""
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    k = _triple(filter_size)
    num_channels = input.shape[1]
    std = (2.0 / (k[0] * k[1] * k[2] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, shape=[num_filters, num_channels // groups] + k,
        dtype=input.dtype, default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d", inputs={"Input": input, "Filter": w},
                     outputs={"Output": pre_bias},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation),
                            "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None):
    return _one("pool3d", {"X": input},
                {"pooling_type": pool_type, "ksize": _triple(pool_size),
                 "strides": _triple(pool_stride),
                 "paddings": _triple(pool_padding),
                 "global_pooling": global_pooling, "ceil_mode": ceil_mode,
                 "exclusive": exclusive}, name=name)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """Transposed 3-D convolution; filters [C, num_filters / groups, kd,
    kh, kw] from Xavier. ``output_size`` is not read (give
    ``filter_size``)."""
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    k = _triple(filter_size)
    num_channels = input.shape[1]
    w = helper.create_parameter(
        helper.param_attr, shape=[num_channels, num_filters // groups] + k,
        dtype=input.dtype, default_initializer=Xavier())
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d_transpose",
                     inputs={"Input": input, "Filter": w},
                     outputs={"Output": pre_bias},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation),
                            "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """pool3d whose output is ``pool_size``: each spatial dim must divide
    by it (a fixed window of D / o)."""
    if require_index:
        raise NotImplementedError("adaptive_pool3d(require_index=True)")
    d, h, w = [int(v) for v in input.shape[2:]]
    ps = _triple(pool_size)
    if d % ps[0] or h % ps[1] or w % ps[2]:
        raise NotImplementedError(
            "adaptive_pool3d: each spatial dim must divide by pool_size "
            "(fixed windows, as the JAX package requires); pad the input "
            "or pick a divisor size")
    k = [d // ps[0], h // ps[1], w // ps[2]]
    return pool3d(input, pool_size=k, pool_type=pool_type, pool_stride=k)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    return _outs("lrn", {"X": input}, {"Out": None, "MidOut": None},
                 {"n": n, "k": k, "alpha": alpha, "beta": beta}, name)[0]


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _one("pad_constant_like", {"X": x, "Y": y},
                {"pad_value": float(pad_value)}, name=name)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    return _one("label_smooth", {"X": label, "PriorDist": prior_dist},
                {"epsilon": float(epsilon)}, name=name)


def _shape_and_offsets(ins, shape, offsets, shape_slot):
    """Attrs for a list shape/offsets, else the var in its input slot."""
    attrs = {}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = list(shape)
    elif shape is not None:
        ins[shape_slot] = shape
    if isinstance(offsets, (list, tuple)):
        attrs["offsets"] = list(offsets)
    elif offsets is not None:
        ins["Offsets"] = offsets
    return attrs


def crop(x, shape=None, offsets=None, name=None):
    ins = {"X": x}
    attrs = _shape_and_offsets(ins, shape, offsets, "Y")
    return _one("crop", ins, attrs, name=name)


def crop_tensor(x, shape=None, offsets=None, name=None):
    ins = {"X": x}
    attrs = _shape_and_offsets(ins, shape, offsets, "Shape")
    return _one("crop_tensor", ins, attrs, name=name)


def affine_grid(theta, out_shape=None, name=None):
    attrs = {}
    ins = {"Theta": theta}
    if isinstance(out_shape, (list, tuple)):
        attrs["output_shape"] = [int(v) for v in out_shape]
    elif out_shape is not None:
        ins["OutputShape"] = out_shape
    return _outs("affine_grid", ins, {"Output": None}, attrs, name)[0]


def strided_slice(input, axes, starts, ends, strides, name=None):
    return _one("strided_slice", {"Input": input},
                {"axes": list(axes), "starts": list(starts),
                 "ends": list(ends), "strides": list(strides)}, name=name)


def space_to_depth(x, blocksize, name=None):
    return _one("space_to_depth", {"X": x}, {"blocksize": blocksize},
                name=name)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    return _one("affine_channel", {"X": x, "Scale": scale, "Bias": bias},
                {"data_layout": data_layout}, name=name)


def hash(input, hash_size, num_hash=1, name=None):
    """[N, num_hash, 1] int64 ids in [0, hash_size) of each row of int
    ``input``."""
    return _outs("hash", {"X": input}, {"Out": "int64"},
                 {"num_hash": num_hash, "mod_by": hash_size}, name)[0]


def grid_sampler(x, grid, name=None):
    return _outs("grid_sampler", {"X": x, "Grid": grid}, {"Output": None},
                 name=name)[0]


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _one("add_position_encoding", {"X": input},
                {"alpha": float(alpha), "beta": float(beta)}, name=name)


def shuffle_channel(x, group, name=None):
    return _one("shuffle_channel", {"X": x}, {"group": group}, name=name)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _one("temporal_shift", {"X": x},
                {"seg_num": seg_num, "shift_ratio": shift_ratio}, name=name)


def pixel_shuffle(x, upscale_factor, name=None):
    return _one("pixel_shuffle", {"X": x},
                {"upscale_factor": upscale_factor}, name=name)


def unique(x, dtype="int32", name=None):
    """(Out, Index): Out is len(x) long, the uniques first."""
    return tuple(_outs("unique", {"X": x}, {"Out": None, "Index": dtype},
                       {"dtype": dtype}, name))


def unique_with_counts(x, dtype="int32", name=None):
    return tuple(_outs("unique_with_counts", {"X": x},
                       {"Out": None, "Index": dtype, "Count": dtype},
                       {"dtype": dtype}, name))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    pads = _pair(paddings) if not isinstance(paddings, (list, tuple)) \
        or len(paddings) != 4 else list(paddings)
    return _outs("unfold", {"X": x}, {"Y": None},
                 {"kernel_sizes": _pair(kernel_sizes),
                  "strides": _pair(strides), "paddings": pads,
                  "dilations": _pair(dilations)}, name)[0]


def random_crop(x, shape, seed=None, name=None):
    return _outs("random_crop", {"X": x}, {"Out": None, "SeedOut": "int64"},
                 {"shape": list(shape),
                  "startup_seed": int(seed) if seed else 0}, name)[0]


def similarity_focus(input, axis, indexes, name=None):
    return _one("similarity_focus", {"X": input},
                {"axis": axis, "indexes": list(indexes)}, name=name)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):
    return _outs("sampling_id", {"X": x}, {"Out": dtype},
                 {"min": min, "max": max, "seed": seed}, name)[0]


def cross_entropy2(input, label, ignore_index=-100, name=None):
    return _outs("cross_entropy2", {"X": input, "Label": label},
                 {"Y": None, "XShape": None, "MatchX": None},
                 {"ignore_index": ignore_index}, name)[0]


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _outs("teacher_student_sigmoid_loss",
                 {"X": input, "Label": label}, {"Y": None},
                 {"soft_max_up_bound": soft_max_up_bound,
                  "soft_max_lower_bound": soft_max_lower_bound})[0]


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """|x - c_y|^2 / 2 per row against the centres parameter [num_classes,
    D] (zeros at start). As in the JAX package, the op's CentersOut is a
    temporary, so the centres parameter never moves (Fluid writes it
    back)."""
    helper = LayerHelper("center_loss", param_attr=param_attr)
    centers = helper.create_parameter(
        helper.param_attr, shape=[num_classes, input.shape[-1]],
        dtype=input.dtype, default_initializer=Constant(0.0))
    rate = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    helper.append_op("fill_constant", outputs={"Out": rate},
                     attrs={"shape": [1], "dtype": "float32",
                            "value": float(alpha)})
    c_out = helper.create_variable_for_type_inference(input.dtype,
                                                      stop_gradient=True)
    diff = helper.create_variable_for_type_inference(input.dtype,
                                                     stop_gradient=True)
    loss = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("center_loss",
                     inputs={"X": input, "Label": label,
                             "Centers": centers, "CenterUpdateRate": rate},
                     outputs={"CentersOut": c_out, "SampleCenterDiff": diff,
                              "Loss": loss},
                     attrs={"cluster_num": num_classes,
                            "need_update": update_center})
    return loss


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out_k = x W_k y^T (+ b_k); W [size, dim x, dim y], b [1, size]."""
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(
        helper.param_attr, shape=[size, x.shape[-1], y.shape[-1]],
        dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": x, "Y": y, "Weight": w}
    if bias_attr is not False:
        ins["Bias"] = helper.create_parameter(
            helper.bias_attr or ParamAttr(), shape=[1, size], dtype=x.dtype,
            is_bias=True)
    helper.append_op("bilinear_tensor_product", inputs=ins,
                     outputs={"Out": out})
    return helper.append_activation(out)


def multiplex(inputs, index):
    return _one("multiplex", {"Ids": index, "X": list(inputs)})


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    pads = _pair(padding)
    if len(pads) == 2:
        pads = pads + pads
    return _one("im2sequence", {"X": input, "Y": input_image_size},
                {"kernels": _pair(filter_size), "strides": _pair(stride),
                 "paddings": pads, "out_stride": _pair(out_stride)},
                name=name)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """The lookahead convolution over [B, T, D]; filter
    [future_context_size + 1, D]."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    w = helper.create_parameter(
        helper.param_attr,
        shape=[future_context_size + 1, input.shape[-1]], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("row_conv", inputs={"X": input, "Filter": w},
                     outputs={"Out": out})
    return helper.append_activation(out)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, name=None):
    """Normalise by accumulated batch statistics: three [C] parameters,
    batch size 1e4, sum 0 and square sum 1e4 at start. No gradient
    reaches them and nothing updates them, as in the JAX package."""
    helper = LayerHelper("data_norm", param_attr=param_attr, act=act,
                         name=name)
    c = input.shape[-1]

    def stat(value):
        return helper.create_parameter(
            ParamAttr(name=None), shape=[c], dtype=input.dtype,
            default_initializer=Constant(value))

    batch_size, batch_sum, batch_sq = stat(1e4), stat(0.0), stat(1e4)
    y = helper.create_variable_for_type_inference(input.dtype)
    means = helper.create_variable_for_type_inference(input.dtype, True)
    scales = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("data_norm",
                     inputs={"X": input, "BatchSize": batch_size,
                             "BatchSum": batch_sum,
                             "BatchSquareSum": batch_sq},
                     outputs={"Y": y, "Means": means, "Scales": scales},
                     attrs={"epsilon": epsilon})
    return helper.append_activation(y)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` over its largest singular value, estimated by power
    iteration from the non-trainable U [h] and V [w] (Normal(0, 1) at
    start). The op is pure, as the JAX package's: U and V stay as the
    startup program set them (Fluid updates them every step)."""
    from .. import unique_name

    helper = LayerHelper("spectral_norm", name=name)
    h = int(weight.shape[dim])
    w = math.prod(int(weight.shape[i]) for i in range(len(weight.shape))
                  if i != dim)

    def vec(key, size):
        return helper.create_parameter(
            ParamAttr(name=unique_name.generate(key), trainable=False),
            shape=[size], dtype=weight.dtype,
            default_initializer=Normal(0.0, 1.0))

    u, v = vec("spectral_norm_u", h), vec("spectral_norm_v", w)
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op("spectral_norm",
                     inputs={"Weight": weight, "U": u, "V": v},
                     outputs={"Out": out},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the short side of the static H x W is ``out_short_len``,
    the ratio kept."""
    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    out_h = int(round(h * out_short_len / short))
    out_w = int(round(w * out_short_len / short))
    return _nn.image_resize(input, [out_h, out_w], resample)


def fsp_matrix(x, y):
    """The flow matrix of two feature maps [N, C1, H, W] and [N, C2, H, W]:
    x_flat @ y_flat^T / (H W), [N, C1, C2]."""
    c1, c2 = x.shape[1], y.shape[1]
    hw = int(x.shape[2]) * int(x.shape[3])
    x2 = _nn.reshape(x, [-1, c1, hw])
    y2 = _nn.reshape(y, [-1, c2, hw])
    prod = _nn.matmul(x2, _nn.transpose(y2, [0, 2, 1]))
    return _nn.scale(prod, scale=1.0 / hw)


def continuous_value_model(input, cvm, use_cvm=True):
    return _outs("cvm", {"X": input, "CVM": cvm}, {"Y": None},
                 {"use_cvm": use_cvm})[0]


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     align_corners=True):
    if out_shape is None:
        d, h, w = [int(s * scale) for s in input.shape[2:]]
    else:
        d, h, w = [int(v) for v in out_shape]
    return _one("trilinear_interp", {"X": input},
                {"out_d": d, "out_h": h, "out_w": w,
                 "align_corners": align_corners}, name=name)


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True):
    raise NotImplementedError(
        "filter_by_instag selects variable-size row subsets at runtime — "
        "dynamic shapes XLA cannot compile. Filter in the data pipeline "
        "(reader decorators) or mask rows with sequence_mask instead.")


# -- RoI and deformable layers, sampled softmax, the host callback ----------

def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch_idx=None, name=None):
    return _outs("roi_pool",
                 {"X": input, "ROIs": rois, "RoisBatchIdx": rois_batch_idx},
                 {"Out": None, "Argmax": "int64"},
                 {"pooled_height": pooled_height,
                  "pooled_width": pooled_width,
                  "spatial_scale": spatial_scale}, name=name)[0]


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_batch_idx=None,
              name=None):
    return _one("roi_align",
                {"X": input, "ROIs": rois, "RoisBatchIdx": rois_batch_idx},
                {"pooled_height": pooled_height,
                 "pooled_width": pooled_width,
                 "spatial_scale": spatial_scale,
                 "sampling_ratio": sampling_ratio}, name=name)


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=1, deformable_groups=1,
                    im2col_step=64, param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    """Deformable convolution, v2 with ``mask`` when ``modulated``, v1
    otherwise; the filter starts from N(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("deformable_conv", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)

    def pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    k = pair(filter_size)
    num_channels = input.shape[1]
    std = (2.0 / (k[0] * k[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr,
        shape=[num_filters, num_channels // groups] + k,
        dtype=input.dtype, default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Input": input, "Offset": offset, "Filter": w}
    if modulated and mask is not None:
        ins["Mask"] = mask
    helper.append_op("deformable_conv", inputs=ins,
                     outputs={"Output": pre_bias},
                     attrs={"strides": pair(stride),
                            "paddings": pair(padding),
                            "dilations": pair(dilation), "groups": groups,
                            "deformable_groups": deformable_groups,
                            "im2col_step": im2col_step})
    return helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1,
                           part_size=None, sample_per_part=1, trans_std=0.1,
                           position_sensitive=True, rois_batch_idx=None,
                           name=None):
    helper = LayerHelper("deformable_psroi_pooling", name=name)
    if not position_sensitive:
        raise NotImplementedError(
            "deformable_roi_pooling(position_sensitive=False): use "
            "roi_align + trans offsets; the PS path is the deformable "
            "detectors' configuration")
    gs = list(group_size)
    out_dim = input.shape[1] // (gs[0] * gs[1])
    ps = list(part_size) if part_size is not None \
        else [pooled_height, pooled_width]
    o = helper.create_variable_for_type_inference(input.dtype)
    cnt = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    ins = {"Input": input, "ROIs": rois, "Trans": trans}
    if rois_batch_idx is not None:
        ins["RoisBatchIdx"] = rois_batch_idx
    helper.append_op("deformable_psroi_pooling", inputs=ins,
                     outputs={"Output": o, "TopCount": cnt},
                     attrs={"no_trans": no_trans,
                            "spatial_scale": spatial_scale,
                            "output_dim": int(out_dim), "group_size": gs,
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width, "part_size": ps,
                            "sample_per_part": sample_per_part,
                            "trans_std": trans_std})
    return o


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_batch_idx=None, name=None):
    """``rois_batch_idx``: int tensor [R] of each RoI's image; required
    when the batch is over 1."""
    return _one("psroi_pool", {"X": input, "ROIs": rois,
                               "RoisBatchIdx": rois_batch_idx},
                {"output_channels": output_channels,
                 "spatial_scale": spatial_scale,
                 "pooled_height": pooled_height,
                 "pooled_width": pooled_width}, name=name)


def prroi_pool(input, rois, output_channels=None, spatial_scale=1.0,
               pooled_height=1, pooled_width=1, batch_roi_nums=None,
               rois_batch_idx=None, name=None):
    """``batch_roi_nums``: int tensor [B] of RoI counts per image (RoIs
    past their sum go to the last image); ``rois_batch_idx``: int tensor
    [R] of each RoI's image. One of the two is required when the batch is
    over 1, and both are refused."""
    if batch_roi_nums is not None and rois_batch_idx is not None:
        raise ValueError(
            "prroi_pool: pass either batch_roi_nums or rois_batch_idx, "
            "not both — with conflicting values the op would silently "
            "follow rois_batch_idx")
    return _one("prroi_pool", {"X": input, "ROIs": rois,
                               "BatchRoINums": batch_roi_nums,
                               "RoisBatchIdx": rois_batch_idx},
                {"spatial_scale": spatial_scale,
                 "pooled_height": pooled_height,
                 "pooled_width": pooled_width}, name=name)


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    if use_customized_samples:
        raise NotImplementedError(
            "sampled_softmax_with_cross_entropy(use_customized_samples): "
            "host-side alias tables; use the log-uniform sampler")
    return _outs("sampled_softmax_with_cross_entropy",
                 {"Logits": logits, "Label": label},
                 {"Loss": None, "Samples": "int64", "Probabilities": None},
                 {"num_samples": num_samples, "seed": seed,
                  "remove_accidental_hits": remove_accidental_hits})[0]


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """A host Python callback inside the program (``ops/misc2.py``
    ``py_func``). The ``out`` vars give the results' shapes and dtypes
    (concrete shapes); ``backward_func`` is refused, the callback being
    opaque to the gradient."""
    from ..ops.misc2 import register_py_func

    if backward_func is not None:
        raise NotImplementedError(
            "py_func(backward_func=...): the host callback is opaque to "
            "the gradient; compute the backward inside the program instead")
    helper = LayerHelper("py_func")
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    fid = register_py_func(func)
    helper.append_op(
        "py_func", inputs={"X": xs}, outputs={"Out": outs},
        attrs={"func_id": fid,
               "out_shapes": [[int(d) for d in v.shape] for v in outs],
               "out_dtypes": [str(v.dtype) for v in outs]})
    return out
