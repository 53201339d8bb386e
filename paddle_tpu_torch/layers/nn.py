"""Layer-building functions (reference: python/paddle/fluid/layers/nn.py),
the subset the port's models call. Each follows the reference pattern:
LayerHelper -> create params -> append op(s) -> return the out Variable.
"""
from __future__ import annotations

import numpy as np

from ..core.types import canonical_dtype
from ..initializer import Constant, Normal, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
           "clip", "clip_by_norm", "increment", "matmul", "mul",
           "fused_multihead_attention", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_min",
           "elementwise_max", "elementwise_pow", "equal", "not_equal",
           "less_than", "less_equal", "greater_than", "greater_equal",
           "logical_and", "logical_or", "logical_xor", "scale", "reshape",
           "transpose", "cast", "unsqueeze", "dropout", "mean", "reduce_sum",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
           "reduce_all", "reduce_any", "softmax_with_cross_entropy",
           "cross_entropy", "square_error_cost",
           "sigmoid_cross_entropy_with_logits", "huber_loss", "smooth_l1",
           "log_loss", "cos_sim", "slice", "topk", "accuracy", "where",
           "one_hot", "concat", "sums", "split", "flatten", "squeeze",
           "stack", "unstack", "expand", "gather", "scatter", "shape", "pad",
           "arg_max", "arg_min", "argsort", "cumsum",
           "relu", "sigmoid", "tanh", "exp", "log", "sqrt", "square", "abs",
           "ceil", "floor", "cos", "sin", "round", "reciprocal", "erf",
           "gelu", "logical_not", "soft_relu", "leaky_relu", "relu6", "elu",
           "swish", "hard_swish", "hard_sigmoid", "pow", "softmax",
           "log_softmax", "linear_chain_crf", "crf_decoding", "nce",
           "hsigmoid", "edit_distance", "ctc_greedy_decoder", "chunk_eval",
           "conv2d_transpose", "group_norm", "instance_norm", "l2_normalize",
           "prelu", "image_resize", "resize_bilinear", "resize_nearest"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: out = act(X W + b)."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    param_shape = [int(np.prod(input.shape[num_flatten_dims:])), size]
    w = helper.create_parameter(helper.param_attr, shape=param_shape,
                                dtype=input.dtype)
    tmp = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mul", inputs={"X": input, "Y": w},
                     outputs={"Out": tmp},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    pre_act = helper.append_bias_op(tmp, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """lookup_table over a [vocab, dim] table. An ``is_sparse`` or
    ``is_distributed`` table is tagged ``is_distributed``, as the
    reference tags it for row sharding; on one card the tag shards
    nothing, and its grad is a SelectedRows either way."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype, is_bias=False)
    if is_distributed or is_sparse:
        w.is_distributed = True
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table", inputs={"W": w, "Ids": input},
                     outputs={"Out": out},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": pad})
    return out


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """2-D convolution over NCHW ``input`` with OIHW filters drawn from
    Normal(0, sqrt(2 / (kh * kw * C))); a per-channel bias unless
    ``bias_attr=False``."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=input.dtype,
                                default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d", inputs={"Input": input, "Filter": w},
                     outputs={"Output": pre_bias},
                     attrs={"strides": list(stride), "paddings": list(padding),
                            "dilations": list(dilation), "groups": groups,
                            "use_cudnn": use_cudnn, "data_format": data_format})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """Transposed 2-D convolution over NCHW ``input`` with [C_in,
    num_filters / groups, kh, kw] filters (Xavier unless ``param_attr``
    names an initializer: ``initializer.Bilinear`` gives the upsampling
    kernel); a per-channel bias unless ``bias_attr=False``."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    filter_shape = [num_channels, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=input.dtype,
                                default_initializer=Xavier())
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d_transpose", inputs={"Input": input, "Filter": w},
                     outputs={"Output": pre_bias},
                     attrs={"strides": list(stride), "paddings": list(padding),
                            "dilations": list(dilation), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"pooling_type": pool_type,
                            "ksize": list(_pair(pool_size)),
                            "strides": list(_pair(pool_stride)),
                            "paddings": list(_pair(pool_padding)),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive,
                            "use_cudnn": use_cudnn})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """Batch normalization: trainable ``Scale`` (1) and ``Bias`` (0),
    and the running ``Mean`` (0) and ``Variance`` (1) as non-trainable
    parameters that the op's ``MeanOut``/``VarianceOut`` overwrite."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c_axis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    channels = input.shape[c_axis]
    dtype = input.dtype
    scale = helper.create_parameter(helper.param_attr, shape=[channels],
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias_at = helper.bias_attr if helper.bias_attr is not False else ParamAttr()
    bias = helper.create_parameter(bias_at or ParamAttr(), shape=[channels],
                                   dtype=dtype, is_bias=True,
                                   default_initializer=Constant(0.0))
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False),
        shape=[channels], dtype=dtype, default_initializer=Constant(0.0))
    mean.stop_gradient = True
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False),
        shape=[channels], dtype=dtype, default_initializer=Constant(1.0))
    variance.stop_gradient = True
    y = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype,
                                                           stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype,
                                                          stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": variance},
        outputs={"Y": y, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y)


def _channel_affine(helper, input):
    """The per-channel scale (1) and bias (0) of group and instance norm."""
    channels = input.shape[1]
    s = helper.create_parameter(helper.param_attr, shape=[channels],
                                dtype=input.dtype,
                                default_initializer=Constant(1.0))
    b = helper.create_parameter(
        helper.bias_attr if helper.bias_attr is not False else None,
        shape=[channels], dtype=input.dtype, is_bias=True,
        default_initializer=Constant(0.0))
    return s, b


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    s, b = _channel_affine(helper, input)
    y = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype, True)
    var = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("group_norm", inputs={"X": input, "Scale": s,
                                           "Bias": b},
                     outputs={"Y": y, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon, "groups": groups})
    return helper.append_activation(y)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    s, b = _channel_affine(helper, input)
    y = helper.create_variable_for_type_inference(input.dtype)
    sm = helper.create_variable_for_type_inference(input.dtype, True)
    sv = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("instance_norm",
                     inputs={"X": input, "Scale": s, "Bias": b},
                     outputs={"Y": y, "SavedMean": sm, "SavedVariance": sv},
                     attrs={"epsilon": epsilon})
    return y


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("l2_normalize", inputs={"X": x},
                     outputs={"Out": out, "Norm": norm},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """alpha (0.25) is one scalar ("all"), one per channel ("channel") or
    one per element of a sample ("element")."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    alpha_shape = [1] if mode == "all" else (
        [x.shape[1]] if mode == "channel" else list(x.shape[1:]))
    alpha = helper.create_parameter(helper.param_attr, shape=alpha_shape,
                                    dtype=x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": x, "Alpha": alpha},
                     outputs={"Out": out}, attrs={"mode": mode})
    return out


def image_resize(input, out_shape, resample="BILINEAR", name=None):
    """NCHW resized to ``out_shape`` (h, w): ``bilinear_interp`` or, for
    ``resample="NEAREST"``, ``interpolate_nearest``."""
    op = ("bilinear_interp" if resample.upper() == "BILINEAR"
          else "interpolate_nearest")
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(op, inputs={"X": input}, outputs={"Out": out},
                     attrs={"out_h": int(out_shape[0]),
                            "out_w": int(out_shape[1])})
    return out


def resize_bilinear(input, out_shape=None, name=None, align_corners=True):
    return image_resize(input, out_shape, "BILINEAR", name)


def resize_nearest(input, out_shape=None, name=None, align_corners=False):
    return image_resize(input, out_shape, "NEAREST", name)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=Constant(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr if helper.bias_attr is not False else None,
            shape=norm_shape, dtype=dtype, is_bias=True,
            default_initializer=Constant(0.0))
    y = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": y, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": x}, outputs={"Out": out},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": x}, outputs={"Out": out},
                     attrs={"max_norm": max_norm})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": float(value)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def fused_multihead_attention(q, k, v, bias_qk=None, causal=False,
                              scale=0.0, attn_dropout=0.0, is_test=False,
                              sequence_parallel=False, name=None):
    """Fused multi-head attention (ops/fused_attention.py): q/k/v
    [B, num_heads, S, head_dim]; bias_qk an additive key bias [B, S] or
    [B, 1, 1, S]. scale=0.0 means 1/sqrt(head_dim)."""
    helper = LayerHelper("fused_multihead_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": q, "K": k, "V": v}
    if bias_qk is not None:
        inputs["BiasQK"] = bias_qk
    helper.append_op("fused_multihead_attention", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"causal": causal, "scale": scale,
                            "attn_dropout": attn_dropout,
                            "is_test": is_test,
                            "sequence_parallel": sequence_parallel})
    return out


def _elementwise(op_type):
    def fn(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": axis})
        return helper.append_activation(out)

    fn.__name__ = op_type
    return fn


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_min = _elementwise("elementwise_min")
elementwise_max = _elementwise("elementwise_max")
elementwise_pow = _elementwise("elementwise_pow")
equal = _elementwise("equal")
not_equal = _elementwise("not_equal")
less_than = _elementwise("less_than")
less_equal = _elementwise("less_equal")
greater_than = _elementwise("greater_than")
greater_equal = _elementwise("greater_equal")
logical_and = _elementwise("logical_and")
logical_or = _elementwise("logical_or")
logical_xor = _elementwise("logical_xor")


# -- simple wrappers (reference layers/nn.py _simple) -----------------------

def _simple(op_type, x_slot="X", out_slot="Out", **attrs):
    def fn(x, name=None, **kw):
        helper = LayerHelper(op_type, name=name)
        a = dict(attrs)
        a.update(kw)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={x_slot: x},
                         outputs={out_slot: out}, attrs=a)
        return out

    fn.__name__ = op_type
    return fn


relu = _simple("relu")
sigmoid = _simple("sigmoid")
tanh = _simple("tanh")
exp = _simple("exp")
log = _simple("log")
sqrt = _simple("sqrt")
square = _simple("square")
abs = _simple("abs")
ceil = _simple("ceil")
floor = _simple("floor")
cos = _simple("cos")
sin = _simple("sin")
round = _simple("round")
reciprocal = _simple("reciprocal")
erf = _simple("erf")
gelu = _simple("gelu")
logical_not = _simple("logical_not")


def soft_relu(x, threshold=40.0, name=None):
    helper = LayerHelper("soft_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("softplus", inputs={"X": x}, outputs={"Out": out})
    return out


def leaky_relu(x, alpha=0.02, name=None):
    return _simple("leaky_relu")(x, name=name, alpha=alpha)


def relu6(x, threshold=6.0, name=None):
    return _simple("relu6")(x, name=name, threshold=threshold)


def elu(x, alpha=1.0, name=None):
    return _simple("elu")(x, name=name, alpha=alpha)


def swish(x, beta=1.0, name=None):
    return _simple("swish")(x, name=name, beta=beta)


hard_swish = _simple("hard_swish")
hard_sigmoid = _simple("hard_sigmoid")


def pow(x, factor=1.0, name=None):
    return _simple("pow")(x, name=name, factor=factor)


def softmax(input, axis=-1, use_cudnn=False, name=None):
    return _simple("softmax")(input, name=name, axis=axis)


def log_softmax(input, axis=-1, name=None):
    return _simple("log_softmax")(input, name=name, axis=axis)


def where(condition, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where", inputs={"Condition": condition, "X": x, "Y": y},
                     outputs={"Out": out})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("transpose2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = canonical_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("unsqueeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": list(axes)})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op("dropout", inputs={"X": x},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "fix_seed": seed is not None, "seed": seed or 0,
                            "dropout_implementation":
                                dropout_implementation})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": x}, outputs={"Out": out})
    return out


def _reduce(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(dims), "keep_dim": keep_dim,
                     "reduce_all": False}
        helper.append_op(op_type, inputs={"X": input}, outputs={"Out": out},
                         attrs=attrs)
        return out

    fn.__name__ = op_type
    return fn


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")
reduce_all = _reduce("reduce_all")
reduce_any = _reduce("reduce_any")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax_out, "Loss": loss},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis,
                            "numeric_stable_mode": numeric_stable_mode})
    if return_softmax:
        return loss, softmax_out
    return loss


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "decrease_axis": []})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of ``input`` scores against ``label`` (reference
    layers/metric_op.py:accuracy)."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32", True)
    correct = correct or helper.create_variable_for_type_inference(
        "int32", True)
    total = total or helper.create_variable_for_type_inference("int32", True)
    helper.append_op("accuracy",
                     inputs={"Out": topk_out, "Indices": topk_indices,
                             "Label": label},
                     outputs={"Accuracy": acc_out, "Correct": correct,
                              "Total": total})
    return acc_out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


# -- losses (reference layers/nn.py and loss.py) ----------------------------

def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost", inputs={"X": input, "Y": label},
                     outputs={"Out": out})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": x, "Label": label}, outputs={"Out": out},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Out": out, "Residual": residual},
                     attrs={"delta": delta})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Out": out, "Diff": diff},
                     attrs={"sigma": sigma or 1.0})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_loss", inputs={"Predicted": input, "Labels": label},
                     outputs={"Loss": out}, attrs={"epsilon": epsilon})
    return out


# -- structured prediction / candidate sampling ----------------------------
# reference nn.py:1412 linear_chain_crf, :1528 crf_decoding, :5080 nce,
# :5216 hsigmoid, :4689 edit_distance, :4816 ctc_greedy_decoder,
# layers/metric_op chunk_eval. Sequence inputs ride the padded + @LOD
# lengths encoding; the Length op input is wired from the companion var.


def _seq_len_or_none(v):
    from .sequence import seq_len_var

    try:
        return seq_len_var(v)
    except ValueError:
        return None


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF negative log-likelihood (reference nn.py:1412). ``input`` is the
    padded [batch, time, tags] emission; the transition parameter is
    [tags+2, tags] (row 0 start, row 1 end). Returns the per-sequence cost
    ([batch, 1]) the reference calls log_likelihood."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    e_exps = helper.create_variable_for_type_inference(input.dtype)
    t_exps = helper.create_variable_for_type_inference(input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Emission": input, "Transition": transition, "Label": label}
    length = length or _seq_len_or_none(input) or _seq_len_or_none(label)
    if length is not None:
        inputs["Length"] = length
    helper.append_op("linear_chain_crf", inputs=inputs,
                     outputs={"Alpha": alpha, "EmissionExps": e_exps,
                              "TransitionExps": t_exps,
                              "LogLikelihood": ll})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the trained transition parameter (reference
    nn.py:1528). With ``label``, returns the 0/1 correctness mask."""
    helper = LayerHelper("crf_decoding")
    transition = helper.main_program.global_block.var(param_attr.name)
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    length = length or _seq_len_or_none(input)
    if length is not None:
        inputs["Length"] = length
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": path})
    return path


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference nn.py:5080)."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    sampler_id = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}[sampler]
    if custom_dist is not None:
        raise NotImplementedError(
            "nce(custom_dist=...): alias-table sampling is host-side; use "
            "sampler='uniform' or 'log_uniform'")
    cost = helper.create_variable_for_type_inference(input.dtype)
    s_logits = helper.create_variable_for_type_inference(input.dtype)
    s_labels = helper.create_variable_for_type_inference("int64")
    inputs = {"Input": input, "Label": label, "Weight": w}
    if sample_weight is not None:
        inputs["SampleWeight"] = sample_weight
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                    shape=[num_total_classes],
                                    dtype=input.dtype,
                                    default_initializer=Constant(0.0))
        inputs["Bias"] = b
    helper.append_op(
        "nce", inputs=inputs,
        outputs={"Cost": cost, "SampleLogits": s_logits,
                 "SampleLabels": s_labels},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": int(num_neg_samples or 10),
               "sampler": sampler_id, "seed": seed, "is_sparse": is_sparse})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid (reference nn.py:5216): complete-binary-tree
    softmax factorization, or a custom tree via path_table/path_code."""
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    if is_custom and (path_table is None or path_code is None):
        raise ValueError("is_custom=True needs path_table AND path_code")
    num_w = num_classes - 1 if not is_custom else num_classes
    w = helper.create_parameter(helper.param_attr, shape=[num_w, dim],
                                dtype=input.dtype)
    cost = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "W": w, "Label": label}
    if path_table is not None:
        inputs["PathTable"] = path_table
        inputs["PathCode"] = path_code
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                    shape=[num_w], dtype=input.dtype,
                                    default_initializer=Constant(0.0))
        inputs["Bias"] = b
    helper.append_op("hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": cost, "PreOut": pre_out},
                     attrs={"num_classes": int(num_classes),
                            "is_sparse": is_sparse})
    return cost


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance per sequence pair (reference nn.py:4689).
    Returns (distance [batch, 1], sequence_num [1])."""
    helper = LayerHelper("edit_distance")
    if ignored_tokens:
        raise NotImplementedError(
            "edit_distance(ignored_tokens=...): pre-filter with "
            "layers.sequence_erase, the reference composes the same way")
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    inputs = {"Hyps": input, "Refs": label}
    input_length = input_length or _seq_len_or_none(input)
    label_length = label_length or _seq_len_or_none(label)
    if input_length is not None:
        inputs["HypsLength"] = input_length
    if label_length is not None:
        inputs["RefsLength"] = label_length
    helper.append_op("edit_distance", inputs=inputs,
                     outputs={"Out": out, "SequenceNum": seq_num},
                     attrs={"normalized": normalized})
    return out, seq_num


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Greedy CTC decode (reference nn.py:4816): argmax per frame, then
    merge repeats + drop blanks. Returns (decoded [batch, time] padded,
    lengths [batch]) — the padded form of the reference's LoD output."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    argmax = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_max", inputs={"X": input}, outputs={"Out": argmax},
                     attrs={"axis": -1})
    decoded = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int32")
    inputs = {"Input": argmax}
    input_length = input_length or _seq_len_or_none(input)
    if input_length is not None:
        inputs["InputLength"] = input_length
    helper.append_op("ctc_align", inputs=inputs,
                     outputs={"Output": decoded, "OutputLength": out_len},
                     attrs={"blank": int(blank), "merge_repeated": True})
    from .sequence import _make_lod_out

    lod = _make_lod_out(helper, decoded)
    helper.append_op("assign", inputs={"X": out_len}, outputs={"Out": lod})
    return decoded, out_len


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk-level precision/recall/F1 for tagging (reference
    layers/nn.py chunk_eval). Returns the reference's 6-tuple."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference("float32")
    recall = helper.create_variable_for_type_inference("float32")
    f1 = helper.create_variable_for_type_inference("float32")
    n_infer = helper.create_variable_for_type_inference("int64")
    n_label = helper.create_variable_for_type_inference("int64")
    n_correct = helper.create_variable_for_type_inference("int64")
    inputs = {"Inference": input, "Label": label}
    seq_length = seq_length or _seq_len_or_none(input) \
        or _seq_len_or_none(label)
    if seq_length is not None:
        inputs["SeqLength"] = seq_length
    helper.append_op(
        "chunk_eval", inputs=inputs,
        outputs={"Precision": precision, "Recall": recall, "F1-Score": f1,
                 "NumInferChunks": n_infer, "NumLabelChunks": n_label,
                 "NumCorrectChunks": n_correct},
        attrs={"num_chunk_types": int(num_chunk_types),
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, n_infer, n_label, n_correct


def cos_sim(X, Y):
    """Cosine similarity along the last dim (reference nn.py:1360)."""
    helper = LayerHelper("cos_sim")
    out_v = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", inputs={"X": X, "Y": Y},
                     outputs={"Out": out_v, "XNorm": xnorm, "YNorm": ynorm})
    return out_v


# -- tensor manipulation (reference layers/nn.py) ---------------------------

def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": input}, outputs={"Out": out},
                     attrs={"depth": depth, "dtype": "float32"})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    out = out or helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": input}, outputs={"Out": out})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        attrs = {"num": num_or_sections, "sections": [], "axis": dim}
        n_out = num_or_sections
    else:
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
        n_out = len(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("flatten2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": axis})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("squeeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": list(axes)})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": x}, outputs={"Y": out},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op("unstack", inputs={"X": x}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", inputs={"X": x}, outputs={"Out": out},
                     attrs={"expand_times": list(expand_times)})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter",
                     inputs={"X": input, "Ids": index, "Updates": updates},
                     outputs={"Out": out}, attrs={"overwrite": overwrite})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("shape", inputs={"Input": input}, outputs={"Out": out})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pad", inputs={"X": x}, outputs={"Out": out},
                     attrs={"paddings": list(paddings),
                            "pad_value": pad_value})
    return out


def arg_max(x, axis=0, name=None):
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("arg_max", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def arg_min(x, axis=0, name=None):
    helper = LayerHelper("arg_min", name=name)
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("arg_min", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("argsort", inputs={"X": input},
                     outputs={"Out": out, "Indices": idx},
                     attrs={"axis": axis, "descending": descending})
    return out, idx


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("cumsum", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out
