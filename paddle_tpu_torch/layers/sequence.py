"""fluid.layers sequence functions on the padded + lengths LoD encoding
(counterpart of ``paddle_tpu/layers/sequence.py``, the same ops and var
names).

Reference: python/paddle/fluid/layers/sequence_lod ops inside nn.py
(sequence_pool :2470, sequence_softmax, sequence_expand :4885, sequence_pad,
sequence_conv :2277, ...) over packed LoDTensors.

Encoding contract: a lod_level>=1 variable ``x`` is padded
``[batch, max_len, ...]`` and its per-sequence lengths live in the companion
variable ``<x.name>@LOD`` (int32 ``[batch]``), created by ``layers.data`` and
fed by hand or by the ``DataFeeder`` (which also buckets max_len). Ops
producing new sequences create the companion for their outputs (an
``assign`` from the input's, or the op's own ``OutLen``), so lengths flow
through the graph like any other var.
"""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_softmax", "sequence_reverse",
           "sequence_expand", "sequence_concat", "sequence_pad",
           "sequence_unpad", "sequence_slice", "sequence_erase",
           "sequence_enumerate", "sequence_conv", "sequence_first_step",
           "sequence_last_step", "sequence_mask", "lod_suffix", "seq_len_var"]

lod_suffix = "@LOD"


def seq_len_var(x: Variable) -> Variable:
    """The companion lengths variable of a lod_level>=1 var. When ``x`` has
    no direct companion, lengths are inferred through the dataflow: ops like
    embedding/elementwise/activation preserve the time axis, so the producer
    chain is walked until a var with a companion is found (the reference
    propagates LoD in each op's InferShape; here it is derived on demand).

    When the producer graph reaches MORE THAN ONE distinct companion (an
    op mixing tensors from different sequences), the first in input order
    is used and a RuntimeWarning names all candidates — pass the intended
    sequence explicitly (produce the tensor with a sequence op, or declare
    the input with lod_level=1) to silence it."""
    block = x.block
    # one exhaustive walk serves both purposes: found[0] is exactly what
    # the old short-circuiting walk returned (same DFS order), the rest
    # detects ambiguity
    all_names: list = []
    _collect_lod_names(block, x.name, set(), all_names)
    if not all_names:
        raise ValueError(
            f"'{x.name}' has no sequence lengths companion "
            f"'{x.name}{lod_suffix}' and none could be inferred from its "
            f"producers — declare the input with layers.data(..., "
            f"lod_level=1) or produce '{x.name}' with a sequence op")
    name = all_names[0]
    if len(set(all_names)) > 1:
        import warnings

        warnings.warn(
            f"seq_len_var('{x.name}'): multiple sequence-length companions"
            f" are reachable through its producers ({sorted(set(all_names))}"
            f"); using '{name}'. If that is the wrong sequence, pass "
            f"lengths explicitly.", RuntimeWarning, stacklevel=3)
    return block._var_recursive(name)


def _collect_lod_names(block, name, seen, found):
    """Producer-graph walk gathering EVERY reachable companion (DFS,
    input order): found[0] is the binding, the rest flag ambiguity."""
    if block.has_var_recursive(name + lod_suffix):
        found.append(name + lod_suffix)
        return
    if name in seen:
        return
    seen.add(name)
    for op in reversed(block.ops):
        if name in op.output_arg_names:
            for n in op.input_arg_names:
                if n != name and n != "@EMPTY@":
                    _collect_lod_names(block, n, seen, found)
            return


def _make_lod_out(helper: LayerHelper, out: Variable) -> Variable:
    lod = helper.block.create_var(name=out.name + lod_suffix, shape=(-1,),
                                  dtype="int32", stop_gradient=True)
    out.lod_level = 1
    return lod


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_pool",
                     inputs={"X": input, "SeqLen": seq_len_var(input)},
                     outputs={"Out": out},
                     attrs={"pooltype": pool_type.upper(),
                            "pad_value": float(pad_value)})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_softmax",
                     inputs={"X": input, "SeqLen": seq_len_var(input)},
                     outputs={"Out": out})
    helper.append_op("assign", inputs={"X": seq_len_var(input)},
                     outputs={"Out": lod})
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_reverse",
                     inputs={"X": x, "SeqLen": seq_len_var(x)},
                     outputs={"Y": out})
    helper.append_op("assign", inputs={"X": seq_len_var(x)},
                     outputs={"Out": lod})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_expand",
                     inputs={"X": x, "Y": y, "SeqLen": seq_len_var(y)},
                     outputs={"Out": out}, attrs={"ref_level": ref_level})
    helper.append_op("assign", inputs={"X": seq_len_var(y)},
                     outputs={"Out": lod})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_concat",
                     inputs={"X": input,
                             "SeqLen": [seq_len_var(v) for v in input]},
                     outputs={"Out": out, "OutLen": lod})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int32",
                                                       stop_gradient=True)
    helper.append_op("sequence_pad",
                     inputs={"X": x, "SeqLen": seq_len_var(x),
                             "PadValue": pad_value},
                     outputs={"Out": out, "Length": length},
                     attrs={"padded_length": int(maxlen or -1)})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_unpad",
                     inputs={"X": x, "Length": length},
                     outputs={"Out": out, "OutLen": lod})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_slice",
                     inputs={"X": input, "SeqLen": seq_len_var(input),
                             "Offset": offset, "Length": length},
                     outputs={"Out": out, "OutLen": lod})
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_erase",
                     inputs={"X": input, "SeqLen": seq_len_var(input)},
                     outputs={"Out": out, "OutLen": lod},
                     attrs={"tokens": list(tokens)})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_enumerate",
                     inputs={"X": input, "SeqLen": seq_len_var(input)},
                     outputs={"Out": out},
                     attrs={"win_size": int(win_size),
                            "pad_value": int(pad_value)})
    helper.append_op("assign", inputs={"X": seq_len_var(input)},
                     outputs={"Out": lod})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """reference nn.py:2277 sequence_conv: context-window projection."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    feat = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                shape=[filter_size * feat, num_filters],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    lod = _make_lod_out(helper, out)
    start = (-(filter_size // 2) if padding_start is None
             else int(padding_start))
    helper.append_op("sequence_conv",
                     inputs={"X": input, "Filter": w,
                             "SeqLen": seq_len_var(input)},
                     outputs={"Out": out},
                     attrs={"contextLength": int(filter_size),
                            "contextStart": start,
                            "contextStride": int(filter_stride)})
    helper.append_op("assign", inputs={"X": seq_len_var(input)},
                     outputs={"Out": lod})
    out = helper.append_bias_op(out, dim_start=2)
    out = helper.append_activation(out)
    # bias/activation un-zero the padded rows (act(bias) != 0); re-mask so
    # the module's zero-padding contract holds for non-length-aware consumers
    masked = helper.create_variable_for_type_inference(out.dtype)
    mlod = helper.block.create_var(name=masked.name + lod_suffix, shape=(-1,),
                                   dtype="int32", stop_gradient=True)
    masked.lod_level = 1
    helper.append_op("sequence_unpad",
                     inputs={"X": out, "Length": seq_len_var(input)},
                     outputs={"Out": masked, "OutLen": mlod})
    return masked


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None or int(maxlen) <= 0:
        # the JAX package's message, word for word; here the reason is the
        # host read of the lengths the reference's default would need
        raise ValueError(
            "sequence_mask on TPU needs a static maxlen (XLA static shapes);"
            " the reference's dynamic max-length default has no encoding")
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("sequence_mask", inputs={"X": x}, outputs={"Y": out},
                     attrs={"maxlen": int(maxlen or -1), "out_dtype": dtype})
    return out


def sequence_reshape(input, new_dim):
    """reference nn.py sequence_reshape: redistribute timesteps so the
    feature dim becomes new_dim; lengths scale by old_dim/new_dim."""
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_reshape",
                     inputs={"X": input, "SeqLen": seq_len_var(input)},
                     outputs={"Out": out, "OutLen": lod},
                     attrs={"new_dim": int(new_dim)})
    return out


def sequence_expand_as(x, y, name=None):
    """reference nn.py sequence_expand_as: row i of x fills sequence i of
    y (padded encoding: broadcast over y's time axis, masked by lengths)."""
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    lod = _make_lod_out(helper, out)
    helper.append_op("sequence_expand_as",
                     inputs={"X": x, "Y": y, "SeqLen": seq_len_var(y)},
                     outputs={"Out": out})
    helper.append_op("assign", inputs={"X": seq_len_var(y)},
                     outputs={"Out": lod})
    return out


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_scatter",
                     inputs={"X": input, "Ids": index, "Updates": updates,
                             "SeqLen": seq_len_var(index)},
                     outputs={"Out": out})
    return out


def lod_reset(x, y=None, target_lod=None):
    """reference nn.py lod_reset: re-bind x's sequence lengths. With the
    padded+lengths encoding this is a companion-var rebind: lengths come
    from y's companion (or y itself when y is int32 [batch]) or from the
    static target_lod offsets."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("assign", inputs={"X": x}, outputs={"Out": out})
    lod = _make_lod_out(helper, out)
    if y is not None:
        src = y if getattr(y, "lod_level", 0) == 0 and \
            str(y.dtype).startswith("int") else seq_len_var(y)
        helper.append_op("assign", inputs={"X": src}, outputs={"Out": lod})
    elif target_lod is not None:
        lens = [int(b) - int(a) for a, b in
                zip(target_lod[:-1], target_lod[1:])]
        helper.append_op("assign_value", outputs={"Out": lod},
                         attrs={"shape": [len(lens)], "dtype": "int32",
                                "values": [float(v) for v in lens]})
    else:
        raise ValueError("lod_reset needs y or target_lod")
    return out


def lod_append(x, level):
    raise NotImplementedError(
        "lod_append: the padded+lengths encoding carries ONE sequence "
        "level (layers/sequence.py module docstring); nested levels "
        "flatten at the data layer — reshape the batch instead")


__all__ += ["sequence_reshape", "sequence_expand_as", "sequence_scatter",
            "lod_reset", "lod_append"]
