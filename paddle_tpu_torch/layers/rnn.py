"""RNN layers: dynamic_lstm, dynamic_gru, gru_unit, lstm (cudnn), warpctc
and DynamicRNN (counterpart of ``paddle_tpu/layers/rnn.py``, the same ops,
parameters and var names).

Reference: python/paddle/fluid/layers/nn.py dynamic_lstm (:443),
dynamic_gru (:743), gru_unit (:846), lstm (cudnn_lstm wrapper, :475 in
later trees), warpctc (:4324). Sequence inputs follow the padded+lengths
encoding (layers/sequence.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .sequence import _make_lod_out, lod_suffix, seq_len_var

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
           "lstm", "warpctc"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input: [B, T, 4H] pre-projected (reference contract); size = 4H."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden_dim = size // 4
    w = helper.create_parameter(helper.param_attr,
                                shape=[hidden_dim, 4 * hidden_dim],
                                dtype=dtype)
    bias_size = 7 * hidden_dim if use_peepholes else 4 * hidden_dim
    b = helper.create_parameter(helper.bias_attr, shape=[1, bias_size],
                                dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    lod = _make_lod_out(helper, hidden)
    ins = {"Input": input, "Weight": w, "Bias": b,
           "SeqLen": seq_len_var(input)}
    if h_0 is not None:
        ins["H0"] = h_0
    if c_0 is not None:
        ins["C0"] = c_0
    helper.append_op("lstm", inputs=ins,
                     outputs={"Hidden": hidden, "Cell": cell},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    helper.append_op("assign", inputs={"X": seq_len_var(input)},
                     outputs={"Out": lod})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, h_0=None, c_0=None,
                  cell_clip=None, proj_clip=None):
    """LSTM with recurrent projection (reference nn.py:583 dynamic_lstmp):
    input [B, T, 4H] pre-projected; size = 4H; returns (projection [B,T,P],
    cell [B,H])."""
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden_dim = size // 4
    from ..param_attr import ParamAttr

    attrs = ParamAttr._to_attr(param_attr)
    if not isinstance(attrs, list):
        # one attr supplied (or none): the projection weight gets its own
        # derived name — reusing the attr verbatim would silently alias the
        # two differently-shaped parameters under one var name
        proj_attr = ParamAttr(
            name=(attrs.name + "_proj") if attrs.name else None,
            initializer=attrs.initializer,
            learning_rate=attrs.learning_rate,
            regularizer=attrs.regularizer, trainable=attrs.trainable)
        attrs = [attrs, proj_attr]
    elif len(attrs) != 2:
        raise ValueError("dynamic_lstmp takes 1 or 2 param_attr entries "
                         "(Weight, ProjWeight)")
    w = helper.create_parameter(attrs[0],
                                shape=[proj_size, 4 * hidden_dim],
                                dtype=dtype)
    w_proj = helper.create_parameter(attrs[1],
                                     shape=[hidden_dim, proj_size],
                                     dtype=dtype)
    bias_size = 7 * hidden_dim if use_peepholes else 4 * hidden_dim
    b = helper.create_parameter(helper.bias_attr, shape=[1, bias_size],
                                dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    _make_lod_out(helper, proj)
    ins = {"Input": input, "Weight": w, "ProjWeight": w_proj, "Bias": b,
           "SeqLen": seq_len_var(input)}
    if h_0 is not None:
        ins["H0"] = h_0
    if c_0 is not None:
        ins["C0"] = c_0
    helper.append_op("lstmp", inputs=ins,
                     outputs={"Projection": proj, "Cell": cell},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation,
                            "cell_clip": float(cell_clip or 0.0),
                            "proj_clip": float(proj_clip or 0.0)})
    helper.append_op("assign", inputs={"X": seq_len_var(input)},
                     outputs={"Out": helper.block.var(
                         proj.name + lod_suffix)})
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                dtype="float32", name=None):
    """input: [B, T, 3H] pre-projected; size = H."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[1, 3 * size],
                                dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    lod = _make_lod_out(helper, hidden)
    ins = {"Input": input, "Weight": w, "Bias": b,
           "SeqLen": seq_len_var(input)}
    if h_0 is not None:
        ins["H0"] = h_0
    helper.append_op("gru", inputs=ins, outputs={"Hidden": hidden},
                     attrs={"is_reverse": is_reverse,
                            "origin_mode": origin_mode,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    helper.append_op("assign", inputs={"X": seq_len_var(input)},
                     outputs={"Out": lod})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False, dtype="float32", name=None):
    """One step; size = 3H (reference nn.py gru_unit contract)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    h = size // 3
    w = helper.create_parameter(helper.param_attr, shape=[h, 3 * h],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[1, 3 * h],
                                dtype=dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_h = helper.create_variable_for_type_inference(dtype)
    updated = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": input, "HiddenPrev": hidden, "Weight": w, "Bias": b}
    helper.append_op("gru_unit", inputs=ins,
                     outputs={"Gate": gate, "ResetHiddenPrev": reset_h,
                              "Hidden": updated},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation,
                            "origin_mode": origin_mode})
    return updated, reset_h, gate


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Multi-layer LSTM (reference fluid.layers.lstm -> cudnn_lstm).
    input: [B, T, D] with a lengths companion. is_bidirec unsupported."""
    if is_bidirec:
        raise NotImplementedError("bidirectional cudnn_lstm: use two "
                                  "dynamic_lstm passes (is_reverse=True)")
    helper = LayerHelper("lstm", name=name)
    in_dim = int(input.shape[-1])
    n = 0
    for layer in range(num_layers):
        d = in_dim if layer == 0 else hidden_size
        n += 4 * hidden_size * d + 4 * hidden_size * hidden_size \
            + 8 * hidden_size
    w = helper.create_parameter(None, shape=[n], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype)
    last_c = helper.create_variable_for_type_inference(input.dtype)
    lod = _make_lod_out(helper, out)
    ins = {"Input": input, "W": w, "SeqLen": seq_len_var(input)}
    if init_h is not None:
        ins["InitH"] = init_h
    if init_c is not None:
        ins["InitC"] = init_c
    helper.append_op("cudnn_lstm", inputs=ins,
                     outputs={"Out": out, "LastH": last_h, "LastC": last_c},
                     attrs={"hidden_size": int(hidden_size),
                            "num_layers": int(num_layers),
                            "dropout_prob": float(dropout_prob),
                            "is_test": is_test})
    helper.append_op("assign", inputs={"X": seq_len_var(input)},
                     outputs={"Out": lod})
    return out, last_h, last_c


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """CTC loss. input: [B, T, C] logits; label: [B, L] padded int ids.
    Lengths come from explicit args or the @LOD companions."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    in_len = input_length if input_length is not None else seq_len_var(input)
    lb_len = label_length if label_length is not None else seq_len_var(label)
    helper.append_op("warpctc",
                     inputs={"Logits": input, "Label": label,
                             "LogitsLength": in_len, "LabelLength": lb_len},
                     outputs={"Loss": loss},
                     attrs={"blank": int(blank),
                            "norm_by_times": norm_by_times})
    return loss


class DynamicRNN:
    """reference layers/control_flow.py DynamicRNN: step over a LoD input.

    Padded-encoding mapping: the loop is StaticRNN (one ``recurrent`` op)
    over the padded time axis; per-step outputs are re-masked by the sequence
    lengths, so every VALID position equals the reference's packed
    computation (invalid steps never feed back into valid ones — step t
    only consumes memory from t-1). Usage mirrors the reference:

        drnn = layers.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(emb)         # [B, T, E] lod_level-1
            prev = drnn.memory(shape=[H])
            h = layers.fc(layers.concat([w, prev], 1), H, act="tanh")
            drnn.update_memory(prev, h)
            drnn.output(h)
        hidden = drnn()                      # [B, T, H] + lengths companion
    """

    def __init__(self, name=None):
        from . import control_flow as _cf

        self._rnn = _cf.StaticRNN(name=name)
        self._lod_source = None

    def block(self):
        return self._rnn.step()

    def step_input(self, x, level=0):
        from . import nn as _nn

        if self._lod_source is None:
            self._lod_source = x
        # StaticRNN wants time-major; build the transpose OUTSIDE the block
        program = x.block.program
        cur = program.current_block_idx
        program.current_block_idx = self._rnn._parent.idx
        try:
            tm = _nn.transpose(x, [1, 0] + list(range(2, len(x.shape))))
        finally:
            program.current_block_idx = cur
        return self._rnn.step_input(tm)

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        if init is not None:
            return self._rnn.memory(init=init)
        if self._lod_source is None:
            raise ValueError("call step_input before memory(shape=...) so "
                             "the batch size is known (reference order)")
        batch_ref = self._tm_of_source()
        return self._rnn.memory(shape=shape, batch_ref=batch_ref,
                                init_value=value, dtype=dtype)

    def _tm_of_source(self):
        # the first step input is time-major with the right batch dim
        src_name = self._rnn._step_inputs[0][0]
        return self._rnn._parent._var_recursive(src_name)

    def update_memory(self, mem, new):
        self._rnn.update_memory(mem, new)

    def output(self, *outs):
        self._rnn.output(*outs)

    def __call__(self):
        from . import nn as _nn
        from .sequence import seq_len_var, sequence_unpad

        outs_tm = self._rnn()
        outs_tm = outs_tm if isinstance(outs_tm, list) else [outs_tm]
        ln = seq_len_var(self._lod_source)
        results = []
        for o in outs_tm:
            bm = _nn.transpose(o, [1, 0] + list(range(2, len(o.shape))))
            results.append(sequence_unpad(bm, ln))  # mask + @LOD companion
        return results[0] if len(results) == 1 else results


__all__.append("DynamicRNN")
