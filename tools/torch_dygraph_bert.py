"""BERT pretraining in the port's dygraph mode.

The model of ``paddle_tpu_torch/models/bert.py`` built from
``dygraph.nn`` layers and ``dygraph.ops``, op for op: the same embeddings,
layer norms, projections (``mul`` with ``x_num_col_dims`` and a bias
``elementwise_add`` on that axis, as ``layers.fc`` appends them),
``fused_multihead_attention`` (K1 forward, K3 and K4 backward on the
card), dropouts, heads and losses, with the same attributes. Its
parameters load from the static program's scope by name
(:func:`load_static`), so one weight set runs both ways.

    from paddle_tpu_torch import dygraph
    with dygraph.guard(place):
        model = DygraphBert(cfg)
        load_static(model, program, scope.vars)
        loss, mlm_loss, nsp_loss = model(to_feed(batch))

The card's ``dygraph`` phase of ``chip_smoke.py`` and the CPU tests
(``tests/test_torch_dygraph.py``) both use it.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch import dygraph
from paddle_tpu_torch.dygraph import ops

__all__ = ["Dense", "EncoderLayer", "DygraphBert", "load_static", "to_feed",
           "FEEDS"]

FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask", "mask_label",
         "next_sent_label")


class Dense(dygraph.Layer):
    """``layers.fc(x, size, num_flatten_dims=k, act=act)``: the ``mul`` of
    the trailing dims, the bias added on axis ``k``, the activation."""

    def __init__(self, in_dim, size, act=None, num_flatten_dims=2):
        super().__init__("fc")
        self.weight = self.create_parameter([in_dim, size])
        self.bias = self.create_parameter([size], is_bias=True)
        self._k = num_flatten_dims
        self._act = act

    def forward(self, x):
        out = ops.mul(x, self.weight, x_num_col_dims=self._k,
                      y_num_col_dims=1)
        out = ops.elementwise_add(out, self.bias, axis=self._k)
        return getattr(ops, self._act)(out) if self._act else out


class EncoderLayer(dygraph.Layer):
    """``models.bert._encoder_layer``: attention, dropout, residual and
    layer norm; the GELU FFN, dropout, residual and layer norm."""

    def __init__(self, cfg):
        super().__init__("encoder_layer")
        h = cfg.hidden_size
        self._cfg = cfg
        self.q, self.k, self.v = Dense(h, h), Dense(h, h), Dense(h, h)
        self.out = Dense(h, h)
        self.ln1 = dygraph.LayerNorm(h)
        self.ffn1 = Dense(h, cfg.intermediate_size, act="gelu")
        self.ffn2 = Dense(cfg.intermediate_size, h)
        self.ln2 = dygraph.LayerNorm(h)

    def _dropout(self, x, rate):
        return ops.dropout(x, dropout_prob=rate, is_test=not self.training,
                           dropout_implementation="upscale_in_train")[0]

    def forward(self, x, mask):
        cfg = self._cfg
        S, H = x.shape[1], cfg.hidden_size
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads

        def split_heads(t):                      # [B,S,H] -> [B,nh,S,hd]
            return ops.transpose(ops.reshape(t, shape=[0, S, nh, hd]),
                                 axis=[0, 2, 1, 3])

        q, k, v = (split_heads(f(x)) for f in (self.q, self.k, self.v))
        ctxv = ops.fused_multihead_attention(
            q, k, v, mask, causal=False, scale=1.0 / math.sqrt(hd),
            attn_dropout=cfg.attention_dropout, is_test=not self.training)
        ctxv = ops.reshape(ops.transpose(ctxv, axis=[0, 2, 1, 3]),
                           shape=[0, S, H])
        att = self._dropout(self.out(ctxv), cfg.hidden_dropout)
        x = self.ln1(ops.elementwise_add(x, att))
        ffn = self._dropout(self.ffn2(self.ffn1(x)), cfg.hidden_dropout)
        return self.ln2(ops.elementwise_add(x, ffn))


class DygraphBert(dygraph.Layer):
    """``models.bert.build_bert_pretrain``'s forward and losses, eager.
    ``forward(feed)`` takes the six feeds as VarBases (:func:`to_feed`)
    and returns ``(loss, mlm_loss, nsp_loss)``."""

    def __init__(self, cfg):
        super().__init__("bert")
        h = cfg.hidden_size
        self._cfg = cfg
        self.word = dygraph.Embedding([cfg.vocab_size, h])
        self.pos = dygraph.Embedding([cfg.max_position, h])
        self.sent = dygraph.Embedding([cfg.type_vocab_size, h])
        self.emb_ln = dygraph.LayerNorm(h)
        self.layers = []
        for i in range(cfg.num_layers):
            layer = EncoderLayer(cfg)
            self.add_sublayer(f"layer{i}", layer)
            self.layers.append(layer)
        self.mlm_trans = Dense(h, h, act="gelu")
        self.mlm_ln = dygraph.LayerNorm(h)
        self.pooler = Dense(h, h, act="tanh", num_flatten_dims=1)
        self.nsp = Dense(h, 2, num_flatten_dims=1)

    def forward(self, feed):
        cfg = self._cfg
        x = ops.elementwise_add(self.word(feed["src_ids"]),
                                self.pos(feed["pos_ids"]))
        x = ops.elementwise_add(x, self.sent(feed["sent_ids"]))
        x = ops.dropout(self.emb_ln(x), dropout_prob=cfg.hidden_dropout,
                        is_test=not self.training,
                        dropout_implementation="upscale_in_train")[0]
        # additive attention mask [B,1,1,S]: (mask-1)*10000
        m = ops.scale(feed["input_mask"], scale=10000.0, bias=-10000.0)
        m = ops.unsqueeze(m, axes=[1, 2])
        for layer in self.layers:
            x = layer(x, m)

        # masked LM head: vocab logits tied to the word embedding,
        # ignore_index=-100, mean over the masked tokens
        mlm = self.mlm_ln(self.mlm_trans(x))
        logits = ops.matmul(mlm, self.word.weight, transpose_X=False,
                            transpose_Y=True, alpha=1.0)
        label = ops.unsqueeze(feed["mask_label"], axes=[2])
        _, mlm_loss = ops.softmax_with_cross_entropy(logits, label,
                                                     ignore_index=-100)
        is_masked = ops.cast(
            ops.not_equal(ops.unsqueeze(feed["mask_label"], axes=[2]),
                          ops.fill_constant(shape=[1], dtype="int64",
                                            value=-100.0)),
            in_dtype="bool", out_dtype="float32")
        denom = ops.elementwise_max(
            ops.reduce_sum(is_masked, dim=[0], keep_dim=False,
                           reduce_all=True),
            ops.fill_constant(shape=[1], dtype="float32", value=1.0))
        mlm_loss = ops.elementwise_div(
            ops.reduce_sum(mlm_loss, dim=[0], keep_dim=False,
                           reduce_all=True), denom)

        # next-sentence head on [CLS]
        cls = ops.slice(x, axes=[1], starts=[0], ends=[1], decrease_axis=[])
        cls = ops.reshape(cls, shape=[0, cfg.hidden_size])
        _, nsp_loss = ops.softmax_with_cross_entropy(
            self.nsp(self.pooler(cls)), feed["next_sent_label"])
        nsp_loss = ops.mean(nsp_loss)
        return ops.elementwise_add(mlm_loss, nsp_loss), mlm_loss, nsp_loss

    def static_names(self, program):
        """{dygraph parameter name: the static program's var name}. The
        layer norms' names are generated (``layer_norm_<n>.w_0``), in the
        order ``build_bert_pretrain`` appends them: the embeddings', two a
        layer, the MLM head's."""
        ln = [(op.input("Scale")[0], op.input("Bias")[0])
              for op in program.global_block.ops if op.type == "layer_norm"]
        names = {"word.weight": "word_embedding",
                 "pos.weight": "pos_embedding",
                 "sent.weight": "sent_embedding"}
        norms = ["emb_ln"]
        for i in range(len(self.layers)):
            pre = f"layer{i}"
            for d in ("q", "k", "v", "out", "ffn1", "ffn2"):
                static = f"{pre}_att_{d}" if d in ("q", "k", "v", "out") \
                    else f"{pre}_{d}"
                names[f"{pre}.{d}.weight"] = static + "_w"
                names[f"{pre}.{d}.bias"] = static + "_b"
            norms += [f"{pre}.ln1", f"{pre}.ln2"]
        norms.append("mlm_ln")
        for d, static in (("mlm_trans", "mlm_trans"), ("pooler", "pooler"),
                          ("nsp", "nsp")):
            names[f"{d}.weight"] = static + "_w"
            names[f"{d}.bias"] = static + "_b"
        if len(ln) != len(norms):
            raise ValueError(f"the static program has {len(ln)} layer "
                             f"norms, the dygraph model {len(norms)}")
        for layer, (w, b) in zip(norms, ln):
            names[f"{layer}.weight"], names[f"{layer}.bias"] = w, b
        return names


def load_static(model, program, values):
    """Set every parameter of ``model`` from ``values`` (a static scope's
    ``vars``: tensors or arrays by the static names), each a copy on the
    guard's device."""
    names = model.static_names(program)
    own = dict(model.named_parameters())
    if set(own) != set(names):
        raise ValueError(f"unmapped parameters: "
                         f"{sorted(set(own) ^ set(names))}")
    for n, p in own.items():
        v = values[names[n]]
        t = v.detach().clone() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(v).clone()
        if tuple(t.shape) != p.shape:
            raise ValueError(f"{n} ({names[n]}): static {tuple(t.shape)} "
                             f"!= {p.shape}")
        p.set_value(t)


def to_feed(batch):
    """The six numpy feeds as VarBases on the guard's device."""
    return {n: dygraph.to_variable(batch[n]) for n in FEEDS}
