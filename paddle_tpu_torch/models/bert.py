"""BERT pretraining (counterpart of ``paddle_tpu/models/bert.py``).

A transformer encoder with learned position embeddings, the masked-LM and
next-sentence losses and Adam, built from the same layers with the same
parameter names, so the port's programs have the JAX package's ops, vars
and attrs and parameters carry across by name
(``interop.scope_from_numpy``). Attention is the
``fused_multihead_attention`` op: the flash-attention kernels K1 (forward,
with in-kernel dropout) and K3/K4 (backward) on the card. Under AMP the
q/k/v products run in bf16 and their float32 biases promote the result
back, so attention takes float32 Q/K/V, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

from .. import layers
from ..framework import Program, default_main_program, program_guard
from ..initializer import TruncatedNormal
from ..optimizer import Adam
from ..param_attr import ParamAttr

__all__ = ["BertConfig", "bert_pretrain_net", "build_bert_pretrain"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=2, intermediate_size=512, max_position=128)


def _attr(name: str, cfg: BertConfig):
    return ParamAttr(name=name,
                     initializer=TruncatedNormal(0.0, cfg.initializer_range))


def _attention(x, mask, cfg: BertConfig, prefix: str, is_test: bool = False):
    """Multi-head self-attention through ``fused_multihead_attention``.
    x: [B, S, H]; mask: [B, 1, 1, S] additive (-10000 on pads)."""
    S, H = x.shape[1], cfg.hidden_size
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads

    def proj(name):
        return layers.fc(x, H, num_flatten_dims=2,
                         param_attr=_attr(f"{prefix}_{name}_w", cfg),
                         bias_attr=ParamAttr(name=f"{prefix}_{name}_b"))

    def split_heads(t):                          # [B,S,H] -> [B,nh,S,hd]
        t = layers.reshape(t, [0, S, nh, hd])
        return layers.transpose(t, [0, 2, 1, 3])

    q, k, v = proj("q"), proj("k"), proj("v")
    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    ctxv = layers.fused_multihead_attention(
        q, k, v, bias_qk=mask, scale=1.0 / math.sqrt(hd),
        attn_dropout=cfg.attention_dropout, is_test=is_test)
    ctxv = layers.transpose(ctxv, [0, 2, 1, 3])
    ctxv = layers.reshape(ctxv, [0, S, H])
    return layers.fc(ctxv, H, num_flatten_dims=2,
                     param_attr=_attr(f"{prefix}_out_w", cfg),
                     bias_attr=ParamAttr(name=f"{prefix}_out_b"))


def _encoder_layer(x, mask, cfg: BertConfig, prefix: str,
                   is_test: bool = False):
    att = _attention(x, mask, cfg, prefix + "_att", is_test=is_test)
    att = layers.dropout(att, cfg.hidden_dropout, is_test=is_test,
                         dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(x, att), begin_norm_axis=2)
    ffn = layers.fc(x, cfg.intermediate_size, num_flatten_dims=2, act="gelu",
                    param_attr=_attr(f"{prefix}_ffn1_w", cfg),
                    bias_attr=ParamAttr(name=f"{prefix}_ffn1_b"))
    ffn = layers.fc(ffn, cfg.hidden_size, num_flatten_dims=2,
                    param_attr=_attr(f"{prefix}_ffn2_w", cfg),
                    bias_attr=ParamAttr(name=f"{prefix}_ffn2_b"))
    ffn = layers.dropout(ffn, cfg.hidden_dropout, is_test=is_test,
                         dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, ffn),
                             begin_norm_axis=2)


def bert_pretrain_net(cfg: BertConfig, seq_len: int = 128,
                      is_test: bool = False):
    """The pretraining network in the current default programs (a
    ``contrib.Trainer`` train_func builds it under the trainer's own):
    the data layers, the encoder and both heads. Returns the loss vars
    ``loss``, ``mlm_loss`` and ``nsp_loss``."""
    main = default_main_program()
    src = layers.data("src_ids", shape=[seq_len], dtype="int64")
    pos = layers.data("pos_ids", shape=[seq_len], dtype="int64")
    sent = layers.data("sent_ids", shape=[seq_len], dtype="int64")
    input_mask = layers.data("input_mask", shape=[seq_len],
                             dtype="float32")
    mask_label = layers.data("mask_label", shape=[seq_len], dtype="int64")
    nsp_label = layers.data("next_sent_label", shape=[1], dtype="int64")

    x = layers.embedding(src, (cfg.vocab_size, cfg.hidden_size),
                         param_attr=_attr("word_embedding", cfg))
    x = layers.elementwise_add(
        x, layers.embedding(pos, (cfg.max_position, cfg.hidden_size),
                            param_attr=_attr("pos_embedding", cfg)))
    x = layers.elementwise_add(
        x, layers.embedding(sent, (cfg.type_vocab_size, cfg.hidden_size),
                            param_attr=_attr("sent_embedding", cfg)))
    x = layers.layer_norm(x, begin_norm_axis=2)
    x = layers.dropout(x, cfg.hidden_dropout, is_test=is_test,
                       dropout_implementation="upscale_in_train")

    # additive attention mask [B,1,1,S]: (mask-1)*10000
    m = layers.scale(input_mask, scale=10000.0, bias=-10000.0)
    m = layers.unsqueeze(m, [1, 2])

    for i in range(cfg.num_layers):
        x = _encoder_layer(x, m, cfg, f"layer{i}", is_test=is_test)

    # masked LM head: full-sequence vocab logits, tied to the word
    # embedding, ignore_index=-100
    mlm = layers.fc(x, cfg.hidden_size, num_flatten_dims=2, act="gelu",
                    param_attr=_attr("mlm_trans_w", cfg),
                    bias_attr=ParamAttr(name="mlm_trans_b"))
    mlm = layers.layer_norm(mlm, begin_norm_axis=2)
    word_emb = main.global_block.var("word_embedding")
    vocab_logits = layers.matmul(mlm, word_emb, transpose_y=True)
    mlm_loss = layers.softmax_with_cross_entropy(
        vocab_logits, layers.unsqueeze(mask_label, [2]),
        ignore_index=-100)
    # mean over the masked tokens; the count is a label statistic,
    # fenced from the backward pass
    is_masked = layers.cast(
        layers.not_equal(layers.unsqueeze(mask_label, [2]),
                         layers.fill_constant([1], "int64", -100)),
        "float32")
    is_masked.stop_gradient = True
    masked_count = layers.reduce_sum(is_masked)
    masked_count.stop_gradient = True
    denom = layers.elementwise_max(
        masked_count, layers.fill_constant([1], "float32", 1.0))
    denom.stop_gradient = True
    mlm_loss = layers.elementwise_div(layers.reduce_sum(mlm_loss), denom)

    # next-sentence head on [CLS]
    cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, [0, cfg.hidden_size])
    pooled = layers.fc(cls, cfg.hidden_size, act="tanh",
                       param_attr=_attr("pooler_w", cfg),
                       bias_attr=ParamAttr(name="pooler_b"))
    nsp_logits = layers.fc(pooled, 2, param_attr=_attr("nsp_w", cfg),
                           bias_attr=ParamAttr(name="nsp_b"))
    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(nsp_logits, nsp_label))

    loss = layers.elementwise_add(mlm_loss, nsp_loss)
    return {"loss": loss, "mlm_loss": mlm_loss, "nsp_loss": nsp_loss}


def build_bert_pretrain(cfg: BertConfig = None, seq_len: int = 128,
                        lr: float = 1e-4, build_optimizer: bool = True,
                        is_test: bool = False, amp: bool = False):
    """The pretraining programs. Feeds: src_ids/pos_ids/sent_ids/input_mask
    [B, S], mask_label [B, S] (-100 on unmasked positions),
    next_sent_label [B, 1]. With ``amp`` the optimizer is wrapped in
    ``contrib.mixed_precision.decorate``: bf16 products, float32 master
    weights, no loss scaling. Returns main, startup, the loss vars and
    the feed names."""
    cfg = cfg or BertConfig.base()
    main, startup = Program(), Program()
    with program_guard(main, startup):
        net = bert_pretrain_net(cfg, seq_len, is_test)
        loss = net["loss"]
        if build_optimizer:
            opt = Adam(learning_rate=lr)
            if amp:
                from ..contrib import mixed_precision

                opt = mixed_precision.decorate(opt)
            opt.minimize(loss)
    return {"main": main, "startup": startup, **net,
            "feeds": ("src_ids", "pos_ids", "sent_ids", "input_mask",
                      "mask_label", "next_sent_label")}
