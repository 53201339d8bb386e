"""DeepFM CTR model (counterpart of ``paddle_tpu/models/deepfm.py``;
Guo et al., "DeepFM: A Factorization-Machine based Neural Network for
CTR Prediction", IJCAI 2017, as in the public PaddleRec deepfm config).

Two embedding tables over the hashed feature ids: ``fm_w`` [vocab, 1]
(first order) and ``fm_v`` [vocab, emb_dim] (the factors, shared by the
second-order term and the MLP). With ``sharded`` (the default) both are
``is_distributed`` tables, so their grads are SelectedRows sized by the
batch's lookups (``core.selected_rows``) and the update ops touch the
rows the batch read; on one card the tag shards nothing.

Model: y = sigmoid(first_order + second_order + dnn).
 - first_order: sum_f w[x_f]                    (w: [vocab, 1] table)
 - second_order: 0.5 * ((sum_f v_f)^2 - sum_f v_f^2) summed over k
 - dnn: an MLP with relu over the concatenated field embeddings
"""
from __future__ import annotations

from .. import layers, optimizer as opt_mod
from ..framework import Program, program_guard
from ..param_attr import ParamAttr

__all__ = ["build_deepfm"]


def build_deepfm(vocab=1024, num_fields=8, emb_dim=8, hidden=(32, 32),
                 lr=1e-3, sharded=True, optimizer="adam"):
    """Feeds: feat_ids int64 [batch, num_fields], label float32 [batch, 1]."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ids = layers.data("feat_ids", shape=[num_fields], dtype="int64")
        label = layers.data("label", shape=[1], dtype="float32")

        first = layers.embedding(ids, size=[vocab, 1],
                                 is_distributed=sharded,
                                 param_attr=ParamAttr(name="fm_w"))  # [B,F,1]
        first_order = layers.reshape(
            layers.reduce_sum(first, dim=[1, 2]), [-1, 1])         # [B,1]

        emb = layers.embedding(ids, size=[vocab, emb_dim],
                               is_distributed=sharded,
                               param_attr=ParamAttr(name="fm_v"))  # [B,F,K]
        sum_v = layers.reduce_sum(emb, dim=[1])                    # [B,K]
        sum_sq = layers.square(sum_v)
        sq_sum = layers.reduce_sum(layers.square(emb), dim=[1])
        second_order = layers.scale(
            layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum),
                              dim=[1], keep_dim=True), scale=0.5)  # [B,1]

        h = layers.reshape(emb, [-1, int(num_fields * emb_dim)])
        for i, width in enumerate(hidden):
            h = layers.fc(h, width, act="relu", name=f"deep_fc{i}")
        dnn_out = layers.fc(h, 1, name="deep_out")                 # [B,1]

        logit = layers.elementwise_add(
            layers.elementwise_add(first_order, second_order), dnn_out)
        loss = layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit, label))
        pred = layers.sigmoid(logit)
        if optimizer == "adam":
            opt = opt_mod.Adam(learning_rate=lr)
        else:
            opt = opt_mod.SGD(learning_rate=lr)
        opt.minimize(loss)
    return {"main": main, "startup": startup, "loss": loss, "pred": pred,
            "feeds": ["feat_ids", "label"]}
