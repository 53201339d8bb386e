"""MNIST MLP (counterpart of ``paddle_tpu/models/mlp.py``; reference
book/test_recognize_digits.py): fc layers with relu, softmax
cross-entropy, top-1 accuracy, SGD or Adam."""
from __future__ import annotations

from .. import layers, optimizer as opt_mod
from ..framework import Program, program_guard

__all__ = ["build_mnist_mlp"]


def build_mnist_mlp(hidden=(200, 200), lr=0.01, optimizer="sgd"):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", shape=[784], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = img
        for width in hidden:
            h = layers.fc(h, width, act="relu")
        logits = layers.fc(h, 10)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(logits, label)
        if optimizer == "sgd":
            opt = opt_mod.SGD(learning_rate=lr)
        else:
            opt = opt_mod.Adam(learning_rate=lr)
        opt.minimize(loss)
    return {"main": main, "startup": startup, "loss": loss, "acc": acc,
            "feeds": ("img", "label"), "logits": logits}
