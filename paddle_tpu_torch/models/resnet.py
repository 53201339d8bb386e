"""ResNet for ImageNet (counterpart of ``paddle_tpu/models/resnet.py``;
reference analogue: the ResNet-50 of Paddle's fp16 benchmarks). Built
from conv2d/batch_norm/pool2d layers in logical NCHW; the convolutions'
memory format follows ``FLAGS_conv_use_nhwc``. Momentum, optionally
wrapped in ``contrib.mixed_precision.decorate`` (``amp=True``)."""
from __future__ import annotations

from .. import layers, optimizer as opt_mod
from ..framework import Program, program_guard

__all__ = ["build_resnet", "resnet_forward"]

_DEPTH_CFG = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv_bn(x, filters, ksize, stride=1, act=None, is_test=False):
    c = layers.conv2d(x, filters, ksize, stride=stride,
                      padding=(ksize - 1) // 2, bias_attr=False)
    return layers.batch_norm(c, act=act, is_test=is_test)


def _bottleneck(x, filters, stride, is_test):
    c = _conv_bn(x, filters, 1, act="relu", is_test=is_test)
    c = _conv_bn(c, filters, 3, stride=stride, act="relu", is_test=is_test)
    c = _conv_bn(c, filters * 4, 1, is_test=is_test)
    if x.shape[1] != filters * 4 or stride != 1:
        x = _conv_bn(x, filters * 4, 1, stride=stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(c, x))


def _basic(x, filters, stride, is_test):
    c = _conv_bn(x, filters, 3, stride=stride, act="relu", is_test=is_test)
    c = _conv_bn(c, filters, 3, is_test=is_test)
    if x.shape[1] != filters or stride != 1:
        x = _conv_bn(x, filters, 1, stride=stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(c, x))


def resnet_forward(depth=50, class_num=1000, image_shape=(3, 224, 224),
                   is_test=False, with_label=True):
    """The network of ``build_resnet`` in the current programs (a
    ``contrib.Trainer``'s ``train_func`` or an ``Inferencer``'s
    ``infer_func`` calls it): the ``img`` (and ``label``) data, the
    logits and, with the label, the mean softmax cross-entropy and top-1
    accuracy. ``is_test`` builds batch_norm on its running statistics."""
    block_fn_name, counts = _DEPTH_CFG[depth]
    block_fn = _bottleneck if block_fn_name == "bottleneck" else _basic
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64") \
        if with_label else None
    x = _conv_bn(img, 64, 7, stride=2, act="relu", is_test=is_test)
    x = layers.pool2d(x, 3, "max", pool_stride=2, pool_padding=1)
    for stage, n in enumerate(counts):
        filters = 64 * (2 ** stage)
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = block_fn(x, filters, stride, is_test)
    x = layers.pool2d(x, 1, "avg", global_pooling=True)
    logits = layers.fc(x, class_num)
    net = {"img": img, "label": label, "logits": logits}
    if with_label:
        net["loss"] = layers.mean(
            layers.softmax_with_cross_entropy(logits, label))
        net["acc"] = layers.accuracy(logits, label)
    return net


def build_resnet(depth=50, class_num=1000, image_shape=(3, 224, 224),
                 lr=0.1, momentum=0.9, build_optimizer=True, amp=False):
    """The train program (softmax cross-entropy, top-1 accuracy, Momentum)
    of a ResNet of ``depth`` 18, 34, 50, 101 or 152."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        net = resnet_forward(depth, class_num, image_shape)
        loss = net["loss"]
        if build_optimizer:
            opt = opt_mod.Momentum(learning_rate=lr, momentum=momentum)
            if amp:
                from ..contrib import mixed_precision as _mp

                opt = _mp.decorate(opt)
            opt.minimize(loss)
    return {"main": main, "startup": startup, "loss": loss,
            "acc": net["acc"], "feeds": ("img", "label"),
            "logits": net["logits"]}
