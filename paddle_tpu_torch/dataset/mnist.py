"""MNIST loader (reference: python/paddle/dataset/mnist.py:1).

Real data: place ``train-images-idx3-ubyte.gz`` etc. under
``$DATA_HOME/mnist/``. Otherwise synthesizes class-structured digits: each
class k has a fixed template blob; samples are the template + noise, so a
small MLP genuinely learns (accuracy >> chance), unlike pure-noise data.
Sample tuple: (image float32[784] in [-1, 1], label int64).
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

from .common import cached_path, synthetic_notice

__all__ = ["train", "test"]

_N_TRAIN, _N_TEST = 8192, 1024


def _templates():
    rng = np.random.RandomState(1234)
    return rng.rand(10, 784).astype(np.float32) * 2 - 1


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    tmpl = _templates()
    labels = rng.randint(0, 10, n)
    imgs = tmpl[labels] * 0.6 + rng.randn(n, 784).astype(np.float32) * 0.35
    return np.clip(imgs, -1, 1).astype(np.float32), labels.astype(np.int64)


def _read_idx(img_path, lbl_path):
    with gzip.open(img_path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with gzip.open(lbl_path, "rb") as f:
        _, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    imgs = imgs.astype(np.float32) / 255.0 * 2.0 - 1.0
    return imgs, labels.astype(np.int64)


def _reader(split: str):
    if split == "train":
        files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
        n, seed = _N_TRAIN, 0
    else:
        files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")
        n, seed = _N_TEST, 1
    img_p, lbl_p = cached_path("mnist", files[0]), cached_path("mnist",
                                                               files[1])

    def reader():
        if img_p and lbl_p:
            imgs, labels = _read_idx(img_p, lbl_p)
        else:
            synthetic_notice("mnist")
            imgs, labels = _synthetic(n, seed)
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
