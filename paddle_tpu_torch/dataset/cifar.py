"""CIFAR-10/100 loader (reference: python/paddle/dataset/cifar.py).

Real data: place ``cifar-10-python.tar.gz`` / ``cifar-100-python.tar.gz``
under ``$DATA_HOME/cifar/``. Otherwise synthesizes class-structured images
(per-class color/template signature + noise).
Sample tuple: (image float32[3072] in [0, 1], label int64).
"""
from __future__ import annotations

import pickle
import tarfile

import numpy as np

from .common import cached_path, synthetic_notice

__all__ = ["train10", "test10", "train100", "test100"]

_N_TRAIN, _N_TEST = 4096, 512


def _synthetic(n, n_classes, seed):
    rng = np.random.RandomState(4321 + n_classes)
    tmpl = rng.rand(n_classes, 3072).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, n)
    imgs = tmpl[labels] * 0.5 + rng.rand(n, 3072).astype(np.float32) * 0.5
    return imgs.astype(np.float32), labels.astype(np.int64)


def _tar_reader(path, names, label_key):
    with tarfile.open(path, "r:gz") as tar:
        for member in tar.getmembers():
            if any(member.name.endswith(n) for n in names):
                batch = pickle.loads(tar.extractfile(member).read(),
                                     encoding="bytes")
                data = batch[b"data"].astype(np.float32) / 255.0
                labels = batch[label_key]
                for img, lbl in zip(data, labels):
                    yield img, int(lbl)


def _reader(n_classes: int, split: str):
    if n_classes == 10:
        fname, label_key = "cifar-10-python.tar.gz", b"labels"
        names = [f"data_batch_{i}" for i in range(1, 6)] \
            if split == "train" else ["test_batch"]
    else:
        fname, label_key = "cifar-100-python.tar.gz", b"fine_labels"
        names = ["train"] if split == "train" else ["test"]
    path = cached_path("cifar", fname)
    n = _N_TRAIN if split == "train" else _N_TEST
    seed = 0 if split == "train" else 1

    def reader():
        if path:
            yield from _tar_reader(path, names, label_key)
        else:
            synthetic_notice(f"cifar{n_classes}")
            imgs, labels = _synthetic(n, n_classes, seed)
            for i in range(n):
                yield imgs[i], int(labels[i])

    return reader


def train10():
    return _reader(10, "train")


def test10():
    return _reader(10, "test")


def train100():
    return _reader(100, "train")


def test100():
    return _reader(100, "test")
