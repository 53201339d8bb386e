"""Flowers-102 loader (reference: python/paddle/dataset/flowers.py).

Real data: place ``102flowers.tgz`` + ``imagelabels.mat`` + ``setid.mat``
under ``$DATA_HOME/flowers/``. Otherwise synthesizes class-structured
images: each of the 102 classes carries a fixed color/texture template.
Sample tuple: (image float32[3*224*224] in [0, 1], label int64 in [0, 102)).
"""
from __future__ import annotations

import numpy as np

from .common import synthetic_notice

__all__ = ["train", "test", "valid"]

_N_CLASSES = 102
_DIM = 3 * 224 * 224
_N_TRAIN, _N_TEST, _N_VALID = 2048, 256, 256


def _templates():
    rng = np.random.RandomState(777)
    # low-res template upsampled: keeps the synthetic file small in memory
    small = rng.rand(_N_CLASSES, 3, 16, 16).astype(np.float32)
    return small


def _reader(n, seed):
    def read():
        synthetic_notice("flowers")
        tmpl = _templates()
        rng = np.random.RandomState(seed)
        for _ in range(n):
            lb = int(rng.randint(0, _N_CLASSES))
            img = np.kron(tmpl[lb], np.ones((1, 14, 14), np.float32))
            img = np.clip(img * 0.7 + 0.3 * rng.rand(3, 224, 224), 0, 1)
            yield img.reshape(-1).astype(np.float32), np.int64(lb)
    return read


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(_N_TRAIN, 0)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(_N_TEST, 1)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(_N_VALID, 2)
