"""UCI housing loader (reference: python/paddle/dataset/uci_housing.py).

Real data: place ``housing.data`` under ``$DATA_HOME/uci_housing/``.
Otherwise synthesizes a linear-plus-noise regression with 13 features, so
fit_a_line converges exactly as the book test expects.
Sample tuple: (features float32[13], price float32[1]).
"""
from __future__ import annotations

import numpy as np

from .common import cached_path, synthetic_notice

__all__ = ["train", "test"]

_N_TRAIN, _N_TEST = 404, 102  # real split sizes

_TRUE_W = np.array([0.8, -1.2, 0.5, 2.0, -0.7, 1.5, 0.1, -0.4, 0.9, -1.1,
                    0.3, 0.6, -2.0], np.float32)


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 13).astype(np.float32)
    ys = xs @ _TRUE_W + 3.0 + rng.randn(n).astype(np.float32) * 0.1
    return xs, ys.reshape(-1, 1).astype(np.float32)


def _load_real(path):
    raw = np.loadtxt(path).astype(np.float32)
    feats, prices = raw[:, :-1], raw[:, -1:]
    # reference normalizes features to zero-mean unit-ish range
    feats = (feats - feats.mean(0)) / (feats.max(0) - feats.min(0) + 1e-8)
    return feats, prices


def _reader(split: str):
    path = cached_path("uci_housing", "housing.data")
    n = _N_TRAIN if split == "train" else _N_TEST
    seed = 0 if split == "train" else 1

    def reader():
        if path:
            feats, prices = _load_real(path)
            lo, hi = (0, _N_TRAIN) if split == "train" \
                else (_N_TRAIN, _N_TRAIN + _N_TEST)
            feats, prices = feats[lo:hi], prices[lo:hi]
        else:
            synthetic_notice("uci_housing")
            feats, prices = _synthetic(n, seed)
        for i in range(len(feats)):
            yield feats[i], prices[i]

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
