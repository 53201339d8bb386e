"""NLTK movie-review sentiment loader (reference:
python/paddle/dataset/sentiment.py).

Real data: place the ``movie_reviews`` corpus under
``$DATA_HOME/sentiment/``. Otherwise synthesizes polarity-bearing word
sequences: positive/negative vocab halves with mixing noise, so a
bag-of-words classifier genuinely learns.
Sample tuple: (word_ids int64[T] (T varies 8..40), label int64 {0, 1}).
"""
from __future__ import annotations

import numpy as np

from .common import synthetic_notice

__all__ = ["train", "test", "get_word_dict"]

_VOCAB = 5000
_N_TRAIN, _N_TEST = 4096, 512


def get_word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _reader(n, seed):
    def read():
        synthetic_notice("sentiment")
        rng = np.random.RandomState(seed)
        half = _VOCAB // 2
        for _ in range(n):
            label = int(rng.randint(0, 2))
            t = int(rng.randint(8, 41))
            polar = rng.randint(label * half, label * half + half, t)
            noise = rng.randint(0, _VOCAB, t)
            keep = rng.rand(t) < 0.7
            words = np.where(keep, polar, noise)
            yield words.astype(np.int64), np.int64(label)
    return read


def train():
    return _reader(_N_TRAIN, 0)


def test():
    return _reader(_N_TEST, 1)
