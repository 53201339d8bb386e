"""WMT16 translation loader (reference: python/paddle/dataset/wmt16.py).

Real data: place ``wmt16.tar.gz`` extracts under ``$DATA_HOME/wmt16/``.
Otherwise synthesizes a learnable toy translation shaped for
ATTENTION-FREE encoder-decoders (book/test_rnn_encoder_decoder.py): the
target is a Markov chain seeded by the source's first word — trg[0] =
m(src[0]), trg[i] = m(trg[i-1]) — so teacher-forced prediction is
deterministic given the previous target token (plus the encoder summary
for the first step) and perplexity genuinely collapses.

Sample tuple (reference wmt16 reader contract):
(src_ids int64[S], trg_ids int64[T] starting with BOS,
 trg_next_ids int64[T] ending with EOS — trg shifted by one).
"""
from __future__ import annotations

import numpy as np

from .common import synthetic_notice

__all__ = ["train", "test", "get_dict"]

_VOCAB = 130          # includes specials
BOS, EOS, UNK = 0, 1, 2
_MIN_LEN, _MAX_LEN = 3, 8
_N_TRAIN, _N_TEST = 8192, 512


def get_dict(lang="en", dict_size=_VOCAB, reverse=False):
    d = {f"{lang}_{i}": i for i in range(dict_size)}
    return {v: k for k, v in d.items()} if reverse else d


def _mapping():
    rng = np.random.RandomState(99)
    m = rng.permutation(_VOCAB - 3) + 3      # specials map to themselves
    return m


def _reader(n, seed):
    def read():
        synthetic_notice("wmt16")
        m = _mapping()
        rng = np.random.RandomState(seed)
        for _ in range(n):
            s = int(rng.randint(_MIN_LEN, _MAX_LEN + 1))
            src = rng.randint(3, _VOCAB, s).astype(np.int64)
            trg_full = np.empty(s, np.int64)
            cur = int(src[0])
            for i in range(s):
                cur = int(m[cur - 3])
                trg_full[i] = cur
            trg = np.concatenate([[BOS], trg_full])
            trg_next = np.concatenate([trg_full, [EOS]])
            yield src, trg, trg_next
    return read


def train(src_dict_size=_VOCAB, trg_dict_size=_VOCAB, src_lang="en"):
    return _reader(_N_TRAIN, 0)


def test(src_dict_size=_VOCAB, trg_dict_size=_VOCAB, src_lang="en"):
    return _reader(_N_TEST, 1)
