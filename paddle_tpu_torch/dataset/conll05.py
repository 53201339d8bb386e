"""CoNLL-2005 SRL loader (reference: python/paddle/dataset/conll05.py).

Real data: place ``conll05st-tests.tar.gz`` extracts under
``$DATA_HOME/conll05/``. Otherwise synthesizes a learnable SRL-shaped task:
words near the predicate get argument tags by a fixed positional+lexical
rule (word class + distance to predicate decide the IOB tag), so an
embedding + LSTM + CRF pipeline genuinely learns structure.

Sample tuple (simplified from the reference's 9-slot sample; the book model
consumes these): (word_ids int64[T], predicate_id int64, mark int64[T]
— 1 at predicate positions, label_ids int64[T] IOB over
``num_chunk_types`` argument types + O).
"""
from __future__ import annotations

import numpy as np

from .common import synthetic_notice

__all__ = ["train", "test", "get_dict", "get_embedding", "word_dict_len",
           "label_dict_len", "predicate_dict_len", "num_chunk_types"]

_VOCAB, _N_PRED, _N_TYPES = 800, 64, 3
_MIN_LEN, _MAX_LEN = 5, 12
_N_TRAIN, _N_TEST = 16384, 512


def word_dict_len():
    return _VOCAB


def predicate_dict_len():
    return _N_PRED


def num_chunk_types():
    return _N_TYPES


def label_dict_len():
    # IOB: B/I per type + O
    return 2 * _N_TYPES + 1


def get_dict():
    wd = {f"w{i}": i for i in range(_VOCAB)}
    vd = {f"v{i}": i for i in range(_N_PRED)}
    ld = {f"l{i}": i for i in range(label_dict_len())}
    return wd, vd, ld


def get_embedding():
    rng = np.random.RandomState(5)
    return rng.randn(_VOCAB, 32).astype(np.float32)


def _label_rule(words, pred_pos):
    """B-type at the word RIGHT BEFORE/AFTER the predicate when the word's
    class (word_id mod (types+1)) is a type; I-type continues while the
    class repeats; O elsewhere. Deterministic + position-sensitive."""
    t = len(words)
    labels = np.full(t, 2 * _N_TYPES, np.int64)           # O
    for pos in (pred_pos - 1, pred_pos + 1):
        if 0 <= pos < t:
            cls = int(words[pos]) % (_N_TYPES + 1)
            if cls < _N_TYPES:
                labels[pos] = 2 * cls                      # B-cls
                q = pos + 1
                while q < t and int(words[q]) % (_N_TYPES + 1) == cls \
                        and q != pred_pos:
                    labels[q] = 2 * cls + 1                # I-cls
                    q += 1
    return labels


def _reader(n, seed):
    def read():
        synthetic_notice("conll05")
        rng = np.random.RandomState(seed)
        for _ in range(n):
            t = int(rng.randint(_MIN_LEN, _MAX_LEN + 1))
            words = rng.randint(0, _VOCAB, t).astype(np.int64)
            pred_pos = int(rng.randint(0, t))
            predicate = np.int64(int(words[pred_pos]) % _N_PRED)
            mark = np.zeros(t, np.int64)
            mark[pred_pos] = 1
            labels = _label_rule(words, pred_pos)
            yield words, predicate, mark, labels
    return read


def train():
    return _reader(_N_TRAIN, 0)


def test():
    return _reader(_N_TEST, 1)
