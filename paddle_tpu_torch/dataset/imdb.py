"""IMDB sentiment loader (reference: python/paddle/dataset/imdb.py).

Real data: place ``aclImdb_v1.tar.gz`` under ``$DATA_HOME/imdb/`` — the word
dict is then built from the real train corpus by frequency (the reference's
``build_dict(pattern, cutoff=150)``). Otherwise synthesizes a sentiment task
with a planted signal: a vocab where word ids below ``_POS_BAND`` lean
positive and ids above lean negative; documents are sampled from the matching
band, so bag-of-words / embedding models genuinely learn. Sample tuple:
(word-id list int64 varlen, label int64 {0,1}).
"""
from __future__ import annotations

import re
import tarfile

import numpy as np

from .common import cached_path, synthetic_notice

__all__ = ["word_dict", "train", "test"]

_VOCAB = 5149  # mimics the reference's cutoff-150 dict size scale
_N_TRAIN, _N_TEST = 2048, 256
_MIN_LEN, _MAX_LEN = 8, 120
_CUTOFF = 150  # reference imdb.py word_dict cutoff
_real_dict = None


def _tokenize(raw: bytes):
    return raw.decode("utf-8", "ignore").lower().split()


def word_dict():
    """reference imdb.word_dict(): word -> id, built by corpus frequency when
    the real archive is present; synthetic fallback maps 'w<i>' -> i."""
    global _real_dict
    path = cached_path("imdb", "aclImdb_v1.tar.gz")
    if not path:
        return {f"w{i}": i for i in range(_VOCAB)}
    if _real_dict is None:
        freq: dict = {}
        pat = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
        with tarfile.open(path, "r:gz") as tar:
            for member in tar.getmembers():
                if not pat.match(member.name):
                    continue
                for w in _tokenize(tar.extractfile(member).read()):
                    freq[w] = freq.get(w, 0) + 1
        # frequency-descending, ties by word, as the reference sorts
        kept = sorted((w for w, c in freq.items() if c >= _CUTOFF),
                      key=lambda w: (-freq[w], w))
        _real_dict = {w: i for i, w in enumerate(kept)}
        # reference appends '<unk>' = len(words) so unknown ids stay in range
        _real_dict["<unk>"] = len(_real_dict)
    return _real_dict


def _reader(split: str, wd=None):
    path = cached_path("imdb", "aclImdb_v1.tar.gz")
    n = _N_TRAIN if split == "train" else _N_TEST
    seed = 0 if split == "train" else 1

    def reader():
        if path:
            d = wd if wd is not None else word_dict()
            unk = d.get("<unk>", len(d) - 1)
            pat = re.compile(rf"aclImdb/{split}/(pos|neg)/.*\.txt$")
            with tarfile.open(path, "r:gz") as tar:
                for member in tar.getmembers():
                    m = pat.match(member.name)
                    if not m:
                        continue
                    ids = [d.get(w, unk)
                           for w in _tokenize(tar.extractfile(member).read())]
                    yield ids, int(m.group(1) == "pos")
        else:
            synthetic_notice("imdb")
            yield from _synthetic(n, seed)

    return reader


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(_MIN_LEN, _MAX_LEN + 1))
        # positive docs draw 70% of words from the low band, negative from
        # the high band; 30% uniform noise
        band = rng.rand(length) < 0.7
        half = _VOCAB // 2
        lo = rng.randint(0, half, length)
        hi = rng.randint(half, _VOCAB, length)
        signal = lo if label == 1 else hi
        noise = rng.randint(0, _VOCAB, length)
        words = np.where(band, signal, noise).astype(np.int64)
        docs.append((list(words), label))
    return docs


def train(word_dict=None):
    return _reader("train", word_dict)


def test(word_dict=None):
    return _reader("test", word_dict)
