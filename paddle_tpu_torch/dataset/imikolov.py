"""PTB/imikolov n-gram loader (reference: python/paddle/dataset/imikolov.py).

Real data: place ``simple-examples.tgz`` under ``$DATA_HOME/imikolov/``.
Otherwise synthesizes a corpus from a planted first-order Markov chain, so
an n-gram next-word model (the book word2vec test) genuinely learns.
``train(word_dict, n)`` yields n-tuples of word ids (the n-1 context words
plus the target), exactly the reference contract.
"""
from __future__ import annotations

import tarfile

import numpy as np

from .common import cached_path, synthetic_notice

__all__ = ["build_dict", "train", "test"]

_VOCAB = 200
_N_TRAIN_SENT, _N_TEST_SENT = 512, 64


def build_dict(min_word_freq: int = 50):
    path = cached_path("imikolov", "simple-examples.tgz")
    if not path:
        return {f"w{i}": i for i in range(_VOCAB)}
    freq: dict = {}
    with tarfile.open(path, "r:gz") as tar:
        f = tar.extractfile("./simple-examples/data/ptb.train.txt")
        for line in f.read().decode("utf-8").splitlines():
            for w in line.strip().split():
                freq[w] = freq.get(w, 0) + 1
    kept = sorted((w for w, c in freq.items() if c >= min_word_freq),
                  key=lambda w: (-freq[w], w))
    d = {w: i for i, w in enumerate(kept)}
    d["<unk>"] = len(d)
    return d


def _synthetic_sentences(n, seed, vocab=_VOCAB):
    """First-order Markov chain: word w transitions to one of 4 preferred
    successors with prob 0.8 — n-gram models reach low perplexity on it."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab, (vocab, 4))
    sents = []
    for _ in range(n):
        length = int(rng.randint(8, 20))
        w = int(rng.randint(0, vocab))
        sent = [w]
        for _ in range(length - 1):
            if rng.rand() < 0.8:
                w = int(succ[w, rng.randint(0, 4)])
            else:
                w = int(rng.randint(0, vocab))
            sent.append(w)
        sents.append(sent)
    return sents


def _reader(split: str, word_dict, n: int):
    path = cached_path("imikolov", "simple-examples.tgz")
    count = _N_TRAIN_SENT if split == "train" else _N_TEST_SENT
    seed = 0 if split == "train" else 1

    def reader():
        if path:
            name = f"./simple-examples/data/ptb.{split}.txt" \
                if split != "test" else "./simple-examples/data/ptb.valid.txt"
            unk = word_dict.get("<unk>", len(word_dict) - 1)
            with tarfile.open(path, "r:gz") as tar:
                f = tar.extractfile(name)
                for line in f.read().decode("utf-8").splitlines():
                    ids = [word_dict.get(w, unk)
                           for w in line.strip().split()]
                    for i in range(len(ids) - n + 1):
                        yield tuple(ids[i:i + n])
        else:
            synthetic_notice("imikolov")
            # respect a caller-supplied (possibly smaller) dict: ids must
            # stay in range of the embedding it sizes
            vocab = min(_VOCAB, len(word_dict)) if word_dict else _VOCAB
            for sent in _synthetic_sentences(count, seed, vocab):
                for i in range(len(sent) - n + 1):
                    yield tuple(sent[i:i + n])

    return reader


def train(word_dict, n: int = 5):
    return _reader("train", word_dict, n)


def test(word_dict, n: int = 5):
    return _reader("test", word_dict, n)
