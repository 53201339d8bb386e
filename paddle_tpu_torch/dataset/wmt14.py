"""WMT14 en-fr loader (reference: python/paddle/dataset/wmt14.py).

Real data: place ``wmt14.tgz`` extracts under ``$DATA_HOME/wmt14/``.
Otherwise the same Markov-chain synthetic translation task as wmt16
(dataset/wmt16.py docstring), re-framed through the wmt14 API: samples are
(src_ids, trg_ids, trg_next_ids) with dict_size-bounded ids.
"""
from __future__ import annotations

from . import wmt16 as _w16

__all__ = ["train", "test", "get_dict"]


def train(dict_size=30000):
    return _w16.train()


def test(dict_size=30000):
    return _w16.test()


def get_dict(dict_size=30000, reverse=False):
    src = _w16.get_dict("en", reverse=reverse)
    trg = _w16.get_dict("fr", reverse=reverse)
    return src, trg
