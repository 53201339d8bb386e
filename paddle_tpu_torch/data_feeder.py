"""DataFeeder: convert python/numpy minibatches into executor feeds
(counterpart of ``paddle_tpu/data_feeder.py``).

Reference: python/paddle/fluid/data_feeder.py (DataFeeder.feed converts a
list of sample tuples into per-variable LoDTensors on the target place).
Here the target representation is a dict name -> numpy batch; the
executor copies it to its device. A ``lod_level >= 1`` variable is fed
padded, with its lengths under ``<name>@LOD`` (``layers.data``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .core.types import np_dtype
from .framework import Variable

__all__ = ["DataFeeder", "coerce_feed_array", "bucket_length",
           "DEFAULT_SEQ_BUCKETS"]


def coerce_feed_array(var: Variable, arr: np.ndarray) -> np.ndarray:
    """Coerce one batched array to a feed variable's declared dtype/rank:
    same-kind dtype cast, and label scalars fed as [N, 1] (the reference
    DataFeeder's LoDTensor convention)."""
    want = np_dtype(var.dtype)
    if arr.dtype != want and arr.dtype.kind == np.dtype(want).kind:
        arr = arr.astype(want)
    if var.shape is not None and arr.ndim == len(var.shape) - 1:
        arr = arr.reshape(arr.shape + (1,))
    return arr


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; doubles past the largest configured bucket.
    The port compiles nothing, so a bucket only fixes the padded length:
    it bounds the distinct shapes a varlen feed produces."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1] if buckets else 1
    while b < n:
        b *= 2
    return b


DEFAULT_SEQ_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None,
                 seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS):
        self.feed_names: List[str] = []
        self.feed_vars: List[Variable] = []
        for v in feed_list:
            if isinstance(v, str):
                if program is None:
                    raise ValueError("string feed names need a program")
                v = program.global_block.var(v)
            self.feed_vars.append(v)
            self.feed_names.append(v.name)
        self.place = place
        self.seq_buckets = tuple(seq_buckets)

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """iterable: list of sample tuples, one tuple per example, fields
        aligned with feed_list. Returns {name: batched ndarray} with dtypes
        coerced to each variable's declared dtype. For lod_level>=1 vars the
        samples are variable-length sequences: they are padded to a bucketed
        max_len and a '<name>@LOD' int32 lengths entry is added."""
        samples = list(iterable)
        if not samples:
            raise ValueError("empty minibatch")
        cols = list(zip(*[s if isinstance(s, (list, tuple)) else (s,)
                          for s in samples]))
        if len(cols) != len(self.feed_names):
            raise ValueError(
                f"sample has {len(cols)} fields, feed_list expects "
                f"{len(self.feed_names)} ({self.feed_names})")
        out = {}
        for var, col in zip(self.feed_vars, cols):
            if var.lod_level >= 1:
                arr, lengths = self._pad_varlen(var, col)
                out[var.name] = arr
                out[var.name + "@LOD"] = lengths
            else:
                arr = np.stack([np.asarray(v, dtype=np_dtype(var.dtype))
                                for v in col])
                out[var.name] = coerce_feed_array(var, arr)
        return out

    def _pad_varlen(self, var: Variable, col):
        dt = np_dtype(var.dtype)
        seqs = [np.asarray(v, dtype=dt) for v in col]
        lengths = np.array([s.shape[0] for s in seqs], dtype=np.int32)
        max_len = bucket_length(int(lengths.max()), self.seq_buckets)
        feat = seqs[0].shape[1:]
        arr = np.zeros((len(seqs), max_len) + feat, dtype=dt)
        for i, s in enumerate(seqs):
            arr[i, :s.shape[0]] = s
        if var.shape is not None and arr.ndim == len(var.shape) - 1:
            # token scalars fed as [.., 1] (reference LoDTensor convention)
            arr = arr.reshape(arr.shape + (1,))
        return arr, lengths
