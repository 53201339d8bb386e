"""PASCAL VOC2012 segmentation loader (reference:
python/paddle/dataset/voc2012.py).

Real data: place ``VOCtrainval_11-May-2012.tar`` extracts under
``$DATA_HOME/voc2012/``. Otherwise synthesizes images whose segmentation
mask is recoverable from color (each of the 21 classes paints its region
with a class-correlated color), so a small FCN genuinely learns.
Sample tuple: (image float32[3, 64, 64] in [0, 1],
label int64[64, 64] in [0, 21)).
"""
from __future__ import annotations

import numpy as np

from .common import synthetic_notice

__all__ = ["train", "test", "val"]

_N_CLASSES, _HW = 21, 64
_N_TRAIN, _N_TEST = 1024, 128


def _reader(n, seed):
    def read():
        synthetic_notice("voc2012")
        crng = np.random.RandomState(55)
        colors = crng.rand(_N_CLASSES, 3).astype(np.float32)
        rng = np.random.RandomState(seed)
        for _ in range(n):
            mask = np.zeros((_HW, _HW), np.int64)
            for _blob in range(int(rng.randint(1, 4))):
                c = int(rng.randint(1, _N_CLASSES))
                y0, x0 = rng.randint(0, _HW - 16, 2)
                h, w = rng.randint(8, 17, 2)
                mask[y0:y0 + h, x0:x0 + w] = c
            img = colors[mask].transpose(2, 0, 1)
            img = np.clip(img + 0.15 * rng.randn(3, _HW, _HW), 0, 1)
            yield img.astype(np.float32), mask
    return read


def train():
    return _reader(_N_TRAIN, 0)


def test():
    return _reader(_N_TEST, 1)


def val():
    return _reader(_N_TEST, 2)
