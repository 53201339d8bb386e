"""Built-in dataset loaders of the PyTorch port, a copy of
``paddle_tpu/dataset`` (reference: python/paddle/dataset/).

The reference downloads real archives from paddlepaddle.org
(dataset/common.py download()). The port downloads nothing: each loader
first looks for the real files under ``$PADDLE_TPU_DATA_HOME`` (default
``~/.cache/paddle_tpu/dataset``; drop them there to train on real data) and
otherwise falls back to a deterministic synthetic sample with the exact
shapes/dtypes/value-ranges of the real dataset — enough to drive every
pipeline, model and test. The reader contract is the reference one: a
loader returns a zero-arg creator whose iterator yields sample tuples.
"""
from . import (cifar, conll05, flowers, imdb, imikolov,  # noqa: F401
               mnist, movielens, sentiment, uci_housing, voc2012,
               wmt14, wmt16)

__all__ = ["mnist", "cifar", "imdb", "imikolov", "uci_housing",
           "movielens", "conll05", "wmt16", "wmt14", "flowers",
           "sentiment", "voc2012"]
