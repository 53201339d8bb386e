"""Data layers (reference: python/paddle/fluid/layers/io.py `data`)."""
from __future__ import annotations

from ..core.types import canonical_dtype
from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable. With append_batch_size, a -1 batch dim
    is prepended; shapes with an explicit -1 are taken as they are."""
    if lod_level:
        raise NotImplementedError(
            "layers.data: LoD inputs wait for a later slice of the port")
    shape = list(shape)
    if append_batch_size and not any(s == -1 for s in shape):
        shape = [-1] + shape
    block = default_main_program().current_block()
    return block.create_var(name=name, shape=shape,
                            dtype=canonical_dtype(dtype),
                            stop_gradient=stop_gradient, is_data=True)
