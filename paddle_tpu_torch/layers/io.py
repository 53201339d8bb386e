"""Data layers (reference: python/paddle/fluid/layers/io.py `data`)."""
from __future__ import annotations

from ..core.types import canonical_dtype
from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    """Declare an input variable. With append_batch_size, a -1 batch dim
    is prepended; shapes with an explicit -1 are taken as they are.

    A ``lod_level >= 1`` input uses the padded + lengths encoding: the
    reference's shape is per token, so the padded var gains a batch AND a
    time dim (``[-1, -1] + shape``), and its per-sequence lengths arrive
    in the int32 ``[-1]`` companion data var ``<name>@LOD`` (fed by the
    ``DataFeeder`` or by hand, read by the sequence ops' ``SeqLen``
    slots). ``type`` is accepted and not read, as in the JAX package."""
    shape = list(shape)
    if append_batch_size:
        if any(s == -1 for s in shape):
            append_batch_size = False
        elif lod_level >= 1:
            shape = [-1, -1] + shape
        else:
            shape = [-1] + shape
    block = default_main_program().current_block()
    v = block.create_var(name=name, shape=shape,
                         dtype=canonical_dtype(dtype), lod_level=lod_level,
                         stop_gradient=stop_gradient, is_data=True)
    if lod_level >= 1:
        block.create_var(name=name + "@LOD", shape=(-1,), dtype="int32",
                         stop_gradient=True, is_data=True)
    return v
