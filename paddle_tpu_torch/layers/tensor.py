"""Tensor creation layers (reference: python/paddle/fluid/layers/tensor.py),
the functions the GPT builders call."""
from __future__ import annotations

from ..core.types import canonical_dtype
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["fill_constant", "assign"]


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape),
                            "dtype": canonical_dtype(dtype),
                            "value": float(value)})
    return out


def assign(input, output=None):
    if not isinstance(input, Variable):
        raise NotImplementedError(
            "layers.assign of a host constant (assign_value) waits for a "
            "later slice of the port")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": input}, outputs={"Out": output})
    return output
