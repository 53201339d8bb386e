"""Operator-overload sugar on ``Variable`` (counterpart of
``paddle_tpu/layers/math_op_patch.py``; reference
layers/math_op_patch.py)."""
from __future__ import annotations


def binary(var, other, op_type: str, reverse: bool = False):
    """Append ``op_type`` over ``var`` and ``other`` (swapped when
    ``reverse``); a scalar ``other`` becomes a ``fill_constant`` of
    ``var``'s dtype and shape [1], which broadcasts."""
    from ..framework import Variable
    from ..layer_helper import LayerHelper

    helper = LayerHelper(op_type)
    if not isinstance(other, Variable):
        tmp = helper.create_variable_for_type_inference(dtype=var.dtype)
        helper.append_op("fill_constant", outputs={"Out": tmp},
                         attrs={"shape": [1], "dtype": var.dtype,
                                "value": float(other)})
        other = tmp
    x, y = (other, var) if reverse else (var, other)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"axis": -1})
    return out
