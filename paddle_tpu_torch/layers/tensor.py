"""Tensor creation layers (counterpart of ``paddle_tpu/layers/tensor.py``;
reference python/paddle/fluid/layers/tensor.py)."""
from __future__ import annotations

import numpy as np

from ..core.types import canonical_dtype
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_global_var", "fill_constant",
           "fill_constant_batch_size_like", "assign", "cast", "zeros", "ones",
           "zeros_like", "ones_like", "range", "linspace", "scale",
           "uniform_random", "gaussian_random"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(shape=[1], dtype=dtype,
                                         persistable=persistable, name=name)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global var of ``shape`` filled with ``value`` by the startup
    program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(shape=shape, dtype=dtype,
                                        persistable=persistable, name=name)
    helper.startup_program.global_block.create_var(
        name=var.name, shape=tuple(shape), dtype=dtype,
        persistable=persistable)
    helper.startup_program.global_block.append_op(
        "fill_constant", outputs={"Out": var.name},
        attrs={"shape": list(shape), "dtype": canonical_dtype(dtype),
               "value": float(value)})
    return var


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape),
                            "dtype": canonical_dtype(dtype),
                            "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": list(shape),
                            "dtype": canonical_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def assign(input, output=None):
    """Copy a var (``assign``) or a host constant (``assign_value``,
    from a numpy array or anything ``np.asarray`` takes)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": input},
                         outputs={"Out": output})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                canonical_dtype(arr.dtype))
        helper.append_op("assign_value", outputs={"Out": output},
                         attrs={"shape": list(arr.shape),
                                "dtype": canonical_dtype(arr.dtype),
                                "values": [v.item() for v in arr.flat]})
    return output


def cast(x, dtype):
    from .nn import cast as _cast

    return _cast(x, dtype)


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": x}, outputs={"Out": out})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": 0.0, "bias": 1.0})
    return out


def range(start, end, step, dtype="float32"):
    """[start, end) by step; the bounds are numbers (the output's length
    is fixed when the program is built, as in the reference)."""
    if isinstance(start, Variable) or isinstance(end, Variable) \
            or isinstance(step, Variable):
        raise ValueError(
            "layers.range requires numeric bounds: the output's length is "
            "fixed when the program is built")
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    helper.append_op("range", outputs={"Out": out},
                     attrs={"start": float(start), "end": float(end),
                            "step": float(step),
                            "dtype": canonical_dtype(dtype),
                            "use_attrs": True})
    return out


def linspace(start, stop, num, dtype="float32"):
    step = (stop - start) / max(num - 1, 1)
    return range(start, stop + step / 2, step, dtype)


def scale(x, **kwargs):
    from .nn import scale as _scale

    return _scale(x, **kwargs)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    helper.append_op("uniform_random", outputs={"Out": out},
                     attrs={"shape": list(shape),
                            "dtype": canonical_dtype(dtype),
                            "min": float(min), "max": float(max),
                            "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(canonical_dtype(dtype))
    helper.append_op("gaussian_random", outputs={"Out": out},
                     attrs={"shape": list(shape),
                            "dtype": canonical_dtype(dtype),
                            "mean": float(mean), "std": float(std),
                            "seed": seed})
    return out
