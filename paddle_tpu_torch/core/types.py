"""Type system of the PyTorch port: canonical dtype names mapped to numpy
and torch dtypes.

Counterpart of ``paddle_tpu/core/types.py``. The port keeps int64 as
int64 on the device (PyTorch has no 32-bit-by-default mode), so there is
no x64 fallback table here.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class VarType(enum.Enum):
    """Variable kinds (reference framework.proto ``VarType.Type``)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    STEP_SCOPES = "step_scopes"
    READER = "reader"
    RAW = "raw"


_CANONICAL = {
    "float32": "float32",
    "float64": "float64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "uint16": "uint16",
    "int32": "int32",
    "uint32": "uint32",
    "int64": "int64",
    "uint64": "uint64",
    "bool": "bool",
    # aliases
    "fp32": "float32",
    "fp64": "float64",
    "fp16": "float16",
    "bf16": "bfloat16",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

_TORCH = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}


def canonical_dtype(dtype) -> str:
    """Normalise a dtype (str / np.dtype / torch.dtype) to its canonical
    string name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        if dtype in _FROM_TORCH:
            return _FROM_TORCH[dtype]
        raise ValueError(f"unknown dtype: {dtype!r}")
    if isinstance(dtype, str):
        name = dtype.lower()
        if name in _CANONICAL:
            return _CANONICAL[name]
        raise ValueError(f"unknown dtype string: {dtype!r}")
    name = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    if name in _CANONICAL:
        return _CANONICAL[name]
    raise ValueError(f"unknown dtype: {dtype!r}")


def np_dtype(dtype) -> np.dtype:
    name = canonical_dtype(dtype)
    if name == "bfloat16":
        raise ValueError("numpy has no bfloat16; keep bf16 data in torch")
    return np.dtype(name)


def torch_dtype(dtype) -> torch.dtype:
    name = canonical_dtype(dtype)
    if name not in _TORCH:
        raise ValueError(f"dtype {name} has no torch counterpart")
    return _TORCH[name]


def is_floating(dtype) -> bool:
    return canonical_dtype(dtype) in ("float16", "float32", "float64",
                                      "bfloat16")
