"""Initializers: emit init ops into the startup program.

Counterpart of ``paddle_tpu/initializer.py`` (reference initializer.py).
An initializer appends ONE op to the var's startup block; the executor
runs the startup program once and the resulting tensors become scope
state: Constant, Uniform, Normal, TruncatedNormal, Xavier (the default
of a weight with no initializer named), MSRA, Bilinear (the upsampling
kernel of a ``conv2d_transpose``), NumpyArrayInitializer and the
reference's ``*Initializer`` aliases. The random ops draw from torch
generators, so the values differ from the JAX package's bits but follow
the same distributions.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "Bilinear", "NumpyArrayInitializer", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer", "XavierInitializer",
           "MSRAInitializer"]


class Initializer:
    """The base: ``init(var, block)`` appends the var's init op."""

    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        return _fan_in_out(var)


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0], shape[0]) if shape else (1, 1)
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed})


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


class TruncatedNormal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


class Xavier(Initializer):
    """Glorot: ``uniform`` draws U(-sqrt(6/(fi+fo)), +), otherwise
    N(0, sqrt(2/(fi+fo)))."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return Uniform(-limit, limit, self.seed)(var, block)
        return Normal(0.0, math.sqrt(2.0 / (fi + fo)), self.seed)(var, block)


class MSRA(Initializer):
    """Kaiming He: ``uniform`` draws U(-sqrt(6/fi), +), otherwise
    N(0, sqrt(2/fi))."""

    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return Uniform(-limit, limit, self.seed)(var, block)
        return Normal(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a 4-D ``conv2d_transpose``
    weight [C_in, C_out, k, k] (reference initializer.py:668): channel c
    to channel c only, (1 - |x/f - c|)(1 - |y/f - c|) with
    f = ceil(k_w / 2) and c = (2f - 1 - f mod 2) / 2f."""

    def __call__(self, var, block):
        shape = tuple(var.shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer requires 4-D weights")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        xs = 1 - np.abs(np.arange(shape[3]) / f - c)
        ys = 1 - np.abs(np.arange(shape[2]) / f - c)
        weight = np.zeros(shape, dtype=np.float32)
        for ch in range(min(shape[0], shape[1])):
            weight[ch, ch] = ys[:, None] * xs[None, :]
        return block.append_op(
            "assign_value", outputs={"Out": var},
            attrs={"shape": list(shape), "dtype": var.dtype,
                   "values": [float(v) for v in weight.reshape(-1)]})


class NumpyArrayInitializer(Initializer):
    """The var takes ``value`` (an ``assign_value`` op)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            "assign_value", outputs={"Out": var},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                   "values": [float(v) for v in
                              self.value.astype(np.float64).flat]
                   if self.value.dtype.kind == "f"
                   else [int(v) for v in self.value.flat]})


# the reference's aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = Xavier
MSRAInitializer = MSRA
BilinearInitializer = Bilinear
