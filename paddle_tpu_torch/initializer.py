"""Initializers: emit init ops into the startup program.

Counterpart of ``paddle_tpu/initializer.py`` (reference initializer.py).
An initializer appends ONE op to the var's startup block; the executor
runs the startup program once and the resulting tensors become scope
state. Ported: Constant, Uniform, Normal, TruncatedNormal and Xavier
(the default of a weight with no initializer named). The random ops draw
from torch generators, so the values differ from the JAX package's bits
but follow the same distributions.
"""
from __future__ import annotations

import math

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier"]


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0], shape[0]) if shape else (1, 1)
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class Constant:
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class Uniform:
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed})


class Normal:
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


class TruncatedNormal:
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


class Xavier:
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
