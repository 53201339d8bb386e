"""Initializers: emit init ops into the startup program.

Counterpart of ``paddle_tpu/initializer.py`` (reference initializer.py).
An initializer appends ONE op to the var's startup block; the executor
runs the startup program once and the resulting tensors become scope
state. Only the two the GPT path uses are ported.
"""
from __future__ import annotations

__all__ = ["Constant", "TruncatedNormal"]


class Constant:
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class TruncatedNormal:
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})
