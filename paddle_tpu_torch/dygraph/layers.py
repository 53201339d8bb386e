"""Layer: the dygraph module system (counterpart of
``paddle_tpu/dygraph/layers.py``; reference dygraph/layers.py:31).

Parameters are eager VarBases initialized at construction (no startup
program); sublayers register via attribute assignment, parameters() walks
the tree, state_dict()/set_dict() snapshot and restore values by
hierarchical name.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .base import VarBase

__all__ = ["Layer"]


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self._full_name = name_scope or type(self).__name__.lower()
        self._dtype = dtype
        self._parameters: Dict[str, VarBase] = {}
        self._sub_layers: Dict[str, "Layer"] = {}
        self.training = True

    # -- construction -----------------------------------------------------
    def create_parameter(self, shape, dtype=None, init=None,
                         is_bias: bool = False,
                         stop_gradient: bool = False) -> VarBase:
        """init: None (Xavier for weights / zeros for bias), a float
        (constant), or a numpy array."""
        dtype = np.dtype(dtype or self._dtype)
        shape = tuple(int(s) for s in shape)
        if isinstance(init, np.ndarray):
            val = init.astype(dtype)
        elif init is not None:
            val = np.full(shape, float(init), dtype)
        elif is_bias:
            val = np.zeros(shape, dtype)
        else:
            fan_in = shape[0] if shape else 1
            fan_out = shape[1] if len(shape) > 1 else 1
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            val = _param_rng().uniform(-limit, limit, shape).astype(dtype)
        vb = VarBase(val, stop_gradient=stop_gradient, persistable=True)
        return vb

    def add_parameter(self, name: str, param: VarBase) -> VarBase:
        self._parameters[name] = param
        param.name = f"{self._full_name}.{name}"
        return param

    def add_sublayer(self, name: str, layer: "Layer") -> "Layer":
        self._sub_layers[name] = layer
        return layer

    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and value.persistable:
            self.__dict__.setdefault("_parameters", {})[name] = value
            value.name = f"{self.__dict__.get('_full_name', '?')}.{name}"
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", {})[name] = value
        object.__setattr__(self, name, value)

    # -- inference/training mode ------------------------------------------
    def train(self):
        self.training = True
        for l in self._sub_layers.values():
            l.train()

    def eval(self):
        self.training = False
        for l in self._sub_layers.values():
            l.eval()

    # -- traversal ---------------------------------------------------------
    def named_parameters(self, prefix="") -> Iterator[Tuple[str, VarBase]]:
        for n, p in self._parameters.items():
            yield (f"{prefix}{n}", p)
        for ln, l in self._sub_layers.items():
            yield from l.named_parameters(prefix=f"{prefix}{ln}.")

    def parameters(self) -> List[VarBase]:
        return [p for _, p in self.named_parameters()]

    def sublayers(self) -> List["Layer"]:
        out = list(self._sub_layers.values())
        for l in self._sub_layers.values():
            out.extend(l.sublayers())
        return out

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- state dicts (reference dygraph/checkpoint.py save_dygraph) --------
    def state_dict(self) -> Dict[str, np.ndarray]:
        return {n: p.numpy() for n, p in self.named_parameters()}

    def set_dict(self, state: Dict[str, np.ndarray]):
        own = dict(self.named_parameters())
        missing = set(own) - set(state)
        if missing:
            raise KeyError(f"state dict missing parameters: {sorted(missing)}")
        for n, p in own.items():
            arr = np.asarray(state[n])
            if tuple(arr.shape) != p.shape:
                raise ValueError(
                    f"parameter '{n}': saved shape {arr.shape} != {p.shape}")
            p.set_value(arr)

    load_dict = set_dict

    # -- call ---------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)


_rng = None


def _param_rng() -> np.random.RandomState:
    global _rng
    if _rng is None:
        _rng = np.random.RandomState(0)
    return _rng


def seed_parameters(seed: int) -> None:
    """Reset the eager parameter-init RNG (fluid.default_startup_program().
    random_seed analogue for dygraph)."""
    global _rng
    _rng = np.random.RandomState(seed)
