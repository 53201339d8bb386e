"""save_dygraph / load_dygraph (counterpart of
``paddle_tpu/dygraph/checkpoint.py``; reference dygraph/checkpoint.py):
state dicts as ``.pdparams.npz`` archives, the JAX package's format, so a
file either package writes loads in the other."""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

__all__ = ["save_dygraph", "load_dygraph"]


def save_dygraph(state_dict: Dict[str, np.ndarray], model_path: str) -> None:
    path = model_path if model_path.endswith(".npz") else \
        model_path + ".pdparams.npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in state_dict.items()})


def load_dygraph(model_path: str) -> Tuple[Dict[str, np.ndarray], None]:
    path = model_path if model_path.endswith(".npz") else \
        model_path + ".pdparams.npz"
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    # second element is the optimizer state slot (reference returns a pair)
    return state, None
