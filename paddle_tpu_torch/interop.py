"""Carry parameters and state from numpy arrays into a port scope.

A training scope carries across whole: the parameters, Adam's
``moment1_*``/``moment2_*`` accumulators, its ``beta1_pow_acc_*``/
``beta2_pow_acc_*`` powers and the learning-rate var all have the same
names in both packages, so a reference scope planted here before a run,
or read back after N steps, compares with the port's name by name.

The JAX package runs with 64-bit types off, so its int64 vars come back
from ``Scope.numpy`` as int32. :func:`scope_from_numpy` converts each
array to the dtype the port declares for it (int32 -> int64 where the var
is int64), on the requested place, so both packages compute from the
same weights.

Under a model-parallel mesh, ``scope_from_numpy(..., mesh=, rules=)``
plants each rank's shard instead: every var the rules shard (and the
optimizer state of a param they shard) is cut to the shard of this
rank's mesh coordinates, as ``parallel.sharding.place_state`` cuts a
scope's values.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .core.types import torch_dtype

__all__ = ["scope_from_numpy"]


def scope_from_numpy(arrays: Dict[str, np.ndarray], scope, place,
                     programs: Optional[Iterable] = None, mesh=None,
                     rules=None, rank: Optional[int] = None):
    """Plant ``arrays`` (name -> array) in ``scope`` as tensors on
    ``place``. A var declared in one of ``programs`` gets its declared
    dtype; others keep the array's dtype. With a ``mesh``, a var the
    parallel step shards over ``programs`` is cut to the shard of
    ``rank``'s coordinates (default: this process's rank): the
    ``pp``-stacked slices of a ``PipelineRegion``, the ``dp`` rows of an
    ``is_distributed`` table, and with ``rules``
    (``parallel.sharding.ShardingRules``) the vars they shard. Returns
    ``scope``."""
    programs = list(programs or ())
    declared = {}
    for prog in programs:
        for blk in prog.blocks:
            for name, var in blk.vars.items():
                declared.setdefault(name, var.dtype)
    specs = {}
    if mesh is not None:
        from .parallel.sharding import extract_param_specs

        for prog in programs:
            specs.update(extract_param_specs(prog, mesh.shape,
                                             rules=rules)[0])
    device = place.torch_device()
    for name, arr in arrays.items():
        spec = specs.get(name)
        if spec and any(a is not None for a in spec):
            from .parallel.sharding import shard_of

            arr = shard_of(np.asarray(arr), spec, mesh, rank)
        t = torch.from_numpy(np.array(arr, copy=True))
        dt = torch_dtype(declared[name]) if name in declared else t.dtype
        scope.set_var(name, t.to(device=device, dtype=dt))
    return scope
