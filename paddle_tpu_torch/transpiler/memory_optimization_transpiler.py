"""``memory_optimize`` and ``release_memory`` (reference
transpiler/memory_optimization_transpiler.py:18, :42): no-ops by design,
as in the JAX package. The executor already frees each value after its
last reader (``executor._release_plan`` over ``analysis.liveness``), so a
graph rewrite has nothing to reuse. The functions validate their
arguments, warn and return the program untouched, so old scripts run.
"""
from __future__ import annotations

import warnings

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    if level not in (0, 1):
        raise ValueError("level must be 0 or 1")
    warnings.warn(
        "memory_optimize is a no-op: the executor frees each value after "
        "its last reader", stacklevel=2)
    return input_program


def release_memory(input_program, skip_opt_set=None):
    warnings.warn(
        "release_memory is a no-op: the executor frees each value after "
        "its last reader", stacklevel=2)
    return input_program
