"""Transpiler package — 2019 distributed front-door compatibility
(counterpart of ``paddle_tpu/transpiler``; reference
python/paddle/fluid/transpiler/). The PS/async machinery is re-decided
(see the distribute_transpiler module docstring); the memory transpilers
are documented no-ops.
"""
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .geo_sgd_transpiler import GeoSgdTranspiler
from .memory_optimization_transpiler import memory_optimize, release_memory
from .ps_dispatcher import HashName, PSDispatcher, RoundRobin

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "GeoSgdTranspiler", "memory_optimize", "release_memory",
           "HashName", "PSDispatcher", "RoundRobin"]
