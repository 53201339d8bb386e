"""The memory transpilers of ``paddle_tpu/transpiler/`` (reference
transpiler/memory_optimization_transpiler.py). The distributed
transpilers wait for the port's multi-device work."""
from .memory_optimization_transpiler import memory_optimize, release_memory

__all__ = ["memory_optimize", "release_memory"]
