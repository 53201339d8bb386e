"""Data-parallel execution over the launched ranks (counterpart of
``paddle_tpu/parallel``): ``CompiledProgram(...).with_data_parallel()``,
the build and execution strategies, and the sharding metadata
(``parallel.sharding``). One process drives one card; the ranks come from
``paddle_tpu_torch.distributed.launch``.
"""
from .compiled_program import (BuildStrategy, CompiledProgram,  # noqa: F401
                               ExecutionStrategy, ReduceStrategy,
                               data_parallel_mesh)
