"""paddle_tpu_torch.analysis — program analyses and transforms over the
Program IR (counterpart of ``paddle_tpu/analysis``), the part the
inference slice runs:

* ``pass_manager`` — ``Pass``/``PassRegistry`` with declared
  dependencies and invalidations, ``PassContext`` analysis
  caching, ``PassManager.run_pipeline``, ``run_transform_pipeline``.
* ``liveness`` — def/use chains, effect classification, PT50x.
* ``epilogue_fusion`` — GEMM-epilogue fusion: mul/matmul ->
  bias/activation/residual/layer_norm chains rewritten into the
  ``fused_gemm_epilogue`` op under a per-chain numerical fidelity witness,
  wired to the executor via ``FLAGS_epilogue_fusion``.
* ``diagnostics`` — ``Diagnostic`` and the code table (PT500-PT504,
  PT750-PT756).

The verifier passes, the other static checks, the memory planner and the
cost model arrive with later slices.
"""
from .diagnostics import (CODES, Diagnostic, ProgramVerificationError,
                          Severity, format_diagnostics)
from . import liveness
from .liveness import block_liveness, classify_op_effects
from . import pass_manager
from .pass_manager import (FunctionPass, Pass, PassContext, PassManager,
                           PassRegistry, PipelineResult,
                           default_pass_manager, get_pass_registry,
                           run_transform_pipeline)
from . import epilogue_fusion
from .epilogue_fusion import FusedChain, FusionDecision, fuse_epilogues

__all__ = [
    "CODES", "Diagnostic", "ProgramVerificationError", "Severity",
    "format_diagnostics", "liveness", "block_liveness",
    "classify_op_effects", "pass_manager", "Pass", "FunctionPass",
    "PassRegistry", "PassContext", "PassManager", "PipelineResult",
    "get_pass_registry", "default_pass_manager",
    "run_transform_pipeline", "epilogue_fusion", "FusedChain",
    "FusionDecision", "fuse_epilogues",
]
