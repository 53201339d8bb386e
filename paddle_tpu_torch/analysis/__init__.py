"""paddle_tpu_torch.analysis — program analyses and transforms over the
Program IR (counterpart of ``paddle_tpu/analysis``), the part the
inference slice runs:

* ``pass_manager`` — ``Pass``/``PassRegistry`` with declared
  dependencies and invalidations, ``PassContext`` analysis
  caching, ``PassManager.run_pipeline``, ``run_transform_pipeline``.
* ``liveness`` — def/use chains, effect classification, proven-safe
  donation (``safe_donation_set``, ``donation_report``), peak-memory
  planning (``memory_plan``, surfaced as ``Program.memory_plan()``),
  PT50x.
* ``remat`` — automatic rematerialisation: memory_plan-scored checkpoint
  selection over a rebuilt training program, wired to the executor via
  ``FLAGS_auto_recompute``.
* ``cost_model`` — static FLOP/byte cost per program and batch
  (``estimate_cost``), behind the monitor's MFU gauges.
* ``epilogue_fusion`` — GEMM-epilogue fusion: mul/matmul ->
  bias/activation/residual/layer_norm chains rewritten into the
  ``fused_gemm_epilogue`` op under a per-chain numerical fidelity witness,
  wired to the executor via ``FLAGS_epilogue_fusion``.
* ``diagnostics`` — ``Diagnostic`` and the code table (PT500-PT504,
  PT750-PT756).

The verifier passes, the other static checks and the multi-device
analyses (sharding, the comms half of the cost model) arrive with later
slices.
"""
from .diagnostics import (CODES, Diagnostic, ProgramVerificationError,
                          Severity, format_diagnostics)
from . import liveness
from .liveness import (block_liveness, classify_op_effects,
                       donation_report, memory_plan, safe_donation_set)
from . import pass_manager
from .pass_manager import (FunctionPass, Pass, PassContext, PassManager,
                           PassRegistry, PipelineResult,
                           default_pass_manager, get_pass_registry,
                           run_transform_pipeline)
from . import epilogue_fusion
from .epilogue_fusion import FusedChain, FusionDecision, fuse_epilogues
from . import remat
from .remat import (RematCandidate, RematDecision, auto_recompute_program,
                    remat_candidates)
from . import cost_model
from .cost_model import CostReport, estimate_cost

__all__ = [
    "CODES", "Diagnostic", "ProgramVerificationError", "Severity",
    "format_diagnostics", "liveness", "block_liveness",
    "classify_op_effects", "donation_report", "memory_plan",
    "safe_donation_set", "pass_manager", "Pass", "FunctionPass",
    "PassRegistry", "PassContext", "PassManager", "PipelineResult",
    "get_pass_registry", "default_pass_manager",
    "run_transform_pipeline", "epilogue_fusion", "FusedChain",
    "FusionDecision", "fuse_epilogues", "remat", "RematCandidate",
    "RematDecision", "auto_recompute_program", "remat_candidates",
    "cost_model", "CostReport", "estimate_cost",
]
