"""paddle_tpu_torch.analysis — program analyses and transforms over the
Program IR (counterpart of ``paddle_tpu/analysis``):

* ``verifier`` — the four verifier passes (schema, dataflow,
  lowerability, shape replay; PT100-PT401), ``verify_program`` and
  ``check_program``, wired to the executor via ``FLAGS_check_program``.
* ``pass_manager`` — ``Pass``/``PassRegistry`` with declared
  dependencies and invalidations, ``PassContext`` analysis caching,
  ``PassManager.run_pipeline`` with the strict verify bracket at
  ``FLAGS_check_program>=2``, ``run_verify_pipeline``,
  ``run_transform_pipeline``.
* ``liveness`` — def/use chains, effect classification, proven-safe
  donation (``safe_donation_set``, ``donation_report``), peak-memory
  planning (``memory_plan``, surfaced as ``Program.memory_plan()``),
  PT50x.
* ``static_checks`` — whole-program dtype/shape replay (PT70x), the
  donation/alias race detector (PT71x), dead code (PT72x) and the opt-in
  ``dce_program`` transform.
* ``numerics`` — value-interval and precision-flow propagation (PT90x),
  ``static_intervals``, the static side of the runtime numerics
  witness's containment check.
* ``registry_audit`` — per-op capability table of the port's registry.
* ``remat`` — automatic rematerialisation: memory_plan-scored checkpoint
  selection over a rebuilt training program, wired to the executor via
  ``FLAGS_auto_recompute``.
* ``cost_model`` — static FLOP/byte cost per program and batch
  (``estimate_cost``), behind the monitor's MFU gauges.
* ``epilogue_fusion`` — GEMM-epilogue fusion: mul/matmul ->
  bias/activation/residual/layer_norm chains rewritten into the
  ``fused_gemm_epilogue`` op under a per-chain numerical fidelity witness,
  wired to the executor via ``FLAGS_epilogue_fusion``.
* ``concurrency`` — the source-level lock analysis over the port's own
  code (PT800-PT802): lock inventory, static lock-order graph
  (``static_edge_set``, what the runtime lock witness is held to).
  Imported on demand (``from paddle_tpu_torch.analysis import
  concurrency``); ``tools/torch_lint_concurrency.py`` is its gate.
* ``diagnostics`` — ``Diagnostic`` and the code table.

The multi-device analyses (``sharding_check``, PT730-PT744, and the comms
half of the cost model) arrive with a later slice.
"""
from .diagnostics import (CODES, Diagnostic, ProgramVerificationError,
                          Severity, format_diagnostics)
from .registry_audit import audit_registry, coverage_summary, format_audit
from .verifier import DEFAULT_PASSES, check_program, verify_program
from . import liveness
from .liveness import (MemoryPlan, block_liveness, classify_op_effects,
                       donation_report, memory_plan, safe_donation_set)
from . import pass_manager
from .pass_manager import (ALL_ANALYSIS_PASSES, VERIFY_PASSES, FunctionPass,
                           Pass, PassContext, PassManager, PassRegistry,
                           PassVerificationError, PipelineResult,
                           clear_analysis_caches, default_pass_manager,
                           get_pass_registry, register_pass,
                           run_transform_pipeline, run_verify_pipeline)
from . import static_checks
from .static_checks import DceDecision, DeadCodeReport, dce_program
from . import epilogue_fusion
from .epilogue_fusion import FusedChain, FusionDecision, fuse_epilogues
from . import remat
from .remat import (RematCandidate, RematDecision, auto_recompute_program,
                    remat_candidates)
from . import cost_model
from .cost_model import CostReport, estimate_cost
from . import numerics
from .numerics import (Interval, NumericsReport, analyze_numerics,
                       check_numerics, static_intervals)

__all__ = [
    "CODES", "Diagnostic", "ProgramVerificationError", "Severity",
    "format_diagnostics", "audit_registry", "coverage_summary",
    "format_audit", "DEFAULT_PASSES", "check_program", "verify_program",
    "liveness", "MemoryPlan", "block_liveness", "classify_op_effects", "donation_report",
    "memory_plan", "safe_donation_set",
    "pass_manager", "Pass", "FunctionPass", "PassRegistry", "PassContext",
    "PassManager", "PassVerificationError", "PipelineResult",
    "register_pass", "get_pass_registry", "default_pass_manager",
    "run_verify_pipeline", "run_transform_pipeline", "clear_analysis_caches",
    "ALL_ANALYSIS_PASSES", "VERIFY_PASSES",
    "static_checks", "DceDecision", "DeadCodeReport", "dce_program",
    "epilogue_fusion", "FusedChain", "FusionDecision", "fuse_epilogues",
    "remat", "RematCandidate", "RematDecision", "auto_recompute_program",
    "remat_candidates", "cost_model", "CostReport", "estimate_cost",
    "numerics", "Interval", "NumericsReport", "analyze_numerics",
    "check_numerics", "static_intervals",
]
