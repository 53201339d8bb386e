"""Registration of the built-in IR passes on the default PassRegistry
(counterpart of ``paddle_tpu/analysis/builtin_passes.py``): ``liveness``,
``cost_model``, ``auto_remat`` and ``epilogue_fusion``, with the JAX
package's ``requires`` and ``invalidates``. Loaded lazily by
``pass_manager.get_pass_registry()`` so the import graph stays acyclic."""
from __future__ import annotations

from typing import List

from .diagnostics import Diagnostic
from .pass_manager import ANALYSIS, TRANSFORM, FunctionPass, PassRegistry

__all__ = ["register_builtins"]


def _liveness_pass(program, ctx):
    """PT50x diagnostics plus the shared analysis products: the global
    block's ``VarLive`` chains and the donation analysis (candidates,
    refusals). The dataflow scan runs once — the triple is handed to
    check_liveness rather than recomputed inside it."""
    from .liveness import _donation_analysis, check_liveness

    gb = program.global_block
    feeds = {v.name for v in gb.vars.values() if v.is_data}
    feeds.update(ctx.feed_names)
    cands, unsafe, live = _donation_analysis(gb, sorted(feeds),
                                             ctx.fetch_names)
    diags: List[Diagnostic] = []
    check_liveness(program, diags, list(ctx.fetch_names),
                   donation=(cands, unsafe, live))
    for d in diags:
        ctx.report(d)
    return {"diagnostics": diags, "live": live, "cands": cands,
            "unsafe": unsafe, "feeds": feeds}


def _auto_remat_pass(program, ctx):
    """Transform wrapper over ``auto_recompute_program`` (analysis/remat.py).
    Options: ``budget_mb`` (FLAGS_remat_budget_mb). Returns the
    ``RematDecision`` — the manager swaps in ``decision.program`` and the
    executor reads the decision from ``result.values["auto_remat"]``."""
    from .remat import auto_recompute_program

    return auto_recompute_program(
        program,
        feed_names=list(ctx.feed_names),
        fetch_names=list(ctx.fetch_names),
        batch_size=ctx.batch_size,
        budget_mb=int(ctx.options.get("budget_mb", 0) or 0))


def _cost_model_pass(program, ctx):
    from .cost_model import check_cost_model

    return check_cost_model(program, ctx)


def _epilogue_fusion_pass(program, ctx):
    """GEMM-epilogue fusion (analysis/epilogue_fusion.py, PT750-PT756):
    rewrite mul/matmul -> bias/activation/residual/layer_norm chains into
    fused_gemm_epilogue ops, gated by the per-chain fidelity witness.
    Returns the ``FusionDecision`` — the manager swaps in
    ``decision.program`` and the executor reads the decision from
    ``result.values["epilogue_fusion"]``."""
    from .epilogue_fusion import epilogue_fusion_pass

    return epilogue_fusion_pass(program, ctx)


def register_builtins(reg: PassRegistry) -> None:
    reg.register(FunctionPass(_liveness_pass, "liveness", ANALYSIS))
    reg.register(FunctionPass(_cost_model_pass, "cost_model", ANALYSIS))
    reg.register(FunctionPass(_auto_remat_pass, "auto_remat", TRANSFORM,
                              invalidates=("*",)))
    reg.register(FunctionPass(_epilogue_fusion_pass, "epilogue_fusion",
                              TRANSFORM, requires=("liveness",),
                              invalidates=("*",)))
