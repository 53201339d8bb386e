"""Registration of the built-in IR passes on the default PassRegistry
(counterpart of ``paddle_tpu/analysis/builtin_passes.py``, with its names,
``requires`` and ``invalidates``): the verifier passes 1-4, liveness, the
static-check families (``static_checks.py``), the cost model, numerics,
and the transforms auto-remat, epilogue fusion and the opt-in DCE. The
pass functions live in their modules; this one wraps them in the ``Pass``
protocol. The reference's ``sharding_check`` waits for the port's
multi-device analyses. Loaded lazily by
``pass_manager.get_pass_registry()`` so the import graph stays acyclic.
"""
from __future__ import annotations

from typing import List

from .diagnostics import Diagnostic
from .pass_manager import ANALYSIS, TRANSFORM, FunctionPass, PassRegistry

__all__ = ["register_builtins"]


# -- passes 1-4: the schema/dataflow/lowerability/shape_replay verifier ----

def _verifier_pass(name: str):
    def run(program, ctx) -> List[Diagnostic]:
        from .verifier import _PASS_FNS

        diags: List[Diagnostic] = []
        _PASS_FNS[name](program, diags, set(ctx.fetch_names))
        for d in diags:
            ctx.report(d)
        return diags

    run.__name__ = f"{name}_pass"
    return run


# -- pass 5: liveness (diagnostics + the cached def/use + donation data) ---

def _liveness_pass(program, ctx):
    """PT50x diagnostics plus the shared analysis products: the global
    block's ``VarLive`` chains and the donation analysis (candidates,
    refusals) that donation_race reuses from the cache. The dataflow scan
    runs ONCE — the triple is handed to check_liveness rather than
    recomputed inside it."""
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


# -- pass 6: auto-remat (FLAGS_auto_recompute) -----------------------------

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


# -- the static-analysis families --------------------------------------

def _dtype_shape_pass(program, ctx):
    from .static_checks import check_dtype_shape

    return check_dtype_shape(program, ctx)


def _donation_race_pass(program, ctx):
    from .static_checks import check_donation_race

    return check_donation_race(program, ctx)


def _dead_code_pass(program, ctx):
    from .static_checks import check_dead_code

    return check_dead_code(program, ctx)


def _cost_model_pass(program, ctx):
    from .cost_model import check_cost_model

    return check_cost_model(program, ctx)


def _numerics_check_pass(program, ctx):
    """Numerics/precision analysis (analysis/numerics.py, PT900-PT906):
    value-interval + dtype-precision propagation over the recorded
    infer_shape metadata, the quant/dequant pairing contract, AMP
    loss-scale coverage and the PT906 quantizability work-list. Options:
    ``numerics_calibration`` — witness-observed abs-max seeds.
    Findings-free programs pay one linear walk, so the full pipeline
    always includes the pass."""
    from .numerics import check_numerics

    return check_numerics(program, ctx)


def _epilogue_fusion_pass(program, ctx):
    """GEMM-epilogue fusion (analysis/epilogue_fusion.py, PT750-PT756):
    rewrite mul/matmul -> bias/activation/residual/layer_norm chains into
    fused_gemm_epilogue ops, gated by the per-chain fidelity witness.
    Consumes the cached liveness chains for the single-consumer and
    fetched-intermediate proofs. Returns the ``FusionDecision`` — the
    manager swaps in ``decision.program`` and the executor reads the
    decision from ``result.values["epilogue_fusion"]``."""
    from .epilogue_fusion import epilogue_fusion_pass

    return epilogue_fusion_pass(program, ctx)


def _dce_pass(program, ctx):
    """Opt-in dead-code elimination, proven by the fidelity witness in
    ``static_checks.dce_program`` (refuses rather than risk a wrong
    program). Reuses the cached dead_code report."""
    from .static_checks import dce_program

    report = ctx.analysis("dead_code")
    return dce_program(program, ctx.fetch_names, report=report)


def register_builtins(reg: PassRegistry) -> None:
    for name in ("schema", "dataflow", "lowerability", "shape_replay"):
        reg.register(FunctionPass(_verifier_pass(name), name, ANALYSIS))
    reg.register(FunctionPass(_liveness_pass, "liveness", ANALYSIS))
    reg.register(FunctionPass(_dtype_shape_pass, "dtype_shape_check",
                              ANALYSIS))
    reg.register(FunctionPass(_donation_race_pass, "donation_race",
                              ANALYSIS, requires=("liveness",)))
    # dead_code derives its mark-and-sweep from the effect classifier
    # directly; it does NOT consume the liveness chains, so it declares no
    # dependency (requesting only dead_code must not drag PT50x findings in)
    reg.register(FunctionPass(_dead_code_pass, "dead_code", ANALYSIS))
    reg.register(FunctionPass(_cost_model_pass, "cost_model", ANALYSIS))
    reg.register(FunctionPass(_numerics_check_pass, "numerics_check",
                              ANALYSIS))
    reg.register(FunctionPass(_auto_remat_pass, "auto_remat", TRANSFORM,
                              invalidates=("*",)))
    reg.register(FunctionPass(_epilogue_fusion_pass, "epilogue_fusion",
                              TRANSFORM, requires=("liveness",),
                              invalidates=("*",)))
    reg.register(FunctionPass(_dce_pass, "dce", TRANSFORM,
                              requires=("dead_code",),
                              invalidates=("*",)))
