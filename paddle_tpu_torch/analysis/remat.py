"""Automatic rematerialisation (auto gradient checkpointing), the
counterpart of ``paddle_tpu/analysis/remat.py``.

The manual path: ``RecomputeOptimizer`` lets the user name checkpoint
activations before backward construction, and ``ops/recompute.py``
collapses each forward segment into ONE ``recompute_segment`` op whose
grad op replays it under autograd. By executor time the program is
already a complete forward+backward+optimize artifact, too late for the
manual API; this pass closes that gap. The candidate space is enumerated
from the program itself, each candidate configuration is *scored
statically* with the liveness planner (``Program.memory_plan``), and the
cheapest configuration that fits the budget wins. The planner models remat
faithfully because segment internals are demoted into sub-blocks (dead
between forward and backward) and the grad op inherits the ``sub_block``
attr.

Pipeline:

1. **Partition** the global block by ``__op_role__``: forward prefix,
   backward region, tail (optimize / lr_sched / trailing forward ops).
2. **Fidelity proof** — rebuild the program with NO checkpoints (strip the
   backward region, re-run ``append_backward`` on the same loss, reattach
   the tail) and require op-for-op equality with the original modulo
   volatile attrs (``__uid__``, build sites). Programs whose backward was
   not produced by the stock ``append_backward`` (custom no_grad sets,
   loss-scaled AMP, sub-block grads) fail this proof and are left
   untouched — auto-remat refuses rather than risks.
3. **Candidates** — forward ops at layer boundaries (where the
   ``op_callstack`` build site changes, i.e. the seam between two builder
   calls) with exactly one float activation flowing to later forward ops;
   sized via infer_shape shapes with ``-1`` dims resolved to the feed batch.
4. **Search** — segment counts from a geometric ladder are scored by
   rebuilding (clone → strip backward → ``insert_recompute_segments`` →
   re-append backward → reattach tail) and planning peak bytes. With
   ``FLAGS_remat_budget_mb`` set, the *cheapest* fitting set wins (most
   checkpoints = least recomputation); without a budget, sqrt(N)
   segmentation (Chen et al. 2016 gradient-checkpointing spacing).

The chosen program is a fresh ``Program`` with its own ``_serial``, so
executor keys can never alias remat and plain variants. Wiring:
``Executor._maybe_auto_remat`` (``FLAGS_auto_recompute``) on ``run`` and
``run_chained``; ``monitor.record_remat`` counts the decisions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..framework import OpRole, Program
from .verifier import EMPTY

__all__ = [
    "RematCandidate", "RematDecision", "RematError",
    "forward_region", "is_trainable_program", "find_loss_name",
    "remat_candidates", "rebuild_with_checkpoints",
    "auto_recompute_program",
]

# attrs that legitimately differ between an original program and a faithful
# rebuild: fresh uid stamps and the build site of re-appended ops
_VOLATILE_ATTRS = ("__uid__", "op_callstack", "op_namescope")


class RematError(RuntimeError):
    """Auto-remat could not transform the program (the caller should fall
    back to the untransformed program; the message says why)."""


def _op_signature(op) -> tuple:
    attrs = sorted((k, repr(v)) for k, v in op.attrs.items()
                   if k not in _VOLATILE_ATTRS)
    return (op.type,
            tuple(sorted((k, tuple(v)) for k, v in op.inputs.items())),
            tuple(sorted((k, tuple(v)) for k, v in op.outputs.items())),
            tuple(attrs))


def forward_region(block) -> Optional[int]:
    """Index of the first backward-role op in ``block``, i.e. the exclusive
    end of the forward prefix; None when the block has no backward ops
    (inference / startup programs)."""
    for i, op in enumerate(block.ops):
        if op.attrs.get("__op_role__", OpRole.Forward) == OpRole.Backward:
            return i
    return None


def is_trainable_program(program: Program) -> bool:
    return forward_region(program.global_block) is not None


def find_loss_name(block, first_bwd: int) -> Optional[str]:
    """The backward target: ``append_backward`` seeds the sweep with a
    backward-role ``fill_constant`` writing ``<loss>@GRAD`` = 1.0 (the very
    first backward op). Anything else — user cotangents, several targets —
    is not a stock training program and auto-remat refuses."""
    from ..framework import GRAD_VAR_SUFFIX

    op = block.ops[first_bwd]
    if op.type != "fill_constant":
        return None
    outs = op.output_arg_names
    if len(outs) != 1 or not outs[0].endswith(GRAD_VAR_SUFFIX):
        return None
    if float(op.attrs.get("value", 0.0)) != 1.0:
        return None
    name = outs[0][:-len(GRAD_VAR_SUFFIX)]
    return name if block.has_var(name) else None


# ---------------------------------------------------------------------------
# candidate discovery
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RematCandidate:
    """One legal checkpoint position: cutting after ``op_idx`` and saving
    ``var_name`` across the fwd/bwd gap costs ``nbytes`` of residency."""

    op_idx: int
    var_name: str
    nbytes: int
    site: str  # op_callstack build site of the producing op


def _activation_bytes(v, batch_size: int) -> Optional[int]:
    from .liveness import _var_bytes

    if v is None or v.shape is None:
        return None
    nbytes, _ = _var_bytes(v, batch_size)
    return nbytes


def remat_candidates(program: Program, batch_size: int = 1,
                     boundaries_only: bool = True) -> List[RematCandidate]:
    """Checkpointable positions in the forward region of ``program``.

    A forward op qualifies when exactly one of its outputs is a float,
    non-persistable, known-shape activation read by a LATER forward op (the
    value that flows across the would-be cut). With ``boundaries_only`` the
    list is restricted to layer boundaries — ops whose successor was built
    at a different user call site (``op_callstack``), the seam between two
    layer-builder invocations. Build sites record the first frame OUTSIDE
    the package, so models built by package code (models/bert.py) or inside
    a Python loop share one site for every op; when boundary filtering
    leaves fewer than 4 positions, all qualifying ops are returned and the
    even-spacing picker provides the layer structure instead."""
    from ..core.types import is_floating

    block = program.global_block
    first_bwd = forward_region(block)
    if first_bwd is None:
        return []
    fwd_ops = block.ops[:first_bwd]

    read_at: Dict[str, List[int]] = {}
    for i, op in enumerate(fwd_ops):
        for n in op.input_arg_names:
            if n != EMPTY:
                read_at.setdefault(n, []).append(i)

    all_cands: List[RematCandidate] = []
    boundary: List[RematCandidate] = []
    for i, op in enumerate(fwd_ops[:-1]):  # a cut at the last op is useless
        flowing: List[Tuple[str, int]] = []
        skip = False
        for n in op.output_arg_names:
            if n == EMPTY or not block.has_var(n):
                continue
            reads = read_at.get(n, [])
            if not any(r > i for r in reads):
                continue  # only backward/tail read it; not a forward seam
            v = block.var(n)
            if v.persistable or v.is_data or not is_floating(v.dtype):
                skip = True  # a persistable flowing forward: odd op, skip
                break
            nb = _activation_bytes(v, batch_size)
            if nb is None:
                skip = True
                break
            flowing.append((n, nb))
        if skip or len(flowing) != 1:
            continue
        name, nb = flowing[0]
        cand = RematCandidate(op_idx=i, var_name=name, nbytes=nb,
                              site=op.attrs.get("op_callstack", ""))
        all_cands.append(cand)
        if fwd_ops[i + 1].attrs.get("op_callstack", "") != cand.site:
            boundary.append(cand)
    if boundaries_only and len(boundary) >= 4:
        return boundary
    return all_cands


# ---------------------------------------------------------------------------
# program rebuild: strip backward -> segment forward -> regenerate backward
# ---------------------------------------------------------------------------

def rebuild_with_checkpoints(program: Program, loss_name: str,
                             checkpoints: Sequence[str],
                             extra_live: Sequence[str] = ()
                             ) -> Tuple[Program, int]:
    """Clone ``program``; drop its backward-role ops; collapse the forward
    region into ``recompute_segment`` ops at ``checkpoints`` (no-op when
    empty); regenerate the backward with ``append_backward``; reattach the
    non-backward tail (optimize / lr_sched / trailing forward ops) in their
    original order. Returns ``(rebuilt_program, n_segments)``.

    The rebuilt program is a fresh ``Program`` (own ``_serial``), so
    executor caches never alias it with the source program. ``extra_live``
    names (fetches, tail reads) are kept as segment outputs so transparent
    remat never breaks a fetch the way the manual API is allowed to."""
    from ..backward import append_backward
    from ..ops.recompute import insert_recompute_segments

    p = program.clone()
    blk = p.global_block
    first_bwd = forward_region(blk)
    if first_bwd is None:
        raise RematError("program has no backward ops — nothing to remat")
    tail = [op for op in blk.ops[first_bwd:]
            if op.attrs.get("__op_role__", OpRole.Forward) != OpRole.Backward]
    blk.ops = list(blk.ops[:first_bwd])
    if not blk.has_var(loss_name):
        raise RematError(f"loss var '{loss_name}' not in the global block")
    loss = blk.var(loss_name)

    tail_reads = {n for op in tail for n in op.input_arg_names if n != EMPTY}
    n_segments = 0
    if checkpoints:
        n_segments = insert_recompute_segments(
            loss, list(checkpoints),
            extra_live=sorted(tail_reads | set(extra_live)))
    append_backward(loss)
    blk.ops.extend(tail)
    p._bump_version()
    return p, n_segments


def _programs_equivalent(a: Program, b: Program) -> bool:
    ao, bo = a.global_block.ops, b.global_block.ops
    if len(ao) != len(bo):
        return False
    return all(_op_signature(x) == _op_signature(y) for x, y in zip(ao, bo))


# ---------------------------------------------------------------------------
# the chooser
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RematDecision:
    """Outcome of one auto-remat attempt (also the monitor/bench payload)."""

    applied: bool
    program: Program                  # transformed, or the original
    reason: str
    n_segments: int = 0
    n_candidates: int = 0
    checkpoints: Tuple[str, ...] = ()
    peak_before: int = 0
    peak_after: int = 0
    budget_bytes: Optional[int] = None
    batch_size: int = 1
    trials: List[dict] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "applied": self.applied, "reason": self.reason,
            "segments": self.n_segments, "candidates": self.n_candidates,
            "checkpoints": list(self.checkpoints),
            "predicted_peak_bytes_plain": self.peak_before,
            "predicted_peak_bytes_remat": self.peak_after,
            "budget_bytes": self.budget_bytes,
            "batch_size": self.batch_size,
            "trials": list(self.trials),
        }


def _pick_evenly(cands: List[RematCandidate],
                 k: int) -> List[RematCandidate]:
    """k checkpoints spread evenly over the candidate sequence (classic
    every-sqrt(N)th-layer spacing generalised to arbitrary k)."""
    n = len(cands)
    if k >= n:
        return list(cands)
    idxs = sorted({int(round((j + 1) * n / (k + 1.0))) - 1
                   for j in range(k)})
    return [cands[max(0, min(n - 1, i))] for i in idxs]


def _k_ladder(n: int, max_trials: int) -> List[int]:
    """Segment-count ladder, densest first: n, n/2, n/4, ..., plus the
    sqrt(N) default, deduped, capped at ``max_trials`` entries."""
    ks: List[int] = []
    k = n
    while k >= 1 and len(ks) < max_trials - 1:
        if k not in ks:
            ks.append(k)
        k //= 2
    s = max(1, int(round(math.sqrt(n))))
    if s not in ks:
        ks.append(s)
    return sorted(set(ks), reverse=True)[:max_trials]


def auto_recompute_program(program: Program,
                           feed_names: Sequence[str] = (),
                           fetch_names: Sequence[str] = (),
                           batch_size: int = 1,
                           budget_mb: int = 0,
                           max_trials: int = 6) -> RematDecision:
    """The auto-remat chooser: candidate discovery, static scoring via
    ``memory_plan``, budget fit, rebuild. Never raises on an untransformable
    program — it returns ``applied=False`` with the reason, and the caller
    runs the original (``RematError`` is internal)."""
    feed_names = list(feed_names)
    fetch_names = [getattr(f, "name", f) for f in (fetch_names or ())]
    batch_size = max(int(batch_size), 1)

    def refuse(reason: str, **kw) -> RematDecision:
        return RematDecision(applied=False, program=program, reason=reason,
                             batch_size=batch_size, **kw)

    if int(getattr(program, "_pipeline_microbatches", 1)) > 1:
        return refuse("pipeline program: the microbatch scan already "
                      "bounds activation residency")
    block = program.global_block
    first_bwd = forward_region(block)
    if first_bwd is None:
        return refuse("no backward ops (inference/startup program)")
    if any(op.type == "recompute_segment" for op in block.ops):
        return refuse("program already carries recompute segments "
                      "(manual RecomputeOptimizer)")
    loss_name = find_loss_name(block, first_bwd)
    if loss_name is None:
        return refuse("backward seed not recognised (custom cotangents or "
                      "non-stock backward) — cannot rebuild faithfully")

    try:
        plain, _ = rebuild_with_checkpoints(program, loss_name, ())
    except Exception as e:  # registry gaps, exotic ops
        return refuse(f"backward regeneration failed: {e}")
    if not _programs_equivalent(program, plain):
        return refuse("backward regeneration does not reproduce the "
                      "original program (custom no_grad/parameter_list, "
                      "loss scaling, or sub-block grads) — refusing")

    cands = remat_candidates(program, batch_size=batch_size)
    if not cands:
        return refuse("no checkpointable layer boundaries found")

    plan0 = program.memory_plan(feed_names=feed_names,
                                fetch_names=fetch_names,
                                batch_size=batch_size)
    peak0 = plan0.peak_bytes
    budget_bytes = int(budget_mb) * (1 << 20) if budget_mb else None
    if budget_bytes is not None and peak0 <= budget_bytes:
        # cheapest fitting set is NO checkpoints: the plain program already
        # fits; inserting segments would buy recompute cost for nothing
        return refuse(f"plain predicted peak {peak0 >> 20} MiB already "
                      f"fits the {budget_mb} MiB budget",
                      n_candidates=len(cands), peak_before=peak0,
                      budget_bytes=budget_bytes)

    def score(k: int) -> Tuple[Program, int, int, List[str]]:
        picks = [c.var_name for c in _pick_evenly(cands, k)]
        prog_k, nseg = rebuild_with_checkpoints(
            program, loss_name, picks, extra_live=fetch_names)
        plan = prog_k.memory_plan(feed_names=feed_names,
                                  fetch_names=fetch_names,
                                  batch_size=batch_size)
        return prog_k, nseg, plan.peak_bytes, picks

    trials: List[dict] = []
    best = None  # (program, nseg, peak, picks, k)
    if budget_bytes is None:
        k = max(1, int(round(math.sqrt(len(cands)))))
        prog_k, nseg, peak, picks = score(k)
        trials.append({"k": k, "segments": nseg, "peak_bytes": peak,
                       "fits": None})
        if nseg and peak < peak0:
            best = (prog_k, nseg, peak, picks, k)
    else:
        # cheapest first (max checkpoints = least recompute): the first
        # fitting rung wins; remember the min-peak rung as the fallback
        fallback = None
        for k in _k_ladder(len(cands), max_trials):
            prog_k, nseg, peak, picks = score(k)
            fits = peak <= budget_bytes
            trials.append({"k": k, "segments": nseg, "peak_bytes": peak,
                           "fits": fits})
            if nseg == 0:
                continue
            if fits:
                best = (prog_k, nseg, peak, picks, k)
                break
            if fallback is None or peak < fallback[2]:
                fallback = (prog_k, nseg, peak, picks, k)
        if best is None and fallback is not None \
                and fallback[2] < peak0:
            best = fallback

    if best is None:
        return refuse("no checkpoint set improved the predicted peak",
                      n_candidates=len(cands), peak_before=peak0,
                      budget_bytes=budget_bytes, trials=trials)

    prog_k, nseg, peak, picks, k = best
    return RematDecision(
        applied=True, program=prog_k,
        reason=(f"k={k} checkpoints over {len(cands)} boundaries"
                + (f", fits {budget_mb} MiB budget" if budget_bytes
                   and peak <= budget_bytes else
                   (", best effort over budget" if budget_bytes else
                    ", sqrt(N) default"))),
        n_segments=nseg, n_candidates=len(cands),
        checkpoints=tuple(picks), peak_before=peak0, peak_after=peak,
        budget_bytes=budget_bytes, batch_size=batch_size, trials=trials)
