"""Static-analysis passes over the shared PassContext (counterpart of
``paddle_tpu/analysis/static_checks.py``, with its codes and messages).

Three diagnostic families the pass manager makes cheap — donation_race
leans on the liveness pass' cached def/use + donation analysis instead of
re-deriving it; dead_code is a standalone mark-and-sweep over the effect
classifier:

* ``check_dtype_shape``  (PT700–PT704) — whole-program dtype/shape replay:
  re-runs ``infer_shape`` across op boundaries WITHOUT restoring metadata
  between ops, so a producer whose replayed output disagrees with the
  recorded metadata is reported at the consumer that observes the drift
  (the shape_replay pass, PT40x, checks each op in isolation; this pass
  checks the op-to-op contract).
* ``check_donation_race`` (PT710–PT713) — the static face of the
  donation-hazard class (in the port: state an op updates in place): variables the old heuristic would donate but a
  later op still reads, unordered double writes, fetches that view a
  donated buffer, and in-place writes to feed vars.
* ``check_dead_code``     (PT720–PT722) — transitive dead-op closure (the
  chain extension of PT502), unused outputs of live ops, unreachable
  sub-blocks; plus ``dce_program``, the opt-in transform that removes the
  proven-dead set, gated by a fidelity witness (refuse, never a wrong
  program — the remat pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core import registry
from .diagnostics import Diagnostic, Severity
from .verifier import EMPTY, _block_reads, _raw_attr_var_names, _site
from .liveness import classify_op_effects

__all__ = [
    "check_dtype_shape", "check_donation_race", "check_dead_code",
    "DeadCodeReport", "DceDecision", "dce_program", "VIEW_OP_TYPES",
]

# identity-like ops whose rule may return a view of the input (no data
# movement: torch's reshape/squeeze/flatten) — the PT712 alias-into-fetch
# surface
VIEW_OP_TYPES = frozenset({
    "assign", "reshape", "reshape2", "squeeze", "squeeze2", "unsqueeze",
    "unsqueeze2", "flatten", "flatten2", "share_data",
})


def _feeds_of(program, ctx) -> Set[str]:
    feeds = {v.name for v in program.global_block.vars.values() if v.is_data}
    feeds.update(ctx.feed_names)
    return feeds


# ---------------------------------------------------------------------------
# PT700s — whole-program dtype/shape consistency
# ---------------------------------------------------------------------------

def check_dtype_shape(program, ctx) -> List[Diagnostic]:
    """Replay ``infer_shape`` over every block in program order WITHOUT
    restoring var metadata between ops, so inferred shapes/dtypes propagate
    across op boundaries the way they will at lowering time. Mismatches are
    reported at the producer with the first consumer named (both with
    ``op_callstack`` build sites). All metadata is restored afterwards."""
    diags: List[Diagnostic] = []
    snapshot = {}
    for blk in program.blocks:
        for v in blk.vars.values():
            snapshot[(blk.idx, v.name)] = (v.shape, v.dtype)
    try:
        for blk in program.blocks:
            _replay_block(program, blk, diags)
    finally:
        for blk in program.blocks:
            for v in blk.vars.values():
                old = snapshot.get((blk.idx, v.name))
                if old is not None:
                    v.shape, v.dtype = old
    for d in diags:
        ctx.report(d)
    return diags


def _replay_block(program, blk, diags: List[Diagnostic]) -> None:
    # var -> list of (op_idx, op) reading it, for consumer attribution
    read_at: Dict[str, List[Tuple[int, object]]] = {}
    for oi, op in enumerate(blk.ops):
        for n in op.input_arg_names:
            if n != EMPTY:
                read_at.setdefault(n, []).append((oi, op))

    def first_consumer_after(name: str, oi: int):
        for ci, cop in read_at.get(name, ()):
            if ci > oi:
                return ci, cop
        return None, None

    # var -> (producer_idx, inferred shape, inferred dtype) for PT703
    produced_meta: Dict[str, Tuple[int, object, object]] = {}
    reported: Set[Tuple[str, str, int]] = set()   # (code, var, op idx)

    for oi, op in enumerate(blk.ops):
        if op.type in ("feed", "fetch") or not registry.has_op(op.type):
            continue
        # PT704 — consumer reads a var with no recorded shape: propagation
        # is undecidable past this boundary (dynamic/raw-op outputs)
        for n in op.input_arg_names:
            if n == EMPTY or not blk.has_var(n):
                continue
            v = blk.var(n)
            if v.shape is None and not v.is_data \
                    and ("PT704", n, oi) not in reported:
                reported.add(("PT704", n, oi))
                diags.append(Diagnostic(
                    "PT704",
                    f"op '{op.type}' reads '{n}' whose shape is unknown — "
                    f"dtype/shape propagation is blind past this boundary",
                    blk.idx, oi, op.type, _site(op)))
        before = {}
        for n in op.output_arg_names:
            if n != EMPTY and blk.has_var(n):
                v = blk.var(n)
                before[n] = (v.shape, v.dtype)
        try:
            op.infer_shape()
        except Exception as e:
            diags.append(Diagnostic(
                "PT700",
                f"op '{op.type}': infer_shape fails under whole-program "
                f"replay ({type(e).__name__}: {e}) — an upstream producer "
                f"hands it metadata it cannot consume",
                blk.idx, oi, op.type, _site(op)))
            continue
        for n, (old_shape, old_dtype) in before.items():
            v = blk.var(n)
            prev = produced_meta.get(n)
            if prev is not None:
                pi, pshape, pdtype = prev
                if (pdtype != v.dtype
                        or (pshape is not None and v.shape is not None
                            and tuple(pshape) != tuple(v.shape))):
                    diags.append(Diagnostic(
                        "PT703",
                        f"'{n}' is written by op {pi} as "
                        f"{_meta(pshape, pdtype)} and rebound by op {oi} "
                        f"('{op.type}') as {_meta(v.shape, v.dtype)} — "
                        f"consumers see whichever write ran last",
                        blk.idx, oi, op.type, _site(op)))
            produced_meta[n] = (oi, v.shape, v.dtype)
            ci, cop = first_consumer_after(n, oi)
            if cop is None:
                continue
            if (old_shape is not None and v.shape is not None
                    and tuple(old_shape) != tuple(v.shape)):
                diags.append(Diagnostic(
                    "PT701",
                    f"op '{op.type}' replays '{n}' as shape "
                    f"{tuple(v.shape)} but the recorded shape its consumer "
                    f"op {ci} ('{cop.type}'{_consumer_site(cop)}) was built "
                    f"against is {tuple(old_shape)}",
                    blk.idx, oi, op.type, _site(op)))
            if old_dtype is not None and old_dtype != v.dtype:
                diags.append(Diagnostic(
                    "PT702",
                    f"op '{op.type}' replays '{n}' as dtype {v.dtype} but "
                    f"the recorded dtype its consumer op {ci} "
                    f"('{cop.type}'{_consumer_site(cop)}) was built "
                    f"against is {old_dtype}",
                    blk.idx, oi, op.type, _site(op)))


def _meta(shape, dtype) -> str:
    s = tuple(shape) if shape is not None else "?"
    return f"{dtype}{s}"


def _consumer_site(op) -> str:
    site = _site(op)
    return f" at {site}" if site else ""


# ---------------------------------------------------------------------------
# PT710s — donation/alias race detector
# ---------------------------------------------------------------------------

def check_donation_race(program, ctx) -> List[Diagnostic]:
    """Turn the donation-hazard class into static diagnostics.
    Uses the liveness pass' cached def/use chains and donation analysis
    (``ctx.analysis("liveness")``) — the executor refuses the unsafe
    donations at runtime; this pass explains them at build time."""
    diags: List[Diagnostic] = []
    live_info = ctx.analysis("liveness")
    gb = program.global_block
    live = live_info["live"]
    cands = live_info["cands"]
    unsafe = live_info["unsafe"]
    safe = cands - set(unsafe)
    fetch = set(ctx.fetch_names)

    # PT710 — donated on one path, still read later: the old heuristic's
    # set minus the proven set, for the read-after-write reason (the
    # fetched flavour is PT500's)
    for n in sorted(unsafe):
        if n in fetch:
            continue  # PT500 covers the fetched flavour
        vl = live[n]
        ld, lu = vl.last_def, vl.last_use
        op = gb.ops[lu] if lu is not None and lu < len(gb.ops) else None
        diags.append(Diagnostic(
            "PT710",
            f"'{n}' would be donated by the state_in∩state_out heuristic "
            f"but op {lu} still reads it after its last write (op {ld}) — "
            f"the donated buffer would already be consumed; the liveness "
            f"proof keeps it un-donated (a host copy per step)",
            gb.idx, lu, op.type if op else None, _site(op) if op else ""))

    # PT711 — unordered double writes, per block: two writes of one var
    # with no read of the var between them and no direct data dependency
    # (the later op reads nothing the earlier one produced). List order is
    # the only thing sequencing them.
    for blk in program.blocks:
        _check_unordered_writes(blk, diags)

    # PT712 — a fetched var that is a view of a donated var, taken BEFORE
    # the donated var's last in-place update: the fetch may alias the
    # consumed buffer (a view op's rule may return a view, no copy).
    for oi, op in enumerate(gb.ops):
        if op.type not in VIEW_OP_TYPES:
            continue
        srcs = [n for n in op.input_arg_names if n != EMPTY and n in safe]
        outs = [n for n in op.output_arg_names if n != EMPTY and n in fetch]
        for src in srcs:
            vl = live.get(src)
            if vl is None or vl.last_def is None or oi >= vl.last_def:
                continue  # view taken after the final write: consistent
            for out in outs:
                diags.append(Diagnostic(
                    "PT712",
                    f"fetch '{out}' is a '{op.type}' view of donated "
                    f"'{src}' taken at op {oi}, before '{src}'s last "
                    f"in-place write (op {vl.last_def}) — the fetched "
                    f"value may alias a consumed buffer",
                    gb.idx, oi, op.type, _site(op)))

    # PT713 — in-place write to a feed var: the user's host array and the
    # scope copy diverge silently (feeds are copied to the device per
    # step).
    feeds = _feeds_of(program, ctx)
    for blk in program.blocks:
        for oi, op in enumerate(blk.ops):
            if op.type in ("feed", "fetch"):
                continue
            for n in op.output_arg_names:
                if n != EMPTY and n in feeds:
                    diags.append(Diagnostic(
                        "PT713",
                        f"op '{op.type}' writes feed var '{n}' — the fed "
                        f"host buffer and the in-step value diverge; feed "
                        f"a copy or write a fresh var instead",
                        blk.idx, oi, op.type, _site(op)))

    for d in diags:
        ctx.report(d)
    return diags


def _check_unordered_writes(blk, diags: List[Diagnostic]) -> None:
    writes_at: Dict[str, List[int]] = {}
    reads_at: Dict[str, List[int]] = {}
    for oi, op in enumerate(blk.ops):
        if op.type in ("feed", "fetch"):
            continue
        for n in op.output_arg_names:
            if n != EMPTY:
                writes_at.setdefault(n, []).append(oi)
        for n in op.input_arg_names:
            if n != EMPTY:
                reads_at.setdefault(n, []).append(oi)
    for n, ws in writes_at.items():
        for a, b in zip(ws, ws[1:]):
            opb = blk.ops[b]
            b_reads = set(opb.input_arg_names)
            if n in b_reads:
                continue  # read-modify-write: ordered by the value chain
            if any(a < r < b for r in reads_at.get(n, ())):
                continue  # an intervening read orders the pair
            opa = blk.ops[a]
            a_outs = {x for x in opa.output_arg_names if x != EMPTY}
            if b_reads & a_outs:
                continue  # direct dependency on another of a's outputs
            diags.append(Diagnostic(
                "PT711",
                f"ops {a} ('{opa.type}') and {b} ('{opb.type}') both "
                f"write '{n}' with no read or data dependency between "
                f"them — only list order sequences the writes, and the "
                f"earlier value is unobservable",
                blk.idx, b, opb.type, _site(opb)))


# ---------------------------------------------------------------------------
# PT720s — dead/unreachable code lint + the opt-in DCE transform
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeadCodeReport:
    """The dead_code analysis result cached on the PassContext (also what
    the DCE transform consumes)."""

    # (block_idx, op_idx) of every transitively dead, eliminable op
    dead_ops: List[Tuple[int, int]]
    # (block_idx, op_idx, var name) unused outputs of live ops
    unused_outputs: List[Tuple[int, int, str]]
    # block idx of sub-blocks no op references
    unreachable_blocks: List[int]
    # every var name some live op still reads (for the DCE var sweep)
    needed_names: Set[str]

    def to_dict(self) -> dict:
        return {"dead_ops": [list(t) for t in self.dead_ops],
                "unused_outputs": [list(t) for t in self.unused_outputs],
                "unreachable_blocks": list(self.unreachable_blocks)}


def _dead_code_analysis(program, fetch_names: Sequence[str]
                        ) -> DeadCodeReport:
    """Backward mark-and-sweep over the whole program: roots are fetches,
    persistable writes, and non-eliminable ops (side effects, collectives,
    control flow); liveness propagates from an op to the producers of
    every name it (or its sub-blocks) reads. Ops never reached are
    transitively dead — including chains PT502 misses, where A's only
    reader is the dead op B."""
    fetch = set(fetch_names or ())
    persistable = {v.name for blk in program.blocks
                   for v in blk.vars.values() if v.persistable}
    memo: Dict[int, Set[str]] = {}

    ops = []  # (blk, oi, op, reads, writes, eliminable)
    producers: Dict[str, List[int]] = {}
    referenced_blocks: Set[int] = {0}
    for blk in program.blocks:
        for oi, op in enumerate(blk.ops):
            reads = {n for n in op.input_arg_names if n != EMPTY}
            sub = op.attrs.get("sub_block")
            if isinstance(sub, int) and 0 <= sub < len(program.blocks):
                referenced_blocks.add(sub)
                reads.update(_block_reads(program, sub, memo))
                reads.update(_raw_attr_var_names(op))
            writes = {n for n in op.output_arg_names if n != EMPTY}
            eff = classify_op_effects(op)
            idx = len(ops)
            ops.append((blk, oi, op, reads, writes, eff.eliminable))
            for n in writes:
                producers.setdefault(n, []).append(idx)

    # ops inside a sub-block live or die with the owning op's reachability;
    # the sweep below only ever removes GLOBAL-block ops, so sub-block ops
    # are rooted unless their whole block is unreachable
    live_ops: Set[int] = set()
    worklist: List[int] = []
    for idx, (blk, oi, op, reads, writes, eliminable) in enumerate(ops):
        rooted = (not eliminable
                  or op.type in ("feed", "fetch")
                  or blk.idx != 0
                  or any(n in fetch or n in persistable for n in writes))
        if rooted:
            live_ops.add(idx)
            worklist.append(idx)
    while worklist:
        idx = worklist.pop()
        for n in ops[idx][3]:           # reads of the live op
            for p in producers.get(n, ()):
                if p not in live_ops:
                    live_ops.add(p)
                    worklist.append(p)

    needed: Set[str] = set(fetch) | set(persistable)
    for idx in live_ops:
        needed.update(ops[idx][3])

    dead: List[Tuple[int, int]] = []
    unused: List[Tuple[int, int, str]] = []
    for idx, (blk, oi, op, reads, writes, eliminable) in enumerate(ops):
        if idx not in live_ops:
            dead.append((blk.idx, oi))
        elif blk.idx == 0 and op.type not in ("feed", "fetch"):
            for n in sorted(writes):
                if n not in needed:
                    unused.append((blk.idx, oi, n))

    unreachable = [blk.idx for blk in program.blocks
                   if blk.idx not in referenced_blocks]
    return DeadCodeReport(dead_ops=dead, unused_outputs=unused,
                          unreachable_blocks=unreachable,
                          needed_names=needed)


def check_dead_code(program, ctx) -> DeadCodeReport:
    """The PT720–PT722 lint pass; returns the ``DeadCodeReport`` the DCE
    transform reuses from the context cache."""
    report = _dead_code_analysis(program, ctx.fetch_names)
    for bidx, oi in report.dead_ops:
        op = program.blocks[bidx].ops[oi]
        outs = sorted(n for n in op.output_arg_names if n != EMPTY)
        ctx.report(Diagnostic(
            "PT720",
            f"transitively dead op: '{op.type}' ({', '.join(outs)}) "
            f"reaches no fetch, persistable or effect — every consumer "
            f"chain is itself dead",
            bidx, oi, op.type, _site(op)))
    for bidx, oi, n in report.unused_outputs:
        op = program.blocks[bidx].ops[oi]
        ctx.report(Diagnostic(
            "PT721",
            f"unused output: '{n}' of live op '{op.type}' is never read, "
            f"fetched or persistable",
            bidx, oi, op.type, _site(op)))
    for bidx in report.unreachable_blocks:
        ctx.report(Diagnostic(
            "PT722",
            f"sub-block {bidx} is unreachable: no op references it via a "
            f"sub_block attr",
            bidx, None, None, ""))
    return report


@dataclasses.dataclass
class DceDecision:
    """Outcome of the opt-in DCE transform (``applied=False`` => the
    original program is returned untouched, with the reason)."""

    applied: bool
    program: object
    reason: str
    removed_ops: int = 0
    removed_vars: int = 0

    def to_dict(self) -> dict:
        return {"applied": self.applied, "reason": self.reason,
                "removed_ops": self.removed_ops,
                "removed_vars": self.removed_vars}


def dce_program(program, fetch_names: Sequence[str] = (),
                report: Optional[DeadCodeReport] = None) -> DceDecision:
    """Remove the transitively dead op set from a CLONE of ``program``,
    gated by a fidelity witness (the remat pattern — refuse, never a wrong
    program): after removal the dead-code analysis is re-run on the result
    and must find zero dead ops and the identical needed-name set, and no
    live op may have lost a producer. Any witness failure refuses."""
    if report is None:
        report = _dead_code_analysis(program, fetch_names)
    if not report.dead_ops:
        return DceDecision(False, program, "no dead ops found")
    if any(bidx != 0 for bidx, _ in report.dead_ops):
        # sub-block surgery would need owner-op attr rewrites; refuse
        return DceDecision(False, program,
                           "dead ops inside sub-blocks — DCE only proves "
                           "global-block removals safe")

    p = program.clone()
    gb = p.global_block
    dead_idx = {oi for bidx, oi in report.dead_ops if bidx == 0}
    removed = [op for oi, op in enumerate(gb.ops) if oi in dead_idx]
    gb.ops = [op for oi, op in enumerate(gb.ops) if oi not in dead_idx]

    # drop vars only the removed ops touched (declared activations)
    still_used: Set[str] = set(report.needed_names)
    for op in gb.ops:
        still_used.update(n for n in op.input_arg_names if n != EMPTY)
        still_used.update(n for n in op.output_arg_names if n != EMPTY)
    removable = []
    for op in removed:
        for n in op.output_arg_names:
            if (n != EMPTY and n in gb.vars and n not in still_used
                    and not gb.vars[n].persistable
                    and not gb.vars[n].is_data):
                removable.append(n)
    for n in removable:
        del gb.vars[n]
    p._bump_version()

    # fidelity witness: the transformed program must be provably clean
    check = _dead_code_analysis(p, fetch_names)
    if check.dead_ops:
        return DceDecision(False, program,
                           "witness failed: removal exposed further dead "
                           "ops — refusing (run the lint, fix the build)")
    if check.needed_names - still_used:
        return DceDecision(False, program,
                           "witness failed: the transformed program needs "
                           "names the original analysis did not — refusing")
    missing = [n for n in check.needed_names
               if n not in gb.vars and not any(
                   n in blk.vars for blk in p.blocks)]
    if missing:
        return DceDecision(False, program,
                           f"witness failed: needed vars vanished "
                           f"({missing[:3]}) — refusing")
    return DceDecision(True, p,
                       f"removed {len(removed)} dead op(s), "
                       f"{len(removable)} var(s)",
                       removed_ops=len(removed),
                       removed_vars=len(removable))
