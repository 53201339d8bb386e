"""Liveness and effect analysis over ``Program`` blocks (counterpart of
``paddle_tpu/analysis/liveness.py``), the part epilogue fusion needs:

* ``classify_op_effects`` — per-op effect classification: pure / in-place
  alias / RNG / collective / side-effecting / control-flow.
* ``block_liveness``      — def/use chains and live intervals per var, with
  conservative cross-block capture for sub-blocks (a sub-block read counts
  as a read at the owning op's index, via the verifier's ``_block_reads``).
  Epilogue fusion's single-consumer proofs read its ``uses`` lists.
* ``_donation_analysis``  — the persistables read into a step and
  rewritten by it, and which of them are provably safe to update in place.
* ``check_liveness``      — the PT50x diagnostics the registered
  ``liveness`` pass reports.

``memory_plan`` and ``donation_report`` arrive with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core import registry
from .diagnostics import Diagnostic
from .verifier import EMPTY, _block_reads, _raw_attr_var_names, _site

__all__ = [
    "OpEffects", "classify_op_effects", "VarLive", "block_liveness",
    "check_liveness", "PURE", "INPLACE", "RNG", "COLLECTIVE", "SIDE_EFFECT",
    "CONTROL_FLOW",
]


# ---------------------------------------------------------------------------
# effect classification
# ---------------------------------------------------------------------------

PURE = "pure"                  # output depends only on inputs/attrs
INPLACE = "inplace"            # writes an output var that is also an input
RNG = "rng"                    # draws from the per-op PRNG stream
COLLECTIVE = "collective"      # cross-replica communication
SIDE_EFFECT = "side_effect"    # observable outside the value graph
CONTROL_FLOW = "control_flow"  # runs a sub-block (while/cond/recurrent)

# none of these are registered in the port; program dumps may carry them
# — classify, don't crash
_COLLECTIVE_TYPES = frozenset({
    "allreduce", "broadcast", "allgather", "reduce_scatter", "barrier",
    "send", "recv", "send_barrier", "fetch_barrier",
})
_SIDE_EFFECT_TYPES = frozenset({
    "feed", "fetch", "print", "py_func", "save", "load",
    "save_combine", "load_combine",
})


@dataclasses.dataclass(frozen=True)
class OpEffects:
    """Effect summary of one op."""

    kind: str
    # output names that alias an input name (in-place rebinding of the var)
    inplace: Tuple[str, ...] = ()
    sub_block: Optional[int] = None

    @property
    def eliminable(self) -> bool:
        """May the op be dropped when nothing reads its outputs? RNG and
        in-place ops are value-only here (keys are derived per-op, not from
        a mutable global stream), so only communication, sub-blocks and
        true side effects pin an op."""
        return self.kind not in (SIDE_EFFECT, COLLECTIVE, CONTROL_FLOW)


def classify_op_effects(op) -> OpEffects:
    ins = {n for n in op.input_arg_names if n != EMPTY}
    inplace = tuple(sorted({n for n in op.output_arg_names
                            if n != EMPTY and n in ins}))
    sub = op.attrs.get("sub_block")
    sub = sub if isinstance(sub, int) else None
    t = op.type
    if t in _SIDE_EFFECT_TYPES:
        kind = SIDE_EFFECT
    elif t.startswith("c_") or t in _COLLECTIVE_TYPES:
        kind = COLLECTIVE
    elif sub is not None or (registry.has_op(t)
                             and registry.get_op_def(t).raw):
        kind = CONTROL_FLOW
    elif registry.has_op(t) and registry.get_op_def(t).needs_rng:
        kind = RNG
    elif inplace:
        kind = INPLACE
    else:
        kind = PURE
    return OpEffects(kind=kind, inplace=inplace, sub_block=sub)


# ---------------------------------------------------------------------------
# per-block liveness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VarLive:
    """Def/use chain of one var within one block. Sub-block accesses are
    charged to the owning raw op's index (conservative: the whole loop body
    counts as one program point)."""

    name: str
    defs: List[int] = dataclasses.field(default_factory=list)
    uses: List[int] = dataclasses.field(default_factory=list)
    live_in: bool = False   # value enters the block from feed/scope
    live_out: bool = False  # value must survive the block (persistable/fetch)

    @property
    def first_def(self) -> Optional[int]:
        return self.defs[0] if self.defs else None

    @property
    def last_def(self) -> Optional[int]:
        return self.defs[-1] if self.defs else None

    @property
    def last_use(self) -> Optional[int]:
        return self.uses[-1] if self.uses else None


def _op_accesses(program, op, memo) -> Tuple[Set[str], Set[str]]:
    """(reads, writes) of one op, folding sub-block reads into the op."""
    reads = {n for n in op.input_arg_names if n != EMPTY}
    writes = {n for n in op.output_arg_names if n != EMPTY}
    sub = op.attrs.get("sub_block")
    if isinstance(sub, int) and 0 <= sub < len(program.blocks):
        reads.update(_block_reads(program, sub, memo))
        reads.update(_raw_attr_var_names(op))
    return reads, writes


def block_liveness(block, feed_names: Sequence[str] = (),
                   fetch_names: Sequence[str] = ()) -> Dict[str, VarLive]:
    """Dataflow liveness for one block. Reads inside nested sub-blocks count
    as reads at the owning op's index, so a ``while`` body reading an outer
    var keeps it live across the loop (and blocks its donation unless the
    loop itself rewrites it)."""
    program = block.program
    memo: Dict[int, Set[str]] = {}
    feed = set(feed_names)
    fetch = set(fetch_names)
    persistable = {v.name for v in block.vars.values() if v.persistable}

    live: Dict[str, VarLive] = {}

    def rec(name: str) -> VarLive:
        vl = live.get(name)
        if vl is None:
            vl = live[name] = VarLive(name)
        return vl

    for oi, op in enumerate(block.ops):
        reads, writes = _op_accesses(program, op, memo)
        for n in reads:
            rec(n).uses.append(oi)
        for n in writes:
            rec(n).defs.append(oi)

    for n, vl in live.items():
        fd, fu = vl.first_def, (vl.uses[0] if vl.uses else None)
        # live-in: fed, or read before (or at) the first local write — a
        # read at the defining op's own index observes the incoming value
        # (read-modify-write ops like sgd's Param -> ParamOut)
        vl.live_in = (n in feed
                      or (fu is not None and (fd is None or fu <= fd)))
        vl.live_out = n in fetch or n in persistable
    return live


def _donation_analysis(block, feed_names: Sequence[str] = (),
                       fetch_names: Sequence[str] = ()
                       ) -> Tuple[Set[str], Dict[str, str],
                                  Dict[str, VarLive]]:
    feed = set(feed_names)
    fetch = set(fetch_names)
    live = block_liveness(block, feed_names, fetch_names)
    persistable = {v.name for v in block.vars.values() if v.persistable}
    cands = {n for n, vl in live.items()
             if vl.live_in and vl.defs and n in persistable
             and n not in feed}
    unsafe: Dict[str, str] = {}
    for n in sorted(cands):
        vl = live[n]
        if n in fetch:
            unsafe[n] = ("fetched: the caller's fetch result and the scope "
                         "could observe a consumed buffer")
        elif vl.last_use is not None and vl.last_use > vl.last_def:
            unsafe[n] = (f"read at op {vl.last_use} after its last write "
                         f"(op {vl.last_def}); the old buffer is not "
                         f"provably dead")
    return cands, unsafe, live


# ---------------------------------------------------------------------------
# PT5xx diagnostics (reported by the registered liveness pass)
# ---------------------------------------------------------------------------

def _global_reads(program) -> Set[str]:
    # _block_reads already folds _raw_attr_var_names in for every
    # sub-block-owning op, so a plain union over all blocks is complete
    memo: Dict[int, Set[str]] = {}
    reads: Set[str] = set()
    for blk in program.blocks:
        reads.update(_block_reads(program, blk.idx, memo))
    return reads


def check_liveness(program, diags: List[Diagnostic],
                   fetch_names: Sequence[str],
                   donation: Optional[tuple] = None) -> None:
    """``donation`` lets a caller that already ran ``_donation_analysis``
    on the global block (the registered liveness pass caches it on the
    PassContext) hand it in instead of paying the dataflow scan twice."""
    fetch = set(fetch_names or ())
    persistable = {v.name for blk in program.blocks
                   for v in blk.vars.values() if v.persistable}
    gb = program.blocks[0]
    feeds = {v.name for v in gb.vars.values() if v.is_data}

    # PT500 — donation-unsafe fetch: the fetched var is also updated in
    # place by the step, so its buffer must not be consumed by the update
    # while the fetch still holds it.
    cands, unsafe, live = donation if donation is not None \
        else _donation_analysis(gb, feeds, fetch)
    for n in sorted(cands & fetch):
        ld = live[n].last_def
        op = gb.ops[ld] if ld is not None else None
        diags.append(Diagnostic(
            "PT500",
            f"var '{n}' is updated in place and fetched — its buffer is "
            f"excluded from donation (a donated buffer could be consumed "
            f"while the fetch still references it)",
            gb.idx, ld, op.type if op else None, _site(op) if op else ""))

    global_reads = _global_reads(program)
    all_writes: Set[str] = set()
    for blk in program.blocks:
        for op in blk.ops:
            all_writes.update(n for n in op.output_arg_names if n != EMPTY)

    # owner chain for PT504: sub-block idx -> (owning block, owning op)
    owner: Dict[int, tuple] = {}
    for blk in program.blocks:
        for op in blk.ops:
            sub = op.attrs.get("sub_block")
            if isinstance(sub, int) and 0 <= sub < len(program.blocks):
                owner[sub] = (blk, op)

    def escape_names(bidx: int) -> Set[str]:
        """Names a sub-block write can escape through: the Out slots of the
        owning raw-op chain up to the global block."""
        names: Set[str] = set()
        seen: Set[int] = set()
        while bidx in owner and bidx not in seen:
            seen.add(bidx)
            blk, op = owner[bidx]
            names.update(op.output_arg_names)
            bidx = blk.idx
        return names

    for blk in program.blocks:
        # PT501 — write-after-fetch: an explicit fetch op's var is rewritten
        # later in the block. A step fetches FINAL values, so the fetch
        # would observe the post-write value, not the value at the fetch
        # op's position.
        writes_at: Dict[str, List[int]] = {}
        for oi, op in enumerate(blk.ops):
            for n in op.output_arg_names:
                if n != EMPTY:
                    writes_at.setdefault(n, []).append(oi)
        for oi, op in enumerate(blk.ops):
            if op.type != "fetch":
                continue
            for n in op.input_arg_names:
                later = [w for w in writes_at.get(n, []) if w > oi]
                if later:
                    diags.append(Diagnostic(
                        "PT501",
                        f"var '{n}' is written (op {later[0]}) after its "
                        f"fetch op {oi}; the compiled step fetches final "
                        f"values, so the fetch observes the later write",
                        blk.idx, oi, op.type, _site(op)))

        # PT502 — dead op: effect-free op none of whose outputs is ever
        # read, fetched or persistable (op-level view of PT203).
        for oi, op in enumerate(blk.ops):
            eff = classify_op_effects(op)
            if not eff.eliminable:
                continue
            outs = [n for n in op.output_arg_names if n != EMPTY]
            if outs and all(n not in global_reads and n not in fetch
                            and n not in persistable for n in outs):
                diags.append(Diagnostic(
                    "PT502",
                    f"dead op: no output of '{op.type}' "
                    f"({', '.join(sorted(outs))}) is read, fetched or "
                    f"persistable — the op computes nothing observable",
                    blk.idx, oi, op.type, _site(op)))

        # PT503 — dead var: declared but never read or written anywhere.
        for v in blk.vars.values():
            if v.is_data or v.persistable:
                continue
            n = v.name
            if (n not in global_reads and n not in all_writes
                    and n not in fetch):
                diags.append(Diagnostic(
                    "PT503",
                    f"dead var: '{n}' is declared in block {blk.idx} but no "
                    f"op reads or writes it",
                    blk.idx, None, None, ""))

        # PT504 — persistable rebound inside a sub-block: a step stores
        # back only what the global block's ops write, so a persistable
        # written in a sub-block without escaping through the owning op's
        # outputs silently never reaches the scope.
        if blk.parent_idx >= 0:
            escapes = escape_names(blk.idx)
            reported: Set[str] = set()
            for oi, op in enumerate(blk.ops):
                for n in op.output_arg_names:
                    if (n != EMPTY and n in persistable
                            and n not in escapes and n not in reported):
                        reported.add(n)
                        diags.append(Diagnostic(
                            "PT504",
                            f"persistable '{n}' is written inside sub-block "
                            f"{blk.idx} but is not an output of the owning "
                            f"control-flow op — the scope will never "
                            f"observe the update",
                            blk.idx, oi, op.type, _site(op)))
