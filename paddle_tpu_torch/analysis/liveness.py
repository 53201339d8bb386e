"""Liveness and effect analysis over ``Program`` blocks (counterpart of
``paddle_tpu/analysis/liveness.py``):

* ``classify_op_effects`` — per-op effect classification: pure / in-place
  alias / RNG / collective / side-effecting / control-flow.
* ``block_liveness``      — def/use chains and live intervals per var, with
  conservative cross-block capture for sub-blocks (a sub-block read counts
  as a read at the owning op's index, via the verifier's ``_block_reads``).
  Epilogue fusion's single-consumer proofs read its ``uses`` lists; the
  executor releases each value after its last reader from it.
* ``donation_candidates`` / ``safe_donation_set`` / ``donation_report`` —
  the persistables read into a step and rewritten by it, and which of
  them are provably safe to update in place.
* ``memory_plan``         — linear-scan peak-memory estimate of live bytes
  per op index (weights / gradients / optimizer state / activations split
  out), surfaced as ``Program.memory_plan()``; auto-remat
  (``analysis/remat.py``) scores its checkpoint sets with it.
* ``check_liveness``      — the PT50x diagnostics the registered
  ``liveness`` pass reports.

With ``mesh=..., specs=...`` the plan is per rank: each var's live bytes
divide by its propagated spec's shard count (``analysis.sharding_check``)
and collective staging is charged at the emitting op.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core import registry
from .diagnostics import Diagnostic
from .verifier import EMPTY, _block_reads, _raw_attr_var_names, _site

__all__ = [
    "OpEffects", "classify_op_effects", "VarLive", "block_liveness",
    "donation_candidates", "safe_donation_set", "donation_report",
    "MemoryPlan", "VarPlanEntry", "memory_plan", "check_liveness",
    "PURE", "INPLACE", "RNG", "COLLECTIVE", "SIDE_EFFECT", "CONTROL_FLOW",
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

    def interval(self, n_ops: int) -> Optional[Tuple[int, int]]:
        """Half-open [start, end) op-index range where the var's buffer is
        live; None for a var with no events (dead declaration)."""
        events = self.defs + self.uses
        if not events and not (self.live_in and self.live_out):
            return None
        start = 0 if self.live_in else min(events)
        end = n_ops if self.live_out else (max(events) + 1 if events
                                           else n_ops)
        return (start, max(end, start))


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


# ---------------------------------------------------------------------------
# proven-safe buffer donation
# ---------------------------------------------------------------------------

def donation_candidates(block, feed_names: Sequence[str] = (),
                        fetch_names: Sequence[str] = ()) -> Set[str]:
    """Scope vars both read into the step and re-written as persistables
    (``state_in ∩ state_out``). The proven set is a subset of this."""
    cands, _, _ = _donation_analysis(block, feed_names, fetch_names)
    return cands


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


def safe_donation_set(block, feed_names: Sequence[str] = (),
                      fetch_names: Sequence[str] = ()) -> Set[str]:
    """Scope vars whose input buffers are PROVEN safe to update in place:
    read into the step, re-written as persistables, never read after the
    last write, and not in the fetch list."""
    cands, unsafe, _ = _donation_analysis(block, feed_names, fetch_names)
    return cands - set(unsafe)


def donation_report(block, feed_names: Sequence[str] = (),
                    fetch_names: Sequence[str] = ()) -> Dict[str, str]:
    """name -> 'donated' or the reason donation was refused (debug aid)."""
    cands, unsafe, _ = _donation_analysis(block, feed_names, fetch_names)
    return {n: unsafe.get(n, "donated") for n in sorted(cands)}


# ---------------------------------------------------------------------------
# peak-memory plan (linear scan over live intervals)
# ---------------------------------------------------------------------------

WEIGHT = "weight"
OPTIMIZER_STATE = "optimizer_state"
GRADIENT = "gradient"
ACTIVATION = "activation"
PERSISTABLE_OTHER = "persistable_other"
SUB_BLOCK = "sub_block"
COLLECTIVE_STAGING = "collective_staging"  # per-chip plans only

_CLASSES = (WEIGHT, GRADIENT, OPTIMIZER_STATE, ACTIVATION,
            PERSISTABLE_OTHER, SUB_BLOCK)


def _classify_var(v) -> str:
    if getattr(v, "is_optimizer_state", False):
        return OPTIMIZER_STATE
    if getattr(v, "trainable", None) is not None:  # Parameter duck-type
        return WEIGHT
    if v.name.endswith("@GRAD"):
        return GRADIENT
    if v.persistable:
        return PERSISTABLE_OTHER
    return ACTIVATION


def _var_bytes(v, batch_size: int) -> Tuple[int, bool]:
    """(bytes, had_dynamic_dims). -1/None dims are resolved to batch_size —
    the plan is an estimate parameterized on batch, not a measurement."""
    if v.shape is None:
        return 0, True
    from ..core.types import np_dtype

    try:
        item = int(np_dtype(v.dtype).itemsize)
    except Exception:
        item = 4
    numel, dynamic = 1, False
    for d in v.shape:
        d = int(d) if d is not None else -1
        if d < 0:
            d, dynamic = int(batch_size), True
        numel *= d
    return numel * item, dynamic


@dataclasses.dataclass
class VarPlanEntry:
    name: str
    cls: str
    bytes: int          # PLANNED bytes: per-chip when the plan has a mesh
    start: int
    end: int            # half-open [start, end)
    shape: Optional[tuple]
    dtype: str
    site: str           # build site of the first producing op, if any
    dynamic: bool       # bytes include batch-resolved -1 dims
    # per-chip mode only (sharding_check specs); None on the single-device
    # path so its dict form stays bit-identical to the pre-mesh planner
    spec: Optional[tuple] = None
    global_bytes: Optional[int] = None

    def to_dict(self) -> dict:
        d = {"name": self.name, "class": self.cls, "bytes": self.bytes,
             "start": self.start, "end": self.end,
             "shape": list(self.shape) if self.shape else None,
             "dtype": self.dtype, "site": self.site,
             "dynamic": self.dynamic}
        if self.spec is not None:
            d["spec"] = list(self.spec)
            d["global_bytes"] = self.global_bytes
        return d


def _fmt_bytes(b: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024 or unit == "GiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b} B"
        b /= 1024.0
    return f"{b:.1f} GiB"


@dataclasses.dataclass
class MemoryPlan:
    """Linear-scan live-byte estimate for one block (reference: the
    memory_optimize_pass' MemOptVarInfo reference-count schedule, recast as
    a static plan). ``timeline[i]`` is the estimated bytes live while op
    ``i`` runs; sub-block peaks are charged at the owning op's index."""

    block_idx: int
    n_ops: int
    batch_size: int
    entries: List[VarPlanEntry]
    timeline: List[int]
    class_timeline: Dict[str, List[int]]
    sub_plans: Dict[int, "MemoryPlan"]
    # per-chip mode (Program.memory_plan(mesh=...)): the mesh shape and
    # the collective staging bytes charged per op index; None/empty on the
    # single-device path, which is byte-identical to the pre-mesh planner
    mesh: Optional[Dict[str, int]] = None
    staging_timeline: Optional[List[int]] = None

    @property
    def peak_bytes(self) -> int:
        return max(self.timeline) if self.timeline else 0

    @property
    def peak_op_idx(self) -> int:
        if not self.timeline:
            return 0
        return max(range(len(self.timeline)), key=self.timeline.__getitem__)

    def by_class_at(self, oi: int) -> Dict[str, int]:
        return {c: t[oi] for c, t in self.class_timeline.items()
                if t and t[oi]}

    def live_at(self, oi: int) -> List[VarPlanEntry]:
        return [e for e in self.entries if e.start <= oi < e.end]

    def top_hot_spots(self, n: int = 10) -> List[VarPlanEntry]:
        """Largest live ranges at the peak op — the buffers a
        rematerialization / reuse pass would attack first."""
        peak = self.peak_op_idx
        return sorted(self.live_at(peak),
                      key=lambda e: (-e.bytes, e.start, e.name))[:n]

    def to_dict(self) -> dict:
        peak = self.peak_op_idx
        d = {
            "block_idx": self.block_idx,
            "n_ops": self.n_ops,
            "batch_size": self.batch_size,
            "peak_bytes": self.peak_bytes,
            "peak_op_idx": peak,
            "by_class_at_peak": self.by_class_at(peak),
            "hot_spots": [e.to_dict() for e in self.top_hot_spots()],
            "sub_block_peaks": {str(oi): p.peak_bytes
                                for oi, p in self.sub_plans.items()},
        }
        if self.mesh is not None:
            d["mesh"] = dict(self.mesh)
            d["per_chip"] = True
            if self.staging_timeline:
                d["staging_at_peak"] = self.staging_timeline[peak] \
                    if peak < len(self.staging_timeline) else 0
                d["staging_peak_bytes"] = max(self.staging_timeline)
        return d

    def format(self, top: int = 10) -> str:
        peak = self.peak_op_idx
        chip = ""
        if self.mesh is not None:
            chip = (" PER CHIP on mesh "
                    + "x".join(f"{k}={v}" for k, v in self.mesh.items()))
        lines = [f"block {self.block_idx}: {self.n_ops} ops, peak "
                 f"{_fmt_bytes(self.peak_bytes)}{chip} at op {peak} "
                 f"(batch={self.batch_size})"]
        breakdown = self.by_class_at(peak)
        if breakdown:
            lines.append("  at peak: " + ", ".join(
                f"{c} {_fmt_bytes(b)}" for c, b in sorted(
                    breakdown.items(), key=lambda kv: -kv[1])))
        lines.append(f"  top {top} live-range hot spots at peak:")
        for e in self.top_hot_spots(top):
            span = f"[{e.start},{e.end})"
            dyn = " (batch-resolved)" if e.dynamic else ""
            lines.append(f"    {_fmt_bytes(e.bytes):>10}  {e.cls:<17} "
                         f"{e.name:<32} live {span}{dyn}")
            if e.site:
                lines.append(f"               built at {e.site}")
        return "\n".join(lines)


def memory_plan(program, feed_names: Sequence[str] = (),
                fetch_names: Sequence[str] = (), batch_size: int = 1,
                block_idx: int = 0, _seen: Optional[Set[int]] = None,
                mesh: Optional[Dict[str, int]] = None,
                specs: Optional[Dict[str, tuple]] = None,
                staging: Optional[Dict[tuple, int]] = None) -> MemoryPlan:
    """Linear-scan peak-memory estimate for ``program.blocks[block_idx]``.

    Sub-blocks are planned recursively and their peak charged at the owning
    op's index (the whole loop body is one program point — conservative for
    a ``while`` whose true peak is inside the body).

    With ``mesh``/``specs`` (propagated shard specs from
    ``analysis.sharding_check``; see ``Program.memory_plan(mesh=...)``)
    the plan is **per chip**: each var's live bytes divide by its spec's
    shard count (replicated tensors — and vars with no spec, including
    every sub-block-only var — count whole: a conservative OVER-estimate,
    never under), and ``staging`` charges collective scratch at the
    emitting op's index. With ``mesh=None`` (the default) the code path
    and numbers are identical to the single-device planner."""
    _seen = set() if _seen is None else _seen
    _seen.add(block_idx)
    block = program.blocks[block_idx]
    n_ops = max(len(block.ops), 1)
    live = block_liveness(block, feed_names, fetch_names)
    per_chip = mesh is not None
    if per_chip:
        from .sharding_check import spec_divisor

    entries: List[VarPlanEntry] = []
    for name, vl in sorted(live.items()):
        v = block.vars.get(name)
        if v is None:
            continue  # sub-block-local name or scope alias; charged there
        span = vl.interval(n_ops)
        if span is None:
            continue
        nbytes, dynamic = _var_bytes(v, batch_size)
        site = ""
        if vl.defs:
            site = block.ops[vl.defs[0]].attrs.get("op_callstack", "") or ""
        spec = None
        global_bytes = None
        if per_chip:
            spec = tuple((specs or {}).get(name, ()))
            global_bytes = nbytes
            nbytes //= spec_divisor(spec, mesh, v.shape, batch_size)
        entries.append(VarPlanEntry(
            name=name, cls=_classify_var(v), bytes=nbytes,
            start=span[0], end=span[1], shape=v.shape,
            dtype=str(v.dtype), site=site, dynamic=dynamic,
            spec=spec, global_bytes=global_bytes))

    timeline = [0] * n_ops
    class_timeline = {c: [0] * n_ops for c in _CLASSES}
    for e in entries:
        for i in range(e.start, min(e.end, n_ops)):
            timeline[i] += e.bytes
            class_timeline[e.cls][i] += e.bytes

    staging_timeline: Optional[List[int]] = None
    if per_chip and staging:
        staging_timeline = [0] * n_ops
        for (bidx, oi), nbytes in staging.items():
            if bidx == block_idx and 0 <= oi < n_ops:
                staging_timeline[oi] += int(nbytes)
                timeline[oi] += int(nbytes)
        # its own class bucket so by_class_at(peak) / format() reconcile
        # with the reported peak (single-device plans never get the key)
        class_timeline[COLLECTIVE_STAGING] = list(staging_timeline)

    sub_plans: Dict[int, MemoryPlan] = {}
    for oi, op in enumerate(block.ops):
        sub = op.attrs.get("sub_block")
        if (isinstance(sub, int) and 0 <= sub < len(program.blocks)
                and sub not in _seen):
            sp = memory_plan(program, (), (), batch_size, sub, _seen,
                             mesh=mesh, specs=specs, staging=staging)
            sub_plans[oi] = sp
            timeline[oi] += sp.peak_bytes
            class_timeline[SUB_BLOCK][oi] += sp.peak_bytes

    return MemoryPlan(block_idx=block_idx, n_ops=len(block.ops),
                      batch_size=batch_size, entries=entries,
                      timeline=timeline, class_timeline=class_timeline,
                      sub_plans=sub_plans,
                      mesh=dict(mesh) if per_chip else None,
                      staging_timeline=staging_timeline)


# ---------------------------------------------------------------------------
# PT5xx diagnostic pass (wired into verify_program; docs/ANALYSIS.md)
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
