"""Static SPMD sharding analysis over the Program IR (pass
``sharding_check``), the counterpart of
``paddle_tpu/analysis/sharding_check.py`` with its names, PT730-PT744
codes, finding keys and messages.

* ``propagate_sharding`` takes a mesh shape (``{"dp": 2}``) and a
  per-param spec assignment (``parallel.sharding.extract_param_specs``,
  the ZeRO-1 ``ReduceStrategy.Reduce`` layout included) and pushes shard
  specs through every op using the shapes recorded at build time. Specs
  are ``PartitionSpec``-like tuples: one mesh-axis name (or None) per dim.
* The PT730-PT744 findings: malformed or unsatisfiable specs,
  shard-indivisible dims, implicit full replication of large tensors,
  resharding inside the training loop, gradient/optimizer-state specs that
  disagree with the param's, donations that resharding invalidates.
* ``ShardingAnalysis``: per-var specs plus the collective events
  (all-reduce / all-gather / reduce-scatter / reshard) implied by spec
  transitions. ``analysis.cost_model.estimate_comms`` turns them into
  per-rank wire volumes; ``liveness.memory_plan(mesh=..., specs=...)``
  divides live bytes per spec.

The port's parallel step (``parallel/compiled_program.py``) reads its
plan from this analysis: the all-reduce events of forward-role ops are
the partial values it makes whole (over ``dp``: the batch's reductions;
over ``tp``: a row-parallel product, a vocab-sharded lookup), those of
backward-role ops the parameter gradients it sums across ``dp`` and the
partial input gradients it sums across ``tp``; an all-gather event over a
model axis is an input it gathers before the op.

Where the port's rules differ from the JAX package's, they differ on a
model axis (``tp``, ``sp``, ``pp``) or where the JAX rule records a
collective over ``dp`` that GSPMD never runs, and each makes the events
the ones GSPMD places:

* a reduction over listed dims (``reduce_sum``/``mean``/``max``/``min``
  with ``dim``) keeps the specs of the dims it keeps, so a sum over a
  row's fields stays batch-sharded; the JAX rule replicates the output
  and records an all-reduce over ``dp`` (DeepFM's field sums);

* a reshape carries a model axis through a split or merge of the dim it
  shards when the outermost dim of the aligned group divides (the
  ``[B, S, H] -> [B, S, nh, hd]`` head split keeps ``tp`` on ``nh``); the
  JAX rule records an all-gather of the input instead;
* a gradient ``<slot>@GRAD`` of a grad op takes the spec of the forward
  var in ``<slot>`` when that var is sharded over a model axis (the JAX
  rule reads the name, and a ``@RENAME`` piece falls to the elementwise
  join);
* ``softmax`` and ``softmax_with_cross_entropy`` (and their grads) whose
  class axis is sharded over a model axis record an all-gather of the
  logits and give replicated outputs (the gradient of the logits keeps
  their spec);
* an input an op gathers over a model axis counts as whole on that axis
  for the partial-sum rule, so no all-reduce follows the gather;
* the ``pipeline`` op (``layers.PipelineRegion``) consumes its
  ``pp``-stacked parameters locally (each rank holds its stage's slice)
  and keeps ``X`` and ``Out`` replicated over ``pp``: ``Out`` takes
  ``X``'s spec and no collective is recorded for the stage slices; its
  grad gives ``X@GRAD`` the spec of ``X`` and each stacked gradient its
  parameter's spec, with the ``dp`` all-reduce of the data-parallel
  gradient when ``X`` is batch-sharded. The shift of the activations
  between stages and the replication of ``Out`` and ``X@GRAD`` over
  ``pp`` happen inside the op (``parallel/pipeline.py``), as ring
  attention's exchanges do inside its op. The JAX package's analysis has
  no rule for the op (its generic rule records an all-reduce over ``pp``
  of ``Out``, a cost estimate of the schedule's ``psum``).

Registered as analysis pass ``sharding_check`` (requires ``liveness``).
The pass reads its inputs from ``PassContext.options``:

    run_pipeline(prog, ("sharding_check",), fetch_names=[loss.name],
                 options={"mesh": {"dp": 2}, "zero": True})

``options["specs"]`` overrides the derived per-param assignment; with no
``mesh`` option the pass is a silent no-op (returns None).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic
from .verifier import EMPTY, _site

__all__ = [
    "Spec", "CollectiveEvent", "ShardingAnalysis", "normalize_spec",
    "spec_divisor", "shard_bytes", "propagate_sharding", "check_sharding",
    "staging_bytes_by_op", "format_spec",
]

# one mesh-axis name (or None) per dim; () means fully replicated
Spec = Tuple[Optional[str], ...]

REPLICATED: Spec = ()

# optimizer update ops: Param/Grad in, ParamOut out, state slots between
_OPT_STATE_SLOTS = (
    "Moment", "Moment1", "Moment2", "Velocity", "MeanSquare", "MeanGrad",
    "AvgSquaredGrad", "AvgSquaredUpdate", "InfNorm",
)

# default byte threshold for the PT736 implicit-replication lint
LARGE_BYTES_DEFAULT = 1 << 20

# ops with no per-dim spec transfer by design (reductions/metrics): the
# generic rule's replicated-output + partial-sum all-reduce IS their
# correct model, so they never warrant a PT744 "no rule" note
_KNOWN_REDUCTIONS = frozenset({
    "mean", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "accuracy", "auc", "top_k", "argmax", "argmin", "not_equal",
    "equal", "less_than", "greater_than",
})

# mesh axes that are not the batch's: the port's rules that differ from
# the JAX package's act on these only (see the module docstring)
_BATCH_AXIS = "dp"

# data-movement ops: their own rules record the gather/reshard they imply;
# the partial-sum reduce rule must not double-charge them
_LAYOUT_TYPES = frozenset({
    "reshape2", "squeeze2", "unsqueeze2", "flatten2", "transpose2",
    "concat", "slice", "assign", "shape", "lookup_table",
    "fill_constant_batch_size_like",
})
# ops whose rule records every collective they imply (the pipeline's
# stage slices are consumed locally): the partial-sum rule skips them
_SELF_PLACED = frozenset({"pipeline", "pipeline_grad"})


def normalize_spec(spec: Optional[Sequence], ndim: int) -> Spec:
    """Pad/trim a spec to ``ndim`` entries (None = unsharded dim)."""
    spec = tuple(spec or ())
    if len(spec) < ndim:
        spec = spec + (None,) * (ndim - len(spec))
    return spec[:ndim]


def is_sharded(spec: Optional[Sequence]) -> bool:
    return any(a is not None for a in (spec or ()))


def _dedup_axes(spec: Spec) -> Spec:
    """Drop repeated mesh axes from a composed spec (first dim wins) —
    a PartitionSpec may use each axis at most once."""
    seen: set = set()
    out = []
    for a in spec:
        if a is not None and a in seen:
            out.append(None)
        else:
            if a is not None:
                seen.add(a)
            out.append(a)
    return tuple(out)


def format_spec(spec: Optional[Sequence]) -> str:
    if not is_sharded(spec):
        return "replicated"
    return "P(" + ", ".join("None" if a is None else repr(a)
                            for a in spec) + ")"


def spec_divisor(spec: Optional[Sequence], mesh: Dict[str, int],
                 shape: Optional[Sequence[int]] = None,
                 batch_size: int = 1) -> int:
    """How many ways the spec splits the value: the product of the mesh
    sizes of its axes — counting only dims the split divides evenly
    (an indivisible dim is kept whole: the conservative per-chip bound)."""
    if not spec:
        return 1
    div = 1
    seen: set = set()
    for d, axis in enumerate(spec):
        if axis is None or axis not in mesh or axis in seen:
            # one mesh axis can split a value at most once — a composed
            # spec that reuses an axis must never multiply the divisor
            # past the mesh size (the per-chip plan would UNDER-estimate)
            continue
        n = int(mesh[axis])
        if n <= 1:
            continue
        if shape is not None and d < len(shape):
            dim = int(shape[d]) if shape[d] is not None else -1
            if dim < 0:
                dim = int(batch_size)
            if dim % n:
                continue
        seen.add(axis)
        div *= n
    return div


def shard_bytes(nbytes: int, spec: Optional[Sequence], mesh: Dict[str, int],
                shape: Optional[Sequence[int]] = None,
                batch_size: int = 1) -> int:
    return int(nbytes) // spec_divisor(spec, mesh, shape, batch_size)


@dataclasses.dataclass
class CollectiveEvent:
    """One collective implied by a spec transition. ``bytes_full`` is the
    FULL (unsharded, batch-resolved) tensor size; the wire-volume formulas
    per kind live in ``cost_model.estimate_comms``."""

    block_idx: int
    op_idx: int
    kind: str            # all_reduce | all_gather | reduce_scatter | reshard
    axis: str            # mesh axis (comma-joined when more than one)
    var: str
    bytes_full: int
    reason: str

    def axis_size(self, mesh: Dict[str, int]) -> int:
        n = 1
        for a in self.axis.split(","):
            n *= int(mesh.get(a, 1))
        return max(n, 1)

    def to_dict(self) -> dict:
        return {"block": self.block_idx, "op": self.op_idx,
                "kind": self.kind, "axis": self.axis, "var": self.var,
                "bytes_full": self.bytes_full, "reason": self.reason}


@dataclasses.dataclass
class ShardingAnalysis:
    """Result of one ``propagate_sharding`` run (cached on the PassContext
    as the ``sharding_check`` analysis value)."""

    mesh: Dict[str, int]
    batch_size: int
    var_specs: Dict[str, Spec]          # every var touched by propagation
    param_specs: Dict[str, Spec]        # the input assignment (validated)
    feed_spec: Spec
    collectives: List[CollectiveEvent]
    diagnostics: List[Diagnostic]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.mesh.values():
            n *= int(s)
        return max(n, 1)

    def spec_of(self, name: str) -> Spec:
        return self.var_specs.get(name, REPLICATED)

    def to_dict(self) -> dict:
        return {
            "mesh": dict(self.mesh),
            "batch_size": self.batch_size,
            "n_devices": self.n_devices,
            "sharded_vars": {n: [a for a in s]
                             for n, s in sorted(self.var_specs.items())
                             if is_sharded(s)},
            "collectives": [c.to_dict() for c in self.collectives],
            "diagnostics": [d.code for d in self.diagnostics],
        }


def staging_bytes_by_op(analysis: "ShardingAnalysis"
                        ) -> Dict[Tuple[int, int], int]:
    """Per-(block, op) collective staging bytes for the per-chip memory
    plan: one ring send+recv chunk pair per collective —
    ``2 * bytes_full / axis_size`` (capped at the full tensor). The
    gathered/reduced DESTINATION is the out var itself and is already
    counted by its (replicated or sharded) live bytes; this term is the
    transient wire-side scratch XLA adds on top."""
    out: Dict[Tuple[int, int], int] = {}
    for ev in analysis.collectives:
        n = ev.axis_size(analysis.mesh)
        chunk = min(ev.bytes_full, 2 * ev.bytes_full // max(n, 1))
        key = (ev.block_idx, ev.op_idx)
        out[key] = out.get(key, 0) + int(chunk)
    return out


# ---------------------------------------------------------------------------
# the propagation engine
# ---------------------------------------------------------------------------

class _Propagator:
    """Walks every block in op order, assigning an output spec per op from
    its input specs + recorded shapes, recording collective events at spec
    transitions, and reporting PT73x findings. Conservative by design:
    whenever a rule cannot prove a sharding, the value is replicated (a
    per-chip OVER-estimate, never an under-estimate)."""

    def __init__(self, program, mesh: Dict[str, int], batch_size: int,
                 large_bytes: int = LARGE_BYTES_DEFAULT):
        self.program = program
        self.mesh = {str(k): int(v) for k, v in mesh.items()}
        self.batch = max(1, int(batch_size))
        self.large = int(large_bytes)
        self.specs: Dict[str, Spec] = {}
        self.diags: List[Diagnostic] = []
        self.collectives: List[CollectiveEvent] = []
        self._reported: Set[tuple] = set()
        self._no_rule_types: Set[str] = set()
        # blocks already walked: a sub-block shared by several owning ops
        # (recurrent + recurrent_grad reference one body) propagates ONCE,
        # at its first owner — the same _seen guard liveness.memory_plan
        # uses; also breaks (malformed) sub_block cycles
        self._visited_blocks: Set[int] = set()
        # grad all-reduce events by var name, for the ZeRO rewrite at the
        # optimizer op (reduce-scatter replaces the all-reduce)
        self._ar_by_var: Dict[str, CollectiveEvent] = {}
        # (block, op index, var, axis) an op gathers over a model axis:
        # whole on that axis for the partial-sum rule
        self._gathered: Set[tuple] = set()

    # -- helpers ----------------------------------------------------------
    def emit(self, code: str, msg: str, blk, oi: Optional[int],
             op=None, dedup_key: Optional[tuple] = None) -> None:
        key = dedup_key if dedup_key is not None else (code, msg)
        if key in self._reported:
            return
        self._reported.add(key)
        self.diags.append(Diagnostic(
            code, msg, blk.idx if blk is not None else 0, oi,
            op.type if op is not None else None,
            _site(op) if op is not None else ""))

    def var(self, blk, name: str):
        try:
            return blk._var_recursive(name)
        except KeyError:
            return None

    def shape_of(self, blk, name: str) -> Optional[Tuple[int, ...]]:
        v = self.var(blk, name)
        if v is None or v.shape is None:
            return None
        return tuple(int(self.batch) if int(d) < 0 else int(d)
                     for d in v.shape)

    def bytes_of(self, blk, name: str) -> int:
        from .liveness import _var_bytes

        v = self.var(blk, name)
        if v is None:
            return 0
        return _var_bytes(v, self.batch)[0]

    def spec_of(self, blk, name: str) -> Spec:
        sp = self.specs.get(name)
        if sp is not None:
            return sp
        shape = self.shape_of(blk, name)
        return normalize_spec((), len(shape) if shape else 0)

    def collective(self, kind: str, axis, name: str, nbytes: int, blk,
                   oi: int, reason: str) -> Optional[CollectiveEvent]:
        if nbytes <= 0:
            return None   # no recorded shape -> no meaningful volume
        axis = ",".join(axis) if isinstance(axis, (list, tuple)) else str(axis)
        ev = CollectiveEvent(blk.idx, oi, kind, axis, name, int(nbytes),
                             reason)
        self.collectives.append(ev)
        if kind == "all_reduce":
            self._ar_by_var[name] = ev
        if kind == "all_gather":
            for a in axis.split(","):
                if a != _BATCH_AXIS:
                    self._gathered.add((blk.idx, oi, name, a))
        return ev

    # -- spec validation (the PT730-PT733 input contract) -----------------
    def validate(self, name: str, spec: Sequence, blk, source: str) -> Spec:
        """Sanitize one assigned spec against the mesh and the var's
        recorded shape; offending dims degrade to None (replicated —
        conservative) after the diagnostic. PT733 divisibility applies to
        STATIC dims only — a ``-1`` dim is resolved at feed time, so its
        divisibility is the runtime contract (the per-chip plan re-checks
        it at the resolved batch and keeps indivisible dims whole)."""
        v = self.var(blk, name)
        shape = self.shape_of(blk, name)
        raw_shape = tuple(v.shape) if v is not None and v.shape is not None \
            else None
        ndim = len(shape) if shape is not None else len(tuple(spec))
        raw = tuple(spec or ())
        if shape is not None and len(raw) > len(shape):
            self.emit("PT731",
                      f"{source} spec {format_spec(raw)} for '{name}' names "
                      f"{len(raw)} dims but the var has shape {shape}",
                      blk, None, dedup_key=("PT731", name))
            raw = raw[:len(shape)]
        out: List[Optional[str]] = list(normalize_spec(raw, ndim))
        seen_axes: Set[str] = set()
        for d, axis in enumerate(out):
            if axis is None:
                continue
            if axis not in self.mesh:
                self.emit("PT730",
                          f"{source} spec for '{name}' shards dim {d} over "
                          f"axis '{axis}' but the mesh has axes "
                          f"{sorted(self.mesh)}",
                          blk, None, dedup_key=("PT730", name, axis))
                out[d] = None
                continue
            if axis in seen_axes:
                self.emit("PT732",
                          f"{source} spec for '{name}' uses mesh axis "
                          f"'{axis}' on two different dims — an axis can "
                          f"shard at most one dim",
                          blk, None, dedup_key=("PT732", name, axis))
                out[d] = None
                continue
            seen_axes.add(axis)
            n = self.mesh[axis]
            if (raw_shape is not None and d < len(raw_shape)
                    and int(raw_shape[d]) >= 0 and n > 1
                    and int(raw_shape[d]) % n):
                self.emit("PT733",
                          f"{source} spec shards '{name}' dim {d} "
                          f"(size {raw_shape[d]}) over axis '{axis}' of "
                          f"size {n} — not divisible; the dim is kept "
                          f"whole",
                          blk, None, dedup_key=("PT733", name, d))
                out[d] = None
        return tuple(out)

    # -- generic rules ----------------------------------------------------
    def _join_elementwise(self, op, blk, oi, out_name: str) -> Spec:
        """Output spec for a same-shape/broadcast op: dims aligned from
        the RIGHT (numpy broadcast); conflicting votes are PT734 and the
        first-seen axis wins (the other input is resharded)."""
        out_shape = self.shape_of(blk, out_name)
        if out_shape is None:
            return REPLICATED
        votes: List[Optional[str]] = [None] * len(out_shape)
        voters: List[Optional[str]] = [None] * len(out_shape)
        for in_name in op.input_arg_names:
            if in_name == EMPTY:
                continue
            in_shape = self.shape_of(blk, in_name)
            if in_shape is None:
                continue
            sp = self.spec_of(blk, in_name)
            sp = normalize_spec(sp, len(in_shape))
            off = len(out_shape) - len(in_shape)
            for d_in, axis in enumerate(sp):
                d_out = d_in + off
                if axis is None or d_out < 0:
                    continue
                if in_shape[d_in] == 1 or in_shape[d_in] != out_shape[d_out]:
                    continue   # broadcast dim carries no sharding vote
                if votes[d_out] is None:
                    votes[d_out] = axis
                    voters[d_out] = in_name
                elif votes[d_out] != axis:
                    self.emit(
                        "PT734",
                        f"op '{op.type}' inputs '{voters[d_out]}' and "
                        f"'{in_name}' shard the aligned dim {d_out} over "
                        f"'{votes[d_out]}' vs '{axis}' — '{in_name}' is "
                        f"resharded to agree",
                        blk, oi, op,
                        dedup_key=("PT734", blk.idx, oi, d_out))
                    self.collective(
                        "reshard", axis, in_name,
                        self.bytes_of(blk, in_name), blk, oi,
                        f"input layout conflict at '{op.type}'")
        return tuple(votes)

    def _reduce_collectives(self, op, blk, oi, out_specs: Dict[str, Spec]
                            ) -> None:
        """Shared partial-sum rule: an input sharded over axis α feeding an
        output that neither keeps α nor keeps the input's shape was reduced
        over sharded data — the output needs an all-reduce over α. Layout
        ops move data without summing, so they are exempt (their own rules
        record the gather/reshard they imply)."""
        if op.type in _LAYOUT_TYPES or op.type in _SELF_PLACED:
            return
        for out, osp in out_specs.items():
            out_shape = self.shape_of(blk, out)
            if out_shape is None:
                continue
            kept = {a for a in osp if a is not None}
            seen_axes: Set[str] = set()
            for in_name in op.input_arg_names:
                if in_name == EMPTY:
                    continue
                isp = self.specs.get(in_name)
                if not is_sharded(isp):
                    continue
                in_shape = self.shape_of(blk, in_name)
                if in_shape == out_shape:
                    continue
                for a in isp:
                    if a is None or a in kept or a in seen_axes \
                            or (blk.idx, oi, in_name, a) in self._gathered:
                        continue
                    seen_axes.add(a)
                    self.collective(
                        "all_reduce", a, out, self.bytes_of(blk, out),
                        blk, oi,
                        f"'{op.type}' reduces over data sharded on "
                        f"'{a}' (partial sums per chip)")

    def _check_large_replication(self, op, blk, oi,
                                 out_specs: Dict[str, Spec],
                                 explained: Set[str]) -> None:
        """PT736 is for UNINTENDED replication (a sharding lost through a
        reshape, a big activation materialized whole); a value whose
        replication a recorded collective already explains — the DP grad
        all-reduce, the ZeRO param all-gather — is the accounted cost of
        the layout, not a finding."""
        any_sharded_in = any(is_sharded(self.specs.get(n))
                             for n in op.input_arg_names if n != EMPTY)
        if not any_sharded_in:
            return
        for out, osp in out_specs.items():
            if is_sharded(osp) or out in explained:
                continue
            nbytes = self.bytes_of(blk, out)
            if nbytes >= self.large:
                self.emit(
                    "PT736",
                    f"'{out}' ({nbytes / 2**20:.1f} MiB) comes out of "
                    f"'{op.type}' fully replicated although its inputs "
                    f"are sharded — every chip holds the whole tensor",
                    blk, oi, op, dedup_key=("PT736", out))

    # -- op dispatch ------------------------------------------------------
    def run_block(self, blk) -> None:
        if blk.idx in self._visited_blocks:
            return
        self._visited_blocks.add(blk.idx)
        for oi, op in enumerate(blk.ops):
            sub = op.attrs.get("sub_block")
            if isinstance(sub, int) and 0 <= sub < len(self.program.blocks):
                # sub-block vars get specs at the owning op's program point
                self.run_block(self.program.blocks[sub])
            self.run_op(op, blk, oi)

    def run_op(self, op, blk, oi) -> None:
        t = op.type
        if t in ("feed", "fetch"):
            return
        handler = _RULES.get(t)
        out_specs: Dict[str, Spec]
        n_coll = len(self.collectives)
        if handler is not None:
            out_specs = handler(self, op, blk, oi)
        elif t.endswith("_grad"):
            out_specs = self._grad_rule(op, blk, oi)
        else:
            out_specs = self._generic_rule(op, blk, oi)
        # composing rules (a dp-sharded feed meeting a param whose spec
        # also uses dp) can yield one axis on two dims — illegal as a
        # PartitionSpec; keep the first (outermost) occurrence
        for name, sp in out_specs.items():
            out_specs[name] = _dedup_axes(sp)
        self._reduce_collectives(op, blk, oi, out_specs)
        explained = {ev.var for ev in self.collectives[n_coll:]}
        self._check_large_replication(op, blk, oi, out_specs, explained)
        for name, sp in out_specs.items():
            self.specs[name] = sp

    def _generic_rule(self, op, blk, oi) -> Dict[str, Spec]:
        """Fallback: each output whose shape matches some input carries the
        elementwise join; an opaque output goes replicated, with PT744
        once per op type when sharding is actually being dropped."""
        out_specs: Dict[str, Spec] = {}
        opaque = False
        for out in op.output_arg_names:
            if out == EMPTY:
                continue
            sp = self._join_elementwise(op, blk, oi, out)
            out_specs[out] = sp
            if not is_sharded(sp):
                out_shape = self.shape_of(blk, out)
                if out_shape is not None and any(
                        self.shape_of(blk, n) == out_shape
                        for n in op.input_arg_names if n != EMPTY):
                    continue   # genuinely matched, inputs just unsharded
                opaque = True
        if opaque and op.type not in _KNOWN_REDUCTIONS \
                and op.type not in self._no_rule_types and any(
                is_sharded(self.specs.get(n))
                for n in op.input_arg_names if n != EMPTY):
            self._no_rule_types.add(op.type)
            self.emit("PT744",
                      f"no sharding propagation rule for op '{op.type}' — "
                      f"its outputs are treated as replicated "
                      f"(conservative for per-chip memory)",
                      blk, oi, op, dedup_key=("PT744", op.type))
        return out_specs

    def _grad_rule(self, op, blk, oi) -> Dict[str, Spec]:
        """Gradients co-locate with their forward var: ``X@GRAD`` gets
        ``X``'s spec. The shared reduce rule then inserts the data-parallel
        all-reduce for every param grad contracted over the sharded batch
        (the multi_devices_graph_pass AllReduceOpHandle, derived instead
        of built)."""
        out_specs: Dict[str, Spec] = {}
        by_slot = self._model_sharded_slots(op, blk)
        for out in op.output_arg_names:
            if out == EMPTY:
                continue
            if out in by_slot:
                shape = self.shape_of(blk, out)
                sp = by_slot[out]
                out_specs[out] = normalize_spec(
                    sp, len(shape) if shape else len(sp))
                continue
            if out.endswith("@GRAD"):
                fwd = out[:-len("@GRAD")]
                sp = self.specs.get(fwd)
                if sp is None:
                    sp = self._join_elementwise(op, blk, oi, out)
                else:
                    shape = self.shape_of(blk, out)
                    sp = normalize_spec(sp, len(shape) if shape else len(sp))
                out_specs[out] = sp
            else:
                out_specs[out] = self._join_elementwise(op, blk, oi, out)
        return out_specs

    def _model_sharded_slots(self, op, blk) -> Dict[str, Spec]:
        """A grad op that reads a value sharded over a model axis: its
        ``<slot>@GRAD`` outputs take the spec of their forward var (input
        slot ``<slot>``). Ops over ``dp`` alone keep the JAX rule."""
        if not any(_model_axis_in(self.specs.get(n))
                   for n in op.input_arg_names if n != EMPTY):
            return {}
        out: Dict[str, Spec] = {}
        for slot, names in op.outputs.items():
            if not slot.endswith("@GRAD"):
                continue
            fwd = op.inputs.get(slot[:-len("@GRAD")], [])
            for g, f in zip(names, fwd):
                sp = self.specs.get(f)
                if g != EMPTY and sp is not None:
                    out[g] = sp
        return out

    # -- matmul-class rules -----------------------------------------------
    def _contract(self, op, blk, oi, x, y, x_dims: Sequence[int],
                  y_dims: Sequence[int], out: str) -> Optional[str]:
        """Handle the contracted dims of a matmul-class op. Returns the
        axis both sides agree on (partial sums -> caller records the
        all-reduce via the shared reduce rule) or None."""
        xs = self.spec_of(blk, x)
        ys = self.spec_of(blk, y)
        ax = {xs[d] for d in x_dims if d < len(xs) and xs[d] is not None}
        ay = {ys[d] for d in y_dims if d < len(ys) and ys[d] is not None}
        if not ax and not ay:
            return None
        if ax == ay and len(ax) == 1:
            return next(iter(ax))
        if ax and ay and ax != ay:
            self.emit("PT735",
                      f"op '{op.type}': contracted dims of '{x}' are "
                      f"sharded over {sorted(ax)} but '{y}' over "
                      f"{sorted(ay)} — no partial-sum layout satisfies "
                      f"both; '{y}' is resharded",
                      blk, oi, op, dedup_key=("PT735", blk.idx, oi))
            self.collective("reshard", sorted(ay), y,
                            self.bytes_of(blk, y), blk, oi,
                            "contraction layout conflict")
            return next(iter(ax))
        # one side sharded, the other replicated: the sharded side's
        # contraction produces partials only if BOTH operands split the
        # contracted dim — with one side whole, GSPMD all-gathers the
        # sharded operand instead
        side, spec_axes = (x, ax) if ax else (y, ay)
        self.collective("all_gather", sorted(spec_axes), side,
                        self.bytes_of(blk, side), blk, oi,
                        f"contracted dim of '{side}' sharded on one side "
                        f"only")
        return None

    def _rule_mul(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("X") or [EMPTY])[0]
        y = (op.input("Y") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        xshape = self.shape_of(blk, x)
        yshape = self.shape_of(blk, y)
        oshape = self.shape_of(blk, out)
        if None in (xshape, yshape, oshape):
            return self._generic_rule(op, blk, oi)
        a = int(op.attrs.get("x_num_col_dims") or 1)
        b = int(op.attrs.get("y_num_col_dims") or 1)
        xs = normalize_spec(self.spec_of(blk, x), len(xshape))
        ys = normalize_spec(self.spec_of(blk, y), len(yshape))
        osp = list(normalize_spec((), len(oshape)))
        for d in range(min(a, len(osp))):
            osp[d] = xs[d]
        for d in range(b, len(yshape)):
            od = a + (d - b)
            if od < len(osp):
                osp[od] = ys[d]
        self._contract(op, blk, oi, x, y,
                       list(range(a, len(xshape))), list(range(b)), out)
        out_specs = {out: tuple(osp)}
        return out_specs

    def _rule_matmul(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("X") or [EMPTY])[0]
        y = (op.input("Y") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        xshape = self.shape_of(blk, x)
        yshape = self.shape_of(blk, y)
        oshape = self.shape_of(blk, out)
        if None in (xshape, yshape, oshape) or len(xshape) < 2 \
                or len(yshape) < 2:
            return self._generic_rule(op, blk, oi)
        tx = bool(op.attrs.get("transpose_X"))
        ty = bool(op.attrs.get("transpose_Y"))
        xs = normalize_spec(self.spec_of(blk, x), len(xshape))
        ys = normalize_spec(self.spec_of(blk, y), len(yshape))
        osp = list(normalize_spec((), len(oshape)))
        # batch dims: join of the two operands' leading dims
        for d in range(len(oshape) - 2):
            for sp, shape in ((xs, xshape), (ys, yshape)):
                off = len(oshape) - len(shape)
                di = d - off
                if 0 <= di < len(shape) - 2 and sp[di] is not None \
                        and shape[di] == oshape[d]:
                    osp[d] = osp[d] or sp[di]
        m_dim = -1 if tx else -2
        n_dim = -2 if ty else -1
        osp[-2] = xs[m_dim]
        osp[-1] = ys[n_dim]
        k_x = len(xshape) + (-2 if tx else -1)
        k_y = len(yshape) + (-1 if ty else -2)
        self._contract(op, blk, oi, x, y, [k_x], [k_y], out)
        return {out: tuple(osp)}

    def _rule_conv2d(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("Input") or [EMPTY])[0]
        w = (op.input("Filter") or [EMPTY])[0]
        out = (op.output("Output") or [EMPTY])[0]
        xshape = self.shape_of(blk, x)
        wshape = self.shape_of(blk, w)
        oshape = self.shape_of(blk, out)
        if None in (xshape, wshape, oshape) or len(oshape) < 4:
            return self._generic_rule(op, blk, oi)
        xs = normalize_spec(self.spec_of(blk, x), len(xshape))
        ws = normalize_spec(self.spec_of(blk, w), len(wshape))
        osp = list(normalize_spec((), len(oshape)))
        osp[0] = xs[0]          # batch
        osp[1] = ws[0]          # out channels follow the filter's Co
        for d in (2, 3):        # spatial sharding needs halo exchange:
            if xs[d] is not None:               # reshard conservative
                self.collective("reshard", xs[d], x,
                                self.bytes_of(blk, x), blk, oi,
                                "spatially sharded conv input (halo "
                                "exchange not modelled)")
        self._contract(op, blk, oi, x, w, [1], [1], out)
        return {out: tuple(osp)}

    def _rule_attention(self, op, blk, oi) -> Dict[str, Spec]:
        q = (op.input("Q") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        qshape = self.shape_of(blk, q)
        oshape = self.shape_of(blk, out)
        if qshape is None or oshape is None:
            return self._generic_rule(op, blk, oi)
        qs = normalize_spec(self.spec_of(blk, q), len(qshape))
        # K/V rotated around the ring when the sequence dim is sharded:
        # wire volume == one all-gather of K and V
        for slot in ("K", "V"):
            name = (op.input(slot) or [EMPTY])[0]
            if name == EMPTY:
                continue
            sp = self.specs.get(name)
            shape = self.shape_of(blk, name)
            if sp is None or shape is None or len(shape) < 2:
                continue
            seq_axis = normalize_spec(sp, len(shape))[-2]
            if seq_axis is not None:
                self.collective("all_gather", seq_axis, name,
                                self.bytes_of(blk, name), blk, oi,
                                "ring/sequence-parallel attention K/V "
                                "rotation")
        out_specs = {out: normalize_spec(qs, len(oshape))}
        for extra in op.output_arg_names:
            if extra != EMPTY and extra != out:
                out_specs[extra] = self._join_elementwise(op, blk, oi, extra)
        return out_specs

    # -- layout/shape ops -------------------------------------------------
    def _rule_reshape(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("X") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        xshape = self.shape_of(blk, x)
        oshape = self.shape_of(blk, out)
        out_specs: Dict[str, Spec] = {}
        for extra in op.output_arg_names:    # XShape echo: replicated
            if extra not in (EMPTY, out):
                out_specs[extra] = REPLICATED
        if xshape is None or oshape is None:
            out_specs[out] = REPLICATED
            return out_specs
        xs = normalize_spec(self.spec_of(blk, x), len(xshape))
        osp = list(normalize_spec((), len(oshape)))
        carried: Set[str] = set()
        # leading dims carry while the prefix sizes agree (batch survives
        # [B, H, W] -> [B, H*W]); trailing dims likewise from the right
        for d in range(min(len(xshape), len(oshape))):
            if xshape[d] != oshape[d]:
                break
            if xs[d] is not None:
                osp[d] = xs[d]
                carried.add(xs[d])
        for d in range(1, min(len(xshape), len(oshape)) + 1):
            if xshape[-d] != oshape[-d] or osp[-d] is not None:
                break
            if xs[-d] is not None and xs[-d] not in carried:
                osp[-d] = xs[-d]
                carried.add(xs[-d])
        for d_in, d_out in _aligned_heads(xshape, oshape):
            a = xs[d_in]
            if a is None or a == _BATCH_AXIS or a in carried \
                    or osp[d_out] is not None \
                    or oshape[d_out] % max(1, self.mesh.get(a, 1)):
                continue
            osp[d_out] = a
            carried.add(a)
        lost = [a for a in xs if a is not None and a not in carried]
        if lost:
            self.collective("all_gather", lost, x, self.bytes_of(blk, x),
                            blk, oi,
                            f"'{op.type}' folds a dim sharded on "
                            f"{lost} into a new shape")
        out_specs[out] = tuple(osp)
        return out_specs

    def _rule_transpose(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("X") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        xshape = self.shape_of(blk, x)
        perm = op.attrs.get("axis")
        out_specs: Dict[str, Spec] = {}
        for extra in op.output_arg_names:
            if extra not in (EMPTY, out):
                out_specs[extra] = REPLICATED
        if xshape is None or not perm:
            out_specs[out] = REPLICATED
            return out_specs
        xs = normalize_spec(self.spec_of(blk, x), len(xshape))
        out_specs[out] = tuple(xs[p] if 0 <= p < len(xs) else None
                               for p in perm)
        return out_specs

    def _rule_concat(self, op, blk, oi) -> Dict[str, Spec]:
        out = (op.output("Out") or [EMPTY])[0]
        axis = int(op.attrs.get("axis") or 0)
        sp = self._join_elementwise(op, blk, oi, out)
        oshape = self.shape_of(blk, out)
        if oshape is None:
            return {out: REPLICATED}
        if axis < 0:
            axis += len(oshape)
        sp = list(normalize_spec(sp, len(oshape)))
        for in_name in op.input_arg_names:
            isp = self.specs.get(in_name)
            ishape = self.shape_of(blk, in_name)
            if isp is None or ishape is None or axis >= len(ishape):
                continue
            a = normalize_spec(isp, len(ishape))[axis]
            if a is not None:
                self.collective("all_gather", a, in_name,
                                self.bytes_of(blk, in_name), blk, oi,
                                "concat along a sharded dim")
        if 0 <= axis < len(sp):
            sp[axis] = None    # the concatenated dim cannot stay sharded
        return {out: tuple(sp)}

    def _rule_slice(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("Input") or op.input("X") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        xshape = self.shape_of(blk, x)
        oshape = self.shape_of(blk, out)
        if xshape is None or oshape is None or len(xshape) != len(oshape):
            return self._generic_rule(op, blk, oi)
        xs = normalize_spec(self.spec_of(blk, x), len(xshape))
        osp = []
        for d in range(len(xshape)):
            if xshape[d] == oshape[d]:
                osp.append(xs[d])
            else:
                if xs[d] is not None:
                    self.collective("all_gather", xs[d], x,
                                    self.bytes_of(blk, x), blk, oi,
                                    "slicing a sharded dim")
                osp.append(None)
        return {out: tuple(osp)}

    def _rule_lookup_table(self, op, blk, oi) -> Dict[str, Spec]:
        w = (op.input("W") or [EMPTY])[0]
        ids = (op.input("Ids") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        oshape = self.shape_of(blk, out)
        if oshape is None:
            return self._generic_rule(op, blk, oi)
        ids_spec = self.spec_of(blk, ids)
        w_spec = self.spec_of(blk, w)
        osp = list(normalize_spec((), len(oshape)))
        if ids_spec:
            osp[0] = ids_spec[0]
        if len(w_spec) >= 2 and w_spec[1] is not None:
            osp[-1] = w_spec[1]
        if w_spec and w_spec[0] is not None:
            # vocab-sharded table: the gather lowers to per-shard partial
            # one-hot contractions + an all-reduce of the dense result
            self.collective("all_reduce", w_spec[0], out,
                            self.bytes_of(blk, out), blk, oi,
                            "vocab-sharded embedding lookup")
        return {out: tuple(osp)}

    def _rule_reduce(self, op, blk, oi) -> Dict[str, Spec]:
        """A reduction over listed dims keeps the specs of the dims it
        keeps (None where ``keep_dim`` leaves a reduced dim as size 1);
        the partial-sum rule then records an all-reduce only for an axis
        a reduced dim was sharded on. No listed dims, ``reduce_all`` or an
        unrecorded shape: the generic rule."""
        x = (op.input("X") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        xshape, oshape = self.shape_of(blk, x), self.shape_of(blk, out)
        dims = op.attrs.get("dim")
        dims = [dims] if isinstance(dims, int) else list(dims or [])
        if xshape is None or oshape is None or not dims \
                or op.attrs.get("reduce_all"):
            return self._generic_rule(op, blk, oi)
        nd = len(xshape)
        dims = {int(d) % nd for d in dims}
        xs = normalize_spec(self.spec_of(blk, x), nd)
        if op.attrs.get("keep_dim"):
            osp = [None if d in dims else xs[d] for d in range(nd)]
        else:
            osp = [xs[d] for d in range(nd) if d not in dims]
        if len(osp) != len(oshape):
            return self._generic_rule(op, blk, oi)
        return {out: tuple(osp)}

    def _rule_pipeline(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("X") or [EMPTY])[0]
        out = (op.output("Out") or [EMPTY])[0]
        return {out: self.spec_of(blk, x)} if out != EMPTY else {}

    def _rule_pipeline_grad(self, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input("X") or [EMPTY])[0]
        xs = self.spec_of(blk, x)
        out: Dict[str, Spec] = {}
        for g in op.output("X@GRAD"):
            if g != EMPTY:
                out[g] = xs
        batch = [a for a in xs if a is not None]
        for p, g in zip(op.input("StackedParams"),
                        op.output("StackedParams@GRAD")):
            if g == EMPTY:
                continue
            out[g] = self.spec_of(blk, p)
            for a in batch:
                if a not in out[g]:
                    self.collective(
                        "all_reduce", a, g, self.bytes_of(blk, g), blk, oi,
                        f"'{op.type}' sums a stage gradient over data "
                        f"sharded on '{a}' (partial sums per chip)")
        return out

    def _rule_fill_like(self, op, blk, oi) -> Dict[str, Spec]:
        # fill_constant_batch_size_like: dim0 follows the reference input
        out = (op.output("Out") or [EMPTY])[0]
        ref = (op.input("Input") or [EMPTY])[0]
        oshape = self.shape_of(blk, out)
        if oshape is None:
            return {out: REPLICATED} if out != EMPTY else {}
        osp = list(normalize_spec((), len(oshape)))
        rsp = self.specs.get(ref)
        if rsp and rsp[0] is not None:
            osp[0] = rsp[0]
        return {out: tuple(osp)}

    # -- the optimizer update (PT738/PT739/PT740 + the ZeRO rewrite) ------
    def _rule_optimizer(self, op, blk, oi) -> Dict[str, Spec]:
        param = (op.input("Param") or [EMPTY])[0]
        grad = (op.input("Grad") or [EMPTY])[0]
        p_spec = self.spec_of(blk, param)
        g_spec = self.spec_of(blk, grad)
        p_shape = self.shape_of(blk, param)
        if p_shape is not None:
            p_spec = normalize_spec(p_spec, len(p_shape))
            g_spec = normalize_spec(g_spec, len(p_shape))
        out_specs: Dict[str, Spec] = {}
        if g_spec != p_spec and (is_sharded(g_spec) or is_sharded(p_spec)):
            self.emit("PT738",
                      f"op '{op.type}': gradient '{grad}' arrives "
                      f"{format_spec(g_spec)} but param '{param}' is "
                      f"{format_spec(p_spec)} — the grad is resharded "
                      f"every step",
                      blk, oi, op, dedup_key=("PT738", param))
            self.collective("reshard",
                            [a for a in set(g_spec) | set(p_spec) if a],
                            grad, self.bytes_of(blk, grad), blk, oi,
                            "grad/param layout disagreement")
        dp_like = None
        for slot in _OPT_STATE_SLOTS:
            for name in op.input(slot):
                if name == EMPTY:
                    continue
                s_spec = self.spec_of(blk, name)
                s_shape = self.shape_of(blk, name)
                if s_shape is not None:
                    s_spec = normalize_spec(s_spec, len(s_shape))
                ndim = max(len(s_spec), len(p_spec))
                if normalize_spec(s_spec, ndim) \
                        == normalize_spec(p_spec, ndim):
                    continue
                if not is_sharded(s_spec) and not is_sharded(p_spec):
                    continue
                zero_axis = s_spec[0] if s_spec else None
                if (zero_axis == "dp" and not is_sharded(p_spec)
                        and all(a is None for a in s_spec[1:])):
                    dp_like = name
                    continue
                self.emit("PT739",
                          f"op '{op.type}': optimizer state '{name}' is "
                          f"{format_spec(s_spec)} but param '{param}' is "
                          f"{format_spec(p_spec)} — not the ZeRO "
                          f"dim-0-over-dp layout; the update resharding "
                          f"is paid every step",
                          blk, oi, op, dedup_key=("PT739", name))
        if dp_like is not None:
            self.emit("PT740",
                      f"op '{op.type}': ZeRO layout on '{param}' — "
                      f"optimizer state (e.g. '{dp_like}') sharded over "
                      f"'dp', param replicated: each step pays a grad "
                      f"reduce-scatter + a param all-gather",
                      blk, oi, op, dedup_key=("PT740", param))
            # the grad's earlier all-reduce becomes a reduce-scatter into
            # the sharded update, and the fresh param is all-gathered:
            # rewrite the recorded event rather than double-count
            ar = self._ar_by_var.pop(grad, None)
            if ar is not None and ar in self.collectives:
                self.collectives.remove(ar)
            self.collective("reduce_scatter", "dp", grad,
                            self.bytes_of(blk, grad), blk, oi,
                            "ZeRO-1: grads reduce-scattered into the "
                            "sharded update")
            self.collective("all_gather", "dp", param,
                            self.bytes_of(blk, param), blk, oi,
                            "ZeRO-1: fresh params all-gathered after the "
                            "sharded update")
        # in-place contract: every output keeps its own var's assigned spec
        for out in op.output_arg_names:
            if out != EMPTY:
                out_specs[out] = self.spec_of(blk, out)
        return out_specs


def _model_axis_in(spec) -> bool:
    return bool(spec) and any(a is not None and a != _BATCH_AXIS
                              for a in spec)


def _aligned_heads(xshape, oshape):
    """``(input dim, output dim)`` pairs a reshape keeps in row-major
    layout: each group of input dims that maps onto a group of output
    dims (equal products) pairs its outermost input dim with its
    outermost output dim, so a dim sharded into contiguous blocks stays
    so. Size-1 dims join the group before them."""
    pairs, i, j = [], 0, 0
    while i < len(xshape) and j < len(oshape):
        i0, j0 = i, j
        pi, pj = xshape[i], oshape[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj and i < len(xshape):
                pi *= xshape[i]
                i += 1
            elif pj < pi and j < len(oshape):
                pj *= oshape[j]
                j += 1
            else:
                return pairs
        pairs.append((i0, j0))
    return pairs


def _rule_softmax(slot_in: str, slot_out: str):
    """``softmax``/``softmax_with_cross_entropy`` and their grads: a class
    axis sharded over a model axis is gathered before the op (the softmax
    needs every class), the outputs replicated on it; otherwise the
    outputs follow the input as ``_rule_same_as_input`` does."""
    same = _rule_same_as_input(slot_in, slot_out)

    def rule(self: _Propagator, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input(slot_in) or [EMPTY])[0]
        shape = self.shape_of(blk, x)
        axis = int(op.attrs.get("axis", -1))
        sp = normalize_spec(self.spec_of(blk, x), len(shape)) \
            if shape else ()
        a = sp[axis] if sp else None
        if a is None or a == _BATCH_AXIS:
            return self._grad_rule(op, blk, oi) \
                if op.type.endswith("_grad") else same(self, op, blk, oi)
        self.collective("all_gather", a, x, self.bytes_of(blk, x), blk, oi,
                        f"'{op.type}' normalises over the class dim "
                        f"sharded on '{a}'")
        whole = list(sp)
        whole[axis] = None
        if op.type.endswith("_grad"):
            return self._grad_rule(op, blk, oi)
        out_specs: Dict[str, Spec] = {}
        for out in op.output_arg_names:
            if out == EMPTY:
                continue
            oshape = self.shape_of(blk, out)
            out_specs[out] = normalize_spec(
                tuple(whole)[:len(oshape)] if oshape else (),
                len(oshape) if oshape else 0)
        return out_specs
    return rule


def _rule_same_as_input(slot_in: str, slot_out: str):
    def rule(self: _Propagator, op, blk, oi) -> Dict[str, Spec]:
        x = (op.input(slot_in) or [EMPTY])[0]
        out = (op.output(slot_out) or [EMPTY])[0]
        oshape = self.shape_of(blk, out)
        sp = self.spec_of(blk, x)
        out_specs = {out: normalize_spec(sp, len(oshape))
                     if oshape is not None else REPLICATED}
        for extra in op.output_arg_names:
            if extra not in (EMPTY, out):
                out_specs[extra] = self._join_elementwise(
                    op, blk, oi, extra)
        return out_specs
    return rule


_RULES = {
    "mul": _Propagator._rule_mul,
    "matmul": _Propagator._rule_matmul,
    "conv2d": _Propagator._rule_conv2d,
    "depthwise_conv2d": _Propagator._rule_conv2d,
    "fused_multihead_attention": _Propagator._rule_attention,
    "reshape2": _Propagator._rule_reshape,
    "squeeze2": _Propagator._rule_reshape,
    "unsqueeze2": _Propagator._rule_reshape,
    "flatten2": _Propagator._rule_reshape,
    "transpose2": _Propagator._rule_transpose,
    "concat": _Propagator._rule_concat,
    "slice": _Propagator._rule_slice,
    "lookup_table": _Propagator._rule_lookup_table,
    "pipeline": _Propagator._rule_pipeline,
    "reduce_sum": _Propagator._rule_reduce,
    "reduce_mean": _Propagator._rule_reduce,
    "reduce_max": _Propagator._rule_reduce,
    "reduce_min": _Propagator._rule_reduce,
    "pipeline_grad": _Propagator._rule_pipeline_grad,
    "fill_constant_batch_size_like": _Propagator._rule_fill_like,
    "batch_norm": _rule_same_as_input("X", "Y"),
    "layer_norm": _rule_same_as_input("X", "Y"),
    "softmax": _rule_softmax("X", "Out"),
    "softmax_grad": _rule_softmax("X", "Out"),
    "dropout": _rule_same_as_input("X", "Out"),
    "softmax_with_cross_entropy": _rule_softmax("Logits", "Softmax"),
    "softmax_with_cross_entropy_grad": _rule_softmax("Logits", "Softmax"),
}

# optimizer ops share one rule, detected by slots at dispatch time
for _t in ("sgd", "momentum", "lars_momentum", "adam", "adamw", "adamax",
           "adagrad", "decayed_adagrad", "adadelta", "rmsprop", "ftrl"):
    _RULES[_t] = _Propagator._rule_optimizer


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def propagate_sharding(program, mesh: Dict[str, int],
                       param_specs: Optional[Dict[str, Sequence]] = None,
                       feed_spec: Optional[Sequence] = None,
                       feed_names: Sequence[str] = (),
                       fetch_names: Sequence[str] = (),
                       batch_size: int = 1,
                       liveness_info: Optional[dict] = None,
                       large_bytes: int = LARGE_BYTES_DEFAULT
                       ) -> ShardingAnalysis:
    """Propagate shard specs from the per-param assignment + feed spec
    through every op of ``program`` (sub-blocks walked at their owning
    op). Returns the :class:`ShardingAnalysis`; diagnostics accumulate on
    ``analysis.diagnostics`` (the registered pass forwards them to the
    PassContext)."""
    prop = _Propagator(program, mesh, batch_size, large_bytes)
    gb = program.global_block
    fetch = {getattr(f, "name", f) for f in (fetch_names or ())}
    dp = prop.mesh.get("dp", 1)
    if feed_spec is None:
        feed_spec = ("dp",) if dp > 1 else ()

    feeds = {v.name for v in gb.vars.values() if v.is_data}
    feeds.update(feed_names or ())

    # 1. feeds: batch-sharded (PT742 when the mesh has dp but the feed
    #    spec does not engage it)
    for name in sorted(feeds):
        v = prop.var(gb, name)
        if v is None:
            continue
        sp = prop.validate(name, feed_spec, gb, "feed")
        prop.specs[name] = sp
        if dp > 1 and "dp" not in {a for a in sp if a}:
            prop.emit("PT742",
                      f"feed '{name}' is not sharded over 'dp' "
                      f"(mesh dp={dp}) — the global batch rides every "
                      f"chip whole; data parallelism is not engaged",
                      gb, None, dedup_key=("PT742", name))

    # 2. params / persistable state: the caller's assignment
    assigned: Dict[str, Spec] = {}
    param_specs = dict(param_specs or {})
    for blk in program.blocks:
        for v in blk.vars.values():
            if not v.persistable or v.name in feeds:
                continue
            raw = param_specs.get(v.name, ())
            sp = prop.validate(v.name, raw, blk, "param")
            assigned[v.name] = sp
            prop.specs[v.name] = sp

    # 3. the walk
    prop.run_block(gb)

    # 4. state-loop / donation / fetch checks on the final specs
    persistable = {v.name for blk in program.blocks
                   for v in blk.vars.values() if v.persistable}
    for name in sorted(persistable):
        in_spec = assigned.get(name, REPLICATED)
        out_spec = prop.specs.get(name, in_spec)
        shape = prop.shape_of(gb, name)
        ndim = len(shape) if shape else max(len(in_spec), len(out_spec))
        if normalize_spec(in_spec, ndim) != normalize_spec(out_spec, ndim):
            prop.emit("PT737",
                      f"persistable '{name}' enters the step "
                      f"{format_spec(in_spec)} but is produced "
                      f"{format_spec(out_spec)} — the training loop pays "
                      f"this layout change every step",
                      gb, None, dedup_key=("PT737", name))
            prop.collective("reshard",
                            [a for a in set(in_spec) | set(out_spec) if a],
                            name, prop.bytes_of(gb, name), gb,
                            max(len(gb.ops) - 1, 0),
                            "state layout change across the step "
                            "boundary")
            if liveness_info is not None:
                cands = liveness_info.get("cands", set())
                unsafe = liveness_info.get("unsafe", {})
                if name in cands and name not in unsafe:
                    prop.emit(
                        "PT741",
                        f"'{name}' is liveness-proven donatable but its "
                        f"input layout {format_spec(in_spec)} differs "
                        f"from its output layout {format_spec(out_spec)}"
                        f" — the donated buffer cannot be reused in "
                        f"place; the step pays an extra copy",
                        gb, None, dedup_key=("PT741", name))

    for name in sorted(fetch):
        sp = prop.specs.get(name)
        if is_sharded(sp):
            prop.emit("PT743",
                      f"fetch '{name}' is {format_spec(sp)} — the "
                      f"executor pins fetches replicated, so every step "
                      f"all-gathers it",
                      gb, None, dedup_key=("PT743", name))
            prop.collective("all_gather",
                            [a for a in sp if a is not None], name,
                            prop.bytes_of(gb, name), gb,
                            max(len(gb.ops) - 1, 0),
                            "sharded value fetched (fetches are pinned "
                            "replicated)")

    return ShardingAnalysis(
        mesh=prop.mesh, batch_size=prop.batch,
        var_specs=dict(prop.specs),
        param_specs=assigned,
        feed_spec=normalize_spec(feed_spec, len(tuple(feed_spec or ()))),
        collectives=list(prop.collectives),
        diagnostics=list(prop.diags))


def check_sharding(program, ctx) -> Optional[ShardingAnalysis]:
    """The registered ``sharding_check`` pass body. Inputs come from
    ``ctx.options``:

    * ``mesh``      — ``{"dp": 8, ...}``; absent => silent no-op (None).
    * ``specs``     — per-param spec dict; default: derived from the
      program via ``parallel.sharding.extract_param_specs`` (honouring
      ``options["zero"]`` / an ``options["build_strategy"]``).
    * ``feed_spec`` — default ``("dp",)`` when the mesh has dp.
    * ``large_bytes`` — PT736 threshold (default 1 MiB).
    """
    mesh = ctx.options.get("mesh")
    if not mesh:
        return None
    specs = ctx.options.get("specs")
    feed_spec = ctx.options.get("feed_spec")
    if specs is None:
        from ..parallel.sharding import extract_param_specs

        bs = ctx.options.get("build_strategy")
        zero = bool(ctx.options.get("zero"))
        specs, derived_feed = extract_param_specs(
            program, mesh, build_strategy=bs, zero=zero)
        if feed_spec is None:
            feed_spec = derived_feed
    live_info = ctx.analysis("liveness")
    analysis = propagate_sharding(
        program, mesh,
        param_specs=specs,
        feed_spec=feed_spec,
        feed_names=ctx.feed_names,
        fetch_names=ctx.fetch_names,
        batch_size=ctx.batch_size,
        liveness_info=live_info,
        large_bytes=int(ctx.options.get("large_bytes",
                                        LARGE_BYTES_DEFAULT)))
    for d in analysis.diagnostics:
        ctx.report(d)
    return analysis
