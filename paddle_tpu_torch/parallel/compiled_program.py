"""CompiledProgram: parallel training over the launched ranks.

Counterpart of ``paddle_tpu/parallel/compiled_program.py`` (reference
python/paddle/fluid/compiler.py:65 CompiledProgram / :143
with_data_parallel). The JAX package jits one program over a device mesh
and GSPMD partitions it, so every op computes over the GLOBAL batch and
fetches come back replicated. The port runs one process per card
(``distributed.launch``) on a mesh of ``dp``, ``tp`` and ``sp`` axes
(``parallel.sharding.Mesh``): each rank feeds the slice of the global
batch its ``dp`` coordinate names, holds its shard of every var the
sharding rules split over ``tp``, and runs the program on local shapes
through the executor's own step (``Executor._run_body``, path
``parallel``); the plan below (``_DPPlan``, kept on the executor's step
record) places the collectives that make the result the global one, each
on the process group of the axis it is over. The nan check, the numerics
witness, the spans, the fault sites and the release plan are the
executor's.

Where the collectives go is read from ``analysis.sharding_check`` (the
events it derives from spec transitions, with the layout of
``parallel.sharding``'s rules and ``zero1_spec_for``):

* a forward-role op that reduces over the batch (``reduce_sum``,
  ``reduce_mean``, ``mean``, ``accuracy``) makes a dp-partial value: the
  step all-reduces its output over ``dp`` (summed, or averaged for a
  mean), so the loss is the global one; the grad op of a mean then scales
  its input gradient by 1/dp, so each rank's gradient is its rows' share
  of the global loss's. ``batch_norm`` in training takes its statistics
  over the global batch inside the op (``LowerCtx.dp``: an all-reduce
  whose backward all-reduces the partial cotangent), so its generic grad,
  which reruns the forward under autograd, reruns the collective too.
  ``layer_norm``'s per-row statistics need nothing. Any other batch
  coupling raises, naming the op and the var: it never runs per rank.
* an output the analysis marks partial over a model axis (a row-parallel
  product, a vocab-sharded lookup, the input gradient of a
  column-parallel product) is all-reduced over that axis right after its
  op, so a row-parallel bias (a separate op) is added once; an input it
  marks gathered over a model axis (logits sharded over the vocabulary
  before the softmax) is all-gathered along its sharded dim for the op;
  an output the op makes whole where the analysis keeps it sharded (the
  gradient of gathered logits) is cut back to this rank's shard.
* each op runs on local shapes: a reshape whose ``shape`` attr names a
  sharded dim's global size (``split_heads``' head count) gets the
  local size; a lookup into a vocab-sharded table reads its own rows
  (ids shifted to the shard, other ids give zero rows and no gradient).
* the parameter gradients the analysis marks dp-partial are summed
  across ``dp`` after the last backward op, bucketed by dtype in the
  program's order of the gradients (one collective a dtype, so a run
  repeats bit for bit); a sparse (SelectedRows) gradient of a replicated
  table is summed by all-gathering every rank's rows and values and
  merging them in rank order (``core.selected_rows.merge_rows``), so a run
  repeats bit for bit too; then the update runs on each rank's shards.
* an ``is_distributed`` table whose height ``dp`` divides is held as
  this rank's rows (``zero1_spec_for``), with its same-height optimizer
  state and its gradient. Its lookup (the analysis's all-reduce over
  ``dp`` at a lookup into a dp-sharded table) all-gathers the ranks' ids,
  looks up the rows this rank owns (zeros elsewhere, ``padding_idx``
  shifted) and sums the result over ``dp``, keeping this rank's batch
  rows; the gradient all-gathers the output gradient, and each rank
  builds the SelectedRows gradient of its own rows over the global batch,
  which needs no further sum. A sparse lookup into a ``tp``
  vocab-sharded table reads its shard's rows the same way on its own ids.
* a ``pipeline`` op on a mesh with a ``pp`` axis runs the GPipe schedule
  (``parallel/pipeline.py``) inside the op; its stacked parameters and
  their optimizer state are held as this rank's stage slice, and their
  gradients are summed over ``dp`` with the others.
* gradient merge (``GradientMergeOptimizer``/``PipelineOptimizer``): the
  executor's microbatch loop runs inside the parallel step, each
  microbatch's forward and backward placed as above, and the merged
  gradients are summed over ``dp`` once, after the last microbatch,
  before the update.

A sharded var the scope holds whole (the startup run, a restored
checkpoint, ``interop.scope_from_numpy``) is cut to this rank's shard at
its first step; the optimizer state of a sharded param follows its param
(``parallel.sharding.state_follows_param``).

``ReduceStrategy.Reduce`` (ZeRO-1, over ``dp``): each optimizer-state
var whose local rows ``dp`` divides is cut to this rank's rows at its
first step; an update op then runs on this rank's rows of its Param and
Grad, and the fresh param is all-gathered over ``dp``. Update ops that
reduce over a whole parameter (``lamb``, ``lars_momentum``, ``dpsgd``)
raise under ZeRO-1; gradient clipping runs on the whole summed gradients
before the update, so a global norm is the unsharded one. A fetched value
that is batch- or model-sharded is gathered in coordinate order.

Dropout: a rank folds only its ``dp`` coordinate into the step seed, so
the ranks of one ``tp`` or ``sp`` group, which hold the same replicated
activations, draw the same masks, and ``dp`` ranks draw different masks
for their rows.

The collective backend is ``distributed.collective_backend``'s; every
rank must feed the same number of rows (checked at a key's first step).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import distributed as _dist
from .. import monitor as _monitor
from ..framework import OpRole, Program, Variable
from ..lowering import EMPTY_VAR_NAME, LowerCtx, _op_site, lower_op
from .sharding import (Mesh, check_mesh, extract_param_specs, local_shape,
                       shard_of, zero1_spec_for)

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "data_parallel_mesh"]


class ReduceStrategy:
    AllReduce = 0  # replicate params, all-reduce grads (default)
    Reduce = 1     # shard optimizer states across ranks (ZeRO-1 style)


class BuildStrategy:
    """Knobs of the reference's details/build_strategy.h:37 that still
    mean something; ``sync_batch_norm`` is always on (the global batch's
    statistics, as in the JAX package)."""

    ReduceStrategy = ReduceStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0  # CoeffNumDevice
        self.num_trainers = 1
        self.trainer_id = 0
        self.sync_batch_norm = False


class ExecutionStrategy:
    """Reference execution_strategy.h:22; kept for API parity."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = True


LAUNCHER_HINT = ("launch one process per card with "
                 "`python -m paddle_tpu_torch.distributed.launch "
                 "--nproc_per_node N script.py`")

RESCALE_REFUSAL = ("elastic re-forming of the process group across ranks "
                   "is ROADMAP Queue A item 6 (slice 28)")


def data_parallel_mesh(places=None) -> Mesh:
    """A ``{'dp': world}`` mesh over the launched ranks. ``places``: None,
    one place (this rank's), or a ready :class:`Mesh` of ``dp``, ``tp``,
    ``sp`` and ``pp`` axes over every launched rank; several places in one
    process raise (one process drives one card)."""
    world = _dist.get_world_size()
    if isinstance(places, Mesh):
        check_mesh(places)
        if places.size not in (1, world):
            raise ValueError(
                f"with_data_parallel: mesh {places.shape} holds "
                f"{places.size} ranks but {world} rank(s) launched; "
                f"{LAUNCHER_HINT}")
        return places
    if places is not None and not hasattr(places, "torch_device"):
        places = list(places)
        if len(places) > 1:
            raise ValueError(
                f"with_data_parallel(places=...): {len(places)} places in "
                f"one process; the port drives one card a process: "
                f"{LAUNCHER_HINT}")
    return Mesh({"dp": world})


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ``dp`` ranks; the backward sums the cotangent too, for
    a value consumed by batch-sharded rows (each rank's cotangent is the
    partial from its own rows)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _dist._all_reduce(t.detach().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return _dist._all_reduce(g.detach().clone().contiguous(),
                                 group=ctx.group), None


class DPContext:
    """What an op rule sees of the data-parallel step (``LowerCtx.dp``):
    the ``dp`` rank count and an autograd-aware sum over those ranks."""

    def __init__(self, world: int, group=None):
        self.world = int(world)
        self.group = group

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(t, self.group)


# forward ops whose batch reduction the step places, by output slot:
# "sum" (all-reduce), "mean" (all-reduce / ranks), "max"/"min"
_BATCH_REDUCERS = {
    "reduce_sum": {"Out": "sum"},
    "reduce_mean": {"Out": "mean"},
    "mean": {"Out": "mean"},
    "reduce_max": {"Out": "max"},
    "reduce_min": {"Out": "min"},
    "accuracy": {"Accuracy": "mean", "Correct": "sum", "Total": "sum"},
}
# outputs the analysis replicates although they stay per row or are made
# global inside the op: nothing to place
_IN_OP = {
    "layer_norm": {"Mean", "Variance"},
    "batch_norm": {"MeanOut", "VarianceOut", "SavedMean", "SavedVariance"},
}
# updates that reduce over a whole parameter: not on a row shard
_WHOLE_PARAM_UPDATES = frozenset({"lamb", "lars_momentum", "dpsgd"})


def _reduces_batch(op) -> bool:
    """Does the op reduce over dim 0 (the batch)?"""
    if op.type in ("mean", "accuracy") or op.attrs.get("reduce_all"):
        return True
    dims = op.attrs.get("dim")
    dims = [dims] if isinstance(dims, int) else list(dims or [])
    return not dims or 0 in [int(d) for d in dims]


def _is_update(op) -> bool:
    return "Param" in op.inputs and "Grad" in op.inputs




_RESHAPES = frozenset({"reshape2", "reshape", "reshape2_grad",
                       "reshape_grad"})
_LOOKUPS = frozenset({"lookup_table", "lookup_table_grad"})


def _model_axes(spec) -> list:
    return [(d, a) for d, a in enumerate(spec or ()) if a is not None
            and a != "dp"]


def _dp_rows(spec) -> bool:
    """An ``is_distributed`` table's layout: its rows over ``dp``."""
    return bool(spec) and spec[0] == "dp" and not _model_axes(spec)


def _sharded_rows_grad(ids, gout, height, off, pad):
    """The SelectedRows gradient (``merge_rows``) of a sparse lookup into
    this rank's ``height`` rows from ``off`` on: ids outside them, and the
    padding id, go to the sentinel row ``height`` (no gradient)."""
    from ..core.selected_rows import merge_rows

    flat = ids.reshape(-1).long()
    out = (flat < off) | (flat >= off + height)
    if pad is not None and pad != -1:
        out = out | (flat == pad)
    flat = torch.where(out, torch.full_like(flat, height), flat - off)
    return merge_rows(flat, gout.reshape(flat.shape[0], -1), height)


class _DPPlan:
    """Where one program's collectives go over the mesh (see the module
    docstring), from the sharding analysis over the mesh with the rules'
    layout. The executor runs the step (``Executor._run_ops`` hands each
    op to :meth:`run_op`); the plan is part of its step record
    (``_Step.dp``)."""

    def __init__(self, program: Program, mesh, feed_names, fetch_names,
                 batch: int, zero1: bool, rules=None):
        """``mesh``: a :class:`Mesh`, or the rank count of a ``dp``-only
        one; ``rules``: the ``ShardingRules`` over its model axes."""
        from ..analysis.sharding_check import propagate_sharding

        if not isinstance(mesh, Mesh):
            mesh = Mesh({"dp": int(mesh)})
        blk = program.global_block
        ops = blk.ops
        self.mesh = mesh
        rank = _dist.get_rank() if _dist.is_initialized() else 0
        self.rank = rank
        # the dp axis: its rank count (``world``: the batch's ranks) and
        # this rank's coordinate on it
        self.world = mesh.shape.get("dp", 1)
        self.dp_rank = mesh.coord("dp", rank)
        self.groups = {a: _dist.axis_group(mesh, a)
                       for a in mesh.axis_names if mesh.shape[a] > 1}
        self.dp_group = self.groups.get("dp", (None, [rank]))[0]
        # what an op rule sees of the step (LowerCtx.dp)
        self.ctx = DPContext(self.world, self.dp_group) \
            if self.world > 1 else None
        # every rank feeds the same rows: checked at the key's first step
        self.checked = False
        param_specs, feed_spec = extract_param_specs(
            program, mesh.shape, rules=rules)
        analysis = propagate_sharding(
            program, mesh.shape, param_specs=param_specs,
            feed_spec=feed_spec, feed_names=list(feed_names),
            fetch_names=list(fetch_names), batch_size=batch * self.world)
        self.analysis = analysis
        specs = analysis.var_specs
        # the state sharded over a model axis, read by this block: cut
        # from whole values at the first step
        read = {n for op in ops for n in op.input_arg_names}
        self.state_specs = {n: sp for n, sp in analysis.param_specs.items()
                            if (_model_axes(sp) or _dp_rows(sp))
                            and n in read}
        roles = [op.attrs.get("__op_role__", OpRole.Forward) for op in ops]
        backward = [i for i, r in enumerate(roles) if r == OpRole.Backward]
        # the parameter gradients are summed right after this op; under
        # gradient merge once a step, after the last microbatch
        # (``Executor._run_microbatched`` calls ``_sum_grads``)
        self.bucket_after = backward[-1] if backward else None
        self.merging = int(getattr(program, "_pipeline_microbatches",
                                   1)) > 1
        params = {p.name for p in program.all_parameters()}
        self.forward: Dict[int, List[tuple]] = {}
        self.grad_scale: Dict[int, float] = {}
        # op -> [(var, axis)]: summed over a model axis after the op,
        # gathered over one before it
        self.partial: Dict[int, List[tuple]] = {}
        self.gathers: Dict[int, List[tuple]] = {}
        partial_pieces: Dict[str, set] = {}
        mean_uids = set()
        for ev in analysis.collectives:
            if ev.block_idx != 0:
                continue
            op = ops[ev.op_idx]
            role = roles[ev.op_idx]
            if role not in (OpRole.Forward, OpRole.Backward):
                continue
            model = [a for a in ev.axis.split(",") if a != "dp"]
            if ev.kind == "reshard" and model:
                raise NotImplementedError(
                    f"parallel step: op '{op.type}'{_op_site(op)} needs "
                    f"'{ev.var}' resharded over {model} ({ev.reason}); the "
                    f"step places no reshard")
            if ev.kind == "all_gather" and model \
                    and ev.var in op.input_arg_names:
                self.gathers.setdefault(ev.op_idx, []).extend(
                    (ev.var, a) for a in model)
                continue
            if ev.kind != "all_reduce":
                continue
            if op.type == "lookup_table" and _dp_rows(
                    self.state_specs.get(op.input("W")[0])):
                continue                # a dp-row lookup: _localize
            if model:
                self.partial.setdefault(ev.op_idx, []).append(
                    (ev.var, model[0]))
                continue
            if role == OpRole.Backward:
                p = ev.var.split("@GRAD")[0]
                if "@GRAD" in ev.var and p in params:
                    partial_pieces.setdefault(p, set()).add(ev.var)
                    continue
                raise NotImplementedError(
                    f"data parallel: grad op '{op.type}'{_op_site(op)} "
                    f"makes '{ev.var}' a partial sum over the ranks' "
                    f"rows, and it is not a parameter gradient: a batch "
                    f"coupling the parallel step cannot place")
            slot = next((s for s, ns in op.outputs.items()
                         if ev.var in ns), None)
            if slot in _IN_OP.get(op.type, ()):
                continue
            kind = _BATCH_REDUCERS.get(op.type, {}).get(slot)
            if kind is None or not _reduces_batch(op):
                raise NotImplementedError(
                    f"data parallel: op '{op.type}'{_op_site(op)} reduces "
                    f"'{ev.var}' over batch-sharded data in a way the "
                    f"parallel step cannot place (PT744's conservatism); "
                    f"it would run per rank, not over the global batch")
            self.forward.setdefault(ev.op_idx, []).append((ev.var, kind))
            if kind == "mean":
                mean_uids.add(op.attrs.get("__uid__"))
            if kind in ("max", "min"):
                uid = op.attrs.get("__uid__")
                if any(o.attrs.get("__fwd_uid__") == uid for o in ops):
                    raise NotImplementedError(
                        f"data parallel: the gradient of '{op.type}'"
                        f"{_op_site(op)} over the global batch is not "
                        f"placed by the parallel step")
        for i, op in enumerate(ops):
            if self.world > 1 and roles[i] == OpRole.Backward and \
                    op.attrs.get("__fwd_uid__") in mean_uids:
                self.grad_scale[i] = 1.0 / self.world
        # ops run on local shapes: reshapes get local shape attrs, lookups
        # into a vocab-sharded table their shard's rows; outputs an op
        # makes whole where the analysis keeps them sharded are cut back
        self.local_ops: Dict[int, object] = {}
        self.lookups: Dict[int, tuple] = {}
        self.row_lookups: Dict[int, tuple] = {}
        self.conform: Dict[int, List[tuple]] = {}
        for i, op in enumerate(ops):
            self._localize(i, op, blk, specs)
        # the parameter gradients: the backward's final `<param>@GRAD`, in
        # the order the backward writes them
        order: Dict[str, int] = {}
        pieces: Dict[str, set] = {}
        for i in backward:
            op = ops[i]
            for n in op.output_arg_names:
                p = n.split("@GRAD")[0]
                if "@GRAD" not in n or p not in params:
                    continue
                if n == p + "@GRAD":
                    order[p] = i
                if op.type != "sum":
                    pieces.setdefault(p, set()).add(n)
        self.grads: List[str] = []
        for p in sorted(order, key=order.get):
            part = partial_pieces.get(p, set())
            if not part:
                continue
            if part != pieces.get(p, set()):
                raise NotImplementedError(
                    f"data parallel: parameter '{p}' gets gradient pieces "
                    f"from batch-sharded ops ({sorted(part)}) and from "
                    f"replicated ones ({sorted(pieces[p] - part)}): the "
                    f"parallel step cannot sum them across ranks")
            self.grads.append(p + "@GRAD")
        # ZeRO-1: the optimizer state this rank holds the rows of (rows
        # of its local shard under a model axis)
        self.zero_state: Dict[str, int] = {}
        self.zero_updates: List[int] = []
        if zero1 and self.world > 1:
            for v in blk.vars.values():
                if not v.persistable or not v.shape \
                        or _dp_rows(self.state_specs.get(v.name)):
                    continue
                local = local_shape(v.shape, self.state_specs.get(v.name),
                                    mesh.shape)
                if zero1_spec_for(_Shaped(v, local), self.world, True):
                    self.zero_state[v.name] = int(local[0])
            for i, op in enumerate(ops):
                touched = [n for n in op.input_arg_names
                           if n in self.zero_state]
                if not touched:
                    continue
                if not _is_update(op):
                    raise NotImplementedError(
                        f"ZeRO-1: op '{op.type}'{_op_site(op)} reads the "
                        f"row-sharded optimizer state '{touched[0]}' "
                        f"outside an update op")
                if op.type in _WHOLE_PARAM_UPDATES:
                    raise NotImplementedError(
                        f"ZeRO-1: update op '{op.type}'{_op_site(op)} "
                        f"reduces over the whole parameter "
                        f"'{op.input('Param')[0]}' (its norms); it cannot "
                        f"run on a row shard (ROADMAP Queue A item 6, "
                        f"slice 28). Use ReduceStrategy.AllReduce for "
                        f"{op.type}")
                self.zero_updates.append(i)
        self._zero_at = frozenset(self.zero_updates)
        # fetches held sharded: gathered in coordinate order (dp rows,
        # then each model axis along its dim)
        self.fetch_specs = {}
        for n in fetch_names:
            sp = list(self.state_specs.get(n) or specs.get(n) or ())
            if n in self.zero_state or (sp and sp[0] == "dp"):
                sp = ["dp"] + sp[1:] if sp else ["dp"]
            if any(a is not None and mesh.shape.get(a, 1) > 1 for a in sp):
                self.fetch_specs[n] = tuple(sp)
        self.gather = set(self.fetch_specs)

    def _localize(self, i, op, blk, specs) -> None:
        """Op ``i``'s local form (see ``run_op``)."""
        mesh = self.mesh.shape
        if op.type in _RESHAPES:
            out = (op.input("__out__Out") if op.type.endswith("_grad")
                   else op.output("Out"))
            sp = specs.get(out[0]) if out else None
            shape = list(op.attrs.get("shape") or ())
            changed = False
            for d, a in _model_axes(sp):
                if d < len(shape) and shape[d] > 0 and mesh.get(a, 1) > 1:
                    shape[d] //= mesh[a]
                    changed = True
            if changed:
                local = copy.copy(op)
                local.attrs = dict(op.attrs, shape=shape)
                self.local_ops[i] = local
        if op.type in _LOOKUPS:
            w = op.input("W")[0]
            sp = self.state_specs.get(w) or specs.get(w) or ()
            if sp and sp[0] is not None and mesh.get(sp[0], 1) > 1:
                rows = int(blk._var_recursive(w).shape[0]) // mesh[sp[0]]
                off = self.mesh.coord(sp[0], self.rank) * rows
                pad = op.attrs.get("padding_idx", -1)
                if pad is not None and pad != -1:
                    local = copy.copy(self.local_ops.get(i, op))
                    local.attrs = dict(local.attrs, padding_idx=(
                        pad - off if off <= pad < off + rows else -1))
                    self.local_ops[i] = local
                if sp[0] == "dp":
                    self.row_lookups[i] = (op.input("Ids")[0], off, rows)
                else:
                    self.lookups[i] = (op.input("Ids")[0], off, rows)
        for n in op.output_arg_names:
            sp = specs.get(n)
            if n == EMPTY_VAR_NAME or not _model_axes(sp):
                continue
            try:
                shape = blk._var_recursive(n).shape or ()
            except KeyError:
                continue
            for d, a in _model_axes(sp):
                if d < len(shape) and shape[d] > 0 and mesh.get(a, 1) > 1:
                    self.conform.setdefault(i, []).append(
                        (n, d, a, int(shape[d])))

    # -- the executor's hooks ----------------------------------------------
    def fold_seed(self, seed: int) -> int:
        """A rank folds its ``dp`` coordinate into its step seed: the dp
        ranks draw different dropout masks for their rows, the ranks of a
        ``tp`` or ``sp`` group the same ones."""
        return (seed + self.dp_rank * 0x9E3779B1) & 0x7FFFFFFF

    def run_op(self, i, op, env, ctx) -> None:
        """Op ``i`` of the step with its collectives: a ZeRO-1 update on
        this rank's rows; inputs gathered over a model axis, a local
        reshape or vocab-shard lookup; outputs summed over a model axis or
        cut to this rank's shard; a forward batch reduction made global, a
        mean's grad scaled by 1/dp, and after the last backward op the
        parameter gradients summed over dp."""
        run = self.local_ops.get(i, op)
        if i in self._zero_at:
            self._zero_update(run, env, ctx)
        elif i in self.row_lookups:
            self._row_lookup(i, op, run, env, ctx)
        elif i in self.lookups and run.type == "lookup_table_grad" and (
                op.attrs.get("is_sparse") or op.attrs.get("is_distributed")):
            ids_name, off, rows = self.lookups[i]
            env[op.output("W@GRAD")[0]] = _sharded_rows_grad(
                env[ids_name], env[op.input("Out@GRAD")[0]], rows, off,
                op.attrs.get("padding_idx", -1))
        elif i in self.gathers or i in self.lookups:
            local = dict(env)
            for var, a in self.gathers.get(i, ()):
                d = [dd for dd, aa in _model_axes(
                    self.analysis.var_specs.get(var)) if aa == a][0]
                local[var] = _dist._all_gather(env[var].contiguous(),
                                               self.groups[a][0], dim=d)
            mask = self._shift_ids(i, run, local)
            lower_op(run, local, ctx)
            for n in op.output_arg_names:
                if n in local and n != EMPTY_VAR_NAME:
                    env[n] = local[n]
            if mask is not None and run.type == "lookup_table":
                o = run.output("Out")[0]
                env[o] = torch.where(mask.reshape(
                    env[o].shape[:-1] + (1,)), env[o],
                    torch.zeros((), dtype=env[o].dtype,
                                device=env[o].device))
        else:
            lower_op(run, env, ctx)
        for var, a in self.partial.get(i, ()):
            env[var] = _dist._all_reduce(env[var].contiguous().clone(),
                                         group=self.groups[a][0])
        for n, d, a, size in self.conform.get(i, ()):
            v = env.get(n)
            if isinstance(v, torch.Tensor) and v.dim() > d \
                    and v.shape[d] == size:
                k = size // self.mesh.shape[a]
                c = self.mesh.coord(a, self.rank)
                env[n] = v.narrow(d, c * k, k).contiguous()
        for var, kind in self.forward.get(i, ()):
            out = _dist._all_reduce(env[var].clone(),
                                    "sum" if kind == "mean" else kind,
                                    group=self.dp_group)
            env[var] = out / self.world if kind == "mean" else out
        scale = self.grad_scale.get(i)
        if scale is not None:
            for n in op.output_arg_names:
                v = env.get(n)
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    env[n] = v * scale
        if i == self.bucket_after and not self.merging:
            self._sum_grads(env)

    def _row_lookup(self, i, op, run, env, ctx) -> None:
        """A lookup into a table held as this rank's ``dp`` rows, or its
        grad (see the module docstring): every rank's ids gathered, this
        rank's rows looked up and the result summed over ``dp``; the
        gradient of this rank's rows over the gathered output gradient."""
        ids_name, off, rows = self.row_lookups[i]
        ids = _dist._all_gather(env[ids_name].contiguous(), self.dp_group)
        if op.type == "lookup_table_grad":
            g = _dist._all_gather(env[op.input("Out@GRAD")[0]].contiguous(),
                                  self.dp_group)
            env[op.output("W@GRAD")[0]] = _sharded_rows_grad(
                ids, g, rows, off, op.attrs.get("padding_idx", -1))
            return
        local = dict(env)
        local[ids_name] = ids
        mask = self._shift_ids(i, run, local, self.row_lookups)
        lower_op(run, local, ctx)
        o = run.output("Out")[0]
        whole = torch.where(mask.reshape(local[o].shape[:-1] + (1,)),
                            local[o], torch.zeros((), dtype=local[o].dtype,
                                                  device=local[o].device))
        whole = _dist._all_reduce(whole.contiguous(), group=self.dp_group)
        k = whole.shape[0] // self.world
        env[o] = whole[self.dp_rank * k:(self.dp_rank + 1) * k]

    def _shift_ids(self, i, op, local, lookups=None):
        """A vocab-shard lookup (or its grad): the ids moved onto this
        shard's rows (others to row 0) and, for the grad, their output
        gradient rows zeroed; returns the in-shard mask."""
        lookups = self.lookups if lookups is None else lookups
        if i not in lookups:
            return None
        ids_name, off, rows = lookups[i]
        ids = local[ids_name]
        inside = (ids >= off) & (ids < off + rows)
        local[ids_name] = torch.where(inside, ids - off,
                                      torch.zeros_like(ids))
        if op.type == "lookup_table_grad":
            g = op.input("Out@GRAD")[0]
            flat = inside.reshape(-1)
            gv = local[g]
            local[g] = torch.where(
                flat.reshape(gv.shape[:-1] + (1,))
                if flat.numel() == gv[..., 0].numel() else flat,
                gv, torch.zeros((), dtype=gv.dtype, device=gv.device))
        if inside.dim() >= 2 and inside.shape[-1] == 1:
            inside = inside.squeeze(-1)
        return inside

    def gathered(self, names, fetches) -> list:
        out = []
        for n, f in zip(names, fetches):
            spec = self.fetch_specs.get(n)
            if spec is not None and isinstance(f, torch.Tensor):
                if spec[0] == "dp" and self.world > 1:
                    f = _dist._all_gather(f, self.dp_group)
                for d, a in _model_axes(spec):
                    if self.mesh.shape.get(a, 1) > 1:
                        f = _dist._all_gather(f, self.groups[a][0], dim=d)
            out.append(f)
        return out

    def add_ranks_check(self, checks, device) -> None:
        """``FLAGS_check_nan_inf`` over the ranks: one more check,
        ``another rank's step``, non-finite when any rank's checks trip
        (one collective, on the device), so every rank takes the same
        branch; a rank's own trip still names its own op first."""
        pairs = [t.float() for _, mm in checks if mm is not None
                 for t in mm]
        ok = (torch.isfinite(torch.stack(pairs)).all() if pairs
              else torch.ones((), dtype=torch.bool, device=device))
        flag = ok.to(torch.int32).reshape(1)
        _dist._all_reduce(flag, "min")
        verdict = torch.where(flag.bool(), 0.0, float("nan"))[0]
        checks.append(("another rank's step", (verdict, verdict)))

    def _sum_grads(self, env) -> None:
        """The parameter gradients summed over the dp ranks: one flat
        all-reduce a dtype, in the order the backward wrote them; a
        sparse one by gathering every rank's rows and values and merging
        them in rank order."""
        from ..core.selected_rows import is_selected_rows, merge_rows

        if self.world <= 1 or not self.grads:
            return
        live = [g for g in self.grads if g in env]
        for g in [g for g in live if is_selected_rows(env[g])]:
            sr = env[g]
            env[g] = merge_rows(
                _dist._all_gather(sr.rows.contiguous(), self.dp_group),
                _dist._all_gather(sr.values.contiguous(), self.dp_group),
                sr.height)
        live = [g for g in live if isinstance(env[g], torch.Tensor)]
        for dt in dict.fromkeys(env[g].dtype for g in live):
            group = [g for g in live if env[g].dtype == dt]
            flat = torch.cat([env[g].reshape(-1) for g in group])
            _dist._all_reduce(flat, group=self.dp_group)
            off = 0
            for g in group:
                n = env[g].numel()
                env[g] = flat[off:off + n].view(env[g].shape)
                off += n

    def _zero_update(self, op, env, ctx) -> None:
        """One update op on this rank's rows: Param and Grad cut to the
        rows of the sharded state, the fresh param all-gathered over
        dp."""
        param = op.input("Param")[0]
        local = dict(env)
        for n in (param, op.input("Grad")[0]):
            v = env[n]
            if not isinstance(v, torch.Tensor):
                raise NotImplementedError(
                    f"ZeRO-1: '{n}' of '{op.type}' is not a dense tensor")
            k = v.shape[0] // self.world
            local[n] = v[self.dp_rank * k:(self.dp_rank + 1) * k]
        lower_op(op, local, ctx)
        for n in op.output_arg_names:
            if n == EMPTY_VAR_NAME:
                continue
            env[n] = _dist._all_gather(local[n], self.dp_group) \
                if n == param else local[n]


def _scope_dict(scope, attr) -> dict:
    d = getattr(scope, attr, None)
    if d is None:
        d = {}
        setattr(scope, attr, d)
    return d


class _Shaped:
    """A var's metadata with another shape (its local shard's), for
    ``zero1_spec_for``."""

    def __init__(self, v, shape):
        self.shape = tuple(shape)
        self.is_distributed = getattr(v, "is_distributed", False)
        self.is_optimizer_state = getattr(v, "is_optimizer_state", False)


class CompiledProgram:
    def __init__(self, program: Program,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._loss_name: Optional[str] = None
        self._mesh: Optional[Mesh] = None
        # the sharding rules over the mesh's model axes
        # (``parallel.sharding.compile_sharded_step``); None: every param
        # replicated
        self._rules = None
        self._is_data_parallel = False
        # part of the executor's key for this program's steps: rescale
        # moves it on, so the next step re-plans as a new key
        self._generation = 0
        self._replica_steps = 0
        # guards the mesh, the generation and the replica counter against
        # concurrent dispatch threads (the JAX package's lock, by name)
        self._cache_lock = _monitor.make_rlock("CompiledProgram._cache_lock")

    @property
    def program(self) -> Program:
        return self._program

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           places=None) -> "CompiledProgram":
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        self._mesh = data_parallel_mesh(places)
        return self

    def rescale(self, places) -> "CompiledProgram":
        """Elastic recovery: the same mesh drops every step (the next
        one re-plans as a new executor key) and the replica-check
        counter; another mesh raises (re-forming the process group)."""
        old = (dict(self._mesh.shape) if self._mesh
               else {"dp": _dist.get_world_size()})
        new = (dict(places.shape) if isinstance(places, Mesh)
               else {"dp": _dist.get_world_size()})
        if new != old:
            raise NotImplementedError(
                f"CompiledProgram.rescale from {old} to {new}: "
                f"{RESCALE_REFUSAL}")
        mesh = data_parallel_mesh(places)
        with self._cache_lock:
            self._generation += 1
            self._mesh = mesh
            self._replica_steps = 0
        return self

    # -- execution (called by Executor.run) ------------------------------
    def _run(self, exe, feed, fetch_list, scope, return_numpy):
        """The executor's step (``Executor._run_body``) with this
        program's plan: one executor key per (program, feed, fetches,
        flags, strategy, rank count, generation)."""
        from .. import trace as _trace
        from ..executor import global_scope
        from ..resilience import elastic as _elastic

        with self._cache_lock:
            if self._mesh is None:
                self._mesh = data_parallel_mesh()
        scope = scope if scope is not None else global_scope()
        feed = feed or {}
        names = [f.name if isinstance(f, Variable) else f
                 for f in (fetch_list or [])]
        program, blocks, prep_s = exe._prepare(self._program, feed, names)
        mrec = _monitor.step_begin("parallel", program)
        with _trace.span("executor.parallel_step",
                         program=int(getattr(program, "_serial", -1)),
                         mesh=str(dict(self._mesh.shape))):
            try:
                with _elastic.device_loss_classification("parallel_step"):
                    return exe._run_body(program, feed, names, scope,
                                         return_numpy, mrec, prep_s, blocks,
                                         dp=self)
            finally:
                _monitor.step_end(mrec)

    def _zero1(self) -> bool:
        return self._build_strategy.reduce_strategy == ReduceStrategy.Reduce

    def _key(self) -> tuple:
        """What the executor's key adds for this program's steps."""
        rules = None if self._rules is None else tuple(
            (pat.pattern, spec) for pat, spec in self._rules.param_rules)
        with self._cache_lock:
            return ("parallel", self._generation, self._zero1(),
                    tuple(self._mesh.shape.items()), rules)

    def _plan(self, program, feed, names) -> _DPPlan:
        """A new key's plan (the executor calls this at the key's compile
        event)."""
        from ..executor import _feed_batch_rows

        plan = _DPPlan(program, self._mesh, sorted(feed), names,
                       _feed_batch_rows(feed), self._zero1(), self._rules)
        self._observe_static_sharding(program, names, feed)
        return plan

    def _before_step(self, exe, step, feed_t, scope) -> None:
        """At a key's first step, that every rank feeds the same rows;
        then the ZeRO-1 state cut to this rank's rows."""
        plan = step.dp
        if not plan.checked:
            rows = {int(v.shape[0]) for v in feed_t.values() if v.dim()}
            every = _dist.all_gather_object(np.asarray(sorted(rows)))
            if any(not np.array_equal(every[0], e) for e in every):
                raise ValueError(
                    f"data parallel: the ranks feed different batch rows "
                    f"({[e.tolist() for e in every]}); every rank feeds an "
                    f"equal slice of the global batch")
            plan.checked = True
        self._shard_model_state(exe, step.program, plan, scope)
        self._shard_zero_state(exe, step.program, plan, scope)

    def _shard_model_state(self, exe, program, plan, scope) -> None:
        """Cut each var sharded over a model axis, or held as its ``dp``
        rows, that the scope holds whole to this rank's shard, and record
        the layout on the scope (``scope._mesh_shards``: name -> spec;
        ``dp`` rows in ``scope._dp_shards``, as ZeRO-1's, for the sharded
        checkpoint) for the replica check."""
        if not plan.state_specs:
            return
        blk = program.global_block
        for n, spec in plan.state_specs.items():
            whole = tuple(blk._var_recursive(n).shape)
            local = local_shape(whole, spec, self._mesh.shape)
            v = exe._state(n, program, scope)
            if n in plan.zero_state and v.shape[0] * plan.world == \
                    plan.zero_state[n]:
                continue                # this rank's ZeRO-1 rows of it
            if tuple(v.shape) == whole and whole != local:
                scope.set_var(n, shard_of(v, spec, self._mesh,
                                          plan.rank).clone())
            elif tuple(v.shape) != local:
                raise RuntimeError(
                    f"parallel step: '{n}' holds {tuple(v.shape)} in the "
                    f"scope; want {whole} (whole) or {local} (this rank's "
                    f"shard under {spec})")
            if _dp_rows(spec):
                _scope_dict(scope, "_dp_shards")[n] = (0, plan.world)
            else:
                _scope_dict(scope, "_mesh_shards")[n] = tuple(spec)

    def _shard_zero_state(self, exe, program, plan, scope) -> None:
        """Cut each ZeRO-1 state var the scope holds whole (the startup
        run, a restored checkpoint) to this rank's rows, and record the
        layout on the scope (``scope._dp_shards``: name -> (dim, parts))
        for the sharded checkpoint and the replica check."""
        if not plan.zero_state:
            return
        rank, world = plan.dp_rank, plan.world
        shards = _scope_dict(scope, "_dp_shards")
        for n, rows in plan.zero_state.items():
            v = exe._state(n, program, scope)
            if v.shape[0] == rows:
                k = rows // world
                scope.set_var(n, v[rank * k:(rank + 1) * k].clone())
            elif v.shape[0] != rows // world:
                raise RuntimeError(
                    f"ZeRO-1: '{n}' holds {v.shape[0]} rows in the scope; "
                    f"want {rows} (whole) or {rows // world} (this rank's)")
            shards[n] = (0, world)

    def _maybe_check_replicas(self, step, scope) -> None:
        """FLAGS_replica_check_interval: every N-th parallel step, check
        that the replicated state (params, and the optimizer state ZeRO-1
        does not shard) holds identical bytes on every rank
        (resilience.distributed: two checksum words a var, gathered).
        Disagreement goes to FLAGS_replica_divergence_policy."""
        from ..flags import flag
        from ..resilience import distributed as _rdist

        plan = step.dp
        interval = int(flag("replica_check_interval"))
        if interval <= 0 or self._mesh.size <= 1:
            return
        with self._cache_lock:
            self._replica_steps += 1
            due = self._replica_steps % interval == 0
        if not due:
            return
        values = {}
        for n in step.state_names:
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor) and n not in plan.zero_state:
                values[n] = v
        if not values:
            return
        if _monitor.enabled():
            _monitor.counter(
                "resilience_divergence_checks_total",
                "cross-replica consistency sweeps run").inc()
        shard_axes = {n: tuple(a for a in sp if a is not None)
                      for n, sp in plan.state_specs.items()}
        diverged = _rdist.replica_divergence_check(
            self._mesh, values, shard_axes=shard_axes)
        if diverged:
            _rdist.handle_divergence(diverged, path="parallel", axis=",".join(
                a for a in self._mesh.axis_names
                if self._mesh.shape[a] > 1))

    def _observe_static_sharding(self, program, fetch_names, feed) -> None:
        """Predicted per-rank collective volume + comms-vs-compute gauges
        for the layout this step runs (analysis.sharding_check over the
        same zero1_spec_for rule). Advisory: never raises into a step."""
        if not _monitor.enabled() or self._mesh is None:
            return
        try:
            from ..analysis.cost_model import estimate_comms, estimate_cost
            from ..analysis.sharding_check import propagate_sharding
            from ..executor import _feed_batch_rows
            mesh_shape = dict(self._mesh.shape)
            specs, feed_spec = extract_param_specs(program, mesh_shape,
                                                   zero=self._zero1(),
                                                   rules=self._rules)
            batch = (_feed_batch_rows(feed) or 1) * \
                self._mesh.shape.get("dp", 1)
            analysis = propagate_sharding(
                program, mesh_shape, param_specs=specs,
                feed_spec=feed_spec, feed_names=list(feed.keys()),
                fetch_names=fetch_names, batch_size=batch)
            _monitor.observe_comms_cost(
                program, estimate_comms(analysis),
                estimate_cost(program, batch_size=batch))
        except Exception:
            pass
