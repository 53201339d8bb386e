"""CompiledProgram: data-parallel training over the launched ranks.

Counterpart of ``paddle_tpu/parallel/compiled_program.py`` (reference
python/paddle/fluid/compiler.py:65 CompiledProgram / :143
with_data_parallel). The JAX package jits one program over a device mesh
and GSPMD partitions it, so every op computes over the GLOBAL batch and
fetches come back replicated. The port runs one process per card
(``distributed.launch``): each rank feeds its slice of the global batch
and runs the program on it through the executor's own step
(``Executor._run_body``, path ``parallel``), and the plan below
(``_DPPlan``, kept on the executor's step record) places the collectives
that make the result the global-batch one. The nan check, the numerics
witness, the spans, the fault sites and the release plan are the
executor's.

Where the collectives go is read from ``analysis.sharding_check`` (the
all-reduce events it derives from spec transitions, with the AllReduce
layout of ``parallel.sharding.zero1_spec_for``):

* a forward-role op that reduces over the batch (``reduce_sum``,
  ``reduce_mean``, ``mean``, ``accuracy``) makes a dp-partial value: the
  step all-reduces its output (summed, or averaged for a mean), so the
  loss is the global one; the grad op of a mean then scales its input
  gradient by 1/ranks, so each rank's gradient is its rows' share of the
  global loss's. ``batch_norm`` in training takes its statistics over the
  global batch inside the op (``LowerCtx.dp``: an all-reduce whose
  backward all-reduces the partial cotangent), so its generic grad, which
  reruns the forward under autograd, reruns the collective too.
  ``layer_norm``'s per-row statistics need nothing. Any other batch
  coupling raises, naming the op and the var: it never runs per rank.
* the parameter gradients the analysis marks partial are summed across
  ranks after the last backward op, bucketed by dtype in the program's
  order of the gradients (one collective a dtype, so a run repeats bit for
  bit); then the update runs.

``ReduceStrategy.Reduce`` (ZeRO-1): each optimizer-state var that
``zero1_spec_for`` row-shards is cut to this rank's rows in the scope at
its first step; an update op then runs on this rank's rows of its Param
and Grad, and the fresh param is all-gathered. Update ops that reduce over
a whole parameter (``lamb``, ``lars_momentum``, ``dpsgd``) raise under
ZeRO-1; gradient clipping runs on the whole summed gradients before the
update, so a global norm is the unsharded one. A fetched value the
analysis keeps batch-sharded is gathered along dim 0 in rank order. Rank
r folds r into its step seed, so ranks draw different dropout masks for
their rows.

The collective backend is ``distributed.collective_backend``'s; every
rank must feed the same number of rows (checked at a key's first step).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import distributed as _dist
from .. import monitor as _monitor
from ..framework import OpRole, Program, Variable
from ..lowering import EMPTY_VAR_NAME, LowerCtx, _op_site, lower_op
from .sharding import Mesh, check_data_parallel, zero1_spec_for

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
                   "is ROADMAP Queue A item 6 (slice 25)")


def data_parallel_mesh(places=None) -> Mesh:
    """A ``{'dp': world}`` mesh over the launched ranks. ``places``: None,
    one place (this rank's), or a ready :class:`Mesh`; several places in
    one process raise (one process drives one card)."""
    world = _dist.get_world_size()
    if isinstance(places, Mesh):
        check_data_parallel(places)
        if places.shape.get("dp", 1) not in (1, world):
            raise ValueError(
                f"with_data_parallel: mesh {places.shape} but {world} "
                f"rank(s) launched; {LAUNCHER_HINT}")
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
    """Sum over the ranks; the backward sums the cotangent too, for a
    value consumed by batch-sharded rows (each rank's cotangent is the
    partial from its own rows)."""

    @staticmethod
    def forward(ctx, t):
        return _dist._all_reduce(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return _dist._all_reduce(g.detach().clone().contiguous())


class DPContext:
    """What an op rule sees of the data-parallel step (``LowerCtx.dp``):
    the rank count and an autograd-aware sum over the ranks."""

    def __init__(self, world: int):
        self.world = int(world)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(t)


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




class _DPPlan:
    """Where one program's collectives go (see the module docstring),
    from the sharding analysis over ``{'dp': world}``. The executor runs
    the step (``Executor._run_ops`` hands each op to :meth:`run_op`); the
    plan is part of its step record (``_Step.dp``)."""

    def __init__(self, program: Program, world: int, feed_names,
                 fetch_names, batch: int, zero1: bool):
        from ..analysis.sharding_check import propagate_sharding

        blk = program.global_block
        ops = blk.ops
        self.world = world
        self.rank = _dist.get_rank() if _dist.is_initialized() else 0
        # what an op rule sees of the step (LowerCtx.dp)
        self.ctx = DPContext(world) if world > 1 else None
        # every rank feeds the same rows: checked at the key's first step
        self.checked = False
        analysis = propagate_sharding(
            program, {"dp": world}, param_specs={}, feed_spec=("dp",),
            feed_names=list(feed_names), fetch_names=list(fetch_names),
            batch_size=batch * world)
        self.analysis = analysis
        roles = [op.attrs.get("__op_role__", OpRole.Forward) for op in ops]
        backward = [i for i, r in enumerate(roles) if r == OpRole.Backward]
        # the parameter gradients are summed right after this op
        self.bucket_after = backward[-1] if backward else None
        params = {p.name for p in program.all_parameters()}
        self.forward: Dict[int, List[tuple]] = {}
        self.grad_scale: Dict[int, float] = {}
        partial_pieces: Dict[str, set] = {}
        mean_uids = set()
        for ev in analysis.collectives:
            if ev.kind != "all_reduce" or ev.block_idx != 0:
                continue
            op = ops[ev.op_idx]
            role = roles[ev.op_idx]
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
            if role != OpRole.Forward:
                continue
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
            if world > 1 and roles[i] == OpRole.Backward and op.attrs.get(
                    "__fwd_uid__") in mean_uids:
                self.grad_scale[i] = 1.0 / world
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
        # ZeRO-1: the optimizer state this rank holds the rows of
        self.zero_state: Dict[str, int] = {}
        self.zero_updates: List[int] = []
        if zero1 and world > 1:
            for v in blk.vars.values():
                if v.persistable and zero1_spec_for(v, world, True):
                    self.zero_state[v.name] = int(v.shape[0])
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
                        f"run on a row shard. Use ReduceStrategy."
                        f"AllReduce for {op.type}")
                self.zero_updates.append(i)
        self._zero_at = frozenset(self.zero_updates)
        # fetches the analysis keeps batch-sharded: gathered in rank order
        self.gather = {n for n in fetch_names
                       if (analysis.var_specs.get(n) or (None,))[0] == "dp"
                       or n in self.zero_state}

    # -- the executor's hooks ----------------------------------------------
    def fold_seed(self, seed: int) -> int:
        """Rank r folds r into its step seed: the ranks draw different
        dropout masks for their rows."""
        return (seed + self.rank * 0x9E3779B1) & 0x7FFFFFFF

    def run_op(self, i, op, env, ctx) -> None:
        """Op ``i`` of the step with its collectives: a ZeRO-1 update on
        this rank's rows, a forward batch reduction made global, a mean's
        grad scaled by 1/ranks, and after the last backward op the
        parameter gradients summed."""
        if i in self._zero_at:
            self._zero_update(op, env, ctx)
        else:
            lower_op(op, env, ctx)
        for var, kind in self.forward.get(i, ()):
            out = _dist._all_reduce(env[var].clone(),
                                    "sum" if kind == "mean" else kind)
            env[var] = out / self.world if kind == "mean" else out
        scale = self.grad_scale.get(i)
        if scale is not None:
            for n in op.output_arg_names:
                v = env.get(n)
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    env[n] = v * scale
        if i == self.bucket_after:
            self._sum_grads(env)

    def gathered(self, names, fetches) -> list:
        return [_dist._all_gather(f) if n in self.gather else f
                for n, f in zip(names, fetches)]

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
        """The parameter gradients summed over the ranks: one flat
        all-reduce a dtype, in the order the backward wrote them."""
        if self.world <= 1 or not self.grads:
            return
        live = [g for g in self.grads if g in env]
        for g in live:
            if not isinstance(env[g], torch.Tensor):
                raise NotImplementedError(
                    f"data parallel: '{g}' is a sparse gradient; sum it "
                    f"densely (is_sparse=False) or shard the table "
                    f"(ROADMAP Queue A item 6, slice 25)")
        for dt in dict.fromkeys(env[g].dtype for g in live):
            group = [g for g in live if env[g].dtype == dt]
            flat = torch.cat([env[g].reshape(-1) for g in group])
            _dist._all_reduce(flat)
            off = 0
            for g in group:
                n = env[g].numel()
                env[g] = flat[off:off + n].view(env[g].shape)
                off += n

    def _zero_update(self, op, env, ctx) -> None:
        """One update op on this rank's rows: Param and Grad cut to the
        rows of the sharded state, the fresh param all-gathered."""
        param = op.input("Param")[0]
        local = dict(env)
        for n in (param, op.input("Grad")[0]):
            v = env[n]
            if not isinstance(v, torch.Tensor):
                raise NotImplementedError(
                    f"ZeRO-1: '{n}' of '{op.type}' is not a dense tensor")
            k = v.shape[0] // self.world
            local[n] = v[self.rank * k:(self.rank + 1) * k]
        lower_op(op, local, ctx)
        for n in op.output_arg_names:
            if n == EMPTY_VAR_NAME:
                continue
            env[n] = _dist._all_gather(local[n]) if n == param \
                else local[n]


class CompiledProgram:
    def __init__(self, program: Program,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._loss_name: Optional[str] = None
        self._mesh: Optional[Mesh] = None
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
        """Elastic recovery: the same world drops every step (the next
        one re-plans as a new executor key) and the replica-check
        counter; another world size raises (re-forming the process
        group)."""
        old = (self._mesh.shape.get("dp", 1) if self._mesh
               else _dist.get_world_size())
        new = (places.shape.get("dp", 1) if isinstance(places, Mesh)
               else _dist.get_world_size())
        if new != old:
            raise NotImplementedError(
                f"CompiledProgram.rescale from dp={old} to dp={new}: "
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
        with self._cache_lock:
            return ("parallel", self._generation, self._zero1(),
                    self._mesh.size)

    def _plan(self, program, feed, names) -> _DPPlan:
        """A new key's plan (the executor calls this at the key's compile
        event)."""
        from ..executor import _feed_batch_rows

        if int(getattr(program, "_pipeline_microbatches", 1)) > 1:
            raise NotImplementedError(
                "data parallel with gradient merge "
                "(GradientMergeOptimizer/PipelineOptimizer): the "
                "microbatch loop does not place the parallel step's "
                "collectives; use one or the other")
        plan = _DPPlan(program, self._mesh.shape.get("dp", 1), sorted(feed),
                       names, _feed_batch_rows(feed), self._zero1())
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
        self._shard_zero_state(exe, step.program, plan, scope)

    def _shard_zero_state(self, exe, program, plan, scope) -> None:
        """Cut each ZeRO-1 state var the scope holds whole (the startup
        run, a restored checkpoint) to this rank's rows, and record the
        layout on the scope (``scope._dp_shards``: name -> (dim, parts))
        for the sharded checkpoint and the replica check."""
        if not plan.zero_state:
            return
        rank, world = plan.rank, plan.world
        shards = getattr(scope, "_dp_shards", None)
        if shards is None:
            shards = scope._dp_shards = {}
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
        if interval <= 0 or plan.world <= 1:
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
        diverged = _rdist.replica_divergence_check(self._mesh, values)
        if diverged:
            _rdist.handle_divergence(diverged, path="parallel", axis="dp")

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
            from .sharding import extract_param_specs

            mesh_shape = dict(self._mesh.shape)
            specs, feed_spec = extract_param_specs(program, mesh_shape,
                                                   zero=self._zero1())
            batch = (_feed_batch_rows(feed) or 1) * self._mesh.size
            analysis = propagate_sharding(
                program, mesh_shape, param_specs=specs,
                feed_spec=feed_spec, feed_names=list(feed.keys()),
                fetch_names=fetch_names, batch_size=batch)
            _monitor.observe_comms_cost(
                program, estimate_comms(analysis),
                estimate_cost(program, batch_size=batch))
        except Exception:
            pass
