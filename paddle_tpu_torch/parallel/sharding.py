"""Sharding rules: map program vars onto a mesh of ranks.

Counterpart of ``paddle_tpu/parallel/sharding.py``. The JAX package
attaches a ``PartitionSpec`` to each var and lets XLA GSPMD partition one
jitted step over a device mesh. The port runs one process per card, so a
:class:`Mesh` maps axis names and sizes onto the launched ranks (rank r's
coordinates are its row-major index over the axes, the last axis varying
fastest, as ``make_mesh`` lays devices out in the JAX package), and each
rank holds its own shard of every sharded var. The specs are the same
tuples (one mesh-axis name or None per dim): ``zero1_spec_for`` and the
rules' specs are the layout ``parallel/compiled_program.py`` runs and
``analysis.sharding_check`` reasons about, one source for both.

Axes: ``dp`` (the batch), ``tp`` (tensor parallel: the params the rules
shard, Megatron-style), ``sp`` (sequence parallel: ring attention in
``fused_multihead_attention(sequence_parallel=True)``) and ``pp``
(pipeline parallel: the ``pipeline`` op's GPipe schedule, each rank
holding one stage's slice of every ``*.pp_stacked`` parameter and its
optimizer state). ``pp`` runs alone or with ``dp``; with ``tp`` or
``sp`` it raises (``PIPELINE_COMPOSE_REFUSAL``).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Mesh", "make_mesh", "ShardingRules", "transformer_tp_rules",
           "compile_sharded_step", "zero1_spec_for", "extract_param_specs",
           "place_state", "P", "check_mesh", "local_shape", "shard_of",
           "state_follows_param", "is_stage_stacked"]

AXES = ("dp", "tp", "sp", "pp")
PIPELINE_COMPOSE_REFUSAL = (
    "a 'pp' axis beside 'tp' or 'sp': the pipeline's stages run the "
    "sub-block without the parallel step's model-axis collectives; "
    "ROADMAP Queue A item 6, slice 28")


def P(*axes) -> tuple:
    """A ``PartitionSpec``-like tuple: one mesh-axis name (or None) per
    dim; ``P()`` is replicated."""
    return tuple(axes)


class Mesh:
    """Axis names and sizes over the launched ranks (``shape`` maps each
    axis to its size, as a jax ``Mesh.shape`` does). Rank r's coordinates
    are its index in row-major order over the axes (the last axis varies
    fastest)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in dict(shape).items()}
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on each axis."""
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords.get(a, 0))
        return r

    def coord(self, axis: str, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) coordinate on ``axis`` (0 for an
        axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        if rank is None:
            from .. import distributed as dist

            rank = dist.get_rank() if dist.is_initialized() else 0
        return self.coords(rank)[axis]

    def lines(self, axis: str):
        """Every group of ranks that differ only in their ``axis``
        coordinate, each in coordinate order, the groups in rank order of
        their first member."""
        seen, out = set(), []
        for r in range(self.size):
            if r in seen:
                continue
            c = self.coords(r)
            line = [self.rank_of({**c, axis: i})
                    for i in range(self.shape[axis])]
            seen.update(line)
            out.append(line)
        return out

    def __repr__(self):
        return f"Mesh({self.shape})"


def check_mesh(mesh: Mesh) -> None:
    """The axes the port's parallel step runs: ``dp``, ``tp``, ``sp`` and
    ``pp``; ``pp`` beside ``tp`` or ``sp``, or any other axis, raises."""
    if mesh.shape.get("pp", 1) > 1 and any(
            mesh.shape.get(a, 1) > 1 for a in ("tp", "sp")):
        raise NotImplementedError(
            f"mesh {mesh.shape}: {PIPELINE_COMPOSE_REFUSAL}")
    extra = [a for a, n in mesh.shape.items() if a not in AXES
             and n > 1]
    if extra:
        raise ValueError(f"mesh {mesh.shape}: unknown axes {extra}; the "
                         f"parallel step runs {list(AXES)}")


def make_mesh(shape: Dict[str, int], devices=None) -> Mesh:
    """``make_mesh({'dp': 2})`` over the launched ranks. ``devices``, when
    given, must hold at least ``prod(shape)`` entries (one per rank)."""
    mesh = Mesh(shape)
    if devices is not None and mesh.size > len(list(devices)):
        raise ValueError(f"mesh needs {mesh.size} devices, have "
                         f"{len(list(devices))}")
    return mesh


class ShardingRules:
    """Ordered (regex, spec) rules for params + the batch spec for feeds."""

    def __init__(self, param_rules: Sequence[Tuple[str, tuple]] = (),
                 feed_spec: tuple = P("dp"), default: tuple = P()):
        self.param_rules = [(re.compile(pat), tuple(spec))
                            for pat, spec in param_rules]
        self.feed_spec = tuple(feed_spec)
        self.default = tuple(default)

    def spec_for_param(self, name: str, shape=None) -> tuple:
        for pat, spec in self.param_rules:
            if pat.search(name):
                return spec
        return self.default


def transformer_tp_rules() -> ShardingRules:
    """Megatron-style tensor-parallel rules for the BERT/transformer
    family: column-parallel QKV/FFN-in (output dim sharded), row-parallel
    out/FFN-out (input dim sharded; their biases replicated, added once
    after the all-reduce), the vocab-sharded word embedding. Everything
    else replicated."""
    return ShardingRules(param_rules=[
        (r"_(q|k|v|ffn1)_w$", P(None, "tp")),
        (r"_(q|k|v|ffn1)_b$", P("tp")),
        (r"_(out|ffn2)_w$", P("tp", None)),
        (r"word_embedding$", P("tp", None)),
    ], feed_spec=P("dp"))


def compile_sharded_step(program, mesh: Mesh, feed_names: Sequence[str],
                         fetch_names: Sequence[str],
                         rules: Optional[ShardingRules] = None,
                         donate: bool = True):
    """The JAX package jits the block over ``mesh`` here. The port's
    counterpart is a ``CompiledProgram`` over the launched ranks with the
    mesh and the rules: returns ``(run, io)`` where ``run(exe, feed,
    scope)`` runs one parallel step and returns the fetches (each rank
    feeds its ``dp`` slice and holds its shards: see :func:`place_state`),
    and ``io`` lists the feeds and fetches."""
    check_mesh(mesh)
    from .compiled_program import CompiledProgram

    compiled = CompiledProgram(program).with_data_parallel(places=mesh)
    compiled._rules = rules

    def run(exe, feed, scope=None):
        return exe.run(compiled, feed=feed, fetch_list=list(fetch_names),
                       scope=scope)
    return run, {"feed_order": list(feed_names),
                 "fetch": list(fetch_names), "compiled": compiled}


def zero1_spec_for(v, dp: int, zero1: bool) -> tuple:
    """The spec tuple a state var gets on a dp mesh (``()`` =
    replicated): sharded embedding tables (``is_distributed``) row-shard
    regardless of the reduce strategy; optimizer-state vars row-shard
    under ZeRO-1 (``BuildStrategy.ReduceStrategy.Reduce``). Only a dim 0
    that the dp size divides is sharded."""
    if dp <= 1:
        return ()
    if v is None or not v.shape or len(v.shape) < 1 \
            or v.shape[0] < dp or v.shape[0] % dp:
        return ()
    if getattr(v, "is_distributed", False):
        return ("dp",)
    if zero1 and getattr(v, "is_optimizer_state", False):
        return ("dp",)
    return ()


def extract_param_specs(program, mesh_shape: Dict[str, int],
                        build_strategy=None, zero: bool = False,
                        rules: Optional[ShardingRules] = None
                        ) -> Tuple[Dict[str, tuple], tuple]:
    """The per-param spec assignment a ``BuildStrategy`` implies, as plain
    metadata: the input to ``analysis.sharding_check`` and
    ``Program.memory_plan(mesh=...)``. Returns ``(param_specs,
    feed_spec)``: only sharded vars are listed; ``feed_spec`` is the
    batch-axis spec for feeds. ``zero=True`` (or a build_strategy with
    ``ReduceStrategy.Reduce``) applies the ZeRO-1 layout; ``rules``
    layers name-pattern specs on top, and the optimizer state of a param
    they shard follows its param (an update reads its moments on the
    param's shard; in the JAX package GSPMD replicates them instead)."""
    dp = int(mesh_shape.get("dp", 1))
    if build_strategy is not None:
        zero = zero or getattr(build_strategy, "reduce_strategy", 0) == 1
    specs: Dict[str, tuple] = {}
    for blk in program.blocks:
        for v in blk.vars.values():
            if not v.persistable or v.is_data:
                continue
            spec: tuple = ()
            if rules is not None:
                spec = tuple(rules.spec_for_param(v.name, v.shape))
            if is_stage_stacked(v, mesh_shape):
                spec = ("pp",)
            if not any(a is not None for a in spec):
                spec = zero1_spec_for(v, dp, zero)
            if any(a is not None for a in spec):
                specs[v.name] = spec
    if rules is not None:
        specs.update(state_follows_param(program, specs))
    feed_spec = ("dp",) if dp > 1 else ()
    return specs, feed_spec


def is_stage_stacked(v, mesh_shape: Dict[str, int]) -> bool:
    """A ``layers.PipelineRegion`` parameter (``*.pp_stacked``) or an
    optimizer state named after one, stacked over the stages on its
    leading dim: one slice a ``pp`` rank. The JAX package places every
    such name over ``pp`` (its ``sharding_for_param``); a state var of
    another height (a beta power) stays replicated."""
    pp = int(mesh_shape.get("pp", 1))
    return pp > 1 and ".pp_stacked" in v.name and bool(v.shape) \
        and int(v.shape[0]) == pp


def state_follows_param(program, specs: Dict[str, tuple]
                        ) -> Dict[str, tuple]:
    """The optimizer state of each param ``specs`` shards: every input of
    an update op (``Param`` and ``Grad`` slots) of the param's shape gets
    the param's spec."""
    out: Dict[str, tuple] = {}
    for blk in program.blocks:
        for op in blk.ops:
            if "Param" not in op.inputs or "Grad" not in op.inputs:
                continue
            p = op.input("Param")[0]
            spec = specs.get(p)
            if not spec or not any(a is not None for a in spec):
                continue
            shape = blk._var_recursive(p).shape
            for slot, names in op.inputs.items():
                if slot in ("Param", "Grad"):
                    continue
                for n in names:
                    try:
                        v = blk._var_recursive(n)
                    except KeyError:
                        continue
                    if v.persistable and tuple(v.shape or ()) == \
                            tuple(shape):
                        out[n] = spec
    return out


def local_shape(shape, spec, mesh_shape: Dict[str, int]) -> tuple:
    """``shape`` cut to one rank's shard under ``spec``."""
    out = list(shape)
    for d, a in enumerate(spec or ()):
        if a is not None and d < len(out) and out[d] > 0:
            out[d] //= int(mesh_shape.get(a, 1))
    return tuple(out)


def shard_of(value, spec, mesh: Mesh, rank: Optional[int] = None):
    """This rank's (or ``rank``'s) piece of a whole ``value`` under
    ``spec``: each sharded dim cut to the rank's coordinate on its axis."""
    for d, a in enumerate(spec or ()):
        n = mesh.shape.get(a, 1) if a is not None else 1
        if n <= 1:
            continue
        if value.shape[d] % n:
            raise ValueError(f"dim {d} of size {value.shape[d]} does not "
                             f"split over '{a}' of size {n}")
        k = value.shape[d] // n
        i = mesh.coord(a, rank)
        idx = [slice(None)] * len(value.shape)
        idx[d] = slice(i * k, (i + 1) * k)
        value = value[tuple(idx)]
    return value


def place_state(scope_values: Dict[str, object], mesh: Mesh,
                rules: ShardingRules) -> Dict[str, object]:
    """Each rank's piece of the scope state under ``rules``: replicated
    values are kept whole (every rank's startup run made the same values
    from the same seeds, the reference's BCastParamsToDevices without the
    broadcast); a value whose rule shards a dim is cut to this rank's
    shard along it (this rank's coordinate on the rule's axis)."""
    check_mesh(mesh)
    placed = {}
    for name, v in scope_values.items():
        spec = rules.spec_for_param(name)
        shape = getattr(v, "shape", ())
        if any(a is not None and mesh.shape.get(a, 1) > 1 and
               d < len(shape) and shape[d] % mesh.shape[a] == 0
               for d, a in enumerate(spec)):
            placed[name] = shard_of(v, spec, mesh)
        else:
            placed[name] = v
    return placed
