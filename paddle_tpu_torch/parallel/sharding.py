"""Sharding rules: map program vars onto a mesh of ranks.

Counterpart of ``paddle_tpu/parallel/sharding.py``. The JAX package
attaches a ``PartitionSpec`` to each var and lets XLA GSPMD partition one
jitted step over a device mesh. The port runs one process per card, so a
:class:`Mesh` here is metadata only: axis names and sizes over the
launched ranks, with no devices in one process. The specs are the same
tuples (one mesh-axis name or None per dim): ``zero1_spec_for`` is the
layout rule ``parallel/compiled_program.py`` runs and
``analysis.sharding_check`` reasons about, one function for both.

The port's step is data parallel only: a mesh with a ``tp``, ``sp`` or
``pp`` axis raises (tensor, sequence and pipeline parallelism are ROADMAP
Queue A item 6, slice 25).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Mesh", "make_mesh", "ShardingRules", "transformer_tp_rules",
           "compile_sharded_step", "zero1_spec_for", "extract_param_specs",
           "place_state", "P"]

MODEL_PARALLEL_REFUSAL = (
    "the port's parallel step is data parallel only: a mesh axis other "
    "than 'dp' (tensor, sequence or pipeline parallelism) is ROADMAP "
    "Queue A item 6, slice 25")


def P(*axes) -> tuple:
    """A ``PartitionSpec``-like tuple: one mesh-axis name (or None) per
    dim; ``P()`` is replicated."""
    return tuple(axes)


class Mesh:
    """Axis names and sizes over the launched ranks (``shape`` maps each
    axis to its size, as a jax ``Mesh.shape`` does). Rank r's coordinate
    is its index in row-major order over the axes."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in dict(shape).items()}
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self):
        return f"Mesh({self.shape})"


def check_data_parallel(mesh: Mesh) -> None:
    extra = [a for a, n in mesh.shape.items() if a != "dp" and n > 1]
    if extra:
        raise NotImplementedError(
            f"mesh {mesh.shape}: axes {extra}: {MODEL_PARALLEL_REFUSAL}")


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
    family (metadata: the port's step refuses a ``tp`` axis)."""
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
    counterpart is a data-parallel ``CompiledProgram`` over the launched
    ranks: returns ``(run, io)`` where ``run(exe, feed, scope)`` runs one
    parallel step and returns the fetches, and ``io`` lists the feeds and
    fetches. A rule that shards a param raises (model parallelism)."""
    check_data_parallel(mesh)
    if rules is not None and any(any(a is not None for a in spec)
                                 for _, spec in rules.param_rules):
        raise NotImplementedError(
            f"compile_sharded_step with param rules: "
            f"{MODEL_PARALLEL_REFUSAL}")
    from .compiled_program import CompiledProgram

    compiled = CompiledProgram(program).with_data_parallel()

    def run(exe, feed, scope=None):
        return exe.run(compiled, feed=feed, fetch_list=list(fetch_names),
                       scope=scope)
    return run, {"feed_order": list(feed_names),
                 "fetch": list(fetch_names)}


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
    layers name-pattern specs on top."""
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
                if ".pp_stacked" in v.name and "pp" in mesh_shape:
                    spec = ("pp",)
            if not any(a is not None for a in spec):
                spec = zero1_spec_for(v, dp, zero)
            if any(a is not None for a in spec):
                specs[v.name] = spec
    feed_spec = ("dp",) if dp > 1 else ()
    return specs, feed_spec


def place_state(scope_values: Dict[str, object], mesh: Mesh,
                rules: ShardingRules) -> Dict[str, object]:
    """Each rank's piece of the scope state under ``rules`` on a dp-only
    mesh: replicated values are kept whole (every rank's startup run made
    the same values from the same seeds, the reference's
    BCastParamsToDevices without the broadcast); a value whose rule
    shards dim 0 over ``dp`` is cut to this rank's rows."""
    check_data_parallel(mesh)
    from .. import distributed as dist

    dp = mesh.shape.get("dp", 1)
    rank = dist.get_rank() if dp > 1 else 0
    placed = {}
    for name, v in scope_values.items():
        spec = rules.spec_for_param(name)
        if dp > 1 and spec and spec[0] == "dp" \
                and getattr(v, "shape", (0,))[0] % dp == 0:
            rows = v.shape[0] // dp
            placed[name] = v[rank * rows:(rank + 1) * rows]
        else:
            placed[name] = v
    return placed
