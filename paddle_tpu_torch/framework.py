"""Program IR: Program / Block / Operator / Variable / Parameter.

Counterpart of ``paddle_tpu/framework.py`` (reference framework.py). The
Python objects ARE the IR, with a JSON-serialisable dict form
(``Program.to_dict``). Ops are metadata; ``lowering.py`` interprets them
eagerly over torch tensors. Every op gets a stable ``__uid__`` and the
program's current ``__op_role__`` (forward, backward, optimize) at append
time; random ops derive their ``torch.Generator`` from the uid, and a
``<type>_grad`` op (``backward.py``) carries its forward op's uid so the
recompute draws the same bits. A program may carry an AMP policy
(``_amp_policy``, installed by ``contrib.mixed_precision``); it survives
``to_dict``/``from_dict`` and ``clone``.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name
from .core import registry
from .core.types import VarType, canonical_dtype

__all__ = ["Program", "Block", "Operator", "Variable", "Parameter",
           "default_main_program", "default_startup_program",
           "program_guard", "grad_var_name", "switch_main_program",
           "switch_startup_program", "name_scope", "in_dygraph_mode"]

GRAD_VAR_SUFFIX = "@GRAD"


class OpRole:
    Forward = "forward"
    Backward = "backward"
    Optimize = "optimize"
    LRSched = "lr_sched"
    # the roles clone(for_test=True) drops
    PRUNE_FOR_TEST = (Backward, Optimize, LRSched)


def grad_var_name(name: str) -> str:
    return name + GRAD_VAR_SUFFIX


class Variable:
    """A named tensor in a Block. Build-time metadata only; runtime
    values live in the executor Scope as torch tensors."""

    def __init__(self, block: "Block", name: str,
                 shape: Optional[Sequence[int]] = None,
                 dtype: Any = "float32", type: VarType = VarType.LOD_TENSOR,
                 lod_level: int = 0, persistable: bool = False,
                 stop_gradient: bool = False, is_data: bool = False,
                 initializer=None, **kwargs):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None \
            else None
        self.dtype = canonical_dtype(dtype)
        self.type = type
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data

    def astype(self, dtype):
        """A ``cast`` of this var to ``dtype``."""
        from .layers import tensor as _t

        return _t.cast(self, dtype)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    # arithmetic sugar (reference math_op_patch.py): each operator appends
    # an elementwise op; a scalar operand becomes a [1] fill_constant
    def _binary(self, other, op, reverse=False):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, op, reverse)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    def __radd__(self, o):
        return self._binary(o, "elementwise_add", True)

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    def __rmul__(self, o):
        return self._binary(o, "elementwise_mul", True)

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", True)

    def __pow__(self, o):
        return self._binary(o, "elementwise_pow")

    def __neg__(self):
        from .layers import nn as _nn

        return _nn.scale(self, scale=-1.0)

    def __matmul__(self, o):
        from .layers import nn as _nn

        return _nn.matmul(self, o)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": self.type.value,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
        }
        if getattr(self, "is_optimizer_state", False):
            d["is_optimizer_state"] = True
        if getattr(self, "is_distributed", False):
            d["is_distributed"] = True    # the sparse-table tag
        return d

    @staticmethod
    def from_dict(block: "Block", d: dict) -> "Variable":
        v = Variable(block, name=d["name"], shape=d["shape"],
                     dtype=d["dtype"], type=VarType(d["type"]),
                     lod_level=d.get("lod_level", 0),
                     persistable=d.get("persistable", False),
                     stop_gradient=d.get("stop_gradient", False),
                     is_data=d.get("is_data", False))
        if d.get("is_optimizer_state"):
            v.is_optimizer_state = True
        if d.get("is_distributed"):
            v.is_distributed = True
        return v


class Parameter(Variable):
    """A trainable persistable Variable."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, name, shape=shape, dtype=dtype, **kwargs)

    def to_dict(self):
        d = super().to_dict()
        d["is_parameter"] = True
        d["trainable"] = self.trainable
        d["optimize_attr"] = self.optimize_attr
        if self.regularizer is not None:
            d["regularizer"] = {
                "type": type(self.regularizer).__name__,
                "coeff": getattr(self.regularizer, "_coeff", 0.0)}
        return d


class Operator:
    """One op in a Block: inputs/outputs map slot name -> var names;
    attrs is a plain dict filled with the registered schema's defaults."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {
            slot: [v.name if isinstance(v, Variable) else v
                   for v in _as_list(vs)]
            for slot, vs in (inputs or {}).items()}
        self.outputs: Dict[str, List[str]] = {
            slot: [v.name if isinstance(v, Variable) else v
                   for v in _as_list(vs)]
            for slot, vs in (outputs or {}).items()}
        self.attrs: Dict[str, Any] = dict(attrs or {})
        if registry.is_generic_grad(type):
            return              # a <type>_grad op carries its forward attrs
        opdef = registry.get_op_def(type)
        for aname, aspec in opdef.attrs.items():
            if aname not in self.attrs:
                if aspec.required:
                    raise ValueError(
                        f"op {type}: required attr '{aname}' missing")
                self.attrs[aname] = copy.copy(aspec.default)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def set_attr(self, name: str, value) -> None:
        """Set an attr and bump the program's version, so caches keyed on
        (serial, version) see the change."""
        self.attrs[name] = value
        self.block.program._bump_version()

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def attr(self, name: str):
        return self.attrs.get(name)

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def infer_shape(self):
        if registry.is_generic_grad(self.type):
            return              # grad vars get their shapes at creation
        opdef = registry.get_op_def(self.type)
        if opdef.infer_shape is not None:
            opdef.infer_shape(self, self.block)
        elif opdef.lower is not None:
            from . import lowering

            lowering.auto_infer_shape(self, self.block)

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _jsonable_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(block: "Block", d: dict) -> "Operator":
        return Operator(block, d["type"], inputs=d["inputs"],
                        outputs=d["outputs"], attrs=d["attrs"])


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


class Block:
    """An ordered list of ops plus a var table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name: Optional[str] = None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kwargs) -> Parameter:
        p = Parameter(self, name, shape, dtype, **kwargs)
        self.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise KeyError(f"variable '{name}' not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def _var_recursive(self, name: str) -> Variable:
        """The var in this block or the nearest ancestor that has it."""
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise KeyError(f"variable '{name}' not found in block {self.idx} "
                       f"or ancestors")

    def has_var_recursive(self, name: str) -> bool:
        try:
            self._var_recursive(name)
            return True
        except KeyError:
            return False

    def all_parameters(self) -> List["Parameter"]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _stamp(self, op: Operator) -> None:
        """Give ``op`` a stable ``__uid__``, the current op role and the
        user line that created it (for ops built outside ``append_op``,
        e.g. ``recompute_segment``)."""
        op.attrs.setdefault("__uid__", self.program._next_uid())
        op.attrs.setdefault("__op_role__", self.program._op_role)
        if "op_callstack" not in op.attrs:
            site = _user_call_site()
            if site:
                op.attrs["op_callstack"] = site
        if _name_scope_stack and "op_namescope" not in op.attrs:
            # reference op_proto_maker OpNamescopeAttrName
            op.attrs["op_namescope"] = "/".join(_name_scope_stack)

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        return self.insert_op(len(self.ops), type, inputs, outputs, attrs)

    def prepend_op(self, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        return self.insert_op(0, type, inputs, outputs, attrs)

    def insert_op(self, index: int, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self._stamp(op)
        self.ops.insert(index, op)
        op.infer_shape()
        return op

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }


class Program:
    """A program: blocks of ops over named vars."""

    _serial_counter = itertools.count()

    def __init__(self):
        self._serial = next(Program._serial_counter)
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._uid_counter = 0
        self.random_seed = 0
        self._op_role = OpRole.Forward       # stamped on appended ops
        # bumped on every append and attr change: with _serial, the
        # identity the executor's caches key on
        self._version = 0
        self._amp_policy = None           # lowering.AmpPolicy

    def _next_uid(self) -> int:
        self._uid_counter += 1
        self._version += 1
        return self._uid_counter

    def _bump_version(self) -> None:
        self._version += 1

    @contextlib.contextmanager
    def _op_role_guard(self, role: str):
        old, self._op_role = self._op_role, role
        try:
            yield
        finally:
            self._op_role = old

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.list_vars() if isinstance(v, Parameter)]

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """Open a sub-block of the current block (or of ``parent_idx``);
        ops append there until :meth:`_rollback`."""
        parent = self.current_block_idx if parent_idx is None \
            else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def _rollback(self):
        self.current_block_idx = \
            self.blocks[self.current_block_idx].parent_idx

    def clone(self, for_test: bool = False) -> "Program":
        """A deep copy with a fresh ``_serial``. With ``for_test`` the
        backward, optimize and lr-schedule ops are pruned (an inference
        run must not update parameters) and every op with an ``is_test``
        attr switches to inference behaviour."""
        p = Program.from_dict(self.to_dict())
        p._uid_counter = self._uid_counter
        p.random_seed = self.random_seed
        if for_test:
            for blk in p.blocks:
                blk.ops = [op for op in blk.ops
                           if op.attrs.get("__op_role__", OpRole.Forward)
                           not in OpRole.PRUNE_FOR_TEST]
            for blk in p.blocks:
                for op in blk.ops:
                    if "is_test" in op.attrs:
                        op.set_attr("is_test", True)
                    if op.type == "batch_norm":
                        op.set_attr("use_global_stats", True)
        return p

    def memory_plan(self, feed_names: Sequence[str] = (),
                    fetch_names: Sequence[str] = (), batch_size: int = 1,
                    mesh: Optional[Dict[str, int]] = None,
                    specs: Optional[Dict[str, tuple]] = None):
        """Static peak-memory plan for the global block: a linear-scan
        estimate of live bytes per op index with weights / gradients /
        optimizer state / activations split out. ``-1`` dims resolve to
        ``batch_size``. See ``analysis.liveness.memory_plan``.

        With ``mesh`` (``{"dp": 2}``) the plan is per rank under a
        sharding assignment: ``specs`` (name -> PartitionSpec-like tuple,
        e.g. from ``parallel.sharding.extract_param_specs``) seeds
        ``analysis.sharding_check.propagate_sharding``, live bytes divide
        per propagated spec (replicated tensors count whole), and
        collective staging buffers are charged at their emitting op. The
        plan carries the analysis on ``plan.sharding``."""
        from .analysis.liveness import memory_plan as _memory_plan

        if mesh is None:
            return _memory_plan(self, feed_names=feed_names,
                                fetch_names=fetch_names,
                                batch_size=batch_size)
        from .analysis.sharding_check import (propagate_sharding,
                                              staging_bytes_by_op)

        analysis = propagate_sharding(
            self, mesh, param_specs=specs, feed_names=feed_names,
            fetch_names=fetch_names, batch_size=batch_size)
        plan = _memory_plan(self, feed_names=feed_names,
                            fetch_names=fetch_names, batch_size=batch_size,
                            mesh=analysis.mesh, specs=analysis.var_specs,
                            staging=staging_bytes_by_op(analysis))
        plan.sharding = analysis
        return plan

    def to_dict(self) -> dict:
        d = {"version": 1, "blocks": [b.to_dict() for b in self.blocks]}
        amp = self._amp_policy
        if amp is not None:
            d["amp_policy"] = {"white": sorted(amp.white),
                               "black": sorted(amp.black),
                               "compute_dtype": amp.compute_dtype}
        return d

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            b.forward_block_idx = bd.get("forward_block_idx", -1)
            p.blocks.append(b)
        for b, bd in zip(p.blocks, d["blocks"]):
            for vd in bd["vars"]:
                if vd.get("is_parameter"):
                    reg = vd.get("regularizer")
                    if reg:
                        from . import regularizer as reg_mod

                        reg = getattr(reg_mod, reg["type"])(reg["coeff"])
                    param = Parameter(
                        b, vd["name"], vd["shape"], vd["dtype"],
                        trainable=vd.get("trainable", True),
                        optimize_attr=vd.get("optimize_attr",
                                             {"learning_rate": 1.0}),
                        regularizer=reg or None)
                    param.stop_gradient = vd.get("stop_gradient", False)
                    if vd.get("is_distributed"):
                        param.is_distributed = True
                    b.vars[vd["name"]] = param
                else:
                    b.vars[vd["name"]] = Variable.from_dict(b, vd)
            for od in bd["ops"]:
                op = Operator.from_dict(b, od)
                b.ops.append(op)
                p._uid_counter = max(p._uid_counter,
                                     op.attrs.get("__uid__", 0))
        if d.get("amp_policy"):
            from .lowering import AmpPolicy

            ap = d["amp_policy"]
            p._amp_policy = AmpPolicy(ap["white"], ap["black"],
                                      ap["compute_dtype"])
        return p

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Program":
        return Program.from_dict(json.loads(s))


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    """Make ``p`` the default main program; returns the previous one."""
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    """Make ``p`` the default startup program; returns the previous one."""
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    old_main, _main_program = _main_program, main_program
    old_startup = _startup_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_startup


_name_scope_stack: List[str] = []


@contextlib.contextmanager
def name_scope(prefix: str):
    """Ops appended inside carry ``op_namescope``, the '/'-joined stack of
    the enclosing scopes' prefixes."""
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()


def in_dygraph_mode() -> bool:
    """True inside ``dygraph.guard()``: the tape is asked, as the JAX
    package asks its own."""
    from .dygraph import base as _dy

    return _dy.in_dygraph_mode()


_PKG_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep


def _user_call_site() -> str:
    """First stack frame outside this package: the user line that created
    the op, so errors can point there."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.normpath(f.f_code.co_filename)
        if not fn.startswith(_PKG_DIR):
            return f"{fn}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return ""


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]
