"""Operator registry: schemas and op rules.

Counterpart of ``paddle_tpu/core/registry.py``. Each op registers ONE
``lower`` rule: a plain function over torch tensors,
``lower(ctx, ins, attrs) -> {out_slot: [tensor, ...]}``. The interpreter
(``lowering.py``) calls it eagerly, op by op; build-time shape inference
calls it on ``device="meta"`` tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

_OP_REGISTRY: Dict[str, "OpDef"] = {}


@dataclasses.dataclass
class IOSpec:
    """One input/output slot of an op (reference OpProto::Var)."""

    name: str
    duplicable: bool = False
    optional: bool = False
    no_grad: bool = False


@dataclasses.dataclass
class AttrSpec:
    name: str
    default: Any = None
    required: bool = False


@dataclasses.dataclass
class OpDef:
    """Schema + behaviour of one operator type."""

    type: str
    inputs: List[IOSpec] = dataclasses.field(default_factory=list)
    outputs: List[IOSpec] = dataclasses.field(default_factory=list)
    attrs: Dict[str, AttrSpec] = dataclasses.field(default_factory=dict)
    # infer_shape(op, block): set shapes/dtypes on output vars at build time
    infer_shape: Optional[Callable] = None
    # lower(ctx, ins, attrs) -> {out_slot: [tensor, ...]}
    lower: Optional[Callable] = None
    grad: Any = "auto"
    grad_lower: Optional[Callable] = None
    # random ops draw from ctx.generator()
    needs_rng: bool = False
    no_need_buffer: Sequence[str] = ()
    raw: bool = False

    def input_spec(self, slot: str) -> Optional[IOSpec]:
        for s in self.inputs:
            if s.name == slot:
                return s
        return None


def register_op(
    type: str,
    inputs: Sequence = (),
    outputs: Sequence = (),
    attrs: Optional[Dict[str, Any]] = None,
    infer_shape: Optional[Callable] = None,
    grad: Any = "auto",
    grad_lower: Optional[Callable] = None,
    needs_rng: bool = False,
    no_need_buffer: Sequence[str] = (),
    raw: bool = False,
):
    """Decorator registering ``fn`` as the rule for op ``type``.
    ``inputs``/``outputs`` entries are slot-name strings or IOSpec;
    ``attrs`` maps attr name -> default value (or AttrSpec)."""

    def norm_io(items) -> List[IOSpec]:
        return [it if isinstance(it, IOSpec) else IOSpec(name=it)
                for it in items]

    def norm_attrs(a) -> Dict[str, AttrSpec]:
        return {k: v if isinstance(v, AttrSpec) else AttrSpec(name=k,
                                                              default=v)
                for k, v in (a or {}).items()}

    def deco(fn: Callable) -> Callable:
        if type in _OP_REGISTRY:
            raise ValueError(f"op '{type}' registered twice")
        _OP_REGISTRY[type] = OpDef(
            type=type, inputs=norm_io(inputs), outputs=norm_io(outputs),
            attrs=norm_attrs(attrs), infer_shape=infer_shape, lower=fn,
            grad=grad, grad_lower=grad_lower, needs_rng=needs_rng,
            no_need_buffer=tuple(no_need_buffer), raw=raw)
        return fn

    return deco


def get_op_def(type: str) -> OpDef:
    if type not in _OP_REGISTRY:
        raise KeyError(
            f"operator '{type}' is not registered in the PyTorch port; "
            f"known ops: {sorted(_OP_REGISTRY)} ({len(_OP_REGISTRY)} total)")
    return _OP_REGISTRY[type]


def has_op(type: str) -> bool:
    return type in _OP_REGISTRY


def is_generic_grad(type: str) -> bool:
    """A ``<type>_grad`` op of a registered forward op that registers no
    rule of its own: the interpreter runs it through the generic
    gradient (``lowering._lower_generic_grad``)."""
    return (type.endswith("_grad") and type not in _OP_REGISTRY
            and type[:-5] in _OP_REGISTRY)


def all_ops() -> List[str]:
    return sorted(_OP_REGISTRY)
