"""Eager functional namespace over the whole op registry (counterpart of
``paddle_tpu/dygraph/ops.py``).

Any registered (non-control-flow) op is callable as
``dygraph.ops.<type>(*inputs, **attrs)`` — inputs map positionally onto the
op's input slots (lists allowed for duplicable slots), execution happens
immediately through the same lowering rule the compiled path uses, and the
call is recorded on the tape for backward(). Returns one VarBase when the
op has a single output value, else a tuple in schema order.

This replaces the reference's per-op dygraph dispatch (every layers.* fn
checking in_dygraph_mode and calling the C++ Tracer) with one generic door:
~150 ops become eager for free, and op semantics can't diverge between the
two modes.
"""
from __future__ import annotations

from typing import Any

from ..core import registry
from .base import VarBase, current_tape

__all__ = []  # populated dynamically via __getattr__


def _as_varbase(v):
    if v is None or isinstance(v, VarBase):
        return v
    return VarBase(v, stop_gradient=True)


def _call_op(op_type: str, *args, **attrs):
    opdef = registry.get_op_def(op_type)
    ins = {}
    specs = opdef.inputs
    if len(args) > len(specs):
        raise TypeError(
            f"{op_type}() takes at most {len(specs)} positional inputs "
            f"({[s.name for s in specs]}), got {len(args)}")
    for spec, arg in zip(specs, args):
        if arg is None:
            continue
        vals = list(arg) if isinstance(arg, (list, tuple)) else [arg]
        ins[spec.name] = [_as_varbase(v) for v in vals]
    # slot values may also arrive as keyword args (e.g. Label=...)
    for spec in specs[len(args):]:
        if spec.name in attrs:
            arg = attrs.pop(spec.name)
            if arg is None:
                continue
            vals = list(arg) if isinstance(arg, (list, tuple)) else [arg]
            ins[spec.name] = [_as_varbase(v) for v in vals]
    outs = current_tape().record(op_type, ins, attrs)
    flat = []
    for spec in opdef.outputs:
        for vb in outs.get(spec.name, []):
            if vb is not None:
                flat.append(vb)
    if not flat:
        return None
    return flat[0] if len(flat) == 1 else tuple(flat)


# user-facing names for ops registered under their versioned type
# (reference layers.reshape appends a reshape2 op, etc.)
_ALIASES = {"reshape": "reshape2", "transpose": "transpose2",
            "squeeze": "squeeze2", "unsqueeze": "unsqueeze2",
            "flatten": "flatten2"}


def __getattr__(name: str):
    op_type = _ALIASES.get(name, name)
    first_only = name in _ALIASES  # strip the versioned ops' dummy XShape
    if registry.has_op(op_type):
        def fn(*args, **attrs):
            r = _call_op(op_type, *args, **attrs)
            if first_only and isinstance(r, tuple):
                return r[0]
            return r

        fn.__name__ = name
        fn.__qualname__ = f"dygraph.ops.{name}"
        return fn
    raise AttributeError(f"no registered op '{name}'")
