"""append_backward: autodiff as a Program -> Program transform.

Counterpart of ``paddle_tpu/backward.py`` (reference backward.py:916). The
default grad maker is generic: it emits a ``<type>_grad`` op that carries
the forward op's inputs, outputs and attrs, and ``lowering.py`` runs it by
recomputing the forward rule under ``torch.autograd``. The program-level
rules are the reference's: a var used by several ops gets one ``@GRAD``
per use (``@RENAME@``) summed by a ``sum`` op, ``stop_gradient`` vars and
``no_grad`` slots get no gradient, and the grad-var names are the same, so
the backward program's ``to_dict()`` equals the JAX package's.
``calc_gradient`` (alias ``gradients``) runs the same sweep from any
targets, seeded with 1.0 or with the caller's cotangents; an op whose
``grad`` is a callable maker gets the descs it returns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from .core import registry
from .core.types import is_floating
from .framework import Parameter, Variable, grad_var_name
from .lowering import EMPTY_VAR_NAME

__all__ = ["append_backward", "gradients", "calc_gradient"]


def _find_op_path(block, target_names: Sequence[str]) -> List[int]:
    """Indices of the ops the targets depend on, in program order."""
    needed: Set[str] = set(target_names)
    path: List[int] = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if any(n in needed for n in op.output_arg_names):
            path.append(idx)
            needed.update(n for n in op.input_arg_names
                          if n != EMPTY_VAR_NAME)
    path.reverse()
    return path


def _var_can_carry_grad(block, name: str) -> bool:
    if name == EMPTY_VAR_NAME or not block.has_var_recursive(name):
        return False
    v = block._var_recursive(name)
    return not v.stop_gradient and is_floating(v.dtype)


class _GradAccumulator:
    """Grad contributions per forward var; a var with several consumers
    gets its contributions summed by a ``sum`` op."""

    def __init__(self, block):
        self.block = block
        self.contribs: Dict[str, List[str]] = {}

    def new_contrib_name(self, fwd_name: str) -> str:
        lst = self.contribs.setdefault(fwd_name, [])
        name = grad_var_name(fwd_name) if not lst else (
            f"{grad_var_name(fwd_name)}@RENAME@{len(lst)}")
        lst.append(name)
        return name

    def resolve(self, fwd_name: str) -> Optional[str]:
        """The final grad name of ``fwd_name``, summing if needed."""
        lst = self.contribs.get(fwd_name)
        if not lst:
            return None
        if len(lst) == 1:
            return lst[0]
        target = grad_var_name(fwd_name)
        self.create_grad_var(target, fwd_name)
        self.block.append_op("sum", inputs={"X": list(lst)},
                             outputs={"Out": target})
        self.contribs[fwd_name] = [target]
        return target

    def create_grad_var(self, grad_name: str, fwd_name: str):
        if self.block.has_var(grad_name):
            return self.block.var(grad_name)
        fwd = self.block._var_recursive(fwd_name)
        return self.block.create_var(name=grad_name, shape=fwd.shape,
                                     dtype=fwd.dtype, stop_gradient=True)


def _make_grad_op(op, out_grad: Dict[str, List[str]],
                  in_grad: Dict[str, List[str]]) -> dict:
    """The generic grad-op desc (run by ``lowering._lower_generic_grad``)."""
    opdef = registry.get_op_def(op.type)
    needed = set(s.name for s in opdef.inputs) - set(opdef.no_need_buffer)
    inputs: Dict[str, List[str]] = {
        slot: list(names) for slot, names in op.inputs.items()
        if slot in needed}
    for slot, names in op.outputs.items():
        inputs["__out__" + slot] = list(names)
    inputs.update(out_grad)
    attrs = dict(op.attrs)
    # the grad op gets its own uid and role; it keeps the forward's uid
    # to draw the same random bits when it recomputes the forward rule
    attrs.pop("__op_role__", None)
    attrs.pop("__uid__", None)
    attrs["__fwd_type__"] = op.type
    attrs["__fwd_uid__"] = op.attrs.get("__uid__", 0)
    return {"type": op.type + "_grad", "inputs": inputs,
            "outputs": in_grad, "attrs": attrs}


def _append_backward_core(block, targets: Sequence[Variable],
                          target_gradients, no_grad: Set[str]
                          ) -> _GradAccumulator:
    """The reverse sweep shared by ``append_backward`` and
    ``calc_gradient``: a seed per target (1.0 by ``fill_constant``, or the
    caller's cotangent by ``assign``), then one grad op per op on the
    targets' path whose outputs received a cotangent."""
    path = _find_op_path(block, [t.name for t in targets])
    acc = _GradAccumulator(block)
    target_gradients = target_gradients or [None] * len(targets)
    for tgt, tg in zip(targets, target_gradients):
        seed = acc.new_contrib_name(tgt.name)
        acc.create_grad_var(seed, tgt.name)
        if tg is None:
            block.append_op(
                "fill_constant", outputs={"Out": seed},
                attrs={"shape": list(tgt.shape if tgt.shape is not None
                                     else [1]),
                       "dtype": tgt.dtype, "value": 1.0})
        else:
            block.append_op("assign", inputs={"X": tg},
                            outputs={"Out": seed})

    for idx in reversed(path):
        op = block.ops[idx]
        opdef = registry.get_op_def(op.type)
        if opdef.grad is None:
            continue
        out_grad: Dict[str, List[str]] = {}
        any_out_grad = False
        for slot, names in op.outputs.items():
            gnames = []
            for n in names:
                g = acc.resolve(n) if n != EMPTY_VAR_NAME else None
                gnames.append(g if g is not None else EMPTY_VAR_NAME)
                any_out_grad = any_out_grad or g is not None
            out_grad[slot + "@GRAD"] = gnames
        if not any_out_grad:
            continue
        # this grad op consumes its outputs' cotangents: clear them before
        # registering the inputs' contributions, so an earlier producer of
        # the same name does not sum them again
        for n in op.output_arg_names:
            if n != EMPTY_VAR_NAME and acc.contribs.get(n):
                acc.contribs[n] = []

        in_grad: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            spec = opdef.input_spec(slot)
            if spec is not None and spec.no_grad:
                continue
            gnames = []
            for n in names:
                if n in no_grad or not _var_can_carry_grad(block, n):
                    gnames.append(EMPTY_VAR_NAME)
                else:
                    gname = acc.new_contrib_name(n)
                    acc.create_grad_var(gname, n)
                    gnames.append(gname)
            if any(g != EMPTY_VAR_NAME for g in gnames):
                in_grad[slot + "@GRAD"] = gnames
        if not in_grad:
            continue
        descs = (opdef.grad(op, block, out_grad, in_grad)
                 if callable(opdef.grad)
                 else [_make_grad_op(op, out_grad, in_grad)])
        for desc in descs:
            block.append_op(desc["type"], inputs=desc["inputs"],
                            outputs=desc["outputs"], attrs=desc["attrs"])
    return acc


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append grad ops for every op on the loss's path; returns
    ``[(param, grad_var), ...]`` as the reference does. ``callbacks`` and
    ``checkpoints`` are accepted and not read, as in the JAX package."""
    block = loss.block
    program = block.program
    with program._op_role_guard("backward"):
        acc = _append_backward_core(block, [loss], None,
                                    set(no_grad_set or ()))
        params = (program.all_parameters() if parameter_list is None else [
            block._var_recursive(p) if isinstance(p, str) else p
            for p in parameter_list])
        result = []
        for p in params:
            if isinstance(p, Parameter) and not p.trainable:
                continue
            # a multiply-used parameter (a tied embedding) gets its sum op
            # here, under the backward role
            g = acc.resolve(p.name)
            if g is not None:
                result.append((p, block.var(g)))
    return result


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of ``targets`` with respect to arbitrary ``inputs``,
    optionally seeded with the caller's cotangents (reference
    backward.py:1177); an input no target depends on gets None."""
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(target_gradients,
                                                       (list, tuple)):
        target_gradients = [target_gradients]
    if target_gradients is not None and \
            len(target_gradients) != len(targets):
        raise ValueError("target_gradients length must match targets")
    block = targets[0].block
    acc = _append_backward_core(block, targets, target_gradients,
                                set(no_grad_set or ()))
    outs = []
    for iv in inputs:
        g = acc.resolve(iv.name)
        outs.append(block.var(g) if g is not None else None)
    return outs


gradients = calc_gradient
