"""Dygraph (eager) core: VarBase, the tape, guard, to_variable.

Counterpart of ``paddle_tpu/dygraph/base.py`` (reference
paddle/fluid/imperative/: ``VarBase`` eager tensors with grad twins,
``Tracer::TraceOp`` running each kernel at once while wiring an autograd
graph, ``BasicEngine`` sweeping it backwards).

Each op runs once, eagerly, through the same registry rule the static
path interprets, on the guard's device; the tape records which VarBases
each op read and wrote. The JAX package replays the tape under
``jax.grad``; the port does not replay: every op runs under autograd
(the float leaves that are not ``stop_gradient`` enter the tape with
``requires_grad``), so ``backward()`` is one ``torch.autograd.grad`` over
the live leaves. An op whose rule carries a gradient of its own
(``grad_lower``: the lookups, gathers and scatters, which sum in a fixed
order) runs inside a ``torch.autograd.Function`` whose backward calls
that rule, so the eager gradients repeat bit for bit as the static
ones do. The attention op's rule is such a function already
(``kernels.flash_attention``: K1 forward, K3 and K4 backward).

Random ops draw from the op's generator, keyed on the op's position on
the tape and a step seed made from the guard's ``seed`` and the number of
resets (each ``backward()`` without ``retain_graph`` ends a step), as the
executor keys a program's steps: two runs under one seed repeat bit for
bit, and each step draws new dropout masks. (The JAX package keys on the
position alone, which restarts at 0 with each step, so its steps repeat
one mask; ROADMAP Queue C.)
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import registry
from ..core.types import canonical_dtype
from ..lowering import LowerCtx, apply_rule_with_grad

__all__ = ["VarBase", "guard", "to_variable", "enabled", "in_dygraph_mode",
           "current_tape"]

_uid = itertools.count(1)
_tape: Optional["Tape"] = None


def in_dygraph_mode() -> bool:
    return _tape is not None


enabled = in_dygraph_mode


def current_tape() -> "Tape":
    if _tape is None:
        raise RuntimeError(
            "not in dygraph mode — wrap eager code in fluid.dygraph.guard()")
    return _tape


@contextlib.contextmanager
def guard(place=None, seed: int = 0):
    """Eager execution inside (reference dygraph/base.py:89), on
    ``place``: ``CUDAPlace(0)`` when none is given, which raises without
    CUDA as ``Executor()`` does; pass ``CPUPlace()`` for the CPU."""
    from ..executor import CUDAPlace

    global _tape
    device = (place if place is not None else CUDAPlace(0)).torch_device()
    old, _tape = _tape, Tape(seed=seed, device=device)
    try:
        yield
    finally:
        _tape = old


def _device() -> torch.device:
    return _tape.device if _tape is not None else torch.device("cpu")


def _as_tensor(value, device=None) -> torch.Tensor:
    """``value`` as a tensor on ``device`` (the guard's by default). A
    numpy float64 array becomes float32, as the JAX package's arrays do;
    integers keep their width (int64 stays int64 in the port)."""
    device = device if device is not None else _device()
    if isinstance(value, torch.Tensor):
        return value if value.device == device else value.to(device)
    if isinstance(value, VarBase):
        return _as_tensor(value.value, device)
    if isinstance(value, (bool, int, float)):
        return torch.as_tensor(value, device=device)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _differentiable(vb: "VarBase") -> bool:
    return not vb.stop_gradient and isinstance(vb.value, torch.Tensor) \
        and vb.value.is_floating_point()


class VarBase:
    """Eager tensor (reference imperative/layer.h:55). ``value`` is a
    torch tensor on the guard's device; ``_grad`` is the grad twin, filled
    by backward()."""

    def __init__(self, value, name: Optional[str] = None,
                 stop_gradient: bool = False, persistable: bool = False):
        self.value = _as_tensor(value)
        self.uid = next(_uid)
        self.name = name or f"eager_tmp_{self.uid}"
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self._grad: Optional[torch.Tensor] = None

    # -- reference VarBase surface ---------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self) -> str:
        return canonical_dtype(self.value.dtype)

    def numpy(self) -> np.ndarray:
        return self.value.detach().cpu().numpy()

    def set_value(self, v) -> None:
        """Rebind ``value`` to a copy of ``v`` (never a write into the old
        tensor, which a recorded graph may hold); a parameter that took
        gradients keeps taking them."""
        t = _as_tensor(v, self.value.device).detach()
        if t.data_ptr() == self.value.data_ptr():
            t = t.clone()
        self.value = t.requires_grad_(self.value.requires_grad
                                      and t.is_floating_point())

    def detach(self) -> "VarBase":
        return VarBase(self.value.detach(), name=self.name + ".detached",
                       stop_gradient=True)

    def backward(self, retain_graph: bool = False) -> None:
        current_tape().backward(self, retain_graph=retain_graph)

    def gradient(self) -> Optional[np.ndarray]:
        return None if self._grad is None else \
            self._grad.detach().cpu().numpy()

    def clear_gradient(self) -> None:
        self._grad = None

    def astype(self, dtype):
        from . import ops

        return ops.cast(self, in_dtype=self.dtype,
                        out_dtype=canonical_dtype(dtype))

    def __repr__(self):
        return f"VarBase(name={self.name}, shape={self.shape}, " \
               f"dtype={self.dtype})"

    # -- arithmetic (reference math_op_patch for VarBase) ----------------
    def _binary(self, other, op, reverse=False):
        from . import ops

        if not isinstance(other, VarBase):
            # a Python or numpy scalar keeps its own type, so a float
            # promotes an int tensor (forcing self.dtype would truncate)
            other = VarBase(other, stop_gradient=True)
        a, b = (other, self) if reverse else (self, other)
        return getattr(ops, op)(a, b)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", reverse=True)

    def __matmul__(self, o):
        return self._binary(o, "matmul")

    def __rmatmul__(self, o):
        return self._binary(o, "matmul", reverse=True)

    def __neg__(self):
        from . import ops

        return ops.scale(self, scale=-1.0)


class Tape:
    """The ops run since the last reset: for each, the uids it read and
    wrote (the backward slice's graph; the values and their autograd
    graph live on the VarBases)."""

    def __init__(self, seed: int = 0, device=None):
        self.seed = int(seed)
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.entries: List[tuple] = []       # (in uids, out uids)
        self.leaves: Dict[int, VarBase] = {}  # uid -> VarBase (leaf refs)
        self.produced: set = set()
        self.steps = 0                        # resets so far

    # -- tracing ---------------------------------------------------------
    def _enter_leaf(self, vb: VarBase) -> None:
        """A VarBase not produced on this tape: its value moves to the
        tape's device, and a differentiable one becomes a fresh autograd
        leaf (a value produced on an earlier tape drops that graph)."""
        self.leaves[vb.uid] = vb
        if vb.value.device != self.device:
            vb.value = vb.value.detach().to(self.device)
        if _differentiable(vb) and not (vb.value.requires_grad
                                        and vb.value.is_leaf):
            vb.value = vb.value.detach().requires_grad_()

    def _operand(self, vb: VarBase):
        if vb.uid in self.produced or _differentiable(vb) \
                or not isinstance(vb.value, torch.Tensor):
            return vb.value
        return vb.value.detach()

    def record(self, op_type: str, ins: Dict[str, List[Optional[VarBase]]],
               attrs: Dict[str, Any]) -> Dict[str, List[VarBase]]:
        """Run one op eagerly and record it (Tracer::TraceOp)."""
        opdef = registry.get_op_def(op_type)
        if opdef.raw:
            raise RuntimeError(
                f"op '{op_type}' is a graph control-flow op; in dygraph "
                f"mode use ordinary Python control flow instead")
        full_attrs = {name: spec.default for name, spec in opdef.attrs.items()}
        full_attrs.update(attrs)
        pos = len(self.entries)
        in_uids, in_vals = set(), {}
        for slot, vbs in ins.items():
            vals = []
            for vb in vbs:
                if vb is None:
                    vals.append(None)
                    continue
                in_uids.add(vb.uid)
                if vb.uid not in self.produced:
                    self._enter_leaf(vb)
                vals.append(self._operand(vb))
            in_vals[slot] = vals

        ctx = LowerCtx(self.device, seed=self.step_seed(), uid=pos)
        with torch.enable_grad():
            if opdef.grad_lower is not None and any(
                    isinstance(v, torch.Tensor) and v.requires_grad
                    for vals in in_vals.values() for v in vals):
                outs = apply_rule_with_grad(opdef, ctx, in_vals, full_attrs)
            else:
                outs = opdef.lower(ctx, in_vals, full_attrs) or {}
        out_vbs: Dict[str, List[VarBase]] = {}
        out_uids = set()
        for slot, vals in outs.items():
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            vbs = []
            for v in vals:
                vb = VarBase(v) if v is not None else None
                vbs.append(vb)
                if vb:
                    self.produced.add(vb.uid)
                    out_uids.add(vb.uid)
            out_vbs[slot] = vbs
        self.entries.append((in_uids, out_uids))
        return out_vbs

    def step_seed(self) -> int:
        """The seed of this step's random ops: the guard's seed and the
        resets so far, mixed as ``Executor`` mixes a program's seed and
        its step counter."""
        return (self.seed * 1_000_003 + self.steps) & 0x7FFFFFFF

    # -- autograd (reference BasicEngine::Execute) -----------------------
    def backward(self, loss: VarBase, retain_graph: bool = False) -> None:
        if loss.uid not in self.produced:
            raise RuntimeError(
                f"backward() target {loss.name} was not produced on this "
                f"tape (created outside dygraph ops?)")
        # backward slice: only leaves the loss's ops read take part, so
        # unrelated parameters keep gradient()==None instead of receiving
        # zeros (and AdamW's decay never touches them)
        needed = {loss.uid}
        for ins, outs in reversed(self.entries):
            if outs & needed:
                needed |= ins
        leaves = [vb for u, vb in self.leaves.items()
                  if u in needed and _differentiable(vb)]
        if not leaves:
            raise RuntimeError("backward(): no differentiable leaves found")
        target = loss.value
        if target.requires_grad:
            grads = torch.autograd.grad(
                target, [vb.value for vb in leaves],
                grad_outputs=torch.ones_like(target),
                retain_graph=retain_graph, allow_unused=True)
        else:
            grads = [None] * len(leaves)
        for vb, g in zip(leaves, grads):
            # a leaf the slice reaches through no differentiable path has
            # a zero gradient, as under jax.grad
            g = torch.zeros_like(vb.value) if g is None else g.detach()
            # accumulate like the reference GradientAccumulator
            vb._grad = g if vb._grad is None else vb._grad + g
        if not retain_graph:
            self.reset()

    def reset(self) -> None:
        """Drop everything recorded and start the next step. Parameters
        re-register as leaves on the next forward; grads accumulate across
        steps on the VarBases themselves (``_grad``)."""
        self.entries.clear()
        self.leaves.clear()
        self.produced.clear()
        self.steps += 1


def to_variable(value, name=None, zero_copy=None) -> VarBase:
    """reference dygraph/base.py:151."""
    if isinstance(value, VarBase):
        return value
    return VarBase(value, name=name, stop_gradient=True)
