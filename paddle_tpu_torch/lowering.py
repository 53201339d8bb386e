"""Block interpretation over torch tensors.

Counterpart of ``paddle_tpu/lowering.py``. The JAX package traces a whole
block once into one XLA computation; the port interprets it eagerly, op by
op: each op's registered rule runs on torch tensors and its outputs shadow
earlier writes in the environment (in-order scope semantics).

* ``LowerCtx`` — per-op context: the device and the op's own
  ``torch.Generator``, keyed on (step seed, op ``__uid__``).
* ``lower_op`` / ``lower_block`` — the interpreter.
* ``auto_infer_shape`` — build-time shapes: the op's rule runs on
  ``device="meta"`` tensors (no data, no compute), with two sentinel sizes
  for -1 dims, as the reference runs its rule under ``jax.eval_shape``.

AMP, the nan-check taps and the generic gradient path wait for the
training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .core import registry
from .core.types import canonical_dtype, torch_dtype

EMPTY_VAR_NAME = "@EMPTY@"

_META = torch.device("meta")


class LowerCtx:
    """Context passed to every op rule."""

    def __init__(self, device=None, seed: Optional[int] = None,
                 uid: int = 0):
        self.device = torch.device(device) if device is not None else _META
        self.seed = seed
        self.uid = uid

    def with_uid(self, uid: int) -> "LowerCtx":
        return LowerCtx(self.device, self.seed, uid)

    def generator(self) -> Optional[torch.Generator]:
        """A generator unique to this op instance and step; None during
        shape inference (nothing runs on meta tensors)."""
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=self.device)
        mixed = ((int(self.seed or 0) * 0x9E3779B1
                  + int(self.uid) * 0x85EBCA77) & 0x7FFFFFFFFFFFFFFF)
        g.manual_seed(mixed)
        return g


class OpLoweringError(RuntimeError):
    pass


def _op_site(op) -> str:
    site = op.attrs.get("op_callstack", "")
    return f" (created at {site})" if site else ""


def _gather_inputs(op, env: Dict[str, Any]) -> Dict[str, List[Any]]:
    ins: Dict[str, List[Any]] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR_NAME:
                vals.append(None)
            elif n in env:
                vals.append(env[n])
            else:
                raise KeyError(
                    f"op {op.type}: input var '{n}' (slot {slot}) not found "
                    f"— not fed, not initialized, not produced by an earlier "
                    f"op")
        ins[slot] = vals
    return ins


def _write_outputs(op, outs, env: Dict[str, Any]) -> None:
    for slot, names in op.outputs.items():
        vals = (outs or {}).get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for n, v in zip(names, vals):
            if n != EMPTY_VAR_NAME and v is not None:
                env[n] = v


def lower_op(op, env: Dict[str, Any], ctx: LowerCtx) -> None:
    """Run one op's rule against the environment, in place."""
    opdef = registry.get_op_def(op.type)
    try:
        outs = opdef.lower(ctx.with_uid(op.attrs.get("__uid__", 0)),
                           _gather_inputs(op, env), op.attrs)
    except OpLoweringError:
        raise
    except Exception as e:
        raise OpLoweringError(
            f"while running op '{op.type}'{_op_site(op)}: "
            f"{type(e).__name__}: {e}") from e
    _write_outputs(op, outs, env)


def lower_block(block, env: Dict[str, Any], ctx: LowerCtx) -> Dict[str, Any]:
    for op in block.ops:
        lower_op(op, env, ctx)
    return env


# Two sentinel batch sizes for -1 dims: the rule runs twice and an output
# dim is dynamic (-1) iff it differs between the runs.
_BATCH_SENTINELS = (64, 96)


def auto_infer_shape(op, block) -> None:
    """Default build-time shape inference: the op's rule on meta tensors.
    A rule that cannot run on meta tensors is skipped (its output vars
    keep what they had), as the reference skips what ``eval_shape``
    refuses."""
    opdef = registry.get_op_def(op.type)
    ctx = LowerCtx(_META, uid=op.attrs.get("__uid__", 0))

    def build_ins(sentinel):
        ins: Dict[str, List[Any]] = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                v = block.vars.get(n)
                if v is None or v.shape is None:
                    return None
                shape = tuple(sentinel if d == -1 else d for d in v.shape)
                vals.append(torch.empty(shape, dtype=torch_dtype(v.dtype),
                                        device=_META))
            ins[slot] = vals
        return ins

    dynamic = any(-1 in (block.vars[n].shape or ())
                  for names in op.inputs.values() for n in names
                  if n in block.vars)
    results = []
    for sentinel in _BATCH_SENTINELS:
        ins = build_ins(sentinel)
        if ins is None:
            return
        try:
            results.append(opdef.lower(ctx, ins, op.attrs))
        except Exception:
            return
        if not dynamic:
            results.append(results[0])
            break

    outs_a, outs_b = results
    for slot, names in op.outputs.items():
        vals_a, vals_b = (outs_a or {}).get(slot), (outs_b or {}).get(slot)
        if vals_a is None:
            continue
        for n, ta, tb in zip(names, vals_a, vals_b):
            if n == EMPTY_VAR_NAME or ta is None or not block.has_var(n):
                continue
            var = block.var(n)
            var.shape = tuple(int(a) if a == b else -1
                              for a, b in zip(ta.shape, tb.shape))
            var.dtype = canonical_dtype(ta.dtype)
