"""Control-flow ops (counterpart of ``paddle_tpu/ops/control_flow.py``):
``conditional_block``, the one the AMP decorator's skip-update runs.
``while``, ``recurrent``, tensor arrays and beam search wait for a later
slice.

The reference lowers ``conditional_block`` to ``lax.cond``; the port
interprets eagerly, so the condition is read on the host (one device
sync) and only the branch taken runs.
"""
from __future__ import annotations

import torch

from ..core.registry import IOSpec, register_op
from ..lowering import LowerCtx, lower_block


def _false_branch(ctx, sub, env, out_names):
    """The outputs when the condition is false: a var that already has a
    value keeps it, a new one is zeros. Their shapes and types come from
    the sub-block run on meta tensors, and a kept value must agree with
    what the sub-block would have written."""
    meta_env = {n: v.to("meta") if isinstance(v, torch.Tensor) else v
                for n, v in env.items()}
    lower_block(sub, meta_env, LowerCtx(program=ctx.program))
    for n in out_names:
        s = meta_env[n]
        v = env.get(n)
        if v is None:
            env[n] = torch.zeros(s.shape, dtype=s.dtype, device=ctx.device)
        elif (tuple(v.shape), v.dtype) != (tuple(s.shape), s.dtype):
            raise ValueError(
                f"conditional_block output '{n}': the sub-block produces "
                f"shape {tuple(s.shape)} dtype {s.dtype} but the "
                f"pre-existing value (kept when the condition is false) "
                f"has shape {tuple(v.shape)} dtype {v.dtype} — both "
                f"branches of a conditional must agree")


def _no_infer(op, block):
    """Outputs keep the shapes and types they were created with."""


@register_op("conditional_block",
             inputs=[IOSpec("Cond"), IOSpec("Input", duplicable=True,
                                           optional=True)],
             outputs=[IOSpec("Out", duplicable=True),
                      IOSpec("Scope", optional=True)],
             attrs={"sub_block": None, "is_scalar_condition": True},
             grad=None, raw=True, infer_shape=_no_infer)
def _conditional_block(ctx, op, env):
    """Run the sub-block over a copy of ``env`` when ``Cond`` holds and
    write its ``Out`` vars back."""
    sub = ctx.program.blocks[op.attrs["sub_block"]]
    out_names = list(dict.fromkeys(op.output("Out")))
    if not bool(env[op.input("Cond")[0]].reshape(-1)[0]):   # host read
        _false_branch(ctx, sub, env, out_names)
        return
    benv = dict(env)
    lower_block(sub, benv, ctx)
    for n in out_names:
        env[n] = benv[n]
