"""The ``pipeline`` op: program-level pipeline parallelism over a ``pp``
mesh axis (counterpart of ``paddle_tpu/ops/pipeline_op.py``; reference
optimizer.py:2781 PipelineOptimizer, framework/trainer.h:110
PipelineTrainer, device_worker.h:267 SectionWorker).

The repeated stage is a sub-block (authored once through
``layers.PipelineRegion``); its parameters are ``[P, ...]``-stacked
persistable vars (``*.pp_stacked``), which the parallel step holds cut to
this rank's ``[1, ...]`` slice on a mesh with a ``pp`` axis. Lowering:

- a parallel step whose mesh has a ``pp`` axis of ``num_stages`` ranks:
  ``parallel/pipeline.py``'s GPipe schedule over the axis, this rank
  running its stage (another size raises, with the JAX package's
  message);
- otherwise: a loop over the stacked leaves on this rank (the JAX
  package's ``lax.scan`` path: the same math, no collectives).

The forward stashes its inputs in the step's environment (the port's
``while`` idiom: ``__pipeline_<uid>__``, not a program var); the grad op
replays the stages from the stash under autograd, through the GPipe
backward on a ``pp`` axis. A stage's random ops draw from the step seed
folded with the stage and the microbatch, so every stage of every
microbatch draws its own masks and the replay draws the same ones.
"""
from __future__ import annotations

import torch

from ..core.registry import IOSpec, register_op
from ..lowering import EMPTY_VAR_NAME, lower_block

__all__ = []


def _stash_key(uid) -> str:
    return f"__pipeline_{uid}__"


def _stage_closure(ctx, op, env):
    """``(leaves, h, tick) -> y`` from the sub-block, ``tick`` (stage,
    microbatch) folded into the step seed."""
    sub = ctx.program.blocks[op.attrs["sub_block"]]
    in_name = op.attrs["in_name"]
    out_name = op.attrs["out_name"]
    slice_names = list(op.attrs["param_slices"])

    def stage_fn(leaves, h, tick):
        stage, mb = tick
        sctx = ctx.with_uid(ctx.uid)
        sctx.seed = (int(ctx.seed or 0) * 0x2545F491 + stage * 0x9E3779B1
                     + mb * 0x85EBCA77 + 1) & 0x7FFFFFFF
        benv = dict(env)
        benv[in_name] = h
        benv.update(zip(slice_names, leaves))
        lower_block(sub, benv, sctx)
        return benv[out_name]

    return stage_fn


def _pp_mesh(ctx, op):
    """The mesh when this step runs the GPipe schedule, else None."""
    P_ = int(op.attrs["num_stages"])
    mesh = getattr(ctx, "mesh", None)
    if mesh is None or mesh.shape.get("pp", 1) <= 1:
        return None
    if mesh.shape["pp"] != P_:
        raise ValueError(
            f"pipeline op has num_stages={P_} but the mesh 'pp' axis "
            f"has {mesh.shape['pp']} ranks — they must match (one "
            f"stage per rank)")
    return mesh


def _scan(stage_fn, x, stacked):
    h = x
    for s in range(int(stacked[0].shape[0]) if stacked else 0):
        h = stage_fn([p[s] for p in stacked], h, (s, 0))
    return h


def _micro(op, x, mesh):
    from ..parallel.pipeline import check_pipeline

    M = int(op.attrs["num_microbatches"])
    rows = check_pipeline(int(op.attrs["num_stages"]), x.shape[0], mesh, M)
    return x.reshape((M, rows) + tuple(x.shape[1:]))


def _pipeline_lower(ctx, op, env):
    from ..parallel.pipeline import _forward

    x = env[op.input("X")[0]]
    stacked = [env[n] for n in op.input("StackedParams")]
    stage_fn = _stage_closure(ctx, op, env)
    mesh = _pp_mesh(ctx, op)
    if mesh is None:
        y = _scan(stage_fn, x, stacked)
    else:
        s = mesh.coord("pp")
        stash = []
        y = _forward(lambda p, h, mb: stage_fn(p, h, (s, mb)),
                     [p[0] for p in stacked], _micro(op, x, mesh), mesh,
                     "pp", stash=stash).reshape(x.shape)
        env[_stash_key(op.attrs.get("__uid__", 0))] = stash
    env[op.output("Out")[0]] = y


def _pipeline_grad_lower(ctx, op, env):
    """Gradients to X and every stacked param: the scan replayed under
    autograd, or the GPipe backward from the forward's stash."""
    from ..parallel.pipeline import pipeline_backward

    x = env[op.input("X")[0]]
    stacked = [env[n] for n in op.input("StackedParams")]
    stage_fn = _stage_closure(ctx, op, env)
    gy = env[op.input("Out@GRAD")[0]]
    mesh = _pp_mesh(ctx, op)
    if mesh is None:
        px = x.detach().requires_grad_()
        prim = [p.detach().requires_grad_() for p in stacked]
        with torch.enable_grad():
            y = _scan(stage_fn, px, prim)
            gx, *gstacked = torch.autograd.grad(
                y, [px] + prim, gy.to(y.dtype).reshape(y.shape),
                allow_unused=True)
        gx = torch.zeros_like(x) if gx is None else gx
        gstacked = [torch.zeros_like(p) if g is None else g
                    for p, g in zip(stacked, gstacked)]
    else:
        s = mesh.coord("pp")
        stash = env.pop(_stash_key(op.attrs.get("__fwd_uid__", 0)), None)
        if stash is None:
            raise RuntimeError("pipeline_grad run without its forward op "
                               "in the same step")
        gx, gstacked = pipeline_backward(
            lambda p, h, mb: stage_fn(p, h, (s, mb)),
            stacked, stash, _micro(op, gy.reshape(x.shape), mesh), mesh)
        gx = gx.reshape(x.shape)
    for slot, grads in (("X@GRAD", [gx]),
                        ("StackedParams@GRAD", gstacked)):
        for n, g in zip(op.output(slot), grads):
            if n != EMPTY_VAR_NAME:
                env[n] = g


def _pipeline_infer_shape(op, block):
    xv = block._var_recursive(op.input("X")[0])
    out = block._var_recursive(op.output("Out")[0])
    out.shape = xv.shape
    out.dtype = xv.dtype


register_op("pipeline",
            inputs=[IOSpec("X"), IOSpec("StackedParams", duplicable=True)],
            outputs=["Out"],
            attrs={"sub_block": None, "num_stages": 0,
                   "num_microbatches": 1, "in_name": "", "out_name": "",
                   "param_slices": []},
            grad="auto", grad_lower=_pipeline_grad_lower, raw=True,
            infer_shape=_pipeline_infer_shape)(_pipeline_lower)
