"""Pipeline parallelism over a ``pp`` mesh axis: the GPipe schedule.

Counterpart of ``paddle_tpu/parallel/pipeline.py`` (reference
python/paddle/fluid/optimizer.py:2781 PipelineOptimizer,
framework/trainer.h:110 PipelineTrainer, device_worker.h:267
SectionWorker). The JAX package runs the schedule as one SPMD program
under ``shard_map``: a ``lax.scan`` over the ticks with a
``lax.ppermute`` of the activations, whose transpose ``jax.grad`` makes
the backward. The port runs one process per rank: rank ``s`` of the
``pp`` line holds stage ``s``'s slice of every ``[P, ...]``-stacked
parameter and runs the same schedule as a host loop, the activations
moving to the next stage by a non-circular point-to-point shift
(``distributed._shift``; rank 0 receives nothing, rank ``P - 1`` sends
nothing).

Schedule (GPipe, M microbatches, P stages, T = M + P - 1 ticks): at tick
``t`` rank ``s`` works on microbatch ``t - s`` when ``0 <= t - s < M``;
rank 0 injects microbatch ``t``, rank ``P - 1`` banks microbatch
``t - (P - 1)``. An idle tick computes nothing (the JAX ranks chew on
zeros there, with the same result). The last stage's outputs are
replicated over the axis by a sum in which every other rank adds zeros
(the JAX package's masked ``psum``), exactly.

The backward (:func:`pipeline_backward`) is the same schedule reversed
and written out: rank ``s`` takes microbatch ``M - 1 - (u - (P - 1 -
s))`` at backward tick ``u``, replays its stage on the microbatch's
stashed input under autograd, and sends the input's cotangent to rank
``s - 1``. Only rank ``P - 1`` reads the output's cotangent (every rank
computes the loss from the replicated output, so each holds the same
cotangent, which must enter the pipeline once), and rank 0's input
cotangents are replicated over the axis as the outputs are, since the ops
before the region run on every ``pp`` rank. The schedule is explicit
rather than a ``torch.autograd.Function`` around the shift: a send must
meet its peer's receive in the same call on both ranks, and autograd
orders a rank's backward nodes by that rank's graph alone (a tick that
only sends has no output for the backward to start from), so the order of
the pairs is kept by the loop. A stage keeps one microbatch's activations
at a time in the backward; the forward keeps the M stage inputs.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .. import distributed as _dist

__all__ = ["pipeline_spmd", "pipeline", "pipeline_backward",
           "stack_stage_params"]


def _line(mesh, axis_name):
    """(stage index, stage count, group, ranks) of this rank's line."""
    group, ranks = _dist.axis_group(mesh, axis_name)
    return mesh.coord(axis_name), int(mesh.shape[axis_name]), group, ranks


def _squeeze(stage_params) -> List[torch.Tensor]:
    """This rank's leaves: a leading singleton (the stage dim of a
    ``[P, ...]``-stacked leaf held sharded over the axis) is squeezed."""
    return [p[0] if p.dim() and p.shape[0] == 1 else p
            for p in stage_params]


def _replicate(buf, mine: bool, group):
    """``buf`` of the rank where ``mine`` holds, on every rank of the
    group: a sum to which every other rank adds zeros."""
    if not mine:
        buf = torch.zeros_like(buf)
    return _dist._all_reduce(buf.contiguous(), group=group)


def _cotangent(s: int, P: int, g_out_mb, recv):
    """The cotangent stage ``s`` pulls back through its output: the
    output's, on the last stage only (it enters the pipeline once), else
    what the next stage sent."""
    return g_out_mb if s == P - 1 else recv


def _replicate_input_grad(buf, mine: bool, group):
    """Stage 0's input cotangents on every rank of the axis: the ops
    before the region run on every ``pp`` rank, and their replicas stay
    equal only if each pulls back the same cotangent."""
    return _replicate(buf, mine, group)


def _forward(stage_fn, params, x_micro, mesh, axis_name, stash=None):
    """The GPipe forward; ``stage_fn(params, h, mb)``. ``stash``: a list
    that takes this stage's input of each microbatch, in order."""
    s, P, group, ranks = _line(mesh, axis_name)
    M = x_micro.shape[0]
    outs: List[Optional[torch.Tensor]] = [None] * M
    recv = None
    for t in range(M + P - 1):
        mb = t - s
        active = 0 <= mb < M
        y = None
        if active:
            h = x_micro[mb] if s == 0 else recv
            if stash is not None:
                stash.append(h)
            y = stage_fn(params, h, mb)
            if s == P - 1:
                outs[mb] = y
        recv = _dist._shift(y, group, ranks, send=active and s < P - 1,
                            recv=s > 0 and 0 <= t - (s - 1) < M,
                            like=x_micro[0])
    buf = torch.stack(outs) if s == P - 1 else torch.empty_like(x_micro)
    return _replicate(buf, s == P - 1, group)


def pipeline_spmd(stage_fn: Callable, stage_params, x_micro,
                  axis_name: str = "pp", mesh=None):
    """Run the GPipe schedule over this rank's line of ``axis_name``.

    stage_fn: ``(params, activation [B_mb, ...]) -> activation`` of the
        same shape and dtype (homogeneous stages).
    stage_params: this rank's stage parameters; a leaf held as a
        ``[1, ...]`` slice of its ``[P, ...]`` stack is squeezed.
    x_micro: ``[M, B_mb, ...]`` microbatched input (replicated over the
        axis). ``mesh``: the ``parallel.sharding.Mesh`` the axis is on
        (the JAX package reads it from the ``shard_map`` context).

    Returns ``[M, B_mb, ...]`` outputs of the last stage, replicated."""
    params = _squeeze(stage_params)
    return _forward(lambda p, h, mb: stage_fn(p, h), params, x_micro,
                    mesh, axis_name)


def pipeline_backward(stage_fn: Callable, stage_params, stash: Sequence,
                      g_out, mesh, axis_name: str = "pp"):
    """The GPipe backward of :func:`_forward`'s run that filled ``stash``:
    ``(g_x [M, B_mb, ...] replicated over the axis, [gradient of each
    leaf of stage_params, its shape])``. ``stage_fn(params, h, mb)`` is
    replayed under autograd one microbatch at a time; ``g_out`` is the
    cotangent of the replicated output, read on the last stage only."""
    s, P, group, ranks = _line(mesh, axis_name)
    M = g_out.shape[0]
    leaves = list(stage_params)
    grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
    g_x: List[Optional[torch.Tensor]] = [None] * M
    recv = None
    like = g_out[0]
    for u in range(M + P - 1):
        k = u - (P - 1 - s)
        active = 0 <= k < M
        g_in = None
        if active:
            mb = M - 1 - k
            gy = _cotangent(s, P, g_out[mb], recv)
            prim = [p.detach().requires_grad_() for p in leaves]
            h = stash[mb].detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(_squeeze(prim), h, mb)
                got = torch.autograd.grad(y, [h] + prim, gy.to(y.dtype),
                                          allow_unused=True)
            g_in = got[0] if got[0] is not None else torch.zeros_like(h)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if s == 0:
                g_x[mb] = g_in
        recv = _dist._shift(g_in, group, ranks, send=active and s > 0,
                            recv=s < P - 1 and 0 <= u - (P - 2 - s) < M,
                            like=like, step=-1)
    buf = torch.stack(g_x) if s == 0 else torch.empty_like(g_out)
    g_x = _replicate_input_grad(buf, s == 0, group)
    return g_x, [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]


def stack_stage_params(per_stage_params):
    """``[stage0_leaves, stage1_leaves, ...]`` -> one list with
    ``[P, ...]`` leaves (a dict of leaves stacks key by key)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: torch.stack([st[k] for st in per_stage_params])
                for k in first}
    return [torch.stack(ls) for ls in zip(*per_stage_params)]


def check_pipeline(n_stages: int, batch: int, mesh, num_microbatches: int,
                   axis_name: str = "pp", batch_axis: str = "dp") -> int:
    """The wrapper's checks: one stage a rank, and the per-``batch_axis``
    rank batch divisible by the microbatch count. Returns the microbatch
    rows."""
    M = int(num_microbatches)
    if mesh.shape.get(axis_name, 1) != n_stages:
        raise ValueError(
            f"mesh '{axis_name}' axis has {mesh.shape.get(axis_name, 1)} "
            f"ranks but the stacked params carry {n_stages} stages — they "
            f"must match (one stage per rank)")
    has_dp = batch_axis is not None and mesh.shape.get(batch_axis, 1) > 1
    if batch % M:
        raise ValueError(
            f"per-{batch_axis + '-rank ' if has_dp else ''}batch {batch} "
            f"not divisible by num_microbatches {M}")
    return batch // M


def pipeline(stage_fn: Callable, stacked_params, x, mesh,
             num_microbatches: int, axis_name: str = "pp",
             batch_axis: str = "dp", place_params: bool = True):
    """The whole-batch wrapper: ``x`` is this rank's ``[B, ...]`` rows
    (its ``batch_axis`` slice), ``stacked_params`` the ``[P, ...]``
    leaves, of which this rank runs its stage's slice (``place_params``
    is the JAX package's switch for its device placement; the port holds
    no placement). Returns the last stage's ``[B, ...]`` outputs,
    replicated over ``axis_name``."""
    leaves = list(stacked_params.values()) \
        if isinstance(stacked_params, dict) else list(stacked_params)
    stages = {int(p.shape[0]) for p in leaves}
    if len(stages) != 1:
        raise ValueError(
            f"stacked param leaves disagree on stage count: {stages}")
    (n_stages,) = stages
    rows = check_pipeline(n_stages, x.shape[0], mesh, num_microbatches,
                          axis_name, batch_axis)
    s = mesh.coord(axis_name)
    xm = x.reshape((int(num_microbatches), rows) + tuple(x.shape[1:]))
    return pipeline_spmd(stage_fn, [p[s:s + 1] for p in leaves], xm,
                         axis_name, mesh).reshape(x.shape)
