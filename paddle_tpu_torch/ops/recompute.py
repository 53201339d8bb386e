"""Gradient checkpointing (recompute) as a program transform + one raw op
(counterpart of ``paddle_tpu/ops/recompute.py``).

Reference: python/paddle/fluid/optimizer.py:3074 RecomputeOptimizer and
backward.py:555 _append_backward_ops_with_checkpoints_ — the reference
re-emits each forward segment's ops inside the backward pass so activations
between user checkpoints are freed and rebuilt.

Design: the segment becomes ONE ``recompute_segment`` op holding the
original forward ops in a sub-block.

* **Forward.** The sub-block is interpreted under ``torch.no_grad()`` in a
  child environment that reads through to the parent's; only ``Out`` goes
  back into the parent, so the segment's internals die with the op. What
  stays alive across the forward/backward gap is the segment's inputs
  (checkpoints and parameters) and outputs.
* **Backward** (the grad rule). The sub-block is replayed from the
  segment's ``Input`` values under ``torch.enable_grad()``, through
  ``lower_op``, so the AMP casts and each op's generator apply as they did
  in the forward; ``torch.autograd.grad`` then pulls the ``Out@GRAD``
  cotangents back to the inputs. An op with a grad rule of its own
  (``grad_lower``: ``lookup_table``'s fixed-order sum, ...) is
  differentiated through that rule (``lowering.grad_rules``), so the
  replay's gradients are the plain program's grad ops' bit for bit. This is the counterpart of the
  reference's ``jax.vjp(jax.checkpoint(seg_fn))``: the replay's autograd
  graph holds the segment's internals only while its grad op runs.

Random ops replay bit-identically: every op's generator is keyed on (step
seed, op ``__uid__``) (``lowering.LowerCtx.generator``), and the replay
runs with the forward step's seed and the inner ops' own uids.
"""
from __future__ import annotations

from collections import ChainMap
from typing import List

import torch

from ..core.registry import IOSpec, register_op
from ..lowering import EMPTY_VAR_NAME, grad_rules, lower_block, lower_op

__all__ = ["insert_recompute_segments"]


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _recompute_segment_lower(ctx, op, env):
    sub = ctx.program.blocks[op.attrs["sub_block"]]
    child = ChainMap({}, env)
    with torch.no_grad():
        lower_block(sub, child, ctx)
    for n in op.outputs.get("Out", []):
        env[n] = child[n]


def _readers(sub, names):
    """For each of ``names``: the indexes of the sub-block's ops that read
    it before any op of the sub-block writes it, in op order."""
    readers = {n: [] for n in names}
    written = set()
    for i, sop in enumerate(sub.ops):
        for n in dict.fromkeys(sop.input_arg_names):
            if n in readers and n not in written:
                readers[n].append(i)
        written.update(sop.output_arg_names)
    return readers


def accumulate(pieces):
    """The gradient pieces of one var summed left to right, as the program's
    ``sum`` op sums them. A sum of several keeps its pieces
    (``_grad_pieces``): a ``sum`` op that reads it adds them one by one
    in their place among its other inputs."""
    acc = pieces[0]
    for g in pieces[1:]:
        acc = acc + g
    if len(pieces) > 1:
        acc._grad_pieces = list(pieces)
    return acc


def _recompute_segment_grad_lower(ctx, op, env):
    """Replay the segment from its inputs with autograd on and pull the
    output cotangents back. A missing cotangent counts as zero; an integer
    output gets none.

    Each op of the segment that reads an input gets a leaf of its own, so
    autograd never sums an input's gradient across its readers; the pieces
    come back last reader first, as the plain program's backward orders
    them, and are summed left to right with the pieces kept
    (``accumulate``). The ``sum`` op that adds them to the input's other
    readers' gradients outside the segment then adds exactly what the
    plain program's ``sum`` adds, in its order: the replay's gradients are
    the plain program's bit for bit."""
    sub = ctx.program.blocks[op.attrs["sub_block"]]
    in_names = op.inputs.get("Input", [])
    diff = [n for n in dict.fromkeys(in_names) if _is_float(env.get(n))]
    readers = _readers(sub, diff)
    leaves = {n: [env[n].detach().requires_grad_()
                  for _ in readers[n] or (None,)] for n in diff}
    child = ChainMap({n: ls[0] for n, ls in leaves.items()}, env)
    out_names = op.inputs.get("__out__Out", [])
    grad_in = op.inputs.get("Out@GRAD", [])
    with torch.enable_grad(), grad_rules():
        for i, sop in enumerate(sub.ops):
            for n in sop.input_arg_names:
                if n in readers and i in readers[n]:
                    child.maps[0][n] = leaves[n][readers[n].index(i)]
            lower_op(sop, child, ctx)
        ys, cts = [], []
        for i, n in enumerate(out_names):
            y = child[n]
            if not _is_float(y) or not y.requires_grad \
                    or i >= len(grad_in) or grad_in[i] == EMPTY_VAR_NAME:
                continue
            g = env[grad_in[i]]
            ys.append(y)
            cts.append(g.to(y.dtype).reshape(y.shape))
        flat = [leaf for n in diff for leaf in leaves[n]]
        grads = iter(torch.autograd.grad(ys, flat, cts, allow_unused=True)
                     if ys and flat else [None] * len(flat))
    grad_map = {}
    for n in diff:
        pieces = [g for g in reversed([next(grads) for _ in leaves[n]])
                  if g is not None]
        grad_map[n] = accumulate(pieces) if pieces else \
            torch.zeros_like(env[n])
    for n, gname in zip(in_names, op.outputs.get("Input@GRAD", [])):
        if gname != EMPTY_VAR_NAME and n in grad_map:
            env[gname] = grad_map[n]


register_op("recompute_segment",
            inputs=[IOSpec("Input", duplicable=True, optional=True)],
            outputs=[IOSpec("Out", duplicable=True)],
            attrs={"sub_block": None},
            grad="auto", grad_lower=_recompute_segment_grad_lower, raw=True,
            infer_shape=lambda op, block: None)(_recompute_segment_lower)


def insert_recompute_segments(loss, checkpoints, extra_live=()) -> int:
    """Rewrite ``loss``'s block: forward ops up to each checkpoint collapse
    into ``recompute_segment`` ops. Returns the number of segments created.

    Must run BEFORE append_backward (RecomputeOptimizer.backward does). Vars
    internal to a segment are demoted to sub-block locals — they no longer
    exist between forward and backward, which is the entire point; fetching
    them from user code stops working (same trade the reference makes).

    ``extra_live`` names are treated as observed-after-every-cut (kept as
    segment outputs, never demoted): the auto-remat pass
    (analysis/remat.py) passes fetch names and optimizer-tail reads here so
    a TRANSPARENT transform never breaks a fetch the manual API is allowed
    to break.
    """
    block = loss.block
    program = block.program
    ckpt_names = {c.name if hasattr(c, "name") else c for c in checkpoints}

    ops = list(block.ops)
    producer = {}
    for i, o in enumerate(ops):
        for n in o.output_arg_names:
            if n in ckpt_names:
                producer[n] = i
    cuts = sorted({producer[n] for n in ckpt_names if n in producer})
    if not cuts:
        return 0

    # names read after each cut index, plus names that must survive:
    # checkpoints themselves, persistables, the loss. One reverse sweep,
    # snapshotting the running read-set only at the cut positions.
    keep_always = set(ckpt_names) | {loss.name} | {
        n for n in extra_live if n != EMPTY_VAR_NAME}
    reads_after_cut = {}
    running: set = set()
    cut_set = set(cuts)
    for i in range(len(ops) - 1, -1, -1):
        if i in cut_set:
            reads_after_cut[i] = set(running)
        running.update(n for n in ops[i].input_arg_names
                       if n != EMPTY_VAR_NAME)

    new_ops: List = []
    start = 0
    n_segments = 0
    for cut in cuts:
        seg = ops[start:cut + 1]
        rest_reads = reads_after_cut[cut]
        if len(seg) <= 1:
            # a 1-op segment saves nothing; leave it inline
            new_ops.extend(seg)
            start = cut + 1
            continue
        produced: List[str] = []
        for o in seg:
            for n in o.output_arg_names:
                if n != EMPTY_VAR_NAME and n not in produced:
                    produced.append(n)
        reads: List[str] = []
        produced_set = set(produced)
        for o in seg:
            for n in o.input_arg_names:
                if (n != EMPTY_VAR_NAME and n not in produced_set
                        and n not in reads):
                    reads.append(n)
        outs = [n for n in produced
                if n in rest_reads or n in keep_always
                or (block.has_var(n) and block.var(n).persistable)]

        sub = program._create_block(parent_idx=block.idx)
        program._rollback()
        for o in seg:
            o.block = sub
        sub.ops = seg
        # demote internals to sub-block locals so block-level analyses and
        # the executor's liveness never see them at the parent level
        for n in produced:
            if n not in outs and block.has_var(n):
                sub.vars[n] = block.vars.pop(n)

        from ..framework import Operator

        seg_op = Operator(block, "recompute_segment",
                          inputs={"Input": reads}, outputs={"Out": outs},
                          attrs={"sub_block": sub.idx})
        block._stamp(seg_op)  # stable __uid__ + op-role
        new_ops.append(seg_op)
        n_segments += 1
        start = cut + 1
    new_ops.extend(ops[start:])
    block.ops = new_ops
    program._bump_version()
    return n_segments
