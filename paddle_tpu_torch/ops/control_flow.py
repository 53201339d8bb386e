"""Control-flow ops (counterpart of ``paddle_tpu/ops/control_flow.py``):
``conditional_block``, ``while``, ``recurrent`` (StaticRNN), the tensor
arrays and dense beam search.

The reference lowers these to ``lax.cond`` / ``lax.while_loop`` /
``lax.scan``; the port interprets eagerly, so control flow is a host loop
over the sub-block (``lower_block``):

* ``conditional_block`` reads its condition on the host (one device
  sync) and runs only the branch taken.
* ``while`` reads its condition once before the loop and once after each
  iteration (one host transfer each, which also carries the size of every
  tensor array in the carry); ``max_len`` bounds the trip count, as it
  bounds the reference's loop. A carried var whose shape or dtype the body
  changes is refused (``lax.while_loop`` refuses it too). The pre-loop
  carry and the trip count are stashed in the step's environment under
  ``__while_init_<uid>__`` (not a program var: the executor's release
  plan, the nan taps and the fetch path never see it); the grad op
  replays that many iterations from it under ``torch.enable_grad()`` and
  pulls the ``Out@GRAD`` cotangents back with ``torch.autograd.grad`` to
  the carried floats and the loop-invariant float reads, then frees the
  stash. Differentiating a While without ``max_len`` keeps the
  reference's refusal.
* ``recurrent`` loops over the time axis of its step inputs: memories are
  carried, step outputs stacked; its grad replays the steps under
  autograd. The forward op and its grad op share one sub-block.
* tensor arrays (:class:`TensorArray`): outside a loop a list with
  append-or-overwrite writes; carried through a ``while`` a buffer of
  fixed capacity (``max_len``, or ``_DEFAULT_CAPACITY``) with a device
  ``size``, so ``tensor_array_to_tensor`` and ``beam_search_decode`` see
  ``capacity`` rows (the decode masks the unwritten tail). A buffered
  write past the capacity raises a ``ValueError`` naming the array, the
  index and the capacity at the loop's next host read; the reference
  clamps it into the last row.
* ``beam_search`` picks the ``beam`` best of each source's ``beam * K``
  candidates, a higher score first and a lower index first on equal
  scores (``jax.lax.top_k``'s order), by ``topk`` over unique int64 keys
  (the score's order-preserving bits above the reversed index), so the
  card and the CPU break ties alike. ``beam_search_decode`` walks the
  parent chain backwards, ``T`` gathers of ``[batch * beam]``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.registry import IOSpec, register_op
from ..lowering import EMPTY_VAR_NAME, LowerCtx, lower_block
from .common import out, x

__all__ = ["TensorArray", "beam_candidates", "cond_reads",
           "reset_cond_reads", "top_k_lowest_index_first"]

_DEFAULT_CAPACITY = 128

# host transfers of a while's condition, counted from the last reset
_COND_READS = 0


def cond_reads() -> int:
    """Host reads of a ``while`` condition since :func:`reset_cond_reads`
    (a decode of ``max_len`` steps makes ``max_len + 1``)."""
    return _COND_READS


def reset_cond_reads() -> None:
    global _COND_READS
    _COND_READS = 0


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


# ---------------------------------------------------------------------------
# Tensor arrays (reference LoDTensorArray + tensor_array_read_write.cc)
# ---------------------------------------------------------------------------

class TensorArray:
    """Value of a LOD_TENSOR_ARRAY var in the environment; immutable (a
    write returns a new array).

    * list mode (outside loops): ``entries``, a Python list of tensors;
    * buffer mode (carried through a ``while``): ``buffer``, a
      ``[capacity, ...]`` tensor, and ``size``, an int64 ``[1]`` device
      tensor (one past the highest index written).
    """

    __slots__ = ("entries", "buffer", "size")

    def __init__(self, entries=None, buffer=None, size=None):
        self.entries: List[torch.Tensor] = \
            entries if entries is not None else []
        self.buffer = buffer
        self.size = size

    @property
    def buffered(self) -> bool:
        return self.buffer is not None

    @property
    def capacity(self) -> int:
        return int(self.buffer.shape[0])

    def to_buffer(self, capacity: int) -> "TensorArray":
        if self.buffered:
            return self
        if not self.entries:
            raise ValueError(
                "tensor array entering a While loop has no entries yet — "
                "write the initial element (e.g. array_write at step 0) "
                "before the loop so its element shape is known")
        n = len(self.entries)
        if n > capacity:
            raise ValueError(
                f"tensor array of {n} entries enters a While loop of "
                f"capacity {capacity}")
        elem = self.entries[0]
        buf = torch.zeros((capacity,) + tuple(elem.shape), dtype=elem.dtype,
                          device=elem.device)
        buf[:n] = torch.stack(self.entries)
        return TensorArray(buffer=buf, size=torch.full(
            (1,), n, dtype=torch.int64, device=elem.device))

    def write(self, i: torch.Tensor, value: torch.Tensor) -> "TensorArray":
        if not self.buffered:
            # outside a loop the index is read on the host: overwrite an
            # entry in range, append past the end (the reference resizes)
            entries = list(self.entries)
            k = int(i.reshape(-1)[0])
            if 0 <= k < len(entries):
                entries[k] = value
            else:
                entries.append(value)
            return TensorArray(entries=entries)
        if tuple(value.shape) != tuple(self.buffer.shape[1:]):
            raise ValueError(
                f"tensor array write of shape {tuple(value.shape)} into "
                f"elements of shape {tuple(self.buffer.shape[1:])}")
        i = i.reshape(-1)[:1].long()
        # clamped here, refused at the loop's next host read
        pos = i.clamp(0, self.capacity - 1)
        buf = self.buffer.index_copy(0, pos, value.unsqueeze(0).to(
            self.buffer.dtype))
        return TensorArray(buffer=buf, size=torch.maximum(self.size, i + 1))

    def read(self, i: torch.Tensor) -> torch.Tensor:
        """The entry at ``i``, clamped into range (XLA's dynamic index),
        with no host read."""
        rows = self.stack()
        pos = i.reshape(-1)[:1].long().clamp(0, rows.shape[0] - 1)
        return rows.index_select(0, pos).squeeze(0)

    def length(self, device) -> torch.Tensor:
        if self.buffered:
            return self.size
        return torch.tensor([len(self.entries)], dtype=torch.int64,
                            device=device)

    def stack(self) -> torch.Tensor:
        """Dense ``[T, ...]`` view (T = capacity in buffer mode)."""
        if self.buffered:
            return self.buffer
        return torch.stack(self.entries)


def _no_infer(op, block):
    """Outputs keep the shapes and types they were created with."""


@register_op("create_array", outputs=["Out"], attrs={"dtype": "float32"},
             grad=None, infer_shape=_no_infer)
def _create_array(ctx, ins, attrs):
    return out(TensorArray())


@register_op("write_to_array", inputs=["X", IOSpec("I", no_grad=True),
                                       IOSpec("Array", optional=True)],
             outputs=["Out"], grad=None, infer_shape=_no_infer)
def _write_to_array(ctx, ins, attrs):
    arr = x(ins, "Array")
    arr = TensorArray() if arr is None else arr
    return out(arr.write(x(ins, "I"), x(ins, "X")))


@register_op("read_from_array", inputs=["X", IOSpec("I", no_grad=True)],
             outputs=["Out"], grad=None, infer_shape=_no_infer)
def _read_from_array(ctx, ins, attrs):
    return out(x(ins, "X").read(x(ins, "I")))


@register_op("lod_array_length", inputs=["X"], outputs=["Out"], grad=None,
             infer_shape=_no_infer)
def _lod_array_length(ctx, ins, attrs):
    return out(x(ins, "X").length(ctx.device))


@register_op("tensor_array_to_tensor", inputs=["X"], outputs=["Out"],
             attrs={"axis": 0}, grad=None, infer_shape=_no_infer)
def _tensor_array_to_tensor(ctx, ins, attrs):
    return out(torch.movedim(x(ins, "X").stack(), 0, attrs.get("axis", 0)))


# ---------------------------------------------------------------------------
# conditional_block
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

def _while_init_key(uid) -> str:
    return f"__while_init_{uid}__"


def _signature(v):
    if isinstance(v, TensorArray):
        return "tensor array", tuple(v.buffer.shape), v.buffer.dtype
    return "tensor", tuple(v.shape), v.dtype


def _while_carry(op, env, capacity):
    """The carried names (the condition first, then every outer var the
    body writes) and their pre-loop values, arrays as buffers."""
    cond_name = op.input("Condition")[0]
    out_names = list(dict.fromkeys(op.output("Out")))
    carry_names = [cond_name] + [n for n in out_names if n != cond_name]
    init = []
    for n in carry_names:
        if n not in env:
            raise KeyError(f"while: carried var '{n}' has no value before "
                           f"the loop")
        v = env[n]
        init.append(v.to_buffer(capacity) if isinstance(v, TensorArray)
                    else v)
    return carry_names, init


def _while_step(sub, carry_names, carry, env, ctx, capacity):
    """One iteration: the sub-block over the outer env (loop-invariant
    reads) with the carry on top; the new carry, each var's shape and
    dtype held to the previous iteration's."""
    benv = dict(env)
    benv.update(zip(carry_names, carry))
    lower_block(sub, benv, ctx)
    new = []
    for n, old in zip(carry_names, carry):
        v = benv[n]
        if isinstance(v, TensorArray):
            v = v.to_buffer(capacity)
        if _signature(v) != _signature(old):
            kind, shape, dtype = _signature(old)
            _, nshape, ndtype = _signature(v)
            raise ValueError(
                f"while: the body changes carried var '{n}' from {kind} "
                f"shape {shape} dtype {dtype} to shape {nshape} dtype "
                f"{ndtype}; a loop carry keeps its shape and dtype, as the "
                f"reference's lax.while_loop requires")
        new.append(v)
    return new


def _sync(carry_names, carry, with_cond=True) -> bool:
    """One host transfer: the condition (when asked) and the size of each
    carried tensor array, refused past its capacity."""
    arrays = [(n, v) for n, v in zip(carry_names, carry)
              if isinstance(v, TensorArray)]
    vals = [v.size for _, v in arrays]
    if with_cond:
        global _COND_READS
        _COND_READS += 1
        vals.insert(0, carry[0].reshape(-1)[:1].to(torch.int64))
    if not vals:
        return False
    host = torch.cat(vals).tolist()
    for (n, v), size in zip(arrays, host[1:] if with_cond else host):
        if size > v.capacity:
            raise ValueError(
                f"tensor array '{n}': write at index {size - 1} past its "
                f"capacity {v.capacity} (the While's max_len, or "
                f"{_DEFAULT_CAPACITY} without one)")
    return bool(host[0]) if with_cond else False


def _while_lower(ctx, op, env):
    sub = ctx.program.blocks[op.attrs["sub_block"]]
    max_len = int(op.attrs.get("max_len") or 0)
    capacity = max_len or _DEFAULT_CAPACITY
    carry_names, init = _while_carry(op, env, capacity)
    carry, trips = list(init), 0
    running = _sync(carry_names, carry)
    while running:
        carry = _while_step(sub, carry_names, carry, env, ctx, capacity)
        trips += 1
        if max_len and trips >= max_len:
            # the bound stops the loop (as it bounds the reference's);
            # the arrays written in the last trip are still checked
            _sync(carry_names, carry, with_cond=False)
            break
        running = _sync(carry_names, carry)
    env.update(zip(carry_names, carry))
    # the while writes its outputs in place, so the inits are gone from
    # env: the grad op replays from this stash
    env[_while_init_key(op.attrs.get("__uid__", 0))] = \
        (carry_names, init, trips)


def _while_grad_lower(ctx, op, env):
    """Replay the forward's trip count from the stashed pre-loop carry
    under autograd and pull the ``Out@GRAD`` cotangents back to the
    carried floats and the loop-invariant float reads (reference
    while_op.cc WhileGradOp over its saved StepScopes)."""
    attrs = op.attrs
    max_len = int(attrs.get("max_len") or 0)
    if max_len <= 0:
        raise ValueError(
            "differentiating a While requires a static iteration bound: "
            "construct it as layers.While(cond, max_len=N) (XLA reverse-mode"
            " needs a fixed trip count to unroll the backward scan over)")
    sub = ctx.program.blocks[attrs["sub_block"]]
    stash = env.pop(_while_init_key(attrs.get("__fwd_uid__", 0)), None)
    if stash is None:
        raise RuntimeError("while_grad run without its forward op in the "
                           "same step")
    carry_names, init, trips = stash
    x_names = op.input("X")
    reads = [n for n in x_names if n not in carry_names and _is_float(
        env.get(n))]
    diff_pos = [i for i, v in enumerate(init) if _is_float(v)]
    prim_carry = [init[i].detach().requires_grad_() for i in diff_pos]
    prim_reads = [env[n].detach().requires_grad_() for n in reads]
    grad_of = {}
    for n, g in zip(op.input("__out__Out"), op.input("Out@GRAD")):
        if g != EMPTY_VAR_NAME:
            grad_of.setdefault(n, g)
    with torch.enable_grad():
        base = dict(env)
        base.update(zip(reads, prim_reads))
        carry = list(init)
        for i, p in zip(diff_pos, prim_carry):
            carry[i] = p
        for _ in range(trips):
            carry = _while_step(sub, carry_names, carry, base, ctx, max_len)
        ys, cts = [], []
        for i in diff_pos:
            y, g = carry[i], env.get(grad_of.get(carry_names[i], ""))
            if g is not None and y.requires_grad:
                ys.append(y)
                cts.append(g.to(y.dtype).reshape(y.shape))
        primals = prim_carry + prim_reads
        grads = (torch.autograd.grad(ys, primals, cts, allow_unused=True)
                 if ys else [None] * len(primals))
    by_name = dict(zip(reads, zip(prim_reads, grads[len(prim_carry):])))
    by_name.update((carry_names[i], pg) for i, pg in
                   zip(diff_pos, zip(prim_carry, grads)))
    for n, gname in zip(x_names, op.output("X@GRAD")):
        if gname != EMPTY_VAR_NAME and n in by_name:
            p, g = by_name[n]
            env[gname] = torch.zeros_like(p) if g is None else g


register_op("while",
            inputs=[IOSpec("X", duplicable=True), IOSpec("Condition")],
            outputs=[IOSpec("Out", duplicable=True),
                     IOSpec("StepScopes", optional=True)],
            attrs={"sub_block": None, "max_len": 0, "is_test": False},
            grad="auto", grad_lower=_while_grad_lower, raw=True,
            infer_shape=_no_infer)(_while_lower)


# ---------------------------------------------------------------------------
# recurrent (StaticRNN)
# ---------------------------------------------------------------------------

def _recurrent_run(ctx, attrs, xs, init, params, param_names, env):
    """The steps of a ``recurrent`` op over the time axis of ``xs``:
    (stacked step outputs, final memories)."""
    sub = ctx.program.blocks[attrs["sub_block"]]
    step_in, pre = attrs["step_input_names"], attrs["pre_memory_names"]
    new, outs = attrs["new_memory_names"], attrs["step_output_names"]
    base = dict(env)
    base.update(zip(param_names, params))
    carry = list(init)
    ys: List[List[torch.Tensor]] = [[] for _ in outs]
    for t in range(xs[0].shape[0]):
        benv = dict(base)
        benv.update(zip(pre, carry))
        benv.update(zip(step_in, (v[t] for v in xs)))
        lower_block(sub, benv, ctx)
        carry = [benv[n] for n in new]
        for lst, n in zip(ys, outs):
            lst.append(benv[n])
    return [torch.stack(lst) for lst in ys], carry


def _recurrent_lower(ctx, op, env):
    stacked, final = _recurrent_run(
        ctx, op.attrs, [env[n] for n in op.input("Inputs")],
        [env[n] for n in op.input("InitStates")],
        [env[n] for n in op.input("Params")], op.input("Params"), env)
    for n, v in zip(op.output("Outputs"), stacked):
        env[n] = v
    for n, v in zip(op.output("FinalStates"), final):
        env[n] = v


_RECURRENT_SLOTS = ("Inputs", "InitStates", "Params")


def _recurrent_grad_lower(ctx, op, env):
    """Replay the steps under autograd from the op's inputs (the grad op
    carries the forward's slots and attrs, so it reads as its forward)
    and pull the step outputs' and final memories' cotangents back
    (reference recurrent_grad: the backward-in-time loop)."""
    vals = {s: [env[n] for n in op.input(s)] for s in _RECURRENT_SLOTS}
    prims = []
    for s in _RECURRENT_SLOTS:
        for i, v in enumerate(vals[s]):
            if _is_float(v):
                vals[s][i] = v.detach().requires_grad_()
                prims.append((s, i, vals[s][i]))
    n_out = len(op.attrs["step_output_names"])
    with torch.enable_grad():
        stacked, final = _recurrent_run(
            ctx, op.attrs, vals["Inputs"], vals["InitStates"],
            vals["Params"], op.input("Params"), env)
        ys, cts = [], []
        for k, y in enumerate(stacked + final):
            names = op.input("Outputs@GRAD") if k < n_out \
                else op.input("FinalStates@GRAD")
            j = k if k < n_out else k - n_out
            g = env.get(names[j]) if j < len(names) \
                and names[j] != EMPTY_VAR_NAME else None
            if g is not None and y.requires_grad:
                ys.append(y)
                cts.append(g.to(y.dtype).reshape(y.shape))
        primals = [p for _, _, p in prims]
        grads = (torch.autograd.grad(ys, primals, cts, allow_unused=True)
                 if ys else [None] * len(primals))
    for (s, i, p), g in zip(prims, grads):
        names = op.output(s + "@GRAD")
        if i < len(names) and names[i] != EMPTY_VAR_NAME:
            env[names[i]] = torch.zeros_like(p) if g is None else g


register_op("recurrent",
            inputs=[IOSpec("Inputs", duplicable=True, optional=True),
                    IOSpec("InitStates", duplicable=True, optional=True),
                    IOSpec("Params", duplicable=True, optional=True)],
            outputs=[IOSpec("Outputs", duplicable=True),
                     IOSpec("FinalStates", duplicable=True, optional=True)],
            attrs={"sub_block": None, "step_input_names": [],
                   "pre_memory_names": [], "new_memory_names": [],
                   "step_output_names": [], "is_test": False},
            grad="auto", grad_lower=_recurrent_grad_lower, raw=True,
            infer_shape=_no_infer)(_recurrent_lower)


# ---------------------------------------------------------------------------
# beam search (dense, fixed width; reference math/beam_search.cc is
# LoD-based)
# ---------------------------------------------------------------------------

_LOW32 = (1 << 32) - 1


def top_k_lowest_index_first(scores: torch.Tensor, k: int):
    """The ``k`` largest of each row, largest first and, among equal
    scores, the lower index first (``jax.lax.top_k``'s order): ``topk``
    over unique int64 keys, the float32 score's order-preserving bits
    above the reversed column index, so no two keys tie."""
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    col = torch.arange(scores.shape[-1], dtype=torch.int64,
                       device=scores.device)
    keys = ordered * (1 << 32) + (_LOW32 - col)
    top = torch.topk(keys, k, dim=-1).values
    pos = _LOW32 - (top & _LOW32)
    return torch.take_along_dim(scores, pos, dim=-1), pos


def beam_candidates(ins, attrs):
    """The candidates of one beam step: ``[batch, beam * K]`` scores and
    ids. ``scores`` is [batch*beam, K] candidate log-probs (accumulated
    if ``is_accumulated``), pre_ids/pre_scores [batch*beam, 1]; a finished
    beam (pre_id == end_id) offers one candidate, itself, at its score."""
    beam = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    pre_ids = x(ins, "pre_ids").reshape(-1)
    pre_scores = x(ins, "pre_scores").reshape(-1)
    scores, ids = x(ins, "scores"), x(ins, "ids")
    nbk, k = scores.shape
    dev = scores.device
    if ids is None:
        ids = torch.arange(k, dtype=torch.int64, device=dev).expand(nbk, k)
    if not attrs.get("is_accumulated", True):
        scores = pre_scores[:, None] + torch.log(torch.clamp(scores,
                                                             min=1e-20))
    finished = pre_ids == end_id
    neg_inf = torch.full((), -1e9, dtype=scores.dtype, device=dev)
    cand = torch.where(finished[:, None], neg_inf, scores)
    cand = torch.cat([torch.where(finished, pre_scores.to(cand.dtype),
                                  cand[:, 0])[:, None], cand[:, 1:]], dim=1)
    cand_ids = torch.where(finished[:, None], end_id, ids.long())
    batch = nbk // beam
    return cand.reshape(batch, beam * k), cand_ids.reshape(batch, beam * k)


@register_op("beam_search",
             inputs=[IOSpec("pre_ids"), IOSpec("pre_scores"),
                     IOSpec("ids", optional=True), IOSpec("scores")],
             outputs=["selected_ids", "selected_scores", "parent_idx"],
             attrs={"beam_size": 4, "end_id": 0, "level": 0,
                    "is_accumulated": True}, grad=None)
def _beam_search(ctx, ins, attrs):
    """One beam step over :func:`beam_candidates`: [batch*beam, 1] ids and
    scores and [batch*beam] global parent rows."""
    beam = int(attrs["beam_size"])
    cand, cand_ids = beam_candidates(ins, attrs)
    batch, k = cand.shape[0], cand.shape[1] // beam
    top_scores, top_pos = top_k_lowest_index_first(cand, beam)
    parent = (torch.arange(batch, dtype=torch.int64,
                           device=cand.device)[:, None] * beam
              + torch.div(top_pos, k, rounding_mode="floor"))
    sel_ids = torch.take_along_dim(cand_ids, top_pos, dim=1)
    return {"selected_ids": [sel_ids.reshape(-1, 1)],
            "selected_scores": [top_scores.reshape(-1, 1).to(cand.dtype)],
            "parent_idx": [parent.reshape(-1)]}


@register_op("beam_search_decode",
             inputs=[IOSpec("Ids"), IOSpec("Scores"),
                     IOSpec("ParentIdx", optional=True)],
             outputs=["SentenceIds", "SentenceScores"],
             attrs={"beam_size": 4, "end_id": 0}, grad=None,
             infer_shape=_no_infer)
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack the beam pointers. Ids/Scores/ParentIdx are tensor
    arrays written once a step: ids [B*beam, 1], parents [B*beam].
    Returns [T, B*beam] ids and scores read through the parent chain in
    chronological order; a buffered array's unwritten rows read as
    end_id (score 0) and pass pointers through unchanged."""
    ids_ta, sc_ta, par_ta = x(ins, "Ids"), x(ins, "Scores"), \
        x(ins, "ParentIdx")
    end_id = int(attrs.get("end_id", 0))
    ids = ids_ta.stack()
    T, nbk = ids.shape[0], ids.shape[1]
    ids = ids.reshape(T, nbk)
    scores = sc_ta.stack().reshape(T, nbk)
    parents = par_ta.stack().reshape(T, nbk).long()
    if ids_ta.buffered:
        valid = (torch.arange(T, device=ids.device)
                 < ids_ta.size)[:, None]
        rows = torch.arange(nbk, dtype=torch.int64, device=ids.device)
        parents = torch.where(valid, parents, rows)
        ids = torch.where(valid, ids, end_id)
        scores = torch.where(valid, scores, torch.zeros_like(scores))
    ptr = torch.arange(nbk, dtype=torch.int64, device=ids.device)
    out_ids: List[Optional[torch.Tensor]] = [None] * T
    out_sc: List[Optional[torch.Tensor]] = [None] * T
    for t in range(T - 1, -1, -1):
        out_ids[t] = ids[t][ptr]
        out_sc[t] = scores[t][ptr]
        ptr = parents[t][ptr].clamp(0, nbk - 1)
    return {"SentenceIds": [torch.stack(out_ids)],
            "SentenceScores": [torch.stack(out_sc)]}
