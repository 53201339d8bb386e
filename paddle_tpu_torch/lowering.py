"""Block interpretation over torch tensors.

Counterpart of ``paddle_tpu/lowering.py``. The JAX package traces a whole
block once into one XLA computation; the port interprets it eagerly, op by
op: each op's registered rule runs on torch tensors and its outputs shadow
earlier writes in the environment (in-order scope semantics).

* ``AmpPolicy`` — mixed precision as a lowering policy read from the
  owning program (``program._amp_policy``): a white-list op's float32
  inputs are cast to the compute dtype where the op runs, a black-list
  op's compute-dtype inputs back to float32. Parameters and optimizer
  state never leave float32.
* ``LowerCtx`` — per-op context: the device, the owning program and the
  op's own ``torch.Generator``, keyed on (step seed, op ``__uid__``).
* ``lower_op`` / ``lower_block`` — the interpreter. A raw op (control
  flow) gets the op and the environment and runs its sub-block itself.
* the generic ``<type>_grad`` — the default gradient of every op: the
  forward rule runs again on the forward inputs under
  ``torch.enable_grad()`` and ``torch.autograd.grad`` pulls the output
  cotangents back, as the reference runs ``jax.vjp`` over the rule. The
  AMP casts happen inside that region, so the gradients of float32
  primals come back float32. The autograd graph lives only inside the
  grad op that built it.
* ``auto_infer_shape`` — build-time shapes: the op's rule runs on
  ``device="meta"`` tensors (no data, no compute), with two sentinel sizes
  for -1 dims, as the reference runs its rule under ``jax.eval_shape``.

* the taps — ``LowerCtx.nan_checks`` (``FLAGS_check_nan_inf``): after
  each op, one device-side finite check per float output (its min and max,
  one launch), labelled with the op and its build site; ``LowerCtx.num_taps``
  (``FLAGS_numerics_witness``): one ``[absmax, min, max, nonfinite-count]``
  vector per float output. The executor stacks each list once at step end
  and reads it with one host transfer. Sub-block replays (raw ops and
  their grads) and the generic grad's rerun append nothing: the owning
  op's outputs are checked at the outer level.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core import registry
from .core.selected_rows import is_selected_rows
from .core.types import canonical_dtype, torch_dtype

EMPTY_VAR_NAME = "@EMPTY@"

_META = torch.device("meta")


class AmpPolicy:
    """Mixed-precision compute policy applied where each op runs
    (counterpart of the reference's ``AmpPolicy``). No program rewrite:
    a white-list op's float32 inputs are cast to ``compute_dtype``
    (bfloat16: tensor cores), a black-list op's ``compute_dtype`` inputs
    back to float32, every other op takes its inputs as they arrive."""

    def __init__(self, white_list, black_list, compute_dtype="bfloat16"):
        self.white = frozenset(white_list)
        self.black = frozenset(black_list)
        self.compute_dtype = canonical_dtype(compute_dtype)
        self._compute = torch_dtype(self.compute_dtype)

    def cast_ins(self, op_type: str, ins: Dict[str, List[Any]]):
        if op_type in self.white:
            src, dst = torch.float32, self._compute
        elif op_type in self.black:
            src, dst = self._compute, torch.float32
        else:
            return ins

        def cast(v):
            if isinstance(v, torch.Tensor) and v.dtype == src:
                return v.to(dst)
            return v
        return {slot: [cast(v) for v in vals] for slot, vals in ins.items()}


def amp_policy_of(ctx) -> Optional[AmpPolicy]:
    """The AMP policy of the program ``ctx`` runs, or None."""
    return ctx.program._amp_policy if ctx.program is not None else None


class LowerCtx:
    """Context passed to every op rule. ``program`` is the owning program
    (its AMP policy, a raw op's sub-blocks). ``gemm_blocks`` is the block
    triple a caller asks ``fused_gemm_epilogue`` to run with (the executor
    passes the run's triple, ``FLAGS_autotune``'s best-known included, and
    the fusion pass's witness the triple it was given); None means
    ``FLAGS_fused_gemm_blocks`` or the kernel's default."""

    def __init__(self, device=None, seed: Optional[int] = None,
                 uid: int = 0, gemm_blocks=None, program=None,
                 nan_checks=None, num_taps=None):
        self.device = torch.device(device) if device is not None else _META
        self.seed = seed
        self.uid = uid
        self.gemm_blocks = gemm_blocks
        self.program = program
        # FLAGS_check_nan_inf: list collecting (label, finite-bool tensor)
        # per float op output; the executor stacks the flags at step end
        # and raises or skips with the label of the first false one
        self.nan_checks = nan_checks
        # FLAGS_numerics_witness: list collecting (var name, stats vector
        # [absmax, min, max, nonfinite-count]) per float op output, stacked
        # into one (N, 4) tensor per step (monitor.numwitness)
        self.num_taps = num_taps
        # the data-parallel step's context (parallel.compiled_program.
        # DPContext): set only inside a parallel step over several ranks
        self.dp = None

    def with_uid(self, uid: int) -> "LowerCtx":
        ctx = LowerCtx(self.device, self.seed, uid, self.gemm_blocks,
                       self.program, self.nan_checks, self.num_taps)
        ctx.dp = self.dp
        return ctx

    def generator(self, device=None) -> Optional[torch.Generator]:
        """A generator unique to this op instance and step, on ``device``
        (default: the op's); None during shape inference (nothing runs on
        meta tensors)."""
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=device if device is not None
                            else self.device)
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
    """Run one op's rule against the environment, in place, then append
    its taps (``ctx.nan_checks`` / ``ctx.num_taps``) when they are on."""
    try:
        _lower_op_inner(op, env, ctx)
    except OpLoweringError:
        raise
    except Exception as e:
        raise OpLoweringError(
            f"while running op '{op.type}'{_op_site(op)}: "
            f"{type(e).__name__}: {e}") from e
    if ctx.nan_checks is not None:
        for name in op.output_arg_names:
            v = env.get(name)
            if _is_float(v):
                # one launch: min and max propagate NaN and reach +-inf,
                # so the pair is finite iff every element is
                # (``read_finite`` turns the pairs into flags)
                ctx.nan_checks.append(
                    (f"op '{op.type}' output '{name}'{_op_site(op)}",
                     torch.aminmax(v.detach()) if v.numel() else None))
    if ctx.num_taps is not None:
        for name in op.output_arg_names:
            v = env.get(name)
            if _is_float(v) and v.numel():
                # nonfinite lanes masked out of the range stats
                vf = v.detach().reshape(-1).float()
                finite = torch.isfinite(vf)
                ctx.num_taps.append((name, torch.stack([
                    torch.where(finite, vf.abs(), 0.0).max(),
                    torch.where(finite, vf, float("inf")).min(),
                    torch.where(finite, vf, float("-inf")).max(),
                    (~finite).sum().float()])))


def read_finite(checks) -> np.ndarray:
    """The finite flag of each ``(label, (min, max))`` nan check, stacked
    on the device and read with one host transfer (an empty output's
    check holds None and is finite)."""
    ok = np.ones(len(checks), dtype=bool)
    idx = [i for i, (_, mm) in enumerate(checks) if mm is not None]
    if idx:
        pairs = torch.stack([t for i in idx for t in checks[i][1]])
        ok[idx] = torch.isfinite(pairs.reshape(-1, 2)).all(dim=1).cpu() \
            .numpy()
    return ok


class _Structure:
    """The slots of one op call through ``_RuleWithGrad``: the input
    slots with their counts (to rebuild ``ins`` from the flat tensors) and,
    once the forward ran, the output slots of each flat output."""

    __slots__ = ("opdef", "ctx", "attrs", "in_slots", "out_slots",
                 "out_vals")

    def __init__(self, opdef, ctx, attrs, in_slots):
        self.opdef, self.ctx, self.attrs = opdef, ctx, attrs
        self.in_slots = in_slots
        self.out_slots: List[tuple] = []
        self.out_vals: Dict[str, list] = {}


def _unflatten(slots, flat) -> Dict[str, List[Any]]:
    ins, i = {}, 0
    for slot, n in slots:
        ins[slot] = list(flat[i:i + n])
        i += n
    return ins


class _RuleWithGrad(torch.autograd.Function):
    """An op whose rule has a gradient rule of its own (``grad_lower``):
    the forward rule runs once, and the backward calls the grad rule
    with the grad op's slots (the forward inputs, ``__out__<slot>`` and
    ``<slot>@GRAD``), as the static path's grad op would."""

    @staticmethod
    def forward(ctx, st: _Structure, *flat):
        outs = st.opdef.lower(st.ctx, _unflatten(st.in_slots, flat),
                              st.attrs) or {}
        flat_out = []
        for slot, vals in outs.items():
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            st.out_vals[slot] = list(vals)
            for i, v in enumerate(vals):
                if isinstance(v, torch.Tensor):
                    st.out_slots.append((slot, i))
                    flat_out.append(v)
        ctx.st = st
        ctx.n_in = len(flat)
        # the outputs are saved, not kept on ``st``: an output holding its
        # grad_fn's ctx would be a reference cycle, freed only by the
        # cyclic collector (remat's replays leaked a step's activations)
        ctx.save_for_backward(*flat, *flat_out)
        ctx.mark_non_differentiable(
            *(v for v in flat_out if not v.is_floating_point()))
        return tuple(flat_out)

    @staticmethod
    def backward(ctx, *cts):
        st = ctx.st
        saved = ctx.saved_tensors
        ins = _unflatten(st.in_slots, saved[:ctx.n_in])
        out_vals = {slot: list(vals) for slot, vals in st.out_vals.items()}
        for (slot, i), t in zip(st.out_slots, saved[ctx.n_in:]):
            out_vals[slot][i] = t
        gins = dict(ins)
        for slot, vals in out_vals.items():
            gins["__out__" + slot] = vals
            gins[slot + "@GRAD"] = [None] * len(vals)
        for (slot, i), ct in zip(st.out_slots, cts):
            gins[slot + "@GRAD"][i] = ct
        res = st.opdef.grad_lower(st.ctx, gins, st.attrs) or {}
        grads = []
        for slot, n in st.in_slots:
            got = res.get(slot + "@GRAD") or []
            for i in range(n):
                g = got[i] if i < len(got) else None
                if is_selected_rows(g):
                    g = g.to_dense()
                grads.append(g)
        return (None, *grads)


def apply_rule_with_grad(opdef, ctx, ins, attrs) -> Dict[str, list]:
    """Run ``opdef``'s rule on ``ins`` so that autograd differentiates it
    through its own grad rule (``grad_lower``), as the static path's grad
    op would: the outputs by slot."""
    st = _Structure(opdef, ctx, attrs, [(s, len(v)) for s, v in ins.items()])
    flat = _RuleWithGrad.apply(st, *(v for vals in ins.values()
                                     for v in vals))
    outs = {s: list(v) for s, v in st.out_vals.items()}
    for (slot, i), t in zip(st.out_slots, flat):
        outs[slot][i] = t
        st.out_vals[slot][i] = None      # the backward reads the saved one
    return outs


# set while a recompute segment replays its sub-block for its gradient:
# an op with a grad rule of its own then runs through it under autograd,
# so the replay's gradients are the plain program's grad ops' bit for bit
_grad_rules = contextvars.ContextVar("paddle_tpu_torch_grad_rules",
                                     default=False)


@contextlib.contextmanager
def grad_rules():
    """Within: ``lower_op`` differentiates each op that has a grad rule
    (``grad_lower``) through that rule, not through autograd's own
    derivative of its forward rule."""
    token = _grad_rules.set(True)
    try:
        yield
    finally:
        _grad_rules.reset(token)


def _lower_op_inner(op, env: Dict[str, Any], ctx: LowerCtx) -> None:
    if registry.is_generic_grad(op.type):
        _lower_generic_grad(op, env, ctx)
        return
    opdef = registry.get_op_def(op.type)
    op_ctx = ctx.with_uid(op.attrs.get("__uid__", 0))
    if opdef.raw:
        # control flow interprets its sub-block over ``env`` itself; its
        # sub-block ops append no taps (the op's own outputs are checked
        # at this level)
        if op_ctx.program is None:
            op_ctx.program = op.block.program
        op_ctx.nan_checks = None
        op_ctx.num_taps = None
        opdef.lower(op_ctx, op, env)
        return
    ins = _gather_inputs(op, env)
    amp = amp_policy_of(ctx)
    if amp is not None:
        ins = amp.cast_ins(op.type, ins)
    if opdef.grad_lower is not None and _grad_rules.get() and any(
            isinstance(v, torch.Tensor) and v.requires_grad
            for vals in ins.values() for v in vals):
        outs = apply_rule_with_grad(opdef, op_ctx, ins, op.attrs)
    else:
        outs = opdef.lower(op_ctx, ins, op.attrs)
    _write_outputs(op, outs, env)


def lower_block(block, env: Dict[str, Any], ctx: LowerCtx) -> Dict[str, Any]:
    for op in block.ops:
        lower_op(op, env, ctx)
    return env


# ---------------------------------------------------------------------------
# Generic gradient (the default grad rule of every op)
# ---------------------------------------------------------------------------

def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _lower_generic_grad(op, env: Dict[str, Any], ctx: LowerCtx) -> None:
    """Run a ``<fwd>_grad`` op emitted by ``backward.py``.

    Grad-op layout: inputs ``<slot>`` (forward inputs), ``__out__<slot>``
    (forward outputs, kept for parity) and ``<slot>@GRAD`` (cotangents of
    the forward outputs, ``@EMPTY@`` where none reached them); outputs
    ``<slot>@GRAD`` (gradients of the forward inputs, ``@EMPTY@`` holes);
    attrs ``__fwd_type__``, ``__fwd_uid__`` and the forward attrs.
    """
    fwd_type = op.attrs["__fwd_type__"]
    fwd_def = registry.get_op_def(fwd_type)
    fwd_uid = op.attrs.get("__fwd_uid__", 0)
    fwd_ctx = ctx.with_uid(fwd_uid)
    if fwd_def.grad_lower is not None and fwd_def.raw:
        # a sub-block op's grad (recompute_segment) replays its sub-block
        # over the environment itself
        if fwd_ctx.program is None:
            fwd_ctx.program = op.block.program
        # the replayed sub-block appends no taps
        fwd_ctx.nan_checks = None
        fwd_ctx.num_taps = None
        fwd_def.grad_lower(fwd_ctx, op, env)
        return
    if fwd_def.grad_lower is not None:
        # no AMP cast: a rule of its own owns its precision (casting the
        # gathered inputs would cast the cotangents too and hand back
        # bf16 parameter gradients)
        _write_outputs(op, fwd_def.grad_lower(
            fwd_ctx, _gather_inputs(op, env), op.attrs), env)
        return

    fwd_attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
    fwd_attrs["__uid__"] = fwd_uid
    fwd_in_slots = [s.name for s in fwd_def.inputs if s.name in op.inputs]
    fwd_ins = {slot: [env[n] if n != EMPTY_VAR_NAME else None
                      for n in op.inputs[slot]] for slot in fwd_in_slots}

    # (slot, i) of each input whose gradient is asked for and is a float
    diff_pos = []
    for slot in fwd_in_slots:
        for i, gname in enumerate(op.outputs.get(slot + "@GRAD", ())):
            if gname != EMPTY_VAR_NAME and i < len(fwd_ins[slot]) \
                    and _is_float(fwd_ins[slot][i]):
                diff_pos.append((slot, i))
    if not diff_pos:
        return

    primals = [fwd_ins[s][i].detach().requires_grad_() for s, i in diff_pos]
    amp = amp_policy_of(ctx)
    with torch.enable_grad():
        ins = {s: list(vs) for s, vs in fwd_ins.items()}
        for (s, i), p in zip(diff_pos, primals):
            ins[s][i] = p
        if amp is not None:
            # cast inside the differentiated region: the primals stay
            # float32, so their gradients come back float32
            ins = amp.cast_ins(fwd_type, ins)
        outs = fwd_def.lower(fwd_ctx, ins, fwd_attrs) or {}
        # float outputs that depend on a primal, each with its cotangent;
        # an output no cotangent reached contributes zero and is skipped
        ys, cts = [], []
        for ospec in fwd_def.outputs:
            vals = outs.get(ospec.name)
            if vals is None:
                continue
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            gnames = op.inputs.get(ospec.name + "@GRAD", [])
            for i, y in enumerate(vals):
                if not _is_float(y) or not y.requires_grad \
                        or i >= len(gnames) or gnames[i] == EMPTY_VAR_NAME:
                    continue
                g = env[gnames[i]]
                if g.dtype != y.dtype:
                    g = g.to(y.dtype)
                if g.shape != y.shape:
                    g = g.reshape(y.shape)   # [1]-shaped loss grad vs scalar
                ys.append(y)
                cts.append(g)
        grads = (torch.autograd.grad(ys, primals, cts, allow_unused=True)
                 if ys else [None] * len(primals))
    for (slot, i), p, g in zip(diff_pos, primals, grads):
        env[op.outputs[slot + "@GRAD"][i]] = torch.zeros_like(p) \
            if g is None else g


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
                if n == EMPTY_VAR_NAME:
                    vals.append(None)
                    continue
                # a sub-block op reads its ancestors' vars
                v = block._var_recursive(n) \
                    if block.has_var_recursive(n) else None
                if v is None or v.shape is None:
                    return None
                shape = tuple(sentinel if d == -1 else d for d in v.shape)
                vals.append(torch.empty(shape, dtype=torch_dtype(v.dtype),
                                        device=_META))
            ins[slot] = vals
        return ins

    dynamic = any(-1 in (block._var_recursive(n).shape or ())
                  for names in op.inputs.values() for n in names
                  if n != EMPTY_VAR_NAME and block.has_var_recursive(n))
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
