"""Scope + Executor: run programs eagerly on a torch device.

Counterpart of ``paddle_tpu/executor.py``. The ``exe.run(program,
feed=..., fetch_list=...)`` contract is the same; the execution model is
the reference's own per-op interpreter (``lowering.lower_block``) over
torch tensors, with no compile cache.

State: persistable vars live in a :class:`Scope` as tensors on the
executor's device. Ops that update state in place (the paged KV caches)
write into those very tensors, which stands in for the JAX package's
buffer donation; every other persistable an op writes (a parameter and
its Adam moments, written by ``adam`` under the same names) is stored
into the scope as soon as the op has written it, so the old value is
freed there. Feeds arrive as numpy and fetches leave as numpy; any var
the step computed can be fetched, ``@GRAD`` vars included. Ops run under
``torch.no_grad()``: only a generic grad op builds an autograd graph, and
frees it before the next op.

Values: a var holds a tensor, or a ``core.selected_rows.SelectedRows``
(the grad of an ``is_sparse`` table, which has no ``.dtype`` or
``.shape``). The nan check and the witness pass it over, as the
reference's walk does; a fetch returns what the reference's returns: a
0-d object array holding the SelectedRows (its rows and values as
numpy), or the SelectedRows of tensors with ``return_numpy=False``;
``run_chained`` stacks its rows and values along the steps, and gradient
merge adds it densely.

Release: the executor holds what ``Program.memory_plan`` says is live.
This stands in for XLA's buffer assignment in the JAX package and for
Fluid's eager deletion (``FLAGS_eager_delete_tensor_gb``). Once per
executor key each var's last reader is computed from
``analysis.liveness.block_liveness`` (a sub-block's reads count at the
owning op, a generic grad op's ``__out__<slot>`` reads count as reads),
and after each op every name dead there leaves the step's environment.
Fetched names and persistables are never released.

``FLAGS_auto_recompute``: ``run`` and ``run_chained`` swap a training
program for its auto-checkpointed rebuild (``analysis/remat.py``), cached
per (program fingerprint, batch, ``FLAGS_remat_budget_mb``, fetches); the
rebuild has its own serial, so its own executor key and compile event.

Places: ``Executor()`` with no place means ``CUDAPlace(0)`` and raises
where CUDA is absent; pass ``CPUPlace()`` to run on the CPU.

``FLAGS_epilogue_fusion``: ``run`` and ``run_chained`` swap a
forward-only program for its GEMM-epilogue-fused clone
(``analysis/epilogue_fusion.py``), witnessed on this executor's device;
the decision is cached per (program serial, version, op count, fetches,
block triple, ``FLAGS_use_fused_gemm``): a new block triple or route mode
re-runs the witness.

``FLAGS_autotune`` (``paddle_tpu_torch.tuning``): the block triple of a
run is ``FLAGS_fused_gemm_blocks`` when set; else, with
``FLAGS_autotune=use|measure`` and outside a ``measure_candidates``
trial, the cost database's best-known triple for (the SUBMITTED
program's content fingerprint, batch bucket, this executor's backend),
looked up once per executor (``_tuning_cache``); else None (the kernel's
default). The triple reaches the fusion witness and every step's
``LowerCtx.gemm_blocks``, and is part of the fusion key and the executor
key; it is never stamped on the shared ``Program``.

``FLAGS_check_program``: ``run`` and ``run_chained`` verify the program
they are about to run (after the remat and fusion swaps) once per
program fingerprint (``_verified``) through
``analysis.pass_manager.run_verify_pipeline``; error-severity findings
raise ``ProgramVerificationError``. At level 2 the transform passes run
inside the pass manager's strict bracket.

Instrumentation (the reference's, ``paddle_tpu/executor.py``):
``monitor.step_begin``/``step_end`` around every dispatch; the spans
``executor.run``, ``executor.step``, ``executor.run_chained`` and
``executor.compile``; ``monitor.record_cache_lookup``; the fault sites
``device_put`` (each feed copy, retried as transient), ``step`` (before
the program runs), ``compile`` (at a key's compile event, retried) and
``hang`` (inside the watchdog-armed section, ``FLAGS_step_timeout_s``).

What a compile is here: the port keeps no executable, so its compile
event is the first run of an executor key — the program fingerprint,
the feed signature, the fetch list, the scope serial and the flags the
port keys on (fusion, ``FLAGS_use_fused_gemm``, the AMP policy), plus
the step count on the chained path. ``monitor.observe_compile`` records
it, naming the changed component as the reference does; its
``trace_lower`` stage is the preparation the call paid (the fusion pass
and its witness), its ``xla_compile`` stage 0. The reference's
XLA-only key component (``FLAGS_xla_options``) has no counterpart.
``self._cache`` maps each key to a :class:`_Step` record, keyed as the
reference keys its compiled steps, so the serving engine's recompile
guard reads it the same way.

Gradient merge (``GradientMergeOptimizer``/``PipelineOptimizer`` set
``program._pipeline_microbatches`` = M > 1): the counterpart of the
reference's ``make_pipeline_step_fn``, a loop of the interpreter where the
reference scans. The forward- and backward-role ops run once per
microbatch on ``batch / M`` rows of every feed (a batch M does not divide
raises), each microbatch with its own step seed, so its own dropout
masks; the parameter gradients are added into zero-initialised buffers
in the parameter's dtype and averaged (or summed, ``_grad_merge_avg``
False); persistables those ops write are stored as they are written, so
the next microbatch reads them; a microbatch's activations leave with
its environment before the next one starts. The other ops (the update,
the clip, the schedule's counter) then run once. A fetched value those
ops produce comes from the last microbatch, anything else from after the
update. A program whose update reads a value only the microbatch ops
produce (an in-program learning-rate schedule) is refused at its first
run. ``run_chained`` refuses microbatched programs, as the reference does.

Data parallel (``parallel.CompiledProgram``): ``run`` of a compiled
program is this step under the path ``parallel``, its key extended with
the reduce strategy, the rank count and the program's rescale
generation; the key's compile event makes the collective plan
(``_Step.dp``), which runs each op with its collectives and folds the
rank into the step seed; the nan check gains one entry, the other
ranks' verdict, so the ranks trip together; the replica check runs after
the step.

``FLAGS_check_nan_inf`` (the reference's protocol, ``unpack_step_result``):
``run`` collects one finite check per float op output on the device
(``lowering.lower_op``), reads them once at step end, and on a trip
restores the scope and raises or drops the step per
``FLAGS_nan_inf_policy`` (``resilience.nonfinite``). The port stores each
persistable as soon as an op writes it and updates the KV caches in
place, so while the check is on the executor holds the pre-step value of
every persistable the step writes (a reference: ops return fresh
tensors) and a clone of each one an op writes in place
(``_IN_PLACE_OPS``). ``run_chained`` checks coarsely: the final state
after all its steps, restored to the pre-call image on a trip.
``FLAGS_numerics_witness`` stacks one ``[absmax, min, max, nonfinite]``
vector per float op output and merges it into ``monitor.numwitness``
before the check runs. Both flags are part of the executor key.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import monitor as _monitor
from . import trace as _trace
from .analysis.liveness import block_liveness
from .core.selected_rows import SelectedRows, is_selected_rows
from .core.types import torch_dtype
from .framework import Program, Variable, default_main_program
from .lowering import (EMPTY_VAR_NAME, LowerCtx, _op_site, lower_op,
                       read_finite)
from .resilience import distributed as _dist
from .resilience import faults as _faults
from .resilience import nonfinite as _nonfinite
from .resilience.retry import call_with_retry

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "CPUPlace",
           "CUDAPlace", "mark_staged"]


class Place:
    def __repr__(self):
        return type(self).__name__ + "()"


class CPUPlace(Place):
    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: CUDA is not available in this process; pass "
                f"CPUPlace() to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(f"{self!r}: only {torch.cuda.device_count()} "
                               f"CUDA device(s) visible")
        return torch.device("cuda", self.device_id)


class Scope:
    """name -> tensor store. The var map is lock-guarded: the serving
    dispatcher runs programs on its own thread while user code may read
    the scope."""

    # monotonic identity for executor keys (id() can alias after GC)
    _serial_counter = itertools.count()

    def __init__(self):
        self.vars: Dict[str, Any] = {}
        self._serial = next(Scope._serial_counter)
        self._lock = _monitor.make_rlock("Scope._lock")

    def find_var(self, name: str):
        with self._lock:
            return self.vars.get(name)

    def set_var(self, name: str, value) -> None:
        with self._lock:
            self.vars[name] = value

    def numpy(self, name: str) -> Optional[np.ndarray]:
        v = self.find_var(name)
        if v is None:
            return None
        return _to_host(v)


def _to_host(v) -> np.ndarray:
    """A value as numpy: a tensor's array; a SelectedRows as the
    reference's ``np.asarray`` gives it, a 0-d object array holding the
    SelectedRows, here with numpy rows and values."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if is_selected_rows(v):
        box = np.empty((), dtype=object)
        box[()] = SelectedRows(v.rows.detach().cpu().numpy(),
                               v.values.detach().cpu().numpy(), v.height)
        return box
    return np.asarray(v)


def _host_bytes(a: np.ndarray) -> int:
    """Bytes of a fetched array (a SelectedRows' rows and values)."""
    if a.dtype == object and is_selected_rows(a[()]):
        return int(a[()].rows.nbytes + a[()].values.nbytes)
    return int(a.nbytes)


_global_scope = Scope()


def _finite_check(v):
    """A nan check's payload (``lowering.read_finite``): the (min, max)
    pair of a float tensor, None (finite) for anything else."""
    if isinstance(v, torch.Tensor) and v.is_floating_point() and v.numel():
        return torch.aminmax(v.detach())
    return None


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Make ``scope`` the global scope inside the block."""
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old


def _fetch_name(f) -> str:
    return f.name if isinstance(f, Variable) else f


def _shape_dtype_sig(v):
    """(shape, dtype) of a feed without copying it."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return (tuple(v.shape), str(v.dtype))
    a = np.asarray(v)
    return (tuple(a.shape), str(a.dtype))


def _feed_host_bytes(v) -> int:
    """Bytes a feed moves host->device (0 for a tensor already there)."""
    if isinstance(v, np.ndarray):
        return int(v.nbytes)
    if isinstance(v, torch.Tensor):
        return 0 if v.device.type != "cpu" else v.nelement() * \
            v.element_size()
    try:
        return int(np.asarray(v).nbytes)
    except Exception:
        return 0


_STAGED = "_paddle_staged_feed"


def mark_staged(t: torch.Tensor) -> torch.Tensor:
    """Mark a tensor that ``reader.DataLoader`` staged for one feed:
    ``Executor.run`` takes it as it is, with no copy, when it lies on the
    executor's device in the feed var's dtype (the loader hands each
    batch out once). Any other tensor a caller passes is copied."""
    setattr(t, _STAGED, True)
    return t


def _staged_feed(v, device, dtype) -> bool:
    return (isinstance(v, torch.Tensor) and getattr(v, _STAGED, False)
            and v.device == device
            and (dtype is None or v.dtype == torch_dtype(dtype)))


def _stack(vals):
    """``run_chained``'s per-step fetches along a new leading axis; a
    SelectedRows stacks its rows and values, as a scan stacks the leaves
    of the reference's pytree."""
    if is_selected_rows(vals[0]):
        return SelectedRows(torch.stack([v.rows for v in vals]),
                            torch.stack([v.values for v in vals]),
                            vals[0].height)
    return torch.stack(vals)


def _tensor_bytes(vals) -> int:
    return sum(v.nelement() * v.element_size() for v in vals
               if isinstance(v, torch.Tensor))


def _feed_batch_rows(feed) -> int:
    """Leading feed dim (the batch the fusion witness and its PT755
    report resolve -1 dims to)."""
    batch = 1
    for v in (feed or {}).values():
        shape = tuple(getattr(v, "shape", None) or np.shape(v))
        if shape:
            batch = max(batch, int(shape[0]))
    return batch


def _release_plan(program: Program, feed_names, fetch_names):
    """Per op of the global block: (the names dead after it, the
    persistables it writes). A name is dead after its last read or write;
    fetched names and persistables never are."""
    blk = program.global_block
    live = block_liveness(blk, feed_names, fetch_names)
    keep = set(fetch_names)
    persistable = {n for n, v in blk.vars.items() if v.persistable}
    dead: List[List[str]] = [[] for _ in blk.ops]
    for n, vl in live.items():
        events = vl.defs + vl.uses
        if events and n not in keep and n not in persistable:
            dead[max(events)].append(n)
    stores = [tuple(n for n in op.output_arg_names if n in persistable)
              for op in blk.ops]
    return [tuple(sorted(d)) for d in dead], stores


class _MicroPlan:
    """How a gradient-merge program's ops split: the forward/backward ops
    run per microbatch (``fb``), the rest once (``tail``); ``refusal`` is
    the message of a program whose tail reads what only ``fb`` makes."""

    __slots__ = ("M", "avg", "fb", "tail", "grads", "params", "fb_written",
                 "fb_state", "refusal")

    def __init__(self, program: Program):
        from .framework import OpRole

        blk = program.global_block
        self.M = int(program._pipeline_microbatches)
        self.avg = bool(getattr(program, "_grad_merge_avg", True))
        pgs = list(getattr(program, "_pipeline_param_grads", []))
        self.params = [p for p, _ in pgs]
        self.grads = [g for _, g in pgs]
        in_fb = [op.attrs.get("__op_role__", OpRole.Forward)
                 in (OpRole.Forward, OpRole.Backward) for op in blk.ops]
        self.fb = [i for i, f in enumerate(in_fb) if f]
        self.tail = [i for i, f in enumerate(in_fb) if not f]
        self.fb_written = {n for i in self.fb
                           for n in blk.ops[i].output_arg_names}
        # persistables the microbatch ops write (batch-norm statistics):
        # carried from one microbatch to the next
        self.fb_state = [n for n in dict.fromkeys(
            n for i in self.fb for n in blk.ops[i].output_arg_names)
            if blk.has_var(n) and blk.var(n).persistable]
        self.refusal = None
        handed = set(self.grads) | set(self.fb_state)
        made = set()
        for i in self.tail:
            op = blk.ops[i]
            for n in op.input_arg_names:
                if n in self.fb_written and n not in handed \
                        and n not in made:
                    self.refusal = (
                        f"gradient merge: op '{op.type}'{_op_site(op)}, "
                        f"which runs once a step, reads '{n}', which only "
                        f"the forward/backward ops make, and they run once "
                        f"per microbatch: a forward-role op inside the "
                        f"microbatch loop, such as an in-program "
                        f"learning-rate schedule, cannot feed the update "
                        f"(pass the optimizer a float learning rate)")
                    return
            made.update(op.output_arg_names)


# op types that update a persistable input in place (the paged KV caches):
# the rollback image clones what they write
_IN_PLACE_OPS = frozenset({"fused_decode_attention", "kv_cache_append"})


class _Step:
    """One executor key (the counterpart of the reference's compiled
    step): the program it runs, its state split, its release plan, and
    the pending compile event, completed at the key's first run.
    ``state_names`` is every persistable the step writes, the state read
    and written first (in the order the ops read it), then the write-only
    state: the rollback image and ``run_chained``'s coarse check walk it
    in that order, as the reference walks its carried and write-only
    state."""

    __slots__ = ("program", "gemm_blocks", "donated_names", "dead_after",
                 "stores", "state_names", "in_place_names", "micro", "dp",
                 "prepared", "prep_s", "_compile_event", "_lock")

    def __init__(self, program: Program, prep_s: float, feed_names,
                 fetch_names, gemm_blocks=None):
        self.program = program
        # the block triple every LowerCtx of this key carries (part of
        # the key: see the module docstring)
        self.gemm_blocks = gemm_blocks
        self.dead_after, self.stores = _release_plan(
            program, feed_names, fetch_names)
        blk = program.global_block
        produced, state_in, state_out = set(), [], set()
        for op in blk.ops:
            for n in op.input_arg_names:
                if n not in produced and n != EMPTY_VAR_NAME:
                    state_in.append(n)
            for n in op.output_arg_names:
                produced.add(n)
                if blk.has_var(n) and blk.var(n).persistable:
                    state_out.add(n)
        # state read and written, updated in place or stored back (the
        # reference's donated buffers; the port copies no state, so the
        # record's kept_buffers, the reference's donation-unsafe state,
        # stays 0)
        self.donated_names = sorted({n for n in state_in
                                     if n in state_out})
        written = [n for op in blk.ops for n in op.output_arg_names
                   if n in state_out]
        carried = [n for n in dict.fromkeys(state_in) if n in state_out]
        self.state_names = tuple(dict.fromkeys(carried + written))
        self.in_place_names = frozenset(
            n for op in blk.ops if op.type in _IN_PLACE_OPS
            for n in op.output_arg_names if n in state_out)
        self.micro = (_MicroPlan(program) if int(getattr(
            program, "_pipeline_microbatches", 1)) > 1 else None)
        # a data-parallel key's collective plan (parallel.compiled_program.
        # _DPPlan), None on one card
        self.dp = None
        self.prepared = False
        self.prep_s = prep_s
        self._compile_event = None
        # serializes the first run's compile event per key (a retry
        # backoff there must not hold the executor lock)
        self._lock = _monitor.make_lock("_CompiledStep._aot_lock")


class Executor:
    """Runs programs op by op on one device."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._lock = _monitor.make_rlock("Executor._lock")
        self._step_counter = 0
        # executor key -> _Step (see the module docstring)
        self._cache: Dict[tuple, _Step] = {}
        # FLAGS_epilogue_fusion: (fingerprint, fetches, blocks, route
        # mode) -> the program to run, and the FusionDecision that chose it
        self._fusion_cache: Dict[tuple, Program] = {}
        self._fusion_decisions: Dict[tuple, Any] = {}
        # FLAGS_auto_recompute: (fingerprint, batch, budget, fetches) ->
        # the program to run, and the RematDecision that chose it
        self._remat_cache: Dict[tuple, Program] = {}
        self._remat_decisions: Dict[tuple, Any] = {}
        # FLAGS_check_program: fingerprints of the programs verified
        self._verified: set = set()
        # FLAGS_autotune: (content fingerprint, bucket, mode) -> the
        # TunedConfig the cost database gave (None: nothing known)
        self._tuning_cache: Dict[tuple, Any] = {}
        # FLAGS_aot_cache_dir: (program serial and version, kind, feed
        # signature, fetches, flags) -> the prepared (program, blocks)
        self._aot_memo: Dict[tuple, tuple] = {}

    def close(self) -> None:
        """Drop every per-executor cache (keys, verified programs, remat
        and fusion decisions, autotuner lookups)."""
        with self._lock:
            self._cache.clear()
            self._verified.clear()
            self._remat_cache.clear()
            self._remat_decisions.clear()
            self._fusion_cache.clear()
            self._fusion_decisions.clear()
            self._tuning_cache.clear()
            self._aot_memo.clear()

    # -- helpers ---------------------------------------------------------
    def _next_seed(self, program: Program) -> int:
        with self._lock:
            self._step_counter += 1
            counter = self._step_counter
        base = program.random_seed or 0
        return (base * 1_000_003 + counter) & 0x7FFFFFFF

    def _to_tensor(self, value, dtype: Optional[str]) -> torch.Tensor:
        """A tensor of the declared dtype on this executor's device, never
        sharing memory with the caller's array."""
        if isinstance(value, torch.Tensor):
            t = value
        else:
            t = torch.from_numpy(np.array(value, copy=True))
        want = torch_dtype(dtype) if dtype is not None else t.dtype
        return t.to(device=self.device, dtype=want, copy=True)

    def _state(self, name: str, program: Program, scope: Scope):
        v = scope.find_var(name)
        blk = program.global_block
        if v is None:
            if blk.has_var(name) and blk.var(name).is_data:
                raise RuntimeError(
                    f"Input variable '{name}' is declared as data but was "
                    f"not passed in feed={{...}}")
            raise RuntimeError(
                f"Variable '{name}' is not initialized in scope — run the "
                f"startup program first")
        if is_selected_rows(v):
            if v.values.device != self.device:
                v = SelectedRows(torch.as_tensor(v.rows).to(self.device),
                                 torch.as_tensor(v.values).to(self.device),
                                 v.height)
                scope.set_var(name, v)
            return v
        if not (isinstance(v, torch.Tensor) and v.device == self.device):
            # planted host state (or state from another device) moves
            # here once; in-place updates then land in the scope's tensor
            dt = blk.var(name).dtype if blk.has_var(name) else None
            v = self._to_tensor(v, dt)
            scope.set_var(name, v)
        return v

    def _feed_tensors(self, program, feed) -> Dict[str, torch.Tensor]:
        """Each feed copied to the device: a transient site (``device_put``
        fault point, retried with backoff). A tensor the DataLoader staged
        on this device in the var's dtype (``mark_staged``) is used as it
        is: it was copied once already, and no one else holds it."""
        blk = program.global_block
        out = {}
        for n, v in feed.items():
            dt = blk.var(n).dtype if blk.has_var(n) else None
            if _staged_feed(v, self.device, dt):
                out[n] = v
                continue

            def _put(v=v, dt=dt):
                _faults.fault_point("device_put")
                return self._to_tensor(v, dt)
            out[n] = call_with_retry("device_put", _put)
        return out

    def _run_ops(self, step, indices, env, ctx, scope) -> None:
        """Run the global block's ops at ``indices`` over ``env``: state
        read from the scope on first use, persistables stored as written,
        dead names released. A data-parallel key's plan runs each op with
        its collectives."""
        program = step.program
        ops = program.global_block.ops
        dp = step.dp
        for i in indices:
            op = ops[i]
            for n in op.input_arg_names:
                if n not in env and n != EMPTY_VAR_NAME:
                    env[n] = self._state(n, program, scope)
            if dp is None:
                lower_op(op, env, ctx)
            else:
                dp.run_op(i, op, env, ctx)
            for n in step.stores[i]:
                if n in env:
                    scope.set_var(n, env[n])
            for n in step.dead_after[i]:
                env.pop(n, None)

    def _run_once(self, step, feed_tensors, fetch_names, scope,
                  checks=None, taps=None):
        program = step.program
        if step.micro is not None:
            return self._run_microbatched(step, feed_tensors, fetch_names,
                                          scope, checks, taps)
        env: Dict[str, Any] = dict(feed_tensors)
        seed = self._next_seed(program)
        if step.dp is not None:
            seed = step.dp.fold_seed(seed)
        ctx = LowerCtx(self.device, seed=seed,
                       gemm_blocks=step.gemm_blocks, program=program,
                       nan_checks=checks, num_taps=taps)
        if step.dp is not None:
            ctx.dp = step.dp.ctx
        with torch.no_grad():
            self._run_ops(step, range(len(program.global_block.ops)), env,
                          ctx, scope)
        fetches = self._fetch(step, env, fetch_names, scope)
        if step.dp is not None:
            fetches = step.dp.gathered(fetch_names, fetches)
        return fetches

    def _fetch(self, step, env, fetch_names, scope):
        fetches = []
        for n in fetch_names:
            if n not in env:
                env[n] = self._state(n, step.program, scope)
            if not isinstance(env[n], torch.Tensor) \
                    and not is_selected_rows(env[n]):
                raise TypeError(
                    f"fetch '{n}' is a {type(env[n]).__name__}, not a "
                    f"tensor; fetch layers.tensor_array_to_tensor of a "
                    f"tensor array")
            fetches.append(env[n])
        return fetches

    def _run_microbatched(self, step, feed_tensors, fetch_names, scope,
                          checks, taps):
        """One gradient-merge step (see the module docstring): the
        reference's ``make_pipeline_step_fn`` as a loop. The nan checks
        cover the accumulated gradients and the carried state under the
        reference's labels, then the tail ops."""
        plan, program = step.micro, step.program
        if plan.refusal is not None:
            raise ValueError(plan.refusal)
        M = plan.M
        for n, v in feed_tensors.items():
            if v.shape[0] % M:
                raise ValueError(
                    f"gradient merge: feed '{n}' batch {v.shape[0]} not "
                    f"divisible by num_microbatches={M}")
        acc: List[torch.Tensor] = []
        fetched: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for i in range(M):
                env: Dict[str, Any] = {
                    n: v[i * (v.shape[0] // M):(i + 1) * (v.shape[0] // M)]
                    for n, v in feed_tensors.items()}
                ctx = LowerCtx(self.device, seed=self._next_seed(program),
                               gemm_blocks=step.gemm_blocks,
                               program=program)
                self._run_ops(step, plan.fb, env, ctx, scope)
                if not acc:
                    acc = [torch.zeros_like(self._state(p, program, scope))
                           for p in plan.params]
                for a, g in zip(acc, plan.grads):
                    # a sparse table's grad is merged densely
                    a.add_(env[g].to_dense() if is_selected_rows(env[g])
                           else env[g])
                fetched.update((n, env[n]) for n in fetch_names
                               if n in plan.fb_written)
                del env, ctx
            env = {g: a.div_(M) if plan.avg else a
                   for g, a in zip(plan.grads, acc)}
            if checks is not None:
                for g, a in zip(plan.grads, acc):
                    checks.append((f"accumulated gradient '{g}' "
                                   f"(fwd/bwd microbatch scan)",
                                   _finite_check(a)))
                for n in plan.fb_state:
                    checks.append((f"carried state '{n}' (microbatch scan)",
                                   _finite_check(scope.find_var(n))))
            ctx = LowerCtx(self.device, seed=self._next_seed(program),
                           gemm_blocks=step.gemm_blocks, program=program,
                           nan_checks=checks, num_taps=taps)
            self._run_ops(step, plan.tail, env, ctx, scope)
        env.update(fetched)
        return self._fetch(step, env, fetch_names, scope)

    @staticmethod
    def _rollback_image(step, scope):
        """The pre-step value of every persistable the step writes: a
        reference (ops return fresh tensors), a clone where an op writes
        in place; None where the scope has no value yet."""
        image = []
        for n in step.state_names:
            v = scope.find_var(n)
            if n in step.in_place_names and isinstance(v, torch.Tensor):
                v = v.clone()
            image.append((n, v))
        return image

    @staticmethod
    def _restore(scope, image) -> None:
        with scope._lock:
            for n, v in image:
                if v is None:
                    scope.vars.pop(n, None)
                else:
                    scope.vars[n] = v

    @staticmethod
    def _record_witness(taps, path) -> None:
        """Merge one step's witness stats (one host transfer) into
        ``monitor.numwitness`` before the nan-check protocol runs, so a
        skip or escalation can name the first offending var."""
        if taps is None:
            return
        from .monitor import numwitness

        stats = (torch.stack([t for _, t in taps]).cpu().numpy() if taps
                 else np.zeros((0, 4), np.float32))
        numwitness.record_step([n for n, _ in taps], stats, path=path)

    def _check_step(self, checks, scope, rollback, path) -> None:
        """The reference's ``unpack_step_result`` protocol over the step's
        checks (one host transfer)."""
        ok = read_finite(checks)
        if ok.all():
            _nonfinite.record_clean(self)
            return
        self._trip(scope, rollback, path, checks[int(np.argmin(ok))][0],
                   "scope restored to pre-step values")

    def _check_chained(self, step, scope, rollback, steps) -> None:
        """``run_chained``'s coarse check (reference executor.py:1187):
        the final state after all ``steps`` iterations, each var's finite
        flag stacked on the device and read once."""
        vals = [(n, scope.find_var(n)) for n in step.state_names]
        vals = [(n, v) for n, v in vals if isinstance(v, torch.Tensor)
                and v.is_floating_point() and v.numel()]
        ok = (torch.stack([torch.isfinite(v).all() for _, v in vals])
              .cpu().numpy() if vals else np.ones(0, dtype=bool))
        if ok.all():
            _nonfinite.record_clean(self)
            return
        self._trip(scope, rollback, "chained",
                   f"final state '{vals[int(np.argmin(ok))][0]}' after "
                   f"{steps} scanned iteration(s)",
                   "run_chained coarse check, scope restored to pre-scan "
                   "values; use run for per-op provenance")

    def _trip(self, scope, rollback, path, label, note) -> None:
        """A tripped check: restore the pre-step image, then policy
        ``raise`` raises FloatingPointError naming the op, ``skip`` and
        ``zero_grad`` count the dropped step (the caller returns its
        fetches)."""
        self._restore(scope, rollback)
        if _nonfinite.policy() == "raise":
            raise FloatingPointError(
                f"FLAGS_check_nan_inf: non-finite value in {label} ({note})")
        # counted AFTER the restore so even skip->raise escalation leaves
        # the scope holding the pre-step values
        _nonfinite.record_skip(path, label, self)

    def _maybe_auto_remat(self, program, feed, fetch_names):
        """FLAGS_auto_recompute entry shared by run / run_chained: swap a
        training program for its auto-checkpointed rebuild
        (analysis/remat.py). Inference programs and anything the pass
        cannot faithfully rebuild pass through untouched. Decisions are
        cached per (program, batch, budget, fetch list): a transform built
        for one fetch list keeps only those fetches alive across
        segments."""
        from .flags import flag

        if not flag("auto_recompute") or not isinstance(program, Program):
            return program
        from .analysis.pass_manager import program_fingerprint

        budget = int(flag("remat_budget_mb"))
        key = (program_fingerprint(program), _feed_batch_rows(feed),
               budget, tuple(fetch_names or ()))
        # the whole decision under the executor lock: a racing second
        # thread must reuse the SAME transformed program
        with self._lock:
            cached = self._remat_cache.get(key)
            if cached is not None:
                return cached
            from .analysis.remat import is_trainable_program

            # startup/inference programs cannot remat by construction; pass
            # through (cached) with no monitor record
            if not is_trainable_program(program):
                self._remat_cache[key] = program
                return program
            from .analysis.pass_manager import run_transform_pipeline

            result = run_transform_pipeline(
                program, ("auto_remat",), feed_names=sorted(feed or {}),
                fetch_names=list(fetch_names or ()),
                batch_size=key[1], options={"budget_mb": budget})
            decision = result.values["auto_remat"]
            _monitor.record_remat(decision)
            self._remat_cache[key] = decision.program
            self._remat_decisions[key] = decision
            return decision.program

    def _maybe_epilogue_fusion(self, program, feed, fetch_names, blocks):
        """FLAGS_epilogue_fusion entry shared by run / run_chained: swap a
        forward-only program for its GEMM-epilogue-fused rewrite. Training
        programs, programs with no mul/matmul, and anything the pass's
        fidelity witness cannot prove pass through untouched. ``blocks``
        is the run's block triple (``_gemm_blocks``): the witness runs the
        chains at it, and it is part of the decision's key. The fused
        clone has its own ``_serial``."""
        from .flags import flag

        if not flag("epilogue_fusion") or not isinstance(program, Program):
            return program
        from .analysis.epilogue_fusion import has_fusable_ops
        from .analysis.pass_manager import (program_fingerprint,
                                            run_transform_pipeline)

        key = (program_fingerprint(program), tuple(fetch_names), blocks,
               flag("use_fused_gemm"))
        with self._lock:
            cached = self._fusion_cache.get(key)
        if cached is not None:
            return cached
        if not has_fusable_ops(program):
            with self._lock:
                self._fusion_cache.setdefault(key, program)
            return program
        # the witness runs the chains on the device: outside the lock
        # (the serving dispatcher contends on it), first insert wins so
        # racing threads converge on ONE fused clone
        result = run_transform_pipeline(
            program, ("epilogue_fusion",), feed_names=sorted(feed or {}),
            fetch_names=list(fetch_names),
            batch_size=_feed_batch_rows(feed),
            options={"gemm_blocks": blocks, "device": self.device})
        decision = result.values["epilogue_fusion"]
        with self._lock:
            winner = self._fusion_cache.get(key)
            if winner is None:
                winner = self._fusion_cache[key] = decision.program
                self._fusion_decisions[key] = decision
                record = True
            else:
                record = False
        if record:
            _monitor.record_fusion(decision)
        return winner

    def _gemm_blocks(self, program, feed):
        """The run's K5 block triple, or None for the kernel's default:
        an explicit ``FLAGS_fused_gemm_blocks`` wins; else, with
        ``FLAGS_autotune=use|measure`` and outside a tuning trial, the
        cost database's best-known triple for the SUBMITTED ``program``
        (trials are recorded under its content fingerprint, before the
        remat and fusion clones, whose fingerprints differ)."""
        from .flags import flag

        if str(flag("fused_gemm_blocks")).strip():
            from .ops.fused_gemm import resolve_gemm_blocks

            return resolve_gemm_blocks()
        from . import tuning

        mode = tuning.autotune_mode()
        # never fill the triple DURING a measure_candidates trial: the
        # candidate under test must run exactly as specified, or its time
        # is recorded against the wrong config
        if mode == "off" or tuning.in_trial() \
                or not isinstance(program, Program):
            return None
        batch = _feed_batch_rows(feed)
        tkey = (tuning.program_content_fingerprint(program),
                tuning.shape_bucket(batch), mode)
        with self._lock:
            probed = tkey in self._tuning_cache
            cfg = self._tuning_cache.get(tkey)
        if not probed:
            cfg = tuning.lookup_best(program, batch, self.device)
            with self._lock:
                self._tuning_cache[tkey] = cfg
        return cfg.gemm_blocks if cfg is not None else None

    def _verify_once(self, program, fetch_names) -> None:
        """FLAGS_check_program pre-run hook: verify each program version
        once before it runs (``run_verify_pipeline``, so per-pass timings
        land on the monitor registry). Raises ProgramVerificationError
        with build-site diagnostics on error-severity findings."""
        from .flags import flag

        if not int(flag("check_program")) \
                or not isinstance(program, Program):
            return
        from .analysis.pass_manager import (program_fingerprint,
                                            run_verify_pipeline)

        fp = program_fingerprint(program)
        with self._lock:
            if fp in self._verified:
                return
        run_verify_pipeline(program, fetch_names=fetch_names)
        with self._lock:
            self._verified.add(fp)

    def _prepare(self, program, feed, fetch_names, kind="run"):
        """The block-triple lookup, the remat and fusion swaps and the
        verification of what will run, timed: the preparation a new key's
        compile event reports as its ``trace_lower`` stage. With
        ``FLAGS_aot_cache_dir`` the prepared step comes from the
        warm-start cache when a saved one matches (``aot_cache``), and a
        cold one is saved there. The tuned triple is looked up first and
        keys the cached step, as the tuned options key the reference's
        compile: a warm process consults the shared cost database too,
        and never runs a step prepared under another triple."""
        t0 = time.perf_counter()
        from . import aot_cache as _aot_cache

        blocks = self._gemm_blocks(program, feed)
        cache_dir = _aot_cache.cache_dir_flag()
        if not cache_dir or not isinstance(program, Program):
            program = self._prepare_cold(program, feed, fetch_names, blocks)
            return program, blocks, time.perf_counter() - t0
        # the disk is probed once per step and executor: the memo holds
        # the prepared program, so every run of the key reuses ONE object
        memo_key = (program._serial, program._version, kind,
                    tuple(sorted((n,) + _shape_dtype_sig(v)
                                 for n, v in feed.items())),
                    tuple(fetch_names), self._key_flags(program),
                    self._pass_flags(), blocks)
        with self._lock:
            hit = self._aot_memo.get(memo_key)
        if hit is not None:
            return hit[0], hit[1], time.perf_counter() - t0
        parts = (kind, program, tuple(fetch_names),
                 self._key_flags(program), self._pass_flags(), blocks)
        key = _aot_cache.executable_key(parts, feed, self.device)
        loaded = _aot_cache.load_executable(cache_dir, key, self.device)
        if loaded is None:
            loaded = (self._prepare_cold(program, feed, fetch_names,
                                         blocks), blocks)
            # publish for the next cold process (atomic; failures warn
            # once and never break the step)
            _aot_cache.save_executable(cache_dir, key, loaded, self.device)
        with self._lock:
            loaded = self._aot_memo.setdefault(memo_key, loaded)
        return loaded[0], loaded[1], time.perf_counter() - t0

    def _prepare_cold(self, program, feed, fetch_names, blocks):
        program = self._maybe_auto_remat(program, feed, fetch_names)
        program = self._maybe_epilogue_fusion(program, feed, fetch_names,
                                              blocks)
        self._verify_once(program, fetch_names)
        return program

    @staticmethod
    def _pass_flags() -> tuple:
        """The flags ``_prepare``'s passes read beside the key flags."""
        from .flags import flag

        return tuple((n, flag(n)) for n in (
            "fused_gemm_blocks", "autotune", "auto_recompute",
            "remat_budget_mb", "check_program"))

    def _key_flags(self, program) -> tuple:
        from .flags import flag

        amp = getattr(program, "_amp_policy", None)
        return (("check_nan_inf", bool(flag("check_nan_inf"))),
                ("numerics_witness", bool(flag("numerics_witness"))),
                ("epilogue_fusion", bool(flag("epilogue_fusion"))),
                ("use_fused_gemm", flag("use_fused_gemm")),
                ("amp", amp.compute_dtype if amp is not None else None))

    def _get_step(self, path, program, key, components, prep_s, mrec,
                  feed, fetch_names, gemm_blocks, make_plan=None):
        """Look ``key`` up; a miss is a compile event (recorded, completed
        at the step's first run). Under the executor lock, so racing
        threads share one step and one compile record. ``make_plan``: a
        data-parallel key's plan, made at its compile event."""
        with self._lock:
            step = self._cache.get(key)
            hit = step is not None
            _monitor.record_cache_lookup(path, hit)
            if mrec is not None:
                mrec.cache_hit = hit
            if hit:
                return step
            step = _Step(program, prep_s, sorted(feed), fetch_names,
                         gemm_blocks)
            if make_plan is not None:
                step.dp = make_plan()
            step._compile_event = _monitor.observe_compile(
                path, program, components, donated_names=step.donated_names)
            self._cache[key] = step
            return step

    def _ensure_prepared(self, step: _Step) -> None:
        """A key's first run completes its compile event: the ``compile``
        fault site (retried as transient) under the ``executor.compile``
        span; stage timings preparation / 0."""
        if step.prepared:
            return
        with step._lock:
            if step.prepared:
                return
            ev, step._compile_event = step._compile_event, None
            try:
                with _trace.span(
                        "executor.compile",
                        program=int(getattr(step.program, "_serial", -1))):
                    call_with_retry("compile", _faults.fault_point,
                                    "compile")
                step.prepared = True
            finally:
                _monitor.complete_compile(ev, step.prep_s, 0.0)

    def _fill_record(self, mrec, step, feed, fetch_names, scope) -> None:
        if mrec is None:
            return
        mrec.fetch_names = tuple(fetch_names)
        mrec.feed_bytes = sum(_feed_host_bytes(v) for v in feed.values())
        mrec.batch_rows = _feed_batch_rows(feed)
        mrec.donated_buffers = len(step.donated_names)
        mrec.donated_bytes = _tensor_bytes(
            scope.find_var(n) for n in step.donated_names)

    def _sync_if_armed(self, tok) -> None:
        """Under ``FLAGS_step_timeout_s`` the armed section waits for the
        device (the reference blocks on the result there too), so a stuck
        device run stays inside the section."""
        if tok is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- public API ------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True):
        from .parallel.compiled_program import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope,
                                return_numpy)
        program = program or default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = feed or {}
        names = [_fetch_name(f) for f in fetch_list or []]
        program, blocks, prep_s = self._prepare(program, feed, names)
        mrec = _monitor.step_begin("run", program)
        # child of whatever request trace is ambient on this thread
        with _trace.span("executor.run",
                         program=int(getattr(program, "_serial", -1))):
            try:
                return self._run_body(program, feed, names, scope,
                                      return_numpy, mrec, prep_s, blocks)
            finally:
                _monitor.step_end(mrec)

    def _run_body(self, program, feed, names, scope, return_numpy, mrec,
                  prep_s, blocks, dp=None):
        """One step of ``program``; ``dp``: the ``CompiledProgram`` whose
        data-parallel plan runs it over the launched ranks (path
        ``parallel``, its own keys)."""
        from .analysis.pass_manager import program_fingerprint

        fp = program_fingerprint(program)
        feed_sig = tuple(sorted((n,) + _shape_dtype_sig(v)
                                for n, v in feed.items()))
        kflags = self._key_flags(program)
        components = {"program": fp[1:], "feed_signature": feed_sig,
                      "fetch_list": tuple(names), "scope": scope._serial,
                      "flags": kflags, "gemm_blocks": blocks}
        path, extra, make_plan = "run", (), None
        if dp is not None:
            path, extra = "parallel", dp._key()
            components["data_parallel"] = extra[1:]
            make_plan = functools.partial(dp._plan, program, feed, names)
        key = (fp, feed_sig, tuple(names), scope._serial) + extra + (
            blocks, kflags)
        step = self._get_step(path, program, key, components, prep_s, mrec,
                              feed, names, blocks, make_plan)
        self._fill_record(mrec, step, feed, names, scope)
        feed_t = self._feed_tensors(program, feed)
        if dp is not None:
            dp._before_step(self, step, feed_t, scope)
        # the step-site probe fires before any state is written
        _faults.fault_point("step")
        self._ensure_prepared(step)
        checks = [] if dict(kflags)["check_nan_inf"] else None
        taps = [] if dict(kflags)["numerics_witness"] else None
        # rollback_active() validates the policy before the step runs
        rollback = (self._rollback_image(step, scope)
                    if checks is not None and _nonfinite.rollback_active()
                    else None)
        with _trace.span("executor.step",
                         cache_hit=bool(mrec.cache_hit)
                         if mrec is not None else None), \
                _dist.watchdog_section("step" if dp is None
                                       else "parallel_step",
                                       program=program) as tok:
            if dp is not None:
                _faults.fault_point("device_lost")
            _faults.fault_point("hang")
            fetches = self._run_once(step, feed_t, names, scope, checks,
                                     taps)
            self._sync_if_armed(tok)
        self._record_witness(taps, path)
        if checks is not None:
            if step.dp is not None:
                step.dp.add_ranks_check(checks, self.device)
            self._check_step(checks, scope, rollback, path)
        if dp is not None:
            dp._maybe_check_replicas(step, scope)
        if return_numpy:
            outs = [_to_host(f) for f in fetches]
            if mrec is not None:
                mrec.fetch_bytes = sum(_host_bytes(o) for o in outs)
            return outs
        return fetches

    def run_chained(self, program: Optional[Program] = None,
                    feed: Optional[Dict[str, Any]] = None,
                    fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
                    steps: int = 1, scope: Optional[Scope] = None,
                    return_numpy: bool = True):
        """Run ``steps`` iterations of ``program`` with the same feed and
        return each fetch stacked along a new leading ``steps`` axis; the
        scope holds the final state, exactly as ``steps`` calls of
        :meth:`run`. The fetches stay on the device until the end, so the
        host waits for the device once per call."""
        from .analysis.pass_manager import program_fingerprint

        program = program or default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = feed or {}
        names = [_fetch_name(f) for f in fetch_list or []]
        if int(getattr(program, "_pipeline_microbatches", 1)) > 1:
            raise NotImplementedError(
                "run_chained with PipelineOptimizer programs: the pipeline "
                "step is already a scan; nest via GradientMergeOptimizer")
        program, blocks, prep_s = self._prepare(program, feed, names,
                                                "chained")
        fp = program_fingerprint(program)
        feed_sig = tuple(sorted((n,) + _shape_dtype_sig(v)
                                for n, v in feed.items()))
        kflags = self._key_flags(program)
        key = ("chained", fp, feed_sig, tuple(names), int(steps),
               scope._serial, blocks, kflags)
        mrec = _monitor.step_begin("chained", program)
        if mrec is not None:
            mrec.iterations = int(steps)
        with _trace.span("executor.run_chained",
                         program=int(getattr(program, "_serial", -1)),
                         steps=int(steps)):
            try:
                step = self._get_step("chained", program, key, {
                    "program": fp[1:], "feed_signature": feed_sig,
                    "fetch_list": tuple(names), "scope": scope._serial,
                    "steps": int(steps), "flags": kflags,
                    "gemm_blocks": blocks}, prep_s, mrec, feed, names,
                    blocks)
                self._fill_record(mrec, step, feed, names, scope)
                feed_t = self._feed_tensors(program, feed)
                _faults.fault_point("step")
                self._ensure_prepared(step)
                check = dict(kflags)["check_nan_inf"]
                rollback = (self._rollback_image(step, scope)
                            if check and _nonfinite.rollback_active()
                            else None)
                with _dist.watchdog_section("chained",
                                            program=program) as tok:
                    _faults.fault_point("hang")
                    per_step: List[List[torch.Tensor]] = [
                        self._run_once(step, feed_t, names, scope)
                        for _ in range(int(steps))]
                    stacked = [_stack([s[i] for s in per_step])
                               for i in range(len(names))]
                    self._sync_if_armed(tok)
                if check:
                    self._check_chained(step, scope, rollback, int(steps))
                if return_numpy:
                    outs = [_to_host(t) for t in stacked]
                    if mrec is not None:
                        mrec.fetch_bytes = sum(_host_bytes(o) for o in outs)
                    return outs
                return stacked
            finally:
                _monitor.step_end(mrec)
