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
back into the scope after the run. Feeds arrive as numpy and fetches
leave as numpy; any var the step computed can be fetched, ``@GRAD`` vars
included. Ops run under ``torch.no_grad()``: only a generic grad op
builds an autograd graph, and frees it before the next op.

Places: ``Executor()`` with no place means ``CUDAPlace(0)`` and raises
where CUDA is absent; pass ``CPUPlace()`` to run on the CPU.

``FLAGS_epilogue_fusion``: ``run`` and ``run_chained`` swap a
forward-only program for its GEMM-epilogue-fused clone
(``analysis/epilogue_fusion.py``), witnessed on this executor's device;
the decision is cached per (program serial, version, op count, fetches,
``FLAGS_fused_gemm_blocks``, ``FLAGS_use_fused_gemm``): a new block triple
or route mode re-runs the witness.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .core.types import torch_dtype
from .framework import Program, Variable, default_main_program
from .lowering import EMPTY_VAR_NAME, LowerCtx, lower_op

__all__ = ["Executor", "Scope", "global_scope", "CPUPlace", "CUDAPlace"]


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

    def __init__(self):
        self.vars: Dict[str, Any] = {}
        self._lock = threading.RLock()

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
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _fetch_name(f) -> str:
    return f.name if isinstance(f, Variable) else f


def _feed_batch_rows(feed) -> int:
    """Leading feed dim (the batch the fusion witness and its PT755
    report resolve -1 dims to)."""
    batch = 1
    for v in (feed or {}).values():
        shape = tuple(getattr(v, "shape", None) or np.shape(v))
        if shape:
            batch = max(batch, int(shape[0]))
    return batch


class Executor:
    """Runs programs op by op on one device."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._lock = threading.Lock()
        self._step_counter = 0
        # FLAGS_epilogue_fusion: (fingerprint, fetches, blocks, route
        # mode) -> the program to run, and the FusionDecision that chose it
        self._fusion_cache: Dict[tuple, Program] = {}
        self._fusion_decisions: Dict[tuple, Any] = {}

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
        if not (isinstance(v, torch.Tensor) and v.device == self.device):
            # planted host state (or state from another device) moves
            # here once; in-place updates then land in the scope's tensor
            dt = blk.var(name).dtype if blk.has_var(name) else None
            v = self._to_tensor(v, dt)
            scope.set_var(name, v)
        return v

    def _run_once(self, program, feed, fetch_names, scope):
        blk = program.global_block
        env: Dict[str, Any] = {}
        for n, v in feed.items():
            env[n] = self._to_tensor(
                v, blk.var(n).dtype if blk.has_var(n) else None)
        ctx = LowerCtx(self.device, seed=self._next_seed(program),
                       program=program)
        written = set()
        with torch.no_grad():
            for op in blk.ops:
                for n in op.input_arg_names:
                    if n not in env and n != EMPTY_VAR_NAME:
                        env[n] = self._state(n, program, scope)
                lower_op(op, env, ctx)
                written.update(op.output_arg_names)
        for n in written:
            if blk.has_var(n) and blk.var(n).persistable:
                scope.set_var(n, env[n])
        fetches = []
        for n in fetch_names:
            if n not in env:
                env[n] = self._state(n, program, scope)
            fetches.append(env[n])
        return fetches

    def _maybe_epilogue_fusion(self, program, feed, fetch_names):
        """FLAGS_epilogue_fusion entry shared by run / run_chained: swap a
        forward-only program for its GEMM-epilogue-fused rewrite. Training
        programs, programs with no mul/matmul, and anything the pass's
        fidelity witness cannot prove pass through untouched. The fused
        clone has its own ``_serial``."""
        from .flags import flag

        if not flag("epilogue_fusion") or not isinstance(program, Program):
            return program
        from .analysis.epilogue_fusion import has_fusable_ops
        from .analysis.pass_manager import (program_fingerprint,
                                            run_transform_pipeline)
        from .ops.fused_gemm import resolve_gemm_blocks

        blocks = resolve_gemm_blocks() if flag("fused_gemm_blocks") \
            else None
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
        return winner

    # -- public API ------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True):
        program = program or default_main_program()
        scope = scope if scope is not None else global_scope()
        names = [_fetch_name(f) for f in fetch_list or []]
        program = self._maybe_epilogue_fusion(program, feed, names)
        fetches = self._run_once(program, feed or {}, names, scope)
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
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
        program = program or default_main_program()
        scope = scope if scope is not None else global_scope()
        names = [_fetch_name(f) for f in fetch_list or []]
        program = self._maybe_epilogue_fusion(program, feed, names)
        per_step: List[List[torch.Tensor]] = [
            self._run_once(program, feed or {}, names, scope)
            for _ in range(int(steps))]
        stacked = [torch.stack([s[i] for s in per_step])
                   for i in range(len(names))]
        if return_numpy:
            return [t.detach().cpu().numpy() for t in stacked]
        return stacked
