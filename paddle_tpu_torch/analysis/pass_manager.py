"""Uniform pass framework over the Program IR (counterpart of
``paddle_tpu/analysis/pass_manager.py``).

* ``Pass`` — base class; ``kind`` is ``ANALYSIS`` (produces diagnostics
  and/or a result object, never mutates the program) or ``TRANSFORM``
  (returns a rebuilt ``Program``; the original is never mutated in place).
* ``PassRegistry`` — named passes with declared dependencies
  (``requires=("liveness",)`` runs and caches the liveness pass first)
  and invalidations (``invalidates="*"`` drops every cached analysis
  after the transform runs).
* ``PassContext`` — per-pipeline analysis cache shared across passes, the
  diagnostics sink (``report``), the pipeline's feed and fetch names, its
  batch size and free-form ``options`` (epilogue fusion reads
  ``gemm_blocks`` and the ``device`` its fidelity witness runs on).
* ``PassManager.run_pipeline`` — dependency-ordered execution.

Registered passes (``builtin_passes``): ``liveness`` (analysis, PT50x +
the def/use chains) and ``epilogue_fusion`` (transform, requires
liveness). Every pass run is counted through ``monitor.record_pass``
(``pass_runs_total``, ``pass_duration_seconds``). Re-verification after
each transform at ``FLAGS_check_program>=2`` arrives with the verifier.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .diagnostics import Diagnostic

__all__ = [
    "ANALYSIS", "TRANSFORM", "Pass", "FunctionPass", "PassRegistry",
    "get_pass_registry", "PassContext", "PipelineResult",
    "PassManager", "default_pass_manager", "run_transform_pipeline",
    "program_fingerprint",
]

ANALYSIS = "analysis"
TRANSFORM = "transform"


def program_fingerprint(program) -> tuple:
    """(serial, version, op count) — the executor's cache identity: serial
    survives GC aliasing, version counts appends and ``set_attr``
    mutations, op count catches removals (which bump no counter)."""
    return (int(getattr(program, "_serial", -1)),
            int(getattr(program, "_version", 0)),
            sum(len(b.ops) for b in program.blocks))


# ---------------------------------------------------------------------------
# passes and the registry
# ---------------------------------------------------------------------------

class Pass:
    """One registered IR pass. Subclass and implement ``run``, or wrap a
    plain function in ``FunctionPass``.

    ``run(program, ctx)`` contract by kind:

    * ANALYSIS — never mutates ``program``; reports findings with
      ``ctx.report(Diagnostic(...))``; its return value is cached on the
      context (``ctx.analysis(name)``) until a transform invalidates it.
    * TRANSFORM — returns the replacement ``Program``, or any object with
      a ``.program`` attribute (e.g. ``FusionDecision``), or ``None`` for
      "no change". Never mutates the input program in place.
    """

    name: str = ""
    kind: str = ANALYSIS
    requires: Tuple[str, ...] = ()
    invalidates: Tuple[str, ...] = ()   # "*" (as a 1-tuple) drops everything

    def run(self, program, ctx: "PassContext"):
        raise NotImplementedError

    def __repr__(self):
        return (f"<{type(self).__name__} {self.name!r} kind={self.kind} "
                f"requires={self.requires}>")


class FunctionPass(Pass):
    """A plain ``fn(program, ctx)`` registered as a pass."""

    def __init__(self, fn: Callable, name: str, kind: str,
                 requires: Sequence[str] = (),
                 invalidates: Sequence[str] = ()):
        self.fn = fn
        self.name = name
        self.kind = kind
        self.requires = tuple(requires)
        self.invalidates = tuple(invalidates)
        self.__doc__ = fn.__doc__

    def run(self, program, ctx: "PassContext"):
        return self.fn(program, ctx)


class PassRegistry:
    """Name -> ``Pass`` table."""

    def __init__(self):
        self._passes: Dict[str, Pass] = {}

    def register(self, p: Pass, override: bool = False) -> Pass:
        if not p.name:
            raise ValueError("pass has no name")
        if p.kind not in (ANALYSIS, TRANSFORM):
            raise ValueError(f"pass '{p.name}': kind must be '{ANALYSIS}' "
                             f"or '{TRANSFORM}', got {p.kind!r}")
        if p.name in self._passes and not override:
            raise ValueError(f"pass '{p.name}' is already registered "
                             f"(pass override=True to replace)")
        self._passes[p.name] = p
        return p

    def get(self, name: str) -> Pass:
        p = self._passes.get(name)
        if p is None:
            raise KeyError(f"unknown pass '{name}' — registered: "
                           f"{sorted(self._passes)}")
        return p


_default_registry = PassRegistry()


def get_pass_registry() -> PassRegistry:
    _ensure_builtin_passes()
    return _default_registry


# ---------------------------------------------------------------------------
# the context: shared analysis cache + diagnostics sink
# ---------------------------------------------------------------------------

class PassContext:
    """Carries one pipeline's inputs (feeds/fetches/batch/options) and the
    analysis cache. Analyses run at most once per context; a transform
    pass invalidates what it declares (``"*"`` for everything)."""

    def __init__(self, program, feed_names: Sequence[str] = (),
                 fetch_names: Sequence[str] = (), batch_size: int = 1,
                 options: Optional[Dict[str, Any]] = None,
                 registry: Optional[PassRegistry] = None):
        self.program = program
        self.feed_names = tuple(feed_names or ())
        self.fetch_names = tuple(getattr(f, "name", f)
                                 for f in (fetch_names or ()))
        self.batch_size = max(int(batch_size), 1)
        self.options: Dict[str, Any] = dict(options or {})
        self.registry = registry if registry is not None \
            else get_pass_registry()
        self.diagnostics: List[Diagnostic] = []
        self._cache: Dict[str, Any] = {}
        self._cache_diags: Dict[str, List[Diagnostic]] = {}
        self._running: List[str] = []   # cycle guard for analysis(...)

    def report(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def analysis(self, name: str):
        """Result of analysis pass ``name``, running it on demand (and
        caching); its diagnostics are recorded once."""
        if name in self._cache:
            return self._cache[name]
        p = self.registry.get(name)
        if p.kind != ANALYSIS:
            raise ValueError(f"pass '{name}' is a {p.kind} pass — only "
                             f"analysis results can be cached/required")
        if name in self._running:
            raise ValueError(f"analysis dependency cycle: "
                             f"{' -> '.join(self._running + [name])}")
        for dep in p.requires:
            self.analysis(dep)
        start = len(self.diagnostics)
        self._running.append(name)
        t0 = time.perf_counter()
        try:
            value = p.run(self.program, self)
        finally:
            self._running.pop()
        _record_pass_metrics(name, p.kind, time.perf_counter() - t0)
        self._cache[name] = value
        self._cache_diags[name] = self.diagnostics[start:]
        return value

    def invalidate(self, names: Sequence[str] = ("*",)) -> None:
        """Drop cached analyses (a transform ran). ``("*",)`` drops all."""
        if "*" in names:
            self._cache.clear()
            self._cache_diags.clear()
        else:
            for n in names:
                self._cache.pop(n, None)
                self._cache_diags.pop(n, None)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineResult:
    """Outcome of one ``run_pipeline`` call."""

    program: Any                       # the (possibly transformed) Program
    diagnostics: List[Diagnostic]
    values: Dict[str, Any]             # pass name -> return value
    context: PassContext
    changed: bool = False              # did any transform swap the program


class PassManager:
    """Dependency-ordered pass execution over one registry."""

    def __init__(self, registry: Optional[PassRegistry] = None):
        self._registry = registry

    @property
    def registry(self) -> PassRegistry:
        return self._registry if self._registry is not None \
            else get_pass_registry()

    def resolve(self, passes: Sequence[str]) -> List[str]:
        """Requested passes plus their transitive ``requires``, in
        dependency order (a required pass runs before its dependent);
        explicit request order is preserved otherwise."""
        reg = self.registry
        order: List[str] = []
        visiting: List[str] = []

        def visit(name: str) -> None:
            if name in order:
                return
            if name in visiting:
                raise ValueError(f"pass dependency cycle: "
                                 f"{' -> '.join(visiting + [name])}")
            p = reg.get(name)
            visiting.append(name)
            for dep in p.requires:
                visit(dep)
            visiting.pop()
            order.append(name)

        for name in passes:
            visit(name)
        return order

    def run_pipeline(self, program, passes: Sequence[str],
                     feed_names: Sequence[str] = (),
                     fetch_names: Sequence[str] = (),
                     batch_size: int = 1,
                     options: Optional[Dict[str, Any]] = None
                     ) -> PipelineResult:
        """Run ``passes`` (dependency-expanded, in order) over ``program``
        with a fresh ``PassContext``. Never mutates ``program``; the
        (possibly rebuilt) program is ``result.program``."""
        ctx = PassContext(program, feed_names, fetch_names, batch_size,
                          options, registry=self.registry)
        values: Dict[str, Any] = {}
        diags: List[Diagnostic] = []
        current = program
        changed = False
        for name in self.resolve(passes):
            p = self.registry.get(name)
            if p.kind == ANALYSIS:
                if name in ctx._cache:
                    _record_pass_metrics(name, p.kind, 0.0, cached=True)
                values[name] = ctx.analysis(name)
                diags.extend(ctx._cache_diags.get(name, ()))
                continue
            start = len(ctx.diagnostics)
            t0 = time.perf_counter()
            try:
                out = p.run(current, ctx)
            finally:
                _record_pass_metrics(name, p.kind, time.perf_counter() - t0)
            values[name] = out
            diags.extend(ctx.diagnostics[start:])
            new_prog = out
            if new_prog is not None and not _is_program(new_prog):
                new_prog = getattr(out, "program", None)
            if new_prog is None or new_prog is current:
                continue
            ctx.invalidate(p.invalidates or ("*",))
            ctx.program = new_prog
            current = new_prog
            changed = True
        return PipelineResult(program=current, diagnostics=diags,
                              values=values, context=ctx, changed=changed)


def _record_pass_metrics(name: str, kind: str, seconds: float,
                         cached: bool = False) -> None:
    from .. import monitor

    monitor.record_pass(name, kind, seconds, cached=cached)


def _is_program(obj) -> bool:
    from ..framework import Program

    return isinstance(obj, Program)


# built-in pass registration (lazy: builtin_passes imports this module)
def _ensure_builtin_passes() -> None:
    if "liveness" in _default_registry._passes:
        return
    from . import builtin_passes

    builtin_passes.register_builtins(_default_registry)


_default_manager: Optional[PassManager] = None


def default_pass_manager() -> PassManager:
    """The process-wide manager the executor hook shares."""
    global _default_manager
    if _default_manager is None:
        _default_manager = PassManager()
    return _default_manager


def run_transform_pipeline(program, passes: Sequence[str],
                           feed_names: Sequence[str] = (),
                           fetch_names: Sequence[str] = (),
                           batch_size: int = 1,
                           options: Optional[Dict[str, Any]] = None
                           ) -> PipelineResult:
    """The executor's hook body (``FLAGS_epilogue_fusion``): run transform
    passes through the shared manager."""
    return default_pass_manager().run_pipeline(
        program, passes, feed_names=feed_names, fetch_names=fetch_names,
        batch_size=batch_size, options=options)
