"""Uniform pass framework over the Program IR (counterpart of
``paddle_tpu/analysis/pass_manager.py``).

* ``Pass`` — base class; ``kind`` is ``ANALYSIS`` (produces diagnostics
  and/or a result object, never mutates the program) or ``TRANSFORM``
  (returns a rebuilt ``Program``; the original is never mutated in place).
* ``PassRegistry`` / ``@register_pass`` — named passes with declared
  dependencies (``requires=("liveness",)`` runs and caches the liveness
  pass first) and invalidations (``invalidates="*"`` drops every cached
  analysis after the transform runs).
* ``PassContext`` — per-pipeline analysis cache shared across passes
  (``donation_race`` reads the one cached ``liveness`` result), the
  diagnostics sink (``report``), the pipeline's feed and fetch names, its
  batch size and free-form ``options`` (epilogue fusion reads
  ``gemm_blocks`` and the ``device`` its fidelity witness runs on).
* ``PassManager.run_pipeline`` — dependency-ordered execution with
  pre/post verification: at ``FLAGS_check_program`` level >= 2 every
  transform pass is bracketed by ``verify_program`` and a pass that
  introduces NEW error-severity findings is refused with
  ``PassVerificationError`` naming the pass. Every pass run is counted
  through ``monitor.record_pass`` (``pass_runs_total``,
  ``pass_duration_seconds``).

``FLAGS_check_program`` levels: 0 = off, 1 = verify each program once
before execution, 2 = additionally re-verify after every transform pass
(the pipeline invariant). The executor routes ``FLAGS_check_program``
through ``run_verify_pipeline`` and ``FLAGS_auto_recompute`` /
``FLAGS_epilogue_fusion`` through ``run_transform_pipeline`` below.

Built-in passes (``builtin_passes``):

| name              | kind      | requires    | what |
|-------------------|-----------|-------------|------|
| schema            | analysis  | —           | PT10x slot/attr conformance |
| dataflow          | analysis  | —           | PT20x def-before-use, dead writes |
| lowerability      | analysis  | —           | PT30x missing op rules |
| shape_replay      | analysis  | —           | PT40x per-op infer_shape drift |
| liveness          | analysis  | —           | PT50x + def/use chains (cached) |
| dtype_shape_check | analysis  | —           | PT70x whole-program replay |
| donation_race     | analysis  | liveness    | PT71x donation/alias races |
| dead_code         | analysis  | —           | PT72x transitively dead ops |
| cost_model        | analysis  | —           | FLOP/byte CostReport (no diagnostics) |
| numerics_check    | analysis  | —           | PT90x interval/precision flow + quantizability |
| auto_remat        | transform | —           | rebuild with checkpoints (FLAGS_auto_recompute) |
| epilogue_fusion   | transform | liveness    | GEMM-epilogue fusion (FLAGS_epilogue_fusion) |
| dce               | transform | dead_code   | opt-in dead-op elimination |
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .diagnostics import (Diagnostic, ProgramVerificationError, Severity,
                          format_diagnostics)

__all__ = [
    "ANALYSIS", "TRANSFORM", "Pass", "FunctionPass", "PassRegistry",
    "register_pass", "get_pass_registry", "PassContext", "PipelineResult",
    "PassManager", "PassVerificationError", "default_pass_manager",
    "run_verify_pipeline", "run_transform_pipeline", "program_fingerprint",
    "clear_analysis_caches", "ALL_ANALYSIS_PASSES", "VERIFY_PASSES",
]

ANALYSIS = "analysis"
TRANSFORM = "transform"

# the verifier pipeline (FLAGS_check_program) and the full static-analysis
# suite
VERIFY_PASSES = ("schema", "dataflow", "lowerability", "shape_replay",
                 "liveness")
# numerics_check is one linear walk on a findings-free program, so the
# full pipeline can always include it. The reference's sharding_check
# (PT730-PT744) is left out until the port's multi-device analyses arrive.
ALL_ANALYSIS_PASSES = VERIFY_PASSES + ("dtype_shape_check", "donation_race",
                                       "dead_code", "sharding_check",
                                       "numerics_check")

class PassVerificationError(ProgramVerificationError):
    """A transform pass broke the pipeline invariant: ``verify_program``
    found error-severity diagnostics after the transform that the input
    program did not have. Carries the offending pass name."""

    def __init__(self, pass_name: str, diags: List[Diagnostic]):
        self.pass_name = pass_name
        ValueError.__init__(
            self,
            f"transform pass '{pass_name}' broke the program invariant — "
            f"post-transform verify_program found new error(s) "
            f"(FLAGS_check_program>=2):\n" + format_diagnostics(diags))
        self.diagnostics = diags


def program_fingerprint(program) -> tuple:
    """(serial, version, op count) — the executor's cache identity: serial
    survives GC aliasing, version counts appends + ``set_attr`` mutations,
    op count catches removals (which bump no counter)."""
    return (int(getattr(program, "_serial", -1)),
            int(getattr(program, "_version", 0)),
            sum(len(b.ops) for b in program.blocks))


# ---------------------------------------------------------------------------
# passes and the registry
# ---------------------------------------------------------------------------

class Pass:
    """One registered IR pass. Subclass and implement ``run``, or register
    a plain function with ``@register_pass`` (wrapped in ``FunctionPass``).

    ``run(program, ctx)`` contract by kind:

    * ANALYSIS — never mutates ``program``; reports findings with
      ``ctx.report(Diagnostic(...))``; its return value is cached on the
      context (``ctx.analysis(name)``) until a transform invalidates it.
    * TRANSFORM — returns the replacement ``Program``, or any object with
      a ``.program`` attribute (e.g. ``FusionDecision``), or ``None`` for
      "no change". Must never mutate the input program in place: the
      pre/post verify bracket and the analysis caches both rely on the
      input staying intact.
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
    """Name -> ``Pass`` table with snapshot/restore for test isolation
    (a test that registers a pass restores the table afterwards)."""

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

    def has(self, name: str) -> bool:
        return name in self._passes

    def names(self) -> List[str]:
        return sorted(self._passes)

    def passes(self) -> List[Pass]:
        return [self._passes[n] for n in sorted(self._passes)]

    # -- test isolation ---------------------------------------------------
    def snapshot(self) -> Dict[str, Pass]:
        return dict(self._passes)

    def restore(self, snap: Dict[str, Pass]) -> None:
        self._passes = dict(snap)


_default_registry = PassRegistry()


def get_pass_registry() -> PassRegistry:
    _ensure_builtin_passes()
    return _default_registry


def register_pass(name: str, kind: str = ANALYSIS,
                  requires: Sequence[str] = (),
                  invalidates: Sequence[str] = (),
                  registry: Optional[PassRegistry] = None,
                  override: bool = False):
    """Decorator registering a function or ``Pass`` subclass:

    >>> @register_pass("my_lint", requires=("liveness",))
    ... def my_lint(program, ctx):
    ...     live = ctx.analysis("liveness")
    ...     ...
    """
    reg = registry if registry is not None else _default_registry

    def deco(obj):
        if isinstance(obj, type) and issubclass(obj, Pass):
            inst = obj()
            inst.name = name
            inst.kind = kind
            inst.requires = tuple(requires)
            inst.invalidates = tuple(invalidates)
            reg.register(inst, override=override)
            return obj
        reg.register(FunctionPass(obj, name, kind, requires, invalidates),
                     override=override)
        return obj

    return deco


# ---------------------------------------------------------------------------
# the context: shared analysis cache + diagnostics sink
# ---------------------------------------------------------------------------

class PassContext:
    """Carries one pipeline's inputs (feeds/fetches/batch/options) and the
    analysis cache. Analyses run at most once per context; a transform
    pass invalidates what it declares (``"*"`` for everything), so e.g.
    ``donation_race`` reads the one cached ``liveness`` result."""

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
        # (start, end) windows claimed by nested analysis() runs, per
        # in-flight frame — keeps each pass' recorded diagnostics disjoint
        self._frames: List[List[Tuple[int, int]]] = []

    # -- diagnostics ------------------------------------------------------
    def report(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.ERROR]

    # -- analysis cache ---------------------------------------------------
    def analysis(self, name: str):
        """Result of analysis pass ``name``, running it on demand (and
        caching). The pass' diagnostics are recorded exactly once no
        matter how many passes request the result: windows claimed by a
        nested ``analysis()`` call (a dependency run on demand inside
        another pass) are excluded from the caller's own window."""
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
        sink_start = len(self.diagnostics)
        self._running.append(name)
        self._frames.append([])
        t0 = time.perf_counter()
        try:
            value = p.run(self.program, self)
        finally:
            self._running.pop()
            nested = self._frames.pop()
        _record_pass_metrics(name, p.kind, time.perf_counter() - t0)
        sink_end = len(self.diagnostics)
        own = [d for i, d in enumerate(self.diagnostics[sink_start:],
                                       sink_start)
               if not any(s <= i < e for s, e in nested)]
        self._cache[name] = value
        self._cache_diags[name] = own
        if self._frames:
            # tell the enclosing pass this whole window (nested runs
            # included — their ranges nest inside ours) is spoken for
            self._frames[-1].append((sink_start, sink_end))
        return value

    def has_analysis(self, name: str) -> bool:
        return name in self._cache

    def invalidate(self, names: Sequence[str] = ("*",)) -> None:
        """Drop cached analyses (a transform ran). ``("*",)`` drops all."""
        if "*" in names:
            self._cache.clear()
            self._cache_diags.clear()
        else:
            for n in names:
                self._cache.pop(n, None)
                self._cache_diags.pop(n, None)

    # -- rebinding after a transform --------------------------------------
    def rebind(self, program) -> None:
        """Point the context at a transform's output program. Cached
        analyses were computed on the OLD program, so the caller (the
        manager) invalidates per the pass declaration before rebinding."""
        self.program = program


def _record_pass_metrics(name: str, kind: str, seconds: float,
                         cached: bool = False) -> None:
    from .. import monitor

    monitor.record_pass(name, kind, seconds, cached=cached)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineResult:
    """Outcome of one ``run_pipeline`` call."""

    program: Any                       # the (possibly transformed) Program
    diagnostics: List[Diagnostic]
    values: Dict[str, Any]             # pass name -> return value
    timings: List[Tuple[str, str, float]]  # (name, kind, seconds)
    context: PassContext
    changed: bool = False              # did any transform swap the program

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.ERROR]


class PassManager:
    """Dependency-ordered pass execution over one registry, with the
    pre/post verification bracket. One default instance serves the
    executor hooks and the CLI tools (``default_pass_manager()``)."""

    def __init__(self, registry: Optional[PassRegistry] = None):
        self._registry = registry

    @property
    def registry(self) -> PassRegistry:
        return self._registry if self._registry is not None \
            else get_pass_registry()

    # -- ordering ---------------------------------------------------------
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

    # -- execution --------------------------------------------------------
    def run_pipeline(self, program, passes: Sequence[str],
                     feed_names: Sequence[str] = (),
                     fetch_names: Sequence[str] = (),
                     batch_size: int = 1,
                     options: Optional[Dict[str, Any]] = None,
                     verify: Optional[str] = None,
                     context: Optional[PassContext] = None
                     ) -> PipelineResult:
        """Run ``passes`` (dependency-expanded, in order) over ``program``.

        ``verify`` controls the invariant bracket:

        * ``None`` (default) — derive from ``FLAGS_check_program``:
          level >= 2 behaves like ``"strict"``, else ``"none"``.
        * ``"none"``  — no bracketing (analysis findings still collect).
        * ``"strict"`` — ``verify_program`` before the pipeline and after
          every transform pass; a transform that introduces NEW
          error-severity findings raises ``PassVerificationError``.

        Never mutates ``program``; the (possibly rebuilt) program is
        ``result.program``.

        A fresh ``PassContext`` is built per call (so programs mutated
        without a version bump, and flag flips, are always re-analysed);
        pass ``context=`` to carry one context across pipeline calls when
        the caller can vouch the program and flags are unchanged. Within
        one pipeline analyses always share: ``donation_race`` reads the
        one cached ``liveness`` result.
        """
        from .verifier import verify_program

        if verify is None:
            from ..flags import flag

            verify = "strict" if int(flag("check_program")) >= 2 else "none"
        order = self.resolve(passes)
        ctx = context if context is not None else PassContext(
            program, feed_names, fetch_names, batch_size, options,
            registry=self.registry)
        if options and ctx.options is not options:
            ctx.options.update(options)

        # baseline keyed by per-code COUNTS: messages embed op indices, so
        # a transform that merely renumbers ops must not make an old error
        # look new — only a code whose count grew blames the pass
        baseline_errors: Dict[str, int] = {}
        if verify == "strict":
            for d in verify_program(program, fetch_names=ctx.fetch_names):
                if d.severity == Severity.ERROR:
                    baseline_errors[d.code] = baseline_errors.get(
                        d.code, 0) + 1

        values: Dict[str, Any] = {}
        timings: List[Tuple[str, str, float]] = []
        pipeline_diags: List[Diagnostic] = []
        current = program
        changed = False
        for name in order:
            p = self.registry.get(name)
            if p.kind == ANALYSIS:
                cached = ctx.has_analysis(name)
                t0 = time.perf_counter()
                values[name] = ctx.analysis(name)
                if cached:
                    # the pass already ran on this program version (earlier
                    # pipeline or a requires= dependency); replay its
                    # recorded findings into this pipeline's window
                    _record_pass_metrics(name, p.kind, 0.0, cached=True)
                else:
                    timings.append((name, p.kind,
                                    time.perf_counter() - t0))
                pipeline_diags.extend(ctx._cache_diags.get(name, ()))
                continue
            # transform — framed like an analysis run so diagnostics from
            # any on-demand ctx.analysis() inside it stay with that
            # analysis' window instead of double-counting here
            sink = len(ctx.diagnostics)
            ctx._frames.append([])
            t0 = time.perf_counter()
            try:
                out = p.run(current, ctx)
            finally:
                seconds = time.perf_counter() - t0
                nested = ctx._frames.pop()
            _record_pass_metrics(name, p.kind, seconds)
            timings.append((name, p.kind, seconds))
            values[name] = out
            pipeline_diags.extend(
                d for i, d in enumerate(ctx.diagnostics[sink:], sink)
                if not any(s <= i < e for s, e in nested))
            new_prog = out
            if new_prog is not None and not _is_program(new_prog):
                new_prog = getattr(out, "program", None)
            if new_prog is None or new_prog is current:
                continue
            if verify == "strict":
                post = [d for d in verify_program(
                            new_prog, fetch_names=ctx.fetch_names)
                        if d.severity == Severity.ERROR]
                post_counts: Dict[str, int] = {}
                for d in post:
                    post_counts[d.code] = post_counts.get(d.code, 0) + 1
                grown = {c for c, n in post_counts.items()
                         if n > baseline_errors.get(c, 0)}
                if grown:
                    raise PassVerificationError(
                        name, [d for d in post if d.code in grown])
            ctx.invalidate(p.invalidates or ("*",))
            ctx.rebind(new_prog)
            current = new_prog
            changed = True

        return PipelineResult(
            program=current, diagnostics=pipeline_diags,
            values=values, timings=timings, context=ctx, changed=changed)


def _is_program(obj) -> bool:
    from ..framework import Program

    return isinstance(obj, Program)


# ---------------------------------------------------------------------------
# built-in pass registration (lazy: verifier/liveness/remat import us back)
# ---------------------------------------------------------------------------

def _ensure_builtin_passes() -> None:
    if "schema" in _default_registry._passes:
        return
    from . import builtin_passes

    builtin_passes.register_builtins(_default_registry)


_default_manager: Optional[PassManager] = None


def default_pass_manager() -> PassManager:
    """The process-wide manager the executor hooks and tools share."""
    global _default_manager
    if _default_manager is None:
        _default_manager = PassManager()
    return _default_manager


def clear_analysis_caches() -> None:
    """Drop the default manager and with it any state it holds — the test
    isolation hook paired with the registry restore. (Contexts are
    per-pipeline, so this guards future manager-held caching rather than
    live state.)"""
    global _default_manager
    _default_manager = None


# ---------------------------------------------------------------------------
# executor-facing entry points
# ---------------------------------------------------------------------------

def run_verify_pipeline(program, fetch_names: Sequence[str] = (),
                        passes: Sequence[str] = VERIFY_PASSES
                        ) -> List[Diagnostic]:
    """The FLAGS_check_program hook body: run the verifier pipeline through
    the manager and raise ``ProgramVerificationError`` on error-severity
    findings, with per-pass monitor timings and shared analysis caching."""
    result = default_pass_manager().run_pipeline(
        program, passes, fetch_names=fetch_names, verify="none")
    if any(d.severity == Severity.ERROR for d in result.diagnostics):
        raise ProgramVerificationError(result.diagnostics)
    return result.diagnostics


def run_transform_pipeline(program, passes: Sequence[str],
                           feed_names: Sequence[str] = (),
                           fetch_names: Sequence[str] = (),
                           batch_size: int = 1,
                           options: Optional[Dict[str, Any]] = None
                           ) -> PipelineResult:
    """The executor's hook body (``FLAGS_auto_recompute``,
    ``FLAGS_epilogue_fusion``): run transform passes through the shared
    manager. Pre/post verification applies at FLAGS_check_program level
    >= 2."""
    return default_pass_manager().run_pipeline(
        program, passes, feed_names=feed_names, fetch_names=fetch_names,
        batch_size=batch_size, options=options)
