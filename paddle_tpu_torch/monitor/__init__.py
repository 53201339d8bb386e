"""paddle_tpu_torch.monitor — executor runtime metrics, recompile
diagnostics and step hooks (counterpart of ``paddle_tpu/monitor``, with the
reference's metric names, labels and record fields).

* ``registry`` — thread-safe counters/gauges/histograms with JSON and
  Prometheus-text exporters (``get_registry()``, ``metric_value()``);
  ``promtext`` parses the text form back.
* ``hooks`` — ``add_hook(on_step_begin=..., on_step_end=...,
  on_compile=...)`` fed by the executor.
* ``recompile`` — compile-event diagnostics that name which key component
  changed (program / feed_signature / fetch_list / scope / flags) with
  the build site.
* ``lockwitness`` — the named-lock factories (plain ``threading``
  primitives unless ``FLAGS_lock_witness``).

What a compile is here: the port interprets a program op by op and has
no executable cache. Its compile event is the first run of an executor
key (program serial and version, feed signature, fetch list, scope
serial, and the flags the port keys on: fusion, ``FLAGS_use_fused_gemm``,
the AMP policy). The event's ``trace_lower`` stage is the preparation
(the fusion pass and its witness, when they ran); its ``xla_compile``
stage is 0.

Cost gauges: ``program_cost`` caches one ``analysis.cost_model``
report per (program, batch); ``step_end`` turns each measured dispatch
into ``executor_model_gflops_per_step``, ``executor_achieved_tflops`` and
``executor_mfu`` (``observe_step_cost``), and the serving engine does the
same per bucket (``observe_serving_cost``), all against
``FLAGS_device_peak_tflops``. ``record_remat`` counts the
``FLAGS_auto_recompute`` decisions. ``record_pass`` times every IR pass
(the ``FLAGS_check_program`` verify pipeline's included:
``pass_runs_total``, ``pass_duration_seconds``);
``record_autotune_lookup`` / ``record_autotune_trial`` count the
autotuner's cost-database lookups and measured trials
(``autotune_hits_total``, ``autotune_misses_total``,
``autotune_trials_total``, ``autotune_best_per_step_seconds``).

``paddle_tpu_torch.resilience`` and ``serving`` report through the same
registry. Everything is on by default (``FLAGS_monitor=0`` disables
collection). ``numwitness`` is the runtime numerics witness
(``FLAGS_numerics_witness``). Not in the port yet: the fleet tier's trace
exemplars and histogram merging (``FLAGS_fleet_telemetry`` is refused on).
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Optional

from .hooks import (CompileRecord, Hook, StepRecord, add_hook, clear_hooks,
                    dispatch, remove_hook)
from .lockwitness import (make_condition, make_lock, make_rlock,
                          reset_witness, witness_cycles, witness_edges,
                          witness_enabled, witness_report)
from .promtext import (ParsedFamily, PromParseError,
                       histogram_snapshot_from_samples,
                       parse_prometheus_text)
from .numwitness import (containment_violations, first_offender,
                         numerics_witness_enabled, numerics_witness_report,
                         numerics_witness_vars, reset_numerics_witness)
from .recompile import RecompileTracker, build_site, get_tracker
from .registry import (DEFAULT_TIME_BUCKETS, Counter, Gauge, Histogram,
                       MetricFamily, MetricsRegistry, counter, gauge,
                       get_registry, histogram, metric_value)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "StepRecord", "CompileRecord", "Hook", "RecompileTracker",
    "DEFAULT_TIME_BUCKETS",
    "add_hook", "remove_hook", "clear_hooks", "get_registry", "counter",
    "gauge", "histogram", "metric_value", "enabled", "record_cache_lookup",
    "observe_compile", "complete_compile", "step_begin", "step_end",
    "record_pass", "record_fusion", "record_remat",
    "record_autotune_lookup", "record_autotune_trial",
    "record_watchdog_timeout", "program_cost", "observe_step_cost",
    "observe_serving_cost",
    "recompile_events", "recompile_count", "snapshot", "reset",
    "get_tracker", "build_site",
    "make_lock", "make_rlock", "make_condition", "witness_enabled",
    "witness_report", "witness_edges", "witness_cycles", "reset_witness",
    "numerics_witness_enabled", "numerics_witness_report",
    "numerics_witness_vars", "reset_numerics_witness", "first_offender",
    "containment_violations",
    "parse_prometheus_text", "histogram_snapshot_from_samples",
    "ParsedFamily", "PromParseError",
]

_step_counter = itertools.count()


def enabled() -> bool:
    """Collection master switch (``FLAGS_monitor``, default on)."""
    from ..flags import flag

    return bool(flag("monitor"))


# -- executor instrumentation entry points ---------------------------------
# (called from Executor.run / run_chained; every entry no-ops when
# FLAGS_monitor=0)

def record_cache_lookup(path: str, hit: bool) -> None:
    if not enabled():
        return
    counter("executor_cache_lookups_total",
            "executor key lookups by path and result").labels(
        path=path, result="hit" if hit else "miss").inc()


def observe_compile(path: str, program, components: Dict[str, Any],
                    donated_names=()) -> Optional[CompileRecord]:
    """Record a compile event (the first run of a new executor key):
    compile counters, recompile diagnosis (component diff + build site)
    and the static in-place-state bytes from the program's var shapes.
    Returns the record so the caller can fill stage timings and fire
    ``complete_compile``."""
    if not enabled():
        return None
    serial = int(getattr(program, "_serial", -1))
    rec = get_tracker().observe(path, serial, build_site(program),
                                components)
    counter("executor_compiles_total",
            "compile events: first runs of a new executor key").labels(
        path=path).inc()
    if rec.recompile:
        counter("executor_recompiles_total",
                "compile events of a program that was already compiled "
                "(a new key: feed shape, fetches, flags)").labels(
            path=path).inc()
    try:
        blk = program.global_block
        rec.donated_bytes_est = sum(
            _var_bytes(blk.var(n)) for n in donated_names if blk.has_var(n))
    except Exception:
        pass
    return rec


def _var_bytes(v) -> int:
    """Static bytes of one var at batch 1 (-1/None dims count as 1)."""
    from ..core.types import np_dtype

    if v.shape is None:
        return 0
    try:
        item = int(np_dtype(v.dtype).itemsize)
    except Exception:
        item = 4
    numel = 1
    for d in v.shape:
        d = int(d) if d is not None else -1
        numel *= d if d >= 0 else 1
    return numel * item


def complete_compile(rec: Optional[CompileRecord],
                     trace_lower_s: Optional[float],
                     compile_s: Optional[float]) -> None:
    """Attach stage timings to a compile record, export them, and fire the
    ``on_compile`` hooks. Called once per compile event."""
    if rec is None:
        return
    rec.trace_lower_s = trace_lower_s
    rec.compile_s = compile_s
    if trace_lower_s is not None:
        histogram("executor_compile_seconds",
                  "compile-stage wall time by stage").labels(
            stage="trace_lower").observe(trace_lower_s)
    if compile_s is not None:
        histogram("executor_compile_seconds",
                  "compile-stage wall time by stage").labels(
            stage="xla_compile").observe(compile_s)
    dispatch("compile", rec)


def step_begin(path: str, program) -> Optional[StepRecord]:
    if not enabled():
        return None
    rec = StepRecord(path=path,
                     program_serial=int(getattr(program, "_serial", -1)),
                     step_index=next(_step_counter))
    # non-field stash for the cost model (step_end turns duration +
    # batch_rows into MFU gauges); transient — dies with the record
    rec._program = program
    rec._t0 = time.perf_counter()
    dispatch("step_begin", rec)
    return rec


def step_end(rec: Optional[StepRecord]) -> None:
    if rec is None:
        return
    if rec.duration_s is None and hasattr(rec, "_t0"):
        rec.duration_s = time.perf_counter() - rec._t0
    p = {"path": rec.path}
    counter("executor_steps_total", "executor dispatches").labels(**p).inc()
    if rec.path == "chained":
        counter("executor_chained_iterations_total",
                "scanned iterations inside run_chained dispatches").inc(
            rec.iterations)
    if rec.duration_s is not None:
        histogram("executor_step_seconds",
                  "wall time of one executor dispatch (feed packing + "
                  "device step + state writeback)").labels(**p).observe(
            rec.duration_s)
        prog = getattr(rec, "_program", None)
        if prog is not None and rec.batch_rows:
            observe_step_cost(prog, rec.batch_rows, rec.duration_s,
                              iterations=rec.iterations, path=rec.path)
    if rec.feed_bytes:
        counter("executor_feed_bytes_total",
                "host->device feed transfer bytes").inc(rec.feed_bytes)
    if rec.fetch_bytes:
        counter("executor_fetch_bytes_total",
                "device->host fetch transfer bytes").inc(rec.fetch_bytes)
    if rec.donated_buffers:
        counter("executor_donated_buffers_total",
                "state buffers updated in place").inc(
            rec.donated_buffers)
    if rec.kept_buffers:
        counter("executor_kept_buffers_total",
                "state buffers kept/copied (donation-unsafe)").inc(
            rec.kept_buffers)
    if rec.donated_bytes:
        counter("executor_donated_bytes_total",
                "live bytes of donated buffers").inc(rec.donated_bytes)
    dispatch("step_end", rec)


def record_watchdog_timeout(section: str) -> None:
    """Account one step-watchdog expiry (resilience.distributed); the
    section name is the armed region (compile / step / chained)."""
    if not enabled():
        return
    counter("watchdog_timeouts_total",
            "watchdog deadlines that expired (hangs converted to "
            "diagnosed failures)").labels(section=section).inc()


def record_pass(name: str, kind: str, seconds: float,
                cached: bool = False) -> None:
    """Account one IR-pass execution (analysis.pass_manager): run counts
    by pass/kind/result (``cached`` = the PassContext served the analysis
    from its cache) and wall-time histograms for real runs."""
    if not enabled():
        return
    counter("pass_runs_total",
            "IR pass executions by pass, kind and result (result=cached "
            "means the PassContext analysis cache was hit)").labels(
        **{"pass": name, "kind": kind,
           "result": "cached" if cached else "run"}).inc()
    if not cached:
        histogram("pass_duration_seconds",
                  "wall time of one IR pass execution, by pass").labels(
            **{"pass": name}).observe(seconds)


def record_autotune_lookup(hit: bool, program_fp: str = "",
                           bucket: int = 0,
                           per_step_s: Optional[float] = None) -> None:
    """One executor-path lookup of the autotuner's cost database
    (``tuning.lookup_best``): ``autotune_hits_total`` /
    ``autotune_misses_total``, and on a hit the best-known step time as
    ``autotune_best_per_step_seconds`` by program and bucket."""
    if not enabled():
        return
    counter("autotune_hits_total" if hit else "autotune_misses_total",
            "autotuner compile-path lookups that found (hits) / did not "
            "find (misses) a best-known config").inc()
    if hit and per_step_s is not None:
        gauge("autotune_best_per_step_seconds",
              "best-known measured step time fed to the compile path, by "
              "program fingerprint and shape bucket").labels(
            program=program_fp, bucket=str(bucket)).set(per_step_s)


def record_autotune_trial() -> None:
    """One measured candidate recorded into the cost database
    (``autotune_trials_total``)."""
    if not enabled():
        return
    counter("autotune_trials_total",
            "measured autotuner candidates recorded into the cost "
            "database").inc()


def record_fusion(decision) -> None:
    """Record one FLAGS_epilogue_fusion decision
    (analysis/epilogue_fusion.py FusionDecision): programs transformed vs
    refused, and fused chains by epilogue kind."""
    if not enabled():
        return
    counter("fusion_programs_total",
            "epilogue-fusion decisions by outcome").labels(
        outcome="applied" if decision.applied else "refused").inc()
    if not decision.applied:
        return
    for c in decision.chains:
        counter("fusion_ops_fused_total",
                "GEMM-epilogue chains rewritten into fused_gemm_epilogue, "
                "by epilogue kind").labels(
            epilogue=c.get("epilogue", "?")).inc()


def record_remat(decision) -> None:
    """Record one FLAGS_auto_recompute decision (analysis/remat.py
    RematDecision): how many programs were transformed vs refused, segments
    inserted, and the planner's predicted peak bytes for the plain and
    remat variants."""
    if not enabled():
        return
    counter("remat_programs_total",
            "auto-remat decisions by outcome").labels(
        outcome="applied" if decision.applied else "refused").inc()
    if not decision.applied:
        return
    counter("remat_segments_inserted_total",
            "recompute segments inserted by FLAGS_auto_recompute").inc(
        decision.n_segments)
    gauge("remat_predicted_peak_bytes",
          "memory_plan predicted peak of the last transformed program, "
          "by variant").labels(variant="plain").set(decision.peak_before)
    gauge("remat_predicted_peak_bytes",
          "memory_plan predicted peak of the last transformed program, "
          "by variant").labels(variant="remat").set(decision.peak_after)


# -- cost model: per-(program, batch) FLOPs -> MFU gauges -------------------
# (analysis/cost_model.py: the monitor turns measured step durations into
# model-FLOP utilisation per program and shape bucket. Reports are cached:
# estimation walks the ops once per (program version, batch);
# steady-state steps pay one dict probe.)

_cost_cache: Dict[tuple, Any] = {}
_COST_CACHE_MAX = 64


def program_cost(program, batch: int):
    """The cached ``CostReport`` for ``program`` at ``batch`` rows, or
    ``None`` when estimation failed (never raises into a step)."""
    if not hasattr(program, "blocks"):
        return None
    key = (int(getattr(program, "_serial", -1)),
           int(getattr(program, "_version", 0)), int(batch))
    if key in _cost_cache:
        return _cost_cache[key]
    try:
        from ..analysis.cost_model import estimate_cost

        rep = estimate_cost(program, batch_size=batch)
    except Exception:
        rep = None
    # unlocked bounded eviction: two step threads can race here, so the
    # pop must tolerate the other thread winning ('never raises into a
    # step' is the contract)
    while len(_cost_cache) >= _COST_CACHE_MAX:
        try:
            _cost_cache.pop(next(iter(_cost_cache)), None)
        except (StopIteration, RuntimeError):
            break
    _cost_cache[key] = rep
    return rep


def observe_step_cost(program, batch: int, duration_s: float,
                      iterations: int = 1, path: str = "run"):
    """Turn one measured dispatch into the cost-model gauges:
    ``executor_model_gflops_per_step`` (static, per program+batch),
    ``executor_achieved_tflops`` and ``executor_mfu`` (per path+program+
    batch, against ``FLAGS_device_peak_tflops``). Returns the achieved
    TF/s, or None when disabled/unmeasurable."""
    if not enabled() or not duration_s or duration_s <= 0:
        return None
    rep = program_cost(program, batch)
    if rep is None or rep.flops_total <= 0:
        return None
    from ..flags import flag

    peak = float(flag("device_peak_tflops"))
    achieved = rep.flops_total * max(1, int(iterations)) / duration_s / 1e12
    labels = {"path": path,
              "program": str(int(getattr(program, "_serial", -1))),
              "batch": str(int(batch))}
    gauge("executor_model_gflops_per_step",
          "cost-model FLOPs of one step (GF, 2 FLOPs/MAC) by program "
          "and batch").labels(program=labels["program"],
                              batch=labels["batch"]).set(
        rep.flops_total / 1e9)
    gauge("executor_achieved_tflops",
          "achieved model TF/s of the most recent dispatch, by path/"
          "program/batch").labels(**labels).set(achieved)
    if peak > 0:
        gauge("executor_mfu",
              "model-FLOP utilisation of the most recent dispatch vs "
              "FLAGS_device_peak_tflops").labels(**labels).set(
            achieved / peak)
    return achieved


def observe_serving_cost(program, padded_rows: int, batch_s: float,
                         bucket: str):
    """Serving flavour of :func:`observe_step_cost`: per shape-bucket
    ``serving_bucket_achieved_tflops`` / ``serving_bucket_mfu`` gauges
    from one dispatched batch's wall time."""
    if not enabled() or not batch_s or batch_s <= 0:
        return None
    rep = program_cost(program, padded_rows)
    if rep is None or rep.flops_total <= 0:
        return None
    from ..flags import flag

    peak = float(flag("device_peak_tflops"))
    achieved = rep.flops_total / batch_s / 1e12
    gauge("serving_bucket_achieved_tflops",
          "achieved model TF/s of the most recent batch, per shape "
          "bucket").labels(bucket=bucket).set(achieved)
    if peak > 0:
        gauge("serving_bucket_mfu",
              "model-FLOP utilisation of the most recent batch vs "
              "FLAGS_device_peak_tflops, per shape bucket").labels(
            bucket=bucket).set(achieved / peak)
    return achieved


# -- introspection ---------------------------------------------------------

def recompile_events(recompiles_only: bool = True):
    """Recent compile records (bounded ring; newest last)."""
    return get_tracker().events(recompiles_only=recompiles_only)


def recompile_count(program_serial: Optional[int] = None) -> int:
    return get_tracker().recompile_count(program_serial)


def snapshot() -> dict:
    """One JSON-ready view of everything: metrics + compile/recompile
    events."""
    return {
        "metrics": get_registry().to_dict(),
        "compile_events": [e.to_dict() for e in
                           get_tracker().events()],
        "recompiles_total": get_tracker().recompile_count(),
    }


def reset() -> None:
    """Clear metrics, recompile history and the cost-report cache (hooks
    stay subscribed)."""
    get_registry().reset()
    get_tracker().reset()
    _cost_cache.clear()
