"""FLAGS_* config (counterpart of ``paddle_tpu/flags.py``), the flags the
port reads, under the reference's names, types and defaults. Flags
resolve, in order: explicit ``set_flags`` > ``FLAGS_<name>`` env var >
default."""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["flag", "set_flags", "get_flags"]

# name -> (type, default, meaning)
_DEFS: Dict[str, tuple] = {
    "check_program": (int, 0,
                      "static-verification level (paddle_tpu_torch."
                      "analysis): 0 off; 1 verify each program once before "
                      "its first run (error-severity findings raise "
                      "ProgramVerificationError with the op's build site); "
                      "2 additionally re-run verify_program after every "
                      "transform pass in a PassManager pipeline — a "
                      "transform introducing new errors is refused with "
                      "PassVerificationError naming the pass"),
    "check_nan_inf": (bool, False,
                      "per-op finite checks with op provenance on failure: "
                      "one device-side flag per float op output, stacked "
                      "and read by the host once a step"),
    "numerics_witness": (bool, False,
                         "per-var numeric range taps in every step "
                         "(monitor.numwitness): abs-max/min/max and "
                         "nonfinite counts per float op output, stacked "
                         "and read by the host once a step. Off: no tap "
                         "runs (no hot-path cost)"),
    "nan_inf_policy": (str, "raise",
                       "what a tripped FLAGS_check_nan_inf step does: "
                       "raise (FloatingPointError with op provenance), "
                       "skip (drop the step, roll state back bit-exactly; "
                       "nan_inf_max_consecutive_skips trips escalate), "
                       "zero_grad (skip without escalation — the zero-"
                       "gradient approximation)"),
    "nan_inf_max_consecutive_skips": (int, 5,
                                      "under nan_inf_policy=skip, this many "
                                      "consecutive dropped steps escalate "
                                      "to FloatingPointError (0 disables "
                                      "escalation)"),
    "use_flash_attention": (str, "auto",
                            "attention path: auto (the hand-written CUDA "
                            "kernel on a CUDA tensor, the plain PyTorch "
                            "version on a CPU tensor) or never (the plain "
                            "version everywhere)"),
    "monitor": (bool, True,
                "runtime metrics collection (paddle_tpu_torch.monitor): "
                "executor counters/histograms, step hooks, recompile "
                "diagnostics, serving metrics. Off disables all collection"),
    "lock_witness": (bool, False,
                     "instrument the named framework locks "
                     "(monitor.lockwitness factories): per-thread "
                     "acquisition-order edges, wait/hold histograms and "
                     "runtime lock-order cycle detection. Off: the "
                     "factories return plain threading primitives"),
    "log_compiles": (bool, False,
                     "log every executor compile event (INFO) and "
                     "recompile (WARNING, with the changed cache-key "
                     "component and program build site)"),
    "recompile_warn_threshold": (int, 3,
                                 "warn via logging once a single program "
                                 "has recompiled this many times, even "
                                 "without FLAGS_log_compiles (0 disables)"),
    "fault_plan": (str, "",
                   "deterministic fault-injection schedule, e.g. "
                   "'batch_dispatch:2:RuntimeError,overload:@3:RuntimeError'"
                   " (resilience.faults; the port probes compile, "
                   "device_put, step, hang, enqueue, overload and "
                   "batch_dispatch; the 'hang' action is an interruptible "
                   "stall the step watchdog must break). Empty disables"),
    "fault_seed": (int, 0,
                   "seed for probabilistic fault-plan rules and retry "
                   "jitter: the same plan and seed replay identically"),
    "fault_stall_s": (float, 5.0,
                      "duration of the 'stall' data-plane fault action "
                      "(resilience.faults.stall)"),
    "retry_max_attempts": (int, 3,
                           "attempts (first try included) for transient "
                           "failures at the compile/device_put sites; 1 "
                           "disables retry"),
    "retry_base_delay": (float, 0.05,
                         "first backoff delay in seconds (doubles per "
                         "retry, seeded jitter on top)"),
    "retry_max_delay": (float, 2.0, "backoff delay ceiling in seconds"),
    "retry_timeout": (float, 30.0,
                      "per-site wall-clock retry budget in seconds across "
                      "all attempts (0 = unlimited)"),
    "step_timeout_s": (float, 0.0,
                       "step watchdog (resilience.distributed): arm a "
                       "deadline around the executor's compile and step "
                       "sections; on expiry every thread's stack and the "
                       "last recompile diagnosis are dumped and the section "
                       "raises WatchdogTimeout. A thread inside a CUDA call "
                       "cannot be broken (only Python code can), so that "
                       "case is left to the hard exit. 0 disables"),
    "watchdog_hard_exit": (bool, True,
                           "after a watchdog expiry, if the hung section "
                           "is still armed one extra timeout later, "
                           "os._exit(124) with the diagnosis already on "
                           "stderr. Off: dump and raise only"),
    "trace": (bool, False,
              "structured span tracing (paddle_tpu_torch.trace): request "
              "and step trace-id propagation through serving, executor and "
              "retry, feeding the flight recorder and the Chrome/JSONL "
              "exporters. Off (default) the hot paths pay one memoized "
              "flag read and a no-op singleton"),
    "trace_buffer_size": (int, 4096,
                          "finished spans kept in the bounded trace "
                          "collector (oldest evicted)"),
    "flight_recorder_size": (int, 256,
                             "spans kept in the flight-recorder ring "
                             "dumped into a WatchdogTimeout or BatchFailed "
                             "incident; 0 disables the recorder"),
    "fleet_telemetry": (bool, False,
                        "fleet telemetry plane: when on, request-latency "
                        "observations carry trace-id exemplars into the "
                        "JSON /metrics form and FleetAggregator.start() "
                        "runs its scrape thread. Off (default) is a "
                        "hot-path no-op: no exemplar allocation, no "
                        "scrape thread"),
    "fleet_scrape_interval_s": (float, 1.0,
                                "FleetAggregator scrape interval in "
                                "seconds (per-replica GET /metrics)"),
    # fleet autoscaler (serving/fleet/autoscaler.py). AutoscalerConfig
    # reads these as defaults.
    "serving_autoscale_min_replicas": (int, 1,
                                       "autoscaler floor: scale-in below "
                                       "this many replicas is refused "
                                       "typed at_min_replicas"),
    "serving_autoscale_max_replicas": (int, 4,
                                       "autoscaler ceiling: scale-out "
                                       "above this many replicas is "
                                       "refused typed at_max_replicas"),
    "serving_autoscale_interval_s": (float, 1.0,
                                     "autoscaler control-loop tick "
                                     "interval in seconds"),
    "serving_autoscale_cooldown_s": (float, 30.0,
                                     "minimum seconds between two scale "
                                     "actions (and from a drain start to "
                                     "the next action): decisions inside "
                                     "it are refused typed cooldown"),
    "serving_autoscale_hot_sustain_s": (float, 5.0,
                                        "burn/pressure must be observed "
                                        "continuously for this long "
                                        "before a scale-out fires"),
    "serving_autoscale_calm_sustain_s": (float, 30.0,
                                         "the fleet must be calm (no "
                                         "burn, no pressure) continuously "
                                         "for this long before a drain-"
                                         "based scale-in fires"),
    "serving_autoscale_max_inflight_spawns": (int, 1,
                                              "spawns not yet ready the "
                                              "autoscaler may have in "
                                              "flight; further scale-outs "
                                              "are refused typed "
                                              "spawn_budget_spent"),
    "serving_autoscale_queue_high": (int, 8,
                                     "per-replica queue depth the "
                                     "autoscaler counts as pressure "
                                     "(alongside degraded mode and open "
                                     "breaker buckets)"),
    "aot_cache_dir": (str, "",
                      "warm-start cache directory (paddle_tpu_torch."
                      "aot_cache): each prepared executor step (the "
                      "program after the tuned block triple, auto-remat, "
                      "epilogue fusion and verification) is saved here, "
                      "and later processes load it instead of preparing "
                      "again. Keyed by program content fingerprint, "
                      "fetch list, feed shapes and dtypes, the executor's "
                      "key flags and the torch/CUDA/card/kernel-source "
                      "versions; corrupt or stale entries degrade to a "
                      "cold prepare. Empty disables (default)"),
    "device_peak_tflops": (float, 989.4,
                           "accelerator peak dense TF/s used for the "
                           "cost-model MFU gauges (executor_mfu, "
                           "serving_bucket_mfu); the default is the NVIDIA "
                           "H100 SXM's published dense bf16 tensor-core "
                           "peak. Set it per card (an H100 PCIe is lower)"),
    "ici_gbytes_per_s": (float, 100.0,
                         "effective per-rank link bandwidth (GB/s) "
                         "between data-parallel ranks for the predicted "
                         "comms-vs-compute ratio "
                         "(analysis.cost_model.estimate_comms); set it "
                         "per deployment (NVLink between cards, the host "
                         "for ranks that share one card)"),
    "replica_check_interval": (int, 0,
                               "every N-th data-parallel step, checksum "
                               "the replicated params and optimizer state "
                               "on every rank (two words a var, gathered) "
                               "and trip ReplicaDivergenceError naming the "
                               "first diverged param when ranks disagree. "
                               "0 disables (default)"),
    "replica_divergence_policy": (str, "raise",
                                  "what a detected cross-replica "
                                  "divergence does: raise "
                                  "(ReplicaDivergenceError), or restore "
                                  "(roll back to the last verified "
                                  "checkpoint through the registered "
                                  "recovery walk; contrib.Trainer wires "
                                  "it)"),
    "auto_recompute": (bool, False,
                       "automatic rematerialisation: on Executor.run / "
                       "run_chained, training programs are segmented at "
                       "layer boundaries and gradient-checkpointed "
                       "(analysis/remat.py), with the checkpoint set chosen "
                       "by Program.memory_plan() scoring. Transformed "
                       "programs get their own serial, so executor keys "
                       "never alias remat and plain variants"),
    "remat_budget_mb": (int, 0,
                        "peak-memory target for FLAGS_auto_recompute in "
                        "MiB: the cheapest checkpoint set (fewest "
                        "recomputed ops) whose PREDICTED peak fits is "
                        "chosen; 0 = no budget, sqrt(N) segmentation"),
    "serving_max_batch": (int, 8,
                          "serving: largest padded batch per dispatch; "
                          "shape buckets are powers of two up to this"),
    "serving_queue_depth": (int, 256,
                            "serving admission control: queued requests "
                            "above this are rejected with typed Overloaded"),
    "serving_deadline_s": (float, 0.0,
                           "default per-request deadline in seconds (0: "
                           "none); an expired request settles typed "
                           "DeadlineExceeded"),
    "serving_queue_age_s": (float, 5.0,
                            "serving admission control: when the OLDEST "
                            "queued request is older than this, new "
                            "arrivals are shed as Overloaded (0 disables)"),
    "serving_batch_window_s": (float, 0.0,
                               "how long the dispatcher waits for a "
                               "partially-filled batch to fill before "
                               "dispatching it anyway (0 = dispatch "
                               "whatever is queued)"),
    "serving_breaker_threshold": (int, 3,
                                  "consecutive batch failures that OPEN a "
                                  "shape bucket's circuit breaker (requests "
                                  "for that bucket are then rejected "
                                  "CircuitOpen until a half-open probe "
                                  "succeeds)"),
    "serving_breaker_cooldown_s": (float, 0.5,
                                   "base open->half-open cooldown; each "
                                   "re-open backs off through the "
                                   "resilience.retry schedule"),
    "serving_degrade_after_s": (float, 1.0,
                                "sustained overload pressure for this long "
                                "enters degraded mode: max batch halves "
                                "and sub-priority requests are shed"),
    "serving_recover_after_s": (float, 1.0,
                                "pressure-free time before degraded mode "
                                "restores the full batch ceiling"),
    "serving_degraded_min_priority": (int, 1,
                                      "in degraded mode, requests with "
                                      "priority below this are shed at "
                                      "admission with typed Overloaded"),
    "serving_bisect_depth": (int, 0,
                             "poison-request bisection depth: a failed "
                             "batch whose error is state-safe is "
                             "re-dispatched as bisected halves down to "
                             "this depth, isolating the culprit request "
                             "(typed PoisonRequest, its feed quarantined); "
                             "0 disables"),
    "serving_bisect_quarantine": (int, 64,
                                  "bounded count of poison feed "
                                  "fingerprints remembered per engine "
                                  "(read with bisection only)"),
    "serving_slo_latency_s": (str, "batch:30,standard:1.0,interactive:0.25",
                              "per-priority-class latency objective of the "
                              "SLO burn-rate tracker (serving/slo.py): "
                              "'class:seconds' pairs, comma-separated"),
    "serving_slo_error_budget": (float, 0.01,
                                 "allowed bad-request fraction of the SLO "
                                 "objective; burn rate = observed bad "
                                 "fraction / this budget"),
    "serving_slo_fast_window_s": (float, 60.0,
                                  "fast burn-rate window in seconds"),
    "serving_slo_slow_window_s": (float, 600.0,
                                  "slow burn-rate window in seconds"),
    "serving_tenant_fair_share": (bool, False,
                                  "per-tenant admission fairness: a tenant "
                                  "over its queue quota is shed typed "
                                  "Overloaded(reason=tenant_quota), and the "
                                  "dispatcher anchors batches by weighted "
                                  "fair queueing instead of FIFO"),
    "serving_tenant_weights": (str, "",
                               "'tenant:weight,...' fair-share weights; "
                               "unlisted tenants weigh 1"),
    "serving_tenant_quota_frac": (float, 0.5,
                                  "largest fraction of serving_queue_depth "
                                  "one weight-1 tenant may occupy; weight w "
                                  "scales it w times (capped at the queue)"),
    "epilogue_fusion": (bool, False,
                        "GEMM-epilogue fusion (analysis/epilogue_fusion.py, "
                        "a registered transform pass): Executor.run and "
                        "run_chained rewrite mul/matmul -> bias-add -> "
                        "activation -> residual -> layer_norm chains of a "
                        "forward-only program into fused_gemm_epilogue ops, "
                        "gated by a fidelity witness (a program it cannot "
                        "prove runs untransformed)"),
    "use_fused_gemm": (str, "auto",
                       "fused_gemm_epilogue path: auto (the hand-written "
                       "CUDA kernel on a CUDA tensor when classify_gemm "
                       "takes the shape, the dense replay of the original "
                       "op rules elsewhere), always (the kernel, or its "
                       "plain version on a CPU tensor; a shape the kernel "
                       "does not take raises), never (the dense replay)"),
    "fused_gemm_blocks": (str, "",
                          "fused_gemm_epilogue block sizes as 'm,n,k', one "
                          "of kernels.fused_gemm.COMPILED_BLOCKS; empty "
                          "defers to the autotuner's best-known triple "
                          "(FLAGS_autotune=use|measure) and then the "
                          "compiled default (DEFAULT_BLOCKS). Part of the "
                          "executor key"),
    "autotune": (str, "off",
                 "persistent autotuner (paddle_tpu_torch.tuning): off (no "
                 "DB access), use (the best-known K5 block triple from the "
                 "cost database reaches the run's LowerCtx when "
                 "FLAGS_fused_gemm_blocks is unset; explicit flags still "
                 "win), measure (use + measure_candidates may run trials "
                 "and record them). The reference's other knob, "
                 "FLAGS_xla_options, has no counterpart in a port that "
                 "compiles no program: every candidate's xla_options is {}"),
    "autotune_db": (str, "",
                    "path of the autotuner cost database (JSON, atomic "
                    "rewrite); empty = ~/.cache/paddle_tpu_torch/"
                    "autotune_db.json. Keyed by (program content "
                    "fingerprint, shape bucket, backend); entries from a "
                    "different framework/torch/CUDA version are ignored"),
    "conv_use_nhwc": (str, "auto",
                      "memory format of conv and pool inputs (shapes stay "
                      "logical NCHW): auto (torch.channels_last on a CUDA "
                      "tensor, contiguous NCHW on a CPU tensor), always "
                      "(channels_last), never (contiguous NCHW)"),
}

# flags that take one of a few words
_CHOICES: Dict[str, tuple] = {"autotune": ("off", "use", "measure"),
                              "use_flash_attention": ("auto", "never"),
                              "use_fused_gemm": ("auto", "always", "never"),
                              "conv_use_nhwc": ("auto", "always", "never")}

_overrides: Dict[str, Any] = {}

# bumped on every set_flags call: cheap change detection for hot-path
# callers that memoize a flag value (trace.enabled caches FLAGS_trace
# against it). Env-var changes after the first read are not observed.
_set_epoch = 0


def _value(name: str, raw):
    val = _coerce(_DEFS[name][0], raw)
    if name in _CHOICES and val not in _CHOICES[name]:
        raise ValueError(f"FLAGS_{name}={val!r}: takes one of "
                         f"{_CHOICES[name]}")
    return val


def _coerce(typ, raw):
    if typ is bool:
        if isinstance(raw, (int, float, bool)):
            return bool(raw)
        s = str(raw).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"not a boolean flag value: {raw!r}")
    return typ(raw)


def flag(name: str):
    """Current value of one flag."""
    if name not in _DEFS:
        raise KeyError(f"unknown flag '{name}' — known: {sorted(_DEFS)}")
    if name in _overrides:
        return _overrides[name]
    typ, default, _ = _DEFS[name]
    raw = os.environ.get(f"FLAGS_{name}")
    return default if raw is None else _value(name, raw)


def get_flags(names=None) -> Dict[str, Any]:
    """``{'FLAGS_<name>': value}`` for ``names`` (one name, a list, or
    None for every flag)."""
    if names is None:
        names = list(_DEFS)
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{n}": flag(n) for n in (x.replace("FLAGS_", "")
                                            for x in names)}


def set_flags(flags_dict: Dict[str, Any]) -> None:
    """``set_flags({'FLAGS_use_flash_attention': 'never'})``."""
    global _set_epoch
    for k, v in flags_dict.items():
        name = k.replace("FLAGS_", "")
        if name not in _DEFS:
            raise KeyError(f"unknown flag '{k}' — known: "
                           f"{sorted('FLAGS_' + n for n in _DEFS)}")
        _overrides[name] = _value(name, v)
    _set_epoch += 1
