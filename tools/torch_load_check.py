#!/usr/bin/env python
"""Serving load generator + CI robustness gate of the PyTorch port
(``paddle_tpu_torch.serving``; counterpart of tools/load_check.py, with
its legs, checks, artifacts and negative controls).

Everything runs on ``CUDAPlace(0)`` unless ``--device cpu`` asks for the
CPU (the CPU tests do); replica processes get the same device through
``--device`` / ``SupervisorConfig.device``. A missing card is an error,
never a fall-back to the CPU.

Drives ResNet-tiny and BERT-tiny inference traffic through a
:class:`ServingEngine` from concurrent submitter threads, then a CHAOS leg
that injects overload pressure, transient compile faults and one
slow-batch hang (armed under the step watchdog). The gate proves the
serving contract end to end:

* **exact accounting** — every submitted request reaches exactly one
  terminal outcome (response or typed rejection); zero silent drops, on
  every leg including chaos;
* **shedding works** — under overload pressure admission control sheds
  with typed ``Overloaded`` (the chaos leg requires ``shed > 0``);
* **faults are absorbed or isolated** — injected transient compile
  faults are retried away (``resilience_retries_total`` grows); the hang
  dies diagnosed under the watchdog (``watchdog_timeouts_total`` grows,
  the batch fails typed, the engine keeps serving);
* **SLOs are measurable** — the JSON artifact carries the full
  ``serving_request_latency_seconds`` histogram with estimated p50/p99.

Every leg takes the engine factory it drives (``make_engine``), so
``chip_smoke.py`` runs the same legs over full-width engines; the
factories here are the tiny CI probes.

Usage:
  python tools/torch_load_check.py --ci --device cpu --json report.json
      CI gate: tiny probes; exit 1 on any missed requirement.
  python tools/torch_load_check.py --ci --device cpu --negative-control
      Disables admission control (unbounded queue, no age bound) and
      re-runs the overload leg: with shedding off the gate MUST fail
      (``shed == 0`` under pressure) — CI asserts the non-zero exit.
  --decode, --fleet, --fleet-chaos, --autoscale select the generative,
  multi-process fleet, fleet self-healing and fleet control-loop legs
  (each with its own --negative-control); --lock-witness adds the
  runtime lock-order gate against the port's static graph.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import monitor, serving  # noqa: E402
from paddle_tpu_torch.resilience import fault_plan_guard  # noqa: E402

# where engines and replica processes run: "cuda" (CUDAPlace(0)) unless
# --device cpu asks for the CPU
_DEVICE = "cuda"


def set_device(device: str) -> None:
    """Run the probes and replica processes on ``"cuda"`` or ``"cpu"``."""
    global _DEVICE
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r} (cuda or cpu)")
    _DEVICE = device


def _executor():
    return fluid.Executor(fluid.CPUPlace() if _DEVICE == "cpu"
                          else fluid.CUDAPlace(0))


# ---------------------------------------------------------------------------
# model probes
# ---------------------------------------------------------------------------

def _resnet_engine(ci: bool, config: serving.ServingConfig):
    from paddle_tpu_torch.models.resnet import build_resnet
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        shape = (3, 16, 16) if ci else (3, 32, 32)
        net = build_resnet(depth=18, class_num=10, image_shape=shape,
                           build_optimizer=False)
        infer = net["main"].clone(for_test=True)
    exe = _executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(net["startup"], scope=scope)
    eng = serving.ServingEngine(
        infer, feed_names=["img", "label"],
        fetch_list=[net["logits"].name], scope=scope, executor=exe,
        config=config)

    def feed(rows=1, seed=0):
        rng = np.random.RandomState(seed)
        return {"img": rng.rand(rows, *shape).astype(np.float32),
                "label": np.zeros((rows, 1), np.int64)}

    return eng, feed


def _bert_engine(ci: bool, config: serving.ServingConfig):
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        seq = 16 if ci else 32
        net = build_bert_pretrain(BertConfig.tiny(), seq_len=seq,
                                  build_optimizer=False, is_test=True)
        infer = net["main"].clone(for_test=True)
    exe = _executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(net["startup"], scope=scope)
    eng = serving.ServingEngine(
        infer, feed_names=list(net["feeds"]),
        fetch_list=[net["loss"].name], scope=scope, executor=exe,
        config=config)

    def feed(rows=1, seed=0):
        rng = np.random.RandomState(seed)
        return {
            "src_ids": rng.randint(0, 1024, (rows, seq)).astype(np.int64),
            "pos_ids": np.tile(np.arange(seq, dtype=np.int64), (rows, 1)),
            "sent_ids": np.zeros((rows, seq), np.int64),
            "input_mask": np.ones((rows, seq), np.float32),
            "mask_label": np.full((rows, seq), -100, np.int64),
            "next_sent_label": np.zeros((rows, 1), np.int64),
        }

    return eng, feed


def _gpt_engine(ci: bool, config: serving.ServingConfig,
                gen_config=None, **net_kw):
    """GPT-tiny generative engine (prefill/decode split scheduling over a
    paged KV cache) — the --decode legs' probe. ``net_kw`` overrides the
    model-build knobs (the speculative leg uses a longer KV + k=8)."""
    from paddle_tpu_torch.models.gpt import GptConfig, build_gpt_generative
    import paddle_tpu_torch.unique_name as un

    kw = dict(batch_slots=4, max_seq=32, page_size=8,
              prompt_buckets=(8, 16))
    kw.update(net_kw)
    with un.guard():
        net = build_gpt_generative(GptConfig.tiny(), **kw)
    exe = _executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(net["startup"], scope=scope)
    eng = serving.GenerativeEngine(
        net, scope=scope, executor=exe, config=config,
        gen_config=gen_config or serving.GenerationConfig(decode_chunk=2))
    return eng


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

def _drive(eng, feed_fn, n_requests, n_threads, rows_cycle=(1, 2),
           deadline_s=None, stagger_s=0.0):
    """Submit ``n_requests`` from ``n_threads`` threads and wait for every
    terminal outcome. Returns per-outcome counts as seen by CALLERS —
    cross-checked against the engine's own ledger by the gate."""
    seen = {"completed": 0, "overloaded": 0, "deadline": 0,
            "batch_failed": 0, "circuit_open": 0, "injected": 0,
            "stopped": 0, "other_error": 0}
    lock = threading.Lock()
    futures = []

    def note(key):
        with lock:
            seen[key] += 1

    def submitter(tid):
        for i in range(tid, n_requests, n_threads):
            rows = rows_cycle[i % len(rows_cycle)]
            try:
                fut = eng.submit(feed_fn(rows=rows, seed=i),
                                 deadline_s=deadline_s,
                                 priority=i % 3)
                with lock:
                    futures.append(fut)
            except serving.Overloaded:
                note("overloaded")
            except serving.EngineStopped:
                note("stopped")
            except Exception as e:
                from paddle_tpu_torch.resilience.faults import InjectedFault

                note("injected" if isinstance(e, InjectedFault)
                     else "other_error")
            if stagger_s:
                time.sleep(stagger_s)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    for fut in futures:
        err = fut.exception(timeout=600)
        if err is None:
            note("completed")
        elif isinstance(err, serving.DeadlineExceeded):
            note("deadline")
        elif isinstance(err, serving.BatchFailed):
            note("batch_failed")
        elif isinstance(err, serving.CircuitOpen):
            note("circuit_open")
        elif isinstance(err, serving.EngineStopped):
            note("stopped")
        else:
            note("other_error")
    seen["submitted"] = n_requests
    seen["terminal"] = sum(v for k, v in seen.items()
                           if k not in ("submitted", "terminal"))
    return seen


def _latency_snapshot():
    snap = monitor.metric_value("serving_request_latency_seconds",
                                default=None)
    if not isinstance(snap, dict):
        return None
    return snap


# ---------------------------------------------------------------------------
# legs
# ---------------------------------------------------------------------------

def leg_steady(name, make_engine, ci):
    cfg = serving.ServingConfig(max_batch=4, queue_depth=64,
                                batch_window_s=0.01)
    eng, feed = make_engine(ci, cfg)
    eng.warm_up()
    n = 24 if ci else 96
    with eng:
        seen = _drive(eng, feed, n_requests=n, n_threads=3)
    acct = eng.accounting()
    ok = (acct["exact"] and seen["terminal"] == seen["submitted"]
          and seen["completed"] == n and acct["shed"] == 0
          and acct["failed"] == 0 and acct["deadline_exceeded"] == 0)
    return {"name": name, "ok": ok, "requests": n, "caller_view": seen,
            "engine_accounting": acct,
            "why": "all requests completed, zero sheds/failures "
                   "(negative control for the chaos leg)"}


def leg_chaos(name, make_engine, ci, shedding=True):
    """Overload + transient compile faults + one watchdog-diagnosed hang.
    ``shedding=False`` is the --negative-control variant: admission
    control is effectively disabled, so the gate's ``shed > 0``
    requirement MUST fail."""
    retries0 = monitor.metric_value("resilience_retries_total", 0.0,
                                    site="compile")
    wd0 = monitor.metric_value("watchdog_timeouts_total", 0.0,
                               section="step")
    cfg = serving.ServingConfig(
        max_batch=4,
        queue_depth=8 if shedding else 100_000,
        queue_age_s=5.0 if shedding else 0.0,
        degrade_after_s=0.2 if shedding else 1e9,
        recover_after_s=0.2, degraded_min_priority=1,
        breaker_threshold=3, breaker_cooldown_s=0.2)
    eng, feed = make_engine(ci, cfg)
    # transient compile faults during warm-up: the retry/backoff at the
    # compile site must absorb them (no caller ever sees one)
    with fault_plan_guard("compile:2:RuntimeError"):
        eng.warm_up()
    fluid.set_flags({"FLAGS_step_timeout_s": 2.0,
                     "FLAGS_watchdog_hard_exit": 0})
    n = 48 if ci else 160
    try:
        # one slow-batch hang (watchdog must break it, typed) + synthetic
        # overload pressure on top of the real burst
        plan = "hang:@2:hang" + (",overload:2:RuntimeError"
                                 if shedding else "")
        with eng, fault_plan_guard(plan):
            seen = _drive(eng, feed, n_requests=n, n_threads=4,
                          deadline_s=8.0)
    finally:
        fluid.set_flags({"FLAGS_step_timeout_s": 0.0})
    acct = eng.accounting()
    retries = monitor.metric_value("resilience_retries_total", 0.0,
                                   site="compile") - retries0
    wd = monitor.metric_value("watchdog_timeouts_total", 0.0,
                              section="step") - wd0
    shed_total = acct["shed"]
    checks = {
        "exact_accounting": bool(acct["exact"]),
        "every_submit_terminal": seen["terminal"] == seen["submitted"],
        "no_untyped_errors": seen["other_error"] == 0,
        "progress_under_chaos": seen["completed"] > 0,
        "hang_died_diagnosed": wd >= 1,
        "hang_batch_failed_typed": acct["failed"] >= 1,
        "compile_faults_retried": retries >= 2,
        "overload_was_shed": shed_total > 0,
        "engine_still_healthy": acct["pending"] == 0,
    }
    return {"name": name, "ok": all(checks.values()), "requests": n,
            "caller_view": seen, "engine_accounting": acct,
            "checks": checks,
            "watchdog_timeouts": wd, "compile_retries": retries,
            "why": "typed outcomes for 100% of submissions under "
                   "overload + compile faults + a watchdog-broken hang"}


def _drive_generate(eng, n_requests, n_threads, deadline_s=None,
                    seed=0):
    """Submit ``n_requests`` generation prompts from ``n_threads`` threads
    and wait for every terminal outcome. Returns caller-side outcome
    counts plus the expected/streamed token totals."""
    seen = {"completed": 0, "overloaded": 0, "deadline": 0,
            "batch_failed": 0, "stopped": 0, "injected": 0,
            "other_error": 0, "tokens_expected": 0, "tokens_streamed": 0}
    lock = threading.Lock()
    futures = []

    def note(key, n=1):
        with lock:
            seen[key] += n

    def submitter(tid):
        rng = np.random.RandomState(seed + tid)
        for i in range(tid, n_requests, n_threads):
            plen = 3 + (i % 10)
            max_new = 2 + (i % 5)
            try:
                fut = eng.submit(rng.randint(1, 128, plen),
                                 max_new_tokens=max_new,
                                 deadline_s=deadline_s, priority=i % 3)
                with lock:
                    futures.append((fut, max_new))
            except serving.Overloaded:
                note("overloaded")
            except serving.EngineStopped:
                note("stopped")
            except Exception as e:
                from paddle_tpu_torch.resilience.faults import InjectedFault

                note("injected" if isinstance(e, InjectedFault)
                     else "other_error")

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    for fut, max_new in futures:
        err = fut.exception(timeout=600)
        note("tokens_streamed", len(fut.tokens()))
        if err is None:
            note("completed")
            note("tokens_expected", max_new)
            assert len(fut.result()[0]) == max_new
        elif isinstance(err, serving.DeadlineExceeded):
            note("deadline")
        elif isinstance(err, serving.BatchFailed):
            note("batch_failed")
        elif isinstance(err, serving.EngineStopped):
            note("stopped")
        else:
            note("other_error")
    seen["submitted"] = n_requests
    seen["terminal"] = sum(v for k, v in seen.items()
                           if k in ("completed", "overloaded", "deadline",
                                    "batch_failed", "stopped", "injected",
                                    "other_error"))
    return seen


def _decode_metrics(t_wall):
    toks = monitor.metric_value("serving_decode_tokens_total", 0.0)
    it = monitor.metric_value("serving_intertoken_seconds", default=None)
    out = {"tokens_total": toks,
           "tokens_per_s": (toks / t_wall) if t_wall > 0 else None}
    if isinstance(it, dict):
        out["intertoken_p50_ms"] = (it["p50"] or 0.0) * 1e3
        out["intertoken_p99_ms"] = (it["p99"] or 0.0) * 1e3
        out["intertoken_count"] = it["count"]
    return out


def leg_decode(name, ci, make_engine=None, buckets=4):
    """GPT-tiny generation burst from multiple threads: every stream
    completes with exact per-stream accounting, one executable per
    (phase, bucket) — zero warm recompiles — and tokens/s + inter-token
    p50/p99 land in the artifact. ``buckets``: the (phase, bucket) count
    ``make_engine``'s model has (the GPT-tiny probe's 4)."""
    cfg = serving.ServingConfig(max_batch=4, queue_depth=64, deadline_s=0)
    eng = (make_engine or _gpt_engine)(ci, cfg)
    eng.warm_up()
    n = 12 if ci else 48
    t0 = time.time()
    with eng:
        seen = _drive_generate(eng, n_requests=n, n_threads=3)
    t_wall = time.time() - t0
    acct = eng.accounting()
    stats = eng.generation_stats()
    metrics = _decode_metrics(t_wall)
    checks = {
        "exact_accounting": bool(acct["exact"]),
        "every_submit_terminal": seen["terminal"] == seen["submitted"],
        "all_completed": seen["completed"] == n,
        "token_counts_exact":
            seen["tokens_streamed"] == seen["tokens_expected"],
        "no_untyped_errors": seen["other_error"] == 0,
        "zero_warm_recompiles": stats["decode_recompiles"] == 0,
        # the probe's prefill:8 + prefill:16 + decode:4 + chunk:8 (the
        # chunked-prefill program is on by default)
        "one_executable_per_phase_bucket":
            len(stats["compiled_buckets"]) == buckets,
        "intertoken_histogram_present":
            metrics.get("intertoken_count", 0) > 0,
    }
    return {"name": name, "ok": all(checks.values()), "requests": n,
            "caller_view": seen, "engine_accounting": acct,
            "checks": checks, "generation": stats, "decode": metrics,
            "why": "multi-thread generation burst: exact accounting, "
                   "bounded compiles, streaming SLO metrics"}


def leg_decode_chaos(name, ci, make_engine=None):
    """Kill one in-flight decode/prefill batch (injected batch_dispatch
    fault): every affected stream must settle with a typed outcome, the
    engine keeps serving, accounting stays exact."""
    cfg = serving.ServingConfig(max_batch=4, queue_depth=64, deadline_s=0)
    eng = (make_engine or _gpt_engine)(ci, cfg)
    eng.warm_up()
    n = 12 if ci else 32
    t0 = time.time()
    with eng:
        with fault_plan_guard("batch_dispatch:@3:RuntimeError"):
            seen = _drive_generate(eng, n_requests=n, n_threads=3, seed=7)
        # the engine must keep serving AFTER the killed batch
        post = eng.submit(np.array([3, 1, 4]), max_new_tokens=3)
        post_ok = len(post.result(timeout=600)[0]) == 3
    t_wall = time.time() - t0
    acct = eng.accounting()
    checks = {
        "exact_accounting": bool(acct["exact"]),
        "every_submit_terminal": seen["terminal"] == seen["submitted"],
        "no_untyped_errors": seen["other_error"] == 0,
        "killed_batch_settled_typed": seen["batch_failed"] >= 1,
        "progress_under_chaos": seen["completed"] > 0,
        "engine_serves_after_kill": post_ok,
        "engine_drained": acct["pending"] == 0,
    }
    return {"name": name, "ok": all(checks.values()), "requests": n,
            "caller_view": seen, "engine_accounting": acct,
            "checks": checks, "decode": _decode_metrics(t_wall),
            "why": "one in-flight batch killed: affected streams settle "
                   "typed BatchFailed, engine keeps serving"}


def _first_token_snap():
    s = monitor.metric_value("serving_first_token_seconds", default=None)
    return (s["count"], s["sum"]) if isinstance(s, dict) else (0, 0.0)


def leg_decode_prefix(name, ci, enabled=True):
    """Shared-prefix burst: a cold group of distinct long
    prompts, then a warm group repeating one 24-token prefix. Warm
    requests must HIT the prefix cache (skipping prefill for the shared
    pages — one suffix chunk slice instead of four cold slices) and
    show a lower average first-token latency than the cold group.
    ``enabled=False`` is the --negative-control variant: with the cache
    off the hit counters MUST stay zero, so the gate fails."""
    cfg = serving.ServingConfig(max_batch=4, queue_depth=64, deadline_s=0)
    gen = serving.GenerationConfig(decode_chunk=2, prefix_cache=enabled,
                                   chunked_prefill=True)
    eng = _gpt_engine(ci, cfg, gen_config=gen)
    eng.warm_up()
    rng = np.random.RandomState(20)
    shared = rng.randint(1, 128, 24)       # 3 whole 8-row pages
    n = 4 if ci else 12
    with eng:
        c0, s0 = _first_token_snap()
        for _ in range(n):                 # cold: distinct prefixes
            p = np.concatenate([rng.randint(1, 128, 24),
                                rng.randint(1, 128, 6)])
            eng.submit(p, max_new_tokens=2).result(timeout=600)
        c1, s1 = _first_token_snap()
        # seed publishes the shared pages, then the warm group hits them
        eng.submit(np.concatenate([shared, rng.randint(1, 128, 6)]),
                   max_new_tokens=2).result(timeout=600)
        c2, s2 = _first_token_snap()
        for _ in range(n):
            p = np.concatenate([shared, rng.randint(1, 128, 6)])
            eng.submit(p, max_new_tokens=2).result(timeout=600)
        c3, s3 = _first_token_snap()
    acct = eng.accounting()
    stats = eng.generation_stats()
    pc = stats["prefix_cache"] or {"hits": 0, "misses": max(1, 2 * n + 1),
                                   "pages_reused": 0, "pages": 0}
    hit_ratio = pc["hits"] / max(1, pc["hits"] + pc["misses"])
    cold_ms = (s1 - s0) / max(1, c1 - c0) * 1e3
    warm_ms = (s3 - s2) / max(1, c3 - c2) * 1e3
    ft = monitor.metric_value("serving_first_token_seconds", default=None)
    report = {
        "prefix_hit_ratio": hit_ratio,
        "prefix_hits": pc["hits"], "prefix_misses": pc["misses"],
        "pages_reused": pc["pages_reused"], "pages_resident": pc["pages"],
        "first_token_p50_ms":
            (ft["p50"] or 0.0) * 1e3 if isinstance(ft, dict) else None,
        "first_token_p99_ms":
            (ft["p99"] or 0.0) * 1e3 if isinstance(ft, dict) else None,
        "cold_first_token_avg_ms": cold_ms,
        "warm_first_token_avg_ms": warm_ms,
        "warm_speedup": (cold_ms / warm_ms) if warm_ms > 0 else None,
    }
    checks = {
        "exact_accounting": bool(acct["exact"]),
        "prefix_hits_positive": pc["hits"] >= n,
        "shared_pages_reused": pc["pages_reused"] >= 3 * n,
        "first_token_p99_reported":
            report["first_token_p99_ms"] is not None,
        "warm_first_token_faster_than_cold": warm_ms < cold_ms,
        "zero_warm_recompiles": stats["decode_recompiles"] == 0,
    }
    return {"name": name, "ok": all(checks.values()), "requests": 2 * n + 1,
            "caller_view": {"submitted": 2 * n + 1,
                            "completed": acct["completed"]},
            "engine_accounting": acct, "checks": checks,
            "generation": stats, "prefix": report,
            "why": "repeated 24-token prefix provably skips prefill for "
                   "the shared pages: hit counters + first-token delta"}


def leg_decode_spec(name, ci, enabled=True):
    """Speculative-decoding leg: the same greedy prompt set
    through a plain engine and a speculative engine. Gates: bit-exact
    streams, >= 1.5x tokens/s, acceptance histogram present.
    ``enabled=False`` is the --negative-control variant: with
    speculation off no acceptance histogram may exist, so the gate
    fails."""
    n = 6 if ci else 12
    max_new = 56

    def run(speculative):
        cfg = serving.ServingConfig(max_batch=4, queue_depth=64,
                                    deadline_s=0)
        gen = serving.GenerationConfig(
            decode_chunk=2, prefix_cache=False, chunked_prefill=False,
            speculative=speculative)
        # longer KV + k=8 (the full sublane tile): a fully accepted
        # verify chunk commits 8 tokens in ONE dispatch vs 2 for a plain
        # decode chunk, and 56-token streams amortize prefill overhead
        eng = _gpt_engine(ci, cfg, gen_config=gen, max_seq=128,
                          prompt_buckets=(8,), spec_k=8)
        eng.warm_up()
        rng = np.random.RandomState(5)
        prompts = [rng.randint(1, 128, 4 + i % 5) for i in range(n)]
        best_tps, outs = 0.0, []
        with eng:
            # one stream at a time: decode is latency-bound, the win is
            # tokens-per-dispatch (verify commits up to k+1 per chunk).
            # Best-of-two passes: greedy streams are deterministic, so
            # the repeat only de-noises the wall clock
            for _ in range(2):
                outs, t0 = [], time.time()
                for p in prompts:
                    outs.append(list(
                        eng.submit(p, max_new_tokens=max_new)
                        .result(timeout=600)[0]))
                wall = time.time() - t0
                toks = sum(len(o) for o in outs)
                best_tps = max(best_tps,
                               toks / wall if wall > 0 else 0.0)
        return eng, outs, best_tps

    plain_eng, plain_out, plain_tps = run(False)
    spec_eng, spec_out, spec_tps = run(enabled)
    acct = spec_eng.accounting()
    stats = spec_eng.generation_stats()
    accepted = monitor.metric_value("serving_spec_accepted_len",
                                    default=None)
    speedup = (spec_tps / plain_tps) if plain_tps > 0 else 0.0
    report = {
        "bit_exact": spec_out == plain_out,
        "tokens_per_s_plain": plain_tps,
        "tokens_per_s_spec": spec_tps,
        "speedup": speedup,
        "verify_chunks": stats["speculative"]["chunks"],
        "accepted_tokens": stats["speculative"]["accepted_tokens"],
        "accepted_len_avg":
            accepted["avg"] if isinstance(accepted, dict) else None,
        "accepted_len_p50":
            accepted["p50"] if isinstance(accepted, dict) else None,
    }
    checks = {
        "exact_accounting":
            bool(acct["exact"] and plain_eng.accounting()["exact"]),
        "greedy_bit_exact": report["bit_exact"],
        "speedup_at_least_1_5x": speedup >= 1.5,
        "acceptance_histogram_present": isinstance(accepted, dict)
            and accepted["count"] > 0,
        "zero_warm_recompiles": stats["decode_recompiles"] == 0
            and plain_eng.generation_stats()["decode_recompiles"] == 0,
    }
    return {"name": name, "ok": all(checks.values()), "requests": 4 * n,
            "caller_view": {"submitted": 4 * n,
                            "completed": acct["completed"]
                            + plain_eng.accounting()["completed"]},
            "engine_accounting": acct, "checks": checks,
            "generation": stats, "spec": report,
            "why": "greedy speculative decode bit-exact vs plain with "
                   ">=1.5x tokens/s (accept-verify in one dispatch)"}


# ---------------------------------------------------------------------------
# fleet legs (--fleet): multi-PROCESS replicas + router + warm start
# ---------------------------------------------------------------------------

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _replica_env():
    """Subprocess env for a replica: no inherited fault plans, watchdog
    deadline or warm-start cache dir (the cache under test is the one
    passed with ``--aot-cache``), and nothing that points the replica at
    another device than ``--device``: a CPU replica sees no card, and a
    CUDA replica does not inherit a parent's empty device list."""
    env = dict(os.environ)
    for k in ("FLAGS_fault_plan", "FLAGS_fault_seed", "FLAGS_aot_cache_dir",
              "FLAGS_step_timeout_s"):
        env.pop(k, None)
    if _DEVICE == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif env.get("CUDA_VISIBLE_DEVICES", "x").strip() in ("", "-1"):
        env.pop("CUDA_VISIBLE_DEVICES")
    return env


class _ReplicaProc:
    """One replica subprocess: spawn, parse the ready/exit stdout
    events, SIGTERM-drain, reap."""

    def __init__(self, model: str, replica_id: str, aot_dir: str = "",
                 log_dir: str = ".", extra_args=()):
        cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.fleet.replica",
               "--model", model, "--replica-id", replica_id,
               "--queue-depth", "256", "--device", _DEVICE]
        if aot_dir:
            cmd += ["--aot-cache", aot_dir]
        cmd += list(extra_args)
        self.replica_id = replica_id
        self.log_path = os.path.join(log_dir, f"replica_{replica_id}.log")
        self._log = open(self.log_path, "w")
        self.t_spawn = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=self._log, text=True,
                                     cwd=_REPO_ROOT, env=_replica_env())
        self.ready_info = None
        self.exit_info = None
        self.wall_to_ready = None
        self._ready_ev = threading.Event()
        threading.Thread(target=self._reader, daemon=True).start()

    def _reader(self):
        for line in self.proc.stdout:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if obj.get("event") == "ready":
                self.wall_to_ready = time.perf_counter() - self.t_spawn
                self.ready_info = obj
                self._ready_ev.set()
            elif obj.get("event") == "exit":
                self.exit_info = obj

    def wait_ready(self, timeout: float = 240.0):
        if not self._ready_ev.wait(timeout):
            raise RuntimeError(
                f"replica {self.replica_id} did not become ready within "
                f"{timeout:g}s (see {self.log_path})")
        return self.ready_info

    @property
    def port(self) -> int:
        return int(self.ready_info["port"])

    def sigterm(self):
        self.proc.send_signal(signal.SIGTERM)

    def wait_exit(self, timeout: float = 60.0) -> int:
        rc = self.proc.wait(timeout)
        self._log.close()
        return rc

    def destroy(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        if not self._log.closed:
            self._log.close()


def _drive_fleet(router, feed_fn, n_requests, n_threads,
                 kill_at=None, kill_fn=None):
    """Submit ``n_requests`` through the ROUTER from ``n_threads``
    threads; after ``kill_at`` submissions have started, fire
    ``kill_fn`` (the mid-burst SIGTERM). Returns caller-side outcome
    counts — cross-checked against the router's fleet-wide ledger."""
    from paddle_tpu_torch.serving.fleet import ReplicaLost

    seen = {"completed": 0, "shed": 0, "deadline": 0, "failed": 0,
            "circuit_open": 0, "stopped": 0, "replica_lost": 0,
            "other_error": 0}
    lock = threading.Lock()
    started = [0]
    started_ev = threading.Event()

    def note(key):
        with lock:
            seen[key] += 1

    def submitter(tid):
        for i in range(tid, n_requests, n_threads):
            with lock:
                started[0] += 1
                if kill_at is not None and started[0] >= kill_at:
                    started_ev.set()
            try:
                router.submit(feed_fn(rows=1, seed=i), priority=i % 3)
                note("completed")
            except ReplicaLost:
                note("replica_lost")
            except serving.Overloaded:
                note("shed")
            except serving.DeadlineExceeded:
                note("deadline")
            except serving.BatchFailed:
                note("failed")
            except serving.CircuitOpen:
                note("circuit_open")
            except serving.EngineStopped:
                note("stopped")
            except Exception:
                note("other_error")

    killer = None
    if kill_fn is not None:
        def _killer():
            started_ev.wait(300)
            kill_fn()
        killer = threading.Thread(target=_killer, daemon=True)
        killer.start()
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if killer is not None:
        killer.join(60)
    seen["submitted"] = n_requests
    seen["terminal"] = sum(v for k, v in seen.items()
                           if k not in ("submitted", "terminal"))
    return seen


def _mlp_feed(rows=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(rows, 784).astype(np.float32),
            "label": np.zeros((rows, 1), np.int64)}


def leg_fleet(name, ci, log_dir="."):
    """The 2-replica fleet gate: r0 starts COLD and populates the
    warm-start cache; r1 starts from it WARM (the measured cold-vs-warm
    pair). Both serve a multi-thread burst through the router; r0 is
    SIGTERMed mid-burst — it drains everything it admitted (typed, exact)
    while the router routes away and retries only unadmitted dispatches
    on r1. Requirements: exact fleet-wide accounting, zero untyped
    errors, zero admitted-request losses, a clean victim exit, and a
    warm start whose every step comes from the cache."""
    from paddle_tpu_torch.serving.fleet import FleetRouter, Replica

    aot_dir = tempfile.mkdtemp(prefix="paddle_tpu_fleet_aot_")
    r0 = r1 = None
    try:
        r0 = _ReplicaProc("mlp_tiny", "r0", aot_dir, log_dir)
        cold = dict(r0.wait_ready())
        r1 = _ReplicaProc("mlp_tiny", "r1", aot_dir, log_dir)
        warm = dict(r1.wait_ready())

        router = FleetRouter([Replica("r0", "127.0.0.1", r0.port),
                              Replica("r1", "127.0.0.1", r1.port)])
        n = 36 if ci else 120
        with router:
            seen = _drive_fleet(router, _mlp_feed, n_requests=n,
                                n_threads=4, kill_at=n // 3,
                                kill_fn=r0.sigterm)
            acct = router.accounting()
        rc = r0.wait_exit(60)
        victim = r0.exit_info or {}
        vacct = victim.get("accounting", {})
        r1.sigterm()
        r1.wait_exit(60)
        survivor = (r1.exit_info or {}).get("accounting", {})

        lat = monitor.metric_value("router_request_seconds", default=None)
        cold_cache = cold.get("aot_cache", {})
        warm_cache = warm.get("aot_cache", {})
        checks = {
            "exact_fleet_accounting": bool(acct["exact"]),
            "every_submit_terminal": seen["terminal"] == seen["submitted"],
            "all_completed": seen["completed"] == n,
            "no_untyped_errors": seen["other_error"] == 0,
            "nothing_admitted_lost":
                seen["replica_lost"] == 0 and seen["stopped"] == 0
                and seen["failed"] == 0,
            "victim_exit_clean": rc == 0 and bool(vacct.get("exact"))
                and vacct.get("pending", -1) == 0,
            "victim_shed_nothing_admitted":
                vacct.get("shed", -1) == 0 and vacct.get("failed", -1) == 0,
            "victim_served_before_drain": vacct.get("completed", 0) > 0,
            "survivor_served": survivor.get("completed", 0) > 0,
            "latency_histogram_present":
                isinstance(lat, dict) and lat["count"] > 0
                and lat["p50"] is not None and lat["p99"] is not None,
            # warm start: the cold replica fills the cache, the second
            # one prepares every step from it. The port's cached step
            # saves the preparation (passes, verification), not a compile,
            # which on the probe is milliseconds against seconds of process
            # start: the cold/warm times are reported, not gated
            "cold_populated_cache": cold_cache.get("hits") == 0
                and cold_cache.get("saves", 0) >= 1,
            "warm_loaded_from_cache": warm_cache.get("hits", 0) >= 1
                and warm_cache.get("misses", 1) == 0,
        }
        warmstart = {
            "cold": {"time_to_ready_s": cold["time_to_ready_s"],
                     "warm_up_s": cold["warm_up_s"],
                     "wall_to_ready_s": r0.wall_to_ready,
                     "aot_cache": cold_cache},
            "warm": {"time_to_ready_s": warm["time_to_ready_s"],
                     "warm_up_s": warm["warm_up_s"],
                     "wall_to_ready_s": r1.wall_to_ready,
                     "aot_cache": warm_cache},
            "ready_speedup":
                cold["time_to_ready_s"] / max(warm["time_to_ready_s"],
                                              1e-9),
            "warm_up_speedup":
                cold["warm_up_s"] / max(warm["warm_up_s"], 1e-9),
        }
        return {"name": name, "ok": all(checks.values()), "requests": n,
                "caller_view": seen, "router_accounting": acct,
                "victim_accounting": vacct,
                "survivor_accounting": survivor,
                "checks": checks, "warmstart": warmstart,
                "latency": lat,
                "why": "kill one of two replicas mid-burst: the fleet "
                       "completes 100% of admitted requests with exactly-"
                       "one-outcome accounting, and a warm-start replica "
                       "prepares every step from the shared cache"}
    finally:
        for r in (r0, r1):
            if r is not None:
                r.destroy()
        shutil.rmtree(aot_dir, ignore_errors=True)


def leg_fleet_negative(name, ci, log_dir="."):
    """--fleet --negative-control: the router runs with drain honoring
    AND the unadmitted-sibling retry disabled (the two behaviors the
    kill scenario exercises). After the mid-burst SIGTERM the router
    keeps dispatching to the draining/dead replica, so requests reach
    typed stopped/replica-lost outcomes — the gate MUST fail."""
    from paddle_tpu_torch.serving.fleet import (FleetRouter, Replica,
                                          RouterConfig)

    aot_dir = tempfile.mkdtemp(prefix="paddle_tpu_fleet_aot_")
    r0 = r1 = None
    try:
        r0 = _ReplicaProc("mlp_tiny", "r0", aot_dir, log_dir)
        r0.wait_ready()
        r1 = _ReplicaProc("mlp_tiny", "r1", aot_dir, log_dir)
        r1.wait_ready()
        router = FleetRouter(
            [Replica("r0", "127.0.0.1", r0.port),
             Replica("r1", "127.0.0.1", r1.port)],
            config=RouterConfig(honor_drain=False,
                                retry_unadmitted=False))
        n = 36 if ci else 120
        with router:
            seen = _drive_fleet(router, _mlp_feed, n_requests=n,
                                n_threads=4, kill_at=n // 3,
                                kill_fn=r0.sigterm)
            acct = router.accounting()
        r1.sigterm()
        checks = {
            "exact_fleet_accounting": bool(acct["exact"]),
            "every_submit_terminal": seen["terminal"] == seen["submitted"],
            "all_completed": seen["completed"] == n,
            "no_untyped_errors": seen["other_error"] == 0,
            "nothing_admitted_lost":
                seen["replica_lost"] == 0 and seen["stopped"] == 0
                and seen["failed"] == 0,
        }
        return {"name": name, "ok": all(checks.values()), "requests": n,
                "caller_view": seen, "router_accounting": acct,
                "checks": checks,
                "why": "drain honoring + unadmitted retry disabled: the "
                       "kill scenario must trip the gate"}
    finally:
        for r in (r0, r1):
            if r is not None:
                r.destroy()
        shutil.rmtree(aot_dir, ignore_errors=True)


def _corrupt_metrics_stub():
    """A 'replica' whose ``/metrics`` endpoints answer 200 with an
    undecodable body — the telemetry leg's negative control. Returns
    ``(server, port)``; the caller shuts it down."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = b"\x00\xffdefinitely{not a metrics body"
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _drive_tenant_burst(router, n, n_threads, tenants):
    """Submit ``n`` standard-priority requests through the router, tagged
    with ``tenants`` round-robin. Returns caller-side outcome counts
    (every outcome typed, like :func:`_drive_fleet`)."""
    from paddle_tpu_torch.serving.fleet import ReplicaLost

    seen = {"completed": 0, "failed": 0, "shed": 0, "deadline": 0,
            "circuit_open": 0, "stopped": 0, "replica_lost": 0,
            "other_error": 0}
    lock = threading.Lock()

    def note(key):
        with lock:
            seen[key] += 1

    def submitter(tid):
        for i in range(tid, n, n_threads):
            try:
                router.submit(_mlp_feed(rows=1, seed=i), priority=1,
                              tenant=tenants[i % len(tenants)])
                note("completed")
            except serving.BatchFailed:
                note("failed")
            except ReplicaLost:
                note("replica_lost")
            except serving.Overloaded:
                note("shed")
            except serving.DeadlineExceeded:
                note("deadline")
            except serving.CircuitOpen:
                note("circuit_open")
            except serving.EngineStopped:
                note("stopped")
            except Exception:
                note("other_error")

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    return threads, seen


def leg_fleet_telemetry(name, ci, log_dir="."):
    """The telemetry-plane gate: 2 replica PROCESSES serving ``/metrics`` + a third target
    serving a CORRUPT body, scraped by an in-process
    :class:`FleetAggregator`. Proves, end to end over the wire:

    * fleet p50/p99 assembled from SCRAPED per-replica histograms via
      the exact bucket-wise merge, count cross-checked against the
      router's own completed ledger;
    * SLO burn state flips to ``burning`` under injected stalled-batch
      faults on one replica (``batch_dispatch`` fault plan) and recovers
      to ``ok`` once the burn windows drain;
    * the per-tenant ledger sums EXACTLY to the fleet outcome ledger,
      outcome by outcome;
    * at least one exported exemplar ``trace_id`` resolves to a recorded
      trace (the router-side root span — one trace id across processes);
    * the corrupt-``/metrics`` target degrades typed: marked stale,
      ``fleet_scrape_failures_total{kind=corrupt}`` counted, the
      aggregator keeps scraping/publishing the healthy replicas and its
      poll thread stays alive (zero crashes).
    """
    from paddle_tpu_torch import flags as flags_mod
    from paddle_tpu_torch import trace
    from paddle_tpu_torch.serving.fleet import (AggregatorConfig, FleetAggregator,
                                          FleetRouter, Replica)

    # squeezed burn windows so the ok -> burning -> ok round trip fits a
    # CI leg; targets/budget stay at defaults (1% budget: one failed
    # batch flips both windows hot immediately)
    slo_flags = ["--set-flag", "FLAGS_serving_slo_fast_window_s=2",
                 "--set-flag", "FLAGS_serving_slo_slow_window_s=6"]
    tele_args = ["--trace", "--set-flag", "FLAGS_fleet_telemetry=1"]
    stall_args = ["--set-flag",
                  "FLAGS_fault_plan=batch_dispatch:2:TimeoutError"]
    aot_dir = tempfile.mkdtemp(prefix="paddle_tpu_fleet_tele_aot_")
    saved_overrides = dict(flags_mod._overrides)
    r0 = r1 = stub = agg = None
    burn_timeline = []

    def observe_state(agg, t0):
        snap = agg.snapshot()
        st = snap["fleet"]["slo_state"]
        if not burn_timeline or burn_timeline[-1][1] != st:
            burn_timeline.append((round(time.monotonic() - t0, 2), st))
        return st, snap

    try:
        # the aggregator + router run IN PROCESS: they need the plane and
        # tracing on locally too (exemplar resolution joins the router's
        # recorded root spans)
        fluid.set_flags({"FLAGS_fleet_telemetry": 1, "FLAGS_trace": 1})
        r0 = _ReplicaProc("mlp_tiny", "r0", aot_dir, log_dir,
                          extra_args=tele_args + slo_flags)
        r0.wait_ready()
        r1 = _ReplicaProc("mlp_tiny", "r1", aot_dir, log_dir,
                          extra_args=tele_args + slo_flags + stall_args)
        r1.wait_ready()
        stub, bad_port = _corrupt_metrics_stub()

        router = FleetRouter([Replica("r0", "127.0.0.1", r0.port),
                              Replica("r1", "127.0.0.1", r1.port)])
        agg = FleetAggregator(
            [("r0", f"127.0.0.1:{r0.port}"),
             ("r1", f"127.0.0.1:{r1.port}"),
             ("rbad", f"127.0.0.1:{bad_port}")],
            AggregatorConfig(scrape_interval_s=0.25, scrape_timeout_s=5.0))
        n = 28 if ci else 80
        tenants = ("acme", "globex", "initech")
        t0 = time.monotonic()
        burning_seen = recovered = False
        with router:
            with agg:
                threads, seen = _drive_tenant_burst(router, n, 4, tenants)
                # poll while the burst runs: the stalled batches land at
                # its head, so burning must be OBSERVED inside the fast
                # window, not reconstructed afterwards
                while any(t.is_alive() for t in threads):
                    st, _ = observe_state(agg, t0)
                    burning_seen = burning_seen or st == "burning"
                    time.sleep(0.15)
                for t in threads:
                    t.join(600)
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    st, _ = observe_state(agg, t0)
                    burning_seen = burning_seen or st == "burning"
                    if burning_seen and st == "ok":
                        recovered = True
                        break
                    time.sleep(0.25)
                agg.poll_now()
                final = agg.snapshot()
                thread_alive = (agg._thread is not None
                                and agg._thread.is_alive())
            acct = router.accounting()
        seen["submitted"] = n
        seen["terminal"] = sum(v for k, v in seen.items()
                               if k not in ("submitted", "terminal"))

        fleet = final["fleet"]
        replicas = final["replicas"]
        merged_count = (fleet["latency"] or {}).get("count", 0)
        # tenant reconciliation: outcome by outcome, the summed tenant
        # ledger must equal the scraped fleet outcome ledger exactly
        tenant_sums = {}
        for t in fleet["tenants"].values():
            for o, c in t["outcomes"].items():
                tenant_sums[o] = tenant_sums.get(o, 0) + c
        fleet_outcomes = {k: int(v) for k, v in fleet["outcomes"].items()}
        # exemplar resolution: exported trace ids join the router's
        # in-process recorded spans (one trace id across processes)
        exported = set()
        for rec in (replicas.get("r0"), replicas.get("r1")):
            for fam in (rec or {}).get("exemplars", {}).values():
                for child in fam:
                    for ring in child["buckets"].values():
                        exported.update(e["trace_id"] for e in ring)
        recorded = {s.trace_id for s in trace.spans()}
        resolved = sorted(exported & recorded)
        rbad = replicas.get("rbad") or {}
        corrupt_count = monitor.metric_value(
            "fleet_scrape_failures_total", default=0,
            replica="rbad", kind="corrupt")

        checks = {
            "exact_fleet_accounting": bool(acct["exact"]),
            "every_submit_terminal": seen["terminal"] == seen["submitted"],
            "no_untyped_errors": seen["other_error"] == 0,
            "stall_faults_burned_budget": seen["failed"] > 0,
            "fleet_latency_scraped":
                fleet["p50"] is not None and fleet["p99"] is not None,
            "scraped_count_matches_router_ledger":
                merged_count == acct["completed"] > 0,
            "scraped_completed_matches_router_ledger":
                int(fleet_outcomes.get("completed", 0))
                == acct["completed"],
            "slo_burning_observed": burning_seen,
            "slo_recovered": recovered,
            "tenant_ledger_reconciles":
                bool(tenant_sums) and tenant_sums == fleet_outcomes,
            "all_tenants_accounted":
                set(tenants) <= set(fleet["tenants"]),
            "exemplar_resolves_to_trace": len(resolved) > 0,
            "corrupt_target_stale":
                bool(rbad.get("stale")) and not rbad.get("up")
                and rbad.get("error") == "corrupt"
                and rbad.get("consecutive_failures", 0) >= 1,
            "corrupt_failures_counted": corrupt_count >= 1,
            "healthy_replicas_kept_publishing":
                bool(replicas.get("r0", {}).get("up"))
                and bool(replicas.get("r1", {}).get("up")),
            "aggregator_thread_survived": thread_alive,
        }
        telemetry = {
            "fleet_p50_s": fleet["p50"], "fleet_p99_s": fleet["p99"],
            "scraped_latency_count": merged_count,
            "router_completed": acct["completed"],
            "fleet_outcomes": fleet_outcomes,
            "tenants": fleet["tenants"],
            "slo_timeline": burn_timeline,
            "slo_state_final": fleet["slo_state"],
            "exemplars_exported": len(exported),
            "exemplar_resolved_trace_ids": resolved[:4],
            "corrupt_scrapes": int(corrupt_count),
            "scrape_ages_s": {rid: rec.get("scrape_age_s")
                              for rid, rec in replicas.items()},
        }
        return {"name": name, "ok": all(checks.values()), "requests": n,
                "caller_view": seen, "router_accounting": acct,
                "checks": checks, "telemetry": telemetry,
                "why": "fleet p50/p99 from scraped /metrics cross-checked "
                       "vs the router ledger; SLO burns and recovers "
                       "under injected stalled batches; tenant ledger "
                       "reconciles exactly; exemplars resolve to traces; "
                       "a corrupt /metrics target degrades typed with "
                       "zero aggregator crashes"}
    finally:
        if agg is not None:
            agg.stop()
        if stub is not None:
            stub.shutdown()
        for r in (r0, r1):
            if r is not None:
                r.sigterm()
        for r in (r0, r1):
            if r is not None:
                try:
                    r.wait_exit(60)
                except Exception:
                    pass
                r.destroy()
        shutil.rmtree(aot_dir, ignore_errors=True)
        flags_mod._overrides.clear()
        flags_mod._overrides.update(saved_overrides)
        flags_mod._set_epoch += 1


# ---------------------------------------------------------------------------
# fleet control-loop legs (--autoscale): SLO-driven autoscaling + tenant
# fair-share. A supervised fleet
# behind the router plus a FleetAutoscaler: a hot-tenant flood must burn
# the SLO, scale OUT a second replica warm through the fleet-shared AOT
# cache AND the fleet-shared autotune CostDatabase, shed the hot tenant
# typed tenant_quota while innocent tenants keep completing, then scale
# back IN strictly via preemption-drain once calm — fleet ledger exact
# throughout, every decision typed/metered/audited.
# ---------------------------------------------------------------------------

_AUTOSCALE_REPLICA_ARGS = [
    # a deliberately slow dispatcher (wide batch window) + a small queue
    # so a hog flood piles real, sustained admission pressure
    "--batch-window-s", "0.15", "--queue-depth", "16"]
_AUTOSCALE_TENANT_FLAGS = [
    # queue_depth 16 * frac 0.125 -> the hog caps at 2 queued slots: low
    # enough that 8 open-loop hog threads (at most 4 in the in-flight
    # batch + the rest queued) provably overrun it
    "--set-flag", "FLAGS_serving_tenant_fair_share=1",
    "--set-flag", "FLAGS_serving_tenant_quota_frac=0.125"]
_AUTOSCALE_SLO_FLAGS = [
    # squeezed burn windows (the telemetry leg's trick) so the
    # burn -> recover round trip fits one CI leg
    "--set-flag", "FLAGS_serving_slo_fast_window_s=2",
    "--set-flag", "FLAGS_serving_slo_slow_window_s=6"]


def _seed_shared_autotune_db(db_path):
    """Populate the fleet-shared autotune CostDatabase IN-PROCESS with a
    real (tiny) measured sweep over the replica probe's warm-up buckets.
    ``build_probe`` guarantees the program CONTENT fingerprint matches
    what every replica process builds, so a replica spawned with
    ``FLAGS_autotune=use`` + this DB warms straight to best-known
    configs: lookups hit, zero re-trials. (measure_candidates is not
    safe under live traffic — which is exactly why the harness seeds the
    DB offline and the fleet only ever consumes it.)"""
    from paddle_tpu_torch import tuning
    from paddle_tpu_torch.core.types import np_dtype
    from paddle_tpu_torch.serving.fleet.replica import build_probe

    fluid.set_flags({"FLAGS_autotune": "measure",
                     "FLAGS_autotune_db": db_path})
    tuning.reset_database_cache()
    eng, _meta = build_probe("mlp_tiny", serving.ServingConfig(max_batch=4),
                             device=_DEVICE)
    db = tuning.get_database(db_path)
    # the default triple and one other compiled GEMM tiling
    candidates = tuning.default_candidates(include_gemm_blocks=True)[:2]
    blk = eng._program.global_block
    buckets = []
    for b in (1, 2, 4):   # the warm-up buckets for max_batch=4
        feed = {}
        for n in eng._feed_names:
            v = blk.var(n)
            tail = tuple(int(d) for d in v.shape[1:])
            feed[n] = np.zeros((b,) + tail, dtype=np_dtype(v.dtype))
        rep = tuning.measure_candidates(
            eng._exe, eng._program, feed, eng._fetch_names, eng._scope,
            candidates=candidates, k_short=1, k_long=2, repeats=1,
            batch_rows=b, db=db)
        buckets.append(rep["bucket"])
    # this process is done measuring; the fleet consumes in use mode
    fluid.set_flags({"FLAGS_autotune": "use"})
    return {"path": db_path, "trials": db.trial_count(),
            "buckets": buckets}


def _drive_autoscale_burst(router, stop_ev, hog_threads=8,
                           small_tenants=("acme", "globex")):
    """Open-loop hog flood (each thread re-submits immediately; typed
    sheds back off a beat) + one closed-loop thread per innocent tenant.
    Outcomes are counted per tenant WITH the Overloaded reason split
    out: ``shed_tenant_quota`` vs ``shed_other`` is the whole point of
    the leg. Innocent-tenant latencies are collected caller-side for
    the p99-held check. The flood runs on while the scaled-out replica
    spawns: the time to ready is reported, not compared, and a paused
    flood lets the loop see calm and drain a replica still spawning.
    Everything submits at
    priority 5: the engine's own degraded mode sheds below
    ``degraded_min_priority``, and this leg needs ``tenant_quota`` to
    be the ONLY shed in play."""
    from paddle_tpu_torch.serving.fleet import ReplicaLost

    lock = threading.Lock()
    seen = {"submitted": 0, "completed": 0, "shed_tenant_quota": 0,
            "shed_other": 0, "failed": 0, "deadline": 0,
            "circuit_open": 0, "stopped": 0, "replica_lost": 0,
            "other_error": 0}
    per_tenant = {}
    small_latencies = []

    def note(tenant, key, latency=None):
        with lock:
            seen["submitted"] += 1
            seen[key] += 1
            t = per_tenant.setdefault(tenant, {})
            t[key] = t.get(key, 0) + 1
            if latency is not None and tenant in small_tenants:
                small_latencies.append(latency)

    def one(tenant, seed):
        t0 = time.perf_counter()
        try:
            router.submit(_mlp_feed(rows=1, seed=seed % 100000),
                          priority=5, tenant=tenant)
            note(tenant, "completed", time.perf_counter() - t0)
            return True
        except serving.Overloaded as e:
            note(tenant, "shed_tenant_quota"
                 if getattr(e, "reason", "") == "tenant_quota"
                 else "shed_other")
        except serving.BatchFailed:
            note(tenant, "failed")
        except serving.DeadlineExceeded:
            note(tenant, "deadline")
        except serving.CircuitOpen:
            note(tenant, "circuit_open")
        except serving.EngineStopped:
            note(tenant, "stopped")
        except ReplicaLost:
            note(tenant, "replica_lost")
        except Exception:
            note(tenant, "other_error")
        return False

    def hog(tid):
        i = 0
        while not stop_ev.is_set():
            if not one("hog", tid * 1000 + i):
                time.sleep(0.01)
            i += 1

    def small(tenant, tid):
        i = 0
        while not stop_ev.is_set():
            one(tenant, 7000 + tid * 1000 + i)
            i += 1
            time.sleep(0.05)

    threads = [threading.Thread(target=hog, args=(t,))
               for t in range(hog_threads)]
    threads += [threading.Thread(target=small, args=(name, t))
                for t, name in enumerate(small_tenants)]
    for t in threads:
        t.start()
    return threads, seen, per_tenant, small_latencies


def leg_autoscale(name, ci, log_dir="."):
    """--autoscale: the closed fleet control loop, end to end over
    processes. One supervised replica starts COLD (empty AOT cache, but
    the harness-seeded shared autotune DB); a hot-tenant flood burns the
    SLO budget through typed tenant_quota sheds; the FleetAutoscaler
    must scale out a second replica (warm: shared AOT cache + autotune
    hits, zero re-trials; its time-to-ready is reported beside the cold
    baseline's, not gated, as in the --fleet leg), refuse further scale-out typed at_max_replicas, and —
    once the burst stops and the squeezed burn windows drain — scale
    back in strictly via preemption-drain (victim exits 0 with an exact
    ledger) then hold the floor typed at_min_replicas. Innocent tenants
    must keep completing with their caller-side p99 held the whole
    time."""
    from paddle_tpu_torch import flags as flags_mod
    from paddle_tpu_torch.serving.fleet import (AutoscalerConfig,
                                          FleetAutoscaler,
                                          ReplicaSupervisor,
                                          SupervisorConfig)

    aot_dir = tempfile.mkdtemp(prefix="paddle_tpu_autoscale_aot_")
    db_dir = tempfile.mkdtemp(prefix="paddle_tpu_autoscale_db_")
    db_path = os.path.join(db_dir, "autotune_db.json")
    saved_overrides = dict(flags_mod._overrides)
    router = sup = auto = None
    stop_ev = threading.Event()
    threads = []
    try:
        seeded = _seed_shared_autotune_db(db_path)
        replica_args = (_AUTOSCALE_REPLICA_ARGS + _AUTOSCALE_TENANT_FLAGS
                        + _AUTOSCALE_SLO_FLAGS)
        router = _chaos_router(request_timeout_s=30.0)
        sup = ReplicaSupervisor(
            router,
            SupervisorConfig(
                ready_timeout_s=240.0, exit_grace_s=60.0, device=_DEVICE,
                # the fleet-shared autotune story rides EVERY spawn —
                # including the autoscaler's, which never mentions it
                shared_flags={"FLAGS_autotune": "use",
                              "FLAGS_autotune_db": db_path}),
            log_dir=log_dir, env=_replica_env(), cwd=_REPO_ROOT)
        sup.add_replica("r0", "mlp_tiny", aot_dir,
                        extra_args=replica_args)
        cold = sup.handle("r0").wait_ready(240)
        router.start()
        assert _wait_routable(router, "r0")

        auto = FleetAutoscaler(
            sup, router=router,
            config=AutoscalerConfig(
                min_replicas=1, max_replicas=2, interval_s=0.2,
                cooldown_s=2.0, hot_sustain_s=1.0, calm_sustain_s=3.0,
                max_inflight_spawns=1, queue_high=4),
            model="mlp_tiny", aot_dir=aot_dir, extra_args=replica_args)
        auto.start()

        threads, seen, per_tenant, small_lat = _drive_autoscale_burst(
            router, stop_ev)
        # the flood sheds the hog typed tenant_quota; sheds are bad SLO
        # outcomes, so the burn state flips and SUSTAINS -> scale-out
        warm = None
        deadline = time.monotonic() + 180.0
        while time.monotonic() < deadline and "as1" not in sup.status():
            time.sleep(0.1)
        scaled_spawned = "as1" in sup.status()
        if scaled_spawned:
            warm = sup.handle("as1").wait_ready(240)
            _wait_routable(router, "as1")
        # keep the burst on the scaled-out fleet: the refusal ladder at
        # max_replicas must fire typed while both replicas take traffic
        time.sleep(3.5 if ci else 5.0)
        stop_ev.set()
        for t in threads:
            t.join(120)

        # calm: the squeezed windows drain, the loop must scale back IN
        # strictly via preemption-drain of the replica it spawned
        drained_clean = False
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            if sup.status().get("as1", {}).get("state") == "stopped":
                drained_clean = True
                break
            time.sleep(0.2)
        # hold the floor a beat: at_min_replicas must be typed + metered
        time.sleep(2.0 if ci else 3.0)
        status = auto.status()
        audit = status["audit"]
        auto.stop()
        acct = router.accounting()
        as1 = sup.handle("as1") if scaled_spawned else None
        victim_acct = ((as1.exit_info or {}).get("accounting") or {}) \
            if as1 is not None else {}
        last_exit = (as1.last_exit or {}) if as1 is not None else {}
        sup.stop(drain=True)
        router.stop()

        seen["terminal"] = sum(v for k, v in seen.items()
                               if k not in ("submitted", "terminal"))

        def decided(action, reason=None):
            return any(e["action"] == action
                       and (reason is None or e["reason"] == reason)
                       for e in audit)

        out = next((e for e in audit if e["action"] == "scale_out"), None)
        hog = per_tenant.get("hog", {})
        smalls = {t: per_tenant.get(t, {}) for t in ("acme", "globex")}
        small_shed = sum(v.get("shed_tenant_quota", 0)
                         + v.get("shed_other", 0)
                         for v in smalls.values())
        p99 = (sorted(small_lat)[max(0, int(0.99 * (len(small_lat) - 1)))]
               if small_lat else None)

        checks = {
            "scale_out_on_sustained_hot":
                out is not None and scaled_spawned and warm is not None,
            "scale_out_reason_typed_hot":
                out is not None
                and (out["reason"] == "slo_burn"
                     or out["reason"].startswith("pressure")),
            "warm_loaded_from_aot_cache":
                warm is not None and warm["aot_cache"]["hits"] >= 1
                and warm["aot_cache"]["misses"] == 0,
            "autotune_shared_db_hit":
                warm is not None and warm["autotune"]["mode"] == "use"
                and warm["autotune"]["hits"] >= 1,
            "autotune_zero_retrials":
                warm is not None and warm["autotune"]["trials"] == 0
                and cold["autotune"]["trials"] == 0,
            "hot_tenant_shed_typed_tenant_quota":
                hog.get("shed_tenant_quota", 0) >= 1,
            "innocent_tenants_kept_admitted":
                small_shed == 0
                and all(v.get("completed", 0) >= 3
                        for v in smalls.values()),
            "innocent_p99_held": p99 is not None and p99 < 5.0,
            "refusal_ladder_typed":
                decided("refuse_scale_out", "at_max_replicas")
                and decided("refuse_scale_in", "at_min_replicas"),
            "refusals_metered":
                monitor.metric_value("autoscaler_decisions_total", 0.0,
                                     action="refuse_scale_out",
                                     reason="at_max_replicas") >= 1,
            "calm_scale_in_via_drain": decided("scale_in", "calm"),
            "victim_drained_clean":
                drained_clean and last_exit.get("reason") == "drain"
                and last_exit.get("rc") == 0,
            "victim_ledger_exact":
                bool(victim_acct.get("exact"))
                and victim_acct.get("pending") == 0,
            "exact_fleet_accounting": bool(acct["exact"]),
            "every_submit_terminal":
                seen["terminal"] == seen["submitted"],
            "no_untyped_errors": seen["other_error"] == 0,
            "nothing_admitted_lost":
                seen["replica_lost"] == 0 and seen["stopped"] == 0,
        }
        warmstart = {
            "cold": {k: cold.get(k) for k in
                     ("time_to_ready_s", "warm_up_s", "aot_cache",
                      "autotune")},
            "warm": ({k: warm.get(k) for k in
                      ("time_to_ready_s", "warm_up_s", "aot_cache",
                       "autotune")} if warm is not None else None),
            "ready_speedup": (cold["time_to_ready_s"]
                              / max(warm["time_to_ready_s"], 1e-9)
                              if warm is not None else None),
        }
        return {"name": name, "ok": all(checks.values()),
                "requests": seen["submitted"], "caller_view": seen,
                "router_accounting": acct,
                "victim_accounting": victim_acct,
                "tenants": per_tenant, "autotune_seed": seeded,
                "warmstart": warmstart,
                "innocent_latency": {"count": len(small_lat),
                                     "p99_s": p99},
                "autoscaler": {"audit": audit,
                               "last_decision": status["last_decision"],
                               "spawned": status["spawned"]},
                "checks": checks,
                "why": "hot-tenant SLO burn scales out warm (shared AOT "
                       "cache + autotune DB, zero re-trials), the hog is "
                       "shed typed tenant_quota while innocents hold, "
                       "calm scales back in via preemption-drain with "
                       "the fleet ledger exact, and every refusal is "
                       "typed + metered"}
    finally:
        stop_ev.set()
        for t in threads:
            t.join(10)
        if auto is not None:
            auto.stop()
        if sup is not None:
            sup.stop(drain=True)
        if router is not None:
            router.stop()
        shutil.rmtree(aot_dir, ignore_errors=True)
        shutil.rmtree(db_dir, ignore_errors=True)
        flags_mod._overrides.clear()
        flags_mod._overrides.update(saved_overrides)


def leg_autoscale_negative(name, ci, log_dir="."):
    """--autoscale --negative-control: NO autoscaler attached and tenant
    fair-share off. The same hog flood piles real queue pressure, but
    nothing answers it: the replica count stays pinned at one and the
    hog's sheds (if any) stay untyped-by-tenant — the control-loop
    checks must FAIL the gate."""
    from paddle_tpu_torch.serving.fleet import (ReplicaSupervisor,
                                          SupervisorConfig)

    aot_dir = tempfile.mkdtemp(prefix="paddle_tpu_autoscale_neg_aot_")
    router = sup = None
    stop_ev = threading.Event()
    threads = []
    try:
        router = _chaos_router(request_timeout_s=30.0)
        sup = ReplicaSupervisor(
            router, SupervisorConfig(ready_timeout_s=240.0,
                                     exit_grace_s=60.0, device=_DEVICE),
            log_dir=log_dir, env=_replica_env(), cwd=_REPO_ROOT)
        sup.add_replica(
            "r0", "mlp_tiny", aot_dir,
            extra_args=_AUTOSCALE_REPLICA_ARGS + _AUTOSCALE_SLO_FLAGS)
        sup.handle("r0").wait_ready(240)
        router.start()
        assert _wait_routable(router, "r0")

        threads, seen, per_tenant, _lat = _drive_autoscale_burst(
            router, stop_ev)
        peak_queue = 0
        t_end = time.monotonic() + (4.0 if ci else 6.0)
        while time.monotonic() < t_end:
            router.poll_now()
            r = router.get_replica("r0")
            if r is not None:
                peak_queue = max(peak_queue,
                                 r.snapshot().get("queue_depth", 0))
            time.sleep(0.1)
        stop_ev.set()
        for t in threads:
            t.join(120)
        acct = router.accounting()
        seen["terminal"] = sum(v for k, v in seen.items()
                               if k not in ("submitted", "terminal"))
        hog = per_tenant.get("hog", {})
        checks = {
            # sanity (passes): the hot condition was genuinely present
            "hot_pressure_observed": peak_queue >= 4,
            "exact_fleet_accounting": bool(acct["exact"]),
            # the control-loop requirements (must FAIL):
            "scale_out_on_sustained_hot": len(sup.status()) > 1,
            "hot_tenant_shed_typed_tenant_quota":
                hog.get("shed_tenant_quota", 0) >= 1,
        }
        return {"name": name, "ok": all(checks.values()),
                "requests": seen["submitted"], "caller_view": seen,
                "router_accounting": acct, "tenants": per_tenant,
                "peak_queue_depth": peak_queue, "checks": checks,
                "why": "no autoscaler + no tenant quotas: sustained "
                       "pressure goes unanswered and the hot tenant is "
                       "never shed typed — the gate must FAIL"}
    finally:
        stop_ev.set()
        for t in threads:
            t.join(10)
        if sup is not None:
            sup.stop(drain=True)
        if router is not None:
            router.stop()
        shutil.rmtree(aot_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# fleet self-healing legs (--fleet-chaos): supervisor + bisection + wire
# chaos. Three failure families against a 2-replica
# fleet: injected wire faults (drop + stall + corrupt), one poison
# request co-batched with innocents, and a crashed + a crash-looping
# replica under the supervisor.
# ---------------------------------------------------------------------------

_BISECT_FLAGS = ["--set-flag", "FLAGS_serving_bisect_depth=3",
                 "--set-flag", "FLAGS_check_nan_inf=1"]


def _chaos_router(request_timeout_s=2.0):
    from paddle_tpu_torch.serving.fleet import FleetRouter, RouterConfig

    return FleetRouter([], RouterConfig(
        poll_interval_s=0.1, connect_timeout_s=3.0,
        request_timeout_s=request_timeout_s,
        breaker_threshold=2, breaker_cooldown_s=0.4))


def _chaos_supervisor(router, log_dir, restart=True, max_restarts=2):
    from paddle_tpu_torch.serving.fleet import (ReplicaSupervisor,
                                          SupervisorConfig)

    cfg = SupervisorConfig(max_restarts=max_restarts,
                           restart_window_s=60.0, backoff_base_s=0.25,
                           backoff_max_s=1.0, ready_timeout_s=240.0,
                           exit_grace_s=30.0, restart=restart,
                           device=_DEVICE)
    return ReplicaSupervisor(router, cfg, log_dir=log_dir,
                             env=_replica_env(), cwd=_REPO_ROOT)


def _wait_routable(router, replica_id, timeout=90.0):
    """Wait until the router's snapshot marks one replica ok+ready (the
    'fresh capacity within one poll' observation point)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        r = router.get_replica(replica_id)
        if r is not None:
            snap = r.snapshot()
            if snap["ok"] and snap["ready"]:
                return True
        time.sleep(0.05)
    return False


def _wait_removed(router, replica_id, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if router.get_replica(replica_id) is None:
            return True
        time.sleep(0.05)
    return False


def _poison_feed(seed=999):
    f = _mlp_feed(rows=1, seed=seed)
    f["img"][0, :7] = np.nan
    return f


def _submit_concurrent(router, feeds, priority=1):
    """Submit each feed from its own thread (so the replica's batch
    window coalesces them) and classify every outcome."""
    from paddle_tpu_torch.serving import (BatchFailed, CircuitOpen,
                                    DeadlineExceeded, EngineStopped,
                                    Overloaded, PoisonRequest)
    from paddle_tpu_torch.serving.fleet import ReplicaLost

    results = [None] * len(feeds)
    outcomes = [None] * len(feeds)

    def one(i):
        try:
            results[i] = router.submit(feeds[i], priority=priority)
            outcomes[i] = "completed"
        except PoisonRequest:
            outcomes[i] = "poisoned"
        except Overloaded:
            outcomes[i] = "shed"
        except BatchFailed:
            outcomes[i] = "failed"
        except ReplicaLost:
            outcomes[i] = "replica_lost"
        except DeadlineExceeded:
            outcomes[i] = "deadline"
        except (CircuitOpen, EngineStopped):
            outcomes[i] = "rejected"
        except Exception:
            outcomes[i] = "other_error"

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(feeds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return results, outcomes


def leg_fleet_chaos_wire_poison(name, ci, log_dir=".", aot_dir=""):
    """Wire chaos + poison bisection against a supervised 2-replica
    fleet. r1 carries its OWN fault plan (its first two submit responses
    stall past the router's request timeout — the stalling-but-listening
    replica the per-replica breaker must eject); the router process
    injects a connect drop and a corrupt request payload (both
    unadmitted, absorbed by the sibling retry). Then one NaN poison
    request rides a batch with innocents: replica-side bisection must
    complete every innocent bit-exactly, settle the culprit typed
    PoisonRequest, and shed its resubmission from quarantine."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.resilience import fault_plan_guard
    from paddle_tpu_torch.serving import Overloaded

    router = _chaos_router(request_timeout_s=2.0)
    sup = _chaos_supervisor(router, log_dir)
    base_args = ["--batch-window-s", "0.02", "--max-batch", "4",
                 "--queue-depth", "256"] + _BISECT_FLAGS
    try:
        sup.add_replica("r0", "mlp_tiny", aot_dir, extra_args=base_args)
        sup.add_replica(
            "r1", "mlp_tiny", aot_dir,
            extra_args=base_args + [
                "--set-flag", "FLAGS_fault_plan=wire_response:2:stall",
                "--set-flag", "FLAGS_fault_stall_s=8"])
        sup.handle("r0").wait_ready(240)
        sup.handle("r1").wait_ready(240)
        router.start()
        assert _wait_routable(router, "r0") and _wait_routable(router, "r1")

        # -- phase S: the stalling-but-listening replica ----------------
        # SEQUENTIAL submissions so the breaker ladder is deterministic:
        # r1's first two responses stall (its own fault plan) past the
        # router timeout — they are necessarily its first two recorded
        # transport outcomes, so two consecutive failures OPEN the
        # breaker before any r1 success could reset the count
        probe = {"completed": 0, "replica_lost": 0, "other": 0}
        from paddle_tpu_torch.serving.fleet import ReplicaLost as _RL
        for i in range(12):
            try:
                router.submit(_mlp_feed(rows=1, seed=700 + i))
                probe["completed"] += 1
            except _RL:
                probe["replica_lost"] += 1
            except Exception:
                probe["other"] += 1
            if probe["replica_lost"] >= 2:
                break
        opened = monitor.metric_value("router_breaker_transitions_total",
                                      0.0, replica="r1", to="open")
        # cooldown + healthz half-open probe must READMIT r1
        r1 = router.get_replica("r1")
        deadline = time.time() + 15.0
        while r1.breaker.state != "closed" and time.time() < deadline:
            time.sleep(0.05)
        readmitted = r1.breaker.state == "closed"

        # -- phase W: burst under router-side wire faults ---------------
        n = 24 if ci else 72
        with fault_plan_guard("wire_connect:@9:drop,"
                              "wire_connect:@12:corrupt") as plan:
            seen = _drive_fleet(router, _mlp_feed, n_requests=n,
                                n_threads=4)
            wire_fired = list(plan.fired)

        # -- phase P: poison bisection through the fleet ----------------
        # all traffic onto r1: r0 drains away (also proves the breaker
        # re-admitted r1 after its cooldown probe). Three rounds of one
        # poison co-batched with one innocent: bisection re-dispatches
        # the innocent as a SOLO batch, so a solo clean resubmission is
        # the exact same program + bucket — a true bit-exactness
        # baseline (results of different buckets may differ in ULPs).
        sup.drain("r0")
        assert _wait_removed(router, "r0"), "drained r0 not deregistered"
        rounds = 3
        poison_outcomes, innocent_outcomes = [], []
        bit_exact = True
        for j in range(rounds):
            poison = _poison_feed(seed=990 + j)   # distinct fingerprints
            innocent = _mlp_feed(rows=1, seed=100 + j)
            results, outcomes = _submit_concurrent(router,
                                                   [poison, innocent])
            poison_outcomes.append(outcomes[0])
            innocent_outcomes.append(outcomes[1])
            if outcomes[1] == "completed":
                clean = router.submit(innocent)
                bit_exact = bit_exact and all(
                    np.array_equal(a, b)
                    for a, b in zip(clean, results[1]))
            else:
                bit_exact = False
        # quarantine: the round-0 poison feed again is shed at admission
        try:
            router.submit(_poison_feed(seed=990))
            quarantine_shed = False
        except Overloaded:
            quarantine_shed = True
        except Exception:
            quarantine_shed = False
        acct = router.accounting()
        sup.stop(drain=True)
        router.stop()
        victim = (sup.handle("r1").exit_info or {}).get("accounting", {})

        checks = {
            "exact_fleet_accounting": bool(acct["exact"]),
            "every_submit_terminal": seen["terminal"] == seen["submitted"],
            "no_untyped_errors": seen["other_error"] == 0,
            # the two stalled responses were typed losses; everything
            # else in the probe completed on the healthy sibling
            "stalled_requests_typed_lost":
                probe["replica_lost"] == 2 and probe["other"] == 0,
            "stalling_replica_ejected": opened >= 1,
            "breaker_readmitted_via_healthz": readmitted,
            # with the stall plan exhausted and the breaker closed, the
            # burst completes 100% (drop/corrupt retried on the sibling)
            "wire_burst_completed":
                seen["completed"] == n and seen["replica_lost"] == 0,
            "unadmitted_wire_faults_retried": acct["retries"] >= 2,
            "wire_faults_audited":
                sum(1 for f in wire_fired if f[0] == "wire_connect") == 2,
            "poison_isolated_typed":
                all(o == "poisoned" for o in poison_outcomes),
            "innocents_complete":
                all(o == "completed" for o in innocent_outcomes),
            "innocents_bit_exact": bit_exact,
            "quarantine_sheds_repeat": quarantine_shed,
            "victim_ledger_exact": bool(victim.get("exact")),
            "victim_poisoned_per_round": victim.get("poisoned") == rounds,
            # bisection saved every innocent: the victim never failed a
            # whole batch
            "victim_zero_batch_failures": victim.get("failed") == 0,
        }
        return {"name": name, "ok": all(checks.values()), "requests": n,
                "caller_view": seen, "stall_probe": probe,
                "router_accounting": acct,
                "poison_outcomes": poison_outcomes,
                "innocent_outcomes": innocent_outcomes,
                "victim_accounting": victim,
                "wire_fired": [list(f) for f in wire_fired],
                "breaker_opens_r1": opened, "checks": checks,
                "why": "drop+stall+corrupt wire faults + one poison "
                       "request: typed outcomes for everything, "
                       "innocents bit-exact via bisection, stalling "
                       "replica ejected by the router breaker"}
    finally:
        sup.stop(drain=False)
        router.stop()


def leg_fleet_chaos_supervisor(name, ci, log_dir=".", aot_dir=""):
    """Supervisor self-healing: r1 is SIGKILLed mid-burst (no exit
    event — the 'kill' classification) and must be restarted within the
    backoff budget, re-registered under the same id on a NEW port, and
    serve again as the only ready replica. A third replica crash-loops
    on purpose and must be RETIRED with a typed ReplicaCrashLoop, never
    a silent restart spin."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving.fleet import ReplicaCrashLoop

    router = _chaos_router(request_timeout_s=10.0)
    sup = _chaos_supervisor(router, log_dir, max_restarts=2)
    base_args = ["--batch-window-s", "0.005", "--max-batch", "4",
                 "--queue-depth", "256"]
    try:
        sup.add_replica("r0", "mlp_tiny", aot_dir, extra_args=base_args)
        sup.add_replica("r1", "mlp_tiny", aot_dir, extra_args=base_args)
        sup.handle("r0").wait_ready(240)
        sup.handle("r1").wait_ready(240)
        router.start()
        assert _wait_routable(router, "r0") and _wait_routable(router, "r1")

        # -- phase K: SIGKILL r1 mid-burst, supervisor must heal --------
        n = 24 if ci else 72
        t_kill = [None]

        def killer():
            t_kill[0] = time.perf_counter()
            sup.kill("r1")

        seen = _drive_fleet(router, _mlp_feed, n_requests=n, n_threads=4,
                            kill_at=n // 3, kill_fn=killer)
        # wait for the ACTUAL restart (the pre-kill pressure snapshot is
        # stale for up to one poll — the supervisor's own state is the
        # ground truth), then for the router to see the new port ready
        h1 = sup.handle("r1")
        deadline = time.time() + 90.0
        while (h1.restarts < 1 or h1.state != "ready") \
                and time.time() < deadline:
            time.sleep(0.05)
        restarted = (h1.restarts == 1 and h1.state == "ready"
                     and _wait_routable(router, "r1", timeout=30.0))
        restart_s = (time.perf_counter() - t_kill[0]
                     if t_kill[0] is not None else None)
        # only the RESTARTED replica left: its service proves the router
        # treats same-id/new-port as fresh capacity
        sup.drain("r0")
        assert _wait_removed(router, "r0"), "drained r0 not deregistered"
        k = 6
        _, outcomes = _submit_concurrent(
            router, [_mlp_feed(rows=1, seed=500 + i) for i in range(k)])

        # -- phase L: forced crash loop must retire typed ---------------
        sup.add_replica("r2", "mlp_tiny", aot_dir,
                        extra_args=base_args + ["--crash-after-s", "0.4"])
        h2 = sup.handle("r2")
        retired = h2.wait_retired(240)
        try:
            sup.check()
            retired_typed = False
        except ReplicaCrashLoop:
            retired_typed = True
        # the fleet keeps serving through the whole crash loop
        _, outcomes2 = _submit_concurrent(
            router, [_mlp_feed(rows=1, seed=600 + i) for i in range(3)])
        acct = router.accounting()
        restarts_crash = monitor.metric_value(
            "supervisor_restarts_total", 0.0, reason="crash")
        restarts_kill = monitor.metric_value(
            "supervisor_restarts_total", 0.0, reason="kill")

        checks = {
            "exact_fleet_accounting": bool(acct["exact"]),
            "every_submit_terminal": seen["terminal"] == seen["submitted"],
            "no_untyped_errors": seen["other_error"] == 0,
            "nothing_admitted_lost_to_routing":
                seen["stopped"] == 0 and seen["failed"] == 0,
            "burst_progressed": seen["completed"] > 0,
            "kill_classified": (h1.last_exit or {}).get("reason") == "kill",
            "restarted_within_budget": restarted and h1.restarts == 1,
            "restarted_replica_serves":
                all(o == "completed" for o in outcomes),
            "restart_counted": restarts_kill >= 1,
            "crash_loop_retired": retired and h2.state == "retired",
            "crash_loop_typed": retired_typed
                and isinstance(h2.error, ReplicaCrashLoop),
            "crash_loop_restarts_bounded": h2.restarts == 2,
            "crash_restarts_counted": restarts_crash >= 2,
            "retired_deregistered": router.get_replica("r2") is None,
            "fleet_serves_through_crash_loop":
                all(o == "completed" for o in outcomes2),
        }
        return {"name": name, "ok": all(checks.values()), "requests": n,
                "caller_view": seen, "router_accounting": acct,
                "restart_elapsed_s": restart_s,
                "victim_status": h1.status(),
                "crashloop_status": h2.status(), "checks": checks,
                "why": "SIGKILLed replica restarted warm under the same "
                       "id within the backoff budget; forced crash loop "
                       "retired typed; fleet ledger exact throughout"}
    finally:
        sup.stop(drain=False)
        router.stop()


def leg_fleet_chaos_negative(name, ci, log_dir=".", aot_dir=""):
    """--fleet-chaos --negative-control: supervision (restarts) and
    bisection BOTH disabled. The poison request must fail its innocent
    batch mates, and the killed replica must stay dead — the gate's
    checks must provably FAIL."""
    router = _chaos_router(request_timeout_s=5.0)
    sup = _chaos_supervisor(router, log_dir, restart=False)
    # bisection off (default), nan checks on: the poison still kills
    # its batch — but now the whole batch dies with it
    base_args = ["--batch-window-s", "0.02", "--max-batch", "4",
                 "--queue-depth", "256",
                 "--set-flag", "FLAGS_check_nan_inf=1"]
    try:
        sup.add_replica("r0", "mlp_tiny", aot_dir, extra_args=base_args)
        sup.add_replica("r1", "mlp_tiny", aot_dir, extra_args=base_args)
        sup.handle("r0").wait_ready(240)
        sup.handle("r1").wait_ready(240)
        router.start()
        assert _wait_routable(router, "r0") and _wait_routable(router, "r1")

        # poison WITHOUT bisection: innocents die with the culprit
        sup.drain("r0")
        assert _wait_removed(router, "r0")
        feeds = [_poison_feed()] + [_mlp_feed(rows=1, seed=100 + i)
                                    for i in range(6)]
        _, outcomes = _submit_concurrent(router, feeds)

        # kill WITHOUT restart: the replica stays dead, the fleet is gone
        sup.kill("r1")
        time.sleep(2.0)
        restarted = _wait_routable(router, "r1", timeout=5.0)
        _, outcomes2 = _submit_concurrent(
            router, [_mlp_feed(rows=1, seed=500 + i) for i in range(4)])
        acct = router.accounting()

        checks = {
            "poison_isolated_typed": outcomes[0] == "poisoned",
            "innocents_complete":
                all(o == "completed" for o in outcomes[1:]),
            "restarted_within_budget": restarted,
            "restarted_replica_serves":
                all(o == "completed" for o in outcomes2),
        }
        return {"name": name, "ok": all(checks.values()),
                "requests": len(feeds), "caller_view": {},
                "poison_outcomes": outcomes,
                "post_kill_outcomes": outcomes2,
                "router_accounting": acct, "checks": checks,
                "why": "restarts + bisection disabled: innocents must "
                       "fail with the poison and the killed replica must "
                       "stay dead — the gate must FAIL"}
    finally:
        sup.stop(drain=False)
        router.stop()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _autoscaler_witness_probe(log_dir="."):
    """Two ticks of a ``FleetAutoscaler`` over a ``ReplicaSupervisor`` and
    its ``FleetRouter`` holding one replica that is not ready (no process
    spawns: the fleet stays calm and below its floor of 0 nothing acts).
    Under ``FLAGS_lock_witness`` each tick takes the supervisor's lock and
    the router replica's lock under the tick lock, edges the static graph
    must predict. The decisions, in order."""
    from paddle_tpu_torch.serving.fleet import (AutoscalerConfig,
                                                FleetAutoscaler, Replica)

    router = _chaos_router()
    sup = _chaos_supervisor(router, log_dir)
    router.add_replica(Replica("witness-probe", "127.0.0.1", 1))
    try:
        auto = FleetAutoscaler(sup, config=AutoscalerConfig(
            min_replicas=0, max_replicas=1))
        return [auto.tick()["action"] for _ in range(2)]
    finally:
        router.remove_replica("witness-probe")


def _witness_gate(static_rep=None):
    """Runtime lock-witness verdict for the artifact and the gate:
    zero runtime lock-order cycles, and every observed edge between
    framework-named locks predicted by the static graph
    (paddle_tpu_torch.analysis.concurrency; ``static_rep`` is a report
    of it already made). Returns (section, ok)."""
    from paddle_tpu_torch.analysis.concurrency import analyze_package

    rep = monitor.witness_report()
    static_rep = static_rep or analyze_package()
    static = static_rep.edge_set()
    known = set(static_rep.locks) | {n for e in static for n in e}
    runtime = sorted(monitor.witness_edges())
    # only framework-named locks participate in the subset check:
    # harness-local locks (this tool, test fixtures) are outside the
    # static scan and prove nothing about the framework
    framework = [e for e in runtime if e[0] in known and e[1] in known]
    extra = sorted(set(framework) - static)
    cycles = rep["cycles"]
    ok = rep["enabled"] and not cycles and not extra
    section = {
        "enabled": rep["enabled"],
        "locks": rep["locks"],
        "runtime_edges": [list(e) for e in runtime],
        "static_edges": sorted(list(e) for e in static),
        "edges_not_in_static_graph": [list(e) for e in extra],
        "runtime_cycles": cycles,
        "ok": ok,
    }
    return section, ok


def _print_witness(witness) -> None:
    locks = witness["locks"]
    tail = max((s["hold"]["p99"] or 0) for s in locks.values()) \
        if locks else 0.0
    print(f"lock witness: {len(locks)} locks, "
          f"{len(witness['runtime_edges'])} runtime edges "
          f"({len(witness['edges_not_in_static_graph'])} outside the "
          f"static graph), {len(witness['runtime_cycles'])} cycle(s), "
          f"worst hold p99 {tail * 1e3:.2f}ms")
    for e in witness["edges_not_in_static_graph"]:
        print(f"       UNPREDICTED edge: {e[0]} -> {e[1]}")
    for c in witness["runtime_cycles"]:
        print(f"       RUNTIME CYCLE: {' -> '.join(c)}")


def _merge_concurrency_json(path, witness) -> None:
    """Land the runtime section next to the static report so the
    torch_lint_concurrency.py JSON artifact carries both halves of the
    gate."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {}
    doc["lock_witness"] = witness
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    print(f"lock_witness section merged into {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ci", action="store_true",
                    help="tiny probes + gate checks (the CI mode)")
    ap.add_argument("--check", action="store_true",
                    help="alias for --ci (sibling-tool convention)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the serving report artifact")
    ap.add_argument("--negative-control", action="store_true",
                    help="disable admission control; the gate must FAIL")
    ap.add_argument("--skip-bert", action="store_true",
                    help="resnet legs only (debugging)")
    ap.add_argument("--decode", action="store_true",
                    help="add the generative legs: a GPT-tiny multi-thread "
                         "generation burst (exact accounting, zero warm "
                         "recompiles, tokens/s + inter-token p50/p99 in "
                         "the artifact) and a chaos sub-leg that kills one "
                         "in-flight batch (affected streams settle typed)")
    ap.add_argument("--fleet", action="store_true",
                    help="run the multi-PROCESS fleet gate instead: two "
                         "replica subprocesses behind the router, one "
                         "SIGTERMed mid-burst (drain honored, unadmitted "
                         "retry, exact fleet-wide accounting) plus the "
                         "cold-vs-warm AOT-cache startup measurement. "
                         "With --negative-control the router runs without "
                         "drain honoring/retry and the gate must FAIL")
    ap.add_argument("--fleet-chaos", action="store_true",
                    help="run the fleet SELF-HEALING gate: a supervised "
                         "2-replica fleet under injected wire faults "
                         "(drop + stall + corrupt), one poison request "
                         "isolated by batch bisection (innocents "
                         "bit-exact), a SIGKILLed replica restarted warm "
                         "within its backoff budget, and a forced crash "
                         "loop retired with a typed ReplicaCrashLoop. "
                         "With --negative-control the supervisor never "
                         "restarts and bisection is off — the gate must "
                         "FAIL")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the fleet CONTROL-LOOP gate: a supervised "
                         "replica + FleetAutoscaler under a hot-tenant "
                         "flood — sustained SLO burn scales out a second "
                         "replica warm (shared AOT cache + shared "
                         "autotune DB, zero re-trials), the hog is shed "
                         "typed tenant_quota while innocent tenants hold "
                         "their p99, calm scales back in strictly via "
                         "preemption-drain (ledger exact), and every "
                         "refusal is typed + metered. With "
                         "--negative-control there is no autoscaler and "
                         "no tenant quotas — the gate must FAIL")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where engines and replica processes run: "
                         "CUDAPlace(0) (default) or the CPU")
    ap.add_argument("--log-dir", default=".",
                    help="where fleet replica stderr logs land")
    ap.add_argument("--lock-witness", action="store_true",
                    help="run with FLAGS_lock_witness=1: every named "
                         "framework lock is instrumented, and after the "
                         "legs the gate additionally requires zero "
                         "runtime lock-order cycles and every observed "
                         "edge to be predicted by the static graph "
                         "(paddle_tpu_torch.analysis.concurrency); "
                         "applies to every mode")
    ap.add_argument("--concurrency-json", metavar="PATH", default=None,
                    help="merge the runtime lock_witness section into "
                         "this existing torch_lint_concurrency.py JSON "
                         "artifact")
    args = ap.parse_args(argv)
    ci = args.ci or args.check
    set_device(args.device)

    if args.lock_witness:
        # before any engine/router/supervisor construction: the factories
        # read the flag once at lock-creation time
        fluid.set_flags({"FLAGS_lock_witness": 1})
        monitor.reset_witness()
    monitor.reset()
    t0 = time.time()
    neg = bool(args.negative_control)
    doc = {}
    if args.fleet_chaos:
        mode = "fleet-chaos"
        legs = _fleet_chaos_legs(ci, neg, args.log_dir)
        gate_ok = all(l["ok"] for l in legs)
    elif args.autoscale:
        mode = "autoscale"
        legs = [leg_autoscale_negative("autoscale_open_loop", ci,
                                       args.log_dir) if neg
                else leg_autoscale("autoscale_control_loop", ci,
                                   args.log_dir)]
        gate_ok = all(l["ok"] for l in legs)
        doc["autoscaler"] = next((l.get("autoscaler") for l in legs
                                  if l.get("autoscaler")), None)
    elif args.fleet:
        mode = "fleet"
        legs = ([leg_fleet_negative("fleet_no_drain_honor", ci,
                                    args.log_dir)] if neg else
                [leg_fleet("fleet_kill_one_replica", ci, args.log_dir),
                 leg_fleet_telemetry("fleet_telemetry_plane", ci,
                                     args.log_dir)])
        gate_ok = all(l["ok"] for l in legs)
        doc["telemetry"] = next((l.get("telemetry") for l in legs
                                 if l.get("telemetry")), None)
    else:
        mode = "serving"
        legs, gate_ok, serving_doc = _serving_legs(args, ci)
        doc.update(serving_doc)
    if mode in ("autoscale", "fleet"):
        doc["warmstart"] = next((l.get("warmstart") for l in legs
                                 if l.get("warmstart")), None)
    witness = None
    if args.lock_witness:
        probe = _autoscaler_witness_probe(args.log_dir)
        witness, w_ok = _witness_gate()
        witness["autoscaler_probe"] = probe
        if not neg:
            gate_ok = gate_ok and w_ok

    for l in legs:
        _print_leg(l)
    if mode == "serving":
        _print_serving(doc)
    if witness is not None:
        _print_witness(witness)
    print(f"serving gate ({time.time() - t0:.1f}s) -> "
          f"{'ok' if gate_ok else 'FAIL'}")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({
                "legs": legs, **doc,
                "lock_witness": witness,
                "device": _DEVICE,
                "snapshot": monitor.snapshot(),
                "check": {"status": "ok" if gate_ok else "fail",
                          "negative_control": neg},
            }, f, indent=2, default=str)
        print(f"{mode} artifact written to {args.json}")
    if args.concurrency_json and witness is not None:
        _merge_concurrency_json(args.concurrency_json, witness)
    return 0 if gate_ok else 1


def _fleet_chaos_legs(ci, neg, log_dir):
    aot_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_fleet_chaos_aot_")
    try:
        if neg:
            return [leg_fleet_chaos_negative("fleet_chaos_no_healing", ci,
                                             log_dir, aot_dir)]
        return [leg_fleet_chaos_wire_poison("fleet_chaos_wire_poison", ci,
                                            log_dir, aot_dir),
                leg_fleet_chaos_supervisor("fleet_chaos_supervisor", ci,
                                           log_dir, aot_dir)]
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)


def _serving_legs(args, ci):
    """The in-process serving (and, with --decode, generative) legs:
    (legs, gate verdict, artifact sections)."""
    legs = []
    if args.negative_control:
        # only the chaos leg matters: with shedding disabled the
        # overload_was_shed requirement must trip the gate
        legs.append(leg_chaos("chaos_resnet_no_shedding", _resnet_engine,
                              ci, shedding=False))
        if args.decode:
            # prefix cache OFF => hit counters must stay zero; spec OFF
            # => no acceptance histogram — both legs must MISS
            legs.append(leg_decode_prefix("decode_gpt_prefix_off", ci,
                                          enabled=False))
            legs.append(leg_decode_spec("decode_gpt_spec_off", ci,
                                        enabled=False))
    else:
        legs.append(leg_steady("steady_resnet", _resnet_engine, ci))
        if not args.skip_bert:
            legs.append(leg_steady("steady_bert", _bert_engine, ci))
        legs.append(leg_chaos("chaos_resnet", _resnet_engine, ci))
        if args.decode:
            legs.append(leg_decode("decode_gpt", ci))
            legs.append(leg_decode_chaos("decode_gpt_chaos", ci))
            legs.append(leg_decode_prefix("decode_gpt_prefix", ci))
            legs.append(leg_decode_spec("decode_gpt_spec", ci))

    latency = _latency_snapshot()
    gate_ok = all(l["ok"] for l in legs) and latency is not None \
        and latency["count"] > 0 and latency["p50"] is not None \
        and latency["p99"] is not None
    decode_report = prefix_report = spec_report = None
    if args.decode and not args.negative_control:
        decode_report = next((l["decode"] for l in legs
                              if l["name"] == "decode_gpt"), None)
        prefix_report = next((l.get("prefix") for l in legs
                              if l["name"] == "decode_gpt_prefix"), None)
        spec_report = next((l.get("spec") for l in legs
                            if l["name"] == "decode_gpt_spec"), None)
        gate_ok = gate_ok and decode_report is not None \
            and (decode_report.get("tokens_per_s") or 0) > 0 \
            and decode_report.get("intertoken_p99_ms") is not None
        # prefix-hit-ratio + first-token p99 in the artifact, bit-exact
        # speculative decode at >= 1.5x tokens/s
        gate_ok = gate_ok and prefix_report is not None \
            and prefix_report["prefix_hit_ratio"] > 0 \
            and prefix_report["first_token_p99_ms"] is not None
        gate_ok = gate_ok and spec_report is not None \
            and spec_report["bit_exact"] \
            and spec_report["speedup"] >= 1.5
    return legs, gate_ok, {"latency_histogram": latency,
                           "decode": decode_report,
                           "decode_prefix": prefix_report,
                           "decode_spec": spec_report}


def _print_leg(l) -> None:
    status = "ok" if l["ok"] else "MISS"
    view = ", ".join(f"{k}={v}" for k, v in
                     sorted(l.get("caller_view", {}).items()) if v)
    print(f"[{status}] {l['name']}: {l['requests']} requests"
          + (f" -> {view}" if view else ""))
    for k, v in sorted(l.get("checks", {}).items()):
        if not v:
            print(f"       FAILED check: {k}")
    if l.get("restart_elapsed_s") is not None:
        print(f"supervisor: kill -> routable again in "
              f"{l['restart_elapsed_s']:.1f}s")
    for tname in sorted(l.get("tenants", {})):
        tview = ", ".join(f"{k}={v}" for k, v in
                          sorted(l["tenants"][tname].items()) if v)
        print(f"tenant {tname}: {tview}")
    ws = l.get("warmstart")
    if ws and ws.get("warm") and "autotune" in ws["warm"]:
        print(f"scale-out warm start: cold ready "
              f"{ws['cold']['time_to_ready_s']:.2f}s -> warm "
              f"{ws['warm']['time_to_ready_s']:.2f}s "
              f"(speedup {ws['ready_speedup']:.1f}x), autotune "
              f"hits={ws['warm']['autotune']['hits']} "
              f"trials={ws['warm']['autotune']['trials']}, "
              f"aot hits={ws['warm']['aot_cache']['hits']} "
              f"misses={ws['warm']['aot_cache']['misses']}")
    elif ws and ws.get("warm"):
        print(f"warm start: cold ready "
              f"{ws['cold']['time_to_ready_s']:.2f}s "
              f"(warm_up {ws['cold']['warm_up_s']:.2f}s) -> warm "
              f"{ws['warm']['time_to_ready_s']:.2f}s "
              f"(warm_up {ws['warm']['warm_up_s']:.2f}s), "
              f"speedup {ws['ready_speedup']:.1f}x ready / "
              f"{ws['warm_up_speedup']:.1f}x warm-up")
    for e in (l.get("autoscaler") or {}).get("audit", []):
        print(f"autoscaler: {e['action']} ({e['reason']}) "
              f"x{e['count']} — {e['detail']}")
    lat = l.get("latency")
    if isinstance(lat, dict) and lat.get("count"):
        print(f"fleet latency: count={lat['count']} "
              f"p50={lat['p50'] * 1e3:.1f}ms "
              f"p99={lat['p99'] * 1e3:.1f}ms")
    tele = l.get("telemetry")
    if tele:
        print(f"telemetry: scraped fleet "
              f"count={tele['scraped_latency_count']} "
              f"p50={(tele['fleet_p50_s'] or 0) * 1e3:.1f}ms "
              f"p99={(tele['fleet_p99_s'] or 0) * 1e3:.1f}ms "
              f"(router completed={tele['router_completed']}), "
              f"tenants={sorted(tele['tenants'])}, "
              f"corrupt scrapes={tele['corrupt_scrapes']}, "
              f"exemplars resolved="
              f"{len(tele['exemplar_resolved_trace_ids'])}")
        print("slo burn: " + " -> ".join(
            f"{st}@{t:.1f}s" for t, st in tele["slo_timeline"]))


def _print_serving(doc) -> None:
    latency = doc["latency_histogram"]
    decode_report = doc["decode"]
    prefix_report = doc["decode_prefix"]
    spec_report = doc["decode_spec"]
    if latency:
        print(f"latency: count={latency['count']} "
              f"p50={latency['p50'] * 1e3:.1f}ms "
              f"p99={latency['p99'] * 1e3:.1f}ms "
              f"max={latency['max'] * 1e3:.1f}ms")
    if decode_report:
        print(f"decode: tokens={decode_report['tokens_total']:.0f} "
              f"tokens/s={decode_report['tokens_per_s']:.1f} "
              f"intertoken p50={decode_report['intertoken_p50_ms']:.2f}ms "
              f"p99={decode_report['intertoken_p99_ms']:.2f}ms")
    if prefix_report:
        print(f"prefix: hit_ratio={prefix_report['prefix_hit_ratio']:.2f} "
              f"pages_reused={prefix_report['pages_reused']} "
              f"first-token cold="
              f"{prefix_report['cold_first_token_avg_ms']:.2f}ms warm="
              f"{prefix_report['warm_first_token_avg_ms']:.2f}ms "
              f"p99={prefix_report['first_token_p99_ms']:.2f}ms")
    if spec_report:
        print(f"speculative: bit_exact={spec_report['bit_exact']} "
              f"tokens/s {spec_report['tokens_per_s_plain']:.1f} -> "
              f"{spec_report['tokens_per_s_spec']:.1f} "
              f"({spec_report['speedup']:.2f}x), accepted/chunk avg="
              f"{spec_report['accepted_len_avg'] or 0:.2f}")


if __name__ == "__main__":
    sys.exit(main())
