#!/usr/bin/env python
"""End-to-end tracing + cost-model CI gate of the PyTorch port
(``paddle_tpu_torch.trace``; counterpart of tools/trace_check.py, with its
legs, checks and artifact).

Runs a traced serving burst and a traced 3-step train, then chaos legs,
and proves the observability contract:

* **complete traces** — every submitted request appears in EXACTLY ONE
  complete trace: one ``serving.request`` root per trace, no orphan
  spans (every parent id resolves inside the trace), every span closed,
  and the root closes at-or-after its children; same for the trainer's
  per-step traces.
* **flight recorder** — an injected ``batch_dispatch`` fault and a
  watchdog-killed hang each produce an incident whose span dump contains
  the failed request's full chain (submit → enqueue → batch → dispatch
  → typed outcome). The ``--negative-control`` run disables the flight
  recorder (``FLAGS_flight_recorder_size=0``) and the gate must FAIL —
  proving the dump is what carries the fault context.
* **overhead guard** — with ``FLAGS_trace=0`` the span hot path must
  cost near-zero (no allocation; bounded ns/span measured here).
* **cost model** — per-program FLOPs from the ``cost_model`` pass agree
  with the hand-derived analytic counts for ResNet-50 and BERT-base
  within 10%, and the measured legs report the ``executor_mfu`` /
  ``serving_bucket_mfu`` gauges (against ``FLAGS_device_peak_tflops``)
  in the artifact.

Usage:
  python tools/torch_trace_check.py --check --json ci_trace_report.json
  python tools/torch_trace_check.py --check --negative-control  # exit 1
  --model bert_base runs the measured legs at full width (the card's):
      the burst and both incidents through a batching engine over
      BERT-base bf16 fused inference (seq 128), the trainer legs as
      BERT-base f32 (batch 8, seq 128, dropout 0) through contrib.Trainer.
  --timeline PATH profiles the serving burst and writes one Chrome trace
      merging its profiler host events and trace spans
      (tools/torch_timeline.py).

Runs on ``CUDAPlace(0)`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import monitor, serving, trace  # noqa: E402
from paddle_tpu_torch.resilience import fault_plan_guard  # noqa: E402
from tools import torch_gate_probes as probes  # noqa: E402


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def _config():
    return serving.ServingConfig(max_batch=4, queue_depth=64)


def _mlp_engine(config=None):
    import paddle_tpu_torch.layers as layers
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.framework import Program, program_guard

    with un.guard():
        main, startup = Program(), Program()
        with program_guard(main, startup):
            x = layers.data("x", shape=[8], dtype="float32")
            h = layers.fc(x, size=16, act="relu")
            y = layers.fc(h, size=4)
        infer = main.clone(for_test=True)
    exe = probes.executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
    eng = serving.ServingEngine(
        infer, feed_names=["x"], fetch_list=[y.name], scope=scope,
        executor=exe, config=config or _config())

    def feed(rows=1, seed=0):
        rng = np.random.RandomState(seed)
        return {"x": rng.rand(rows, 8).astype(np.float32)}

    return eng, feed


def bert_engine_factory(seed=0, tiny=False):
    """``make_engine() -> (engine, feed)``: a batching ServingEngine over
    BERT-base bf16 inference (fused under ``FLAGS_epilogue_fusion``, which
    the caller sets), each engine on fresh parameters from ``seed``."""
    prog, startup, names, enc, _ = probes.bert_infer(seed, tiny=tiny)
    vocab = probes.bert_config(tiny).vocab_size

    def make_engine(config=None):
        exe, scope = probes.executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        eng = serving.ServingEngine(prog, feed_names=names,
                                    fetch_list=[enc], scope=scope,
                                    executor=exe,
                                    config=config or _config())

        def feed(rows=1, seed=0):
            data = probes.bert_feed(seed, vocab, rows, probes.BERT_SEQ)
            return {n: data[n] for n in names}

        return eng, feed

    return make_engine


def _tiny_trainer(steps):
    """(train_func, optimizer_func, reader, feed_order) of the JAX tool's
    fc/SGD trainer."""
    def train_func():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, 1)
        return fluid.layers.mean(
            fluid.layers.square_error_cost(pred, y))

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(steps):
            yield [(rng.rand(4).astype(np.float32),
                    rng.rand(1).astype(np.float32)) for _ in range(8)]

    return train_func, lambda: fluid.optimizer.SGD(0.1), reader, ["x", "y"]


def bert_trainer(steps, seed=0, tiny=False):
    """The same for BERT-base f32 pretraining (dropout 0, Adam, batch 8,
    seq 128): each step one synthetic batch."""
    from paddle_tpu_torch.models.bert import bert_pretrain_net

    cfg = probes.bert_config(tiny)
    order = ["src_ids", "pos_ids", "sent_ids", "input_mask", "mask_label",
             "next_sent_label"]

    def train_func():
        return bert_pretrain_net(cfg, probes.BERT_SEQ)["loss"]

    def reader():
        for step in range(steps):
            b = probes.bert_feed(seed + step, cfg.vocab_size,
                                 probes.BERT_BATCH, probes.BERT_SEQ)
            yield [tuple(b[n][j] for n in order)
                   for j in range(probes.BERT_BATCH)]

    return (train_func, lambda: fluid.optimizer.Adam(learning_rate=1e-4),
            reader, order)


def _verify_trace(trace_id: str) -> dict:
    """Structural checks over one finished trace pulled from the
    collector. Returns per-check booleans."""
    tree = trace.trace_tree(trace_id)
    ids = {s.span_id for s in tree}
    roots = [s for s in tree if s.parent_id is None]
    closed = all(s.duration_s is not None for s in tree)
    no_orphans = all(s.parent_id is None or s.parent_id in ids
                     for s in tree)
    parent_after_children = True
    by_id = {s.span_id: s for s in tree}
    for s in tree:
        p = by_id.get(s.parent_id) if s.parent_id else None
        if p is None or p.duration_s is None or s.duration_s is None:
            continue
        if (p.t0_mono + p.duration_s) + 1e-6 < (s.t0_mono + s.duration_s):
            parent_after_children = False
    return {"spans": len(tree), "one_root": len(roots) == 1,
            "all_closed": closed, "no_orphans": no_orphans,
            "parent_closes_after_children": parent_after_children,
            "root_has_outcome": bool(roots)
            and roots[0].attrs.get("outcome") is not None}


def leg_serving_burst(n_requests=24, n_threads=3, make_engine=None,
                      timeline=None) -> dict:
    """Traced burst: every request -> exactly one complete trace. With
    ``timeline`` the burst runs under the profiler and one merged Chrome
    trace of its host events and spans is written there."""
    trace.clear()
    eng, feed = (make_engine or _mlp_engine)()
    futs, lock = [], threading.Lock()
    prof_dir = tempfile.mkdtemp(prefix="trace_check_prof_") \
        if timeline else None

    def burst():
        with eng:
            def submitter(tid):
                for i in range(tid, n_requests, n_threads):
                    with fluid.profiler.RecordEvent("trace_check::submit"):
                        f = eng.submit(feed(rows=1 + i % 2, seed=i))
                    with lock:
                        futs.append(f)
            ts = [threading.Thread(target=submitter, args=(t,))
                  for t in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            for f in futs:
                f.result(timeout=60)

    timeline_events = None
    try:
        if timeline:
            with fluid.profiler.profiler(profile_path=prof_dir):
                burst()
            spans_path = os.path.join(prof_dir, "spans.jsonl")
            trace.export_jsonl(spans_path)
            from tools import torch_timeline

            if torch_timeline.convert(prof_dir, timeline,
                                      trace_path=spans_path) == 0:
                with open(timeline) as f:
                    timeline_events = len(json.load(f)["traceEvents"])
        else:
            burst()
    finally:
        if prof_dir:
            shutil.rmtree(prof_dir, ignore_errors=True)
    per_request = [_verify_trace(f.trace_id) for f in futs]
    unique_traces = len({f.trace_id for f in futs})
    # the dispatch span proves submit-thread -> dispatch-thread
    # propagation: it lives on the dispatch thread under the submit
    # thread's root
    cross_thread = 0
    for f in futs:
        tree = trace.trace_tree(f.trace_id)
        root = next(s for s in tree if s.parent_id is None)
        cross_thread += any(s.name == "serving.dispatch"
                            and s.thread != root.thread for s in tree)
    acct = eng.accounting()
    checks = {
        "all_submitted": len(futs) == n_requests,
        "one_trace_per_request": unique_traces == n_requests,
        "every_trace_complete": all(
            all(v for k, v in pr.items() if k != "spans")
            for pr in per_request),
        "chain_depth": all(pr["spans"] >= 4 for pr in per_request),
        "cross_thread_parentage": cross_thread == n_requests,
        "accounting_carries_trace_ids": all(
            r["trace_id"] for r in acct["recent_outcomes"]),
        "exact_accounting": acct["exact"],
    }
    if timeline:
        checks["timeline_written"] = bool(timeline_events)
    out = {"name": "serving_burst", "ok": all(checks.values()),
           "checks": checks, "requests": n_requests,
           "example_trace": per_request[0] if per_request else None}
    if timeline:
        out["timeline"] = {"path": timeline, "events": timeline_events}
    return out


def leg_trainer_steps(tmp_dir: str, steps=3, trainer=None) -> dict:
    """Traced 3-step train: one complete root trace per step with data +
    executor children and a checkpoint child on the saving step."""
    import paddle_tpu_torch.unique_name as un

    trace.clear()
    train_func, opt_func, reader, order = (trainer or _tiny_trainer)(steps)
    # fresh dir per run: a stale serial from a previous gate run would
    # resume past the epoch and train zero steps
    ckpt_dir = tempfile.mkdtemp(prefix="trace_ckpt_", dir=tmp_dir)
    try:
        ckpt = fluid.contrib.CheckpointConfig(ckpt_dir, step_interval=steps)
        with un.guard():
            tr = fluid.contrib.Trainer(train_func, opt_func,
                                       place=probes.place(),
                                       checkpoint_config=ckpt)
            tr.train(num_epochs=1, event_handler=lambda ev: None,
                     reader=lambda: reader(), feed_order=order)
        probes.synchronize()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    step_roots = [s for s in trace.spans()
                  if s.name == "trainer.step" and s.parent_id is None]
    verified = [_verify_trace(s.trace_id) for s in step_roots]
    has_children = []
    ckpt_spans = 0
    for s in step_roots:
        tree = trace.trace_tree(s.trace_id)
        names = {t.name for t in tree}
        has_children.append("trainer.data" in names
                            and "executor.run" in names)
        ckpt_spans += "trainer.checkpoint" in names
    checks = {
        "step_traces": len(step_roots) == steps,
        "every_trace_complete": bool(verified) and all(
            all(v for k, v in pr.items() if k != "spans")
            for pr in verified),
        "data_and_dispatch_children": all(has_children),
        "checkpoint_span_present": ckpt_spans >= 1,
    }
    return {"name": "trainer_steps", "ok": all(checks.values()),
            "checks": checks, "steps": steps}


def _find_chain(incident: dict, trace_id: str) -> set:
    return {d["name"] for d in incident["recent_spans"]
            if d["trace_id"] == trace_id}


def leg_batch_fault_flight(make_engine=None) -> dict:
    """Injected batch_dispatch fault: the BatchFailed incident must ship
    the failed request's full span chain."""
    trace.clear()
    trace.clear_incidents()
    eng, feed = (make_engine or _mlp_engine)()
    err = None
    with eng, fault_plan_guard("batch_dispatch:1:RuntimeError"):
        fut = eng.submit(feed(rows=1, seed=0))
        try:
            fut.result(timeout=60)
        except serving.BatchFailed as e:
            err = e
    incs = [i for i in trace.incidents() if i["kind"] == "batch_failed"]
    chain = _find_chain(incs[-1], fut.trace_id) if incs else set()
    want = {"serving.request", "serving.submit", "serving.enqueue",
            "serving.dispatch"}
    batch_in_dump = any(d["name"] == "serving.batch"
                        for d in incs[-1]["recent_spans"]) if incs else False
    root = [d for d in (incs[-1]["recent_spans"] if incs else ())
            if d["trace_id"] == fut.trace_id
            and d["name"] == "serving.request"]
    checks = {
        "batch_failed_typed": err is not None,
        "error_carries_trace_id": getattr(err, "trace_id", "")
        == fut.trace_id,
        "incident_recorded": bool(incs),
        "full_chain_in_dump": want <= chain,
        "batch_span_in_dump": batch_in_dump,
        "typed_outcome_in_dump": bool(root)
        and root[0]["attrs"].get("outcome") == "failed",
    }
    return {"name": "batch_fault_flight", "ok": all(checks.values()),
            "checks": checks,
            "dumped_chain": sorted(chain),
            "flight_recorder_enabled":
                incs[-1]["flight_recorder_enabled"] if incs else None}


def leg_watchdog_flight(make_engine=None) -> dict:
    """A watchdog-killed hang must dump the flight recorder with the
    hung request's span chain."""
    trace.clear()
    trace.clear_incidents()
    wd0 = monitor.metric_value("watchdog_timeouts_total", 0.0,
                               section="step")
    eng, feed = (make_engine or _mlp_engine)()
    fluid.set_flags({"FLAGS_step_timeout_s": 2.0,
                     "FLAGS_watchdog_hard_exit": 0})
    err = None
    try:
        with eng, fault_plan_guard("hang:@1:hang"):
            fut = eng.submit(feed(rows=1, seed=0))
            try:
                fut.result(timeout=60)
            except serving.BatchFailed as e:
                err = e
    finally:
        fluid.set_flags({"FLAGS_step_timeout_s": 0.0,
                         "FLAGS_watchdog_hard_exit": 1})
    wd = monitor.metric_value("watchdog_timeouts_total", 0.0,
                              section="step") - wd0
    incs = [i for i in trace.incidents()
            if i["kind"] == "watchdog_timeout"]
    # the request chain at expiry: submit/enqueue closed; the root +
    # dispatch close AFTER the typed failure, so the batch_failed
    # incident (also fired) carries the terminal chain
    chain_at_expiry = _find_chain(incs[-1], fut.trace_id) if incs else set()
    batch_incs = [i for i in trace.incidents()
                  if i["kind"] == "batch_failed"]
    final_chain = _find_chain(batch_incs[-1], fut.trace_id) \
        if batch_incs else set()
    want = {"serving.request", "serving.submit", "serving.enqueue",
            "serving.dispatch"}
    checks = {
        "watchdog_fired": wd >= 1,
        "hang_failed_typed": err is not None,
        "watchdog_incident_recorded": bool(incs),
        "expiry_dump_has_request_context": bool(chain_at_expiry),
        "terminal_dump_full_chain": want <= final_chain,
    }
    return {"name": "watchdog_flight", "ok": all(checks.values()),
            "checks": checks,
            "watchdog_timeouts": wd,
            "chain_at_expiry": sorted(chain_at_expiry),
            "terminal_chain": sorted(final_chain)}


def leg_overhead(n=200_000, budget_ns=3000) -> dict:
    """FLAGS_trace=0 span hot path: bounded ns/span, no allocation
    (identity singleton)."""
    fluid.set_flags({"FLAGS_trace": 0})
    assert not trace.enabled()
    spans = [trace.span("bench") for _ in range(4)]
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("bench"):
            pass
    disabled_ns = (time.perf_counter() - t0) / n * 1e9
    fluid.set_flags({"FLAGS_trace": 1})
    t0 = time.perf_counter()
    for _ in range(n // 20):
        with trace.span("bench"):
            pass
    enabled_ns = (time.perf_counter() - t0) / (n // 20) * 1e9
    trace.clear()
    checks = {
        "no_allocation_when_disabled": all(s is trace.NOOP_SPAN
                                           for s in spans),
        "disabled_under_budget": disabled_ns < budget_ns,
    }
    return {"name": "overhead_guard", "ok": all(checks.values()),
            "checks": checks,
            "disabled_ns_per_span": round(disabled_ns),
            "enabled_ns_per_span": round(enabled_ns),
            "budget_ns": budget_ns}


def leg_cost_model() -> dict:
    """Cost-model FLOPs vs hand-derived analytic counts, ±10%."""
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.analysis.cost_model import estimate_cost
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    from paddle_tpu_torch.models.resnet import build_resnet

    results = {}
    # ResNet-50 @224 train: analytic 2/MAC convention — fwd 2*4.089
    # GMAC ≈ 8.18 GF/img, backward ≈ 2x fwd => ~24.5 GF/img
    with un.guard():
        rn = build_resnet(depth=50, class_num=1000, amp=True)
    rep = estimate_cost(rn["main"], batch_size=128)
    per_img = rep.flops_total / 128
    results["resnet50_train"] = {
        "cost_model_gflops_per_img": round(per_img / 1e9, 2),
        "analytic_gflops_per_img": 24.55,
        "ratio": round(per_img / 24.55e9, 3)}
    with un.guard():
        rn_i = build_resnet(depth=50, class_num=1000,
                            build_optimizer=False)
    rep_i = estimate_cost(rn_i["main"].clone(for_test=True),
                          batch_size=128)
    per_img_i = rep_i.flops_total / 128
    results["resnet50_infer"] = {
        "cost_model_gflops_per_img": round(per_img_i / 1e9, 2),
        "analytic_gflops_per_img": 8.18,
        "ratio": round(per_img_i / 8.18e9, 3)}
    # BERT-base pretrain: 6ND + the attention-score term
    cfg = BertConfig.base()
    B, S = 8, 128
    with un.guard():
        bm = build_bert_pretrain(cfg, seq_len=S, amp=True)
    rep_b = estimate_cost(bm["main"], batch_size=B)
    analytic_b = 6 * 110e6 * B * S \
        + 3 * 4 * B * S * S * cfg.hidden_size * cfg.num_layers
    results["bert_base_train"] = {
        "cost_model_gflops": round(rep_b.flops_total / 1e9, 1),
        "analytic_gflops": round(analytic_b / 1e9, 1),
        "ratio": round(rep_b.flops_total / analytic_b, 3)}
    checks = {f"{k}_within_10pct": abs(v["ratio"] - 1.0) <= 0.10
              for k, v in results.items()}
    # intensity sanity: training must move more FLOPs/byte than zero
    checks["arithmetic_intensity_positive"] = rep.flops_per_byte > 0
    return {"name": "cost_model", "ok": all(checks.values()),
            "checks": checks, "results": results}


def _mfu_figures() -> dict:
    """The measured MFU gauges the traced legs produced (against
    ``FLAGS_device_peak_tflops``)."""
    out = {}
    snap = monitor.get_registry().to_dict()
    for name in ("executor_mfu", "serving_bucket_mfu",
                 "executor_achieved_tflops",
                 "serving_bucket_achieved_tflops",
                 "executor_model_gflops_per_step"):
        fam = snap.get(name)
        out[name] = [{"labels": s.get("labels", {}),
                      "value": s.get("value")}
                     for s in (fam or {}).get("values", [])][:12]
    return out


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def run_legs(tmp_dir, negative_control=False, model="tiny", seed=0,
             tiny=False, timeline=None):
    """Every leg, from a reset monitor and collector: ``(legs, mfu)``.
    ``model="bert_base"`` runs the measured legs at full width (``tiny``
    at BERT-tiny width for a CPU rehearsal); the serving legs then run
    under ``FLAGS_epilogue_fusion``."""
    monitor.reset()
    trace.get_collector().reset()
    bert = model == "bert_base"
    prev = fluid.get_flags(["FLAGS_epilogue_fusion"])
    fluid.set_flags({"FLAGS_trace": 1})
    if negative_control:
        # trace stays ON but the ring is disabled: incidents then ship
        # WITHOUT span context and the flight-recorder legs must fail
        fluid.set_flags({"FLAGS_flight_recorder_size": 0})
    make_engine = trainer = None
    if bert:
        fluid.set_flags({"FLAGS_epilogue_fusion": True})
        make_engine = bert_engine_factory(seed, tiny)

        def trainer(steps):
            return bert_trainer(steps, seed, tiny)
    try:
        legs = [leg_serving_burst(make_engine=make_engine,
                                  timeline=timeline),
                leg_trainer_steps(tmp_dir, trainer=trainer),
                leg_batch_fault_flight(make_engine),
                leg_watchdog_flight(make_engine),
                leg_cost_model()]
        mfu = _mfu_figures()
        legs.append(leg_overhead())      # flips FLAGS_trace off/on; last
    finally:
        fluid.set_flags(dict(prev, FLAGS_trace=0,
                             FLAGS_flight_recorder_size=256))
    return legs, mfu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="run the CI gate")
    ap.add_argument("--json", metavar="PATH",
                    help="write ci_trace_report.json")
    ap.add_argument("--negative-control", action="store_true",
                    help="disable the flight recorder; the gate must "
                         "FAIL (fault context lost)")
    ap.add_argument("--tmp", default=None,
                    help="scratch dir for the trainer leg (default: the "
                         "system temp dir)")
    ap.add_argument("--model", choices=("tiny", "bert_base"),
                    default="tiny",
                    help="bert_base: the measured legs at full width")
    ap.add_argument("--timeline", metavar="PATH",
                    help="profile the serving burst and write the merged "
                         "Chrome trace here")
    probes.add_device_arg(ap)
    args = ap.parse_args(argv)
    probes.set_device(args.device)

    t0 = time.time()
    legs, mfu = run_legs(args.tmp or tempfile.gettempdir(),
                         args.negative_control, args.model,
                         timeline=args.timeline)
    gate_ok = all(leg["ok"] for leg in legs)
    for leg in legs:
        print(f"[{'ok' if leg['ok'] else 'MISS'}] {leg['name']}")
        for k, v in sorted(leg.get("checks", {}).items()):
            if not v:
                print(f"       FAILED check: {k}")
    print(f"trace gate ({time.time() - t0:.1f}s) -> "
          f"{'ok' if gate_ok else 'FAIL'}")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({
                "legs": legs,
                "mfu_figures": mfu,
                "incidents": trace.incidents(),
                "check": {"status": "ok" if gate_ok else "fail",
                          "negative_control":
                              bool(args.negative_control)},
            }, f, indent=2, default=str)
        print(f"trace artifact written to {args.json}")
    return 0 if gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
