#!/usr/bin/env python
"""Executor runtime-metrics report + CI recompile gate of the PyTorch port
(the reporting face of ``paddle_tpu_torch.monitor``; counterpart of
tools/metrics_report.py, with its scenarios, expectations and artifact).

The port interprets programs op by op and builds no executable: its
compile event is the first run of an executor key
(``monitor/recompile.py``), and a recompile is a later first run of the
same program under changed key components. The gate counts exactly that.

Usage:
  python tools/torch_metrics_report.py [--device cpu]
      Run the suite, print the per-scenario metric summary.
  python tools/torch_metrics_report.py --json report.json
      Also write the machine-readable artifact.
  python tools/torch_metrics_report.py --check
      CI gate: exit 1 if any scenario misses its expected compile/cache
      behaviour or if recompiles exceed --recompile-threshold (default 0 —
      the suite is steady-state by construction, ANY recompile is a
      regression in the cache keying).
  python tools/torch_metrics_report.py --check --force-recompile 3
      Negative control: appends a scenario that grows the feed batch to
      force 3 recompiles; the gate must then FAIL (non-zero exit).
  --model bert_base runs the scenarios at full width (the card's legs):
      run_repeat on BERT-base bf16 fused inference (batch 8, seq 128),
      chained_kept_state as run_chained steps of BERT-base f32 training,
      infer_clone on the inference clone of that model.

Runs on ``CUDAPlace(0)`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import monitor  # noqa: E402
from tools import torch_gate_probes as probes  # noqa: E402

# the (metric, labels) scalars each scenario reports as deltas
_TRACKED = {
    "run_hits": ("executor_cache_lookups_total",
                 {"path": "run", "result": "hit"}),
    "run_misses": ("executor_cache_lookups_total",
                   {"path": "run", "result": "miss"}),
    "run_compiles": ("executor_compiles_total", {"path": "run"}),
    "chained_hits": ("executor_cache_lookups_total",
                     {"path": "chained", "result": "hit"}),
    "chained_misses": ("executor_cache_lookups_total",
                       {"path": "chained", "result": "miss"}),
    "chained_compiles": ("executor_compiles_total", {"path": "chained"}),
    "chained_iterations": ("executor_chained_iterations_total", {}),
    "donated_buffers": ("executor_donated_buffers_total", {}),
    "kept_buffers": ("executor_kept_buffers_total", {}),
    "feed_bytes": ("executor_feed_bytes_total", {}),
    "fetch_bytes": ("executor_fetch_bytes_total", {}),
}

# the BERT-base legs: run_chained steps a call (two calls)
CHAINED_STEPS = 5


def _counters_now() -> dict:
    vals = {}
    for key, (name, labels) in _TRACKED.items():
        v = monitor.metric_value(name, default=0.0, **labels)
        vals[key] = float(v)
    vals["recompiles"] = float(monitor.recompile_count())
    return vals


def _delta(before: dict, after: dict) -> dict:
    return {k: int(after[k] - before[k]) for k in after}


def _build_regression():
    x = fluid.layers.data("x", shape=[13], dtype="float32")
    y = fluid.layers.data("y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(x, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.02).minimize(loss)
    return loss


def _feed(batch=8, dtype=np.float32):
    rng = np.random.RandomState(0)
    return {"x": rng.rand(batch, 13).astype(dtype),
            "y": rng.rand(batch, 1).astype(dtype)}


def _run_twice(program, startup, feed, fetch):
    """Startup outside the window, then two runs of ``program``: the
    counters' deltas over the two."""
    exe = probes.executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        before = _counters_now()
        exe.run(program, feed=feed, fetch_list=fetch)
        exe.run(program, feed=feed, fetch_list=fetch)
    probes.synchronize()
    return _delta(before, _counters_now())


_RUN_ONCE_MORE = {"run_compiles": 1, "run_hits": 1, "run_misses": 1,
                  "recompiles": 0}


def scenario_run_repeat():
    """Two exe.run of the same program/feed: exactly 1 compile + 1 cache
    hit (the acceptance bar for the compile cache)."""
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            loss = _build_regression()
        got = _run_twice(main, startup, _feed(), [loss])
    return {"name": "run_repeat", "metrics": got,
            "expect": dict(_RUN_ONCE_MORE)}


def _chained_twice(main, startup, feed, fetch, steps):
    exe = probes.executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        before = _counters_now()
        for _ in range(2):
            exe.run_chained(main, feed=feed, fetch_list=fetch, steps=steps)
    probes.synchronize()
    return _delta(before, _counters_now())


def _chained_result(got, steps):
    expect = {"chained_compiles": 1, "chained_hits": 1,
              "chained_misses": 1, "chained_iterations": 2 * steps,
              "recompiles": 0}
    return {"name": "chained_kept_state", "metrics": got, "expect": expect,
            "extra_ok": got["donated_buffers"] > 0
            and got["kept_buffers"] == 0,
            "extra_why": "donated>0 and kept==0 (the port updates state "
                         "in place and a fetch copies the fetched param's "
                         "value: no state buffer is kept)"}


def scenario_chained_kept_state():
    """run_chained twice with a fetched param: 1 chained compile + 1 hit,
    the state updated in place (donated) and no buffer kept: the JAX
    executor keeps a fetched param donation-unsafe, the port copies the
    fetched value instead."""
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            loss = _build_regression()
            param = next(v.name for v in main.global_block.vars.values()
                         if type(v).__name__ == "Parameter"
                         and v.name.endswith(".w_0"))
        got = _chained_twice(main, startup, _feed(), [loss, param], 3)
    return _chained_result(got, 3)


def scenario_infer_clone():
    """Inference clone run twice: its own single compile, then cache."""
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[13], dtype="float32")
            pred = fluid.layers.fc(x, 4, act="softmax")
        infer = main.clone(for_test=True)
        feed = {"x": np.random.RandomState(1).rand(8, 13)
                .astype(np.float32)}
        got = _run_twice(infer, startup, feed, [pred.name])
    return {"name": "infer_clone_repeat", "metrics": got,
            "expect": dict(_RUN_ONCE_MORE)}


def scenario_forced_recompile(n: int):
    """Negative control: grow the feed batch size every run so each run
    after the first misses the cache with a fresh signature — n recompiles,
    each diagnosed with changed=('feed_signature',). The --check gate must
    fail on this."""
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            loss = _build_regression()
        exe = probes.executor()
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            before = _counters_now()
            for i in range(n + 1):
                exe.run(main, feed=_feed(batch=8 * (i + 1)),
                        fetch_list=[loss])
    got = _delta(before, _counters_now())
    evs = monitor.recompile_events()
    return {"name": f"forced_recompile_x{n}", "metrics": got,
            "expect": {"recompiles": n}, "forced": True,
            "diagnostic": (evs[-1].to_dict() if evs else None)}


# ------------------------------------------------- the full-width legs

def bert_run_repeat(seed=0, tiny=False):
    """run_repeat on BERT-base bf16 fused inference (batch 8, seq 128)."""
    prog, startup, _, enc, feed = probes.bert_infer(seed, tiny=tiny)
    prev = fluid.get_flags(["FLAGS_epilogue_fusion"])
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    try:
        got = _run_twice(prog, startup, feed, [enc])
    finally:
        fluid.set_flags(prev)
    return {"name": "run_repeat", "metrics": got,
            "expect": dict(_RUN_ONCE_MORE),
            "model": "bert_base bf16 fused inference"}


def bert_chained_kept_state(seed=0, tiny=False):
    """chained_kept_state as two run_chained calls of ``CHAINED_STEPS``
    BERT-base f32 training steps, fetching the loss and the smallest
    parameter."""
    net, feed, _ = probes.bert_train(seed, tiny=tiny)
    blk = net["main"].global_block
    param = min((v for v in blk.vars.values()
                 if type(v).__name__ == "Parameter"),
                key=lambda v: int(np.prod(v.shape)))
    got = _chained_twice(net["main"], net["startup"], feed,
                         [net["loss"], param.name], CHAINED_STEPS)
    return dict(_chained_result(got, CHAINED_STEPS),
                model="bert_base f32 training")


def bert_infer_clone(seed=0, tiny=False):
    """infer_clone on BERT-base's f32 inference clone."""
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.models.bert import build_bert_pretrain

    cfg = probes.bert_config(tiny)
    with un.guard():
        net = build_bert_pretrain(cfg, seq_len=probes.BERT_SEQ,
                                  build_optimizer=False)
    net["startup"].random_seed = seed
    infer = net["main"].clone(for_test=True)
    feed = probes.bert_feed(seed, cfg.vocab_size, probes.BERT_BATCH,
                            probes.BERT_SEQ)
    got = _run_twice(infer, net["startup"], feed, [net["loss"].name])
    return {"name": "infer_clone_repeat", "metrics": got,
            "expect": dict(_RUN_ONCE_MORE),
            "model": "bert_base f32 inference clone"}


SCENARIOS = [scenario_run_repeat, scenario_chained_kept_state,
             scenario_infer_clone]
BERT_SCENARIOS = [bert_run_repeat, bert_chained_kept_state,
                  bert_infer_clone]


def judge(results, recompile_threshold=0):
    """Mark each scenario ok/missed, print the table, and return the
    ``check`` section (the gate's verdict)."""
    suite_ok = True
    for r in results:
        missed = {k: (v, r["metrics"].get(k))
                  for k, v in r["expect"].items()
                  if r["metrics"].get(k) != v}
        r["ok"] = not missed and r.get("extra_ok", True)
        r["missed"] = {k: {"want": w, "got": g}
                       for k, (w, g) in missed.items()}
        if not r.get("forced"):
            suite_ok = suite_ok and r["ok"]
        status = "ok" if r["ok"] else "MISS"
        print(f"[{status}] {r['name']}: " + ", ".join(
            f"{k}={v}" for k, v in sorted(r["metrics"].items()) if v))
        for k, wg in r["missed"].items():
            print(f"       expected {k}={wg['want']}, got {wg['got']}")
    recompiles = monitor.recompile_count()
    gate_ok = suite_ok and recompiles <= recompile_threshold
    print(f"recompiles across suite: {recompiles} "
          f"(threshold {recompile_threshold}) -> "
          f"{'ok' if gate_ok else 'FAIL'}")
    for ev in monitor.recompile_events():
        print(f"  recompile[{ev.path}] program {ev.program_serial} "
              f"built at {ev.build_site}: changed {list(ev.changed)} — "
              f"{ev.detail}")
    return {"recompile_threshold": recompile_threshold,
            "recompiles": recompiles, "suite_ok": suite_ok,
            "status": "ok" if gate_ok else "fail"}


def _print_histograms():
    """Histogram SLO summary: the registry snapshots carry estimated
    p50/p99."""
    for fam in monitor.get_registry().families():
        if fam.kind != "histogram":
            continue
        # only *_seconds histograms are durations; ratio histograms print
        # their raw values
        in_ms = fam.name.endswith("_seconds")

        def _fmt(v):
            return f"{v * 1e3:.2f}ms" if in_ms else f"{v:.4g}"

        for labels, child in fam.children():
            snap = child.snapshot()
            if not snap["count"]:
                continue
            lbl = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            print(f"  {fam.name}{{{lbl}}}: n={snap['count']} "
                  f"p50={_fmt(snap['p50'])} p99={_fmt(snap['p99'])} "
                  f"max={_fmt(snap['max'])}")


def run_suite(model="tiny", force_recompile=0, recompile_threshold=0,
              seed=0, tiny=False):
    """The suite from a reset monitor: ``(results, check)``.
    ``model="bert_base"`` runs the full-width scenarios (``tiny`` gives
    them at BERT-tiny width for a CPU rehearsal)."""
    monitor.reset()
    if model == "bert_base":
        results = [fn(seed, tiny) for fn in BERT_SCENARIOS]
    else:
        results = [fn() for fn in SCENARIOS]
    if force_recompile > 0:
        results.append(scenario_forced_recompile(force_recompile))
    check = judge(results, recompile_threshold)
    return results, check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on missed expectations or recompiles "
                         "above --recompile-threshold (the CI gate)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the metrics snapshot artifact as JSON")
    ap.add_argument("--recompile-threshold", type=int, default=0,
                    help="max tolerated recompiles across the suite "
                         "(default 0)")
    ap.add_argument("--force-recompile", type=int, default=0, metavar="N",
                    help="append a scenario that forces N recompiles "
                         "(negative control: --check must then fail)")
    ap.add_argument("--model", choices=("tiny", "bert_base"),
                    default="tiny",
                    help="bert_base: the full-width scenarios (the card's)")
    probes.add_device_arg(ap)
    args = ap.parse_args(argv)
    probes.set_device(args.device)

    results, check = run_suite(args.model, args.force_recompile,
                               args.recompile_threshold)
    _print_histograms()
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"scenarios": results,
                       "snapshot": monitor.snapshot(),
                       "check": check}, f, indent=2, default=str)
        print(f"metrics artifact written to {args.json}")
    return 0 if (not args.check or check["status"] == "ok") else 1


if __name__ == "__main__":
    sys.exit(main())
