#!/usr/bin/env python
"""Auto-remat CI gate of the PyTorch port (``paddle_tpu_torch.analysis.
remat``; counterpart of tools/remat_check.py, with its gates, values and
report keys).

The chooser runs on a BERT-base-shaped training program and the gate
reads the MEMORY PLANNER's predicted peak, the score the executor's
``FLAGS_auto_recompute`` path uses to pick checkpoint sets.

  python tools/torch_remat_check.py --check [--json report.json]
      [--device cpu] [--model bert_base]

Gates (exit 1 on any failure):
  1. positive   — the transform on BERT-base (bs=64, amp) inserts
                  recompute segments with no user-provided checkpoints
                  and drops the predicted peak >= 30%.
  2. budget     — re-running with the budget set to the fitted peak
                  chooses a set whose predicted peak fits the budget.
  3. negative   — with FLAGS_auto_recompute=0 the executor hook returns
                  the SAME program object: zero segments inserted (the
                  tripwire against the transform leaking into un-flagged
                  runs).
  4. bit-exact  — a small MLP trained 4 steps with and without
                  FLAGS_auto_recompute produces bit-identical losses.
  --model bert_base adds the card's leg: BERT-base f32, batch 8, seq
  128, dropout 0, 4 steps with and without FLAGS_auto_recompute from the
  same weights; the losses must be bit-identical (the replay runs the
  same f32 kernels on the same inputs). Each run's measured peak
  (``torch.cuda.max_memory_allocated``) is reported beside the planner's
  predicted peak, not gated.

Runs on ``CUDAPlace(0)`` unless ``--device cpu``."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import torch_gate_probes as probes  # noqa: E402

MIN_PEAK_DROP = 0.30
BERT_BATCH = 64
TRAIN_STEPS = 4


def _gate(name, ok, detail, report):
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}")
    report["gates"].append({"name": name, "ok": bool(ok), "detail": detail})
    return ok


def check_bert(report) -> bool:
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.analysis.remat import auto_recompute_program
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    t0 = time.time()
    with un.guard():
        model = build_bert_pretrain(BertConfig.base(), seq_len=128, amp=True)
    feeds = list(model["feeds"])
    fetches = [model["loss"].name]
    dec = auto_recompute_program(model["main"], feed_names=feeds,
                                 fetch_names=fetches, batch_size=BERT_BATCH)
    drop = 1.0 - dec.peak_after / max(dec.peak_before, 1)
    report["bert"] = dict(dec.to_dict(), seconds=round(time.time() - t0, 1))
    ok = _gate(
        "bert_peak_drop", dec.applied and dec.n_segments > 0
        and drop >= MIN_PEAK_DROP,
        f"applied={dec.applied} segments={dec.n_segments} "
        f"peak {dec.peak_before >> 20} MiB -> {dec.peak_after >> 20} MiB "
        f"(drop {drop:.1%}, need >= {MIN_PEAK_DROP:.0%})", report)

    # budget gate: ask for the peak the free search just achieved (+margin);
    # the chooser must return a set that fits it
    budget_mb = (dec.peak_after >> 20) + 256
    dec_b = auto_recompute_program(model["main"], feed_names=feeds,
                                   fetch_names=fetches,
                                   batch_size=BERT_BATCH,
                                   budget_mb=budget_mb)
    report["bert_budget"] = dict(dec_b.to_dict(), budget_mb=budget_mb)
    ok &= _gate(
        "bert_budget_respected",
        dec_b.applied and dec_b.peak_after <= budget_mb << 20,
        f"budget {budget_mb} MiB, fitted peak "
        f"{dec_b.peak_after >> 20} MiB, k={len(dec_b.checkpoints)}", report)
    return ok


def _ran_program(exe, main):
    """The program the executor ran for ``main`` under its remat hook
    (``main`` itself when the hook passed it through)."""
    from paddle_tpu_torch.analysis.pass_manager import program_fingerprint

    fp = program_fingerprint(main)
    return next((p for k, p in exe._remat_cache.items() if k[0] == fp),
                main)


def check_negative_and_bitexact(report) -> bool:
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un

    # activation-dominated on purpose (wide batch vs narrow weights) so
    # remat has something to win
    width, depth, batch = 128, 8, 256

    def build():
        with un.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data("x", shape=[width], dtype="float32")
                y = fluid.layers.data("y", shape=[1], dtype="float32")
                h = x
                for _ in range(depth):
                    h = fluid.layers.fc(h, width, act="relu")
                pred = fluid.layers.fc(h, 1)
                loss = fluid.layers.mean(
                    fluid.layers.square_error_cost(pred, y))
                fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return main, startup, loss

    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(batch, width).astype(np.float32),
            "y": rng.randn(batch, 1).astype(np.float32)}

    def train(auto: bool):
        main, startup, loss = build()
        main.random_seed = startup.random_seed = 11
        prev = fluid.get_flags(["FLAGS_auto_recompute"])
        fluid.set_flags({"FLAGS_auto_recompute": auto})
        try:
            exe = probes.executor()
            scope = fluid.Scope()
            losses = []
            with fluid.scope_guard(scope):
                exe.run(startup)
                for _ in range(TRAIN_STEPS):
                    (lv,) = exe.run(main, feed=feed,
                                    fetch_list=[loss.name])
                    losses.append(float(np.asarray(lv).reshape(-1)[0]))
            ran = _ran_program(exe, main)
            segs = sum(1 for op in ran.global_block.ops
                       if op.type == "recompute_segment")
            peak = ran.memory_plan(feed_names=["x", "y"],
                                   fetch_names=[loss.name],
                                   batch_size=batch).peak_bytes
            return losses, segs, peak, ran is main
        finally:
            fluid.set_flags(prev)

    base_losses, base_segs, base_peak, base_same = train(False)
    rc_losses, rc_segs, rc_peak, _ = train(True)
    report["negative_control"] = {
        "flag_off_segments": base_segs, "flag_off_peak_bytes": base_peak,
        "flag_off_program_untouched": base_same,
    }
    report["bit_exact"] = {"plain": base_losses, "remat": rc_losses,
                           "remat_segments": rc_segs}
    ok = _gate("negative_control",
               base_segs == 0 and base_same,
               f"FLAGS_auto_recompute=0: segments={base_segs}, program "
               f"untouched={base_same}, peak={base_peak}", report)
    ok &= _gate("bit_exact_training",
                rc_segs > 0 and base_losses == rc_losses,
                f"remat segments={rc_segs}, losses bit-identical="
                f"{base_losses == rc_losses}", report)
    ok &= _gate("remat_peak_improves", rc_peak < base_peak,
                f"predicted peak {base_peak} -> {rc_peak}", report)
    return ok


def check_bert_train(report, seed: int = 0, tiny: bool = False) -> bool:
    """The card's leg: BERT-base f32 (batch 8, seq 128, dropout 0) trained
    ``TRAIN_STEPS`` steps with and without FLAGS_auto_recompute from the
    same weights on fresh executors; losses bit-identical. Reports each
    run's predicted and measured peak."""
    import torch

    import paddle_tpu_torch as fluid

    net, feed, _ = probes.bert_train(seed, tiny=tiny)
    fetch = [net["loss"].name]
    init_exe, init = probes.executor(), fluid.Scope()
    init_exe.run(net["startup"], scope=init)
    on_card = probes.device() == "cuda"

    def train(auto: bool):
        exe, scope = probes.executor(), fluid.Scope()
        for n, t in init.vars.items():
            scope.set_var(n, t.clone())
        prev = fluid.get_flags(["FLAGS_auto_recompute"])
        fluid.set_flags({"FLAGS_auto_recompute": auto})
        try:
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses = []
            for _ in range(TRAIN_STEPS):
                (lv,) = exe.run(net["main"], feed=feed, fetch_list=fetch,
                                scope=scope)
                losses.append(float(np.asarray(lv).reshape(-1)[0]))
            seconds = time.perf_counter() - t0
            measured = torch.cuda.max_memory_allocated() if on_card \
                else None
        finally:
            fluid.set_flags(prev)
        ran = _ran_program(exe, net["main"])
        segs = sum(1 for op in ran.global_block.ops
                   if op.type == "recompute_segment")
        predicted = ran.memory_plan(feed_names=list(feed),
                                    fetch_names=fetch,
                                    batch_size=probes.BERT_BATCH).peak_bytes
        return dict(losses=losses, segments=segs,
                    predicted_peak_bytes=predicted,
                    measured_peak_bytes=measured, seconds=seconds)

    plain, remat = train(False), train(True)
    report["bert_train"] = {"model": "bert_tiny" if tiny else "bert_base",
                            "dtype": "float32", "batch": probes.BERT_BATCH,
                            "seq": probes.BERT_SEQ, "steps": TRAIN_STEPS,
                            "plain": plain, "remat": remat}
    ok = _gate("bert_train_remat_applied",
               plain["segments"] == 0 and remat["segments"] > 0,
               f"segments plain={plain['segments']} "
               f"remat={remat['segments']}", report)
    ok &= _gate("bert_train_losses_bit_identical",
                plain["losses"] == remat["losses"]
                and all(np.isfinite(plain["losses"])),
                f"plain {plain['losses']} remat {remat['losses']}", report)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="run the gates; exit 1 on failure (CI mode)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report (CI artifact)")
    ap.add_argument("--model", choices=("mlp", "bert_base"), default="mlp",
                    help="bert_base adds the full-width BERT-base f32 "
                         "training leg (the card's)")
    probes.add_device_arg(ap)
    args = ap.parse_args(argv)
    probes.set_device(args.device)

    report = {"min_peak_drop": MIN_PEAK_DROP, "gates": []}
    ok = check_bert(report)
    ok &= check_negative_and_bitexact(report)
    if args.model == "bert_base":
        ok &= check_bert_train(report)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.json}")
    if not ok:
        print("remat gate -> FAIL", file=sys.stderr)
        return 1
    print("remat gate: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
