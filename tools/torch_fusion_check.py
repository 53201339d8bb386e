#!/usr/bin/env python
"""Epilogue-fusion + persistent-autotuner gate of the PyTorch port
(counterpart of ``tools/fusion_check.py``: ``analysis/epilogue_fusion.py``,
``ops/fused_gemm.py``, ``paddle_tpu_torch.tuning``).

  python tools/torch_fusion_check.py --check [--cpu] [--json PATH]
  python tools/torch_fusion_check.py --negative-control [--cpu]

Runs on the card (``CUDAPlace(0)``) unless ``--cpu`` asks for the CPU.
Gates (exit 1 on any failure, with the ``-> FAIL`` marker):

  1. fusion_applies — the pass fuses >= 1 chain on every probe (an MLP
     gelu/relu stack, BERT-tiny and ResNet-18 inference), the executor
     runs the fused program, and the fused program passes the full
     static-analysis pipeline (``ALL_ANALYSIS_PASSES``) with zero errors.
  2. parity        — fused against unfused fetches: bit-exact on the CPU
     (the dense route replays the original op rules), within the fusion
     witness's declared tolerance on the card (K5 sums in its own order).
  3. not_slower    — on the card only: the fused per-step time (chained
     differencing, ``tuning.chained_step_seconds``) at most the unfused
     one times ``CUDA_SLACK``. On the CPU both legs run the same op rules,
     so the gate is reported as not applicable.
  4. autotune_roundtrip — a fresh subprocess under
     ``FLAGS_autotune=measure`` measures every default candidate (K5's
     compiled tilings) on the MLP probe into a cost database; a SECOND
     fresh subprocess under ``use`` runs straight at the recorded best:
     ``autotune_hits_total >= 1``, the run's block triple equals the
     recorded best (on the card: every K5 launch at that triple), and the
     database's trial count is unchanged.

``--negative-control``: with ``FLAGS_epilogue_fusion=0`` the MLP probe runs
no fused op and its fetch is bit-equal to a run whose fusion entry is
disabled outright; exits 0 when confirmed.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# fused step at most this times the unfused one on the card: K5 at the
# probes' small shapes is within a few percent of cuBLAS, and the chained
# per-step times of millisecond steps swing with the host
CUDA_SLACK = 1.25


def _gate(name, ok, detail, report):
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    report["gates"].append({"name": name, "ok": bool(ok), "detail": detail})
    return ok


# ---------------------------------------------------------------------------
# probes — forward-only programs with fusable chains
# ---------------------------------------------------------------------------

def probe_mlp():
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[512], dtype="float32")
            h = fluid.layers.fc(x, 512, act="gelu")
            h = fluid.layers.fc(h, 512, act="relu")
            h = fluid.layers.fc(h, 512, act="gelu")
            pred = fluid.layers.fc(h, 128)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(256, 512).astype(np.float32)}
    return main, startup, pred.name, feed


def probe_bert_tiny():
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    cfg = BertConfig.tiny()
    seq, batch = 32, 4
    with un.guard():
        model = build_bert_pretrain(cfg, seq_len=seq, build_optimizer=False)
    infer = model["main"].clone(for_test=True)
    rng = np.random.RandomState(0)
    feed = {
        "src_ids": rng.randint(0, cfg.vocab_size, (batch, seq)),
        "pos_ids": np.tile(np.arange(seq), (batch, 1)),
        "sent_ids": np.zeros((batch, seq)),
        "input_mask": np.ones((batch, seq), np.float32),
        "mask_label": rng.randint(0, cfg.vocab_size, (batch, seq)),
        "next_sent_label": rng.randint(0, 2, (batch, 1)),
    }
    for k in ("src_ids", "pos_ids", "sent_ids", "mask_label",
              "next_sent_label"):
        feed[k] = feed[k].astype(np.int64)
    return infer, model["startup"], model["loss"].name, feed


def probe_resnet_tiny():
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.models.resnet import build_resnet

    with un.guard():
        model = build_resnet(depth=18, class_num=128,
                             image_shape=(3, 32, 32), build_optimizer=False)
    infer = model["main"].clone(for_test=True)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 128, (8, 1)).astype(np.int64)}
    return infer, model["startup"], model["logits"].name, feed


PROBES = {"mlp": probe_mlp, "bert_tiny": probe_bert_tiny,
          "resnet_tiny": probe_resnet_tiny}


def _place(cpu: bool):
    import paddle_tpu_torch as fluid

    return fluid.CPUPlace() if cpu else fluid.CUDAPlace(0)


def run_probe(name, fused: bool, cpu: bool):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import tuning

    main, startup, fetch, feed = PROBES[name]()
    startup.random_seed = 7
    prev = fluid.get_flags(["FLAGS_epilogue_fusion"])
    fluid.set_flags({"FLAGS_epilogue_fusion": fused})
    try:
        exe, scope = fluid.Executor(_place(cpu)), fluid.Scope()
        exe.run(startup, scope=scope)
        (out,) = exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
        per_step = tuning.chained_step_seconds(
            exe, main, feed, [fetch], scope, k_short=2, k_long=10,
            repeats=5)
        decs = list(exe._fusion_decisions.values())
        dec = decs[0] if decs else None
        # what the executor ACTUALLY ran: fused ops across the programs
        # behind its keys (the negative control's real signal)
        n_fused_exec = sum(1 for step in exe._cache.values()
                           for blk in step.program.blocks
                           for op in blk.ops
                           if op.type == "fused_gemm_epilogue")
        return {"probe": name, "fused": fused, "per_step_s": per_step,
                "n_fused": dec.n_fused if dec is not None and dec.applied
                else 0, "n_fused_exec": n_fused_exec, "decision": dec,
                "feed_names": sorted(feed), "fetch_names": [fetch],
                "out": np.asarray(out)}
    finally:
        fluid.set_flags(prev)


def check_fusion_legs(report, cpu: bool) -> bool:
    from paddle_tpu_torch.analysis.diagnostics import Severity
    from paddle_tpu_torch.analysis.epilogue_fusion import WITNESS_TOLERANCES
    from paddle_tpu_torch.analysis.pass_manager import (ALL_ANALYSIS_PASSES,
                                                        default_pass_manager)

    ok = True
    report["legs"] = {}
    for name in PROBES:
        base = run_probe(name, False, cpu)
        fus = run_probe(name, True, cpu)
        leg = {"unfused_per_step_s": base["per_step_s"],
               "fused_per_step_s": fus["per_step_s"],
               "speedup": base["per_step_s"] / fus["per_step_s"],
               "n_fused": fus["n_fused"], "n_fused_exec": fus["n_fused_exec"]}
        report["legs"][name] = leg
        ok &= _gate(f"{name}_fusion_applies",
                    fus["n_fused"] > 0 and fus["n_fused_exec"] > 0,
                    f"{fus['n_fused']} fused chain(s), "
                    f"{fus['n_fused_exec']} fused op(s) run", report)
        if cpu:
            par = np.array_equal(base["out"], fus["out"])
            detail = "bit-exact (dense route replays the original rules)"
        else:
            rtol, atol = WITNESS_TOLERANCES.get(
                str(base["out"].dtype), WITNESS_TOLERANCES["float32"])
            par = np.allclose(base["out"].astype(np.float32),
                              fus["out"].astype(np.float32),
                              rtol=rtol, atol=atol)
            detail = (f"within the witness tolerance rtol={rtol} "
                      f"atol={atol}")
        leg["parity"] = bool(par)
        ok &= _gate(f"{name}_parity", par, detail, report)
        timing = (f"fused {fus['per_step_s'] * 1e3:.3f} ms vs unfused "
                  f"{base['per_step_s'] * 1e3:.3f} ms (speedup "
                  f"{leg['speedup']:.2f}x)")
        if cpu:
            print(f"[n/a] {name}_not_slower: {timing} — on the CPU both "
                  f"legs run the same op rules; the gate is the card's",
                  flush=True)
        else:
            ok &= _gate(f"{name}_not_slower",
                        fus["per_step_s"] <= base["per_step_s"] * CUDA_SLACK,
                        timing + f", slack {CUDA_SLACK}", report)
        dec = fus["decision"]
        if dec is None:
            ok &= _gate(f"{name}_fused_lint_clean", False,
                        "no fusion decision recorded", report)
            continue
        result = default_pass_manager().run_pipeline(
            dec.program, ALL_ANALYSIS_PASSES, feed_names=fus["feed_names"],
            fetch_names=fus["fetch_names"], verify="none")
        errs = [str(d) for d in result.diagnostics
                if d.severity == Severity.ERROR]
        leg["lint_errors"] = errs
        ok &= _gate(f"{name}_fused_lint_clean", not errs,
                    f"{len(errs)} error(s)" + (f": {errs[0]}" if errs
                                               else ""), report)
    return ok


# ---------------------------------------------------------------------------
# autotune round trip (two fresh subprocesses against one DB file)
# ---------------------------------------------------------------------------

def _child(mode: str, db_path: str, cpu: bool) -> int:
    """Subprocess body: measure populates the DB; use must hit it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor, tuning

    fg = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")
    main, startup, fetch, feed = probe_mlp()
    startup.random_seed = 7
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    exe, scope = fluid.Executor(_place(cpu)), fluid.Scope()
    out = {"mode": mode, "fp": tuning.program_content_fingerprint(main),
           "backend": tuning.backend_name(exe.device)}
    exe.run(startup, scope=scope)
    db = tuning.get_database(db_path)
    if mode == "measure":
        rep = tuning.measure_candidates(
            exe, main, feed, [fetch], scope, k_short=2, k_long=4,
            candidates=tuning.default_candidates(include_gemm_blocks=True))
        out["statuses"] = [t["status"] for t in rep["trials"]]
        out["best"] = rep["best"]["candidate"] if rep["best"] else None
    else:
        by0 = dict(fg.fused_gemm.launches_by_blocks)
        exe.run_chained(main, feed=feed, fetch_list=[fetch], steps=2,
                        scope=scope)
        comps = [e.components.get("gemm_blocks")
                 for e in monitor.recompile_events(recompiles_only=False)
                 if e.path == "chained"]
        out["hits"] = monitor.metric_value("autotune_hits_total") or 0
        out["run_blocks"] = list(comps[-1]) if comps and comps[-1] else None
        out["launches_by_blocks"] = {
            ",".join(map(str, b)): n - by0.get(b, 0)
            for b, n in fg.fused_gemm.launches_by_blocks.items()
            if n != by0.get(b, 0)}
    out["trials"] = db.trial_count()
    print("CHILD_JSON:" + json.dumps(out), flush=True)
    return 0


def _spawn(mode: str, db_path: str, cpu: bool) -> dict:
    env = dict(os.environ, FLAGS_autotune=mode, FLAGS_autotune_db=db_path)
    cmd = [sys.executable, os.path.abspath(__file__), "--child", mode,
           "--db", db_path] + (["--cpu"] if cpu else [])
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("CHILD_JSON:"):
            return json.loads(line[len("CHILD_JSON:"):])
    raise RuntimeError(
        f"autotune child ({mode}) produced no report "
        f"(rc={proc.returncode}):\n{proc.stdout[-2000:]}"
        f"\n{proc.stderr[-2000:]}")


def check_autotune_roundtrip(report, cpu: bool) -> bool:
    from paddle_tpu_torch.kernels.fused_gemm import DEFAULT_BLOCKS

    with tempfile.TemporaryDirectory(prefix="torch_fusion_check_") as d:
        db_path = os.path.join(d, "autotune_db.json")
        measured = _spawn("measure", db_path, cpu)
        used = _spawn("use", db_path, cpu)
    report["autotune"] = {"measure": measured, "use": used}
    ok = _gate("autotune_measure_populates",
               bool(measured.get("best"))
               and measured.get("statuses") == ["ok"] * 4
               and measured.get("trials") == 4,
               f"{measured.get('trials')} trial(s) "
               f"{measured.get('statuses')}, best="
               f"{json.dumps(measured.get('best'))}", report)
    ok &= _gate("autotune_use_hits", used.get("hits", 0) >= 1,
                f"autotune_hits_total={used.get('hits')}", report)
    best = (measured.get("best") or {}).get("gemm_blocks")
    ok &= _gate("autotune_use_runs_best", used.get("run_blocks") == best,
                f"run at {used.get('run_blocks')} vs best {best}", report)
    if not cpu:
        want = ",".join(map(str, best or DEFAULT_BLOCKS))
        got = used.get("launches_by_blocks", {})
        ok &= _gate("autotune_use_launches_best",
                    list(got) == [want] and got[want] > 0,
                    f"K5 launches by triple {got}", report)
    ok &= _gate("autotune_zero_retrials",
                used.get("trials") == measured.get("trials")
                and used.get("fp") == measured.get("fp"),
                f"trials {measured.get('trials')} -> {used.get('trials')} "
                f"(fingerprints match="
                f"{used.get('fp') == measured.get('fp')})", report)
    return ok


def check_negative_control(report, cpu: bool) -> bool:
    """FLAGS_epilogue_fusion=0: zero fused ops, bit-equal to a run whose
    fusion entry is the identity (a genuinely untransformed execution)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.executor import Executor

    orig = Executor._maybe_epilogue_fusion
    Executor._maybe_epilogue_fusion = \
        lambda self, program, feed, fetch_names, blocks: program
    try:
        base = run_probe("mlp", False, cpu)
    finally:
        Executor._maybe_epilogue_fusion = orig
    off = run_probe("mlp", False, cpu)
    applied = monitor.metric_value("fusion_programs_total",
                                   outcome="applied") or 0
    ok = _gate("negative_zero_fused",
               base["n_fused_exec"] == 0 and off["n_fused_exec"] == 0
               and applied == 0,
               f"fused ops run={off['n_fused_exec']}, "
               f"fusion_programs_total(applied)={applied}", report)
    ok &= _gate("negative_bit_exact", np.array_equal(base["out"], off["out"]),
                "flag-off fetch bit-equal to the fusion-entry-disabled "
                "baseline", report)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--negative-control", action="store_true",
                    help="verify the FLAGS_epilogue_fusion=0 kill switch")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--json", metavar="PATH")
    ap.add_argument("--child", choices=["measure", "use"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--db", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        return _child(args.child, args.db, args.cpu)
    if not (args.check or args.negative_control):
        ap.error("pass --check or --negative-control")
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("torch_fusion_check: no CUDA device; pass --cpu to run "
                  "on the CPU", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    report = {"gates": [], "device": "cpu" if args.cpu else "cuda",
              "cuda_slack": CUDA_SLACK}
    if args.negative_control:
        ok = check_negative_control(report, args.cpu)
    else:
        ok = check_fusion_legs(report, args.cpu)
        ok &= check_autotune_roundtrip(report, args.cpu)
    if args.json:
        for leg in report.get("legs", {}).values():
            leg.pop("out", None)
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"report written to {args.json}")
    if not ok:
        print("fusion gate -> FAIL", file=sys.stderr)
        return 1
    print("fusion gate: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
