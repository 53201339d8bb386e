#!/usr/bin/env python
"""Option sweep of the PyTorch port's tunables over chained-run probes
(counterpart of tools/xla_sweep.py, with its protocol, artifact schema
and exit codes).

The port compiles no program, so it has no ``FLAGS_xla_options``
(``paddle_tpu_torch/flags.py``). What it can tune is swept instead, each
option set a dict of port flags applied over the probe's defaults:

* K5's compiled tilings (``tuning.default_candidates(
  include_gemm_blocks=True)``, as ``FLAGS_fused_gemm_blocks``),
* ``FLAGS_conv_use_nhwc`` (always / never),
* ``FLAGS_epilogue_fusion`` (off; the probes run fused by default).

Each set is timed in a fresh executor and scope with the chained
differencing protocol (``tuning.chained_step_seconds``) and the ranked
results land in a JSON artifact. With ``FLAGS_autotune=measure`` every
successful K5-tiling trial is also recorded into the tuning database
(the ``{}`` baseline and each triple: the database keys on the triple,
so the layout and fusion sets are reported, not recorded).

Usage:
  python tools/torch_option_sweep.py [--model resnet --model bert]
      [--json out.json] [--device cpu]
      Full-width probes: BERT-base bf16 fused inference (batch 8, seq
      128) and ResNet-50 bf16 inference (batch 32).
  python tools/torch_option_sweep.py --ci --json ci_option_sweep.json
      CI mode: tiny probes (MLP + BERT-tiny training), short chains;
      exits non-zero if the sweep could not rank (every set errored).
  python tools/torch_option_sweep.py --ci --negative-control
      Sweeps only sets that cannot run (a malformed K5 tiling, an
      unknown flag): nothing ranks and the gate must FAIL.
  python tools/torch_option_sweep.py --options-file my_sets.json
      Sweep user option sets (a JSON list of flag objects).

Runs on ``CUDAPlace(0)`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import torch_gate_probes as probes  # noqa: E402

# sets that cannot run: the negative control's
BROKEN_OPTION_SETS = [{"FLAGS_fused_gemm_blocks": "128,256"},
                      {"FLAGS_no_such_option": 1}]
# the flags every probe runs under unless a set overrides them
BASE_FLAGS = {"FLAGS_epilogue_fusion": True}


def default_option_sets():
    """``{}`` (the probe's defaults), one set per other compiled K5
    tiling, both layouts and the unfused program."""
    from paddle_tpu_torch import tuning

    sets = []
    for cand in tuning.default_candidates(include_gemm_blocks=True):
        sets.append({"FLAGS_fused_gemm_blocks": ",".join(
            str(b) for b in cand.gemm_blocks)} if cand.gemm_blocks else {})
    sets += [{"FLAGS_conv_use_nhwc": "always"},
             {"FLAGS_conv_use_nhwc": "never"},
             {"FLAGS_epilogue_fusion": False}]
    return sets


def _probe_mlp(width=256, depth=4, batch=64):
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un

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
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(batch, width).astype(np.float32),
            "y": rng.randn(batch, 1).astype(np.float32)}
    return main, startup, loss.name, feed


def _probe_resnet(ci: bool):
    if ci:
        import paddle_tpu_torch.unique_name as un
        from paddle_tpu_torch.models.resnet import build_resnet

        with un.guard():
            model = build_resnet(depth=18, class_num=100,
                                 image_shape=(3, 64, 64))
        rng = np.random.RandomState(0)
        feed = {"img": rng.rand(8, 3, 64, 64).astype(np.float32),
                "label": rng.randint(0, 100, (8, 1)).astype(np.int64)}
        return model["main"], model["startup"], model["loss"].name, feed
    prog, startup, fetch, feed = probes.resnet_infer()
    return prog, startup, fetch, feed


def _probe_bert(ci: bool):
    if ci:
        net, feed, _ = probes.bert_train(tiny=True, batch=4, seq=32)
        return net["main"], net["startup"], net["loss"].name, feed
    prog, startup, _, enc, feed = probes.bert_infer()
    return prog, startup, enc, feed


PROBES = {"mlp": lambda ci: _probe_mlp(),
          "resnet": _probe_resnet,
          "bert": _probe_bert}


def time_one(main, startup, loss_name, feed, k_short, k_long, repeats):
    """Per-step seconds in a fresh executor/scope, timed through the one
    shared chained-differencing implementation
    (tuning.chained_step_seconds)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import tuning

    exe = probes.executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return tuning.chained_step_seconds(
            exe, main, feed, [loss_name], scope,
            k_short=k_short, k_long=k_long, repeats=repeats)


def sweep(models, option_sets, ci: bool, k_short, k_long, repeats,
          probe_fns=None) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import tuning

    probe_fns = probe_fns or PROBES
    persist = tuning.autotune_mode() == "measure"
    report = {"backend": tuning.backend_name(probes.place().torch_device()),
              "protocol": "run_chained differencing: "
                          f"(T({k_long})-T({k_short}))/{k_long - k_short}, "
                          f"min over {repeats} repeats",
              "autotune_db": tuning.default_db_path() if persist else None,
              "models": {}}
    touched = set(BASE_FLAGS)
    for opts in option_sets:
        touched |= {k for k in opts if k.startswith("FLAGS_")}
    prev = fluid.get_flags(sorted(
        k for k in touched if _known_flag(k)))
    # one shared DB handle, one durable write per model
    database = tuning.get_database() if persist else None
    try:
        for mname in models:
            main, startup, loss_name, feed = probe_fns[mname](ci)
            trials = []
            for opts in option_sets:
                label = json.dumps(opts, sort_keys=True)
                t0 = time.time()
                try:
                    fluid.set_flags(dict(prev, **BASE_FLAGS))
                    fluid.set_flags(opts)
                    # trial_guard: the executor must run exactly these
                    # flags — in measure mode it would otherwise fill an
                    # unset tiling from the database's best-known entry
                    with tuning.trial_guard():
                        per_step = time_one(main, startup, loss_name, feed,
                                            k_short, k_long, repeats)
                    trials.append({"options": opts, "status": "ok",
                                   "per_step_s": per_step,
                                   "sweep_s": round(time.time() - t0, 2)})
                    config = _tuned_config(opts)
                    if persist and config is not None:
                        batch = max([1] + [np.asarray(v).shape[0]
                                           for v in feed.values()])
                        try:
                            tuning.record_trial(
                                main, batch, config, per_step,
                                db=database, save=False,
                                device=probes.place().torch_device())
                        except Exception as e:
                            print(f"[{mname}] {label}: DB record failed "
                                  f"({type(e).__name__}: {e})", flush=True)
                    print(f"[{mname}] {label}: "
                          f"{per_step * 1e3:.3f} ms/step", flush=True)
                except Exception as e:
                    trials.append({"options": opts, "status": "error",
                                   "error": f"{type(e).__name__}: {e}"[:300]})
                    print(f"[{mname}] {label}: FAILED "
                          f"({type(e).__name__})", flush=True)
            ok = sorted((t for t in trials if t["status"] == "ok"),
                        key=lambda t: t["per_step_s"])
            base = next((t["per_step_s"] for t in trials
                         if t["status"] == "ok" and not t["options"]), None)
            for rank, t in enumerate(ok):
                t["rank"] = rank
                if base:
                    t["speedup_vs_default"] = round(
                        base / t["per_step_s"], 4)
            report["models"][mname] = {
                "trials": trials,
                "best_options": ok[0]["options"] if ok else None,
                "best_per_step_s": ok[0]["per_step_s"] if ok else None,
            }
            if database is not None:
                try:
                    database.save()
                except Exception as e:
                    print(f"[{mname}] DB save failed "
                          f"({type(e).__name__}: {e})", flush=True)
    finally:
        fluid.set_flags(prev)
    return report


def _known_flag(name: str) -> bool:
    from paddle_tpu_torch.flags import _DEFS

    return name.replace("FLAGS_", "", 1) in _DEFS


def _tuned_config(opts):
    """The tuning database's record of a set: the ``{}`` baseline and K5
    tilings are TunedConfigs; other sets are not recorded (None)."""
    from paddle_tpu_torch import tuning

    if not opts:
        return tuning.TunedConfig.make({})
    if set(opts) == {"FLAGS_fused_gemm_blocks"}:
        return tuning.TunedConfig.make(
            {}, [int(b) for b in opts["FLAGS_fused_gemm_blocks"].split(",")])
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", action="append", choices=sorted(PROBES),
                    help="probe model(s); default: resnet + bert "
                         "(mlp + bert under --ci)")
    ap.add_argument("--ci", action="store_true",
                    help="tiny probes + short chains (the CI artifact run)")
    ap.add_argument("--options-file", metavar="PATH",
                    help="JSON list of flag objects to sweep instead of "
                         "the built-ins")
    ap.add_argument("--negative-control", action="store_true",
                    help="sweep only sets that cannot run: the gate must "
                         "FAIL to rank")
    ap.add_argument("--json", metavar="PATH",
                    help="write the ranked report (the CI artifact)")
    ap.add_argument("--k-short", type=int, default=None)
    ap.add_argument("--k-long", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=None)
    probes.add_device_arg(ap)
    args = ap.parse_args(argv)
    probes.set_device(args.device)

    models = args.model or (["mlp", "bert"] if args.ci
                            else ["resnet", "bert"])
    if args.negative_control:
        option_sets = BROKEN_OPTION_SETS
    elif args.options_file:
        with open(args.options_file, "r", encoding="utf-8") as f:
            option_sets = json.load(f)
        if not isinstance(option_sets, list):
            print("--options-file must hold a JSON list of objects",
                  file=sys.stderr)
            return 2
    else:
        option_sets = default_option_sets()
    k_short = args.k_short or (2 if args.ci else 4)
    k_long = args.k_long or (6 if args.ci else 16)
    repeats = args.repeats or (1 if args.ci else 3)

    report = sweep(models, option_sets, args.ci, k_short, k_long, repeats)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.json}")

    ranked = all(m["best_options"] is not None
                 for m in report["models"].values())
    for mname, m in report["models"].items():
        if m["best_per_step_s"]:
            print(f"{mname}: best {m['best_per_step_s'] * 1e3:.3f} ms/step "
                  f"with {json.dumps(m['best_options'])}")
    if not ranked:
        print("sweep failed to rank (no option set succeeded) -> FAIL",
              file=sys.stderr)
        return 1
    print("sweep gate -> ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
