#!/usr/bin/env python
"""Where auto-remat's BERT training leaves the plain run's bits.

Trains BERT-base f32 (batch 8, seq 128, dropout 0; the remat gate's card
leg, ``tools/torch_remat_check.py --model bert_base``) from one set of
weights three ways on fresh executors: plain, plain again (the
run-to-run control) and under ``FLAGS_auto_recompute``. The first step
fetches every parameter's gradient; each step's loss and, after the
last, every state var are compared bit for bit. Prints the gradients and
state vars that differ (max |a-b| and the largest |a|) for plain against
plain again and plain against remat.

    python tools/torch_remat_bits.py [--device cpu] [--tiny] [--json PATH]

Runs on ``CUDAPlace(0)`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import torch_gate_probes as probes  # noqa: E402
from tools.torch_remat_check import TRAIN_STEPS as STEPS  # noqa: E402


def _run(net, init, feed, steps, auto, grads):
    import paddle_tpu_torch as fluid

    exe, scope = probes.executor(), fluid.Scope()
    for n, t in init.vars.items():
        scope.set_var(n, t.clone())
    fluid.set_flags({"FLAGS_auto_recompute": auto})
    try:
        losses, first = [], None
        for step in range(steps):
            fetch = [net["loss"].name] + (grads if step == 0 else [])
            out = exe.run(net["main"], feed=feed, fetch_list=fetch,
                          scope=scope)
            losses.append(float(np.ravel(out[0])[0]))
            if step == 0:
                first = dict(zip(grads, out[1:]))
    finally:
        fluid.set_flags({"FLAGS_auto_recompute": False})
    state = {n: scope.numpy(n) for n in sorted(init.vars)}
    return losses, first, state


def _diff(a: dict, b: dict) -> list:
    """[(name, max |a-b|, max |a|)] of the arrays that differ in a bit."""
    out = []
    for n in a:
        x, y = np.asarray(a[n]), np.asarray(b[n])
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            out.append((n, float(np.max(np.abs(x.astype(np.float64)
                                               - y.astype(np.float64)))),
                        float(np.max(np.abs(x)))))
    return sorted(out, key=lambda r: -r[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="BERT-tiny widths (a CPU rehearsal)")
    ap.add_argument("--json", metavar="PATH")
    probes.add_device_arg(ap)
    args = ap.parse_args(argv)
    probes.set_device(args.device)
    import paddle_tpu_torch as fluid

    net, feed, _ = probes.bert_train(tiny=args.tiny)
    grads = sorted(v.name + "@GRAD" for v in
                   net["main"].global_block.vars.values()
                   if type(v).__name__ == "Parameter")
    init = fluid.Scope()
    probes.executor().run(net["startup"], scope=init)
    runs = {name: _run(net, init, feed, STEPS, auto, grads)
            for name, auto in (("plain", False), ("plain_again", False),
                               ("remat", True))}
    report = {"steps": STEPS, "losses": {k: r[0]
                                              for k, r in runs.items()}}
    for other in ("plain_again", "remat"):
        g = _diff(runs["plain"][1], runs[other][1])
        s = _diff(runs["plain"][2], runs[other][2])
        report[other] = {"grads_differing": g, "state_differing": s,
                         "losses_equal": runs["plain"][0]
                         == runs[other][0]}
        print(f"plain vs {other}: losses equal "
              f"{report[other]['losses_equal']}; step-1 gradients "
              f"differing {len(g)} of {len(grads)}; state vars differing "
              f"{len(s)} of {len(runs['plain'][2])} after {STEPS} "
              f"steps")
        for n, d, m in g[:12]:
            print(f"    grad {n}: max|diff| {d:.3e} (max|a| {m:.3e})")
    for k, v in report["losses"].items():
        print(f"  losses {k}: {v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
