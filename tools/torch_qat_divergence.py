"""Where one quant-aware ResNet-50 training step on the GPU parts from the
same step on the CPU.

    python3 tools/torch_qat_divergence.py [--batch 2] [--seed 0] [--out FILE]

The program is ``chip_smoke.qat_resnet()`` (ResNet-50 at 224², 1000
classes, ``contrib.slim.quant_aware``, Momentum 0.1 / 0.9), and the
control is the same network and optimizer without ``quant_aware``. For
each, from the startup's weights and ``chip_smoke.image_feed(seed)``'s
first ``--batch`` images:

1. one step on the card, one on the CPU, one on the card with the
   image scaled by 1 + 1e-7 and one in float64 on the CPU (the
   program's float32 vars and constants made float64;
   ``float32_leaks`` counts the float32 values its ops still wrote, by
   op type): the loss and the state's normwise difference, card against
   CPU, nudged against card and each float32 step against the float64
   one, and per state leaf the share of the squared difference it holds
   beside its share of the squared norm (the ten largest), and by kind
   of leaf (weight, velocity, BatchNorm statistic, quant scale);
2. the step once more on the card with every op run again on the CPU
   from the CPU's own values (the two devices in lockstep, each on its
   own inputs): per op in program order, the largest normwise difference
   of its float inputs and of its float outputs. It prints the first ops
   past 1e-5, 1e-3 and 1e-1 and the ops that multiply the difference
   they were given the most.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import executor as ex  # noqa: E402
from paddle_tpu_torch.lowering import LowerCtx  # noqa: E402

NUDGE = 1e-7


def programs(quant):
    if quant:
        return cs.qat_resnet()
    hw = cs.RESNET_HW
    with fluid.unique_name.guard():
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start):
            net = cs.resnet_forward(50, 1000, (3, hw, hw))
            fluid.optimizer.Momentum(learning_rate=0.1,
                                     momentum=0.9).minimize(net["loss"])
    return main, start, net


def kind(name):
    if "velocity" in name:
        return "velocity"
    if "quant_scale" in name:
        return "quant scale"
    if re.fullmatch(r"batch_norm_\d+\.w_[12]", name):
        return "bn statistic"
    return "parameter"


def sq(a, b):
    a = torch.as_tensor(a).double().cpu().reshape(-1)
    b = torch.as_tensor(b).double().cpu().reshape(-1)
    return float(((a - b) ** 2).sum()), float((b ** 2).sum())


def rel(a, b):
    """||a - b|| / ||b||, or 1.0 where b is 0 and a is not."""
    d, w = sq(a, b)
    return (d / w) ** 0.5 if w else float(d > 0)


def leaves(sa, sb, names):
    rows, num, den = [], 0.0, 0.0
    for n in names:
        d, w = sq(sa.find_var(n), sb.find_var(n))
        rows.append((n, d, w))
        num += d
        den += w
    by_kind = collections.defaultdict(lambda: [0.0, 0.0])
    for n, d, w in rows:
        k = by_kind[kind(n)]
        k[0] += d
        k[1] += w
    top = sorted(rows, key=lambda r: -r[1])[:10]
    return dict(
        normwise=(num / den) ** 0.5 if den else 0.0,
        top=[dict(name=n, diff_share=d / num if num else 0.0,
                  norm_share=w / den, leaf_normwise=(d / w) ** 0.5
                  if w else None) for n, d, w in top],
        by_kind={k: dict(diff_share=v[0] / num if num else 0.0,
                         norm_share=v[1] / den,
                         normwise=(v[0] / v[1]) ** 0.5 if v[1] else None)
                 for k, v in by_kind.items()})


def lockstep(main, loss, init, feed):
    """One step of ``main`` on the card with the CPU in lockstep."""
    real, cpu = ex.lower_op, torch.device("cpu")
    cpu_env, trail = {}, []

    def lower_op(op, env, ctx):
        ins = [n for n in op.input_arg_names if n in env]
        cin = {n: cpu_env[n] if n in cpu_env else (
            env[n].to(cpu) if isinstance(env[n], torch.Tensor) else env[n])
            for n in ins}
        e_in = max([rel(env[n], cin[n]) for n in ins
                    if isinstance(env[n], torch.Tensor)
                    and env[n].is_floating_point()] or [0.0])
        real(op, env, ctx)
        real(op, cin, LowerCtx(cpu, seed=ctx.seed,
                               gemm_blocks=ctx.gemm_blocks,
                               program=ctx.program))
        e_out = 0.0
        for n in op.output_arg_names:
            if n in cin:
                cpu_env[n] = cin[n]
            a, b = env.get(n), cin.get(n)
            if isinstance(a, torch.Tensor) and a.is_floating_point() \
                    and b is not None:
                e_out = max(e_out, rel(a, b))
        trail.append(dict(i=len(trail), type=op.type,
                          out=op.output_arg_names[0]
                          if op.output_arg_names else "",
                          in_err=e_in, out_err=e_out))

    ex.lower_op = lower_op
    try:
        cs.qat_steps(main, loss, init, feed, 1)
    finally:
        ex.lower_op = real
    first = {}
    for t in (1e-5, 1e-3, 1e-1):
        first[str(t)] = next((r for r in trail if r["out_err"] > t), None)
    gain = sorted((r for r in trail if r["out_err"] > 1e-6),
                  key=lambda r: -r["out_err"] / max(r["in_err"], 1e-9))[:10]
    return dict(ops=len(trail), first_past=first, largest_gain=gain,
                worst=max(trail, key=lambda r: r["out_err"]))


def as_float64(main):
    """A copy of ``main`` whose float32 vars and constants are float64."""
    m = main.clone()
    for v in m.global_block.vars.values():
        if v.dtype == "float32":
            v.dtype = "float64"
    for op in m.global_block.ops:
        if op.attrs.get("dtype") == "float32":
            op.attrs["dtype"] = "float64"
    return m


def float64_step(main, loss, init, feed):
    """The step in float64 on the CPU; returns its loss, its scope and
    the types of the ops that still wrote a float32 value, counted."""
    real, leaks = ex.lower_op, collections.Counter()

    def lower_op(op, env, ctx):
        real(op, env, ctx)
        leaks[op.type] += sum(isinstance(env.get(n), torch.Tensor)
                              and env[n].dtype == torch.float32
                              for n in op.output_arg_names)

    ex.lower_op = lower_op
    try:
        l64, _, s64 = cs.qat_steps(
            as_float64(main), loss,
            {n: v.double() if v.is_floating_point() else v
             for n, v in init.items()},
            dict(feed, img=feed["img"].astype(np.float64)), 1,
            exe=fluid.Executor(fluid.CPUPlace()))
    finally:
        ex.lower_op = real
    return l64, s64, {k: v for k, v in leaks.items() if v}


def case(quant, batch, seed):
    main, start, net = programs(quant)
    start.random_seed = seed
    scope0 = fluid.Scope()
    fluid.Executor().run(start, scope=scope0)
    init = dict(scope0.vars)
    feed = {n: v[:batch] for n, v in
            cs.image_feed(seed, cs.QAT_BATCH, 1000, hw=cs.RESNET_HW).items()}
    loss = net["loss"]
    lc, _, sc = cs.qat_steps(main, loss, init, feed, 1)
    lh, _, sh = cs.qat_steps(main, loss, init, feed, 1,
                             exe=fluid.Executor(fluid.CPUPlace()))
    nudged = dict(feed, img=feed["img"] * np.float32(1 + NUDGE))
    ln, _, sn = cs.qat_steps(main, loss, init, nudged, 1)
    l64, s64, leaks = float64_step(main, loss, init, feed)
    names = sorted(n for n in sc.vars if n in init)
    return dict(
        quant=quant, batch=batch, losses=dict(card=lc[0], cpu=lh[0],
                                              nudged=ln[0], float64=l64[0]),
        loss_rel=dict(cpu=abs(lc[0] - lh[0]) / abs(lh[0]),
                      nudge=abs(ln[0] - lc[0]) / abs(lc[0]),
                      card_vs_float64=abs(lc[0] - l64[0]) / abs(l64[0]),
                      cpu_vs_float64=abs(lh[0] - l64[0]) / abs(l64[0])),
        card_vs_cpu=leaves(sc, sh, names),
        nudge_vs_card=leaves(sn, sc, names),
        card_vs_float64=leaves(sc, s64, names),
        cpu_vs_float64=leaves(sh, s64, names), float32_leaks=leaks,
        lockstep=lockstep(main, loss, init, feed))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=cs.QAT_CPU_BATCH)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    out = []
    for quant in (True, False):
        r = case(quant, args.batch, args.seed)
        out.append(r)
        print(json.dumps(r, default=float), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, cases=out), fh, default=float)


if __name__ == "__main__":
    main()
