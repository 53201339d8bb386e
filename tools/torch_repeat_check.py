"""How far two BERT-base bf16 training runs of the PyTorch port part on one
NVIDIA GPU: plain against plain (the same program, state and feeds twice)
and remat against plain (``FLAGS_auto_recompute`` on against off).

    python3 tools/torch_repeat_check.py [--steps 3] [--batch 32] [--seq 512]
                                         [--out-dir DIR]

``build_bert_pretrain(BertConfig.base(), amp=True)``, dropout 0.1, random
weights and a synthetic batch from ``--seed``; each run starts from a copy
of the same initial scope on a fresh executor (so the step seeds, and with
them the dropout masks, repeat). Prints each pair's losses step by step,
and for the first step the parameter gradients that differ, each with its
largest absolute difference relative to its largest element. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.models.bert import (BertConfig,  # noqa: E402
                                          build_bert_pretrain)


def feed_for(seed, vocab, batch, seq):
    """Random tokens, two segments, padded lengths in [seq/2, seq], 15 %
    of the real tokens masked (chip_smoke.py's ``bert_feed``)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(seq // 2, seq + 1, (batch, 1))
    lens[0] = seq
    real = np.arange(seq)[None] < lens
    masked = real & (rng.rand(batch, seq) < 0.15)
    return {"src_ids": rng.randint(0, vocab, (batch, seq)).astype(np.int64),
            "pos_ids": np.tile(np.arange(seq, dtype=np.int64), (batch, 1)),
            "sent_ids": (np.arange(seq)[None] >= lens // 2).astype(np.int64),
            "input_mask": real.astype(np.float32),
            "mask_label": np.where(masked, rng.randint(0, vocab,
                                                       (batch, seq)),
                                   -100).astype(np.int64),
            "next_sent_label": rng.randint(0, 2, (batch, 1)).astype(
                np.int64)}


def run(net, init, feed, grads, steps, remat):
    """Losses of each step and the first step's parameter gradients."""
    fluid.set_flags({"FLAGS_auto_recompute": remat})
    try:
        exe, scope = fluid.Executor(), fluid.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        losses, first = [], None
        # the same fetch list every step (one executor key)
        fetch = [net["loss"].name] + grads
        for step in range(steps):
            out = exe.run(net["main"], feed=feed, fetch_list=fetch,
                          scope=scope, return_numpy=False)
            losses.append(float(out[0].reshape(-1)[0]))
            if step == 0:
                first = [t.float().cpu() for t in out[1:]]
    finally:
        fluid.set_flags({"FLAGS_auto_recompute": False})
    return losses, first


def compare(grads, a, b):
    la, ga = a
    lb, gb = b
    rel = [abs(x - y) / abs(y) for x, y in zip(la, lb)]
    differ = []
    for n, x, y in zip(grads, ga, gb):
        d = (x - y).abs().max().item()
        if d:
            differ.append({"grad": n, "max_abs": d,
                           "rel_to_max": d / max(y.abs().max().item(),
                                                 1e-30)})
    differ.sort(key=lambda r: -r["rel_to_max"])
    return {"losses": [la, lb], "loss_rel_diff": rel,
            "grads_differing": len(differ), "grads": len(grads),
            "largest": differ[:8]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_repeat_check: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cfg = BertConfig.base()
    net = build_bert_pretrain(cfg, seq_len=args.seq, amp=True)
    net["startup"].random_seed = args.seed + 4
    scope0 = fluid.Scope()
    fluid.Executor().run(net["startup"], scope=scope0)
    init = dict(scope0.vars)
    feed = feed_for(args.seed + 5, cfg.vocab_size, args.batch, args.seq)
    grads = [p.name + "@GRAD" for p in net["main"].all_parameters()]
    plain = run(net, init, feed, grads, args.steps, False)
    again = run(net, init, feed, grads, args.steps, False)
    remat = run(net, init, feed, grads, args.steps, True)
    report = {"batch": args.batch, "seq": args.seq, "steps": args.steps,
              "plain_vs_plain": compare(grads, again, plain),
              "remat_vs_plain": compare(grads, remat, plain)}
    for k in ("plain_vs_plain", "remat_vs_plain"):
        r = report[k]
        print(f"[{k}] losses {r['losses'][0]} vs {r['losses'][1]}; rel. "
              f"diff by step {r['loss_rel_diff']}; step-1 grads differing "
              f"{r['grads_differing']} of {r['grads']}")
        for g in r["largest"]:
            print(f"    {g['grad']}: max abs {g['max_abs']:.3e}, "
                  f"{g['rel_to_max']:.3e} of its largest element")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "repeat_check.json"), "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
