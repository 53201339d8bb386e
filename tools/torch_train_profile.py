"""Where a BERT-base train step of the PyTorch port spends its time, in
float32 and in bf16 (AMP), on one GPU.

    python3 tools/torch_train_profile.py [--seq 512] [--batch 32]
                                         [--steps 3] [--seed 0]
                                         [--precisions f32,amp]
                                         [--out-dir DIR]

For each precision, in the order given: ``build_bert_pretrain(
BertConfig.base(), seq_len=--seq, amp=...)`` (dropout 0.1, Adam, random
weights and a synthetic batch from ``--seed``, the batch of
``chip_smoke.py``) runs ``--steps`` steps through the kernels (the first
one untimed), then one step under ``torch.profiler``. Prints steps/s and
tokens/s (host clock, steps 2..N, each ending in a host read of the
loss), peak device memory, the profiled step's device busy time and idle
share, its device ms by class (``chip_smoke.kernel_class``: cuBLAS GEMMs
in f32 or bf16, the port's attention kernels K1, K3 and K4, casts to
bf16, copies: contiguous layouts and casts back to f32, reductions, other
elementwise kernels) and its top kernels; with ``--out-dir``, also to
``DIR/train_profile.json``. TF32 and cuBLAS's
reduced-precision bf16 reductions are off, as in ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch as fluid  # noqa: E402
from chip_smoke import _device_us, bert_feed, kernel_class  # noqa: E402
from paddle_tpu_torch.models.bert import (BertConfig,  # noqa: E402
                                          build_bert_pretrain)

def run(precision, args, feed):
    cfg = BertConfig.base()
    net = build_bert_pretrain(cfg, seq_len=args.seq, amp=precision == "amp")
    net["startup"].random_seed = args.seed
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(net["startup"], scope=scope)

    def step():
        return float(exe.run(net["main"], feed=feed,
                             fetch_list=[net["loss"]], scope=scope)[0][0])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step()]
    t0 = time.perf_counter()
    losses += [step() for _ in range(args.steps - 1)]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(step())
        prof_wall = time.perf_counter() - t1
    rows = sorted(((_device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and _device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    classes = {}
    for us, name, n in rows:
        c = classes.setdefault(kernel_class(name), {"ms": 0.0, "calls": 0})
        c["ms"] += us / 1e3
        c["calls"] += n
    tokens = args.batch * args.seq
    sps = (args.steps - 1) / wall
    res = dict(precision=precision, seq=args.seq, batch=args.batch,
               losses=losses, steps_per_s=sps, tokens_per_s=sps * tokens,
               peak_gib=peak / 2**30, profiled_wall_ms=prof_wall * 1e3,
               device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / (prof_wall * 1e3),
               device_kernels=sum(r[2] for r in rows),
               classes=dict(sorted(classes.items(),
                                   key=lambda kv: -kv[1]["ms"])),
               top_kernels=[{"name": k[:100], "ms": us / 1e3, "calls": n}
                            for us, k, n in rows[:15]])
    print(f"[{precision}] BERT-base batch {args.batch}, seq {args.seq}: "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; {sps:.3f} steps/s = "
          f"{sps * tokens:.1f} tokens/s (steps 2-{args.steps}), peak "
          f"{peak / 2**30:.2f} GiB; profiled step wall "
          f"{prof_wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, idle "
          f"share {res['idle_share']:.3f}, {res['device_kernels']} "
          f"kernels", flush=True)
    for c, r in res["classes"].items():
        print(f"    {r['ms']:9.3f} ms ({r['ms'] / busy_ms * 100:5.1f} %) "
              f"{r['calls']:6d} calls  {c}")
    for r in res["top_kernels"]:
        print(f"    {r['ms']:9.3f} ms {r['calls']:5d} calls  {r['name']}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precisions", default="f32,amp")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}", flush=True)
    feed = bert_feed(args.seed, BertConfig.base().vocab_size, args.batch,
                     args.seq)
    out = {"card": card, "runs": []}
    for precision in args.precisions.split(","):
        out["runs"].append(run(precision, args, feed))
        torch.cuda.empty_cache()
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "train_profile.json"),
                  "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
