"""What the warm-start cache saves on a program whose preparation costs
something, on one GPU: BERT-base bf16 fused inference (the program
``chip_smoke.py``'s ``serve_batch`` and ``fleet`` (b) serve: the is_test
clone under ``decorate_program``, ``FLAGS_epilogue_fusion=1``, seq 128).

    python3 tools/torch_aot_cache_prepare.py [--pairs 3] [--batch 8]
                                             [--out FILE]

Each pair, in a fresh cache directory (``FLAGS_aot_cache_dir``):

* ``off``: a fresh executor's ``_prepare`` with the cache off (the block
  triple, remat, the fusion pass with its witness on the card, and the
  verification);
* ``cold``: a fresh executor's ``_prepare`` with the cache on and empty
  (the same, then the save);
* ``warm``: a fresh executor's ``_prepare`` against the entry ``cold``
  saved (the load and its validation);

then, in the same directory, a fresh executor's first ``run`` (time to
the first output, read back) cold (the entry removed) and warm, the two
outputs compared bit for bit. Times are the host's wall clock (the
preparation is host work that waits on the witness's device runs). The
cache's counters are printed at the end; a warm start must show hits and
no errors.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import aot_cache  # noqa: E402
from paddle_tpu_torch.contrib import mixed_precision  # noqa: E402
from paddle_tpu_torch.models.bert import (BertConfig,  # noqa: E402
                                          build_bert_pretrain)

SEQ = 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}")
    cfg = BertConfig.base()
    net = build_bert_pretrain(cfg, seq_len=SEQ, build_optimizer=False)
    net["startup"].random_seed = 0
    prog = mixed_precision.decorate_program(net["main"].clone(for_test=True))
    enc = next(op.input("X")[0] for op in prog.global_block.ops
               if op.type == "mul" and op.input("Y")[0] == "mlm_trans_w")
    names = list(net["feeds"])
    scope = fluid.Scope()
    fluid.Executor().run(net["startup"], scope=scope)
    data = cs.bert_feed(1, cfg.vocab_size, args.batch, SEQ)
    feed = {n: data[n] for n in names}
    fetch = [enc]
    root = tempfile.mkdtemp(prefix="aot_prepare_")

    def prepare(cache_dir):
        fluid.set_flags({"FLAGS_aot_cache_dir": cache_dir})
        exe = fluid.Executor()
        t0 = time.perf_counter()
        exe._prepare(prog, feed, fetch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def first_run(cache_dir):
        fluid.set_flags({"FLAGS_aot_cache_dir": cache_dir})
        exe = fluid.Executor()
        t0 = time.perf_counter()
        out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        return time.perf_counter() - t0, out

    times = {"off": [], "cold": [], "warm": [], "first_run_cold": [],
             "first_run_warm": []}
    exact = []
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    try:
        # the kernels' builds and the first witness run outside the pairs
        prepare("")
        for i in range(args.pairs):
            d = os.path.join(root, str(i))
            os.makedirs(d)
            times["off"].append(prepare(""))
            times["cold"].append(prepare(d))
            times["warm"].append(prepare(d))
            for f in glob.glob(os.path.join(d, "*")):
                os.remove(f)
            s, cold = first_run(d)
            times["first_run_cold"].append(s)
            s, warm = first_run(d)
            times["first_run_warm"].append(s)
            exact.append(all(np.array_equal(a, b)
                             for a, b in zip(cold, warm)))
            print(f"  pair {i}: " + ", ".join(
                f"{k} {v[-1]:.4f} s" for k, v in times.items())
                + f"; warm run == cold run bit for bit: {exact[-1]}")
    finally:
        fluid.set_flags({"FLAGS_epilogue_fusion": False,
                         "FLAGS_aot_cache_dir": ""})
        shutil.rmtree(root, ignore_errors=True)
    stats = aot_cache.cache_stats()
    summary = {k: {"median_s": statistics.median(v), "runs_s": v}
               for k, v in times.items()}
    print(f"BERT-base bf16 fused, batch {args.batch}, seq {SEQ}: " + ", ".join(
        f"{k} median {v['median_s']:.4f} s" for k, v in summary.items()))
    print(f"counters {stats}; warm runs bit-identical {exact}")
    res = {"card": card, "batch": args.batch, "seq": SEQ, "times": summary,
           "counters": stats, "bit_identical": exact}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    ok = (all(exact) and stats["hits"] > 0 and stats["errors"] == 0)
    print(json.dumps({"ok": ok, "times": {k: v["median_s"]
                                          for k, v in summary.items()}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
