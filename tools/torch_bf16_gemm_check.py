"""What cuBLAS's reduced-precision bf16 reductions cost and save on the
products of a BERT-base bf16 train step, on one GPU.

    python3 tools/torch_bf16_gemm_check.py [--seed 0] [--out-dir DIR]

For each product shape of the step at batch 32 x seq 512 (16384 rows; the
forward's q/k/v/out-proj, FFN1, FFN2 and vocab-logits products, and the
backward's dX and dW products; and the vocab logits' dX at 4096 rows),
bf16 operands drawn from a standard
normal, with ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`` on and then off: the largest
relative error (``|got - ref| / max(|ref|, 1)``) and the mean absolute
error of ``torch.mm`` against a float64 product of the same operands,
the median device time of 10 launches (CUDA events), and the cuBLAS
kernels that ran (``torch.profiler``). TF32 is off. Prints one line per
shape and setting; with ``--out-dir``, also ``DIR/bf16_gemm_check.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

# (m, n, k, role) of the step's products at 16384 rows
SHAPES = (
    (16384, 768, 768, "q/k/v/out-proj"),
    (16384, 3072, 768, "FFN1"),
    (16384, 768, 3072, "FFN2"),
    (16384, 30522, 768, "vocab logits"),
    (16384, 768, 30522, "vocab logits dX"),
    # the same product at batch 8 x seq 512, where cuBLAS picks split-k
    (4096, 768, 30522, "vocab logits dX, 4096 rows"),
    (768, 768, 16384, "q/k/v/out-proj dW"),
    (3072, 768, 16384, "FFN2 dW"),
    (30522, 768, 16384, "word embedding dW"),
)


def median_ms(fn, iters=10):
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def check(m, n, k, role, gen):
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    y = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
    ref = x.double() @ y.double()
    rows = []
    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
        got = torch.mm(x, y).double()
        err = (got - ref).abs()
        max_rel = float((err / ref.abs().clamp_min(1.0)).max())
        mean_abs = float(err.mean())
        del got, err
        ms = median_ms(lambda: torch.mm(x, y))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.mm(x, y)
            torch.cuda.synchronize()
        kernels = sorted({e.key[:80] for e in prof.key_averages()
                          if e.device_type.name == "CUDA"})
        row = dict(m=m, n=n, k=k, role=role, reduced=reduced,
                   max_rel_err=max_rel, mean_abs_err=mean_abs, ms=ms,
                   kernels=kernels)
        print(f"  [{m},{k}]@[{k},{n}] {role:20s} reduced={reduced!s:5s}: "
              f"max rel err {max_rel:.4e}, mean abs err {mean_abs:.4e}, "
              f"{ms:.4f} ms; {kernels}", flush=True)
        rows.append(row)
    del ref
    torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_gemm_check: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = [r for shape in SHAPES for r in check(*shape, gen)]
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "bf16_gemm_check.json"),
                  "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
