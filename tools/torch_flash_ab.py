"""Time the flash-attention forward kernel (K1) of one copy of the port, on
one GPU, at the serving path's prefill shapes without dropout.

    python3 tools/torch_flash_ab.py --root DIR [--iters 50] [--out FILE]

``DIR`` holds a ``paddle_tpu_torch`` package (this checkout, or an older
one unpacked with ``git archive``); its K1 is built from its own
``csrc/`` and timed through the public wrapper, so two versions of the
kernel compare in one call, in turns (old, new, new, old). Each time is
the mean of ``--iters`` CUDA-event pairs, each launch after a 64 MiB write
that evicts L2, after 3 warm-up launches. Prints one JSON line per shape;
with ``--out``, appends them to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from paddle_tpu_torch import kernels as K

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(16 * 1024 * 1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for S, dtype in ((128, torch.float32), (512, torch.float32),
                     (512, torch.bfloat16)):
        B, H, D = 8, 12, 64
        q, k, v = (torch.randn(B * H, S, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        bias = torch.zeros(B, S, device="cuda")
        bias[1:, S // 2:] = -10000.0

        def run():
            return K.flash_attention_with_lse(q, k, v, bias=bias,
                                              causal=True, num_heads=H)

        for _ in range(3):
            run()
        pairs = []
        for _ in range(args.iters):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        rows.append({"root": args.root, "shape": [B * H, S, D],
                     "dtype": str(dtype)[6:],
                     "ms": sum(a.elapsed_time(b) for a, b in pairs)
                     / args.iters})
    for r in rows:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
