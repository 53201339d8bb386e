"""Time the two ways the port can take a 3-D max pool on one GPU.

    python3 tools/torch_pool3d_paths.py [--iters 10] [--out FILE]

``direct`` is ``F.max_pool3d`` (its gradient scatters into each input
with atomics, which repeat bit for bit only where no two windows share
an input); ``by_index`` is ``ops.image.max_pool3d_by_index``, a gather at
``F.max_pool3d``'s indices whose gradient sums in a fixed order. Rows:
C3D's pool1 (1x2x2 stride 1x2x2 on conv1a's [30, 64, 16, 112, 112]) and
pool2 (2x2x2 stride 2 on conv2a's [30, 128, 16, 56, 56]), float32, the
windows of both disjoint (Tran et al., ICCV 2015, batch 30). Each path
runs forward, and forward with the backward of a fixed cotangent, timed
with CUDA events (mean of ``--iters`` after 2 warm-ups, the two paths in
turns direct, by_index, by_index, direct); the two paths' outputs and
input gradients must be equal bit for bit. Prints the card's name and
power limit and one JSON line a row; ``--out`` appends the lines to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from paddle_tpu_torch.ops.image import max_pool3d_by_index  # noqa: E402

ROWS = {"c3d_pool1": ((30, 64, 16, 112, 112), (1, 2, 2), (1, 2, 2)),
        "c3d_pool2": ((30, 128, 16, 56, 56), (2, 2, 2), (2, 2, 2))}
PATHS = {"direct": lambda v, k, s: F.max_pool3d(v, k, s),
         "by_index": max_pool3d_by_index}


def timed(fn, iters):
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def row(name, iters):
    shape, k, s = ROWS[name]
    g = torch.Generator(device="cuda").manual_seed(0)
    xv = torch.randn(shape, generator=g, device="cuda").requires_grad_()
    ct = None
    got, ms = {}, {p: {"fwd": 0.0, "fwd_bwd": 0.0} for p in PATHS}
    for p in PATHS:
        y = PATHS[p](xv, k, s)
        if ct is None:
            ct = torch.randn(y.shape, generator=g, device="cuda")
        got[p] = (y.detach(), torch.autograd.grad(y, xv, ct)[0])
    for p in ("direct", "by_index", "by_index", "direct"):
        def fwd(p=p):
            with torch.no_grad():
                PATHS[p](xv, k, s)

        def fwd_bwd(p=p):
            torch.autograd.grad(PATHS[p](xv, k, s), xv, ct)

        ms[p]["fwd"] += timed(fwd, iters) / 2
        ms[p]["fwd_bwd"] += timed(fwd_bwd, iters) / 2
    equal = all(torch.equal(a, b) for a, b in zip(got["direct"],
                                                    got["by_index"]))
    return {"row": name, "shape": list(shape), "ksize": list(k),
            "strides": list(s), "ms": ms, "equal": equal}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_pool3d_paths: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card} | torch {torch.__version__}", flush=True)
    lines = []
    for name in ROWS:
        r = dict(row(name, args.iters), card=card)
        lines.append(json.dumps(r))
        print(lines[-1], flush=True)
        if not r["equal"]:
            raise SystemExit(f"torch_pool3d_paths: {name}: the two paths "
                             "disagree")
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
