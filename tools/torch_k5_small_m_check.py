"""How far K5's float32 route and ``torch.addmm`` each are from the exact
product at small M, on one GPU.

    python3 tools/torch_k5_small_m_check.py [--seeds 3] [--out-dir DIR]

At [8,2048]@[2048,1000] + bias (the ResNet-50 fc head at batch 8) and at
m = 8 of BERT-base's three products ([8,768]@[768,768],
[8,768]@[768,3072], [8,3072]@[3072,768], each + bias), float32 operands
are drawn as the epilogue-fusion witness draws them (numpy standard
normals times 0.5). For K5 at every compiled block triple that takes the
shape, and for ``torch.addmm``, the script prints the largest absolute
error, the largest relative error (``|got - ref| / max(|ref|, 1)``) and
the root-mean-square error against a float64 product of the same
operands, and the largest absolute difference between K5 and ``addmm``
(what the witness compares). Then, at each shape, the median device
time of 20 launches (CUDA events, warm L2) of K5 at the default triple,
of its plain version (``fused_gemm_reference``) and of ``addmm``, beside
the bound: the larger of the bytes (each input read once, the output
written once) over 3.35 TB/s and 2*M*N*K over 67 TFLOP/s, and the mean
device time of K5's kernels (the split pass and the reduction), of the
plain version's and of ``addmm``'s over 20 calls (``torch.profiler``,
``chip_smoke.device_ms``). TF32 is off.

``--chains 32,64,128,...`` also sweeps the depth of one k split
(``fused_gemm.SPLITK_K``; 0 is one chain over all of K, no split): at each
depth and shape, K5's worst max-abs and rms errors over the seeds against
the float64 product, and its device ms at every compiled triple.
With ``--out-dir``, also ``DIR/k5_small_m_check.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (m, n, k, role)
SHAPES = (
    (8, 1000, 2048, "ResNet-50 fc head"),
    (8, 768, 768, "BERT-base q/k/v/out-proj"),
    (8, 3072, 768, "BERT-base FFN1"),
    (8, 768, 3072, "BERT-base FFN2"),
)


def errors(got, ref):
    err = (got.double() - ref).abs()
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / ref.abs().clamp_min(1.0)).max()),
            "rms_err": float(err.pow(2).mean().sqrt())}


def check(m, n, k, role, seed):
    import importlib

    fg = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")

    rng = np.random.default_rng(seed)
    draw = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32) * 0.5).cuda()
    x, y, bias = draw(m, k), draw(k, n), draw(n)
    ref = torch.addmm(bias.double(), x.double(), y.double())
    dense = torch.addmm(bias, x, y)
    rows = [dict(m=m, n=n, k=k, role=role, seed=seed, route="addmm",
                 **errors(dense, ref))]
    for blocks in fg.COMPILED_BLOCKS:
        kind, _ = fg.classify_gemm(m, n, k, block_m=blocks[0],
                                   block_n=blocks[1], block_k=blocks[2])
        if kind != "supported":
            continue
        got = fg.fused_gemm(x, y, bias, block_m=blocks[0],
                            block_n=blocks[1], block_k=blocks[2])
        rows.append(dict(m=m, n=n, k=k, role=role, seed=seed,
                         route=f"K5 {blocks}", **errors(got, ref),
                         max_abs_vs_addmm=float((got - dense).abs().max())))
    torch.cuda.synchronize()
    return rows


def median_ms(fn, iters=20):
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


def timings(m, n, k):
    import importlib

    from chip_smoke import device_ms

    fg = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, k, generator=g, device="cuda")
    y = torch.randn(k, n, generator=g, device="cuda")
    bias = torch.randn(n, generator=g, device="cuda")
    nbytes = 4 * (m * k + k * n + n + m * n)
    k5 = lambda: fg.fused_gemm(x, y, bias)  # noqa: E731
    plain = lambda: fg.fused_gemm_reference(x, y, bias)  # noqa: E731
    lib = lambda: torch.addmm(bias, x, y)  # noqa: E731
    return {"m": m, "n": n, "k": k,
            "splits": fg.splitk_splits(m, n, k),
            "ms": median_ms(k5), "device_ms": device_ms(k5),
            "plain_ms": median_ms(plain), "plain_device_ms": device_ms(plain),
            "library_ms": median_ms(lib), "library_device_ms": device_ms(lib),
            "bound_ms": max(nbytes / 3.35e12, 2 * m * n * k / 67e12) * 1e3,
            "bound_by": ("bytes" if nbytes / 3.35e12
                         >= 2 * m * n * k / 67e12 else "operations")}


def sweep(chains, seeds):
    """K5's errors and device ms at each split depth in ``chains`` (0: no
    split), the shipped ``SPLITK_K`` restored afterwards."""
    import importlib

    from chip_smoke import device_ms

    fg = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")
    shipped, rows = fg.SPLITK_K, []
    try:
        for chain in chains:
            fg.SPLITK_K = chain or 1 << 30
            for m, n, k, role in SHAPES:
                worst = {"max_abs_err": 0.0, "rms_err": 0.0}
                for seed in range(seeds):
                    rng = np.random.default_rng(seed)
                    draw = lambda *s: torch.from_numpy(  # noqa: E731
                        rng.standard_normal(s, dtype=np.float32)
                        * 0.5).cuda()
                    x, y, bias = draw(m, k), draw(k, n), draw(n)
                    ref = torch.addmm(bias.double(), x.double(), y.double())
                    e = errors(fg.fused_gemm(x, y, bias), ref)
                    for key in worst:
                        worst[key] = max(worst[key], e[key])
                dev = {}
                for b in fg.COMPILED_BLOCKS:
                    dev[str(b)] = device_ms(lambda: fg.fused_gemm(
                        x, y, bias, block_m=b[0], block_n=b[1],
                        block_k=b[2]))
                rows.append(dict(chain=chain, m=m, n=n, k=k, role=role,
                                 splits=fg.splitk_splits(m, n, k),
                                 device_ms=dev, **worst))
                print(f"  chain {chain or 'all of K':>8} [{m},{k}]@[{k},{n}]"
                      f" {rows[-1]['splits']:2d} splits: max abs "
                      f"{worst['max_abs_err']:.3e}, rms "
                      f"{worst['rms_err']:.3e}; device ms " + ", ".join(
                          f"{b} {v:.4f}" for b, v in dev.items()))
    finally:
        fg.SPLITK_K = shipped
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--chains", default="",
                    help="comma-separated split depths to sweep (0: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}")
    rows = []
    for m, n, k, role in SHAPES:
        for seed in range(args.seeds):
            for r in check(m, n, k, role, seed):
                rows.append(r)
                extra = (f", vs addmm {r['max_abs_vs_addmm']:.3e}"
                         if "max_abs_vs_addmm" in r else "")
                print(f"  [{m},{k}]@[{k},{n}] {role:26s} seed {seed} "
                      f"{r['route']:22s}: max abs {r['max_abs_err']:.3e}, "
                      f"max rel {r['max_rel_err']:.3e}, rms "
                      f"{r['rms_err']:.3e}{extra}")
    # the verdict per shape: K5's worst max-abs error over seeds and
    # triples against addmm's
    verdict = {}
    for m, n, k, role in SHAPES:
        mine = [r for r in rows if r["role"] == role]
        k5 = max(r["max_abs_err"] for r in mine if r["route"] != "addmm")
        dense = max(r["max_abs_err"] for r in mine if r["route"] == "addmm")
        verdict[role] = {"k5_max_abs_err": k5, "addmm_max_abs_err": dense,
                         "k5_farther": k5 > dense}
        print(f"{role}: K5 worst {k5:.3e}, addmm worst {dense:.3e} -> "
              f"{'K5 farther' if k5 > dense else 'K5 not farther'}")
    times = [timings(m, n, k) for m, n, k, _ in SHAPES]
    for t in times:
        print(f"  [{t['m']},{t['k']}]@[{t['k']},{t['n']}] + bias, "
              f"{t['splits']} splits: K5 {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} (device "
              f"{t['plain_device_ms']:.4f}), addmm {t['library_ms']:.4f} "
              f"(device {t['library_device_ms']:.4f}), bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']})")
    chains = [int(c) for c in args.chains.split(",") if c.strip()]
    swept = sweep(chains, args.seeds) if chains else []
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "k5_small_m_check.json"),
                  "w") as f:
            json.dump({"card": card, "rows": rows, "verdict": verdict,
                       "times": times, "sweep": swept}, f, indent=1)
    print(json.dumps({"verdict": verdict}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
