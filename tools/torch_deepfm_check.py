"""DeepFM on one GPU, alone: ``chip_smoke.py``'s ``deepfm`` and
``deepfm_infer`` phases and K5 at DeepFM's inference GEMM, without the
rest of the script.

    python3 tools/torch_deepfm_check.py [--seed 0] [--out-dir DIR]

Prints the card, K5 at [4096,400]@[400,400] +bias+relu f32 against its
plain version (with kernel, plain and ``addmm`` times), then the two
phases' reports and gates exactly as ``chip_smoke.py`` runs them (sparse
training at the DeepFM paper's Criteo widths: steps/s, examples/s, the
profiled step, repeat, card against CPU, dense tables, SGD sparse and
dense, the sync check; fused and unfused inference of the pruned
``pred`` program). Any failed gate exits non-zero. With ``--out-dir``,
also writes ``DIR/deepfm_check.json``. About 40 s of command time, most
of it building K5.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    card = cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    row = cs.check_gemm(gen, 4096, 400, 400, "bias+relu", torch.float32,
                        torch.float32)
    cs.log(f"  fused_gemm [4096, 400, 400] float32 +bias+relu: kernel "
           f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}) | plain "
           f"{row['plain_ms']:.4f} ms | addmm {row['library_ms']:.4f} ms "
           f"(device {row['library_device_ms']:.4f}) | bound "
           f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    fm = cs.phase_deepfm(args.seed)
    infer = cs.phase_deepfm_infer(fm.pop("_ctx"), args.seed)
    cs.log("[seconds] " + ", ".join(f"{k} {v:.2f}"
                                    for k, v in cs.TIMES.items()))
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "deepfm_check.json"), "w") as f:
            json.dump({"card": card, "k5_row": row, "deepfm": fm,
                       "deepfm_infer": infer, "seconds": cs.TIMES}, f,
                      indent=1, default=str)


if __name__ == "__main__":
    main()
