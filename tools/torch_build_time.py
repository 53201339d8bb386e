"""Time ``nvcc`` on the port's CUDA sources, with and without
``--split-compile=0``, one build at a time.

    python3 tools/torch_build_time.py [--sources fused_gemm,...] [--out FILE]

Each source in ``paddle_tpu_torch/csrc`` (default: all of
``kernels.KERNEL_SOURCES``) is compiled with the flags
``kernels._build.NVCC_FLAGS`` names, once without ``--split-compile`` and
once with it, into a temporary directory, and the wall time of each
``nvcc`` call and ptxas's register and spill lines are reported. Builds
run one after another, so each time is that source's alone (``chip_smoke.py``
builds all sources at once). Prints one JSON line per build; with
``--out``, appends them to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch import kernels as K  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402

SPLIT = "--split-compile=0"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", default=",".join(K.KERNEL_SOURCES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    nvcc = _build._nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    base = [f for f in _build.NVCC_FLAGS if f != SPLIT]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sources.split(","):
            for split in (False, True):
                flags = base + ([SPLIT] if split else [])
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [nvcc, *flags, "-o", os.path.join(tmp, f"{name}.so"),
                     os.path.join(_build.CSRC, name + ".cu")],
                    capture_output=True, text=True)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise SystemExit(f"nvcc failed for {name}:\n"
                                     f"{proc.stderr}")
                ptxas = [ln.strip() for ln in proc.stderr.splitlines()
                         if "registers" in ln or "spill" in ln]
                row = dict(source=f"csrc/{name}.cu", split_compile=split,
                           seconds=seconds, nvcc=version,
                           cpus=os.cpu_count(), ptxas=ptxas)
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
