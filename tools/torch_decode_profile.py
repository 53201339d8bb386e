"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python3 tools/torch_decode_profile.py [--steps 8] [--pos 256] [--seed 0]
                                          [--out-dir DIR]

Builds GPT-2 small (``GptConfig.base()``, random weights from ``--seed``)
with 8 slots and a 1024-token paged KV cache, puts every slot at position
``--pos`` with its decode gate on, and profiles one ``run_chained`` decode
chunk of ``--steps`` steps with ``torch.profiler``. Prints the wall time per
step (host clock, ending in a synchronize), the summed device time of the
kernels per step, the device's idle share, kernel launches per step, the
paged decode-attention kernel's (K2's) device time and launches per step,
and the kernels that take the most device time; with ``--out-dir``, also
to ``DIR/decode_profile.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import kernels as K  # noqa: E402
from paddle_tpu_torch.models.gpt import (GptConfig,  # noqa: E402
                                         build_gpt_generative)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--pos", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_gpt_generative(GptConfig.base(), batch_slots=8,
                                 max_seq=1024, page_size=8,
                                 prompt_buckets=(128,))
    model["startup"].random_seed = args.seed
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(model["startup"], scope=scope)
    rng = np.random.RandomState(args.seed)
    for name, (shape, dt) in model["state_vars"].items():
        if name.startswith("gpt_kv_"):
            val = rng.randn(*shape).astype(np.float32) * 0.5
        elif name == "gpt_gen_pos":
            val = np.full(shape, args.pos, np.int64)
        elif name == "gpt_gen_active":
            val = np.ones(shape, np.float32)
        else:
            val = rng.randint(1, 50257, shape).astype(np.int64)
        scope.set_var(name, val)
    dec = model["decode"]

    def chunk():
        return exe.run_chained(dec["main"], feed={},
                               fetch_list=[dec["next_token"]],
                               steps=args.steps, scope=scope)

    chunk()                                   # warm-up (builds K2)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    chunk()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        wall_prof = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0 and e.device_type.name == "CUDA":
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    k2 = [(us, n) for us, k, n in rows if "decode_kernel" in k]
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    out = {
        "card": card, "steps": args.steps, "pos": args.pos, "slots": 8,
        "wall_ms_per_step": wall_plain * 1e3 / args.steps,
        "wall_ms_per_step_profiled": wall_prof * 1e3 / args.steps,
        "device_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_prof,
        "kernel_launches_per_step": sum(r[2] for r in rows) / args.steps,
        "decode_attention_launches": K.launch_counts()["decode_attention"],
        "k2_device_ms_per_step": sum(us for us, _ in k2) / 1e3 / args.steps,
        "k2_launches_per_step": sum(n for _, n in k2) / args.steps,
        "top_kernels": [{"name": k[:90], "device_ms_per_step":
                         us / 1e3 / args.steps, "calls_per_step":
                         n / args.steps} for us, k, n in rows[:12]],
    }
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "decode_profile.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    for r in out["top_kernels"]:
        print(f"  {r['device_ms_per_step']:.4f} ms/step  "
              f"{r['calls_per_step']:.1f} calls/step  {r['name']}")
    print(json.dumps({k: v for k, v in out.items() if k != "top_kernels"}))


if __name__ == "__main__":
    main()
