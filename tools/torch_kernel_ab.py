"""Time two copies of the port's CUDA kernels on one GPU, in turns (A/B).

    python3 tools/torch_kernel_ab.py --roots OLD NEW [--iters 20] [--out FILE]

Each DIR holds a ``paddle_tpu_torch`` package: this checkout, or an older
one unpacked with ``git archive`` into a directory of the repo that
``.gitignore`` lists (a copy of the repo made for the card is not a git
repository). The two copies' ``kernels`` packages are loaded side by side
in this one process, each building its kernels from its own ``csrc/`` into
its own ``_build/``, and every row runs on the same inputs in turns OLD,
NEW, NEW, OLD; a copy's time is the mean of its two turns.

Rows: K5 (fused GEMM) at BERT-base inference's four f32 shapes and FFN1 in
bf16 to both output types; K1 (flash forward) at its four f32 main-path
shapes ([96,512,64] and [96,128,64] causal + bias, serving prefill;
[384,128,64] bias + dropout 0.1, training; [384,512,64] bias, inference)
and [96,512|128,64] bf16 causal; K2 at its main-path row; K3 and K4
(flash backward) at [384,128,64] f32 bias + dropout 0.1 (training),
[96,512,64] f32 causal + bias and [384,128,64] bf16 bias + dropout 0.1,
on lse and delta from the plain forward.

Two times a launch: ``ms``, as ``chip_smoke.py`` takes it (CUDA events
around each wrapper call, a 64 MiB write evicting L2 before it, mean of
``--iters`` after 3 warm-ups), and ``device_ms``, the kernel's own device
time from ``torch.profiler`` over ``--iters`` back-to-back calls, which
leaves out the wrapper's host time. K5, K1, K3 and K4 rows also time the
library call for the same function by both methods (``torch.addmm``;
``scaled_dot_product_attention`` with an equivalent mask, its forward for
K1 and its whole backward, dQ, dK and dV together, for K3 and K4). Prints
the card, each copy's ptxas registers and spills for K1, K3, K4 and K5,
the tensor-core instruction count (``cuobjdump -sass``) of each of their
kernels where the copy can read it, and one JSON line a row; ``--out``
appends the JSON lines to FILE.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

# chip_smoke.py, at the repo's root, times SDPA's backward the same way
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import sdpa_backward  # noqa: E402

_FLUSH = None


def load_kernels(root: str, tag: str):
    """``root``'s ``paddle_tpu_torch/kernels`` as the package ``tag``
    (it imports nothing outside itself but torch)."""
    pkg = os.path.join(os.path.abspath(root), "paddle_tpu_torch", "kernels")
    spec = importlib.util.spec_from_file_location(
        tag, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[tag] = mod
    spec.loader.exec_module(mod)
    return mod


def event_ms(fn, iters):
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 * 1024 * 1024, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def device_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type.name == "CUDA") / iters / 1e3


def pad_bias(B, S, gen):
    lens = torch.randint(S // 2, S + 1, (B,), generator=gen, device="cuda")
    lens[0] = S
    return torch.where(torch.arange(S, device="cuda")[None, :]
                       < lens[:, None], 0.0, -10000.0).float()


def k5_row(gen, m, n, k, epilogue, dtype, out_dtype):
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    y = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5).to(dtype)
    bias = torch.randn(n, generator=gen, device="cuda")
    args = dict(bias=bias, activation="gelu" if "gelu" in epilogue
                else "none", layer_norm="layer_norm" in epilogue,
                out_dtype=out_dtype)
    if args["layer_norm"]:
        args.update(ln_scale=torch.randn(n, generator=gen, device="cuda"),
                    ln_bias=torch.randn(n, generator=gen, device="cuda"))
    bias_lib = bias.to(dtype)
    return (dict(kernel="K5", shape=[m, n, k], epilogue=epilogue,
                 dtype=str(dtype)[6:], out_dtype=str(out_dtype)[6:]),
            lambda K: K.fused_gemm(x, y, **args),
            lambda: torch.addmm(bias_lib, x, y))


def k1_row(gen, B, S, causal, rate, dtype, H=12, D=64):
    BH = B * H
    q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    bias = pad_bias(B, S, gen)
    args = dict(bias=bias, causal=causal, num_heads=H, dropout_rate=rate,
                seed=1234)
    mask = bias.reshape(B, 1, 1, S)
    if causal:
        mask = mask + torch.full((S, S), float("-inf"),
                                 device="cuda").triu(1)
    mask = mask.to(dtype)
    q4, k4, v4 = (t.reshape(B, H, S, D) for t in (q, k, v))
    return (dict(kernel="K1", shape=[BH, S, D], dtype=str(dtype)[6:],
                 causal=causal, dropout=rate),
            lambda K: K.flash_attention_with_lse(q, k, v, **args),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, dropout_p=rate))


def k2_row(gen, B=8, H=12, S=1024, D=64):
    BH = B * H
    q = torch.randn(BH, 1, D, generator=gen, device="cuda")
    kc, vc = (torch.randn(BH, S, D, generator=gen, device="cuda")
              for _ in range(2))
    lens = torch.tensor([1, 8, 9, 16, 333, 700, 1017, 1024],
                        dtype=torch.int32, device="cuda")
    return (dict(kernel="K2", shape=[BH, 1, S, D], dtype="float32"),
            lambda K: K.flash_attention_decode(q, kc, vc, lens, num_heads=H),
            None)


def k34_rows(gen, ref, B, H, S, dtype, causal, rate, D=64):
    """K3 and K4 on lse and delta from the plain forward (``ref``'s
    ``flash_attention_reference``), as the autograd wrapper computes them,
    with SDPA's whole backward (``chip_smoke.sdpa_backward``) as the library
    call of both."""
    BH = B * H
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    bias = pad_bias(B, S, gen)
    kw = dict(causal=causal, dropout_rate=rate, seed=4321, num_heads=H)
    o, lse = ref.flash_attention_reference(q, k, v, bias=bias, **kw)
    delta = (do.float() * o.float()).sum(-1)
    del o
    args = (q, k, v, bias, do, lse, delta)
    mask = bias.reshape(B, 1, 1, S)
    if causal:
        mask = mask + torch.full((S, S), float("-inf"),
                                 device="cuda").triu(1)
    lib, _ = sdpa_backward(q, k, v, do, mask, rate, D ** -0.5, B, H)
    info = dict(shape=[BH, S, D], dtype=str(dtype)[6:], causal=causal,
                dropout=rate)
    return [(dict(info, kernel="K3"),
             lambda K: K.flash_attention_dq(*args, **kw), lib),
            (dict(info, kernel="K4"),
             lambda K: K.flash_attention_dkv(*args, **kw), lib)]


def first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


# the sources whose ptxas report and SASS tensor-core count are printed
REPORTED = ("fused_gemm", "flash_attention_fwd", "flash_attention_dq",
            "flash_attention_dkv")


def ptxas_report(mod, names=REPORTED):
    """(kernel function, registers, spill line) from each build's log."""
    rows = []
    for name in names:
        fn = None
        for line in mod._build.build_logs.get(name, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                rows.append((name, fn, int(m.group(1))))
            if "spill" in line and fn and "0 bytes spill" not in line:
                rows.append((name, fn, line.strip()))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs=2, required=True,
                    metavar=("OLD", "NEW"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    mods = {"old": load_kernels(args.roots[0], "_ab_old_kernels"),
            "new": load_kernels(args.roots[1], "_ab_new_kernels")}
    for tag, K in mods.items():
        with ThreadPoolExecutor(len(K.KERNEL_SOURCES)) as pool:
            list(pool.map(K._build.load, K.KERNEL_SOURCES))
        for name, fn, regs in ptxas_report(K):
            print(f"[ptxas {tag}] {name} {fn}: {regs}")
        if hasattr(K._build, "sass"):
            for name in REPORTED:
                for fn, text in K._build.sass(name).items():
                    print(f"[sass {tag}] {name} {fn}: "
                          f"{K._build.tensor_core_ops(text)} tensor-core "
                          f"instructions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = [k5_row(gen, 16384, 768, 768, "bias", f32, f32),
            k5_row(gen, 16384, 3072, 768, "bias+gelu", f32, f32),
            k5_row(gen, 16384, 768, 3072, "bias", f32, f32),
            k5_row(gen, 16384, 768, 768, "bias+gelu+layer_norm", f32, f32),
            k5_row(gen, 16384, 3072, 768, "bias+gelu", bf16, f32),
            k5_row(gen, 16384, 3072, 768, "bias+gelu", bf16, bf16),
            k1_row(gen, 8, 512, True, 0.0, f32),
            k1_row(gen, 8, 128, True, 0.0, f32),
            k1_row(gen, 32, 128, False, 0.1, f32),
            k1_row(gen, 32, 512, False, 0.0, f32),
            k1_row(gen, 8, 512, True, 0.0, bf16),
            k1_row(gen, 8, 128, True, 0.0, bf16),
            k2_row(gen)]
    for B, S, dtype, causal, rate in ((32, 128, f32, False, 0.1),
                                      (8, 512, f32, True, 0.0),
                                      (32, 128, bf16, False, 0.1)):
        rows += k34_rows(gen, mods["new"], B, 12, S, dtype, causal, rate)
    results = []
    for info, run, lib in rows:
        turns = []
        for tag in ("old", "new", "new", "old"):
            K = mods[tag]
            turns.append((tag, event_ms(lambda: run(K), args.iters),
                          device_ms(lambda: run(K), args.iters)))
        outs = {tag: first(run(K)) for tag, K in mods.items()}
        torch.cuda.synchronize()
        r = dict(info, card=card, iters=args.iters,
                 max_abs_diff=float((outs["old"].float()
                                     - outs["new"].float()).abs().max()))
        for tag in ("old", "new"):
            ts = [t for t in turns if t[0] == tag]
            r[f"{tag}_ms"] = sum(t[1] for t in ts) / 2
            r[f"{tag}_device_ms"] = sum(t[2] for t in ts) / 2
        r["turns"] = turns
        if lib is not None:
            r["library_ms"] = event_ms(lib, args.iters)
            r["library_device_ms"] = device_ms(lib, args.iters)
        results.append(r)
        print(json.dumps(r), flush=True)
    print("[summary] row | old ms (device) | new ms (device) | library ms "
          "(device)")
    for r in results:
        lib = (f"{r['library_ms']:.4f} ({r['library_device_ms']:.4f})"
               if "library_ms" in r else "-")
        tag = " ".join(str(r.get(k)) for k in (
            "kernel", "shape", "epilogue", "dtype", "out_dtype", "causal",
            "dropout") if r.get(k) is not None)
        print(f"  {tag} | {r['old_ms']:.4f} ({r['old_device_ms']:.4f}) | "
              f"{r['new_ms']:.4f} ({r['new_device_ms']:.4f}) | {lib}")
    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
