"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out-dir DIR]

Phases, in order; any failure exits non-zero (no phase is caught):

1. device — requires CUDA; prints the card's name and power limit; turns
   TF32 off for float32 matrix products and convolutions.
2. kernels — builds every kernel of the serving path from
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, all at once), runs
   each on the card at the main path's shapes against its plain PyTorch
   version (``kernels.KERNEL_TOL``: f32 atol 1e-4 / rtol 1e-3, the two sum
   in different orders; bf16 atol 8e-3 / rtol 1.6e-2, about two bf16
   ulp), and times kernel, plain version and one library call
   (``F.scaled_dot_product_attention`` with an equivalent mask) with CUDA
   events, L2 flushed before each launch.
3. serve — GPT-2 small (``GptConfig.base()``, random weights from
   ``--seed``) behind ``GenerativeEngine``: 8 slots, 1024-token paged KV,
   prompt buckets 128/512; 12 greedy requests of 32 new tokens (prompts of
   20..500 tokens, four sharing a 256-token prefix so the prefix cache
   hits, one of 600 tokens that runs as chunked prefill only). Every
   request settles, the accounting is exact and both kernels launched.
4. whole-path check — the same requests with
   ``FLAGS_use_flash_attention=never`` (the plain versions) on fresh state
   with the same weights: greedy tokens agree wherever the kernel run's
   top-2 logit gap exceeds 1e-3 (gaps from a teacher-forced forward).
5. prints the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``. With ``--out-dir``, everything
   measured is also written to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch as fluid
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models.gpt import (GptConfig, build_gpt_generative,
                                         build_gpt_prefill)
from paddle_tpu_torch.serving import (GenerationConfig, GenerativeEngine,
                                      ServingConfig)

# H100 SXM published peaks (dense): bytes/s of HBM3, FLOP/s per type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = K.KERNEL_TOL
REPLACES = {
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:167",
    "decode_attention": "paddle_tpu/kernels/decode_attention.py:117",
}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- device
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available — this script "
                         "runs the port on an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card


# ---------------------------------------------------------------- timing
_FLUSH = None


def time_ms(fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    its own CUDA-event pair after a 64 MiB write that evicts L2."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 * 1024 * 1024, dtype=torch.float32,
                             device="cuda")
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


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name, got, want, dtype):
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max())
    rel = float((err / want.float().abs().clamp_min(1e-6)).max())
    ok = torch.allclose(got.float(), want.float(), **TOL[dtype])
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={rel:.3e} "
        f"tol={TOL[dtype]} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                         f"version beyond {TOL[dtype]}")
    return max_abs


# ---------------------------------------------------------------- kernels
def check_flash(S, dtype, gen, B=8, H=12, D=64):
    BH = B * H
    q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device="cuda")
    lens[0] = S
    bias = torch.where(torch.arange(S, device="cuda")[None, :] < lens[:, None],
                       0.0, -10000.0).float()
    scale = D ** -0.5
    args = dict(bias=bias, causal=True, scale=scale, num_heads=H)
    o_k, lse_k = K.flash_attention_with_lse(q, k, v, **args)
    o_p, lse_p = K.flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    tag = f"K1 [{BH},{S},{D}] {str(dtype)[6:]} causal+bias"
    err = compare(tag + " o", o_k, o_p, dtype)
    compare(tag + " lse", lse_k, lse_p, torch.float32)
    mask = bias.reshape(B, 1, 1, S) + torch.full(
        (S, S), float("-inf"), device="cuda").triu(1)
    q4, k4, v4 = (t.reshape(B, H, S, D) for t in (q, k, v))
    ms = time_ms(lambda: K.flash_attention_with_lse(q, k, v, **args))
    plain = time_ms(lambda: K.flash_attention_reference(q, k, v, **args))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask.to(dtype), scale=scale))
    pairs = BH * S * (S + 1) // 2          # visible (q, k) pairs, causal
    elt = q.element_size()
    nbytes = 4 * BH * S * D * elt + B * S * 4 + BH * S * 4
    b_ms, b_by = bound(4 * D * pairs, nbytes, dtype)
    return dict(shape=[BH, S, D], dtype=str(dtype)[6:], max_abs_err=err,
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def check_decode(q_len, dtype, gen, B=8, H=12, S=1024, D=64):
    BH = B * H
    q = torch.randn(BH, q_len, D, generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randn(BH, S, D, generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    # early, page-boundary, mid and full-cache lengths
    lens = torch.tensor([1, 8, 9, 16, 333, 700, 1017, 1024],
                        dtype=torch.int32, device="cuda")[:B]
    scale = D ** -0.5
    o_k = K.flash_attention_decode(q, kc, vc, lens, scale=scale,
                                   num_heads=H)
    per_bh = lens.long().repeat_interleave(H)
    o_p = K.decode_attention_reference(q, kc, vc, per_bh, scale)
    torch.cuda.synchronize()
    tag = f"K2 q_len={q_len} caches [{BH},{S},{D}] {str(dtype)[6:]}"
    err = compare(tag, o_k, o_p, dtype)
    vis = torch.arange(S, device="cuda")[None, None, :] < (
        lens.long()[:, None, None] + torch.arange(q_len, device="cuda")
        [None, :, None])                                   # [B, q_len, S]
    mask = torch.zeros(B, 1, q_len, S, device="cuda", dtype=dtype)
    mask.masked_fill_(~vis[:, None], float("-inf"))
    q4 = q.reshape(B, H, q_len, D)
    k4, v4 = kc.reshape(B, H, S, D), vc.reshape(B, H, S, D)
    ms = time_ms(lambda: K.flash_attention_decode(q, kc, vc, lens,
                                                  scale=scale, num_heads=H))
    plain = time_ms(lambda: K.decode_attention_reference(q, kc, vc, per_bh,
                                                         scale))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, scale=scale))
    elt = q.element_size()
    keys = torch.clamp(lens.long() + q_len - 1, max=S)     # rows read
    row_keys = vis.sum().item()                            # (row, key) pairs
    nbytes = (H * int(keys.sum()) * 2 * D * elt + 2 * BH * q_len * D * elt
              + B * 4)
    b_ms, b_by = bound(4 * D * H * row_keys, nbytes, dtype)
    return dict(shape=[BH, q_len, S, D], dtype=str(dtype)[6:],
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def phase_kernels(seed):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(K.KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load, K.KERNEL_SOURCES))
    log(f"[kernels] built {list(K.KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res = {"flash_attention_fwd": [], "decode_attention": []}
    for dtype in (torch.float32, torch.bfloat16):
        for S in (128, 512):
            res["flash_attention_fwd"].append(check_flash(S, dtype, gen))
        for q_len in (1, 8):
            res["decode_attention"].append(check_decode(q_len, dtype, gen))
    for name, rows in res.items():
        for r in rows:
            log(f"  {name} {r['shape']} {r['dtype']}: kernel "
                f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | sdpa "
                f"{r['library_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    return res


# ---------------------------------------------------------------- serve
def make_requests(seed, vocab):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab, 256)
    lens = [20, 45, 80, 127, 150, 230, 390, 500]
    shared = [np.concatenate([prefix, rng.randint(1, vocab, n)])
              for n in (30, 64, 101, 200)]
    plain = [rng.randint(1, vocab, n) for n in lens[:7]]
    long_prompt = rng.randint(1, vocab, 600)
    # the first shared-prefix request goes alone, so its pages are
    # published before the other three are admitted
    return [shared[0]], shared[1:] + plain + [long_prompt]


def serve(model, params, exe, seed, vocab):
    scope = fluid.Scope()
    for n, t in params.items():
        scope.set_var(n, t)
    eng = GenerativeEngine(
        model, scope=scope, executor=exe,
        config=ServingConfig(queue_depth=64, deadline_s=0),
        gen_config=GenerationConfig(decode_chunk=8, prefix_cache_pages=256))
    eng.warm_up()
    first, rest = make_requests(seed, vocab)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eng:
        futs = [eng.submit(p, max_new_tokens=32) for p in first]
        next(futs[0].stream(timeout=600))
        futs += [eng.submit(p, max_new_tokens=32) for p in rest]
        outs = [f.result(timeout=900)[0] for f in futs]
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    acct = eng.accounting()
    stats = eng.generation_stats()
    return dict(prompts=first + rest, tokens=outs, wall_s=wall,
                launches=launches, accounting=acct, stats=stats)


def phase_serve(seed):
    cfg = GptConfig.base()
    model = build_gpt_generative(cfg, batch_slots=8, max_seq=1024,
                                 page_size=8, prompt_buckets=(128, 512))
    model["startup"].random_seed = seed
    exe = fluid.Executor()                       # CUDAPlace(0)
    pscope = fluid.Scope()
    exe.run(model["startup"], scope=pscope)
    params = dict(pscope.vars)
    run = serve(model, params, exe, seed, cfg.vocab_size)
    acct, stats = run["accounting"], run["stats"]
    n_tok = sum(len(t) for t in run["tokens"])
    pt = stats["phase_time"]
    prefix_hits = stats["prefix_cache"]["hits"]
    log(f"[serve] GPT-2 small, 8 slots, {len(run['tokens'])} requests, "
        f"{n_tok} tokens in {run['wall_s']:.3f}s = "
        f"{n_tok / run['wall_s']:.2f} tok/s")
    for p, r in sorted(pt.items()):
        log(f"  {p}: {r['dispatches']} dispatches, {r['units']} units, "
            f"{r['seconds'] * 1e3 / max(r['dispatches'], 1):.3f} ms per "
            f"dispatch")
    if "decode" in pt:
        log(f"  decode step: "
            f"{pt['decode']['seconds'] * 1e3 / pt['decode']['units']:.3f} "
            f"ms per step (8 slots)")
    log(f"  prefix-cache hits {prefix_hits}, chunk slices "
        f"{stats['prefill_chunks']}, launches {run['launches']}, "
        f"accounting exact={acct['exact']} completed={acct['completed']}")
    if not acct["exact"] or acct["completed"] != len(run["tokens"]):
        raise SystemExit(f"chip_smoke: serving accounting broken: {acct}")
    if any(len(t) != 32 for t in run["tokens"]):
        raise SystemExit("chip_smoke: a request did not stream 32 tokens")
    if prefix_hits < 1:
        raise SystemExit("chip_smoke: the shared prefix never hit the cache")
    for name, n in run["launches"].items():
        if n < 1:
            raise SystemExit(f"chip_smoke: kernel {name} was never launched "
                             f"on the serving path")
    return model, params, exe, run


def teacher_forced_gaps(cfg, params, exe, prompts, tokens):
    """Top-1 token and top-2 logit gap at every generated position, from
    a full-sequence forward of prompt + generated tokens (kernel path)."""
    S = 1024
    net = build_gpt_prefill(cfg, 1, S, S, page_size=8, fetch_logits=True)
    scope = fluid.Scope()
    for n, t in params.items():
        scope.set_var(n, t)
    for n, (shape, dt) in net["state_vars"].items():
        scope.set_var(n, np.zeros(shape, np.dtype(dt)))
    out = []
    for p, t in zip(prompts, tokens):
        seq = np.concatenate([p, t[:-1]])
        L = len(seq)
        feed = {"prompt_ids": np.zeros((1, S), np.int64),
                "prompt_pos": np.arange(S, dtype=np.int64)[None],
                "prompt_mask": np.zeros((1, S), np.float32),
                "prompt_len": np.array([[L]], np.int64),
                "slot_mask": np.zeros((1, 1), np.float32)}
        feed["prompt_ids"][0, :L] = seq
        feed["prompt_mask"][0, :L] = 1.0
        lg = exe.run(net["main"], feed=feed, fetch_list=[net["logits"]],
                     scope=scope, return_numpy=False)[0][0]
        rows = lg[len(p) - 1:L]                      # predicts t[0..]
        top2 = torch.topk(rows, 2, dim=-1).values
        out.append((rows.argmax(-1).cpu().numpy(),
                    (top2[:, 0] - top2[:, 1]).cpu().numpy()))
    return out


def phase_whole_path(model, params, exe, run, seed):
    fluid.set_flags({"FLAGS_use_flash_attention": "never"})
    try:
        plain = serve(model, params, exe, seed,
                      model["config"].vocab_size)
    finally:
        fluid.set_flags({"FLAGS_use_flash_attention": "auto"})
    if any(n for n in plain["launches"].values()):
        raise SystemExit(f"chip_smoke: the plain run launched kernels: "
                         f"{plain['launches']}")
    gaps = teacher_forced_gaps(model["config"], params, exe,
                               run["prompts"], run["tokens"])
    compared = agreed = near_ties = 0
    for i, (a, b) in enumerate(zip(run["tokens"], plain["tokens"])):
        _, gap = gaps[i]
        for j in range(len(a)):
            if gap[j] > 1e-3:
                compared += 1
                if a[j] != b[j]:
                    raise SystemExit(
                        f"chip_smoke: request {i} token {j}: kernel run "
                        f"{a[j]} vs plain run {b[j]} at top-2 gap "
                        f"{gap[j]:.3e} > 1e-3")
                agreed += 1
            else:
                near_ties += 1
            if a[j] != b[j]:
                # a near-tie split the runs; later tokens see different
                # contexts and are not comparable
                break
    log(f"[whole-path] kernel vs plain runs: {agreed}/{compared} compared "
        f"positions agree (top-2 gap > 1e-3); {near_ties} near-tie "
        f"position(s) skipped; plain run {plain['wall_s']:.3f}s")
    return dict(compared=compared, agreed=agreed, near_ties=near_ties,
                plain_wall_s=plain["wall_s"])


# ---------------------------------------------------------------- main
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None,
                    help="also write the full report to DIR/chip_smoke.json")
    args = ap.parse_args()
    card = phase_device()
    kres = phase_kernels(args.seed)
    model, params, exe, run = phase_serve(args.seed)
    whole = phase_whole_path(model, params, exe, run, args.seed)
    launches = run["launches"]
    n_tok = sum(len(t) for t in run["tokens"])
    report = {"card": card, "kernels": kres, "serve": {
        "wall_s": run["wall_s"], "tokens": n_tok,
        "tok_per_s": n_tok / run["wall_s"], "launches": launches,
        "accounting": dict(run["accounting"]), "stats": run["stats"],
        "whole_path": whole}}
    main_shape = {"flash_attention_fwd": ([96, 512, 64], "float32"),
                  "decode_attention": ([96, 1, 1024, 64], "float32")}
    line = []
    for name, rows in kres.items():
        shape, dt = main_shape[name]
        r = next(r for r in rows if r["shape"] == shape and r["dtype"] == dt)
        line.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["dtype"] == "float32"),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    report["kernels_line"] = line
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
