"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out-dir DIR]

Phases, in order; any failure exits non-zero (no phase is caught):

1. device — requires CUDA; prints the card's name and power limit; turns
   TF32 off for float32 matrix products and convolutions.
2. kernels — builds every kernel of the serving, training and inference
   paths from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once), runs each on the card at the main paths' shapes (K1: serving
   prefill [96,128|512,64] causal, f32 and bf16; training [384,128,64]
   with dropout; inference [384,512,64]) against its
   plain PyTorch version (``kernels.KERNEL_TOL``: f32 atol 1e-4 / rtol
   1e-3, the two sum in different orders; bf16 atol 8e-3 / rtol 1.6e-2,
   about two bf16 ulp), checks that K1, K3 and K4 drop exactly the
   elements the plain version's Philox mask drops, and times kernel,
   plain version and one library call (``F.scaled_dot_product_attention``
   with an equivalent mask: its forward for K1 and K2, its backward alone
   for K3 and K4; ``torch.addmm`` for K5, the GEMM + bias part of its
   work) with CUDA events, L2 flushed before each launch.
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
5. train — BERT-base pretraining (``BertConfig.base()``: 12 layers, hidden
   768, 12 heads, vocab 30522, hidden and attention dropout 0.1, Adam at
   lr 1e-4; f32, batch 32, seq 128; random weights and a synthetic batch
   from ``--seed``): 10 ``Executor.run`` steps through the kernels (K1 24
   launches a step: 12 forward + 12 in the grad ops' recompute; K3 and K4
   12 each), then 10 steps with ``FLAGS_use_flash_attention=never`` on
   fresh state from the same weights and feeds. Step-1 losses agree within
   rtol 1e-5, later steps within rtol 1e-3, the loss falls, and the
   device memory held between steps stays flat. Reports steps/s,
   tokens/s, peak device memory and one profiled step's device idle share,
   top kernels and the device time of each of the port's kernels.
6. infer — BERT-base inference (``BertConfig.base()``, f32, batch 32, seq
   512; ``build_bert_pretrain(build_optimizer=False)`` cloned for test;
   random weights and a synthetic batch from ``--seed``; fetch the loss
   and the last encoder layer), run three ways on the same weights and
   feed: (a) ``FLAGS_epilogue_fusion=1``, the fusion pass (witnessed on
   the card) fusing 75 chains, K5 launched 74 times a forward (every chain
   but the NSP head, n = 2, which ``classify_gemm`` refuses) and K1 12;
   (b) ``FLAGS_epilogue_fusion=0``, the unfused program on cuBLAS; (c)
   fusion with ``FLAGS_use_fused_gemm=never``, the dense replay, bit-exact
   against (b) with no K5 launch (a check: one forward after the warm-up,
   neither timed nor profiled). (a) and (b) agree on the loss within
   rtol 1e-4 and on the encoder output within atol 1e-3; reports forward
   ms (median of 5 after a warm-up), peak device memory, one profiled
   forward's device idle share and top kernels, and the witness's largest
   error per chain signature.
7. prints the script time of each phase and part (``[seconds]``), the
   ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``. With ``--out-dir``, everything
   measured is also written to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

import paddle_tpu_torch as fluid
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
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
    "flash_attention_dq": "paddle_tpu/kernels/flash_attention.py:293",
    "flash_attention_dkv": "paddle_tpu/kernels/flash_attention.py:327",
    "fused_gemm": "paddle_tpu/kernels/fused_gemm.py:146",
}
# the kernels the serving path runs (no backward there)
SERVE_KERNELS = ("flash_attention_fwd", "decode_attention")
# the shape and type of each kernel's row in the kernels line: the main
# paths' (K1 serving prefill, K2 decode, K3/K4 BERT training)
MAIN_ROW = {"flash_attention_fwd": ([96, 512, 64], "float32", 0.0),
            "decode_attention": ([96, 1, 1024, 64], "float32", 0.0),
            "flash_attention_dq": ([384, 128, 64], "float32", 0.1),
            "flash_attention_dkv": ([384, 128, 64], "float32", 0.1),
            "fused_gemm": ([16384, 3072, 768], "float32", 0.0)}


def log(*a):
    print(*a, flush=True)


# seconds of script time by phase and part, reported at the end
TIMES = {}


@contextlib.contextmanager
def timed(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        TIMES[name] = time.perf_counter() - t0


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


def _pad_bias(B, S, gen):
    """Additive [B, S] key bias of BERT's padding mask: 0 on tokens,
    -10000 on pads, random lengths in [S/2, S], the first full."""
    lens = torch.randint(S // 2, S + 1, (B,), generator=gen, device="cuda")
    lens[0] = S
    return torch.where(torch.arange(S, device="cuda")[None, :]
                       < lens[:, None], 0.0, -10000.0).float()


def check_flash_padded(gen, S, rate, B=32, H=12, D=64, seed=1234):
    """K1 at BERT-base's shapes: padding bias, not causal; S = 128 with
    dropout 0.1 (training), S = 512 without (inference)."""
    BH, dtype = B * H, torch.float32
    q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda")
               for _ in range(3))
    bias = _pad_bias(B, S, gen)
    scale = D ** -0.5
    args = dict(bias=bias, scale=scale, num_heads=H, dropout_rate=rate,
                seed=seed)
    o_k, lse_k = K.flash_attention_with_lse(q, k, v, **args)
    o_p, lse_p = K.flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    tag = (f"K1 [{BH},{S},{D}] float32 bias"
           + (f"+dropout {rate}" if rate else ""))
    err = compare(tag + " o", o_k, o_p, dtype)
    compare(tag + " lse", lse_k, lse_p, dtype)
    del o_p, lse_p
    q4, k4, v4 = (t.reshape(B, H, S, D) for t in (q, k, v))
    mask = bias.reshape(B, 1, 1, S)
    ms = time_ms(lambda: K.flash_attention_with_lse(q, k, v, **args))
    plain = time_ms(lambda: K.flash_attention_reference(q, k, v, **args))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, dropout_p=rate, scale=scale))
    nbytes = 4 * BH * S * D * 4 + B * S * 4 + BH * S * 4
    b_ms, b_by = bound(4 * D * BH * S * S, nbytes, dtype)
    return dict(shape=[BH, S, D], dtype="float32", dropout=rate,
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def sdpa_backward(q, k, v, do, mask, rate, scale, B, H):
    """A function running the backward alone of one
    ``scaled_dot_product_attention`` call on the same inputs (the first
    backend that takes them), and the backend's name; (None, None) if
    none does."""
    S, D = q.shape[1], q.shape[2]
    q4, k4, v4 = (t.reshape(B, H, -1, D).detach().requires_grad_()
                  for t in (q, k, v))
    do4 = do.reshape(B, H, S, D)
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask.to(q.dtype), dropout_p=rate,
                    scale=scale)
            torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return (lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                            retain_graph=True),
                backend.name)
    return None, None


def sdpa_backward_ms(q, k, v, do, mask, rate, scale, B, H):
    """Time of the backward alone of one ``scaled_dot_product_attention``
    call on the same inputs, and the name of the backend that ran."""
    fn, backend = sdpa_backward(q, k, v, do, mask, rate, scale, B, H)
    return (time_ms(fn) if fn else None), backend


def check_backward(gen, B, H, S, D, dtype, causal, rate, seed=4321):
    """K3 and K4 against their plain versions at one shape; returns the
    K3 row and the K4 row."""
    BH = B * H
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    bias = _pad_bias(B, S, gen)
    scale = D ** -0.5
    o, lse = K.flash_attention_reference(
        q, k, v, bias=bias, causal=causal, scale=scale, num_heads=H,
        dropout_rate=rate, seed=seed)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, bias, do, lse, delta)
    kw = dict(causal=causal, scale=scale, dropout_rate=rate, seed=seed,
              num_heads=H)
    n0 = K.launch_counts()
    dq = K.flash_attention_dq(*args, **kw)
    dk, dv = K.flash_attention_dkv(*args, **kw)
    n1 = K.launch_counts()
    rdq = K.flash_attention_dq_reference(*args, **kw)
    rdk, rdv = K.flash_attention_dkv_reference(*args, **kw)
    torch.cuda.synchronize()
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        if n1[name] != n0[name] + 1:
            raise SystemExit(f"chip_smoke: {name} did not launch")
    if min(float(t.float().abs().max()) for t in (dq, dk, dv)) == 0.0:
        raise SystemExit("chip_smoke: a backward kernel wrote only zeros")
    dts = str(dtype)[6:]
    tag = (f"[{BH},{S},{D}] {dts} {'causal+' if causal else ''}bias"
           f"{f'+dropout {rate}' if rate else ''}")
    e_dq = compare("K3 " + tag + " dq", dq, rdq, dtype)
    e_dkv = max(compare("K4 " + tag + " dk", dk, rdk, dtype),
                compare("K4 " + tag + " dv", dv, rdv, dtype))
    ms_dq = time_ms(lambda: K.flash_attention_dq(*args, **kw))
    plain_dq = time_ms(lambda: K.flash_attention_dq_reference(*args, **kw))
    ms_dkv = time_ms(lambda: K.flash_attention_dkv(*args, **kw))
    plain_dkv = time_ms(lambda: K.flash_attention_dkv_reference(*args,
                                                                **kw))
    mask = bias.reshape(B, 1, 1, S)
    if causal:
        mask = mask + torch.full((S, S), float("-inf"),
                                 device="cuda").triu(1)
    lib, backend = sdpa_backward_ms(q, k, v, do, mask, rate, scale, B, H)
    pairs = BH * S * (S + 1) // 2 if causal else BH * S * S
    elt = q.element_size()
    read = 4 * BH * S * D * elt + 2 * BH * S * 4 + B * S * 4
    rows = []
    for err, ms, plain, flops, write in (
            (e_dq, ms_dq, plain_dq, 6 * D * pairs, BH * S * D * elt),
            (e_dkv, ms_dkv, plain_dkv, 8 * D * pairs, 2 * BH * S * D * elt)):
        b_ms, b_by = bound(flops, read + write, dtype)
        rows.append(dict(shape=[BH, S, D], dtype=dts, causal=causal,
                         dropout=rate, max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib,
                         library_backend=backend, bound_ms=b_ms,
                         bound_by=b_by))
    return rows


def check_masks(BH=384, S=128, D=128, rate=0.1, seed=99):
    """The elements K1, K3 and K4 drop, read off their outputs, against
    ``dropout_keep`` (BERT's 384 heads of 128 x 128 scores): K1 with
    v = I (o[i, j] = 0 iff dropped), K4 with dO = I (dv[j, i]), K3 with
    k = I and delta = 0 (dq[i, j])."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keep = K.dropout_keep(seed, BH, S, S, rate, device="cuda")
    eye = torch.eye(S, D, device="cuda").expand(BH, S, D).contiguous()
    q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda")
               for _ in range(3))
    zeros = torch.zeros(BH, S, device="cuda")
    o, lse = K.flash_attention_with_lse(q, k, eye, dropout_rate=rate,
                                        seed=seed)
    _, dv = K.flash_attention_dkv(q, k, v, None, eye, lse, zeros,
                                  dropout_rate=rate, seed=seed)
    _, lse_i = K.flash_attention_reference(q, eye, v)
    dq = K.flash_attention_dq(q, eye, v, None, k, lse_i, zeros,
                              dropout_rate=rate, seed=seed)
    got = {"K1": o[..., :S] != 0, "K4": dv[..., :S].transpose(1, 2) != 0,
           "K3": dq[..., :S] != 0}
    for name, m in got.items():
        diff = int((m != keep).sum())
        log(f"  dropout mask {name} [{BH},{S},{S}] rate {rate}: "
            f"{diff} elements differ from the plain version's")
        if diff:
            raise SystemExit(f"chip_smoke: {name}'s dropout mask differs "
                             f"from the plain version's in {diff} elements")
    return dict(shape=[BH, S, S], rate=rate,
                keep_share=float(keep.float().mean()), differing=0)


# K5 at the inference path's shapes (BERT-base, batch 32 x seq 512 =
# 16384 rows): (m, n, k, epilogue, input type, output type)
GEMM_ROWS = (
    (16384, 768, 768, "bias", torch.float32, torch.float32),      # q,k,v,out
    (16384, 3072, 768, "bias+gelu", torch.float32, torch.float32),   # FFN1
    (16384, 768, 3072, "bias", torch.float32, torch.float32),        # FFN2
    (16384, 768, 768, "bias+gelu+layer_norm", torch.float32,
     torch.float32),                                                 # MLM
    (16384, 3072, 768, "bias+gelu", torch.bfloat16, torch.float32),
    (16384, 3072, 768, "bias+gelu", torch.bfloat16, torch.bfloat16))


def check_gemm(gen, m, n, k, epilogue, dtype, out_dtype):
    """K5 against its plain version at one shape; times kernel, plain
    version and ``torch.addmm(bias, x, y)``."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    y = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5) \
        .to(dtype)
    bias = torch.randn(n, generator=gen, device="cuda")
    ln = "layer_norm" in epilogue
    args = dict(bias=bias, activation="gelu" if "gelu" in epilogue
                else "none", layer_norm=ln, out_dtype=out_dtype)
    if ln:
        args.update(ln_scale=torch.randn(n, generator=gen, device="cuda"),
                    ln_bias=torch.randn(n, generator=gen, device="cuda"))
    n0 = K.fused_gemm.launches
    got = K.fused_gemm(x, y, **args)
    if K.fused_gemm.launches != n0 + 1:
        raise SystemExit("chip_smoke: fused_gemm did not launch")
    want = K.fused_gemm_reference(x, y, **args)
    torch.cuda.synchronize()
    dts, odts = str(dtype)[6:], str(out_dtype)[6:]
    tag = f"K5 [{m},{k}]@[{k},{n}] +{epilogue} {dts}->{odts}"
    err = compare(tag, got, want, out_dtype)
    ms = time_ms(lambda: K.fused_gemm(x, y, **args))
    plain = time_ms(lambda: K.fused_gemm_reference(x, y, **args))
    lib = time_ms(lambda: torch.addmm(bias.to(dtype), x, y))
    elt = x.element_size()
    nbytes = ((m * k + k * n) * elt + m * n * got.element_size()
              + n * 4 * (3 if ln else 1))
    b_ms, b_by = bound(2 * m * n * k, nbytes, dtype)
    return dict(shape=[m, n, k], dtype=dts, out_dtype=odts,
                epilogue=epilogue, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def phase_kernels(seed):
    with timed("kernels.build"), \
            ThreadPoolExecutor(max_workers=len(K.KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load, K.KERNEL_SOURCES))
    log(f"[kernels] built {list(K.KERNEL_SOURCES)} in "
        f"{TIMES['kernels.build']:.1f}s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res = {name: [] for name in K.KERNEL_SOURCES}
    for dtype in (torch.float32, torch.bfloat16):
        for S in (128, 512):
            res["flash_attention_fwd"].append(check_flash(S, dtype, gen))
        for q_len in (1, 8):
            res["decode_attention"].append(check_decode(q_len, dtype, gen))
    for S, rate in ((128, 0.1), (512, 0.0)):       # training, inference
        res["flash_attention_fwd"].append(check_flash_padded(gen, S, rate))
    for B, H, S, dtype, causal, rate in (
            (32, 12, 128, torch.float32, False, 0.1),
            (8, 12, 512, torch.float32, True, 0.0),
            (32, 12, 128, torch.bfloat16, False, 0.1)):
        dq_row, dkv_row = check_backward(gen, B, H, S, 64, dtype, causal,
                                         rate)
        res["flash_attention_dq"].append(dq_row)
        res["flash_attention_dkv"].append(dkv_row)
    masks = check_masks()
    for row in GEMM_ROWS:
        res["fused_gemm"].append(check_gemm(gen, *row))
    for name, rows in res.items():
        for r in rows:
            lib = r["library_ms"]
            drop = f" dropout {r['dropout']}" if r.get("dropout") else ""
            if name == "fused_gemm":
                drop = f" +{r['epilogue']} -> {r['out_dtype']}"
            backend = " " + r["library_backend"] \
                if r.get("library_backend") else ""
            libname = "addmm" if name == "fused_gemm" else "sdpa"
            log(f"  {name} {r['shape']} {r['dtype']}{drop}: kernel "
                f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
                f"{libname}{backend} "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'} | bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res, masks


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
        if (n < 1) if name in SERVE_KERNELS else n:
            raise SystemExit(f"chip_smoke: kernel {name} was launched {n} "
                             f"times on the serving path")
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


# ---------------------------------------------------------------- train
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 128, 10
# launches of each kernel in one BERT-base train step: K1 once per layer in
# the forward and once more in the grad op's recompute of the forward
# rule; K3 and K4 once per layer
TRAIN_LAUNCHES = {"flash_attention_fwd": 24, "flash_attention_dq": 12,
                  "flash_attention_dkv": 12}


def bert_feed(seed, vocab, B, S):
    """A synthetic pretraining batch: random tokens, two segments, padded
    lengths in [S/2, S], 15 % of the real tokens masked."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(S // 2, S + 1, (B, 1))
    lens[0] = S
    real = np.arange(S)[None] < lens
    masked = real & (rng.rand(B, S) < 0.15)
    return {"src_ids": rng.randint(0, vocab, (B, S)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
            "sent_ids": (np.arange(S)[None] >= lens // 2).astype(np.int64),
            "input_mask": real.astype(np.float32),
            "mask_label": np.where(masked, rng.randint(0, vocab, (B, S)),
                                   -100).astype(np.int64),
            "next_sent_label": rng.randint(0, 2, (B, 1)).astype(np.int64)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def train(net, init, feed, plain):
    """TRAIN_STEPS steps from ``init`` on a fresh executor (so the step
    seeds, and with them the dropout masks, repeat) and a fresh scope."""
    exe, scope = fluid.Executor(), fluid.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    fetch = [net["loss"], net["mlm_loss"], net["nsp_loss"]]
    fluid.set_flags({"FLAGS_use_flash_attention":
                     "never" if plain else "auto"})
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        losses, held, t_first = [], [], None
        t0 = time.perf_counter()
        for step in range(TRAIN_STEPS):
            losses.append(exe.run(net["main"], feed=feed, fetch_list=fetch,
                                  scope=scope))
            held.append(torch.cuda.memory_allocated())
            if step == 0:
                t_first = time.perf_counter()
        wall = time.perf_counter() - t_first     # fetches synchronised
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        first_s = t_first - t0
    finally:
        fluid.set_flags({"FLAGS_use_flash_attention": "auto"})
    return dict(losses=np.array([[float(np.ravel(x)[0]) for x in step]
                                 for step in losses]),
                steps_per_s=(TRAIN_STEPS - 1) / wall, first_step_s=first_s,
                launches=launches, peak_bytes=peak, base_bytes=base,
                held_bytes=held, exe=exe, scope=scope)


def profile_step(net, exe, scope, feed):
    """One more kernel-path step under torch.profiler: device busy time
    (summed kernel time) over the step's wall time."""
    return profile_run(lambda: exe.run(net["main"], feed=feed,
                                       fetch_list=[net["loss"]],
                                       scope=scope))


# the port's kernels by the names of their CUDA functions (K1, K3, K4, K2,
# K5's routes)
PORT_KERNELS = {"flash_attention_fwd": ("flash_fwd_",),
                "flash_attention_dq": ("flash_dq_",),
                "flash_attention_dkv": ("flash_dkv_",),
                "decode_attention": ("decode_kernel",),
                "fused_gemm": ("gemm_f32_kernel", "gemm_bf16_kernel",
                               "gemm_ln_")}


def profile_run(fn):
    """``fn()`` (which ends in a host read of its result) under
    torch.profiler: device busy time (summed kernel time) over wall
    time, the top kernels, and the device time and launches of each of
    the port's kernels."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    rows = sorted(((_device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and _device_us(e) > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    port = {}
    for name, marks in PORT_KERNELS.items():
        mine = [(us, n) for us, k, n in rows if any(m in k for m in marks)]
        if mine:
            port[name] = {"ms": sum(us for us, _ in mine) / 1e3,
                          "calls": sum(n for _, n in mine)}
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=1.0 - busy / wall,
                device_kernels=sum(r[2] for r in rows),
                top_kernels=[{"name": k[:90], "ms": us / 1e3, "calls": n}
                             for us, k, n in rows[:12]],
                port_kernels=port)


def phase_train(seed):
    cfg = BertConfig.base()
    net = build_bert_pretrain(cfg, seq_len=TRAIN_SEQ)
    net["startup"].random_seed = seed
    scope0 = fluid.Scope()
    fluid.Executor().run(net["startup"], scope=scope0)
    init = dict(scope0.vars)
    feed = bert_feed(seed, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    kern = train(net, init, feed, plain=False)
    prof = profile_step(net, kern.pop("exe"), kern.pop("scope"), feed)
    plain = train(net, init, feed, plain=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    kl, pl = kern["losses"], plain["losses"]
    rel = np.abs(kl - pl) / np.abs(pl)
    log(f"[train] BERT-base f32, batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, "
        f"dropout 0.1, {TRAIN_STEPS} steps: loss {kl[0, 0]:.6f} -> "
        f"{kl[-1, 0]:.6f} (plain run {pl[0, 0]:.6f} -> {pl[-1, 0]:.6f})")
    log(f"  kernels: {kern['steps_per_s']:.3f} steps/s = "
        f"{kern['steps_per_s'] * tokens:.1f} tokens/s (steps 2-"
        f"{TRAIN_STEPS}; step 1 {kern['first_step_s']:.3f} s), peak "
        f"{kern['peak_bytes'] / 2**30:.2f} GiB "
        f"({kern['base_bytes'] / 2**30:.2f} GiB resident before), launches "
        f"{kern['launches']}")
    log(f"  plain:   {plain['steps_per_s']:.3f} steps/s, peak "
        f"{plain['peak_bytes'] / 2**30:.2f} GiB "
        f"({plain['base_bytes'] / 2**30:.2f} GiB resident before)")
    log(f"  profiled step: wall {prof['wall_s'] * 1e3:.1f} ms, device busy "
        f"{prof['device_busy_s'] * 1e3:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}, {prof['device_kernels']} device kernels")
    log(f"  loss rel. diff kernel vs plain: step 1 {rel[0].max():.3e}, "
        f"later max {rel[1:].max():.3e}")
    growth = max(kern["held_bytes"][1:]) - min(kern["held_bytes"][1:])
    log(f"  device memory held between steps 2-{TRAIN_STEPS}: "
        f"{min(kern['held_bytes'][1:]) / 2**30:.3f} GiB, growth "
        f"{growth / 2**20:.1f} MiB")
    for r in prof["top_kernels"][:6]:
        log(f"    {r['ms']:8.3f} ms {r['calls']:5d} calls  {r['name']}")
    log("  the port's kernels in the profiled step: " + ", ".join(
        f"{n} {r['ms']:.3f} ms ({r['calls']})"
        for n, r in prof["port_kernels"].items()))
    if growth > 16 * 2**20:
        raise SystemExit(f"chip_smoke: device memory grew by "
                         f"{growth / 2**20:.1f} MiB across train steps")
    if not np.isfinite(kl).all():
        raise SystemExit("chip_smoke: non-finite training loss")
    if rel[0].max() > 1e-5 or rel[1:].max() > 1e-3:
        raise SystemExit(f"chip_smoke: kernel and plain training runs "
                         f"disagree (step 1 rtol {rel[0].max():.3e} > 1e-5 "
                         f"or later {rel[1:].max():.3e} > 1e-3)")
    if not kl[-1, 0] < kl[0, 0]:
        raise SystemExit("chip_smoke: the training loss did not fall")
    for name, per_step in TRAIN_LAUNCHES.items():
        if kern["launches"][name] != per_step * TRAIN_STEPS:
            raise SystemExit(f"chip_smoke: {name} launched "
                             f"{kern['launches'][name]} times in "
                             f"{TRAIN_STEPS} train steps, expected "
                             f"{per_step * TRAIN_STEPS}")
    if any(plain["launches"].values()):
        raise SystemExit(f"chip_smoke: the plain training run launched "
                         f"kernels: {plain['launches']}")
    return dict(
        config="BertConfig.base()", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, losses=kl.tolist(), plain_losses=pl.tolist(),
        step1_rel_diff=float(rel[0].max()),
        later_rel_diff=float(rel[1:].max()),
        steps_per_s=kern["steps_per_s"],
        tokens_per_s=kern["steps_per_s"] * tokens,
        first_step_s=kern["first_step_s"],
        peak_gib=kern["peak_bytes"] / 2**30,
        resident_before_gib=kern["base_bytes"] / 2**30,
        plain_steps_per_s=plain["steps_per_s"],
        plain_peak_gib=plain["peak_bytes"] / 2**30,
        plain_resident_before_gib=plain["base_bytes"] / 2**30,
        held_gib=[b / 2**30 for b in kern["held_bytes"]],
        launches=kern["launches"], profiled_step=prof)


# ---------------------------------------------------------------- infer
INFER_BATCH, INFER_SEQ, INFER_FORWARDS = 32, 512, 5
# BERT-base inference: the fusion pass fuses 75 chains (q, k, v, out-proj
# and FFN2 of 12 layers, the pooler and the NSP head: bias; FFN1: bias +
# gelu; the MLM transform: bias + gelu + layer_norm); K5 takes all but the
# NSP head (n = 2, not a multiple of 4), K1 runs once a layer
INFER_CHAINS = 75
INFER_LAUNCHES = {"fused_gemm": 74, "flash_attention_fwd": 12}


def infer_run(tag, prog, fetch, init, feed, fused, kernel="auto",
              forwards=INFER_FORWARDS, profiled=True):
    """``forwards`` timed forwards of ``prog`` after one warm-up (which
    also runs the fusion pass and its witness) on a fresh executor, plus
    one profiled forward if ``profiled``; each forward ends in a host read
    of the loss. Script time of each part lands in ``TIMES`` under
    ``infer.<tag>.``."""
    fluid.set_flags({"FLAGS_epilogue_fusion": fused,
                     "FLAGS_use_fused_gemm": kernel})
    try:
        exe, scope = fluid.Executor(), fluid.Scope()
        for n, t in init.items():
            scope.set_var(n, t)

        def forward():
            outs = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                           return_numpy=False)
            outs[0].item()
            return outs

        with timed(f"infer.{tag}.warmup"):
            forward()
        warm = TIMES[f"infer.{tag}.warmup"]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        times = []
        with timed(f"infer.{tag}.forwards"):
            for _ in range(forwards):
                t0 = time.perf_counter()
                outs = forward()
                times.append(time.perf_counter() - t0)
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        prof = None
        if profiled:
            with timed(f"infer.{tag}.profiled"):
                prof = profile_run(forward)
    finally:
        fluid.set_flags({"FLAGS_epilogue_fusion": False,
                         "FLAGS_use_fused_gemm": "auto"})
    decisions = list(exe._fusion_decisions.values())
    return dict(loss=outs[0], enc=outs[1], warmup_s=warm,
                forward_ms=float(np.median(times)) * 1e3,
                forward_ms_all=[t * 1e3 for t in times],
                launches={n: v / forwards for n, v in launches.items()},
                launches_total=launches, peak_bytes=peak, base_bytes=base,
                profiled=prof, decision=decisions[0] if decisions else None)


def phase_infer(seed):
    t0 = time.perf_counter()
    cfg = BertConfig.base()
    net = build_bert_pretrain(cfg, seq_len=INFER_SEQ, build_optimizer=False)
    net["startup"].random_seed = seed
    prog = net["main"].clone(for_test=True)
    # the last encoder layer's output: the MLM transform's input
    enc = next(op.input("X")[0] for op in prog.global_block.ops
               if op.type == "mul" and op.input("Y")[0] == "mlm_trans_w")
    fetch = [net["loss"].name, enc]
    scope0 = fluid.Scope()
    fluid.Executor().run(net["startup"], scope=scope0)
    init = dict(scope0.vars)
    feed = bert_feed(seed + 1, cfg.vocab_size, INFER_BATCH, INFER_SEQ)
    TIMES["infer.setup"] = time.perf_counter() - t0
    fused = infer_run("fused", prog, fetch, init, feed, fused=True)
    unfused = infer_run("unfused", prog, fetch, init, feed, fused=False)
    # the dense replay is a check, not a measurement: one forward, counted
    dense = infer_run("dense", prog, fetch, init, feed, fused=True,
                      kernel="never", forwards=1, profiled=False)
    dec = fused["decision"]
    lf, lu = float(fused["loss"]), float(unfused["loss"])
    rel = abs(lf - lu) / abs(lu)
    enc_err = float((fused["enc"] - unfused["enc"]).abs().max())
    exact = (torch.equal(dense["loss"], unfused["loss"])
             and torch.equal(dense["enc"], unfused["enc"]))
    tokens = INFER_BATCH * INFER_SEQ
    log(f"[infer] BERT-base f32, batch {INFER_BATCH}, seq {INFER_SEQ}: "
        f"fusion {dec.reason if dec else 'not run'}; loss fused "
        f"{lf:.6f} vs unfused {lu:.6f} (rel {rel:.3e}); encoder output "
        f"max abs err {enc_err:.3e}; dense replay bit-exact={exact}")
    for w in (dec.witness if dec else []):
        log(f"  witness {w['epilogue']} (m={w['m']}, n={w['n']}, "
            f"k={w['k']}) route {w.get('route')}: max abs err "
            f"{w.get('max_abs_err', float('nan')):.3e}")
    for tag, r in (("fused (K5)", fused), ("unfused", unfused),
                   ("dense replay", dense)):
        p = r["profiled"]
        log(f"  {tag}: forward {r['forward_ms']:.2f} ms median of "
            f"{len(r['forward_ms_all'])} "
            f"({tokens / r['forward_ms'] * 1e3:.0f} tokens/s; warm-up "
            f"{r['warmup_s']:.2f} s), peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB ({r['base_bytes'] / 2**30:.2f}"
            f" GiB resident), launches a forward {r['launches']}" + (
                f", profiled: wall {p['wall_s'] * 1e3:.1f} ms, busy "
                f"{p['device_busy_s'] * 1e3:.1f} ms, idle share "
                f"{p['idle_share']:.3f}" if p else ""))
        for k in (p["top_kernels"][:5] if p else []):
            log(f"    {k['ms']:8.3f} ms {k['calls']:5d} calls  {k['name']}")
    if dec is None or not dec.applied or dec.n_fused != INFER_CHAINS:
        raise SystemExit(f"chip_smoke: the fusion pass did not fuse "
                         f"{INFER_CHAINS} chains: "
                         f"{dec.to_dict() if dec else None}")
    for name in K.KERNEL_SOURCES:
        want = INFER_LAUNCHES.get(name, 0)
        for tag, r in (("fused", fused), ("unfused", unfused),
                       ("dense", dense)):
            n = r["launches"][name]
            expect = want if (tag == "fused" or name != "fused_gemm") else 0
            if n != expect:
                raise SystemExit(f"chip_smoke: {name} launched {n} times a "
                                 f"forward in the {tag} inference run, "
                                 f"expected {expect}")
    if not np.isfinite(lf) or rel > 1e-4 or enc_err > 1e-3:
        raise SystemExit(f"chip_smoke: fused and unfused inference disagree "
                         f"(loss rel {rel:.3e} > 1e-4 or encoder output "
                         f"{enc_err:.3e} > 1e-3)")
    if not exact:
        raise SystemExit("chip_smoke: the dense replay is not bit-exact "
                         "against the unfused program")

    def summary(r):
        return dict(forward_ms=r["forward_ms"], forward_ms_all=r[
            "forward_ms_all"], warmup_s=r["warmup_s"],
            tokens_per_s=tokens / r["forward_ms"] * 1e3,
            peak_gib=r["peak_bytes"] / 2**30,
            resident_gib=r["base_bytes"] / 2**30,
            launches_per_forward=r["launches"], profiled=r["profiled"])

    return dict(config="BertConfig.base()", batch=INFER_BATCH,
                seq=INFER_SEQ, loss_fused=lf, loss_unfused=lu,
                loss_rel_diff=rel, encoder_max_abs_err=enc_err,
                dense_bit_exact=exact, decision=dec.to_dict(),
                fused=summary(fused), unfused=summary(unfused),
                dense=summary(dense),
                launches=fused["launches_total"])


# ---------------------------------------------------------------- main
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None,
                    help="also write the full report to DIR/chip_smoke.json")
    args = ap.parse_args()
    t0 = time.perf_counter()
    with timed("device"):
        card = phase_device()
    with timed("kernels"):
        kres, masks = phase_kernels(args.seed)
    with timed("serve"):
        model, params, exe, run = phase_serve(args.seed)
    with timed("whole_path"):
        whole = phase_whole_path(model, params, exe, run, args.seed)
    del model, params, exe
    with timed("train"):
        trained = phase_train(args.seed)
    torch.cuda.empty_cache()
    with timed("infer"):
        inferred = phase_infer(args.seed)
    # launches on the main paths: serving (K1, K2), training (K1, K3, K4)
    # and inference (K1, K5), each counted from 0 over its own run
    launches = {n: run["launches"][n] + trained["launches"][n]
                + inferred["launches"][n] for n in K.KERNEL_SOURCES}
    n_tok = sum(len(t) for t in run["tokens"])
    report = {"card": card, "kernels": kres, "dropout_masks": masks,
              "serve": {
                  "wall_s": run["wall_s"], "tokens": n_tok,
                  "tok_per_s": n_tok / run["wall_s"],
                  "launches": run["launches"],
                  "accounting": dict(run["accounting"]),
                  "stats": run["stats"], "whole_path": whole},
              "train": trained, "infer": inferred, "launches": launches}
    line = []
    for name, rows in kres.items():
        shape, dt, rate = MAIN_ROW[name]
        r = next(r for r in rows if r["shape"] == shape and r["dtype"] == dt
                 and r.get("dropout", 0.0) == rate
                 and r.get("out_dtype", dt) == dt)
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
    report["wall_s"] = time.perf_counter() - t0
    report["seconds"] = dict(TIMES)
    log("[seconds] " + ", ".join(f"{k} {v:.2f}" for k, v in TIMES.items()))
    log(f"[done] {report['wall_s']:.1f} s")
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
