"""Time the K1 forward and K5 wrappers through their ``torch.library``
custom ops, as the port calls them, against a direct call of the same
launch, in turns on one GPU.

    python3 tools/torch_custom_op_ab.py [--pairs 10] [--out FILE]

``op`` is the package as it stands: ``flash_attention_with_lse`` goes
through its autograd function and K1's forward and K5 through
``paddle_tpu_torch::flash_attention_fwd`` / ``::fused_gemm``. ``direct``
patches the module globals so the wrappers call ``_run_k1`` / ``_run_k5``
themselves and a forward that needs no gradient skips the autograd
function. Each row runs ``--pairs`` times in the order op, direct,
direct, op (so 2·pairs turns each way) on the same inputs, and reports
both ways' means, the spread of each, and the mean and spread of the
paired difference (direct minus op, one per pair).

Rows: K1 at [96,128,64] f32 causal + bias (serving prefill) and
[384,128,64] f32 bias (a training forward, no dropout so it matches the
inference path); K5 at BERT-base's [16384,768]@[768,768] + bias and
DeepFM's [4096,400]@[400,400] + bias + relu. Each row times ``calls``
back-to-back wrapper calls and one synchronise (the host's dispatch is
inside: ``loop_ms`` a call) and one call between CUDA events with L2
flushed as ``chip_smoke.py`` takes it (``event_ms``). Then two steps:
BERT-base fused inference (batch 32, seq 512) through ``Executor.run``
and one dygraph BERT-base Adam step (batch 32, seq 128, dropout 0.1),
``ms`` the host's wall time of one step, outputs read back.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402

# the modules (the package re-exports their functions under the same names)
fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
fg = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")

_FLUSH = None
_SHIPPED = dict(fwd=fa._fwd_op, gemm=fg._gemm_op, fn=fa._FlashAttention)


class _NoGradShortcut:
    """``_FlashAttention`` with the forward alone when nothing needs a
    gradient."""

    @staticmethod
    def apply(q, k, v, bias, cfg):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _SHIPPED["fn"].apply(q, k, v, bias, cfg)
        causal, scale, rate, seed, q_off, k_off, heads = cfg
        return fa._launch_fwd(q, k, v, bias, causal, scale, q_off, k_off,
                              heads, rate, seed)


def use(way):
    direct = way == "direct"
    fa._fwd_op = fa._run_k1 if direct else _SHIPPED["fwd"]
    fg._gemm_op = fg._run_k5 if direct else _SHIPPED["gemm"]
    fa._FlashAttention = _NoGradShortcut if direct else _SHIPPED["fn"]


def loop_ms(fn, calls):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def event_ms(fn, iters=20):
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 * 1024 * 1024, device="cuda")
    total = 0.0
    for _ in range(iters):
        _FLUSH.zero_()
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def kernel_rows():
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    rows = []
    for bh, s, causal in ((96, 128, True), (384, 128, False)):
        q, k, v = (rand(bh, s, 64) for _ in range(3))
        bias = rand(bh // 12, s).clamp(max=0) * 10
        rows.append((f"K1 [{bh},{s},64] f32 "
                     f"{'causal+bias' if causal else 'bias'}",
                     lambda q=q, k=k, v=v, b=bias, c=causal:
                     fa.flash_attention_with_lse(q, k, v, b, causal=c,
                                                 num_heads=12), 200))
    for m, n, kk, act in ((16384, 768, 768, "none"), (4096, 400, 400,
                                                      "relu")):
        x, y, b = rand(m, kk), rand(kk, n), rand(n)
        rows.append((f"K5 [{m},{kk}]@[{kk},{n}] +bias"
                     f"{'+relu' if act == 'relu' else ''} f32",
                     lambda x=x, y=y, b=b, a=act:
                     fg.fused_gemm(x, y, bias=b, activation=a), 200))
    return rows


def infer_step(seed):
    cfg = cs.BertConfig.base()
    with fluid.unique_name.guard():
        net = cs.build_bert_pretrain(cfg, seq_len=cs.INFER_SEQ,
                                     build_optimizer=False)
    net["startup"].random_seed = seed
    prog = net["main"].clone(for_test=True)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(net["startup"], scope=scope)
    feed = cs.bert_feed(seed + 1, cfg.vocab_size, cs.INFER_BATCH,
                        cs.INFER_SEQ)
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    return lambda: exe.run(prog, feed=feed, fetch_list=[net["loss"].name],
                           scope=scope)


def dygraph_step(seed, stack):
    from tools.torch_dygraph_bert import DygraphBert, load_static, to_feed

    cfg = cs.BertConfig.base()
    net, init = cs.dy_bert(cfg, seed)
    feed = cs.bert_feed(seed, cfg.vocab_size, cs.TRAIN_BATCH, cs.TRAIN_SEQ)
    stack.enter_context(fluid.dygraph.guard(fluid.CUDAPlace(0), seed=seed))
    model = DygraphBert(cfg)
    load_static(model, net["main"], init)
    opt = fluid.optimizer.Adam(learning_rate=1e-4)
    f = to_feed(feed)

    def step():
        loss, _, _ = model(f)
        out = float(loss.numpy().reshape(-1)[0])
        loss.backward()
        opt.minimize(loss, parameter_list=model.parameters())
        model.clear_gradients()
        return out
    return step


def spread(xs):
    return dict(mean=statistics.fmean(xs), median=statistics.median(xs),
                min=min(xs), max=max(xs),
                stdev=statistics.stdev(xs) if len(xs) > 1 else 0.0)


def ab(name, measure, pairs):
    for way in ("op", "direct"):   # warm both ways
        use(way)
        measure()
    turns = {"op": [], "direct": []}
    diffs = []
    for _ in range(pairs):
        got = {}
        for way in ("op", "direct", "direct", "op"):
            use(way)
            t = measure()
            turns[way].append(t)
            got.setdefault(way, []).append(t)
        diffs.append(statistics.fmean(got["direct"])
                     - statistics.fmean(got["op"]))
    use("op")
    return dict(row=name, pairs=pairs, op=spread(turns["op"]),
                direct=spread(turns["direct"]), direct_minus_op=spread(diffs),
                turns=turns)


def main():
    import contextlib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    results = []

    def emit(r):
        r["card"] = card
        results.append(r)
        print(f"{r['row']} [{r['metric']}]: op {r['op']['mean']:.4f} "
              f"(median {r['op']['median']:.4f}, {r['op']['min']:.4f}-"
              f"{r['op']['max']:.4f}), direct {r['direct']['mean']:.4f} "
              f"(median {r['direct']['median']:.4f}, "
              f"{r['direct']['min']:.4f}-{r['direct']['max']:.4f}); "
              f"direct - op per pair {r['direct_minus_op']['mean']:+.4f} "
              f"+- {r['direct_minus_op']['stdev']:.4f}", flush=True)

    for name, fn, calls in kernel_rows():
        emit(dict(ab(name, lambda: loop_ms(fn, calls), args.pairs),
                  metric=f"loop_ms, {calls} calls"))
        emit(dict(ab(name, lambda: event_ms(fn), args.pairs),
                  metric="event_ms, L2 flushed, 20 calls"))
    run = infer_step(args.seed)

    def wall(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    emit(dict(ab("BERT-base fused inference b32 s512, Executor.run",
                  lambda: wall(run), args.pairs), metric="wall ms a forward"))
    fluid.set_flags({"FLAGS_epilogue_fusion": False})
    with contextlib.ExitStack() as stack:
        step = dygraph_step(args.seed, stack)
        emit(dict(ab("dygraph BERT-base Adam step b32 s128 dropout 0.1",
                     lambda: wall(step), args.pairs), metric="wall ms a step"))
    if args.out:
        with open(args.out, "a") as fh:
            for r in results:
                fh.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
