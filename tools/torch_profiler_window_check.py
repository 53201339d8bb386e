"""How often torch.profiler leaves out a kernel near the edges of its
capture window, on one GPU.

    python3 tools/torch_profiler_window_check.py [--repeats 200] [--out-dir DIR]

Each repeat profiles one short burst on an idle card: an elementwise add
(the first kernel), ``--gemms`` bf16 products of BERT-base's q/k/v shape
(16384 x 768 by 768 x 768), an elementwise multiply (the last kernel),
and a host read of the result, as ``chip_smoke.profile_run`` profiles a
forward that ends in a host read. Two windows take turns: ``bare``, the
profiler started just before the burst and stopped just after the read,
and ``padded``, ``chip_smoke.profile_window`` (the card idles
``PROFILE_PAD_S`` on each side). A small case does the same with one
64 x 64 product between the add and the multiply. Prints, for each case
and window, the repeats, the kernels the burst launches, the repeats
that missed any of them, and the missed adds, products and multiplies;
with ``--out-dir``, also ``DIR/profiler_window_check.json``.

``--beside`` runs both cases again while a second process keeps the card
busy with bf16 products (this script with ``--busy``), then while it
only holds a context on the card, with a third window, ``stopped``: the
padded one with that process stopped (SIGSTOP) for its length.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import profile_window  # noqa: E402

# the burst's kernels by marks of their CUDA functions' names (cuBLAS's
# products on the H100 are nvjet, cutlass or *gemm* kernels)
MARKS = {"add": ("addfunctor", "functoronself_add"), "gemm": ("gemm", "nvjet", "cutlass"),
         "mul": ("mulfunctor",)}


def _marks_seen(prof):
    seen = dict.fromkeys(MARKS, 0)
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        for kind, marks in MARKS.items():
            if any(m in e.key.lower() for m in marks):
                seen[kind] += e.count
    return seen


def _burst(x, w, gemms):
    y = x + 1.0
    for _ in range(gemms):
        y = y @ w
    return (y * 0.5).sum().item()


def busy(seconds, work=True):
    """Keep the card busy with bf16 products for ``seconds`` (or, without
    ``work``, only hold a context on it)."""
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print("busy", flush=True)
    end = time.time() + seconds
    while time.time() < end:
        if not work:
            time.sleep(0.1)
            continue
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


class _Peer:
    """The busy process, in a process group of its own."""

    def __init__(self, work=True):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--busy",
             "900" if work else "-900"],
            stdout=subprocess.PIPE, text=True, start_new_session=True)
        self.proc.stdout.readline()   # "busy": its products are running
        time.sleep(2.0)

    def stop(self):
        os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()


@contextlib.contextmanager
def stopped_window(peer):
    """``profile_window`` with ``peer`` stopped, after 0.3 s for the work
    it queued to drain."""
    os.killpg(peer.proc.pid, signal.SIGSTOP)
    try:
        time.sleep(0.3)
        with profile_window() as prof:
            yield prof
    finally:
        os.killpg(peer.proc.pid, signal.SIGCONT)


def run_case(name, m, k, gemms, repeats, peer=None):
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(k, k, device="cuda", dtype=torch.bfloat16) / k ** 0.5
    _burst(x, w, gemms)
    torch.cuda.synchronize()
    want = {"add": 1, "gemm": gemms, "mul": 1}
    with profile_window() as prof:
        _burst(x, w, gemms)
    names = sorted({e.key[:100] for e in prof.key_averages()
                    if e.device_type.name == "CUDA"})
    print(f"[{name}] kernels: {names}", flush=True)
    out = {"kernels": names}
    windows = {
        "bare": lambda: profile(activities=[ProfilerActivity.CUDA]),
        "padded": profile_window}
    if peer is not None:
        windows["stopped"] = lambda: stopped_window(peer)
    tallies = {w_: {"repeats": 0, "short": 0,
                    "missed": dict.fromkeys(MARKS, 0)} for w_ in windows}
    for _ in range(repeats):
        for wname, window in windows.items():
            torch.cuda.synchronize()
            with window() as prof:
                _burst(x, w, gemms)
            seen = _marks_seen(prof)
            t = tallies[wname]
            t["repeats"] += 1
            short = False
            for kind in MARKS:
                miss = max(want[kind] - seen[kind], 0)
                t["missed"][kind] += miss
                short |= miss > 0
            t["short"] += short
    for wname, t in tallies.items():
        print(f"[{name}] {wname}: {t['repeats']} repeats of "
              f"{sum(want.values())} kernels; repeats missing any "
              f"{t['short']}; missed add {t['missed']['add']}, gemm "
              f"{t['missed']['gemm']}, mul {t['missed']['mul']}", flush=True)
        out[wname] = t
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--gemms", type=int, default=72)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--beside", action="store_true",
                    help="also beside a second process busy on the card")
    ap.add_argument("--busy", type=float, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_window_check: no CUDA device")
    if args.busy is not None:
        busy(abs(args.busy), work=args.busy > 0)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "burst": run_case("burst", 16384, 768, args.gemms,
                                args.repeats // 4),
              "small": run_case("small", 64, 64, 1, args.repeats)}
    if args.beside:
        for tag, work in (("beside", True), ("beside_idle", False)):
            peer = _Peer(work)
            try:
                report[tag] = {
                    "burst": run_case(f"burst {tag}", 16384, 768,
                                      args.gemms, args.repeats // 4, peer),
                    "small": run_case(f"small {tag}", 64, 64, 1,
                                      args.repeats, peer)}
            finally:
                peer.stop()
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "profiler_window_check.json"),
                  "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
