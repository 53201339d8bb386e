"""Do a DataLoader's side-stream copies overlap the step's kernels on the
card?

    python3 tools/torch_loader_overlap_check.py [--mb 77] [--sleep-ms 50]

For each way of getting a side stream (a ``torch.cuda.Stream`` from
PyTorch's pool, and a stream made with ``cuStreamCreate(...,
CU_STREAM_NON_BLOCKING)`` wrapped in ``torch.cuda.ExternalStream``) it
prints the stream's flags (``cuStreamGetFlags``: 1 is non-blocking, 0
synchronises with the legacy default stream), then runs a kernel of
``--sleep-ms`` on the current stream and, while it runs, copies a pinned
batch of ``--mb`` MB to the card on the side stream; CUDA events give
when the copy ended against when the kernel ended (a copy that overlaps
ends before the kernel). Then the same through ``reader.DataLoader``
itself: a batch staged while the kernel runs. One JSON line; exits 1
without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CU_STREAM_NON_BLOCKING = 1


def stream_flags(libcuda, stream) -> int:
    flags = ctypes.c_uint(99)
    rc = libcuda.cuStreamGetFlags(ctypes.c_void_p(stream.cuda_stream),
                                  ctypes.byref(flags))
    if rc != 0:
        raise RuntimeError(f"cuStreamGetFlags returned {rc}")
    return int(flags.value)


def non_blocking_stream(libcuda, device):
    handle = ctypes.c_void_p()
    rc = libcuda.cuStreamCreate(ctypes.byref(handle), CU_STREAM_NON_BLOCKING)
    if rc != 0:
        raise RuntimeError(f"cuStreamCreate returned {rc}")
    return torch.cuda.ExternalStream(handle.value, device=device)


def cycles_for(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that take about ``ms`` on this card."""
    probe = 50_000_000
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(probe)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(probe)
    b.record()
    torch.cuda.synchronize()
    return int(probe * ms / a.elapsed_time(b))


def copy_during_kernel(stream, host, cycles):
    """ms from the kernel's start to its end and to the copy's end."""
    cur = torch.cuda.current_stream()
    start, k_end, c_end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
    torch.cuda.synchronize()
    start.record(cur)
    torch.cuda._sleep(cycles)
    k_end.record(cur)
    with torch.cuda.stream(stream):
        dev = host.to("cuda", non_blocking=True)
        c_end.record(stream)
    torch.cuda.synchronize()
    del dev
    return start.elapsed_time(k_end), start.elapsed_time(c_end)


def loader_during_kernel(host_np, cycles):
    """The same through the DataLoader: the worker stages a batch while
    the consumer's stream runs the kernel."""
    import paddle_tpu_torch as fluid

    loader = fluid.DataLoader.from_generator(feed_list=["x"], capacity=2)
    gate = []

    def gen():
        while not gate:
            pass                 # hold the batch until the kernel runs
        yield (host_np,)

    loader.set_batch_generator(gen, places=fluid.CUDAPlace(0))
    cur = torch.cuda.current_stream()
    start, k_end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    it = iter(loader)
    start.record(cur)
    torch.cuda._sleep(cycles)
    k_end.record(cur)
    gate.append(1)
    batch = next(it)
    landed = torch.cuda.Event(enable_timing=True)
    landed.record(cur)           # after the wait on the copy's event
    torch.cuda.synchronize()
    it.close()
    return start.elapsed_time(k_end), start.elapsed_time(landed), \
        batch["x"].shape


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=77.07)
    ap.add_argument("--sleep-ms", type=float, default=50.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    libcuda = ctypes.CDLL("libcuda.so.1")
    torch.cuda.init()
    n = int(args.mb * 2**20 / 4)
    host = torch.empty(n, dtype=torch.float32, pin_memory=True)
    host.normal_()
    cycles = cycles_for(args.sleep_ms)
    default = torch.cuda.current_stream()
    res = {"card": card, "mb": args.mb,
           "default_stream": default.cuda_stream,
           "default_flags": stream_flags(libcuda, default)}
    ways = {"pool": torch.cuda.Stream(),
            "non_blocking": non_blocking_stream(libcuda, default.device)}
    for name, stream in ways.items():
        copy_during_kernel(stream, host, cycles)          # warm
        k, c = copy_during_kernel(stream, host, cycles)
        res[name] = {"flags": stream_flags(libcuda, stream),
                     "kernel_ms": k, "copy_end_ms": c, "overlaps": c < k}
    k, landed, shape = loader_during_kernel(
        np.ones((n // 1024, 1024), np.float32), cycles)
    res["loader"] = {"kernel_ms": k, "batch_ready_ms": landed,
                     "shape": list(shape)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
