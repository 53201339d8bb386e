"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface: one entry point named
``<name>`` that takes the stream last and returns ``cudaGetLastError()``.
At first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``paddle_tpu_torch/_build/`` (named by a hash of the source
and the ``csrc/*.cuh`` headers, so an edited source or header is rebuilt),
loaded with ``ctypes`` and bound to its signature once. Nothing here
runs at import time: the CPU tests import every module on a machine
without ``nvcc``. A kernel that fails to build, load or launch raises
:class:`KernelError`, which no caller turns into a fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
# --split-compile=0: nvcc optimises a source's kernels on as many threads as
# there are cores, which shortens the build of a source with many template
# instantiations (fused_gemm.cu has fourteen) and leaves registers and spills
# as they were; tools/torch_build_time.py times it
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each entry point, the stream (last) included
# the flash kernels' dropout tail: seed, drop_threshold | drop_scale
_DROP = [_I, _I, _F]
SIGNATURES = {
    # q, k, v, bias, o, lse | BH, Sq, Sk, D, num_heads, causal | scale |
    # q_offset, k_offset, is_bf16 | dropout | stream
    "flash_attention_fwd": [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + _DROP
    + [_P],
    # q, k, v, bias, do, lse, delta, dq | (as the forward)
    "flash_attention_dq": [_P] * 8 + [_I] * 6 + [_F] + [_I] * 3 + _DROP
    + [_P],
    # q, k, v, bias, do, lse, delta, dk, dv | (as the forward)
    "flash_attention_dkv": [_P] * 9 + [_I] * 6 + [_F] + [_I] * 3 + _DROP
    + [_P],
    # q, k_cache, v_cache, lengths, o | BH, q_len, S, D, num_heads,
    # split | scale | is_bf16 | stream
    "decode_attention": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
    # x, y, bias, residual, ln_scale, ln_bias, out | M, N, K, activation,
    # layer_norm | ln_eps | in_bf16, out_bf16 | block_m, block_n, block_k |
    # stream
    "fused_gemm": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 5 + [_P, _I, _P],
}



class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_fns: Dict[str, Callable[..., int]] = {}
# ptxas resource report of each build (registers, shared memory, spills)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from paddle_tpu_torch/csrc at first use")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def _compile(name: str) -> str:
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    build_logs[name] = proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str):
    """The bound entry point of ``csrc/<name>.cu``, built at first use.
    Different sources build concurrently when called from several
    threads."""
    fn = _fns.get(name)
    if fn is None:
        with _lock:
            name_lock = _name_locks.setdefault(name, threading.Lock())
        with name_lock:
            fn = _fns.get(name)
            if fn is None:
                path = _compile(name)
                try:
                    fn = getattr(ctypes.CDLL(path), name)
                except (OSError, AttributeError) as e:
                    raise KernelError(f"cannot load csrc/{name}.cu's "
                                      f"build {path}: {e}") from e
                fn.argtypes = SIGNATURES[name]
                fn.restype = ctypes.c_int
                _fns[name] = fn
    return fn


def sass(name: str) -> Dict[str, str]:
    """The SASS of each kernel in ``csrc/<name>.cu``'s build, by mangled
    function name (``cuobjdump -sass``; builds the source first)."""
    load(name)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", _lib_path(name)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(f"cuobjdump failed for csrc/{name}.cu: "
                          f"{proc.stderr}")
    funcs: Dict[str, list] = {}
    cur = None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    return {f: "\n".join(lines) for f, lines in funcs.items()}


def tensor_core_ops(sass_text: str) -> int:
    """Tensor-core instructions (HMMA, HGMMA) in one kernel's SASS."""
    return sum(1 for line in sass_text.splitlines()
               if "HMMA" in line or "HGMMA" in line)


# the wrappers' launch counters: engines on several threads of one
# process launch into the same counts, so each increment is one locked
# read-modify-write (a bare ``+= 1`` can lose one to a thread switch)
_count_lock = threading.Lock()


def count_launch(wrapper, blocks=None) -> None:
    """Add one to ``wrapper.launches`` (and, with ``blocks``, to
    ``wrapper.launches_by_blocks[blocks]``)."""
    with _count_lock:
        wrapper.launches += 1
        if blocks is not None:
            by = wrapper.launches_by_blocks
            by[blocks] = by.get(blocks, 0) + 1


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned data pointer, as the
    kernels' cp.async copies need (a view at an odd offset is copied
    once)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``csrc/<name>.cu`` with ``args`` on ``device``'s current stream,
    read at each call (the serving dispatcher launches from its own
    thread), and raise :class:`KernelError` on a non-zero ``cudaError_t``."""
    fn = load(name)
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(name, device, *args)
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
