"""Native (C++) runtime components of the PyTorch port, built on demand
with the system g++ (counterpart of ``paddle_tpu/native``).

Reference: the framework's native ingest path —
paddle/fluid/framework/data_feed.cc MultiSlotDataFeed +
operators/reader/lod_tensor_blocking_queue.h — is C++ so parsing never
holds the GIL. Same here: the port's own copy of ``datafeed.cpp``
compiles once (``g++ -O2 -std=c++17 -shared -fPIC -pthread``) into
``paddle_tpu_torch/_build/native/``, the shared object named by a hash of
the source, at first use; nothing is built at import. If no compiler is
available ``load_datafeed`` returns None, ``build_error`` says why, and
``dataset_feed`` falls back to its Python parser (degraded but
functional) — a caller that needs the native engine checks
``MultiSlotDataset.using_native`` and fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

__all__ = ["load_datafeed", "build_error", "BUILD_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def _compile(src: str, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_datafeed() -> Optional[ctypes.CDLL]:
    """Compile-and-load (cached by source hash). None if no toolchain."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        src = os.path.join(_HERE, "datafeed.cpp")
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"datafeed_{tag}.so")
        if not os.path.exists(so):
            try:
                _compile(src, so)
            except (subprocess.CalledProcessError, OSError) as e:
                _build_error = getattr(e, "stderr", None) or str(e)
                return None
        lib = ctypes.CDLL(so)
        lib.df_create.restype = ctypes.c_void_p
        lib.df_create.argtypes = [ctypes.c_char_p]
        lib.df_set_capacity.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.df_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.df_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.df_start.restype = ctypes.c_int
        lib.df_next.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_void_p)]
        lib.df_next.restype = ctypes.c_int
        lib.df_parse_errors.argtypes = [ctypes.c_void_p]
        lib.df_parse_errors.restype = ctypes.c_longlong
        lib.df_stop_join.argtypes = [ctypes.c_void_p]
        lib.df_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the engine did not build (the compiler's message), or None."""
    return _build_error
