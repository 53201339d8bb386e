"""Warm-start cache of prepared executor steps (counterpart of
``paddle_tpu/aot_cache.py``).

The fleet serving tier starts replicas by the dozen, and every cold
replica pays its preparation before it can flip ``ready()`` true. The
port compiles no XLA executable: its counterpart of one is the
executor's prepared step, the program that ``Executor._prepare`` hands
the interpreter after the tuned K5 block triple, auto-remat, epilogue
fusion (with its fidelity witness on the device) and verification. This
module persists that: after a cold prepare the transformed program is
written to disk in the port's own program serialization
(``Program.to_dict``, with the program attributes the executor reads
and the block triple), and the next process that prepares the same step
loads it and skips the passes. A loaded step runs bit-identical to a
cold one: it is the same program, interpreted by the same rules.

Keying. The executor's in-memory keys lean on per-process serials
(``program._serial``, ``scope._serial``), useless across restarts. The
disk key reuses the autotuner's durable identity
(:func:`paddle_tpu_torch.tuning.program_content_fingerprint`) plus
everything else that shapes the prepared step:

* the execution kind (``run`` / ``chained``) and the fetch list,
* the executor's key flags (``Executor._key_flags``: nan check, numerics
  witness, fusion, ``FLAGS_use_fused_gemm``, the AMP policy) and the
  flags the passes read (block triple, autotune mode, remat and budget,
  verification level),
* the feeds' names, shapes and dtypes,
* the versions: framework, torch, CUDA, the card's name and a hash of
  the kernels' sources (``csrc/``), so another toolchain's or card's
  entries are never loaded (the cost database's staleness rule).

Safety posture: loads never raise. A missing entry is a miss; an entry
written under other versions is a miss with one warning; an unreadable
or malformed one is an ``error`` (op ``load``) with one warning. Either
way the executor prepares cold as if the cache did not exist. Saves are
atomic (a temporary sibling, fsync, rename) and validated first (the
serialized program must load back with the same content fingerprint).
Counters: ``aot_cache_hits_total`` / ``aot_cache_misses_total`` /
``aot_cache_saves_total`` / ``aot_cache_errors_total{op}``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, Tuple

from .monitor.lockwitness import make_lock

__all__ = ["executable_key", "load_executable", "save_executable",
           "cache_dir_flag", "cache_stats"]

logger = logging.getLogger("paddle_tpu_torch.aot_cache")

_SCHEMA = 1
_SUFFIX = ".prep.json"

# program attributes the executor reads beside the blocks (gradient merge)
_PROGRAM_ATTRS = ("_pipeline_microbatches", "_grad_merge_avg",
                  "_pipeline_param_grads", "_pipeline_cut_names")

# one warning per failure class per process: a broken cache dir must not
# spam a serving replica's log at request rate
_warned = set()
_warned_lock = make_lock("aot_cache._warned_lock")
_versions_cache: Dict[str, Tuple[str, ...]] = {}


def _warn_once(kind: str, msg: str, *args) -> None:
    with _warned_lock:
        if kind in _warned:
            return
        _warned.add(kind)
    logger.warning(msg, *args)


def _kernel_sources_hash() -> str:
    from .kernels._build import CSRC

    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _versions(device) -> Tuple[str, ...]:
    """(framework, torch, CUDA, card, kernel sources) for ``device``."""
    import torch

    from . import __version__

    dev = str(device)
    if dev not in _versions_cache:
        card = (torch.cuda.get_device_name(torch.device(dev))
                if torch.device(dev).type == "cuda" else "cpu")
        _versions_cache[dev] = (str(__version__), str(torch.__version__),
                                str(torch.version.cuda), card,
                                _kernel_sources_hash())
    return _versions_cache[dev]


def cache_dir_flag() -> str:
    """``FLAGS_aot_cache_dir`` (empty = cache disabled)."""
    from .flags import flag

    return str(flag("aot_cache_dir")).strip()


def _count(name: str, help_: str, **labels) -> None:
    from . import monitor

    if monitor.enabled():
        c = monitor.counter(name, help_)
        (c.labels(**labels) if labels else c).inc()


def _feed_signature(feed) -> str:
    import numpy as np

    sig = []
    for name in sorted(feed or {}):
        v = feed[name]
        shape = tuple(getattr(v, "shape", np.shape(v)))
        dtype = str(getattr(v, "dtype", np.asarray(v).dtype))
        sig.append(f"{name}:{shape}:{dtype.replace('torch.', '')}")
    return "|".join(sig)


def executable_key(parts: tuple, args, device="cpu") -> str:
    """Durable identity of one prepared step.

    ``parts`` is the executor-stamped tuple ``(kind, program,
    fetch_names, key_flags, pass_flags, gemm_blocks)``; the program
    element is
    replaced by its content fingerprint (the autotuner's restart-stable
    hash, one identity shared by the cost database and this cache).
    ``args`` is the run's feed dict: only its names, shapes and dtypes
    enter the key. ``device`` picks the card whose name enters it."""
    from .tuning import program_content_fingerprint

    kind, program, *rest = parts
    fp = program_content_fingerprint(program)
    material = repr((kind, fp, tuple(rest), _feed_signature(args),
                     _versions(device)))
    return hashlib.sha256(material.encode()).hexdigest()[:32]


def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, key + _SUFFIX)


def _encode(program, gemm_blocks, device) -> dict:
    attrs = {}
    for name in _PROGRAM_ATTRS:
        if hasattr(program, name):
            attrs[name] = getattr(program, name)
    return {"schema": _SCHEMA, "versions": list(_versions(device)),
            "program": program.to_dict(),
            "random_seed": int(program.random_seed or 0),
            "attrs": attrs,
            "gemm_blocks": (list(gemm_blocks) if gemm_blocks is not None
                            else None)}


def _decode(blob: dict):
    from .framework import Program

    program = Program.from_dict(blob["program"])
    program.random_seed = int(blob["random_seed"])
    for name, value in blob["attrs"].items():
        if name not in _PROGRAM_ATTRS:
            raise ValueError(f"unknown program attribute {name!r}")
        if name == "_pipeline_param_grads":
            value = [tuple(pair) for pair in value]
        setattr(program, name, value)
    blocks = blob["gemm_blocks"]
    return program, (tuple(int(b) for b in blocks)
                     if blocks is not None else None)


def load_executable(cache_dir: str, key: str, device="cpu"):
    """``(program, gemm_blocks)`` of the prepared step saved under
    ``key``, or None. Counts a hit or a miss; never raises (a corrupt
    entry counts an error and is a miss to the caller, an entry of other
    versions a miss with one warning)."""
    path = _path(cache_dir, key)
    try:
        if not os.path.exists(path):
            _count("aot_cache_misses_total",
                   "warm-start cache lookups that had to prepare")
            return None
        with open(path, "r") as f:
            blob = json.load(f)
        if not isinstance(blob, dict) or blob.get("schema") != _SCHEMA:
            raise ValueError("not a prepared-step entry of this schema")
        if blob.get("versions") != list(_versions(device)):
            # another toolchain's or card's step is not a corrupt file:
            # it is simply not ours to load (staleness rule)
            _count("aot_cache_misses_total",
                   "warm-start cache lookups that had to prepare")
            _warn_once("stale",
                       "aot cache entry %s was written under other "
                       "versions %s — ignoring (preparing)", path,
                       blob.get("versions"))
            return None
        loaded = _decode(blob)
        _count("aot_cache_hits_total",
               "prepares skipped by loading a saved prepared step")
        return loaded
    except Exception as e:
        _count("aot_cache_errors_total",
               "warm-start cache operations that failed (non-fatal; the "
               "executor prepares instead)", op="load")
        _warn_once("load",
                   "aot cache load failed for %s (%s: %s) — preparing "
                   "instead", path, type(e).__name__, e)
        return None


def save_executable(cache_dir: str, key: str, compiled,
                    device="cpu") -> bool:
    """Save the prepared step ``compiled`` = ``(program, gemm_blocks)``
    under ``key`` (atomic publish). Returns whether the entry was
    written; failures warn once and return False: a replica that cannot
    persist its steps still serves."""
    from .tuning import program_content_fingerprint

    try:
        program, gemm_blocks = compiled
        blob = _encode(program, gemm_blocks, device)
        raw = json.dumps(blob)
        # validate BEFORE publishing: an entry that does not load back as
        # the same program would poison every later warm start
        back, _ = _decode(json.loads(raw))
        if program_content_fingerprint(back) != \
                program_content_fingerprint(program):
            _count("aot_cache_errors_total",
                   "warm-start cache operations that failed (non-fatal; "
                   "the executor prepares instead)", op="validate")
            _warn_once("validate",
                       "aot cache: the serialized step does not load back "
                       "as the same program — not publishing it")
            return False
        os.makedirs(cache_dir, exist_ok=True)
        path = _path(cache_dir, key)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _count("aot_cache_saves_total",
               "prepared steps saved into the warm-start cache")
        return True
    except Exception as e:
        _count("aot_cache_errors_total",
               "warm-start cache operations that failed (non-fatal; the "
               "executor prepares instead)", op="save")
        _warn_once("save",
                   "aot cache save failed under %s (%s: %s) — the step "
                   "stays in memory only", cache_dir, type(e).__name__, e)
        return False


def cache_stats() -> Dict[str, Any]:
    """Monitor-counter snapshot for reports (the replica's ready line)."""
    from . import monitor

    return {
        "hits": monitor.metric_value("aot_cache_hits_total", 0.0),
        "misses": monitor.metric_value("aot_cache_misses_total", 0.0),
        "saves": monitor.metric_value("aot_cache_saves_total", 0.0),
        "errors": sum(
            monitor.metric_value("aot_cache_errors_total", 0.0, op=op)
            for op in ("load", "save", "validate")),
    }
