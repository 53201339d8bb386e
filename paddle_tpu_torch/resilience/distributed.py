"""Distributed resilience: sharded checkpoints, cross-replica divergence
detection, and the step watchdog (counterpart of
``paddle_tpu/resilience/distributed.py``, with its names, messages and
manifest format).

* **Sharded checkpoints** (``io.save_checkpoint(..., mesh=...)``, manifest
  ``format_version`` 2): each rank writes its rows of the row-sharded
  state (ZeRO-1's optimizer moments, ``scope._dp_shards``) as its own
  shard file; rank 0 writes everything replicated to ``common.npz``; the
  manifest records the mesh shape and a spec for each sharded var, and
  publish stays the atomic temp-dir + rename. Restore reassembles the
  full value, so a run saved on two ranks resumes on one, and one saved
  on one resumes on two (the parallel step cuts its rows again).
  PT605-PT609 diagnose shard-count/spec mismatches and torn shard writes
  (``resilience.checkpoint.CKPT_CODES``).
* **Cross-replica divergence detection** (``FLAGS_replica_check_interval``):
  every N-th data-parallel step each rank reduces its copy of the
  replicated params and optimizer state to two checksum words a var on
  its device; the words are gathered and compared. Disagreement raises
  :class:`ReplicaDivergenceError` naming the first diverged var, or
  (``FLAGS_replica_divergence_policy=restore``) rolls back through the
  registered recovery walk.
* **Step watchdog** (``FLAGS_step_timeout_s``): a daemon thread watches
  the sections armed by :func:`watchdog_section` (the executor arms its
  compile and step sections). On expiry it dumps every thread's stack,
  the armed program serial, the last recompile diagnosis and the flight
  recorder, then interrupts the hung thread so the section raises
  :class:`WatchdogTimeout` instead of hanging forever. The interrupt is a
  Python exception: it is delivered at the thread's next bytecode, so it
  breaks Python-level stalls (the injected ``hang`` fault) but not a
  thread blocked inside a CUDA call; such a section still armed one more
  timeout later hard-exits 124 (``FLAGS_watchdog_hard_exit``) with the
  diagnosis already on stderr.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..monitor.lockwitness import make_lock
from .faults import fault_point

__all__ = ["ReplicaDivergenceError", "WatchdogTimeout", "watchdog_section",
           "replica_divergence_check", "handle_divergence",
           "set_divergence_recovery", "save_sharded_vars",
           "load_sharded_vars", "shard_axis_of", "mesh_axes"]

logger = logging.getLogger("paddle_tpu_torch.resilience")


COMMON_FILE = "common.npz"


# ---------------------------------------------------------------------------
# pillar 1: sharded checkpoints (manifest format_version 2)
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """Normalise a mesh argument (a ``parallel.sharding.Mesh`` |
    ``{'dp': 2}`` | 2) to axis sizes."""
    if mesh is None:
        return {}
    if isinstance(mesh, int):
        return {"dp": int(mesh)}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    shape = getattr(mesh, "shape", None)
    if shape is not None:
        return {str(k): int(v) for k, v in dict(shape).items()}
    raise TypeError(f"save_checkpoint: cannot read a mesh shape from "
                    f"{mesh!r} (want a Mesh, a dict of axis sizes, or "
                    f"an int shard count)")


def shard_axis_of(scope, name: str, axis: str = "dp") -> Optional[int]:
    """The dim of ``name`` the data-parallel step row-shards over ``axis``
    (``scope._dp_shards``, written by ZeRO-1), or None when replicated."""
    if axis != "dp":
        return None
    layout = (getattr(scope, "_dp_shards", None) or {}).get(name)
    return None if layout is None else int(layout[0])


def _shard_file_name(k: int, n: int) -> str:
    return f"shard_{k:05d}-of-{n:05d}.npz"


def save_sharded_vars(dirname: str, vars_: Sequence, scope, mesh) -> dict:
    """Write ``vars_`` as a sharded checkpoint into ``dirname`` (the temp
    dir of ``io.save_checkpoint``'s atomic publish).

    Under launched ranks (world = the mesh's dp) each rank writes its own
    rows of every var the step row-shards (``shard_axis_of``) as shard
    file ``rank`` (``shard_write`` fault site first), and rank 0 writes
    the replicated vars to ``common.npz`` and the manifest skeleton. In
    one process with ``dp`` > 1 the scope holds whole values: the vars
    ZeRO-1 would row-shard over ``dp`` (``zero1_spec_for``) are cut into
    ``dp`` shard files here. Returns the manifest skeleton (vars inventory
    + the ``sharding`` section); fsync and the per-file sha256 happen in
    ``resilience.checkpoint.finalize_manifest``."""
    from .. import distributed as _pdist
    from .. import monitor as _monitor
    from ..io import _host_array
    from ..parallel.sharding import zero1_spec_for

    axes = mesh_axes(mesh)
    axis = "dp" if "dp" in axes else (next(iter(axes)) if axes else "dp")
    n = max(1, int(axes.get(axis, 1)))
    world, rank = _pdist.get_world_size(), _pdist.get_rank()
    if world > 1 and world != n:
        raise ValueError(
            f"save_sharded_vars: mesh {axes} but {world} ranks launched; "
            f"each rank writes its own shard")
    inventory: Dict[str, dict] = {}
    specs: Dict[str, dict] = {}
    common: Dict[str, np.ndarray] = {}
    mine: Dict[int, Dict[str, np.ndarray]] = {}
    key_owner: Dict[str, str] = {}
    for v in vars_:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(
                f"save: variable '{v.name}' has no value in scope")
        key = v.name.replace("/", "__")
        if key_owner.setdefault(key, v.name) != v.name:
            raise RuntimeError(
                f"save: var names '{key_owner[key]}' and '{v.name}' both "
                f"serialize to blob key '{key}' — rename one")
        arr, dtname = _host_array(val)
        dim = shard_axis_of(scope, v.name, axis)
        if world == 1 and dim is None and n > 1 \
                and zero1_spec_for(v, n, True):
            dim = 0
        shape = list(arr.shape)
        if dim is not None and world > 1:
            shape[dim] *= n       # this rank holds 1/n of the rows
        inventory[v.name] = {"shape": shape, "dtype": dtname}
        if n > 1 and dim is not None and shape[dim] % n == 0:
            specs[v.name] = {"dim": int(dim), "parts": n}
            if world > 1:
                mine.setdefault(rank, {})[key] = arr
            else:
                sz = shape[dim] // n
                for k in range(n):
                    idx = (slice(None),) * dim + (slice(k * sz,
                                                        (k + 1) * sz),)
                    mine.setdefault(k, {})[key] = arr[idx]
        else:
            common[key] = arr
    shard_files = [_shard_file_name(k, n) for k in range(n)]
    writes = [rank] if world > 1 else list(range(n))
    for k in writes:
        # one writer dying here is the failure the format must survive:
        # the manifest/publish never happens, the serial stays unpublished
        fault_point("shard_write")
        with open(os.path.join(dirname, shard_files[k]), "wb") as f:
            np.savez(f, **mine.get(k, {}))
    if _monitor.enabled():
        _monitor.counter(
            "resilience_shards_written_total",
            "per-shard blob files written by sharded checkpoints").inc(
            len(writes))
    manifest = {"vars": inventory, "filename": None,
                "sharding": {"mesh": axes, "axis": axis, "num_shards": n,
                             "common_file": COMMON_FILE,
                             "shard_files": shard_files, "specs": specs}}
    if rank == 0:
        with open(os.path.join(dirname, COMMON_FILE), "wb") as f:
            np.savez(f, **common)
        with open(os.path.join(dirname, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_sharded_vars(dirname: str, manifest: dict, vars_: Sequence,
                      scope) -> None:
    """Reassemble a format_version-2 sharded checkpoint into ``scope``:
    every sharded var's pieces are concatenated back to the full value,
    so a restore on another rank count is bit-identical to a
    gather-then-save checkpoint; the next parallel step cuts its rows
    again. Everything is read and validated before the first ``set_var``,
    so a failed load never half-mutates the scope. Content mismatches
    raise ``CheckpointCorruptError`` PT606/PT608."""
    import torch

    from .. import monitor as _monitor
    from .checkpoint import CheckpointCorruptError, verify_sharding_section

    sh = verify_sharding_section(dirname, manifest)
    n = int(sh["num_shards"])
    specs = sh["specs"]
    inventory = manifest.get("vars") or {}
    common = _load_npz(os.path.join(dirname, sh.get("common_file",
                                                    COMMON_FILE)))
    shard_blobs = [_load_npz(os.path.join(dirname, f))
                   for f in sh["shard_files"]]
    staged: List[Tuple[str, np.ndarray]] = []
    for v in vars_:
        key = v.name.replace("/", "__")
        spec = specs.get(v.name)
        want = inventory.get(v.name)
        if spec is None:
            if key not in common:
                raise RuntimeError(
                    f"load: '{v.name}' missing from sharded checkpoint "
                    f"'{dirname}'")
            arr = common[key]
        else:
            dim = int(spec["dim"])
            if want is not None and dim >= len(want.get("shape", ())):
                raise CheckpointCorruptError(
                    "PT606", dirname,
                    f"'{v.name}' spec shards dim {dim} but the var is "
                    f"{len(want['shape'])}-d")
            pieces = []
            for k, blob in enumerate(shard_blobs):
                if key not in blob:
                    raise CheckpointCorruptError(
                        "PT606", dirname,
                        f"piece of '{v.name}' missing from shard {k}/{n}")
                pieces.append(blob[key])
            try:
                arr = np.concatenate(pieces, axis=dim)
            except Exception as e:
                raise CheckpointCorruptError(
                    "PT608", dirname,
                    f"'{v.name}' pieces do not concatenate on dim {dim}: "
                    f"{e}")
        if want is not None and list(arr.shape) != list(want["shape"]):
            raise CheckpointCorruptError(
                "PT608", dirname,
                f"'{v.name}' reassembled to {list(arr.shape)}, manifest "
                f"says {want['shape']}")
        if v.shape is not None and tuple(arr.shape) != tuple(v.shape) \
                and -1 not in (v.shape or ()):
            raise RuntimeError(
                f"load: shape mismatch for '{v.name}': checkpoint "
                f"{arr.shape} vs program {v.shape}")
        staged.append((v.name, arr))
    shards = getattr(scope, "_dp_shards", None) or {}
    for name, arr in staged:
        # host tensors: the executor moves each to its device at first use
        t = torch.from_numpy(np.array(arr, copy=True))
        if (inventory.get(name) or {}).get("dtype") == "bfloat16":
            t = t.view(torch.bfloat16)
        scope.set_var(name, t)
        shards.pop(name, None)
    if _monitor.enabled():
        _monitor.counter(
            "resilience_sharded_restores_total",
            "sharded (format_version 2) checkpoints reassembled into a "
            "scope").inc()


# ---------------------------------------------------------------------------
# pillar 2: cross-replica divergence detection
# ---------------------------------------------------------------------------

class ReplicaDivergenceError(RuntimeError):
    """Replicated state disagrees across data-parallel replicas. Carries
    ``param`` (the first diverged name) and ``diverged`` (all of them).
    Never retried (``transient = False``): diverged replicas are a
    determinism bug or corrupted memory, not infrastructure noise."""

    transient = False

    def __init__(self, diverged: Sequence[str], axis: str = "dp"):
        self.diverged = list(diverged)
        self.param = self.diverged[0] if self.diverged else "<unknown>"
        super().__init__(
            f"replica divergence across the '{axis}' axis: param "
            f"'{self.param}' holds different bytes on different replicas "
            f"({len(self.diverged)} diverged var(s): "
            f"{', '.join(self.diverged[:5])}"
            f"{', …' if len(self.diverged) > 5 else ''}). Replicated "
            f"state must be bit-identical; this is nondeterminism or "
            f"memory corruption, not noise — restore from the last "
            f"verified checkpoint (FLAGS_replica_divergence_policy="
            f"restore) or debug the step.")


_U32 = 0xFFFFFFFF


def _bits_u32(x):
    """A lossless view of a tensor's bit patterns as uint32 words (held in
    int64), by item width, so no dtype aliases two bit patterns to one
    word."""
    import torch

    x = x.detach().contiguous().reshape(-1)
    size = x.element_size()
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    if size == 8:
        w = x.view(torch.int64)
        return torch.cat([(w >> 32) & _U32, w & _U32])
    if size == 4:
        return x.view(torch.int32).to(torch.int64) & _U32
    if size == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    return x.view(torch.uint8).to(torch.int64)


def _checksum(x):
    """Two words of one copy: the bit-pattern sum and a position-weighted
    sum, both mod 2**32 (int64 arithmetic wraps mod 2**64, which keeps
    the low 32 bits exact)."""
    import torch

    u = _bits_u32(x)
    if not u.numel():
        return torch.zeros(2, dtype=torch.int64, device=u.device)
    w = torch.arange(u.numel(), dtype=torch.int64, device=u.device) * 2 + 1
    return torch.stack([u.sum() & _U32, (u * w).sum() & _U32])


def replica_divergence_check(mesh, values: Dict[str, Any],
                             axis: Optional[str] = None) -> List[str]:
    """Names in ``values`` whose replicas disagree, sorted.

    ``values`` maps a name to this rank's copy (a tensor): each rank
    reduces its copy to two words on its device, and the ``[V, 2]`` words
    are all-gathered over the launched ranks (the only transfer). In one
    process a name may map to a list of copies (one a replica) instead.
    The port's mesh is data parallel only, so the replicas are the ``dp``
    ranks and ``axis`` is accepted for the JAX package's signature."""
    import torch

    from .. import distributed as _pdist

    if not values:
        return []
    names = sorted(values)
    local = [values[n] for n in names]
    if all(isinstance(v, (list, tuple)) for v in local):
        per = [[_checksum(c).cpu() for c in copies] for copies in local]
        return [n for n, sums in zip(names, per)
                if any(not torch.equal(sums[0], s) for s in sums[1:])]
    words = torch.stack([_checksum(v) for v in local])       # [V, 2]
    gathered = _pdist._all_gather(words).cpu().numpy()
    world = gathered.shape[0] // len(names)
    per_rank = gathered.reshape(world, len(names), 2)
    return [n for i, n in enumerate(names)
            if not (per_rank[:, i, :] == per_rank[0, i, :]).all()]


# restore policy wiring: contrib.Trainer registers its recovery walk here
# (the newest->oldest verified-checkpoint reload); anything returning
# truthy means "state restored, keep training"
_recovery: Optional[Callable[[], Any]] = None


def set_divergence_recovery(fn: Optional[Callable[[], Any]]) -> None:
    global _recovery
    _recovery = fn


def handle_divergence(diverged: Sequence[str], path: str = "parallel",
                      axis: str = "dp") -> None:
    """Apply ``FLAGS_replica_divergence_policy`` to a non-empty diverged
    set: ``raise`` trips :class:`ReplicaDivergenceError`; ``restore``
    rolls the scope back to the last verified checkpoint through the
    registered recovery walk and keeps training (escalating to raise when
    nothing restorable exists)."""
    from .. import monitor as _monitor
    from .. import trace as _trace
    from ..flags import flag

    if _monitor.enabled():
        _monitor.counter(
            "resilience_divergence_detected_total",
            "cross-replica divergence detections").labels(path=path).inc()
    _trace.record_incident(
        "replica_divergence",
        detail=f"path {path}, axis {axis}: "
               f"{', '.join(list(diverged)[:5])}")
    policy = str(flag("replica_divergence_policy")).strip().lower()
    if policy not in ("raise", "restore"):
        raise ValueError(
            f"FLAGS_replica_divergence_policy={policy!r} — expected "
            f"raise or restore")
    err = ReplicaDivergenceError(diverged, axis=axis)
    if policy == "restore" and _recovery is not None:
        restored = False
        try:
            restored = bool(_recovery())
        except Exception:
            logger.exception("divergence recovery walk itself failed")
        if restored:
            if _monitor.enabled():
                _monitor.counter(
                    "resilience_divergence_restores_total",
                    "divergences resolved by rolling back to the last "
                    "verified checkpoint").inc()
            logger.warning(
                "replica divergence on '%s' (+%d more): restored the last "
                "verified checkpoint, training continues "
                "(FLAGS_replica_divergence_policy=restore)", err.param,
                max(0, len(err.diverged) - 1))
            return
        logger.error("replica divergence: restore policy had nothing to "
                     "restore — escalating to raise")
    raise err


# ---------------------------------------------------------------------------
# pillar 3: step watchdog
# ---------------------------------------------------------------------------

class _WatchdogInterrupt(BaseException):
    """Async exception the watchdog raises INSIDE a hung non-main thread
    (``PyThreadState_SetAsyncExc``) — the cross-thread analogue of the
    ``interrupt_main``/KeyboardInterrupt path the main thread gets. A
    ``BaseException`` so broad ``except Exception`` handlers inside the
    hung section cannot swallow it; ``watchdog_section`` converts it to
    :class:`WatchdogTimeout` before callers see it. Serving's dispatch
    thread is the reason this exists: a slow-batch hang there must die
    diagnosed and typed, not ride straight to the hard-exit escalation."""


def _interrupt_thread(thread_id: int) -> bool:
    """Raise :class:`_WatchdogInterrupt` asynchronously in ``thread_id``.
    Delivery happens at the thread's next bytecode boundary — enough for
    Python-level stalls (the ``hang`` fault action sleeps in 20 ms slices);
    a thread inside a CUDA call or a kernel wait stays for the hard-exit
    escalation."""
    import ctypes

    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(_WatchdogInterrupt))
    if res > 1:
        # "affected more than one thread" — undo per CPython docs
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_id), None)
        return False
    return res == 1


class WatchdogTimeout(RuntimeError):
    """An armed compile/step/collective section exceeded
    ``FLAGS_step_timeout_s``. The full diagnosis (all thread stacks, the
    active program serial, the last recompile diagnosis) was already
    dumped to the resilience logger and stderr when the deadline fired.
    ``transient = False``: a hang is never retried."""

    transient = False

    def __init__(self, section: str, seconds: float, detail: str = ""):
        self.section = section
        self.seconds = seconds
        self.detail = detail
        super().__init__(
            f"watchdog: section '{section}' exceeded "
            f"FLAGS_step_timeout_s={seconds:g}s"
            f"{' (' + detail + ')' if detail else ''} — thread stacks and "
            f"the last recompile diagnosis were dumped at expiry")


@dataclasses.dataclass
class _Section:
    token: int
    section: str
    detail: str
    timeout: float
    deadline: float
    thread_id: int
    expired: bool = False
    hard_deadline: Optional[float] = None


_wd_lock = make_lock("resilience.distributed._wd_lock")
_wd_armed: Dict[int, _Section] = {}
_wd_tokens = itertools.count(1)
_wd_thread: Optional[threading.Thread] = None


def _dump_section(s: _Section) -> str:
    lines = [
        f"watchdog: section '{s.section}' exceeded {s.timeout:g}s "
        f"({s.detail or 'no detail'})",
    ]
    try:
        from .. import monitor as _monitor

        evs = _monitor.get_tracker().events(recompiles_only=False)
        if evs:
            e = evs[-1]
            lines.append(
                f"  last compile: path={e.path} program_serial="
                f"{e.program_serial} recompile={e.recompile} "
                f"changed={list(e.changed)} at {e.build_site}")
        else:
            lines.append("  last compile: <none recorded>")
    except Exception:
        lines.append("  last compile: <monitor unavailable>")
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    for tid, frame in frames.items():
        t = by_id.get(tid)
        name = t.name if t else "?"
        mark = " [hung section]" if tid == s.thread_id else ""
        lines.append(f"-- thread '{name}' ({tid}){mark} --")
        lines.append("".join(traceback.format_stack(frame)).rstrip())
    # flight recorder: the hang's diagnosis ships with the last N trace
    # spans (the hung request/step's chain among them) — incidents() /
    # the ci_trace_report artifact carry the structured form
    try:
        from .. import trace as _trace

        incident = _trace.record_incident(
            "watchdog_timeout",
            detail=f"section '{s.section}' ({s.detail or 'no detail'}) "
                   f"exceeded {s.timeout:g}s")
        if incident["recent_spans"]:
            lines.append(f"-- flight recorder: last "
                         f"{len(incident['recent_spans'])} span(s) --")
            for d in incident["recent_spans"][-12:]:
                lines.append(
                    f"  {d['name']} trace={d['trace_id']} "
                    f"status={d['status']} "
                    f"dur={d['duration_s'] if d['duration_s'] is not None else '?'} "
                    f"attrs={d['attrs']}")
        elif not incident["flight_recorder_enabled"]:
            lines.append("-- flight recorder: disabled (FLAGS_trace / "
                         "FLAGS_flight_recorder_size) — no span context --")
    except Exception:
        logger.exception("flight-recorder dump failed (diagnosis "
                         "continues without span context)")
    text = "\n".join(lines)
    logger.error("%s", text)
    print(text, file=sys.stderr, flush=True)
    return text


def _wd_loop() -> None:
    import _thread

    while True:
        now = time.monotonic()
        with _wd_lock:
            sections = list(_wd_armed.values())
        for s in sections:
            if not s.expired and now >= s.deadline:
                s.expired = True
                s.hard_deadline = now + max(s.timeout, 1.0)
                try:
                    _dump_section(s)
                except Exception:   # the dump must never kill the dog
                    logger.exception("watchdog diagnosis dump failed")
                try:
                    from .. import monitor as _monitor

                    _monitor.record_watchdog_timeout(s.section)
                except Exception:
                    pass
                with _wd_lock:
                    still = s.token in _wd_armed
                if still:
                    if s.thread_id == threading.main_thread().ident:
                        _thread.interrupt_main()
                    else:
                        # non-main thread (e.g. the serving dispatcher):
                        # deliver the typed interrupt directly into it
                        _interrupt_thread(s.thread_id)
            elif s.expired and s.hard_deadline is not None \
                    and now >= s.hard_deadline:
                with _wd_lock:
                    still = s.token in _wd_armed
                if not still:
                    continue   # disarmed between snapshot and deadline
                from ..flags import flag

                if flag("watchdog_hard_exit"):
                    print(f"watchdog: section '{s.section}' still hung "
                          f"{max(s.timeout, 1.0):g}s after the diagnosis "
                          f"dump (uninterruptible native code?) — "
                          f"os._exit(124)", file=sys.stderr, flush=True)
                    os._exit(124)
                s.hard_deadline = None   # dump once, then leave it be
        time.sleep(0.05 if sections else 0.2)


def _ensure_wd_thread() -> None:
    global _wd_thread
    if _wd_thread is None or not _wd_thread.is_alive():
        _wd_thread = threading.Thread(target=_wd_loop,
                                      name="paddle_tpu_torch-watchdog",
                                      daemon=True)
        _wd_thread.start()


@contextlib.contextmanager
def watchdog_section(section: str, detail: str = "", timeout=None,
                     program=None):
    """Arm the watchdog around a compile/step/collective region.

    ``timeout`` defaults to ``FLAGS_step_timeout_s``; 0/None disarms (the
    default — the context manager is then a no-op). When the deadline
    fires the watchdog dumps the diagnosis and interrupts the hung
    thread — ``interrupt_main`` for the main thread, an async
    :class:`_WatchdogInterrupt` (``PyThreadState_SetAsyncExc``) for any
    other thread, e.g. the serving dispatcher. Either pending interrupt
    is converted to :class:`WatchdogTimeout` here, so callers see one
    typed, documented failure instead of a hang; a section stuck in
    uninterruptible native code still escalates to the hard exit."""
    if timeout is None:
        from ..flags import flag

        timeout = float(flag("step_timeout_s"))
    if not timeout or timeout <= 0:
        yield None
        return
    if program is not None and not detail:
        detail = f"program serial {getattr(program, '_serial', '?')}"
    s = _Section(token=next(_wd_tokens), section=section, detail=detail,
                 timeout=float(timeout),
                 deadline=time.monotonic() + float(timeout),
                 thread_id=threading.get_ident())
    from .. import monitor as _monitor

    if _monitor.enabled():
        _monitor.counter(
            "watchdog_sections_armed_total",
            "watchdog-armed executor sections").labels(
            section=section).inc()
    with _wd_lock:
        _wd_armed[s.token] = s
    _ensure_wd_thread()
    converted = False
    try:
        yield s
    except KeyboardInterrupt:
        if s.expired:
            converted = True
            raise WatchdogTimeout(section, s.timeout, s.detail) from None
        raise
    except _WatchdogInterrupt:
        # the cross-thread delivery path (non-main sections): always ours
        # — nothing else raises this type
        converted = True
        raise WatchdogTimeout(section, s.timeout, s.detail) from None
    finally:
        with _wd_lock:
            _wd_armed.pop(s.token, None)
        if s.expired and not converted:
            # the section finished in the race window between expiry and
            # interrupt delivery: absorb the in-flight interrupt here (it
            # was aimed at this section) instead of letting it detonate in
            # whatever innocent code runs next. The watchdog polls every
            # 0.05s, so a few short sleeps cover the window.
            try:
                for _ in range(4):
                    time.sleep(0.02)
            except (KeyboardInterrupt, _WatchdogInterrupt):
                logger.warning(
                    "watchdog: absorbed a late interrupt for section "
                    "'%s' that completed at its deadline", section)
