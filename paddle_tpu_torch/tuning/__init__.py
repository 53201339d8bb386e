"""paddle_tpu_torch.tuning — the persistent, measurement-driven autotuner
(counterpart of ``paddle_tpu/tuning``).

The knob on this card is the fused-GEMM kernel's (K5) block triple: the
port compiles ``csrc/fused_gemm.cu`` at the tilings of
``kernels.fused_gemm.COMPILED_BLOCKS``, and which one runs fastest depends
on the GEMM's shape (a 128 x 256 tile gives ResNet-50's fc head four
blocks on 132 SMs). A durable cost database keyed by **(program content
fingerprint, shape bucket, backend)** records the measured step time per
candidate, and the best-known entry feeds back into the executor path.

Modes (``FLAGS_autotune``):

* ``off``     — no database access anywhere (default).
* ``use``     — ``Executor`` consults the DB per program, batch bucket and
  backend: when ``FLAGS_fused_gemm_blocks`` is not explicitly set, the
  best-known triple reaches the run's ``LowerCtx.gemm_blocks`` (and joins
  the executor and fusion keys, so a DB update re-witnesses and re-keys
  rather than silently reusing a stale entry). It is never stamped on the
  shared ``Program``. Zero trials ever run in this mode.
* ``measure`` — ``use`` plus :func:`measure_candidates` may run trials
  (the chained-differencing protocol) and record them.

The reference's second knob, ``FLAGS_xla_options``, has no counterpart
in a port that compiles no program: every candidate's ``xla_options`` is
``{}``, kept so the database's schema and field names are the
reference's.

Safety: the executor-path lookups NEVER raise — a torn/corrupt/alien DB
file degrades to "no best known" with one warning. Each trial carries the
framework version and, under the reference's field name ``jax_version``,
the compute stack it ran on (``torch <version> cuda <version>``);
``best()`` ignores trials measured by a different version (staleness
rule).

Counters (``monitor.record_autotune_lookup`` / ``record_autotune_trial``):
``autotune_hits_total`` / ``autotune_misses_total`` (executor-path
lookups), ``autotune_trials_total`` (measured candidates),
``autotune_best_per_step_seconds`` gauge per (program, bucket).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..monitor.lockwitness import make_lock, make_rlock

__all__ = [
    "CostDatabase", "TunedConfig", "autotune_mode", "default_db_path",
    "get_database", "reset_database_cache", "program_content_fingerprint",
    "shape_bucket", "backend_name", "lookup_best", "record_trial",
    "default_candidates", "measure_candidates", "in_trial", "trial_guard",
    "chained_step_seconds", "GEMM_BLOCK_SETS",
]

logger = logging.getLogger("paddle_tpu_torch.tuning")

_SCHEMA = 1

# measure_candidates sets this while a candidate trial is running: the
# executor path must NOT fill the unset block triple from the DB during a
# trial, or the baseline {} candidate would silently be measured under the
# best-known triple and recorded as if it were its own — corrupting best()
# forever after. PROCESS-global (a nesting counter, not thread-local) on
# purpose: the candidate flag set_flags writes is process-global too, so
# any OTHER thread running mid-sweep already sees the candidate's explicit
# triple — at least it must not additionally mix DB-filled knobs into it.
_trial_depth = 0
_trial_lock = make_lock("tuning._trial_lock")


def in_trial() -> bool:
    """True while measure_candidates is timing a candidate anywhere in
    this process (the executor skips DB knob-filling then)."""
    return _trial_depth > 0


class trial_guard:
    """Context manager marking this process as running a tuning trial:
    the executor path will not fill the unset block triple from the cost
    database while it is active — a candidate must run exactly as its
    flags specify."""

    def __enter__(self):
        global _trial_depth
        with _trial_lock:
            _trial_depth += 1
        return self

    def __exit__(self, *exc):
        global _trial_depth
        with _trial_lock:
            _trial_depth = max(0, _trial_depth - 1)
        return False


# K5's Hopper tilings (kernels.fused_gemm.COMPILED_BLOCKS): None is the
# compiled default (128, 256, 32); the others give small GEMMs more blocks
# on the 132 SMs
GEMM_BLOCK_SETS: List[Optional[Tuple[int, int, int]]] = [
    None,
    (128, 128, 32),
    (64, 128, 32),
    (64, 64, 32),
]


def autotune_mode() -> str:
    from ..flags import flag

    return str(flag("autotune"))


def default_db_path() -> str:
    from ..flags import flag

    raw = str(flag("autotune_db")).strip()
    if raw:
        return raw
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "autotune_db.json")


def _versions() -> Tuple[str, str]:
    """(framework version, compute stack version): the staleness rule's
    identity of who measured a trial."""
    import torch

    from .. import __version__

    return str(__version__), f"torch {torch.__version__} cuda " \
                             f"{torch.version.cuda}"


def backend_name(device=None) -> str:
    """``"cuda:<card name>"`` for a CUDA device (the default when one is
    visible), else ``"cpu"``: trials measured on one card never rank
    another's."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return "cuda:" + torch.cuda.get_device_name(device)


def shape_bucket(batch_rows: int) -> int:
    """Power-of-two batch bucket — the serving engine's padding rule, so a
    measurement at bucket 128 serves every batch the executor would pad
    there."""
    b = max(int(batch_rows), 1)
    p = 1
    while p < b:
        p <<= 1
    return p


_VOLATILE_ATTRS = ("__uid__", "op_callstack", "op_namescope")


def program_content_fingerprint(program) -> str:
    """Stable CONTENT hash of a program — unlike ``program._serial`` (a
    per-process counter) it survives process restarts, which is what makes
    the database durable. Hashes op types, slot wiring, non-volatile attrs
    and var metadata in deterministic order; memoized per (program,
    version)."""
    cached = getattr(program, "_content_fp", None)
    if cached is not None and cached[0] == getattr(program, "_version", 0):
        return cached[1]
    h = hashlib.sha256()
    for blk in program.blocks:
        for name in sorted(blk.vars):
            v = blk.vars[name]
            h.update(f"v|{blk.idx}|{name}|{v.shape}|{v.dtype}|"
                     f"{v.persistable}|{v.is_data}\n".encode())
        for op in blk.ops:
            attrs = sorted((k, repr(val)) for k, val in op.attrs.items()
                           if k not in _VOLATILE_ATTRS)
            h.update(f"o|{blk.idx}|{op.type}|"
                     f"{sorted((k, tuple(v)) for k, v in op.inputs.items())}|"
                     f"{sorted((k, tuple(v)) for k, v in op.outputs.items())}"
                     f"|{attrs}\n".encode())
    fp = h.hexdigest()[:16]
    program._content_fp = (getattr(program, "_version", 0), fp)
    return fp


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One candidate configuration (also the DB trial identity).
    ``xla_options`` stays empty in the port (see the module docstring)."""

    xla_options: Tuple[Tuple[str, Any], ...] = ()
    gemm_blocks: Optional[Tuple[int, int, int]] = None

    @staticmethod
    def make(xla_options: Optional[dict] = None,
             gemm_blocks=None) -> "TunedConfig":
        return TunedConfig(
            xla_options=tuple(sorted((xla_options or {}).items())),
            gemm_blocks=tuple(int(b) for b in gemm_blocks)
            if gemm_blocks else None)

    def options_dict(self) -> dict:
        return dict(self.xla_options)

    def to_dict(self) -> dict:
        return {"xla_options": dict(self.xla_options),
                "gemm_blocks": list(self.gemm_blocks)
                if self.gemm_blocks else None}

    @staticmethod
    def from_dict(d: dict) -> "TunedConfig":
        return TunedConfig.make(d.get("xla_options") or {},
                                d.get("gemm_blocks"))


class CostDatabase:
    """The durable cost store: one JSON file, atomic rewrite (temp sibling
    + fsync + rename), a thread lock per instance plus a cross-process file
    lock + merge-on-save for concurrent recorders (two measure-mode
    processes sharing one DB union their trials instead of last-writer-wins
    dropping one side). Load failures are warnings, not errors: a corrupt
    database means "nothing is known", never a broken run."""

    def __init__(self, path: str):
        self.path = path
        self._lock = make_rlock("CostDatabase._lock")
        self._entries: Optional[Dict[str, dict]] = None

    # -- keys ------------------------------------------------------------
    @staticmethod
    def key(program_fp: str, bucket: int, backend: str) -> str:
        return f"{program_fp}|b{int(bucket)}|{backend}"

    # -- persistence -----------------------------------------------------
    def _read_file(self) -> Dict[str, dict]:
        """Entries as currently on disk — no memoization."""
        entries: Dict[str, dict] = {}
        try:
            if os.path.exists(self.path):
                with open(self.path, "r", encoding="utf-8") as f:
                    raw = json.load(f)
                if isinstance(raw, dict) and raw.get("schema") == _SCHEMA \
                        and isinstance(raw.get("entries"), dict):
                    entries = raw["entries"]
                else:
                    logger.warning(
                        "autotune DB %s has schema %r (want %d) — starting "
                        "empty", self.path, raw.get("schema")
                        if isinstance(raw, dict) else None, _SCHEMA)
        except (OSError, ValueError) as e:
            logger.warning("autotune DB %s unreadable (%s: %s) — starting "
                           "empty", self.path, type(e).__name__, e)
        return entries

    def _load(self) -> Dict[str, dict]:
        if self._entries is None:
            self._entries = self._read_file()
        return self._entries

    def _merge_from_disk(self, entries: Dict[str, dict]) -> None:
        """Union trials another process recorded since we memoized into
        ``entries``. Same-candidate conflicts keep the in-memory trial
        (this process re-measured — record()'s latest-belief rule)."""
        for key, de in self._read_file().items():
            e = entries.get(key)
            if e is None:
                entries[key] = de
                continue
            have = {json.dumps(t.get("candidate"), sort_keys=True)
                    for t in e.get("trials", ())}
            for t in de.get("trials", ()):
                if json.dumps(t.get("candidate"),
                              sort_keys=True) not in have:
                    e.setdefault("trials", []).append(t)

    def save(self) -> None:
        with self._lock:
            entries = self._load()
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # cross-process exclusive section: lock sibling, re-read,
            # merge, then the atomic rewrite — concurrent recorders
            # serialize here instead of last-replace-wins losing trials
            lk = None
            try:
                try:
                    import fcntl

                    lk = open(self.path + ".lock", "w")
                    fcntl.flock(lk, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    if lk is not None:
                        lk.close()
                    lk = None   # no fcntl (or lockfile unwritable):
                    # merge-on-save still shrinks the lost-update window
                self._merge_from_disk(entries)
                tmp = self.path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump({"schema": _SCHEMA, "entries": entries}, f,
                              indent=1, sort_keys=True)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            finally:
                if lk is not None:
                    lk.close()

    # -- record / query --------------------------------------------------
    def record(self, program_fp: str, bucket: int, backend: str,
               config: TunedConfig, per_step_s: float,
               achieved_tflops: Optional[float] = None,
               save: bool = True) -> dict:
        fw, stack = _versions()
        trial = {"candidate": config.to_dict(),
                 "per_step_s": float(per_step_s),
                 "achieved_tflops": achieved_tflops,
                 "framework_version": fw, "jax_version": stack,
                 "recorded_at": time.time()}
        with self._lock:
            entries = self._load()
            key = self.key(program_fp, bucket, backend)
            e = entries.setdefault(key, {"program": program_fp,
                                         "bucket": int(bucket),
                                         "backend": backend, "trials": []})
            # one trial per candidate: remeasuring replaces (the DB stores
            # the latest belief)
            cand = config.to_dict()
            e["trials"] = [t for t in e["trials"]
                           if t.get("candidate") != cand]
            e["trials"].append(trial)
            if save:
                self.save()
        return trial

    def best(self, program_fp: str, bucket: int, backend: str
             ) -> Optional[dict]:
        """The fastest valid trial, or None. Staleness rule: trials from a
        different framework or compute-stack version are invisible — a
        torch or CUDA upgrade invalidates its own measurements."""
        fw, stack = _versions()
        with self._lock:
            e = self._load().get(self.key(program_fp, bucket, backend))
            if not e:
                return None
            valid = [t for t in e.get("trials", ())
                     if t.get("framework_version") == fw
                     and t.get("jax_version") == stack
                     and isinstance(t.get("per_step_s"), (int, float))]
            if not valid:
                return None
            return min(valid, key=lambda t: t["per_step_s"])

    def trial_count(self) -> int:
        with self._lock:
            return sum(len(e.get("trials", ()))
                       for e in self._load().values())

    def to_dict(self) -> dict:
        with self._lock:
            return {"schema": _SCHEMA, "path": self.path,
                    "entries": json.loads(json.dumps(self._load()))}


_db_cache: Dict[str, CostDatabase] = {}
_db_lock = make_lock("tuning._db_lock")


def get_database(path: Optional[str] = None) -> CostDatabase:
    p = path or default_db_path()
    with _db_lock:
        db = _db_cache.get(p)
        if db is None:
            db = _db_cache[p] = CostDatabase(p)
        return db


def reset_database_cache() -> None:
    """Test hook: drop memoized databases (a test pointing
    FLAGS_autotune_db at a fresh tmp file must not see another test's
    entries)."""
    with _db_lock:
        _db_cache.clear()


# ---------------------------------------------------------------------------
# executor-path feedback (the 'use' side)
# ---------------------------------------------------------------------------

_warned_lookup = False


def lookup_best(program, batch_rows: int,
                device=None) -> Optional[TunedConfig]:
    """Best-known config for (program, batch bucket, backend of
    ``device``), or None. Called from the executor path — NEVER raises;
    counts ``autotune_hits_total`` / ``autotune_misses_total``."""
    global _warned_lookup
    try:
        if autotune_mode() == "off":
            return None
        from .. import monitor

        fp = program_content_fingerprint(program)
        bucket = shape_bucket(batch_rows)
        t = get_database().best(fp, bucket, backend_name(device))
        monitor.record_autotune_lookup(
            t is not None, fp, bucket,
            t["per_step_s"] if t is not None else None)
        if t is None:
            return None
        return TunedConfig.from_dict(t["candidate"])
    except Exception as e:  # the executor path must keep running
        if not _warned_lookup:
            _warned_lookup = True
            logger.warning("autotune lookup disabled after error: %s: %s",
                           type(e).__name__, e)
        return None


def record_trial(program, batch_rows: int, config: TunedConfig,
                 per_step_s: float, achieved_tflops: Optional[float] = None,
                 db: Optional[CostDatabase] = None,
                 save: bool = True, device=None) -> dict:
    """Record one measured candidate (requires FLAGS_autotune=measure).
    ``save=False`` defers the durable write — callers recording a batch
    of trials (measure_candidates) save once at the end instead of
    paying a lock+merge+fsync cycle per candidate."""
    if autotune_mode() != "measure":
        raise RuntimeError(
            "recording autotune trials requires FLAGS_autotune=measure "
            f"(currently {autotune_mode()!r})")
    from .. import monitor

    fp = program_content_fingerprint(program)
    bucket = shape_bucket(batch_rows)
    monitor.record_autotune_trial()
    return (db or get_database()).record(
        fp, bucket, backend_name(device), config, per_step_s,
        achieved_tflops, save=save)


# ---------------------------------------------------------------------------
# the measure loop (the 'measure' side)
# ---------------------------------------------------------------------------

def chained_step_seconds(exe, program, feed, fetch_list, scope,
                         k_short: int = 2, k_long: int = 6,
                         repeats: int = 1) -> float:
    """Per-step seconds via the chained differencing protocol:
    (T(k_long) - T(k_short)) / (k_long - k_short), each T the min over
    ``repeats`` timed dispatches after one untimed warm-up dispatch, the
    last fetched element read through ``.item()`` forcing the host to
    wait for the device. Floored at 1e-9: a noise-negative difference is
    meaningless."""

    def run_k(k: int) -> float:
        def once() -> float:
            t0 = time.perf_counter()
            out = exe.run_chained(program, feed=feed,
                                  fetch_list=fetch_list, steps=k,
                                  scope=scope, return_numpy=False)
            _ = float(out[0].reshape(-1)[-1].item())
            return time.perf_counter() - t0
        once()
        return min(once() for _ in range(repeats))

    t_short, t_long = run_k(k_short), run_k(k_long)
    return max((t_long - t_short) / (k_long - k_short), 1e-9)


def default_candidates(include_gemm_blocks: bool = False
                       ) -> List[TunedConfig]:
    """The ``{}`` baseline (the compiled default triple), plus one
    candidate per other compiled triple when ``include_gemm_blocks``."""
    cands = [TunedConfig.make({})]
    if include_gemm_blocks:
        for blocks in GEMM_BLOCK_SETS:
            if blocks is not None:
                cands.append(TunedConfig.make({}, blocks))
    return cands


def measure_candidates(exe, program, feed, fetch_list, scope,
                       candidates: Optional[Sequence[TunedConfig]] = None,
                       k_short: int = 2, k_long: int = 6, repeats: int = 1,
                       batch_rows: Optional[int] = None,
                       db: Optional[CostDatabase] = None) -> dict:
    """Measure ``candidates`` on ``program`` with the chained-differencing
    protocol and record every successful trial into the cost database
    under ``exe``'s backend. Returns the ranked report. Requires
    ``FLAGS_autotune=measure``. A candidate that raises is reported with
    ``status: "error"`` and recorded nowhere.

    NOT safe under concurrent traffic: each candidate is applied through
    the process-global ``FLAGS_fused_gemm_blocks``, so any other thread
    running mid-sweep runs under the candidate's transient triple. The
    trial guard is process-global so such a thread at least never mixes
    a DB-filled triple on top — but run sweeps offline, not under a live
    serving engine."""
    from ..flags import get_flags, set_flags

    if autotune_mode() != "measure":
        raise RuntimeError("measure_candidates requires FLAGS_autotune="
                           f"measure (currently {autotune_mode()!r})")
    if batch_rows is None:
        from ..executor import _feed_batch_rows

        batch_rows = _feed_batch_rows(feed)
    candidates = list(candidates if candidates is not None
                      else default_candidates())

    prev = get_flags(["FLAGS_fused_gemm_blocks"])
    trials = []
    database = db or get_database()
    recorded = 0
    try:
        with trial_guard():
            for cand in candidates:
                set_flags({"FLAGS_fused_gemm_blocks": ",".join(
                    str(b) for b in cand.gemm_blocks)
                    if cand.gemm_blocks else ""})
                label = json.dumps(cand.to_dict(), sort_keys=True)
                try:
                    per_step = chained_step_seconds(
                        exe, program, feed, fetch_list, scope,
                        k_short=k_short, k_long=k_long, repeats=repeats)
                    rec = record_trial(program, batch_rows, cand, per_step,
                                       db=database, save=False,
                                       device=exe.device)
                    recorded += 1
                    trials.append({"candidate": cand.to_dict(),
                                   "status": "ok",
                                   "per_step_s": per_step,
                                   "recorded_at": rec["recorded_at"]})
                except Exception as e:  # one candidate's failure is data
                    trials.append({"candidate": cand.to_dict(),
                                   "status": "error",
                                   "error": f"{type(e).__name__}: {e}"[:300]})
                    logger.warning("autotune candidate %s failed: %s",
                                   label, e)
    finally:
        set_flags(prev)
        # one durable write for the whole batch (in the finally so an
        # interrupted sweep keeps the trials measured before the crash)
        if recorded:
            try:
                database.save()
            except OSError as e:
                logger.warning("autotune DB save failed: %s: %s",
                               type(e).__name__, e)

    ok = sorted((t for t in trials if t["status"] == "ok"),
                key=lambda t: t["per_step_s"])
    for rank, t in enumerate(ok):
        t["rank"] = rank
    return {
        "program": program_content_fingerprint(program),
        "bucket": shape_bucket(batch_rows),
        "backend": backend_name(exe.device),
        "trials": trials,
        "best": ok[0] if ok else None,
    }
