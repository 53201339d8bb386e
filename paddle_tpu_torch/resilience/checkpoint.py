"""Crash-safe checkpoint integrity: manifest, verification, atomic publish
(counterpart of ``paddle_tpu/resilience/checkpoint.py``, with its names,
PT600-PT604 codes, messages and manifest format).

A process can die at ANY byte of a checkpoint write (preemption, OOM-kill,
power). Two halves keep the live directory whole:

* **atomic publish** (``io.save_checkpoint``): write into a temp dir
  sibling, fsync every file and the directory, then ``rename`` into place —
  the live path either holds the complete old checkpoint or the complete
  new one, never a mixture.
* **verification** (this module): the final ``manifest.json`` carries a
  per-file sha256 + byte count, the param inventory, and the framework
  version. ``verify_checkpoint`` replays the hashes before a single byte is
  loaded; failures raise :class:`CheckpointCorruptError` with a stable
  PT6xx code naming exactly what failed.

``load_latest_checkpoint`` is the recovery walk: serials are tried newest
-> oldest, torn/corrupt ones are skipped (counted on
``trainer_ckpt_fallback_total``), and training resumes from the newest
checkpoint that *proves* intact.

The sharded format (manifest ``format_version`` 2, PT605-PT609) is the
data-parallel step's: ``resilience/distributed.py`` writes and
reassembles it; :func:`verify_sharding_section` checks its structure
before any blob is read.
"""
from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

__all__ = ["CheckpointCorruptError", "CKPT_CODES", "FORMAT_VERSION",
           "MANIFEST_NAME", "finalize_manifest", "verify_checkpoint",
           "verify_sharding_section", "atomic_replace_dir", "fsync_dir",
           "iter_serials", "load_latest_checkpoint"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

# max SUPPORTED format. 2 = v1 + a "sharding" section (resilience.
# distributed): per-mesh-shard blob files, the mesh shape, and a per-param
# sharding spec. Plain (non-sharded) checkpoints are still STAMPED 1 —
# their layout is byte-identical to v1, so a framework rollback keeps
# restoring them instead of refusing with PT604.
FORMAT_VERSION = 2
MANIFEST_NAME = "manifest.json"

# PT6xx: checkpoint-integrity diagnostics (the reference's stable codes;
# PT605-PT609 belong to the sharded format)
CKPT_CODES = {
    "PT600": "checkpoint manifest missing (torn write or pre-manifest dir)",
    "PT601": "checkpoint manifest unreadable or not a verification manifest",
    "PT602": "file listed in the manifest is missing from the checkpoint",
    "PT603": "file content does not match its manifest sha256/size "
             "(torn write or tampering)",
    "PT604": "checkpoint format version newer than this framework supports",
    # PT605-PT609: sharded (format_version 2) checkpoints
    "PT605": "shard-count mismatch: the manifest's num_shards, shard file "
             "list and per-param specs disagree",
    "PT606": "per-param sharding spec does not match the declared var "
             "(bad axis, non-divisible parts, or missing piece)",
    "PT607": "torn shard write: a shard file the manifest declares is "
             "absent or was never integrity-hashed (a distributed writer "
             "died mid-checkpoint)",
    "PT608": "shard reassembly mismatch: concatenated pieces do not "
             "produce the declared var shape/dtype",
    "PT609": "sharding section malformed (missing/ill-typed fields)",
}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification. Carries the PT6xx
    ``code``, the checkpoint ``dirname`` and a ``detail`` naming the exact
    file/field that failed."""

    def __init__(self, code: str, dirname: str, detail: str):
        self.code = code
        self.dirname = dirname
        self.detail = detail
        super().__init__(
            f"[{code}] checkpoint '{dirname}': {detail} — {CKPT_CODES[code]}")


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Durably record directory entries (the rename itself needs this)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass   # some filesystems refuse dir fsync; rename is still atomic
    finally:
        os.close(fd)


def _rel_files(dirname: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(dirname):
        for f in files:
            out.append(os.path.relpath(os.path.join(root, f), dirname))
    return sorted(out)


def finalize_manifest(dirname: str, params: Optional[Dict[str, dict]] = None,
                      extra: Optional[dict] = None) -> dict:
    """Upgrade the var-inventory ``manifest.json`` that ``_save_var_list``
    wrote into the integrity manifest: per-file sha256 + bytes over every
    OTHER file in the dir (the manifest cannot hash itself), param
    inventory, framework + format versions. Everything is fsynced; the
    caller then atomically publishes the directory."""
    manifest_path = os.path.join(dirname, MANIFEST_NAME)
    manifest: dict = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    files = {}
    for rel in _rel_files(dirname):
        if rel == MANIFEST_NAME:
            continue
        full = os.path.join(dirname, rel)
        _fsync_file(full)
        files[rel] = {"sha256": _sha256(full),
                      "bytes": os.path.getsize(full)}
    from .. import __version__

    manifest.update({
        # plain checkpoints stay format 1 (byte-identical layout to what
        # older builds wrote AND verify), so a framework rollback can
        # still restore them; only the sharding section requires 2
        "format_version": 2 if manifest.get("sharding") else 1,
        "framework_version": __version__,
        "files": files,
    })
    if params is not None:
        manifest["vars"] = params
    if extra:
        manifest.update(extra)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(dirname)
    return manifest


def verify_checkpoint(dirname: str) -> dict:
    """Replay the manifest before loading anything. Returns the manifest on
    success; raises :class:`CheckpointCorruptError` (PT600-PT604) naming
    the first failure otherwise."""
    manifest_path = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.isdir(dirname) or not os.path.exists(manifest_path):
        raise CheckpointCorruptError("PT600", dirname,
                                     f"no {MANIFEST_NAME} present")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict):
            raise ValueError("manifest is not an object")
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError("PT601", dirname,
                                     f"cannot parse {MANIFEST_NAME}: {e}")
    files = manifest.get("files")
    if not isinstance(files, dict):
        raise CheckpointCorruptError(
            "PT601", dirname,
            f"{MANIFEST_NAME} has no 'files' integrity section (written by "
            f"a pre-resilience save_checkpoint?)")
    version = manifest.get("format_version", 0)
    if int(version) > FORMAT_VERSION:
        raise CheckpointCorruptError(
            "PT604", dirname,
            f"format_version {version} > supported {FORMAT_VERSION}")
    if manifest.get("sharding") is not None:
        # sharded structural checks first: a torn shard gets its specific
        # PT607 diagnosis rather than the generic missing-file PT602
        verify_sharding_section(dirname, manifest)
    for rel, want in sorted(files.items()):
        full = os.path.join(dirname, rel)
        if not os.path.exists(full):
            raise CheckpointCorruptError("PT602", dirname,
                                         f"'{rel}' listed but missing")
        size = os.path.getsize(full)
        if "bytes" in want and size != int(want["bytes"]):
            raise CheckpointCorruptError(
                "PT603", dirname,
                f"'{rel}' is {size} bytes, manifest says {want['bytes']}")
        if _sha256(full) != want.get("sha256"):
            raise CheckpointCorruptError(
                "PT603", dirname, f"'{rel}' sha256 mismatch")
    return manifest


def verify_sharding_section(dirname: str, manifest: dict) -> dict:
    """Structural checks for a format_version-2 sharded checkpoint, run
    BEFORE any blob is read: the sharding section is well-formed (PT609),
    its counts agree (PT605), and every declared shard file both exists on
    disk and is covered by the integrity section (PT607 — the torn
    distributed write: one writer died after the manifest named its shard
    but before the shard file landed or was hashed; a raw KeyError deep in
    the loader is exactly what the recovery walk must never see).
    Content-level checks (PT606/PT608) happen at load, where the pieces
    are actually read."""
    sh = manifest.get("sharding")
    if not isinstance(sh, dict):
        raise CheckpointCorruptError(
            "PT609", dirname, "'sharding' section is not an object")
    shard_files = sh.get("shard_files")
    specs = sh.get("specs")
    n = sh.get("num_shards")
    if not isinstance(shard_files, list) or not isinstance(specs, dict) \
            or not isinstance(n, int) or not isinstance(sh.get("mesh"),
                                                        dict):
        raise CheckpointCorruptError(
            "PT609", dirname,
            "sharding section lacks num_shards/mesh/shard_files/specs")
    if len(shard_files) != n:
        raise CheckpointCorruptError(
            "PT605", dirname,
            f"num_shards={n} but {len(shard_files)} shard files declared")
    for name, spec in sorted(specs.items()):
        if not isinstance(spec, dict) or "dim" not in spec \
                or "parts" not in spec:
            raise CheckpointCorruptError(
                "PT609", dirname, f"spec for '{name}' lacks dim/parts")
        if int(spec["parts"]) != n:
            raise CheckpointCorruptError(
                "PT605", dirname,
                f"'{name}' declares parts={spec['parts']} but the "
                f"checkpoint holds {n} shards")
    files = manifest.get("files") or {}
    for rel in shard_files:
        if not os.path.exists(os.path.join(dirname, str(rel))):
            raise CheckpointCorruptError(
                "PT607", dirname, f"shard file '{rel}' declared but absent")
        if rel not in files:
            raise CheckpointCorruptError(
                "PT607", dirname,
                f"shard file '{rel}' present but never integrity-hashed "
                f"(its writer died before finalize)")
    return sh


def atomic_replace_dir(tmp: str, dst: str) -> None:
    """Publish ``tmp`` at ``dst``. The fresh-path case (``dst`` absent or
    an empty placeholder — every ``checkpoint_<n>`` serial of a training
    loop that never re-uses one) is a single atomic rename. Overwriting a NON-empty ``dst``
    (direct re-save to one path) needs two renames because POSIX has no
    portable atomic directory swap: old -> ``<dst>.replaced.<pid>``, tmp
    -> ``dst``. A SIGKILL exactly between them leaves the old checkpoint
    at the ``.replaced`` name (recovery does not scan it — prefer
    serial-per-save layouts when overwrite-crash matters); an exception
    restores it. Stale ``.replaced`` litter from such kills is cleaned up
    on the next publish."""
    parent = os.path.dirname(os.path.abspath(dst)) or "."
    for stale in glob.glob(f"{dst}.replaced.*"):
        shutil.rmtree(stale, ignore_errors=True)
    if os.path.isdir(dst) and os.listdir(dst):
        aside = f"{dst}.replaced.{os.getpid()}"
        os.rename(dst, aside)
        try:
            os.rename(tmp, dst)
        except BaseException:
            os.rename(aside, dst)   # put the old checkpoint back
            raise
        fsync_dir(parent)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        if os.path.isdir(dst):
            os.rmdir(dst)   # empty placeholder (e.g. pytest tmp_path)
        os.rename(tmp, dst)
        fsync_dir(parent)


_SERIAL_RE = re.compile(r"^checkpoint_(\d+)$")


def iter_serials(checkpoint_dir: str) -> List[Tuple[int, str]]:
    """(serial, path) for every ``checkpoint_<int>`` DIRECTORY, ascending.
    Files, temp dirs (``.checkpoint_*.tmp.*``) and non-numeric entries are
    ignored — a garbage-filled checkpoint dir must never crash recovery."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in os.listdir(checkpoint_dir):
        m = _SERIAL_RE.match(name)
        path = os.path.join(checkpoint_dir, name)
        if m and os.path.isdir(path):
            out.append((int(m.group(1)), path))
    return sorted(out)


def load_latest_checkpoint(executor, checkpoint_dir: str, main_program=None,
                           scope=None, allow_legacy: bool = True):
    """Walk serials newest -> oldest, skipping any checkpoint that fails
    verification or loading. Returns ``(meta, serial, skipped)`` where
    ``skipped`` is a list of ``{serial, path, code, error}`` dicts for the
    checkpoints passed over; ``(None, None, skipped)`` when nothing loads.
    Each skip increments ``trainer_ckpt_fallback_total``.

    When NO serial verifies and ``allow_legacy`` is set, a second pass
    retries (newest -> oldest) the serials whose only defect was a missing
    integrity manifest (PT600/PT601 — what a pre-resilience writer
    produced for every checkpoint) with ``verify=False``: resuming from an
    unverified-but-loadable legacy checkpoint beats silently restarting at
    step 0 and letting rotation delete it. Genuinely torn blobs still fail
    to load (npz CRC) and are skipped. Verified checkpoints ALWAYS win,
    even over a newer legacy-shaped one — that newer one is
    indistinguishable from a torn write."""
    from .. import io as io_mod
    from .. import monitor as _monitor

    def _skip(serial, path, code, err, why):
        skipped.append({"serial": serial, "path": path,
                        "code": str(code), "error": str(err)})
        if _monitor.enabled():
            _monitor.counter(
                "trainer_ckpt_fallback_total",
                "checkpoints skipped during recovery (torn/corrupt/"
                "unloadable)").labels(code=str(code)).inc()
        logger.warning(
            "resilience: checkpoint_%d %s (%s), falling back: %s",
            serial, why, code, err)

    skipped: List[dict] = []
    serials = iter_serials(checkpoint_dir)
    for serial, path in reversed(serials):
        try:
            meta = io_mod.load_checkpoint(executor, path,
                                          main_program=main_program,
                                          scope=scope)
        except Exception as e:
            _skip(serial, path, getattr(e, "code", type(e).__name__), e,
                  "failed verification/load")
            continue
        return meta, serial, skipped
    if allow_legacy:
        legacy = {s["serial"] for s in skipped
                  if s["code"] in ("PT600", "PT601")}
        for serial, path in reversed(serials):
            if serial not in legacy:
                continue
            try:
                meta = io_mod.load_checkpoint(executor, path,
                                              main_program=main_program,
                                              scope=scope, verify=False)
            except Exception as e:
                _skip(serial, path, "legacy_load_failed", e,
                      "has no integrity manifest and did not load")
                continue
            logger.warning(
                "resilience: no serial in '%s' passed verification; "
                "resumed from UNVERIFIED legacy checkpoint_%d (written by "
                "a pre-resilience build?). Save once to upgrade it to the "
                "manifest format.", checkpoint_dir, serial)
            return meta, serial, skipped
    return None, None, skipped
