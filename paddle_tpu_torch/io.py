"""Checkpointing: save/load params, persistables, inference models
(counterpart of ``paddle_tpu/io.py``; reference python/paddle/fluid/io.py
save_vars :130, save_params :263, save_persistables :496, load_vars :546,
save_inference_model :965, load_inference_model :1157).

The on-disk format is the JAX package's, so a checkpoint crosses packages
in both directions: one ``<name>.npy`` per var (``/`` written as ``__``)
or one ``npz`` archive (``filename``), plus a ``manifest.json`` holding
``{"vars": {name: {"shape", "dtype"}}, "filename"}``. A bfloat16 var is
written as the JAX package's ``np.save`` writes an ``ml_dtypes`` bfloat16
array: descr ``<V2`` over the raw two-byte values, ``"bfloat16"`` in the
manifest; on load such a blob becomes a torch bfloat16 tensor again.
Loads land on the executor's device, and are two-phase: every blob is
read and checked against the program first, so a mismatch leaves the
scope untouched.

``save_checkpoint``/``load_checkpoint`` add crash safety
(``resilience.checkpoint``): a temp dir, a verified manifest with per-file
sha256, fsync and an atomic rename; the ``ckpt_write`` fault site fires
between the blobs and the manifest. The sharded format (``mesh=``) needs
the sharded half of ``resilience/distributed.py`` and raises
``NotImplementedError``. The re-export of ``DataLoader``/``PyReader``
waits for the port's data path.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import List, Optional

import numpy as np
import torch

from .executor import Scope, global_scope
from .framework import Parameter, Program, Variable

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "save_checkpoint", "load_checkpoint"]

_MANIFEST = "manifest.json"
# the descr numpy writes for an ml_dtypes bfloat16 array
_BF16_DESCR = "<V2"


def _ensure_dir(dirname: str) -> None:
    """makedirs with a CLEAR diagnostic when the target exists as a file."""
    if os.path.exists(dirname) and not os.path.isdir(dirname):
        raise ValueError(
            f"save: dirname '{dirname}' already exists as a FILE — "
            f"checkpoints and inference models are directories; remove the "
            f"file or pick another path")
    os.makedirs(dirname, exist_ok=True)


def _vars_of(program: Program, predicate) -> List[Variable]:
    return [v for v in program.list_vars() if predicate(v)]


def _host_array(val):
    """(numpy array, manifest dtype) of a scope value; a bfloat16 tensor
    becomes its raw two-byte values."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(val)
    return arr, str(arr.dtype)


def _write_npy(fp, arr: np.ndarray, dtype: str) -> None:
    """``np.save``'s bytes; a bfloat16 blob gets the ``<V2`` descr."""
    if dtype != "bfloat16":
        np.lib.format.write_array(fp, arr, allow_pickle=False)
        return
    arr = np.ascontiguousarray(arr)
    np.lib.format.write_array_header_1_0(
        fp, {"descr": _BF16_DESCR, "fortran_order": False,
             "shape": arr.shape})
    fp.write(arr.tobytes("C"))


def _save_var_list(executor, dirname: str, vars_: List[Variable],
                   scope: Optional[Scope], filename: Optional[str]):
    scope = scope or global_scope()
    _ensure_dir(dirname)
    manifest = {}
    blobs = {}
    for v in vars_:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"save: variable '{v.name}' has no value in scope")
        arr, dtype = _host_array(val)
        blobs[v.name] = (arr, dtype)
        manifest[v.name] = {"shape": list(arr.shape), "dtype": dtype}
    if filename is None:
        for name, (arr, dtype) in blobs.items():
            with open(os.path.join(dirname, name.replace("/", "__")
                                   + ".npy"), "wb") as f:
                _write_npy(f, arr, dtype)
    else:
        # the combined blob is an npz archive written as np.savez writes
        # one (stored, zip64 entries of plain tensor bytes, never pickled
        # objects)
        with open(os.path.join(dirname, filename), "wb") as f, \
                zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                                allowZip64=True) as zf:
            for name, (arr, dtype) in blobs.items():
                with zf.open(name.replace("/", "__") + ".npy", "w",
                             force_zip64=True) as fid:
                    _write_npy(fid, arr, dtype)
    with open(os.path.join(dirname, _MANIFEST), "w") as f:
        json.dump({"vars": manifest, "filename": filename}, f)


def _to_tensor(arr: np.ndarray, dtype: Optional[str], device
               ) -> torch.Tensor:
    """A loaded blob as a tensor on ``device``; a ``V2`` blob the manifest
    calls bfloat16 is reinterpreted as bfloat16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 and \
            dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _load_var_list(executor, dirname: str, vars_: List[Variable],
                   scope: Optional[Scope], filename: Optional[str]):
    scope = scope or global_scope()
    device = getattr(executor, "device", torch.device("cpu"))
    manifest_path = os.path.join(dirname, _MANIFEST)
    manifest = None
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    dtypes = {n: e.get("dtype") for n, e in
              ((manifest or {}).get("vars") or {}).items()}
    blobs = {}
    if filename is not None or (manifest and manifest.get("filename")):
        fname = filename or manifest["filename"]
        with np.load(os.path.join(dirname, fname),
                     allow_pickle=False) as combined:
            wanted = {v.name.replace("/", "__"): v.name for v in vars_}
            for key, name in wanted.items():
                if key not in combined:
                    raise RuntimeError(
                        f"load: '{name}' missing from checkpoint")
                blobs[name] = combined[key]
    # two phases: read + validate EVERYTHING, then commit to the scope —
    # a shape mismatch on the Nth var must not leave vars 0..N-1 from the
    # checkpoint mixed with the scope's previous values (recovery walks
    # rely on a failed load leaving the scope untouched)
    staged = []
    for v in vars_:
        if blobs:
            arr = blobs[v.name]
        else:
            path = os.path.join(dirname, v.name.replace("/", "__") + ".npy")
            if not os.path.exists(path):
                raise RuntimeError(f"load: '{path}' not found")
            arr = np.load(path)
        if v.shape is not None and tuple(arr.shape) != tuple(v.shape) \
                and -1 not in (v.shape or ()):
            raise RuntimeError(
                f"load: shape mismatch for '{v.name}': checkpoint "
                f"{arr.shape} vs program {v.shape}")
        staged.append((v, arr))
    tensors = [(v.name, _to_tensor(arr, dtypes.get(v.name), device))
               for v, arr in staged]
    for name, t in tensors:
        scope.set_var(name, t)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    from .framework import default_main_program

    program = main_program or default_main_program()
    if vars is None:
        vars = _vars_of(program, predicate or (lambda v: v.persistable))
    _save_var_list(executor, dirname, vars, scope, filename)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    save_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter), filename=filename,
              scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    save_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable, filename=filename,
              scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    from .framework import default_main_program

    program = main_program or default_main_program()
    if vars is None:
        vars = _vars_of(program, predicate or (lambda v: v.persistable))
    _load_var_list(executor, dirname, vars, scope, filename)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter), filename=filename,
              scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable, filename=filename,
              scope=scope)


# ---------------------------------------------------------------------------
# Inference model export (reference io.py:965 prunes to feed/fetch + saves)
# ---------------------------------------------------------------------------

def _prune_for_inference(program: Program, feed_names, fetch_names) -> Program:
    """Keep only ops on the path from feeds to fetches (reference Prune,
    framework/prune.cc)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_arg_names):
            keep.append(op)
            needed.update(op.input_arg_names)
    block.ops = list(reversed(keep))
    used = set()
    for op in block.ops:
        used.update(op.input_arg_names)
        used.update(op.output_arg_names)
    used.update(feed_names)
    used.update(fetch_names)
    block.vars = {n: v for n, v in block.vars.items() if n in used}
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, scope=None):
    from .framework import default_main_program

    program = main_program or default_main_program()
    fetch_names = [t.name if isinstance(t, Variable) else t
                   for t in target_vars]
    pruned = _prune_for_inference(program, feeded_var_names, fetch_names)
    _ensure_dir(dirname)
    model_filename = model_filename or "__model__"
    with open(os.path.join(dirname, model_filename), "w") as f:
        json.dump({"program": pruned.to_dict(),
                   "feed_names": list(feeded_var_names),
                   "fetch_names": fetch_names}, f)
    params = [v for v in pruned.list_vars() if v.persistable]
    _save_var_list(executor, os.path.join(dirname, "params"), params, scope,
                   params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    model_filename = model_filename or "__model__"
    with open(os.path.join(dirname, model_filename)) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    params = [v for v in program.list_vars() if v.persistable]
    _load_var_list(executor, os.path.join(dirname, "params"), params, scope,
                   params_filename)
    fetch_vars = [program.global_block.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


# full-checkpoint helpers: step/meta and crash safety
# (resilience.checkpoint holds the failure model and the manifest schema)
def save_checkpoint(executor, dirname, main_program=None, scope=None,
                    meta: dict = None, mesh=None):
    """Crash-safe checkpoint write: everything lands in a temp sibling dir
    first (``.<name>.tmp.<pid>``), the manifest gains per-file sha256 +
    framework version, files and directories are fsynced, and only then
    is the temp dir atomically renamed into place. A process killed at ANY
    point leaves either the complete previous checkpoint or the complete
    new one at ``dirname`` — never a torn mixture. The torn temp dir a
    kill leaves behind is ignored by recovery
    (``resilience.iter_serials``) and overwritten by the next save.

    ``mesh`` (the sharded format, manifest format_version 2) needs the
    sharded half of ``resilience/distributed.py`` and raises
    ``NotImplementedError``."""
    from .resilience import checkpoint as _rck
    from .resilience.faults import fault_point

    if mesh is not None:
        raise NotImplementedError(
            "save_checkpoint(mesh=...): the sharded checkpoint (manifest "
            "format_version 2) needs the sharded half of "
            "resilience/distributed.py, which the port does not have yet")
    dirname = os.path.normpath(dirname)
    if os.path.exists(dirname) and not os.path.isdir(dirname):
        raise ValueError(
            f"save_checkpoint: '{dirname}' already exists as a FILE — "
            f"checkpoints are directories")
    parent = os.path.dirname(os.path.abspath(dirname))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(dirname)}.tmp."
                               f"{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    try:
        save_persistables(executor, tmp, main_program,
                          filename="ckpt.npz", scope=scope)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta or {}, f)
            f.flush()
            os.fsync(f.fileno())
        # blobs are on disk, manifest/rename have not happened: a kill here
        # (FLAGS_fault_plan site) is the worst case the design must survive
        fault_point("ckpt_write")
        _rck.finalize_manifest(tmp)
        _rck.atomic_replace_dir(tmp, dirname)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_checkpoint(executor, dirname, main_program=None, scope=None,
                    verify: bool = True) -> dict:
    """Verify the checkpoint's manifest (per-file sha256, format version)
    BEFORE loading a single byte, then restore persistables and return the
    meta dict. A torn or tampered checkpoint raises
    ``resilience.CheckpointCorruptError`` with a PT6xx code naming what
    failed — it never half-loads into the scope. ``verify=False`` skips
    integrity checks (for checkpoints written without a manifest). A
    sharded (format_version 2) checkpoint raises ``NotImplementedError``."""
    from .resilience import checkpoint as _rck

    manifest = None
    if verify:
        manifest = _rck.verify_checkpoint(dirname)
    else:
        mpath = os.path.join(dirname, _rck.MANIFEST_NAME)
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
            except (ValueError, OSError):
                manifest = None
    if isinstance(manifest, dict) and manifest.get("sharding") is not None:
        raise NotImplementedError(
            f"load_checkpoint: '{dirname}' is a sharded checkpoint "
            f"(format_version 2), which needs the sharded half of "
            f"resilience/distributed.py; the port does not have it yet")
    load_persistables(executor, dirname, main_program,
                      filename="ckpt.npz", scope=scope)
    meta_path = os.path.join(dirname, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


# reference fluid.io re-exports the data pipeline (python/paddle/fluid/io.py
# pulls DataLoader/PyReader from reader.py)
from .reader import DataLoader, PyReader  # noqa: E402,F401
