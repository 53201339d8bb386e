"""Multi-pass static program verifier (counterpart of
``paddle_tpu/analysis/verifier.py``, with its passes, codes and messages).

Passes over a ``Program``:

1. **schema**       — every op's slots and attrs checked against its OpDef
                      in the port's registry (PT10x / PT107).
2. **dataflow**     — def-before-use per block with parent-block recursion,
                      dead writes, dangling outputs, uninitialized reads
                      (PT20x).
3. **lowerability** — ops that cannot run: no op rule, grad ops of
                      non-differentiable forwards, random ops under
                      ``torch.use_deterministic_algorithms`` (PT30x).
4. **shape_replay** — re-runs infer_shape/auto_infer_shape over each block
                      and flags drift against the recorded var metadata
                      (PT40x). Catches post-append mutations that skipped
                      ``Operator.set_attr``.
5. **liveness**     — dataflow liveness + effect classification (see
                      ``analysis/liveness.py``): donation-unsafe fetches,
                      write-after-fetch hazards, dead ops/vars, persistables
                      rebound inside sub-blocks (PT50x).

An op type the port does not register yet (a program loaded from the JAX
package's JSON) is PT100 in the schema pass; the lowerability pass then
skips it, as the reference does. Only error-severity findings gate
execution (see ``check_program``, ``FLAGS_check_program``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from ..core import registry
from .diagnostics import (Diagnostic, ProgramVerificationError, Severity,
                          format_diagnostics)

__all__ = ["verify_program", "check_program", "DEFAULT_PASSES", "EMPTY"]

DEFAULT_PASSES = ("schema", "dataflow", "lowerability", "shape_replay",
                  "liveness")

EMPTY = "@EMPTY@"  # lowering.EMPTY_VAR_NAME (no import: keep analysis light)

# attrs stamped by the framework itself, never part of an op schema
_FRAMEWORK_ATTRS = frozenset({"op_callstack", "op_namescope", "op_device"})


def _is_internal_attr(name: str) -> bool:
    return name.startswith("__") or name in _FRAMEWORK_ATTRS


def _site(op) -> str:
    return op.attrs.get("op_callstack", "") or ""


def _is_auto_grad(op) -> bool:
    return (op.type.endswith("_grad") and not registry.has_op(op.type)
            and registry.has_op(op.attrs.get("__fwd_type__", op.type[:-5])))


def _fwd_type(op) -> str:
    return op.attrs.get("__fwd_type__", op.type[:-5])


# ---------------------------------------------------------------------------
# pass 1: schema conformance
# ---------------------------------------------------------------------------

def _check_schema(program, diags: List[Diagnostic]) -> None:
    for blk in program.blocks:
        for oi, op in enumerate(blk.ops):
            if op.type in ("feed", "fetch"):
                continue
            if not registry.has_op(op.type):
                if op.type.endswith("_grad"):
                    _check_grad_op_schema(blk, oi, op, diags)
                else:
                    diags.append(Diagnostic(
                        "PT100", f"op '{op.type}' is not registered",
                        blk.idx, oi, op.type, _site(op)))
                continue
            opdef = registry.get_op_def(op.type)
            declared_in = {s.name: s for s in opdef.inputs}
            declared_out = {s.name: s for s in opdef.outputs}
            for sname, spec in declared_in.items():
                names = [n for n in op.inputs.get(sname, ()) if n != EMPTY]
                if not spec.optional and not names:
                    diags.append(Diagnostic(
                        "PT101",
                        f"op '{op.type}': required input slot '{sname}' "
                        f"absent or empty", blk.idx, oi, op.type, _site(op)))
                if not spec.duplicable and len(names) > 1:
                    diags.append(Diagnostic(
                        "PT107",
                        f"op '{op.type}': input slot '{sname}' is not "
                        f"duplicable but holds {len(names)} vars",
                        blk.idx, oi, op.type, _site(op)))
            for sname in op.inputs:
                if sname not in declared_in:
                    diags.append(Diagnostic(
                        "PT102",
                        f"op '{op.type}': input slot '{sname}' is not in "
                        f"the schema (declares {sorted(declared_in)})",
                        blk.idx, oi, op.type, _site(op)))
            for sname, spec in declared_out.items():
                names = [n for n in op.outputs.get(sname, ()) if n != EMPTY]
                if not spec.optional and not names:
                    diags.append(Diagnostic(
                        "PT103",
                        f"op '{op.type}': required output slot '{sname}' "
                        f"absent or empty", blk.idx, oi, op.type, _site(op)))
                if not spec.duplicable and len(names) > 1:
                    diags.append(Diagnostic(
                        "PT107",
                        f"op '{op.type}': output slot '{sname}' is not "
                        f"duplicable but holds {len(names)} vars",
                        blk.idx, oi, op.type, _site(op)))
            for sname in op.outputs:
                if sname not in declared_out:
                    diags.append(Diagnostic(
                        "PT104",
                        f"op '{op.type}': output slot '{sname}' is not in "
                        f"the schema (declares {sorted(declared_out)})",
                        blk.idx, oi, op.type, _site(op)))
            for aname, aspec in opdef.attrs.items():
                if aspec.required and aname not in op.attrs:
                    diags.append(Diagnostic(
                        "PT105",
                        f"op '{op.type}': required attr '{aname}' missing",
                        blk.idx, oi, op.type, _site(op)))
            for aname in op.attrs:
                if aname not in opdef.attrs and not _is_internal_attr(aname):
                    diags.append(Diagnostic(
                        "PT106",
                        f"op '{op.type}': attr '{aname}' is not in the "
                        f"schema", blk.idx, oi, op.type, _site(op)))


def _check_grad_op_schema(blk, oi, op, diags: List[Diagnostic]) -> None:
    """Auto '<fwd>_grad' ops (backward.py _make_grad_op layout): inputs are
    forward slots, '__out__<slot>' echoes and '<slot>@GRAD' cotangents;
    outputs are '<slot>@GRAD'. Anything else is a malformed grad desc."""
    fwd = _fwd_type(op)
    if not registry.has_op(fwd):
        diags.append(Diagnostic(
            "PT100",
            f"grad op '{op.type}': forward op '{fwd}' is not registered",
            blk.idx, oi, op.type, _site(op)))
        return
    fwd_def = registry.get_op_def(fwd)
    fwd_in = {s.name for s in fwd_def.inputs}
    fwd_out = {s.name for s in fwd_def.outputs}
    for sname in op.inputs:
        base = sname[:-5] if sname.endswith("@GRAD") else None
        ok = (sname in fwd_in
              or (sname.startswith("__out__") and sname[7:] in fwd_out)
              or (base is not None and base in fwd_out))
        if not ok:
            diags.append(Diagnostic(
                "PT102",
                f"grad op '{op.type}': input slot '{sname}' matches no "
                f"forward slot of '{fwd}'", blk.idx, oi, op.type, _site(op)))
    for sname in op.outputs:
        if not (sname.endswith("@GRAD") and sname[:-5] in fwd_in):
            diags.append(Diagnostic(
                "PT104",
                f"grad op '{op.type}': output slot '{sname}' is not the "
                f"@GRAD of a forward input of '{fwd}'",
                blk.idx, oi, op.type, _site(op)))


# ---------------------------------------------------------------------------
# pass 2: dataflow
# ---------------------------------------------------------------------------

def _raw_attr_var_names(op) -> Set[str]:
    """Raw (sub-block) ops name vars through attrs (step_input_names etc.);
    count those as reads so they don't show up dead."""
    names: Set[str] = set()
    for v in op.attrs.values():
        if isinstance(v, str):
            names.add(v)
        elif isinstance(v, (list, tuple)):
            names.update(n for n in v if isinstance(n, str))
    return names


def _block_reads(program, bidx: int, memo: Dict[int, Set[str]]) -> Set[str]:
    """All var names read by block ``bidx``'s ops, including nested
    sub-blocks (parent-block recursion for the raw control-flow ops)."""
    if bidx in memo:
        return memo[bidx]
    memo[bidx] = set()  # cycle guard
    reads: Set[str] = set()
    blk = program.blocks[bidx]
    for op in blk.ops:
        reads.update(n for n in op.input_arg_names if n != EMPTY)
        sub = op.attrs.get("sub_block")
        if isinstance(sub, int) and 0 <= sub < len(program.blocks):
            reads.update(_block_reads(program, sub, memo))
            reads.update(_raw_attr_var_names(op))
    memo[bidx] = reads
    return reads


def _persistable_names(program) -> Set[str]:
    return {v.name for blk in program.blocks for v in blk.vars.values()
            if v.persistable}


def _check_dataflow(program, diags: List[Diagnostic],
                    fetch_names: Sequence[str]) -> None:
    read_memo: Dict[int, Set[str]] = {}
    persistable = _persistable_names(program)
    produced_by_block: Dict[int, Set[str]] = {}
    for blk in program.blocks:
        produced_by_block[blk.idx] = {
            n for op in blk.ops for n in op.output_arg_names if n != EMPTY}

    global_reads: Set[str] = set()
    for blk in program.blocks:
        global_reads.update(_block_reads(program, blk.idx, read_memo))

    for blk in program.blocks:
        # names available before the block runs: feeds, persistables, and —
        # for sub-blocks — everything the ancestor context can supply (the
        # raw op seeds the env; ordering across blocks is runtime's job)
        avail: Set[str] = set(persistable)
        avail.update(v.name for v in blk.vars.values() if v.is_data)
        anc = blk.parent_block
        block_local_produced = produced_by_block[blk.idx]
        while anc is not None:
            avail.update(anc.vars.keys())
            avail.update(produced_by_block[anc.idx])
            anc = anc.parent_block
        if blk.parent_idx >= 0:
            # sub-block vars never produced locally are seeded by the owning
            # raw op's lowering (while/recurrent step slices)
            avail.update(n for n in blk.vars
                         if n not in block_local_produced)

        first_producer: Dict[str, int] = {}
        for oi, op in enumerate(blk.ops):
            for n in op.output_arg_names:
                if n != EMPTY:
                    first_producer.setdefault(n, oi)

        produced: Set[str] = set()
        last_write: Dict[str, int] = {}
        read_since_write: Set[str] = set()
        for oi, op in enumerate(blk.ops):
            if op.type in ("feed", "fetch"):
                continue
            op_reads = {n for n in op.input_arg_names if n != EMPTY}
            sub = op.attrs.get("sub_block")
            if isinstance(sub, int) and 0 <= sub < len(program.blocks):
                op_reads.update(_block_reads(program, sub, read_memo))
                op_reads.update(_raw_attr_var_names(op))
            for n in op_reads:
                read_since_write.add(n)
                if n in produced or n in avail:
                    continue
                if n in first_producer and first_producer[n] > oi:
                    diags.append(Diagnostic(
                        "PT200",
                        f"op '{op.type}' reads '{n}' which is only produced "
                        f"later (op {first_producer[n]}) in block {blk.idx}",
                        blk.idx, oi, op.type, _site(op)))
                else:
                    diags.append(Diagnostic(
                        "PT201",
                        f"op '{op.type}' reads '{n}' which no op produces "
                        f"and no feed/persistable supplies (runtime will "
                        f"require it pre-set in the scope)",
                        blk.idx, oi, op.type, _site(op)))
                # report each name once per block
                avail.add(n)
            for n in op.output_arg_names:
                if n == EMPTY:
                    continue
                if (n in last_write and n not in read_since_write
                        and n not in persistable):
                    diags.append(Diagnostic(
                        "PT202",
                        f"op '{op.type}' overwrites '{n}' whose previous "
                        f"write (op {last_write[n]}) was never read",
                        blk.idx, oi, op.type, _site(op)))
                last_write[n] = oi
                read_since_write.discard(n)
                produced.add(n)

        # dangling outputs: produced here, read nowhere, not fetched
        for oi, op in enumerate(blk.ops):
            if op.type in ("feed", "fetch"):
                continue
            for n in op.output_arg_names:
                if (n != EMPTY and n not in global_reads
                        and n not in fetch_names and n not in persistable):
                    diags.append(Diagnostic(
                        "PT203",
                        f"op '{op.type}' output '{n}' is never read, not "
                        f"fetched and not persistable",
                        blk.idx, oi, op.type, _site(op)))


# ---------------------------------------------------------------------------
# pass 3: lowerability
# ---------------------------------------------------------------------------

def _check_lowerability(program, diags: List[Diagnostic]) -> None:
    import torch

    # the counterpart of the reference's FLAGS_cudnn_deterministic
    deterministic = torch.are_deterministic_algorithms_enabled()
    for blk in program.blocks:
        for oi, op in enumerate(blk.ops):
            if op.type in ("feed", "fetch"):
                continue
            if _is_auto_grad(op):
                fwd_def = registry.get_op_def(_fwd_type(op))
                if fwd_def.grad is None and fwd_def.grad_lower is None:
                    diags.append(Diagnostic(
                        "PT301",
                        f"grad op '{op.type}': forward '{fwd_def.type}' "
                        f"declares grad=None (non-differentiable); the "
                        f"generic vjp lowering may be meaningless",
                        blk.idx, oi, op.type, _site(op)))
                continue
            if not registry.has_op(op.type):
                continue  # PT100 already reported by the schema pass
            opdef = registry.get_op_def(op.type)
            if opdef.lower is None:
                diags.append(Diagnostic(
                    "PT300",
                    f"op '{op.type}' has no lower rule — it cannot execute",
                    blk.idx, oi, op.type, _site(op)))
            if opdef.needs_rng and deterministic:
                diags.append(Diagnostic(
                    "PT302",
                    f"op '{op.type}' draws randomness but "
                    f"torch.use_deterministic_algorithms is on",
                    blk.idx, oi, op.type, _site(op)))


# ---------------------------------------------------------------------------
# pass 4: shape/dtype replay
# ---------------------------------------------------------------------------

def _check_shape_replay(program, diags: List[Diagnostic]) -> None:
    """Re-run each registered op's infer_shape in block order and compare
    against the recorded var metadata, then restore the snapshot. Drift
    means the program was mutated after append without re-inference (e.g.
    direct ``op.attrs[...] =`` writes). A generic ``<type>_grad`` op has
    no rule of its own and is skipped, as in the reference."""
    snapshot = {}
    for blk in program.blocks:
        for v in blk.vars.values():
            snapshot[(blk.idx, v.name)] = (v.shape, v.dtype)
    try:
        for blk in program.blocks:
            for oi, op in enumerate(blk.ops):
                if op.type in ("feed", "fetch") or not registry.has_op(
                        op.type):
                    continue
                before = {}
                for n in op.output_arg_names:
                    if n != EMPTY and blk.has_var(n):
                        v = blk.var(n)
                        before[n] = (v.shape, v.dtype)
                try:
                    op.infer_shape()
                except Exception:
                    continue  # dynamic/unsupported at build time
                for n, (old_shape, old_dtype) in before.items():
                    v = blk.var(n)
                    if (old_shape is not None and v.shape is not None
                            and tuple(old_shape) != tuple(v.shape)):
                        diags.append(Diagnostic(
                            "PT400",
                            f"op '{op.type}' output '{n}': recorded shape "
                            f"{tuple(old_shape)} but infer_shape replays "
                            f"{tuple(v.shape)}",
                            blk.idx, oi, op.type, _site(op)))
                    if old_dtype is not None and old_dtype != v.dtype:
                        diags.append(Diagnostic(
                            "PT401",
                            f"op '{op.type}' output '{n}': recorded dtype "
                            f"{old_dtype} but infer_shape replays {v.dtype}",
                            blk.idx, oi, op.type, _site(op)))
    finally:
        for blk in program.blocks:
            for v in blk.vars.values():
                old = snapshot.get((blk.idx, v.name))
                if old is not None:
                    v.shape, v.dtype = old


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _check_liveness_pass(program, diags: List[Diagnostic],
                         fetch_names: Sequence[str]) -> None:
    # lazy import: liveness.py imports helpers from this module
    from .liveness import check_liveness

    check_liveness(program, diags, fetch_names)


_PASS_FNS = {
    "schema": lambda p, d, f: _check_schema(p, d),
    "dataflow": _check_dataflow,
    "lowerability": lambda p, d, f: _check_lowerability(p, d),
    "shape_replay": lambda p, d, f: _check_shape_replay(p, d),
    "liveness": _check_liveness_pass,
}


def verify_program(program, fetch_names: Sequence[str] = (),
                   passes: Sequence[str] = DEFAULT_PASSES
                   ) -> List[Diagnostic]:
    """Run the static verifier; returns all findings (never raises).

    ``fetch_names`` suppresses PT203 for vars the caller will fetch.

    Routes through ``PassManager.run_pipeline`` over the default
    ``PassRegistry``: any registered analysis pass name (the PT700s/710s/
    720s/900s families and custom ``@register_pass`` passes) is accepted,
    each run lands ``pass_runs_total``/``pass_duration_seconds`` on the
    monitor registry, and passes sharing a dependency (liveness) compute
    it once. Raises ``KeyError`` on an unknown pass name.
    """
    from .pass_manager import default_pass_manager

    result = default_pass_manager().run_pipeline(
        program, passes, fetch_names=fetch_names, verify="none")
    return list(result.diagnostics)


def check_program(program, fetch_names: Sequence[str] = (),
                  passes: Sequence[str] = DEFAULT_PASSES) -> List[Diagnostic]:
    """verify_program + raise ProgramVerificationError on error findings.

    The executor's FLAGS_check_program pre-run hook runs these passes once
    per program version; warnings and infos pass through silently (inspect
    the return value to see them).
    """
    diags = verify_program(program, fetch_names, passes)
    if any(d.severity == Severity.ERROR for d in diags):
        raise ProgramVerificationError(diags)
    return diags
