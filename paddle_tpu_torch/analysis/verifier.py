"""The verifier's shared helpers (counterpart of part of
``paddle_tpu/analysis/verifier.py``): the names liveness and epilogue
fusion use. The four verifier passes (schema, dataflow, lowerability,
shape replay) arrive with a later slice of the port."""
from __future__ import annotations

from typing import Dict, Set

__all__ = ["EMPTY"]

EMPTY = "@EMPTY@"  # lowering.EMPTY_VAR_NAME (no import: keep analysis light)


def _site(op) -> str:
    return op.attrs.get("op_callstack", "") or ""


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
