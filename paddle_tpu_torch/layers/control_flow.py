"""Control-flow layer helpers (counterpart of
``paddle_tpu/layers/control_flow.py``). Only what the AMP decorator's
skip-update needs is ported: :func:`_block_io`. ``While``, ``Switch``,
``IfElse``, ``StaticRNN`` and the tensor arrays wait for a later slice."""
from __future__ import annotations

from typing import List

from ..lowering import EMPTY_VAR_NAME

__all__: List[str] = []


def _block_io(sub_block, parent_block):
    """(reads, writes): the vars a sub-block reads from, and writes to,
    its enclosing blocks, each in first-use order."""
    written_local: set = set()
    reads: List[str] = []
    writes: List[str] = []
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if n == EMPTY_VAR_NAME or n in written_local or n in reads:
                continue
            if n not in sub_block.vars and parent_block.has_var_recursive(n):
                reads.append(n)
        for n in op.output_arg_names:
            if n == EMPTY_VAR_NAME:
                continue
            if n in sub_block.vars:
                written_local.add(n)
            elif parent_block.has_var_recursive(n) and n not in writes:
                writes.append(n)
    return reads, writes
