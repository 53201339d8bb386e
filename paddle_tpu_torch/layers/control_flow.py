"""Control-flow layers: While, cond, Switch, IfElse, StaticRNN and the
tensor arrays (counterpart of ``paddle_tpu/layers/control_flow.py``;
reference python/paddle/fluid/layers/control_flow.py: While :697, Switch
:1052, IfElse :1327, StaticRNN :282, array_write/read :893/:1013).

Build-time only, and the same programs as the JAX package's: each
construct opens a sub-block, records the user's ops there, then appends
ONE structured op (``while`` / ``conditional_block`` / ``recurrent``) to
the parent; ``ops/control_flow.py`` interprets it (a host loop over the
sub-block, tensor arrays as fixed-capacity buffers inside a While).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

from .. import unique_name
from ..core.types import VarType
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper
from ..lowering import EMPTY_VAR_NAME

__all__ = ["While", "Switch", "IfElse", "StaticRNN", "create_array",
           "array_write", "array_read", "array_length", "cond",
           "tensor_array_to_tensor"]


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


class While:
    """A loop over a sub-block (reference control_flow.py:697). Usage:

        i = layers.fill_constant([1], 'int64', 0)
        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ...
            layers.increment(i)
            layers.assign(layers.less_than(i, n), cond)   # refresh cond

    ``max_len`` bounds the trip count and is the capacity of every tensor
    array carried through the loop (128 without it); differentiating the
    loop needs it."""

    def __init__(self, cond: Variable, is_test: bool = False, name=None,
                 max_len: int = 0):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test
        self.max_len = max_len

    @contextlib.contextmanager
    def block(self):
        program = self.cond_var.block.program
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        reads, writes = _block_io(sub, parent)
        if self.cond_var.name not in writes:
            raise ValueError(
                "While body never updates the condition variable "
                f"'{self.cond_var.name}' — the loop cannot terminate. "
                "Assign a fresh comparison to it inside the block.")
        parent.append_op(
            "while",
            inputs={"X": reads, "Condition": [self.cond_var.name]},
            outputs={"Out": writes},
            attrs={"sub_block": sub.idx, "is_test": self.is_test,
                   "max_len": self.max_len})


def cond(pred: Variable, true_fn=None, false_fn=None):
    """Functional if-else (the 2.x API): one conditional_block per branch,
    the results merged by ``where``; the branches' return vars must match
    in shape."""
    program = pred.block.program
    parent = program.current_block()
    helper = LayerHelper("cond")

    def run_branch(fn):
        sub = program._create_block()
        try:
            res = fn() if fn is not None else None
        finally:
            program._rollback()
        res_list = list(res) if isinstance(res, (list, tuple)) else (
            [] if res is None else [res])
        return sub, res_list

    true_sub, true_out = run_branch(true_fn)
    false_sub, false_out = run_branch(false_fn)
    true_reads, true_writes = _block_io(true_sub, parent)
    false_reads, false_writes = _block_io(false_sub, parent)
    if len(true_out) != len(false_out):
        raise ValueError("cond branches must return the same structure")

    # ONE conditional_block per branch. Out = branch return vars PLUS every
    # outer var the branch writes, so side effects (assigns to enclosing-
    # scope vars) survive; emitted even when the branch returns nothing:
    # the writes are the observable effect.
    t_outs = list(dict.fromkeys([v.name for v in true_out] + true_writes))
    f_outs = list(dict.fromkeys([v.name for v in false_out] + false_writes))
    if t_outs or true_sub.ops:
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [pred.name], "Input": true_reads},
            outputs={"Out": t_outs},
            attrs={"sub_block": true_sub.idx})
    if f_outs or false_sub.ops:
        notp = helper.create_variable_for_type_inference("bool")
        parent.append_op("logical_not", inputs={"X": pred},
                         outputs={"Out": notp})
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [notp.name], "Input": false_reads},
            outputs={"Out": f_outs},
            attrs={"sub_block": false_sub.idx})
    outs = []
    for tv, fv in zip(true_out, false_out):
        out = helper.create_variable_for_type_inference(tv.dtype)
        out.shape = tv.shape
        outs.append(out)
        parent.append_op("where", inputs={"Condition": pred, "X": tv,
                                          "Y": fv},
                         outputs={"Out": out})
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


class Switch:
    """reference control_flow.py:1052 — case chain, used by LR schedules.

        with Switch() as switch:
            with switch.case(cond1): assign(a, out)
            with switch.default():   assign(b, out)

    Build-time: each case body becomes a conditional_block gated on
    (its cond) AND (no earlier cond fired)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._prior: Optional[Variable] = None  # any earlier case matched

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextlib.contextmanager
    def case(self, condition: Variable):
        if self._prior is None:
            eff = condition
            new_prior = condition
        else:
            notp = self.helper.create_variable_for_type_inference("bool")
            self.helper.append_op("logical_not", inputs={"X": self._prior},
                                  outputs={"Out": notp})
            eff = self.helper.create_variable_for_type_inference("bool")
            self.helper.append_op("logical_and",
                                  inputs={"X": condition, "Y": notp},
                                  outputs={"Out": eff})
            new_prior = self.helper.create_variable_for_type_inference("bool")
            self.helper.append_op("logical_or",
                                  inputs={"X": self._prior, "Y": condition},
                                  outputs={"Out": new_prior})
        program = eff.block.program
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        reads, writes = _block_io(sub, parent)
        parent.append_op("conditional_block",
                         inputs={"Cond": [eff.name], "Input": reads},
                         outputs={"Out": writes},
                         attrs={"sub_block": sub.idx})
        self._prior = new_prior

    @contextlib.contextmanager
    def default(self):
        if self._prior is None:
            raise ValueError("Switch.default() before any case()")
        notp = self.helper.create_variable_for_type_inference("bool")
        self.helper.append_op("logical_not", inputs={"X": self._prior},
                              outputs={"Out": notp})
        program = notp.block.program
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        reads, writes = _block_io(sub, parent)
        parent.append_op("conditional_block",
                         inputs={"Cond": [notp.name], "Input": reads},
                         outputs={"Out": writes},
                         attrs={"sub_block": sub.idx})


class IfElse:
    """reference control_flow.py:1327. true_block/false_block write output
    vars; ifelse() returns the merged outputs."""

    def __init__(self, cond: Variable, name=None):
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._true_out: List[Variable] = []
        self._false_out: List[Variable] = []
        self._blocks = {}

    def input(self, x: Variable) -> Variable:
        return x  # dense tensors: no LoD split needed

    @contextlib.contextmanager
    def true_block(self):
        with self._branch(True):
            yield

    @contextlib.contextmanager
    def false_block(self):
        with self._branch(False):
            yield

    @contextlib.contextmanager
    def _branch(self, is_true: bool):
        program = self.cond.block.program
        parent = program.current_block()
        sub = program._create_block()
        self._current = (is_true, sub, parent)
        try:
            yield
        finally:
            program._rollback()
            del self._current
        self._blocks[is_true] = sub

    def output(self, *outs: Variable):
        is_true, _, _ = self._current
        (self._true_out if is_true else self._false_out).extend(outs)

    def __call__(self) -> List[Variable]:
        if len(self._true_out) != len(self._false_out):
            raise ValueError("IfElse branches produced different outputs")
        parent = self.cond.block.program.current_block()
        merged = []
        for tv, fv in zip(self._true_out, self._false_out):
            t_reads, _ = _block_io(self._blocks[True], parent)
            parent.append_op("conditional_block",
                             inputs={"Cond": [self.cond.name],
                                     "Input": t_reads},
                             outputs={"Out": [tv.name]},
                             attrs={"sub_block": self._blocks[True].idx})
            notp = self.helper.create_variable_for_type_inference("bool")
            parent.append_op("logical_not", inputs={"X": self.cond},
                             outputs={"Out": notp})
            f_reads, _ = _block_io(self._blocks[False], parent)
            parent.append_op("conditional_block",
                             inputs={"Cond": [notp.name],
                                     "Input": f_reads},
                             outputs={"Out": [fv.name]},
                             attrs={"sub_block": self._blocks[False].idx})
            out = self.helper.create_variable_for_type_inference(tv.dtype)
            out.shape = tv.shape
            parent.append_op("where",
                             inputs={"Condition": self.cond, "X": tv, "Y": fv},
                             outputs={"Out": out})
            merged.append(out)
        return merged


class StaticRNN:
    """An RNN over the SEQUENCE axis (reference control_flow.py:282).

    Inputs are TIME-MAJOR [seq, batch, ...] (reference convention);
    step_input yields the per-step slice [batch, ...]. One ``recurrent``
    op, differentiable end to end (its grad replays the steps).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._sub = None
        self._parent = None
        self._seq_len = None
        self._step_inputs = []   # (source_name, step_var)
        self._memories = []      # (pre_var, init_name, new_name_or_None)
        self._outputs = []       # step output vars
        self._status = "outside"

    @contextlib.contextmanager
    def step(self):
        program = default_main_program()
        self._parent = program.current_block()
        self._sub = program._create_block()
        self._status = "inside"
        try:
            yield
        finally:
            program._rollback()
            self._status = "done"
        self._append_recurrent_op()

    def _require_inside(self):
        if self._status != "inside":
            raise RuntimeError("StaticRNN ops must be inside rnn.step()")

    def step_input(self, x: Variable) -> Variable:
        self._require_inside()
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("step_input needs [seq, batch, ...] input")
        seq = x.shape[0]
        if self._seq_len is None:
            self._seq_len = seq
        step = self._sub.create_var(
            name=unique_name.generate("rnn_step_in"),
            shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._step_inputs.append((x.name, step))
        return step

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None, init_value=0.0,
               dtype="float32") -> Variable:
        self._require_inside()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            # constant init of [batch, *shape] built OUTSIDE the loop;
            # batch_ref is time-major so the batch is its dim 1 (reference
            # StaticRNN.memory also uses fill_constant_batch_size_like,
            # which keeps the shape inferable when batch is dynamic)
            from .tensor import fill_constant_batch_size_like

            program = default_main_program()
            cur = program.current_block_idx
            program.current_block_idx = self._parent.idx
            try:
                init = fill_constant_batch_size_like(
                    input=batch_ref, shape=[-1] + list(shape), dtype=dtype,
                    value=init_value, input_dim_idx=1, output_dim_idx=0)
            finally:
                program.current_block_idx = cur
        pre = self._sub.create_var(
            name=unique_name.generate("rnn_mem_pre"),
            shape=init.shape, dtype=init.dtype)
        self._memories.append([pre, init.name, None])
        return pre

    def update_memory(self, mem: Variable, new: Variable):
        self._require_inside()
        for m in self._memories:
            if m[0].name == mem.name:
                m[2] = new.name
                return
        raise ValueError(f"update_memory: '{mem.name}' is not a memory")

    def step_output(self, out: Variable):
        self._require_inside()
        self._outputs.append(out)

    def output(self, *outs: Variable):
        for o in outs:
            self.step_output(o)

    def _append_recurrent_op(self):
        if not self._outputs:
            raise ValueError("StaticRNN produced no step_output")
        for m in self._memories:
            if m[2] is None:
                raise ValueError(
                    f"memory '{m[0].name}' never update_memory'd")
        reads, _ = _block_io(self._sub, self._parent)
        source_names = [s for s, _ in self._step_inputs]
        init_names = [m[1] for m in self._memories]
        inner = {v.name for _, v in self._step_inputs}
        inner |= {m[0].name for m in self._memories}
        param_names = [n for n in reads
                       if n not in source_names and n not in init_names]
        out_vars = []
        for o in self._outputs:
            ov = self._parent.create_var(
                name=unique_name.generate("rnn_out"),
                shape=(self._seq_len,) + tuple(o.shape)
                if o.shape else None,
                dtype=o.dtype)
            out_vars.append(ov)
        self._out_vars = out_vars
        self._parent.append_op(
            "recurrent",
            inputs={"Inputs": source_names, "InitStates": init_names,
                    "Params": param_names},
            outputs={"Outputs": [v.name for v in out_vars]},
            attrs={"sub_block": self._sub.idx,
                   "step_input_names": [v.name for _, v in self._step_inputs],
                   "pre_memory_names": [m[0].name for m in self._memories],
                   "new_memory_names": [m[2] for m in self._memories],
                   "step_output_names": [o.name for o in self._outputs]})

    def __call__(self):
        outs = self._out_vars
        return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# tensor arrays (reference array_write :893 / array_read :1013)
# ---------------------------------------------------------------------------

def create_array(dtype="float32") -> Variable:
    helper = LayerHelper("create_array")
    arr = helper.block.create_var(
        name=unique_name.generate("array"), dtype=dtype,
        type=VarType.LOD_TENSOR_ARRAY, shape=(0,), stop_gradient=True)
    helper.append_op("create_array", outputs={"Out": arr},
                     attrs={"dtype": dtype})
    return arr


def array_write(x: Variable, i: Variable, array: Optional[Variable] = None
                ) -> Variable:
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op("write_to_array",
                     inputs={"X": x, "I": i, "Array": array},
                     outputs={"Out": array})
    return array


def array_read(array: Variable, i: Variable) -> Variable:
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("read_from_array", inputs={"X": array, "I": i},
                     outputs={"Out": out})
    return out


def array_length(array: Variable) -> Variable:
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", True)
    out.shape = (1,)
    helper.append_op("lod_array_length", inputs={"X": array},
                     outputs={"Out": out})
    return out


def tensor_array_to_tensor(input: Variable, axis=0, name=None):
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("tensor_array_to_tensor", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out
