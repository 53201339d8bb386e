"""AMP decorator: wrap an optimizer so training runs in bf16 with float32
master weights (counterpart of
``paddle_tpu/contrib/mixed_precision/decorator.py``; reference
decorator.py:27).

* No program rewrite: ``Program._amp_policy`` makes the interpreter cast
  a white-list op's inputs to bf16 where the op runs
  (``lowering.AmpPolicy``). Parameters and optimizer state never leave
  float32, so the master weights need no twin vars.
* Loss scaling is off by default: bf16 has float32's exponent range. With
  ``init_loss_scaling`` != 1 or ``use_dynamic_loss_scaling`` the loss is
  scaled, the gradients are checked and unscaled
  (``check_finite_and_unscale``), the scale follows
  ``update_loss_scaling``, and the whole update runs in a
  ``conditional_block`` on "all gradients finite", so an overflow step
  leaves parameters and optimizer state untouched.
"""
from __future__ import annotations

from typing import Optional

from ... import unique_name
from ...framework import (Variable, default_main_program,
                          default_startup_program, program_guard)
from ...lowering import AmpPolicy
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "decorate_program", "OptimizerWithMixedPrecision"]


def decorate_program(program, amp_lists=None, compute_dtype="bfloat16"):
    """Install the compute policy on ``program`` (the inference-side
    entry) and bump its version, so caches keyed on it miss. Returns the
    program."""
    lists = amp_lists or AutoMixedPrecisionLists()
    program._amp_policy = AmpPolicy(lists.white_list, lists.black_list,
                                    compute_dtype)
    program._bump_version()
    return program


def _create_persistable_scalar(name_hint, dtype, init_value):
    name = unique_name.generate(name_hint)
    main_block = default_main_program().global_block
    var = main_block.create_var(name=name, shape=(1,), dtype=dtype,
                                persistable=True, stop_gradient=True)
    startup = default_startup_program().global_block
    startup.create_var(name=name, shape=(1,), dtype=dtype, persistable=True)
    startup.append_op("fill_constant", outputs={"Out": name},
                      attrs={"shape": [1], "dtype": dtype,
                             "value": float(init_value)})
    return var


class OptimizerWithMixedPrecision:
    """Drop-in optimizer wrapper (reference decorator.py:27)."""

    def __init__(self, optimizer, amp_lists: AutoMixedPrecisionLists,
                 init_loss_scaling: float, use_dynamic_loss_scaling: bool,
                 incr_every_n_steps: int, decr_every_n_nan_or_inf: int,
                 incr_ratio: float, decr_ratio: float,
                 compute_dtype: str = "bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._compute_dtype = compute_dtype
        self._loss_scaling: Optional[Variable] = None
        self._found_inf: Optional[Variable] = None

    def get_loss_scaling(self) -> Optional[Variable]:
        return self._loss_scaling

    @property
    def _needs_scaling(self) -> bool:
        return self._use_dynamic_loss_scaling or self._init_loss_scaling != 1.0

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """Scale the loss, run the inner optimizer's backward, then
        unscale and check the gradients. Returns (params_grads,
        scaled_loss)."""
        from ... import layers

        program = loss.block.program
        decorate_program(program, self._amp_lists, self._compute_dtype)
        with program_guard(program, startup_program), \
                program._op_role_guard("backward"):
            if self._needs_scaling:
                self._loss_scaling = _create_persistable_scalar(
                    "loss_scaling", "float32", self._init_loss_scaling)
                scaled_loss = layers.elementwise_mul(loss, self._loss_scaling)
            else:
                scaled_loss = loss
            params_grads = self._optimizer.backward(
                scaled_loss, startup_program, parameter_list, no_grad_set,
                callbacks)
            if self._needs_scaling:
                self._append_unscale_ops(program, params_grads)
        return params_grads, scaled_loss

    def _append_unscale_ops(self, program, params_grads):
        block = program.global_block
        grad_names = [g.name for _, g in params_grads]
        self._found_inf = block.create_var(
            name=unique_name.generate("find_infinite_scale"),
            shape=(1,), dtype="bool", stop_gradient=True)
        block.append_op("check_finite_and_unscale",
                        inputs={"X": grad_names,
                                "Scale": self._loss_scaling.name},
                        outputs={"Out": grad_names,
                                 "FoundInfinite": self._found_inf.name})
        if self._use_dynamic_loss_scaling:
            good = _create_persistable_scalar("good_steps", "int32", 0)
            bad = _create_persistable_scalar("bad_steps", "int32", 0)
            block.append_op(
                "update_loss_scaling",
                inputs={"FoundInfinite": self._found_inf.name,
                        "PrevLossScaling": self._loss_scaling.name,
                        "InGoodSteps": good.name, "InBadSteps": bad.name},
                outputs={"LossScaling": self._loss_scaling.name,
                         "OutGoodSteps": good.name,
                         "OutBadSteps": bad.name},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio})

    def apply_gradients(self, params_grads):
        if self._found_inf is None:
            return self._optimizer.apply_gradients(params_grads)
        # skip-update: the whole update (accumulators and parameter
        # writes) runs in a conditional_block on "all gradients finite"
        from ...layers.control_flow import _block_io

        program = params_grads[0][0].block.program
        with program._op_role_guard("optimize"):
            parent = program.current_block()
            notinf = parent.create_var(
                name=unique_name.generate("amp_grads_finite"), shape=(1,),
                dtype="bool", stop_gradient=True)
            parent.append_op("logical_not", inputs={"X": self._found_inf.name},
                             outputs={"Out": notinf.name})
            sub = program._create_block()
            try:
                optimize_ops = self._optimizer.apply_gradients(params_grads)
            finally:
                program._rollback()
            reads, writes = _block_io(sub, parent)
            parent.append_op("conditional_block",
                             inputs={"Cond": [notinf.name], "Input": reads},
                             outputs={"Out": writes},
                             attrs={"sub_block": sub.idx})
        return optimize_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads, _ = self.backward(
            loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        with program_guard(program, startup_program):
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False, compute_dtype="bfloat16"):
    """Wrap ``optimizer`` for mixed precision (reference decorator.py:27
    ``decorate``): bf16 compute, loss scaling off unless asked for."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists or AutoMixedPrecisionLists(),
        init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        compute_dtype)
