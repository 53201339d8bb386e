"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``): ``minimize`` =
``append_backward`` + ``apply_gradients``, which creates the learning-rate
var and the per-parameter accumulators (persistable, initialised by
``fill_constant`` in the startup program) and appends one update op per
parameter under the optimize role.

SGD, Momentum and Adam are ported, with the global gradient clip
(``clip.set_gradient_clip``) and then weight decay (``regularization``
or a parameter's ``ParamAttr.regularizer``, ``regularizer.py``) appended
before the update ops as the JAX package does, and the
``RecomputeOptimizer`` wrapper (gradient checkpointing at user-named
checkpoints, ``ops/recompute.py``); the other optimizers wait for a
later slice. ``apply_gradients`` appends to the
program's current block, so a wrapper (the AMP skip-update) can run the
whole update inside a sub-block.
"""
from __future__ import annotations

from typing import Dict, Optional

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import (Parameter, Variable, default_main_program,
                        default_startup_program, program_guard)
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGDOptimizer", "SGD", "MomentumOptimizer",
           "Momentum", "AdamOptimizer", "Adam", "RecomputeOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._learning_rate_var: Optional[Variable] = None
        self.type = "optimizer"

    # -- learning rate ---------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        if self._learning_rate_var is not None:
            return
        name = unique_name.generate("learning_rate")
        self._learning_rate_var = \
            default_main_program().global_block.create_var(
                name=name, shape=(1,), dtype="float32", persistable=True,
                stop_gradient=True)
        startup = default_startup_program().global_block
        startup.create_var(name=name, shape=(1,), dtype="float32",
                           persistable=True)
        startup.append_op("fill_constant", outputs={"Out": name},
                          attrs={"shape": [1], "dtype": "float32",
                                 "value": float(self._learning_rate)})

    def _create_param_lr(self, param_and_grad):
        mult = (param_and_grad[0].optimize_attr or {}).get("learning_rate",
                                                            1.0)
        if mult == 1.0:
            return self._learning_rate_var
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference("float32", True)
        helper.append_op("scale", inputs={"X": self._learning_rate_var},
                         outputs={"Out": out}, attrs={"scale": float(mult)})
        return out

    # -- accumulators ----------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter, dtype=None,
                         fill_value=0.0, shape=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate(f"{name}_{param.name}")
        var = default_main_program().global_block.create_var(
            name=var_name, shape=tuple(shape), dtype=dtype, persistable=True,
            stop_gradient=True)
        var.is_optimizer_state = True
        startup = default_startup_program().global_block
        startup.create_var(name=var_name, shape=tuple(shape), dtype=dtype,
                           persistable=True)
        startup.append_op("fill_constant", outputs={"Out": var_name},
                          attrs={"shape": shape, "dtype": dtype,
                                 "value": float(fill_value)})
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter):
        return self._accumulators[name][param.name]

    # -- hooks of the subclasses -----------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- public API ------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        program = params_grads[0][0].block.program
        with program_guard(program), program._op_role_guard("optimize"):
            block = program.current_block()
            params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            self._create_global_learning_rate()
            self._create_accumulators(block, [pg[0] for pg in params_grads])
            return [self._append_optimize_op(block, pg)
                    for pg in params_grads]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        with program_guard(program, startup_program):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        vel = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": vel,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": vel},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class RecomputeOptimizer:
    """Gradient checkpointing (reference optimizer.py:3074
    RecomputeOptimizer, backward.py:555
    _append_backward_ops_with_checkpoints_).

    Before the backward is appended, forward ops up to each user checkpoint
    collapse into ``recompute_segment`` ops: activations between
    checkpoints are not kept across the forward/backward gap; the
    segment's grad op rebuilds them from the checkpoint tensors (see
    ``ops/recompute.py``)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        if not isinstance(checkpoints, (list, tuple)):
            raise TypeError("checkpoints must be a list of Variables/names")
        self._checkpoints = list(checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        from .ops.recompute import insert_recompute_segments

        if self._checkpoints:
            insert_recompute_segments(loss, self._checkpoints)
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        with program_guard(program, startup_program):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self._optimizer.apply_gradients(params_grads)
        return optimize_ops, params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
