"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``): ``minimize`` =
``append_backward`` + ``apply_gradients``, which creates the learning-rate
var and the per-parameter accumulators (persistable, initialised by
``fill_constant`` in the startup program) and appends one update op per
parameter under the optimize role.

Every optimizer of the JAX package is ported: SGD, Momentum,
LarsMomentum, Adagrad, DecayedAdagrad, Adam, AdamW, Lamb, Adamax,
Adadelta, RMSProp and Ftrl, with the global gradient clip
(``clip.set_gradient_clip``) and then weight decay (``regularization``
or a parameter's ``ParamAttr.regularizer``, ``regularizer.py``) appended
before the update ops as the JAX package does; the averagers
(``ExponentialMovingAverage``, ``ModelAverage``) and the wrappers
(``LookaheadOptimizer``, ``GradientMergeOptimizer`` with its
``PipelineOptimizer`` form, ``RecomputeOptimizer``: gradient
checkpointing at user-named checkpoints, ``ops/recompute.py``).
``DGCMomentumOptimizer`` refuses, as in the JAX package. The learning
rate is a float or a Variable (a schedule of
``layers.learning_rate_scheduler``). ``apply_gradients`` appends to the
program's current block, so a wrapper (the AMP skip-update) can run the
whole update inside a sub-block. Inside ``dygraph.guard()``, ``minimize``
is the eager update (``_dygraph_minimize``): the same registry update
rules run at once on each parameter's ``_grad``, after the global clip and
weight decay, with per-instance state keyed by the parameter's ``uid``
and one learning-rate tensor a step for each dtype; SGD, Momentum, Adam,
AdamW and Lamb have it, the others refuse as in the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import (Parameter, Variable, default_main_program,
                        default_startup_program, program_guard)
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "AdamW", "DecayedAdagrad",
    "Adadelta", "RMSProp", "Ftrl", "Lamb", "LarsMomentum",
    "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "DecayedAdagradOptimizer", "AdadeltaOptimizer",
    "RMSPropOptimizer", "FtrlOptimizer", "LambOptimizer",
    "LarsMomentumOptimizer", "ExponentialMovingAverage", "ModelAverage",
    "LookaheadOptimizer", "RecomputeOptimizer", "PipelineOptimizer",
    "GradientMergeOptimizer", "DGCMomentumOptimizer",
]


def _persistable_pair(name, shape, dtype, startup_op):
    """``name`` persistable in the main program's global block and in the
    startup program, initialised there by ``startup_op(block, name)``."""
    var = default_main_program().global_block.create_var(
        name=name, shape=tuple(shape), dtype=dtype, persistable=True,
        stop_gradient=True)
    startup = default_startup_program().global_block
    startup.create_var(name=name, shape=tuple(shape), dtype=dtype,
                       persistable=True)
    startup_op(startup, name)
    return var


def _fill(shape, dtype, value):
    def op(startup, name):
        startup.append_op("fill_constant", outputs={"Out": name},
                          attrs={"shape": list(shape), "dtype": dtype,
                                 "value": value})
    return op


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._eager_accumulators: Dict[int, dict] = {}  # dygraph-mode state
        self._learning_rate_var: Optional[Variable] = None
        self.type = "optimizer"

    # -- learning rate ---------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        if self._learning_rate_var is not None:
            return
        self._learning_rate_var = _persistable_pair(
            unique_name.generate("learning_rate"), (1,), "float32",
            _fill((1,), "float32", float(self._learning_rate)))

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
        var = _persistable_pair(unique_name.generate(f"{name}_{param.name}"),
                                shape, dtype,
                                _fill(shape, dtype, float(fill_value)))
        var.is_optimizer_state = True
        if (getattr(param, "is_distributed", False)
                and list(shape[:1]) == list(param.shape[:1])):
            # a sparse table's row-shaped accumulators carry its tag
            var.is_distributed = True
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter):
        return self._accumulators[name][param.name]

    # -- hooks of the subclasses -----------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass

    # -- public API ------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

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
            optimize_ops = [self._append_optimize_op(block, pg)
                            for pg in params_grads]
            self._finish_update(block, params_grads)
        return optimize_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .dygraph import base as dy

        if dy.in_dygraph_mode():
            return self._dygraph_minimize(loss, parameter_list)
        program = loss.block.program
        with program_guard(program, startup_program):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # -- dygraph (eager) path --------------------------------------------
    def _dygraph_minimize(self, loss, parameter_list=None):
        """Apply the update rule eagerly on (param, param._grad) pairs
        (reference dygraph minimize: optimizer ops run at once on the grad
        twins), through the same registry rules as the static path. Call
        loss.backward() first. Each parameter is rebound to its update,
        so no graph recorded before sees a write."""
        from .core import registry
        from .lowering import LowerCtx

        if parameter_list is None:
            raise ValueError(
                "dygraph minimize needs parameter_list (e.g. "
                "model.parameters()); the tape does not own the params")
        if type(self)._eager_slots is Optimizer._eager_slots and \
                self.type not in ("sgd",):
            raise NotImplementedError(
                f"{type(self).__name__} has no eager (dygraph) update path "
                f"yet — supported: SGD, Momentum, Adam/AdamW/Lamb")
        params = [p for p in parameter_list if p._grad is not None]
        if not params:
            raise RuntimeError(
                "no gradients found — call loss.backward() before minimize")
        rule = registry.get_op_def(self.type).lower
        attrs = self._eager_attrs()
        with torch.no_grad():
            clipped = self._eager_clip_grads(params)
            lr = self._current_lr()
            # one learning-rate tensor a step for each (dtype, device),
            # shared by the parameters (not one host copy each)
            lr_t: Dict[tuple, torch.Tensor] = {}
            for p in params:
                # static-path order: clip first, then fold the weight
                # decay into the clipped grad
                base_grad = clipped[id(p)] if clipped is not None \
                    else p._grad
                grad = self._eager_regularized_grad(p, base_grad)
                key = (p.value.dtype, p.value.device)
                if key not in lr_t:
                    lr_t[key] = torch.tensor([lr], dtype=key[0],
                                             device=key[1])
                ins = {"Param": [p.value.detach()], "Grad": [grad],
                       "LearningRate": [lr_t[key]]}
                for k, v in self._eager_slots(p).items():
                    ins[k] = [v]
                outs = rule(LowerCtx(p.value.device), ins, attrs)
                p.set_value(outs["ParamOut"][0])
                self._eager_store(p, outs)
        return params, [(p, p._grad) for p in params]

    def _eager_clip_grads(self, params):
        """The global clip (``set_gradient_clip``) applied eagerly, as
        ``append_gradient_clip_ops`` does in a program: ``{id(p): grad}``,
        or None when no clip is installed."""
        from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                           GradientClipByValue, _clip_attr)

        clip = _clip_attr.get("__global__")
        if clip is None:
            return None
        grads = {id(p): p._grad for p in params}
        if isinstance(clip, GradientClipByValue):
            return {k: torch.clamp(g, clip.min, clip.max)
                    for k, g in grads.items()}
        if isinstance(clip, GradientClipByNorm):
            out = {}
            for k, g in grads.items():
                norm = torch.sqrt(torch.sum(torch.square(g)))
                s = torch.clamp(clip.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
                out[k] = g * s
            return out
        if isinstance(clip, GradientClipByGlobalNorm):
            total = sum(torch.sum(torch.square(g)) for g in grads.values())
            gnorm = torch.sqrt(total)
            scale = clip.clip_norm / torch.clamp(gnorm, min=clip.clip_norm)
            return {k: g * scale for k, g in grads.items()}
        raise NotImplementedError(
            f"dygraph clip for {type(clip).__name__}")

    def _eager_regularized_grad(self, p, g=None):
        """L1/L2 weight decay folded into the grad, as
        ``append_regularization_ops`` does in a program."""
        from .regularizer import L1DecayRegularizer, L2DecayRegularizer

        g = p._grad if g is None else g
        reg = self.regularization
        if reg is None:
            return g
        if isinstance(reg, L2DecayRegularizer):
            return g + reg._coeff * p.value.detach()
        if isinstance(reg, L1DecayRegularizer):
            return g + reg._coeff * torch.sign(p.value.detach())
        raise NotImplementedError(
            f"dygraph regularization for {type(reg).__name__}")

    def _current_lr(self) -> float:
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        lr = self._learning_rate
        if isinstance(lr, LearningRateDecay):
            return lr()  # evaluates the current rate, advances step_num
        if isinstance(lr, Variable):
            raise TypeError("dygraph mode needs a float learning rate or a "
                            "dygraph LearningRateDecay scheduler")
        return float(lr)

    def _eager_state(self, p) -> dict:
        # per optimizer instance and by the VarBase's stable uid (an id()
        # could be recycled after GC and hand a new parameter a dead
        # one's moments)
        return self._eager_accumulators.setdefault(p.uid, {})

    def _eager_slots(self, p) -> dict:
        """Extra input slots (accumulators) of the rule; default none."""
        return {}

    def _eager_store(self, p, outs) -> None:
        """Keep the accumulator outputs after the update; default none."""

    def _eager_attrs(self) -> dict:
        return {}


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

    def _eager_attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

    def _eager_slots(self, p):
        st = self._eager_state(p)
        if "velocity" not in st:
            st["velocity"] = torch.zeros_like(p.value.detach())
        return {"Velocity": st["velocity"]}

    def _eager_store(self, p, outs):
        self._eager_state(p)["velocity"] = outs["VelocityOut"][0]


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        vel = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": vel,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": vel},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name)
        self.type = "adagrad"
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    """The moment is a decayed average of grad^2 (``decayed_adagrad``), not
    adagrad's monotone sum."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


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
            self.type,
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs=self._op_attrs())

    def _op_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _eager_attrs(self):
        return self._op_attrs()

    def _eager_slots(self, p):
        st = self._eager_state(p)
        if "moment1" not in st:
            v = p.value.detach()
            st["moment1"] = torch.zeros_like(v)
            st["moment2"] = torch.zeros_like(v)
            st["beta1_pow"] = torch.tensor([self._beta1], dtype=v.dtype,
                                           device=v.device)
            st["beta2_pow"] = torch.tensor([self._beta2], dtype=v.dtype,
                                           device=v.device)
        return {"Moment1": st["moment1"], "Moment2": st["moment2"],
                "Beta1Pow": st["beta1_pow"], "Beta2Pow": st["beta2_pow"]}

    def _eager_store(self, p, outs):
        st = self._eager_state(p)
        st["moment1"] = outs["Moment1Out"][0]
        st["moment2"] = outs["Moment2Out"][0]
        st["beta1_pow"] = outs["Beta1PowOut"][0]
        st["beta2_pow"] = outs["Beta2PowOut"][0]


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay (the ``adamw`` op)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, regularization=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, regularization,
                         name)
        self.type = "adamw"
        self._weight_decay = weight_decay

    def _op_attrs(self):
        a = super()._op_attrs()
        a["weight_decay"] = self._weight_decay
        return a


class LambOptimizer(AdamOptimizer):
    """LAMB (You et al., ICLR 2020): Adam's direction plus decoupled decay,
    scaled per parameter by the trust ratio (the ``lamb`` op)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, regularization,
                         name)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay

    def _op_attrs(self):
        a = super()._op_attrs()
        a["weight_decay"] = self._weight_decay
        return a


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment": self._get_accumulator("moment", p),
                    "InfNorm": self._get_accumulator("inf_norm", p),
                    "Beta1Pow": self._get_accumulator("beta1_pow_acc", p)},
            outputs={"ParamOut": p,
                     "MomentOut": self._get_accumulator("moment", p),
                     "InfNormOut": self._get_accumulator("inf_norm", p)},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        """The beta1 powers advance after every update (a ``scale`` each)."""
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op("scale", inputs={"X": b1p},
                            outputs={"Out": b1p},
                            attrs={"scale": self._beta1})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": p, "Grad": g, "AvgSquaredGrad": asg,
                    "AvgSquaredUpdate": asu},
            outputs={"ParamOut": p, "AvgSquaredGradOut": asg,
                     "AvgSquaredUpdateOut": asu},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        mom = self._get_accumulator("momentum", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": p, "Grad": g, "MeanSquare": ms, "MeanGrad": mg,
                    "Moment": mom,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": mom, "MeanSquareOut": ms,
                     "MeanGradOut": mg},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": p, "Grad": g, "SquaredAccumulator": sq,
                    "LinearAccumulator": lin,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "SquaredAccumOut": sq,
                     "LinearAccumOut": lin},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


# ---------------------------------------------------------------------------
# averaging and wrappers
# ---------------------------------------------------------------------------

def _swap_guard(scope, values: Dict[str, object], need_restore: bool):
    """Set each ``name -> value`` in ``scope``; on exit put the old values
    back when ``need_restore``."""
    saved = {n: scope.find_var(n) for n in values}
    for n, v in values.items():
        scope.set_var(n, v)
    try:
        yield
    finally:
        if need_restore:
            for n, v in saved.items():
                scope.set_var(n, v)


class ExponentialMovingAverage:
    """EMA of the trainable parameters (reference optimizer.py
    ExponentialMovingAverage): a shadow var per parameter, updated by ops
    appended to the main program at construction
    (``ema = decay * ema + (1 - decay) * param``); ``apply`` swaps the
    shadows in for the parameters. The port passes scopes explicitly, so
    ``apply`` takes the scope (default: ``global_scope()``)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._ema_vars: Dict[str, Variable] = {}
        self._params: List[Parameter] = []
        program = default_main_program()
        block = program.global_block
        for p in program.all_parameters():
            if not p.trainable:
                continue
            self._params.append(p)
            ema_name = self._name + p.name + ".ema"
            ema = _persistable_pair(ema_name, p.shape, p.dtype,
                                    _fill(p.shape, p.dtype, 0.0))
            self._ema_vars[p.name] = ema
            tmp = block.create_var(
                name=unique_name.generate(ema_name + ".tmp"),
                shape=p.shape, dtype=p.dtype, stop_gradient=True)
            block.append_op("scale", inputs={"X": ema}, outputs={"Out": tmp},
                            attrs={"scale": decay})
            tmp2 = block.create_var(
                name=unique_name.generate(ema_name + ".tmp"),
                shape=p.shape, dtype=p.dtype, stop_gradient=True)
            block.append_op("scale", inputs={"X": p}, outputs={"Out": tmp2},
                            attrs={"scale": 1.0 - decay})
            block.append_op("sum", inputs={"X": [tmp, tmp2]},
                            outputs={"Out": ema})

    def update(self):
        pass  # the updates were appended to the main program

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True, scope=None):
        from .executor import global_scope

        scope = scope if scope is not None else global_scope()
        # checked before anything is swapped, so a missing shadow leaves
        # the scope as it was
        for p in self._params:
            if scope.find_var(self._ema_vars[p.name].name) is None:
                raise RuntimeError(
                    f"EMA shadow var '{self._ema_vars[p.name].name}' is not "
                    f"in the scope — construct ExponentialMovingAverage "
                    f"before training and run the startup+main programs that "
                    f"contain its ops")
        yield from _swap_guard(
            scope, {p.name: scope.find_var(self._ema_vars[p.name].name)
                    for p in self._params}, need_restore)

    def restore(self, executor):
        pass


class ModelAverage(Optimizer):
    """The windowed average of the parameters through the
    ``average_accumulates`` op (reference optimizer.py ModelAverage).
    Construct it after ``minimize`` and before training: construction
    appends the accumulation ops to the main program. ``apply`` raises
    if they never ran; it takes the scope (default: ``global_scope()``)."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
        self._avg_window_rate = average_window_rate
        self._min_window = min_average_window
        self._max_window = max_average_window
        self._params: List[Parameter] = []
        self._acc_names: Dict[str, Dict[str, str]] = {}
        program = default_main_program()
        block = program.global_block
        for p in program.all_parameters():
            if not p.trainable or p.do_model_average is False:
                continue
            self._params.append(p)
            names = {}
            for slot, shape, dtype in (
                    ("sum_1", p.shape, p.dtype), ("sum_2", p.shape, p.dtype),
                    ("sum_3", p.shape, p.dtype),
                    ("num_accumulates", (1,), "int64"),
                    ("old_num_accumulates", (1,), "int64"),
                    ("num_updates", (1,), "int64")):
                vname = unique_name.generate(f"{p.name}.{slot}")
                names[slot] = vname
                _persistable_pair(vname, shape, dtype,
                                  _fill(shape, dtype, 0.0))
            self._acc_names[p.name] = names
            block.append_op(
                "average_accumulates",
                inputs={"Param": p.name, "InSum1": names["sum_1"],
                        "InSum2": names["sum_2"], "InSum3": names["sum_3"],
                        "InNumAccumulates": names["num_accumulates"],
                        "InOldNumAccumulates": names["old_num_accumulates"],
                        "InNumUpdates": names["num_updates"]},
                outputs={"OutSum1": names["sum_1"], "OutSum2": names["sum_2"],
                         "OutSum3": names["sum_3"],
                         "OutNumAccumulates": names["num_accumulates"],
                         "OutOldNumAccumulates": names["old_num_accumulates"],
                         "OutNumUpdates": names["num_updates"]},
                attrs={"average_window": average_window_rate,
                       "min_average_window": min_average_window,
                       "max_average_window": max_average_window})

    def minimize(self, loss, **kw):
        raise RuntimeError("ModelAverage wraps a trained program; call apply()")

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True, scope=None):
        """Swap the parameters for (sum_1 + sum_2 + sum_3) / (num +
        old_num), every average computed before anything is swapped."""
        from .executor import global_scope

        scope = scope if scope is not None else global_scope()
        averaged = {}
        for p in self._params:
            names = self._acc_names[p.name]
            s1 = scope.find_var(names["sum_1"])
            if s1 is None:
                raise RuntimeError(
                    f"ModelAverage accumulator '{names['sum_1']}' is not in "
                    f"the scope — the accumulating program never ran. "
                    f"Construct ModelAverage before training (after "
                    f"optimizer.minimize) and train the SAME program.")
            total = int(scope.numpy(names["num_accumulates"])[0]) + int(
                scope.numpy(names["old_num_accumulates"])[0])
            if total == 0:
                raise RuntimeError(
                    "ModelAverage.apply: zero accumulated steps — train "
                    "before applying the average")
            s = s1 + scope.find_var(names["sum_2"]) \
                + scope.find_var(names["sum_3"])
            averaged[p.name] = (s / total).to(scope.find_var(p.name).dtype)
        yield from _swap_guard(scope, averaged, need_restore)

    def restore(self, executor):
        pass


class LookaheadOptimizer:
    """Lookahead (reference optimizer.py LookaheadOptimizer): slow weights
    that every ``k`` steps move ``alpha`` of the way to the fast ones,
    which then restart from them. Branch-free, as the reference: a step
    counter, and a gate that is 1 where ``step / k`` is whole."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        ops, pgs = self.inner_optimizer.minimize(
            loss, startup_program=startup_program)
        block = default_main_program().global_block
        step_name = unique_name.generate("lookahead_step")
        _persistable_pair(step_name, (1,), "float32",
                          _fill((1,), "float32", 0.0))
        block.append_op("increment", inputs={"X": step_name},
                        outputs={"Out": step_name}, attrs={"step": 1.0})

        def copy_of(src):
            def op(startup, name):
                startup.append_op("assign", inputs={"X": src},
                                  outputs={"Out": name})
            return op

        for p, _ in pgs:
            slow_name = p.name + ".slow"
            _persistable_pair(slow_name, p.shape, p.dtype, copy_of(p.name))
            helper = LayerHelper("lookahead")

            def tmp(dtype):
                return helper.create_variable_for_type_inference(dtype, True)

            inv = tmp("float32")
            block.append_op("scale", inputs={"X": step_name},
                            outputs={"Out": inv},
                            attrs={"scale": 1.0 / self.k})
            flo = tmp("float32")
            block.append_op("floor", inputs={"X": inv}, outputs={"Out": flo})
            frac = tmp("float32")
            block.append_op("elementwise_sub", inputs={"X": inv, "Y": flo},
                            outputs={"Out": frac}, attrs={"axis": -1})
            iszero, zero = tmp("bool"), tmp("float32")
            block.append_op("fill_constant", outputs={"Out": zero},
                            attrs={"shape": [1], "dtype": "float32",
                                   "value": 0.0})
            block.append_op("equal", inputs={"X": frac, "Y": zero},
                            outputs={"Out": iszero})
            gate = tmp("float32")
            block.append_op("cast", inputs={"X": iszero},
                            outputs={"Out": gate},
                            attrs={"in_dtype": "bool",
                                   "out_dtype": "float32"})
            # slow += gate * alpha * (fast - slow)
            diff = tmp(p.dtype)
            block.append_op("elementwise_sub",
                            inputs={"X": p.name, "Y": slow_name},
                            outputs={"Out": diff}, attrs={"axis": -1})
            sdiff = tmp(p.dtype)
            block.append_op("scale", inputs={"X": diff},
                            outputs={"Out": sdiff},
                            attrs={"scale": self.alpha})
            gated = tmp(p.dtype)
            block.append_op("elementwise_mul", inputs={"X": sdiff, "Y": gate},
                            outputs={"Out": gated}, attrs={"axis": 0})
            block.append_op("sum", inputs={"X": [slow_name, gated]},
                            outputs={"Out": slow_name})
            # fast += gate * (slow - fast)
            diff2 = tmp(p.dtype)
            block.append_op("elementwise_sub",
                            inputs={"X": slow_name, "Y": p.name},
                            outputs={"Out": diff2}, attrs={"axis": -1})
            gated2 = tmp(p.dtype)
            block.append_op("elementwise_mul", inputs={"X": diff2, "Y": gate},
                            outputs={"Out": gated2}, attrs={"axis": 0})
            block.append_op("sum", inputs={"X": [p.name, gated2]},
                            outputs={"Out": p.name})
        return ops, pgs


class GradientMergeOptimizer:
    """Gradient accumulation over microbatches (reference
    ir/multi_batch_merge_pass.cc; the JAX package's
    ``make_pipeline_step_fn``): the executor runs the forward and backward
    ops once per microbatch, on ``batch / M`` rows of every feed, adds up
    the parameter gradients, and runs the rest of the program (clip,
    decay, the update ops) once on their average (``avg``) or sum. With a
    mean loss this is the plain step on the whole batch, at one
    microbatch's activation memory. Ops of the forward role run in every
    microbatch, so a learning-rate schedule built into the program cannot
    feed the update: the executor refuses that program at its first run
    (pass a float rate)."""

    def __init__(self, optimizer, num_microbatches=2, k_steps=None,
                 avg=True):
        self._optimizer = optimizer
        self._num_microbatches = int(k_steps or num_microbatches)
        self._avg = bool(avg)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._optimizer.minimize(loss, startup_program,
                                          parameter_list, no_grad_set)
        program = loss.block.program
        _, params_grads = result
        program._pipeline_microbatches = self._num_microbatches
        program._grad_merge_avg = self._avg      # False: the sum
        program._pipeline_param_grads = [(p.name, g.name)
                                         for p, g in params_grads]
        program._bump_version()
        return result


class PipelineOptimizer(GradientMergeOptimizer):
    """The reference's PipelineOptimizer API over gradient merge: the
    microbatch schedule runs on one device, and ``cut_list`` (the section
    boundaries) is checked and recorded on the program
    (``_pipeline_cut_names``). Placing the sections on devices waits for
    the multi-device slice."""

    def __init__(self, optimizer, cut_list=None, num_microbatches=2,
                 start_cpu_core_id=0):
        super().__init__(optimizer, num_microbatches=num_microbatches)
        self._cut_list = cut_list

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = super().minimize(loss, startup_program, parameter_list,
                                  no_grad_set)
        program = loss.block.program
        if self._cut_list:
            names = []
            for cut in self._cut_list:
                for v in (cut if isinstance(cut, (list, tuple)) else [cut]):
                    names.append(v if isinstance(v, str) else v.name)
            missing = [n for n in names
                       if not program.global_block.has_var(n)]
            if missing:
                raise ValueError(
                    f"PipelineOptimizer cut_list names unknown vars: "
                    f"{missing}")
            program._pipeline_cut_names = names
        return result


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


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum: refused, as in the JAX package.
    DGC sends each gradient's top-k entries to save network bytes; the
    top-k selection and the irregular scatter cost more than the dense
    all-reduce they replace on devices joined by a fast interconnect, and
    its momentum correction exists only to repair DGC's own convergence."""

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None,
                 regularization=None, name=None):
        raise NotImplementedError(
            "DGCMomentumOptimizer is intentionally unsupported: top-k "
            "gradient sparsification saves network bytes at the cost of "
            "top-k + irregular scatter compute, which on devices joined by "
            "a fast interconnect is slower than the dense all-reduce it "
            "replaces. Use Momentum (dense collectives), or local SGD "
            "(use_local_sgd) to cut communication FREQUENCY instead.")


# the short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
