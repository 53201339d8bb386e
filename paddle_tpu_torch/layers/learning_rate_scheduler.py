"""Learning-rate schedules as ops of the main program (counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``; reference
layers/learning_rate_scheduler.py): noam, exponential, natural_exp,
inverse_time, polynomial, piecewise, cosine and linear warmup.

A persistable step counter, ``@LR_DECAY_COUNTER@``, starts at
``begin - 1``; its ``increment`` is prepended to the main program under
the ``lr_sched`` role (pruned by ``clone(for_test=True)``), so the first
step sees ``begin``. Every schedule then computes the rate from the
counter with ordinary ops, each step, on the device."""
from __future__ import annotations

import math

from .. import unique_name
from ..framework import default_main_program, default_startup_program
from ..layer_helper import LayerHelper
from . import nn, tensor

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"]

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    main = default_main_program().global_block
    startup = default_startup_program().global_block
    if not main.has_var(LR_COUNTER_NAME):
        main.create_var(name=LR_COUNTER_NAME, shape=(1,), dtype="float32",
                        persistable=True, stop_gradient=True)
        startup.create_var(name=LR_COUNTER_NAME, shape=(1,), dtype="float32",
                           persistable=True)
        # init to begin-1: the prepended increment runs before first use, so
        # the first step observes `begin` (reference autoincreased_step_counter)
        startup.append_op("fill_constant", outputs={"Out": LR_COUNTER_NAME},
                          attrs={"shape": [1], "dtype": "float32",
                                 "value": float(begin) - 1.0})
        # lr_sched role: pruned by clone(for_test=True) so inference runs
        # don't advance the schedule (reference OpRole.LRSched)
        main.prepend_op("increment", inputs={"X": LR_COUNTER_NAME},
                        outputs={"Out": LR_COUNTER_NAME},
                        attrs={"step": 1.0, "__op_role__": "lr_sched"})
    return main.var(LR_COUNTER_NAME)


def _const(value):
    return tensor.fill_constant([1], "float32", float(value))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr = lr0 * d_model^-0.5 * min(step^-0.5, step*warmup^-1.5)."""
    step = _decay_step_counter(begin=1)
    a = step ** -0.5
    b = step * float(warmup_steps ** -1.5)
    lr = nn.elementwise_min(a, b)
    return nn.scale(lr, scale=float(learning_rate) * d_model ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    ratio = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = nn.floor(ratio)
    return nn.scale(_const(decay_rate) ** ratio,
                    scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    ratio = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = nn.floor(ratio)
    return nn.scale(nn.exp(nn.scale(ratio, scale=-decay_rate)),
                    scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _decay_step_counter()
    ratio = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = nn.floor(ratio)
    denom = nn.scale(ratio, scale=decay_rate, bias=1.0)
    return nn.elementwise_div(_const(learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        div = nn.ceil(nn.scale(step, scale=1.0 / decay_steps))
        # at step 0, div must be 1
        one = _const(1.0)
        zero = _const(0.0)
        is_zero = nn.cast(nn.equal(step, zero), "float32")
        div = nn.elementwise_add(div, is_zero)
        total = nn.scale(div, scale=float(decay_steps))
    else:
        total = _const(decay_steps)
        step = nn.elementwise_min(step, total)
    frac = nn.elementwise_div(step, total)
    base = nn.scale(frac, scale=-1.0, bias=1.0) ** power
    return nn.scale(base, scale=float(learning_rate - end_learning_rate),
                    bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    assert len(values) == len(boundaries) + 1
    step = _decay_step_counter()
    lr = _const(values[-1])
    # evaluate from the last boundary backwards: where(step<b_i, v_i, lr)
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = nn.less_than(step, _const(b))
        lr = nn.where(cond, _const(v), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr = 0.5 * lr0 * (cos(epoch * pi / epochs) + 1)"""
    step = _decay_step_counter()
    epoch = nn.floor(nn.scale(step, scale=1.0 / step_each_epoch))
    cosv = nn.cos(nn.scale(epoch, scale=math.pi / epochs))
    return nn.scale(nn.scale(cosv, scale=1.0, bias=1.0),
                    scale=0.5 * learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _decay_step_counter()
    warm = nn.scale(step, scale=float(end_lr - start_lr) / warmup_steps,
                    bias=float(start_lr))
    in_warmup = nn.less_than(step, _const(warmup_steps))
    if not hasattr(learning_rate, "name"):  # python float
        learning_rate = _const(learning_rate)
    return nn.where(in_warmup, warm, learning_rate)
