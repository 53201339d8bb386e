"""Dygraph LR schedulers (counterpart of
``paddle_tpu/dygraph/learning_rate_scheduler.py``; reference
python/paddle/fluid/dygraph/learning_rate_scheduler.py): the decay object
is passed as an optimizer's learning_rate; each evaluation returns the
current rate then advances step_num by step_size (the reference __call__
contract). Formulas mirror the static layers.learning_rate_scheduler
versions so the two modes cannot diverge."""
from __future__ import annotations

import math

__all__ = ["LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineDecay", "NoamDecay"]


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step
        self.dtype = dtype

    def __call__(self):
        lr = float(self.step())
        self.step_num += self.step_size
        return lr

    def step(self):
        raise NotImplementedError

    def create_lr_var(self, lr):  # reference API parity: eager mode floats
        return float(lr)


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * math.exp(-self.decay_rate * div)


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * (self.decay_rate ** div)


class InverseTimeDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate / (1 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_learning_rate = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        tmp_step = self.step_num
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(self.step_num / float(self.decay_steps))
            div = max(div, 1.0)
            decay_steps = self.decay_steps * div
        else:
            tmp_step = min(tmp_step, self.decay_steps)
        frac = (1 - tmp_step / decay_steps) ** self.power
        return ((self.learning_rate - self.end_learning_rate) * frac
                + self.end_learning_rate)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        cur_epoch = math.floor(self.step_num / self.step_each_epoch)
        return self.learning_rate * 0.5 * (
            math.cos(cur_epoch * math.pi / self.epochs) + 1)


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        a = self.step_num ** -0.5
        b = (self.warmup_steps ** -1.5) * self.step_num
        return (self.d_model ** -0.5) * min(a, b)
