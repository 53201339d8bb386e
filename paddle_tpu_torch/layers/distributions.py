"""Probability distributions of the port (counterpart of
``paddle_tpu/layers/distributions.py``): ``Uniform``, ``Normal`` and
``Categorical``.

Graph-building classes: every method appends ops of the port's layers,
so a sample draws from its random op's generator and ``log_prob``,
``entropy`` and ``kl_divergence`` are differentiable expressions like
any layer output."""
from __future__ import annotations

import math

import numpy as np

from . import nn, tensor
from ..framework import Variable

__all__ = ["Uniform", "Normal", "Categorical"]


def _as_var(v, like=None):
    if isinstance(v, Variable):
        return v
    arr = np.asarray(v, np.float32)
    return tensor.assign(arr.reshape(arr.shape or (1,)))


class Uniform:
    """U(low, high) elementwise."""

    def __init__(self, low, high):
        self.low = _as_var(low)
        self.high = _as_var(high)

    def sample(self, shape, seed=0):
        u = tensor.uniform_random(shape, min=0.0, max=1.0, seed=seed)
        return nn.elementwise_add(
            nn.elementwise_mul(u, nn.elementwise_sub(self.high, self.low)),
            self.low)

    def log_prob(self, value):
        """-log(high-low) in support, -inf-ish (log 0) outside (reference
        Uniform.log_prob gates with lb*ub indicator)."""
        rng = nn.elementwise_sub(self.high, self.low)
        inside_lo = nn.cast(nn.greater_equal(value, self.low), "float32")
        inside_hi = nn.cast(nn.less_than(value, self.high), "float32")
        ind = nn.elementwise_mul(inside_lo, inside_hi)
        return nn.log(nn.elementwise_div(ind, rng))

    def entropy(self):
        return nn.log(nn.elementwise_sub(self.high, self.low))


class Normal:
    """N(loc, scale) elementwise."""

    def __init__(self, loc, scale):
        self.loc = _as_var(loc)
        self.scale = _as_var(scale)

    def sample(self, shape, seed=0):
        z = tensor.gaussian_random(shape, mean=0.0, std=1.0, seed=seed)
        return nn.elementwise_add(nn.elementwise_mul(z, self.scale),
                                  self.loc)

    def log_prob(self, value):
        var = nn.elementwise_mul(self.scale, self.scale)
        d = nn.elementwise_sub(value, self.loc)
        quad = nn.elementwise_div(nn.elementwise_mul(d, d),
                                  nn.scale(var, scale=2.0))
        log_z = nn.elementwise_add(
            nn.log(self.scale),
            tensor.assign(np.array([0.5 * math.log(2 * math.pi)],
                                   np.float32)))
        return nn.scale(nn.elementwise_add(quad, log_z), scale=-1.0)

    def entropy(self):
        return nn.elementwise_add(
            nn.log(self.scale),
            tensor.assign(np.array([0.5 + 0.5 * math.log(2 * math.pi)],
                                   np.float32)))

    def kl_divergence(self, other: "Normal"):
        """KL(self || other), the closed form."""
        var_ratio = nn.elementwise_div(self.scale, other.scale)
        var_ratio = nn.elementwise_mul(var_ratio, var_ratio)
        d = nn.elementwise_sub(self.loc, other.loc)
        t1 = nn.elementwise_div(
            nn.elementwise_mul(d, d),
            nn.elementwise_mul(other.scale, other.scale))
        inner = nn.elementwise_sub(
            nn.elementwise_add(var_ratio, t1),
            tensor.assign(np.array([1.0], np.float32)))
        return nn.scale(
            nn.elementwise_sub(inner, nn.log(var_ratio)), scale=0.5)


class Categorical:
    """Categorical over the last axis of ``logits``."""

    def __init__(self, logits):
        self.logits = logits

    def _log_p(self):
        return nn.log_softmax(self.logits)

    def entropy(self):
        logp = self._log_p()
        p = nn.softmax(self.logits)
        return nn.scale(nn.reduce_sum(nn.elementwise_mul(p, logp),
                                      dim=[-1]), scale=-1.0)

    def log_prob(self, value):
        """value: int ids [..., 1] or [...]."""
        logp = self._log_p()
        oh = nn.one_hot(value, depth=int(self.logits.shape[-1]))
        return nn.reduce_sum(nn.elementwise_mul(logp, oh), dim=[-1])

    def kl_divergence(self, other: "Categorical"):
        p = nn.softmax(self.logits)
        diff = nn.elementwise_sub(self._log_p(), other._log_p())
        return nn.reduce_sum(nn.elementwise_mul(p, diff), dim=[-1])
