"""Architecture search controllers (counterpart of
``paddle_tpu/contrib/slim/searcher``; reference contrib/slim/searcher/
controller.py:28 EvolutionaryController, :59 SAController).

The reference's LightNAS wrapped these behind a socket-based
ControllerServer (nas/controller_server.py) so distributed trainers could
share one controller; here the search loop runs on the host around the
evaluations, so the controllers are plain objects.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["EvolutionaryController", "SAController"]


class EvolutionaryController:
    """Token-space search base (reference controller.py:28)."""

    def update(self, tokens, reward):
        raise NotImplementedError

    def reset(self, range_table, constrain_func=None):
        raise NotImplementedError

    def next_tokens(self):
        raise NotImplementedError


class SAController(EvolutionaryController):
    """Simulated annealing over integer token vectors (reference
    controller.py:59). Accept a worse reward with probability
    exp((reward - current) / T), T decaying by ``reduce_rate`` per step."""

    def __init__(self, range_table=None, reduce_rate=0.85,
                 init_temperature=1024, max_iter_number=300, seed=None):
        self._range_table = range_table
        self._reduce_rate = reduce_rate
        self._init_temperature = init_temperature
        self._max_iter_number = max_iter_number
        self._reward = -1
        self._tokens = None
        self._max_reward = -1
        self._best_tokens = None
        self._iter = 0
        self._constrain_func = None
        self._rng = np.random.RandomState(seed)

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items()
                if k != "_constrain_func"}

    @property
    def best_tokens(self):
        return self._best_tokens

    @property
    def max_reward(self):
        return self._max_reward

    def reset(self, range_table, init_tokens, constrain_func=None):
        self._range_table = list(range_table)
        self._constrain_func = constrain_func
        self._tokens = list(init_tokens)
        self._iter = 0

    def update(self, tokens, reward):
        self._iter += 1
        temperature = self._init_temperature * \
            self._reduce_rate ** self._iter
        if reward > self._reward or self._rng.random_sample() <= math.exp(
                min((reward - self._reward) / max(temperature, 1e-9), 0.0)):
            self._reward = reward
            self._tokens = list(tokens)
        if reward > self._max_reward:
            self._max_reward = reward
            self._best_tokens = list(tokens)

    def next_tokens(self, control_token=None):
        tokens = list(control_token) if control_token else list(self._tokens)
        new_tokens = list(tokens)
        index = int(len(self._range_table) * self._rng.random_sample())
        new_tokens[index] = (
            new_tokens[index]
            + self._rng.randint(max(self._range_table[index] - 1, 1)) + 1
        ) % self._range_table[index]
        if self._constrain_func is None:
            return new_tokens
        for _ in range(self._max_iter_number):
            if not self._constrain_func(new_tokens):
                index = int(len(self._range_table)
                            * self._rng.random_sample())
                new_tokens = list(tokens)
                new_tokens[index] = self._rng.randint(
                    self._range_table[index])
            else:
                break
        return new_tokens
