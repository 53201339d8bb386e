"""Dygraph DataParallel (counterpart of ``paddle_tpu/dygraph/parallel.py``;
reference python/paddle/fluid/dygraph/parallel.py: Env :54, DataParallel
:84 with apply_collective_grads :201).

One process on one card: ``prepare_context`` and
``apply_collective_grads`` pass through with one rank, so the same script
runs standalone, and raise with more than one, since the port's
multi-device slice (ROADMAP Queue A item 6) is not in yet. ``ParallelEnv``
is the port's own copy of the JAX package's env-var view
(``paddle_tpu/distributed``)."""
from __future__ import annotations

import os
from typing import List

from .layers import Layer

__all__ = ["DataParallel", "ParallelEnv", "prepare_context"]

_MULTI_RANK = ("dygraph data parallelism over more than one rank waits for "
               "the port's multi-device slice (ROADMAP Queue A item 6)")


class ParallelEnv:
    """Reference dygraph/parallel.py:54 Env: the cluster env-var view."""

    def __init__(self):
        self.trainer_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self.nranks = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self.current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints: List[str] = [e for e in eps.split(",") if e]
        self.backend = os.getenv("PADDLE_DIST_BACKEND", "")
        self.local_devices = int(os.getenv("PADDLE_LOCAL_DEVICES", "0"))

    @property
    def rank(self) -> int:
        return self.trainer_id

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def dev_id(self) -> int:
        return int(os.getenv("FLAGS_selected_gpus", "0"))


def prepare_context(strategy=None):
    """reference dygraph/parallel.py prepare_context: the env of this
    process; raises when the env names more than one rank."""
    env = ParallelEnv()
    if env.nranks > 1:
        raise NotImplementedError(f"prepare_context: PADDLE_TRAINERS_NUM="
                                  f"{env.nranks}; {_MULTI_RANK}")
    return env


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None):
        super().__init__("data_parallel")
        self._layers = layers
        self._env = ParallelEnv()

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    # -- reference surface -------------------------------------------------
    def scale_loss(self, loss):
        """Identity, as in the JAX package: apply_collective_grads would
        take the mean itself."""
        return loss

    def apply_collective_grads(self):
        """Average every parameter gradient across ranks: with one rank
        there is nothing to average; more than one raises."""
        if self._env.nranks > 1:
            raise NotImplementedError(
                f"apply_collective_grads with {self._env.nranks} ranks: "
                f"{_MULTI_RANK}")

    # -- delegation --------------------------------------------------------
    def parameters(self):
        return self._layers.parameters()

    def named_parameters(self, prefix=""):
        return self._layers.named_parameters(prefix)

    def state_dict(self):
        return self._layers.state_dict()

    def set_dict(self, state):
        return self._layers.set_dict(state)

    load_dict = set_dict

    def clear_gradients(self):
        self._layers.clear_gradients()
