"""Dygraph DataParallel (counterpart of ``paddle_tpu/dygraph/parallel.py``;
reference python/paddle/fluid/dygraph/parallel.py: Env :54, DataParallel
:84 with apply_collective_grads :201).

``prepare_context`` bootstraps the process group over the launched ranks
(``distributed.init_parallel_env``; a no-op with one rank, so the same
script runs standalone). Each rank's loss is its own, as in the JAX
package; ``apply_collective_grads`` averages the gradient of every
trainable parameter, by position, in one collective a dtype."""
from __future__ import annotations

import torch

from ..distributed import ParallelEnv, init_parallel_env
from .layers import Layer

__all__ = ["DataParallel", "ParallelEnv", "prepare_context"]


def prepare_context(strategy=None):
    """reference dygraph/parallel.py prepare_context: bootstrap the
    collectives from the PADDLE_* env."""
    return init_parallel_env()


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
        """Average every parameter gradient across ranks, one collective
        a dtype (the reference :201 coalesces grads before its allreduce
        for the same reason). Keyed by POSITION over all TRAINABLE
        parameters: a rank where one has no grad contributes zeros, and
        every rank writes the average back, so no copy diverges;
        stop_gradient params (BatchNorm running stats) take no part."""
        from .. import distributed as dist

        if self._env.nranks <= 1:
            return
        if not dist.is_initialized():
            raise RuntimeError(
                f"apply_collective_grads: PADDLE_TRAINERS_NUM="
                f"{self._env.nranks} but the process group is not up; call "
                f"dygraph.prepare_context() first")
        params = [p for p in self._layers.parameters()
                  if not getattr(p, "stop_gradient", False)]
        if not any(p._grad is not None for p in params):
            return
        tree = dist.allgather_mean_tree(
            {str(i): (p._grad if p._grad is not None
                      else torch.zeros_like(p.value))
             for i, p in enumerate(params)})
        for i, p in enumerate(params):
            p._grad = tree[str(i)]

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
