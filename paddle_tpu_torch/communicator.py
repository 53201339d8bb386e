"""Communicator compat surface (counterpart of
``paddle_tpu/communicator.py``; reference communicator.py:26, wrapping the
C++ async-SGD Communicator, communicator.h:163). It drove ASYNC
parameter-server training, which the port does not run; constructing one
raises with the JAX package's message, so a 2019 script meets the decision
instead of an ImportError.
"""
from __future__ import annotations

__all__ = ["Communicator"]


class Communicator:
    def __init__(self, program, vars_info=None, trainers=None,
                 geo_sgd_need_push_nums=None):
        raise NotImplementedError(
            "Communicator drove ASYNC parameter-server training "
            "(communicator.h:163); async consistency has no TPU analogue. "
            "Sync collective training needs no communicator — gradients "
            "are exchanged by XLA collectives compiled into the step. See "
            "fluid.transpiler.DistributeTranspiler (sync mode) or "
            "fleet.distributed_optimizer.")

    def start(self):  # pragma: no cover - unreachable after __init__ raises
        pass

    def stop(self):  # pragma: no cover
        pass
