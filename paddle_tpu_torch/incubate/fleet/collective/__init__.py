"""Fleet collective mode: the distributed-training front door.

Reference: python/paddle/fluid/incubate/fleet/collective/__init__.py
(:41 CollectiveOpBasedFleet, :94 DistributedStrategy, :142
CollectiveOptimizer) — there the distributed_optimizer rewrites the program
through the collective transpiler, inserting c_allreduce_sum on every grad
(transpiler/collective.py:178 GradAllReduce).

The counterpart of ``paddle_tpu/incubate/fleet/collective``: no
transpilation. ``fleet.distributed_optimizer(opt).minimize`` builds the
normal program; ``fleet.main_program`` returns it wrapped in a
data-parallel ``CompiledProgram`` over the launched ranks, whose parallel
step places the gradient collectives. Ranks bootstrap through
``fleet.init`` -> ``distributed.init_parallel_env`` (the gen_nccl_id
replacement).
"""
from __future__ import annotations

import os
from typing import Optional

from ....parallel.compiled_program import (BuildStrategy, CompiledProgram,
                                           ReduceStrategy)
from ..base.role_maker import PaddleCloudRoleMaker, RoleMakerBase

__all__ = ["fleet", "Fleet", "DistributedStrategy", "CollectiveOptimizer",
           "LocalSGDSync"]


class DistributedStrategy:
    """Reference collective/__init__.py:94 — knobs that still mean
    something, plus accepted-for-parity fields."""

    def __init__(self):
        self.use_local_sgd = False
        self.use_dgc = False                  # parity only
        self.nccl_comm_num = 1                # parity only
        self.forward_recompute = False
        self.recompute_checkpoints = []
        self.use_amp = False
        self.amp_loss_scaling = 2 ** 15
        # ZeRO-1: shard optimizer state over data-parallel ranks
        self.use_sharding = False


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy = DistributedStrategy()
        self._origin_program = None
        self._compiled = None
        self._startup = None
        self._inited = False

    # -- lifecycle (reference fleet_base.py:29 Fleet.init) ----------------
    def init(self, role_maker: Optional[RoleMakerBase] = None):
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        if self._role_maker.worker_num() > 1:
            from .... import distributed as dist

            dist.init_parallel_env()
        self._inited = True
        return self

    def _require_init(self):
        if not self._inited:
            raise RuntimeError("call fleet.init(role) before using fleet")

    # -- cluster views ----------------------------------------------------
    def is_first_worker(self) -> bool:
        self._require_init()
        return self._role_maker.is_first_worker()

    def worker_index(self) -> int:
        self._require_init()
        return self._role_maker.worker_index()

    def worker_num(self) -> int:
        self._require_init()
        return self._role_maker.worker_num()

    def is_worker(self) -> bool:
        self._require_init()
        return self._role_maker.is_worker()

    def worker_endpoints(self):
        self._require_init()
        return self._role_maker.get_trainer_endpoints()

    # -- the optimizer wrapper -------------------------------------------
    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        self._require_init()
        if strategy is not None:
            self._strategy = strategy
        return CollectiveOptimizer(self, optimizer, self._strategy)

    # -- programs to run (reference fleet.main_program property) ----------
    @property
    def main_program(self):
        if self._compiled is None:
            raise RuntimeError("minimize() a distributed_optimizer first")
        return self._compiled

    @property
    def startup_program(self):
        from ....framework import default_startup_program

        return self._startup or default_startup_program()

    def save_persistables(self, executor, dirname, main_program=None):
        from .... import io

        prog = main_program or self._origin_program
        return io.save_persistables(executor, dirname, prog)


class CollectiveOptimizer:
    """reference collective/__init__.py:142 — wraps a normal optimizer;
    minimize() additionally prepares the data-parallel program."""

    def __init__(self, fleet_: Fleet, optimizer, strategy: DistributedStrategy):
        self._fleet = fleet_
        self._inner = optimizer
        self._strategy = strategy

    def backward(self, loss, **kw):
        return self._inner.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        opt = self._inner
        if self._strategy.use_amp:
            from ....contrib import mixed_precision as mp

            opt = mp.decorate(opt,
                              init_loss_scaling=self._strategy.amp_loss_scaling)
        if self._strategy.forward_recompute:
            from ....optimizer import RecomputeOptimizer

            opt = RecomputeOptimizer(opt)
            opt._set_checkpoints(list(self._strategy.recompute_checkpoints))
        result = opt.minimize(loss, startup_program=startup_program,
                              parameter_list=parameter_list,
                              no_grad_set=no_grad_set)

        bs = BuildStrategy()
        if self._strategy.use_sharding:
            bs.reduce_strategy = ReduceStrategy.Reduce
        program = loss.block.program
        self._fleet._origin_program = program
        self._fleet._startup = startup_program
        self._fleet._compiled = CompiledProgram(program).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        return result


class LocalSGDSync:
    """LocalSGD (reference transpiler/collective.py:269 LocalSGD): each
    rank trains INDEPENDENTLY (no per-step gradient allreduce) and every
    ``k`` steps the persistable parameters are averaged across processes —
    trading per-step traffic for slightly stale weights.

    Usage: run the PLAIN (non-data-parallel) program per rank and call
    ``sync.step(scope)`` after each exe.run; every k-th call averages.
    """

    def __init__(self, program, k_steps: int = 1):
        self._names = [p.name for p in program.all_parameters()]
        self._k = max(1, int(k_steps))
        self._count = 0

    def step(self, scope) -> bool:
        """Returns True when a sync happened on this call."""
        self._count += 1
        if self._count % self._k:
            return False
        from ....distributed import allgather_mean_tree

        tree = {}
        for n in self._names:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"LocalSGDSync: parameter '{n}' not initialized in "
                    f"scope — run the startup program first")
            tree[n] = v
        for n, v in allgather_mean_tree(tree).items():
            scope.set_var(n, v)
        return True


fleet = Fleet()
