"""DistributeTranspiler — the 2019 parameter-server front door, on the
port (counterpart of ``paddle_tpu/transpiler/distribute_transpiler.py``,
with its decisions and messages).

Reference: python/paddle/fluid/transpiler/distribute_transpiler.py:230
(DistributeTranspiler), :494 (transpile), :130 (DistributeTranspilerConfig).
There are no parameter servers: every rank holds the parameters and the
data-parallel step sums the gradients over the ranks. The shim keeps a
2019 PS script runnable without rewriting it:

- **sync pserver mode** maps onto the collective path. The "trainer"
  program is the original program (run it through ``CompiledProgram``'s
  data-parallel path, or plain ``Executor`` on one card). The "pserver"
  program is an empty no-op program: a process whose role is PSERVER
  starts, runs it, and exits immediately.
- **async / half-async / DC-ASGD / GEO modes raise** with the JAX
  package's migration messages: silently running them synchronously would
  change convergence behavior the user tuned for.
- **nccl2 / collective modes** record endpoints and return the program
  unchanged: bootstrap is ``distributed.init_parallel_env``.
"""
from __future__ import annotations

from typing import Optional

from ..framework import (Program, default_main_program,
                         default_startup_program)
from .ps_dispatcher import HashName, PSDispatcher, RoundRobin

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "HashName", "RoundRobin", "PSDispatcher"]

_ASYNC_MIGRATION_MSG = (
    "async parameter-server training has no TPU analogue: its relaxed "
    "consistency (communicator.h:273 AsyncCommunicator merging stale "
    "grads) traded convergence for network latency that ICI does not "
    "have. Use sync_mode=True (lowered onto XLA collectives), or "
    "fleet.DistributedStrategy(use_local_sgd=True) for reduced "
    "communication frequency with defined semantics."
)

_GEO_MIGRATION_MSG = (
    "GEO-SGD (communicator.h:320 GeoSgdCommunicator, param deltas every "
    "k steps) is intentionally unsupported on TPU. LocalSGD has the same "
    "communication profile with defined convergence: "
    "fleet.DistributedStrategy(use_local_sgd=True)."
)


class DistributeTranspilerConfig:
    """Reference distribute_transpiler.py:130. Knobs that still steer the
    run are honored; the rest are accepted for parity (they configured
    gRPC block-slicing)."""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    enable_dc_asgd = False
    mode = "pserver"            # pserver | nccl2 | collective
    print_log = False
    wait_port = True
    _runtime_split_send_recv = False
    _sync_mode = True
    geo_sgd_mode = False
    geo_sgd_need_push_nums = 100
    nccl_comm_num = 1
    use_hierarchical_allreduce = False
    hierarchical_allreduce_inter_nranks = 0
    collective_mode = None      # grad_allreduce | local_sgd

    def __init__(self):
        pass

    @property
    def runtime_split_send_recv(self):
        return self._runtime_split_send_recv

    @runtime_split_send_recv.setter
    def runtime_split_send_recv(self, value):
        if value is None:
            raise ValueError("runtime_split_send_recv can't be None")
        if value and self._sync_mode:
            raise ValueError("set config.sync_mode=False before enabling "
                             "runtime_split_send_recv")
        self._runtime_split_send_recv = value

    @property
    def sync_mode(self):
        return self._sync_mode

    @sync_mode.setter
    def sync_mode(self, value):
        if value is None:
            raise ValueError("sync_mode can't be None")
        if value and self._runtime_split_send_recv:
            raise ValueError("set runtime_split_send_recv=False before "
                             "enabling sync_mode")
        self._sync_mode = value


class DistributeTranspiler:
    """Reference distribute_transpiler.py:230. See the module docstring
    for what each mode maps onto."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        if self.config.split_method is None:
            self.config.split_method = RoundRobin
        assert self.config.min_block_size >= 8192
        assert self.config.split_method.__bases__[0] == PSDispatcher
        self._transpiled = False

    def transpile(self, trainer_id, program=None,
                  pservers="127.0.0.1:6174", trainers=1, sync_mode=True,
                  startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        """Reference :494. Records the cluster layout; the program itself is
        NOT rewritten (no send/recv splicing — the data-parallel step
        places the collectives, multi_devices_graph_pass.cc:454's job)."""
        self.origin_program = program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.trainer_id = trainer_id
        self.sync_mode = sync_mode

        if self.config.mode in ("nccl2", "collective"):
            # reference nccl2 path ignores sync_mode (distribute_transpiler
            # .py:560 returns before the pserver machinery); collective mode
            # (reference _transpile_collective) likewise only records the
            # cluster layout — bootstrap is distributed.init_parallel_env
            if not isinstance(trainers, str):
                raise ValueError(f"{self.config.mode} mode takes trainers as "
                                 "a comma-separated endpoint string")
            self.trainer_endpoints = trainers.split(",")
            self.trainer_num = len(self.trainer_endpoints)
            self.current_endpoint = current_endpoint
            self.origin_program._trainers_endpoints = self.trainer_endpoints
            self._transpiled = True
            return

        if self.config.geo_sgd_mode:
            raise NotImplementedError(_GEO_MIGRATION_MSG)
        if not sync_mode or not self.config.sync_mode:
            raise NotImplementedError(_ASYNC_MIGRATION_MSG)
        if self.config.enable_dc_asgd:
            raise NotImplementedError(_ASYNC_MIGRATION_MSG)

        self.trainer_num = int(trainers)
        self.pserver_endpoints = [ep.strip() for ep in pservers.split(",")]
        self.current_endpoint = current_endpoint
        # logical shard layout: which pserver each parameter WOULD have
        # lived on (kept so checkpoint tooling can answer layout questions;
        # nothing at runtime consumes it)
        dispatcher = self.config.split_method(self.pserver_endpoints)
        params = [v for v in self.origin_program.global_block.vars.values()
                  if getattr(v, "trainable", False)
                  or type(v).__name__ == "Parameter"]
        self.param_grad_ep_mapping = {ep: {"params": [], "grads": []}
                                      for ep in self.pserver_endpoints}
        for p, ep in zip(params, dispatcher.dispatch(params)):
            self.param_grad_ep_mapping[ep]["params"].append(p)
        self._transpiled = True

    def _require_transpiled(self):
        if not self._transpiled:
            raise RuntimeError("call transpile() first")

    def get_trainer_program(self, wait_port=True):
        """Reference :832. The trainer program is the ORIGINAL program:
        the data-parallel step exchanges gradients when the program runs
        under CompiledProgram/fleet; no send/recv ops are spliced in."""
        self._require_transpiled()
        return self.origin_program

    def get_pserver_program(self, endpoint):
        """Reference :966. A no-op program: every rank holds the
        parameters, so a pserver-role process has nothing to serve.
        Running it returns immediately, letting unmodified 2019 launch
        scripts (which spawn pserver processes) complete cleanly."""
        self._require_transpiled()
        if endpoint not in self.pserver_endpoints:
            raise ValueError(f"endpoint {endpoint!r} not in pserver list "
                             f"{self.pserver_endpoints}")
        prog = Program()
        prog._is_pserver_noop = True
        prog._pserver_endpoint = endpoint
        return prog

    def get_pserver_programs(self, endpoint):
        """Reference :1223 — (main, startup) pair for a pserver."""
        return (self.get_pserver_program(endpoint),
                self.get_startup_program(endpoint))

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        """Reference :1252. Pserver startup is empty for the same reason
        its main program is."""
        self._require_transpiled()
        prog = Program()
        prog._is_pserver_noop = True
        return prog
