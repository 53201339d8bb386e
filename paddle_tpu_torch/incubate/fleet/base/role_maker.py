"""Role makers: who am I in the cluster?

Reference: python/paddle/fluid/incubate/fleet/base/role_maker.py
(:328 PaddleCloudRoleMaker reading the PADDLE_* env, :428 UserDefinedRoleMaker,
:111 MPIRoleMaker); the counterpart of
``paddle_tpu/incubate/fleet/base/role_maker.py``. Cluster membership comes
from the launcher env (``paddle_tpu_torch.distributed.launch``), so
PaddleCloud + UserDefined cover the surface.
"""
from __future__ import annotations

import os
from typing import List, Optional

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2  # accepted for API parity; there are no parameter servers


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints: List[str] = []

    def generate_role(self):
        pass

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id

    def worker_num(self) -> int:
        return max(1, len(self._worker_endpoints)) if self._worker_endpoints \
            else 1

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._worker_endpoints)


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the launcher's PADDLE_* env contract (the same vars
    paddle_tpu_torch.distributed.launch sets; reference role_maker.py:328)."""

    def __init__(self, is_collective: bool = True):
        super().__init__()
        self._is_collective = is_collective
        self._generated = False

    def generate_role(self):
        if self._generated:
            return
        self._current_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        self._nranks = int(os.getenv("PADDLE_TRAINERS_NUM",
                                     str(max(1, len(self._worker_endpoints)))))
        self._role = Role.WORKER
        self._generated = True

    def worker_num(self) -> int:
        self.generate_role()
        return self._nranks


class UserDefinedRoleMaker(RoleMakerBase):
    """reference role_maker.py:428 — explicit role wiring for tests."""

    def __init__(self, current_id: int = 0, role: int = Role.WORKER,
                 worker_num: int = 1,
                 server_endpoints: Optional[List[str]] = None,
                 worker_endpoints: Optional[List[str]] = None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._num = worker_num
        self._worker_endpoints = list(worker_endpoints or [])

    def worker_num(self) -> int:
        return self._num
