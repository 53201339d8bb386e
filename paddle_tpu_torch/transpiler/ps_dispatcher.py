"""Parameter-server shard dispatchers (API parity).

Reference: python/paddle/fluid/transpiler/ps_dispatcher.py:18 (PSDispatcher),
:46 (HashName), :65 (RoundRobin); the counterpart of
``paddle_tpu/transpiler/ps_dispatcher.py``. There are no parameter
servers — every rank holds the parameters — but the dispatch policy objects
remain part of ``DistributeTranspilerConfig.split_method``'s public surface,
and the shim uses them to report which *logical* shard each variable would
have landed on (useful for checkpoint-layout compatibility tooling).
"""
from __future__ import annotations

__all__ = ["PSDispatcher", "HashName", "RoundRobin"]


class PSDispatcher:
    """Base class: dispatch a list of variables onto endpoints."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError("use HashName or RoundRobin")


class HashName(PSDispatcher):
    """Hash each var name onto an endpoint (reference ps_dispatcher.py:46)."""

    def __init__(self, pserver_endpoints):
        super().__init__(pserver_endpoints)

    def _hash_block(self, block_str, total):
        # stable across processes (builtin hash() is salted per-interpreter,
        # which would scatter the same var to different servers per rank).
        # This intentionally DIVERGES from the reference's builtin hash():
        # the var->endpoint layout here answers "which shard would this
        # param have lived on" for checkpoint tooling within THIS framework
        # only — nothing consumes reference-layout parity, and the
        # reference's own layout was never stable across interpreters.
        import zlib

        return zlib.crc32(block_str.encode()) % total

    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            name = var if isinstance(var, str) else var.name
            server_id = self._hash_block(name, len(self._eps))
            eplist.append(self._eps[server_id])
        return eplist


class RoundRobin(PSDispatcher):
    """Distribute vars round-robin (reference ps_dispatcher.py:65)."""

    def __init__(self, pserver_endpoints):
        super().__init__(pserver_endpoints)

    def dispatch(self, varlist):
        eplist = []
        for _ in varlist:
            eplist.append(self._eps[self._step])
            self._step = (self._step + 1) % len(self._eps)
        return eplist
