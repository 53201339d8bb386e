"""Multi-process distributed runtime: the env contract and the bootstrap.

Counterpart of ``paddle_tpu/distributed/__init__.py``. The PADDLE_*
environment contract is the reference launcher's, verbatim:

  PADDLE_TRAINER_ID         this process's rank            (int)
  PADDLE_TRAINERS_NUM       world size                     (int)
  PADDLE_CURRENT_ENDPOINT   this process's ip:port
  PADDLE_TRAINER_ENDPOINTS  comma-separated all endpoints; [0] doubles as
                            the rendezvous store's address
  PADDLE_DIST_BACKEND       optional: "cpu" runs the ranks on the CPU
                            with gloo; "gpu" or unset puts rank r on
                            CUDAPlace(FLAGS_selected_gpus); "tpu" raises
  PADDLE_LOCAL_DEVICES      optional: devices per process; more than one
                            raises (one process drives one card)

The port adds three, which the launcher sets:

  PADDLE_LOCAL_NPROC        ranks on this node
  PADDLE_LOCAL_CARDS        comma-separated card of each rank on this node
                            (decides the backend)
  PADDLE_RENDEZVOUS_FILE    optional: a file-store path in place of the
                            TCP store (no port to race for)

The JAX package drives several devices from one process; the torch idiom
is one process per card, so ``init_parallel_env`` runs
``torch.distributed.init_process_group`` over the launched ranks. The
collective backend follows one rule (:func:`collective_backend`): NCCL
where each rank has a card of its own, gloo where ranks share a card or
run on the CPU. Gloo takes CUDA tensors only for ``all_reduce`` and
``broadcast``, so the helpers below build all-gather and reduce-scatter
from those two there (an all-gather sums an integer view of zero-padded
slots, which moves the bits exactly), and the ring exchange stages a CUDA
tensor through the host for gloo's send and receive.

A model-parallel mesh (``parallel.sharding.Mesh``) gets one process group
for each of its axes (:func:`axis_group`): every rank makes every group
of the mesh, axis by axis in the mesh's order, the first time any rank
asks for one, so the ranks call ``new_group`` in the same order. The
helpers take such a group (None: every launched rank).
"""
from __future__ import annotations

import atexit
import datetime
import os
from typing import List, Optional

import numpy as np

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "barrier", "all_gather_object",
           "allgather_mean_tree", "collective_backend", "collective_stats",
           "reset_collective_stats", "set_collective_timing", "axis_group"]

# how long a collective or the rendezvous waits for a peer
_DIST_TIMEOUT = datetime.timedelta(seconds=300)


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
        self.local_nproc = int(os.getenv("PADDLE_LOCAL_NPROC",
                                         str(max(self.nranks, 1))))
        cards = os.getenv("PADDLE_LOCAL_CARDS", "")
        self.local_cards: List[int] = [int(c) for c in cards.split(",")
                                       if c.strip()]

    @property
    def rank(self) -> int:
        return self.trainer_id

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def dev_id(self) -> int:
        return int(os.getenv("FLAGS_selected_gpus", "0"))

    def place(self):
        """This rank's place: the CPU under ``PADDLE_DIST_BACKEND=cpu``,
        else ``CUDAPlace(FLAGS_selected_gpus)``."""
        from ..executor import CPUPlace, CUDAPlace

        if self.backend == "cpu":
            return CPUPlace()
        return CUDAPlace(self.dev_id)


_state = {"initialized": False, "backend": None, "device": None,
          "timing": False}
# what the collective helpers moved: calls, bytes of the tensors handed
# in, and (with ``set_collective_timing(True)``) the seconds they took
_stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "by_kind": {}}


def collective_stats() -> dict:
    """Calls, bytes and seconds of the collective helpers since the last
    :func:`reset_collective_stats` (seconds are counted only while
    :func:`set_collective_timing` is on: each call then waits for the
    card before and after it)."""
    out = dict(_stats)
    out["by_kind"] = {k: dict(v) for k, v in _stats["by_kind"].items()}
    return out


def reset_collective_stats() -> None:
    _stats.update(calls=0, bytes=0, seconds=0.0, by_kind={})


def set_collective_timing(on: bool) -> None:
    _state["timing"] = bool(on)


class _counted:
    """Count one collective call on ``t`` (see :func:`collective_stats`;
    ``by_kind`` splits the calls and bytes by ``kind``)."""

    def __init__(self, t, kind="all_reduce"):
        self.t = t
        self.kind = kind

    def __enter__(self):
        nbytes = self.t.numel() * self.t.element_size()
        _stats["calls"] += 1
        _stats["bytes"] += nbytes
        k = _stats["by_kind"].setdefault(self.kind, {"calls": 0, "bytes": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        if _state["timing"]:
            self._sync()
            import time

            self.t0 = time.perf_counter()
        return self

    def _sync(self):
        if self.t.is_cuda:
            import torch

            torch.cuda.synchronize(self.t.device)

    def __exit__(self, *exc):
        if _state["timing"]:
            import time

            self._sync()
            _stats["seconds"] += time.perf_counter() - self.t0
        return False


def is_initialized() -> bool:
    return _state["initialized"]


def _check_backend(env: ParallelEnv) -> None:
    if env.backend not in ("", "cpu", "gpu"):
        raise ValueError(
            f"PADDLE_DIST_BACKEND={env.backend!r}: the port runs on 'gpu' "
            f"(the default) or 'cpu'; 'tpu' is the JAX package's")
    if env.local_devices > 1:
        raise NotImplementedError(
            f"PADDLE_LOCAL_DEVICES={env.local_devices}: one process drives "
            f"one card in the port; launch one rank per card "
            f"(--nproc_per_node) instead")


def collective_backend(env: Optional[ParallelEnv] = None) -> str:
    """The written rule: ``"nccl"`` where each rank of a node has a card
    of its own (``PADDLE_LOCAL_CARDS`` distinct; without it, ranks on the
    node <= the cards this process sees), else ``"gloo"`` (ranks that
    share a card, or the CPU)."""
    env = env or ParallelEnv()
    if env.backend == "cpu":
        return "gloo"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "distributed: CUDA is not available in this process; launch "
            "with --backend cpu to run the ranks on the CPU")
    if env.local_cards:
        own = len(set(env.local_cards)) == len(env.local_cards)
    else:
        own = env.local_nproc <= torch.cuda.device_count()
    return "nccl" if own else "gloo"


def _device(env: ParallelEnv):
    import torch

    if env.backend == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", env.dev_id)


def init_parallel_env(coordinator_address: Optional[str] = None
                      ) -> ParallelEnv:
    """Bootstrap the process group from the PADDLE_* env contract.

    Single-process (``PADDLE_TRAINERS_NUM`` absent or 1) is a no-op, so
    the same training script runs standalone or under the launcher. The
    store is ``PADDLE_RENDEZVOUS_FILE`` when set, else TCP at
    ``coordinator_address`` or ``PADDLE_TRAINER_ENDPOINTS[0]``. The group
    is torn down at interpreter exit."""
    env = ParallelEnv()
    _check_backend(env)
    if env.nranks <= 1 or _state["initialized"]:
        return env
    import torch
    import torch.distributed as tdist

    backend = collective_backend(env)
    device = _device(env)
    if device.type == "cuda":
        if env.dev_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"distributed: FLAGS_selected_gpus={env.dev_id} but only "
                f"{torch.cuda.device_count()} card(s) visible")
        torch.cuda.set_device(device)
    store_file = os.getenv("PADDLE_RENDEZVOUS_FILE", "")
    if store_file:
        init_method = f"file://{store_file}"
    else:
        coord = coordinator_address or (
            env.trainer_endpoints[0] if env.trainer_endpoints else None)
        if coord is None:
            raise RuntimeError(
                "init_parallel_env: no coordinator — set "
                "PADDLE_TRAINER_ENDPOINTS or pass coordinator_address")
        init_method = f"tcp://{coord}"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    tdist.init_process_group(
        backend, init_method=init_method, world_size=env.nranks,
        rank=env.trainer_id, timeout=_DIST_TIMEOUT, **kwargs)
    _state.update(initialized=True, backend=backend, device=device)
    atexit.register(_teardown)
    return env


def _teardown() -> None:
    import torch.distributed as tdist

    if _state["initialized"] and tdist.is_initialized():
        tdist.destroy_process_group()
    _state["initialized"] = False
    _groups.clear()


def get_rank() -> int:
    return ParallelEnv().trainer_id


def get_world_size() -> int:
    return ParallelEnv().nranks


def backend_name() -> Optional[str]:
    """The backend the group runs on (None before init or single-rank)."""
    return _state["backend"]


def _active() -> bool:
    return _state["initialized"]


def barrier() -> None:
    """Host-level sync of every rank (a no-op single-process)."""
    if not _active():
        return
    import torch.distributed as tdist

    if _state["backend"] == "nccl":
        tdist.barrier(device_ids=[_state["device"].index])
    else:
        tdist.barrier()


# -- the port's collective helpers (each over what the backend takes) -------

_INT_VIEW = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def _int_view(t):
    import torch

    if t.dtype == torch.bool:
        return t.to(torch.int8), lambda x: x.to(torch.bool)
    if not t.is_floating_point() and not t.is_complex():
        return t, lambda x: x
    dt = getattr(torch, _INT_VIEW[t.element_size()])
    return t.view(dt), lambda x: x.view(t.dtype)


# mesh shape -> {axis: (group, ranks of this rank's group)}
_groups: dict = {}


def axis_group(mesh, axis: str):
    """``(group, ranks)``: the process group of this rank's line along
    ``axis`` of ``mesh`` (the ranks that differ from this one only in
    their ``axis`` coordinate, in coordinate order). The first call for a
    mesh shape makes every group of every axis, in the mesh's axis order,
    on every rank (``torch.distributed.new_group`` must be called by all
    ranks alike). Single-process, or an axis of size 1: ``(None, [rank])``
    and the helpers do nothing with it."""
    rank = get_rank() if _active() else 0
    if not _active() or mesh.shape.get(axis, 1) <= 1:
        return None, [rank]
    import torch.distributed as tdist

    key = tuple(mesh.shape.items())
    if key not in _groups:
        if mesh.size != get_world_size():
            raise ValueError(
                f"mesh {mesh.shape} holds {mesh.size} ranks but "
                f"{get_world_size()} were launched")
        made = {}
        for a in mesh.axis_names:
            if mesh.shape[a] <= 1:
                continue
            for line in mesh.lines(a):
                g = tdist.new_group(line)
                if rank in line:
                    made[a] = (g, list(line))
        _groups[key] = made
    return _groups[key][axis]


def _group_rank_size(group):
    import torch.distributed as tdist

    if group is None:
        return get_rank(), get_world_size()
    return tdist.get_rank(group), tdist.get_world_size(group)


def _all_reduce(t, op: str = "sum", group=None):
    """In place over every rank of ``group`` (None: all); returns ``t``."""
    if not _active():
        return t
    import torch.distributed as tdist

    with _counted(t):
        tdist.all_reduce(t, op={"sum": tdist.ReduceOp.SUM,
                                "max": tdist.ReduceOp.MAX,
                                "min": tdist.ReduceOp.MIN}[op],
                         group=group)
    return t


def _broadcast(t, src: int = 0):
    if not _active():
        return t
    import torch.distributed as tdist

    with _counted(t, "broadcast"):
        tdist.broadcast(t, src)
    return t


def _all_gather(t, group=None, dim: int = 0):
    """Every rank's ``t`` of ``group`` (None: all; same shape everywhere)
    concatenated along ``dim`` in group-rank order, bit for bit."""
    if not _active():
        return t
    if dim != 0:
        out = _all_gather(t.movedim(dim, 0).contiguous(), group)
        return out.movedim(0, dim).contiguous()
    import torch
    import torch.distributed as tdist

    rank, world = _group_rank_size(group)
    t = t.contiguous()
    if _state["backend"] == "nccl":
        out = torch.empty((world * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device) if t.dim() \
            else torch.empty(world, dtype=t.dtype, device=t.device)
        with _counted(t, "all_gather"):
            tdist.all_gather_into_tensor(out, t, group=group)
        return out
    if t.device.type == "cpu":
        parts = [torch.empty_like(t) for _ in range(world)]
        with _counted(t, "all_gather"):
            tdist.all_gather(parts, t, group=group)
        return torch.cat(parts) if t.dim() else torch.stack(parts)
    # gloo on a CUDA tensor: all_reduce of zero-padded slots over an
    # integer view (x + 0 moves every bit pattern exactly)
    iv, back = _int_view(t)
    slots = torch.zeros((world,) + tuple(iv.shape), dtype=iv.dtype,
                        device=iv.device)
    slots[rank] = iv
    with _counted(slots, "all_gather"):
        tdist.all_reduce(slots, group=group)
    out = back(slots)
    return out.reshape((world * t.shape[0],) + tuple(t.shape[1:])) \
        if t.dim() else out


def _reduce_scatter(t):
    """This rank's rows of the sum of every rank's ``t`` (dim 0 split
    evenly over the ranks)."""
    if not _active():
        return t
    import torch
    import torch.distributed as tdist

    world, rank = get_world_size(), get_rank()
    rows = t.shape[0] // world
    if _state["backend"] == "nccl":
        out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        with _counted(t, "reduce_scatter"):
            tdist.reduce_scatter_tensor(out, t.contiguous())
        return out
    s = _all_reduce(t.clone())
    return s[rank * rows:(rank + 1) * rows]


def _ring_exchange(t, group, ranks, shift: int = 1):
    """Point to point around the ring of ``ranks`` (``group``'s ranks in
    coordinate order): this rank sends ``t`` to the rank ``shift`` places
    on and returns what the rank ``shift`` places back sent (same shape
    and dtype). Nothing else is gathered. Gloo takes no CUDA tensor for a
    send, so a CUDA tensor is staged through the host there."""
    if not _active() or len(ranks) <= 1:
        return t
    import torch
    import torch.distributed as tdist

    me = ranks.index(get_rank())
    n = len(ranks)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    staged = t.is_cuda and _state["backend"] != "nccl"
    send = (t.cpu() if staged else t).contiguous()
    recv = torch.empty_like(send)
    with _counted(send, "send_recv"):
        reqs = tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, send, dst, group),
            tdist.P2POp(tdist.irecv, recv, src, group)])
        for r in reqs:
            r.wait()
    return recv.to(t.device, non_blocking=False) if staged else recv


def _shift(t, group, ranks, send: bool, recv: bool, like, step: int = 1):
    """Non-circular point to point along the line ``ranks`` (``group``'s
    ranks in coordinate order): with ``send`` this rank sends ``t`` to the
    rank ``step`` places on, with ``recv`` it returns what the rank
    ``step`` places back sent (the shape, dtype and device of ``like``),
    else None. A rank past either end of the line neither sends nor
    receives there: unlike :func:`_ring_exchange`, nothing wraps around.
    Every send must meet the receive its peer posts in the same call. Gloo
    takes no CUDA tensor for a send, so a CUDA tensor is staged through
    the host there."""
    if not _active() or len(ranks) <= 1 or not (send or recv):
        return None
    import torch
    import torch.distributed as tdist

    me = ranks.index(get_rank())
    staged = like.is_cuda and _state["backend"] != "nccl"
    ops, buf = [], None
    if send:
        out = (t.cpu() if staged else t).contiguous()
        ops.append(tdist.P2POp(tdist.isend, out, ranks[me + step], group))
    if recv:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        ops.append(tdist.P2POp(tdist.irecv, buf, ranks[me - step], group))
    with _counted(out if send else buf, "send_recv"):
        for r in tdist.batch_isend_irecv(ops):
            r.wait()
    if buf is None:
        return None
    return buf.to(like.device, non_blocking=False) if staged else buf


def all_gather_object(arr) -> list:
    """Gather a numpy array from every process; a list indexed by rank."""
    if not _active():
        return [np.asarray(arr)]
    import torch.distributed as tdist

    out = [None] * get_world_size()
    tdist.all_gather_object(out, np.asarray(arr))
    return [np.asarray(a) for a in out]


def allgather_mean_tree(tree: dict) -> dict:
    """Average a ``{key: array}`` tree across processes, one collective a
    dtype (identity single-process). Shared by LocalSGD and dygraph
    DataParallel. Tensors come back as tensors on their device, anything
    else as numpy."""
    if not _active():
        return dict(tree)
    import torch

    world = get_world_size()
    keys = list(tree)
    vals = {k: (tree[k] if isinstance(tree[k], torch.Tensor)
                else torch.as_tensor(np.asarray(tree[k])))
            for k in keys}
    out = {}
    for dt in dict.fromkeys(v.dtype for v in vals.values()):
        group = [k for k in keys if vals[k].dtype == dt]
        dev = vals[group[0]].device
        flat = torch.cat([vals[k].detach().reshape(-1).to(dev)
                          for k in group])
        _all_reduce(flat)
        flat = flat / world if flat.is_floating_point() else flat // world
        off = 0
        for k in group:
            n = vals[k].numel()
            piece = flat[off:off + n].reshape(vals[k].shape)
            off += n
            out[k] = piece if isinstance(tree[k], torch.Tensor) \
                else piece.cpu().numpy()
    return out
