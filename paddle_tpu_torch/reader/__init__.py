"""Data pipeline of the PyTorch port: DataLoader / PyReader + the reader
combinators (counterpart of ``paddle_tpu/reader``).

Reference: python/paddle/fluid/reader.py:73 (DataLoader.from_generator),
:298 (GeneratorLoader pushing LoDTensors into a C++ LoDTensorBlockingQueue
read by a create_py_reader op), :569 (PyReader), and the C++ double-buffer
prefetch in paddle/fluid/operators/reader/buffered_reader.cc, which copies
batch N+1 to the card on a side stream while batch N computes.

As in the JAX package there is no reader op inside the graph: a worker
thread runs the user's generator and stages each batch, a bounded queue
(``capacity`` deep) hands staged batches to the training loop, and
``Executor.run`` takes them as they are. Staging on the card
(``places`` a ``CUDAPlace``, or None: ``cuda:0``) is BufferedReader's:

* the worker turns each array into a tensor in **pinned** host memory, in
  a ring of ``capacity`` buffer sets that grow to the largest batch seen
  (a pinned allocation synchronises the card); a set is written again
  only after the copy that read it has completed (its event: the copy,
  not the consumer, holds a pinned set);
* it copies the pinned tensors to the card with ``non_blocking=True`` on
  a side ``torch.cuda.Stream`` of its own (the device set in the worker
  thread) and records an event after them;
* the consumer makes its current stream wait on that event before it
  hands the batch out, so no kernel of the step reads a batch whose copy
  has not landed, and calls ``record_stream`` on each tensor, so the
  caching allocator does not give its memory to the side stream while
  the compute stream still reads it.

The worker marks each pull from the generator (``dataloader::read``) and
each staging (``dataloader::stage``) with ``profiler.RecordEvent``.

A staged tensor reaches ``Executor.run`` without a second copy
(``executor.mark_staged``): the loader hands each batch out once. A
stream or event that fails raises in the consumer; nothing falls back to
a pageable copy. ``places=CPUPlace()`` stages plain CPU tensors (the CPU
tests). Dtypes and ranks go through ``data_feeder.coerce_feed_array``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..profiler import RecordEvent
from .decorator import (buffered, cache, chain, compose, firstn,  # noqa: F401
                        map_readers, multiprocess_reader, shuffle,
                        xmap_readers)

__all__ = ["DataLoader", "PyReader", "batch", "cache", "map_readers",
           "buffered", "compose", "chain", "shuffle", "firstn",
           "xmap_readers", "multiprocess_reader"]

# how long a blocked put or join waits before it looks at the stop flag
_POLL_S = 0.05


def batch(reader, batch_size, drop_last=False):
    """reference python/paddle/batch.py: sample reader -> sample-list
    reader. A reader with resume state (a seeded ``shuffle``) lends its
    ``state_dict``/``set_state_dict`` to the batched reader, so the data
    cursor of ``contrib.Trainer`` replays a later epoch's order too (the
    JAX package's ``batch`` drops them: its resume replays the first
    epoch's order only)."""

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    if hasattr(reader, "state_dict") and hasattr(reader, "set_state_dict"):
        batched.state_dict = reader.state_dict
        batched.set_state_dict = reader.set_state_dict
    return batched


class _EndOfEpoch:
    pass


_EOE = _EndOfEpoch()


def _resolve_device(places) -> torch.device:
    """The device a loader stages to: the first of ``places``; None means
    ``CUDAPlace(0)``, which raises without a card."""
    from ..executor import CUDAPlace

    place = places[0] if isinstance(places, (list, tuple)) else places
    if place is None:
        place = CUDAPlace(0)
    return place.torch_device()


class _CudaStager:
    """The worker thread's side of staging on the card: the side stream
    and the ring of pinned buffer sets with the event of each set's last
    copy."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        torch.cuda.set_device(device)
        self.stream = torch.cuda.Stream(device=device)
        self.ring: List[dict] = [{} for _ in range(slots)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0

    @staticmethod
    def _pinned(bufs: dict, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` written into the slot's pinned bytes for ``name``, as a
        tensor of its shape and dtype. The bytes grow to the largest batch
        seen and are never given back: allocating pinned memory
        synchronises the card (with the GIL held), so a smaller batch or
        another shape must not allocate anew."""
        buf = bufs.get(name)
        if buf is None or buf.numel() < arr.nbytes:
            buf = torch.empty(max(arr.nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            bufs[name] = buf
        want = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        t = buf[:arr.nbytes].view(want).view(arr.shape)
        np.copyto(t.numpy(), arr, casting="no")
        return t

    def stage(self, arrays: dict):
        slot = self.next
        self.next = (slot + 1) % len(self.ring)
        if self.events[slot] is not None:
            # the copy that last read this slot's pinned buffers has to
            # land before the host writes them again
            self.events[slot].synchronize()
        bufs = self.ring[slot]
        host = {n: self._pinned(bufs, n, np.ascontiguousarray(a))
                for n, a in arrays.items()}
        out = {}
        with torch.cuda.stream(self.stream):
            for n, t in host.items():
                out[n] = t.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[slot] = ev
        return out, ev


def _hand_out(staged, device: torch.device):
    """The consumer's side: order the current stream after the batch's
    copy, tie each tensor to that stream for the allocator, mark it
    staged for the executor."""
    from ..executor import mark_staged

    out, ev = staged
    if ev is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ev)
        for t in out.values():
            t.record_stream(cur)
    for t in out.values():
        mark_staged(t)
    return out


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """``q.put`` that gives up once ``stop`` is set (the consumer left)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


class DataLoader:
    """reference reader.py:73. Construct via ``from_generator``."""

    def __init__(self, feed_list=None, capacity=4, use_double_buffer=True,
                 iterable=True, return_list=False):
        if feed_list is None:
            raise ValueError("feed_list is required (list of fluid.data vars)")
        self._feed_names = [v if isinstance(v, str) else v.name
                            for v in feed_list]
        self._feed_vars = [v for v in feed_list if not isinstance(v, str)]
        self._capacity = max(2, int(capacity)) if use_double_buffer \
            else max(1, int(capacity))
        self._use_double_buffer = use_double_buffer
        self._iterable = iterable
        self._return_list = return_list
        self._device: Optional[torch.device] = None
        self._batch_reader: Optional[Callable] = None
        # deterministic data-order resume (state_dict/set_state_dict)
        self._batches_served = 0
        self._epochs_done = 0
        self._skip_batches = 0
        # non-iterable (start/reset/next) mode: the live epoch iterator
        self._iter = None
        # the live epoch's worker thread (None between epochs)
        self._worker: Optional[threading.Thread] = None

    # -- construction (reference DataLoader.from_generator) ---------------
    @staticmethod
    def from_generator(feed_list=None, capacity=4, use_double_buffer=True,
                       iterable=True, return_list=False):
        return DataLoader(feed_list, capacity, use_double_buffer, iterable,
                          return_list)

    # -- generator wiring (reference GeneratorLoader.set_*) ---------------
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        """reader yields ONE sample (tuple of arrays); loader batches."""

        return self.set_sample_list_generator(
            batch(reader, batch_size, drop_last=drop_last), places)

    def set_sample_list_generator(self, reader, places=None):
        """reader yields a LIST of samples per iteration (a batch)."""

        def batch_reader():
            for samples in reader():
                yield _stack_samples([s if isinstance(s, (list, tuple))
                                      else (s,) for s in samples])

        return self.set_batch_generator(batch_reader, places)

    def set_batch_generator(self, reader, places=None):
        """reader yields ready batches (tuple/list of batched arrays, or a
        dict keyed by feed name). ``places``: where batches are staged
        (None: ``CUDAPlace(0)``, which raises without a card)."""
        self._device = _resolve_device(places)
        self._batch_reader = reader
        return self

    # -- staging -----------------------------------------------------------
    def _arrays(self, batch) -> dict:
        """One batch as numpy arrays keyed by feed name, coerced to each
        feed variable's dtype and rank."""
        from ..data_feeder import coerce_feed_array

        if isinstance(batch, dict):
            items = [(n, batch[n]) for n in self._feed_names]
        else:
            vals = list(batch) if isinstance(batch, (list, tuple)) else [batch]
            if len(vals) != len(self._feed_names):
                raise ValueError(
                    f"generator yielded {len(vals)} arrays but feed_list has "
                    f"{len(self._feed_names)} ({self._feed_names})")
            items = list(zip(self._feed_names, vals))
        out = {}
        for name, v in items:
            arr = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for var in self._feed_vars:
                if var.name == name:
                    arr = coerce_feed_array(var, arr)
                    break
            out[name] = arr
        return out

    # -- deterministic resume (SURVEY §5 failure/elastic) -----------------
    def state_dict(self) -> dict:
        """Data-order resume point: how many batches this epoch has served
        (plus completed epochs). Restoring via ``set_state_dict`` makes the
        NEXT epoch skip exactly that many batches, so training continues on
        the sample the crash interrupted — provided the underlying reader
        is deterministic (same files, same order, same shuffle seed)."""
        return {"epoch": self._epochs_done, "batch": self._batches_served}

    def set_state_dict(self, state: dict):
        self._skip_batches = int(state.get("batch", 0))
        self._epochs_done = int(state.get("epoch", 0))

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        if self._batch_reader is None:
            raise RuntimeError("call set_sample_generator / "
                               "set_sample_list_generator / "
                               "set_batch_generator first")
        q: queue.Queue = queue.Queue(maxsize=self._capacity)
        stop = threading.Event()
        skip = self._skip_batches
        self._skip_batches = 0
        self._batches_served = skip
        # snapshot the mutable loader config BEFORE spawning the worker:
        # the prefetch thread then only touches its own locals
        batch_reader = self._batch_reader
        device = self._device
        on_card = device.type == "cuda"

        def worker():
            try:
                stager = _CudaStager(device, self._capacity) \
                    if on_card else None
                it = iter(batch_reader())
                i = 0
                while not stop.is_set():
                    with RecordEvent("dataloader::read"):
                        b = next(it, _EOE)
                    if b is _EOE:
                        break
                    i += 1
                    if i <= skip:
                        continue  # fast-forward: resume mid-epoch
                    with RecordEvent("dataloader::stage"):
                        arrays = self._arrays(b)
                        if stager is not None:
                            staged = stager.stage(arrays)
                        else:
                            staged = ({n: torch.from_numpy(np.array(a))
                                       for n, a in arrays.items()}, None)
                    if not _put(q, staged, stop):
                        return
                else:
                    return
                _put(q, _EOE, stop)
            except BaseException as e:  # surface in the consumer
                _put(q, e, stop)

        t = threading.Thread(target=worker, daemon=True,
                             name="paddle_tpu_torch-dataloader")
        self._worker = t
        t.start()
        try:
            while True:
                item = q.get()
                if item is _EOE:
                    self._epochs_done += 1
                    self._batches_served = 0
                    return
                if isinstance(item, BaseException):
                    raise item
                self._batches_served += 1
                item = _hand_out(item, device)
                if self._return_list:
                    yield [item[n] for n in self._feed_names]
                else:
                    yield item
        finally:
            stop.set()
            # the worker's puts give up once stop is set; drain so a put
            # already in progress returns, then wait for the thread
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=_POLL_S)
            self._worker = None

    # -- non-iterable start/reset mode (reference PyReader) ---------------
    def start(self):
        self._iter = iter(self)

    def next(self):
        if self._iter is None:
            raise RuntimeError(
                "DataLoader.next() called without an active epoch — call "
                "start() first (after reset(), start() begins a new epoch)")
        return next(self._iter)

    def reset(self):
        it = self._iter
        self._iter = None
        if it is not None:
            it.close()  # unwind the generator's finally: stop the worker


class PyReader(DataLoader):
    """reference reader.py:569 — the older name for the same machinery."""

    def __init__(self, feed_list=None, capacity=4, use_double_buffer=True,
                 iterable=True, return_list=False):
        super().__init__(feed_list, capacity, use_double_buffer, iterable,
                         return_list)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last, places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)


def _stack_samples(samples: List[tuple]) -> tuple:
    cols = list(zip(*samples))
    return tuple(np.stack([np.asarray(v) for v in col]) for col in cols)
