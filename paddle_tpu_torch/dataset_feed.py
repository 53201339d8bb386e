"""Dataset over the native C++ data-feed engine, in the PyTorch port
(counterpart of ``paddle_tpu/dataset_feed.py``).

Reference: python/paddle/fluid/dataset.py (DatasetFactory :22,
QueueDataset/InMemoryDataset) configuring the C++ Dataset/MultiSlotDataFeed
(framework/data_set.h, data_feed.h) that `exe.train_from_dataset` consumes.

Here the same MultiSlot text protocol is parsed by the port's own
``native/datafeed.cpp`` on GIL-free threads into a bounded blocking
queue; ``iter_batches`` drains it as {slot: ndarray} feeds for exe.run
(or, behind ``DataLoader.set_batch_generator``, for the side-stream
staging onto the card). With no C++ toolchain the pure-Python parser
below keeps behaviour identical (slower); ``using_native`` says which
one runs and ``native.build_error()`` why the engine did not build.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MultiSlotDataset", "DatasetFactory"]


class MultiSlotDataset:
    """use_var-style config: slots are (name, dtype, length) with dtype
    'float32' or 'int64' (the reference's two MultiSlot types)."""

    def __init__(self):
        self._slots: List[Tuple[str, str, int]] = []
        self._files: List[str] = []
        self._threads = 1
        self._batch = 1
        self._capacity = 1024

    # -- reference Dataset config surface --------------------------------
    def set_use_var(self, slots: Sequence[Tuple[str, str, int]]):
        self._slots = []  # replace, not append (reference set_use_var)
        for name, dtype, length in slots:
            if dtype not in ("float32", "int64"):
                raise ValueError(f"slot '{name}': dtype must be float32 or "
                                 f"int64 (MultiSlot protocol), got {dtype}")
            if ":" in name or "," in name:
                raise ValueError(
                    f"slot name '{name}' may not contain ':' or ',' (they "
                    f"delimit the native engine's spec string)")
            self._slots.append((name, dtype, int(length)))

    def set_filelist(self, files: Sequence[str]):
        self._files = list(files)

    def set_thread(self, n: int):
        self._threads = max(1, int(n))

    def set_batch_size(self, n: int):
        self._batch = max(1, int(n))

    def set_queue_capacity(self, n: int):
        self._capacity = max(2, int(n))

    # -- consumption ------------------------------------------------------
    @property
    def using_native(self) -> bool:
        from . import native

        return native.load_datafeed() is not None

    def iter_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._slots:
            raise RuntimeError("set_use_var first")
        if not self._files:
            raise RuntimeError("set_filelist first")
        from . import native

        lib = native.load_datafeed()
        if lib is None:
            yield from self._iter_python()
            return
        spec = ",".join(f"{n}:{'f' if d == 'float32' else 'i'}:{l}"
                        for n, d, l in self._slots)
        h = lib.df_create(spec.encode())
        if not h:
            raise RuntimeError(f"bad slot spec: {spec}")
        try:
            lib.df_set_capacity(h, self._capacity)
            for f in self._files:
                lib.df_add_file(h, f.encode())
            if lib.df_start(h, self._threads) != 0:
                raise RuntimeError("datafeed already started")
            fslots = [(n, l) for n, d, l in self._slots if d == "float32"]
            islots = [(n, l) for n, d, l in self._slots if d == "int64"]
            while True:
                fbufs = [np.empty((self._batch, l), np.float32)
                         for _, l in fslots]
                ibufs = [np.empty((self._batch, l), np.int64)
                         for _, l in islots]
                fptrs = (ctypes.c_void_p * max(1, len(fbufs)))(
                    *[b.ctypes.data for b in fbufs] or [None])
                iptrs = (ctypes.c_void_p * max(1, len(ibufs)))(
                    *[b.ctypes.data for b in ibufs] or [None])
                rows = lib.df_next(h, self._batch, fptrs, iptrs)
                if rows <= 0:
                    break
                batch = {}
                for (n, _), b in zip(fslots, fbufs):
                    batch[n] = b[:rows]
                for (n, _), b in zip(islots, ibufs):
                    batch[n] = b[:rows]
                yield batch
                if rows < self._batch:
                    break
        finally:
            lib.df_stop_join(h)  # race-free: producers joined before read
            self._parse_errors = int(lib.df_parse_errors(h))
            lib.df_destroy(h)

    def parse_errors(self) -> int:
        """Malformed rows skipped during the LAST completed iteration."""
        return getattr(self, "_parse_errors", 0)

    # -- pure-Python fallback (no toolchain) ------------------------------
    def _iter_python(self) -> Iterator[Dict[str, np.ndarray]]:
        rows: List[List[np.ndarray]] = []

        def flush(rows):
            batch = {}
            for i, (n, d, l) in enumerate(self._slots):
                batch[n] = np.stack([r[i] for r in rows])
            return batch

        self._parse_errors = 0
        for path in self._files:
            with open(path) as f:
                for line in f:
                    toks = line.split()
                    if not toks:
                        continue
                    try:
                        vals, pos = [], 0
                        for n, d, l in self._slots:
                            cnt = int(toks[pos]); pos += 1
                            if cnt != l:
                                raise ValueError("slot length mismatch")
                            dt = np.float32 if d == "float32" else np.int64
                            vals.append(np.array(toks[pos:pos + cnt], dt))
                            if len(vals[-1]) != cnt:
                                raise ValueError("truncated line")
                            pos += cnt
                    except (ValueError, IndexError):
                        # skip malformed rows like the native engine
                        self._parse_errors += 1
                        continue
                    rows.append(vals)
                    if len(rows) == self._batch:
                        yield flush(rows)
                        rows = []
        if rows:
            yield flush(rows)


class DatasetFactory:
    """reference dataset.py:22 DatasetFactory.create_dataset."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class in ("QueueDataset", "InMemoryDataset",
                              "MultiSlotDataset"):
            return MultiSlotDataset()
        raise ValueError(f"unknown dataset class {datafeed_class}")
