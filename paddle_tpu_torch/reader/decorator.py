"""Reader combinators of the PyTorch port, a copy of
``paddle_tpu/reader/decorator.py`` (reference: python/paddle/reader/
decorator.py:37-361 — cache/map_readers/shuffle/chain/compose/buffered/
firstn/xmap_readers/multiprocess_reader). A reader is a zero-arg callable
returning an iterable; the same generator gives the same sequence in both
packages (a seeded ``shuffle`` draws from the same ``random.Random``)."""
from __future__ import annotations

import itertools
import queue
import random
import threading
from typing import Callable, Iterable

__all__ = ["cache", "map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    all_data = []
    filled = [False]

    def cached():
        if not filled[0]:
            all_data.extend(reader())
            filled[0] = True
        return iter(all_data)

    return cached


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size, seed=None):
    """Buffered shuffle. With ``seed`` the order is DETERMINISTIC per
    epoch: epoch k of any run with the same seed shuffles identically
    (a fresh ``random.Random`` derived from ``(seed, epoch)``), and the
    returned reader carries ``state_dict()``/``set_state_dict()`` so the
    checkpoint data cursor (resilience.elastic — meta ``data_cursor``)
    can resume a preempted run on exactly the interrupted sample order.
    Without ``seed`` the legacy process-global ``random.shuffle`` is
    kept (non-resumable, order differs per run)."""
    def _buffered_shuffle(do_shuffle):
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                do_shuffle(buf)
                yield from buf
                buf = []
        if buf:
            do_shuffle(buf)
            yield from buf

    if seed is None:
        def shuffled():
            return _buffered_shuffle(random.shuffle)

        return shuffled

    state = {"seed": int(seed), "epoch": 0}

    def shuffled():
        # int derivation, not a tuple seed (tuple seeding is deprecated
        # and hash-salted — the whole point here is run-to-run stability)
        rng = random.Random((state["seed"] << 32) ^ state["epoch"])
        state["epoch"] += 1
        return _buffered_shuffle(rng.shuffle)

    # state["epoch"] is the index the NEXT reader() call plays; the
    # trainer's cursor realigns it to the epoch being (re-)entered so an
    # interrupted epoch re-shuffles identically on resume
    shuffled.state_dict = lambda: dict(state)
    shuffled.set_state_dict = lambda s: state.update(
        {"seed": int(s.get("seed", state["seed"])),
         "epoch": int(s.get("epoch", state["epoch"]))})
    return shuffled


def chain(*readers):
    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, check_alignment=True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        iterator = zip(*rs) if not check_alignment else \
            itertools.zip_longest(*rs, fillvalue=_STOP)
        for outputs in iterator:
            if check_alignment and _STOP in outputs:
                raise RuntimeError("compose: readers have different lengths")
            yield sum((make_tuple(o) for o in outputs), ())

    return reader


_STOP = object()


def buffered(reader, size):
    """Background-thread prefetch into a bounded queue (the Python analogue
    of reference reader/buffered_reader.cc double-buffering)."""

    class _End:
        pass

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        err = []

        def fill():
            try:
                for d in reader():
                    q.put(d)
            except Exception as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                if err:
                    raise err[0]
                return
            yield e

    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader using threads (reference xmap_readers)."""

    end = object()

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feed():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, d = item
                out_q.put((i, mapper(d)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        if order:
            for k in sorted(pending):
                yield pending[k]

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Thread-based fan-in (the host feeds through threads; kept for API
    parity with the reference's multiprocess_reader)."""
    return chain(*readers) if len(readers) == 1 else _parallel_chain(readers, queue_size)


def _parallel_chain(readers, queue_size):
    def reader():
        q: queue.Queue = queue.Queue(queue_size)
        done = object()

        def run(r):
            for d in r():
                q.put(d)
            q.put(done)

        for r in readers:
            threading.Thread(target=run, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            item = q.get()
            if item is done:
                finished += 1
            else:
                yield item

    return reader
