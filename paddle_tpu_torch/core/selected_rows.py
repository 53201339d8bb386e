"""SelectedRows: the sparse row-slice gradient of an ``is_sparse`` table.

Counterpart of ``paddle_tpu/core/selected_rows.py``: a ``{rows, values,
height}`` triple, the gradient type of ``is_sparse``/``is_distributed``
embedding lookups, consumed by the sparse branches of the update ops.

The rows vector has a static length N, the number of lookups this step,
never the number of unique ids: ``merge_rows`` sorts the ids, sums
duplicate rows and pads the tail with the sentinel ``height``, whose
values are zero. So no op on the sparse path reads a count back to the
host, and a step on the card makes no host sync.

torch has no scatter that drops an out-of-range row (XLA's
``mode="drop"``), so the sentinel slots are handled by construction:

* the segment sum is the accumulating ``index_put_`` of the dense
  grad (``ops/tensor.py``), over the sorted segment ids: on CUDA it sorts
  stably and adds each segment's rows one after another in their lookup
  order, so a run repeats bit for bit (no ``index_add_`` atomics) and a
  row's sum is the dense grad's to the bit. It is called with its range
  check off (``aten._index_put_impl_(unsafe=True)``: the segment ids lie
  in [0, N) by construction), since that check reads the indices back to
  the host;
* a write into a table (``set_rows``) sends every sentinel slot to the
  last live row with that row's own value, so duplicate writes of one
  row all carry the same value and the undefined winner of a
  non-accumulating ``index_put_`` does not matter.
"""
from __future__ import annotations

import torch

__all__ = ["SelectedRows", "is_selected_rows", "merge_rows",
           "concat_merge", "gather_rows", "set_rows"]


class SelectedRows:
    """rows: int64 [N] (duplicate-free, sorted, sentinel-padded with
    ``height``), values: [N, ...tail], height: the table's row count."""

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    # NOTE: deliberately no ``.dtype``/``.shape`` attributes, as in the
    # reference: the executor's nan-check walk, feed signature and byte
    # counts treat anything with those as a dense tensor.

    def astype(self, dtype) -> "SelectedRows":
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    def scale(self, s) -> "SelectedRows":
        return SelectedRows(self.rows, self.values * s, self.height)

    def to_dense(self):
        """The dense [height, ...tail] gradient (for consumers without a
        sparse path). Sentinel rows are dropped."""
        z = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                        dtype=self.values.dtype, device=self.values.device)
        return set_rows(z, self.rows, self.values, self.height)

    def __repr__(self):
        return (f"SelectedRows(n={self.rows.shape[0]}, "
                f"height={self.height}, tail={tuple(self.values.shape[1:])})")


def is_selected_rows(v) -> bool:
    return isinstance(v, SelectedRows)


def merge_rows(ids, values, height: int) -> SelectedRows:
    """The canonical SelectedRows of raw (possibly duplicated) lookup ids
    and their per-lookup gradient rows: ids sorted (stable), duplicate
    rows summed, the tail padded with the ``height`` sentinel and zero
    values. An id already at ``height`` (a padding row routed away) forms
    a sentinel segment and is zeroed too."""
    n = ids.shape[0]
    ids = ids.reshape(-1).long()
    sids, order = torch.sort(ids, stable=True)
    svals = values[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first, 0) - 1                     # [n], sorted
    summed = torch.ops.aten._index_put_impl_(
        torch.zeros_like(values), (seg,), svals, True, True)
    # each slot's row: its segment's first id (n past the last segment)
    start = torch.searchsorted(seg, torch.arange(n, device=ids.device))
    rows = torch.cat([sids, sids.new_full((1,), height)])[start]
    rows = torch.where(rows < height, rows, height)
    # sentinel slots' values are zero: norm and clip consumers reduce over
    # values, and a dropped row must read as zero there
    live = (rows < height).reshape((n,) + (1,) * (values.dim() - 1))
    summed = torch.where(live, summed, torch.zeros((), dtype=summed.dtype,
                                                   device=summed.device))
    return SelectedRows(rows, summed, height)


def concat_merge(a: SelectedRows, b: SelectedRows) -> SelectedRows:
    """Sum of two SelectedRows of one table (a table read by two lookups):
    concatenated, then merged again. Sentinels sort to the end."""
    assert a.height == b.height, "summing grads of different tables"
    return merge_rows(torch.cat([a.rows, b.rows]),
                      torch.cat([a.values, b.values]), a.height)


def gather_rows(table, rows):
    """``table[rows]`` with a sentinel row read as the last row (clamped,
    as a TPU gather reads it); callers never keep a sentinel slot's
    result, ``set_rows`` drops it."""
    return table[rows.clamp(max=table.shape[0] - 1)]


def set_rows(table, rows, new, height: int):
    """``table[rows] = new`` in place, dropping the sentinel slots, with
    ``rows`` canonical (live rows first, duplicate-free). Every sentinel
    slot is sent to the last live row with that row's value, so all
    writes of a row carry one value; with no live row at all, every slot
    writes row 0's own value back. No host sync. Returns ``table``."""
    n = rows.shape[0]
    if n == 0:
        return table
    n_live = (rows < height).sum()
    src = torch.minimum(torch.arange(n, device=rows.device),
                        (n_live - 1).clamp(min=0))
    any_live = n_live > 0
    idx = torch.where(any_live, rows[src], torch.zeros_like(rows[src]))
    mask = any_live.reshape((1,) * new.dim())
    val = torch.where(mask, new[src].to(table.dtype), table[0:1])
    table.index_put_((idx,), val)
    return table
