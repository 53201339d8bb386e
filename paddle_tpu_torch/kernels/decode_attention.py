"""Paged decode attention: the hand-written Hopper kernel (K2), its plain
PyTorch version, and the paged KV appends.

Counterpart of ``paddle_tpu/kernels/decode_attention.py``. A chunk of
query rows per sequence attends against that sequence's cache
``[B*H, S_max, D]``: query row ``i`` sees keys ``k_pos < length + i``
(causal within the chunk, whose own K rows were appended first); a row
that sees no key gives 0.

* :func:`flash_attention_decode` — a CUDA tensor launches
  ``csrc/decode_attention.cu`` (counted on ``.launches``) or raises; a
  CPU tensor takes :func:`decode_attention_reference`. The kernel takes
  1..8 query rows directly; a longer chunk runs as 8-row slices, slice
  ``j`` with lengths ``+ 8 * j`` (:func:`decode_in_slices`), which is
  exact. The kernel splits each sequence's cache into runs of
  :func:`split_keys` keys, one block each, combined inside one launch.
* :func:`paged_kv_append` / :func:`paged_kv_append_rows` — the KV writes,
  done IN PLACE with torch index writes (the port's stand-in for the JAX
  package's buffer donation), with the reference's clamping.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention_decode", "decode_attention_reference",
           "decode_in_slices", "paged_kv_append", "paged_kv_append_rows"]

NEG_INF = -1e30
MAX_ROWS = 8
MAX_HEAD_DIM = 128
# the kernel's split-K: at most MAX_SPLITS blocks (one thread-block
# cluster) share a b*h's cache, each walking at most SPLIT_KEYS keys up to
# S_max = MAX_SPLITS * SPLIT_KEYS, more beyond
MAX_SPLITS = 8
SPLIT_KEYS = 256


def _keep(mask, b: int, ndim: int, device):
    """[B, 1, 1, ...] bool from a [B, 1] slot mask (None: all slots)."""
    if mask is None:
        return None
    return (mask.reshape(b) > 0).to(device).reshape((b,) + (1,) * (ndim - 1))


def paged_kv_append(cache, new, positions, slot_mask=None):
    """Write ``new`` [B, ..., L, D] into ``cache`` [B, ..., S, D] at
    per-sequence start rows ``positions`` [B], in place. The start clamps
    into [0, S - L] (``dynamic_update_slice`` semantics), so a saturated
    position overwrites the last rows instead of a neighbour. With
    ``slot_mask`` [B, 1], unmasked sequences keep their rows bit for bit.
    Returns ``cache``."""
    B, S, L = cache.shape[0], cache.shape[-2], new.shape[-2]
    start = positions.reshape(B).long().clamp(0, max(S - L, 0))
    rows = start[:, None] + torch.arange(L, device=cache.device)[None, :]
    view = cache.movedim(-2, 1)                   # [B, S, ..., D]
    bidx = torch.arange(B, device=cache.device)[:, None]
    vals = new.to(cache.dtype).movedim(-2, 1)     # [B, L, ..., D]
    keep = _keep(slot_mask, B, vals.dim(), cache.device)
    if keep is not None:
        vals = torch.where(keep, vals, view[bidx, rows])
    view[bidx, rows] = vals
    return cache


def paged_kv_append_rows(cache, new, positions, slot_mask=None):
    """Chunked KV write with PER-ROW clamping, in place: row ``i`` of
    ``new`` [B, ..., C, D] lands at ``min(positions + i, S - 1)``. Rows
    past the cache end collapse onto the last row, and, as in the
    reference's row-by-row loop, the chunk's LAST row is what stays
    there. ``slot_mask`` as in :func:`paged_kv_append`. Returns
    ``cache``."""
    B, S, C = cache.shape[0], cache.shape[-2], new.shape[-2]
    want = positions.reshape(B).long()[:, None] + torch.arange(
        C, device=cache.device)[None, :]
    rows = want.clamp(max=S - 1)
    vals = new.to(cache.dtype).movedim(-2, 1)     # [B, C, ..., D]
    # every row that lands on S - 1 carries the last row's value, so the
    # duplicate index writes agree (last write wins, deterministically)
    over = (want >= S - 1).reshape((B, C) + (1,) * (vals.dim() - 2))
    vals = torch.where(over, vals[:, C - 1:C], vals)
    view = cache.movedim(-2, 1)
    bidx = torch.arange(B, device=cache.device)[:, None]
    keep = _keep(slot_mask, B, vals.dim(), cache.device)
    if keep is not None:
        vals = torch.where(keep, vals, view[bidx, rows])
    view[bidx, rows] = vals
    return cache


def decode_attention_reference(q, k_cache, v_cache, lengths, scale):
    """Plain PyTorch version of the kernel: masked softmax attention of a
    chunk of query rows per sequence. q [BH, Sq, D]; caches [BH, S, D];
    lengths [BH] (already expanded per head): row ``i`` sees
    ``lengths + i`` keys. A row that sees none gives 0, as the kernel
    does. Computes in float32, with P cast to the operand type before
    P.V as the JAX kernel casts it (a no-op in float32); the output has
    q's dtype."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k_cache.float()) * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
    row = torch.arange(q.shape[1], device=q.device)[None, :, None]
    vis = k_pos < lengths.to(q.device).long()[:, None, None] + row
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * vis
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o / torch.where(l > 0, l, torch.ones_like(l))
    return o.to(q.dtype)


def decode_in_slices(q, lengths, attend):
    """Run a chunk of any length as <= 8-row slices: slice ``j`` (rows
    ``8j .. 8j+7``) is the chunk whose row 0 sees ``lengths + 8j`` keys.
    ``attend(q_slice, lengths_slice)`` computes one slice."""
    outs = [attend(q[:, j:j + MAX_ROWS], lengths + j)
            for j in range(0, q.shape[1], MAX_ROWS)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def split_keys(S: int) -> int:
    """Keys each block of a b*h's cluster walks: ``S`` shared evenly by
    ``ceil(S / SPLIT_KEYS)`` blocks, at most ``MAX_SPLITS``, rounded up to
    a multiple of 16 (so 4 blocks of 256 keys at S_max 1024, S_max / 8
    keys beyond S_max 2048)."""
    n = min(MAX_SPLITS, max(1, -(-S // SPLIT_KEYS)))
    return max(16, -(-S // (16 * n)) * 16)


def _launch(q, k_cache, v_cache, lengths, scale, num_heads):
    BH, q_len, D = q.shape
    S = k_cache.shape[1]
    o = torch.empty_like(q)
    _build.launch("decode_attention", q.device, q.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                  o.data_ptr(), BH, q_len, S, D, int(num_heads),
                  split_keys(S), float(scale),
                  int(q.dtype == torch.bfloat16))
    _build.count_launch(flash_attention_decode)
    return o


def _check(q, k_cache, v_cache, lengths, num_heads):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"decode attention: {name} must match q in "
                             f"dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"decode attention: {name} must be contiguous")
    BH, _, D = q.shape
    if k_cache.dim() != 3 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != BH or k_cache.shape[2] != D:
        raise ValueError(f"decode attention: want q [BH, q_len, D] and "
                         f"caches [BH, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if D < 8 or D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"decode attention kernel: head_dim={D} must be a "
                         f"multiple of 8 in [8, {MAX_HEAD_DIM}]")
    if BH % num_heads or lengths.shape != (BH // num_heads,) \
            or lengths.dtype != torch.int32 or lengths.device != q.device:
        raise ValueError(f"decode attention: lengths must be int32 "
                         f"[{BH // max(num_heads, 1)}] on {q.device}, got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")


def flash_attention_decode(q, k_cache, v_cache, lengths, *, scale=None,
                           num_heads: int = 1):
    """One decode/verify chunk: q [BH, q_len, D] against caches
    [BH, S_max, D]; ``lengths`` per BATCH ([B] int, B = BH // num_heads):
    keys visible to query row 0. Returns o [BH, q_len, D]."""
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    if q.is_cuda:
        lengths = lengths.reshape(-1).to(device=q.device, dtype=torch.int32)
        q = q.contiguous()
        _check(q, k_cache, v_cache, lengths, num_heads)
        # the kernel reads q, K and V 16 bytes at a time
        k_cache, v_cache = _build.aligned(k_cache), _build.aligned(v_cache)
        return decode_in_slices(
            q, lengths, lambda qs, ls: _launch(_build.aligned(qs), k_cache,
                                               v_cache, ls, scale,
                                               num_heads))
    per_bh = lengths.reshape(-1).repeat_interleave(num_heads)
    return decode_attention_reference(q, k_cache, v_cache, per_bh, scale)


flash_attention_decode.launches = 0
