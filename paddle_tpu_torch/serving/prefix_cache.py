"""Radix/prefix KV cache: content-addressed prompt pages shared across
requests. A copy of ``paddle_tpu/serving/prefix_cache.py`` (pure host
code); in the port the stored pages are device tensors.

LLM traffic is prefix-heavy — shared system prompts, few-shot templates,
multi-turn resubmissions all repeat the same leading tokens. The paged KV
layout already stores a prompt as whole ``page_size``-row blocks, so the
reusable unit is a PAGE and the identity of a page is the token content
of that page *and every page before it* (attention rows depend on the
whole preceding context). :class:`PrefixCache` therefore keys entries by
a **chain hash**::

    h_0 = sha256(page_0 token bytes)
    h_i = sha256(h_{i-1} || page_i token bytes)

so two prompts share cached pages exactly as far as their token streams
agree on whole-page boundaries — a radix-tree lookup flattened into one
hash map (the chain hash IS the path key).

Sharing is **copy-on-write by copy-in**: a hit copies the cached K/V rows
into the requester's slot pages, and a completed prefill publishes copies
of its freshly computed pages. Residents never alias the store, so

* divergence after a shared prefix (the mid-page CoW case) only ever
  mutates the resident's own slot pages, and
* eviction can never corrupt a resident mid-decode — the entry being
  dropped was a source of copies, not a shared mapping.

That trades copy bandwidth for an aliasing-proof invariant, the right
trade at host-side page sizes (a page is ``page_size * hidden`` floats
per layer). The store is bounded (``capacity_pages``) with LRU eviction
— an ``OrderedDict`` whose hits
``move_to_end`` and whose inserts pop the stalest entries past capacity.

The LAST prompt token is never cached: its logits produce the request's
first generated token, so the suffix after the matched pages is always
non-empty and every request still runs at least one (chunked) prefill
slice. Thread-safety is the engine's dispatcher-thread discipline — the
cache is only touched from the scheduling loop, like the slot table.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["PrefixCache"]


class PrefixCache:
    """Bounded chain-hash store of prompt KV pages.

    An entry holds ONE page of K/V rows per transformer layer (each
    ``[num_heads, page_size, head_dim]``), keyed by the chain hash of the
    prompt up to and including that page. ``capacity_pages`` bounds the
    total page count; inserts evict least-recently-used entries past it.
    """

    def __init__(self, page_size: int, capacity_pages: int = 64):
        if page_size < 1:
            raise ValueError(f"prefix cache: page_size must be >= 1, got "
                             f"{page_size}")
        if capacity_pages < 1:
            raise ValueError(f"prefix cache: capacity_pages must be >= 1, "
                             f"got {capacity_pages}")
        self.page_size = int(page_size)
        self.capacity_pages = int(capacity_pages)
        self._entries: "OrderedDict[bytes, dict]" = OrderedDict()
        # counters (read by the engine's stats/metrics)
        self.hits = 0            # requests that matched >= 1 page
        self.misses = 0          # requests that matched 0 pages
        self.pages_reused = 0    # total pages served from the store
        self.pages_inserted = 0
        self.evictions = 0

    # -- hashing ---------------------------------------------------------
    def _chain(self, prompt: np.ndarray) -> List[bytes]:
        """Chain hashes of every whole page of ``prompt[:-1]`` (the last
        token is never cached — it must produce the first logits)."""
        P = self.page_size
        n = (int(prompt.shape[0]) - 1) // P
        hashes, h = [], b""
        for i in range(n):
            page = np.ascontiguousarray(
                prompt[i * P:(i + 1) * P].astype(np.int64))
            h = hashlib.sha256(h + page.tobytes()).digest()
            hashes.append(h)
        return hashes

    # -- lookup / publish ------------------------------------------------
    def match(self, prompt: np.ndarray) -> Tuple[int, List[dict]]:
        """Longest cached prefix of ``prompt``: returns ``(rows,
        entries)`` where ``rows = len(entries) * page_size`` and each
        entry has ``"k"``/``"v"`` per-layer page arrays to copy into the
        requester's slot. Counts one hit (>= 1 page) or one miss."""
        matched: List[dict] = []
        for h in self._chain(np.asarray(prompt)):
            e = self._entries.get(h)
            if e is None:
                break
            self._entries.move_to_end(h)
            matched.append(e)
        if matched:
            self.hits += 1
            self.pages_reused += len(matched)
        else:
            self.misses += 1
        return len(matched) * self.page_size, matched

    def insert(self, prompt: np.ndarray, page_rows) -> int:
        """Publish the whole-page prefix of a freshly prefilled prompt.
        ``page_rows(page_index) -> (k_pages, v_pages)`` returns per-layer
        COPIES of the slot's cache rows ``[page*P, (page+1)*P)`` (each
        ``[num_heads, page_size, head_dim]``); it is only called for
        pages not already stored. Returns the number of new pages."""
        added = 0
        for i, h in enumerate(self._chain(np.asarray(prompt))):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            k_pages, v_pages = page_rows(i)
            self._entries[h] = {"k": list(k_pages), "v": list(v_pages)}
            self.pages_inserted += 1
            added += 1
        while len(self._entries) > self.capacity_pages:
            self._entries.popitem(last=False)
            self.evictions += 1
        return added

    # -- maintenance -----------------------------------------------------
    def evict_all(self) -> int:
        """Drop every entry (tests + admin reset). Safe at any time: the
        store is copy-in/copy-out, residents hold no references."""
        n = len(self._entries)
        self.evictions += n
        self._entries.clear()
        return n

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {
            "pages": len(self._entries),
            "capacity_pages": self.capacity_pages,
            "hits": self.hits,
            "misses": self.misses,
            "pages_reused": self.pages_reused,
            "pages_inserted": self.pages_inserted,
            "evictions": self.evictions,
        }
