"""Generative serving: prefill/decode split scheduling over a GPT model.

Counterpart of ``paddle_tpu/serving/generate.py``. ``GenerativeEngine``
owns a fixed set of batch slots over the programs of
``models.gpt.build_gpt_generative``:

* **prefill** — queued requests are admitted into free slots and
  prefilled as one slot-masked batch per prompt bucket; the prefill
  writes the slot's KV pages, merges its generation state and samples
  the request's FIRST token, streamed at once.
* **prefix reuse + chunked prefill** — admission matches the prompt
  against the content-hash :class:`~.prefix_cache.PrefixCache`; matched
  pages are COPIED into the slot's KV rows (device to device) and only
  the suffix is prefilled, one ``prefill_chunk``-token slice per
  scheduler iteration, interleaved with the resident decode chunks. The
  same path admits prompts longer than the largest bucket. Completed
  prefills publish copies of their pages.
* **decode** — every active slot advances ``decode_chunk`` tokens per
  dispatch through ``Executor.run_chained``; sampling is in-program, so
  no host round-trip separates the tokens of a chunk.

Contract: every submitted request reaches EXACTLY ONE terminal outcome.
Deadlines apply per token: re-checked before every prefill and after
every decode chunk, so an expired stream settles ``DeadlineExceeded``
within ``decode_chunk`` tokens, its streamed tokens still readable.

Speculative decoding in the engine waits for a later slice of the port
(the verify program and its ``spec_accept`` op are ported).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.types import torch_dtype
from .engine import (BatchFailed, EngineStopped, ServingConfig,
                     ServingEngine, ServingFuture, _Request)

__all__ = ["GenerationConfig", "GenerativeEngine"]

logger = logging.getLogger("paddle_tpu_torch.serving")


@dataclasses.dataclass
class GenerationConfig:
    """Generative-scheduling knobs (model geometry — slots, pages,
    buckets — lives on the ``build_gpt_generative`` dict)."""

    decode_chunk: int = 4          # tokens per chained decode dispatch
    max_new_tokens_default: int = 16
    eos_id: int = -1               # < 0: no stop token
    prefix_cache: bool = True
    prefix_cache_pages: int = 64
    chunked_prefill: bool = True
    speculative: bool = False

    def resolve(self) -> "GenerationConfig":
        if self.speculative:
            raise NotImplementedError(
                "GenerationConfig(speculative=True): speculative decoding in "
                "the engine arrives with the port's engine-services slice "
                "(the verify program and spec_accept op are already ported)")
        if self.decode_chunk < 1:
            raise ValueError(f"generation: decode_chunk must be >= 1, got "
                             f"{self.decode_chunk}")
        if self.max_new_tokens_default < 1:
            raise ValueError(f"generation: max_new_tokens_default must be "
                             f">= 1, got {self.max_new_tokens_default}")
        if self.prefix_cache_pages < 1:
            raise ValueError(f"generation: prefix_cache_pages must be >= 1, "
                             f"got {self.prefix_cache_pages}")
        return self


@dataclasses.dataclass
class _GenRequest(_Request):
    prompt: np.ndarray = None      # [L] int64
    bucket: int = 0                # prompt bucket (0: chunked-only admit)
    max_new: int = 1
    slot: int = -1                 # assigned batch slot, -1 while queued
    emitted: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    chunked: bool = False          # admitted via chunk slices
    prefilled: bool = False        # decode-eligible
    next_off: int = 0              # next prompt offset to prefill


class GenerativeEngine(ServingEngine):
    """``model`` is a ``build_gpt_generative`` dict; parameters must
    already be in ``scope`` (run the model's startup program first).
    Generation state (tokens/positions/KV pages) is planted and reset by
    the engine itself, on the executor's device."""

    def __init__(self, model: dict, scope=None, place=None, executor=None,
                 config: Optional[ServingConfig] = None,
                 gen_config: Optional[GenerationConfig] = None):
        self.gen_config = (gen_config or GenerationConfig()).resolve()
        decode = model["decode"]
        super().__init__(decode["main"], fetch_list=[decode["next_token"]],
                         scope=scope, place=place, executor=executor,
                         config=config)
        self._model = model
        self._slots: List[Optional[_GenRequest]] = \
            [None] * int(model["batch_slots"])
        self._max_seq = int(model["max_seq"])
        self._page_size = int(model["page_size"])
        self._buckets = tuple(model["prompt_buckets"])
        self._chunk = model.get("chunk")
        self._prefill_chunk = int(model.get("prefill_chunk") or
                                  self._page_size)
        self._cache_names = sorted(
            (n, "gpt_kv_v_" + n[len("gpt_kv_k_"):])
            for n in model["state_vars"] if n.startswith("gpt_kv_k_"))
        gc = self.gen_config
        self._prefix_cache = None
        if gc.prefix_cache and self._chunk is not None:
            from .prefix_cache import PrefixCache
            self._prefix_cache = PrefixCache(
                self._page_size, capacity_pages=gc.prefix_cache_pages)
        # (phase, bucket) programs run so far; there is no compile cache
        # to grow, so the recompile count stays 0
        self._compiled_buckets = set()
        self.decode_recompiles = 0
        self.prefill_chunks = 0
        # phase -> [dispatches, tokens or rows, host seconds to the fetch]
        self._phase_time: Dict[str, list] = defaultdict(
            lambda: [0, 0, 0.0])

    # -- state lifecycle -------------------------------------------------
    def reset_generation_state(self) -> None:
        """Plant zeroed generation state on the executor's device."""
        dev = self._exe.device
        for name, (shape, dt) in self._model["state_vars"].items():
            self._scope.set_var(name, torch.zeros(
                shape, dtype=torch_dtype(dt), device=dev))

    def _ensure_state(self) -> None:
        if any(self._scope.find_var(n) is None
               for n in self._model["state_vars"]):
            self.reset_generation_state()

    def start(self) -> "GenerativeEngine":
        self._ensure_state()
        super().start()
        return self

    def warm_up(self) -> int:
        """Run every (phase, bucket) program once before traffic (each
        prefill bucket with an all-zero slot mask, one decode chunk, one
        chunk slice), then reset the state. Refused on a started engine:
        it would zero resident streams' caches."""
        with self._lock:
            if self._running:
                raise RuntimeError(
                    "serving: GenerativeEngine.warm_up resets the "
                    "generation state and cannot run on a started engine; "
                    "call it before start()")
        self.reset_generation_state()
        n = 0
        for bucket in self._buckets:
            net = self._model["prefill"][bucket]
            self._exe.run(net["main"], feed=self._prefill_feed(bucket, []),
                          fetch_list=[net["first_token"].name],
                          scope=self._scope)
            self._compiled_buckets.add(("prefill", bucket))
            n += 1
        self._exe.run_chained(self._program, feed={},
                              fetch_list=self._fetch_names,
                              steps=self.gen_config.decode_chunk,
                              scope=self._scope)
        self._compiled_buckets.add(("decode", len(self._slots)))
        n += 1
        if self._use_chunked():
            net = self._chunk
            self._exe.run(net["main"], feed=self._chunk_feed([]),
                          fetch_list=[net["first_token"].name],
                          scope=self._scope)
            self._compiled_buckets.add(("chunk", self._prefill_chunk))
            n += 1
        self.reset_generation_state()
        return n

    def _use_chunked(self) -> bool:
        return self._chunk is not None and (
            self.gen_config.chunked_prefill or self._prefix_cache is not None)

    # -- submission ------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None) -> ServingFuture:
        """Admit one generation request (any thread). ``prompt`` is a 1-D
        int token array (a ``[1, L]`` row is accepted); the returned
        future streams tokens and settles exactly once with the full token
        array or a typed error."""
        prompt = np.asarray(prompt)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"serving: prompt must be a non-empty 1-D "
                             f"token array, got shape {prompt.shape}")
        prompt = prompt.astype(np.int64)
        L = int(prompt.shape[0])
        bucket = next((b for b in self._buckets if b >= L), None)
        chunked = False
        if bucket is None:
            if not (self._chunk is not None
                    and self.gen_config.chunked_prefill):
                raise ValueError(
                    f"serving: prompt length {L} exceeds the largest prompt "
                    f"bucket {max(self._buckets)}; split or truncate the "
                    f"prompt (or enable chunked_prefill)")
            bucket, chunked = 0, True
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.gen_config.max_new_tokens_default)
        if max_new < 1:
            raise ValueError(f"serving: max_new_tokens must be >= 1, got "
                             f"{max_new}")
        if L + max_new > self._max_seq:
            raise ValueError(
                f"serving: prompt ({L}) + max_new_tokens ({max_new}) exceeds "
                f"the KV capacity max_seq {self._max_seq}")
        seq = next(ServingEngine._seq)
        req = _GenRequest(
            seq=seq, priority=int(priority),
            deadline=self._deadline(deadline_s,
                                    f"serving generation #{seq}"),
            submitted=self._now(), future=ServingFuture(), prompt=prompt,
            bucket=bucket, max_new=max_new, chunked=chunked)
        return self._admit_and_enqueue(req)

    # -- scheduler -------------------------------------------------------
    def _dispatch_forever(self) -> None:
        while True:
            with self._lock:
                while (self._running and not self._queue
                       and not any(r is not None for r in self._slots)):
                    self._work.wait(timeout=0.05)
                    self._sweep_expired_locked()
                active = [r for r in self._slots if r is not None]
                stopping = not self._running and (
                    not self._drain or (not self._queue and not active))
                if stopping:
                    leftovers, self._queue = self._queue, []
                    self._slots = [None] * len(self._slots)
                else:
                    self._sweep_expired_locked()
                    newcomers = self._refill_locked()
            if stopping:
                for r in leftovers + active:
                    if not r.future.done():
                        self._settle_error(
                            r, "rejected_stopped",
                            EngineStopped("serving: engine stopped without "
                                          "draining"),
                            dispatched=(r in active))
                self._current_batch = []
                return
            self._current_batch = [r for r in self._slots if r is not None]
            if newcomers:
                self._run_prefill(self._admit_newcomers(newcomers))
            # one chunk slice per pending chunked request per iteration,
            # interleaved with the resident decode chunk
            if any(r is not None and r.chunked and not r.prefilled
                   for r in self._slots):
                self._run_chunk_slices()
            if any(r is not None and r.prefilled for r in self._slots):
                self._run_decode_chunk()
            self._current_batch = [r for r in self._slots if r is not None]

    def _refill_locked(self) -> List[_GenRequest]:
        """Seat queued requests in free slots, FIFO (under ``_lock``)."""
        free = [j for j, r in enumerate(self._slots) if r is None]
        taken: List[_GenRequest] = []
        while free and self._queue:
            r = self._queue.pop(0)
            r.slot = free.pop(0)
            self._slots[r.slot] = r
            self._dispatched += 1
            taken.append(r)
        return taken

    # -- admission: prefix reuse + chunked prefill -----------------------
    def _admit_newcomers(self, newcomers: List[_GenRequest]):
        """A prefix-cache hit copies the matched pages into the slot and
        prefills only the suffix via chunk slices; an over-bucket prompt
        goes chunked from row 0; the rest take the bucket prefill
        (returned)."""
        bucketed = []
        for r in newcomers:
            if self._prefix_cache is not None:
                rows, entries = self._prefix_cache.match(r.prompt)
                if rows:
                    self._copy_in_prefix(r.slot, entries)
                    r.next_off, r.chunked = rows, True
                    continue
            if r.chunked:
                r.next_off = 0
            else:
                bucketed.append(r)
        return bucketed

    def _copy_in_prefix(self, slot: int, entries: List[dict]) -> None:
        """Copy matched prefix pages into ``slot``'s KV rows in place
        (copy-in, never aliasing: the resident owns its rows)."""
        P = self._page_size
        for li, (nk, nv) in enumerate(self._cache_names):
            for name, kv in ((nk, "k"), (nv, "v")):
                cache = self._scope.find_var(name)
                for i, e in enumerate(entries):
                    cache[slot, :, i * P:(i + 1) * P, :] = e[kv][li]

    def _publish_pages(self, r: _GenRequest) -> None:
        """Publish COPIES of ``r``'s whole-page prompt rows."""
        if self._prefix_cache is None:
            return
        P, slot = self._page_size, r.slot

        def page_rows(i):
            rows = slice(i * P, (i + 1) * P)
            return ([self._scope.find_var(nk)[slot, :, rows, :].clone()
                     for nk, _ in self._cache_names],
                    [self._scope.find_var(nv)[slot, :, rows, :].clone()
                     for _, nv in self._cache_names])

        self._prefix_cache.insert(r.prompt, page_rows)

    def _deactivate_slot(self, slot: int) -> None:
        """Clear a retired slot's decode gate, so later dispatches leave
        its state and cache rows untouched."""
        active = self._scope.find_var("gpt_gen_active")
        if active is not None:
            active[slot, 0] = 0.0

    # -- dispatch helper -------------------------------------------------
    def _dispatch(self, phase: str, fn, units: int):
        """Run one dispatch; a failure fails every resident stream typed
        and resets the generation state (in-place state may be half
        written). Returns the fetches, or None after a failure."""
        t0 = time.perf_counter()
        try:
            outs = fn()
        except Exception as e:
            self._fail_all_resident(e, phase)
            return None
        rec = self._phase_time[phase]
        rec[0] += 1
        rec[1] += units
        rec[2] += time.perf_counter() - t0
        return outs

    # -- chunked prefill -------------------------------------------------
    def _chunk_feed(self, pending: Sequence[_GenRequest]) -> dict:
        B, C = len(self._slots), self._prefill_chunk
        feed = {
            "chunk_ids": np.zeros((B, C), np.int64),
            "chunk_pos": np.zeros((B, C), np.int64),
            "chunk_start": np.zeros((B, 1), np.int64),
            "chunk_len": np.ones((B, 1), np.int64),
            "slot_mask": np.zeros((B, 1), np.float32),
            "sample_mask": np.zeros((B, 1), np.float32),
        }
        for r in pending:
            off, L = r.next_off, len(r.prompt)
            take = r.prompt[off:off + C]
            n = len(take)
            feed["chunk_ids"][r.slot, :n] = take
            if n < C:
                feed["chunk_ids"][r.slot, n:] = take[-1]
            feed["chunk_pos"][r.slot] = np.clip(
                off + np.arange(C), 0, self._max_seq - 1)
            feed["chunk_start"][r.slot, 0] = off
            feed["chunk_len"][r.slot, 0] = n
            feed["slot_mask"][r.slot, 0] = 1.0
            if off + n >= L:
                feed["sample_mask"][r.slot, 0] = 1.0
        return feed

    def _run_chunk_slices(self) -> None:
        """One prefill slice for EVERY pending chunked request, batched
        into one slot-masked dispatch; a prompt's final slice samples its
        first token in-program and flips the slot's decode gate."""
        live = []
        for r in self._slots:
            if r is None or not r.chunked or r.prefilled:
                continue
            if r.deadline is not None and r.deadline.expired:
                self._retire(r)
                self._settle_expired(r, dispatched=True)
            else:
                live.append(r)
        if not live:
            return
        net = self._chunk
        outs = self._dispatch(
            "chunk",
            lambda: self._exe.run(net["main"], feed=self._chunk_feed(live),
                                  fetch_list=[net["first_token"].name],
                                  scope=self._scope),
            units=len(live))
        if outs is None:
            return
        self._compiled_buckets.add(("chunk", self._prefill_chunk))
        self.prefill_chunks += len(live)
        first = outs[0].reshape(len(self._slots))
        C = self._prefill_chunk
        for r in live:
            r.next_off += min(C, len(r.prompt) - r.next_off)
            if r.next_off < len(r.prompt):
                continue
            r.prefilled = True
            self._publish_pages(r)
            self._emit(r, [int(first[r.slot])])

    # -- prefill ---------------------------------------------------------
    def _prefill_feed(self, bucket: int, reqs: Sequence[_GenRequest]) -> dict:
        B = len(self._slots)
        feed = {
            "prompt_ids": np.zeros((B, bucket), np.int64),
            "prompt_pos": np.tile(np.arange(bucket, dtype=np.int64),
                                  (B, 1)),
            "prompt_mask": np.zeros((B, bucket), np.float32),
            "prompt_len": np.ones((B, 1), np.int64),
            "slot_mask": np.zeros((B, 1), np.float32),
        }
        for r in reqs:
            L = len(r.prompt)
            feed["prompt_ids"][r.slot, :L] = r.prompt
            feed["prompt_mask"][r.slot, :L] = 1.0
            feed["prompt_len"][r.slot, 0] = L
            feed["slot_mask"][r.slot, 0] = 1.0
        return feed

    def _run_prefill(self, newcomers: List[_GenRequest]) -> None:
        by_bucket = defaultdict(list)
        for r in newcomers:
            by_bucket[r.bucket].append(r)
        for bucket in sorted(by_bucket):
            reqs = by_bucket[bucket]
            net = self._model["prefill"][bucket]
            outs = self._dispatch(
                "prefill",
                lambda: self._exe.run(
                    net["main"], feed=self._prefill_feed(bucket, reqs),
                    fetch_list=[net["first_token"].name], scope=self._scope),
                units=len(reqs))
            if outs is None:
                return
            self._compiled_buckets.add(("prefill", bucket))
            first = outs[0].reshape(len(self._slots))
            for r in reqs:
                r.prefilled = True
                r.next_off = len(r.prompt)
                self._publish_pages(r)
                if r.deadline is not None and r.deadline.expired:
                    self._retire(r)
                    self._settle_expired(r, dispatched=True)
                    continue
                self._emit(r, [int(first[r.slot])])

    # -- decode ----------------------------------------------------------
    def _run_decode_chunk(self) -> None:
        # only decode-eligible residents: slots mid-chunked-prefill keep
        # their in-program decode gate at 0 and stay untouched
        active = [r for r in self._slots if r is not None and r.prefilled]
        steps = self.gen_config.decode_chunk
        outs = self._dispatch(
            "decode",
            lambda: self._exe.run_chained(
                self._program, feed={}, fetch_list=self._fetch_names,
                steps=steps, scope=self._scope),
            units=steps)
        if outs is None:
            return
        self._compiled_buckets.add(("decode", len(self._slots)))
        toks = outs[0].reshape(steps, len(self._slots))
        eos = self.gen_config.eos_id
        for r in active:
            if r.deadline is not None and r.deadline.expired:
                # the typed outcome is the LAST word: this chunk's tokens
                # are dropped, the ones already streamed stay readable
                self._retire(r)
                self._settle_expired(r, dispatched=True)
                continue
            take = toks[:r.max_new - r.emitted, r.slot]
            if eos >= 0:
                hits = np.nonzero(take == eos)[0]
                if hits.size:
                    take = take[:int(hits[0]) + 1]
            self._emit(r, [int(t) for t in take])

    # -- settle paths ----------------------------------------------------
    def _emit(self, r: _GenRequest, toks: List[int]) -> None:
        """Stream ``toks`` and settle the request at its token budget or
        stop token."""
        if toks:
            r.future._emit_tokens(toks)
            r.out_tokens.extend(toks)
            r.emitted += len(toks)
        eos = self.gen_config.eos_id
        if r.emitted >= r.max_new or (eos >= 0 and toks
                                      and toks[-1] == eos):
            self._retire(r)
            self._settle_completed(
                r, [np.asarray(r.out_tokens, dtype=np.int64)])

    def _retire(self, r: _GenRequest) -> None:
        if 0 <= r.slot < len(self._slots) and self._slots[r.slot] is r:
            self._slots[r.slot] = None
            self._deactivate_slot(r.slot)

    def _fail_all_resident(self, err: BaseException, phase: str) -> None:
        resident = [r for r in self._slots if r is not None]
        logger.error("serving: %s dispatch raised %s: %s — failing %d "
                     "resident stream(s) typed and resetting the generation "
                     "state", phase, type(err).__name__, err, len(resident))
        for r in resident:
            self._retire(r)
            e = BatchFailed(f"serving: {phase} dispatch failed for stream "
                            f"#{r.seq}: {type(err).__name__}: {err}")
            e.__cause__ = err
            self._settle_error(r, "failed", e, dispatched=True)
        self.reset_generation_state()

    # -- observability ---------------------------------------------------
    def generation_stats(self) -> dict:
        """Resident slots, programs run per (phase, bucket), prefix-cache
        counters, and per phase the dispatches, units (requests for
        prefill/chunk, steps for decode) and host seconds up to the
        fetched result."""
        pc = self._prefix_cache
        return {
            "slots": len(self._slots),
            "resident": [r.seq for r in self._slots if r is not None],
            "compiled_buckets": sorted(f"{p}:{b}"
                                       for p, b in self._compiled_buckets),
            "decode_recompiles": self.decode_recompiles,
            "max_seq": self._max_seq,
            "page_size": self._page_size,
            "prompt_buckets": list(self._buckets),
            "prefill_chunk": self._prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "prefix_cache": pc.stats() if pc is not None else None,
            "phase_time": {p: {"dispatches": d, "units": u, "seconds": s}
                           for p, (d, u, s) in self._phase_time.items()},
        }
