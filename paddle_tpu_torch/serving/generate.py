"""Generative serving: prefill/decode split scheduling over a GPT model.

Counterpart of ``paddle_tpu/serving/generate.py``, with its metrics,
spans and fault points. ``GenerativeEngine`` extends the batching
:class:`~paddle_tpu_torch.serving.engine.ServingEngine` and owns a fixed
set of batch slots over the programs of ``models.gpt.build_gpt_generative``:

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
* **speculative decoding** (``GenerationConfig.speculative``) — each
  round a host-side draft (prompt-lookup n-gram by default, swappable via
  ``engine.draft_fn``) proposes ``spec_k - 1`` tokens per slot and the
  verify program scores the whole chunk in ONE dispatch; ``spec_accept``
  commits the longest agreeing prefix plus the bonus token in-program.
  Near the KV capacity a round falls back to the plain decode chunk.
  Greedy speculative output equals plain decode wherever the model's
  top-2 logits are not tied at the rounding of the two dispatches (on
  the CPU: bit-exact).

Contract: every submitted request reaches EXACTLY ONE terminal outcome.
Deadlines apply per token: re-checked before every prefill and after
every decode chunk, so an expired stream settles ``DeadlineExceeded``
within ``decode_chunk`` tokens, its streamed tokens still readable.
An injected ``batch_dispatch`` fault fails exactly the streams of that
dispatch, typed ``BatchFailed``; a real executor failure mid-dispatch
fails every resident stream typed and resets the generation state (its
in-place KV writes may be half done).

The recompile guard (``decode_recompiles``) reads the executor's keys:
a new key for a (phase, bucket) program after its first is counted.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import monitor as _monitor
from .. import trace as _trace
from ..core.types import torch_dtype
from ..resilience import faults as _faults
from ..resilience.deadline import Deadline, DeadlineExceeded
from .engine import (DEFAULT_TENANT, BatchFailed, EngineStopped,
                     ServingConfig, ServingEngine, ServingFuture, _Request)

__all__ = ["GenerationConfig", "GenerativeEngine"]

logger = logging.getLogger("paddle_tpu_torch.serving")


@dataclasses.dataclass
class GenerationConfig:
    """Generative-scheduling knobs (the serving half; model geometry —
    slots, pages, buckets — lives on the ``build_gpt_generative`` dict)."""

    decode_chunk: int = 4          # tokens per chained decode dispatch;
    # also the deadline-enforcement granularity
    max_new_tokens_default: int = 16
    eos_id: int = -1               # < 0: no stop token
    # -- prefix-reuse KV cache --------------------------------------------
    prefix_cache: bool = True      # content-hash prompt pages, share them
    prefix_cache_pages: int = 64   # LRU bound on stored pages
    # -- chunked prefill -------------------------------------------------
    chunked_prefill: bool = True   # admit long/cold prompts slice by
    # slice between decode chunks instead of one monolithic prefill
    # -- speculative decoding --------------------------------------------
    speculative: bool = False      # draft k tokens, verify in one dispatch

    def resolve(self) -> "GenerationConfig":
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
    # chunked-prefill / prefix-reuse bookkeeping (dispatcher thread only)
    chunked: bool = False          # admitted via chunk slices
    prefilled: bool = False        # decode-eligible (prefill complete)
    prefix_rows: int = 0           # KV rows copied in from the prefix cache
    next_off: int = 0              # next prompt offset to prefill


class GenerativeEngine(ServingEngine):
    """See module docstring. ``model`` is a ``build_gpt_generative`` dict;
    parameters must already be initialized in ``scope`` (run the model's
    startup program first). Generation state (tokens/positions/KV pages)
    is planted and reset by the engine itself."""

    def __init__(self, model: dict, scope=None, place=None, executor=None,
                 config: Optional[ServingConfig] = None,
                 gen_config: Optional[GenerationConfig] = None):
        decode = model["decode"]
        super().__init__(decode["main"], feed_names=[],
                         fetch_list=[decode["next_token"]],
                         scope=scope, place=place, executor=executor,
                         config=config)
        self._model = model
        self.gen_config = (gen_config or GenerationConfig()).resolve()
        self._slots: List[Optional[_GenRequest]] = \
            [None] * int(model["batch_slots"])
        self._max_seq = int(model["max_seq"])
        self._page_size = int(model["page_size"])
        self._buckets = tuple(model["prompt_buckets"])
        # recompile guard: (phase, bucket) -> the executor keys of its
        # program once run; any LATER new key for it is a recompile
        self._compiled_buckets: Dict[tuple, bool] = {}
        self.decode_recompiles = 0
        # chunked prefill + speculative verify programs (a model dict
        # without them degrades to bucket prefill / plain decode)
        self._chunk = model.get("chunk")
        self._verify = model.get("verify")
        self._prefill_chunk = int(model.get("prefill_chunk") or
                                  self._page_size)
        self._spec_k = int(model.get("spec_k") or 0)
        self._cache_names = sorted(
            (n, "gpt_kv_v_" + n[len("gpt_kv_k_"):])
            for n in model["state_vars"] if n.startswith("gpt_kv_k_"))
        gc = self.gen_config
        self._prefix_cache = None
        if gc.prefix_cache and self._chunk is not None:
            from .prefix_cache import PrefixCache
            self._prefix_cache = PrefixCache(
                self._page_size, capacity_pages=gc.prefix_cache_pages)
        self._speculative = bool(
            gc.speculative and self._verify is not None and self._spec_k >= 2)
        # host-side draft proposer for speculative decoding: callable
        # (history_tokens: np.ndarray, n: int) -> n proposed tokens.
        # Default: prompt-lookup n-gram (see _ngram_draft). Swappable for
        # tests and for a real draft model.
        self.draft_fn = None
        self.prefill_chunks = 0    # chunk slices dispatched (per request)
        self.spec_chunks = 0       # verify dispatches
        self.spec_accepted = 0     # draft tokens accepted in total
        # phase -> [dispatches, units, host seconds to the fetched result]
        # (units: requests for prefill/chunk, steps for decode, positions
        # scored for verify)
        self._phase_time: Dict[str, list] = defaultdict(
            lambda: [0, 0, 0.0])

    # -- state lifecycle -------------------------------------------------
    def reset_generation_state(self) -> None:
        """Plant zeroed generation state (tokens, positions, KV pages) on
        the executor's device. Called at warm-up/start and after a real
        mid-dispatch failure (half-written state is never reused)."""
        dev = self._exe.device
        for name, (shape, dt) in self._model["state_vars"].items():
            self._scope.set_var(name, torch.zeros(
                shape, dtype=torch_dtype(dt), device=dev))

    def _ensure_state(self) -> None:
        for name in self._model["state_vars"]:
            if self._scope.find_var(name) is None:
                self.reset_generation_state()
                return

    def start(self) -> "GenerativeEngine":
        self._ensure_state()
        super().start()
        return self

    def warm_up(self, batch_sizes=None) -> int:
        """Run every (phase, bucket) program once before traffic: each
        prefill bucket with an all-zero slot mask (no slot is touched), one
        decode chunk, one chunk slice and one verify dispatch on scratch
        state. Seeds the recompile guard — after warm-up, steady-state
        decode must never record a new executor key.

        Unlike the base engine's stateless warm-up, this one RESETS the
        generation state and dispatches on the caller thread, so it must
        run before ``start()``: on a running engine it would zero resident
        streams' caches mid-generation while racing the dispatch thread —
        refused loudly instead."""
        with self._lock:
            if self._running:
                raise RuntimeError(
                    "serving: GenerativeEngine.warm_up resets the "
                    "generation state and cannot run on a started engine "
                    "(resident streams would silently decode from zeroed "
                    "caches); call it before start()")
        self.reset_generation_state()
        compiled = 0
        for bucket in self._buckets:
            net = self._model["prefill"][bucket]
            feed = self._prefill_feed(bucket, [])
            self._exe.run(net["main"], feed=feed,
                          fetch_list=[net["first_token"].name],
                          scope=self._scope)
            self._note_compiles("prefill", bucket, net["main"])
            compiled += 1
        self._exe.run_chained(self._program, feed={},
                              fetch_list=self._fetch_names,
                              steps=self.gen_config.decode_chunk,
                              scope=self._scope)
        self._note_compiles("decode", len(self._slots), self._program)
        compiled += 1
        if self._use_chunked():
            net = self._chunk
            self._exe.run(net["main"], feed=self._chunk_feed([]),
                          fetch_list=[net["first_token"].name],
                          scope=self._scope)
            self._note_compiles("chunk", self._prefill_chunk, net["main"])
            compiled += 1
        if self._speculative:
            net = self._verify
            self._exe.run(net["main"], feed=self._verify_feed([]),
                          fetch_list=[net["accept_len"].name,
                                      net["sampled"].name],
                          scope=self._scope)
            self._note_compiles("verify", self._spec_k, net["main"])
            compiled += 1
        self.reset_generation_state()
        return compiled

    def _use_chunked(self) -> bool:
        """Chunked prefill is live when the model ships a chunk program
        and either admission leg needs it (long-prompt slicing or the
        prefix cache's suffix prefill)."""
        return self._chunk is not None and (
            self.gen_config.chunked_prefill or self._prefix_cache is not None)

    # -- submission ------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               trace_parent=None,
               tenant: Optional[str] = None) -> ServingFuture:
        """Admit one generation request (any thread). ``prompt`` is a 1-D
        int token array (a ``[1, L]`` row is accepted); the returned
        future STREAMS tokens (``ServingFuture.stream()``) and settles
        exactly once with the full token array or a typed error.
        ``trace_parent`` parents the request root span and ``tenant``
        attributes the request in the per-tenant ledger (see
        ``ServingEngine.submit``)."""
        req = self._build_gen_request(prompt, max_new_tokens, priority,
                                      deadline_s, trace_parent, tenant)
        sub = _trace.start_span("serving.submit", parent=req.span,
                                priority=req.priority,
                                prompt_len=len(req.prompt))
        # the base engine's shared admission sequence: accounting, the
        # enqueue fault point, typed rejections, the dispatcher wake
        return self._admit_and_enqueue(req, sub)

    def _build_gen_request(self, prompt, max_new_tokens, priority,
                           deadline_s, trace_parent=None,
                           tenant=None) -> _GenRequest:
        prompt = np.asarray(prompt)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"serving: prompt must be a non-empty 1-D token array, "
                f"got shape {prompt.shape}")
        prompt = prompt.astype(np.int64)
        L = int(prompt.shape[0])
        bucket = next((b for b in self._buckets if b >= L), None)
        chunked = False
        if bucket is None:
            # past the largest bucket: chunked prefill admits it slice by
            # slice (no bucket program runs at this length)
            if not (self._chunk is not None
                    and self.gen_config.chunked_prefill):
                raise ValueError(
                    f"serving: prompt length {L} exceeds the largest "
                    f"prompt bucket {max(self._buckets)}; split or "
                    f"truncate the prompt (or enable chunked_prefill)")
            bucket, chunked = 0, True
        max_new = int(max_new_tokens
                      if max_new_tokens is not None
                      else self.gen_config.max_new_tokens_default)
        if max_new < 1:
            raise ValueError(f"serving: max_new_tokens must be >= 1, got "
                             f"{max_new}")
        if L + max_new > self._max_seq:
            raise ValueError(
                f"serving: prompt ({L}) + max_new_tokens ({max_new}) "
                f"exceeds the KV capacity max_seq {self._max_seq}")
        budget = self.config.deadline_s if deadline_s is None else deadline_s
        seq = next(ServingEngine._seq)
        dl = Deadline(budget, what=f"serving generation #{seq}") \
            if budget and budget > 0 else None
        tenant = str(tenant).strip() if tenant is not None else ""
        req = _GenRequest(seq=seq, feed={}, nrows=1,
                          sig=("gen", bucket or "chunk"),
                          priority=int(priority), deadline=dl,
                          submitted=self._now(), future=ServingFuture(),
                          tenant=tenant or DEFAULT_TENANT,
                          prompt=prompt, bucket=bucket, max_new=max_new,
                          chunked=chunked)
        req.span = self._request_root(trace_parent, seq=seq,
                                      prompt_len=L, max_new=max_new,
                                      priority=int(priority))
        req.future.trace_id = req.span.trace_id
        return req

    # -- scheduler -------------------------------------------------------
    def _dispatch_forever(self) -> None:
        self._current_batch = []
        while True:
            with self._lock:
                while (self._running and not self._queue
                       and not any(r is not None for r in self._slots)):
                    self._work.wait(timeout=0.05)
                    self._sweep_expired_locked(self._now())
                    self._update_pressure_locked(self._now())
                active = [r for r in self._slots if r is not None]
                stopping = not self._running and (
                    not self._drain or (not self._queue and not active))
                if stopping:
                    leftovers, self._queue = self._queue, []
                    self._slots = [None] * len(self._slots)
                    self._gauge_depth_locked()
                else:
                    now = self._now()
                    self._sweep_expired_locked(now)
                    self._update_pressure_locked(now)
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
            # the crash guard settles every RESIDENT request, not just the
            # ones inside one dispatch
            self._current_batch = [r for r in self._slots if r is not None]
            if newcomers:
                self._run_prefill(self._admit_newcomers(newcomers))
                self._current_batch = [r for r in self._slots
                                       if r is not None]
            # one chunk slice per pending chunked request per iteration,
            # INTERLEAVED with the resident decode chunk below — a long
            # cold prompt never stalls the decoders
            if any(r is not None and r.chunked and not r.prefilled
                   for r in self._slots):
                self._run_chunk_slices()
                self._current_batch = [r for r in self._slots
                                       if r is not None]
            if any(r is not None and r.prefilled for r in self._slots):
                if not (self._speculative and self._run_spec_chunk()):
                    self._run_decode_chunk()
                self._current_batch = [r for r in self._slots
                                       if r is not None]
            self._gauge_kv_occupancy()

    def _refill_locked(self) -> List[_GenRequest]:
        """Assign queued requests to free slots (FIFO). Runs under
        ``_lock``; the assigned requests count as dispatched from here on
        (the accounting's in-flight arm)."""
        free = [j for j, r in enumerate(self._slots) if r is None]
        taken: List[_GenRequest] = []
        while free and self._queue:
            r = self._queue.pop(0)
            r.slot = free.pop(0)
            self._slots[r.slot] = r
            self._dispatched += 1
            taken.append(r)
        if taken:
            self._gauge_depth_locked()
        return taken

    # -- admission: prefix reuse + chunked prefill -----------------------
    def _admit_newcomers(self,
                         newcomers: List[_GenRequest]) -> List[_GenRequest]:
        """Route just-seated requests: a prefix-cache hit copies the
        matched pages into the slot and prefills ONLY the suffix via
        chunk slices; an over-bucket prompt goes chunked from row 0;
        everything else takes the classic bucket prefill (returned)."""
        bucketed: List[_GenRequest] = []
        for r in newcomers:
            rows = 0
            if self._prefix_cache is not None:
                rows, entries = self._prefix_cache.match(r.prompt)
                if _monitor.enabled():
                    (_monitor.counter("serving_prefix_hits_total",
                                      "requests that reused >= 1 cached "
                                      "prefix page") if rows else
                     _monitor.counter("serving_prefix_misses_total",
                                      "requests with no cached prefix "
                                      "page")).inc()
                    if rows:
                        _monitor.counter(
                            "serving_prefix_pages_reused_total",
                            "KV pages served from the prefix cache"
                        ).inc(rows // self._page_size)
                if rows:
                    self._copy_in_prefix(r.slot, entries)
                    r.prefix_rows, r.next_off, r.chunked = rows, rows, True
                    continue
            if r.chunked:
                r.next_off = 0
            else:
                bucketed.append(r)
        return bucketed

    def _copy_in_prefix(self, slot: int, entries: List[dict]) -> None:
        """Copy matched prefix pages into ``slot``'s KV rows in place
        (copy-in, never aliasing: the resident owns its rows outright, so
        later divergence or store eviction can never corrupt it)."""
        P = self._page_size
        for li, (nk, nv) in enumerate(self._cache_names):
            for name, kv in ((nk, "k"), (nv, "v")):
                cache = self._scope.find_var(name)
                for i, e in enumerate(entries):
                    cache[slot, :, i * P:(i + 1) * P, :] = e[kv][li]

    def _publish_pages(self, r: _GenRequest) -> None:
        """After ``r``'s prefill completes, publish COPIES of its whole-
        page prompt rows under their chain hashes (cheap no-op for pages
        already stored)."""
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
        if _monitor.enabled():
            _monitor.gauge(
                "serving_prefix_pages",
                "KV pages resident in the prefix cache").set(
                float(len(self._prefix_cache)))

    def _deactivate_slot(self, slot: int) -> None:
        """Host-side decode-gate clear on retire: the slot's ``active``
        flag goes 0 so later decode/verify dispatches leave its state and
        cache rows untouched until the next admission re-arms it."""
        active = self._scope.find_var("gpt_gen_active")
        if active is not None:
            active[slot, 0] = 0.0

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
        into a single slot-masked dispatch. A prompt's final slice samples
        its first token in-program and flips the slot's decode gate."""
        pending = [r for r in self._slots
                   if r is not None and r.chunked and not r.prefilled]
        live: List[_GenRequest] = []
        for r in pending:
            if r.deadline is not None and r.deadline.expired:
                self._retire(r)
                self._settle_error(
                    r, "deadline_exceeded",
                    DeadlineExceeded(r.deadline.what, r.deadline.budget_s,
                                     r.deadline.elapsed()),
                    dispatched=True)
            else:
                live.append(r)
        if not live:
            return
        net = self._chunk
        span = _trace.NOOP_SPAN
        if _trace.enabled():
            span = _trace.root_span(
                "serving.prefill_chunk", requests=len(live),
                request_traces=",".join(r.span.trace_id for r in live))
        try:
            _faults.fault_point("batch_dispatch")
            feed = self._chunk_feed(live)
            t0 = time.perf_counter()
            with _trace.attach(span):
                outs = self._exe.run(net["main"], feed=feed,
                                     fetch_list=[net["first_token"].name],
                                     scope=self._scope)
            dt = time.perf_counter() - t0
        except _faults.InjectedFault as e:
            span.end(error=e)
            self._fail_group(live, e, phase="prefill_chunk")
            return
        except Exception as e:
            span.end(error=e)
            self._fail_all_resident(e, phase="prefill_chunk")
            return
        span.end()
        self._note_compiles("chunk", self._prefill_chunk, net["main"])
        self._time_phase("chunk", len(live), dt)
        self.prefill_chunks += len(live)
        if _monitor.enabled():
            _monitor.counter(
                "serving_prefill_chunks_total",
                "chunked-prefill slices dispatched (per request)"
            ).inc(len(live))
            _monitor.histogram(
                "serving_prefill_seconds",
                "wall time of one slot-masked prefill dispatch").observe(dt)
        first = np.asarray(outs[0]).reshape(len(self._slots))
        C = self._prefill_chunk
        for r in live:
            n = min(C, len(r.prompt) - r.next_off)
            r.next_off += n
            if r.next_off < len(r.prompt):
                continue
            r.prefilled = True
            self._publish_pages(r)
            if _monitor.enabled():
                _monitor.histogram(
                    "serving_first_token_seconds",
                    "submit-to-first-token latency (prefill + queue)"
                ).observe(self._now() - r.submitted)
            self._emit(r, [int(first[r.slot])], dt,
                       record_intertoken=False)

    # -- speculative decoding --------------------------------------------
    def _ngram_draft(self, hist: np.ndarray, n: int) -> List[int]:
        """Prompt-lookup drafting (model-free): find the most recent
        earlier occurrence of the last token and propose the tokens that
        followed it; pad by repeating. A wrong draft costs only its
        rejected verify rows — correctness rides on the verify dispatch,
        never the proposer."""
        last = int(hist[-1])
        prev = np.nonzero(hist[:-1] == last)[0]
        cand = hist[int(prev[-1]) + 1:int(prev[-1]) + 1 + n] \
            if prev.size else hist[:0]
        toks = [int(t) for t in cand]
        while len(toks) < n:
            toks.append(toks[-1] if toks else last)
        return toks

    def _draft(self, r: _GenRequest, n: int) -> List[int]:
        hist = np.concatenate(
            [r.prompt, np.asarray(r.out_tokens, np.int64)]) \
            if r.out_tokens else r.prompt
        if self.draft_fn is not None:
            toks = [int(t) for t in self.draft_fn(hist, n)]
            if len(toks) != n:
                raise ValueError(
                    f"serving: draft_fn returned {len(toks)} tokens, "
                    f"expected {n}")
            return toks
        return self._ngram_draft(hist, n)

    def _verify_feed(self, active: Sequence[_GenRequest]) -> dict:
        B, k = len(self._slots), self._spec_k
        feed = {
            "chunk_ids": np.zeros((B, k), np.int64),
            "chunk_pos": np.zeros((B, k), np.int64),
            "chunk_start": np.zeros((B, 1), np.int64),
            "slot_mask": np.zeros((B, 1), np.float32),
            "draft_ids": np.zeros((B, k - 1), np.int64),
        }
        for r in active:
            pos = len(r.prompt) + r.emitted - 1   # committed cache rows
            drafts = self._draft(r, k - 1)
            feed["chunk_ids"][r.slot, 0] = r.out_tokens[-1]
            feed["chunk_ids"][r.slot, 1:] = drafts
            feed["chunk_pos"][r.slot] = np.clip(
                pos + np.arange(k), 0, self._max_seq - 1)
            feed["chunk_start"][r.slot, 0] = pos
            feed["slot_mask"][r.slot, 0] = 1.0
            feed["draft_ids"][r.slot] = drafts
        return feed

    def _run_spec_chunk(self) -> bool:
        """One draft-then-verify round for every decode-eligible resident:
        the target scores the whole k-token chunk in ONE dispatch and
        commits the longest agreeing prefix + bonus token in-program.
        Returns False (caller falls back to the plain decode chunk) when
        any resident is too near its KV capacity for a full chunk."""
        active = [r for r in self._slots if r is not None and r.prefilled]
        k = self._spec_k
        if not active:
            return False
        for r in active:
            if len(r.prompt) + r.emitted - 1 + k > self._max_seq:
                return False
        span = _trace.NOOP_SPAN
        if _trace.enabled():
            span = _trace.root_span(
                "serving.spec_verify", k=k, requests=len(active),
                request_traces=",".join(r.span.trace_id for r in active))
        net = self._verify
        try:
            _faults.fault_point("batch_dispatch")
            feed = self._verify_feed(active)
            t0 = time.perf_counter()
            with _trace.attach(span):
                outs = self._exe.run(
                    net["main"], feed=feed,
                    fetch_list=[net["accept_len"].name,
                                net["sampled"].name],
                    scope=self._scope)
            dt = time.perf_counter() - t0
        except _faults.InjectedFault as e:
            span.end(error=e)
            self._fail_group(active, e, phase="spec_verify")
            return True
        except Exception as e:
            span.end(error=e)
            self._fail_all_resident(e, phase="spec_verify")
            return True
        span.end()
        self._note_compiles("verify", k, net["main"])
        self._time_phase("verify", k, dt)
        self.spec_chunks += 1
        accept = np.asarray(outs[0]).reshape(len(self._slots))
        sampled = np.asarray(outs[1]).reshape(len(self._slots), k)
        if _monitor.enabled():
            _monitor.histogram(
                "serving_decode_chunk_seconds",
                "wall time of one chained decode chunk").observe(dt)
        for r in active:
            if r.deadline is not None and r.deadline.expired:
                self._retire(r)
                self._settle_error(
                    r, "deadline_exceeded",
                    DeadlineExceeded(r.deadline.what, r.deadline.budget_s,
                                     r.deadline.elapsed()),
                    dispatched=True)
                continue
            m = int(accept[r.slot])
            self.spec_accepted += m
            if _monitor.enabled():
                _monitor.histogram(
                    "serving_spec_accepted_len",
                    "draft tokens accepted per verify chunk (0..k-1; the "
                    "bonus token is on top)").observe(float(m))
            take = sampled[r.slot, :m + 1][:r.max_new - r.emitted]
            eos = self.gen_config.eos_id
            if eos >= 0:
                hits = np.nonzero(take == eos)[0]
                if hits.size:
                    take = take[:int(hits[0]) + 1]
            self._emit(r, [int(t) for t in take], dt)
        return True

    # -- prefill ---------------------------------------------------------
    def _prefill_feed(self, bucket: int,
                      reqs: Sequence[_GenRequest]) -> dict:
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
            span = _trace.NOOP_SPAN
            if _trace.enabled():
                span = _trace.root_span(
                    "serving.prefill", bucket=bucket, requests=len(reqs),
                    request_traces=",".join(r.span.trace_id for r in reqs))
                for r in reqs:
                    r.dispatch_span = _trace.start_span(
                        "serving.dispatch", parent=r.span, phase="prefill",
                        bucket=bucket, slot=r.slot)
            try:
                _faults.fault_point("batch_dispatch")
                feed = self._prefill_feed(bucket, reqs)
                t0 = time.perf_counter()
                with _trace.attach(span):
                    outs = self._exe.run(net["main"], feed=feed,
                                         fetch_list=[net["first_token"].name],
                                         scope=self._scope)
                dt = time.perf_counter() - t0
            except _faults.InjectedFault as e:
                # fired before any dispatch: state intact, only this
                # group fails (typed) — the engine keeps serving
                span.end(error=e)
                self._fail_group(reqs, e, phase="prefill")
                continue
            except Exception as e:
                # a real failure may have half-written the state in place:
                # fail every resident stream typed + reset the state
                span.end(error=e)
                self._fail_all_resident(e, phase="prefill")
                return
            span.end()
            self._note_compiles("prefill", bucket, net["main"])
            self._time_phase("prefill", len(reqs), dt)
            if _monitor.enabled():
                _monitor.histogram(
                    "serving_prefill_seconds",
                    "wall time of one slot-masked prefill dispatch"
                ).observe(dt)
            first = np.asarray(outs[0]).reshape(len(self._slots))
            for r in reqs:
                r.prefilled = True
                r.next_off = len(r.prompt)
                self._publish_pages(r)
                if r.deadline is not None and r.deadline.expired:
                    self._retire(r)
                    self._settle_error(
                        r, "deadline_exceeded",
                        DeadlineExceeded(r.deadline.what,
                                         r.deadline.budget_s,
                                         r.deadline.elapsed()),
                        dispatched=True)
                    continue
                if _monitor.enabled():
                    _monitor.histogram(
                        "serving_first_token_seconds",
                        "submit-to-first-token latency (prefill + queue)"
                    ).observe(self._now() - r.submitted)
                # the first token's cost is the FIRST-TOKEN histogram's
                # story — it must not pollute the inter-token latency
                self._emit(r, [int(first[r.slot])], dt,
                           record_intertoken=False)

    # -- decode ----------------------------------------------------------
    def _run_decode_chunk(self) -> None:
        # only decode-eligible residents: slots mid-chunked-prefill keep
        # their in-program decode gate (``gpt_gen_active``) at 0, so the
        # dispatch leaves their state and cache rows bit-untouched
        active = [r for r in self._slots if r is not None and r.prefilled]
        steps = self.gen_config.decode_chunk
        span = _trace.NOOP_SPAN
        if _trace.enabled():
            span = _trace.root_span(
                "serving.decode", steps=steps, requests=len(active),
                request_traces=",".join(r.span.trace_id for r in active))
        try:
            _faults.fault_point("batch_dispatch")
            t0 = time.perf_counter()
            with _trace.attach(span):
                outs = self._exe.run_chained(
                    self._program, feed={}, fetch_list=self._fetch_names,
                    steps=steps, scope=self._scope)
            dt = time.perf_counter() - t0
        except _faults.InjectedFault as e:
            # the chaos gate's kill-one-batch: every stream in THIS batch
            # settles typed; state untouched (the fault fires before the
            # dispatch), freed slots are re-prefilled next iteration
            span.end(error=e)
            self._fail_group(active, e, phase="decode")
            return
        except Exception as e:
            span.end(error=e)
            self._fail_all_resident(e, phase="decode")
            return
        span.end()
        self._note_compiles("decode", len(self._slots), self._program)
        self._time_phase("decode", steps, dt)
        toks = np.asarray(outs[0]).reshape(steps, len(self._slots))
        per_tok = dt / steps
        if _monitor.enabled():
            _monitor.histogram(
                "serving_decode_chunk_seconds",
                "wall time of one chained decode chunk").observe(dt)
        for r in active:
            if r.deadline is not None and r.deadline.expired:
                # mid-stream expiry: the typed outcome is the LAST word —
                # this chunk's tokens are discarded, the ones already
                # streamed remain readable as partial results
                self._retire(r)
                self._settle_error(
                    r, "deadline_exceeded",
                    DeadlineExceeded(r.deadline.what, r.deadline.budget_s,
                                     r.deadline.elapsed()),
                    dispatched=True)
                continue
            take = toks[:r.max_new - r.emitted, r.slot]
            eos = self.gen_config.eos_id
            if eos >= 0:
                hits = np.nonzero(take == eos)[0]
                if hits.size:
                    take = take[:int(hits[0]) + 1]
            self._emit(r, [int(t) for t in take], per_tok * len(take))

    # -- shared settle paths ---------------------------------------------
    def _emit(self, r: _GenRequest, toks: List[int], dt: float,
              record_intertoken: bool = True) -> None:
        """Stream ``toks`` to the future (partial results) and settle the
        request when it reaches its token budget or stop token.
        ``record_intertoken=False`` on the prefill-produced first token:
        its cost belongs to ``serving_first_token_seconds``, not the
        inter-token distribution."""
        if toks:
            r.future._emit_tokens(toks)
            r.out_tokens.extend(toks)
            r.emitted += len(toks)
            if _monitor.enabled():
                _monitor.counter(
                    "serving_decode_tokens_total",
                    "tokens streamed to generative requests").inc(len(toks))
                if record_intertoken:
                    h = _monitor.histogram(
                        "serving_intertoken_seconds",
                        "per-token wall time within a decode chunk "
                        "(p50/p99 in the snapshot)")
                    for _ in toks:
                        h.observe(dt / len(toks))
        done = r.emitted >= r.max_new
        eos = self.gen_config.eos_id
        if not done and eos >= 0 and toks and toks[-1] == eos:
            done = True
        if done:
            self._retire(r)
            latency = self._now() - r.submitted
            with self._lock:
                self._acct["completed"] += 1
                self._dispatched -= 1
            self._record_outcome("completed")
            self._finish_request(r, "completed")
            if _monitor.enabled():
                _monitor.histogram(
                    "serving_request_latency_seconds",
                    "submit-to-response latency of completed requests "
                    "(p50/p99 in the snapshot)").observe(latency)
            r.future._settle(
                result=[np.asarray(r.out_tokens, dtype=np.int64)])

    def _retire(self, r: _GenRequest) -> None:
        if 0 <= r.slot < len(self._slots) and self._slots[r.slot] is r:
            self._slots[r.slot] = None
            self._deactivate_slot(r.slot)

    def _fail_group(self, reqs: List[_GenRequest], err: BaseException,
                    phase: str) -> None:
        logger.warning(
            "serving: %s dispatch of %d stream(s) failed (%s: %s) — "
            "failing those streams typed, engine continues",
            phase, len(reqs), type(err).__name__, err)
        if _monitor.enabled():
            _monitor.counter("serving_batches_total",
                             "dispatched batches by result").labels(
                result="failed").inc()
        for r in reqs:
            self._retire(r)
            e = BatchFailed(
                f"serving: {phase} batch failed for stream #{r.seq}: "
                f"{type(err).__name__}: {err}")
            e.__cause__ = err
            self._settle_error(r, "failed", e, dispatched=True)
        _trace.record_incident(
            "batch_failed", error=err,
            context=reqs[0].span if reqs else None,
            detail=f"generative {phase}, {len(reqs)} stream(s)")

    def _fail_all_resident(self, err: BaseException, phase: str) -> None:
        resident = [r for r in self._slots if r is not None]
        logger.error(
            "serving: %s dispatch raised %s — generation state may hold "
            "consumed buffers; failing all %d resident stream(s) typed "
            "and resetting the generation state",
            phase, type(err).__name__, len(resident))
        self._fail_group(resident, err, phase)
        self.reset_generation_state()

    def _time_phase(self, phase: str, units: int, seconds: float) -> None:
        rec = self._phase_time[phase]
        rec[0] += 1
        rec[1] += units
        rec[2] += seconds

    # -- observability ---------------------------------------------------
    def _program_steps(self, program) -> frozenset:
        """Identities of the executor keys belonging to ``program`` —
        run-path keys lead with the program fingerprint ``(serial, ...)``,
        chained keys with ``("chained", fingerprint, ...)``. Scoped per
        program so unrelated runs on a SHARED executor (a trainer thread,
        a sibling engine) can never read as this engine's recompiles."""
        serial = getattr(program, "_serial", None)
        with self._exe._lock:
            return frozenset(
                id(step) for key, step in self._exe._cache.items()
                if (key[0] == "chained" and key[1][0] == serial)
                or (isinstance(key[0], tuple) and key[0]
                    and key[0][0] == serial))

    def _note_compiles(self, phase: str, bucket: int, program) -> None:
        """The bucketed-recompile guard: a (phase, bucket) whose executor
        key already exists must NEVER get a new one — positions move,
        shapes don't. A NEW key appearing for this phase's program after
        its first is counted on ``serving_decode_recompiles_total`` and
        logged loudly."""
        key = (phase, int(bucket))
        steps = self._program_steps(program)
        prev = self._compiled_buckets.get(key)
        if prev is None:
            self._compiled_buckets[key] = steps
            return
        if steps - prev:
            self.decode_recompiles += 1
            logger.error(
                "serving: RECOMPILE on warm (phase=%s, bucket=%s) — a new "
                "executor key appeared for a program that was already "
                "run; KV growth must never reshape a decode dispatch",
                phase, bucket)
            if _monitor.enabled():
                _monitor.counter(
                    "serving_decode_recompiles_total",
                    "executable compiles beyond one per (phase, bucket) — "
                    "always a bug; gated to zero in CI").labels(
                    phase=phase, bucket=str(bucket)).inc()
            self._compiled_buckets[key] = prev | steps

    def _gauge_kv_occupancy(self) -> None:
        if not _monitor.enabled():
            return
        pages = self._max_seq // self._page_size
        used = 0
        for r in self._slots:
            if r is not None:
                length = min(len(r.prompt) + r.emitted, self._max_seq)
                used += -(-length // self._page_size)   # ceil
        _monitor.gauge(
            "serving_kv_page_occupancy",
            "fraction of KV cache pages held by resident sequences"
        ).set(used / (pages * len(self._slots)))

    def generation_stats(self) -> dict:
        """Decode-side snapshot for reports: resident slots, (phase,
        bucket) programs run, recompiles, prefix-cache and
        speculative-decoding counters, and per phase the dispatches, units
        (requests for prefill/chunk, steps for decode, positions for
        verify) and host seconds up to the fetched result."""
        resident = [r.seq for r in self._slots if r is not None]
        pc = self._prefix_cache
        return {
            "slots": len(self._slots),
            "resident": resident,
            "compiled_buckets": sorted(
                f"{p}:{b}" for (p, b) in self._compiled_buckets),
            "decode_recompiles": self.decode_recompiles,
            "max_seq": self._max_seq,
            "page_size": self._page_size,
            "prompt_buckets": list(self._buckets),
            "prefill_chunk": self._prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "prefix_cache": pc.stats() if pc is not None else None,
            "speculative": {
                "enabled": self._speculative,
                "k": self._spec_k if self._speculative else 0,
                "chunks": self.spec_chunks,
                "accepted_tokens": self.spec_accepted,
            },
            "phase_time": {p: {"dispatches": d, "units": u, "seconds": sec}
                           for p, (d, u, sec) in self._phase_time.items()},
        }
