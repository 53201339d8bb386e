"""Generative-inference ops (counterpart of ``paddle_tpu/ops/generation.py``):
fused decode attention over a paged KV cache, bulk KV writes,
last-position gathers, in-program token sampling and the speculative
accept rule.

The KV caches are persistable scope state that these ops update IN PLACE
(the port's stand-in for the JAX package's buffer donation): the
``CacheKOut``/``CacheVOut``/``Out`` outputs are the input tensors
themselves. A slot whose ``SlotMask`` bit is 0 keeps its rows bit for bit.
"""
from __future__ import annotations

import torch

from .common import IOSpec, register_op, x
from .fused_attention import plain_requested


@register_op(
    "fused_decode_attention",
    inputs=[IOSpec("Q"), IOSpec("KNew"), IOSpec("VNew"),
            IOSpec("CacheK"), IOSpec("CacheV"),
            IOSpec("Positions", no_grad=True),
            IOSpec("SlotMask", optional=True, no_grad=True)],
    outputs=["Out", "CacheKOut", "CacheVOut"],
    attrs={"scale": 0.0, "page_size": 128},
    grad=None)
def _fused_decode_attention(ctx, ins, attrs):
    """One decode/verify chunk: append this chunk's K/V rows ([B, H, C, D])
    into the caches ([B, H, S_max, D]) at per-sequence ``Positions``
    ([B, 1], the length before the chunk) with per-row clamping, then
    attend the C query rows against the updated caches; row i sees keys
    at positions < pos + i + 1. ``page_size`` is the cache's page: the
    Hopper kernel needs no page tiling, so it only documents the layout."""
    from ..kernels import (decode_attention_reference, flash_attention_decode,
                           paged_kv_append_rows)

    q, kn, vn = x(ins, "Q"), x(ins, "KNew"), x(ins, "VNew")
    ck, cv = x(ins, "CacheK"), x(ins, "CacheV")
    pos, smask = x(ins, "Positions"), x(ins, "SlotMask")
    B, H, q_len, D = q.shape
    S = ck.shape[2]
    scale = attrs["scale"] or float(D) ** -0.5
    paged_kv_append_rows(ck, kn, pos, smask)
    paged_kv_append_rows(cv, vn, pos, smask)
    lengths = torch.clamp(pos.reshape(B).long() + 1, max=S)
    q3 = q.reshape(B * H, q_len, D)
    k3, v3 = ck.reshape(B * H, S, D), cv.reshape(B * H, S, D)
    if plain_requested():
        o = decode_attention_reference(
            q3, k3, v3, lengths.repeat_interleave(H), scale)
    else:
        o = flash_attention_decode(q3, k3, v3, lengths, scale=scale,
                                   num_heads=H)
    return {"Out": [o.reshape(B, H, q_len, D)],
            "CacheKOut": [ck], "CacheVOut": [cv]}


@register_op(
    "kv_cache_append",
    inputs=[IOSpec("Cache"), IOSpec("New"),
            IOSpec("Positions", no_grad=True),
            IOSpec("SlotMask", optional=True, no_grad=True)],
    outputs=["Out"],
    attrs={},
    grad=None)
def _kv_cache_append(ctx, ins, attrs):
    """Bulk KV write of ``New`` [B, H, L, D] into ``Cache`` at per-sequence
    ``Positions`` [B, 1] (the prefill writes a whole prompt bucket at
    position 0); ``SlotMask`` keeps unmasked sequences' rows."""
    from ..kernels import paged_kv_append

    return {"Out": [paged_kv_append(x(ins, "Cache"), x(ins, "New"),
                                    x(ins, "Positions"),
                                    x(ins, "SlotMask"))]}


@register_op(
    "spec_accept",
    inputs=[IOSpec("Sampled", no_grad=True), IOSpec("Drafts", no_grad=True),
            IOSpec("Start", no_grad=True)],
    outputs=["AcceptLen", "NewTok", "NewPos"],
    attrs={},
    grad=None)
def _spec_accept(ctx, ins, attrs):
    """Speculative accept rule: the longest prefix m on which the drafts
    ``Drafts`` [B, k-1] agree with the target's tokens ``Sampled`` [B, k]
    is accepted, plus the bonus token ``Sampled[:, m]``. Outputs
    ``AcceptLen`` = m, ``NewTok``, ``NewPos`` = ``Start + m + 1``."""
    s, d = x(ins, "Sampled"), x(ins, "Drafts")
    start = x(ins, "Start")
    B, k = s.shape
    if tuple(d.shape) != (B, k - 1):
        raise ValueError(
            f"spec_accept: Drafts must be [B, k-1] = [{B}, {k - 1}] for "
            f"Sampled [B, k] = {tuple(s.shape)}, got {tuple(d.shape)}")
    if k == 1:
        m = torch.zeros((B,), dtype=torch.int64, device=s.device)
    else:
        agree = (s[:, :k - 1] == d).long()
        m = torch.cumprod(agree, dim=1).sum(dim=1)
    new_tok = torch.gather(s.long(), 1, m[:, None])
    new_pos = start.reshape(B, 1).long() + m[:, None] + 1
    return {"AcceptLen": [m[:, None]], "NewTok": [new_tok],
            "NewPos": [new_pos]}


@register_op(
    "sequence_gather",
    inputs=[IOSpec("X"), IOSpec("Index", no_grad=True)],
    outputs=["Out"])
def _sequence_gather(ctx, ins, attrs):
    """Out[b] = X[b, Index[b]] along axis 1 (indices clamp into range)."""
    xv, idx = x(ins, "X"), x(ins, "Index")
    B = xv.shape[0]
    i = idx.reshape(B).long().clamp(0, xv.shape[1] - 1)
    return {"Out": [xv[torch.arange(B, device=xv.device), i]]}


@register_op(
    "sample_token",
    inputs=[IOSpec("Logits", no_grad=True)],
    outputs=["Out"],
    attrs={"strategy": "greedy", "temperature": 1.0, "top_k": 0},
    needs_rng=True,
    grad=None)
def _sample_token(ctx, ins, attrs):
    """Next token from ``Logits`` [B, V] -> ``Out`` [B, 1] int64: 'greedy'
    is argmax; 'sample' draws from softmax(logits / temperature),
    optionally truncated to the ``top_k`` largest logits, with the op's
    own generator (reproducible for a fixed ``program.random_seed``)."""
    logits = x(ins, "Logits").float()
    strategy = str(attrs.get("strategy", "greedy"))
    if strategy == "greedy":
        tok = torch.argmax(logits, dim=-1)
    elif strategy == "sample":
        if logits.is_meta:
            return {"Out": [torch.empty((logits.shape[0], 1),
                                        dtype=torch.int64, device="meta")]}
        scaled = logits / max(float(attrs.get("temperature", 1.0)), 1e-6)
        k = int(attrs.get("top_k", 0))
        if k > 0:
            k = min(k, scaled.shape[-1])
            thresh = torch.topk(scaled, k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled >= thresh, scaled,
                                 torch.full_like(scaled, -1e30))
        probs = torch.softmax(scaled, dim=-1)
        tok = torch.multinomial(probs, 1, generator=ctx.generator())[:, 0]
    else:
        raise ValueError(f"sample_token: unknown strategy '{strategy}' "
                         f"(expected 'greedy' or 'sample')")
    return {"Out": [tok.long()[:, None]]}
