"""Flash-attention forward: the hand-written Hopper kernel (K1) and its
plain PyTorch version.

Counterpart of ``paddle_tpu/kernels/flash_attention.py`` (the forward
``_fwd_kernel``). Layout is the JAX package's: ``[B*H, S, D]`` head-major
tensors, an additive ``[B, Sk]`` key bias indexed by ``bh // num_heads``,
causal on global positions ``q_offset + i >= k_offset + j``. Returns
``(o, lse)``; a row that sees no key gives o = 0 and lse = -inf.

Routing: a CPU (or meta) tensor goes to :func:`flash_attention_reference`;
a CUDA tensor launches ``csrc/flash_attention_fwd.cu`` or raises. The
kernel masks the ragged edges itself, so any ``Sq, Sk >= 1`` works and
:func:`classify_shapes` only bounds the head dim.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "classify_shapes"]

NEG_INF = -1e30          # finite sentinel, as the reference kernel uses
MAX_HEAD_DIM = 128


def classify_shapes(sq: int, sk: int, head_dim: int):
    """``('prefill', why)`` when the Hopper kernel takes the shape, else
    ``('unsupported', reason)``. Unlike the TPU kernel it needs no block
    divisibility: the ragged edge is masked in-kernel."""
    bad = []
    if sq < 1 or sk < 1:
        bad.append(f"sequence lengths must be >= 1 (sq={sq}, sk={sk})")
    if head_dim < 8 or head_dim > MAX_HEAD_DIM or head_dim % 8:
        bad.append(f"head_dim={head_dim} must be a multiple of 8 in "
                   f"[8, {MAX_HEAD_DIM}]")
    if bad:
        return "unsupported", "; ".join(bad)
    return "prefill", (f"{-(-sq // 64)} q-tile(s) of 64 rows over {sk} "
                       f"key(s), ragged edges masked in-kernel")


def flash_attention_reference(q, k, v, bias=None, causal=False, scale=None,
                              q_offset=0, k_offset=0, num_heads=1):
    """Plain PyTorch version of the kernel: the torch twin of the JAX
    package's ``_primitive_attention`` plus the lse, with the kernel's
    dead-row rule. Computes in float32; o has q's dtype."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = float(scale if scale is not None else D ** -0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float().repeat_interleave(num_heads, dim=0)[:, None, :]
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kp = k_offset + torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~(qp >= kp)[None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    alive = m > NEG_INF * 0.5
    p = torch.exp(s - torch.where(alive, m, torch.zeros_like(m)))
    p = torch.where(s > NEG_INF * 0.5, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(o))
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(l[..., 0]),
                      torch.full_like(l[..., 0], float("-inf")))
    return o.to(q.dtype), lse


def _launch(q, k, v, bias, causal, scale, q_offset, k_offset, num_heads):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash attention: {name} must match q in dtype "
                             f"and device ({t.dtype}/{t.device} vs "
                             f"{q.dtype}/{q.device})")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash attention: want q [BH, Sq, D], k/v "
                         f"[BH, Sk, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    kind, why = classify_shapes(Sq, Sk, D)
    if kind == "unsupported":
        raise ValueError(f"flash attention kernel refuses the shape: {why}")
    if BH % num_heads:
        raise ValueError(f"BH={BH} is not a multiple of num_heads="
                         f"{num_heads}")
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32 \
                or tuple(bias.shape) != (BH // num_heads, Sk):
            raise ValueError(f"flash attention: bias must be float32 "
                             f"[{BH // num_heads}, {Sk}] on {q.device}, got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        bias = bias.contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  o.data_ptr(), lse.data_ptr(), BH, Sq, Sk, D,
                  int(num_heads), int(bool(causal)), float(scale),
                  int(q_offset), int(k_offset),
                  int(q.dtype == torch.bfloat16))
    flash_attention_with_lse.launches += 1
    return o, lse


def flash_attention_with_lse(q, k, v, bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             dropout_rate: float = 0.0, q_offset: int = 0,
                             k_offset: int = 0, num_heads: int = 1):
    """Flash attention over ``[B*H, S, D]`` tensors; returns (o, lse).
    A CUDA tensor launches the kernel (counted on ``.launches``); a CPU
    tensor takes the plain version. Dropout waits for the training slice
    and raises."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash attention with dropout > 0 arrives with the port's "
            "training slice (Philox dropout in the kernel)")
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    if q.is_cuda:
        return _launch(q, k, v, bias, causal, scale, q_offset, k_offset,
                       num_heads)
    return flash_attention_reference(q, k, v, bias, causal, scale,
                                     q_offset, k_offset, num_heads)


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    dropout_rate=0.0, num_heads=1):
    """Like :func:`flash_attention_with_lse` but returns only o."""
    return flash_attention_with_lse(q, k, v, bias=bias, causal=causal,
                                    scale=scale, dropout_rate=dropout_rate,
                                    num_heads=num_heads)[0]
