"""Flash attention: the hand-written Hopper kernels and their plain PyTorch
versions.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. Three kernels:

* K1, ``csrc/flash_attention_fwd.cu`` — the forward ``_fwd_kernel``;
* K3, ``csrc/flash_attention_dq.cu`` — ``_dq_kernel``;
* K4, ``csrc/flash_attention_dkv.cu`` — ``_dkv_kernel``.

Layout is the JAX package's: ``[B*H, S, D]`` head-major tensors, an
additive ``[B, Sk]`` key bias indexed by ``bh // num_heads``, causal on
global positions ``q_offset + i >= k_offset + j``. The forward returns
``(o, lse)``; a row that sees no key gives o = 0 and lse = -inf, and zero
gradients. :func:`flash_attention_with_lse` is a ``torch.autograd.Function``
whose backward takes cotangents for both o and lse (``delta = rowsum(dO∘O)
− dlse``) and recomputes ``P = exp(S − lse)`` from the saved lse.

Dropout is Philox4x32-10 keyed on ``(seed, bh, row, col)`` (counter
``(col, row, bh, 0)``, key ``(seed, 0)``, first output word): element
(row, col) is kept iff that word ``>= round(rate * 2**32)``, and kept
probabilities are scaled by ``1 / (1 - rate)`` after the softmax
normaliser is summed. The mask does not depend on the tiling, so the
three kernels and :func:`dropout_keep` drop the same elements bit for bit.
The TPU kernel reseeds its own PRNG per block instead, so its bits differ.

Routing: a CPU (or meta) tensor takes the plain versions; a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "flash_attention_dq",
           "flash_attention_dkv", "flash_attention_dq_reference",
           "flash_attention_dkv_reference", "classify_shapes",
           "classify_backward_shapes", "philox4x32_10", "dropout_keep"]

NEG_INF = -1e30          # finite sentinel, as the reference kernel uses
MAX_HEAD_DIM = 128

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


# ----------------------------------------------------------------- Philox
def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * x`` for a 32-bit constant ``m`` and
    int64 tensors holding 32-bit values, without int64 overflow: x splits
    into 16-bit halves, each partial product fits in 48 bits."""
    p0 = m * (x & 0xFFFF)
    p1 = m * (x >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (t >> 32) + (p1 >> 16), t & _U32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) over Python ints or
    broadcastable int64 tensors holding 32-bit words; returns the four
    output words."""
    c0, c1, c2, c3, k0, k1 = (v & _U32 for v in (c0, c1, c2, c3, k0, k1))
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """The 32-bit threshold: an element is kept iff its word >= this."""
    return min(int(round(float(rate) * 2.0 ** 32)), _U32)


def dropout_keep(seed: int, bh: int, sq: int, sk: int, rate: float,
                 device=None) -> torch.Tensor:
    """Bool keep mask ``[bh, sq, sk]`` of attention dropout, the same
    function the kernels compute per element."""
    cols = torch.arange(sk, dtype=torch.int64, device=device)[None, None, :]
    rows = torch.arange(sq, dtype=torch.int64, device=device)[None, :, None]
    heads = torch.arange(bh, dtype=torch.int64, device=device)[:, None, None]
    word = philox4x32_10(cols, rows, heads, 0, int(seed) & _U32, 0)[0]
    return word >= dropout_threshold(rate)


def _drop_scale(rate: float) -> float:
    """What a kept probability is multiplied by (0.0: no dropout)."""
    return 1.0 / (1.0 - rate) if rate > 0.0 else 0.0


def _drop_args(rate: float, seed: int):
    """(seed, threshold, scale) as the kernels take them: 32-bit words
    passed as C ints (two's complement), scale 0 meaning no dropout."""
    def i32(v):
        v &= _U32
        return v - (1 << 32) if v >= 1 << 31 else v

    return (i32(int(seed)), i32(dropout_threshold(rate) if rate > 0 else 0),
            float(_drop_scale(rate)))


# ----------------------------------------------------------------- shapes
def _shape_problems(sq: int, sk: int, head_dim: int):
    bad = []
    if sq < 1 or sk < 1:
        bad.append(f"sequence lengths must be >= 1 (sq={sq}, sk={sk})")
    if head_dim < 8 or head_dim > MAX_HEAD_DIM or head_dim % 8:
        bad.append(f"head_dim={head_dim} must be a multiple of 8 in "
                   f"[8, {MAX_HEAD_DIM}]")
    return "; ".join(bad)


def classify_shapes(sq: int, sk: int, head_dim: int):
    """``('prefill', why)`` when K1 takes the shape, else
    ``('unsupported', reason)``. Unlike the TPU kernel it needs no block
    divisibility: the ragged edge is masked in-kernel. K1 is compiled for
    head dims 64 and 128; a smaller multiple of 8 is zero-padded up to the
    next one as its tiles load."""
    bad = _shape_problems(sq, sk, head_dim)
    if bad:
        return "unsupported", bad
    padded = 64 if head_dim <= 64 else 128
    return "prefill", (f"{-(-sq // 64)} q-tile(s) of 64 rows over {sk} "
                       f"key(s), ragged edges masked in-kernel, head_dim "
                       f"{head_dim} run as {padded}")


def classify_backward_shapes(sq: int, sk: int, head_dim: int):
    """``('backward', why)`` when K3 and K4 take the shape, else
    ``('unsupported', reason)``. Like K1 they need no block divisibility
    (ragged edges are masked in-kernel) and are compiled for head dims 64
    and 128, a smaller multiple of 8 zero-padded up to the next one as
    their tiles load."""
    bad = _shape_problems(sq, sk, head_dim)
    if bad:
        return "unsupported", bad
    padded = 64 if head_dim <= 64 else 128
    return "backward", (f"K3: {-(-sq // 64)} q-tile(s) of 64 rows over "
                        f"{sk} key(s); K4: {-(-sk // 64)} k-tile(s) of 64 "
                        f"rows over {sq} query row(s); head_dim {head_dim} "
                        f"run as {padded}")


# ----------------------------------------------------------- plain versions
def _scores(q, k, bias, causal, scale, q_offset, k_offset, num_heads):
    """Masked f32 scores ``[BH, Sq, Sk]``."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float().repeat_interleave(num_heads, dim=0)[:, None, :]
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kp = k_offset + torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~(qp >= kp)[None], NEG_INF)
    return s


def _keep(q, k, dropout_rate, seed):
    return dropout_keep(seed, q.shape[0], q.shape[1], k.shape[1],
                        dropout_rate, device=q.device)


def flash_attention_reference(q, k, v, bias=None, causal=False, scale=None,
                              q_offset=0, k_offset=0, num_heads=1,
                              dropout_rate=0.0, seed=0):
    """Plain PyTorch version of K1: the torch twin of the JAX package's
    ``_primitive_attention`` plus the lse, with the kernel's dead-row rule
    and dropout mask. Computes in float32, with the dropped P cast to the
    operand type before P.V as the JAX kernel casts it (a no-op in
    float32); o has q's dtype. Differentiable by autograd (the
    ``FLAGS_use_flash_attention=never`` route)."""
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    s = _scores(q, k, bias, causal, scale, q_offset, k_offset, num_heads)
    m = s.amax(dim=-1, keepdim=True)
    alive = m > NEG_INF * 0.5
    p = torch.exp(s - torch.where(alive, m, torch.zeros_like(m)))
    p = torch.where(s > NEG_INF * 0.5, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = torch.where(_keep(q, k, dropout_rate, seed),
                        p * _drop_scale(dropout_rate), torch.zeros_like(p))
    # P (dropped) in the operand type before P.V, as _fwd_kernel casts it
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(o))
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(l[..., 0]),
                      torch.full_like(l[..., 0], float("-inf")))
    return o.to(q.dtype), lse


def _bwd_terms(q, k, v, bias, do, lse, delta, causal, scale, dropout_rate,
               seed, q_offset, k_offset, num_heads):
    """P recomputed from lse (dead rows: P = 0), the dropped dP and
    dS = P ∘ (dP − delta), all f32 ``[BH, Sq, Sk]``; plus the keep mask."""
    s = _scores(q, k, bias, causal, scale, q_offset, k_offset, num_heads)
    lse_safe = torch.where(torch.isfinite(lse), lse,
                           torch.full_like(lse, -NEG_INF))
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    keep = None
    if dropout_rate > 0.0:
        keep = _keep(q, k, dropout_rate, seed)
        dp = torch.where(keep, dp * _drop_scale(dropout_rate),
                         torch.zeros_like(dp))
    ds = p * (dp - delta[..., None])
    return p, ds, keep


def flash_attention_dq_reference(q, k, v, bias, do, lse, delta, causal=False,
                                 scale=None, dropout_rate=0.0, seed=0,
                                 q_offset=0, k_offset=0, num_heads=1):
    """Plain PyTorch version of K3: ``dQ = scale · dS K``. dS is rounded
    to k's type before the product, where the JAX kernel casts it
    (``ds.astype(k_ref.dtype)``): a no-op in float32, one bf16 rounding per
    element in bfloat16, as the kernel's tensor-core route does."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    _, ds, _ = _bwd_terms(q, k, v, bias, do, lse, delta, causal, scale,
                          dropout_rate, seed, q_offset, k_offset, num_heads)
    ds = ds.to(k.dtype).float()
    return (scale * torch.einsum("bqk,bkd->bqd", ds, k.float())).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, bias, do, lse, delta,
                                  causal=False, scale=None, dropout_rate=0.0,
                                  seed=0, q_offset=0, k_offset=0,
                                  num_heads=1):
    """Plain PyTorch version of K4: ``dK = scale · dSᵀ Q`` and
    ``dV = P_droppedᵀ dO``. dS and P_dropped are rounded to the type of the
    operand they meet before each product, where the JAX kernel casts them
    (``ds.astype(q.dtype)``, ``p_used.astype(do.dtype)``): a no-op in
    float32, one bf16 rounding per element in bfloat16."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    p, ds, keep = _bwd_terms(q, k, v, bias, do, lse, delta, causal, scale,
                             dropout_rate, seed, q_offset, k_offset,
                             num_heads)
    if keep is not None:
        p = torch.where(keep, p * _drop_scale(dropout_rate),
                        torch.zeros_like(p))
    p, ds = p.to(do.dtype).float(), ds.to(q.dtype).float()
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels
def _check(q, k, v, bias, num_heads, *more):
    """Validate what every kernel takes; returns contiguous tensors."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)) + tuple(more):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash attention: {name} must match q in dtype "
                             f"and device ({t.dtype}/{t.device} vs "
                             f"{q.dtype}/{q.device})")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash attention: want q [BH, Sq, D], k/v "
                         f"[BH, Sk, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in more:
        if t.shape != q.shape:
            raise ValueError(f"flash attention: {name} must have q's shape "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
    BH, Sk = q.shape[0], k.shape[1]
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
    return (q.contiguous(), k.contiguous(), v.contiguous(), bias,
            *(t.contiguous() for _, t in more))


def _rows(name, t, q):
    if t.dtype != torch.float32 or t.device != q.device \
            or tuple(t.shape) != tuple(q.shape[:2]):
        raise ValueError(f"flash attention: {name} must be float32 "
                         f"{tuple(q.shape[:2])} on {q.device}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _run_k1(q, k, v, bias, causal, scale, q_offset, k_offset, num_heads,
            dropout_rate, seed):
    """Launch K1 on checked tensors and count it."""
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  o.data_ptr(), lse.data_ptr(), BH, Sq, Sk, D,
                  int(num_heads), int(bool(causal)), float(scale),
                  int(q_offset), int(k_offset),
                  int(q.dtype == torch.bfloat16),
                  *_drop_args(dropout_rate, seed))
    flash_attention_with_lse.launches += 1
    return o, lse


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], causal: bool, scale: float,
            q_offset: int, k_offset: int, num_heads: int,
            dropout_rate: float, seed: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as a PyTorch operator, so ``torch.export`` traces it as one
    node of the graph (its ctypes launch on raw pointers cannot be
    traced) and an exported program still launches and counts it."""
    return _run_k1(q, k, v, bias, causal, scale, q_offset, k_offset,
                   num_heads, dropout_rate, seed)


@_fwd_op.register_fake
def _(q, k, v, bias, causal, scale, q_offset, k_offset, num_heads,
      dropout_rate, seed):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _launch_fwd(q, k, v, bias, causal, scale, q_offset, k_offset, num_heads,
                dropout_rate, seed):
    q, k, v, bias = _check(q, k, v, bias, num_heads)
    kind, why = classify_shapes(q.shape[1], k.shape[1], q.shape[2])
    if kind == "unsupported":
        raise ValueError(f"flash attention kernel refuses the shape: {why}")
    return _fwd_op(q, k, v, bias, bool(causal), float(scale), int(q_offset),
                   int(k_offset), int(num_heads), float(dropout_rate),
                   int(seed))


def _launch_bwd(name, n_out, q, k, v, bias, do, lse, delta, causal, scale,
                dropout_rate, seed, q_offset, k_offset, num_heads):
    q, k, v, bias, do = _check(q, k, v, bias, num_heads, ("do", do))
    q, k, v, do = (_build.aligned(t) for t in (q, k, v, do))
    lse, delta = _rows("lse", lse, q), _rows("delta", delta, q)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    kind, why = classify_backward_shapes(Sq, Sk, D)
    if kind == "unsupported":
        raise ValueError(f"flash attention backward kernels refuse the "
                         f"shape: {why}")
    outs = [torch.empty_like(q if n_out == 1 else k) for _ in range(n_out)]
    _build.launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  *(t.data_ptr() for t in outs), BH, Sq, Sk, D,
                  int(num_heads), int(bool(causal)), float(scale),
                  int(q_offset), int(k_offset),
                  int(q.dtype == torch.bfloat16),
                  *_drop_args(dropout_rate, seed))
    return outs


def flash_attention_dq(q, k, v, bias, do, lse, delta, causal=False,
                       scale=None, dropout_rate=0.0, seed=0, q_offset=0,
                       k_offset=0, num_heads=1):
    """dQ of flash attention: K3 on a CUDA tensor (counted on
    ``.launches``), the plain version on a CPU tensor."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if not q.is_cuda:
        return flash_attention_dq_reference(
            q, k, v, bias, do, lse, delta, causal, scale, dropout_rate, seed,
            q_offset, k_offset, num_heads)
    (dq,) = _launch_bwd("flash_attention_dq", 1, q, k, v, bias, do, lse,
                        delta, causal, scale, dropout_rate, seed, q_offset,
                        k_offset, num_heads)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, bias, do, lse, delta, causal=False,
                        scale=None, dropout_rate=0.0, seed=0, q_offset=0,
                        k_offset=0, num_heads=1):
    """(dK, dV) of flash attention: K4 on a CUDA tensor (counted on
    ``.launches``), the plain version on a CPU tensor."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if not q.is_cuda:
        return flash_attention_dkv_reference(
            q, k, v, bias, do, lse, delta, causal, scale, dropout_rate, seed,
            q_offset, k_offset, num_heads)
    dk, dv = _launch_bwd("flash_attention_dkv", 2, q, k, v, bias, do, lse,
                         delta, causal, scale, dropout_rate, seed, q_offset,
                         k_offset, num_heads)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K3 + K4 backward (plain versions off the card)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cfg):
        causal, scale, dropout_rate, seed, q_offset, k_offset, num_heads = cfg
        if q.is_cuda:
            o, lse = _launch_fwd(q, k, v, bias, causal, scale, q_offset,
                                 k_offset, num_heads, dropout_rate, seed)
        else:
            o, lse = flash_attention_reference(
                q, k, v, bias, causal, scale, q_offset, k_offset, num_heads,
                dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        causal, scale, dropout_rate, seed, q_offset, k_offset, num_heads = \
            ctx.cfg
        if do is None:
            do = torch.zeros_like(o)
        # delta_i = rowsum(dO ∘ O) − dlse_i: d lse / dS = P, so the lse
        # cotangent joins the P-weighted term
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        args = (q, k, v, bias, do, lse, delta, causal, scale, dropout_rate,
                seed, q_offset, k_offset, num_heads)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             dropout_rate: float = 0.0, seed: int = 0,
                             q_offset: int = 0, k_offset: int = 0,
                             num_heads: int = 1):
    """Flash attention over ``[B*H, S, D]`` tensors; returns (o, lse),
    both differentiable. A CUDA tensor launches K1 (counted on
    ``.launches``) and, in the backward, K3 and K4; a CPU tensor takes the
    plain versions. ``seed`` keys the dropout mask."""
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    cfg = (bool(causal), scale, float(dropout_rate), int(seed),
           int(q_offset), int(k_offset), int(num_heads))
    return _FlashAttention.apply(q, k, v, bias, cfg)


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    dropout_rate=0.0, seed=0, num_heads=1):
    """Like :func:`flash_attention_with_lse` but returns only o."""
    return flash_attention_with_lse(q, k, v, bias=bias, causal=causal,
                                    scale=scale, dropout_rate=dropout_rate,
                                    seed=seed, num_heads=num_heads)[0]
