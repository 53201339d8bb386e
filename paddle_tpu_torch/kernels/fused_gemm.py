"""Fused GEMM + epilogue: the hand-written Hopper kernel (K5) and its plain
PyTorch version.

Counterpart of ``paddle_tpu/kernels/fused_gemm.py``. ``epilogue(x @ y)``
for ``x`` [M, K] and ``y`` [K, N] with an f32 accumulator; the epilogue
runs on the accumulator, in the order the fusion pass matched it in the
program: bias-add ``bias`` [N], ``relu`` or ``gelu`` (erf or tanh),
residual-add ``residual`` [M, N], row-wise layer_norm (``ln_scale`` /
``ln_bias`` [N], two-pass statistics), then one cast to ``out_dtype``.

* :func:`fused_gemm` — a CUDA tensor launches ``csrc/fused_gemm.cu`` at
  the given block triple (counted on ``.launches`` and, per triple, on
  ``.launches_by_blocks``) or raises; a CPU tensor takes
  :func:`fused_gemm_reference`, the plain version for every triple.
* :func:`classify_gemm` — what the Hopper kernel takes, with the failing
  constraint named. Its rules are the kernel's own, not the TPU's lane and
  sublane tiling: M, N and K need not divide into blocks (the kernel masks
  ragged edges; M up to 65535 row tiles), but N and K must be multiples of
  4 (x and y rows are copied into shared memory in 16-byte f32 / 8-byte
  bf16 chunks), the block triple must be one of :data:`COMPILED_BLOCKS`,
  and a layer_norm epilogue's 32 whole rows must fit in shared memory
  beside the k-tile ring.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["fused_gemm", "classify_gemm", "fused_gemm_reference",
           "DEFAULT_BLOCKS", "COMPILED_BLOCKS", "EPILOGUE_ACTIVATIONS"]

# (block_m, block_n, block_k) of the compiled GEMM tiles (the f32 route on
# CUDA cores and the bf16 route on tensor cores alike), k in 32-deep tiles
# through a ring in shared memory (the bf16 route takes them two at a
# time). DEFAULT_BLOCKS, 128 x 256 outputs a block, reuses each loaded
# element most; the smaller tiles give a small GEMM more blocks on the 132
# SMs. The autotuner (paddle_tpu_torch.tuning) chooses among them.
DEFAULT_BLOCKS = (128, 256, 32)
COMPILED_BLOCKS = (DEFAULT_BLOCKS, (128, 128, 32), (64, 128, 32),
                   (64, 64, 32))
EPILOGUE_ACTIVATIONS = ("none", "relu", "gelu")

# the layer_norm variants: 32 whole rows a block, parked in shared memory
# behind the k-tile ring
LN_ROWS = 32
# H100: shared memory one block may use (bytes), and the larger of the two
# layer_norm variants' rings (f32: 4 stages of an 8 x 32 x-tile, k-rows
# padded by 4, and an 8 x 256 y-tile; bf16: 3 stages of padded 32 x 32 and
# 32 x 128 tiles), as csrc/fused_gemm.cu asserts (LN_RING)
_SMEM_PER_BLOCK = 232448
_LN_RING_SMEM = 4 * (8 * (LN_ROWS + 4) + 8 * 256) * 4
# N above this leaves no room for the rows (1524)
LN_MAX_N = (_SMEM_PER_BLOCK - _LN_RING_SMEM) // (4 * LN_ROWS)

# row tiles run along the grid's y dimension
_MAX_ROW_TILES = 65535
_DTYPES = (torch.float32, torch.bfloat16)


def classify_gemm(m: int, n: int, k: int, *, layer_norm: bool = False,
                  block_m: int = DEFAULT_BLOCKS[0],
                  block_n: int = DEFAULT_BLOCKS[1],
                  block_k: int = DEFAULT_BLOCKS[2]) -> Tuple[str, str]:
    """``('supported' | 'unsupported', reason)``: whether the Hopper kernel
    takes an ``[m, k] @ [k, n]`` GEMM, and if not which constraint fails,
    so callers refuse loudly (``FLAGS_use_fused_gemm=always``) or replay
    the chain densely with the reason on record."""
    if min(m, n, k) < 1:
        return ("unsupported",
                f"GEMM dims must be >= 1: m={m}, n={n}, k={k}")
    if (block_m, block_n, block_k) not in COMPILED_BLOCKS:
        return ("unsupported",
                f"block_m={block_m}, block_n={block_n}, block_k={block_k} "
                f"has no compiled instantiation (csrc/fused_gemm.cu "
                f"compiles {list(COMPILED_BLOCKS)})")
    if -(-m // block_m) > _MAX_ROW_TILES:
        return ("unsupported",
                f"m={m} is more than {_MAX_ROW_TILES} row tiles of "
                f"{block_m} (the grid's y dimension)")
    bad = [f"{name}={v}" for name, v in (("n", n), ("k", k)) if v % 4]
    if bad:
        return ("unsupported",
                f"{' and '.join(bad)} not a multiple of 4: the kernel copies "
                f"x and y rows in 16-byte f32 / 8-byte bf16 chunks")
    if layer_norm and n > LN_MAX_N:
        return ("unsupported",
                f"layer_norm epilogue needs {LN_ROWS} whole rows in shared "
                f"memory: {LN_ROWS} x n={n} f32 is {LN_ROWS * n * 4} bytes, "
                f"above the {LN_MAX_N * LN_ROWS * 4} the H100 leaves beside "
                f"the k-tile ring (n <= {LN_MAX_N})")
    if layer_norm:
        return ("supported",
                f"{-(-m // LN_ROWS)} blocks of {LN_ROWS} whole rows with "
                f"layer_norm (the layer_norm variants keep their own "
                f"{LN_ROWS}-row tiles under every block triple)")
    return ("supported",
            f"{-(-m // block_m)} x {-(-n // block_n)} blocks of "
            f"({block_m}, {block_n}), k in tiles of {block_k}")


def _activation(acc, activation: str, gelu_approximate: bool):
    if activation == "relu":
        return torch.relu(acc)
    if activation == "gelu":
        return torch.nn.functional.gelu(
            acc, approximate="tanh" if gelu_approximate else "none")
    return acc


def fused_gemm_reference(x, y, bias=None, residual=None, ln_scale=None,
                         ln_bias=None, activation: str = "none",
                         gelu_approximate: bool = False,
                         layer_norm: bool = False, ln_eps: float = 1e-5,
                         out_dtype=None):
    """Plain PyTorch version with the kernel's numerics: an f32 product
    (bf16 inputs upcast first; a bf16 x bf16 product is exact in f32, so
    this is what an f32-accumulating kernel computes, where a bf16
    ``torch.matmul`` would round the product before the epilogue), the
    epilogue in f32, one final cast."""
    acc = x.float() @ y.float()
    if bias is not None:
        acc = acc + bias.float()[None, :]
    acc = _activation(acc, activation, gelu_approximate)
    if residual is not None:
        acc = acc + residual.float()
    if layer_norm:
        mean = acc.mean(dim=1, keepdim=True)
        var = (acc - mean).square().mean(dim=1, keepdim=True)
        acc = (acc - mean) / torch.sqrt(var + ln_eps)
        if ln_scale is not None:
            acc = acc * ln_scale.float()[None, :]
        if ln_bias is not None:
            acc = acc + ln_bias.float()[None, :]
    return acc.to(out_dtype or x.dtype)


def _f32(t, shape, name, device):
    """An epilogue operand as the contiguous f32 tensor the kernel reads."""
    if t is None:
        return None
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"fused_gemm: {name} must be {list(shape)} on "
                         f"{device}, got {list(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def fused_gemm(x, y, bias=None, residual=None, ln_scale=None, ln_bias=None,
               activation: str = "none", gelu_approximate: bool = False,
               layer_norm: bool = False, ln_eps: float = 1e-5,
               block_m: int = DEFAULT_BLOCKS[0],
               block_n: int = DEFAULT_BLOCKS[1],
               block_k: int = DEFAULT_BLOCKS[2], out_dtype=None):
    """``epilogue(x @ y)``: bias-add (``bias`` [N]), activation
    (``relu``/``gelu``), residual-add (``residual`` [M, N]) and row-wise
    layer_norm (``ln_scale``/``ln_bias`` [N]), in that order, on the f32
    accumulator; ``out_dtype`` defaults to x's. ``x`` [M, K] and ``y``
    [K, N]; raises ``ValueError`` with the :func:`classify_gemm` reason on
    a shape the kernel does not take (callers choose between a loud
    refusal and the dense replay before calling)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(
            f"fused_gemm is strictly 2-D [M,K]@[K,N]: got x{tuple(x.shape)} "
            f"y{tuple(y.shape)}")
    if activation not in EPILOGUE_ACTIVATIONS:
        raise ValueError(f"unknown epilogue activation {activation!r} — "
                         f"one of {EPILOGUE_ACTIVATIONS}")
    m, k = x.shape
    n = y.shape[1]
    kind, reason = classify_gemm(m, n, k, layer_norm=layer_norm,
                                 block_m=block_m, block_n=block_n,
                                 block_k=block_k)
    if kind != "supported":
        raise ValueError(f"fused_gemm has no kernel tiling for "
                         f"(m={m}, n={n}, k={k}): {reason}")
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return fused_gemm_reference(
            x, y, bias, residual, ln_scale, ln_bias, activation,
            gelu_approximate, layer_norm, ln_eps, out_dtype)
    if x.dtype not in _DTYPES or y.dtype != x.dtype \
            or out_dtype not in _DTYPES:
        raise TypeError(f"fused_gemm kernel takes x and y both float32 or "
                        f"both bfloat16 and writes float32 or bfloat16, got "
                        f"{x.dtype} @ {y.dtype} -> {out_dtype}")
    if y.device != x.device:
        raise ValueError(f"fused_gemm: y on {y.device}, x on {x.device}")
    dev = x.device
    bias = _f32(bias, (n,), "bias", dev)
    residual = _f32(residual, (m, n), "residual", dev)
    ln_scale = _f32(ln_scale, (n,), "ln_scale", dev)
    ln_bias = _f32(ln_bias, (n,), "ln_bias", dev)
    act = {"none": 0, "relu": 1}.get(activation,
                                     3 if gelu_approximate else 2)
    return _gemm_op(x, y, bias, residual, ln_scale, ln_bias, act,
                    bool(layer_norm), float(ln_eps), out_dtype, int(block_m),
                    int(block_n), int(block_k))


def _run_k5(x, y, bias, residual, ln_scale, ln_bias, act, layer_norm,
            ln_eps, out_dtype, block_m, block_n, block_k):
    """Launch K5 on checked operands and count it."""
    x, y = _build.aligned(x), _build.aligned(y)
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch("fused_gemm", x.device, x.data_ptr(), y.data_ptr(),
                  ptr(bias), ptr(residual), ptr(ln_scale), ptr(ln_bias),
                  out.data_ptr(), m, n, k, act, int(layer_norm), ln_eps,
                  int(x.dtype == torch.bfloat16),
                  int(out_dtype == torch.bfloat16), block_m, block_n,
                  block_k)
    fused_gemm.launches += 1
    blocks = (block_m, block_n, block_k)
    fused_gemm.launches_by_blocks[blocks] = \
        fused_gemm.launches_by_blocks.get(blocks, 0) + 1
    return out


@torch.library.custom_op("paddle_tpu_torch::fused_gemm", mutates_args=(),
                         device_types="cuda")
def _gemm_op(x: torch.Tensor, y: torch.Tensor, bias: Optional[torch.Tensor],
             residual: Optional[torch.Tensor],
             ln_scale: Optional[torch.Tensor],
             ln_bias: Optional[torch.Tensor], act: int, layer_norm: bool,
             ln_eps: float, out_dtype: torch.dtype, block_m: int,
             block_n: int, block_k: int) -> torch.Tensor:
    """K5 as a PyTorch operator, so ``torch.export`` traces it as one
    node of the graph (its ctypes launch on raw pointers cannot be
    traced) and an exported program still launches and counts it."""
    return _run_k5(x, y, bias, residual, ln_scale, ln_bias, act, layer_norm,
                   ln_eps, out_dtype, block_m, block_n, block_k)


@_gemm_op.register_fake
def _(x, y, bias, residual, ln_scale, ln_bias, act, layer_norm, ln_eps,
      out_dtype, block_m, block_n, block_k):
    return x.new_empty((x.shape[0], y.shape[1]), dtype=out_dtype)


fused_gemm.launches = 0
# launches per block triple, beside the total (a layer_norm launch counts
# under the triple it was asked for)
fused_gemm.launches_by_blocks = {}
