"""``fused_gemm_epilogue``: the op the epilogue-fusion pass rewrites
mul/matmul -> elementwise_add -> activation -> residual -> layer_norm chains
into (counterpart of ``paddle_tpu/ops/fused_gemm.py``).

Routes (``fused_gemm_route``, the one authority the op, the fusion pass's
fidelity witness and its PT755 report share):

- ``'cuda'`` — a CUDA tensor and a shape :func:`kernel_support` takes:
  the hand-written kernel K5 (``kernels/fused_gemm.py``) runs the whole
  epilogue on its f32 accumulator;
- ``'plain'`` — ``FLAGS_use_fused_gemm=always`` on a CPU tensor: the
  kernel's plain PyTorch version (the JAX package's interpret mode);
- ``'primitive'`` — everything else: a dense replay of the ORIGINAL
  unfused op rules in the original order, each sub-op's inputs cast by
  the program's AMP policy as the interpreter casts them, bit-exact
  against the unfused program by construction.

Under an AMP policy a white-list base op's float32 x and y are cast to
the compute type before the kernel (the fused op itself is on no list:
its epilogue params stay float32, as the unfused chain's do), and the
route is decided on that type.

``FLAGS_use_fused_gemm`` = auto|always|never picks the path; ``always``
raises on a shape the kernel does not take instead of replaying. Block
sizes resolve, in order: ``FLAGS_fused_gemm_blocks`` ("m,n,k") > the
triple on ``LowerCtx.gemm_blocks`` (the executor puts the autotuner's
best-known triple there, on the run's steps and the fusion witness alike)
> the kernel's default.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import flags
from ..core import registry
from ..core.types import canonical_dtype, torch_dtype
from ..lowering import amp_policy_of
from .common import IOSpec, register_op, x

__all__ = ["fused_gemm_route", "kernel_support", "resolve_gemm_blocks",
           "compute_dtype"]

# the input types the kernel takes (x and y alike)
_KERNEL_DTYPES = ("float32", "bfloat16")


def resolve_gemm_blocks(ctx=None) -> Tuple[int, int, int]:
    """(block_m, block_n, block_k): the flag wins, then the triple on the
    lowering context, then the kernel's compiled default."""
    from ..kernels.fused_gemm import DEFAULT_BLOCKS

    raw = str(flags.flag("fused_gemm_blocks")).strip()
    if raw:
        parts = [p for p in raw.replace("x", ",").split(",") if p.strip()]
        if len(parts) != 3:
            raise ValueError(
                f"FLAGS_fused_gemm_blocks must be 'm,n,k', got {raw!r}")
        return tuple(int(p) for p in parts)
    tuned = getattr(ctx, "gemm_blocks", None)
    if tuned:
        return tuple(int(b) for b in tuned)
    return DEFAULT_BLOCKS


def kernel_support(m: int, n: int, k: int, *, layer_norm: bool,
                   blocks: Tuple[int, int, int], alpha: float = 1.0,
                   dtype="float32") -> Tuple[str, str]:
    """('supported' | 'unsupported', reason): whether K5 computes this
    chain — an alpha-scaled matmul and a type the kernel does not take
    never do, whatever the tiling; otherwise ``classify_gemm`` decides."""
    from ..kernels.fused_gemm import classify_gemm

    if alpha != 1.0:
        return "unsupported", f"alpha={alpha} != 1 runs the dense replay"
    dt = canonical_dtype(dtype)
    if dt not in _KERNEL_DTYPES:
        return ("unsupported", f"dtype {dt}: the kernel takes "
                               f"{' or '.join(_KERNEL_DTYPES)}")
    return classify_gemm(m, n, k, layer_norm=layer_norm, block_m=blocks[0],
                         block_n=blocks[1], block_k=blocks[2])


def fused_gemm_route(m: int, n: int, k: int, *, layer_norm: bool,
                     blocks: Tuple[int, int, int], alpha: float = 1.0,
                     dtype="float32", on_cuda: bool = False
                     ) -> Tuple[str, str]:
    """('cuda' | 'plain' | 'primitive', reason) for a chain whose tensors
    are on a CUDA device (``on_cuda``) or not."""
    mode = flags.flag("use_fused_gemm")
    if mode == "never":
        return "primitive", "FLAGS_use_fused_gemm=never"
    kind, reason = kernel_support(m, n, k, layer_norm=layer_norm,
                                  blocks=blocks, alpha=alpha, dtype=dtype)
    if kind != "supported":
        if mode == "always" and alpha == 1.0:
            # loud, not a silent dense fallback: 'always' is a promise
            # (an alpha-scaled matmul has no kernel variant to insist on)
            raise ValueError(
                f"FLAGS_use_fused_gemm=always but (m={m}, n={n}, k={k}) "
                f"has no kernel tiling: {reason}")
        return "primitive", reason
    if on_cuda:
        return "cuda", reason
    if mode == "always":
        return "plain", reason
    return "primitive", f"CPU tensor ({reason})"


def _replay(ctx, op_type: str, ins: dict, attrs: dict):
    """Run one original op rule (the dense route and the witness both go
    through here), its inputs cast by the program's AMP policy exactly as
    the interpreter casts the unfused op's."""
    opdef = registry.get_op_def(op_type)
    full = {k: v.default for k, v in opdef.attrs.items()}
    full.update(attrs)
    amp = amp_policy_of(ctx)
    if amp is not None:
        ins = amp.cast_ins(op_type, ins)
    return opdef.lower(ctx, ins, full)


def compute_dtype(ctx, base_type: str, dtype) -> torch.dtype:
    """The type the chain's product runs in: the AMP policy's compute
    type for a float32 operand of a white-list base op, else ``dtype``."""
    amp = amp_policy_of(ctx)
    if amp is not None and base_type in amp.white \
            and dtype == torch.float32:
        return torch_dtype(amp.compute_dtype)
    return dtype


def _base_attrs(attrs: dict) -> dict:
    if attrs["base_type"] == "mul":
        return {"x_num_col_dims": attrs["x_num_col_dims"],
                "y_num_col_dims": attrs["y_num_col_dims"]}
    return {"transpose_X": attrs["transpose_X"],
            "transpose_Y": attrs["transpose_Y"],
            "alpha": attrs["alpha"]}


def _primitive_chain(ctx, xv, yv, bias, residual, ln_scale, ln_bias, attrs):
    """The unfused chain, op rule by op rule, in the matched order —
    bit-exact against the original program."""
    cur = _replay(ctx, attrs["base_type"], {"X": [xv], "Y": [yv]},
                  _base_attrs(attrs))["Out"][0]
    if bias is not None:
        cur = _replay(ctx, "elementwise_add", {"X": [cur], "Y": [bias]},
                      {"axis": attrs["bias_axis"]})["Out"][0]
    act = attrs["activation"]
    if act == "relu":
        cur = _replay(ctx, "relu", {"X": [cur]}, {})["Out"][0]
    elif act == "gelu":
        cur = _replay(ctx, "gelu", {"X": [cur]},
                      {"approximate": attrs["gelu_approximate"]})["Out"][0]
    if residual is not None:
        cur = _replay(ctx, "elementwise_add", {"X": [cur], "Y": [residual]},
                      {"axis": attrs["residual_axis"]})["Out"][0]
    if attrs["layer_norm"]:
        ins = {"X": [cur], "Scale": [ln_scale], "Bias": [ln_bias]}
        cur = _replay(ctx, "layer_norm", ins,
                      {"epsilon": attrs["epsilon"],
                       "begin_norm_axis": attrs["begin_norm_axis"]})["Y"][0]
    return cur


def _gemm_2d_view(xv, yv, attrs):
    """(x2 [M,K], y2 [K,N], out_shape) — the strictly-2-D view the kernel
    computes in, mirroring the mul/matmul rules' own reshapes. A
    transposed matmul operand is a strided view here; the kernel wrapper
    makes it contiguous (one copy) before the launch."""
    if attrs["base_type"] == "mul":
        xnc, ync = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
        xs, ys = tuple(xv.shape), tuple(yv.shape)
        x2 = xv.reshape(math.prod(xs[:xnc]), math.prod(xs[xnc:]))
        y2 = yv.reshape(math.prod(ys[:ync]), math.prod(ys[ync:]))
        return x2, y2, xs[:xnc] + ys[ync:]
    x2 = xv.transpose(-1, -2) if attrs["transpose_X"] else xv
    y2 = yv.transpose(-1, -2) if attrs["transpose_Y"] else yv
    return x2, y2, (x2.shape[0], y2.shape[1])


@register_op("fused_gemm_epilogue",
             inputs=[IOSpec("X"), IOSpec("Y"),
                     IOSpec("Bias", optional=True, no_grad=True),
                     IOSpec("Residual", optional=True),
                     IOSpec("LnScale", optional=True, no_grad=True),
                     IOSpec("LnBias", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"base_type": "mul",
                    "x_num_col_dims": 1, "y_num_col_dims": 1,
                    "transpose_X": False, "transpose_Y": False, "alpha": 1.0,
                    "activation": "none", "gelu_approximate": False,
                    "bias_axis": -1, "residual_axis": -1,
                    "layer_norm": False, "epsilon": 1e-5,
                    "begin_norm_axis": -1},
             grad=None)
def _fused_gemm_epilogue(ctx, ins, attrs):
    """Out = epilogue(X [mul|matmul] Y): bias-add, relu/gelu, residual-add,
    layer_norm — folded into the GEMM on the kernel route, replayed rule by
    rule on the dense route. Only the epilogue-fusion pass emits this op;
    it never carries a backward (the pass refuses training programs), so
    ``grad=None``."""
    xv, yv = x(ins, "X"), x(ins, "Y")
    bias = x(ins, "Bias")
    residual = x(ins, "Residual")
    ln_scale, ln_bias = x(ins, "LnScale"), x(ins, "LnBias")

    blocks = resolve_gemm_blocks(ctx)
    x2, y2, out_shape = _gemm_2d_view(xv, yv, attrs)
    m, k = int(x2.shape[0]), int(x2.shape[1])
    n = int(y2.shape[1])
    # the route is decided on the type the product runs in (under AMP a
    # white-list base op's bf16), not on the scope's float32
    comp = compute_dtype(ctx, attrs["base_type"], x2.dtype)
    route, _reason = fused_gemm_route(
        m, n, k, layer_norm=bool(attrs["layer_norm"]), blocks=blocks,
        alpha=float(attrs.get("alpha", 1.0)), dtype=comp,
        on_cuda=x2.is_cuda)
    if route == "primitive":
        return {"Out": [_primitive_chain(ctx, xv, yv, bias, residual,
                                         ln_scale, ln_bias, attrs)]}

    from ..kernels.fused_gemm import fused_gemm

    x2 = x2.to(comp)
    y2 = y2.to(compute_dtype(ctx, attrs["base_type"], y2.dtype))
    res2 = residual.reshape(m, n) if residual is not None else None
    # the unfused chain's output type: a GEMM output (bf16 under AMP)
    # meeting epilogue params of a wider type promotes op by op, as the
    # binary ops do
    out_dt = x2.dtype
    for extra in (bias, res2, ln_scale, ln_bias):
        if extra is not None:
            out_dt = torch.promote_types(out_dt, extra.dtype)
    o = fused_gemm(
        x2, y2, bias=bias, residual=res2, ln_scale=ln_scale,
        ln_bias=ln_bias, activation=attrs["activation"],
        gelu_approximate=bool(attrs["gelu_approximate"]),
        layer_norm=bool(attrs["layer_norm"]),
        ln_eps=float(attrs["epsilon"]),
        block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
        out_dtype=out_dt)
    return {"Out": [o.reshape(out_shape)]}
