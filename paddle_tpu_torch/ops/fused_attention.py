"""fused_multihead_attention (counterpart of
``paddle_tpu/ops/fused_attention.py``).

Routing, as the reference's ``_route``: ``FLAGS_use_flash_attention=never``
asks for the plain PyTorch version explicitly (differentiated by
autograd); otherwise a CUDA tensor launches the hand-written kernels
(``kernels/flash_attention.py``: K1 forward, K3/K4 backward) and a CPU
tensor takes their plain versions. There is no fallback from a kernel: a
shape a kernel refuses raises.

Attention dropout draws its int32 seed from the op's generator, keyed on
(step seed, op uid) like every random op, so the generic grad op's
recompute and the backward kernels regenerate the forward's mask.

``sequence_parallel=True`` inside a parallel step whose mesh has an
``sp`` axis of more than one rank runs ring attention over it
(``parallel/ring_attention.py``: one K1 call a block, K3/K4 through its
backward), refusing ``BiasQK`` and ``attn_dropout > 0`` as the JAX
package does; with no such axis it is plain attention.
"""
from __future__ import annotations

import torch

from .. import flags
from .common import IOSpec, register_op, x


def plain_requested() -> bool:
    """True when ``FLAGS_use_flash_attention=never`` asks every attention
    op for its plain PyTorch version."""
    return flags.flag("use_flash_attention") == "never"


@register_op("fused_multihead_attention",
             inputs=[IOSpec("Q"), IOSpec("K"), IOSpec("V"),
                     IOSpec("BiasQK", optional=True, no_grad=True)],
             outputs=["Out"],
             attrs={"causal": False, "scale": 0.0, "attn_dropout": 0.0,
                    "is_test": False, "sequence_parallel": False},
             needs_rng=True)
def _fused_mha(ctx, ins, attrs):
    """Q/K/V [B, num_heads, S, head_dim]; BiasQK an additive key bias,
    [B, S] or [B, 1, 1, S]. scale 0.0 means 1/sqrt(head_dim)."""
    from ..kernels import flash_attention_reference, flash_attention_with_lse

    q, k, v = x(ins, "Q"), x(ins, "K"), x(ins, "V")
    bias = x(ins, "BiasQK")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = attrs["scale"] or float(D) ** -0.5
    dropout = 0.0 if attrs.get("is_test") else float(attrs["attn_dropout"])
    causal = bool(attrs["causal"])
    mesh = getattr(ctx, "mesh", None)
    if attrs.get("sequence_parallel") and mesh is not None \
            and mesh.shape.get("sp", 1) > 1:
        if bias is not None:
            raise NotImplementedError(
                "sequence_parallel attention with BiasQK: fold padding "
                "into the sequence instead — the ring path has no "
                "global [B, S] bias plumbing yet")
        if dropout > 0.0:
            raise NotImplementedError(
                "sequence_parallel attention with attn_dropout>0: the "
                "ring path's per-block kernels do not coordinate a "
                "global dropout mask")
        from ..parallel.ring_attention import ring_attention

        o = ring_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), mesh, seq_axis="sp",
                           causal=causal, scale=scale)
        return {"Out": [o.transpose(1, 2)]}
    if bias is not None:
        if bias.dim() == 4:
            bias = bias.reshape(bias.shape[0], bias.shape[-1])
        elif bias.dim() != 2:
            raise ValueError(f"BiasQK must be [B, S] or [B, 1, 1, S], got "
                             f"{tuple(bias.shape)}")
        bias = bias.float()
    seed = 0
    if dropout > 0.0 and not q.is_meta:
        # drawn on the host: no device sync
        seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=ctx.generator(device="cpu")))
    fn = flash_attention_reference if plain_requested() \
        else flash_attention_with_lse
    o, _ = fn(q.reshape(B * H, Sq, D), k.reshape(B * H, Sk, D),
              v.reshape(B * H, Sk, D), bias=bias,
              causal=causal, scale=scale, num_heads=H,
              dropout_rate=dropout, seed=seed)
    return {"Out": [o.reshape(B, H, Sq, D)]}
