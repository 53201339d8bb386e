"""Hand-written Hopper kernels of the port (CUDA C++ in ``../csrc``, bound
with ctypes) and their plain PyTorch versions: flash attention forward
(K1) and backward (K3, K4), paged decode attention (K2) and the fused
GEMM + epilogue (K5). Each wrapper launches its
kernel on a CUDA tensor, counting launches on ``.launches``, and takes the
plain version on a CPU tensor."""
import torch

from .decode_attention import (decode_attention_reference, decode_in_slices,
                               flash_attention_decode, paged_kv_append,
                               paged_kv_append_rows)
from .flash_attention import (classify_backward_shapes, classify_shapes,
                              dropout_keep, flash_attention,
                              flash_attention_dkv,
                              flash_attention_dkv_reference,
                              flash_attention_dq,
                              flash_attention_dq_reference,
                              flash_attention_reference,
                              flash_attention_with_lse, philox4x32_10)
from .fused_gemm import (COMPILED_BLOCKS, DEFAULT_BLOCKS, classify_gemm,
                         fused_gemm, fused_gemm_reference)

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "flash_attention_dq",
           "flash_attention_dq_reference", "flash_attention_dkv",
           "flash_attention_dkv_reference", "classify_shapes",
           "classify_backward_shapes", "philox4x32_10", "dropout_keep",
           "flash_attention_decode", "decode_attention_reference",
           "decode_in_slices", "paged_kv_append", "paged_kv_append_rows",
           "fused_gemm", "fused_gemm_reference", "classify_gemm",
           "DEFAULT_BLOCKS", "COMPILED_BLOCKS",
           "KERNEL_SOURCES", "KERNEL_TOL", "reset_launch_counts",
           "launch_counts"]

# csrc/<name>.cu -> the wrapper whose .launches counts its launches
KERNEL_SOURCES = {
    "flash_attention_fwd": flash_attention_with_lse,
    "decode_attention": flash_attention_decode,
    "flash_attention_dq": flash_attention_dq,
    "flash_attention_dkv": flash_attention_dkv,
    "fused_gemm": fused_gemm,
}

# How closely a kernel's output must match its plain version on the card
# (torch.allclose). float32: the two sum in different orders. bfloat16:
# both accumulate in float32 and round the output once, so they differ by
# about one bf16 ulp (2**-7 relative); rtol allows two, atol one at 1.0.
KERNEL_TOL = {
    torch.float32: dict(atol=1e-4, rtol=1e-3),
    torch.bfloat16: dict(atol=8e-3, rtol=1.6e-2),
}


def reset_launch_counts() -> None:
    for fn in KERNEL_SOURCES.values():
        fn.launches = 0
    fused_gemm.launches_by_blocks.clear()


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_SOURCES.items()}
