"""Op rules of the PyTorch port; importing this package registers them."""
from . import (amp_ops, control_flow, fused_attention,  # noqa: F401
               fused_gemm, generation, loss, math, nn, optimizer_ops,
               recompute, tensor)
