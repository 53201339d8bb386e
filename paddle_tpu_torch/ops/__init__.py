"""Op rules of the PyTorch port; importing this package registers them."""
from . import (fused_attention, fused_gemm, generation, loss,  # noqa: F401
               math, nn, optimizer_ops, tensor)
