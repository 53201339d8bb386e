"""Op rules of the PyTorch port; importing this package registers them."""
from . import (amp_ops, control_flow, fused_attention,  # noqa: F401
               fused_gemm, generation, loss, math, misc2, nn, optimizer_ops,
               recompute, rnn_ops, sequence_ops, structured, tensor)
