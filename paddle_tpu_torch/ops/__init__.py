"""Op rules of the PyTorch port; importing this package registers them."""
from . import (amp_ops, control_flow, detection,  # noqa: F401
               fused_attention,
               fused_gemm, generation, image, loss, math, misc, misc2, nn,
               optimizer_ops, pipeline_op, quant_ops, recompute, rnn_ops,
               sequence_ops, structured, tensor)
from ..core.registry import all_ops, get_op_def, has_op, register_op  # noqa: F401,E402
