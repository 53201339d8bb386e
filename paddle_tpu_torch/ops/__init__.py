"""Op rules of the PyTorch port; importing this package registers them."""
from . import (fused_attention, generation, loss, math, nn,  # noqa: F401
               optimizer_ops, tensor)
