"""Op rules of the PyTorch port; importing this package registers them."""
from . import fused_attention, generation, math, nn, tensor  # noqa: F401
