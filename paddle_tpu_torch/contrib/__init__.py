"""fluid.contrib of the PyTorch port (counterpart of
``paddle_tpu/contrib``): mixed precision. The trainer, inferencer and
slim wait for a later slice."""
from . import mixed_precision  # noqa: F401
