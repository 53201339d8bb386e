"""incubate namespace of the PyTorch port (counterpart of
``paddle_tpu/incubate``; reference python/paddle/fluid/incubate):
``data_generator`` and ``fleet``."""
from . import data_generator  # noqa: F401
from . import fleet  # noqa: F401
