"""incubate namespace of the PyTorch port (counterpart of
``paddle_tpu/incubate``; reference python/paddle/fluid/incubate):
``data_generator``. ``incubate.fleet`` waits for multi-device."""
from . import data_generator  # noqa: F401
