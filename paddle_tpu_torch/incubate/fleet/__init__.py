"""Fleet distributed-training API (counterpart of
``paddle_tpu/incubate/fleet``; reference incubate/fleet/)."""
from . import base  # noqa: F401
