"""fluid.contrib of the PyTorch port (counterpart of
``paddle_tpu/contrib``): mixed precision, model compression (``slim``:
quantization-aware training, pruning, distillation, the search
controller), and the high-level ``Trainer`` and ``Inferencer`` with their
events and ``CheckpointConfig``."""
from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401
from .trainer import (CheckpointConfig, Trainer,  # noqa: F401
                      BeginEpochEvent, BeginStepEvent, EndEpochEvent,
                      EndStepEvent)
from .inferencer import Inferencer  # noqa: F401
