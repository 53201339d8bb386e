"""Generative serving of the PyTorch port."""
from .engine import (BatchFailed, DeadlineExceeded, EngineStopped,  # noqa
                     Overloaded, ServingConfig, ServingEngine, ServingError,
                     ServingFuture)
from .generate import GenerationConfig, GenerativeEngine  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
