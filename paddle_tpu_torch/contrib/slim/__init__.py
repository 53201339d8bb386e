"""Model compression (counterpart of ``paddle_tpu/contrib/slim``;
reference python/paddle/fluid/contrib/slim/):
quantization (QAT), pruning (mask + shape-shrink), distillation
(L2/FSP/soft-label over merged programs), search (SA controller)."""
from . import distillation  # noqa: F401
from . import prune  # noqa: F401
from . import quantization  # noqa: F401
from . import searcher  # noqa: F401
